"""Preference alignment in the port (DPO, ORPO, KTO) against the JAX package.

Model: a tiny Llama (2 layers, hidden 64, 4 heads / 2 kv heads, vocab 512);
inputs and records are seeded numpy; weights cross with
``tools/convert.py::params_from_jax``.  Tolerances:

- the losses (``logprobs_from_logits``, ``sequence_logprobs``, ``dpo_loss``,
  ``orpo_loss``, ``kto_loss``): values and gradients (torch autograd against
  ``jax.grad``) in fp32 within rtol 1e-6 (atol 1e-7 for values near 0);
- the data modules: every array equal bit for bit, ``_mismatched_pairing``
  equal index for index, with the same warnings and errors;
- the loss functions on the tiny model: ``fp32`` loss within rtol 1e-5 and
  every gradient leaf within 1e-5 of its largest entry; ``mixed_precision``
  loss within rtol 1e-4 and every gradient leaf within 3e-2 of its largest
  entry (``test_torch_llama.py``'s bar: bf16 rounds at different points);
- the reference pass: columns within rtol 1e-5 of JAX's (fp32); a resumed,
  a restored or a recomputed pass gives the whole pass's columns bit for bit;
- the trainer, 3 steps from the JAX trainer's weights, in fp32 (DPO's
  JAX run, on 2 virtual devices, is shared with the gloo test): loss and
  grad norm within rtol 1e-5, each reward metric within rtol 1e-4 and atol
  1e-5.  (Under ``mixed_precision`` the bf16 logits move each sequence's
  log-prob by ~1e-3 nats between the frameworks and the preference margin
  reads those differences, so after step 0 the losses part by ~4e-4: fp32 is
  the comparison that can see a fault of the port.)
- gloo (``tests/_torch_dp_worker.py``, one launch of 2 ranks): DPO and KTO
  at dp=2 with ZeRO-1, and DPO at tp=2 with SP, each 3 steps against the
  JAX trainer on 2 virtual devices, at the trainer's fp32 tolerances.
"""

import json
import logging
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.alignment import dpo as t_dpo
from neuronx_distributed_training_torch.alignment import kto as t_kto
from neuronx_distributed_training_torch.alignment import losses as t_losses
from neuronx_distributed_training_torch.alignment.orpo import make_orpo_loss_fn as t_orpo_fn
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.data import build as t_build
from neuronx_distributed_training_torch.data import modules as t_modules
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.ops import cross_entropy as t_ce
from neuronx_distributed_training_torch.optim.adamw import init_opt_state
from neuronx_distributed_training_torch.tools.convert import params_from_jax, params_to_jax
from neuronx_distributed_training_torch.trainer import cli as t_cli
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy as TPolicy
from neuronx_distributed_training_tpu.alignment import dpo as j_dpo
from neuronx_distributed_training_tpu.alignment import kto as j_kto
from neuronx_distributed_training_tpu.alignment import losses as j_losses
from neuronx_distributed_training_tpu.alignment.orpo import make_orpo_loss_fn as j_orpo_fn
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.data import modules as j_modules
from neuronx_distributed_training_tpu.models import llama as j_llama
from neuronx_distributed_training_tpu.ops import cross_entropy as j_ce
from neuronx_distributed_training_tpu.trainer import loop as j_loop
from neuronx_distributed_training_tpu.utils.dtypes import DtypePolicy as JPolicy

REPO = Path(__file__).resolve().parents[1]
CONF = REPO / "examples" / "conf"
MODEL = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128, "num_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 64}
SEQ = 64
TOK = t_build.CharTokenizer(512)
#: trainer tolerances (fp32): loss and grad norm, reward metrics (rtol, atol)
TRAIN_RTOL, METRIC_TOL = 1e-5, (1e-4, 1e-5)
METRICS = {"dpo": ("rewards_chosen", "rewards_rejected", "reward_accuracy", "reward_margin"),
           "orpo": ("orpo_nll", "orpo_log_odds", "orpo_ratio", "rewards_chosen",
                    "rewards_rejected"),
           "kto": ("kto_kl", "rewards_desirable", "rewards_undesirable")}


def _text(rng, lo, hi):
    return "".join(chr(int(c)) for c in rng.integers(32, 127, int(rng.integers(lo, hi))))


def pref_records(n=24, seed=3, prompts=6):
    """prompt / chosen / rejected records; each prompt shared by several."""
    rng = np.random.default_rng(seed)
    ps = [_text(rng, 5, 30) for _ in range(prompts)]
    return [{"prompt": ps[i % prompts], "chosen": _text(rng, 5, 40),
             "rejected": _text(rng, 5, 40)} for i in range(n)]


def kto_records(n=24, seed=4, prompts=6):
    """prompt / completion / label records, about half desirable."""
    rng = np.random.default_rng(seed)
    ps = [_text(rng, 5, 30) for _ in range(prompts)]
    return [{"prompt": ps[i % prompts], "completion": _text(rng, 5, 40),
             "label": bool(rng.random() < 0.5)} for i in range(n)]


def _jsonl(path, records):
    path.write_text("\n".join(json.dumps(r) for r in records))
    return path


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _close(a, b, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------


def test_logprobs_from_logits_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    weight = rng.standard_normal((2, 7)).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda x: jnp.sum(j_ce.logprobs_from_logits(x, labels) * weight))(logits)
    x = _t(logits, True)
    tv = torch.sum(t_ce.logprobs_from_logits(x, torch.as_tensor(labels)) * _t(weight))
    tv.backward()
    _close(tv.detach(), jv)
    _close(x.grad, jg)


@pytest.mark.parametrize("shift,average,mask", [(True, False, True), (True, True, True),
                                                (False, False, False), (True, True, False)])
def test_sequence_logprobs_matches_jax(shift, average, mask):
    rng = np.random.default_rng(1)
    logits = (2 * rng.standard_normal((3, 9, 17))).astype(np.float32)
    labels = rng.integers(0, 17, (3, 9)).astype(np.int32)
    labels[0, :4] = -100  # a masked prompt
    labels[2, :] = -100  # a row with nothing to count (the average's max(., 1))
    loss_mask = (rng.random((3, 9)) > 0.3).astype(np.float32) if mask else None
    w = np.asarray([0.5, -1.5, 2.0], np.float32)
    kw = dict(shift=shift, average=average)
    jv, jg = jax.value_and_grad(lambda x: jnp.sum(
        j_losses.sequence_logprobs(x, labels, loss_mask, **kw) * w))(logits)
    x = _t(logits, True)
    tv = torch.sum(t_losses.sequence_logprobs(
        x, torch.as_tensor(labels), None if loss_mask is None else _t(loss_mask), **kw) * _t(w))
    tv.backward()
    _close(tv.detach(), jv)
    _close(x.grad, jg)


def _logps(seed, n=6, scale=3.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(n) - 20).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_dpo_loss_matches_jax(label_smoothing):
    pc, pr, rc, rr = _logps(2)
    kw = dict(beta=0.2, label_smoothing=label_smoothing)

    def jfn(pc, pr):
        return j_losses.dpo_loss(pc, pr, rc, rr, **kw)

    (jv, jm), jg = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(pc, pr)
    a, b = _t(pc, True), _t(pr, True)
    tv, tm = t_losses.dpo_loss(a, b, _t(rc), _t(rr), **kw)
    tv.backward()
    _close(tv.detach(), jv)
    _close(a.grad, jg[0])
    _close(b.grad, jg[1])
    assert tm.keys() == jm.keys()
    for k in jm:
        _close(tm[k], jm[k])


def test_orpo_loss_matches_jax():
    pc, pr, _, _ = _logps(3, scale=0.5)
    pc, pr = pc / 20, pr / 20  # length-averaged log-probs, about -1
    pc[0] = -1e-8  # hits the clip at -1e-6

    def jfn(pc, pr):
        return j_losses.orpo_loss(pc, pr, -jnp.mean(pc), beta=0.3)

    (jv, jm), jg = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(pc, pr)
    a, b = _t(pc, True), _t(pr, True)
    tv, tm = t_losses.orpo_loss(a, b, -torch.mean(a), beta=0.3)
    tv.backward()
    _close(tv.detach(), jv)
    _close(a.grad, jg[0])
    _close(b.grad, jg[1])
    assert tm.keys() == jm.keys()
    for k in jm:
        _close(tm[k], jm[k])


@pytest.mark.parametrize("kl,weights", [(False, (1.0, 1.0)), (True, (1.0, 1.0)),
                                        (False, (1.7, 0.6)), (True, (0.8, 2.5))])
def test_kto_loss_matches_jax(kl, weights):
    pol, ref, kl_r, _ = _logps(4, n=8)
    labels = np.asarray([1, 0, 0, 1, 1, 1, 0, 1], np.float32)
    kl_rewards = np.abs(kl_r - kl_r.mean()).astype(np.float32) * 0.1 if kl else None
    kw = dict(beta=0.1, desirable_weight=weights[0], undesirable_weight=weights[1])
    (jv, jm), jg = jax.value_and_grad(lambda p: j_losses.kto_loss(
        p, ref, labels, kl_rewards=kl_rewards, **kw), has_aux=True)(pol)
    a = _t(pol, True)
    tv, tm = t_losses.kto_loss(a, _t(ref), _t(labels),
                               kl_rewards=None if kl_rewards is None else _t(kl_rewards), **kw)
    tv.backward()
    _close(tv.detach(), jv)
    _close(a.grad, jg)
    assert tm.keys() == jm.keys()
    for k in jm:
        _close(tm[k], jm[k])
    if kl:
        assert float(tm["kto_kl"]) > 0  # the baseline comes from kl_rewards


# ---------------------------------------------------------------------------
# the data modules
# ---------------------------------------------------------------------------


def _same_arrays(t, j):
    assert t.keys() == j.keys()
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


DPO_DATA_CASES = {"plain": {}, "prompt_cap": {"max_prompt_length": 8},
                  "keep_end": {"max_prompt_length": 8, "truncation_mode": "keep_end"},
                  "overlong": {"seq": 24, "truncation_mode": "keep_end"},
                  "overlong_start": {"seq": 24}}


@pytest.mark.parametrize("case", DPO_DATA_CASES)
def test_dpo_data_module_matches_jax(case):
    kw = dict(DPO_DATA_CASES[case])
    seq = kw.pop("seq", SEQ)
    recs = pref_records()
    recs[0]["chosen"] = "x" * 70  # a completion longer than the row
    t = t_modules.DPODataModule(recs, TOK, seq, 4, seed=9, **kw)
    j = j_modules.DPODataModule(recs, TOK, seq, 4, seed=9, **kw)
    _same_arrays(t.arrays, j.arrays)
    tb, jb = next(t.global_batches()), next(j.global_batches())
    _same_arrays(tb, jb)


@pytest.mark.parametrize("estimator", ["batch_mean", "mismatched"])
@pytest.mark.parametrize("case", ["plain", "overlong"])
def test_kto_data_module_matches_jax(estimator, case):
    recs = kto_records()
    seq, kw = (SEQ, {}) if case == "plain" else (20, {"max_prompt_length": 12,
                                                       "truncation_mode": "keep_end"})
    t = t_modules.KTODataModule(recs, TOK, seq, 4, kl_estimator=estimator, seed=13, **kw)
    j = j_modules.KTODataModule(recs, TOK, seq, 4, kl_estimator=estimator, seed=13, **kw)
    _same_arrays(t.arrays, j.arrays)
    assert ("kl_input_ids" in t.arrays) == (estimator == "mismatched")
    _same_arrays(next(t.global_batches()), next(j.global_batches()))
    cols = {"reference_logps": np.arange(len(recs), dtype=np.float64)}
    t.attach_reference_logprobs(cols)
    j.attach_reference_logprobs(cols)
    _same_arrays(t.arrays, j.arrays)


PAIRING_CASES = {
    "distinct": ([(i,) for i in range(9)], None),
    "repeated": ([(i % 3,) for i in range(12)], None),
    "majority": ([(0,)] * 7 + [(1,), (2,), (1,)], "owns 7 of 10"),
    "identical": ([(5, 5)] * 6, "shares one prompt"),
}


@pytest.mark.parametrize("case", PAIRING_CASES)
def test_mismatched_pairing_matches_jax(case):
    prompts, warning = PAIRING_CASES[case]

    def pairing(mod):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            pair = mod._mismatched_pairing(prompts, np.random.default_rng(21))
        return pair, [str(w.message) for w in seen]

    t, tw = pairing(t_modules)
    j, jw = pairing(j_modules)
    assert t == j
    assert tw == jw and len(tw) == (warning is not None)
    if warning:
        assert warning in tw[0]
    if case in ("distinct", "repeated"):
        assert sorted(t) == list(range(len(prompts)))  # a bijection
    if case != "identical":
        assert all(prompts[i] != prompts[p] for i, p in enumerate(t))


@pytest.mark.parametrize("bad,err,match", [
    ("one_record", ValueError, "at least 2"),
    ("no_label", KeyError, "missing 'label'"),
])
def test_kto_data_module_errors_match_jax(bad, err, match):
    recs = kto_records(1) if bad == "one_record" else kto_records(4)
    if bad == "no_label":
        del recs[2]["label"]
    for mod in (t_modules, j_modules):
        with pytest.raises(err, match=match):
            mod.KTODataModule(recs, TOK, SEQ, 1, kl_estimator="mismatched")


# ---------------------------------------------------------------------------
# the loss functions and the reference pass on the tiny model
# ---------------------------------------------------------------------------


def _models(precision):
    jcfg = j_llama.LlamaConfig.from_config(MODEL)
    jpol = JPolicy.from_precision_config({"type": precision})
    jparams = j_llama.init_params(jax.random.PRNGKey(0), jcfg, jpol)
    tcfg = t_llama.LlamaConfig.from_config(MODEL)
    tpol = TPolicy.from_precision_config({"type": precision})
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")

    def tfwd(p, ids):
        return t_llama.forward(p, {"input_ids": torch.as_tensor(ids)}, tcfg, tpol)[0]

    return jparams, j_loop._forward_logits_for(jcfg, jpol), tparams, tfwd


def _batch(kind, n=4):
    if kind == "kto_mismatched":
        dm = t_modules.KTODataModule(kto_records(), TOK, SEQ, n, kl_estimator="mismatched")
    elif kind == "kto":
        dm = t_modules.KTODataModule(kto_records(), TOK, SEQ, n)
    else:
        dm = t_modules.DPODataModule(pref_records(), TOK, SEQ, n)
    batch = next(dm.global_batches())
    rng = np.random.default_rng(5)
    for k in (("reference_logps", "reference_kl_logps") if kind.startswith("kto")
              else ("reference_chosen_logps", "reference_rejected_logps")):
        batch[k] = (-150 + 10 * rng.standard_normal(n)).astype(np.float32)
    return batch


def _loss_fns(kind, jfwd, tfwd):
    if kind == "dpo":
        return j_dpo.make_dpo_loss_fn(jfwd, beta=0.2), t_dpo.make_dpo_loss_fn(tfwd, beta=0.2)
    if kind == "orpo":
        return j_orpo_fn(jfwd, beta=0.2), t_orpo_fn(tfwd, beta=0.2)
    kw = dict(beta=0.2, desirable_weight=1.3, undesirable_weight=0.7,
              kl_estimator="mismatched" if kind == "kto_mismatched" else "batch_mean")
    return j_kto.make_kto_loss_fn(jfwd, **kw), t_kto.make_kto_loss_fn(tfwd, **kw)


LOSS_FN_TOL = {"fp32": (1e-5, 1e-5), "mixed_precision": (1e-4, 3e-2)}


@pytest.mark.parametrize("precision", ["fp32", "mixed_precision"])
@pytest.mark.parametrize("kind", ["dpo", "orpo", "kto", "kto_mismatched"])
def test_loss_fns_match_jax_loss_and_every_grad_leaf(kind, precision):
    jparams, jfwd, tparams, tfwd = _models(precision)
    batch = _batch(kind)
    jfn, tfn = _loss_fns(kind, jfwd, tfwd)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jfn(p, jb, None), has_aux=True))(jparams)
    flat = t_llama.named_params(tparams)
    for p in flat.values():
        p.requires_grad_(True)
    tloss, tm = tfn(tparams, {k: torch.as_tensor(v) for k, v in batch.items()})
    tloss.backward()
    loss_rtol, grad_rel = LOSS_FN_TOL[precision]
    assert np.isclose(float(tloss), float(jloss), rtol=loss_rtol), (float(tloss), float(jloss))
    assert tm.keys() == jm.keys()

    def grad_tree(tree):
        if isinstance(tree, dict):
            return {k: grad_tree(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [grad_tree(v) for v in tree]
        return tree.grad

    tflat = dict(jax.tree_util.tree_flatten_with_path(params_to_jax(grad_tree(tparams)))[0])
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(tflat) == len(jflat)
    for path, jg in jflat:
        jg, tg = np.asarray(jg, np.float32), np.asarray(tflat[path], np.float32)
        err = np.abs(tg - jg).max() / (np.abs(jg).max() + 1e-12)
        assert err < grad_rel, (jax.tree_util.keystr(path), err)


def test_kto_kl_forward_keeps_no_graph():
    """The mismatched-KL forward runs without autograd: the loss's graph
    holds one forward (its backward launches no dq / dk,dv for the KL rows)."""
    _, _, tparams, tfwd = _models("fp32")
    calls = []

    def fwd(p, ids):
        out = tfwd(p, ids)
        calls.append(out.requires_grad)
        return out

    for p in t_llama.named_params(tparams).values():
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(v) for k, v in _batch("kto_mismatched").items()}
    _loss_fns("kto_mismatched", None, fwd)[1](tparams, batch)
    assert calls == [True, False]


@pytest.mark.parametrize("kind", ["dpo", "kto", "kto_mismatched"])
def test_reference_columns_match_jax(kind):
    jparams, jfwd, tparams, tfwd = _models("fp32")
    batch = _batch(kind, n=6)
    batch = {k: v for k, v in batch.items() if not k.startswith("reference_")}
    halves = [{k: v[:3] for k, v in batch.items()}, {k: v[3:] for k, v in batch.items()}]
    if kind == "dpo":
        j = j_dpo.compute_reference_logprobs(jparams, halves, jfwd)
        t = t_dpo.compute_reference_logprobs(tparams, halves, tfwd, micro_batch_size=2)
    else:
        j = j_kto.compute_reference_logprobs_kto(jparams, halves, jfwd)
        t = t_kto.compute_reference_logprobs_kto(tparams, halves, tfwd, micro_batch_size=2)
    assert t.keys() == j.keys()
    assert ("reference_kl_logps" in t) == (kind == "kto_mismatched")
    for k in j:
        assert t[k].dtype == np.float32 and t[k].shape == (6,)
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def pref_cfg(tmp_path, strategy, data, exp, *, kl_estimator=None, precision="fp32",
             max_steps=3, every=0, val=None, lora=False, **over):
    blk = {"kl_beta": 0.2}
    if strategy == "kto":
        blk.update(desirable_weight=1.5, undesirable_weight=0.7)
        if kl_estimator:
            blk["kl_estimator"] = kl_estimator
    model = dict(MODEL, optim={"name": "adamw_fp32OptState", "lr": 1e-3, "weight_decay": 0.0,
                               "sched": {"name": "constant"}})
    if lora:
        model["lora"] = {"lora_rank": 4, "lora_alpha": 16, "target_modules": ["qkv_proj"]}
    cfg = {
        "name": "pref", "model_source": "hf", "seed": 5,
        "model_alignment_strategy": {strategy: blk},
        "trainer": {"max_steps": max_steps, "log_every_n_steps": 1},
        "exp_manager": {"exp_dir": str(tmp_path / exp), "create_tensorboard_logger": False,
                        "log_files": False, "resume_if_exists": True,
                        "telemetry": {"compile_census": False},
                        "checkpoint_callback_params": {"save_top_k": 1,
                                                       "every_n_train_steps": every}},
        "distributed_strategy": {"tensor_model_parallel_size": 1},
        "data": {"global_batch_size": 8, "micro_batch_size": 2, "seq_length": SEQ,
                 "train_dir": str(data), "val_dir": None if val is None else str(val),
                 "tokenizer": {"library": "char", "vocab_size": 512}},
        "model": model,
        "precision": {"type": precision},
    }
    for k, v in over.items():
        cfg[k] = {**cfg.get(k, {}), **v} if isinstance(v, dict) else v
    return cfg


def _data_for(tmp_path, strategy):
    recs = kto_records() if strategy == "kto" else pref_records()
    return _jsonl(tmp_path / f"{strategy}.jsonl", recs)


def jax_run(cfg, devices=1):
    jt = j_loop.Trainer.from_config(j_loader.load_config(cfg),
                                    devices=jax.devices()[:devices], enable_checkpointing=False)
    jparams = jax.tree_util.tree_map(np.asarray, jt.params)
    jt.fit()
    lines = [json.loads(x) for x in (jt.exp.log_dir / "metrics.jsonl").read_text().splitlines()]
    return jparams, [x for x in lines if "loss" in x]


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """``run(strategy, kl_estimator, devices) -> (weights, metric lines)`` of
    the JAX trainer, 3 steps on ``devices`` virtual devices (data parallel,
    ZeRO-1), each run once and shared by the trainer and the gloo tests."""
    root = tmp_path_factory.mktemp("jax_trainer")
    runs = {}

    def run(strategy, est=None, devices=1):
        key = (strategy, est, devices)
        if key not in runs:
            ds = {"tensor_model_parallel_size": 1, "sequence_parallel": False, "zero1": True}
            cfg = pref_cfg(root, strategy, _data_for(root, strategy),
                           f"{strategy}_{est}_{devices}", kl_estimator=est,
                           distributed_strategy=ds)
            runs[key] = jax_run(cfg, devices=devices)
        return runs[key]

    return run


def _port(cfg, jparams=None, **kw):
    t = t_loop.Trainer.from_config(t_loader.load_config(cfg), device="cpu", **kw)
    if jparams is not None:
        src = t_llama.named_params(params_from_jax(jparams, device="cpu"))
        with torch.no_grad():
            for n, p in t_llama.named_params(t.params).items():
                p.copy_(src[n])
        flat = t_llama.named_params(t.params)
        t.opt_state = init_opt_state({n: flat[n] for n in flat
                                      if t.trainable is None or n in t.trainable}, t.policy)
    return t


def assert_history_matches(history, lines, strategy):
    assert len(history) == len(lines) == 3
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in history], [x[k] for x in lines],
                                   rtol=TRAIN_RTOL, atol=0, err_msg=k)
    for k in METRICS[strategy]:
        np.testing.assert_allclose([h[k] for h in history], [x[k] for x in lines],
                                   rtol=METRIC_TOL[0], atol=METRIC_TOL[1], err_msg=k)


TRAINER_CASES = {"dpo": ("dpo", None), "orpo": ("orpo", None),
                 "kto_batch_mean": ("kto", "batch_mean"), "kto_mismatched": ("kto", "mismatched")}


@pytest.mark.parametrize("case", TRAINER_CASES)
def test_trainer_matches_jax(tmp_path, jax_trainer, case):
    """3 steps of each strategy through ``Trainer.from_config`` at one rank
    from the JAX trainer's weights: loss, grad norm and every reward metric
    per step.  DPO's and KTO's step 0 see policy = reference: DPO's loss is
    ln 2 and KTO's 0.5 x the mean class weight, with every reward 0."""
    strategy, est = TRAINER_CASES[case]
    data = _data_for(tmp_path, strategy)
    # DPO's loss and metrics are means over pairs, so the gloo test's JAX run
    # on 2 devices serves here too.  KTO's z0 is taken over each microbatch,
    # whose rows JAX groups otherwise at dp=2: a one-rank run meets a
    # one-device run.
    jparams, lines = jax_trainer(strategy, est, devices=2 if strategy == "dpo" else 1)
    t = _port(pref_cfg(tmp_path, strategy, data, "port", kl_estimator=est), jparams,
              enable_checkpointing=False)
    history = t.fit()
    assert_history_matches(history, lines, strategy)
    assert all("logits" not in h for h in history)
    if strategy == "dpo":
        assert abs(history[0]["loss"] - np.log(2)) < 1e-6
        assert history[0]["reward_margin"] == history[0]["rewards_chosen"] == 0.0
    if strategy == "kto":
        w = np.where(t.data_module.arrays["kto_labels"] > 0.5, 1.5, 0.7)
        assert history[0]["kto_kl"] == 0.0 and max(h["kto_kl"] for h in history) > 0
        assert 0.5 * w.min() <= history[0]["loss"] <= 0.5 * w.max()
    assert (t.reference is None) == (strategy == "orpo")


def _counting(trainer):
    """Count the rows the trainer's reference pass computes."""
    import dataclasses

    seen = []
    columns = trainer.reference.columns

    def counted(p, batch):
        seen.append(len(next(iter(batch.values()))))
        return columns(p, batch)

    trainer.reference = dataclasses.replace(trainer.reference, columns=counted)
    return seen


def test_dpo_resume_skips_the_pass_and_continues_bitwise(tmp_path, caplog):
    """A DPO run checkpointed at step 2 and resumed to step 4 reads the
    sidecar (no pass rows), keeps it beside retention (save_top_k 1), and
    equals a straight run bit for bit."""
    data = _data_for(tmp_path, "dpo")
    straight = _port(pref_cfg(tmp_path, "dpo", data, "a", max_steps=4, every=2))
    hs = straight.fit()
    first = _port(pref_cfg(tmp_path, "dpo", data, "b", max_steps=4, every=2))
    first.max_steps = 2
    rows = _counting(first)
    first.fit()
    assert sum(rows) == 24
    sidecar = Path(first.checkpointer.config.dir) / "dpo_reference_logps.npz"
    assert sidecar.exists()
    second = _port(pref_cfg(tmp_path, "dpo", data, "b", max_steps=4, every=2))
    rows = _counting(second)
    with caplog.at_level(logging.INFO, logger="nxdt.torch.train"):
        hr = second.fit()
    assert rows == [] and "reference logps restored" in caplog.text
    assert second.checkpointer.last_restore["step"] == 2
    assert [(r["loss"], r["grad_norm"], r["reward_margin"]) for r in hr] == [
        (r["loss"], r["grad_norm"], r["reward_margin"]) for r in hs[2:]]
    assert sidecar.exists() and second.checkpointer.committed_steps == [4]
    for k in ("reference_chosen_logps", "reference_rejected_logps"):
        np.testing.assert_array_equal(second.data_module.arrays[k],
                                      straight.data_module.arrays[k])


def test_reference_pass_resumes_at_its_cursor_and_recomputes_stale_sidecars(tmp_path, caplog):
    """A partial sidecar resumes at its cursor and gives the whole pass's
    columns bit for bit; a sidecar of another length, or of another column
    set (a batch_mean KTO sidecar under mismatched), is recomputed."""
    data = _data_for(tmp_path, "kto")
    whole = _port(pref_cfg(tmp_path, "kto", data, "whole", kl_estimator="mismatched"))
    whole.pre_fit()
    cols = {k: whole.data_module.arrays[k].copy()
            for k in ("reference_logps", "reference_kl_logps")}
    part = _port(pref_cfg(tmp_path, "kto", data, "part", kl_estimator="mismatched"))
    path = Path(part.checkpointer.config.dir) / "kto_reference_logps.npz"
    stale = {k: np.where(np.arange(24) < 10, v, np.nan).astype(np.float32)
             for k, v in cols.items()}
    t_loop._sidecar_store(str(path), 10, stale)
    rows = _counting(part)
    part.pre_fit()
    assert rows == [8, 6]  # batches of gbs 8 from the cursor: rows 10-17, 18-23
    for k, v in cols.items():
        np.testing.assert_array_equal(part.data_module.arrays[k], v)
    with np.load(path) as z:
        assert int(z["_done_upto"]) == 24
    for name, bad in (("short", {k: v[:20] for k, v in cols.items()}),
                      ("batch_mean", {"reference_logps": cols["reference_logps"]})):
        again = _port(pref_cfg(tmp_path, "kto", data, "part", kl_estimator="mismatched"))
        t_loop._sidecar_store(str(path), 24, bad)
        rows = _counting(again)
        with caplog.at_level(logging.WARNING, logger="nxdt.torch.train"):
            again.pre_fit()
        assert sum(rows) == 24, name
        assert "recomputing" in caplog.text
        caplog.clear()
        for k, v in cols.items():
            np.testing.assert_array_equal(again.data_module.arrays[k], v)


def test_a_jax_written_sidecar_is_read_by_the_port(tmp_path):
    data = _data_for(tmp_path, "dpo")
    t = _port(pref_cfg(tmp_path, "dpo", data, "x"))
    path = Path(t.checkpointer.config.dir) / "dpo_reference_logps.npz"
    cols = {"reference_chosen_logps": np.linspace(-90, -10, 24).astype(np.float32),
            "reference_rejected_logps": np.linspace(-80, -20, 24).astype(np.float32)}
    j_loop._sidecar_store(str(path), 24, cols)
    rows = _counting(t)
    t.pre_fit()
    assert rows == []
    for k, v in cols.items():
        np.testing.assert_array_equal(t.data_module.arrays[k], v)
    # and the port's sidecar is read by the JAX package
    t_loop._sidecar_store(str(path), 24, cols)
    done, back = j_loop._sidecar_load(str(path), "train")
    assert done == 24 and back.keys() == cols.keys()


def test_validation_runs_on_preference_batches(tmp_path):
    """The val module gets its own columns (and sidecar) and the validation
    loss is a DPO loss: ln 2 while the policy is the reference."""
    data = _data_for(tmp_path, "dpo")
    val = _jsonl(tmp_path / "val.jsonl", pref_records(16, seed=8))
    t = _port(pref_cfg(tmp_path, "dpo", data, "v", every=0, val=val,
                       trainer={"max_steps": 2, "val_check_interval": 1,
                                "limit_val_batches": 2}))
    history = t.fit()
    assert "reference_chosen_logps" in t.val_data_module.arrays
    assert (Path(t.checkpointer.config.dir) / "dpo_reference_logps_val.npz").exists()
    assert all(np.isfinite(h["val_loss"]) for h in history)
    assert abs(history[0]["val_loss"] - np.log(2)) < 0.05


def test_lora_reference_is_the_base(tmp_path):
    """With ``model.lora`` the reference comes from the base plus zero
    ``lora_b``, which is the base: the columns equal the LoRA-free run's."""
    data = _data_for(tmp_path, "dpo")
    base = _port(pref_cfg(tmp_path, "dpo", data, "base"), enable_checkpointing=False)
    lora = _port(pref_cfg(tmp_path, "dpo", data, "lora", lora=True),
                 enable_checkpointing=False)
    assert lora.trainable and len(lora.trainable) == 2 * 2
    base.pre_fit()
    lora.pre_fit()
    for k in ("reference_chosen_logps", "reference_rejected_logps"):
        np.testing.assert_array_equal(lora.data_module.arrays[k], base.data_module.arrays[k])


@pytest.mark.parametrize("config,strategy", [("hf_llama3_8B_DPO_config.yaml", "dpo"),
                                             ("hf_llama3_8B_ORPO_config.yaml", "orpo"),
                                             ("hf_llama3_8B_KTO_config.yaml", "kto")])
def test_cli_trains_the_alignment_configs_on_cpu_and_needs_the_card_otherwise(
        tmp_path, monkeypatch, config, strategy):
    data = _data_for(tmp_path, strategy)
    args = ["--config", str(CONF / config),
            "--set", "distributed_strategy.tensor_model_parallel_size=1",
            "--set", "distributed_strategy.sequence_parallel=false",
            "--set", "data.global_batch_size=4", "--set", f"data.seq_length={SEQ}",
            "--set", "trainer.max_steps=2", "--set", "trainer.log_every_n_steps=1",
            "--set", f"data.train_dir={data}", "--set", "data.tokenizer.library=char",
            "--set", f"exp_manager.exp_dir={tmp_path / 'exp'}"]
    for k, v in MODEL.items():
        args += ["--set", f"model.{k}={v}"]
    trainer, history = t_cli.run(args + ["--device", "cpu"])
    assert len(history) == 2
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in history)
    assert all(np.isfinite(r[k]) for r in history for k in METRICS[strategy])
    lines = [json.loads(x) for x in (trainer.exp.log_dir / "metrics.jsonl").read_text()
             .splitlines()]
    assert all(k in lines[-1] for k in METRICS[strategy])
    if strategy == "dpo":
        assert abs(history[0]["loss"] - np.log(2)) < 1e-6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.run(args)


# ---------------------------------------------------------------------------
# gloo: dp=2 with ZeRO-1 and tp=2 with SP
# ---------------------------------------------------------------------------


GLOO_CASES = {"dpo_dp2": ("dpo", 1, None), "kto_dp2": ("kto", 1, "batch_mean"),
              "dpo_tp2": ("dpo", 2, None)}


def test_dp2_zero1_and_tp2_sp_match_jax(tmp_path, jax_trainer):
    """One launch of 2 gloo ranks: DPO and KTO (batch_mean, ranks holding
    different desirable shares, so a per-rank z0 would show) at dp=2 with
    ZeRO-1, and DPO at tp=2 with SP, each 3 steps from the JAX trainer's
    weights against the JAX trainer on 2 virtual devices (GSPMD computes the
    same function at dp=2 and at tp=2, so the tp case is held to the dp
    run's numbers)."""
    from test_torch_dp import _port_weights, launch

    scenarios = []
    for case, (strategy, tp, est) in GLOO_CASES.items():
        data = _data_for(tmp_path, strategy)
        ds = {"tensor_model_parallel_size": tp, "sequence_parallel": tp > 1, "zero1": True}
        scenarios.append({"name": case, "steps": 3,
                          "cfg": pref_cfg(tmp_path, strategy, data, f"port_{case}",
                                          kl_estimator=est, distributed_strategy=ds),
                          "weights": str(_port_weights(jax_trainer(strategy, est, 2)[0],
                                                       tmp_path / f"{case}_w.pt"))})
    ranks = launch(tmp_path, scenarios)
    for case, (strategy, tp, est) in GLOO_CASES.items():
        h0, h1 = (r[case]["history"] for r in ranks)
        assert [(a["loss"], a["grad_norm"]) for a in h0] == [(b["loss"], b["grad_norm"])
                                                             for b in h1], case
        assert_history_matches(h0, jax_trainer(strategy, est, 2)[1], strategy)
        rows = [r[case]["rows"] for r in ranks]
        if tp == 1:
            assert rows[0] != rows[1], case  # the two data ranks hold different rows
        else:
            assert rows[0] == rows[1], case  # the tp ranks compute the same rows
        if strategy == "kto":
            des = [r[case]["kto_desirable"] for r in ranks]
            assert any(a != b for a, b in zip(np.ravel(des[0]), np.ravel(des[1])))
            assert max(h["kto_kl"] for h in h0) > 0
