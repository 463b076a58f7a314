"""The dense Llama configs at their own meshes, over gloo in CPU processes:
tp above the kv heads (each kv head replicated over tp/nkv ranks), a vocab tp
does not divide (each rank's slice padded to ``ceil(V/tp)`` rows), the
chunked head at tp 2 with SP, and DPO / ORPO / KTO under context
parallelism, each against the JAX trainer.

- 4 gloo ranks (one launch), the tiny model of ``tests/test_torch_dp.py``
  (4 heads, 2 kv heads: replication 2 at tp 4), tp 4 with SP:
  - at vocab 512 against the JAX trainer at tp 4 on 4 virtual devices, fp32;
  - at vocab 510 (510 % 4 = 2) in fp32 and ``mixed_precision`` against the
    JAX trainer on one device: its trainer places the embedding with a spec
    that must divide the vocab and refuses vocab 510 at tp 4 ("global size
    of its dimension 0 should be divisible by 4"), and GSPMD computes one
    function on every mesh;
  - every gradient at vocab 510 against the port at tp 1 (1e-5 relative);
  - a save at step 2 at vocab 510, restored at tp 1 here (params and moments
    bit for bit, saved shapes ``[V, h]`` and JAX's qkv segments) and at tp 2
    in the 2-rank launch;
  - DPO (ring) and KTO ``mismatched`` (ring) at dp x cp = 2 x 2 against the
    JAX trainer on 4 virtual devices.
- 2 gloo ranks (one launch):
  - the chunked head (``fusions.chunked_ce: 4``) at tp 2 with SP against the
    JAX trainer at tp 2;
  - DPO and ORPO at cp 2 with the ring against the JAX trainer at cp 2, and
    with Ulysses against the same run (JAX's Ulysses and ring compute one
    function: its ``test_ulysses.py``);
  - DPO's first gradients at cp 2 against the port at cp 1 (each counted
    once: the context sum's backward is the identity);
  - the reference sidecar written at cp 2 and read at cp 1 (no pass), and
    one written at cp 1 read at cp 2.
- ``check_supported`` on the shipped flagship and Llama-3.1-8B configs
  (tp 32 over 8 kv heads) as they are.

Tolerances: fp32 loss and grad norm rtol 1e-5 (the reward metrics 1e-4 /
1e-5, as ``test_torch_alignment.py``); ``mixed_precision`` loss 1e-4, grad
norm 2e-3.
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_alignment as TA
import test_torch_dp as DPT
import test_torch_tp as TPT
from neuronx_distributed_training_torch.alignment import losses as t_losses
from neuronx_distributed_training_torch.checkpoint import integrity as ck_integrity
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.optim.adamw import init_opt_state
from neuronx_distributed_training_torch.trainer import loop as t_loop

REPO = Path(__file__).resolve().parents[1]
PAD_VOCAB = 510


def tp4_cfg(tmp, exp, *, tp=4, vocab=PAD_VOCAB, precision="fp32", **kw):
    cfg = TPT.tp_cfg(tmp, exp, tp=tp, sp=tp > 1, precision=precision, **kw)
    cfg["model"]["vocab_size"] = vocab
    return cfg


def pref_cp_cfg(tmp, strategy, exp, *, fusion="ring_attention", cp=2, kl_estimator=None,
                every=0):
    ds = {"tensor_model_parallel_size": 1, "context_parallel_size": cp, "zero1": True}
    data = TA._data_for(tmp, strategy)
    return TA.pref_cfg(tmp, strategy, data, exp, kl_estimator=kl_estimator, every=every,
                       distributed_strategy=ds,
                       model={"fusions": {fusion: True} if cp > 1 else {}})


#: name: (vocab, precision, JAX devices)
TP4 = {"kv_rep": (512, "fp32", 4), "pad": (PAD_VOCAB, "fp32", 1),
       "pad_mixed": (PAD_VOCAB, "mixed_precision", 1)}
#: name: (strategy, kl_estimator)
PREF4 = {"dpo_dp2_cp2": ("dpo", None), "kto_mm_dp2_cp2": ("kto", "mismatched")}


def _mesh4_build(tmp: Path) -> dict:
    jts, scenarios = {}, []
    for name, (vocab, precision, devices) in TP4.items():
        jts[name], j0 = TPT._jax_start(tp4_cfg(tmp, f"jax_{name}", tp=devices, vocab=vocab,
                                               precision=precision), devices)
        scenarios.append({"name": name, "steps": 3, "dump": str(tmp / f"{name}.pt"),
                          "cfg": tp4_cfg(tmp, f"port_{name}", vocab=vocab, precision=precision),
                          "weights": str(TPT._global_weights(j0, tmp / f"{name}_w.pt"))})
    for name, (strategy, est) in PREF4.items():
        cfg = pref_cp_cfg(tmp, strategy, f"jax_{name}", kl_estimator=est)
        jts[name], j0 = TPT._jax_start(cfg, 4)
        scenarios.append({"name": name, "steps": 3,
                          "cfg": pref_cp_cfg(tmp, strategy, f"port_{name}", kl_estimator=est),
                          "weights": str(TPT._global_weights(j0, tmp / f"{name}_w.pt"))})
    scenarios += [
        {"name": "grads", "cfg": tp4_cfg(tmp, "grads"), "steps": 1, "max_steps": 1,
         "grads": str(tmp / "grads.pt")},
        {"name": "save", "cfg": tp4_cfg(tmp, "ck", every=2), "steps": 3, "max_steps": 2,
         "dump": str(tmp / "ck2.pt")},
    ]
    run = DPT.Launch(tmp, scenarios, nproc=4)
    jax_side = {}
    for name, jt in jts.items():
        j1, lines = TPT._jax_finish(jt)
        jax_side[name] = (None if name in PREF4 else j1, lines)
    return {"tmp": tmp, "jax": jax_side, "ranks": run.results()}


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    """The 4-rank launch, once a run (the JAX trainers fitted while the
    ranks run)."""
    return DPT.shared(tmp_path_factory, "mesh4", _mesh4_build)


def _assert_pref_matches(hist, lines, strategy):
    """``test_torch_alignment.py``'s bars, but DPO's ``reward_accuracy`` at
    step 0: there policy and reference agree, every margin is rounding
    noise (held to 1e-6), and ``chosen > rejected`` counts the noise's sign:
    JAX's sharded reference pass and train step round apart, the port's
    reference pass and its policy forward are one computation, so its
    margins are exactly 0."""
    assert len(hist) == len(lines) == 3
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in hist], [x[k] for x in lines],
                                   rtol=TA.TRAIN_RTOL, atol=0, err_msg=k)
    for k in TA.METRICS[strategy]:
        skip = 1 if k == "reward_accuracy" else 0
        np.testing.assert_allclose([h[k] for h in hist[skip:]], [x[k] for x in lines[skip:]],
                                   rtol=TA.METRIC_TOL[0], atol=TA.METRIC_TOL[1], err_msg=k)
    if strategy == "dpo":
        assert abs(hist[0]["loss"] - np.log(2)) < 1e-6
        assert abs(lines[0]["reward_margin"]) < 1e-6 and hist[0]["reward_margin"] == 0.0


@pytest.mark.parametrize("name", list(TP4))
def test_tp4_replicated_kv_and_padded_vocab_match_jax(mesh4, name):
    j1, lines = mesh4["jax"][name]
    ranks = [r[name] for r in mesh4["ranks"]]
    hist = [r["history"] for r in ranks]
    assert all([(h["loss"], h["grad_norm"]) for h in x] ==
               [(h["loss"], h["grad_norm"]) for h in hist[0]] for x in hist)
    dump = torch.load(mesh4["tmp"] / f"{name}.pt")
    TPT._assert_matches_jax(lines, hist[0], dump, j1, TP4[name][1])
    # the tp ranks computed the same rows; the merged leaves are JAX's
    assert all(r["rows"] == ranks[0]["rows"] for r in ranks)
    assert dump["params/embed.embedding"].shape[0] == TP4[name][0]
    assert dump["params/layers.0.attn.qkv.w"].shape == (64, (4 + 2 * 2) * 16)


def test_tp4_gradients_equal_tp1(mesh4):
    """Every gradient AdamW receives at tp 4 (kv heads replicated twice, the
    vocab padded to 4 x 128), merged, equals the port's at tp 1 within 1e-5
    relative, and the loss within rtol 1e-6: the kv heads' replicas summed
    over the ranks that share them, each counted once."""
    tmp = mesh4["tmp"]
    one = TPT._single(tp4_cfg(tmp, "grads_one", tp=1))
    want, loss = TPT._first_grads(one)
    got = torch.load(tmp / "grads.pt")
    hist = mesh4["ranks"][0]["grads"]["history"]
    assert np.isclose(hist[0]["loss"], loss, rtol=1e-6, atol=0)
    assert got.keys() == want.keys()
    assert got["layers.0.attn.qkv.w"].shape == want["layers.0.attn.qkv.w"].shape
    for n in got:
        rel = float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30))
        assert rel <= 1e-5, (n, rel)


def _tp1_from_save(mesh4) -> tuple:
    """The tp 4 save at step 2 restored at tp 1 in this process: ``(live
    state, step 3's record)``, computed once a process, in an exp dir of
    its own (the save's dir is shared by every xdist worker)."""
    if "tp1" not in mesh4:
        tmp, exp = mesh4["tmp"], f"one{os.getpid()}"
        ck = tmp / "ck" / "dp" / "version_0" / "checkpoints"
        shutil.copytree(ck / "2", tmp / exp / "dp" / "version_0" / "checkpoints" / "2")
        one = t_loop.Trainer.from_config(
            t_loader.load_config(tp4_cfg(tmp, exp, tp=1, every=2)), device="cpu")
        assert one.maybe_resume() and one.step == 2
        live = {f"params/{n}": t.clone() for n, t in t_llama.named_params(one.params).items()}
        live.update({f"{g}/{n}": t.clone() for g in ("mu", "nu")
                     for n, t in one.opt_state[g].items()})
        mesh4["tp1"] = (live, one.fit()[0])
    return mesh4["tp1"]


def test_tp4_save_keeps_global_shapes_and_restores_at_tp1(mesh4):
    tmp = mesh4["tmp"]
    assert mesh4["ranks"][0]["save"]["committed"] == [2]
    ck = tmp / "ck" / "dp" / "version_0" / "checkpoints"
    side = json.loads((ck / "2" / "integrity.json").read_text())
    tree = side["tree"]["params"]
    assert tree["embed.embedding"]["shape"] == [PAD_VOCAB, 64]
    assert tree["lm_head.w"]["shape"] == [64, PAD_VOCAB]
    assert tree["layers.0.attn.qkv.w:q"]["shape"] == [64, 64]
    assert tree["layers.0.attn.qkv.w:k"]["shape"] == [64, 32]  # 2 kv heads of 16
    assert tree["layers.0.attn.qkv.w:v"]["shape"] == [64, 32]
    # the last rank's vocab block is its 126 real rows; each kv head is
    # written once, though two ranks hold it
    emb = side["shards"]["params"]["embed.embedding"]
    assert [r["sizes"][0] for r in emb] == [128, 128, 128, 126]
    assert len(side["shards"]["params"]["layers.0.attn.qkv.w:k"]) == 2
    assert ck_integrity.verify_step(ck, 2).status == "ok"
    saved = torch.load(tmp / "ck2.pt")
    live, step3 = _tp1_from_save(mesh4)
    assert saved.keys() >= live.keys()
    assert all(torch.equal(saved[k], live[k]) for k in live), [
        k for k in live if not torch.equal(saved[k], live[k])]
    assert step3["step"] == 2 and np.isfinite(step3["loss"])


@pytest.mark.parametrize("name", list(PREF4))
def test_preference_at_dp2_cp2_matches_jax(mesh4, name):
    strategy, _ = PREF4[name]
    ranks = [r[name] for r in mesh4["ranks"]]
    hist = [r["history"] for r in ranks]
    assert all([(h["loss"], h["grad_norm"]) for h in x] ==
               [(h["loss"], h["grad_norm"]) for h in hist[0]] for x in hist)
    _assert_pref_matches(hist[0], mesh4["jax"][name][1], strategy)
    coords = [r["coords"] for r in ranks]
    assert coords == [{"dp": w // 2, "cp": w % 2, "tp": 0} for w in range(4)]
    rows = [r["rows"] for r in ranks]
    assert rows[0] == rows[1] and rows[2] == rows[3] and rows[0] != rows[2]
    # the pass: each data rank computed its half of the rows, on both of its
    # context ranks, and every rank holds the same columns
    assert all(r["reference_columns"] == ranks[0]["reference_columns"] for r in ranks)
    if strategy == "kto":
        assert max(h["kto_kl"] for h in hist[0]) > 0


# ---------------------------------------------------------------------------
# 2 ranks: the chunked head at tp 2, preference alignment at cp 2
# ---------------------------------------------------------------------------


#: name: (strategy, fusion, the JAX run it is held to)
PREF2 = {"dpo_ring": ("dpo", "ring_attention", "dpo_ring"),
         "dpo_ulysses": ("dpo", "ulysses_attention", "dpo_ring"),
         "orpo_ring": ("orpo", "ring_attention", "orpo_ring"),
         "orpo_ulysses": ("orpo", "ulysses_attention", "orpo_ring")}


def _ce_cfg(tmp, exp, tp=2):
    cfg = TPT.tp_cfg(tmp, exp, tp=tp, sp=tp > 1)
    cfg["model"]["fusions"] = {"chunked_ce": 4}
    return cfg


@pytest.fixture(scope="module")
def mesh2(tmp_path_factory, mesh4):
    """The 2-rank launch, once a run (the JAX trainers fitted while the
    ranks run)."""
    return DPT.shared(tmp_path_factory, "mesh2", lambda tmp: _mesh2_build(tmp, mesh4))


def _mesh2_build(tmp: Path, mesh4: dict) -> dict:
    jts, scenarios = {}, []
    jts["ce_tp2"], j0 = TPT._jax_start(_ce_cfg(tmp, "jax_ce"), 2)
    scenarios.append({"name": "ce_tp2", "steps": 3, "dump": str(tmp / "ce_tp2.pt"),
                      "cfg": _ce_cfg(tmp, "port_ce"),
                      "weights": str(TPT._global_weights(j0, tmp / "ce_w.pt"))})
    weights = {}
    for name, (strategy, fusion, ref) in PREF2.items():
        if ref == name:
            jts[name], j0 = TPT._jax_start(
                pref_cp_cfg(tmp, strategy, f"jax_{name}", fusion=fusion), 2)
            weights[strategy] = str(TPT._global_weights(j0, tmp / f"{strategy}_w.pt"))
        scenarios.append({"name": name, "steps": 3, "weights": weights[strategy],
                          "cfg": pref_cp_cfg(tmp, strategy, f"port_{name}", fusion=fusion,
                                             every=3 if name == "dpo_ring" else 0)})
    # a sidecar written at cp 1 (one process, the cp 2 runs' weights), read at cp 2
    solo = t_loop.Trainer.from_config(
        t_loader.load_config(pref_cp_cfg(tmp, "dpo", "solo", cp=1, every=3)), device="cpu")
    src = torch.load(weights["dpo"])
    with torch.no_grad():
        for n, p in t_llama.named_params(solo.params).items():
            p.copy_(src[n])
    solo.opt_state = init_opt_state(t_llama.named_params(solo.params), solo.policy,
                                    health=solo.health.enabled)
    solo.max_steps = 1
    solo.fit()
    shutil.copytree(tmp / "solo", tmp / "solo_cp2")
    shutil.copytree(mesh4["tmp"] / "ck", tmp / "from4")
    scenarios += [
        {"name": "dpo_grads", "steps": 1, "max_steps": 1, "weights": weights["dpo"],
         "cfg": pref_cp_cfg(tmp, "dpo", "grads"), "grads": str(tmp / "dpo_grads.pt")},
        {"name": "sidecar_from_cp1", "steps": 3, "max_steps": 1,
         "cfg": pref_cp_cfg(tmp, "dpo", "solo_cp2", every=3)},
        {"name": "from_tp4", "steps": 3, "cfg": tp4_cfg(tmp, "from4", tp=2, every=2)},
    ]
    run = DPT.Launch(tmp, scenarios, nproc=2)
    jax_side = {}
    for name, jt in jts.items():
        j1, lines = TPT._jax_finish(jt)
        jax_side[name] = (None if name in PREF2 else j1, lines)
    solo_arrays = {k: np.asarray(v) for k, v in solo.data_module.arrays.items()}
    return {"tmp": tmp, "jax": jax_side, "ranks": run.results(), "solo_arrays": solo_arrays,
            "weights": weights}


def test_chunked_ce_at_tp2_sp_matches_jax(mesh2):
    j1, lines = mesh2["jax"]["ce_tp2"]
    h0, h1 = (r["ce_tp2"]["history"] for r in mesh2["ranks"])
    assert [(a["loss"], a["grad_norm"]) for a in h0] == [(b["loss"], b["grad_norm"]) for b in h1]
    dump = torch.load(mesh2["tmp"] / "ce_tp2.pt")
    TPT._assert_matches_jax(lines, h0, dump, j1, "fp32")


@pytest.mark.parametrize("name", list(PREF2))
def test_preference_at_cp2_matches_jax(mesh2, name):
    strategy, _, ref = PREF2[name]
    h0, h1 = (r[name]["history"] for r in mesh2["ranks"])
    assert [(a["loss"], a["grad_norm"]) for a in h0] == [(b["loss"], b["grad_norm"]) for b in h1]
    _assert_pref_matches(h0, mesh2["jax"][ref][1], strategy)
    r0, r1 = (r[name] for r in mesh2["ranks"])
    assert r0["rows"] == r1["rows"] and r0["coords"]["cp"] == 0 and r1["coords"]["cp"] == 1
    if strategy == "dpo":
        # the pass ran on both context ranks, over every row, and both hold
        # the same columns
        assert r0["reference_rows"] == r1["reference_rows"] == 24
        assert r0["reference_columns"] == r1["reference_columns"]


def test_dpo_gradients_at_cp2_are_counted_once(mesh2):
    """DPO's first gradients at cp 2 (ring), merged, against the port at
    cp 1 from the same weights: within 1e-5 relative.  The sequence
    log-probs' context sum is the identity in backward, so each context
    rank's gradient reaches its own tokens and the step's SUM over
    ``(data, context)`` counts each once; an all-reduce there would double
    every gradient (:func:`test_context_sum_backward_is_the_identity`)."""
    tmp = mesh2["tmp"]
    one = TPT._single(pref_cp_cfg(tmp, "dpo", "grads_one", cp=1),
                      torch.load(mesh2["weights"]["dpo"]))
    want, loss = TPT._first_grads(one)
    got = torch.load(tmp / "dpo_grads.pt")
    assert np.isclose(mesh2["ranks"][0]["dpo_grads"]["history"][0]["loss"], loss, rtol=1e-6)
    assert got.keys() == want.keys()
    for n in got:
        rel = float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30))
        assert rel <= 1e-5, (n, rel)


def test_context_sum_backward_is_the_identity():
    """``sequence_logprobs`` under cp: the forward sums the ranks' partial
    row sums, the backward hands each rank its own tokens' gradient
    unscaled (two ranks, one process, a stand-in context group)."""

    class FakeCP:
        size, rank = 2, 0

        def __init__(self, other):
            self.other = other

        def sum_context(self, t):
            return t + self.other

    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 6, 8, generator=gen, requires_grad=True)
    labels = torch.randint(0, 8, (2, 6), generator=gen)
    other = torch.randn(2, generator=gen)
    got = t_losses.sequence_logprobs(logits, labels, shift=False, cp=FakeCP(other))
    local = t_losses.sequence_logprobs(logits, labels, shift=False)
    assert torch.equal(got.detach(), local.detach() + other)
    (g,) = torch.autograd.grad(got.sum(), logits)
    (w,) = torch.autograd.grad(local.sum(), logits)
    assert torch.equal(g, w)
    loss = torch.tensor(1.5, requires_grad=True)
    once = t_losses.count_once(loss * 2, type("CP", (), {"size": 2, "rank": 1})())
    assert once.item() == 0.0
    once.backward()
    assert float(loss.grad) == 2.0


def test_sidecar_written_at_cp2_is_read_at_cp1_and_back(mesh2):
    tmp = mesh2["tmp"]
    r0 = mesh2["ranks"][0]
    # cp 1 -> cp 2: the cp 2 run computed no row and holds cp 1's columns
    solo_cols = {k: mesh2["solo_arrays"][k].tolist()
                 for k in ("reference_chosen_logps", "reference_rejected_logps")}
    for r in mesh2["ranks"]:
        assert r["sidecar_from_cp1"]["reference_rows"] == 0
        assert r["sidecar_from_cp1"]["reference_columns"] == solo_cols
    # cp 2 -> cp 1: a one-process trainer on the cp 2 run's exp dir reads
    # its sidecar, with no pass, and its columns are cp 2's
    cp2_cols = r0["dpo_ring"]["reference_columns"]
    ck = next((tmp / "port_dpo_ring").glob("*/version_0/checkpoints"))
    assert (ck / "dpo_reference_logps.npz").exists()
    dst = tmp / "back" / ck.relative_to(tmp / "port_dpo_ring")
    shutil.copytree(ck, dst)
    back = t_loop.Trainer.from_config(
        t_loader.load_config(pref_cp_cfg(tmp, "dpo", "back", cp=1, every=3)), device="cpu")
    rows = []
    original = back._reference_rows
    back._reference_rows = lambda b, m, n: rows.append(m) or original(b, m, n)
    back.pre_fit()
    assert not rows
    assert {k: back.data_module.arrays[k].tolist() for k in cp2_cols} == cp2_cols
    # and cp 1's own pass gives the same columns within fp32 rounding
    for k, v in cp2_cols.items():
        np.testing.assert_allclose(v, solo_cols[k], rtol=1e-5, atol=1e-5)


def test_tp4_save_restores_at_tp2(mesh2, mesh4):
    """The tp 4 save at step 2 (vocab 510: 128-row slices at tp 4, 255 at
    tp 2; kv heads replicated at tp 4, one a rank at tp 2) trains step 3 at
    tp 2 as at tp 1."""
    _, step3 = _tp1_from_save(mesh4)
    h = mesh2["ranks"][0]["from_tp4"]["history"]
    assert [x["step"] for x in h] == [2]
    assert np.isclose(h[0]["loss"], step3["loss"], rtol=1e-6, atol=0)
    assert np.isclose(h[0]["grad_norm"], step3["grad_norm"], rtol=1e-5, atol=0)


@pytest.mark.parametrize("config", ["hf_mixtral_8x7b_config.yaml",
                                    "hf_mixtral_8x7b_dropped_config.yaml"])
def test_shipped_mixtral_configs_are_refused_naming_moe(config):
    """An hf Mixtral config passes ``check_supported`` as shipped (entry 10
    is ported), at its mesh: tp 8 (SP) over its 8 kv heads x ep 4, its 8
    experts 2 a rank, a Mixtral model whose one-process trainer asks for
    torchrun."""
    cfg = t_loader.load_config(REPO / "examples" / "conf" / config)
    ds = cfg.distributed_strategy
    assert (ds.tensor_model_parallel_size, ds.expert_model_parallel_size) == (8, 4)
    assert ds.sequence_parallel and cfg.model.num_key_value_heads == 8
    t_loop.check_supported(cfg)
    mc = t_loop.model_config(cfg)
    assert type(mc).__name__ == "MixtralConfig" and mc.moe.num_experts % 4 == 0
    assert mc.moe.dropless == (config == "hf_mixtral_8x7b_config.yaml")
    with pytest.raises(ValueError, match="needs 8 processes: launch under torchrun"):
        t_loop.Trainer.from_config(cfg, device="cpu")


@pytest.mark.parametrize("config", ["hf_llama3_8B_config.yaml", "hf_llama3.1_8B_config.yaml",
                                    "hf_llama3_70B_config.yaml", "hf_llama3.1_70B_config.yaml"])
def test_shipped_dense_configs_pass_check_supported(config):
    """The flagship, Llama-3.1-8B and the two 70B configs (pp 8, ``schedule:
    1f1b``), tp 32 over 8 kv heads, as shipped: each kv head replicated over
    4 ranks."""
    cfg = t_loader.load_config(REPO / "examples" / "conf" / config)
    ds = cfg.distributed_strategy
    assert ds.tensor_model_parallel_size == 32 and cfg.model.num_key_value_heads == 8
    t_loop.check_supported(cfg)
