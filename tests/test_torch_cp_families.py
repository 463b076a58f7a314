"""The trainer's last combinations against the JAX trainer, on the CPU: GPT
under context parallelism, the dropped (capacity-factor) MoE path under
context parallelism, expert parallelism with tp above the kv heads, and
(read by ``tests/test_torch_lora_families.py``) LoRA on Mixtral and on GPT
under tp, ep and dp.

- the dropped path's token order (``parallel/mesh.py::tokens_in_order`` /
  ``own_tokens``): four simulated ranks at dp 2 x cp 2, each holding its
  rows' context chunk, rebuild the whole microbatch's expert indices in
  JAX's order (row after row, chunk 0 first), so each rank's
  ``moe_dropped`` output equals its tokens of JAX's ``moe_block`` on the
  whole microbatch at a binding capacity, with and without
  ``token_shuffle_group_size``, and its keep mask is the whole
  microbatch's, which the per-rank rule is not;
- GPT's dropout under cp: a context rank's masks are its slice of the one
  global mask (``utils/prng.py``), at cp 2 with and without SP;
- ``context_parallel_batch`` carries a GPT's tokentype ids with the chunk;
- ``check_supported`` accepts the four combinations;
- one 4-rank gloo launch (``tests/_torch_dp_worker.py``), built once a run
  for every xdist worker (``test_torch_dp.py::shared``, ``::Launch``), its
  JAX references fitting on one virtual device while the ranks run, each
  with the same microbatches (the router loss is a product of means over a
  microbatch): GPT at dp 2 x cp 2 (ring; learned positions, biased gelu)
  and at cp 2 x tp 2 (SP; rope on half of each head, a window, swiglu,
  untied head), the dropped Mixtral at dp 2 x cp 2 under the ring and
  under Ulysses (cf 0.5 binds, the stride shuffle on; GPT-MoE's dropped
  path at dp 2 x cp 2 against one process), Mixtral at ep 2 x
  tp 2 over one kv head (SP), each 3 steps against the JAX trainer: loss,
  grad norm (and the router and LM losses), fp32 rtol 1e-5, and every param
  at ``test_torch_step.py``'s bar; GPT with dropout 0.1 at dp 2 x cp 2
  against one process at cp 1 from the same weights (the same masks, so
  the same losses at rtol 1e-5), and at pp 2 x cp 2 against pp 2 x dp 2;
  the ep 2 x tp 2 run saved at step 2,
  restored at tp 1 (dp 2 x ep 2) bit for bit and resumed at ep 2 x tp 2 bit
  for bit against the straight run; and LoRA's three meshes (Mixtral at tp
  2 x ep 2 and at dp 2 x ep 2 with ZeRO-1, GPT at tp 2 x dp 2).
"""

import concurrent.futures
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dp as DPT
import test_torch_pipeline as PPT
import test_torch_tp as TPT
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.data.loader import context_parallel_batch
from neuronx_distributed_training_torch.models import gpt as t_gpt
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.ops import moe as t_moe
from neuronx_distributed_training_torch.parallel import mesh as t_mesh
from neuronx_distributed_training_torch.tools.checkpoint_converter import unflatten
from neuronx_distributed_training_torch.tools.convert import params_from_jax, params_to_jax
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.utils import prng
from neuronx_distributed_training_tpu.ops import moe as j_moe

REPO = Path(__file__).resolve().parents[1]
CONF = REPO / "examples" / "conf"
#: seconds each rank of the launch may take (beside a loaded xdist run)
LAUNCH_TIMEOUT = 600
RTOL = 1e-5


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def gpt_cfg(tmp, exp, *, tp=1, cp=1, pp=1, mbs=2, every=0, **model):
    """A tiny GPT (hidden 64, 4 / 2 heads, seq 32) under ``DPT.dp_cfg``'s
    trainer settings; ``model`` overrides the model block."""
    cfg = DPT.dp_cfg(tmp, exp, every=every, data={"micro_batch_size": mbs})
    cfg["model_source"] = "megatron"
    cfg["distributed_strategy"].update(tensor_model_parallel_size=tp, sequence_parallel=tp > 1,
                                       context_parallel_size=cp,
                                       pipeline_model_parallel_size=pp)
    cfg["model"] = {"architecture": "gpt", "vocab_size": 96, "hidden_size": 64,
                    "ffn_hidden_size": 128, "num_layers": 2, "num_attention_heads": 4,
                    "num_query_groups": 2, "max_position_embeddings": 32,
                    "optim": cfg["model"]["optim"], **model}
    if cp > 1:
        cfg["model"]["fusions"] = {"ring_attention": True}
    return cfg


def mx_cfg(tmp, exp, *, tp=1, cp=1, ep=1, mbs=2, every=0, fusion="ring_attention", moe=None,
           **model):
    """A tiny Mixtral (hidden 64, ffn 96, 4 experts top 2, seq 32)."""
    cfg = DPT.dp_cfg(tmp, exp, every=every, data={"micro_batch_size": mbs})
    cfg["distributed_strategy"].update(tensor_model_parallel_size=tp, sequence_parallel=tp > 1,
                                       context_parallel_size=cp,
                                       expert_model_parallel_size=ep)
    block = {"num_experts": 4, "top_k": 2, "dropless": True, "router_aux_loss_coef": 0.02}
    cfg["model"].update(architecture="mixtral", intermediate_size=96, sliding_window=24,
                        moe={**block, **(moe or {})}, **model)
    if cp > 1:
        cfg["model"]["fusions"] = {fusion: True}
    return cfg


#: the dropped path: cf 0.5 binds (half the routes of a skew-free load)
DROPPED = {"dropless": False, "capacity_factor": 0.5, "token_shuffle_group_size": 4}
#: the adapters of the LoRA cases (rank 4; Mixtral's default targets, GPT's
#: default ones and its glu ``up`` and untied head)
LORA = {"lora_rank": 4, "lora_alpha": 16}
GPT_LORA_TARGETS = ["qkv_proj", "o_proj", "up_proj", "down_proj", "lm_head"]
GPT_CP_ROPE = {"rotary_percentage": 0.5, "sliding_window": 24, "activation": "swiglu",
               "share_embeddings_and_output_weights": False}
GPT_LORA_MODEL = {"activation": "swiglu", "position_embedding_type": "learned_absolute",
                  "share_embeddings_and_output_weights": False,
                  "lora": {**LORA, "target_modules": GPT_LORA_TARGETS}}

#: name -> (JAX reference, port config at 4 ranks): the JAX trainer on one
#: device at the port's microbatch (its ``micro_batch_size`` times the
#: data ranks')
CASES = {
    "gpt_cp_rope": (lambda t, e: gpt_cfg(t, e, mbs=4, **GPT_CP_ROPE),
                    lambda t, e: gpt_cfg(t, e, cp=2, **GPT_CP_ROPE)),
    "mx_dropped_ring": (lambda t, e: mx_cfg(t, e, mbs=4, moe=DROPPED, num_key_value_heads=1),
                        lambda t, e: mx_cfg(t, e, cp=2, moe=DROPPED, num_key_value_heads=1)),
    "lora_mx": (lambda t, e: mx_cfg(t, e, mbs=8, lora=LORA),
                lambda t, e: mx_cfg(t, e, tp=2, ep=2, mbs=4, lora=LORA)),
    "lora_gpt": (lambda t, e: gpt_cfg(t, e, mbs=4, **GPT_LORA_MODEL),
                 lambda t, e: gpt_cfg(t, e, cp=2, tp=2, mbs=4, **GPT_LORA_MODEL)),
}
#: port scenarios that share a case's JAX reference and weights
SAME_AS = {
    "mx_dropped_ulysses": ("mx_dropped_ring",
                           lambda t, e: mx_cfg(t, e, cp=2, moe=DROPPED, num_key_value_heads=1,
                                               fusion="ulysses_attention")),
    "mx_ep_tp_kv": ("mx_dropped_ring",
                    lambda t, e: mx_cfg(t, e, tp=2, ep=2, moe=DROPPED, num_key_value_heads=1)),
    "lora_mx_dp2_ep2": ("lora_mx", lambda t, e: mx_cfg(t, e, ep=2, lora=LORA)),
    "gpt_cp_dropout": ("gpt_cp_rope",
                       lambda t, e: gpt_cfg(t, e, cp=2, hidden_dropout=0.1, **GPT_CP_ROPE)),
}
#: GPT-MoE on the dropped path (every layer MoE), at dp 2 x cp 2 and at one
#: process with the same microbatches: the port against itself (GPT-MoE's
#: dropped forward is held to JAX's in ``test_torch_gpt.py``)
GPT_MOE = {"moe": {"num_experts": 4, "top_k": 2, **DROPPED}}


def _kv_cfg(tmp, *, tp):
    """The ep 2 x tp 2 case's model saving at step 2, at ``tp`` (tp 1 is
    dp 2 x ep 2 on the same 4 ranks)."""
    return mx_cfg(tmp, "kv_ck", tp=tp, ep=2, every=2, moe=DROPPED, num_key_value_heads=1)


# ---------------------------------------------------------------------------
# the launch, once a run
# ---------------------------------------------------------------------------


def _jax_fit(cfg, weights: str) -> tuple:
    """The JAX trainer of ``cfg`` on one device from ``weights`` (the port's
    global leaves): ``(final params, metric lines)``."""
    jt, _ = PPT._jax_start(cfg, 1)
    tree = params_to_jax(unflatten(torch.load(weights)))
    jt.params = jax.tree_util.tree_map(
        lambda ref, a: jax.device_put(np.asarray(a, ref.dtype), ref.sharding), jt.params, tree)
    return PPT._jax_finish(jt)


def _build(tmp: Path) -> dict:
    """Each case's weights come from the port at one process (its
    reference config); the 4-rank launch starts from them at once, and the
    JAX trainers fit from them while it runs, as do the one-process port
    runs the tests hold to JAX (LoRA's, and GPT's dropout at cp 1)."""
    weights, scenarios, singles = {}, [], {}

    def start(name, cfg):
        singles[name] = TPT._single(cfg)
        flat = t_llama.named_params(singles[name].params)
        weights[name] = str(tmp / f"{name}_w.pt")
        torch.save({n: t.detach().clone() for n, t in flat.items()}, weights[name])

    for name, (ref_cfg, port_cfg) in CASES.items():
        start(name, ref_cfg(tmp, f"one_{name}"))
        scenarios.append({"name": name, "cfg": port_cfg(tmp, f"port_{name}"), "steps": 3,
                          "weights": weights[name], "dump": str(tmp / f"{name}.pt")})
    for name, (case, port_cfg) in SAME_AS.items():
        scenarios.append({"name": name, "cfg": port_cfg(tmp, f"port_{name}"), "steps": 3,
                          "weights": weights[case], "dump": str(tmp / f"{name}.pt")})
    # GPT's dropout under pp: at pp 2 x cp 2 each context rank draws its
    # slice of pp 2 x dp 2's masks (the pipeline splits the key per microbatch)
    for name, kw in (("gpt_pp2_cp2_dropout", {"cp": 2, "mbs": 2}),
                     ("gpt_pp2_dp2_dropout", {"mbs": 1})):
        scenarios.append({"name": name, "steps": 3, "weights": weights["gpt_cp_rope"],
                          "cfg": gpt_cfg(tmp, f"port_{name}", pp=2, hidden_dropout=0.1,
                                         **kw, **GPT_CP_ROPE)})
    start("gpt_moe", gpt_cfg(tmp, "one_gpt_moe", mbs=4, **GPT_MOE))
    scenarios.append({"name": "gpt_moe_dropped_cp", "cfg": gpt_cfg(tmp, "port_gpt_moe", cp=2,
                                                                   **GPT_MOE),
                      "steps": 3, "weights": weights["gpt_moe"]})
    scenarios += [
        {"name": "kv_pre", "cfg": _kv_cfg(tmp, tp=2), "steps": 3, "max_steps": 2,
         "weights": weights["mx_dropped_ring"], "dump": str(tmp / "kv_pre.pt")},
        {"name": "kv_at_tp1", "cfg": _kv_cfg(tmp, tp=1), "steps": 3, "max_steps": 2,
         "dump": str(tmp / "kv_at_tp1.pt")},
        {"name": "kv_resume", "cfg": _kv_cfg(tmp, tp=2), "steps": 3,
         "dump": str(tmp / "kv_resume.pt")},
    ]
    run = DPT.Launch(tmp, scenarios, nproc=4, timeout=LAUNCH_TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
        fitted = {name: pool.submit(_jax_fit, ref_cfg(tmp, f"jax_{name}"), weights[name])
                  for name, (ref_cfg, _) in CASES.items()}
        dropout = TPT._single(gpt_cfg(tmp, "one_dropout", mbs=4, hidden_dropout=0.1,
                                      **GPT_CP_ROPE), torch.load(weights["gpt_cp_rope"]))
        one = {"gpt_cp_dropout": dropout.fit(), "gpt_moe": singles["gpt_moe"].fit()}
        for name in ("lora_mx", "lora_gpt"):
            one[name] = singles[name].fit()
            one[name + "_frozen"] = _frozen_equal(singles[name], weights[name])
        fitted = {name: f.result() for name, f in fitted.items()}
    ranks = run.results()
    names = list(CASES) + list(SAME_AS) + ["kv_pre", "kv_at_tp1", "kv_resume"]
    return {"tmp": tmp, "weights": weights, "jax": fitted, "ranks": ranks, "one": one,
            "dumps": {k: torch.load(tmp / f"{k}.pt") for k in names}}


def _frozen_equal(trainer, weights: str) -> list:
    """The frozen leaves of a fitted LoRA trainer that moved from
    ``weights`` (none should), and the optimizer's leaves."""
    start = torch.load(weights)
    flat = t_llama.named_params(trainer.params)
    moved = [n for n, t in flat.items() if n not in trainer.trainable
             and not torch.equal(t, start[n])]
    return [moved, sorted(trainer.opt_state["mu"]), sorted(trainer.trainable)]


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    return DPT.shared(tmp_path_factory, "families", _build)


def same_history(got: list, want: list, keys=("loss", "grad_norm"), rtol: float = RTOL):
    assert [r["step"] for r in got] == [0, 1, 2]
    for g, w in zip(got, want):
        for k in keys:
            assert np.isclose(g[k], w[k], rtol=rtol, atol=0), (k, g[k], w[k])


#: the q and k widths of the tiny GPT's ``qkv`` (4 heads and 2 kv heads of 16)
GPT_Q, GPT_K = 64, 32


def params_bar(dump: dict, jparams, start: dict) -> None:
    """``test_torch_step.py``'s fp32 bar (``test_torch_dp.py::
    _assert_params_bar``) on every trained leaf, and a frozen one (LoRA's
    base) bit for bit as it started.  The k part of a GPT ``qkv.bias`` is
    held to the bar's bound alone: its gradient is zero in exact arithmetic
    (softmax is shift invariant), so AdamW moves each entry by about ``lr``
    in the direction of each package's rounding noise."""
    ref = t_llama.named_params(params_from_jax(jparams, device="cpu"))
    lora = any(n.endswith("lora_a") for n in ref)
    for n, j in ref.items():
        got = dump[f"params/{n}"].float()
        if lora and not n.endswith(("lora_a", "lora_b")):
            assert torch.equal(got, start[n].float()), n
            continue
        d = (got - j.float()).abs()
        assert float(d.max()) <= 2 * DPT.LR * 3, (n, float(d.max()))
        if n.endswith("attn.qkv.bias"):
            d = torch.cat([d[:GPT_Q], d[GPT_Q + GPT_K:]])
        assert float((d > 1e-6).float().mean()) <= 1e-2, n


def matches_jax(families, name: str, case: str = None, keys=("loss", "grad_norm")):
    """A scenario's history (every rank the same) and final params against
    its case's JAX trainer."""
    case = case or name
    jparams, lines = families["jax"][case]
    ranks = [r[name] for r in families["ranks"]]
    same_history(ranks[0]["history"], lines, keys)
    for r in ranks[1:]:
        assert [h["loss"] for h in r["history"]] == [h["loss"] for h in ranks[0]["history"]]
    params_bar(families["dumps"][name], jparams, torch.load(families["weights"][case]))
    return ranks


# ---------------------------------------------------------------------------
# the dropped path's token order at dp 2 x cp 2
# ---------------------------------------------------------------------------


class _Ranks:
    """Rank ``rank`` of a simulated ``(data, context)`` token group whose
    gather hands back every rank's indices (``every``, in group order)."""

    def __init__(self, rank, every, context):
        self.token_rank, self.token_size, self.every = rank, len(every), every
        self.context = context

    def gather_tokens(self, idx, rows=1):
        assert torch.equal(idx, self.every[self.token_rank])
        return t_mesh.tokens_in_order(torch.cat(self.every), self.token_size, self.context,
                                      rows)

    def own_tokens(self, full, rows=1):
        return t_mesh.own_tokens(full, self.token_rank, self.token_size, self.context, rows)


@pytest.mark.parametrize("shuffle", [0, 4])
def test_dropped_keep_at_cp2_dp2_is_the_whole_microbatchs(shuffle):
    """dp 2 x cp 2: 2 rows a data rank, 2 chunks of 8 positions a row, a
    capacity that binds (cf 0.75) and the later rows skewed to one expert:
    each of the 4 ranks' ``moe_block`` output equals its rows and positions
    of JAX's ``moe_block`` on the whole [4, 16] microbatch (fp32), so its
    keep decisions are JAX's; the rebuilt order is the whole microbatch's
    token order, and the ranks' own keep masks are slices of the whole
    one's, which per rank they would not be."""
    h, e, ffn = 16, 4, 24
    jc = j_moe.MoEConfig(num_experts=e, top_k=2, dropless=False, capacity_factor=0.75,
                         token_shuffle_group_size=shuffle)
    tc = t_moe.MoEConfig(num_experts=e, top_k=2, dropless=False, capacity_factor=0.75,
                         token_shuffle_group_size=shuffle)
    rng = np.random.default_rng(3)
    router = rng.normal(0, 1, (h, e)).astype(np.float32)
    gate_up = rng.normal(0, 0.1, (e, h, 2 * ffn)).astype(np.float32)
    down = rng.normal(0, 0.1, (e, ffn, h)).astype(np.float32)
    x = rng.normal(0, 1, (4, 16, h)).astype(np.float32)
    x[2:] += 1.5 * router[:, 0] / np.linalg.norm(router[:, 0])  # skew rows 2-3 to expert 0
    want, jaux = j_moe.moe_block({"router": {"w": jnp.asarray(router)},
                                  "experts": {"gate_up": jnp.asarray(gate_up),
                                              "down": jnp.asarray(down)}},
                                 jnp.asarray(x), jc, compute_dtype=jnp.float32)
    want = np.asarray(want)
    params = {"router": {"w": torch.tensor(router)},
              "experts": {"gate_up": torch.tensor(gate_up), "down": torch.tensor(down)}}
    # group order (data, context): rank 2 d + c holds rows 2d..2d+1, chunk c
    parts = [torch.tensor(x[2 * d:2 * d + 2, 8 * c:8 * c + 8]) for d in range(2)
             for c in range(2)]
    idx = [t_moe.route(params["router"], p.reshape(-1, h), tc)[1] for p in parts]
    ordered = t_mesh.tokens_in_order(torch.cat(idx), 4, 2, 2)
    np.testing.assert_array_equal(ordered.numpy(), np.asarray(jaux["expert_idx"]))
    full = t_moe.keep_mask(ordered, tc)
    differs = 0
    for r, p in enumerate(parts):
        y, aux = t_moe.moe_block(params, p, tc, compute_dtype=torch.float32,
                                 tokens=_Ranks(r, idx, 2))
        d, c = divmod(r, 2)
        np.testing.assert_allclose(y.numpy(), want[2 * d:2 * d + 2, 8 * c:8 * c + 8],
                                   rtol=2e-5, atol=1e-7)
        mine = t_mesh.own_tokens(full, r, 4, 2, 2)
        assert torch.equal(mine.reshape(2, 8, 2),
                           full.reshape(2, 2, 2, 8, 2)[d, :, c]), r
        differs += int((mine != t_moe.keep_mask(aux["expert_idx"], tc)).sum())
    assert differs > 0


# ---------------------------------------------------------------------------
# GPT under cp: the dropout masks, the chunk's arrays, the config rules
# ---------------------------------------------------------------------------


class _Axis:
    """The rank and size of a parallel axis (what ``_seq_slice`` reads)."""

    def __init__(self, rank, size, sequence_parallel=True):
        self.rank, self.size, self.sequence_parallel = rank, size, sequence_parallel


@pytest.mark.parametrize("tp", [1, 2])
def test_gpt_dropout_under_cp_is_a_slice_of_the_global_mask(tp):
    """At cp 2 (and under SP at tp 2 inside each chunk, JAX's ``seq_axes``:
    context before model) each rank's embedding and residual dropout masks
    are its positions of cp 1's masks, bit for bit."""
    key = prng.step_key(3).fold(prng.LAYER_TAG, 1).with_rows([4, 5])
    whole = t_gpt._dropout(torch.ones(2, 16, 8), 0.3, key, None)
    n = 16 // (2 * tp)
    for c in range(2):
        for r in range(tp):
            tpa = _Axis(r, tp) if tp > 1 else None
            got = t_gpt._dropout(torch.ones(2, n, 8), 0.3, key, tpa, _Axis(c, 2))
            start = (c * tp + r) * n
            assert torch.equal(got, whole[:, start:start + n]), (c, r)
    assert not torch.equal(whole[:, :n], whole[:, n:2 * n])


def test_context_chunk_carries_gpt_tokentypes():
    """``context_parallel_batch`` cuts a GPT's ``tokentype_ids`` with the
    chunk, as the LM arrays and the positions."""
    ids = torch.arange(24).reshape(2, 12)
    batch = {"input_ids": ids, "labels": ids, "tokentype_ids": ids % 3}
    pos = torch.arange(12).expand(2, 12)
    got = context_parallel_batch(batch, 1, 2, positions=pos)
    assert torch.equal(got["tokentype_ids"], (ids % 3)[:, 6:])
    assert torch.equal(got["positions"], pos[:, 6:])


def test_check_supported_accepts_the_last_combinations(caplog):
    """LoRA on Mixtral and on GPT, GPT at cp 2 (ring, or a Ulysses fusion
    it does not read), the dropped path at cp 2, and ep 2 with tp 4 above
    Mixtral's 2 kv heads pass ``check_supported``; zig-zag on Mixtral keeps
    JAX's refusal."""
    mixtral = CONF / "hf_mixtral_8x7b_config.yaml"
    dropped = CONF / "hf_mixtral_8x7b_dropped_config.yaml"
    gpt = CONF / "megatron_gpt_config.yaml"
    for path, over in (
            (mixtral, {"model.lora": {"lora_rank": 16}}),
            (gpt, {"model.lora": {"lora_rank": 16}}),
            (gpt, {"distributed_strategy.context_parallel_size": 2,
                   "model.fusions.ring_attention": True}),
            (gpt, {"distributed_strategy.context_parallel_size": 2,
                   "model.fusions.ulysses_attention": True}),
            (dropped, {"distributed_strategy.context_parallel_size": 2,
                       "model.fusions.ring_attention": True}),
            (mixtral, {"distributed_strategy.tensor_model_parallel_size": 4,
                       "model.num_key_value_heads": 2,
                       "distributed_strategy.expert_model_parallel_size": 2})):
        t_loop.check_supported(t_loader.load_config(path, over))
    with pytest.raises(NotImplementedError, match="zigzag_ring_attention is llama/mistral-only"):
        t_loop.check_supported(t_loader.load_config(dropped, {
            "distributed_strategy.context_parallel_size": 2, "model.sliding_window": None,
            "model.fusions.zigzag_ring_attention": True}))


# ---------------------------------------------------------------------------
# the launch against the JAX trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gpt_cp_rope", "lora_gpt"])
def test_gpt_under_cp_matches_jax(families, name):
    """GPT at dp 2 x cp 2 (rope on half of each head, a window, swiglu) and,
    with LoRA, at cp 2 x tp 2 (SP; learned positions, biased swiglu, the
    untied head adapted): 3 steps against the JAX trainer, every param
    (the adapters, and the frozen base bit for bit), the ranks' rows and
    chunks as the mesh says."""
    ranks = matches_jax(families, name)
    coords = sorted((r["coords"]["dp"], r["coords"]["cp"], r["coords"]["tp"]) for r in ranks)
    tp = 2 if name == "lora_gpt" else 1
    assert coords == sorted((d, c, t) for d in range(2 // tp) for c in range(2)
                            for t in range(tp))


def test_gpt_dropout_at_cp2_equals_cp1(families):
    """Dropout 0.1 at dp 2 x cp 2 against one process at cp 1 from the same
    weights with the same microbatches: each context rank draws its slice of
    the global masks, so the losses and grad norms agree to fp32 rounding,
    and differ from the dropout-0 run's."""
    got = families["ranks"][0]["gpt_cp_dropout"]["history"]
    same_history(got, families["one"]["gpt_cp_dropout"])
    plain = families["ranks"][0]["gpt_cp_rope"]["history"]
    assert all(not np.isclose(a["loss"], b["loss"], rtol=1e-4) for a, b in zip(got, plain))


@pytest.mark.parametrize("name", ["mx_dropped_ring", "mx_dropped_ulysses"])
def test_dropped_moe_under_cp_matches_jax(families, name):
    """The dropped path at dp 2 x cp 2 (ring, Ulysses): the keep mask over
    the whole microbatch, so loss, grad norm, router and LM losses are the
    JAX trainer's."""
    matches_jax(families, name, "mx_dropped_ring",
                keys=("loss", "grad_norm", "router_aux_loss", "lm_loss"))


def test_gpt_dropout_at_pp2_cp2_equals_pp2_dp2(families):
    """Under pp each microbatch carries its key through the context cut:
    dropout 0.1 at pp 2 x cp 2 draws each context rank's slice of pp 2 x dp
    2's masks (the same microbatches), so the two agree to fp32 rounding,
    and differ from the dropout-0 run's grad norms."""
    a, b = (families["ranks"][0][n]["history"]
            for n in ("gpt_pp2_cp2_dropout", "gpt_pp2_dp2_dropout"))
    same_history(a, b)
    plain = families["ranks"][0]["gpt_cp_rope"]["history"]
    assert all(not np.isclose(x["grad_norm"], y["grad_norm"], rtol=1e-3)
               for x, y in zip(a, plain))


def test_gpt_moe_dropped_under_cp_equals_one_process(families):
    """GPT-MoE on the dropped path at dp 2 x cp 2 (the queue over both data
    and both context ranks' tokens) against one process with the same
    microbatches, from the same weights: losses, grad norms, router and
    LM losses at fp32 rtol 1e-5."""
    got = families["ranks"][0]["gpt_moe_dropped_cp"]["history"]
    same_history(got, families["one"]["gpt_moe"],
                 ("loss", "grad_norm", "router_aux_loss", "lm_loss"))


def test_expert_parallel_above_the_kv_heads_matches_jax(families):
    """ep 2 x tp 2 over one kv head (each replicated on both tp ranks): 3
    steps against the JAX trainer; the kv head's moments keep their ZeRO-1
    split over (data, expert) and the experts' none (data 1)."""
    ranks = matches_jax(families, "mx_ep_tp_kv", "mx_dropped_ring",
                        keys=("loss", "grad_norm", "router_aux_loss", "lm_loss"))
    shards = ranks[0]["zero1_shards"]
    assert shards["layers.0.attn.qkv.w"][1][0] == 64 // 2
    assert shards["layers.0.mlp.experts.gate_up"][0] == shards["layers.0.mlp.experts.gate_up"][1]


def test_expert_parallel_above_the_kv_heads_checkpoints(families):
    """The ep 2 x tp 2 run saved at step 2: restored at tp 1 (dp 2 x ep 2)
    its params and moments are the saved ones bit for bit (each kv head
    written once), and resumed at ep 2 x tp 2 its step 3 and final state
    equal the straight run's."""
    d = families["dumps"]
    assert d["kv_pre"].keys() == d["kv_at_tp1"].keys()
    for k, v in d["kv_pre"].items():
        assert torch.equal(v, d["kv_at_tp1"][k]), k
    assert d["kv_resume"].keys() == d["mx_ep_tp_kv"].keys()
    for k, v in d["kv_resume"].items():
        assert torch.equal(v, d["mx_ep_tp_kv"][k]), k
    for r in families["ranks"]:
        assert [h["step"] for h in r["kv_resume"]["history"]] == [2]
        assert r["kv_resume"]["history"][0]["loss"] == r["mx_ep_tp_kv"]["history"][2]["loss"]
