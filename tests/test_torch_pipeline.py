"""Pipeline parallelism of the port at vp 1 (``parallel/pipeline.py``),
against the JAX package's ``parallel/pipeline.py``.

- The host side, exactly: the stage split, the interleave on a list of
  layers, the schedule gate and its texts (``blocked_1f1b_reason``,
  ``supports_1f1b``, ``resolve_schedule``), the compacted work table (every
  column and ring size), the bubble model and ``ce_denominator``, over a
  grid of ``(schedule, pp, nm, vp)``.
- The executors through the loopback (every virtual rank in this process)
  on a tiny fp32 Llama, tied and untied, with a ``loss_mask`` that gives the
  microbatches different valid counts: ``1f1b`` against JAX's
  ``pipeline_loss_and_grad`` and ``wavefront`` against ``jax.grad`` of its
  ``pipeline_loss``, on 2 and 4 virtual devices, at JAX's own bars (loss
  rtol 1e-5, every gradient rtol 5e-4 / atol 1e-5,
  ``tests/test_pipeline_1f1b.py``); the two schedules bit for bit equal;
  the in-flight counts (``1f1b``: at most ``pp - r`` graphs on rank ``r``;
  ``wavefront``: one graph, ``nm`` stage inputs); and the unpipelined
  mean of the microbatches' means, which this mask must tell apart.
- The config rules (JAX's texts) and ``check_supported`` over the shipped
  configs.
- One 4-rank gloo launch (``tests/_torch_dp_worker.py``): pp 4, pp 2 x dp 2
  with ZeRO-1, pp 2 x tp 2 with SP and LoRA at pp 2 x dp 2 (``auto``
  resolves to ``wavefront``), each against the JAX trainer at the same
  mesh and against the port at pp 1; a non-finite gradient on one stage
  skipped by every rank; a save at pp 2 x dp 2 restored at pp 1 and pp 4;
  a bitwise resume at pp 2; and LoRA at tp 4 over 2 kv heads against tp 1.
"""

import collections
import concurrent.futures
import dataclasses
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_pipeline_1f1b as JP
import test_torch_dp as DPT
import test_torch_tp as TPT
from neuronx_distributed_training_torch.checkpoint import integrity as ck_integrity
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.parallel import pipeline as t_pipe
from neuronx_distributed_training_torch.tools.convert import (
    merge_stages,
    params_from_jax,
    params_to_jax,
)
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.models import llama as j_llama
from neuronx_distributed_training_tpu.parallel import pipeline as j_pipe
from neuronx_distributed_training_tpu.parallel.mesh import MeshConfig as JMeshConfig
from neuronx_distributed_training_tpu.parallel.mesh import build_mesh as j_build_mesh

REPO = Path(__file__).resolve().parents[1]
CONF = REPO / "examples" / "conf"
FP32 = DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32,
                   softmax_dtype=torch.float32)
#: JAX's bars (tests/test_pipeline_1f1b.py)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-4, 1e-5


# ---------------------------------------------------------------------------
# host side, against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers,pp,vp", [(8, 2, 1), (8, 4, 2), (12, 3, 2), (6, 4, 1),
                                          (80, 8, 1), (126, 14, 3)])
def test_stage_split_and_interleave_match_jax(layers, pp, vp):
    try:
        want = j_pipe.stage_layer_slice(layers, pp, vp)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_pipe.stage_layer_slice(layers, pp, vp)
        assert str(got.value) == str(e)
        return
    assert t_pipe.stage_layer_slice(layers, pp, vp) == want
    stacked = {"w": np.arange(layers)}
    inter = j_pipe.to_interleaved(stacked, pp, vp)["w"]
    ours = t_pipe.to_interleaved(list(range(layers)), pp, vp)
    assert np.array_equal(np.array(ours), inter)
    assert t_pipe.from_interleaved(ours) == list(j_pipe.from_interleaved({"w": inter})["w"])
    if vp == 1:
        got = [list(t_pipe.stage_layers(layers, r, pp)) for r in range(pp)]
        assert np.array_equal(np.array(got), inter[0])


def _pcfgs():
    out = []
    for pp in (1, 2):
        for vp in (1, 2):
            for cp in (1, 2):
                for alignment in (None, "sft", "dpo", "kto"):
                    for lora in (False, True):
                        out.append({"pipeline_model_parallel_size": pp,
                                    "virtual_pipeline_model_parallel_size": vp,
                                    "context_parallel_size": cp, "alignment": alignment,
                                    "lora": lora})
    return out


PCFGS = _pcfgs()
T_CFG = t_llama.LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=4,
                            num_attention_heads=4, num_kv_heads=2,
                            activations_checkpoint_granularity=None)


def _same_outcome(fn_t, fn_j):
    """Both return the same value, or both raise the same error text."""
    try:
        want = fn_j()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_t()
        assert str(got.value) == str(e)
        return "raised"
    assert fn_t() == want
    return want


@pytest.mark.parametrize("schedule", list(j_pipe.PIPELINE_SCHEDULES) + ["gpipe", None])
def test_schedule_gate_matches_jax(schedule):
    """``blocked_1f1b_reason``, ``supports_1f1b`` (Llama, Mixtral, GPT) and
    ``resolve_schedule`` give JAX's results and texts over every
    (pp, vp, cp, alignment, lora), for every schedule name."""
    assert t_pipe.PIPELINE_SCHEDULES == j_pipe.PIPELINE_SCHEDULES
    assert t_pipe.MANUAL_VJP_SCHEDULES == j_pipe.MANUAL_VJP_SCHEDULES
    j_cfg = JP.CFG
    zz_t = dataclasses.replace(T_CFG, attention_impl="zigzag_ring")
    zz_j = dataclasses.replace(j_cfg, attention_impl="zigzag_ring")
    from neuronx_distributed_training_torch.models import mixtral as t_mixtral
    from neuronx_distributed_training_torch.ops import moe as t_moe
    from neuronx_distributed_training_tpu.models import gpt as j_gpt
    from neuronx_distributed_training_tpu.models import mixtral as j_mixtral
    from neuronx_distributed_training_tpu.ops import moe as j_moe

    class GPTConfig:  # the port has no GPT config yet: the gate keys on the name
        pass

    j_mx = j_mixtral.MixtralConfig(llama=j_cfg, moe=j_moe.MoEConfig(num_experts=4, top_k=2,
                                                                    dropless=True))
    t_mx = t_mixtral.MixtralConfig(llama=T_CFG, moe=t_moe.MoEConfig(num_experts=4, top_k=2,
                                                                    dropless=True))
    j_gc = j_gpt.GPTConfig(vocab_size=128, hidden_size=32, num_layers=4, num_attention_heads=4,
                           max_position_embeddings=32)
    models = [(T_CFG, j_cfg), (zz_t, zz_j), (t_mx, j_mx), (GPTConfig(), j_gc)]
    seen = set()
    for pcfg in PCFGS:
        if schedule in j_pipe.MANUAL_VJP_SCHEDULES:
            seen.add(_same_outcome(lambda: t_pipe.blocked_1f1b_reason(pcfg, schedule),
                                   lambda: j_pipe.blocked_1f1b_reason(pcfg, schedule)))
            for mt, mj in models:
                seen.add(_same_outcome(lambda: t_pipe.supports_1f1b(mt, pcfg, schedule),
                                       lambda: j_pipe.supports_1f1b(mj, pcfg, schedule)))
        elif schedule in ("auto", "wavefront"):
            with pytest.raises(ValueError) as e:
                t_pipe.blocked_1f1b_reason(pcfg, schedule)
            assert "not a manual-vjp schedule" in str(e.value)
        for mt, mj in models:
            seen.add(_same_outcome(lambda: t_pipe.resolve_schedule(schedule, mt, pcfg),
                                   lambda: j_pipe.resolve_schedule(schedule, mj, pcfg)))
    assert {"raised"} < seen if schedule in j_pipe.MANUAL_VJP_SCHEDULES else seen


WT_GRID = [(s, pp, nm, vp) for s in j_pipe.MANUAL_VJP_SCHEDULES for pp in (2, 4)
           for nm in (1, 3, 4, 8) for vp in ((2, 3) if s == "1f1b-interleaved" else (1,))
           if not (vp > 1 and nm < pp)]


@pytest.mark.parametrize("schedule,pp,nm,vp", WT_GRID)
def test_work_table_and_bubble_model_match_jax(schedule, pp, nm, vp):
    want, got = j_pipe.work_table(schedule, pp, nm, vp), t_pipe.work_table(schedule, pp, nm, vp)
    assert (got.span, got.ring_sizes, got.lockstep_span) == (want.span, want.ring_sizes,
                                                             want.lockstep_span)
    for cols in ("rank_cols", "glob_cols"):
        a, b = getattr(got, cols), getattr(want, cols)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (cols, k)
    assert got.tick_counts() == want.tick_counts()
    assert got.bubble_fraction() == want.bubble_fraction()
    assert t_pipe.ring_slot_counts(schedule, pp, nm, vp) == j_pipe.ring_slot_counts(
        schedule, pp, nm, vp)
    for s in (schedule, "wavefront", None):
        assert t_pipe.bubble_multiplier(s, pp, nm, vp) == j_pipe.bubble_multiplier(s, pp, nm, vp)
        assert t_pipe.predicted_bubble_fraction(s, pp, nm, vp) == \
            j_pipe.predicted_bubble_fraction(s, pp, nm, vp)


def test_work_table_refusals_match_jax():
    for args in (("wavefront", 2, 4, 1), ("1f1b", 1, 4, 1), ("1f1b", 2, 0, 1),
                 ("1f1b", 2, 4, 2), ("1f1b-interleaved", 2, 4, 1)):
        _same_outcome(lambda: t_pipe.work_table(*args), lambda: j_pipe.work_table(*args))
    assert t_pipe.predicted_bubble_fraction("1f1b", 1, 8) == 0.0


@pytest.mark.parametrize("shift", [True, False])
def test_ce_denominator_matches_jax(shift):
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 50, (3, 2, 16)).astype(np.int32)
    labels[0, 0, :5] = -100
    mask = (rng.random((3, 2, 16)) > 0.3).astype(np.float32)
    want = j_pipe.ce_denominator({"labels": jnp.asarray(labels), "loss_mask": jnp.asarray(mask)},
                                 shift_labels=shift)
    got = t_pipe.ce_denominator({"labels": torch.tensor(labels), "loss_mask": torch.tensor(mask)},
                                shift_labels=shift)
    assert float(got) == float(want)


# ---------------------------------------------------------------------------
# the executors through the loopback, against JAX
# ---------------------------------------------------------------------------


def _batch(nm, mb=4, s=16, vocab=128, seed=1):
    """Tokens from a seed and JAX's uneven mask: microbatch 0 loses its
    first 8 positions, so the microbatches hold different valid counts."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (nm, mb, s)).astype(np.int32)
    mask = np.ones((nm, mb, s), np.float32)
    mask[0, :, :8] = 0.0
    return ids, mask


def _jax_grads_named(tree) -> dict:
    return {n: t for n, t in t_llama.named_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")).items()}


#: ``build(dir)`` once for every xdist worker of this run
_shared = DPT.shared


def _onef1b_grads(cfg, g):
    """JAX's ``pipeline_loss_and_grad`` entries folded as its trainer folds
    them."""
    fold = j_llama.onef1b_head_hooks(cfg, JP.FP32)[3]
    grads = dict(g["params_from_embed"])
    grads["layers"] = jax.tree_util.tree_map(lambda a, d: a + d, grads["layers"], g["layers"])
    return fold(grads, g["head_params"], g["head_weight"])


#: JAX's init by config, built once for the module: the JAX cases of one
#: width share their weights (JAX arrays are immutable)
_JAX_INIT: dict = {}


def _jax_init(cfg):
    key = repr(cfg)
    if key not in _JAX_INIT:
        _JAX_INIT[key] = j_llama.init_params(jax.random.PRNGKey(0), cfg, JP.FP32)
    return _JAX_INIT[key]


def _jax_pipeline(pp, tied, devices, *, vp=1, nm=None, chunks=None,
                  schedules=("1f1b", "wavefront")):
    """JAX's ``schedules`` on ``pp`` pipe ranks at ``vp`` (``pp vp`` layers
    at vp > 1) with ``vocab_chunks`` ``chunks``: ``1f1b`` /
    ``1f1b-interleaved`` (``pipeline_loss_and_grad``, its grads folded as its
    trainer folds them), ``1f1b-zb`` (its ``zero_bubble`` split) and
    ``wavefront`` (``value_and_grad`` of ``pipeline_loss``): ``(params, (ids,
    mask), {schedule: (loss, grads by port name)})``, the layers flat."""
    cfg = dataclasses.replace(JP.CFG, tie_word_embeddings=tied, vocab_chunks=chunks,
                              num_layers=JP.CFG.num_layers if vp == 1 else pp * vp)
    params = _jax_init(cfg)
    ids, mask = _batch(nm or (6 if pp == 4 else 4))
    mbs = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids),
           "loss_mask": jnp.asarray(mask)}
    hooks = j_llama.pipeline_hooks(cfg, JP.FP32)
    mesh = j_build_mesh(JMeshConfig(pipeline_model_parallel_size=pp,
                                    virtual_pipeline_model_parallel_size=vp), devices=devices)
    sh_params, sh_mbs = JP.shard_for(mesh, cfg, params, mbs, vp=vp)
    kw = {"virtual_pipeline_size": vp} if vp > 1 else {}

    def named(g):
        return _jax_grads_named({**g, "layers": j_pipe.from_interleaved(g["layers"])}
                                if vp > 1 else g)

    out = {}
    for schedule in schedules:
        if schedule == "wavefront":
            loss, g = JP.wavefront_loss_and_grad(mesh, hooks, sh_params, sh_mbs, **kw)
        else:
            loss, g = JP.onef1b_loss_and_grad(mesh, cfg, hooks, sh_params, sh_mbs,
                                              zero_bubble=schedule == "1f1b-zb", **kw)
            g = _onef1b_grads(cfg, g)
        out[schedule] = (float(loss), named(g))
    return jax.tree_util.tree_map(np.asarray, params), (ids, mask), out


def _port_step(jparams, ids, mask, tied, pp, schedule, stats=None, *, vp=1, chunks=None):
    cfg = dataclasses.replace(T_CFG, tie_word_embeddings=tied, vocab_chunks=chunks,
                              num_layers=len(next(iter(jax.tree_util.tree_leaves(
                                  jparams["layers"])))))
    params = params_from_jax(jparams, device="cpu")
    leaves = t_llama.named_params(params)
    for t in leaves.values():
        t.requires_grad_(True)
    mbs = [{"input_ids": torch.tensor(ids[m]), "labels": torch.tensor(ids[m]),
            "loss_mask": torch.tensor(mask[m])} for m in range(len(ids))]
    denom = t_pipe.ce_denominator({"labels": torch.tensor(ids), "loss_mask": torch.tensor(mask)},
                                  shift_labels=True)
    hooks = t_llama.pipeline_hooks(cfg, FP32)
    loss, grads = t_pipe.loopback_step(params, hooks, mbs, denom, schedule, pp, leaves=leaves,
                                       act_dtype=torch.float32, stats=stats, vp=vp)
    return params, mbs, cfg, loss, grads


PARITY = [(2, False), (2, True), (4, False), (4, True)]
#: (pp, nm) of the virtual pipeline's cases at vp 2 (the last two ragged),
#: with the JAX function each is held to: the port's two schedules are
#: equal bit for bit, so each JAX function is met at a plain and a ragged
#: shape, and one compile a shape is enough
VP_PARITY = {(2, 4): "1f1b-interleaved", (4, 4): "wavefront", (2, 3): "wavefront",
             (4, 6): "1f1b-interleaved"}


def _jax_cases(devices8) -> dict:
    """Every case, compiled four at a time (XLA compiles outside the GIL; the
    mesh contexts are thread-local)."""
    jobs = {key: lambda key=key: _jax_pipeline(*key, devices8, schedules=(
        "1f1b", "wavefront") + (() if key[1] else ("1f1b-zb",))) for key in PARITY}
    jobs.update({("vp", pp, nm): lambda pp=pp, nm=nm, schedule=schedule: _jax_pipeline(
        pp, False, devices8[:pp], vp=2, nm=nm, schedules=(schedule,))
        for (pp, nm), schedule in VP_PARITY.items()})
    jobs["chunked"] = lambda: _jax_pipeline(2, False, devices8[:2], chunks=4,
                                            schedules=("wavefront",))
    jobs["preference"] = lambda: _jax_preference(devices8[:2])
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory, devices8):
    """:func:`_jax_pipeline` of every ``PARITY`` case, by ``(pp, tied)``
    (``1f1b-zb`` too where untied), of the ``VP_PARITY`` cases by ``("vp",
    pp, nm)``, of the chunked head (``"chunked"``) and the preference hooks
    (``"preference"``)."""
    return _shared(tmp_path_factory, "jax_pipeline", lambda _: _jax_cases(devices8))


@pytest.mark.parametrize("schedule", ["1f1b", "wavefront"])
@pytest.mark.parametrize("pp,tied", PARITY)
def test_loopback_matches_jax_pipeline(pp, tied, schedule, jax_side):
    """The port's schedule on ``pp`` virtual ranks against JAX's (``1f1b``
    against ``pipeline_loss_and_grad``, ``wavefront`` against
    ``jax.grad(pipeline_loss)``) with the uneven mask: the loss at rtol
    1e-5 and every gradient at rtol 5e-4 / atol 1e-5; the tied weight's
    gradient holds the embedding's and the head's."""
    jparams, (ids, mask), jax_out = jax_side[(pp, tied)]
    want_loss, want = jax_out[schedule]
    _, _, _, loss, grads = _port_step(jparams, ids, mask, tied, pp, schedule)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert grads.keys() == want.keys()
    assert ("lm_head.w" in grads) == (not tied)
    for n in grads:
        np.testing.assert_allclose(grads[n].numpy(), want[n].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=n)


@pytest.mark.parametrize("pp,tied", PARITY)
def test_schedules_bitwise_equal_and_bounded(pp, tied, jax_side):
    """``1f1b`` and ``wavefront`` give the same loss and gradients bit for
    bit; ``1f1b`` keeps at most ``pp - r`` graphs alive on rank ``r`` and
    holds no stage input, ``wavefront`` one graph at a time and every
    microbatch's stage input on the ranks after the first."""
    jparams, (ids, mask), _ = jax_side[(pp, tied)]
    nm = len(ids)
    runs = {}
    for schedule in ("1f1b", "wavefront"):
        stats = [{} for _ in range(pp)]
        runs[schedule] = _port_step(jparams, ids, mask, tied, pp, schedule, stats)[3:] + (stats,)
    (l1, g1, s1), (lw, gw, sw) = runs["1f1b"], runs["wavefront"]
    assert torch.equal(l1, lw) and g1.keys() == gw.keys()
    assert all(torch.equal(g1[n], gw[n]) for n in g1), [n for n in g1
                                                        if not torch.equal(g1[n], gw[n])]
    assert [s["graphs_max"] for s in s1] == [min(pp - r, nm) for r in range(pp)]
    assert all(s["inputs_max"] == 0 for s in s1)
    assert [s["graphs_max"] for s in sw] == [1] * pp
    assert [s["inputs_max"] for s in sw] == [0] + [nm] * (pp - 1)


def test_pipelined_normalization_is_the_global_count(jax_side):
    """Mutation check of the loss rule: the unpipelined step's mean of the
    microbatches' means (``trainer/step.py`` at pp 1) on the same weights
    and rows is not JAX's pipelined loss under this mask (so the parity
    tests above would catch it), while the port's pipelined loss is, and it
    equals the plain forward summed over microbatches over the global
    count."""
    jparams, (ids, mask), jax_out = jax_side[(2, False)]
    params, mbs, cfg, loss, _ = _port_step(jparams, ids, mask, False, 2, "1f1b")
    with torch.no_grad():
        means = [t_llama.forward(params, mb, cfg, FP32)[0] for mb in mbs]
        mean_of_means = float(sum(means) / len(means))
        denom = sum(float(t_llama.loss_token_count(mb)) for mb in mbs)
        global_rule = float(sum(t_llama.forward(params, mb, cfg, FP32,
                                                loss_denominator=torch.tensor(denom))[0]
                                for mb in mbs))
    want = jax_out["1f1b"][0]
    assert abs(mean_of_means - want) > 10 * LOSS_RTOL * want
    np.testing.assert_allclose(global_rule, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), want, rtol=LOSS_RTOL)


def _assert_matches(loss, grads, want_loss, want):
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert grads.keys() == want.keys()
    for n in grads:
        np.testing.assert_allclose(grads[n].numpy(), want[n].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=n)


def _bitwise(a: tuple, b: tuple) -> bool:
    (la, ga), (lb, gb) = a, b
    return torch.equal(la, lb) and ga.keys() == gb.keys() and all(
        torch.equal(ga[n], gb[n]) for n in ga)


@pytest.mark.parametrize("schedule", ["1f1b-interleaved", "wavefront"])
@pytest.mark.parametrize("pp,nm", VP_PARITY)
def test_virtual_pipeline_matches_jax(pp, nm, schedule, jax_side):
    """The virtual pipeline at vp 2 (``2 pp`` layers, chunk ``c`` of rank
    ``r`` the stage ``c pp + r``), every virtual rank through the loopback,
    with the uneven mask: ``1f1b-interleaved`` and the wavefront against
    JAX's ``pipeline_loss_and_grad(virtual_pipeline_size=2)`` at (pp, nm) =
    (2, 4) and (4, 6) and ``jax.grad`` of
    ``pipeline_loss(virtual_pipeline_size=2)`` at (4, 4) and (2, 3), at
    JAX's bars; nm 3 at pp 2 and nm 6 at pp 4 leave a ragged last group."""
    jparams, (ids, mask), jax_out = jax_side[("vp", pp, nm)]
    _, _, _, loss, grads = _port_step(jparams, ids, mask, False, pp, schedule, vp=2)
    _assert_matches(loss, grads, *jax_out[VP_PARITY[(pp, nm)]])


@pytest.mark.parametrize("pp,nm", VP_PARITY)
def test_virtual_pipeline_schedules_bitwise_equal_and_bounded(pp, nm, jax_side):
    """``1f1b-interleaved`` and the vp 2 wavefront give the same loss and
    gradients bit for bit; the interleave keeps at most Megatron's warm-up
    plus one stage forwards alive on each rank (the last rank exactly that,
    fewer than its ``2 nm`` stage forwards), the wavefront one graph and a
    stage input for every chunk it did not embed."""
    jparams, (ids, mask), _ = jax_side[("vp", pp, nm)]
    runs, stats = {}, {}
    for schedule in ("1f1b-interleaved", "wavefront"):
        stats[schedule] = [{} for _ in range(pp)]
        runs[schedule] = _port_step(jparams, ids, mask, False, pp, schedule, stats[schedule],
                                    vp=2)[3:]
    assert _bitwise(runs["1f1b-interleaved"], runs["wavefront"])
    il, wf = stats["1f1b-interleaved"], stats["wavefront"]
    bound = [t_pipe.warmup_bound("1f1b-interleaved", pp, nm, 2, r) for r in range(pp)]
    assert all(s["graphs_max"] <= b for s, b in zip(il, bound)), (il, bound)
    assert il[-1]["graphs_max"] == bound[-1] and il[-1]["graphs_max"] < 2 * nm
    assert all(s["inputs_max"] == 0 for s in il)
    assert [s["graphs_max"] for s in wf] == [1] * pp
    assert [s["inputs_max"] for s in wf] == [nm] + [2 * nm] * (pp - 1)


@pytest.mark.parametrize("pp", [2, 4])
def test_zero_bubble_matches_jax_and_equals_1f1b(pp, jax_side):
    """``1f1b-zb``: the backward computes the activation gradients (and the
    norms' and embedding's), each ``x @ w`` hands ``(x, dy)`` to the
    microbatch's deferred weight pass, which runs after the backward of
    microbatch ``m + r``.  Against JAX's ``zero_bubble=True`` at its bars,
    bit for bit the port's ``1f1b``, and at most ``r + 1`` microbatches'
    weight passes pending on rank ``r``."""
    jparams, (ids, mask), jax_out = jax_side[(pp, False)]
    stats = [{} for _ in range(pp)]
    zb = _port_step(jparams, ids, mask, False, pp, "1f1b-zb", stats)[3:]
    _assert_matches(*zb, *jax_out["1f1b-zb"])
    assert _bitwise(zb, _port_step(jparams, ids, mask, False, pp, "1f1b")[3:])
    nm = len(ids)
    assert [s["deferred_max"] for s in stats] == [min(r + 1, nm) for r in range(pp)]
    assert [s["graphs_max"] for s in stats] == [min(pp - r, nm) for r in range(pp)]
    assert all(s["deferred_bytes_max"] > 0 for s in stats)


@pytest.mark.parametrize("schedule,vp", [("1f1b", 1), ("wavefront", 1), ("1f1b-zb", 1),
                                         ("1f1b-interleaved", 2)])
def test_chunked_head_at_the_pipeline_loss_site_matches_jax(schedule, vp, jax_side, monkeypatch):
    """``fusions.chunked_ce`` under pp: the last stage's loss hook runs the
    fused head over 4 vocab blocks (JAX's ``loss_fn`` with ``vocab_chunks``)
    in every executor, against JAX's wavefront loss and gradients with
    ``vocab_chunks`` at its bars (JAX's manual head is vocab-sharded over
    the pipe instead; both give this loss)."""
    calls = []
    chunked = t_llama._chunked_head_loss
    monkeypatch.setattr(t_llama, "_chunked_head_loss",
                        lambda *a, **k: calls.append(k["reduction"]) or chunked(*a, **k))
    jparams, (ids, mask), jax_out = jax_side["chunked"]
    _, _, _, loss, grads = _port_step(jparams, ids, mask, False, 2, schedule, vp=vp, chunks=4)
    _assert_matches(loss, grads, *jax_out["wavefront"])
    per_mb = 2 if schedule == "wavefront" else 1  # the wavefront's backward recomputes it
    assert calls == ["sum"] * (len(ids) * per_mb)


PREF_NM, PREF_MB = 4, 4


def _pref_batch(kind, seed=7, s=16, vocab=128) -> dict:
    """A preference batch from a seed (``[nm, mb, ...]``): random ids, a loss
    mask over a random suffix of each row, random reference log-probs and
    (KTO) labels."""
    rng = np.random.default_rng(seed)
    shape = (PREF_NM, PREF_MB)

    def ids():
        return rng.integers(0, vocab, shape + (s,)).astype(np.int32)

    def mask():
        m = np.zeros(shape + (s,), np.float32)
        for idx in np.ndindex(*shape):
            m[idx][int(rng.integers(2, s - 2)):] = 1.0
        return m

    def logps():
        return rng.normal(-60.0, 3.0, shape).astype(np.float32)

    if kind == "kto":
        return {"input_ids": ids(), "loss_mask": mask(), "reference_logps": logps(),
                "kto_labels": (rng.random(shape) > 0.5).astype(np.float32)}
    return {"chosen_input_ids": ids(), "rejected_input_ids": ids(), "chosen_loss_mask": mask(),
            "rejected_loss_mask": mask(), "reference_chosen_logps": logps(),
            "reference_rejected_logps": logps()}


def _jax_preference(devices8) -> tuple:
    """``jax.value_and_grad`` of JAX's ``pipeline_loss`` over its
    ``preference_pipeline_hooks`` (DPO, ORPO) and ``kto_pipeline_hooks`` at
    pp 2: ``(params, {kind: (batch, loss, grads by port name)})``."""
    from neuronx_distributed_training_tpu.alignment import dpo as j_dpo
    from neuronx_distributed_training_tpu.alignment import kto as j_kto
    from neuronx_distributed_training_tpu.ops import norm as j_norm

    cfg = JP.CFG
    params = _jax_init(cfg)
    embed, stage, _ = j_llama.pipeline_hooks(cfg, JP.FP32)

    def head_fn(p, y):
        h = j_norm.apply_rms_norm(p["final_norm"], y, eps=cfg.rms_norm_eps)
        return j_llama.logits_fn(p, h, cfg, JP.FP32)

    mesh = j_build_mesh(JMeshConfig(pipeline_model_parallel_size=2), devices=devices8)
    out = {}
    for kind in ("dpo", "orpo", "kto"):
        batch = _pref_batch(kind)
        hooks = (j_kto.kto_pipeline_hooks(embed, stage, head_fn, beta=0.2, desirable_weight=1.5,
                                          undesirable_weight=0.7) if kind == "kto" else
                 j_dpo.preference_pipeline_hooks(embed, stage, head_fn, mode=kind, beta=0.2))
        sh_params, sh_mbs = JP.shard_for(mesh, cfg, params,
                                         {k: jnp.asarray(v) for k, v in batch.items()})
        loss, grads = JP.wavefront_loss_and_grad(mesh, hooks, sh_params, sh_mbs)
        out[kind] = (batch, float(loss), _jax_grads_named(grads))
    return jax.tree_util.tree_map(np.asarray, params), out


@pytest.mark.parametrize("kind", ["dpo", "orpo", "kto"])
def test_preference_pipeline_hooks_match_jax(kind, jax_side):
    """``alignment/dpo.py::preference_pipeline_hooks`` (DPO, ORPO: chosen and
    rejected concatenated in the embed hook, the loss hook splitting the
    last hidden states) and ``alignment/kto.py::kto_pipeline_hooks`` at pp 2
    through the loopback's wavefront (the schedule JAX's gate gives them),
    against JAX's hooks under ``jax.grad(pipeline_loss)``: the loss weighted
    by pairs (examples) over the global count, at JAX's bars; ``1f1b`` gives
    the wavefront's numbers bit for bit."""
    from neuronx_distributed_training_torch.alignment import dpo as t_dpo
    from neuronx_distributed_training_torch.alignment import kto as t_kto

    jparams, runs = jax_side["preference"]
    batch, want_loss, want = runs[kind]
    params = params_from_jax(jparams, device="cpu")
    leaves = t_llama.named_params(params)
    for t in leaves.values():
        t.requires_grad_(True)
    base = t_llama.pipeline_hooks(T_CFG, FP32)
    head = t_loop._head_fn(T_CFG, FP32, None)
    hooks = (t_kto.kto_pipeline_hooks(base, head, beta=0.2, desirable_weight=1.5,
                                      undesirable_weight=0.7) if kind == "kto" else
             t_dpo.preference_pipeline_hooks(base, head, mode=kind, beta=0.2))
    mbs = [{k: torch.tensor(v[m]) for k, v in batch.items()} for m in range(PREF_NM)]
    denom = torch.tensor(float(PREF_NM * PREF_MB))
    runs = {sch: t_pipe.loopback_step(params, hooks, mbs, denom, sch, 2, leaves=leaves,
                                      act_dtype=torch.float32) for sch in ("wavefront", "1f1b")}
    _assert_matches(*runs["wavefront"], want_loss, want)
    assert _bitwise(runs["wavefront"], runs["1f1b"])


def test_exchange_plans_pair_and_finish():
    """Every schedule's plan over a grid (pp 2-6, vp 1-3, nm from pp or 1
    to 3 pp + 1): each rank runs each forward once and its backwards in
    ``_bwd_order``, a send and its receive sit in the same tick on both
    sides, a rank's batch holds at most one activation and one cotangent
    each way (activations first), the manual schedules keep within
    ``warmup_bound`` and ``1f1b-zb`` at most ``r + 1`` weight passes
    pending; an interleaved step at nm < pp is refused with JAX's text."""
    for schedule in t_pipe.EXECUTED_SCHEDULES + ("forward",):
        for pp in range(2, 7):
            vps = (1,) if schedule in ("1f1b", "1f1b-zb") else \
                (2, 3) if schedule == "1f1b-interleaved" else (1, 2, 3)
            for vp in vps:
                for nm in range(pp if vp > 1 else 1, 3 * pp + 2):
                    plan = t_pipe.exchange_plan(schedule, pp, nm, vp)
                    ticks = [[] for _ in range(pp)]
                    for r in range(pp):
                        ops = [op for op, _, _ in plan[r] if op]
                        fwd = [("f",) + k for k in t_pipe._fwd_order(pp, nm, vp)]
                        assert sorted(o for o in ops if o[0] == "f") == sorted(fwd)
                        if schedule != "forward":
                            assert [o for o in ops if o[0] == "b"] == [
                                ("b",) + k for k in t_pipe._bwd_order(pp, nm, vp)]
                        alive = most = pending = deferred = 0
                        for op in ops:
                            alive += {"f": 1, "b": -1}.get(op[0], 0)
                            most = max(most, alive)
                            pending += {"b": 1, "w": -1}.get(op[0], 0)
                            deferred = max(deferred, pending)
                        if schedule in t_pipe.MANUAL_VJP_SCHEDULES:
                            assert most <= t_pipe.warmup_bound(schedule, pp, nm, vp, r)
                        if schedule == "1f1b-zb":
                            assert deferred <= r + 1
                        for op, sends, recvs in plan[r]:
                            for kind in ("f", "b"):
                                assert sum(k[0] == kind for _, k in sends) <= 1
                                assert sum(k[0] == kind for _, k in recvs) <= 1
                            assert [k[0] for _, k in sends] == sorted(k[0] for _, k in sends)
                            ticks[r].append((sends, recvs))
                    sent = collections.Counter((r, (r + o) % pp, k) for r in range(pp)
                                               for sends, _ in ticks[r] for o, k in sends)
                    got = collections.Counter(((r + o) % pp, r, k) for r in range(pp)
                                              for _, recvs in ticks[r] for o, k in recvs)
                    assert sent == got, (schedule, pp, nm, vp)
    with pytest.raises(ValueError, match=r"interleaved pipeline needs num_microbatches >= pp "
                                         r"\(got nm=2, pp=4, vp=2\)"):
        t_pipe.check_microbatches(4, 2, 2)


@pytest.mark.parametrize("case", ["causal", "window", "padding"])
def test_blockwise_gspmd_attention_matches_jax(case):
    """``parallel/ring_attention.py::blockwise_gspmd_attention`` (JAX's cp
    attention under pp, ported as the plain whole-sequence function) against
    JAX's on the same inputs, GQA 4 over 2 heads, 16-row kv blocks: o and
    every gradient at fp32 2e-5, causal, with a window, and with padded
    keys."""
    from neuronx_distributed_training_torch.parallel import ring_attention as t_ring
    from neuronx_distributed_training_tpu.parallel import ring_attention as j_ring

    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16), (2, 64, 4, 16)))
    am = None
    if case == "padding":
        am = np.ones((2, 64), np.int32)
        am[0, 40:] = 0
        am[1, 7:19] = 0
    kw = {"causal": True, "block_kv": 16,
          "sliding_window": 24 if case == "window" else None}
    jo, vjp = jax.vjp(lambda *a: j_ring.blockwise_gspmd_attention(
        *a, attention_mask=None if am is None else jnp.asarray(am), **kw),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    to = t_ring.blockwise_gspmd_attention(*ts, attention_mask=None if am is None
                                          else torch.tensor(am), **kw)
    tgrads = torch.autograd.grad(to, ts, torch.tensor(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=0, atol=2e-5)
    for name, a, b in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5, err_msg=name)


def test_interleaved_layout_through_params_to_jax_and_back():
    """At vp 2 ``params_from_jax`` takes the JAX trainer's interleaved ``[vp,
    pp, Lc, ...]`` layer stack to each pipeline rank's tree (the layers of
    its two chunks, which ``init_params`` at that rank draws bit for bit)
    and ``params_to_jax`` merges the ranks back into it exactly."""
    cfg = dataclasses.replace(T_CFG, num_layers=8)
    whole = t_llama.init_params(cfg, FP32, generator=torch.Generator().manual_seed(5),
                                device="cpu")
    tree = params_to_jax(whole)
    inter = {**tree, "layers": j_pipe.to_interleaved(tree["layers"], 2, 2)}
    ranks = []
    for r in range(2):
        mine = params_from_jax(inter, device="cpu", pp_rank=r, pp_size=2, vp=2)
        drawn = t_llama.init_params(cfg, FP32, generator=torch.Generator().manual_seed(5),
                                    device="cpu", pp_rank=r, pp_size=2, vp=2)
        held = [i for i, x in enumerate(mine["layers"]) if x is not None]
        assert held == t_pipe.stage_layers(8, r, 2, 2) == [2 * r, 2 * r + 1, 4 + 2 * r,
                                                            5 + 2 * r]
        a, b = t_llama.named_params(mine), t_llama.named_params(drawn)
        assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)
        ranks.append(mine)
    back = params_to_jax(ranks, pp_size=2, vp=2)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(inter)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, inter))


def test_stage_params_and_convert_round_trip():
    """``init_params`` at pp draws every leaf and keeps the stage's layers
    (a pp 2 stage's tensors are pp 1's, bit for bit); ``params_from_jax``
    carries a JAX tree to one stage and ``params_to_jax`` merges the stages
    back (also across tp); LoRA draws the same A's at any pp."""
    from neuronx_distributed_training_torch.peft import LoraConfig, add_lora

    cfg = dataclasses.replace(T_CFG, num_layers=4)
    whole = t_llama.init_params(cfg, FP32, generator=torch.Generator().manual_seed(5),
                                device="cpu")
    whole = add_lora(whole, LoraConfig(rank=4), torch.Generator().manual_seed(6))
    flat = t_llama.named_params(whole)
    stages = []
    for r in range(2):
        st = t_llama.init_params(cfg, FP32, generator=torch.Generator().manual_seed(5),
                                 device="cpu", pp_rank=r, pp_size=2)
        st = add_lora(st, LoraConfig(rank=4), torch.Generator().manual_seed(6))
        mine = t_llama.named_params(st)
        assert [i for i, x in enumerate(st["layers"]) if x is not None] == [2 * r, 2 * r + 1]
        assert all(torch.equal(t, flat[n]) for n, t in mine.items())
        assert {n.split(".")[1] for n in mine if n.startswith("layers.")} == {str(2 * r),
                                                                               str(2 * r + 1)}
        stages.append(st)
    tree = params_to_jax(whole)
    back = params_to_jax(stages, pp_size=2)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, tree, back))
    assert t_llama.named_params(merge_stages(stages)).keys() == flat.keys()
    ranks = [params_from_jax(tree, device="cpu", cfg=cfg, tp_rank=t, tp_size=2, pp_rank=p,
                             pp_size=2) for p in range(2) for t in range(2)]
    assert ranks[2]["layers"][0] is None and ranks[2]["layers"][2] is not None
    again = params_to_jax(ranks, cfg=cfg, pp_size=2)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, tree, again))


# ---------------------------------------------------------------------------
# config rules and the shipped configs
# ---------------------------------------------------------------------------


def _cfg_with(**blocks):
    cfg = {"name": "x", "model_source": "hf",
           "distributed_strategy": {"pipeline_model_parallel_size": 2},
           "data": {"global_batch_size": 8, "micro_batch_size": 2, "seq_length": 32},
           "model": {"num_layers": 4, "num_attention_heads": 4}}
    for k, v in blocks.items():
        cfg[k] = {**cfg.get(k, {}), **v}
    return cfg


@pytest.mark.parametrize("bad,match", [
    (_cfg_with(distributed_strategy={"pipeline_model_parallel_size": 1,
                                     "virtual_pipeline_model_parallel_size": 2}),
     "virtual pipeline requires"),
    (_cfg_with(model={"num_layers": 6}, distributed_strategy={
        "pipeline_model_parallel_size": 2, "virtual_pipeline_model_parallel_size": 2}),
     "must divide evenly"),
    (_cfg_with(distributed_strategy={"pipeline": "1f1b"}), "must be a mapping"),
    (_cfg_with(distributed_strategy={"pipeline": {"schedul": "1f1b"}}), "did you mean"),
    (_cfg_with(distributed_strategy={"pipeline": {"schedule": "gpipe"}}), "must be one of"),
    (_cfg_with(distributed_strategy={"pipeline": {"schedule": "1f1b"},
                                     "virtual_pipeline_model_parallel_size": 2}),
     "1f1b-interleaved"),
    (_cfg_with(distributed_strategy={"pipeline": {"schedule": "1f1b"}},
               model={"lora": {"lora_rank": 4}}), "LoRA adapters"),
    (_cfg_with(distributed_strategy={"pipeline": {"schedule": "1f1b-zb"},
                                     "context_parallel_size": 2},
               model={"fusions": {"ring_attention": True}}), "context parallelism under pp"),
    (dict(_cfg_with(distributed_strategy={"pipeline": {"schedule": "1f1b"}}),
          model_alignment_strategy="dpo"), "preference alignment"),
])
def test_pipeline_config_rules_match_jax(bad, match):
    msgs = []
    for ld in (t_loader, j_loader):
        with pytest.raises(ValueError, match=match) as e:
            ld.load_config(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


#: the shipped configs check_supported accepts as they are, with the
#: schedule their pipeline resolves to
ACCEPTED = {"hf_llama3_8B_config.yaml": None, "hf_llama3.1_8B_config.yaml": None,
            "hf_llama3_8B_v5p_config.yaml": None, "hf_llama_7B_config.yaml": None,
            "hf_llama3_8B_SFT_config.yaml": None, "hf_llama3_8B_SFT_lora_config.yaml": None,
            "hf_llama3_8B_DPO_config.yaml": None, "hf_llama3_8B_ORPO_config.yaml": None,
            "hf_llama3_8B_KTO_config.yaml": None, "tiny_smoke_config.yaml": None,
            "hf_llama3_70B_config.yaml": "1f1b", "hf_llama3.1_70B_config.yaml": "1f1b",
            "hf_llama3_70B_v5p_config.yaml": "1f1b-interleaved",
            "hf_llama3.1_405B_config.yaml": "1f1b-interleaved",
            "hf_llama3_70B_CP_config.yaml": "wavefront",
            "hf_mixtral_8x7b_config.yaml": None, "hf_mixtral_8x7b_dropped_config.yaml": None,
            # the Megatron GPT configs (the 70B at pp 4 x tp 32: JAX's gate
            # keeps GPT on the wavefront)
            "megatron_gpt_config.yaml": None, "megatron_llama2_7B_SFT_config.yaml": None,
            "megatron_llama_70b_config.yaml": "wavefront", "megatron_llama_7B_config.yaml": None,
            "megatron_mistral_config.yaml": None, "megatron_mixtral_8x7b_config.yaml": None,
            "megatron_mixtral_8x7b_dropless_config.yaml": None}
#: the refused ones, with what each refusal names
REFUSED: dict = {}


@pytest.mark.parametrize("config", sorted(p.name for p in CONF.glob("*.yaml")))
def test_shipped_configs_check_supported(config):
    """All 24 shipped configs pass as shipped: the two 70B configs at pp 8 x
    tp 32 (``1f1b``), the 70B v5p config (pp 4 x vp 2) and the 405B (pp 14
    x vp 3, ``chunked_ce: 8``) on ``1f1b-interleaved``, the 70B CP config
    (pp 8 x cp 2) on the wavefront, as JAX's gate resolves them, both hf
    Mixtral configs (tp 8 x ep 4), and the seven ``megatron_*`` GPT configs,
    ``megatron_llama_70b`` (pp 4 x tp 32) on the wavefront, where JAX's gate
    keeps GPT; a refusal would name what it lacks (``REFUSED``)."""
    cfg = t_loader.load_config(CONF / config)
    if config in ACCEPTED:
        t_loop.check_supported(cfg)
        ds, model = dict(cfg["distributed_strategy"]), dict(cfg["model"])
        if ACCEPTED[config] is not None:
            facts = t_loop._pipeline_facts(cfg, ds, model)
            schedule = dict(ds.get("pipeline", {}) or {}).get("schedule", "auto")
            assert t_pipe.resolve_schedule(schedule, t_loop.model_config(cfg),
                                           facts) == ACCEPTED[config]
        return
    with pytest.raises(NotImplementedError) as e:
        t_loop.check_supported(cfg)
    for want in REFUSED.get(config, ["entry 11 [item 14]"]):
        assert want in str(e.value), (config, str(e.value))


def test_forced_schedule_on_a_blocked_combination_raises_jax_text():
    """A forced ``1f1b`` the gate blocks (LoRA) raises the JAX package's
    ``resolve_schedule`` text from the trainer; ``auto`` there resolves to
    the wavefront."""
    facts = {"pipeline_model_parallel_size": 2, "lora": True}
    want = j_pipe.resolve_schedule("auto", JP.CFG, facts)
    assert t_pipe.resolve_schedule("auto", T_CFG, facts) == want == "wavefront"
    with pytest.raises(ValueError) as j:
        j_pipe.resolve_schedule("1f1b", JP.CFG, facts)
    cfg = t_loader.load_config(CONF / "tiny_smoke_config.yaml",
                               {"distributed_strategy.pipeline_model_parallel_size": 2})
    cfg["model"]["lora"] = {"lora_rank": 4}
    cfg["distributed_strategy"]["pipeline"] = {"schedule": "1f1b"}
    with pytest.raises(ValueError) as t:
        t_loop.check_supported(cfg)
    assert str(t.value) == str(j.value)


# ---------------------------------------------------------------------------
# one 4-rank gloo launch: the trainer at pp, against the JAX trainer
# ---------------------------------------------------------------------------


def pp_cfg(tmp, exp, *, pp=2, tp=1, vp=1, cp=1, precision="fp32", **kw):
    cfg = DPT.dp_cfg(tmp, exp, precision=precision, **kw)
    cfg["distributed_strategy"].update(pipeline_model_parallel_size=pp,
                                       tensor_model_parallel_size=tp, sequence_parallel=tp > 1)
    if vp > 1:
        cfg["distributed_strategy"]["virtual_pipeline_model_parallel_size"] = vp
    if cp > 1:
        cfg["distributed_strategy"]["context_parallel_size"] = cp
        cfg["model"]["fusions"] = {"ring_attention": True}
    cfg["model"]["num_layers"] = 4
    return cfg


def pp_pref_cfg(tmp, strategy, data, exp, *, pp=2, cp=1, micro=2):
    """``test_torch_alignment.py``'s preference config at pp x cp (the ring
    under cp) with ``micro`` rows a microbatch."""
    import test_torch_alignment as AL

    ds = {"tensor_model_parallel_size": 1, "sequence_parallel": False, "zero1": True,
          "pipeline_model_parallel_size": pp, "context_parallel_size": cp}
    cfg = AL.pref_cfg(tmp, strategy, data, exp, distributed_strategy=ds)
    cfg["data"]["micro_batch_size"] = micro
    if cp > 1:
        cfg["model"]["fusions"] = {"ring_attention": True}
    return cfg


def _flat_layers(jparams):
    """A JAX trainer's tree at vp > 1 with its layers flat ``[L, ...]``."""
    return {**jparams, "layers": j_pipe.from_interleaved(jparams["layers"])}


def pp_lora_cfg(tmp, data, exp, *, pp=2, tp=1):
    cfg = TPT.lora_cfg(tmp, data, exp, tp=tp, sp=tp > 1)
    cfg["distributed_strategy"]["pipeline_model_parallel_size"] = pp
    cfg["data"]["global_batch_size"] = 8
    return cfg


#: name: (pp, tp) of the dense parity runs (dp = 4 / (pp * tp))
MESHES = {"pp4": (4, 1), "pp2_dp2": (2, 1), "pp2_tp2": (2, 2)}
#: name: (pp x cp or vp overrides, the schedule ``auto`` resolves to) of the
#: parity runs of the virtual pipeline and of cp under pp
MESHES_9CD = {"vp2_dp2": ({"vp": 2}, "1f1b-interleaved"), "pp2_cp2": ({"cp": 2}, "wavefront")}


#: validation after every step, one batch
VAL = {"val_check_interval": 1, "limit_val_batches": 1}
#: the 4-rank launch's time limit a rank (``test_torch_dp.py``'s 180 s is
#: for launches of a few scenarios)
PP_LAUNCH_TIMEOUT = 600


def _lora_tp4_weights(tmp, data) -> Path:
    """LoRA tp 4 weights: the port's initial tree with a non-zero B, so the
    column layers' A has a gradient at step 0."""
    one = TPT._single(TPT.lora_cfg(tmp, data, "lora_w", tp=1, sp=False))
    w = {n: t.detach().clone() for n, t in t_llama.named_params(one.params).items()}
    gen = torch.Generator().manual_seed(8)
    for n in w:
        if n.endswith("lora_b"):
            w[n] = 0.02 * torch.randn(w[n].shape, generator=gen)
    torch.save(w, tmp / "lora_tp4_w.pt")
    return tmp / "lora_tp4_w.pt"


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    return _shared(tmp_path_factory, "pp_runs", _pp_launch)


#: the JAX trainer built but not fitted, then fitted (``test_torch_tp.py``)
_jax_start, _jax_finish = TPT._jax_start, TPT._jax_finish


def _pp_launch(tmp: Path) -> dict:
    """The JAX trainers are built first (the port's scenarios start from
    their initial weights), the 4-rank launch then runs in a thread while
    they fit."""
    import test_torch_alignment as AL

    data = TPT._sft_jsonl(tmp / "train.jsonl")
    pref, kto = AL._jsonl(tmp / "dpo.jsonl", AL.pref_records()), AL._jsonl(
        tmp / "kto.jsonl", AL.kto_records())
    jts, scenarios = {}, []
    for name, (pp, tp) in MESHES.items():
        jts[name], j0 = _jax_start(pp_cfg(tmp, f"jax_{name}", pp=pp, tp=tp), 4)
        scenarios.append({"name": name, "cfg": pp_cfg(tmp, f"port_{name}", pp=pp, tp=tp),
                          "steps": 3, "dump": str(tmp / f"{name}.pt"),
                          "weights": str(TPT._global_weights(j0, tmp / "w.pt"))})
    for name, (kw, _) in MESHES_9CD.items():
        jts[name], j0 = _jax_start(pp_cfg(tmp, f"jax_{name}", **kw), 4)
        j0 = _flat_layers(j0) if "vp" in kw else j0
        scenarios.append({"name": name, "cfg": pp_cfg(tmp, f"port_{name}", **kw), "steps": 3,
                          "dump": str(tmp / f"{name}.pt"),
                          "weights": str(TPT._global_weights(j0, tmp / f"{name}_w.pt"))})
    # the vp 2 run saved at step 2 and resumed (against vp2_dp2's straight
    # run, from the same weights)
    scenarios += [
        {"name": "vp_pre", "cfg": pp_cfg(tmp, "vpck", vp=2, every=2), "steps": 3,
         "max_steps": 2, "dump": str(tmp / "vpck2.pt"), "weights": str(tmp / "vp2_dp2_w.pt")},
        # restored at vp 1 (pp 2, saving nothing), then resumed at vp 2
        {"name": "vp_at_vp1", "cfg": pp_cfg(tmp, "vpck"), "steps": 3},
        {"name": "vp_resume", "cfg": pp_cfg(tmp, "vpck", vp=2, every=2), "steps": 3,
         "dump": str(tmp / "vp_resume.pt")}]
    jts["dpo"], j0 = _jax_start(pp_pref_cfg(tmp, "dpo", pref, "jax_dpo"), 4)
    pref_w = str(TPT._global_weights(j0, tmp / "dpo_w.pt"))
    scenarios += [
        {"name": "dpo", "cfg": pp_pref_cfg(tmp, "dpo", pref, "port_dpo"), "steps": 3,
         "weights": pref_w},
        # the same DPO at pp 2 x cp 2 (ring), and KTO at pp 2 x dp 2 with 4-row
        # microbatches (its baseline over both data ranks' rows)
        {"name": "dpo_cp2", "cfg": pp_pref_cfg(tmp, "dpo", pref, "port_dpo_cp2", cp=2),
         "steps": 3, "weights": pref_w},
        {"name": "kto", "cfg": pp_pref_cfg(tmp, "kto", kto, "port_kto", micro=2), "steps": 3,
         "weights": pref_w}]
    jts["lora"], lora_j0 = _jax_start(pp_lora_cfg(tmp, data, "jax_lora"), 4)
    scenarios += [
        {"name": "lora", "cfg": pp_lora_cfg(tmp, data, "port_lora"), "steps": 3,
         "dump": str(tmp / "lora.pt"),
         "weights": str(TPT._global_weights(lora_j0, tmp / "lw.pt"))},
        {"name": "poison", "cfg": pp_cfg(tmp, "poison"), "steps": 3,
         "poison_grad": {"step": 1, "pp_rank": 0}},
        # a save at step 2 at pp 2 x dp 2, restored at pp 4 (no save) and
        # resumed at pp 2 (bit for bit against the straight run)
        {"name": "pre", "cfg": pp_cfg(tmp, "ck", every=2), "steps": 3, "max_steps": 2,
         "dump": str(tmp / "ck2.pt")},
        {"name": "at_pp4", "cfg": pp_cfg(tmp, "ck", pp=4), "steps": 3},
        {"name": "resume", "cfg": pp_cfg(tmp, "ck", every=2), "steps": 3,
         "dump": str(tmp / "resume.pt")},
        {"name": "straight", "cfg": pp_cfg(tmp, "a", every=2), "steps": 3,
         "dump": str(tmp / "straight.pt")},
        # the forward schedule's eval loss, and JAX's rule on the val batches
        {"name": "val", "cfg": pp_cfg(tmp, "val", trainer=VAL), "steps": 3,
         "val": {"gbs": 8, "seed": 4}, "weights": str(tmp / "w.pt")},
        {"name": "val_bad", "cfg": pp_cfg(tmp, "val_bad"), "val": {"gbs": 4, "seed": 4},
         "expect_error": True},
        # LoRA at tp above the kv heads (4 over 2), pp 1
        {"name": "lora_tp4", "cfg": TPT.lora_cfg(tmp, data, "lora_tp4", tp=4), "steps": 1,
         "max_steps": 1, "grads": str(tmp / "lora_tp4_grads.pt"),
         "weights": str(_lora_tp4_weights(tmp, data))},
    ]
    # a pp 1 save at step 2 (this process), restored at pp 2 x tp 2
    solo = t_loop.Trainer.from_config(t_loader.load_config(pp_cfg(tmp, "solo", pp=1, every=2)),
                                      device="cpu")
    solo.max_steps = 2
    solo.fit()
    scenarios.append({"name": "from_pp1", "cfg": pp_cfg(tmp, "solo", pp=2, tp=2), "steps": 3})
    # the scenarios take ~25 s alone, up to 7x that beside a loaded xdist run
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(DPT.launch, tmp, scenarios, 4, PP_LAUNCH_TIMEOUT)
        fitted = {name: _jax_finish(jt) for name, jt in jts.items()}
        ranks = ranks.result()
    jax_side = {}
    for name in list(MESHES) + list(MESHES_9CD):
        j1, lines = fitted[name]
        jax_side[name] = (_flat_layers(j1) if "vp" in MESHES_9CD.get(name, ({},))[0] else j1,
                          lines)
    jax_side["dpo"] = fitted["dpo"][1]
    jax_side["lora"] = (lora_j0, *fitted["lora"])
    return {"tmp": tmp, "jax": jax_side, "ranks": ranks, "data": data}


def _pp1_history(pp_runs) -> list:
    """The port at pp 1 in this process, from the parity runs' weights."""
    if "pp1" not in pp_runs:
        tmp = pp_runs["tmp"]
        one = TPT._single(pp_cfg(tmp, "pp1", pp=1), torch.load(tmp / "w.pt"))
        pp_runs["pp1"] = one.fit()
    return pp_runs["pp1"]


@pytest.mark.parametrize("name", list(MESHES))
def test_pipeline_trainer_matches_jax_and_pp1(pp_runs, name):
    """pp 4, pp 2 x dp 2 (ZeRO-1) and pp 2 x tp 2 (SP), fp32, 3 steps:
    losses, grad norms, the health groups' norms and the params bar against
    the JAX trainer at the same mesh; losses and grad norms against the port
    at pp 1 (every token valid: the pipelined and unpipelined rules agree);
    every rank the same history; ``auto`` resolved to ``1f1b``."""
    j1, lines = pp_runs["jax"][name]
    ranks = [r[name] for r in pp_runs["ranks"]]
    hist = [r["history"] for r in ranks]
    assert all([(h["loss"], h["grad_norm"]) for h in x] ==
               [(h["loss"], h["grad_norm"]) for h in hist[0]] for x in hist)
    dump = torch.load(pp_runs["tmp"] / f"{name}.pt")
    TPT._assert_matches_jax(lines, hist[0], dump, j1, "fp32")
    one = _pp1_history(pp_runs)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in hist[0]], [h[k] for h in one], rtol=1e-5,
                                   atol=0, err_msg=k)
    pp, tp = MESHES[name]
    assert {r["schedule"] for r in ranks} == {"1f1b"}
    assert sorted((c["pp"], c["dp"], c["tp"]) for c in (r["coords"] for r in ranks)) == sorted(
        (w // (4 // pp), (w // tp) % (4 // (pp * tp)), w % tp) for w in range(4))
    # a stage's ranks hold its layers alone; ZeRO-1 shards over a stage's dp
    for r in ranks:
        layers = {n.split(".")[1] for n in r["zero1_shards"] if n.startswith("layers.")}
        per = 4 // pp
        assert layers == {str(i) for i in range(r["coords"]["pp"] * per,
                                                (r["coords"]["pp"] + 1) * per)}
    if name == "pp2_dp2":
        assert any(full != part for full, part in ranks[0]["zero1_shards"].values())


def test_lora_at_pp2_resolves_to_wavefront_and_matches_jax(pp_runs):
    """LoRA SFT at pp 2 x dp 2: ``auto`` gives the wavefront (JAX's gate);
    losses and grad norms against the JAX trainer at rtol 1e-5 (the packed
    rows' masks give the microbatches different counts: the pipelined
    rule); the frozen base bit for bit, every adapter moved."""
    j0, j1, lines = pp_runs["jax"]["lora"]
    ranks = [r["lora"] for r in pp_runs["ranks"]]
    assert {r["schedule"] for r in ranks} == {"wavefront"}
    h0 = ranks[0]["history"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in h0], [x[k] for x in lines], rtol=1e-5,
                                   atol=0, err_msg=k)
    dump = torch.load(pp_runs["tmp"] / "lora.pt")
    start = t_llama.named_params(params_from_jax(j0, device="cpu"))
    final = t_llama.named_params(params_from_jax(j1, device="cpu"))
    for n, t in start.items():
        got = dump[f"params/{n}"]
        if n.endswith(("lora_a", "lora_b")):
            assert float((got - final[n]).abs().max()) <= 2 * 1e-2 * 3, n
            assert not torch.equal(got, t), n
        else:
            assert torch.equal(got, t), n


def test_nonfinite_gradient_on_one_stage_is_skipped_everywhere(pp_runs):
    """A NaN in a layer gradient of stage 0 alone, at step 1: the norm's
    sum over the stages carries it, so every rank skips that step."""
    for r in pp_runs["ranks"]:
        h = r["poison"]["history"]
        assert [x["health/updates_finite"] for x in h] == [1.0, 0.0, 1.0]
        assert r["poison"]["opt_step"] == 2 and r["poison"]["health"]["skipped_count"] == 1


def test_pipeline_checkpoints_reshard_and_resume_bitwise(pp_runs):
    """The pp 2 x dp 2 save at step 2 holds every leaf once under its global
    name (the sidecar verifies, with the leaves of a pp 1 save), resumes at
    pp 2 bit for bit against the straight run, restores at pp 4 (step 3
    within rtol 1e-5 of the straight run's) and at pp 1 here (params and
    moments bit for bit); a pp 1 save restores at pp 2 x tp 2 (step 3
    within rtol 1e-5 of the pp 2 run's: every pp and tp draws the same
    initial tensors)."""
    tmp = pp_runs["tmp"]
    ck = tmp / "ck" / "dp" / "version_0" / "checkpoints"
    side = json.loads((ck / "2" / "integrity.json").read_text())
    names = {n.split(":")[0] for n in side["tree"]["params"]}
    one = TPT._single(pp_cfg(tmp, "names", pp=1))
    assert names == set(t_llama.named_params(one.params))
    assert ck_integrity.verify_step(ck, 2).status == "ok"
    straight, resume = torch.load(tmp / "straight.pt"), torch.load(tmp / "resume.pt")
    assert straight.keys() == resume.keys()
    assert all(torch.equal(straight[k], resume[k]) for k in straight)
    ranks = pp_runs["ranks"]
    s3 = ranks[0]["straight"]["history"][2]
    assert ranks[0]["resume"]["history"][0]["loss"] == s3["loss"]
    np.testing.assert_allclose(ranks[0]["at_pp4"]["history"][0]["loss"], s3["loss"], rtol=1e-5)
    assert {r["at_pp4"]["coords"]["pp"] for r in ranks} == {0, 1, 2, 3}
    # a pp 1 save restored across pp x tp (2 x 2): its step 3 is the pp 2 run's
    assert len(ranks[0]["from_pp1"]["history"]) == 1
    np.testing.assert_allclose(ranks[0]["from_pp1"]["history"][0]["loss"], s3["loss"],
                               rtol=1e-5)
    # pp 1, in this process
    shutil.copytree(ck / "2", tmp / "one" / "dp" / "version_0" / "checkpoints" / "2")
    one = t_loop.Trainer.from_config(t_loader.load_config(pp_cfg(tmp, "one", pp=1, every=2)),
                                     device="cpu")
    assert one.maybe_resume() and one.step == 2
    saved = torch.load(tmp / "ck2.pt")
    live = {f"params/{n}": t for n, t in t_llama.named_params(one.params).items()}
    live.update({f"{g}/{n}": t for g in ("mu", "nu") for n, t in one.opt_state[g].items()})
    assert saved.keys() >= live.keys()
    assert all(torch.equal(saved[k], live[k]) for k in live), [
        k for k in live if not torch.equal(saved[k], live[k])]


def test_lora_at_tp_above_kv_heads_gradients_equal_tp1(pp_runs):
    """LoRA at tp 4 over 2 kv heads (each replicated on 2 ranks): every
    gradient AdamW receives, merged, equals the port's at tp 1 within 1e-5
    relative, the loss within rtol 1e-6."""
    tmp = pp_runs["tmp"]
    one = TPT._single(TPT.lora_cfg(tmp, pp_runs["data"], "lora_one", tp=1, sp=False),
                      torch.load(tmp / "lora_tp4_w.pt"))
    want, loss = TPT._first_grads(one)
    got = torch.load(tmp / "lora_tp4_grads.pt")
    hist = pp_runs["ranks"][0]["lora_tp4"]["history"]
    assert np.isclose(hist[0]["loss"], loss, rtol=1e-6, atol=0)
    assert got.keys() == want.keys() and len(got) == 16
    for n in got:
        rel = float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30))
        assert rel <= 1e-5, (n, rel)


def test_eval_runs_the_forward_schedule(pp_runs):
    """At pp 2 x dp 2 the validation loss (the forward schedule over the
    stages, summed over ``pipe`` and ``data``) follows the port's at pp 1 on
    the same weights and val rows within rtol 1e-5 (every token valid); a
    val module of another global batch is refused with JAX's text."""
    from neuronx_distributed_training_torch.data.loader import SyntheticDataModule

    tmp = pp_runs["tmp"]
    cfg = pp_cfg(tmp, "val1", pp=1, trainer=VAL)
    one = TPT._single(cfg, torch.load(tmp / "w.pt"))
    one.val_data_module = SyntheticDataModule(cfg["model"]["vocab_size"],
                                              cfg["data"]["seq_length"], 8, seed=4)
    want = [h["val_loss"] for h in one.fit()]
    for r in pp_runs["ranks"]:
        got = [h["val_loss"] for h in r["val"]["history"]]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        assert r["val_bad"]["error"] == (
            "under pipeline parallelism validation batches must match the train "
            "global_batch_size 8 (val module has 4): the pipelined eval loss "
            "microbatches the same way")


@pytest.mark.parametrize("name", list(MESHES_9CD))
def test_virtual_pipeline_and_cp_under_pp_match_jax(pp_runs, name):
    """pp 2 x vp 2 x dp 2 with ZeRO-1 (``auto``: ``1f1b-interleaved``, one
    layer a chunk) and pp 2 x cp 2 with the ring (``auto``: the wavefront;
    the ring bodies run inside each stage's layers, where JAX attends with
    ``blockwise_gspmd_attention``), fp32, 3 steps: losses, grad norms, the
    health groups' norms and the params bar against the JAX trainer at the
    same mesh; every rank the same history; a rank holds the layers of its
    chunks alone."""
    j1, lines = pp_runs["jax"][name]
    ranks = [r[name] for r in pp_runs["ranks"]]
    hist = [r["history"] for r in ranks]
    assert all([(h["loss"], h["grad_norm"]) for h in x] ==
               [(h["loss"], h["grad_norm"]) for h in hist[0]] for x in hist)
    TPT._assert_matches_jax(lines, hist[0], torch.load(pp_runs["tmp"] / f"{name}.pt"), j1,
                            "fp32")
    kw, schedule = MESHES_9CD[name]
    assert {r["schedule"] for r in ranks} == {schedule}
    for r in ranks:
        layers = {int(n.split(".")[1]) for n in r["zero1_shards"] if n.startswith("layers.")}
        assert layers == set(t_pipe.stage_layers(4, r["coords"]["pp"], 2, kw.get("vp", 1)))
    if name == "pp2_cp2":
        assert sorted(c["cp"] for c in (r["coords"] for r in ranks)) == [0, 0, 1, 1]
    else:
        assert any(full != part for full, part in ranks[0]["zero1_shards"].values())


def test_dpo_under_pp_matches_jax(pp_runs):
    """DPO at pp 2 x dp 2 (``auto``: the wavefront over the concatenated
    forward), its reference pass run through the pipelined forward: losses
    and grad norms against the JAX trainer at the same mesh at rtol 1e-5
    (step 0 is ``ln 2`` only if the pipelined reference log-probs equal the
    policy's), every rank the same history and reference columns."""
    lines = pp_runs["jax"]["dpo"]
    ranks = [r["dpo"] for r in pp_runs["ranks"]]
    assert {r["schedule"] for r in ranks} == {"wavefront"}
    h0 = ranks[0]["history"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in h0], [x[k] for x in lines], rtol=1e-5,
                                   atol=0, err_msg=k)
    np.testing.assert_allclose(h0[0]["loss"], np.log(2.0), rtol=1e-6)
    assert all([(h["loss"], h["grad_norm"]) for h in r["history"]] ==
               [(h["loss"], h["grad_norm"]) for h in h0] for r in ranks)
    cols = [r["reference_columns"] for r in ranks]
    assert all(c == cols[0] for c in cols) and sorted(cols[0]) == [
        "reference_chosen_logps", "reference_rejected_logps"]
    assert all(r["reference_rows"] > 0 for r in ranks)


def test_virtual_pipeline_checkpoint_resumes_bitwise_and_restores_at_pp1(pp_runs):
    """A pp 2 x vp 2 x dp 2 save at step 2 holds every leaf once under its
    global name, resumes bit for bit against the straight run from the same
    weights, restores at vp 1 (pp 2: step 3 within rtol 1e-5 of the
    straight run's) and at pp 1 here (params and moments bit for bit)."""
    tmp = pp_runs["tmp"]
    ck = tmp / "vpck" / "dp" / "version_0" / "checkpoints"
    assert ck_integrity.verify_step(ck, 2).status == "ok"
    straight, resume = torch.load(tmp / "vp2_dp2.pt"), torch.load(tmp / "vp_resume.pt")
    assert straight.keys() == resume.keys()
    assert all(torch.equal(straight[k], resume[k]) for k in straight), [
        k for k in straight if not torch.equal(straight[k], resume[k])]
    ranks = pp_runs["ranks"]
    s3 = ranks[0]["vp2_dp2"]["history"][2]
    assert ranks[0]["vp_resume"]["history"][0]["loss"] == s3["loss"]
    assert [len(r["vp_at_vp1"]["history"]) for r in ranks] == [1] * 4
    assert {r["vp_at_vp1"]["schedule"] for r in ranks} == {"1f1b"}
    np.testing.assert_allclose(ranks[0]["vp_at_vp1"]["history"][0]["loss"], s3["loss"],
                               rtol=1e-5)
    shutil.copytree(ck / "2", tmp / "vp_one" / "dp" / "version_0" / "checkpoints" / "2")
    one = t_loop.Trainer.from_config(t_loader.load_config(pp_cfg(tmp, "vp_one", pp=1, every=2)),
                                     device="cpu")
    assert one.maybe_resume() and one.step == 2
    saved = torch.load(tmp / "vpck2.pt")
    live = {f"params/{n}": t for n, t in t_llama.named_params(one.params).items()}
    live.update({f"{g}/{n}": t for g in ("mu", "nu") for n, t in one.opt_state[g].items()})
    assert saved.keys() >= live.keys()
    assert all(torch.equal(saved[k], live[k]) for k in live), [
        k for k in live if not torch.equal(saved[k], live[k])]


def test_dpo_under_pp_x_cp_and_kto_under_pp(pp_runs):
    """DPO at pp 2 x cp 2 with the ring (each side's context slices through
    the concatenated forward, the sequence log-probs summed over the context
    group, the reference pass through the pipelined forward on the slices)
    follows the JAX trainer's pp 2 x dp 2 DPO run at rtol 1e-5: the same
    function of the same global batch.  KTO at pp 2 x dp 2 (two 4-row
    microbatches, each data rank holding 2 rows of each, the baseline ``z0``
    over all 4) follows the port's KTO at pp 1 on the same weights and
    microbatches at rtol 1e-5."""
    tmp = pp_runs["tmp"]
    lines = pp_runs["jax"]["dpo"]
    ranks = [r["dpo_cp2"] for r in pp_runs["ranks"]]
    assert {r["schedule"] for r in ranks} == {"wavefront"}
    assert sorted((r["coords"]["pp"], r["coords"]["cp"]) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in ranks[0]["history"]], [x[k] for x in lines],
                                   rtol=1e-5, atol=0, err_msg=k)
    kto = [r["kto"] for r in pp_runs["ranks"]]
    assert {r["schedule"] for r in kto} == {"wavefront"}
    assert len({str(r["kto_desirable"]) for r in kto}) > 1  # the data ranks' rows differ
    one = TPT._single(pp_pref_cfg(tmp, "kto", tmp / "kto.jsonl", "kto_one", pp=1, micro=4),
                      torch.load(tmp / "dpo_w.pt"))
    want = one.fit()
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in kto[0]["history"]], [h[k] for h in want],
                                   rtol=1e-5, atol=0, err_msg=k)
