"""Context parallelism in the port, on the CPU.

- function level, against the JAX package on 2 and 4 of the 8 virtual CPU
  devices: ``ring_attention``, ``zigzag_ring_attention`` and
  ``ulysses_attention``, forward and dq/dk/dv (causal, GQA, a padding mask
  for the ring and Ulysses, a window for the ring, the flash route at
  head_dim 64 and the blockwise route at 16, Ulysses's KV replication),
  fp32 at atol 2e-5 as in ``tests/test_ring_attention.py``.  The port's
  bodies run every virtual rank in this process through a loopback that
  answers their yields (the shifts, all-to-alls and all-gathers); the cp ==
  1 fallback to core attention; ``_merge_partial`` with fully masked rows;
  ``zigzag_positions``, and the zig-zag batch split against JAX's
  ``zigzag_transform_batch``; the ``2 cp + 1`` pairs of every zig-zag rank;
- the batch split (``data/loader.py::context_parallel_batch``): labels
  shifted on the whole row, positions of a padded row from the whole row,
  the zig-zag layout;
- the config rules against JAX's texts, and the dispatch;
- over gloo (``tests/_torch_dp_worker.py``), one launch of 2 ranks and one
  of 4: the trainer at cp 2 with each of the ring, zig-zag ring and
  Ulysses, the ring in ``mixed_precision`` and on right-padded rows with a
  key mask, and dp x cp = 2 x 2 with ZeRO-1 (ring) and tp x cp = 2 x 2 with
  SP (Ulysses, its kv heads repeated), each against the JAX trainer at the
  same mesh for 3 steps (fp32: loss and grad norm rtol 1e-5; mixed: 1e-4
  and 2e-3; params to ``test_torch_step.py``'s bar); params and moments bit
  for bit equal across the context ranks; a NaN loss on one context rank
  skips the step on every rank; a cp 2 save resumes bit for bit at cp 2 and
  restores at cp 1; the bodies over the real groups.
"""

import importlib.util
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.data.loader import context_parallel_batch
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.ops import attention as t_attn
from neuronx_distributed_training_torch.ops import flash_attention as t_fa
from neuronx_distributed_training_torch.parallel import ring_attention as t_ring
from neuronx_distributed_training_torch.parallel import ulysses as t_uly
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.data import loader as j_data
from neuronx_distributed_training_tpu.ops import attention as j_attn
from neuronx_distributed_training_tpu.parallel import ring_attention as j_ring
from neuronx_distributed_training_tpu.parallel import sharding as j_shd
from neuronx_distributed_training_tpu.parallel import ulysses as j_uly
from neuronx_distributed_training_tpu.parallel.mesh import MeshConfig as JMeshConfig
from neuronx_distributed_training_tpu.parallel.mesh import build_mesh as j_build_mesh

REPO = Path(__file__).resolve().parents[1]


def _load(name: str, file: str):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TPT = _load("_torch_tp_helpers", "test_torch_tp.py")
DPT = TPT.DPT
WORKER = DPT._worker_module()

# ---------------------------------------------------------------------------
# the loopback: every virtual context rank's body in this process
# ---------------------------------------------------------------------------


def loopback(bodies: list) -> list:
    """Drive one body generator per context rank in lock step, answering
    each round of yields as the group would: ``post`` (each rank's handle is
    the previous rank's tensors), ``wait`` (the handle back), ``all_to_all`` (chunk ``r`` of every rank's
    buffer to rank ``r``) and ``all_gather`` (every rank's slice along dim
    1).  Returns each body's return value."""
    n = len(bodies)
    requests = [next(b) for b in bodies]
    while True:
        op = requests[0][0]
        assert all(r[0] == op for r in requests), [r[0] for r in requests]
        sends = [r[1] for r in requests]
        if op == "post":  # the handle is what the previous rank posted
            recv = [sends[(r - 1) % n] for r in range(n)]
        elif op == "wait":
            recv = sends
        elif op == "all_to_all":
            recv = [[torch.stack([sends[i][j][r] for i in range(n)])
                     for j in range(len(sends[0]))] for r in range(n)]
        else:
            recv = [[torch.cat([sends[i][j] for i in range(n)], dim=1)
                     for j in range(len(sends[0]))] for r in range(n)]
        out, done = [None] * n, 0
        for r, body in enumerate(bodies):
            try:
                requests[r] = body.send(recv[r])
            except StopIteration as stop:
                out[r], done = stop.value, done + 1
        if done:
            assert done == n
            return out


def _qkv(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, x, d)).astype(np.float32) for x in (h, kvh, kvh, h)]


def _right_pad(b, s, valid):
    m = np.zeros((b, s), np.int32)
    for i, n in enumerate(valid):
        m[i, :n] = 1
    return m


def _jax_cp(fn, cp, q, k, v, do, mask=None):
    """o and dq/dk/dv of the JAX function under a cp mesh of ``cp`` devices
    (the gradient of sum(o * do))."""
    mesh = j_build_mesh(JMeshConfig(context_parallel_size=cp), devices=jax.devices()[:cp])
    mask = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        o = fn(q, k, v, mask)
        return jnp.sum(o * jnp.asarray(do)), o

    with mesh, j_shd.use_mesh(mesh):
        (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (o, *g)]


def _jax_core(q, k, v, do, mask=None, **kw):
    """o and dq/dk/dv of JAX's core attention over the whole sequence on one
    device (the reference the cases without a JAX mesh are held to)."""
    bias = None if mask is None else j_attn.padding_mask_bias(jnp.asarray(mask))
    o, vjp = jax.vjp(lambda q, k, v: j_attn.core_attention(q, k, v, bias=bias, **kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (o, *vjp(jnp.asarray(do)))]


def _port_ring(cp, q, k, v, do, *, plan_of, mask=None, order=None):
    """The port's ring bodies over ``cp`` virtual ranks (loopback): o and
    dq/dk/dv stitched back to the whole sequence (``order``: the layout's
    slot -> position map, None for contiguous)."""
    s = q.shape[1]
    order = np.arange(s) if order is None else np.asarray(order)
    sq = s // cp
    t = [torch.tensor(x[:, order]) for x in (q, k, v, do)]
    rows = [slice(r * sq, (r + 1) * sq) for r in range(cp)]
    kvs = [torch.stack([t[1][:, x], t[2][:, x]]) for x in rows]
    ms = [None if mask is None else torch.tensor(mask[:, order][:, x]).contiguous()
          for x in rows]
    plans = [plan_of(r) for r in range(cp)]
    fwd = loopback([t_ring.ring_forward(t[0][:, rows[r]], kvs[r], ms[r], plans[r])
                    for r in range(cp)])
    bwd = loopback([t_ring.ring_backward(t[0][:, rows[r]], kvs[r], ms[r], *fwd[r],
                                         t[3][:, rows[r]], plans[r]) for r in range(cp)])
    stitched = [torch.cat(parts, dim=1).numpy() for parts in (
        [f[0] for f in fwd], [g[0] for g in bwd], [g[1][0] for g in bwd],
        [g[1][1] for g in bwd])]
    inv = np.argsort(order)
    return [x[:, inv] for x in stitched]


def _assert_close(got, want, atol=2e-5):
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=name)


RING_CASES = {
    # name: (cp, b, s, h, kvh, d, window, causal, padded, against JAX's ring on a mesh)
    "causal_gqa_blockwise": (4, 2, 64, 4, 2, 16, None, True, False, False),
    "padded_blockwise": (2, 2, 64, 4, 2, 16, None, True, True, True),
    "window_blockwise": (4, 2, 64, 4, 4, 16, 16, True, False, False),
    "non_causal": (2, 2, 64, 4, 2, 16, None, False, False, False),
    "flash_route_padded": (2, 2, 128, 4, 2, 64, None, True, True, False),
    "flash_route_window": (4, 1, 256, 4, 2, 64, 80, True, False, True),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_matches_jax(case):
    cp, b, s, h, kvh, d, window, causal, padded, on_mesh = RING_CASES[case]
    q, k, v, do = _qkv(sum(map(ord, case)), b, s, h, kvh, d)
    mask = _right_pad(b, s, [s - s // 3, s - 7]) if padded else None
    if on_mesh:
        want = _jax_cp(lambda q, k, v, m: j_ring.ring_attention(
            q, k, v, causal=causal, sliding_window=window, attention_mask=m), cp, q, k, v, do,
            mask)
    else:
        want = _jax_core(q, k, v, do, mask, causal=causal,
                         sliding_window=window if causal else None)
    sq = s // cp
    route = t_ring.pick_route(sq, sq, d, h, kvh, 512).name
    assert route == ("flash" if d == 64 else "blockwise")
    before = t_fa.FALLBACKS["blockwise"]
    got = _port_ring(cp, q, k, v, do, mask=mask, plan_of=lambda r: t_ring.ring_plan(
        r, cp, sq, d, h, kvh, causal=causal, window=window))
    assert (t_fa.FALLBACKS["blockwise"] > before) == (route == "blockwise")
    _assert_close(got, want)


@pytest.mark.parametrize("case", ["cp2_gqa_blockwise", "cp4_blockwise", "cp2_flash_route"])
def test_zigzag_ring_attention_matches_jax(case):
    cp, b, s, h, kvh, d = {"cp2_gqa_blockwise": (2, 2, 64, 4, 2, 16),
                           "cp4_blockwise": (4, 1, 64, 2, 2, 16),
                           "cp2_flash_route": (2, 1, 256, 4, 2, 64)}[case]
    q, k, v, do = _qkv(sum(map(ord, case)), b, s, h, kvh, d)
    order = np.asarray(j_ring.zigzag_positions(s, cp))
    if case == "cp2_gqa_blockwise":
        # JAX's zig-zag takes its inputs in the layout; compare in the original order
        zq, zk, zv, zdo = (x[:, order] for x in (q, k, v, do))
        want = _jax_cp(lambda q, k, v, m: j_ring.zigzag_ring_attention(q, k, v), cp,
                       zq, zk, zv, zdo)
        want = [x[:, np.argsort(order)] for x in want]
    else:
        want = _jax_core(q, k, v, do, causal=True)
    hc = s // (2 * cp)
    assert t_ring.zigzag_plan(0, cp, 2 * hc, d, h, kvh).route.name == (
        "flash" if d == 64 else "blockwise")
    got = _port_ring(cp, q, k, v, do, order=order,
                     plan_of=lambda r: t_ring.zigzag_plan(r, cp, 2 * hc, d, h, kvh))
    _assert_close(got, want)


def _port_ulysses(cp, q, k, v, do, *, mask=None, window=None):
    """The port's Ulysses bodies over ``cp`` virtual ranks; the loopback's
    all-to-alls are torch ops, so autograd takes the backward through them."""
    sq = q.shape[1] // cp
    ts = [torch.tensor(x) for x in (q, k, v)]
    parts = [[x[:, r * sq:(r + 1) * sq].clone().requires_grad_(True) for r in range(cp)]
             for x in ts]
    mult = t_uly.kv_replication(k.shape[2], 1, cp)

    def body(r):
        kk, vv = (x[r].repeat_interleave(mult, dim=2) for x in parts[1:])
        return t_uly.ulysses_body(
            parts[0][r], kk, vv,
            None if mask is None else torch.tensor(mask[:, r * sq:(r + 1) * sq]).contiguous(),
            cp=cp, causal=True, window=window)

    o = torch.cat(loopback([body(r) for r in range(cp)]), dim=1)
    o.backward(torch.tensor(do))
    return [o.detach().numpy()] + [torch.cat([p.grad for p in x], dim=1).numpy()
                                   for x in parts]


ULYSSES_CASES = {
    # name: (cp, b, s, h, kvh, d, window, padded, against JAX's Ulysses on a mesh)
    "causal_gqa": (2, 2, 64, 4, 2, 16, None, False, False),
    "kv_replication_cp4": (4, 1, 64, 4, 2, 16, None, False, True),
    "padded_window": (2, 2, 64, 4, 2, 16, 20, True, True),
    "flash_route_padded": (2, 2, 128, 4, 2, 64, None, True, False),
}


@pytest.mark.parametrize("case", sorted(ULYSSES_CASES))
def test_ulysses_attention_matches_jax(case):
    cp, b, s, h, kvh, d, window, padded, on_mesh = ULYSSES_CASES[case]
    q, k, v, do = _qkv(sum(map(ord, case)), b, s, h, kvh, d)
    mask = _right_pad(b, s, [s - s // 4, s - 9]) if padded else None
    if on_mesh:
        want = _jax_cp(lambda q, k, v, m: j_uly.ulysses_attention(
            q, k, v, sliding_window=window, attention_mask=m), cp, q, k, v, do, mask)
    else:
        want = _jax_core(q, k, v, do, mask, causal=True, sliding_window=window)
    mult = t_uly.kv_replication(kvh, 1, cp)
    tiles = t_fa.flash_tileable(s, s, d, h // cp, kvh * mult // cp)
    assert tiles == (d == 64)
    before = t_fa.FALLBACKS["core"]
    got = _port_ulysses(cp, q, k, v, do, mask=mask, window=window)
    # one core fallback a rank exactly where the head group's shapes do not tile
    assert t_fa.FALLBACKS["core"] - before == (0 if tiles else cp)
    _assert_close(got, want)


@pytest.mark.parametrize("impl", ["ring", "ulysses", "zigzag_ring"])
def test_cp1_falls_back_to_core_as_jax(impl):
    q, k, v, _ = _qkv(3, 2, 32, 4, 2, 16)
    mask = None if impl == "zigzag_ring" else _right_pad(2, 32, [20, 32])
    jfn = {"ring": j_ring.ring_attention, "ulysses": j_uly.ulysses_attention,
           "zigzag_ring": lambda *a, attention_mask=None: j_ring.zigzag_ring_attention(*a)}[impl]
    want = np.asarray(jfn(*(jnp.asarray(x) for x in (q, k, v)),
                          attention_mask=None if mask is None else jnp.asarray(mask)))
    got = t_attn.attention(*(torch.tensor(x) for x in (q, k, v)), impl=impl,
                           attention_mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_merge_partial_with_fully_masked_chunks_matches_jax():
    rng = np.random.default_rng(4)
    o_acc, o_c = (rng.standard_normal((2, 3, 8, 4)).astype(np.float32) for _ in range(2))
    lse_acc, lse_c = (rng.standard_normal((2, 3, 8)).astype(np.float32) for _ in range(2))
    lse_acc[0, :, :3] = t_ring.NEG_INF  # the running result saw no key yet
    lse_c[0, :, 2:5] = t_ring.NEG_INF  # the chunk has no visible key there
    lse_c[1] = t_ring.NEG_INF  # a whole chunk with no visible key
    o_acc[0, :, :3] = 0.0
    want = j_ring._merge_partial(*(jnp.asarray(x) for x in (o_acc, lse_acc, o_c, lse_c)))
    got = t_ring._merge_partial(*(torch.tensor(x) for x in (o_acc, lse_acc, o_c, lse_c)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    # rows no chunk sees stay NEG_INF with o = 0; a masked chunk leaves o as it was
    assert (got[1][0, :, 2] == t_ring.NEG_INF).all() and (got[0][0, :, 2] == 0).all()
    np.testing.assert_allclose(got[0][1].numpy(), o_acc[1], atol=0, rtol=0)


@pytest.mark.parametrize("s,cp", [(8, 1), (16, 2), (64, 4)])
def test_zigzag_positions_and_transform_match_jax(s, cp):
    """``zigzag_positions`` equals JAX's, and the zig-zag split of
    ``context_parallel_batch`` over every context rank, laid end to end, is
    JAX's ``zigzag_transform_batch`` (shift in the original order, then the
    gather)."""
    assert t_ring.zigzag_positions(s, cp).tolist() == np.asarray(
        j_ring.zigzag_positions(s, cp)).tolist()
    rng = np.random.default_rng(s)
    batch = {"input_ids": rng.integers(0, 100, (2, s)).astype(np.int32),
             "labels": rng.integers(0, 100, (2, s)).astype(np.int32),
             "loss_mask": (rng.random((2, s)) > 0.3).astype(np.float32)}
    want = j_ring.zigzag_transform_batch({k: jnp.asarray(v) for k, v in batch.items()}, cp)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    pos = t_llama.positions_for(tb["input_ids"])
    parts = [context_parallel_batch(tb, r, cp, positions=pos, zigzag=True) for r in range(cp)]
    for key in batch:
        got = torch.cat([p[key] for p in parts], dim=1)
        assert got.tolist() == np.asarray(want[key]).tolist(), key
    assert torch.cat([p["positions"] for p in parts], 1)[0].tolist() == \
        np.asarray(j_ring.zigzag_positions(s, cp)).tolist()
    with pytest.raises(ValueError, match="must divide by 2\\*cp"):
        t_ring.zigzag_positions(s + 2, 2 * cp)


@pytest.mark.parametrize("cp", [1, 2, 3, 4, 8])
def test_every_zigzag_rank_computes_2cp_plus_1_pairs(cp):
    counts = [sum(len(t_ring.zigzag_pairs(t, my, cp, 4)) for t in range(cp))
              for my in range(cp)]
    assert counts == [2 * cp + 1] * cp
    # the contiguous causal ring is the imbalanced one: rank r computes r + 1 chunks
    ring = [sum(len(t_ring.ring_pairs(t, my, cp, 8)) for t in range(cp)) for my in range(cp)]
    assert ring == [my + 1 for my in range(cp)]


def test_pick_bkv_matches_jax():
    for s, want in [(32768, 512), (8192, 1024), (4097, 512), (1000, 512)]:
        assert t_ring.pick_bkv(s, want) == j_ring.pick_bkv(s, want)


# ---------------------------------------------------------------------------
# the batch split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zigzag", [False, True])
def test_context_parallel_batch_shifts_and_positions_on_the_whole_row(zigzag):
    s, cp = 16, 2
    ids = torch.arange(1, 2 * s + 1).reshape(2, s)
    am = torch.ones(2, s, dtype=torch.int32)
    am[1, 11:] = 0
    batch = {"input_ids": ids, "labels": ids.clone(), "loss_mask": torch.ones(2, s),
             "attention_mask": am}
    pos = t_llama.positions_for(ids, am)
    parts = [context_parallel_batch(batch, r, cp, positions=pos, zigzag=zigzag)
             for r in range(cp)]
    cat = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
    order = t_ring.zigzag_positions(s, cp) if zigzag else torch.arange(s)
    # the target of each slot is the next token of the whole row (the last
    # slot's target is masked): rank 0's last token targets rank 1's first
    want_labels = torch.cat([ids[:, 1:], torch.full((2, 1), -100)], dim=1)[:, order]
    assert torch.equal(cat["labels"], want_labels)
    want_mask = torch.cat([am[:, 1:].float(), torch.zeros(2, 1)], dim=1)[:, order]
    assert torch.equal(cat["loss_mask"], want_mask)
    # positions: the whole padded row's count of real tokens, then sliced
    assert torch.equal(cat["positions"], pos[:, order])
    assert torch.equal(cat["attention_mask"], am[:, order])
    assert all(p["input_ids"].shape == (2, s // cp) for p in parts)
    # the loss over the slices is the in-model shift's loss over the rows
    pre = context_parallel_batch(batch, 0, 1, positions=pos, shift_labels=False)
    assert torch.equal(pre["labels"], ids) and torch.equal(pre["loss_mask"], am.float())


# ---------------------------------------------------------------------------
# config rules, dispatch and the trainer's checks
# ---------------------------------------------------------------------------


def _cfg_with(**blocks):
    cfg = {"distributed_strategy": {}, "data": {"seq_length": 64}, "model": {}}
    for k, v in blocks.items():
        cfg[k] = {**cfg.get(k, {}), **v}
    return cfg


@pytest.mark.parametrize("bad,match", [
    (_cfg_with(distributed_strategy={"context_parallel_size": 2}), "requires a context-parallel"),
    (_cfg_with(distributed_strategy={"context_parallel_size": 3},
               model={"fusions": {"ring_attention": True}}), "must be divisible by"),
    (_cfg_with(distributed_strategy={"pipeline_model_parallel_size": 2},
               model={"num_layers": 2, "fusions": {"zigzag_ring_attention": True}}),
     "not supported under pipeline"),
    (_cfg_with(model={"sliding_window": 8, "fusions": {"zigzag_ring_attention": True}}),
     "does not support sliding_window"),
    (_cfg_with(distributed_strategy={"context_parallel_size": 4}, data={"seq_length": 68},
               model={"fusions": {"zigzag_ring_attention": True}}), "2\\*context_parallel_size"),
    (_cfg_with(distributed_strategy={"context_parallel_size": 4,
                                     "tensor_model_parallel_size": 2},
               model={"num_attention_heads": 4, "fusions": {"ulysses_attention": True}}),
     "divisible by tp\\*cp"),
    (_cfg_with(distributed_strategy={"context_parallel_size": 2,
                                     "pipeline_model_parallel_size": 2},
               data={"seq_length": 4078}, model={"num_layers": 2,
                                                 "fusions": {"ring_attention": True}}),
     "divisor near the kv block"),
])
def test_cp_config_rules_match_jax(bad, match):
    msgs = []
    for ld in (t_loader, j_loader):
        with pytest.raises(ValueError, match=match) as e:
            ld.load_config(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_shipped_cp_config_is_rejected_naming_pipeline_and_kv_replication():
    """The shipped 70B CP config (pp 8, tp 32 over 8 kv heads, cp 2) passes
    ``check_supported`` as shipped: KV replication (entry 2a) and cp under
    the pipeline (entry 9, step 9d) are ported, and JAX's gate resolves its
    ``auto`` schedule to the wavefront."""
    from neuronx_distributed_training_torch.models import llama as t_llama
    from neuronx_distributed_training_torch.parallel import pipeline as t_pipe

    cfg = t_loader.load_config(REPO / "examples" / "conf" / "hf_llama3_70B_CP_config.yaml")
    ds = cfg.distributed_strategy
    assert ds.context_parallel_size == 2 and ds.pipeline_model_parallel_size == 8
    assert ds.tensor_model_parallel_size > cfg.model.num_key_value_heads
    t_loop.check_supported(cfg)
    facts = t_loop._pipeline_facts(cfg, dict(ds), dict(cfg.model))
    assert t_pipe.resolve_schedule("auto", t_llama.LlamaConfig.from_config(
        dict(cfg.model), dict(ds)), facts) == "wavefront"


@pytest.mark.parametrize("fusion", ["ring_attention", "ulysses_attention",
                                    "zigzag_ring_attention"])
def test_llama_config_takes_the_cp_impl_in_jax_order(fusion):
    from neuronx_distributed_training_tpu.models import llama as j_llama

    model = {"fusions": {"flash_attention": True, "ring_attention": True, fusion: True}}
    ds = {"context_parallel_size": 2}
    t, j = t_llama.LlamaConfig.from_config(model, ds), j_llama.LlamaConfig.from_config(model, ds)
    assert t.attention_impl == j.attention_impl and t.context_parallel and j.context_parallel


# ---------------------------------------------------------------------------
# gloo launches: the trainer against JAX at the same mesh
# ---------------------------------------------------------------------------

SEQ = 64


def cp_cfg(tmp, exp, *, fusion="ring_attention", cp=2, tp=1, sp=False, precision="fp32",
           **kw):
    """DPT's tiny model (hidden 64, 4 heads of 16, 2 kv heads) at seq 64 and
    context parallelism: the bodies take the blockwise route (Ulysses core
    attention) at these widths; the flash route is held above and over the
    real groups (``cp_units``)."""
    cfg = DPT.dp_cfg(tmp, exp, precision=precision, **kw)
    cfg["distributed_strategy"].update(context_parallel_size=cp,
                                       tensor_model_parallel_size=tp, sequence_parallel=sp)
    cfg["data"]["seq_length"] = SEQ
    cfg["model"].update(max_position_embeddings=SEQ, fusions={fusion: True})
    return cfg


class _JaxPaddedRows(j_data.DataModule):
    def __init__(self, vocab_size, seq_len, global_batch_size, *, seed):
        self.vocab_size, self.seq_len, self.seed = vocab_size, seq_len, seed
        super().__init__(1 << 12, global_batch_size, input_names=WORKER.PADDED_NAMES)

    def fetch_rows(self, idx):
        return WORKER.padded_rows(idx, seq=self.seq_len, vocab=self.vocab_size, seed=self.seed)


#: name: (fusion, precision, padded rows).  The zig-zag run is held to the
#: JAX trainer's ring run on the same weights: JAX's zig-zag computes the
#: contiguous ring's loss (its own ``test_zigzag.py::
#: test_loss_matches_contiguous_ring``), its trainer compiles three times as
#: long, and its attention is held to JAX's zig-zag function above.
PARITY2 = {"ring": ("ring_attention", "fp32", False),
           "zigzag": ("zigzag_ring_attention", "fp32", False),
           "ulysses": ("ulysses_attention", "fp32", False),
           "ring_mixed": ("ring_attention", "mixed_precision", False),
           "ring_padded": ("ring_attention", "fp32", True)}
JAX_FUSION = {"zigzag_ring_attention": "ring_attention"}
#: name: (fusion, dp, tp)
PARITY4 = {"dp2_cp2_zero1": ("ring_attention", 2, 1),
           "tp2_cp2_sp": ("ulysses_attention", 1, 2)}


def _weights(tmp, name, j0) -> str:
    return str(TPT._global_weights(j0, tmp / f"{name}_w.pt"))


def _cp2_build(tmp: Path) -> dict:
    jts, j0s, scenarios = {}, {}, []
    for name, (fusion, precision, padded) in PARITY2.items():
        key = (JAX_FUSION.get(fusion, fusion), precision, padded)
        if key not in jts:
            cfg = cp_cfg(tmp, f"jax_{name}", fusion=key[0], precision=precision)
            data = _JaxPaddedRows(128, SEQ, 8, seed=6) if padded else None
            jts[key], j0s[key] = TPT._jax_start(cfg, 2, data)
        scenarios.append({
            "name": name, "steps": 3, "dump": str(tmp / f"{name}.pt"),
            "cfg": cp_cfg(tmp, f"port_{name}", fusion=fusion, precision=precision,
                          every=2 if name == "ring" else 0),
            "weights": _weights(tmp, name, j0s[key]),
            **({"data": {"kind": "padded", "seed": 6}} if padded else {})})
    ring_w = scenarios[0]["weights"]
    scenarios += [
        {"name": "units", "kind": "cp_units"},
        {"name": "nan", "cfg": cp_cfg(tmp, "nan"), "steps": 3, "poison": {"step": 1,
                                                                         "cp_rank": 1}},
        {"name": "pre", "cfg": cp_cfg(tmp, "b", every=2), "steps": 3, "max_steps": 2,
         "dump": str(tmp / "pre.pt"), "weights": ring_w},
        {"name": "resume", "cfg": cp_cfg(tmp, "b", every=2), "steps": 3,
         "dump": str(tmp / "resume.pt"), "weights": ring_w},
    ]
    run = DPT.Launch(tmp, scenarios, nproc=2)
    fitted = {key: TPT._jax_finish(jt) for key, jt in jts.items()}
    jax_side = {name: fitted[(JAX_FUSION.get(f, f), p, pad)]
                for name, (f, p, pad) in PARITY2.items()}
    return {"tmp": tmp, "jax": jax_side, "ranks": run.results()}


@pytest.fixture(scope="module")
def cp2_runs(tmp_path_factory):
    """One launch of 2 ranks at cp 2, once a run (the JAX trainers fitted
    while the ranks run): the parity runs (the ring's saving at steps 2 and
    3, the straight run of the resume), the bodies over the group, the NaN
    on context rank 1, and a run stopped at step 2 and resumed."""
    return DPT.shared(tmp_path_factory, "cp2", _cp2_build)


def _cp4_build(tmp: Path) -> dict:
    jts, scenarios = {}, []
    for name, (fusion, dp, tp) in PARITY4.items():
        cfg = cp_cfg(tmp, f"jax_{name}", fusion=fusion, tp=tp, sp=tp > 1)
        jts[name], j0 = TPT._jax_start(cfg, 4)
        scenarios.append({"name": name, "steps": 3, "dump": str(tmp / f"{name}.pt"),
                          "cfg": cp_cfg(tmp, f"port_{name}", fusion=fusion, tp=tp, sp=tp > 1),
                          "weights": _weights(tmp, name, j0)})
    scenarios.append({"name": "units", "kind": "cp_units"})
    run = DPT.Launch(tmp, scenarios, nproc=4)
    jax_side = {name: TPT._jax_finish(jt) for name, jt in jts.items()}
    return {"tmp": tmp, "jax": jax_side, "ranks": run.results()}


@pytest.fixture(scope="module")
def cp4_runs(tmp_path_factory):
    return DPT.shared(tmp_path_factory, "cp4", _cp4_build)


def _replicas_equal(ranks, name):
    """Params and moments are bit for bit equal on the ranks that differ
    only in their context coordinate (and the loss and grad norm on all)."""
    by = {}
    for r in ranks:
        c = r[name]["coords"]
        by.setdefault((c["dp"], c["tp"]), []).append(r[name]["state_digest"])
    assert all(len(set(d)) == 1 and len(d) == 2 for d in by.values()), by
    hist = [[(h["loss"], h["grad_norm"]) for h in r[name]["history"]] for r in ranks]
    assert all(h == hist[0] for h in hist)


@pytest.mark.parametrize("name", list(PARITY2))
def test_cp2_trainer_matches_jax(cp2_runs, name):
    j1, lines = cp2_runs["jax"][name]
    ranks = cp2_runs["ranks"]
    _replicas_equal(ranks, name)
    precision = PARITY2[name][1]
    dump = torch.load(cp2_runs["tmp"] / f"{name}.pt")
    hist = ranks[0][name]["history"]
    if precision == "fp32":
        TPT._assert_matches_jax(lines, hist, dump, j1, precision)
    else:
        # the mixed_precision bars of test_torch_tp.py: loss 1e-4, grad norm 2e-3,
        # and the params bar.
        # The health groups' norms are held at 5e-3: the blockwise route's
        # plain arithmetic keeps p in fp32 for p v where JAX's rounds it to
        # bf16, and a small group (the input norms' scales, a norm of ~4e-3)
        # moves by ~2e-3 of itself with it
        np.testing.assert_allclose([h["loss"] for h in hist], [x["loss"] for x in lines],
                                   rtol=1e-4, atol=0)
        np.testing.assert_allclose([h["grad_norm"] for h in hist],
                                   [x["grad_norm"] for x in lines], rtol=2e-3, atol=0)
        keys = sorted(k for k in lines[0] if k.startswith("health/grad_norm/"))
        assert len(keys) == 7
        for k in keys:
            np.testing.assert_allclose([h[k] for h in hist], [x[k] for x in lines], rtol=5e-3,
                                       atol=0, err_msg=k)
        DPT._assert_params_bar(dump, j1, fp32=False)
    # the context ranks of the one data rank computed the same rows
    assert ranks[0][name]["rows"] == ranks[1][name]["rows"]


@pytest.mark.parametrize("name", list(PARITY4))
def test_2x2_with_cp_matches_jax(cp4_runs, name):
    j1, lines = cp4_runs["jax"][name]
    ranks = cp4_runs["ranks"]
    _replicas_equal(ranks, name)
    dump = torch.load(cp4_runs["tmp"] / f"{name}.pt")
    TPT._assert_matches_jax(lines, ranks[0][name]["history"], dump, j1, "fp32")
    coords = [r[name]["coords"] for r in ranks]
    # world ranks lay out (data, context, model) with model innermost
    fusion, dp, tp = PARITY4[name]
    assert coords == [{"dp": w // (2 * tp), "cp": (w // tp) % 2, "tp": w % tp}
                      for w in range(4)]
    if dp == 2:  # ZeRO-1 shards over data only
        assert any(full != part for full, part in ranks[0][name]["zero1_shards"].values())


def _assert_units_match_core(ranks):
    for r in ranks:
        for case, res in r["units"].items():
            assert max(res["errs"]) <= 2e-5, (case, res)
            assert (res["blockwise"] > 0) == case.endswith("blockwise"), (case, res)
            # Ulysses at head_dim 16 does not tile: flash_attention's core fallback, once
            assert res["core"] == int(case == "ulysses_core"), (case, res)


def test_cp_bodies_over_gloo_match_core(cp2_runs):
    _assert_units_match_core(cp2_runs["ranks"])


def test_cp_bodies_over_a_4_rank_ring_match_core(cp4_runs):
    """cp 4 over gloo: each rank's previous and next ranks differ, so a
    shift posted to the wrong neighbour or waited for out of order shows."""
    _assert_units_match_core(cp4_runs["ranks"])


def test_a_nan_on_one_context_rank_skips_the_step_everywhere(cp2_runs):
    ranks = [r["nan"] for r in cp2_runs["ranks"]]
    for r in ranks:
        h = r["history"]
        assert [x["health/updates_finite"] for x in h] == [1.0, 0.0, 1.0]
        assert h[2]["health/skipped_count"] == 1.0 and np.isfinite(h[2]["loss"])
        assert r["opt_step"] == 2 and r["health"]["skipped_count"] == 1
    assert ranks[0]["state_digest"] == ranks[1]["state_digest"]


def test_cp2_checkpoint_resumes_bitwise_and_restores_at_cp1(cp2_runs):
    tmp, r0 = cp2_runs["tmp"], cp2_runs["ranks"][0]
    assert r0["ring"]["committed"] == [2, 3] and r0["pre"]["committed"] == [2]
    assert [h["step"] for h in r0["resume"]["history"]] == [2]
    assert (r0["resume"]["history"][0]["loss"], r0["resume"]["history"][0]["grad_norm"]) == \
        (r0["ring"]["history"][2]["loss"], r0["ring"]["history"][2]["grad_norm"])
    a, b = torch.load(tmp / "ring.pt"), torch.load(tmp / "resume.pt")
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]
    # the saved layout is the one without cp: it restores in one process
    # (cp 1: the ring fusion is core attention there) bit for bit, and trains
    # step 3 as the cp 2 run did within the fp32 tolerance
    from neuronx_distributed_training_torch.checkpoint import integrity as ck_integrity

    ck_b = tmp / "b" / "dp" / "version_0" / "checkpoints"
    assert ck_integrity.verify_step(ck_b, 2).status == "ok"
    dst = tmp / "c" / "dp" / "version_0" / "checkpoints"
    shutil.copytree(ck_b / "2", dst / "2")
    c = t_loop.Trainer.from_config(t_loader.load_config(cp_cfg(tmp, "c", cp=1)), device="cpu")
    assert c.maybe_resume() and c.step == 2
    pre = torch.load(tmp / "pre.pt")
    live = {f"params/{n}": t for n, t in t_llama.named_params(c.params).items()}
    live.update({f"{g}/{n}": t for g in ("mu", "nu") for n, t in c.opt_state[g].items()})
    assert all(torch.equal(pre[k], live[k]) for k in live), [k for k in live
                                                            if not torch.equal(pre[k], live[k])]
    h3 = c.fit()
    assert np.isclose(h3[0]["loss"], r0["ring"]["history"][2]["loss"], rtol=1e-5, atol=0)
    assert np.isclose(h3[0]["grad_norm"], r0["ring"]["history"][2]["grad_norm"],
                      rtol=1e-5, atol=0)
    meta = json.loads((ck_b / "2" / "integrity.json").read_text())
    assert meta["tree"]["params"]["layers.0.attn.qkv.w:q"]["shape"] == [64, 64]
