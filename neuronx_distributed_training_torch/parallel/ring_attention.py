"""Ring and zig-zag ring attention over the ``context`` axis (counterpart of
the JAX package's ``parallel/ring_attention.py``).

Each context rank holds ``s/cp`` of the sequence: q, k, v ``[b, s/cp, h,
d]``.  ``cp`` ring steps attend the rank's queries to the K/V chunk it holds,
then pass that chunk on to the next rank (rank ``r`` sends to ``r + 1`` and
receives from ``r - 1``, JAX's ``ppermute`` ring), so at step ``t`` rank
``my`` holds the chunk of rank ``my - t``.  Each chunk's normalised partial
``(o, lse)`` merges into the running one (:func:`_merge_partial`), which is
exact softmax recombination.

Where JAX gets the backward from autodiff through ``ppermute``, the port
writes it: one ``torch.autograd.Function`` per ring body (:class:`_Ring`),
whose backward runs the ring again.  It calls the dq and dk/dv kernels on
each chunk with the **merged** lse and ``delta = rowsum(do * o)`` of the
merged o, which is the whole-sequence attention's gradient restricted to the
chunk; the fp32 dk/dv accumulators travel with their K/V chunk and come home
with one more shift after the last step.  A causal chunk with no visible key
(rank ``my``'s future) is skipped on both passes, and every rank still runs
every shift, so the sends and receives always pair up.

The bodies are generators (:func:`ring_forward`, :func:`ring_backward`).  A
shift is two yields: ``("post", tensors)`` starts sending the tensors to the
next rank and is sent back a handle; ``("wait", handle)`` is sent back what
arrived from the previous rank.  Each step posts the next chunk before its
kernels and waits for it after them, so the transfer runs under the kernels;
in the backward the dk/dv accumulator that arrives for the held chunk is
waited for only after that chunk's kernels, and its own sum is posted on.
:func:`drive` answers the yields with the context group's point-to-point
messages (``parallel/mesh.py::ContextParallel``).  Computation and
communication are thus separate: a loopback that answers the yields of all
``cp`` bodies at once runs every rank in one process (the tests and
``chip_smoke.py`` phase 10a do).

Per chunk the bodies run one of two routes, chosen from the shapes as JAX
does: the flash kernels (``ops/flash_attention.py``: ``flash_fwd``,
``flash_dq``, ``flash_dkv``; their plain versions on CPU tensors) when
``flash_tileable`` accepts the chunk, else the blockwise route: the plain
functions over kv blocks of ``block_kv`` rows merged online (JAX's
``_chunk_update``), counted in ``FALLBACKS["blockwise"]``.

Zig-zag (:func:`zigzag_ring_attention`): the sequence is cut into ``2 cp``
chunks and rank ``r`` holds chunks ``r`` and ``2 cp - 1 - r``
(:func:`zigzag_positions`; the trainer permutes the batch so, with JAX's
``zigzag_transform_batch`` rule, in ``data/loader.py::
context_parallel_batch``); each (q half, kv half) pair is a
plain causal diagonal, fully visible or skipped, so every rank computes
``2 cp + 1`` pairs (:func:`zigzag_pairs`).

Under pipeline parallelism the JAX package attends with
:func:`blockwise_gspmd_attention`, global online-softmax attention over kv
blocks whose context collectives GSPMD inserts (a nested manual region
would deadlock there).  The port keeps these ring bodies under pp: its pipe
and context axes are separate process groups, and a ring completes inside
each layer call of a stage.  :func:`blockwise_gspmd_attention` is ported as
the plain whole-sequence function, the counterpart its tests hold the
bodies and JAX's function against.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from neuronx_distributed_training_torch.ops import flash_attention as fa

NEG_INF = fa.NEG_INF


def _merge_partial(o_acc, lse_acc, o_c, lse_c):
    """Online merge of a normalised partial result: ``(o_acc [b, h, sq, d]
    fp32, lse_acc [b, h, sq])`` with a chunk's ``(o_c, lse_c)``.
    ``o = sum_i o_i exp(lse_i - lse)``, ``lse = logaddexp_i lse_i``; a chunk
    with no visible key carries ``lse_c = NEG_INF`` and drops out through the
    guarded weights (``exp(NEG_INF - NEG_INF)`` must not become 1)."""
    top = torch.maximum(lse_acc, lse_c)
    lse_new = top + torch.log1p(torch.exp(-torch.abs(lse_acc - lse_c)))
    lse_new = torch.where(top > NEG_INF / 2, lse_new, NEG_INF)
    w_prev = torch.where(lse_acc > NEG_INF / 2, torch.exp(lse_acc - lse_new), 0.0)
    w_c = torch.where(lse_c > NEG_INF / 2, torch.exp(lse_c - lse_new), 0.0)
    return o_acc * w_prev[..., None] + o_c.float() * w_c[..., None], lse_new


# ---------------------------------------------------------------------------
# what each ring step computes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pair:
    """One block of a ring step: query rows ``q`` of the rank against rows
    ``kv`` of the chunk it holds, with the kernels' mask arguments."""

    q: slice
    kv: slice
    causal: bool
    window: Optional[int] = None
    q_offset: int = 0


def ring_pairs(t: int, my: int, cp: int, sq: int, *, causal: bool = True,
               window: Optional[int] = None) -> list[Pair]:
    """What rank ``my`` computes at ring step ``t`` of the contiguous layout
    (JAX ``_ring_local_flash``): its own chunk causally at ``t == 0``; the
    chunk of rank ``my - t`` whole when it lies in the past (``my >= t``),
    where only a window masks, at the relative offset ``t * sq``; nothing for
    a future chunk.  Not causal: every chunk, unmasked."""
    whole = slice(0, sq)
    if not causal:
        return [Pair(whole, whole, False)]
    if t == 0:
        return [Pair(whole, whole, True, window, 0)]
    if my >= t:
        return [Pair(whole, whole, False, window, t * sq if window is not None else 0)]
    return []


def zigzag_pairs(t: int, my: int, cp: int, hc: int) -> list[Pair]:
    """The (q half, kv half) pairs rank ``my`` computes at step ``t`` of the
    zig-zag ring (JAX ``_pair_attn``): a kv chunk before the q chunk is
    whole, the same chunk is causal, a later one is skipped.  Over the ``cp``
    steps every rank gets ``2 cp + 1`` pairs, whatever its index."""
    src = (my - t) % cp
    mine, held = (my, 2 * cp - 1 - my), (src, 2 * cp - 1 - src)
    out = []
    for qi, qc in enumerate(mine):
        for ki, kc in enumerate(held):
            if kc <= qc:
                out.append(Pair(slice(qi * hc, (qi + 1) * hc), slice(ki * hc, (ki + 1) * hc),
                                kc == qc))
    return out


# ---------------------------------------------------------------------------
# the two routes a pair runs
# ---------------------------------------------------------------------------


def _kv_blocks(skv: int, block_kv: int) -> list[tuple[int, int]]:
    """JAX ``_chunk_update``'s blocks: ``min(block_kv, skv)`` rows, or one
    block when that does not divide ``skv``."""
    bkv = min(block_kv, skv)
    if skv % bkv:
        bkv = skv
    return [(lo, lo + bkv) for lo in range(0, skv, bkv)]


def _rows(t: Optional[torch.Tensor], rows: slice) -> Optional[torch.Tensor]:
    return None if t is None else t[:, rows].contiguous()


def _blockwise_fwd(q, k, v, kvm=None, seg=None, *, causal, window, q_offset, block_kv):
    """(o fp32 [b, sq, nh, d], lse [b, nh, sq]) over kv blocks, merged
    online (the plain forward on each block)."""
    b, sq, nh, d = q.shape
    o = torch.zeros((b, nh, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, nh, sq), NEG_INF, dtype=torch.float32, device=q.device)
    qf = q.float()
    for lo, hi in _kv_blocks(k.shape[1], block_kv):
        o_b, lse_b = fa.flash_fwd_plain(qf, k[:, lo:hi], v[:, lo:hi], _rows(kvm, slice(lo, hi)),
                                        causal=causal, window=window, q_offset=q_offset - lo)
        o, lse = _merge_partial(o, lse, o_b.transpose(1, 2), lse_b)
    fa.FALLBACKS["blockwise"] += 1
    return torch.where(lse[..., None] > NEG_INF / 2, o, 0.0).transpose(1, 2), lse


def _blockwise_dq(q, k, v, do, lse, delta, kvm=None, seg=None, *, causal, window, q_offset,
                  block_kv):
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    qf, dof = q.float(), do.float()
    for lo, hi in _kv_blocks(k.shape[1], block_kv):
        dq += fa.flash_dq_plain(qf, k[:, lo:hi], v[:, lo:hi], dof, lse, delta,
                                _rows(kvm, slice(lo, hi)), causal=causal, window=window,
                                q_offset=q_offset - lo)
    return dq


def _blockwise_dkv(q, k, v, do, lse, delta, kvm=None, seg=None, *, causal, window, q_offset,
                   block_kv):
    qf, dof = q.float(), do.float()
    parts = [fa.flash_dkv_plain(qf, k[:, lo:hi].float(), v[:, lo:hi].float(), dof, lse, delta,
                                _rows(kvm, slice(lo, hi)), causal=causal, window=window,
                                q_offset=q_offset - lo)
             for lo, hi in _kv_blocks(k.shape[1], block_kv)]
    return torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1)


@dataclasses.dataclass(frozen=True)
class Route:
    """The forward, dq and dk/dv functions a pair runs (the flash kernel
    wrappers' signatures)."""

    name: str
    fwd: Callable
    dq: Callable
    dkv: Callable


FLASH = Route("flash", fa.flash_fwd, fa.flash_dq, fa.flash_dkv)


def blockwise_route(block_kv: int) -> Route:
    return Route("blockwise", *(functools.partial(fn, block_kv=block_kv)
                                for fn in (_blockwise_fwd, _blockwise_dq, _blockwise_dkv)))


def pick_route(sq: int, skv: int, d: int, nh: int, nkv: int, block_kv: int) -> Route:
    """The flash kernels when these chunk shapes tile, else the blockwise
    route (JAX picks the same way, ``flash_tileable`` on the local shapes)."""
    return FLASH if fa.flash_tileable(sq, skv, d, nh, nkv) else blockwise_route(block_kv)


def pick_bkv(s: int, block_kv: int) -> tuple[int, bool]:
    """Largest divisor of ``s`` no bigger than ``block_kv``, and whether the
    choice is degraded (more than 8x smaller than asked).  The config's
    pp x cp rule uses it, as in the JAX package."""
    bkv = max(1, min(block_kv, s))
    while s % bkv:
        bkv -= 1
    return bkv, bkv * 8 < min(block_kv, s)


def blockwise_gspmd_attention(q, k, v, *, causal: bool = True,
                              sliding_window: Optional[int] = None, block_kv: int = 512,
                              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's cp attention under pipeline parallelism, as a plain function
    of the whole sequence: q ``[b, s, h, d]``, k / v ``[b, s, kvh, d]``
    (GQA by head index), the online softmax over kv blocks of
    :func:`pick_bkv` rows (the largest divisor of ``s`` up to ``block_kv``),
    causal with an optional window, ``attention_mask`` ``[b, s]`` (1 = a
    real key) masking padded keys; rows with no visible key are 0.  fp32
    inside, q's dtype out, differentiable by autograd."""
    b, s, nh, d = q.shape
    bkv, _ = pick_bkv(s, block_kv)
    kvm = None if attention_mask is None else attention_mask.to(torch.int32)
    o = torch.zeros((b, nh, s, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, nh, s), NEG_INF, dtype=torch.float32, device=q.device)
    qf = q.float()
    for lo in range(0, s, bkv):
        kb, vb = k[:, lo:lo + bkv], v[:, lo:lo + bkv]
        sc = fa._masked_scores(qf, kb, _rows(kvm, slice(lo, lo + bkv)), None, causal,
                               sliding_window, -lo)
        m = torch.amax(sc, dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        l_b = torch.sum(p, dim=-1, keepdim=True)
        o_b = torch.matmul(p, fa._heads_first(vb, nh // k.shape[2])) / l_b
        lse_b = torch.where(m > NEG_INF / 2, m + torch.log(l_b), NEG_INF).squeeze(-1)
        o, lse = _merge_partial(o, lse, o_b, lse_b)
    o = torch.where(lse[..., None] > NEG_INF / 2, o, 0.0)
    return o.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# the bodies, and how they are driven
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    """A rank's ring: the pairs of each of the ``cp`` steps and the route."""

    steps: tuple  # (tuple of Pair, ...) per ring step
    route: Route


def ring_plan(my: int, cp: int, sq: int, d: int, nh: int, nkv: int, *, causal: bool = True,
              window: Optional[int] = None, block_kv: int = 512) -> Plan:
    return Plan(tuple(tuple(ring_pairs(t, my, cp, sq, causal=causal, window=window))
                      for t in range(cp)), pick_route(sq, sq, d, nh, nkv, block_kv))


def zigzag_plan(my: int, cp: int, s_local: int, d: int, nh: int, nkv: int) -> Plan:
    hc = s_local // 2
    return Plan(tuple(tuple(zigzag_pairs(t, my, cp, hc)) for t in range(cp)),
                pick_route(hc, hc, d, nh, nkv, hc))


def ring_forward(q, kv, kvm, plan: Plan):
    """Generator body of one rank's forward.  ``q [b, sq, nh, d]``, ``kv
    [2, b, sq, nkv, d]`` (k and v stacked: one message a shift), ``kvm``
    None or the int32 key mask ``[b, sq]`` that travels with them.  Each
    step but the last posts ``[kv, kvm]`` before its kernels and waits for
    the next chunk after them; returns ``(o [b, sq, nh, d] in q's dtype,
    lse fp32 [b, nh, sq])``."""
    b, sq, nh, d = q.shape
    o_acc = torch.zeros((b, nh, sq, d), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((b, nh, sq), NEG_INF, dtype=torch.float32, device=q.device)
    last = len(plan.steps) - 1
    for t, pairs in enumerate(plan.steps):
        if t < last:
            pending = yield "post", [kv, kvm]
        for p in pairs:
            o_c, lse_c = plan.route.fwd(q[:, p.q], kv[0][:, p.kv], kv[1][:, p.kv],
                                        _rows(kvm, p.kv), None, causal=p.causal,
                                        window=p.window, q_offset=p.q_offset)
            o_acc[:, :, p.q], lse_acc[:, :, p.q] = _merge_partial(
                o_acc[:, :, p.q], lse_acc[:, :, p.q], o_c.transpose(1, 2), lse_c)
        if t < last:
            kv, kvm = yield "wait", pending
    o = torch.where(lse_acc[..., None] > NEG_INF / 2, o_acc, 0.0)
    return o.transpose(1, 2).contiguous().to(q.dtype), lse_acc


def ring_backward(q, kv, kvm, o, lse, do, plan: Plan):
    """Generator body of one rank's backward: ``(dq, dkv)`` in the inputs'
    dtypes, ``dkv`` the gradient of this rank's own ``kv``.  The fp32 dk/dv
    accumulator travels one step behind the chunk it belongs to: each step
    adds the one that arrived for the held chunk to its own part after the
    kernels and posts the sum on; the last step's post brings each home
    (after the last step a rank holds the chunk of the next rank)."""
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    last = len(plan.steps) - 1
    for t, pairs in enumerate(plan.steps):
        if t < last:
            pending = yield "post", [kv, kvm]
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
        for p in pairs:
            args = (q[:, p.q], kv[0][:, p.kv], kv[1][:, p.kv], do[:, p.q],
                    lse[:, :, p.q].contiguous(), delta[:, :, p.q].contiguous(),
                    _rows(kvm, p.kv), None)
            kw = dict(causal=p.causal, window=p.window, q_offset=p.q_offset)
            dq[:, p.q] += plan.route.dq(*args, **kw).float()
            dk, dv = plan.route.dkv(*args, **kw)
            dkv[0][:, p.kv] += dk.float()
            dkv[1][:, p.kv] += dv.float()
        if t > 0:
            (came,) = yield "wait", arriving
            dkv += came
        if last > 0:
            arriving = yield "post", [dkv]
        if t < last:
            kv, kvm = yield "wait", pending
    if last > 0:
        (dkv,) = yield "wait", arriving
    return dq.to(q.dtype), dkv.to(kv.dtype)


def drive(body, exchange: Callable) -> Any:
    """Run a body generator to its end, answering each ``(op, tensors)`` it
    yields with ``exchange(op, tensors)``; returns what the body returns."""
    try:
        request = next(body)
        while True:
            request = body.send(exchange(*request))
    except StopIteration as stop:
        return stop.value


def _exchange(cp) -> Callable:
    """The context group's answer to a ring body's yields."""

    def exchange(op: str, payload):
        if op == "post":
            return cp.post(payload)
        if op == "wait":
            return cp.wait(payload)
        raise ValueError(f"ring bodies only post and wait; got {op!r}")

    return exchange


class _Ring(torch.autograd.Function):
    """The whole ring of one rank (forward and backward) as one autograd
    node: saves q, the stacked k/v, the key mask, o and the merged lse."""

    @staticmethod
    def forward(ctx, q, k, v, kvm, cp, plan):
        kv = torch.stack([k, v])
        o, lse = drive(ring_forward(q, kv, kvm, plan), _exchange(cp))
        ctx.save_for_backward(q, kv, kvm, o, lse)
        ctx.cp, ctx.plan = cp, plan
        return o

    @staticmethod
    def backward(ctx, do):
        q, kv, kvm, o, lse = ctx.saved_tensors
        dq, dkv = drive(ring_backward(q, kv, kvm, o, lse, do, ctx.plan), _exchange(ctx.cp))
        return dq, dkv[0], dkv[1], None, None, None


def _core(q, k, v, *, causal, sliding_window=None, attention_mask=None):
    from neuronx_distributed_training_torch.ops.attention import core_attention, padding_mask_bias

    return core_attention(q, k, v, causal=causal, sliding_window=sliding_window,
                          bias=None if attention_mask is None
                          else padding_mask_bias(attention_mask))


def _key_mask(attention_mask, b: int, sq: int):
    if attention_mask is None:
        return None
    if tuple(attention_mask.shape) != (b, sq):
        raise ValueError(f"attention_mask must be this rank's [batch, seq/cp] = ({b}, {sq}); "
                         f"got {tuple(attention_mask.shape)}")
    return attention_mask.to(torch.int32).contiguous()


def ring_attention(
    q: torch.Tensor,  # [b, s/cp, h, d]: this context rank's chunk
    k: torch.Tensor,  # [b, s/cp, kvh, d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    cp=None,  # parallel/mesh.py::ContextParallel
    block_kv: int = 512,
    attention_mask: Optional[torch.Tensor] = None,  # [b, s/cp] 1 = real key
) -> torch.Tensor:
    """Context-parallel ring attention over ``cp``'s group.  Without a
    context group (``cp`` None or of size 1) it is core attention with the
    padding bias, as in the JAX package.  The window is causal-only."""
    if not causal:
        sliding_window = None
    if cp is None or cp.size == 1:
        return _core(q, k, v, causal=causal, sliding_window=sliding_window,
                     attention_mask=attention_mask)
    b, sq, nh, d = q.shape
    plan = ring_plan(cp.rank, cp.size, sq, d, nh, k.shape[2], causal=causal,
                     window=sliding_window, block_kv=block_kv)
    return _Ring.apply(q, k, v, _key_mask(attention_mask, b, sq), cp, plan)


# ---------------------------------------------------------------------------
# zig-zag layout
# ---------------------------------------------------------------------------


def zigzag_positions(s: int, cp: int, device=None) -> torch.Tensor:
    """Original position of each slot of the zig-zag layout (int64 ``[s]``):
    rank ``r``'s contiguous slots hold chunks ``r`` and ``2 cp - 1 - r`` of
    ``2 cp``.  ``cp == 1`` is the identity."""
    if s % (2 * cp) != 0:
        raise ValueError(f"zigzag: seq {s} must divide by 2*cp = {2 * cp}")
    hc = s // (2 * cp)
    idx = []
    for r in range(cp):
        idx.append(torch.arange(r * hc, (r + 1) * hc, device=device))
        idx.append(torch.arange((2 * cp - 1 - r) * hc, (2 * cp - r) * hc, device=device))
    return torch.cat(idx)


def zigzag_ring_attention(
    q: torch.Tensor,  # [b, s/cp, h, d] in the zig-zag layout
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    cp=None,  # parallel/mesh.py::ContextParallel
) -> torch.Tensor:
    """Balanced causal ring attention over the zig-zag layout.  Without a
    context group the layout is the identity and this is core attention.
    Causal only: a non-causal ring has no imbalance to fix."""
    if not causal:
        raise ValueError("zigzag ring is causal-only; use ring_attention")
    if cp is None or cp.size == 1:
        return _core(q, k, v, causal=True)
    b, s_local, nh, d = q.shape
    if s_local % 2:
        raise ValueError(f"zigzag ring: seq {s_local * cp} must divide by 2*cp = {2 * cp}")
    plan = zigzag_plan(cp.rank, cp.size, s_local, d, nh, k.shape[2])
    return _Ring.apply(q, k, v, None, cp, plan)
