"""Ulysses (all-to-all) context parallelism (counterpart of the JAX package's
``parallel/ulysses.py``).

Outside attention the sequence stays split over ``context`` (the ring's
layout, so the trainer's batch split, RoPE positions and loss are shared).
For attention one all-to-all trades each rank's ``s/cp`` sequence chunk of
all its heads for the whole sequence of ``h/cp`` of them; attention then
runs locally over the full sequence through ``flash_attention`` (its
kernels when the shapes tile, else its counted core fallback with the
padding bias; causal at offset 0, no ring and no merge); a second all-to-all restores the
sequence split.  The key mask is all-gathered (bytes per token, no
gradient).  Each all-to-all is an autograd Function (:class:`_AllToAll`)
whose backward is the same all-to-all, which is its own inverse.

Ulysses needs ``h`` divisible by ``tp * cp``.  KV heads repeat
(consecutively, so a query head's group still finds its kv head) until they
divide ``tp * cp``; autograd sums the replicas' gradients.  tp divides the
kv heads in the port, so the repeat is the same on each rank's local heads
as on the global ones: tp 8 x cp 2 with 8 kv heads repeats each twice.  At
tp above the kv heads each rank holds one kv head, replicated over tp/nkv
ranks (``parallel/sharding.py``), so the count it repeats is the one after
that replication, tp: tp 32 x cp 2 with 8 kv heads repeats each rank's
head twice, as JAX's repeat of 8 heads to 64 puts two copies on each.

Like the ring, the body is a generator (:func:`ulysses_body`) that yields
``("all_to_all", buffers)`` and ``("all_gather", [mask])`` and is sent back
the result, so one process can drive every rank through a loopback.  Send
buffers are ``[cp, ...]``: chunk ``j`` goes to context rank ``j``
(``all_to_all_single`` on contiguous memory).
"""

from __future__ import annotations

from typing import Optional

import torch

from neuronx_distributed_training_torch.ops import flash_attention as fa
from neuronx_distributed_training_torch.parallel.ring_attention import _core, _key_mask, drive
from neuronx_distributed_training_torch.parallel.tensor_parallel import gather_seq


def _pack_heads(x: torch.Tensor, cp: int) -> torch.Tensor:
    """``[b, sq, h, d]`` -> ``[cp, b, sq, h/cp, d]``: chunk ``j`` is head group ``j``."""
    b, sq, h, d = x.shape
    return x.reshape(b, sq, cp, h // cp, d).permute(2, 0, 1, 3, 4).contiguous()


def _unpack_seq(buf: torch.Tensor) -> torch.Tensor:
    """``[cp, b, sq, hg, d]`` (chunk ``i``: sequence chunk ``i``) -> ``[b, cp sq, hg, d]``."""
    cp, b, sq, hg, d = buf.shape
    return buf.permute(1, 0, 2, 3, 4).reshape(b, cp * sq, hg, d)


def _pack_seq(x: torch.Tensor, cp: int) -> torch.Tensor:
    """``[b, s, hg, d]`` -> ``[cp, b, s/cp, hg, d]``: chunk ``j`` is sequence chunk ``j``."""
    b, s, hg, d = x.shape
    return x.reshape(b, cp, s // cp, hg, d).transpose(0, 1).contiguous()


def _unpack_heads(buf: torch.Tensor) -> torch.Tensor:
    """``[cp, b, sq, hg, d]`` (chunk ``i``: head group ``i``) -> ``[b, sq, cp hg, d]``."""
    cp, b, sq, hg, d = buf.shape
    return buf.permute(1, 2, 0, 3, 4).reshape(b, sq, cp * hg, d)


def ulysses_body(q, k, v, kvm, *, cp: int, causal: bool, window: Optional[int]):
    """Generator body of one rank: q ``[b, s/cp, h_l, d]``, k/v ``[b, s/cp,
    kvh_l, d]`` with ``h_l`` and ``kvh_l`` divisible by ``cp``; ``kvm`` None
    or the int32 key mask ``[b, s/cp]``.  Returns o ``[b, s/cp, h_l, d]``."""
    qb, kb, vb = yield "all_to_all", [_pack_heads(x, cp) for x in (q, k, v)]
    qf, kf, vf = (_unpack_seq(x) for x in (qb, kb, vb))
    mf = None
    if kvm is not None:
        (mf,) = yield "all_gather", [kvm]
    o = fa.flash_attention(qf, kf, vf, causal=causal, sliding_window=window, attention_mask=mf)
    (ob,) = yield "all_to_all", [_pack_seq(o, cp)]
    return _unpack_heads(ob)


class _AllToAll(torch.autograd.Function):
    """``ContextParallel.all_to_all`` with the same all-to-all as backward."""

    @staticmethod
    def forward(ctx, buf, cp):
        ctx.cp = cp
        return cp.all_to_all(buf)

    @staticmethod
    def backward(ctx, g):
        return ctx.cp.all_to_all(g), None


def _exchange(cp):
    def exchange(op: str, tensors: list):
        if op == "all_to_all":
            return [_AllToAll.apply(t, cp) for t in tensors]
        if op == "all_gather":
            return [gather_seq(t, cp) for t in tensors]
        raise ValueError(f"the Ulysses body does not yield {op!r}")

    return exchange


def kv_replication(nkv: int, tp: int, cp: int) -> int:
    """How many times each kv head repeats so that the kv heads divide
    ``tp * cp`` (1: none), with the JAX package's error when they cannot."""
    if nkv % (tp * cp) == 0:
        return 1
    if (tp * cp) % nkv != 0:
        raise ValueError(f"ulysses attention: kv_heads {nkv} and tp*cp {tp * cp} must "
                         f"divide one another")
    return (tp * cp) // nkv


def ulysses_attention(
    q: torch.Tensor,  # [b, s/cp, h/tp, d]: this rank's chunk and heads
    k: torch.Tensor,  # [b, s/cp, kvh/tp, d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    cp=None,  # parallel/mesh.py::ContextParallel
    tp_size: int = 1,
    attention_mask: Optional[torch.Tensor] = None,  # [b, s/cp] 1 = real key
) -> torch.Tensor:
    """All-to-all context-parallel attention over ``cp``'s group.  Without a
    context group it is core attention with the padding bias, as the ring."""
    if not causal:
        sliding_window = None
    if cp is None or cp.size == 1:
        return _core(q, k, v, causal=causal, sliding_window=sliding_window,
                     attention_mask=attention_mask)
    b, sq, h_l, _ = q.shape
    n, tp = cp.size, tp_size
    # the kv heads after tp's replication (tp of them above the kv heads)
    h, kvh = h_l * tp, k.shape[2] * tp
    if h % (tp * n) != 0:
        raise ValueError(
            f"ulysses attention: num_heads {h} must be divisible by tp*cp = "
            f"{tp}*{n} (use ring attention when cp exceeds the head budget)")
    mult = kv_replication(kvh, tp, n)
    if mult > 1:
        k = k.repeat_interleave(mult, dim=2)
        v = v.repeat_interleave(mult, dim=2)
    body = ulysses_body(q, k, v, _key_mask(attention_mask, b, sq), cp=n, causal=causal,
                        window=sliding_window)
    return drive(body, _exchange(cp))
