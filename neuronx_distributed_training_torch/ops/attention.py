"""Attention ops (counterpart of the JAX package's ``ops/attention.py``).

``core_attention`` is the numerics reference: naive attention with an fp32
softmax.  ``attention`` dispatches between it, the flash kernels
(``ops/flash_attention.py``) and the context-parallel bodies
(``parallel/ring_attention.py``, ``parallel/ulysses.py``), which take the
context group ``cp`` and fall back to core attention without one, as the JAX
package's do at cp == 1.  Layout is ``[batch, seq, heads, head_dim]``; GQA
repeats K/V to the query heads on the fly.

Unlike the JAX package there is no fallback when a kernel is missing: a kernel
that cannot build or launch raises.
"""

from __future__ import annotations

from typing import Optional

import torch

_CP_IMPLS = ("ring", "ulysses", "zigzag_ring")


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, s, kv_heads, d] -> [b, s, kv_heads * n_rep, d]."""
    if n_rep == 1:
        return x
    b, s, kvh, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kvh, n_rep, d).reshape(b, s, kvh * n_rep, d)


def _neg(dtype) -> float:
    return torch.finfo(dtype).min / 2


def causal_mask_bias(q_len: int, kv_len: int, *, q_offset: int = 0,
                     sliding_window: Optional[int] = None, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Additive bias ``[q_len, kv_len]``: 0 where visible, a large negative
    where masked; ``q_offset`` is the absolute position of query row 0."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    visible = kv_pos <= q_pos
    if sliding_window is not None:
        visible = visible & (kv_pos > q_pos - sliding_window)
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(visible, zero, torch.full((), _neg(dtype), dtype=dtype, device=device))


def core_attention(
    q: torch.Tensor,  # [b, sq, h, d]
    k: torch.Tensor,  # [b, skv, kvh, d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    sliding_window: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
    softmax_dtype=torch.float32,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    if kvh != h:
        k = repeat_kv(k, h // kvh)
        v = repeat_kv(v, h // kvh)
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=softmax_dtype))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(softmax_dtype), k.to(softmax_dtype))
    scores = scores * scale.to(q.device)
    if causal:
        scores = scores + causal_mask_bias(sq, k.shape[1], q_offset=q_offset,
                                           sliding_window=sliding_window,
                                           dtype=softmax_dtype, device=q.device)
    if bias is not None:
        scores = scores + bias.to(softmax_dtype)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def padding_mask_bias(attention_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``attention_mask`` [b, skv] (1 = real token) -> additive bias
    [b, 1, 1, skv] masking padded keys."""
    zero = torch.zeros((), dtype=dtype, device=attention_mask.device)
    neg = torch.full((), _neg(dtype), dtype=dtype, device=attention_mask.device)
    return torch.where(attention_mask.bool(), zero, neg)[:, None, None, :]


def segment_mask_bias(segment_ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``segment_ids`` [b, s] -> additive bias [b, 1, s, s] restricting
    attention to same-segment pairs."""
    zero = torch.zeros((), dtype=dtype, device=segment_ids.device)
    neg = torch.full((), _neg(dtype), dtype=dtype, device=segment_ids.device)
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    return torch.where(same, zero, neg)[:, None, :, :]


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str = "core",  # "core" | "flash" | "ring" | "ulysses" | "zigzag_ring"
    causal: bool = True,
    q_offset: int = 0,
    sliding_window: Optional[int] = None,
    softmax_dtype=torch.float32,
    attention_mask: Optional[torch.Tensor] = None,  # [b, skv] 1 = attend
    segment_ids: Optional[torch.Tensor] = None,  # [b, s] packed-record segments
    cp=None,  # parallel/mesh.py::ContextParallel (the cp impls)
    tp_size: int = 1,  # tensor-parallel degree (Ulysses's head rule)
) -> torch.Tensor:
    """Dispatch between core, flash and the context-parallel attention with
    the JAX package's rejection rules: zig-zag takes no padding mask and no
    window, no cp impl takes segments or an explicit ``q_offset``."""
    if attention_mask is not None and impl == "zigzag_ring":
        raise ValueError(
            "zigzag_ring does not support attention_mask (padded batches); "
            "use fusions.ring_attention"
        )
    if segment_ids is not None and impl in _CP_IMPLS:
        raise ValueError(
            f"segment_ids (packed-sequence masking) is supported by the "
            f"flash and core paths only, not {impl!r}"
        )
    if impl in _CP_IMPLS and q_offset:
        what = {"ring": "ring attention derives global positions from the mesh",
                "ulysses": "ulysses attention derives global positions from the mesh",
                "zigzag_ring": "zigzag ring derives positions from the layout"}[impl]
        raise ValueError(f"{what}; an explicit q_offset is not meaningful here")
    if impl == "ring":
        from neuronx_distributed_training_torch.parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, causal=causal, sliding_window=sliding_window, cp=cp,
                              attention_mask=attention_mask)
    if impl == "ulysses":
        from neuronx_distributed_training_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, causal=causal, sliding_window=sliding_window, cp=cp,
                                 tp_size=tp_size, attention_mask=attention_mask)
    if impl == "zigzag_ring":
        from neuronx_distributed_training_torch.parallel.ring_attention import (
            zigzag_ring_attention,
        )

        if sliding_window is not None:
            raise ValueError("zigzag ring does not support sliding_window; use "
                             "ring_attention (contiguous layout) for windowed models")
        return zigzag_ring_attention(q, k, v, causal=causal, cp=cp)
    if impl == "flash":
        from neuronx_distributed_training_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, sliding_window=sliding_window,
                               q_offset=q_offset, attention_mask=attention_mask,
                               segment_ids=segment_ids)
    if impl != "core":
        raise ValueError(f"unknown attention impl {impl!r}")
    bias = None
    if attention_mask is not None:
        bias = padding_mask_bias(attention_mask, softmax_dtype)
    if segment_ids is not None:
        seg_bias = segment_mask_bias(segment_ids, softmax_dtype)
        bias = seg_bias if bias is None else bias + seg_bias
    return core_attention(q, k, v, causal=causal, q_offset=q_offset,
                          sliding_window=sliding_window, bias=bias,
                          softmax_dtype=softmax_dtype)
