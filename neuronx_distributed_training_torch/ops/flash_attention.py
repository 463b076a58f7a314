"""Flash attention on three hand-written Hopper kernels (counterpart of the
JAX package's ``ops/flash_attention.py``).

Kernels (CUDA C++ for sm_90a under ``csrc/``, built by ``utils/build.py``):

- ``flash_fwd`` (``csrc/flash_fwd.cu``) replaces ``_fwd_kernel``;
- ``flash_dq`` (``csrc/flash_dq.cu``) replaces ``_dq_kernel``;
- ``flash_dkv`` (``csrc/flash_dkv.cu``) replaces ``_dkv_kernel``.

Each kernel has a wrapper of the same name and a plain PyTorch version
(``*_plain``) beside it.  A wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it launches its kernel or raises — nothing falls
back.  ``LAUNCHES`` counts kernel launches (never plain calls), so a run can
show that its main path went through the kernels.  The source notes on what
bounds each kernel on the card sit at the top of the ``.cu`` files.

Semantics kept from the TPU kernels: scale ``1/sqrt(d)``; masked scores are
``NEG_INF``; a row with no visible key gives o = 0 and lse = ``NEG_INF``, and
the backward zeroes p there; causal / sliding-window masking with
``q_offset``; a key-padding mask; packed segments; GQA by index; exact
skipping of fully masked tiles.  The port's lse is a plain fp32
``[b, nh, sq]``.  All three kernels read their bf16 operands through TMA
tensor maps (``tma_geometry``): the forward and dq in 128-row q tiles against
kv tiles of 128 and 64 rows, dk/dv in 128-row kv tiles against 64-row q
tiles.  Sequence lengths must be multiples of 64 (a last 128-row tile may be
half past the end) and head_dim 64 or 128 (the TPU's 128-lane rule is a Mosaic
constraint).  Other shapes fall back, counted in ``FALLBACKS``, to
``core_attention``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from neuronx_distributed_training_torch.utils import build as kbuild

NEG_INF = -1e30
#: sequence lengths the kernels take are multiples of this
SEQ_MULTIPLE = 64
HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16,)

#: kernel launches per wrapper; the plain versions never count
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
#: calls whose shapes do not tile: flash_attention calls that went to
#: core_attention, and context-parallel chunks that took the blockwise route
#: (``parallel/ring_attention.py``)
FALLBACKS = {"core": 0, "blockwise": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, FALLBACKS):
        for k in d:
            d[k] = 0


def flash_tileable(sq: int, skv: int, d: int, nh: int, nkv: int) -> bool:
    """True when these shapes run the Hopper kernels (no fallback)."""
    return (sq % SEQ_MULTIPLE == 0 and skv % SEQ_MULTIPLE == 0 and d in HEAD_DIMS
            and nh % nkv == 0)


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the card holds each kernel against)
# ---------------------------------------------------------------------------


def _visible(b, sq, skv, causal, window, q_offset, kvm, seg, device) -> torch.Tensor:
    """Boolean visibility, broadcastable to [b, nh, sq, skv]."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    kv_pos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kv_pos <= q_pos)
    if window is not None:
        ok = ok & (kv_pos > q_pos - window)
    ok = ok[None, None]
    if kvm is not None:
        ok = ok & (kvm[:, None, None, :] > 0)
    if seg is not None:
        ok = ok & (seg[:, None, :, None] == seg[:, None, None, :])
    return ok


def _heads_first(x: torch.Tensor, group: int = 1) -> torch.Tensor:
    """[b, s, h, d] -> fp32 [b, h * group, s, d] (kv heads repeated per group)."""
    x = x.float().transpose(1, 2)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _masked_scores(q, k, kvm, seg, causal, window, q_offset):
    b, sq, nh, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    s = torch.matmul(_heads_first(q), _heads_first(k, nh // nkv).transpose(-1, -2))
    s.mul_(1.0 / math.sqrt(d))
    ok = _visible(b, sq, skv, causal, window, q_offset, kvm, seg, q.device)
    return s.masked_fill_(~ok, NEG_INF)


def _p_and_ds(q, k, v, do, lse, delta, kvm, seg, causal, window, q_offset):
    nh, nkv, d = q.shape[2], k.shape[2], q.shape[3]
    s = _masked_scores(q, k, kvm, seg, causal, window, q_offset)
    lse_ = lse[..., None]
    p = torch.where(lse_ > NEG_INF / 2, torch.exp(s.sub_(lse_)), 0.0)
    del s
    dof = _heads_first(do)
    dp = torch.matmul(dof, _heads_first(v, nh // nkv).transpose(-1, -2))
    ds = dp.sub_(delta[..., None]).mul_(p).mul_(1.0 / math.sqrt(d))
    return p, ds, dof


def flash_fwd_plain(q, k, v, kvm=None, seg=None, *, causal=True, window=None, q_offset=0):
    """(o [b, sq, nh, d] in q's dtype, lse fp32 [b, nh, sq])."""
    nh, nkv = q.shape[2], k.shape[2]
    s = _masked_scores(q, k, kvm, seg, causal, window, q_offset)
    m = torch.amax(s, dim=-1, keepdim=True)
    vis = m > NEG_INF / 2
    p = torch.exp(s.sub_(m))
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.matmul(p, _heads_first(v, nh // nkv)).div_(l)
    o = torch.where(vis, o, 0.0)
    lse = torch.where(vis, m + torch.log(l), NEG_INF).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype), lse


def flash_dq_plain(q, k, v, do, lse, delta, kvm=None, seg=None, *, causal=True, window=None,
                   q_offset=0):
    """dq = sum_kv ds k, with ds = p (do v^T - delta) / sqrt(d), all fp32."""
    nh, nkv = q.shape[2], k.shape[2]
    _, ds, _ = _p_and_ds(q, k, v, do, lse, delta, kvm, seg, causal, window, q_offset)
    dq = torch.matmul(ds, _heads_first(k, nh // nkv))
    return dq.transpose(1, 2).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, kvm=None, seg=None, *, causal=True, window=None,
                    q_offset=0):
    """dk = sum ds^T q and dv = sum p^T do over the GQA group, all fp32."""
    b, skv, nkv, d = k.shape
    group = q.shape[2] // nkv
    p, ds, dof = _p_and_ds(q, k, v, do, lse, delta, kvm, seg, causal, window, q_offset)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    del p, dof
    dk = torch.matmul(ds.transpose(-1, -2), _heads_first(q))

    def per_kv_head(x):
        return x.view(b, nkv, group, skv, d).sum(2).transpose(1, 2)

    return per_kv_head(dk).to(k.dtype), per_kv_head(dv).to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_STRIDES12 = _LL * 12
_PLL = ctypes.POINTER(_LL)
_EXACT_DTYPES = {"lse": torch.float32, "delta": torch.float32, "kvm": torch.int32,
                 "seg": torch.int32}
#: launcher error codes from this value up: a tensor map could not be encoded
#: (the code less this value is the driver's CUresult)
_ERR_TMAP = 1000


def _fn(lib_name: str, sym: str, argtypes):
    fn = getattr(kbuild.load(lib_name), sym)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def tma_geometry(t: torch.Tensor):
    """The 4-D TMA tensor map through which the kernels read a bf16
    ``[b, s, h, d]`` operand (``make_tmap`` in ``csrc/hopper.cuh`` builds the
    same one from the element strides): dims innermost first
    ``(d, s, h, b)`` and the byte strides of ``s``, ``h`` and ``b``.  Raises
    ValueError on a layout no tensor map can describe: the head dim must be
    contiguous, the base 16-byte aligned and every stride a multiple of 16
    bytes below 2^40 (the map ignores the stride of a dimension of size 1)."""
    b, s, h, d = t.shape
    sb, ss, sh, sd = t.stride()
    size = t.element_size()
    strides = tuple(16 if n == 1 else st * size for n, st in ((s, ss), (h, sh), (b, sb)))
    if sd != 1 or t.data_ptr() % 16 or any(x % 16 or not 0 <= x < 2 ** 40 for x in strides):
        raise ValueError(f"no TMA tensor map for strides {t.stride()} (element size {size}) "
                         f"at address offset {t.data_ptr() % 16} mod 16")
    return (d, s, h, b), strides


def _check(what: str, tensors: dict, q: torch.Tensor, k: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
    b, sq, nh, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    if not flash_tileable(sq, skv, d, nh, nkv):
        raise ValueError(f"{what}: shapes do not tile (sq={sq}, skv={skv}, d={d}, "
                         f"nh={nh}, nkv={nkv})")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != q.device or not _on_card(t):
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {q.device}")
        if name in _EXACT_DTYPES:
            # 16-byte aligned: the dq and dk/dv kernels copy their rows in bulk
            if t.dtype != _EXACT_DTYPES[name] or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must be a contiguous, 16-byte aligned "
                                 f"{_EXACT_DTYPES[name]} tensor")
            continue
        if t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}; the kernels take "
                             f"{KERNEL_DTYPES}")
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} needs a contiguous, 16-byte aligned head dim "
                             f"and strides that are multiples of 8 (got {t.stride()})")
        try:
            tma_geometry(t)
        except ValueError as e:
            raise ValueError(f"{what}: {name}: {e}") from None


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err >= _ERR_TMAP:
        raise RuntimeError(f"{what}: a TMA tensor map could not be encoded (CUresult "
                           f"{err - _ERR_TMAP})")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def flash_fwd(q, k, v, kvm=None, seg=None, *, causal=True, window=None, q_offset=0):
    """Forward kernel: (o [b, sq, nh, d], lse fp32 [b, nh, sq])."""
    if _on_cpu(q):
        return flash_fwd_plain(q, k, v, kvm, seg, causal=causal, window=window,
                               q_offset=q_offset)
    _check("flash_fwd", dict(q=q, k=k, v=v, kvm=kvm, seg=seg), q, k)
    fn = _fn("flash_fwd", "nxdt_flash_fwd",
             [_VP] * 7 + [_I] * 6 + [_LL] * 12 + [_F, _I, _I, _I, _VP])
    b, sq, nh, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, nh, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, nh, sq), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kvm), _ptr(seg), o.data_ptr(),
             lse.data_ptr(), b, sq, skv, nh, nkv, d, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *o.stride()[:3], 1.0 / math.sqrt(d), int(causal),
             -1 if window is None else int(window), int(q_offset), _stream(q))
    _raise_on(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _bwd_strides(q, k, v, do):
    return _STRIDES12(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])


def flash_dq(q, k, v, do, lse, delta, kvm=None, seg=None, *, causal=True, window=None,
             q_offset=0):
    """dq kernel: dq [b, sq, nh, d] in q's dtype."""
    if _on_cpu(q):
        return flash_dq_plain(q, k, v, do, lse, delta, kvm, seg, causal=causal,
                              window=window, q_offset=q_offset)
    _check("flash_dq", dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, kvm=kvm, seg=seg),
           q, k)
    fn = _fn("flash_dq", "nxdt_flash_dq",
             [_VP] * 9 + [_I] * 6 + [_PLL] + [_LL] * 3 + [_F, _I, _I, _I, _VP])
    b, sq, nh, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), _ptr(kvm), _ptr(seg), dq.data_ptr(), b, sq, skv, nh, nkv, d,
             _bwd_strides(q, k, v, do), *dq.stride()[:3], 1.0 / math.sqrt(d), int(causal),
             -1 if window is None else int(window), int(q_offset), _stream(q))
    _raise_on(err, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, kvm=None, seg=None, *, causal=True, window=None,
              q_offset=0):
    """dk/dv kernel: (dk, dv) [b, skv, nkv, d] in k's and v's dtypes."""
    if _on_cpu(q):
        return flash_dkv_plain(q, k, v, do, lse, delta, kvm, seg, causal=causal,
                               window=window, q_offset=q_offset)
    _check("flash_dkv", dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, kvm=kvm, seg=seg),
           q, k)
    fn = _fn("flash_dkv", "nxdt_flash_dkv",
             [_VP] * 10 + [_I] * 6 + [_PLL] + [_LL] * 3 + [_F, _I, _I, _I, _VP])
    b, sq, nh, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    dk = torch.empty((b, skv, nkv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, skv, nkv, d), dtype=v.dtype, device=v.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), _ptr(kvm), _ptr(seg), dk.data_ptr(), dv.data_ptr(), b, sq, skv,
             nh, nkv, d, _bwd_strides(q, k, v, do), *dk.stride()[:3], 1.0 / math.sqrt(d),
             int(causal), -1 if window is None else int(window), int(q_offset), _stream(q))
    _raise_on(err, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# autograd glue (the JAX package's _flash / _flash_lse custom_vjps)
# ---------------------------------------------------------------------------


def _backward(ctx, do, dlse):
    q, k, v, o, lse, kvm, seg = ctx.saved_tensors
    causal, window, q_offset = ctx.mask_args
    do = do.contiguous()
    delta = torch.sum(do.float() * o.float(), dim=-1).transpose(1, 2).contiguous()
    if dlse is not None:
        # lse is a differentiable output: d lse / d s = p, so
        # ds = p (dp - delta + dlse) — fold dlse into the delta operand
        delta = delta - dlse
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    dq = flash_dq(q, k, v, do, lse, delta, kvm, seg, **kw)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, kvm, seg, **kw)
    return dq, dk, dv, None, None, None, None, None


class _Flash(torch.autograd.Function):
    """o = flash(q, k, v); saves q, k, v, o and lse (the JAX residuals)."""

    @staticmethod
    def forward(ctx, q, k, v, kvm, seg, causal, window, q_offset):
        o, lse = flash_fwd(q, k, v, kvm, seg, causal=causal, window=window,
                           q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse, kvm, seg)
        ctx.mask_args = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        return _backward(ctx, do, None)


class _FlashLse(torch.autograd.Function):
    """(o, lse) = flash(q, k, v) with lse differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, kvm, seg, causal, window, q_offset):
        o, lse = flash_fwd(q, k, v, kvm, seg, causal=causal, window=window,
                           q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse, kvm, seg)
        ctx.mask_args = (causal, window, q_offset)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return _backward(ctx, do, dlse)


def _prep_mask(attention_mask, b, skv):
    """``attention_mask`` [b, skv] (1 = real key) -> int32 or None."""
    if attention_mask is None:
        return None
    if tuple(attention_mask.shape) != (b, skv):
        raise ValueError(f"attention_mask must be [batch, kv_len] = ({b}, {skv}); got "
                         f"{tuple(attention_mask.shape)}")
    return attention_mask.to(torch.int32).contiguous()


def flash_attention_with_lse(
    q: torch.Tensor,  # [b, sq, nh, d]
    k: torch.Tensor,  # [b, skv, nkv, d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    q_offset: int = 0,
    attention_mask: Optional[torch.Tensor] = None,
):
    """(o [b, sq, nh, d], lse [b, nh, sq]).  No core fallback: callers check
    ``flash_tileable`` first.  The window is honored even when not causal."""
    b, sq, nh, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    if not flash_tileable(sq, skv, d, nh, nkv):
        raise ValueError(f"flash_attention_with_lse: shapes not tileable "
                         f"(sq={sq}, skv={skv}, d={d}, nh={nh}, nkv={nkv})")
    kvm = _prep_mask(attention_mask, b, skv)
    return _FlashLse.apply(q, k, v, kvm, None, causal, sliding_window, q_offset)


def flash_attention(
    q: torch.Tensor,  # [b, sq, nh, d]
    k: torch.Tensor,  # [b, skv, nkv, d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    q_offset: int = 0,
    attention_mask: Optional[torch.Tensor] = None,  # [b, skv] 1 = real key
    segment_ids: Optional[torch.Tensor] = None,  # [b, s] packed-record segments
) -> torch.Tensor:
    """Flash attention in the model's [b, s, h, d] layout.  Shapes that do not
    tile fall back to ``core_attention`` (counted in ``FALLBACKS``)."""
    b, sq, nh, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    if not causal:
        sliding_window = None  # the window is causal-only, as in core_attention
    if not flash_tileable(sq, skv, d, nh, nkv):
        from neuronx_distributed_training_torch.ops.attention import (
            core_attention,
            padding_mask_bias,
            segment_mask_bias,
        )

        FALLBACKS["core"] += 1
        bias = None
        if attention_mask is not None:
            bias = padding_mask_bias(attention_mask)
        if segment_ids is not None:
            sb = segment_mask_bias(segment_ids)
            bias = sb if bias is None else bias + sb
        return core_attention(q, k, v, causal=causal, q_offset=q_offset,
                              sliding_window=sliding_window, bias=bias)
    kvm = _prep_mask(attention_mask, b, skv)
    seg = None
    if segment_ids is not None:
        if sq != skv:
            raise ValueError(f"segment_ids need self-attention (sq == skv); got sq={sq}, "
                             f"skv={skv}")
        if tuple(segment_ids.shape) != (b, sq):
            raise ValueError(f"segment_ids must be [batch, seq] = ({b}, {sq}); got "
                             f"{tuple(segment_ids.shape)}")
        seg = segment_ids.to(torch.int32).contiguous()
    return _Flash.apply(q, k, v, kvm, seg, causal, sliding_window, q_offset)
