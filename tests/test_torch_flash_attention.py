"""The port's flash attention against the JAX package's Pallas flash attention.

On the CPU the port's wrappers run the plain PyTorch version of each kernel
(forward, dq, dk/dv) under the same autograd Functions that launch the CUDA
kernels on the card; the JAX side runs its Pallas kernels in interpret mode at
block_q = block_kv = 128 (as tests/test_flash_attention.py does), so d = 128
and s is a multiple of 128.  Tolerance (fp32): outputs rtol / atol 1e-5, the
scalar loss rtol 2e-4, gradients 1e-4 of each gradient's largest entry.  The
CUDA kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` (this file imports jax, which the card's machine lacks).
"""

import functools
import importlib.util
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.ops import flash_attention as tfa
from neuronx_distributed_training_torch.utils import build as kbuild
from neuronx_distributed_training_tpu.ops import flash_attention as jfa

D = 128
BLK = dict(block_q=128, block_kv=128, interpret=True)


def _qkv(seed, b, sq, skv, nh, nkv, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, nh, d)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, d)).astype(np.float32),
            rng.standard_normal((b, sq, nh, d)).astype(np.float32))


def _pad(b, s, valid):
    m = np.zeros((b, s), np.int32)
    for i, n in enumerate(valid):
        m[i, :n] = 1
    return m


def _seg(b, s, bounds):
    seg = np.zeros((b, s), np.int32)
    for bi in range(b):
        prev, sid = 0, 1
        for cut in bounds[bi] + [s]:
            seg[bi, prev:cut] = sid
            prev, sid = cut, sid + 1
    return seg


def _port(q, k, v, cot, **kw):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    kw = {k_: (torch.tensor(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()}
    o = tfa.flash_attention(*ts, **kw)
    loss = (o * torch.tensor(cot)).sum()
    loss.backward()
    return o.detach().numpy(), float(loss.detach()), [t.grad.numpy() for t in ts]


def _jax(q, k, v, cot, **kw):
    kw = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()}

    def f(q, k, v):
        o = jfa.flash_attention(q, k, v, **kw, **BLK)
        return jnp.sum(o * cot), o

    (loss, o), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(o), float(loss), [np.asarray(x) for x in g]


def _assert_grads(tg, jg):
    for a, b, name in zip(tg, jg, "qkv"):
        err = np.abs(a - b).max() / (np.abs(b).max() + 1e-12)
        assert err < 1e-4, f"d{name} rel err {err}"


CASES = [
    # (name, b, sq, skv, nh, nkv, kwargs)
    ("causal_mha", 1, 256, 256, 2, 2, dict(causal=True)),
    ("causal_gqa", 2, 256, 256, 4, 2, dict(causal=True)),
    ("window", 1, 256, 256, 2, 1, dict(causal=True, sliding_window=100)),
    ("cross_noncausal_mqa", 1, 256, 512, 2, 1, dict(causal=False)),
    ("q_offset", 1, 128, 256, 2, 2, dict(causal=True, q_offset=128)),
    ("padding_causal", 2, 256, 256, 4, 2,
     dict(causal=True, attention_mask=_pad(2, 256, [219, 129]))),
    ("padding_noncausal", 2, 256, 256, 2, 1,
     dict(causal=False, attention_mask=_pad(2, 256, [219, 129]))),
    ("segments", 2, 256, 256, 4, 2,
     dict(causal=True, segment_ids=_seg(2, 256, [[100, 180], [37]]))),
    ("segments_padding", 1, 256, 256, 2, 2,
     dict(causal=True, segment_ids=_seg(1, 256, [[90]]), attention_mask=_pad(1, 256, [200]))),
]


@pytest.mark.parametrize("name,b,sq,skv,nh,nkv,kw", CASES, ids=[c[0] for c in CASES])
def test_flash_matches_jax_fwd_and_grad(name, b, sq, skv, nh, nkv, kw):
    q, k, v, cot = _qkv(zlib.crc32(name.encode()) % 1000, b, sq, skv, nh, nkv)
    to, tl, tg = _port(q, k, v, cot, **kw)
    jo, jl, jg = _jax(q, k, v, cot, **kw)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    assert np.isclose(tl, jl, rtol=2e-4), (tl, jl)
    _assert_grads(tg, jg)


def test_plain_kernels_match_pallas_kernels():
    """Each plain version against its Pallas kernel, called directly."""
    q, k, v, do = _qkv(7, 1, 256, 256, 4, 2)
    kvm = _pad(1, 256, [200])
    kw = dict(causal=True, window=None, q_offset=0)
    qt, kt, vt, dot = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v, do))
    jo, jlse = jfa._fwd_pallas(qt, kt, vt, jnp.asarray(kvm), None, sm_scale=D ** -0.5,
                               bq=128, bkv=128, interpret=True, **kw)
    to, tlse = tfa.flash_fwd_plain(*(torch.tensor(x) for x in (q, k, v)), torch.tensor(kvm),
                                   **kw)
    np.testing.assert_allclose(to.numpy(), np.swapaxes(np.asarray(jo), 1, 2), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0], rtol=1e-5, atol=1e-5)
    jdq, jdk, jdv = jfa._bwd_pallas((qt, kt, vt, jnp.asarray(kvm), None, jo, jlse), dot,
                                    sm_scale=D ** -0.5, bq=128, bkv=128, interpret=True, **kw)
    tdo = torch.tensor(do)
    delta = (tdo * to).sum(-1).transpose(1, 2).contiguous()
    args = (*(torch.tensor(x) for x in (q, k, v)), tdo, tlse, delta, torch.tensor(kvm))
    tdq = tfa.flash_dq_plain(*args, **kw)
    tdk, tdv = tfa.flash_dkv_plain(*args, **kw)
    _assert_grads([tdq.numpy(), tdk.numpy(), tdv.numpy()],
                  [np.swapaxes(np.asarray(x), 1, 2) for x in (jdq, jdk, jdv)])


def test_lse_variant_with_lse_cotangent():
    """(o, lse) with both cotangents non-zero: the backward folds dlse into
    delta; fully masked rows (left padding) carry lse = NEG_INF."""
    b, s = 2, 256
    q, k, v, cot = _qkv(11, b, s, s, 2, 1)
    rng = np.random.default_rng(12)
    lcot = rng.standard_normal((b, 2, s)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, :70] = 0  # rows < 70 of batch 1 see no key

    def jf(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, causal=True,
                                              attention_mask=jnp.asarray(mask), **BLK)
        return jnp.sum(o * cot) + jnp.sum(jnp.where(lse > -1e29, lse, 0.0) * lcot), (o, lse)

    (jl, (jo, jlse)), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                                      has_aux=True))(q, k, v)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    to, tlse = tfa.flash_attention_with_lse(*ts, causal=True, attention_mask=torch.tensor(mask))
    tl = (to * torch.tensor(cot)).sum() + (
        torch.where(tlse > -1e29, tlse, 0.0) * torch.tensor(lcot)).sum()
    tl.backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlse.detach().numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)
    assert np.isclose(float(tl.detach()), float(jl), rtol=2e-4)
    _assert_grads([t.grad.numpy() for t in ts], [np.asarray(x) for x in jg])
    # fully masked rows: o = 0, lse = NEG_INF, and no gradient
    assert np.all(tlse.detach().numpy()[1, :, :70] == tfa.NEG_INF)
    assert np.all(to.detach().numpy()[1, :70] == 0)
    assert np.all(ts[0].grad.numpy()[1, :70] == 0)


def test_no_grad_leak_to_padded_keys():
    b, s, valid = 1, 256, 100
    q, k, v, cot = _qkv(13, b, s, s, 2, 2)
    _, _, (_, dk, dv) = _port(q, k, v, cot, causal=True, attention_mask=_pad(b, s, [valid]))
    assert np.all(dk[:, valid:] == 0) and np.all(dv[:, valid:] == 0)


def test_no_cross_segment_leak():
    b, s = 1, 256
    q, k, v, _ = _qkv(14, b, s, s, 2, 2)
    seg = torch.tensor(_seg(b, s, [[128]]))
    args = [torch.tensor(a) for a in (q, k, v)]
    o1 = tfa.flash_attention(*args, causal=True, segment_ids=seg)
    args[1][:, :128] += 1.0
    args[2][:, :128] -= 1.0
    o2 = tfa.flash_attention(*args, causal=True, segment_ids=seg)
    assert torch.equal(o1[:, 128:], o2[:, 128:])
    assert not torch.allclose(o1[:, :128], o2[:, :128])


def test_cross_attention_segments_rejected():
    q, k, v, _ = _qkv(15, 1, 128, 256, 2, 2)
    with pytest.raises(ValueError, match="self-attention"):
        tfa.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=False,
                            segment_ids=torch.zeros(1, 128, dtype=torch.int32))


def test_chip_smoke_o_check_scales_with_each_element():
    """``chip_smoke.py`` holds the forward kernel's o to its plain version per
    element (``o_err``, limit ``TOL_O``).  The kernel's own rounding (the
    unnormalized p rounded to bf16 before p v) stays inside the limit; a stale
    V tile near the end of the sequence, or an error of a tenth of a row's rms
    on the last rows, fails it by far."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    s, nh, nkv = 1024, 4, 1
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, s, h, D, generator=g).bfloat16() for h in (nh, nkv, nkv))
    o_p, _ = tfa.flash_fwd_plain(q, k, v)
    scores = tfa._masked_scores(q, k, None, None, True, None, 0)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    o_kernel = ((p.bfloat16().float() @ tfa._heads_first(v, nh // nkv)) / p.sum(-1, keepdim=True))
    o_kernel = o_kernel.transpose(1, 2).bfloat16()
    assert smoke.o_err(o_kernel, o_p) < smoke.TOL_O
    tile = s // 64 - 2
    v_stale = v.clone()
    v_stale[:, tile * 64:(tile + 1) * 64] = v[:, (tile - 1) * 64:tile * 64]
    assert smoke.o_err(tfa.flash_fwd_plain(q, k, v_stale)[0], o_p) > 50 * smoke.TOL_O
    o_off = o_p.float().clone()
    rms = o_off[:, -64:].pow(2).mean(-1, keepdim=True).sqrt()
    o_off[:, -64:] += 0.1 * rms
    assert smoke.o_err(o_off.bfloat16(), o_p) > 5 * smoke.TOL_O
    assert smoke.abs_err(o_off.bfloat16(), o_p) < 3e-2  # what an absolute bound would pass


def test_tileable_predicate_and_counted_fallback():
    assert tfa.flash_tileable(8192, 8192, 128, 32, 8)  # the main path tiles
    assert tfa.flash_tileable(64, 128, 64, 4, 4)
    assert not tfa.flash_tileable(96, 96, 128, 2, 2)  # not a multiple of 64
    assert not tfa.flash_tileable(128, 128, 96, 2, 2)  # head dim not 64/128
    assert not tfa.flash_tileable(128, 128, 128, 3, 2)  # heads not grouped
    tfa.reset_counters()
    rng = np.random.default_rng(16)
    q, k, v = (torch.tensor(rng.standard_normal((1, 40, 2, 32)).astype(np.float32))
               for _ in range(3))
    from neuronx_distributed_training_torch.ops.attention import core_attention

    o = tfa.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(o, core_attention(q, k, v, causal=True), rtol=1e-5, atol=1e-5)
    assert tfa.FALLBACKS["core"] == 1
    with pytest.raises(ValueError, match="not tileable"):
        tfa.flash_attention_with_lse(q, k, v)


def test_cpu_tensors_take_the_plain_versions_uncounted():
    tfa.reset_counters()
    q, k, v, cot = _qkv(17, 1, 128, 128, 2, 1)
    _port(q, k, v, cot, causal=True)
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    assert tfa.FALLBACKS["core"] == 0


def test_card_request_raises_when_the_library_cannot_load(monkeypatch):
    """A CUDA request launches the kernel or raises: stub a card tensor and a
    library that cannot load, and no wrapper may fall back to the plain path."""

    def broken_load(name):
        raise RuntimeError(f"cannot load {name}")

    monkeypatch.setattr(tfa, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tfa, "_check", lambda *a, **k: None)
    monkeypatch.setattr(tfa.kbuild, "load", broken_load)
    tfa.reset_counters()
    q, k, v, do = (torch.tensor(x) for x in _qkv(18, 1, 64, 64, 2, 1))
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(RuntimeError, match="cannot load flash_fwd"):
        tfa.flash_fwd(q, k, v)
    with pytest.raises(RuntimeError, match="cannot load flash_dq"):
        tfa.flash_dq(q, k, v, do, lse, lse)
    with pytest.raises(RuntimeError, match="cannot load flash_dkv"):
        tfa.flash_dkv(q, k, v, do, lse, lse)
    with pytest.raises(RuntimeError, match="cannot load"):
        tfa.flash_attention(q, k, v)
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def test_kernel_inputs_are_checked(monkeypatch):
    monkeypatch.setattr(tfa, "_on_cpu", lambda t: False)
    q, k, v, _ = (torch.tensor(x) for x in _qkv(19, 1, 64, 64, 2, 1))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tfa.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="do not tile"):
        tfa.flash_fwd(q[:, :40], k[:, :40], v[:, :40])


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)
    monkeypatch.setattr(kbuild.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.build_all()


# ---------------------------------------------------------------------------
# the arithmetic of the Hopper dq and dk/dv kernels (csrc/flash_dq.cu,
# csrc/flash_dkv.cu), emulated
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
#: emulated dk/dv against the plain version and against JAX, relative to each
#: gradient's largest entry: both read ~5e-7 at the shape below, while bf16
#: operands in place of the exact split miss JAX by ~2e-3
DKV_EMULATION_TOL = 1e-5
#: emulated dq against the plain version and against JAX, relative to its
#: largest entry: the emulation differs from both only by fp32 summation order
#: and the exact split (~5e-7 at the shape below), while ds rounded to bf16
#: misses JAX by ~2e-3
DQ_EMULATION_TOL = 1e-5
#: kv rows per tile of the dq kernel (`BN` in csrc/flash_dq.cu) and of the
#: forward (csrc/flash_fwd.cu); both take 128-row q tiles
DQ_BLOCK_KV, FWD_BLOCK_KV, BLOCK_Q = 64, 128, 128


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split3(x: torch.Tensor):
    """The kernel's ``split3``: x = hi + mid + lo, each part bf16."""
    hi = _bf16(x)
    mid = _bf16(x - hi)
    return hi, mid, _bf16(x - hi - mid)


def _dkv_hopper_emulation(q, k, v, do, lse, delta, kvm, seg, *, causal, window=None,
                          q_offset=0, exact_split=True):
    """dk, dv as the kernel computes them: the transposed products S^T = K Q^T
    and dP^T = V dO^T (kv rows first), p = exp2(s * scale * log2 e -
    lse * log2 e) and 0 where lse is NEG_INF, and each fp32 operand of
    p^T do and ds^T q split into hi + mid + lo bf16 parts whose products are
    summed in fp32, smallest first.  ``exact_split=False`` rounds p and ds to
    bf16 instead."""
    b, sq, nh, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    scale = d ** -0.5

    def heads(x, n):  # [b, s, h, d] -> [b, nkv, n, s, d]; q head h = kv head * group + g
        return x.float().permute(0, 2, 1, 3).reshape(b, nkv, n, x.shape[1], d)

    qh, doh, kh, vh = heads(q, group), heads(do, group), heads(k, 1), heads(v, 1)
    st, dpt = kh @ qh.transpose(-1, -2), vh @ doh.transpose(-1, -2)  # [b, nkv, g, skv, sq]
    ok = tfa._visible(b, sq, skv, causal, window, q_offset, kvm, seg, q.device)
    x = torch.where(ok.transpose(-1, -2)[:, :, None], st * (scale * LOG2E), tfa.NEG_INF)
    lse_t = lse.view(b, nkv, group, 1, sq)
    p = torch.where(lse_t > tfa.NEG_INF / 2, torch.exp2(x - lse_t * LOG2E), 0.0)
    ds = p * (dpt - delta.view(b, nkv, group, 1, sq)) * scale

    def product(a, y):
        if not exact_split:
            return _bf16(a) @ y
        hi, mid, lo = _split3(a)
        return lo @ y + mid @ y + hi @ y

    dk, dv = product(ds, qh).sum(2), product(p, doh).sum(2)
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _dq_hopper_emulation(q, k, v, do, lse, delta, kvm, seg, *, causal, window=None,
                         q_offset=0, exact_split=True):
    """dq as the kernel computes it: per kv tile of the kernel's width,
    S = Q K^T and dP = dO V^T, p = exp2(s * scale * log2 e - lse * log2 e) and
    0 where lse is NEG_INF, ds = p (dp - delta) scale, and dQ += ds K with ds
    split into hi + mid + lo bf16 parts whose products are summed in fp32,
    smallest first.  ``exact_split=False`` rounds ds to bf16 instead."""
    b, sq, nh, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    scale = d ** -0.5
    qh, doh = tfa._heads_first(q), tfa._heads_first(do)  # [b, nh, s, d]
    kh, vh = tfa._heads_first(k, nh // nkv), tfa._heads_first(v, nh // nkv)
    ok = tfa._visible(b, sq, skv, causal, window, q_offset, kvm, seg, q.device)
    lse_ = lse[..., None]
    dq = torch.zeros_like(qh)
    for lo in range(0, skv, DQ_BLOCK_KV):
        kt, vt = kh[:, :, lo:lo + DQ_BLOCK_KV], vh[:, :, lo:lo + DQ_BLOCK_KV]
        s, dp = qh @ kt.transpose(-1, -2), doh @ vt.transpose(-1, -2)
        x = torch.where(ok[..., lo:lo + DQ_BLOCK_KV], s * (scale * LOG2E), tfa.NEG_INF)
        p = torch.where(lse_ > tfa.NEG_INF / 2, torch.exp2(x - lse_ * LOG2E), 0.0)
        ds = p * (dp - delta[..., None]) * scale
        if exact_split:
            for part in reversed(_split3(ds)):
                dq += part @ kt
        else:
            dq += _bf16(ds) @ kt
    return dq.transpose(1, 2)


@functools.lru_cache(maxsize=1)
def _dkv_case():
    """b=2, s=256, nh=4, nkv=2, d=64, causal, key padding and packed segments:
    bf16-valued inputs, the plain forward's lse and delta, the plain (dq, dk,
    dv) and the JAX package's `_bwd_pallas` (interpret mode) (dq, dk, dv)."""
    b, s, nh, nkv, d = 2, 256, 4, 2, 64
    q, k, v, do = (_bf16(torch.tensor(x)) for x in _qkv(21, b, s, s, nh, nkv, d))
    kvm, seg = _pad(b, s, [200, 256]), _seg(b, s, [[90, 170], [130]])
    kw = dict(causal=True, window=None, q_offset=0)
    o, lse = tfa.flash_fwd_plain(q, k, v, torch.tensor(kvm), torch.tensor(seg), **kw)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, torch.tensor(kvm), torch.tensor(seg))
    plain = (tfa.flash_dq_plain(*args, **kw), *tfa.flash_dkv_plain(*args, **kw))
    qt, kt, vt, dot = (jnp.swapaxes(jnp.asarray(x.numpy()), 1, 2) for x in (q, k, v, do))
    jkw = dict(sm_scale=d ** -0.5, bq=128, bkv=128, interpret=True, **kw)
    jo, jlse = jfa._fwd_pallas(qt, kt, vt, jnp.asarray(kvm), jnp.asarray(seg), **jkw)
    jgrads = jfa._bwd_pallas((qt, kt, vt, jnp.asarray(kvm), jnp.asarray(seg), jo, jlse),
                             dot, **jkw)
    return args, kw, plain, tuple(np.swapaxes(np.asarray(x), 1, 2) for x in jgrads)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("reference", ["plain", "jax"])
def test_dkv_kernel_arithmetic_matches(reference):
    """The kernel's dk/dv arithmetic (transposed products, exp2 with log2 e
    folded in, three-way split products) against the plain version and the
    JAX package's Pallas backward, within DKV_EMULATION_TOL."""
    args, kw, plain, jax_grads = _dkv_case()
    dk, dv = _dkv_hopper_emulation(*args, **kw)
    ref = plain if reference == "plain" else jax_grads
    assert _rel(dk, ref[1]) < DKV_EMULATION_TOL
    assert _rel(dv, ref[2]) < DKV_EMULATION_TOL
    # padded keys get no gradient
    assert torch.all(dk[0, 200:] == 0) and torch.all(dv[0, 200:] == 0)


def test_dkv_bf16_operands_miss_jax_beyond_tolerance():
    """Why the kernel splits p and ds instead of rounding them to bf16: the
    rounded products miss the JAX dk and dv by far more than the tolerance."""
    args, kw, _, (_, jdk, jdv) = _dkv_case()
    dk, dv = _dkv_hopper_emulation(*args, **kw, exact_split=False)
    assert _rel(dk, jdk) > 20 * DKV_EMULATION_TOL
    assert _rel(dv, jdv) > 20 * DKV_EMULATION_TOL


@pytest.mark.parametrize("reference", ["plain", "jax"])
def test_dq_kernel_arithmetic_matches(reference):
    """The dq kernel's arithmetic (kv tiles of its width, exp2 with log2 e
    folded in, p = 0 on rows whose lse is NEG_INF, ds split three ways)
    against the plain version and the JAX package's Pallas backward, within
    DQ_EMULATION_TOL, on inputs with key padding and packed segments."""
    args, kw, plain, jax_grads = _dkv_case()
    dq = _dq_hopper_emulation(*args, **kw)
    ref = plain if reference == "plain" else jax_grads
    assert _rel(dq, ref[0]) < DQ_EMULATION_TOL
    assert torch.isfinite(dq).all()


def test_dq_bf16_ds_misses_jax_beyond_tolerance():
    """Why the kernel splits ds instead of rounding it to bf16: the rounded
    product misses the JAX dq by far more than the tolerance, which the split
    one meets (``test_dq_kernel_arithmetic_matches[jax]``)."""
    args, kw, _, (jdq, _, _) = _dkv_case()
    assert _rel(_dq_hopper_emulation(*args, **kw, exact_split=False), jdq) > (
        20 * DQ_EMULATION_TOL)


def test_three_way_split_is_exact():
    """hi + mid + lo reproduces each fp32 operand exactly, over magnitudes
    from 1e-13 to 1e4 and both signs."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(200_000, generator=g) * torch.exp(
        torch.empty(200_000).uniform_(-30.0, 10.0, generator=g))
    x = torch.cat([x, torch.tensor([0.0, 1.0, -1.0, 1.0 + 2.0 ** -23, 3.0 ** 0.5])])
    hi, mid, lo = _split3(x)
    assert torch.equal((hi + mid) + lo, x)
    assert torch.equal(torch.stack([hi, mid, lo]), _bf16(torch.stack([hi, mid, lo])))


# ---------------------------------------------------------------------------
# the TMA tensor maps of the forward and dk/dv kernels
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_tma_geometry_of_fused_qkv_views():
    """q, k and v split out of one fused [b, s, (nh + 2 nkv) d] projection, as
    models/llama.py does, are strided views; each maps to a 4-D tensor map
    (d, s, h, b) with the seq stride of the fused row."""
    b, s, nh, nkv, d = 2, 128, 8, 2, 128
    width = (nh + 2 * nkv) * d
    qkv = torch.zeros(b, s, width, dtype=torch.bfloat16)
    q, k, v = _chip_smoke().fused_views(torch, qkv, nh, nkv, d)
    assert not v.is_contiguous() and v.stride() == (s * width, width, d, 1)
    for t, h in ((q, nh), (k, nkv), (v, nkv)):
        dims, strides = tfa.tma_geometry(t)
        assert dims == (d, s, h, b)
        assert strides == (width * 2, d * 2, s * width * 2)
    # a contiguous operand: the head stride is d, the seq stride h * d
    assert tfa.tma_geometry(torch.zeros(1, s, nkv, d, dtype=torch.bfloat16)) == (
        (d, s, nkv, 1), (nkv * d * 2, d * 2, 16))


def test_check_raises_on_a_stride_tma_cannot_take(monkeypatch):
    """The fused views pass the kernels' input check; a seq pitch that is not
    a multiple of 16 bytes (here 8 * 128 + 4 elements) cannot be a tensor map
    and raises, as does a head dim that is not contiguous."""
    monkeypatch.setattr(tfa, "_on_card", lambda t: True)
    b, s, nh, nkv, d = 1, 128, 4, 2, 128
    q, k, v = _chip_smoke().fused_views(
        torch, torch.zeros(b, s, (nh + 2 * nkv) * d, dtype=torch.bfloat16), nh, nkv, d)
    tfa._check("flash_fwd", dict(q=q, k=k, v=v), q, k)
    odd = torch.zeros(b, s, nh * d + 4, dtype=torch.bfloat16)[..., :nh * d].view(b, s, nh, d)
    with pytest.raises(ValueError, match="strides that are multiples of 8"):
        tfa._check("flash_fwd", dict(q=odd, k=k, v=v), odd, k)
    with pytest.raises(ValueError, match="no TMA tensor map"):
        tfa.tma_geometry(odd)
    with pytest.raises(ValueError, match="no TMA tensor map"):
        tfa.tma_geometry(q.transpose(2, 3))


# ---------------------------------------------------------------------------
# the producer's kv-tile walk, shared by the forward and dq kernels
# ---------------------------------------------------------------------------


def _kv_walk(bi, qi, *, sq, skv, block_kv, causal, window, q_offset, kvm, seg):
    """{kv tile: whole} for the q tile qi of batch bi, by the rules of
    ``stream_kv_tiles`` in csrc/flash_pipeline.cuh: a tile missing from the
    result is skipped, a whole one takes no per-element mask, the others are
    flagged for it."""
    q_lo = qi * BLOCK_Q
    q_rows = min(BLOCK_Q, sq - q_lo)
    qpos_lo, qpos_hi = q_offset + q_lo, q_offset + q_lo + q_rows - 1
    segq = None if seg is None else seg[bi, q_lo:q_lo + q_rows]
    walk = {}
    for ki in range(-(-skv // block_kv)):
        kv_lo = ki * block_kv
        kv_n = min(block_kv, skv - kv_lo)
        kv_hi = kv_lo + kv_n - 1
        if causal and kv_lo > qpos_hi:
            break
        if window is not None and kv_hi <= qpos_lo - window:
            continue
        whole = (kv_n == block_kv and (not causal or kv_hi <= qpos_lo)
                 and (window is None or kv_lo > qpos_hi - window))
        if kvm is not None:
            keys = kvm[bi, kv_lo:kv_lo + kv_n] > 0
            if not keys.any():
                continue
            whole = whole and bool(keys.all())
        if seg is not None:
            segk = seg[bi, kv_lo:kv_lo + kv_n]
            if segk.min() > segq.max():
                continue
            whole = whole and segk.min() == segk.max() == segq.min() == segq.max()
        walk[ki] = bool(whole)
    return walk


WALK_CASES = [
    # (name, b, sq, skv, kwargs); 576 = 4.5 q tiles: the last one is ragged
    ("causal", 1, 512, 512, dict(causal=True)),
    ("window", 1, 512, 512, dict(causal=True, window=100)),
    ("window_noncausal", 1, 512, 512, dict(causal=False, window=150)),
    ("q_offset", 1, 256, 512, dict(causal=True, q_offset=200)),
    ("padding", 2, 512, 512, dict(causal=False, kvm=_pad(2, 512, [300, 64]))),
    ("segments", 2, 512, 512, dict(causal=True, seg=_seg(2, 512, [[100, 300], [257]]))),
    ("ragged_padding_segments", 2, 576, 576,
     dict(causal=True, kvm=_pad(2, 576, [576, 500]), seg=_seg(2, 576, [[130], [64, 448]]))),
]


@pytest.mark.parametrize("block_kv", [DQ_BLOCK_KV, FWD_BLOCK_KV], ids=["dq", "fwd"])
@pytest.mark.parametrize("name,b,sq,skv,kw", WALK_CASES, ids=[c[0] for c in WALK_CASES])
def test_kv_tile_walk_is_exact(name, b, sq, skv, kw, block_kv):
    """At 128-row q tiles: a tile the walk skips holds no visible (query, key)
    pair and a tile it takes whole holds only visible pairs, against the
    plain versions' ``_visible``; every case skips or takes whole at least
    one tile, and flags at least one."""
    kw = dict(dict(window=None, q_offset=0, kvm=None, seg=None), **kw)
    kvm = None if kw["kvm"] is None else torch.tensor(kw["kvm"])
    seg = None if kw["seg"] is None else torch.tensor(kw["seg"])
    ok = tfa._visible(b, sq, skv, kw["causal"], kw["window"], kw["q_offset"], kvm, seg, "cpu")
    kinds = {"skipped": 0, "whole": 0, "flagged": 0}
    for bi in range(b):
        for qi in range(-(-sq // BLOCK_Q)):
            walk = _kv_walk(bi, qi, sq=sq, skv=skv, block_kv=block_kv, **kw)
            for ki in range(-(-skv // block_kv)):
                pairs = ok[min(bi, ok.shape[0] - 1), 0, qi * BLOCK_Q:(qi + 1) * BLOCK_Q,
                           ki * block_kv:(ki + 1) * block_kv]
                if ki not in walk:
                    kinds["skipped"] += 1
                    assert not pairs.any(), (bi, qi, ki)
                elif walk[ki]:
                    kinds["whole"] += 1
                    assert pairs.all(), (bi, qi, ki)
                else:
                    kinds["flagged"] += 1
    assert kinds["skipped"] + kinds["whole"] > 0 and kinds["flagged"] > 0, kinds
