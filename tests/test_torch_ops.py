"""Parity of the PyTorch port's leaf ops with the JAX package (CPU, fp32).

Inputs come from a seeded numpy generator and go to both frameworks as the
same arrays.  Tolerance: fp32 everywhere, so forward outputs agree to rtol /
atol 1e-5 and gradients to 1e-4 of each gradient's largest entry (the two
frameworks sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.ops import attention as t_attn
from neuronx_distributed_training_torch.ops import cross_entropy as t_ce
from neuronx_distributed_training_torch.ops import linear as t_lin
from neuronx_distributed_training_torch.ops import norm as t_norm
from neuronx_distributed_training_torch.ops import rope as t_rope
from neuronx_distributed_training_tpu.ops import attention as j_attn
from neuronx_distributed_training_tpu.ops import cross_entropy as j_ce
from neuronx_distributed_training_tpu.ops import linear as j_lin
from neuronx_distributed_training_tpu.ops import norm as j_norm
from neuronx_distributed_training_tpu.ops import rope as j_rope

RTOL = ATOL = 1e-5
GRAD_REL = 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _grad_close(t_grad, j_grad):
    j = np.asarray(j_grad)
    err = np.abs(t_grad.numpy() - j).max() / (np.abs(j).max() + 1e-12)
    assert err < GRAD_REL, err


def _torch_vjp(fn, arrays, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out * torch.tensor(cot)).sum().backward()
    return out, [t.grad for t in ts]


def _jax_vjp(fn, arrays, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return out, vjp(jnp.asarray(cot))


def test_rms_norm_fwd_and_grad():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 16, 64), 1 + 0.1 * _rand(rng, 64)
    cot = _rand(rng, 2, 16, 64)
    to, tg = _torch_vjp(lambda x, s: t_norm.apply_rms_norm({"scale": s}, x), [x, scale], cot)
    jo, jg = _jax_vjp(lambda x, s: j_norm.apply_rms_norm({"scale": s}, x), [x, scale], cot)
    _close(to, jo)
    for a, b in zip(tg, jg):
        _grad_close(a, b)


@pytest.mark.parametrize("per_batch", [False, True])
def test_rope_fwd_and_grad(per_batch):
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 12, 3, 16
    np.testing.assert_array_equal(
        t_rope.rope_frequencies(d, theta=5e5, position_interpolation_factor=2.0),
        j_rope.rope_frequencies(d, theta=5e5, position_interpolation_factor=2.0))
    inv = t_rope.rope_frequencies(d, theta=5e5)
    pos = (np.tile(np.arange(s), (b, 1)) + np.arange(b)[:, None] * 3) if per_batch \
        else np.arange(s)
    pos = pos.astype(np.int32)
    tc, ts = t_rope.rope_cos_sin(torch.tensor(pos), inv)
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos), inv)
    _close(tc, jc)
    _close(ts, js)
    x, cot = _rand(rng, b, s, h, d), _rand(rng, b, s, h, d)
    to, tg = _torch_vjp(lambda x: t_rope.apply_rope(x, tc, ts), [x], cot)
    jo, jg = _jax_vjp(lambda x: j_rope.apply_rope(x, jc, js), [x], cot)
    _close(to, jo)
    _grad_close(tg[0], jg[0])


def test_linear_and_embedding_fwd_and_grad():
    rng = np.random.default_rng(2)
    x, w, cot = _rand(rng, 2, 5, 8), _rand(rng, 8, 6), _rand(rng, 2, 5, 6)
    to, tg = _torch_vjp(lambda x, w: t_lin.apply_linear({"w": w}, x), [x, w], cot)
    jo, jg = _jax_vjp(lambda x, w: j_lin.apply_linear({"w": w}, x), [x, w], cot)
    _close(to, jo)
    for a, b in zip(tg, jg):
        _grad_close(a, b)
    table = _rand(rng, 20, 8)
    ids = rng.integers(0, 20, (3, 7)).astype(np.int32)
    ids[0, :3] = 5  # repeated rows: the gather's gradient accumulates
    cot = _rand(rng, 3, 7, 8)
    to, tg = _torch_vjp(
        lambda t: t_lin.apply_embedding({"embedding": t}, torch.tensor(ids)), [table], cot)
    jo, jg = _jax_vjp(
        lambda t: j_lin.apply_embedding({"embedding": t}, jnp.asarray(ids)), [table], cot)
    _close(to, jo)
    _grad_close(tg[0], jg[0])


def test_init_linear_is_truncated_normal():
    gen = torch.Generator().manual_seed(0)
    w = t_lin.init_linear(gen, 256, 512, stddev=0.02)["w"]
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 0.04 + 1e-7
    # std of a unit normal cut at +-2 sigma is 0.8796
    assert abs(float(w.std()) / 0.02 - 0.8796) < 0.01


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_fwd_and_grad(with_mask):
    rng = np.random.default_rng(3)
    b, s, v = 2, 9, 33
    logits = 3 * _rand(rng, b, s, v)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, 2] = labels[1, 5] = -100  # ignore_index
    mask = (rng.random((b, s)) > 0.3).astype(np.float32) if with_mask else None

    def tf(lg):
        lgs, lbl, lm = t_ce.shift_for_next_token(
            lg, torch.tensor(labels), None if mask is None else torch.tensor(mask))
        return t_ce.cross_entropy_loss(lgs, lbl, loss_mask=lm)

    def jf(lg):
        lgs, lbl, lm = j_ce.shift_for_next_token(
            lg, jnp.asarray(labels), None if mask is None else jnp.asarray(mask))
        return j_ce.cross_entropy_loss(lgs, lbl, loss_mask=lm)

    to, tg = _torch_vjp(tf, [logits], np.float32(1.0))
    jo, jg = _jax_vjp(jf, [logits], np.float32(1.0))
    _close(to, jo)
    _grad_close(tg[0], jg[0])
    for red in ("sum", "none"):
        _close(t_ce.cross_entropy_loss(torch.tensor(logits), torch.tensor(labels),
                                       reduction=red),
               j_ce.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                       reduction=red), rtol=1e-5, atol=1e-4)


def test_repeat_kv_and_mask_biases():
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 5, 2, 4)
    _close(t_attn.repeat_kv(torch.tensor(x), 3), j_attn.repeat_kv(jnp.asarray(x), 3))
    _close(t_attn.causal_mask_bias(6, 9, q_offset=3, sliding_window=4),
           j_attn.causal_mask_bias(6, 9, q_offset=3, sliding_window=4))
    am = (rng.random((2, 7)) > 0.4).astype(np.int32)
    _close(t_attn.padding_mask_bias(torch.tensor(am)), j_attn.padding_mask_bias(jnp.asarray(am)))
    seg = np.array([[0, 0, 1, 1, 1, 2, 2]], np.int32)
    _close(t_attn.segment_mask_bias(torch.tensor(seg)),
           j_attn.segment_mask_bias(jnp.asarray(seg)))


CORE_CASES = [
    # (name, causal, window, q_offset, padding, segments, sq, skv)
    ("causal", True, None, 0, False, False, 16, 16),
    ("window", True, 5, 0, False, False, 16, 16),
    ("q_offset", True, None, 8, False, False, 8, 16),
    ("padding", True, None, 0, True, False, 16, 16),
    ("segments", True, None, 0, False, True, 16, 16),
    ("non_causal_padding", False, None, 0, True, False, 16, 16),
]


@pytest.mark.parametrize("name,causal,window,q_offset,padding,segments,sq,skv", CORE_CASES)
def test_core_attention_fwd_and_grad(name, causal, window, q_offset, padding, segments, sq,
                                     skv):
    rng = np.random.default_rng(5)
    b, nh, nkv, d = 2, 4, 2, 8
    q, k, v = _rand(rng, b, sq, nh, d), _rand(rng, b, skv, nkv, d), _rand(rng, b, skv, nkv, d)
    cot = _rand(rng, b, sq, nh, d)
    am = np.ones((b, skv), np.int32)
    am[1, 11:] = 0
    seg = np.repeat(np.array([[0] * 5 + [1] * 6 + [2] * 5]), b, 0).astype(np.int32)

    def run(mod, xp):
        def fn(q, k, v):
            return mod.attention(
                q, k, v, impl="core", causal=causal, q_offset=q_offset,
                sliding_window=window,
                attention_mask=xp(am) if padding else None,
                segment_ids=xp(seg) if segments else None)
        return fn

    to, tg = _torch_vjp(run(t_attn, torch.tensor), [q, k, v], cot)
    jo, jg = _jax_vjp(run(j_attn, jnp.asarray), [q, k, v], cot)
    _close(to, jo)
    for a, b_ in zip(tg, jg):
        _grad_close(a, b_)


def test_attention_dispatch_rules():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="zigzag_ring does not support attention_mask"):
        t_attn.attention(q, q, q, impl="zigzag_ring", attention_mask=torch.ones(1, 4))
    with pytest.raises(ValueError, match="flash and core paths only"):
        t_attn.attention(q, q, q, impl="ring", segment_ids=torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="zigzag ring does not support sliding_window"):
        t_attn.attention(q, q, q, impl="zigzag_ring", sliding_window=2)


@pytest.mark.parametrize("impl,module,fn", [
    ("ring", "ring_attention", "ring_attention"),
    ("ulysses", "ulysses", "ulysses_attention"),
    ("zigzag_ring", "ring_attention", "zigzag_ring_attention"),
])
def test_cp_impls_dispatch_to_their_modules(impl, module, fn, monkeypatch):
    """Each context-parallel impl reaches its module's function with the
    context group; without one it is core attention (JAX's cp == 1 rule),
    and an explicit q_offset is rejected as in JAX."""
    import importlib

    q = torch.randn(1, 8, 2, 8, generator=torch.Generator().manual_seed(1))
    assert torch.equal(t_attn.attention(q, q, q, impl=impl), t_attn.core_attention(q, q, q))
    with pytest.raises(ValueError, match="q_offset is not meaningful"):
        t_attn.attention(q, q, q, impl=impl, q_offset=4)
    mod = importlib.import_module(f"neuronx_distributed_training_torch.parallel.{module}")
    seen = {}
    monkeypatch.setattr(mod, fn, lambda *a, **kw: seen.update(kw) or a[0])
    group = object()
    assert t_attn.attention(q, q, q, impl=impl, cp=group) is q
    assert seen["cp"] is group
