"""The port's LoRA against the JAX package's.

- ``LoraConfig.from_config``, ``add_lora`` (shapes, targets, init),
  ``trainable_mask`` and ``merge_lora`` against ``peft/lora.py``;
- ``apply_linear`` with adapters, forward and gradients, fp32 rtol 1e-6;
  with ``compute_dtype=bfloat16`` and a frozen fp32 weight, as the LoRA
  layer runs under ``mixed_precision``, within one bf16 rounding (2^-8) of
  each array's largest entry;
- the Llama forward on an SFT-shaped batch (prompt labels -100, a loss
  mask, packed ``segment_ids``) with LoRA leaves carried in by
  ``params_from_jax``: the loss and every adapter gradient against
  ``llama.forward`` + ``jax.grad`` under JAX's ``trainable_mask``, with
  ``test_torch_llama.py``'s tolerances (fp32 loss rtol 2e-4 / grads 1e-4
  of each leaf's largest entry is what that file allows; here fp32 is held
  to loss rtol 1e-5 and grads 1e-5; ``mixed_precision`` to loss rtol 1e-4
  and grads 3e-2); the frozen leaves get no ``.grad``;
- three training steps with the freeze against the JAX ``make_train_step``
  with ``trainable_mask`` (which calls ``adamw_update(...,
  trainable_mask=...)``): adapters and ``grad_norm`` within
  ``test_torch_step.py``'s tolerances, every frozen leaf bit for bit, and no
  optimizer state for frozen leaves.

B is drawn non-zero in these comparisons so that every adapter has a
gradient from the first step.  With B = 0, A's gradient is exactly zero in
step 1 and proportional to B's first update (about lr) in step 2, where
Adam's first update of A is about lr * sign(g) for gradients near eps: more
of A's entries then flip between the two frameworks than the base model's
do in ``test_torch_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.ops import linear as t_linear
from neuronx_distributed_training_torch.optim import adamw as t_adamw
from neuronx_distributed_training_torch.optim import lr as t_lr
from neuronx_distributed_training_torch.peft import lora as t_lora
from neuronx_distributed_training_torch.tools.convert import params_from_jax, params_to_jax
from neuronx_distributed_training_torch.trainer import step as t_step
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy as TPolicy
from neuronx_distributed_training_tpu.models import llama as j_llama
from neuronx_distributed_training_tpu.ops import linear as j_linear
from neuronx_distributed_training_tpu.optim import adamw as j_adamw
from neuronx_distributed_training_tpu.optim import lr as j_lr
from neuronx_distributed_training_tpu.peft import lora as j_lora
from neuronx_distributed_training_tpu.trainer import step as j_step
from neuronx_distributed_training_tpu.utils.dtypes import DtypePolicy as JPolicy

MODEL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
             num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=128,
             rope_theta=500000.0)
LORA = {"lora_rank": 8, "lora_alpha": 32, "lora_dropout": 0.05,
        "target_modules": ["qkv_proj", "o_proj", "gate_up_proj", "down_proj"]}
B, S = 2, 128
TOL = {"fp32": (1e-5, 1e-5), "mixed_precision": (1e-4, 3e-2)}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jkey(name: str):
    """A port name (``layers.0.attn.qkv.lora_a``) -> (the JAX keystr of the
    stacked leaf, the layer index or None)."""
    parts = name.split(".")
    layer = int(parts[1]) if parts[0] == "layers" else None
    keys = [k for k in parts if not k.isdigit()]
    return "".join(f"[{k!r}]" for k in keys), layer


def _jax_lora_params(precision="fp32", nonzero_b=True, seed=0):
    """JAX params with adapters; B drawn non-zero so every adapter has a
    gradient."""
    cfg = j_llama.LlamaConfig.from_config(MODEL)
    pol = JPolicy.from_precision_config(precision)
    params = j_lora.add_lora(j_llama.init_params(jax.random.PRNGKey(seed), cfg, pol),
                             j_lora.LoraConfig.from_config(LORA), jax.random.PRNGKey(seed + 1))
    if nonzero_b:
        rng = np.random.default_rng(seed)
        for blk in ("attn", "mlp"):
            for name, lin in params["layers"][blk].items():
                if "lora_b" in lin:
                    lin["lora_b"] = jnp.asarray(
                        0.02 * rng.standard_normal(lin["lora_b"].shape), lin["lora_b"].dtype)
    return cfg, pol, params


def _sft_batch(seed=0, gbs=B):
    """Packed SFT rows: two records per row, prompt labels -100, segments."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, MODEL["vocab_size"], (gbs, S)).astype(np.int32)
    labels = ids.copy()
    seg = np.zeros((gbs, S), np.int32)
    for r in range(gbs):
        cut, end = int(rng.integers(30, 80)), int(rng.integers(100, S))
        seg[r, :cut], seg[r, cut:end] = 1, 2
        labels[r, : int(rng.integers(5, 20))] = -100
        labels[r, cut: cut + int(rng.integers(5, 15))] = -100
        labels[r, end:] = -100
        ids[r, end:] = 0
    return {"input_ids": ids, "labels": labels,
            "loss_mask": (labels != -100).astype(np.float32), "segment_ids": seg}


# ---------------------------------------------------------------------------
# config, tree transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [LORA, {}, {"rank": 4, "alpha": 8, "dropout": 0.1},
                                   {"lora_rank": 16, "target_modules": ["q_proj", "v"]}])
def test_lora_config_matches_jax(block):
    t, j = t_lora.LoraConfig.from_config(block), j_lora.LoraConfig.from_config(block)
    assert (t.rank, t.alpha, t.dropout, t.target_modules, t.scale) == \
        (j.rank, j.alpha, j.dropout, j.target_modules, j.scale)


@pytest.mark.parametrize("targets", [LORA["target_modules"], ["qkv_proj"], None])
def test_add_lora_shapes_and_targets_match_jax(targets):
    block = dict(LORA, target_modules=targets)
    tcfg, jcfg = t_lora.LoraConfig.from_config(block), j_lora.LoraConfig.from_config(block)
    mc = t_llama.LlamaConfig.from_config(MODEL)
    base = t_llama.init_params(mc, TPolicy(), generator=torch.Generator().manual_seed(0))
    tparams = t_lora.add_lora(base, tcfg, torch.Generator().manual_seed(1))
    jparams = j_lora.add_lora(
        j_llama.init_params(jax.random.PRNGKey(0), j_llama.LlamaConfig.from_config(MODEL),
                            JPolicy()), jcfg, jax.random.PRNGKey(1))
    tflat, jflat = _flat(params_to_jax(tparams)), _flat(jparams)
    assert tflat.keys() == jflat.keys()
    assert all(tflat[k].shape == jflat[k].shape for k in tflat)
    named = t_llama.named_params(tparams)
    for n, t in named.items():
        if n.endswith("lora_b"):
            assert not t.any()
        elif n.endswith("lora_a"):
            # 0.02 x a normal cut at +-2: |a| <= 0.04, std 0.02 x 0.8796
            assert t.abs().max() <= 0.04 and abs(float(t.std()) - 0.0176) < 0.002
        elif n.endswith("lora_scale"):
            assert t.shape == () and float(t) == tcfg.scale
        else:
            assert t is t_llama.named_params(base)[n]  # the base is shared, not copied
    again = t_lora.add_lora(base, tcfg, torch.Generator().manual_seed(1))
    assert all(torch.equal(v, t_llama.named_params(again)[n]) for n, v in named.items())


def test_trainable_mask_matches_jax():
    _, _, jparams = _jax_lora_params()
    named = t_llama.named_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                                 device="cpu"))
    tmask = t_lora.trainable_mask(named)
    jmask = _flat(j_lora.trainable_mask(jparams))
    assert tmask.keys() == named.keys()
    for n, m in tmask.items():
        assert m == float(jmask[_jkey(n)[0]]), n
    assert sorted(n for n, m in tmask.items() if m) == sorted(
        f"layers.{i}.{blk}.{lin}.{ab}" for i in range(2)
        for blk, lin in (("attn", "qkv"), ("attn", "o"), ("mlp", "gate_up"), ("mlp", "down"))
        for ab in ("lora_a", "lora_b"))


def test_merge_lora_matches_jax():
    _, _, jparams = _jax_lora_params()
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tm, jm = _flat(params_to_jax(t_lora.merge_lora(tparams))), _flat(j_lora.merge_lora(jparams))
    assert tm.keys() == jm.keys() and not any("lora" in k for k in tm)
    for k in tm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert not np.array_equal(tm["['layers']['attn']['qkv']['w']"],
                              np.asarray(jparams["layers"]["attn"]["qkv"]["w"]))


# ---------------------------------------------------------------------------
# apply_linear
# ---------------------------------------------------------------------------


def test_apply_linear_with_adapters_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    p = {"w": rng.standard_normal((24, 40)).astype(np.float32) * 0.1,
         "lora_a": rng.standard_normal((24, 4)).astype(np.float32) * 0.1,
         "lora_b": rng.standard_normal((4, 40)).astype(np.float32) * 0.1,
         "lora_scale": np.float32(2.0)}
    dy = rng.standard_normal((2, 5, 40)).astype(np.float32)

    def jf(p, x):
        return jnp.sum(j_linear.apply_linear(p, x) * dy)

    jy = j_linear.apply_linear({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    jg = jax.grad(jf, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=k != "lora_scale") for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty = t_linear.apply_linear(tp, tx)
    (ty * torch.tensor(dy)).sum().backward()
    # fp32 products summed in other orders: within 1e-6 of each array's largest entry
    for name, t, j in [("y", ty.detach(), jy), ("dx", tx.grad, jg[1])] + [
            (k, tp[k].grad, jg[0][k]) for k in ("w", "lora_a", "lora_b")]:
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-6 * np.abs(j).max(), name


def test_apply_linear_with_adapters_in_bf16_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    p = {"w": rng.standard_normal((32, 48)).astype(np.float32) * 0.1,
         "lora_a": rng.standard_normal((32, 4)).astype(np.float32) * 0.1,
         "lora_b": rng.standard_normal((4, 48)).astype(np.float32) * 0.1,
         "lora_scale": np.float32(4.0)}
    dy = rng.standard_normal((3, 7, 48)).astype(np.float32)
    bf = jnp.bfloat16

    def jf(ad, x):
        y = j_linear.apply_linear({**ad, "w": jnp.asarray(p["w"])}, x, compute_dtype=bf)
        return jnp.sum(y.astype(jnp.float32) * dy)

    jad = {k: jnp.asarray(p[k]) for k in ("lora_a", "lora_b", "lora_scale")}
    jy = j_linear.apply_linear({**jad, "w": jnp.asarray(p["w"])}, jnp.asarray(x),
                               compute_dtype=bf)
    jg = jax.grad(jf, argnums=(0, 1))(jad, jnp.asarray(x))
    # the frozen base takes no gradient, as under the LoRA freeze
    tp = {k: torch.tensor(v, requires_grad=k in ("lora_a", "lora_b")) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty = t_linear.apply_linear(tp, tx, compute_dtype=torch.bfloat16)
    assert ty.dtype == torch.bfloat16 and jy.dtype == bf
    (ty.float() * torch.tensor(dy)).sum().backward()
    assert tp["w"].grad is None
    for name, t, j in [("y", ty.detach().float(), jy), ("dx", tx.grad, jg[1])] + [
            (k, tp[k].grad, jg[0][k]) for k in ("lora_a", "lora_b")]:
        assert t.dtype == torch.float32 or name == "y", name
        j = np.asarray(j, dtype=np.float32)
        assert np.abs(t.numpy() - j).max() <= 2.0 ** -8 * np.abs(j).max(), name


# ---------------------------------------------------------------------------
# the Llama forward with adapters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision,impl", [("fp32", "core"), ("mixed_precision", "core"),
                                            ("mixed_precision", "flash")])
def test_llama_lora_loss_and_adapter_grads_match_jax(precision, impl):
    block = dict(MODEL)
    if impl == "flash":
        block["fusions"] = {"flash_attention": True, "flash_block_q": 128,
                            "flash_block_kv": 128}
    jcfg = j_llama.LlamaConfig.from_config(block)
    _, jpol, jparams = _jax_lora_params(precision)
    batch = _sft_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: j_llama.forward(p, jb, jcfg, jpol)[0]))(
        jparams)
    mask = j_lora.trainable_mask(jparams)
    jgrads = _flat(jax.tree_util.tree_map(lambda g, m: g * m, jgrads, mask))

    tcfg = t_llama.LlamaConfig.from_config(block)
    tpol = TPolicy.from_precision_config(precision)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    named = t_llama.named_params(params)
    train = {n for n, m in t_lora.trainable_mask(named).items() if m}
    for n, p in named.items():
        p.requires_grad_(n in train)
    loss, _ = t_llama.forward(params, {k: torch.as_tensor(v) for k, v in batch.items()},
                              tcfg, tpol)
    loss.backward()
    loss_rtol, grad_rel = TOL[precision]
    assert np.isclose(float(loss), float(jloss), rtol=loss_rtol), (float(loss), float(jloss))
    assert all(named[n].grad is None for n in named if n not in train)
    assert len(train) == 16
    for n in train:
        key, layer = _jkey(n)
        jg, tg = jgrads[key][layer].astype(np.float32), named[n].grad.float().numpy()
        assert np.abs(jg).max() > 0, n
        err = np.abs(tg - jg).max() / np.abs(jg).max()
        assert err < grad_rel, (n, err)
    for n in named:  # JAX's masked gradient of every frozen leaf is zero
        if n not in train:
            key, layer = _jkey(n)
            assert not (jgrads[key] if layer is None else jgrads[key][layer]).any(), n


# ---------------------------------------------------------------------------
# three steps with the freeze
# ---------------------------------------------------------------------------

OPTIM = {"lr": 1e-3, "weight_decay": 0.1, "betas": [0.9, 0.95],
         "sched": {"name": "CosineAnnealing", "warmup_steps": 0, "max_steps": 6}}
TRAINER = {"gradient_clip_val": 1.0}


@pytest.mark.parametrize("precision", ["fp32", "mixed_precision"])
def test_three_lora_steps_match_jax_and_keep_the_base_bitwise(precision):
    jcfg, jpol, jparams = _jax_lora_params(precision)
    mask = j_lora.trainable_mask(jparams)
    jstep = jax.jit(j_step.make_train_step(
        lambda p, b, k: j_llama.forward(p, b, jcfg, jpol),
        j_adamw.AdamWConfig.from_config(OPTIM, TRAINER), j_lr.build_lr_schedule(OPTIM), jpol,
        num_microbatches=2, trainable_mask=mask))
    jstate = j_adamw.init_opt_state(jparams, jpol)

    tcfg = t_llama.LlamaConfig.from_config(MODEL)
    tpol = TPolicy.from_precision_config(precision)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    named = t_llama.named_params(tparams)
    train = {n for n, m in t_lora.trainable_mask(named).items() if m}
    before = {n: p.clone() for n, p in named.items()}
    tstep = t_step.make_train_step(
        lambda p, b: t_llama.forward(p, b, tcfg, tpol),
        t_adamw.AdamWConfig.from_config(OPTIM, TRAINER), t_lr.build_lr_schedule(OPTIM), tpol,
        num_microbatches=2, trainable=train)
    tstate = t_adamw.init_opt_state({n: named[n] for n in train}, tpol)
    assert set(tstate["mu"]) == train and len(train) == 16

    fp32 = precision == "fp32"
    for i in range(3):
        batch = _sft_batch(seed=10 + i, gbs=4)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.PRNGKey(i))
        tm = tstep(tparams, tstate, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert np.isclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5 if fp32 else 1e-4)
        assert np.isclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                          rtol=1e-5 if fp32 else 2e-3)
    jflat = _flat(jparams)
    tflat = _flat(params_to_jax(tparams))
    lr = OPTIM["lr"]
    apart, max_frac = (1e-6, 1e-2) if fp32 else (1e-4, 5e-2)
    for n, p in named.items():
        if n in train:
            assert not torch.equal(p, before[n]), n  # every adapter moved
        else:
            assert torch.equal(p, before[n]) and p.grad is None and not p.requires_grad, n
    for key, jl in jflat.items():
        tl = tflat[key]
        if "lora_a" in key or "lora_b" in key:
            d = np.abs(tl - jl)
            assert d.max() <= 2 * lr * 3, (key, d.max())
            assert (d > apart).mean() <= max_frac, (key, (d > apart).mean())
        else:  # JAX's frozen update is w - lr * 0: the base stays bit for bit
            np.testing.assert_array_equal(tl, jl, err_msg=key)
    # JAX keeps zero moments for frozen leaves; the port keeps none
    jmu = _flat(jstate["mu"])
    assert all(not v.any() for k, v in jmu.items() if "lora_a" not in k and "lora_b" not in k)
