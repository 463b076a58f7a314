"""The port's Llama forward and gradients against the JAX package's.

Weights are drawn by the JAX package's ``init_params`` and carried to the
port by ``tools/convert.py::params_from_jax``; the batch is seeded numpy.
Model: hidden 256, 2 heads, 1 KV head (GQA group 2), head_dim 128, ffn 512,
vocab 512, 2 layers, seq 256 — the JAX flash path runs in interpret mode at
128 x 128 blocks (2 x 2 blocks, so block skipping is exercised).

Tolerances:
- ``fp32``: loss rtol 2e-4; every gradient leaf within 1e-4 of its largest
  entry (fp32 sums in different orders).
- ``mixed_precision``: bf16 activations are rounded at different points by
  the two frameworks (XLA fuses elementwise chains before rounding, PyTorch
  rounds after each op), so a bf16 ulp (2^-8 = 3.9e-3 relative) enters at
  every rounding point: loss within rtol 1e-4 (the fp32 mean over 500 tokens
  averages the rounding out; measured 4.1e-6) and every gradient leaf within
  3e-2 of its largest entry (a few bf16 ulps; measured at most 1.12e-2).

The JAX side is jitted (one compile per case runs faster than the eager
interpret-mode Pallas kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.tools.convert import params_from_jax, params_to_jax
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy as TPolicy
from neuronx_distributed_training_tpu.models import llama as j_llama
from neuronx_distributed_training_tpu.utils.dtypes import DtypePolicy as JPolicy

MODEL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
             num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=256,
             rope_theta=500000.0)
B, S = 2, 256
TOL = {"fp32": (2e-4, 1e-4), "mixed_precision": (1e-4, 3e-2)}


def _model_block(impl, tied, remat):
    m = dict(MODEL, tie_word_embeddings=tied, activations_checkpoint_granularity=remat)
    if impl == "flash":
        m["fusions"] = {"flash_attention": True, "flash_block_q": 128, "flash_block_kv": 128}
    return m


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, MODEL["vocab_size"], (B, S)).astype(np.int32)
    return {"input_ids": ids, "labels": ids.copy(),
            "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32)}


def _jax_loss_and_grads(block, precision, batch):
    cfg = j_llama.LlamaConfig.from_config(block)
    pol = JPolicy.from_precision_config(precision)
    params = j_llama.init_params(jax.random.PRNGKey(0), cfg, pol)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: j_llama.forward(p, jb, cfg, pol)[0]))(
        params)
    return params, float(loss), grads


def _port_loss_and_grads(block, precision, jparams, batch):
    cfg = t_llama.LlamaConfig.from_config(block)
    pol = TPolicy.from_precision_config(precision)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    flat = t_llama.named_params(params)
    for p in flat.values():
        p.requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, _ = t_llama.forward(params, tb, cfg, pol)
    loss.backward()

    def grad_tree(tree):
        if isinstance(tree, dict):
            return {k: grad_tree(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [grad_tree(v) for v in tree]
        return tree.grad

    return float(loss.detach()), params_to_jax(grad_tree(params))


CASES = [
    # (precision, impl, tied, remat)
    ("fp32", "flash", False, "selective"),
    ("fp32", "core", False, "selective"),
    ("fp32", "flash", True, "selective"),
    ("fp32", "core", True, "full"),
    ("mixed_precision", "flash", False, "selective"),
    ("mixed_precision", "core", False, "selective"),
]


@pytest.mark.parametrize("precision,impl,tied,remat", CASES)
def test_loss_and_every_grad_leaf_match_jax(precision, impl, tied, remat):
    block = _model_block(impl, tied, remat)
    batch = _batch()
    jparams, jloss, jgrads = _jax_loss_and_grads(block, precision, batch)
    tloss, tgrads = _port_loss_and_grads(block, precision, jparams, batch)
    loss_rtol, grad_rel = TOL[precision]
    assert np.isclose(tloss, jloss, rtol=loss_rtol), (tloss, jloss)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(tgrads)[0])
    assert len(tflat) == len(jflat)
    for path, jg in jflat:
        jg = np.asarray(jg, np.float32)
        tg = np.asarray(tflat[path], np.float32)
        assert tg.shape == jg.shape, path
        err = np.abs(tg - jg).max() / (np.abs(jg).max() + 1e-12)
        assert err < grad_rel, (jax.tree_util.keystr(path), err)


def test_convert_round_trip_and_layout():
    cfg = j_llama.LlamaConfig.from_config(_model_block("flash", False, "selective"))
    jparams = jax.tree_util.tree_map(
        np.asarray, j_llama.init_params(jax.random.PRNGKey(1), cfg, JPolicy()))
    params = params_from_jax(jparams, device="cpu")
    assert len(params["layers"]) == MODEL["num_layers"]
    assert params["layers"][0]["attn"]["qkv"]["w"].shape == (256, (2 + 2 * 1) * 128)
    assert params["embed"]["embedding"].shape == (512, 256)
    back = params_to_jax(params)
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    bleaves = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(bleaves) == len(jleaves)
    for path, a in jleaves:
        np.testing.assert_array_equal(bleaves[path], a)
    names = t_llama.named_params(params)
    assert "layers.1.mlp.gate_up.w" in names and "lm_head.w" in names


def test_config_from_yaml_blocks_and_positions():
    block = dict(MODEL, fusions={"flash_attention": True})
    assert t_llama.LlamaConfig.from_config(block).attention_impl == "flash"
    assert t_llama.LlamaConfig.from_config(MODEL).attention_impl == "core"
    jc = j_llama.LlamaConfig.from_config(block)
    tc = t_llama.LlamaConfig.from_config(block)
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "kv_heads",
              "head_size", "rope_theta", "rms_norm_eps", "tie_word_embeddings",
              "activations_checkpoint_granularity", "attention_impl"):
        assert getattr(tc, f) == getattr(jc, f), f
    ids = np.zeros((2, 9), np.int32)
    am = np.array([[0, 0, 1, 1, 1, 1, 1, 1, 1], [1] * 9], np.int32)
    seg = np.array([[1, 1, 1, 2, 2, 3, 3, 3, 3], [5] * 9], np.int32)
    for kw in ({}, {"attention_mask": am}, {"segment_ids": seg}):
        tp = t_llama.positions_for(torch.tensor(ids),
                                   **{k: torch.tensor(v) for k, v in kw.items()})
        jp = j_llama.positions_for(jnp.asarray(ids),
                                   **{k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_init_params_shapes_and_dtypes():
    cfg = t_llama.LlamaConfig.from_config(_model_block("flash", False, "selective"))
    gen = torch.Generator().manual_seed(0)
    params = t_llama.init_params(cfg, TPolicy(param_dtype=torch.bfloat16), generator=gen,
                                 device="cpu")
    jparams = j_llama.init_params(jax.random.PRNGKey(0), j_llama.LlamaConfig.from_config(
        _model_block("flash", False, "selective")))
    back = params_to_jax(params)
    assert (jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams))
    assert ([np.shape(x) for x in jax.tree_util.tree_leaves(back)]
            == [x.shape for x in jax.tree_util.tree_leaves(jparams)])
    assert all(p.dtype == torch.bfloat16 for p in t_llama.named_params(params).values())
    assert torch.all(params["final_norm"]["scale"] == 1)
