"""Three training steps of the port against the JAX package's jitted
``make_train_step`` + ``adamw_update`` + ``build_lr_schedule`` (one CPU
device), plus the optimizer, schedule and dtype-policy pieces on their own.

Both sides start from the same weights (``tools/convert.py``) and see the same
seeded batches: global batch 4 in 2 microbatches, AdamW with clipping active
(the step-0 grad norm is above the clip value of 1), weight decay 0.1 off the
norm scales, and a cosine schedule.

Tolerances.  Adam's first update is about lr * sign(g) whatever |g|, so an
entry whose gradient is near zero can move by up to 2 * lr per step between
the two frameworks once their sums differ in the last bits, and later
gradients inherit that.  So params are held to a bound on every entry,
|delta| <= 2 * lr * steps, plus a bound on the fraction of entries that moved
apart at all; moments to each leaf's largest entry.
- ``fp32``: loss, grad_norm and lr rtol 1e-5 (measured 1.2e-6); params: at
  most 1% of entries apart by more than 1e-6 (measured 0.18%); mu and nu
  within 1e-3 of each leaf's largest entry (measured 2.1e-4).
- ``mixed_precision``: the bf16 forward rounds at other points in the two
  frameworks (see test_torch_llama): loss rtol 1e-4 (measured 2.3e-5),
  grad_norm rtol 2e-3 (6.9e-4); params: at most 5% of entries apart by more
  than 1e-4 = lr / 10 (measured 1.3%); mu and nu within 1e-1 of each leaf's
  largest entry (measured 3.9e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.optim import adamw as t_adamw
from neuronx_distributed_training_torch.optim import lr as t_lr
from neuronx_distributed_training_torch.tools.convert import params_from_jax, params_to_jax
from neuronx_distributed_training_torch.trainer import step as t_step
from neuronx_distributed_training_torch.utils import dtypes as t_dtypes
from neuronx_distributed_training_torch.utils import perf as t_perf
from neuronx_distributed_training_tpu.models import llama as j_llama
from neuronx_distributed_training_tpu.optim import adamw as j_adamw
from neuronx_distributed_training_tpu.optim import lr as j_lr
from neuronx_distributed_training_tpu.trainer import step as j_step
from neuronx_distributed_training_tpu.utils import dtypes as j_dtypes
from neuronx_distributed_training_tpu.utils import perf as j_perf

MODEL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
             num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=128,
             rope_theta=500000.0)
OPTIM = {"lr": 1e-3, "weight_decay": 0.1, "betas": [0.9, 0.95],
         "sched": {"name": "CosineAnnealing", "warmup_steps": 0, "max_steps": 6}}
TRAINER = {"gradient_clip_val": 1.0}
GBS, SEQ, NM, STEPS = 4, 128, 2, 3


def _unflatten(flat: dict) -> dict:
    """Dotted names -> the port's parameter-tree layout."""
    tree: dict = {}
    for name, t in flat.items():
        parts = name.split(".")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = t
    tree["layers"] = [tree["layers"][str(i)] for i in range(len(tree["layers"]))]
    return tree


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, MODEL["vocab_size"], (GBS, SEQ)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids.copy(),
                    "loss_mask": np.ones((GBS, SEQ), np.float32)})
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("precision", ["fp32", "mixed_precision"])
def test_three_steps_match_jax(precision):
    jcfg = j_llama.LlamaConfig.from_config(MODEL)
    jpol = j_dtypes.DtypePolicy.from_precision_config(precision)
    params = j_llama.init_params(jax.random.PRNGKey(0), jcfg, jpol)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    jstep = jax.jit(j_step.make_train_step(
        lambda p, b, k: j_llama.forward(p, b, jcfg, jpol),
        j_adamw.AdamWConfig.from_config(OPTIM, TRAINER), j_lr.build_lr_schedule(OPTIM), jpol,
        num_microbatches=NM))
    jstate = j_adamw.init_opt_state(params, jpol)

    tcfg = t_llama.LlamaConfig.from_config(MODEL)
    tpol = t_dtypes.DtypePolicy.from_precision_config(precision)
    tstep = t_step.make_train_step(
        lambda p, b: t_llama.forward(p, b, tcfg, tpol),
        t_adamw.AdamWConfig.from_config(OPTIM, TRAINER), t_lr.build_lr_schedule(OPTIM), tpol,
        num_microbatches=NM)
    tstate = t_adamw.init_opt_state(t_llama.named_params(tparams), tpol)

    fp32 = precision == "fp32"
    for i, batch in enumerate(_batches()):
        params, jstate, jm = jstep(params, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jax.random.PRNGKey(i))
        tm = tstep(tparams, tstate, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert np.isclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5 if fp32 else 1e-4)
        assert np.isclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                          rtol=1e-5 if fp32 else 2e-3)
        assert np.isclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-5)
    assert tstate["step"] == int(jstate["step"]) == STEPS
    assert ("master" in tstate) == ("master" in jstate)
    lr = OPTIM["lr"]
    apart, max_frac, moment_rel = (1e-6, 1e-2, 1e-3) if fp32 else (1e-4, 5e-2, 1e-1)
    for key, tree in (("params", tparams), ("mu", _unflatten(tstate["mu"])),
                      ("nu", _unflatten(tstate["nu"]))):
        jtree = params if key == "params" else jstate[key]
        tflat = dict(jax.tree_util.tree_flatten_with_path(params_to_jax(tree))[0])
        for path, jl in jax.tree_util.tree_flatten_with_path(jtree)[0]:
            tl, jl = np.asarray(tflat[path], np.float32), np.asarray(jl, np.float32)
            where = (key, jax.tree_util.keystr(path))
            if key == "params":
                d = np.abs(tl - jl)
                assert d.max() <= 2 * lr * STEPS, (where, d.max())
                assert (d > apart).mean() <= max_frac, (where, (d > apart).mean())
            else:
                assert _rel(tl, jl) < moment_rel, (where, _rel(tl, jl))


@pytest.mark.parametrize("sched", [
    {"name": "LinearAnnealingWithWarmUp", "warmup_steps": 3, "max_steps": 10, "min_lr": 1e-5},
    {"name": "CosineAnnealing", "warmup_steps": 2, "max_steps": 9, "min_lr": 0.0},
    {"name": "constant"},
])
def test_lr_schedules_match_jax(sched):
    cfg = {"lr": 3e-4, "sched": sched}
    t, j = t_lr.build_lr_schedule(cfg), j_lr.build_lr_schedule(cfg)
    for step in range(13):
        assert np.isclose(float(t(step)), float(j(step)), rtol=1e-6, atol=0), step
    with pytest.raises(ValueError, match="unknown LR schedule"):
        t_lr.build_lr_schedule({"sched": {"name": "nope"}})


@pytest.mark.parametrize("precision", [
    "mixed_precision", "bf16SR", "autocast", "fp32",
    {"type": "mixed_precision", "master_weights": False},
    {"type": "bf16", "grad_accum_dtype": "bf16"},
])
def test_dtype_policy_regimes_match_jax(precision):
    t = t_dtypes.DtypePolicy.from_precision_config(precision)
    j = j_dtypes.DtypePolicy.from_precision_config(precision)
    for f in ("param_dtype", "compute_dtype", "reduce_dtype", "grad_accum_dtype",
              "optimizer_dtype", "softmax_dtype"):
        assert str(getattr(t, f)).replace("torch.", "") == str(np.dtype(getattr(j, f))), f
    tree = {"a": torch.ones(2), "b": [torch.ones(2, dtype=torch.int32)]}
    cast = t.cast_to_compute(tree)
    assert cast["a"].dtype == t.compute_dtype and cast["b"][0].dtype == torch.int32
    with pytest.raises(ValueError, match="unknown precision regime"):
        t_dtypes.DtypePolicy.from_precision_config("fp8")


def test_adamw_pieces_match_jax():
    assert t_adamw.AdamWConfig.from_config(OPTIM, TRAINER) == \
        t_adamw.AdamWConfig(**vars(j_adamw.AdamWConfig.from_config(OPTIM, TRAINER)))
    cfg = t_adamw.AdamWConfig()
    names = ["embed.embedding", "layers.0.input_norm.scale", "layers.0.attn.qkv.w",
             "final_norm.scale", "lm_head.w"]
    assert t_adamw.decay_mask(names, cfg) == {
        "embed.embedding": 1.0, "layers.0.input_norm.scale": 0.0,
        "layers.0.attn.qkv.w": 1.0, "final_norm.scale": 0.0, "lm_head.w": 1.0}
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(s).astype(np.float32) for s in [(3, 4), (5,), (2, 2, 2)]]
    assert np.isclose(float(t_adamw.global_norm([torch.tensor(x) for x in xs])),
                      float(j_adamw.global_norm([jnp.asarray(x) for x in xs])), rtol=1e-6)
    pol = t_dtypes.DtypePolicy(param_dtype=torch.bfloat16)
    st = t_adamw.init_opt_state({"w": torch.ones(3, dtype=torch.bfloat16)}, pol)
    assert st["master"]["w"].dtype == torch.float32 and st["step"] == 0
    assert "master" not in t_adamw.init_opt_state({"w": torch.ones(3)}, t_dtypes.DtypePolicy())


def test_microbatch_split_and_flops():
    batch = {"input_ids": torch.arange(24).reshape(4, 6)}
    mb = t_step.microbatch_split(batch, 2)
    jmb = j_step.microbatch_split({"input_ids": jnp.arange(24).reshape(4, 6)}, 2)
    np.testing.assert_array_equal(mb["input_ids"].numpy(), np.asarray(jmb["input_ids"]))
    kw = dict(num_layers=32, hidden_size=4096, intermediate_size=14336, num_attention_heads=32,
              num_kv_heads=8, vocab_size=128256, seq_len=8192)
    assert t_perf.llama_flops_per_token(**kw) == j_perf.llama_flops_per_token(**kw)
    assert t_perf.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert t_perf.peak_tflops("NVIDIA H100 PCIe") == 756.0
    assert t_perf.card_peaks("NVIDIA H100 NVL") == (835e12, 3.9e12)
    assert t_perf.peak_tflops("cpu") is None
