"""Megatron GPT in the port against the JAX package, on the CPU
(``models/gpt.py``, ``utils/prng.py``, the GPT leaves of
``parallel/sharding.py``, ``tensor_parallel.full_width_norm``,
``tools/convert_megatron.py`` and the GPT trainer).

Model: a tiny GPT (hidden 64, ffn 96, 4 heads over 2 kv groups, 2 layers,
seq 16, vocab 96), weights crossing with ``tools/convert.py``, inputs seeded
numpy; the norms' scales and every bias are perturbed from JAX's init so
none is trivially one or zero.  Bars, as JAX's ``tests/test_gpt.py`` and the
port's other model tests: fp32 loss rtol 2e-5, gradients rtol 1e-3 / atol
1e-5; ``mixed_precision`` loss rtol 1e-4.

- ``forward`` + gradients over the combinations of block layout x
  activation, with the norm, the positions, the bias and the tying rotated
  across them, and ``rotary_percentage`` 0.5, MQA, a sliding window, left
  padding, segment ids, tokentype ids and full remat riding on some of
  them; the loss in mixed precision;
  ``gelu`` and ``geglu``'s gate against ``jax.nn.gelu`` (the tanh form);
- GPT-MoE: top-k and sinkhorn routing, dropped and dropless, ``moe_frequency``
  2 (JAX's grouped layout through ``tools/convert.py``);
- the normformer's whole-width mid-MLP norm at tp 2 (two ranks in threads,
  their all-reduces answered in memory) against the norm at tp 1;
- ``pipeline_hooks`` at pp 2 through the loopback's wavefront against JAX's
  ``pipeline_loss(stage_aux=True)``, dense and MoE;
- the decay mask against JAX's; the MFU accounting; ``GPTConfig.from_config``
  on every ``megatron_*`` config and JAX's aliases; the block-layout rules and
  the trainer's refusals with their texts; DPO on a GPT-MoE;
- ``tools/convert_megatron.py`` against JAX's, in a round trip and from tp 2
  x pp 2 shards;
- dropout (JAX's masks cannot be drawn by torch, so parity is held at rate
  0): a mask is a function of its key path, its row and its position; a tp
  rank, an SP slice and a data rank's rows draw the masks of the one-rank
  run; the wavefront's recompute redraws them (``1f1b`` and the wavefront
  bit for bit); a resume redraws the straight run's (bit for bit); rate 0 or
  no key draws nothing;
- one 4-rank gloo launch (``tests/_torch_dp_worker.py``) in a thread while
  the JAX trainers fit: tp 2 x dp 2 (SP, tied, layernorm + bias, gelu, vocab
  97: padded slices) against the JAX trainer on one device, whose trainer
  refuses vocab 97 at tp 2 (its embedding spec must divide it) and whose
  GSPMD computes one function on every mesh; pp 2 x tp 2 (rmsnorm, swiglu,
  untied) against the JAX trainer at that mesh; and at dropout 0.1, dp 2 x
  tp 2 against dp 4 x tp 1 of the port (the same microbatches); a tp 2 x
  dp 2 save restored at tp 1 bit for bit; the port at one rank against the
  one-device JAX trainer.
"""

import concurrent.futures
import dataclasses
import itertools
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_pipeline_1f1b as JP
import test_torch_dp as DPT
import test_torch_pipeline as PPT
import test_torch_tp as TPT
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import gpt as t_gpt
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.ops import moe as t_moe
from neuronx_distributed_training_torch.optim import adamw as t_adamw
from neuronx_distributed_training_torch.parallel import pipeline as t_pipe
from neuronx_distributed_training_torch.parallel import tensor_parallel as t_tp
from neuronx_distributed_training_torch.tools import convert_megatron as t_cm
from neuronx_distributed_training_torch.tools.convert import params_from_jax
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.utils import perf as t_perf
from neuronx_distributed_training_torch.utils import prng
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy as TPolicy
from neuronx_distributed_training_tpu.alignment import dpo as j_dpo
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.models import gpt as j_gpt
from neuronx_distributed_training_tpu.ops import moe as j_moe
from neuronx_distributed_training_tpu.optim import adamw as j_adamw
from neuronx_distributed_training_tpu.parallel.mesh import MeshConfig as JMeshConfig
from neuronx_distributed_training_tpu.parallel.mesh import build_mesh as j_build_mesh
from neuronx_distributed_training_tpu.tools import convert_megatron as j_cm
from neuronx_distributed_training_tpu.trainer import loop as j_loop
from neuronx_distributed_training_tpu.utils import perf as j_perf
from neuronx_distributed_training_tpu.utils.dtypes import DtypePolicy as JPolicy

REPO = Path(__file__).resolve().parents[1]
CONF = REPO / "examples" / "conf"
BASE = dict(vocab_size=96, hidden_size=64, ffn_hidden_size=96, num_layers=2,
            num_attention_heads=4, num_query_groups=2, max_position_embeddings=32,
            activations_checkpoint_granularity=None)
RTOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-3, 1e-5
LAUNCH_TIMEOUT = 600
MEGATRON = sorted(p.name for p in CONF.glob("megatron_*.yaml"))


def _policies(precision: str = "fp32"):
    return (JPolicy.from_precision_config({"type": precision}),
            TPolicy.from_precision_config({"type": precision}))


def _cfgs(moe=None, **kw):
    """The JAX and the port's GPTConfig of ``BASE`` with ``kw``; ``moe`` the
    MoE block's knobs (4 experts)."""
    c = {**BASE, **kw}
    jm = tm = None
    if moe is not None:
        jm = j_moe.MoEConfig(**{"num_experts": 4, **moe})
        tm = t_moe.MoEConfig(**dataclasses.asdict(jm))
    return j_gpt.GPTConfig(**c, moe=jm), t_gpt.GPTConfig(**c, moe=tm)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named(jtree) -> dict:
    return t_llama.named_params(params_from_jax(_np(jtree), device="cpu"))


def _close(got, want, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


#: JAX's perturbed init by (config, seed), built once for the module: most
#: cases ask for the same weights on the JAX side and on the port's side
_JAX_PARAMS: dict = {}


def _jax_params(jc, seed=0):
    """JAX's init with every norm scale and every bias perturbed (a copy of
    the module's cached tree: callers may write into what they get)."""
    key = (repr(jc), seed)
    if key not in _JAX_PARAMS:
        _JAX_PARAMS[key] = _perturbed_init(jc, seed)
    return jax.tree_util.tree_map(np.copy, _JAX_PARAMS[key])


def _perturbed_init(jc, seed):
    jp = j_gpt.init_params(jax.random.PRNGKey(seed), jc, _policies()[0])
    rng = np.random.default_rng(seed + 100)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        if "bias" in name or "scale" in name:
            return np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(perturb, jp)


def _batch(b=2, s=16, vocab=96, seed=1, extra=()):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    out = {"input_ids": ids, "labels": ids}
    if "left_pad" in extra:
        am = np.ones((b, s), np.int32)
        am[0, :5] = 0
        out["attention_mask"] = am
    if "segments" in extra:
        out["segment_ids"] = np.repeat(np.arange(2), s // 2)[None].repeat(b, 0).astype(np.int32)
    if "tokentypes" in extra:
        out["tokentype_ids"] = rng.integers(0, 2, (b, s)).astype(np.int32)
    return out


def _jax_loss_grads(jc, batch, precision="fp32", seed=0):
    """JAX's loss and gradients (by the port's names) of ``forward``."""
    jpol, _ = _policies(precision)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: j_gpt.forward(p, {k: jnp.asarray(v) for k, v in batch.items()}, jc,
                                jpol)[0]))(_jax_params(jc, seed))
    return float(jl), {n: t.numpy() for n, t in _named(jg).items()}


def _port_loss_grads(jc, tc, batch, precision="fp32", seed=0):
    _, tpol = _policies(precision)
    tp = params_from_jax(_jax_params(jc, seed), device="cpu")
    flat = t_llama.named_params(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, _ = t_gpt.forward(tp, {k: torch.tensor(v) for k, v in batch.items()}, tc, tpol)
    tl.backward()
    return float(tl.detach()), {n: t.grad for n, t in flat.items()}


def _combos():
    """Each block layout x activation; the norm, the positions, the bias and
    the tying take four patterns that cover both values of each, rotated so
    each layout meets all four.  The other knobs ride on some of the
    sixteen: rotary 0.5, MQA, a window, left padding (with rope and with
    learned positions), segment ids, tokentype ids, full remat."""
    patterns = [("layernorm", "rope", True, True), ("rmsnorm", "learned_absolute", False, True),
                ("layernorm", "learned_absolute", False, False),
                ("rmsnorm", "rope", True, False)]
    riders = {(0, 1): ("mqa", dict(num_query_groups=1), ()),
              (1, 2): ("window", dict(sliding_window=6), ()),
              (1, 3): ("rotary_half", dict(rotary_percentage=0.5), ()),
              (2, 1): ("left_pad", {}, ("left_pad",)),
              (0, 2): ("left_pad", {}, ("left_pad",)),
              (2, 3): ("segments", {}, ("segments",)),
              (3, 0): ("tokentypes", dict(num_tokentypes=2), ("tokentypes",)),
              (3, 2): ("full_remat", dict(activations_checkpoint_granularity="full"), ())}
    out = {}
    for b, bt in enumerate(t_gpt.BLOCK_TYPES):
        for a, act in enumerate(t_gpt.ACTIVATIONS):
            norm, pos, bias, tied = patterns[(a + b) % 4]
            kw = dict(transformer_block_type=bt, activation=act, normalization=norm,
                      position_embedding_type=pos, bias=bias,
                      share_embeddings_and_output_weights=tied)
            name, extra_kw, extra = riders.get((b, a), ("", {}, ()))
            out[f"{bt}-{act}-{norm}-{pos}-{'bias' if bias else 'nobias'}-"
                f"{'tied' if tied else 'untied'}{'-' + name if name else ''}"] = (
                    {**kw, **extra_kw}, extra)
    return out


COMBOS = _combos()
MOE = {"topk_dropless": (dict(top_k=2, dropless=True), 1),
       "topk_dropped": (dict(top_k=2, dropless=False, capacity_factor=1.0), 1),
       "sinkhorn": (dict(top_k=1, router_type="sinkhorn", dropless=True), 1),
       "sinkhorn_dropped": (dict(top_k=1, router_type="sinkhorn", dropless=False,
                                 capacity_factor=1.0), 1),
       "frequency_2": (dict(top_k=2, dropless=True), 2)}
MIXED = dict(transformer_block_type="normformer", activation="geglu")


def _moe_cfgs(case):
    """GPT-MoE (post_ln, so the router loss crosses a norm after it)."""
    moe, freq = MOE[case]
    return _cfgs(moe=moe, moe_frequency=freq, num_layers=2 * freq,
                 transformer_block_type="post_ln")


@pytest.mark.parametrize("case", list(COMBOS))
def test_forward_and_grads_match_jax(case):
    kw, extra = COMBOS[case]
    jc, tc = _cfgs(**kw)
    jl, jg = _jax_loss_grads(jc, _batch(extra=extra))
    tl, tg = _port_loss_grads(jc, tc, _batch(extra=extra))
    _close(tl, jl)
    assert set(tg) == set(jg)
    for n, g in tg.items():
        _close(g, jg[n], GRAD_RTOL, GRAD_ATOL, n)


def test_mixed_precision_loss_matches_jax():
    jc, tc = _cfgs(**MIXED)
    tl, _ = _port_loss_grads(jc, tc, _batch(), "mixed_precision")
    _close(tl, _jax_loss_grads(jc, _batch(), "mixed_precision")[0], 1e-4)


@pytest.mark.parametrize("act", ["gelu", "geglu"])
def test_gelu_is_the_tanh_approximation(act):
    """``jax.nn.gelu`` defaults to the tanh form and torch's ``gelu`` to erf:
    the port's activation is JAX's to 1e-6 where the two forms differ by up
    to ~5e-4."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)[None]
    x2 = np.concatenate([x, np.full_like(x, 1.5)], -1)
    jc, tc = _cfgs(activation=act)
    want = np.asarray(j_gpt._activation(jc, jnp.asarray(x2 if act == "geglu" else x)))
    got = t_gpt._activation(tc, torch.tensor(x2 if act == "geglu" else x)).numpy()
    _close(got, want, 0, 1e-6)


@pytest.mark.parametrize("case", list(MOE))
def test_moe_gpt_matches_jax(case):
    """GPT-MoE: the loss with its router term averaged over the MoE layers,
    every gradient; at ``moe_frequency`` 2 JAX's grouped layout crosses to
    the port's alternating layers."""
    jc, tc = _moe_cfgs(case)
    jl, jg = _jax_loss_grads(jc, _batch())
    tl, tg = _port_loss_grads(jc, tc, _batch())
    _close(tl, jl)
    for n, g in tg.items():
        _close(g, jg[n], GRAD_RTOL, GRAD_ATOL, n)
    if MOE[case][1] > 1:
        kinds = [t_moe.is_moe_mlp(lp["mlp"]) for lp in
                 params_from_jax(_jax_params(jc), device="cpu")["layers"]]
        assert kinds == [True, False, True, False]


class _ThreadTP:
    """A tp group of ``size`` ranks, one per thread: ``all_reduce`` sums
    the ranks' tensors in memory (for ``tensor_parallel.all_reduce``)."""

    def __init__(self, size):
        self.size, self.barrier, self.lock, self.box = size, threading.Barrier(size, timeout=60), \
            threading.Lock(), []

    def view(self, rank):
        return type("TP", (), {"size": self.size, "rank": rank, "sequence_parallel": False,
                               "group": self})()

    def all_reduce(self, x):
        with self.lock:
            self.box.append(x.clone())
        self.barrier.wait()
        out = sum(self.box[1:], self.box[0].clone())
        self.barrier.wait()
        with self.lock:
            self.box.clear()
        self.barrier.wait()
        return out


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_normformer_mid_norm_is_whole_width_at_tp2(norm, monkeypatch):
    """The mid-MLP norm over an ffn split in two column halves, each rank in
    a thread: the outputs and the gradients of the input, scale and bias,
    put together, are the whole-width norm's at tp 1 (JAX's true norm over
    the ffn), to fp32 rounding; a per-shard norm would differ."""
    monkeypatch.setattr(t_tp, "all_reduce", lambda x, tp, op=None: tp.group.all_reduce(x))
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(0.3, 2.0, (2, 5, 96)).astype(np.float32))
    params = {"scale": torch.tensor(rng.normal(1, 0.2, 96).astype(np.float32)),
              "bias": torch.tensor(rng.normal(0, 0.2, 96).astype(np.float32))}
    if norm == "rmsnorm":
        params.pop("bias")
    dy = torch.tensor(rng.normal(0, 1, (2, 5, 96)).astype(np.float32))

    def run(tp, xs):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xs = xs.clone().requires_grad_(True)
        y = t_tp.full_width_norm(leaves, xs, tp, eps=1e-5, center=norm == "layernorm")
        return y, xs, leaves

    y1, x1, p1 = run(None, x)
    (y1 * dy).sum().backward()
    group, outs = _ThreadTP(2), [None, None]

    def rank(r):
        y, xs, leaves = run(group.view(r), x[..., r * 48:(r + 1) * 48])
        (y * dy[..., r * 48:(r + 1) * 48]).sum().backward()
        outs[r] = (y.detach(), xs.grad, {k: v.grad for k, v in leaves.items()})

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and all(o is not None for o in outs)
    _close(torch.cat([o[0] for o in outs], -1), y1.detach(), 1e-5, 1e-6)
    _close(torch.cat([o[1] for o in outs], -1), x1.grad, 1e-4, 1e-6)
    for k in params:  # a partial sum over tp: each rank's slice, zeros elsewhere
        _close(outs[0][2][k] + outs[1][2][k], p1[k].grad, 1e-5, 1e-6, k)
    per_shard = t_gpt.norm_ops.apply_layer_norm if norm == "layernorm" else \
        t_gpt.norm_ops.apply_rms_norm
    half = per_shard({k: v[:48] for k, v in params.items()}, x[..., :48])
    assert not torch.allclose(half, y1.detach()[..., :48], atol=1e-3)


def _pp_case(kind):
    moe = dict(top_k=2, dropless=True) if kind == "moe" else None
    jc, tc = _cfgs(moe=moe, num_layers=4, position_embedding_type="learned_absolute")
    return jc, tc, (1.0 / (4 * 4) if moe else 0.0)


def _jax_pipeline(kind):
    jc, _, scale = _pp_case(kind)
    ids, mask = PPT._batch(4, vocab=96)
    mbs = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids),
           "loss_mask": jnp.asarray(mask)}
    mesh = j_build_mesh(JMeshConfig(pipeline_model_parallel_size=2), devices=jax.devices()[:2])
    sh_params, sh_mbs = JP.shard_for(mesh, jc, _jax_params(jc, 3), mbs,
                                     specs=j_gpt.param_specs(jc, pipeline=True))
    jl, jg = JP.wavefront_loss_and_grad(mesh, j_gpt.pipeline_hooks(jc, JP.FP32), sh_params,
                                        sh_mbs, stage_aux=True, aux_scale=scale)
    return float(jl), {n: t.numpy() for n, t in _named(jg).items()}


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_pipeline_hooks_match_jax_wavefront(kind):
    """``pipeline_hooks`` at pp 2 (learned positions and a tied head, so
    stage 0's position table and both ends' embedding gradients meet in the
    pipe sum), 4 microbatches with uneven loss masks, through the loopback's
    wavefront, against JAX's ``pipeline_loss(stage_aux=True)``: the loss (with
    the stages' router terms under MoE) and every gradient."""
    jc, tc, scale = _pp_case(kind)
    moe = tc.moe is not None
    jl, want = _jax_pipeline(kind)
    ids, mask = PPT._batch(4, vocab=96)
    nm = 4
    tp = params_from_jax(_jax_params(jc, 3), device="cpu")
    leaves = t_llama.named_params(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    t_mbs = [{"input_ids": torch.tensor(ids[m]), "labels": torch.tensor(ids[m]),
              "loss_mask": torch.tensor(mask[m])} for m in range(nm)]
    denom = t_pipe.ce_denominator({"labels": torch.tensor(ids), "loss_mask": torch.tensor(mask)},
                                  shift_labels=True)
    loss, grads = t_pipe.loopback_step(tp, t_gpt.pipeline_hooks(tc, PPT.FP32), t_mbs, denom,
                                       "wavefront", 2, leaves=leaves, act_dtype=torch.float32,
                                       aux_scale=scale if moe else None)
    _close(float(loss.detach()), jl, 1e-5)
    for n in leaves:
        _close(grads[n], want[n], 5e-4, 1e-5, n)


def test_decay_mask_matches_jax():
    """AdamW's decay mask on GPT's dotted names is JAX's on its tree paths:
    biases and every norm (``nf_mlp_norm`` too) undecayed, the position and
    tokentype tables decayed."""
    jc, _ = _cfgs(transformer_block_type="normformer", position_embedding_type="learned_absolute",
                  num_tokentypes=2, share_embeddings_and_output_weights=False)
    jp = _jax_params(jc)
    cfg = {"weight_decay": 0.1}
    jmask = j_adamw.decay_mask(jp, j_adamw.AdamWConfig.from_config(cfg))
    want = _named(jax.tree_util.tree_map(lambda m, x: np.full(np.shape(x), m, np.float32),
                                         jmask, jp))
    got = t_adamw.decay_mask(list(want), t_adamw.AdamWConfig.from_config(cfg))
    assert {n: float(want[n].flatten()[0]) for n in want} == got
    assert got["pos_embed.embedding"] == 1.0 and got["layers.0.attn.qkv.bias"] == 0.0
    assert got["layers.0.nf_mlp_norm.scale"] == 0.0


def test_mfu_counts_match_jax():
    for kw in (dict(), dict(activation="swiglu"),
               dict(moe=dict(top_k=2), moe_frequency=2, num_layers=4)):
        jc, tc = _cfgs(**kw)
        assert t_perf.flops_for_model(tc, 2048) == pytest.approx(
            j_perf.flops_for_model(jc, 2048), rel=1e-12), kw
    # the shipped gelu config: 2 matmuls in the MLP, the tied head counted
    cfg = t_loader.load_config(CONF / "megatron_gpt_config.yaml")
    jcfg = j_loader.load_config(CONF / "megatron_gpt_config.yaml")
    tc = t_loop.model_config(cfg)
    jc = j_gpt.GPTConfig.from_config(dict(jcfg["model"]), dict(jcfg["distributed_strategy"]))
    assert t_perf.flops_for_model(tc, 2048) == pytest.approx(j_perf.flops_for_model(jc, 2048),
                                                             rel=1e-12)


@pytest.mark.parametrize("config", MEGATRON + ["aliases"])
def test_from_config_matches_jax(config):
    """Every knob of JAX's ``GPTConfig.from_config``, aliases included."""
    if config == "aliases":
        model = {"num_kv_heads": 2, "has_bias": False, "rotary_base": 5e5,
                 "window_size": 64, "num_moe_experts": 4, "num_attention_heads": 4,
                 "hidden_dropout": 0.1, "num_tokentypes": 3,
                 "transformer_block_type": "gpt_j", "rotary_percentage": 0.25}
        ds = {"sequence_parallel": True}
    else:
        cfg = j_loader.load_config(CONF / config)
        model, ds = dict(cfg["model"]), dict(cfg["distributed_strategy"])
    j = dataclasses.asdict(j_gpt.GPTConfig.from_config(model, ds))
    t = dataclasses.asdict(t_gpt.GPTConfig.from_config(model, ds))
    for k in ("flash_block_q", "flash_block_kv"):  # the Hopper tiles are fixed
        j.pop(k)
    assert t == j


@pytest.mark.parametrize("override,text", [
    ({"model.transformer_block_type": "sandwich"}, "unknown transformer_block_type 'sandwich'"),
    ({"model.transformer_block_type": "normformer",
      "model.moe": {"num_experts": 4, "top_k": 2}}, "normformer blocks are dense-only"),
])
def test_block_layout_rules_match_jax(override, text):
    msgs = []
    for ld in (t_loader, j_loader):
        with pytest.raises(ValueError) as e:
            ld.load_config(CONF / "megatron_gpt_config.yaml", override)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and text in msgs[0]


def test_trainer_rules_for_gpt():
    """``auto`` resolves to the wavefront at pp 2 and an explicit ``1f1b`` is
    refused with JAX's gate text; cp and LoRA on GPT pass (once refused
    naming entry 11 [item 14], now ported); an unknown block type raises
    JAX's init text."""
    over = {"distributed_strategy.pipeline_model_parallel_size": 2,
            "distributed_strategy.tensor_model_parallel_size": 1,
            "distributed_strategy.sequence_parallel": False}
    cfg = t_loader.load_config(CONF / "megatron_gpt_config.yaml", over)
    t_loop.check_supported(cfg)
    facts = t_loop._pipeline_facts(cfg, dict(cfg["distributed_strategy"]), dict(cfg["model"]))
    assert t_pipe.resolve_schedule("auto", t_loop.model_config(cfg), facts) == "wavefront"
    forced = t_loader.load_config(CONF / "megatron_gpt_config.yaml",
                                  {**over, "distributed_strategy.pipeline": {"schedule": "1f1b"}})
    with pytest.raises(ValueError, match="GPTConfig: head not wired for the manual-vjp 1f1b "
                                         r"schedule \(supported families: llama/mistral\)"):
        t_loop.check_supported(forced)
    for extra in ({"distributed_strategy.context_parallel_size": 2,
                   "model.fusions.ring_attention": True}, {"model.lora": {"r": 4}}):
        t_loop.check_supported(t_loader.load_config(CONF / "megatron_gpt_config.yaml", extra))
    with pytest.raises(ValueError, match="unknown activation"):
        t_gpt.check_config(t_gpt.GPTConfig(activation="squared_relu"))


def _dpo_case():
    jc, tc = _cfgs(moe=dict(top_k=2, dropless=True))
    rng = np.random.default_rng(5)
    batch = {f"{side}_{k}": v for side in ("chosen", "rejected")
             for k, v in (("input_ids", rng.integers(0, 96, (2, 16)).astype(np.int32)),
                          ("loss_mask", (rng.random((2, 16)) > 0.3).astype(np.float32)))}
    batch["reference_chosen_logps"] = rng.normal(-60, 3, 2).astype(np.float32)
    batch["reference_rejected_logps"] = rng.normal(-60, 3, 2).astype(np.float32)
    return jc, tc, batch


def _jax_dpo():
    jc, _, batch = _dpo_case()
    j_fn = j_dpo.make_dpo_loss_fn(j_loop._forward_logits_for(jc, _policies()[0]), beta=0.2)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: j_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, None),
        has_aux=True))(_jax_params(jc, 4))
    return (float(jl), {k: float(jm[k]) for k in ("rewards_chosen", "rewards_rejected")},
            {n: t.numpy() for n, t in _named(jg).items()})


def test_dpo_on_gpt_moe_matches_jax():
    """DPO on a GPT-MoE policy (JAX's ``_forward_logits_for``: the router
    loss rides along): loss, rewards and every gradient in fp32."""
    jc, tc, batch = _dpo_case()
    _, tpol = _policies()
    jl, jm, want = _jax_dpo()
    jp = _jax_params(jc, 4)
    cfg = t_loader.load_config(CONF / "megatron_gpt_config.yaml")
    fn, _ = t_loop._preference_objective("dpo", {"kl_beta": 0.2}, dict(cfg["model"]), tc, tpol,
                                         tp=None, dp=None, cp=None, micro_batch_size=2)
    tp = params_from_jax(jp, device="cpu")
    flat = t_llama.named_params(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, tm = fn(tp, {k: torch.tensor(v) for k, v in batch.items()})
    tl.backward()
    _close(float(tl.detach()), jl, 1e-5)
    for k in ("rewards_chosen", "rewards_rejected"):
        _close(float(tm[k]), jm[k], 1e-4, 1e-5)
    for n, t in flat.items():
        _close(t.grad, want[n], GRAD_RTOL, GRAD_ATOL, n)


def test_dpo_pipeline_hooks_on_gpt_match_unpipelined():
    """DPO on a post_ln GPT (no final norm: the head is GPT's own) at pp 2
    through the trainer's pipelined hooks (the concatenated forward, 2
    microbatches of 2 pairs) against the unpipelined loss function, which
    is held to JAX's above: the loss and every gradient in fp32."""
    jc, tc = _cfgs(transformer_block_type="post_ln", num_layers=4)
    _, tpol = _policies()
    rng = np.random.default_rng(8)
    batch = {f"{side}_{k}": torch.tensor(v) for side in ("chosen", "rejected")
             for k, v in (("input_ids", rng.integers(0, 96, (4, 16)).astype(np.int32)),
                          ("loss_mask", (rng.random((4, 16)) > 0.3).astype(np.float32)))}
    batch["reference_chosen_logps"] = torch.tensor(rng.normal(-60, 3, 4).astype(np.float32))
    batch["reference_rejected_logps"] = torch.tensor(rng.normal(-60, 3, 4).astype(np.float32))
    block = dict(t_loader.load_config(CONF / "megatron_gpt_config.yaml")["model"])

    def run(pipelined):
        params = params_from_jax(_jax_params(jc, 6), device="cpu")
        flat = t_llama.named_params(params)
        for t in flat.values():
            t.requires_grad_(True)
        if not pipelined:
            fn, _ = t_loop._preference_objective("dpo", {"kl_beta": 0.2}, block, tc, tpol, tp=None,
                                                 dp=None, cp=None, micro_batch_size=2)
            loss = fn(params, batch)[0]
            return loss.detach(), dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
        hooks = t_loop._pipeline_hooks("dpo", {"kl_beta": 0.2}, block, tc, tpol, shift_labels=True,
                                       tp=None, dp=None, cp=None)
        mbs = [{k: v[m:m + 2] for k, v in batch.items()} for m in (0, 2)]
        return t_pipe.loopback_step(params, hooks, mbs, torch.tensor(4.0), "wavefront", 2,
                                    leaves=flat, act_dtype=torch.float32)

    (pl, pg), (ul, ug) = run(True), run(False)
    _close(float(pl), float(ul), 1e-5)
    for n in ug:
        _close(pg[n], ug[n], 5e-4, 1e-5, n)


# ---------------------------------------------------------------------------
# tools/convert_megatron.py
# ---------------------------------------------------------------------------


def _megatron_state(jc, seed=0) -> dict:
    """A seeded Megatron-named state dict of ``jc``'s shapes (numpy)."""
    return j_cm.native_to_megatron_gpt(_jax_params(jc, seed), jc)


@pytest.mark.parametrize("kw", [dict(), dict(transformer_block_type="normformer",
                                             position_embedding_type="learned_absolute",
                                             num_tokentypes=2),
                                dict(normalization="rmsnorm", bias=False, activation="swiglu",
                                     share_embeddings_and_output_weights=False,
                                     transformer_block_type="post_ln")],
                         ids=["gelu_tied", "normformer_learned", "swiglu_untied_post_ln"])
def test_convert_megatron_round_trip_matches_jax(kw):
    jc, tc = _cfgs(**kw)
    state = _megatron_state(jc)
    tstate = {"model." + k: torch.tensor(v) for k, v in state.items()}
    got = t_llama.named_params(t_cm.megatron_gpt_to_native(tstate, tc, device="cpu"))
    want = _named(j_cm.megatron_gpt_to_native(state, jc))
    assert got.keys() == want.keys()
    for n in got:
        assert torch.equal(got[n], want[n]), n
    back = t_cm.native_to_megatron_gpt(t_cm.megatron_gpt_to_native(tstate, tc, device="cpu"), tc)
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert np.array_equal(back[k].numpy(), v), k


def test_merge_nnm_shards_matches_jax_at_tp2_pp2():
    """tp 2 x pp 2 shards of a glu GPT (each rank's ``dense_h_to_4h`` its
    ``[gate_r; up_r]``) merged by the port and by JAX: the same dict."""
    jc, _ = _cfgs(activation="swiglu", num_layers=4)
    full = _megatron_state(jc)
    shards = {}
    for t, p in itertools.product(range(2), range(2)):
        shard = {}
        for k, v in full.items():
            m = j_cm._LAYER_RE.search(k)
            if m and not 2 * p <= int(m.group(2)) < 2 * p + 2:
                continue
            key = j_cm._offset_layer(k, -2 * p) if m else k
            ax = j_cm._tp_axis_for(k)
            if ax is not None:
                if "dense_h_to_4h" in k:
                    halves = v.reshape((2, 2, v.shape[0] // 4) + v.shape[1:])[:, t]
                    v = halves.reshape((-1,) + v.shape[1:])
                else:
                    v = np.split(v, 2, axis=ax)[t]
            shard["model." + key] = v
        shards[(t, p)] = shard
    want = j_cm.merge_nnm_shards(shards, tp=2, pp=2, num_layers=4, glu=True)
    got = t_cm.merge_nnm_shards({k: {n: torch.tensor(v) for n, v in s.items()}
                                 for k, s in shards.items()}, tp=2, pp=2, num_layers=4, glu=True)
    assert got.keys() == want.keys() == full.keys()
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k
        assert np.array_equal(want[k], full[k]), k


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_masks_are_keyed_and_layout_free():
    """A mask is a function of the key path, the row and the position: the
    same key draws the same mask, another step or fold another; a rank's SP
    slice is its positions of the whole-sequence mask, and a data rank's
    rows (``Key.rows``) draw those rows' masks; rate 0 and no key draw
    nothing (the tensor itself comes back)."""
    x = torch.ones(4, 16, 8)
    key = prng.step_key(3).fold(prng.LAYER_TAG, 1).fold(2)
    whole = prng.dropout(x, 0.25, key)
    assert torch.equal(whole, prng.dropout(x, 0.25, key))
    assert 0.6 < float((whole > 0).float().mean()) < 0.9
    assert torch.all((whole == 0) | (whole == 1 / 0.75))
    for other in (prng.step_key(4).fold(prng.LAYER_TAG, 1).fold(2), key.fold(0),
                  prng.step_key(3).fold(prng.LAYER_TAG, 0).fold(2)):
        assert not torch.equal(whole, prng.dropout(x, 0.25, other))
    for r in range(2):  # sequence parallelism: each rank's slice
        held = slice(r * 8, (r + 1) * 8)
        part = prng.dropout(x[:, held], 0.25, key, seq_len=16, positions=held)
        assert torch.equal(part, whole[:, held])
    for dp_rank in range(2):  # data parallelism: the rank's rows
        rows = range(2 * dp_rank, 2 * dp_rank + 2)
        assert torch.equal(prng.dropout(x[:2], 0.25, key.with_rows(rows)), whole[2 * dp_rank:][:2])
    assert prng.dropout(x, 0.0, key) is x and prng.dropout(x, 0.25, None) is x


def test_gpt_dropout_over_rows_and_recompute():
    """The model at dropout 0.1: the forward of 4 rows equals two forwards
    of 2 rows keyed with their rows (a data rank's); without a key the
    forward is the dropout-0 one; a full-remat layer's recompute redraws its
    masks (its gradients equal the unchecked run's bit for bit); at pp 2 the
    wavefront (which recomputes each stage in its backward) and ``1f1b``
    give the same loss and gradients bit for bit."""
    _, tc = _cfgs(hidden_dropout=0.1, embedding_dropout=0.1)
    _, t0 = _cfgs()
    _, tpol = _policies()
    jp = _jax_params(_cfgs()[0], 2)
    params = params_from_jax(jp, device="cpu")
    b = _batch(b=4)
    ids = torch.tensor(b["input_ids"])
    key = prng.step_key(5)
    whole, _ = t_gpt.forward(params, {"input_ids": ids}, tc, tpol, rng=key)
    halves = [t_gpt.forward(params, {"input_ids": ids[r:r + 2]}, tc, tpol,
                            rng=key.with_rows(range(r, r + 2)))[0] for r in (0, 2)]
    _close(torch.cat(halves), whole, 1e-6, 1e-6)
    plain = t_gpt.forward(params, {"input_ids": ids}, t0, tpol)[0]
    assert torch.equal(t_gpt.forward(params, {"input_ids": ids}, tc, tpol)[0], plain)
    assert not torch.allclose(whole, plain, atol=1e-3)

    def grads(cfg, schedule=None):
        ps = params_from_jax(jp, device="cpu")
        flat = t_llama.named_params(ps)
        for t in flat.values():
            t.requires_grad_(True)
        batch = {"input_ids": ids, "labels": ids}
        if schedule is None:
            loss = t_gpt.forward(ps, batch, cfg, tpol, rng=key)[0]
            got = torch.autograd.grad(loss, list(flat.values()))
            return loss.detach(), dict(zip(flat, got))
        mbs = [{"input_ids": ids[m:m + 2], "labels": ids[m:m + 2],
                "_rng": key.fold(m // 2).with_rows(range(2))} for m in (0, 2)]
        denom = t_pipe.ce_denominator(batch, shift_labels=True)
        return t_pipe.loopback_step(ps, t_gpt.pipeline_hooks(cfg, tpol), mbs, denom, schedule,
                                    2, leaves=flat, act_dtype=torch.float32)

    plain_l, plain_g = grads(tc)
    remat_l, remat_g = grads(dataclasses.replace(tc, activations_checkpoint_granularity="full"))
    assert torch.equal(plain_l, remat_l)
    assert all(torch.equal(plain_g[n], remat_g[n]) for n in plain_g)
    wl, wg = grads(tc, "wavefront")
    fl, fg = grads(tc, "1f1b")
    assert torch.equal(wl, fl) and wg.keys() == fg.keys()
    assert all(torch.equal(wg[n], fg[n]) for n in wg)


def _gpt_cfg(tmp, exp, *, tp=1, pp=1, vocab=96, every=0, precision="fp32", data=None,
             **model):
    cfg = DPT.dp_cfg(tmp, exp, every=every, precision=precision)
    cfg["model_source"] = "megatron"
    cfg["distributed_strategy"].update(tensor_model_parallel_size=tp,
                                       pipeline_model_parallel_size=pp,
                                       sequence_parallel=tp > 1)
    cfg["model"] = {"architecture": "gpt", "vocab_size": vocab, "hidden_size": 64,
                    "ffn_hidden_size": 128, "num_layers": 2, "num_attention_heads": 4,
                    "num_query_groups": 2, "max_position_embeddings": 32,
                    "optim": cfg["model"]["optim"], **model}
    if data:
        cfg["data"] = {**cfg["data"], **data}
    return cfg


def test_dropout_resume_is_bit_for_bit(tmp_path):
    """(c) A GPT with dropout 0.1 saved at step 2 and resumed: its step 3
    (loss, grad norm) and final params equal the straight run's bit for bit,
    the masks redrawn from the step key; the dropout-0 run's losses differ."""
    def run(exp, max_steps=None, dropout=0.1):
        cfg = t_loader.load_config(_gpt_cfg(tmp_path, exp, every=2, hidden_dropout=dropout))
        t = t_loop.Trainer.from_config(cfg, device="cpu")
        if max_steps:
            t.max_steps = max_steps
        return t, t.fit()

    straight, hs = run("straight")
    run("ck", max_steps=2)
    resumed, hr = run("ck")
    assert [h["step"] for h in hr] == [2]
    assert hr[0]["loss"] == hs[2]["loss"] and hr[0]["grad_norm"] == hs[2]["grad_norm"]
    a, b = t_llama.named_params(straight.params), t_llama.named_params(resumed.params)
    assert all(torch.equal(a[n], b[n]) for n in a)
    _, h0 = run("plain", dropout=0.0)
    assert all(x["loss"] != y["loss"] for x, y in zip(h0[1:], hs[1:]))


# ---------------------------------------------------------------------------
# the trainer: the 4-rank gloo launch and one rank, against the JAX trainer
# ---------------------------------------------------------------------------

#: the launch's cases: (tp, pp, dp, vocab, model knobs, data knobs)
LAUNCH = {
    "tp2_dp2": (2, 1, 97, dict(activation="gelu", normalization="layernorm", bias=True,
                               share_embeddings_and_output_weights=True), {}),
    "pp2_tp2": (2, 2, 128, dict(activation="swiglu", normalization="rmsnorm", has_bias=False,
                                share_embeddings_and_output_weights=False), {}),
    "drop_tp2": (2, 1, 97, dict(hidden_dropout=0.1), {}),
    "drop_tp1": (1, 1, 97, dict(hidden_dropout=0.1), {"micro_batch_size": 1}),
}


def _launch(tmp: Path) -> dict:
    """The JAX trainers are built first (the port's scenarios start from
    their initial weights), then the 4-rank launch runs in a thread while
    they fit, and the port at one rank trains from the tp 2 x dp 2 case's
    weights.  tp 2 x dp 2's reference is the JAX trainer on one device at
    micro batch 4 (the same microbatches as 2 data ranks of 2); the dropout
    pair both start from the tp 2 x dp 2 case's weights."""
    jts, scenarios = {}, []
    one = {"micro_batch_size": 4}
    for name in ("tp2_dp2", "pp2_tp2"):
        tp, pp, vocab, model, _ = LAUNCH[name]
        jcfg = _gpt_cfg(tmp, f"jax_{name}", tp=1 if name == "tp2_dp2" else tp, pp=pp,
                        vocab=vocab, data=one if name == "tp2_dp2" else None, **model)
        jts[name], j0 = PPT._jax_start(jcfg, 1 if name == "tp2_dp2" else 4)
        scenarios.append({"name": name, "steps": 3, "dump": str(tmp / f"{name}.pt"),
                          "cfg": _gpt_cfg(tmp, f"port_{name}", tp=tp, pp=pp, vocab=vocab,
                                          **model),
                          "weights": str(TPT._global_weights(j0, tmp / f"{name}_w.pt"))})
    for name in ("drop_tp2", "drop_tp1"):
        tp, pp, vocab, model, data = LAUNCH[name]
        scenarios.append({"name": name, "steps": 3, "dump": str(tmp / f"{name}.pt"),
                          "grads": str(tmp / f"{name}_g.pt"),
                          "cfg": _gpt_cfg(tmp, f"port_{name}", tp=tp, pp=pp, vocab=vocab,
                                          data=data, **model),
                          "weights": scenarios[0]["weights"]})
    tp, pp, vocab, model, _ = LAUNCH["tp2_dp2"]
    scenarios += [  # a tp 2 x dp 2 save at step 2, restored at dp 4 x tp 1
        {"name": "pre", "cfg": _gpt_cfg(tmp, "ck", tp=2, vocab=vocab, every=2, **model),
         "steps": 3, "max_steps": 2, "weights": scenarios[0]["weights"],
         "dump": str(tmp / "pre.pt")},
        {"name": "at_tp1", "cfg": _gpt_cfg(tmp, "ck", tp=1, vocab=vocab, every=2, **model),
         "steps": 3, "max_steps": 2, "dump": str(tmp / "at_tp1.pt")}]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(DPT.launch, tmp, scenarios, 4, LAUNCH_TIMEOUT)
        fitted = {name: PPT._jax_finish(jt)[1] for name, jt in jts.items()}
        single = TPT._single(_gpt_cfg(tmp, "port_one", vocab=97, data=one,
                                      **LAUNCH["tp2_dp2"][3]),
                             torch.load(scenarios[0]["weights"])).fit()
        ranks = ranks.result()
    dumps = {k: torch.load(tmp / f"{k}.pt") for k in list(LAUNCH) + ["pre", "at_tp1"]}
    grads = {k: torch.load(tmp / f"{k}_g.pt") for k in ("drop_tp2", "drop_tp1")}
    return {"jax": fitted, "one": single, "ranks": ranks, "dumps": dumps, "grads": grads}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return PPT._shared(tmp_path_factory, "gpt_runs", _launch)


def _same_history(got: list, want: list, rtol: float = 1e-5):
    assert [r["step"] for r in got] == [0, 1, 2]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            assert np.isclose(g[k], w[k], rtol=rtol, atol=0), (k, g[k], w[k])


def test_trainer_matches_jax_at_one_rank(runs):
    _same_history(runs["one"], runs["jax"]["tp2_dp2"])


@pytest.mark.parametrize("name", ["tp2_dp2", "pp2_tp2"])
def test_gloo_trainer_matches_jax(runs, name):
    """tp 2 x dp 2 (SP, tied, padded vocab 97) and pp 2 x tp 2 (SP, swiglu,
    untied) on 4 gloo ranks against the JAX trainer, every rank logging the
    same numbers."""
    ranks = [r[name] for r in runs["ranks"]]
    _same_history(ranks[0]["history"], runs["jax"][name])
    for r in ranks[1:]:
        assert [h["loss"] for h in r["history"]] == [h["loss"] for h in ranks[0]["history"]]


def test_dropout_tp2_equals_tp1(runs):
    """(b) At dropout 0.1, dp 2 x tp 2 (SP: each rank a slice of each mask)
    and dp 4 x tp 1 (each rank its own rows) train the same model: losses,
    grad norms and the first step's gradients agree to fp32 rounding, and
    the final params to what AdamW makes of it; the dropout-0 run differs."""
    a = [r["drop_tp2"]["history"] for r in runs["ranks"]][0]
    b = [r["drop_tp1"]["history"] for r in runs["ranks"]][0]
    _same_history(a, b)
    assert all(not np.isclose(x["loss"], y["loss"], rtol=1e-4)
               for x, y in zip(a[1:], [r["tp2_dp2"]["history"] for r in runs["ranks"]][0][1:]))
    ga, gb = runs["grads"]["drop_tp2"], runs["grads"]["drop_tp1"]
    assert ga.keys() == gb.keys()
    for n in ga:
        _close(ga[n], gb[n], 1e-4, 1e-6, n)
    # after 3 AdamW steps, whose m / sqrt(v) turns a gradient's last-bit
    # difference into up to ~lr where the gradient is near zero
    da, db = runs["dumps"]["drop_tp2"], runs["dumps"]["drop_tp1"]
    for n in da:
        if n.startswith("params/"):
            _close(da[n], db[n], 1e-3, 1e-5, n)


def test_megatron_configs_train_on_the_cpu(tmp_path, caplog):
    """``megatron_gpt``, ``megatron_mixtral_8x7b`` and
    ``megatron_llama2_7B_SFT`` through the trainer at a tiny width and one
    rank (the SFT config's tokenizer path is not in the repo: the char
    tokenizer and a seeded jsonl stand in, as ``chip_smoke.py`` does):
    finite losses near ln V, ``router_aux_loss`` beside the loss for the MoE
    config."""
    tiny = {"distributed_strategy.tensor_model_parallel_size": 1,
            "distributed_strategy.sequence_parallel": False,
            "model.num_layers": 2, "model.hidden_size": 64, "model.ffn_hidden_size": 96,
            "model.num_attention_heads": 4, "model.num_query_groups": 2,
            "model.vocab_size": 97, "data.seq_length": 32, "data.global_batch_size": 4,
            "data.micro_batch_size": 2, "data.synthetic": True, "trainer.max_steps": 2,
            "exp_manager.exp_dir": str(tmp_path),
            "exp_manager.create_tensorboard_logger": False,
            "exp_manager.checkpoint_callback_params.every_n_train_steps": 0}
    sft = {"data.synthetic": False, "data.train_dir": str(TPT._sft_jsonl(tmp_path / "sft.jsonl")),
           "data.tokenizer.library": "char", "model.vocab_size": 256}
    for config, extra in (("megatron_gpt_config.yaml", {}),
                          ("megatron_mixtral_8x7b_config.yaml", {}),
                          ("megatron_llama2_7B_SFT_config.yaml", sft)):
        cfg = t_loader.load_config(CONF / config, {**tiny, **extra})
        vocab = cfg["model"]["vocab_size"]
        hist = t_loop.Trainer.from_config(cfg, device="cpu", enable_checkpointing=False).fit()
        assert all(np.isfinite(h["loss"]) and abs(h["loss"] - np.log(vocab)) < 1.5
                   for h in hist), (config, hist)
        assert ("router_aux_loss" in hist[0]) == ("mixtral" in config)


def test_tp2_save_restores_at_tp1_bit_for_bit(runs):
    """A GPT checkpoint (padded vocab 97, fused qkv with biases, the
    layernorm biases) saved at tp 2 x dp 2 and restored at dp 4 x tp 1:
    every param and moment as saved, bit for bit (the saved leaves are
    JAX's global ones, ``[V, h]`` at any tp)."""
    d = runs["dumps"]
    assert d["pre"].keys() == d["at_tp1"].keys()
    assert "params/layers.0.attn.qkv.bias" in d["pre"]
    assert tuple(d["pre"]["params/embed.embedding"].shape) == (97, 64)
    for k, v in d["pre"].items():
        assert torch.equal(v, d["at_tp1"][k]), k
