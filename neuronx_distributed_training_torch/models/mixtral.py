"""Mixtral-family decoder (counterpart of the JAX package's
``models/mixtral.py``): the Llama decoder with the MLP of every
``moe_frequency``-th layer replaced by a routed mixture of SwiGLU experts
(``ops/moe.py``), and the router losses added to the LM loss.

The parameter tree is Llama's (``models/llama.py``) with a MoE layer's
``mlp`` = ``{"router": {"w": [h, E]}, "experts": {"gate_up": [E, h, 2 ffn],
"down": [E, ffn, h]}}``.  Where the JAX package stacks ``moe_frequency > 1``
as ``{"moe": [G, ...], "dense": [G, f-1, ...]}`` groups, the port keeps its
list of layers, layer ``i`` MoE iff ``i % f == 0`` (``tools/convert.py``
bridges the two).  The attention, norms, RoPE, remat (``full`` checkpoints
each layer; ``selective`` recomputes core attention alone) and the head with
its cross-entropy (the chunked head under ``fusions.chunked_ce``) are
``models/llama.py``'s.

A MoE layer runs on the gathered sequence under sequence parallelism (the
column region of ``parallel/tensor_parallel.py``, as the dense MLP): each tp
rank routes the same tokens, computes its slice of each expert's ffn, and the
row region sums the partial outputs.  The router's gradient is then a
partial sum over tp (``parallel/sharding.py``), and the router loss's
gradient is scaled by ``1 / tp`` on each rank, so their sum is the loss's.
Under expert parallelism (``ep``, a ``parallel/mesh.py::ExpertParallel``)
the layer gathers every expert's weights over the expert axis
(``ops/moe.py::gather_experts``: JAX's weight-gather EP), runs the rank's own
tokens, and the gather's backward reduce-scatters the expert gradients.

The router loss (``router_aux_loss``) is the mean over the MoE layers of
each layer's ``weighted_router_loss`` over the whole microbatch (its
statistics summed over ``ep``'s token groups): the loss returned is the LM
loss plus this rank's share of it (``ops/moe.py::router_loss_share``), and
``aux`` holds the global ``router_aux_loss`` and ``lm_loss``, detached, the
JAX trainer's metrics.  Without labels ``aux`` also holds
``router_aux_share``, the share with its gradient, which the preference
losses add (JAX's ``reg``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from neuronx_distributed_training_torch.models import llama
from neuronx_distributed_training_torch.ops import linear as linear_ops
from neuronx_distributed_training_torch.ops import moe as moe_ops
from neuronx_distributed_training_torch.ops import norm as norm_ops
from neuronx_distributed_training_torch.parallel import tensor_parallel as tp_ops
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    """Llama knobs + the MoE block (JAX's ``MixtralConfig``)."""

    llama: llama.LlamaConfig = dataclasses.field(default_factory=llama.LlamaConfig)
    moe: moe_ops.MoEConfig = dataclasses.field(default_factory=moe_ops.MoEConfig)
    moe_frequency: int = 1  # every f-th layer is MoE; 1 = all (Mixtral)

    @property
    def vocab_size(self) -> int:
        return self.llama.vocab_size

    @property
    def hidden_size(self) -> int:
        return self.llama.hidden_size

    @property
    def intermediate_size(self) -> int:
        return self.llama.intermediate_size

    @property
    def num_layers(self) -> int:
        return self.llama.num_layers

    @property
    def num_attention_heads(self) -> int:
        return self.llama.num_attention_heads

    @property
    def num_kv_heads(self):
        return self.llama.num_kv_heads

    # the sizes parallel/sharding.py reads
    @property
    def kv_heads(self) -> int:
        return self.llama.kv_heads

    @property
    def head_size(self) -> int:
        return self.llama.head_size

    @classmethod
    def from_config(cls, model_cfg: dict[str, Any],
                    ds_cfg: Optional[dict[str, Any]] = None) -> "MixtralConfig":
        m = dict(model_cfg or {})
        base = llama.LlamaConfig.from_config(m, ds_cfg)
        if m.get("sliding_window") is None and m.get("use_sliding_window", False):
            base = dataclasses.replace(base, sliding_window=4096)
        return cls(llama=base, moe=moe_ops.MoEConfig.from_config(m.get("moe", {})),
                   moe_frequency=int((m.get("moe", {}) or {}).get("frequency", 1) or 1))


def num_moe_layers(cfg: MixtralConfig) -> int:
    """Layer ``i`` is MoE iff ``i % moe_frequency == 0``."""
    f = cfg.moe_frequency
    if cfg.llama.num_layers % f != 0:
        raise ValueError(f"num_layers {cfg.llama.num_layers} must divide by moe frequency {f}")
    return cfg.llama.num_layers // f


def init_params(cfg: MixtralConfig, policy: Optional[DtypePolicy] = None, *,
                generator: torch.Generator, device=None, tp_rank: int = 0, tp_size: int = 1,
                ep_rank: int = 0, ep_size: int = 1, pp_rank: int = 0, pp_size: int = 1,
                vp: int = 1):
    """``models/llama.py::init_params``'s tree with a MoE block in every
    ``moe_frequency``-th layer's ``mlp``, drawn in that layer's turn (the
    router in fp32, the experts in the param dtype); a rank keeps its
    ``E / ep_size`` experts and its tp slices of each whole draw."""
    policy = policy or DtypePolicy()
    lc = cfg.llama
    num_moe_layers(cfg)

    def mlp_of(i):
        if i % cfg.moe_frequency:
            return None
        return lambda cut: moe_ops.init_moe_params(
            generator, lc.hidden_size, lc.intermediate_size, cfg.moe,
            dtype=policy.param_dtype, stddev=lc.initializer_range, device=device, cut=cut)

    return llama.init_params(lc, policy, generator=generator, device=device, tp_rank=tp_rank,
                             tp_size=tp_size, pp_rank=pp_rank, pp_size=pp_size, vp=vp,
                             ep_rank=ep_rank, ep_size=ep_size, mlp_of=mlp_of)


def moe_mlp(mlp: dict, h: torch.Tensor, moe: moe_ops.MoEConfig, policy: DtypePolicy, tp, ep):
    """The MoE block of a layer (its params cast already) ->
    ``(y, loss share, loss value)`` (GPT's MoE layers run it too)."""
    h = tp_ops.enter_column(h, tp)
    params = {"router": mlp["router"], "experts": moe_ops.gather_experts(mlp["experts"], ep)}
    y, aux = moe_ops.moe_block(params, h, moe, compute_dtype=policy.compute_dtype, tokens=ep)
    size = tp.size if tp_ops.active(tp) else 1
    share, value = moe_ops.router_loss_share(
        aux["router_logits"], aux["expert_idx"], moe,
        reduce=None if ep is None else ep.sum_stats_, grad_scale=1.0 / size)
    return tp_ops.leave_row(y, tp), share, value


def _moe_layer(lp, x, cos, sin, cfg: MixtralConfig, policy: DtypePolicy, attention_mask=None,
               segment_ids=None, tp=None, cp=None, ep=None, attend=None):
    """Pre-norm attention + MoE block -> ``(x, loss share, loss value)``
    (``attend`` as in ``models/llama.py::_attention_block``)."""
    lc = cfg.llama
    lp = policy.cast_to_compute(lp)  # one layer's compute-dtype copy at a time
    h = norm_ops.apply_rms_norm(lp["input_norm"], x, eps=lc.rms_norm_eps)
    x = x + llama._attention_block(lp["attn"], h, cos, sin, lc, policy,
                                   attention_mask=attention_mask, segment_ids=segment_ids,
                                   tp=tp, cp=cp, attend=attend)
    h = norm_ops.apply_rms_norm(lp["post_attn_norm"], x, eps=lc.rms_norm_eps)
    y, share, value = moe_mlp(lp["mlp"], h, cfg.moe, policy, tp, ep)
    return x + y, share, value


def _run_layers(layers, x, cos, sin, cfg: MixtralConfig, policy: DtypePolicy,
                attention_mask=None, segment_ids=None, tp=None, cp=None, ep=None) -> tuple:
    """``(x, share, value)``: the layers in order (a dense one is Llama's),
    and the sums of the MoE layers' router-loss shares and values."""
    full = cfg.llama.activations_checkpoint_granularity == "full"
    share = value = None
    for lp in layers:
        if not moe_ops.is_moe_mlp(lp["mlp"]):
            x = llama._run_layers([lp], x, cos, sin, cfg.llama, policy, attention_mask,
                                  segment_ids, tp, cp)
            continue
        args = (lp, x, cos, sin, cfg, policy, attention_mask, segment_ids, tp, cp, ep)
        x, s, v = (checkpoint(_moe_layer, *args, use_reentrant=False) if full
                   else _moe_layer(*args))
        share = s if share is None else share + s
        value = v if value is None else value + v
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, zero if share is None else share, zero if value is None else value


def forward(params, batch: dict[str, torch.Tensor], cfg: MixtralConfig, policy: DtypePolicy,
            *, positions=None, shift_labels: bool = True, return_logits: bool = False,
            loss_denominator: Optional[torch.Tensor] = None, tp=None, cp=None, ep=None):
    """Causal-LM forward -> ``(loss, aux)``: ``models/llama.py::forward``'s
    loss (its ``loss_denominator``, ``tp`` and ``cp`` rules) plus the
    router loss, the mean over the MoE layers of their
    ``weighted_router_loss`` (this rank's share of it under ``ep``).
    ``aux``: ``router_aux_loss`` and ``lm_loss`` over the whole microbatch,
    detached; without labels ``(logits, aux)`` with ``router_aux_share``."""
    lc = cfg.llama
    ids, am, seg = batch["input_ids"], batch.get("attention_mask"), batch.get("segment_ids")
    if cp is not None:
        positions = batch["positions"]
    if positions is None:
        positions = llama.positions_for(ids, am, seg)
    x = linear_ops.apply_embedding(params["embed"], ids, compute_dtype=policy.compute_dtype,
                                   tp=tp)
    cos, sin = llama._rope(lc, positions)
    x, share, value = _run_layers(params["layers"], x, cos, sin, cfg, policy, am, seg, tp, cp,
                                  ep)
    hidden = norm_ops.apply_rms_norm(params["final_norm"], x, eps=lc.rms_norm_eps)
    n = num_moe_layers(cfg)
    out, aux = llama.head_loss(params, hidden, batch, lc, policy, shift_labels=shift_labels,
                               return_logits=return_logits, loss_denominator=loss_denominator,
                               tp=tp, cp=cp)
    aux = dict(aux, router_aux_loss=value / n)
    if batch.get("labels") is None:
        aux["router_aux_share"] = share / n
        return out, aux
    lm = out.detach().float()
    aux["lm_loss"] = lm if ep is None else ep.sum_stats_(lm.clone())
    return out + share / n, aux


def pipeline_hooks(cfg: MixtralConfig, policy: DtypePolicy, *, shift_labels: bool = True,
                   tp=None, cp=None, ep=None):
    """``models/llama.py::pipeline_hooks`` with a stage that returns ``(x,
    aux)``: ``aux`` the sum of its MoE layers' router-loss shares, which
    ``parallel/pipeline.py`` sums over the stages and the microbatches and
    scales by ``1 / (num_microbatches * num_moe_layers)`` (JAX's
    ``stage_aux``).  The embedding, the head and the loss are Llama's."""
    embed_fn, _, loss_fn, act_shape = llama.pipeline_hooks(
        cfg.llama, policy, shift_labels=shift_labels, tp=tp, cp=cp)

    def stage_fn(layers, x, mb):
        cos, sin = llama.stage_rope(cfg.llama, mb)
        x, share, _ = _run_layers(layers, x, cos, sin, cfg, policy, mb.get("attention_mask"),
                                  mb.get("segment_ids"), tp, cp, ep)
        return x, share

    return embed_fn, stage_fn, loss_fn, act_shape
