"""Llama-family decoder (counterpart of the JAX package's ``models/llama.py``).

Plain functions over a parameter tree of tensors:

    {"embed": {"embedding": [V, H]},
     "layers": [{"input_norm": {"scale"}, "post_attn_norm": {"scale"},
                 "attn": {"qkv": {"w"}, "o": {"w"}}   (or "q"/"k"/"v" unfused),
                 "mlp": {"gate_up": {"w"}, "down": {"w"}}}, ...],
     "final_norm": {"scale": [H]},
     "lm_head": {"w": [H, V]}}          (absent with tied embeddings)

Linear weights are ``[in, out]`` as in the JAX package.  Where JAX stacks the
layers on a leading dim and scans, the port keeps one dict per layer and loops
(``tools/convert.py`` bridges the two).  ``named_params`` flattens the tree to
dotted names (``layers.0.attn.qkv.w``) for the optimizer.  LoRA
(``peft/lora.py``) adds ``lora_a``, ``lora_b`` and ``lora_scale`` beside a
target linear's ``w`` (``layers.0.attn.qkv.lora_a``); the forward carries them
through the layer's compute-dtype cast to ``ops/linear.py``.

Remat (``activations_checkpoint_granularity``): ``full`` checkpoints each
layer; ``selective`` recomputes only ``core_attention`` (its scores and
probs); on the flash path ``selective`` recomputes nothing, since the flash
autograd Function saves only q, k, v, o and lse.

Tensor parallelism (``tp``, a ``parallel/mesh.py::TensorParallel``): each
rank holds its slices of the leaves (``parallel/sharding.py``) and so
``nh/tp`` q heads and ``nkv/tp`` kv heads, or, at tp above the kv heads,
one kv head that ``tp/nkv`` ranks share (rank ``r`` holds head ``r //
(tp/nkv)``); q head ``i`` uses kv head ``i // (nh/nkv)`` locally as
globally, since tp and nkv divide one another.  A vocab tp does not divide
is padded to ``ceil(V/tp)`` rows a rank, whose logits' padded columns are
``-inf``.  The activations
cross the ranks through Megatron's regions (``parallel/tensor_parallel.py``):
the vocab-parallel embedding, then per layer the column input (all-gather
along the sequence under SP, else the copy region) before ``qkv`` and before
``gate_up``, and the row output (reduce-scatter along the sequence under SP,
else all-reduce) after ``o`` and after ``down``.  Under SP the residual
stream and the norms hold the rank's ``s/tp`` slice of the sequence; RoPE,
positions, the attention mask and segment ids stay whole, since attention
sees the gathered sequence.  The final norm's output is gathered before the
column-parallel ``lm_head``, whose ``[b, s, V/tp]`` logits go to the
vocab-parallel cross-entropy ungathered; with ``fusions.chunked_ce``
(``vocab_chunks``) the head and the cross-entropy are one function over
vocab blocks (``ops/cross_entropy.py::chunked_cross_entropy_from_hidden``),
the logits never held whole, as in the JAX package's ``forward``.  ``tp`` None (or of size 1) is the
one-device path, with no collective.

Context parallelism (``cp``, a ``parallel/mesh.py::ContextParallel``): the
model runs on the rank's ``s/cp`` slice of each row, cut by
``data/loader.py::context_parallel_batch`` (contiguous, or in the zig-zag
layout), which also carries the rank's RoPE positions (taken on the whole
row) and next-token targets (shifted on the whole row).  Under SP that slice
splits again over ``model``, as JAX's ``seq_axes`` puts ``context`` before
``model``.  Attention is the only layer that crosses the context ranks
(``ops/attention.py``: the ring, the zig-zag ring or Ulysses).

Pipeline parallelism: at ``pp_size > 1`` a rank's tree holds the layers
of its ``vp`` chunks and None for the other ranks' (:func:`init_params`),
so ``named_params`` names every leaf by its global layer index;
:func:`pipeline_hooks` gives the embedding, a chunk's slice of layers and
the head + CE (the chunked head under ``fusions.chunked_ce``) that
``parallel/pipeline.py`` runs stage by stage, under cp on the context
rank's slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from neuronx_distributed_training_torch.ops import attention as attn_ops
from neuronx_distributed_training_torch.ops import cross_entropy as ce_ops
from neuronx_distributed_training_torch.ops import linear as linear_ops
from neuronx_distributed_training_torch.ops import norm as norm_ops
from neuronx_distributed_training_torch.ops import rope as rope_ops
from neuronx_distributed_training_torch.parallel import sharding
from neuronx_distributed_training_torch.parallel import tensor_parallel as tp_ops
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_attention_heads: int = 32
    num_kv_heads: Optional[int] = None  # None -> MHA
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rope_interpolation_factor: Optional[float] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    sliding_window: Optional[int] = None
    fuse_qkv: bool = True
    attention_impl: str = "core"  # "core" | "flash" | "ring" | "ulysses" | "zigzag_ring"
    context_parallel: bool = False  # distributed_strategy.context_parallel_size > 1
    activations_checkpoint_granularity: Optional[str] = "selective"
    vocab_chunks: Optional[int] = None  # fusions.chunked_ce: the fused head + CE

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_attention_heads

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @classmethod
    def from_config(cls, model_cfg: dict[str, Any],
                    ds_cfg: Optional[dict[str, Any]] = None) -> "LlamaConfig":
        """Build from the ``model:`` and ``distributed_strategy:`` blocks.
        ``attention_impl`` follows the fusions in JAX's order: Ulysses, then
        the zig-zag ring, then the ring, then flash."""
        m = dict(model_cfg or {})
        ds = dict(ds_cfg or {})
        fusions = dict(m.get("fusions", {}) or {})
        if fusions.get("ulysses_attention"):
            impl = "ulysses"
        elif fusions.get("zigzag_ring_attention"):
            impl = "zigzag_ring"
        elif fusions.get("ring_attention"):
            impl = "ring"
        elif fusions.get("flash_attention"):
            impl = "flash"
        else:
            impl = "core"
        return cls(
            vocab_size=int(m.get("vocab_size", 32000)),
            hidden_size=int(m.get("hidden_size", 4096)),
            intermediate_size=int(m.get("intermediate_size", m.get("ffn_hidden_size", 11008))),
            num_layers=int(m.get("num_layers", m.get("num_hidden_layers", 32))),
            num_attention_heads=int(m.get("num_attention_heads", 32)),
            num_kv_heads=(int(m["num_key_value_heads"])
                          if m.get("num_key_value_heads") is not None else None),
            rope_theta=float(m.get("rope_theta", 10000.0)),
            rope_interpolation_factor=m.get("position_interpolation_factor"),
            rms_norm_eps=float(m.get("rms_norm_eps", 1e-5)),
            tie_word_embeddings=bool(m.get("tie_word_embeddings", False)),
            sliding_window=m.get("sliding_window"),
            fuse_qkv=bool(m.get("fuse_qkv", True)),
            attention_impl=impl,
            context_parallel=int(ds.get("context_parallel_size", 1) or 1) > 1,
            activations_checkpoint_granularity=m.get(
                "activations_checkpoint_granularity", "selective"),
            vocab_chunks=(int(fusions["chunked_ce"]) if fusions.get("chunked_ce") else None),
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(gen, cfg: LlamaConfig, dtype, device, cut, mlp=None):
    h, d = cfg.hidden_size, cfg.head_size
    nh, nkv = cfg.num_attention_heads, cfg.kv_heads
    std = cfg.initializer_range

    def lin(module, i, o):
        w = linear_ops.init_linear(gen, i, o, dtype=dtype, stddev=std, device=device)["w"]
        return {"w": cut(module + ".w", w)}

    if cfg.fuse_qkv:
        attn = {"qkv": lin("attn.qkv", h, (nh + 2 * nkv) * d)}
    else:
        attn = {"q": lin("attn.q", h, nh * d), "k": lin("attn.k", h, nkv * d),
                "v": lin("attn.v", h, nkv * d)}
    attn["o"] = lin("attn.o", nh * d, h)
    return {
        "input_norm": norm_ops.init_rms_norm(h, dtype=dtype, device=device),
        "post_attn_norm": norm_ops.init_rms_norm(h, dtype=dtype, device=device),
        "attn": attn,
        "mlp": ({"gate_up": lin("mlp.gate_up", h, 2 * cfg.intermediate_size),
                 "down": lin("mlp.down", cfg.intermediate_size, h)} if mlp is None
                else mlp(lambda n, t: cut("mlp." + n, t))),
    }


def init_params(cfg: LlamaConfig, policy: DtypePolicy | None = None, *,
                generator: torch.Generator, device=None, tp_rank: int = 0, tp_size: int = 1,
                pp_rank: int = 0, pp_size: int = 1, vp: int = 1, ep_rank: int = 0,
                ep_size: int = 1, mlp_of=None):
    """The parameter tree in the policy's param dtype, drawn from
    ``generator`` (which must live on ``device``).  At ``tp_size > 1`` every
    leaf is still drawn whole, in the same order, and the rank keeps its
    slice (``parallel/sharding.py::shard_leaf``): a tp run starts from the
    slices of the one-rank run's tensors, bit for bit, holding one whole
    leaf more than its share at a time.  At ``pp_size > 1`` the same holds
    of the layers: every layer is drawn, pipeline rank ``pp_rank`` keeps
    its own, those of its ``vp`` chunks (``parallel/pipeline.py::
    stage_layers``), and ``layers`` holds None for the other ranks' (the
    embedding, the final norm and the head are kept on every rank).
    ``mlp_of(i)``, if given and not None for layer ``i``, draws that
    layer's ``mlp`` in place of the dense one (``mlp(cut) -> dict``, the
    MoE block of ``models/mixtral.py``), whose expert leaves a rank of
    ``ep_size`` keeps ``E / ep_size`` of."""
    policy = policy or DtypePolicy()
    dtype = policy.param_dtype
    mine = set(range(cfg.num_layers))
    if pp_size > 1:
        from neuronx_distributed_training_torch.parallel.pipeline import stage_layers

        mine = set(stage_layers(cfg.num_layers, pp_rank, pp_size, vp))

    def cut(name: str, t: torch.Tensor) -> torch.Tensor:
        return sharding.local_leaf(t, sharding.leaf_layout(name, cfg), tp_rank, tp_size,
                                   ep_rank, ep_size).contiguous()

    embedding = linear_ops.init_embedding(generator, cfg.vocab_size, cfg.hidden_size,
                                          dtype=dtype, stddev=cfg.initializer_range,
                                          device=device)["embedding"]
    def layer(i):
        mlp = None if mlp_of is None else mlp_of(i)
        if i in mine:
            return _init_layer(generator, cfg, dtype, device,
                               lambda n, t: cut("layers.0." + n, t), mlp)
        # another stage's: drawn leaf by leaf (the generator advances), dropped
        _init_layer(generator, cfg, dtype, device, lambda n, t: None, mlp)
        return None

    params: dict[str, Any] = {
        "embed": {"embedding": cut("embed.embedding", embedding)},
        "layers": [layer(i) for i in range(cfg.num_layers)],
        "final_norm": norm_ops.init_rms_norm(cfg.hidden_size, dtype=dtype, device=device),
    }
    del embedding
    if not cfg.tie_word_embeddings:
        w = linear_ops.init_linear(generator, cfg.hidden_size, cfg.vocab_size, dtype=dtype,
                                   stddev=cfg.initializer_range, device=device)["w"]
        params["lm_head"] = {"w": cut("lm_head.w", w)}
    return params


def named_params(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Flatten a parameter tree to ``{dotted.name: tensor}`` (same tensors);
    a None entry (another pipeline stage's layer) has no leaves."""
    out: dict[str, torch.Tensor] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            out[name] = v
        else:
            out.update(named_params(v, name + "."))
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def check_heads(nh: int, nkv: int, tp: int) -> None:
    """tp must divide the heads, and divide or be divided by the kv heads
    (the JAX package's texts): then the local GQA map, q head ``i`` -> kv
    head ``i // (nh/nkv)``, holds on each rank's heads."""
    if nh % tp:
        raise ValueError(f"attention: num_heads {nh} must be divisible by tp {tp}")
    if nkv % tp and tp % nkv:
        raise ValueError(f"attention: kv_heads {nkv} and tp {tp} must divide one another "
                         f"(got kvh%tp and tp%kvh both nonzero)")


def _attention_block(lp, x, cos, sin, cfg: LlamaConfig, policy: DtypePolicy,
                     attention_mask=None, segment_ids=None, tp=None, cp=None, attend=None):
    """The attention sublayer.  ``attend(q, k, v, attention)``, if given,
    takes the place of the configured attention, which it gets as its last
    argument, with the rotated k and the v ``[b, s, nkv, d]`` (the KV-cache
    contract of ``models/decode.py``: its prefill stores them and calls
    ``attention``, its decode step attends over the cache)."""
    x = tp_ops.enter_column(x, tp)
    b, s, _ = x.shape
    size = tp.size if tp_ops.active(tp) else 1
    check_heads(cfg.num_attention_heads, cfg.kv_heads, size)
    # above the kv heads the rank holds one, replicated (parallel/sharding.py)
    nh, nkv, d = cfg.num_attention_heads // size, max(cfg.kv_heads // size, 1), cfg.head_size
    if cfg.fuse_qkv:
        qkv = linear_ops.apply_linear(lp["qkv"], x)
        q, k, v = torch.split(qkv, [nh * d, nkv * d, nkv * d], dim=-1)
    else:
        q = linear_ops.apply_linear(lp["q"], x)
        k = linear_ops.apply_linear(lp["k"], x)
        v = linear_ops.apply_linear(lp["v"], x)
    q = rope_ops.apply_rope(q.reshape(b, s, nh, d), cos, sin)
    k = rope_ops.apply_rope(k.reshape(b, s, nkv, d), cos, sin)
    v = v.reshape(b, s, nkv, d)

    def attention(q, k, v):
        return attn_ops.attention(
            q, k, v, impl=cfg.attention_impl, causal=True,
            sliding_window=cfg.sliding_window, softmax_dtype=policy.softmax_dtype,
            attention_mask=attention_mask, segment_ids=segment_ids, cp=cp, tp_size=size,
        )

    if attend is not None:
        out = attend(q, k, v, attention)
    elif (cfg.attention_impl == "core"
            and cfg.activations_checkpoint_granularity == "selective"):
        # recompute core attention's O(s^2) scores and probs in backward
        out = checkpoint(attention, q, k, v, use_reentrant=False)
    else:
        out = attention(q, k, v)
    return tp_ops.leave_row(linear_ops.apply_linear(lp["o"], out.reshape(b, s, nh * d)), tp)


def _mlp_block(lp, x, tp=None):
    x = tp_ops.enter_column(x, tp)
    gate, up = torch.chunk(linear_ops.apply_linear(lp["gate_up"], x), 2, dim=-1)
    return tp_ops.leave_row(linear_ops.apply_linear(lp["down"], F.silu(gate) * up), tp)


def _decoder_layer(lp, x, cos, sin, cfg: LlamaConfig, policy: DtypePolicy,
                   attention_mask=None, segment_ids=None, tp=None, cp=None, attend=None):
    """One layer (``attend`` as in :func:`_attention_block`)."""
    # cast inside the layer: one layer's compute-dtype copy at a time
    lp = policy.cast_to_compute(lp)
    h = norm_ops.apply_rms_norm(lp["input_norm"], x, eps=cfg.rms_norm_eps)
    x = x + _attention_block(lp["attn"], h, cos, sin, cfg, policy,
                             attention_mask=attention_mask, segment_ids=segment_ids, tp=tp,
                             cp=cp, attend=attend)
    h = norm_ops.apply_rms_norm(lp["post_attn_norm"], x, eps=cfg.rms_norm_eps)
    return x + _mlp_block(lp["mlp"], h, tp)


def positions_for(input_ids: torch.Tensor, attention_mask=None, segment_ids=None) -> torch.Tensor:
    """RoPE position ids [b, s]: arange; for padded batches the count of real
    tokens (``cumsum(attention_mask) - 1``); for packed segments positions
    restart at each record."""
    b, s = input_ids.shape
    idx = torch.arange(s, dtype=torch.int32, device=input_ids.device)[None, :]
    if segment_ids is not None:
        starts = torch.cat([torch.ones_like(segment_ids[:, :1], dtype=torch.bool),
                            segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
        start = torch.where(starts, idx, torch.zeros_like(idx))
        return idx - torch.cummax(start, dim=1).values
    if attention_mask is not None:
        m = attention_mask.to(torch.int32)
        return torch.clamp(torch.cumsum(m, dim=1, dtype=torch.int32) - 1, min=0)
    return idx.expand(b, s)


def _rope(cfg: LlamaConfig, positions: torch.Tensor):
    inv_freq = rope_ops.rope_frequencies(
        cfg.head_size, theta=cfg.rope_theta,
        position_interpolation_factor=cfg.rope_interpolation_factor)
    return rope_ops.rope_cos_sin(positions, inv_freq, dtype=torch.float32)


def _run_layers(layers, x, cos, sin, cfg: LlamaConfig, policy: DtypePolicy,
                attention_mask=None, segment_ids=None, tp=None, cp=None) -> torch.Tensor:
    full = cfg.activations_checkpoint_granularity == "full"
    for lp in layers:
        args = (lp, x, cos, sin, cfg, policy, attention_mask, segment_ids, tp, cp)
        x = (checkpoint(_decoder_layer, *args, use_reentrant=False) if full
             else _decoder_layer(*args))
    return x


def hidden_states(params, input_ids: torch.Tensor, cfg: LlamaConfig, policy: DtypePolicy, *,
                  positions=None, attention_mask=None, segment_ids=None,
                  tp=None, cp=None) -> torch.Tensor:
    """Embedding + decoder layers + final norm -> [batch, seq, hidden] (the
    rank's ``seq/tp`` slice of the sequence under SP).  Under ``cp``,
    ``input_ids`` and ``positions`` are the context rank's slice."""
    x = linear_ops.apply_embedding(params["embed"], input_ids,
                                   compute_dtype=policy.compute_dtype, tp=tp)
    if positions is None:
        positions = positions_for(input_ids, attention_mask, segment_ids)
    cos, sin = _rope(cfg, positions)
    x = _run_layers(params["layers"], x, cos, sin, cfg, policy, attention_mask, segment_ids,
                    tp, cp)
    return norm_ops.apply_rms_norm(params["final_norm"], x, eps=cfg.rms_norm_eps)


def logits_fn(params, hidden: torch.Tensor, cfg: LlamaConfig, policy: DtypePolicy, tp=None):
    """``[b, s, V]`` logits; with ``tp``, the rank's ``ceil(V/tp)`` slice of
    the vocab (the no-gather column-parallel ``lm_head``), whose padded
    columns, past the vocab, are ``-inf``."""
    hidden = tp_ops.enter_column(hidden, tp)
    if cfg.tie_word_embeddings:
        logits = hidden @ params["embed"]["embedding"].to(policy.compute_dtype).T
    else:
        logits = linear_ops.apply_linear(params["lm_head"], hidden,
                                         compute_dtype=policy.compute_dtype)
    if tp_ops.active(tp) and cfg.vocab_size % tp.size:
        _, real = sharding.vocab_rows(cfg.vocab_size, tp.rank, tp.size)
        pad = torch.arange(logits.shape[-1], device=logits.device) >= real
        logits = logits.masked_fill(pad, float("-inf"))
    return logits


def _chunked_head_loss(params, hidden, labels, loss_mask, cfg: LlamaConfig, *,
                       shift_labels: bool, denominator, tp, reduction: str = "mean"):
    """The loss of ``fusions.chunked_ce``: the final hidden states through
    the column region (gathered under SP), then the fused head + CE over
    ``cfg.vocab_chunks`` vocab blocks (``ops/cross_entropy.py``); the
    ``[b, s, V]`` logits are never held."""
    x = tp_ops.enter_column(hidden, tp)
    if shift_labels:
        x, labels = x[:, :-1], labels[:, 1:]
        loss_mask = None if loss_mask is None else loss_mask[:, 1:]
    head_w = (params["embed"]["embedding"].T if cfg.tie_word_embeddings
              else params["lm_head"]["w"])
    return ce_ops.chunked_cross_entropy_from_hidden(
        x, head_w, labels, num_chunks=cfg.vocab_chunks, loss_mask=loss_mask,
        reduction=reduction, denominator=denominator, tp=tp, vocab_size=cfg.vocab_size)


def _loss_mask(batch: dict[str, torch.Tensor]):
    loss_mask = batch.get("loss_mask")
    attention_mask = batch.get("attention_mask")
    if attention_mask is not None:
        am = attention_mask.float()
        loss_mask = am if loss_mask is None else loss_mask * am
    return loss_mask


def loss_token_count(batch: dict[str, torch.Tensor], *, shift_labels: bool = True):
    """The loss denominator of ``forward`` on ``batch``: its count of loss
    tokens (at least 1), as a 0-d fp32 tensor.  Under data parallelism the
    trainer takes it on the whole microbatch and passes it to each rank's
    ``forward`` (``ops/cross_entropy.py``)."""
    labels, loss_mask = batch["labels"], _loss_mask(batch)
    if shift_labels:
        labels = labels[:, 1:]
        loss_mask = None if loss_mask is None else loss_mask[:, 1:]
    return ce_ops.loss_token_count(labels, loss_mask=loss_mask)


def forward(params, batch: dict[str, torch.Tensor], cfg: LlamaConfig, policy: DtypePolicy, *,
            positions=None, shift_labels: bool = True, return_logits: bool = False,
            loss_denominator: Optional[torch.Tensor] = None, tp=None, cp=None):
    """Causal-LM forward -> (loss, aux); without labels -> (logits, aux).
    ``loss_denominator`` replaces this batch's own loss-token count (see
    :func:`loss_token_count`).  With ``tp`` the logits are the rank's vocab
    slice, and every rank of the tp group returns the whole loss.  With
    ``cp`` the batch is a context rank's slice from
    ``data/loader.py::context_parallel_batch``: its ``positions`` are used,
    its labels are next-token targets already and its ``loss_mask`` holds the
    attention mask, so nothing is shifted or masked again; the loss is the
    rank's share (its tokens over ``loss_denominator``).  With
    ``cfg.vocab_chunks``, labels, no logits asked for and a plain head (tied,
    or an ``lm_head`` without a LoRA adapter) the loss is the chunked head's
    and ``aux`` is empty."""
    attention_mask = batch.get("attention_mask")
    if cp is not None:
        positions = batch["positions"]
    hidden = hidden_states(params, batch["input_ids"], cfg, policy, positions=positions,
                           attention_mask=attention_mask,
                           segment_ids=batch.get("segment_ids"), tp=tp, cp=cp)
    return head_loss(params, hidden, batch, cfg, policy, shift_labels=shift_labels,
                     return_logits=return_logits, loss_denominator=loss_denominator, tp=tp,
                     cp=cp)


def head_loss(params, hidden: torch.Tensor, batch: dict, cfg: LlamaConfig,
              policy: DtypePolicy, *, shift_labels: bool = True, return_logits: bool = False,
              loss_denominator: Optional[torch.Tensor] = None, tp=None, cp=None):
    """:func:`forward`'s head and loss on the final hidden states (after the
    final norm): ``(loss, aux)``, or ``(logits, aux)`` without labels."""
    if cp is not None:
        shift_labels = False
    labels = batch.get("labels")
    loss_mask = batch.get("loss_mask") if cp is not None else _loss_mask(batch)
    if cfg.vocab_chunks and labels is not None and not return_logits and _head_plain(params, cfg):
        # an lm_head LoRA adapter needs apply_linear: the plain head below
        return _chunked_head_loss(params, hidden, labels, loss_mask, cfg,
                                  shift_labels=shift_labels, denominator=loss_denominator,
                                  tp=tp), {}
    logits = logits_fn(params, hidden, cfg, policy, tp)
    aux: dict[str, Any] = {"logits": logits} if return_logits else {}
    if labels is None:
        return logits, aux
    if shift_labels:
        logits, labels, loss_mask = ce_ops.shift_for_next_token(logits, labels, loss_mask)
    return ce_ops.cross_entropy_loss(logits, labels, loss_mask=loss_mask,
                                     denominator=loss_denominator, tp=tp), aux


def _head_plain(params, cfg: LlamaConfig) -> bool:
    """A head the chunked head can run: tied, or an ``lm_head`` without a
    LoRA adapter (that needs ``apply_linear``)."""
    return cfg.tie_word_embeddings or ("lm_head" in params and "lora_a" not in params["lm_head"])


def stage_rope(cfg: LlamaConfig, mb: dict):
    """A pipeline microbatch's RoPE tables: from its ``positions``, else
    from its attention mask or segment ids, as :func:`forward`."""
    positions = mb.get("positions")
    if positions is None:
        positions = positions_for(mb["input_ids"], mb.get("attention_mask"),
                                  mb.get("segment_ids"))
    return _rope(cfg, positions)


def pipeline_hooks(cfg: LlamaConfig, policy: DtypePolicy, *, shift_labels: bool = True,
                   tp=None, cp=None):
    """``(embed_fn, stage_fn, loss_fn, act_shape)`` for
    ``parallel/pipeline.py`` (the JAX package's ``pipeline_hooks``, with the
    head its ``onef1b_head_hooks`` wires: the final norm and the tied or
    untied head weight):

    - ``embed_fn(params, mb)``: the (vocab-parallel) embedding, the rank's
      ``seq/tp`` slice under SP;
    - ``stage_fn(layers, x, mb)``: a slice of decoder layers, RoPE from the
      microbatch's ``positions`` (else from its attention mask or segment
      ids, as :func:`forward`), with its attention mask and segment ids;
    - ``loss_fn(params, y, mb) -> (loss_sum, valid_count)``: the final norm,
      the head (``logits_fn``: the embedding's rows when tied, ``lm_head``
      else) and the summed cross-entropy, masked as :func:`forward` masks;
      with ``cfg.vocab_chunks`` and a plain head the fused chunked head
      (``ops/cross_entropy.py``), as JAX's ``loss_fn`` there;
    - ``act_shape(mb)``: the shape of the activations that cross the stages.

    Under ``cp`` each microbatch is the context rank's slice
    (``data/loader.py::context_parallel_batch``: its positions, targets and
    loss mask taken on the whole row, so nothing is shifted here) and the
    layers' attention crosses the context group within each stage call.

    A tied weight's gradient comes from the first stage's embedding and the
    last stage's head; ``parallel/pipeline.py`` sums the two over ``pipe``
    (JAX's ``fold_grads``).  The flash kernels run in the stage's layers as
    in :func:`forward`."""
    sp = tp.size if tp_ops.active(tp) and tp.sequence_parallel else 1

    def embed_fn(params, mb):
        return linear_ops.apply_embedding(params["embed"], mb["input_ids"],
                                          compute_dtype=policy.compute_dtype, tp=tp)

    def stage_fn(layers, x, mb):
        cos, sin = stage_rope(cfg, mb)
        return _run_layers(layers, x, cos, sin, cfg, policy, mb.get("attention_mask"),
                           mb.get("segment_ids"), tp, cp)

    shift = shift_labels and cp is None

    def loss_fn(params, y, mb):
        h = norm_ops.apply_rms_norm(params["final_norm"], y, eps=cfg.rms_norm_eps)
        labels = mb["labels"]
        loss_mask = mb.get("loss_mask") if cp is not None else _loss_mask(mb)
        if cfg.vocab_chunks and _head_plain(params, cfg):
            loss_sum = _chunked_head_loss(params, h, labels, loss_mask, cfg, shift_labels=shift,
                                          denominator=None, tp=tp, reduction="sum")
            if shift:
                labels = labels[:, 1:]
                loss_mask = None if loss_mask is None else loss_mask[:, 1:]
        else:
            logits = logits_fn(params, h, cfg, policy, tp)
            if shift:
                logits, labels, loss_mask = ce_ops.shift_for_next_token(logits, labels,
                                                                        loss_mask)
            loss_sum = ce_ops.cross_entropy_loss(logits, labels, loss_mask=loss_mask,
                                                 reduction="sum", tp=tp)
        valid = (labels != -100).float()
        if loss_mask is not None:
            valid = valid * loss_mask.float()
        return loss_sum, torch.sum(valid)

    def act_shape(mb):
        b, s = mb["input_ids"].shape
        return (b, s // sp, cfg.hidden_size)

    return embed_fn, stage_fn, loss_fn, act_shape
