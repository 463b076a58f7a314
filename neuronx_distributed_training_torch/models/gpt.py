"""Megatron-family GPT model (counterpart of the JAX package's
``models/gpt.py``): the ``model_source: megatron`` / ``architecture: gpt``
decoder and the knobs of its ``GPTConfig``:

- positions: ``rope`` (``rotary_percentage`` of each head rotated, the rest
  passed through) or ``learned_absolute`` (a ``pos_embed`` table taken at
  ``models/llama.py::positions_for``);
- normalization: ``layernorm`` (scale and bias) or ``rmsnorm``;
- activation: ``gelu`` (the tanh approximation, as ``jax.nn.gelu``'s
  default), or the glu ``swiglu`` / ``geglu`` / ``reglu``, whose ``up`` is
  ``[h, 2 ffn]`` split in halves, gate first;
- biased linears (``bias``), GQA / MQA (``num_query_groups``), a sliding
  window, tokentype embeddings, a tied or untied head;
- the block layouts ``pre_ln``, ``post_ln`` (no final norm), ``normformer``
  (two more norms, the mid-MLP one over the ffn width) and ``gpt_j`` (a
  parallel residual with two independent norms);
- dropout on the embedding and on each residual branch, with the key
  discipline of ``utils/prng.py``;
- MoE layers (every ``moe_frequency``-th) through ``ops/moe.py``, as
  ``models/mixtral.py`` runs them, the router loss averaged over the MoE
  layers and added.

The parameter tree is Llama's shape with GPT's names, one dict per layer
(JAX stacks them and scans; ``tools/convert.py`` bridges the two, also for
the grouped ``{"moe", "dense"}`` layout of ``moe_frequency > 1``):

    {"embed": {"embedding": [V, h]}, "pos_embed": {"embedding": [P, h]}?,
     "tokentype_embed": {"embedding": [T, h]}?,
     "layers": [{"input_norm", "post_attn_norm", ("nf_attn_norm",
                 "nf_mlp_norm" [ffn])?,
                 "attn": {"qkv": {"w", "bias"?}, "o": {"w", "bias"?}},
                 "mlp": {"up": {"w", "bias"?}, "down": {"w", "bias"?}}
                        (or a MoE block)}, ...],
     "final_norm"? (absent under post_ln), "lm_head": {"w"}? (untied)}

Tensor parallelism, sequence parallelism and pipeline parallelism are
``models/llama.py``'s (the regions of ``parallel/tensor_parallel.py``, the
layouts of ``parallel/sharding.py``); a row layer's bias is added once after
its reduce (``ops/linear.py::apply_row_linear``), and the normformer's
mid-MLP norm is the true full-width norm over the tp-split ffn
(``tensor_parallel.full_width_norm``), as in JAX.  The head and its
cross-entropy are Llama's (``llama.head_loss``: a tied head takes the
rank's padded vocab rows and masks the pad columns out, as an untied one).
Attention goes through ``ops/attention.py``, so the flash kernels run at
GPT's head dims as at Llama's.

Context parallelism (``cp``): each context rank runs its chunk of every row
(``data/loader.py::context_parallel_batch``, which carries the chunk's
global positions and tokentype ids), its attention through the ring body
whatever the cp fusion (JAX's GPT attends over the whole, GSPMD-sharded
sequence and reads no cp fusion), and every dropout mask as its slice of
the whole sequence's (:func:`_seq_slice`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from neuronx_distributed_training_torch.models import llama, mixtral
from neuronx_distributed_training_torch.ops import attention as attn_ops
from neuronx_distributed_training_torch.ops import cross_entropy as ce_ops
from neuronx_distributed_training_torch.ops import linear as linear_ops
from neuronx_distributed_training_torch.ops import moe as moe_ops
from neuronx_distributed_training_torch.ops import norm as norm_ops
from neuronx_distributed_training_torch.ops import rope as rope_ops
from neuronx_distributed_training_torch.parallel import sharding
from neuronx_distributed_training_torch.parallel import tensor_parallel as tp_ops
from neuronx_distributed_training_torch.utils import prng
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

BLOCK_TYPES = ("pre_ln", "post_ln", "normformer", "gpt_j")
ACTIVATIONS = ("gelu", "swiglu", "geglu", "reglu")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The ``megatron`` ``model:`` block (JAX's ``GPTConfig``, same defaults)."""

    vocab_size: int = 50257
    hidden_size: int = 1024
    ffn_hidden_size: Optional[int] = None  # default 4 h
    num_layers: int = 12
    num_attention_heads: int = 16
    num_query_groups: Optional[int] = None  # GQA; 1 = MQA; None = MHA
    max_position_embeddings: int = 2048
    position_embedding_type: str = "rope"  # "rope" | "learned_absolute"
    rotary_percentage: float = 1.0
    rope_theta: float = 10000.0
    normalization: str = "layernorm"  # "layernorm" | "rmsnorm"
    layernorm_epsilon: float = 1e-5
    activation: str = "gelu"  # "gelu" | "swiglu" | "geglu" | "reglu"
    bias: bool = True
    hidden_dropout: float = 0.0
    embedding_dropout: float = 0.0
    sliding_window: Optional[int] = None
    transformer_block_type: str = "pre_ln"
    num_tokentypes: int = 0
    share_embeddings_and_output_weights: bool = True
    initializer_range: float = 0.02
    attention_impl: str = "core"  # "core" | "flash"
    sequence_parallel: bool = False
    activations_checkpoint_granularity: Optional[str] = "selective"
    moe: Optional[moe_ops.MoEConfig] = None
    moe_frequency: int = 1

    @property
    def kv_heads(self) -> int:
        return self.num_query_groups or self.num_attention_heads

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ffn_size(self) -> int:
        return int(self.ffn_hidden_size) if self.ffn_hidden_size else 4 * self.hidden_size

    # the ffn width parallel/sharding.py reads (Llama's name)
    @property
    def intermediate_size(self) -> int:
        return self.ffn_size

    @property
    def is_glu(self) -> bool:
        return self.activation in ("swiglu", "geglu", "reglu")

    # what models/llama.py's head and the trainer read
    @property
    def tie_word_embeddings(self) -> bool:
        return self.share_embeddings_and_output_weights

    @property
    def vocab_chunks(self) -> None:
        return None  # JAX's GPT has no chunked head

    @property
    def context_parallel(self) -> bool:
        return False

    @property
    def needs_rng(self) -> bool:
        """Does a train step draw dropout masks (JAX's ``needs_rng``)?"""
        return self.hidden_dropout > 0.0 or self.embedding_dropout > 0.0

    @classmethod
    def from_config(cls, model_cfg: dict[str, Any],
                    ds_cfg: Optional[dict[str, Any]] = None) -> "GPTConfig":
        """Every alias of JAX's ``from_config``: ``num_kv_heads``,
        ``has_bias``, ``rotary_base``, ``sliding_window_size`` /
        ``window_size``, ``num_moe_experts`` and ``moe.frequency``."""
        m = dict(model_cfg or {})
        ds = dict(ds_cfg or {})
        fusions = dict(m.get("fusions", {}) or {})
        moe_block = m.get("moe") or (
            {"num_experts": m["num_moe_experts"]} if m.get("num_moe_experts") else None)
        moe_freq = int((moe_block or {}).get("frequency", 1) or 1)
        groups = m.get("num_query_groups", m.get("num_kv_heads"))
        window = m.get("sliding_window_size", m.get("window_size", m.get("sliding_window")))
        return cls(
            vocab_size=int(m.get("vocab_size", 50257)),
            hidden_size=int(m.get("hidden_size", 1024)),
            ffn_hidden_size=m.get("ffn_hidden_size"),
            num_layers=int(m.get("num_layers", 12)),
            num_attention_heads=int(m.get("num_attention_heads", 16)),
            num_query_groups=None if groups is None else int(groups),
            max_position_embeddings=int(m.get("max_position_embeddings", 2048)),
            position_embedding_type=str(m.get("position_embedding_type", "rope")),
            rotary_percentage=float(m.get("rotary_percentage", 1.0)),
            rope_theta=float(m.get("rotary_base", m.get("rope_theta", 10000.0))),
            normalization=str(m.get("normalization", "layernorm")),
            layernorm_epsilon=float(m.get("layernorm_epsilon", 1e-5)),
            activation=str(m.get("activation", "gelu")),
            bias=bool(m.get("has_bias", m.get("bias", True))),
            hidden_dropout=float(m.get("hidden_dropout", 0.0)),
            embedding_dropout=float(m.get("embedding_dropout", m.get("hidden_dropout", 0.0))),
            sliding_window=None if window is None else int(window),
            transformer_block_type=str(m.get("transformer_block_type", "pre_ln")),
            num_tokentypes=int(m.get("num_tokentypes", 0) or 0),
            share_embeddings_and_output_weights=bool(
                m.get("share_embeddings_and_output_weights", True)),
            attention_impl="flash" if fusions.get("flash_attention") else "core",
            sequence_parallel=bool(ds.get("sequence_parallel", False)),
            activations_checkpoint_granularity=m.get(
                "activations_checkpoint_granularity", "selective"),
            moe=moe_ops.MoEConfig.from_config(moe_block) if moe_block else None,
            moe_frequency=moe_freq,
        )


def check_config(cfg: GPTConfig) -> None:
    """JAX's refusals at init, with its texts."""
    if cfg.transformer_block_type not in BLOCK_TYPES:
        raise ValueError(f"unknown transformer_block_type {cfg.transformer_block_type!r}; "
                         f"supported: {BLOCK_TYPES}")
    if cfg.transformer_block_type == "normformer" and cfg.moe is not None:
        raise ValueError("normformer blocks are dense-only (the mid-MLP norm has no "
                         "expert equivalent); use pre_ln or post_ln with MoE")
    if cfg.activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {cfg.activation!r}; supported: {ACTIVATIONS}")


def num_moe_layers(cfg: GPTConfig) -> int:
    """Layer ``i`` is MoE iff ``i % moe_frequency == 0``."""
    f = cfg.moe_frequency
    if cfg.num_layers % f != 0:
        raise ValueError(f"num_layers {cfg.num_layers} must divide by moe frequency {f}")
    return cfg.num_layers // f


def is_moe_layer(cfg: GPTConfig, i: int) -> bool:
    return cfg.moe is not None and i % cfg.moe_frequency == 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _norm_init(cfg: GPTConfig, dtype, device, width: Optional[int] = None):
    width = width or cfg.hidden_size
    if cfg.normalization == "rmsnorm":
        return norm_ops.init_rms_norm(width, dtype=dtype, device=device)
    return norm_ops.init_layer_norm(width, dtype=dtype, device=device)


def _init_layer(gen, cfg: GPTConfig, dtype, device, cut, moe: bool):
    h, d = cfg.hidden_size, cfg.head_size
    nh, nkv = cfg.num_attention_heads, cfg.kv_heads
    std, bias = cfg.initializer_range, cfg.bias

    def lin(module, i, o):
        p = linear_ops.init_linear(gen, i, o, dtype=dtype, stddev=std, device=device,
                                   use_bias=bias)
        return {k: cut(f"{module}.{k}", t) for k, t in p.items()}

    p: dict[str, Any] = {"input_norm": _norm_init(cfg, dtype, device),
                         "post_attn_norm": _norm_init(cfg, dtype, device)}
    if cfg.transformer_block_type == "normformer":
        p["nf_attn_norm"] = _norm_init(cfg, dtype, device)
        p["nf_mlp_norm"] = _norm_init(cfg, dtype, device, width=cfg.ffn_size)
    p["attn"] = {"qkv": lin("attn.qkv", h, (nh + 2 * nkv) * d), "o": lin("attn.o", nh * d, h)}
    if moe:
        p["mlp"] = moe_ops.init_moe_params(gen, h, cfg.ffn_size, cfg.moe, dtype=dtype,
                                           stddev=std, device=device,
                                           cut=lambda n, t: cut("mlp." + n, t))
    else:
        width = 2 * cfg.ffn_size if cfg.is_glu else cfg.ffn_size
        p["mlp"] = {"up": lin("mlp.up", h, width), "down": lin("mlp.down", cfg.ffn_size, h)}
    return p


def init_params(cfg: GPTConfig, policy: Optional[DtypePolicy] = None, *,
                generator: torch.Generator, device=None, tp_rank: int = 0, tp_size: int = 1,
                pp_rank: int = 0, pp_size: int = 1, vp: int = 1, ep_rank: int = 0,
                ep_size: int = 1):
    """The parameter tree in the policy's param dtype, drawn from
    ``generator`` leaf by leaf in a fixed order (the embedding, the position
    and tokentype tables, each layer, the head), each leaf whole, of which a
    rank keeps its tp slices, its experts and its pipeline stages' layers
    (``models/llama.py::init_params``'s rule: every layout starts from the
    one-rank run's tensors)."""
    check_config(cfg)
    if cfg.moe is not None:
        num_moe_layers(cfg)
    policy = policy or DtypePolicy()
    dtype, std = policy.param_dtype, cfg.initializer_range
    mine = set(range(cfg.num_layers))
    if pp_size > 1:
        from neuronx_distributed_training_torch.parallel.pipeline import stage_layers

        mine = set(stage_layers(cfg.num_layers, pp_rank, pp_size, vp))

    def cut(name: str, t: torch.Tensor) -> torch.Tensor:
        return sharding.local_leaf(t, sharding.leaf_layout(name, cfg), tp_rank, tp_size,
                                   ep_rank, ep_size).contiguous()

    def table(rows: int):
        return {"embedding": linear_ops._normal_init(generator, (rows, cfg.hidden_size), dtype,
                                                     std, device)}

    params: dict[str, Any] = {"embed": {"embedding": cut("embed.embedding",
                                                         table(cfg.vocab_size)["embedding"])}}
    if cfg.position_embedding_type == "learned_absolute":
        params["pos_embed"] = table(cfg.max_position_embeddings)
    if cfg.num_tokentypes > 0:
        params["tokentype_embed"] = table(cfg.num_tokentypes)

    def layer(i):
        if i in mine:
            return _init_layer(generator, cfg, dtype, device,
                               lambda n, t: cut("layers.0." + n, t), is_moe_layer(cfg, i))
        _init_layer(generator, cfg, dtype, device, lambda n, t: None, is_moe_layer(cfg, i))
        return None

    params["layers"] = [layer(i) for i in range(cfg.num_layers)]
    if cfg.transformer_block_type != "post_ln":
        # post_ln layers end with their own norm: no final norm
        params["final_norm"] = _norm_init(cfg, dtype, device)
    if not cfg.share_embeddings_and_output_weights:
        w = linear_ops.init_linear(generator, cfg.hidden_size, cfg.vocab_size, dtype=dtype,
                                   stddev=std, device=device)["w"]
        params["lm_head"] = {"w": cut("lm_head.w", w)}
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply_norm(cfg: GPTConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.normalization == "rmsnorm":
        return norm_ops.apply_rms_norm(params, x, eps=cfg.layernorm_epsilon)
    return norm_ops.apply_layer_norm(params, x, eps=cfg.layernorm_epsilon)


def _activation(cfg: GPTConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation; torch's is erf
    if cfg.is_glu:
        gate, up = torch.chunk(x, 2, dim=-1)
        if cfg.activation == "swiglu":
            gate = F.silu(gate)
        elif cfg.activation == "geglu":
            gate = F.gelu(gate, approximate="tanh")
        else:
            gate = F.relu(gate)
        return gate * up
    return F.gelu(x, approximate="tanh")


def _seq_slice(x: torch.Tensor, tp, cp=None) -> tuple:
    """``(seq_len, positions)`` of the residual-stream activation ``x``: the
    whole sequence, or the rank's slice of it: under cp its context
    chunk, and under SP its ``1/tp`` of that (JAX's ``seq_axes``: context
    before model)."""
    s = x.shape[1]
    start, n = 0, s
    if tp_ops.active(tp) and tp.sequence_parallel:
        start, n = tp.rank * s, s * tp.size
    if cp is not None:
        start, n = cp.rank * n + start, n * cp.size
    return (s, None) if n == s else (n, slice(start, start + s))


def _dropout(x: torch.Tensor, rate: float, key, tp, cp=None) -> torch.Tensor:
    seq_len, positions = _seq_slice(x, tp, cp)
    return prng.dropout(x, rate, key, seq_len=seq_len, positions=positions)


def _rotate(cfg: GPTConfig, x: torch.Tensor, cos, sin) -> torch.Tensor:
    if cfg.rotary_percentage < 1.0:
        rot = int(x.shape[-1] * cfg.rotary_percentage) // 2 * 2
        return torch.cat([rope_ops.apply_rope(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)
    return rope_ops.apply_rope(x, cos, sin)


def _attention_block(cfg: GPTConfig, lp, x, cos, sin, policy: DtypePolicy,
                     attention_mask=None, segment_ids=None, tp=None, attend=None, cp=None):
    """The attention sublayer; ``attend`` as in ``models/llama.py::
    _attention_block`` (k rotated on its first ``int(d p) // 2 * 2`` dims
    under partial rotary).  Under ``cp`` the rank holds its context chunk
    and attends through the ring body (``parallel/ring_attention.py``:
    per chunk pair the flash kernels where they tile, the key mask rotating
    with K/V), whatever the cp fusions say: JAX's GPT reads none of them
    and attends over the whole sequence, which the ring's merged chunks
    are."""
    x = tp_ops.enter_column(x, tp)
    b, s, _ = x.shape
    size = tp.size if tp_ops.active(tp) else 1
    llama.check_heads(cfg.num_attention_heads, cfg.kv_heads, size)
    nh, nkv, d = cfg.num_attention_heads // size, max(cfg.kv_heads // size, 1), cfg.head_size
    q, k, v = torch.split(linear_ops.apply_linear(lp["qkv"], x), [nh * d, nkv * d, nkv * d],
                          dim=-1)
    q, k, v = q.reshape(b, s, nh, d), k.reshape(b, s, nkv, d), v.reshape(b, s, nkv, d)
    if cos is not None:
        q, k = _rotate(cfg, q, cos, sin), _rotate(cfg, k, cos, sin)

    def attention(q, k, v):
        return attn_ops.attention(
            q, k, v, impl=cfg.attention_impl if cp is None else "ring", causal=True,
            sliding_window=cfg.sliding_window, softmax_dtype=policy.softmax_dtype,
            attention_mask=attention_mask, segment_ids=segment_ids, cp=cp, tp_size=size)

    if attend is not None:
        out = attend(q, k, v, attention)
    elif (cp is None and cfg.attention_impl == "core"
          and cfg.activations_checkpoint_granularity == "selective"):
        out = checkpoint(attention, q, k, v, use_reentrant=False)
    else:
        out = attention(q, k, v)
    return linear_ops.apply_row_linear(lp["o"], out.reshape(b, s, nh * d), tp)


def _mlp_block(cfg: GPTConfig, lp, x, policy: DtypePolicy, tp=None, ep=None, mid_norm=None):
    """``(y, router-loss share, value)``; the last two None for a dense MLP."""
    if moe_ops.is_moe_mlp(lp):
        return mixtral.moe_mlp(lp, x, cfg.moe, policy, tp, ep)
    y = _activation(cfg, linear_ops.apply_linear(lp["up"], tp_ops.enter_column(x, tp)))
    if mid_norm is not None:
        # normformer: the whole-width norm over the tp-split ffn
        y = tp_ops.full_width_norm(mid_norm, y, tp, eps=cfg.layernorm_epsilon,
                                   center=cfg.normalization != "rmsnorm")
    return linear_ops.apply_row_linear(lp["down"], y, tp), None, None


def _decoder_layer(lp, x, cos, sin, cfg: GPTConfig, policy: DtypePolicy, key=None,
                   attention_mask=None, segment_ids=None, tp=None, ep=None, attend=None,
                   cp=None):
    """One block in the configured layout -> ``(x, share, value)``
    (``attend`` as in :func:`_attention_block`):

    - ``pre_ln``      x += drop(attn(LN1 x));       x += drop(mlp(LN2 x))
    - ``post_ln``     x = LN1(x + drop(attn(x)));   x = LN2(x + drop(mlp(x)))
    - ``normformer``  x += drop(LNa(attn(LN1 x)));  x += drop(mlp_mid(LN2 x))
    - ``gpt_j``       x += drop(attn(LN1 x)) + drop(mlp(LN2 x))
    """
    lp = policy.cast_to_compute(lp)  # one layer's compute-dtype copy at a time
    bt = cfg.transformer_block_type
    rate = cfg.hidden_dropout
    k1 = k2 = None
    if key is not None:
        k1, k2 = key.fold(1), key.fold(2)

    def attn(h):
        return _attention_block(cfg, lp["attn"], h, cos, sin, policy, attention_mask,
                                segment_ids, tp, attend, cp)

    if bt == "gpt_j":
        a = attn(apply_norm(cfg, lp["input_norm"], x))
        m, share, value = _mlp_block(cfg, lp["mlp"], apply_norm(cfg, lp["post_attn_norm"], x),
                                     policy, tp, ep)
        return x + _dropout(a, rate, k1, tp, cp) + _dropout(m, rate, k2, tp, cp), share, value
    hidden = attn(x if bt == "post_ln" else apply_norm(cfg, lp["input_norm"], x))
    if bt == "normformer":
        hidden = apply_norm(cfg, lp["nf_attn_norm"], hidden)
    x = x + _dropout(hidden, rate, k1, tp, cp)
    if bt == "post_ln":
        x = apply_norm(cfg, lp["input_norm"], x)
    hidden, share, value = _mlp_block(
        cfg, lp["mlp"], x if bt == "post_ln" else apply_norm(cfg, lp["post_attn_norm"], x),
        policy, tp, ep, mid_norm=lp.get("nf_mlp_norm") if bt == "normformer" else None)
    x = x + _dropout(hidden, rate, k2, tp, cp)
    if bt == "post_ln":
        x = apply_norm(cfg, lp["post_attn_norm"], x)
    return x, share, value


def _run_layers(layers, x, cos, sin, cfg: GPTConfig, policy: DtypePolicy, keys=None,
                attention_mask=None, segment_ids=None, tp=None, ep=None, cp=None) -> tuple:
    """``(x, share, value)``: the layers in order (``keys[j]``, if given,
    layer ``j``'s dropout key), and the sums of the MoE layers' router-loss
    shares and values (zeros for a dense model)."""
    full = cfg.activations_checkpoint_granularity == "full"
    share = value = None
    for j, lp in enumerate(layers):
        args = (lp, x, cos, sin, cfg, policy, None if keys is None else keys[j],
                attention_mask, segment_ids, tp, ep, None, cp)
        x, s, v = (checkpoint(_decoder_layer, *args, use_reentrant=False) if full
                   else _decoder_layer(*args))
        if s is not None:
            share = s if share is None else share + s
            value = v if value is None else value + v
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, zero if share is None else share, zero if value is None else value


def _rope_for(cfg: GPTConfig, positions: torch.Tensor):
    """RoPE tables over the rotated ``int(d p) // 2 * 2`` dims; None, None
    for learned positions."""
    if cfg.position_embedding_type == "learned_absolute":
        return None, None
    rot = int(cfg.head_size * cfg.rotary_percentage) // 2 * 2
    inv_freq = rope_ops.rope_frequencies(rot, theta=cfg.rope_theta)
    return rope_ops.rope_cos_sin(positions, inv_freq, dtype=torch.float32)


def _add_tokentype(cfg: GPTConfig, params, x, tokentype_ids):
    """Segment embeddings: ids without a table is a config error (JAX's
    text); a table without ids adds nothing."""
    if tokentype_ids is None:
        return x
    if cfg.num_tokentypes <= 0:
        raise ValueError("batch has tokentype_ids but model.num_tokentypes is 0; set "
                         "num_tokentypes to the number of segment types")
    return x + F.embedding(tokentype_ids.long(),
                           params["tokentype_embed"]["embedding"]).to(x.dtype)


def embed(params, input_ids, positions, cfg: GPTConfig, policy: DtypePolicy, *,
          tokentype_ids=None, key=None, tp=None, cp=None) -> torch.Tensor:
    """The (vocab-parallel) embedding, the learned positions and tokentypes
    at the positions the rank holds (its sequence slice under SP; under cp
    ``input_ids``, ``positions`` and ``tokentype_ids`` are the context
    chunk's, so the table rows are the chunk's global positions) and the
    embedding dropout (``key`` folded with ``prng.EMBED_TAG``), the rank's
    slice of the whole sequence's mask."""
    x = linear_ops.apply_embedding(params["embed"], input_ids,
                                   compute_dtype=policy.compute_dtype, tp=tp)
    _, held = _seq_slice(x, tp)
    held = held or slice(None)
    if cfg.position_embedding_type == "learned_absolute":
        x = x + F.embedding(positions[:, held].long(),
                            params["pos_embed"]["embedding"]).to(x.dtype)
    x = _add_tokentype(cfg, params, x, None if tokentype_ids is None else tokentype_ids[:, held])
    if key is not None:
        x = _dropout(x, cfg.embedding_dropout, key.fold(prng.EMBED_TAG), tp, cp)
    return x


def final_hidden(params, x: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """The final norm (none under ``post_ln``: its layers end normalized)."""
    return x if cfg.transformer_block_type == "post_ln" else apply_norm(
        cfg, params["final_norm"], x)


def layer_keys(key, n: int):
    """Layer ``j``'s dropout key of ``n``, None when ``key`` is."""
    return None if key is None else [key.fold(prng.LAYER_TAG, j) for j in range(n)]


def forward(params, batch: dict[str, torch.Tensor], cfg: GPTConfig, policy: DtypePolicy, *,
            rng=None, positions=None, shift_labels: bool = True, return_logits: bool = False,
            loss_denominator: Optional[torch.Tensor] = None, tp=None, ep=None, cp=None):
    """Causal-LM forward -> ``(loss, aux)``; without labels ``(logits,
    aux)``.  ``rng`` (a ``utils/prng.py::Key``, None: no dropout) is the
    step's key.  The loss is ``models/llama.py::head_loss``'s (the attention
    mask folded into the loss mask; ``loss_denominator``, ``tp`` and ``cp``
    as there), plus, with MoE layers, the router loss averaged over them
    (this rank's share under ``ep``), as ``models/mixtral.py::forward``:
    ``aux`` then holds ``router_aux_loss`` and ``lm_loss``, and without
    labels ``router_aux_share``.  With ``cp`` the batch is a context rank's
    chunk from ``data/loader.py::context_parallel_batch`` (its global
    ``positions``, next-token targets and loss mask), the attention runs the
    ring body and each dropout mask is the rank's slice of the one global
    mask, so the masks per position are cp 1's."""
    ids, am, seg = batch["input_ids"], batch.get("attention_mask"), batch.get("segment_ids")
    if cp is not None:
        positions = batch["positions"]
    if positions is None:
        positions = llama.positions_for(ids, am, seg)
    x = embed(params, ids, positions, cfg, policy, tokentype_ids=batch.get("tokentype_ids"),
              key=rng, tp=tp, cp=cp)
    cos, sin = _rope_for(cfg, positions)
    x, share, value = _run_layers(params["layers"], x, cos, sin, cfg, policy,
                                  layer_keys(rng, len(params["layers"])), am, seg, tp, ep, cp)
    out, aux = llama.head_loss(params, final_hidden(params, x, cfg), batch, cfg, policy,
                               shift_labels=shift_labels, return_logits=return_logits,
                               loss_denominator=loss_denominator, tp=tp, cp=cp)
    if cfg.moe is None:
        return out, aux
    n = num_moe_layers(cfg)
    aux = dict(aux, router_aux_loss=value / n)
    if batch.get("labels") is None:
        aux["router_aux_share"] = share / n
        return out, aux
    lm = out.detach().float()
    aux["lm_loss"] = lm if ep is None else ep.sum_stats_(lm.clone())
    return out + share / n, aux


def logits_of(params, y: torch.Tensor, cfg: GPTConfig, policy: DtypePolicy, tp=None):
    """The final norm and the head on the last layer's output (the
    preference pipeline's ``head_fn``)."""
    return llama.logits_fn(params, final_hidden(params, y, cfg), cfg, policy, tp)


def pipeline_hooks(cfg: GPTConfig, policy: DtypePolicy, *, shift_labels: bool = True,
                   tp=None, ep=None, cp=None):
    """``(embed_fn, stage_fn, loss_fn, act_shape)`` for
    ``parallel/pipeline.py``, as ``models/llama.py::pipeline_hooks``, with
    GPT's embedding, layers, final norm (none under ``post_ln``) and head.

    Dropout: a microbatch's ``_rng`` (``utils/prng.py::Key``, set by the
    trainer per microbatch) keys the embedding (``fold(EMBED_TAG)``) and,
    folded with the pipe rank (``_pipe``) and the chunk (``_chunk``, both
    set by ``bind_stage``), the stage's layers (JAX's stage fold).  With MoE
    layers the stage returns ``(x, aux)``, ``aux`` the sum of their
    router-loss shares (JAX's ``stage_aux``).  Under ``cp`` each
    microbatch is the context rank's chunk, as :func:`forward` takes it
    (nothing shifted or masked again)."""
    sp = tp.size if tp_ops.active(tp) and tp.sequence_parallel else 1
    shift = shift_labels and cp is None

    def positions_of(mb):
        pos = mb.get("positions")
        if pos is None:
            pos = llama.positions_for(mb["input_ids"], mb.get("attention_mask"),
                                      mb.get("segment_ids"))
        return pos

    def embed_fn(params, mb):
        return embed(params, mb["input_ids"], positions_of(mb), cfg, policy,
                     tokentype_ids=mb.get("tokentype_ids"), key=mb.get("_rng"), tp=tp, cp=cp)

    def stage_fn(layers, x, mb):
        cos, sin = _rope_for(cfg, positions_of(mb))
        key = mb.get("_rng")
        if key is not None:
            key = prng.stage_key(key, mb.get("_pipe", 0), mb.get("_chunk", 0))
        x, share, _ = _run_layers(layers, x, cos, sin, cfg, policy, layer_keys(key, len(layers)),
                                  mb.get("attention_mask"), mb.get("segment_ids"), tp, ep, cp)
        return (x, share) if cfg.moe is not None else x

    def loss_fn(params, y, mb):
        logits = logits_of(params, y, cfg, policy, tp)
        labels = mb["labels"]
        loss_mask = mb.get("loss_mask") if cp is not None else llama._loss_mask(mb)
        if shift:
            logits, labels, loss_mask = ce_ops.shift_for_next_token(logits, labels, loss_mask)
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
