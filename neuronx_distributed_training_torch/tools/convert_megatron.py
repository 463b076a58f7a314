"""NeMo-Megatron (NNM) checkpoint converter: Megatron-named torch state dicts
<-> the port's GPT parameter tree (counterpart of the JAX package's
``tools/convert_megatron.py``).

Two independent stages, as in JAX:

1. :func:`merge_nnm_shards`: ``{(tp_rank, pp_rank): state dict}`` of a
   Megatron-sharded checkpoint -> one full Megatron-named state dict (each
   key's tp shards concatenated on its parallel dim, a glu
   ``dense_h_to_4h`` merged per half, pp-local layer indices offset by
   ``pp_rank * num_layers // pp``);
2. :func:`megatron_gpt_to_native` / :func:`native_to_megatron_gpt`: the
   name and layout mapping between Megatron's
   ``language_model.encoder.layers.N...`` and ``models/gpt.py``'s tree (one
   dict per layer), with the fused QKV's head-group de-interleave: Megatron
   stores, for each kv group, its ``q_per`` query heads then one K and one
   V head; the port's ``qkv`` is ``[all Q | all K | all V]``.

State dicts hold torch's ``[out, in]`` weights (torch tensors or numpy
arrays); the port's linears are ``[in, out]``, so weights transpose on the
way.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Optional

import numpy as np
import torch

from neuronx_distributed_training_torch.utils.device import resolve_device

_LAYER_RE = re.compile(r"(\.layers\.)(\d+)(\.)")


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _norm_key(k: str) -> str:
    """``model.language_model...`` -> ``language_model...``."""
    return k[len("model."):] if k.startswith("model.") else k


def _offset_layer(k: str, offset: int) -> str:
    m = _LAYER_RE.search(k)
    if not m:
        return k
    return k[: m.start(2)] + str(int(m.group(2)) + offset) + k[m.end(2):]


def _deinterleave_qkv(w: np.ndarray, nh: int, nkv: int, d: int):
    """Megatron's fused qkv ``[nkv (q_per + 2) d, ...]`` -> ``(q [nh d, ...],
    k, v)``."""
    q_per = nh // nkv
    g = w.reshape((nkv, q_per + 2, d) + w.shape[1:])
    q = g[:, :q_per].reshape((nh * d,) + w.shape[1:])
    k = g[:, q_per].reshape((nkv * d,) + w.shape[1:])
    v = g[:, q_per + 1].reshape((nkv * d,) + w.shape[1:])
    return q, k, v


def _interleave_qkv(q: np.ndarray, k: np.ndarray, v: np.ndarray, nh: int, nkv: int,
                    d: int) -> np.ndarray:
    q_per = nh // nkv
    tail = q.shape[1:]
    groups = [q.reshape((nkv, q_per, d) + tail), k.reshape((nkv, 1, d) + tail),
              v.reshape((nkv, 1, d) + tail)]
    return np.concatenate(groups, axis=1).reshape((nkv * (q_per + 2) * d,) + tail)


def _t(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.T)


def megatron_gpt_to_native(state: Mapping[str, Any], cfg, *, device=None,
                           dtype: Optional[torch.dtype] = None) -> dict[str, Any]:
    """A full (unsharded) Megatron-named state dict -> the port's GPT tree
    on ``device`` (the card unless the caller asks for the CPU; ``cfg``:
    ``models/gpt.py::GPTConfig``).  Keys may carry the ``model.`` prefix."""
    device = resolve_device(device)
    st = {_norm_key(k): _np(v) for k, v in state.items()}
    nh, nkv, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_size

    def g(name):
        return st["language_model." + name]

    def t(a):
        out = torch.from_numpy(np.array(a, copy=True)).to(device)
        return out if dtype is None else out.to(dtype)

    def norm(prefix):
        out = {"scale": t(g(prefix + ".weight"))}
        if cfg.normalization == "layernorm":
            out["bias"] = t(g(prefix + ".bias"))
        return out

    layers = []
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}."
        qkv = _deinterleave_qkv(g(pre + "self_attention.query_key_value.weight"), nh, nkv, d)
        attn = {"qkv": {"w": t(_t(np.concatenate(qkv, axis=0)))},
                "o": {"w": t(_t(g(pre + "self_attention.dense.weight")))}}
        mlp = {"up": {"w": t(_t(g(pre + "mlp.dense_h_to_4h.weight")))},
               "down": {"w": t(_t(g(pre + "mlp.dense_4h_to_h.weight")))}}
        if cfg.bias:
            qkv_b = _deinterleave_qkv(g(pre + "self_attention.query_key_value.bias"), nh, nkv, d)
            attn["qkv"]["bias"] = t(np.concatenate(qkv_b, axis=0))
            attn["o"]["bias"] = t(g(pre + "self_attention.dense.bias"))
            mlp["up"]["bias"] = t(g(pre + "mlp.dense_h_to_4h.bias"))
            mlp["down"]["bias"] = t(g(pre + "mlp.dense_4h_to_h.bias"))
        layer = {"input_norm": norm(pre + "input_layernorm"),
                 "post_attn_norm": norm(pre + "post_attention_layernorm")}
        if cfg.transformer_block_type == "normformer":
            layer["nf_attn_norm"] = norm(pre + "post_attention_normformer_norm")
            layer["nf_mlp_norm"] = norm(pre + "mlp.normalization")
        layer.update(attn=attn, mlp=mlp)
        layers.append(layer)
    params: dict[str, Any] = {"embed": {"embedding": t(g("embedding.word_embeddings.weight"))}}
    if cfg.position_embedding_type == "learned_absolute":
        params["pos_embed"] = {"embedding": t(g("embedding.position_embeddings.weight"))}
    if cfg.num_tokentypes > 0:
        params["tokentype_embed"] = {"embedding": t(g("embedding.tokentype_embeddings.weight"))}
    params["layers"] = layers
    if cfg.transformer_block_type != "post_ln":  # post_ln has no final norm
        params["final_norm"] = norm("encoder.final_layernorm")
    if not cfg.share_embeddings_and_output_weights:
        params["lm_head"] = {"w": t(_t(g("output_layer.weight")))}
    return params


def native_to_megatron_gpt(params: Mapping[str, Any], cfg) -> dict[str, torch.Tensor]:
    """Inverse of :func:`megatron_gpt_to_native`: ``{name: [out, in]
    tensor}`` on the CPU, bf16 leaves in fp32."""
    nh, nkv, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_size
    out: dict[str, torch.Tensor] = {}

    def p(name, v):
        out["language_model." + name] = torch.from_numpy(np.ascontiguousarray(_np(v)))

    def put_norm(prefix, tree):
        p(prefix + ".weight", tree["scale"])
        if cfg.normalization == "layernorm":
            p(prefix + ".bias", tree["bias"])

    p("embedding.word_embeddings.weight", params["embed"]["embedding"])
    if cfg.position_embedding_type == "learned_absolute":
        p("embedding.position_embeddings.weight", params["pos_embed"]["embedding"])
    if cfg.num_tokentypes > 0:
        p("embedding.tokentype_embeddings.weight", params["tokentype_embed"]["embedding"])
    for i, lp in enumerate(params["layers"]):
        pre = f"encoder.layers.{i}."
        put_norm(pre + "input_layernorm", lp["input_norm"])
        put_norm(pre + "post_attention_layernorm", lp["post_attn_norm"])
        if cfg.transformer_block_type == "normformer":
            put_norm(pre + "post_attention_normformer_norm", lp["nf_attn_norm"])
            put_norm(pre + "mlp.normalization", lp["nf_mlp_norm"])
        q, k, v = np.split(_t(_np(lp["attn"]["qkv"]["w"])), [nh * d, (nh + nkv) * d], axis=0)
        p(pre + "self_attention.query_key_value.weight", _interleave_qkv(q, k, v, nh, nkv, d))
        p(pre + "self_attention.dense.weight", _t(_np(lp["attn"]["o"]["w"])))
        p(pre + "mlp.dense_h_to_4h.weight", _t(_np(lp["mlp"]["up"]["w"])))
        p(pre + "mlp.dense_4h_to_h.weight", _t(_np(lp["mlp"]["down"]["w"])))
        if cfg.bias:
            qb, kb, vb = np.split(_np(lp["attn"]["qkv"]["bias"]), [nh * d, (nh + nkv) * d])
            p(pre + "self_attention.query_key_value.bias", _interleave_qkv(qb, kb, vb, nh, nkv, d))
            p(pre + "self_attention.dense.bias", lp["attn"]["o"]["bias"])
            p(pre + "mlp.dense_h_to_4h.bias", lp["mlp"]["up"]["bias"])
            p(pre + "mlp.dense_4h_to_h.bias", lp["mlp"]["down"]["bias"])
    if cfg.transformer_block_type != "post_ln":
        put_norm("encoder.final_layernorm", params["final_norm"])
    if not cfg.share_embeddings_and_output_weights:
        p("output_layer.weight", _t(_np(params["lm_head"]["w"])))
    return out


# tp merge rules by key suffix, first match: the concat dim of Megatron's
# Column / RowParallelLinear shards in torch's [out, in] layout, or None
# (replicated: rank 0's); the reference's normformer mid-MLP norm is
# per-partition, so its shards concatenate along the width
_TP_AXIS: list[tuple[str, Optional[int]]] = [
    ("embedding.word_embeddings.weight", 0),
    ("embedding.position_embeddings.weight", None),
    ("self_attention.query_key_value.weight", 0),
    ("self_attention.query_key_value.bias", 0),
    ("self_attention.dense.weight", 1),
    ("self_attention.dense.bias", None),
    ("mlp.dense_h_to_4h.weight", 0),
    ("mlp.dense_h_to_4h.bias", 0),
    ("mlp.dense_4h_to_h.weight", 1),
    ("mlp.dense_4h_to_h.bias", None),
    ("output_layer.weight", 0),
    ("mlp.normalization.weight", 0),
    ("mlp.normalization.bias", 0),
    ("embedding.tokentype_embeddings.weight", None),
    ("layernorm.weight", None),
    ("layernorm.bias", None),
    ("normformer_norm.weight", None),
    ("normformer_norm.bias", None),
]


def _tp_axis_for(key: str) -> Optional[int]:
    for suffix, ax in _TP_AXIS:
        if key.endswith(suffix) or suffix in key:
            return ax
    return None  # an unknown key is taken as replicated


def _lookup(shard: Mapping[str, Any], key: str):
    return shard[key] if key in shard else shard["model." + key]


def merge_nnm_shards(shards: Mapping[tuple, Mapping[str, Any]], *, tp: int, pp: int,
                     num_layers: int, glu: bool = False) -> dict[str, torch.Tensor]:
    """``{(tp_rank, pp_rank): state dict}`` -> the full state dict (CPU
    tensors).  ``glu``: each rank's ``dense_h_to_4h`` holds ``[gate; up]``,
    merged per half so the whole stays ``[gate; up]``."""
    per_stage = num_layers // pp
    full: dict[str, torch.Tensor] = {}
    for pp_rank in range(pp):
        for key in (_norm_key(k) for k in shards[(0, pp_rank)].keys()):
            parts = [_np(_lookup(shards[(r, pp_rank)], key)) for r in range(tp)]
            ax = _tp_axis_for(key)
            if ax is None or tp == 1:
                merged = parts[0]
            elif glu and "dense_h_to_4h" in key:
                halves = [p.reshape((2, p.shape[0] // 2) + p.shape[1:]) for p in parts]
                merged = np.concatenate(halves, axis=1)
                merged = merged.reshape((-1,) + merged.shape[2:])
            else:
                merged = np.concatenate(parts, axis=ax)
            full[_offset_layer(key, pp_rank * per_stage)] = torch.from_numpy(
                np.ascontiguousarray(merged))
    return full
