"""Weight bridge between the JAX package's parameter tree and the port's.

The JAX tree, as numpy arrays: ``{"embed": {"embedding": [V, H]},
"layers": {... leaves stacked on a leading [L, ...] dim ...},
"final_norm": {"scale": [H]}, "lm_head": {"w": [H, V]}}`` with linear weights
``[in, out]``.  The port keeps the same names and layouts but one dict per
layer (``models/llama.py``).  LoRA leaves cross like any other: ``lora_a``
``[L, in, r]``, ``lora_b`` ``[L, r, out]`` and ``lora_scale`` ``[L]`` become
one ``[in, r]``, ``[r, out]`` and 0-d tensor per layer, and back.

Under tensor parallelism (``tp_size > 1``) ``params_from_jax`` gives rank
``tp_rank``'s local tree (``parallel/sharding.py``: fused leaves are cut by
segment, so rank r holds ``[q_r | k_r | v_r]``; above the kv heads its k and
v parts are the one head it shares with ``tp/nkv`` ranks; a vocab tp does
not divide is padded with zero rows to ``ceil(V/tp)`` a rank), and
``params_to_jax`` merges the list of every rank's local tree back into JAX's
global leaves (one replica of each kv head, the real vocab rows).
Both need the model's config (``LlamaConfig``, ``MixtralConfig`` or
``GPTConfig``) for the segments.  Under pipeline
parallelism ``params_from_jax`` gives one rank's tree (the layers of its
chunks; None for the other ranks'), and ``params_to_jax`` merges the ranks
back (:func:`merge_stages`).  At ``vp > 1`` the JAX tree's layers are the
JAX trainer's interleaved ``[vp, pp, Lc, ...]`` stack
(``parallel/pipeline.py::to_interleaved``) on both sides.  This module imports
neither JAX nor the JAX package: the caller hands over ``np.asarray`` leaves.

Mixtral (``models/mixtral.py``): the router and the expert stacks cross like
any leaf (``[L, h, E]``, ``[L, E, h, 2 ffn]``, ``[L, E, ffn, h]``); under
expert parallelism (``ep_size > 1``) a rank keeps its ``E / ep`` experts
and ``params_to_jax`` concatenates them back.  JAX's ``moe_frequency > 1``
layout, ``mlp = {"moe": [G, ...], "dense": [G, f-1, ...]}`` beside the flat
``[L, ...]`` attention and norm leaves, becomes the port's one ``mlp`` per
layer (layer ``i`` is MoE iff ``i % f == 0``) and back; under the virtual
pipeline its ``[vp, pp, Gc, ...]`` interleave is undone leaf by leaf first,
as JAX's ``deinterleave_layers`` does.

GPT (``models/gpt.py``): the same rules, with GPT's names (``mlp.up``,
biases, LayerNorm ``bias``, ``pos_embed``, ``tokentype_embed``, the
normformer norms) and its config (``GPTConfig``, for the segments: q / k / v
of ``qkv``, gate / up of a glu ``up``); JAX's GPT-MoE groups cross as
Mixtral's.  ``tools/convert_megatron.py`` maps Megatron state dicts to the
same tree.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from neuronx_distributed_training_torch.models.llama import named_params
from neuronx_distributed_training_torch.ops.moe import is_moe_mlp
from neuronx_distributed_training_torch.parallel import sharding
from neuronx_distributed_training_torch.parallel.pipeline import stage_layers
from neuronx_distributed_training_torch.utils.device import resolve_device


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map_named(tree, fn, prefix: str = ""):
    """``_map`` with the leaf's dotted name (``named_params``'s) passed too."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, f"{prefix}{k}.") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def _layer_of(stacked: dict, i: int, n_layers: int) -> dict:
    """Layer ``i``'s leaves of JAX's stacked layers (flat ``[L, ...]``, or
    MoE-grouped ``mlp``)."""
    def at(tree, *index):
        return _map(tree, lambda a: np.asarray(a)[index])

    mlp = stacked.get("mlp", {})
    if "moe" not in mlp:
        return at(stacked, i)
    out = {k: at(v, i) for k, v in stacked.items() if k != "mlp"}
    f = n_layers // next(iter(_leaves(mlp["moe"]))).shape[0]
    g, j = divmod(i, f)
    out["mlp"] = at(mlp["moe"], g) if j == 0 else at(mlp["dense"], g, j - 1)
    return out


def params_from_jax(tree: dict[str, Any], *, device=None, dtype: Optional[torch.dtype] = None,
                    cfg=None, tp_rank: int = 0, tp_size: int = 1, pp_rank: int = 0,
                    pp_size: int = 1, vp: int = 1, ep_rank: int = 0,
                    ep_size: int = 1) -> dict[str, Any]:
    """JAX parameter tree (numpy leaves) -> the port's parameter tree on
    ``device`` (the card unless the caller asks for the CPU); at ``tp_size >
    1``, rank ``tp_rank``'s slices (``cfg``: the ``LlamaConfig``); at
    ``pp_size > 1``, pipeline rank ``pp_rank``'s tree: the layers of its
    ``vp`` chunks, None for the other ranks', and the replicated embedding,
    final norm and head; at ``ep_size > 1``, expert rank ``ep_rank``'s
    experts.  At ``vp > 1`` the tree's layers are stacked ``[vp, pp, Lc,
    ...]``."""
    dev = resolve_device(device)
    if tp_size > 1 and cfg is None:
        raise ValueError("a tensor-parallel conversion needs the model's LlamaConfig")

    def to_t(name, a):
        if tp_size > 1 or ep_size > 1:
            layout = sharding.leaf_layout(name, cfg) if cfg is not None else (
                sharding.LeafLayout(expert=".experts." in name))
            a = sharding.local_leaf(np.asarray(a), layout, tp_rank, tp_size, ep_rank, ep_size)
        t = torch.from_numpy(np.array(a, copy=True)).to(dev)
        return t if dtype is None else t.to(dtype)

    out: dict[str, Any] = {k: _map_named(v, to_t, f"{k}.") for k, v in tree.items()
                           if k != "layers"}
    stacked = tree["layers"]
    if vp > 1:
        stacked = _map(stacked, lambda a: np.asarray(a).reshape((-1,) + np.shape(a)[3:]))
    n_layers = next(iter(_leaves(stacked["input_norm"]))).shape[0]
    mine = set(stage_layers(n_layers, pp_rank, pp_size, vp))
    out["layers"] = [_map_named(_layer_of(stacked, i, n_layers), to_t, f"layers.{i}.")
                     if i in mine else None for i in range(n_layers)]
    return out


def merge_stages(stages: list) -> dict[str, Any]:
    """One tree from every pipeline stage's (in stage order): each layer
    from the stage that holds it, the replicated leaves from stage 0."""
    out = dict(stages[0])
    out["layers"] = [next(s["layers"][i] for s in stages if s["layers"][i] is not None)
                     for i in range(len(stages[0]["layers"]))]
    return out


def _stack(*xs):
    if isinstance(xs[0], dict):
        return {k: _stack(*(x[k] for x in xs)) for k in xs[0]}
    return np.stack(xs)


def _stack_layers(layers: list) -> dict:
    """The port's per-layer dicts stacked as JAX's ``layers``: flat
    ``[L, ...]``, or, when only every ``f``-th layer is MoE, the attention
    and norm leaves flat and ``mlp`` grouped ``{"moe": [G], "dense": [G,
    f-1]}``."""
    moe = [i for i, lp in enumerate(layers) if is_moe_mlp(lp["mlp"])]
    if not moe or len(moe) == len(layers):
        return _stack(*layers)
    f = len(layers) // len(moe)
    out = _stack(*({k: v for k, v in lp.items() if k != "mlp"} for lp in layers))
    groups = range(len(moe))
    out["mlp"] = {"moe": _stack(*(layers[g * f]["mlp"] for g in groups)),
                  "dense": _stack(*(_stack(*(layers[g * f + j]["mlp"] for j in range(1, f)))
                                    for g in groups))}
    return out


def params_to_jax(params, cfg=None, *, pp_size: int = 1, vp: int = 1,
                  ep_size: int = 1) -> dict[str, Any]:
    """Inverse of ``params_from_jax``: numpy leaves (fp32 for bf16 tensors),
    layers stacked on a leading dim.  ``params`` is one tree, or the list of
    every tp rank's local tree in rank order, which are merged (``cfg``:
    the ``LlamaConfig``); at ``pp_size > 1`` the list of every rank's tree,
    stage-major (stage ``i // tp``, tp rank ``i % tp``); at ``ep_size > 1``
    expert-major within a stage (rank ``(stage ep + expert) tp + tp
    rank``), the expert leaves concatenated over ``expert``.  At ``vp > 1``
    the layers come back stacked ``[vp, pp, Lc, ...]``, the JAX trainer's
    interleaved layout."""
    ranks = params if isinstance(params, (list, tuple)) else [params]
    tp = len(ranks) // (pp_size * ep_size)
    if pp_size > 1:
        ranks = [merge_stages(ranks[i::ep_size * tp]) for i in range(ep_size * tp)]
    if len(ranks) > 1 and cfg is None:
        raise ValueError("merging tensor-parallel trees needs the model's LlamaConfig")

    def to_np(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    flats = [named_params(p) for p in ranks]

    def merged(name, _):
        layout = sharding.leaf_layout(name, cfg) if len(flats) > 1 else None
        per_ep = []
        for e in range(ep_size if layout is not None and layout.expert else 1):
            parts = [to_np(f[name]) for f in flats[e * tp:(e + 1) * tp]]
            per_ep.append(parts[0] if len(parts) == 1 else sharding.merge_leaf(parts, layout))
        return per_ep[0] if len(per_ep) == 1 else np.concatenate(per_ep, axis=0)

    params = ranks[0]
    out: dict[str, Any] = {k: _map_named(v, merged, f"{k}.") for k, v in params.items()
                           if k != "layers"}
    out["layers"] = _stack_layers([_map_named(lp, merged, f"layers.{i}.")
                                   for i, lp in enumerate(params["layers"])])
    if vp > 1:
        out["layers"] = _map(out["layers"], lambda a: a.reshape(
            (vp, pp_size, a.shape[0] // (vp * pp_size)) + a.shape[1:]))
    return out


# -- HF checkpoints (the JAX package's tools/convert.py, to the port's tree) --
#
# HF Llama -> the port's tree (one dict per layer, weights [in, out]):
#   model.embed_tokens.weight [V,H]            -> embed.embedding [V,H]
#   layers.i.self_attn.{q,k,v}_proj.weight     -> layers[i].attn.qkv.w [H,(nh+2kv)d]
#   layers.i.self_attn.o_proj.weight [H,H]     -> layers[i].attn.o.w [H,H] (T)
#   layers.i.mlp.{gate,up}_proj.weight         -> layers[i].mlp.gate_up.w [H,2F] (T, fused)
#   layers.i.mlp.down_proj.weight [H,F]        -> layers[i].mlp.down.w [F,H] (T)
#   layers.i.{input,post_attention}_layernorm  -> layers[i].{input,post_attn}_norm.scale
#   model.norm.weight                          -> final_norm.scale
#   lm_head.weight [V,H]                       -> lm_head.w [H,V] (T)
# Mixtral adds block_sparse_moe.gate.weight -> mlp.router.w and the experts'
# w1 / w3 stacked and fused -> mlp.experts.gate_up [E,H,2F], w2 ->
# mlp.experts.down [E,F,H]; at moe_frequency f > 1 layer i is MoE iff
# i % f == 0 and the others carry the Llama mlp names.  The tensors keep
# their dtype (a bf16 HF checkpoint stays bf16; a restore casts to the
# run's dtype), and the values cross bit for bit.


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, copy=True))


def _tt(x) -> torch.Tensor:
    return _tensor(x).t().contiguous()


def deinterleave_layers(params: dict[str, Any], num_layers: int, moe_frequency: int = 1,
                        layout: Optional[str] = None) -> dict[str, Any]:
    """The JAX package's ``deinterleave_layers``: a tree whose ``layers``
    are JAX's stacked leaves (numpy or torch) with a pipeline-interleaved
    ``[vp, pp, Lc, ...]`` stack flattened back to ``[L, ...]`` (grouped
    MoE leaves to their group count ``L / f``).  ``layout`` ("flat" |
    "interleaved") is authoritative when known; otherwise a leaf whose
    first three dims multiply to the expected count is interleaved.  The
    port's own tree (a list of layers) needs none of this."""
    if layout == "flat":
        return dict(params)
    if layout not in (None, "interleaved"):
        raise ValueError(f"unknown layer layout {layout!r} (flat|interleaved)")

    def flat(x, expect: int):
        if (x.ndim >= 3 and x.shape[0] != expect
                and x.shape[0] * x.shape[1] * x.shape[2] == expect):
            return x.reshape((expect,) + tuple(x.shape[3:]))
        if layout == "interleaved" and x.shape[0] != expect:
            raise ValueError(
                f"checkpoint meta says layer_layout=interleaved but a leaf "
                f"of shape {tuple(x.shape)} cannot flatten to {expect} layers"
            )
        return x

    def visit(tree, expect: int):
        result = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                if k == "mlp" and ("moe" in v or "dense" in v):
                    g = num_layers // moe_frequency
                    result[k] = {kk: visit(vv, g) for kk, vv in v.items()}
                else:
                    result[k] = visit(v, expect)
            else:
                result[k] = flat(v, expect)
        return result

    out = dict(params)
    out["layers"] = visit(dict(params["layers"]), num_layers)
    return out


def _port_layers(params: dict[str, Any], n_layers: int, moe_frequency: int,
                 layer_layout: Optional[str]) -> list:
    """The per-layer dicts of ``params``: the port's list as it is, or
    JAX's stacked ``layers`` (flat, interleaved or MoE-grouped) unstacked."""
    if isinstance(params["layers"], (list, tuple)):
        return list(params["layers"])
    stacked = deinterleave_layers(params, n_layers, moe_frequency, layout=layer_layout)["layers"]
    return [_map(_layer_of(stacked, i, n_layers), _tensor) for i in range(n_layers)]


def _attn_from_hf(g, pre: str) -> dict:
    qkv = torch.cat([_tt(g(pre + "self_attn.q_proj.weight")),
                     _tt(g(pre + "self_attn.k_proj.weight")),
                     _tt(g(pre + "self_attn.v_proj.weight"))], dim=1)
    return {"input_norm": {"scale": g(pre + "input_layernorm.weight")},
            "post_attn_norm": {"scale": g(pre + "post_attention_layernorm.weight")},
            "attn": {"qkv": {"w": qkv}, "o": {"w": _tt(g(pre + "self_attn.o_proj.weight"))}}}


def _dense_mlp_from_hf(g, pre: str) -> dict:
    return {"gate_up": {"w": torch.cat([_tt(g(pre + "mlp.gate_proj.weight")),
                                        _tt(g(pre + "mlp.up_proj.weight"))], dim=1)},
            "down": {"w": _tt(g(pre + "mlp.down_proj.weight"))}}


def _moe_mlp_from_hf(g, pre: str, e: int) -> dict:
    gate_up = torch.stack([torch.cat([_tt(g(pre + f"block_sparse_moe.experts.{j}.w1.weight")),
                                      _tt(g(pre + f"block_sparse_moe.experts.{j}.w3.weight"))],
                                     dim=1) for j in range(e)])
    down = torch.stack([_tt(g(pre + f"block_sparse_moe.experts.{j}.w2.weight"))
                        for j in range(e)])
    return {"router": {"w": _tt(g(pre + "block_sparse_moe.gate.weight"))},
            "experts": {"gate_up": gate_up, "down": down}}


def _outer_from_hf(state, g, tie: bool, layers: list, device) -> dict[str, Any]:
    params: dict[str, Any] = {"embed": {"embedding": g("model.embed_tokens.weight")},
                              "layers": layers, "final_norm": {"scale": g("model.norm.weight")}}
    if not tie:
        head = state.get("lm_head.weight", state["model.embed_tokens.weight"])
        params["lm_head"] = {"w": _tt(head)}
    dev = resolve_device(device)
    return {k: [_map(lp, lambda t: t.to(dev)) for lp in v] if k == "layers"
            else _map(v, lambda t: t.to(dev)) for k, v in params.items()}


def hf_llama_to_native(state, cfg, *, device=None) -> dict[str, Any]:
    """HF Llama state dict (name -> tensor or array) -> the port's tree on
    ``device`` (the card unless the caller asks for the CPU); ``cfg`` a
    ``models/llama.py::LlamaConfig``.  Equals ``params_from_jax`` of the
    JAX package's ``hf_llama_to_native`` bit for bit."""
    g = lambda name: _tensor(state[name])
    layers = [{**_attn_from_hf(g, f"model.layers.{i}."),
               "mlp": _dense_mlp_from_hf(g, f"model.layers.{i}.")}
              for i in range(cfg.num_layers)]
    return _outer_from_hf(state, g, cfg.tie_word_embeddings, layers, device)


def hf_mixtral_to_native(state, cfg, *, device=None) -> dict[str, Any]:
    """HF Mixtral state dict -> the port's tree (``cfg``: ``models/
    mixtral.py::MixtralConfig``; at ``moe_frequency`` f > 1 only every f-th
    layer is MoE, the others dense with the Llama names).  Equals
    ``params_from_jax`` of the JAX package's ``hf_mixtral_to_native``."""
    lc, e, f = cfg.llama, cfg.moe.num_experts, getattr(cfg, "moe_frequency", 1)
    g = lambda name: _tensor(state[name])
    layers = []
    for i in range(lc.num_layers):
        pre = f"model.layers.{i}."
        mlp = _moe_mlp_from_hf(g, pre, e) if i % f == 0 else _dense_mlp_from_hf(g, pre)
        layers.append({**_attn_from_hf(g, pre), "mlp": mlp})
    return _outer_from_hf(state, g, lc.tie_word_embeddings, layers, device)


def _hf_outer(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    out = {"model.embed_tokens.weight": _tensor(params["embed"]["embedding"]).contiguous(),
           "model.norm.weight": _tensor(params["final_norm"]["scale"]).contiguous()}
    if "lm_head" in params:  # tied checkpoints simply have no head tensor
        out["lm_head.weight"] = _tt(params["lm_head"]["w"])
    return out


def _hf_attn(out: dict, pre: str, lp: dict, lc) -> None:
    nh, nkv, d = lc.num_attention_heads, lc.kv_heads, lc.head_size
    q, k, v = torch.split(_tensor(lp["attn"]["qkv"]["w"]), [nh * d, nkv * d, nkv * d], dim=1)
    out[pre + "self_attn.q_proj.weight"] = _tt(q)
    out[pre + "self_attn.k_proj.weight"] = _tt(k)
    out[pre + "self_attn.v_proj.weight"] = _tt(v)
    out[pre + "self_attn.o_proj.weight"] = _tt(lp["attn"]["o"]["w"])
    out[pre + "input_layernorm.weight"] = _tensor(lp["input_norm"]["scale"]).contiguous()
    out[pre + "post_attention_layernorm.weight"] = _tensor(
        lp["post_attn_norm"]["scale"]).contiguous()


def _hf_dense(out: dict, pre: str, mlp: dict) -> None:
    gate, up = torch.chunk(_tensor(mlp["gate_up"]["w"]), 2, dim=1)
    out[pre + "mlp.gate_proj.weight"] = _tt(gate)
    out[pre + "mlp.up_proj.weight"] = _tt(up)
    out[pre + "mlp.down_proj.weight"] = _tt(mlp["down"]["w"])


def _hf_moe(out: dict, pre: str, mlp: dict, e: int, ffn: int) -> None:
    out[pre + "block_sparse_moe.gate.weight"] = _tt(mlp["router"]["w"])
    gate_up, down = _tensor(mlp["experts"]["gate_up"]), _tensor(mlp["experts"]["down"])
    for j in range(e):
        w1, w3 = torch.split(gate_up[j], [ffn, gate_up.shape[-1] - ffn], dim=1)
        out[pre + f"block_sparse_moe.experts.{j}.w1.weight"] = _tt(w1)
        out[pre + f"block_sparse_moe.experts.{j}.w3.weight"] = _tt(w3)
        out[pre + f"block_sparse_moe.experts.{j}.w2.weight"] = _tt(down[j])


def native_to_hf_llama(params: dict[str, Any], cfg,
                       layer_layout: Optional[str] = None) -> dict[str, torch.Tensor]:
    """The port's tree (or JAX's stacked tree, flat or vp-interleaved: pass
    the checkpoint's ``layer_layout`` when known) -> HF Llama state dict of
    contiguous tensors, on the tree's device and in its dtype."""
    out = _hf_outer(params)
    for i, lp in enumerate(_port_layers(params, cfg.num_layers, 1, layer_layout)):
        pre = f"model.layers.{i}."
        _hf_attn(out, pre, lp, cfg)
        _hf_dense(out, pre, lp["mlp"])
    return out


def native_to_hf_mixtral(params: dict[str, Any], cfg,
                         layer_layout: Optional[str] = None) -> dict[str, torch.Tensor]:
    """Inverse of :func:`hf_mixtral_to_native` (JAX's stacked tree too,
    MoE-grouped at ``moe_frequency`` > 1 and vp-interleaved)."""
    lc, e = cfg.llama, cfg.moe.num_experts
    out = _hf_outer(params)
    layers = _port_layers(params, lc.num_layers, getattr(cfg, "moe_frequency", 1), layer_layout)
    for i, lp in enumerate(layers):
        pre = f"model.layers.{i}."
        _hf_attn(out, pre, lp, lc)
        if is_moe_mlp(lp["mlp"]):
            _hf_moe(out, pre, lp["mlp"], e, lc.intermediate_size)
        else:
            _hf_dense(out, pre, lp["mlp"])
    return out


def load_torch_state_dict(path) -> dict[str, torch.Tensor]:
    """An HF checkpoint dir or file as CPU tensors: ``pytorch_model*.bin``
    through ``torch.load(weights_only=True)``, ``*.safetensors`` through the
    ``safetensors`` package, which a machine without it cannot read (the
    error names the file and the package; nothing is skipped)."""
    from pathlib import Path

    p = Path(path)
    if p.is_dir():
        files = sorted(p.glob("*.safetensors")) or sorted(p.glob("pytorch_model*.bin"))
        if not files:
            raise FileNotFoundError(f"no safetensors/bin files under {p}")
    else:
        files = [p]
    state: dict[str, torch.Tensor] = {}
    for f in files:
        if f.suffix == ".safetensors":
            try:
                from safetensors.torch import load_file
            except ImportError as e:
                raise ImportError(f"{f}: reading a .safetensors file needs the safetensors "
                                  f"package, which is not installed") from e
            state.update(load_file(str(f)))
        else:
            state.update(torch.load(str(f), map_location="cpu", weights_only=True))
    return state
