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
