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
segment, so rank r holds ``[q_r | k_r | v_r]``), and ``params_to_jax``
merges the list of every rank's local tree back into JAX's global leaves.
Both need the model's ``LlamaConfig`` for the segments.  This module imports
neither JAX nor the JAX package: the caller hands over ``np.asarray`` leaves.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from neuronx_distributed_training_torch.models.llama import named_params
from neuronx_distributed_training_torch.parallel import sharding
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


def params_from_jax(tree: dict[str, Any], *, device=None, dtype: Optional[torch.dtype] = None,
                    cfg=None, tp_rank: int = 0, tp_size: int = 1) -> dict[str, Any]:
    """JAX parameter tree (numpy leaves) -> the port's parameter tree on
    ``device`` (the card unless the caller asks for the CPU); at ``tp_size >
    1``, rank ``tp_rank``'s slices (``cfg``: the ``LlamaConfig``)."""
    dev = resolve_device(device)
    if tp_size > 1 and cfg is None:
        raise ValueError("a tensor-parallel conversion needs the model's LlamaConfig")

    def to_t(name, a):
        if tp_size > 1:
            a = sharding.shard_leaf(np.asarray(a), sharding.leaf_layout(name, cfg),
                                    tp_rank, tp_size)
        t = torch.from_numpy(np.array(a, copy=True)).to(dev)
        return t if dtype is None else t.to(dtype)

    out: dict[str, Any] = {k: _map_named(v, to_t, f"{k}.") for k, v in tree.items()
                           if k != "layers"}
    stacked = tree["layers"]
    n_layers = next(iter(_leaves(stacked))).shape[0]
    out["layers"] = [_map_named(stacked, lambda n, a, i=i: to_t(n, np.asarray(a)[i]),
                                f"layers.{i}.") for i in range(n_layers)]
    return out


def params_to_jax(params, cfg=None) -> dict[str, Any]:
    """Inverse of ``params_from_jax``: numpy leaves (fp32 for bf16 tensors),
    layers stacked on a leading dim.  ``params`` is one tree, or the list of
    every tp rank's local tree in rank order, which are merged (``cfg``:
    the ``LlamaConfig``)."""
    ranks = params if isinstance(params, (list, tuple)) else [params]
    if len(ranks) > 1 and cfg is None:
        raise ValueError("merging tensor-parallel trees needs the model's LlamaConfig")

    def to_np(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    flats = [named_params(p) for p in ranks]

    def merged(name, _):
        parts = [to_np(f[name]) for f in flats]
        return parts[0] if len(parts) == 1 else sharding.merge_leaf(
            parts, sharding.leaf_layout(name, cfg))

    params = ranks[0]
    out: dict[str, Any] = {k: _map_named(v, merged, f"{k}.") for k, v in params.items()
                           if k != "layers"}
    layers = [_map_named(lp, merged, f"layers.{i}.") for i, lp in enumerate(params["layers"])]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    out["layers"] = stack(*layers)
    return out
