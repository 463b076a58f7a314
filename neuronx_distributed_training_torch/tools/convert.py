"""Weight bridge between the JAX package's parameter tree and the port's.

The JAX tree, as numpy arrays: ``{"embed": {"embedding": [V, H]},
"layers": {... leaves stacked on a leading [L, ...] dim ...},
"final_norm": {"scale": [H]}, "lm_head": {"w": [H, V]}}`` with linear weights
``[in, out]``.  The port keeps the same names and layouts but one dict per
layer (``models/llama.py``).  LoRA leaves cross like any other: ``lora_a``
``[L, in, r]``, ``lora_b`` ``[L, r, out]`` and ``lora_scale`` ``[L]`` become
one ``[in, r]``, ``[r, out]`` and 0-d tensor per layer, and back.  This module imports neither JAX nor the JAX
package: the caller hands over ``np.asarray`` leaves.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

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


def params_from_jax(tree: dict[str, Any], *, device=None,
                    dtype: Optional[torch.dtype] = None) -> dict[str, Any]:
    """JAX parameter tree (numpy leaves) -> the port's parameter tree on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)

    def to_t(a):
        t = torch.from_numpy(np.array(a, copy=True)).to(dev)
        return t if dtype is None else t.to(dtype)

    out: dict[str, Any] = {k: _map(v, to_t) for k, v in tree.items() if k != "layers"}
    stacked = tree["layers"]
    n_layers = next(iter(_leaves(stacked))).shape[0]
    out["layers"] = [_map(stacked, lambda a, i=i: to_t(np.asarray(a)[i]))
                     for i in range(n_layers)]
    return out


def params_to_jax(params: dict[str, Any]) -> dict[str, Any]:
    """Inverse of ``params_from_jax``: numpy leaves (fp32 for bf16 tensors),
    layers stacked on a leading dim."""

    def to_np(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out: dict[str, Any] = {k: _map(v, to_np) for k, v in params.items() if k != "layers"}
    layers = [_map(lp, to_np) for lp in params["layers"]]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    out["layers"] = stack(*layers)
    return out
