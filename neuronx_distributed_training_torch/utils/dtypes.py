"""Explicit dtype policies (counterpart of the JAX package's ``utils/dtypes.py``).

Regime mapping (``precision:`` YAML block -> policy):

- ``mixed_precision``: fp32 params, bf16 compute, fp32 grad accumulation and
  optimizer state.
- ``bf16SR``: bf16 params and compute with fp32 optimizer state (stochastic
  rounding is a Trainium feature; fp32 master state is the stand-in).
- ``autocast``: bf16 compute, fp32 params.
- ``fp32``: everything fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
    "float64": torch.float64,
}


def canonical_dtype(d: Any) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        try:
            return _DTYPES[d.lower()]
        except KeyError as e:
            raise ValueError(f"unknown dtype name {d!r}") from e
    raise ValueError(f"unknown dtype {d!r}")


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Which dtype each role uses (param / compute / reduce / grad-accum /
    optimizer state / softmax and norm internals)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    reduce_dtype: torch.dtype = torch.float32
    grad_accum_dtype: torch.dtype = torch.float32
    optimizer_dtype: torch.dtype = torch.float32
    softmax_dtype: torch.dtype = torch.float32

    @classmethod
    def from_precision_config(cls, precision_cfg: Any) -> "DtypePolicy":
        """Map the ``precision:`` block (a regime name or a mapping with a
        ``type`` key and optional per-role overrides) to a policy."""
        if precision_cfg is None:
            return cls()
        if isinstance(precision_cfg, str):
            regime, extra = precision_cfg, {}
        else:
            extra = dict(precision_cfg)
            regime = extra.get("type", "mixed_precision")
        regime = str(regime).lower()
        if regime in ("mixed_precision", "mixed_precisionsr", "mixed", "autocast"):
            pol = cls(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
        elif regime in ("bf16sr", "bf16"):
            pol = cls(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
        elif regime in ("fp32", "32", "float32"):
            pol = cls(param_dtype=torch.float32, compute_dtype=torch.float32)
        else:
            raise ValueError(f"unknown precision regime {regime!r}")
        overrides = {
            k: canonical_dtype(extra[k])
            for k in ("param_dtype", "compute_dtype", "reduce_dtype",
                      "grad_accum_dtype", "optimizer_dtype", "softmax_dtype")
            if k in extra
        }
        # master_weights=False means optimizer state follows the param dtype
        if extra.get("master_weights") is False and "optimizer_dtype" not in overrides:
            overrides["optimizer_dtype"] = pol.param_dtype
        return dataclasses.replace(pol, **overrides) if overrides else pol

    def cast_to_compute(self, tree):
        """Cast the floating tensors of a (nested dict / list) tree to the
        compute dtype."""
        if isinstance(tree, torch.Tensor):
            return tree.to(self.compute_dtype) if tree.is_floating_point() else tree
        if isinstance(tree, dict):
            return {k: self.cast_to_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_to_compute(v) for v in tree)
        return tree
