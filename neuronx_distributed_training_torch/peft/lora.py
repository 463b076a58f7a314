"""LoRA as a transform of the parameter tree (counterpart of the JAX package's
``peft/lora.py``).

- ``add_lora`` puts ``lora_a [in, r]``, ``lora_b [r, out]`` and
  ``lora_scale`` (alpha / r, an fp32 scalar) beside the ``w`` of every linear
  dict whose key is a target module; ``ops/linear.py::apply_linear`` adds the
  adapter term, so no model code changes;
- ``trainable_mask`` names the adapter leaves trainable and everything else
  frozen.  The trainer gives ``requires_grad`` only to trainable leaves, and
  the optimizer holds no state for the frozen ones (``trainer/step.py``);
- ``merge_lora`` folds ``w + (a @ b) * scale`` back into the base weight.

``dropout`` is parsed from ``lora_dropout`` and applied nowhere, as in the JAX
package.  The adapters' TP layouts (the JAX ``lora_param_specs``) are in
``parallel/sharding.py``: on a column layer (``qkv``, ``gate_up``) A is
replicated and B holds the rank's output columns, by segment; on a row layer
(``o``, ``down``) A holds the rank's input rows and B is replicated.  The
replicated factor's gradient is a partial sum over tp, which the train step
all-reduces.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from neuronx_distributed_training_torch.parallel.sharding import ROW

# the reference's target-module names, without the ``_proj`` suffix
DEFAULT_TARGETS = ("qkv", "q", "k", "v", "o", "gate_up", "down")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """The ``model.lora`` block."""

    rank: int = 16
    alpha: float = 32.0
    dropout: float = 0.0  # parsed, not applied (nor by the JAX package)
    target_modules: tuple = DEFAULT_TARGETS

    @classmethod
    def from_config(cls, lora_cfg: dict[str, Any]) -> "LoraConfig":
        c = dict(lora_cfg or {})
        targets = c.get("target_modules")
        return cls(
            rank=int(c.get("lora_rank", c.get("rank", 16))),
            alpha=float(c.get("lora_alpha", c.get("alpha", 32.0))),
            dropout=float(c.get("lora_dropout", c.get("dropout", 0.0))),
            target_modules=tuple(t.replace("_proj", "") for t in targets)
            if targets else DEFAULT_TARGETS,
        )

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _is_linear(v) -> bool:
    return isinstance(v, dict) and isinstance(v.get("w"), torch.Tensor) and v["w"].ndim >= 2


def add_lora(params: Any, cfg: LoraConfig, generator: torch.Generator, *, tp_rank: int = 0,
             tp_size: int = 1) -> Any:
    """The tree with adapters beside every target linear's ``w``: A is 0.02
    times a normal truncated at +-2, drawn from ``generator`` in tree order
    (the trainer seeds it with ``seed + 1``, as the JAX trainer keys its
    draw), B is zeros, so the adapted model starts as the base model.  The
    base tensors are shared, not copied.  Under tensor parallelism ``params``
    holds the rank's slices: A is drawn whole and a row layer's keeps the
    rank's rows, so every tp draws the same numbers."""

    def visit(node):
        if isinstance(node, list):
            return [visit(v) for v in node]
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k in cfg.target_modules and _is_linear(v):
                w = v["w"]
                in_dim, out_dim = w.shape[-2:]
                row = k in ROW and tp_size > 1
                a = torch.empty((in_dim * tp_size if row else in_dim, cfg.rank),
                                dtype=torch.float32, device=w.device)
                torch.nn.init.trunc_normal_(a, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                            generator=generator)
                if row:
                    a = a[tp_rank * in_dim:(tp_rank + 1) * in_dim]
                out[k] = {**v,
                          "lora_a": (0.02 * a).to(w.dtype),
                          "lora_b": torch.zeros((cfg.rank, out_dim), dtype=w.dtype,
                                                device=w.device),
                          "lora_scale": torch.tensor(cfg.scale, dtype=torch.float32,
                                                     device=w.device)}
            else:
                out[k] = visit(v)
        return out

    return visit(params)


def trainable_mask(named: dict[str, torch.Tensor]) -> dict[str, float]:
    """1.0 for the adapters' A and B leaves, 0.0 elsewhere, over
    ``models.llama.named_params`` names.  ``lora_scale`` stays frozen: it is
    the configured alpha / r, not a learned parameter."""
    return {n: 1.0 if {"lora_a", "lora_b"} & set(n.split(".")) else 0.0 for n in named}


@torch.no_grad()
def merge_lora(params: Any) -> Any:
    """The tree with every adapter folded into its base weight (in fp32, then
    the weight's dtype) and the adapter leaves removed."""

    def visit(node):
        if isinstance(node, list):
            return [visit(v) for v in node]
        if not isinstance(node, dict):
            return node
        if "lora_a" in node and "w" in node:
            w = node["w"]
            delta = (node["lora_a"].float() @ node["lora_b"].float()) * node["lora_scale"].float()
            merged = {k: v for k, v in node.items() if not k.startswith("lora_")}
            merged["w"] = (w.float() + delta).to(w.dtype)
            return merged
        return {k: visit(v) for k, v in node.items()}

    return visit(params)
