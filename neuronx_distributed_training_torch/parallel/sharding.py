"""Tensor-parallel layouts of the parameter leaves (counterpart of the JAX
package's ``models/llama.py::param_specs``, ``peft/lora.py::lora_param_specs``
and ``parallel/sharding.py::seq_axes``).

Each dotted leaf name (``models/llama.py::named_params``) has a
:class:`LeafLayout`:

- ``dim``: the dim the ``model`` axis shards, or None (replicated).  Column
  layers (``qkv``, ``q``/``k``/``v``, ``gate_up``, ``lm_head``) shard their
  output dim 1, row layers (``o``, ``down``) their input dim 0, the
  embedding its vocab dim 0: JAX's ``P(None, "model")``, ``P("model",
  None)`` and ``P("model", None)``.  LoRA's ``lora_a`` takes the base
  weight's input layout and ``lora_b`` its output layout, as in
  ``lora_param_specs``;
- ``segments``: for the fused leaves, ``(name, global size)`` of each part
  along ``dim``.  JAX's ``qkv.w`` is ``[h, (nh + 2 nkv) d]`` laid out
  ``[all q | all k | all v]`` and ``gate_up.w`` is ``[gate | up]``; a
  Megatron rank needs its heads of each part, so rank ``r`` holds
  ``[q_r | k_r | v_r]`` (and ``[gate_r | up_r]``, NxD's
  ``ColumnParallel(stride=2)``): the concatenation of each segment's ``r``-th
  slice, not the ``r``-th slice of the whole.  Conversion and checkpoints
  go through the segments (:func:`split_segments`), so the global layout of
  every saved tensor is JAX's whatever the tp;
- ``partial``: the leaf is replicated but each rank's gradient is a partial
  sum over the tp group, which the train step all-reduces: the norm scales
  under sequence parallelism (each rank normalises a slice of the
  sequence), LoRA's ``lora_a`` on column layers and ``lora_b`` on row
  layers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

#: layers whose output dim is sharded (and their LoRA ``lora_b``)
COLUMN = ("qkv", "q", "k", "v", "gate_up")
#: layers whose input dim is sharded (and their LoRA ``lora_a``)
ROW = ("o", "down")


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    dim: Optional[int] = None
    segments: tuple = ()  # ((name, global size along dim), ...) of a fused leaf
    partial: bool = False

    @property
    def sharded(self) -> bool:
        return self.dim is not None


REPLICATED = LeafLayout()


def fused_segments(cfg, module: str) -> tuple:
    """``(name, global size)`` of a fused layer's output parts."""
    d, nh, nkv = cfg.head_size, cfg.num_attention_heads, cfg.kv_heads
    if module == "qkv":
        return (("q", nh * d), ("k", nkv * d), ("v", nkv * d))
    if module == "gate_up":
        return (("gate", cfg.intermediate_size), ("up", cfg.intermediate_size))
    return ()


def leaf_layout(name: str, cfg, *, sequence_parallel: bool = False) -> LeafLayout:
    """The layout of one dotted leaf name (``cfg``: ``models/llama.py::
    LlamaConfig``, for the fused segments)."""
    parts = name.split(".")
    leaf, module = parts[-1], parts[-2] if len(parts) > 1 else ""
    if name == "embed.embedding":
        return LeafLayout(dim=0)
    if name == "lm_head.w":
        return LeafLayout(dim=1)
    if module in COLUMN:
        if leaf in ("w", "lora_b"):
            return LeafLayout(dim=1, segments=fused_segments(cfg, module))
        if leaf == "lora_a":
            return LeafLayout(partial=True)
    if module in ROW:
        if leaf in ("w", "lora_a"):
            return LeafLayout(dim=0)
        if leaf == "lora_b":
            return LeafLayout(partial=True)
    if leaf == "scale" and module.endswith("norm"):
        # under SP the norms see a seq shard (JAX's ``seq_axes``), so their
        # gradient is a partial sum over tp (a partial sum over context, as
        # every leaf's is under cp, is the train step's (data, context) sum)
        return LeafLayout(partial=bool(sequence_parallel))
    return REPLICATED


def leaf_layouts(names, cfg, *, sequence_parallel: bool = False) -> dict[str, LeafLayout]:
    return {n: leaf_layout(n, cfg, sequence_parallel=sequence_parallel) for n in names}


def _narrow(t, dim: int, start: int, length: int):
    """``t.narrow`` for a torch tensor or a numpy array (a view)."""
    if isinstance(t, torch.Tensor):
        return t.narrow(dim, start, length)
    index = [slice(None)] * t.ndim
    index[dim] = slice(start, start + length)
    return t[tuple(index)]


def split_segments(t, layout: LeafLayout, size: int) -> list[tuple[str, Any]]:
    """``(segment name, view)`` of each segment of a rank's local tensor
    ``t`` (``[("", t)]`` for a leaf with no segments)."""
    if not layout.segments:
        return [("", t)]
    out, start = [], 0
    for seg, n in layout.segments:
        out.append((seg, _narrow(t, layout.dim, start, n // size)))
        start += n // size
    return out


def shard_leaf(full, layout: LeafLayout, rank: int, size: int):
    """Rank ``rank``'s local tensor of the global leaf ``full`` (torch or
    numpy): a new contiguous tensor, or ``full`` itself at ``size == 1`` and
    for a replicated leaf."""
    if size == 1 or not layout.sharded:
        return full
    dim = layout.dim
    lengths = [n for _, n in layout.segments] or [full.shape[dim]]
    out, start = [], 0
    for n in lengths:
        if n % size:
            raise ValueError(f"dim {dim} part of {n} not divisible by tp {size}")
        out.append(_narrow(full, dim, start + rank * (n // size), n // size))
        start += n
    if isinstance(full, torch.Tensor):
        return torch.cat(out, dim=dim)
    import numpy as np

    return np.ascontiguousarray(np.concatenate(out, axis=dim))


def merge_leaf(parts: list, layout: LeafLayout) -> Any:
    """The global leaf from every rank's local tensor, in rank order (the
    inverse of :func:`shard_leaf`; torch tensors or numpy arrays)."""
    if len(parts) == 1 or not layout.sharded:
        return parts[0]
    size, dim = len(parts), layout.dim
    segs = [[x for _, x in split_segments(p, layout, size)] for p in parts]
    cols = [segs[r][i] for i in range(len(segs[0])) for r in range(size)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(cols, dim=dim)
    import numpy as np

    return np.concatenate(cols, axis=dim)
