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
- ``parts``: the :class:`Part` s laid end to end along ``dim``: one for a
  plain leaf, one per segment for the fused ones.  JAX's ``qkv.w`` is
  ``[h, (nh + 2 nkv) d]`` laid out ``[all q | all k | all v]`` and
  ``gate_up.w`` is ``[gate | up]``; a Megatron rank needs its heads of each
  part, so rank ``r`` holds ``[q_r | k_r | v_r]`` (and ``[gate_r | up_r]``,
  NxD's ``ColumnParallel(stride=2)``): the concatenation of each part's
  ``r``-th piece, not the ``r``-th slice of the whole.  Conversion and
  checkpoints go through the parts (:func:`split_segments`), so the global
  layout of every saved tensor is JAX's whatever the tp;
- ``partial``: the leaf is replicated but each rank's gradient is a partial
  sum over the tp group, which the train step all-reduces: the norm scales
  under sequence parallelism (each rank normalises a slice of the
  sequence), LoRA's ``lora_a`` on column layers and ``lora_b`` on row
  layers.

Two kinds of part need no tp that divides them, as GSPMD needs none in the
JAX package:

- **replicated kv heads** (the ``k`` and ``v`` parts, of ``qkv`` or
  unfused): at tp above the kv heads each head sits on ``tp / nkv``
  consecutive ranks, rank ``r`` holding head ``r // (tp / nkv)``, which its
  q heads ``r nh / tp ...`` attend to (NxD's ``kv_shared_group_size``, the
  consecutive repeat of JAX's ``_cp_prep``).  A shard hands each rank its
  head, a merge takes one replica per head, and the ranks that share a head
  sum their gradients of it (``trainer/step.py``); the grad norm counts it
  once (:func:`owned_views`);
- **padded vocab slices** (``embed.embedding``, ``lm_head.w``): at a tp that
  does not divide the vocab, each rank holds ``ceil(V / tp)`` rows (the
  reference's ``pad_vocab_size``), rank ``r`` the real rows ``r ceil(V /
  tp) ...`` and zero rows after them.  No id reaches a padded row, the
  logits' padded columns are masked out of the cross-entropy
  (``models/llama.py::logits_fn``, ``ops/cross_entropy.py``), so their
  gradients are zero and AdamW keeps them zero; conversion and checkpoints
  see the real rows alone, so the saved shape is ``[V, h]`` at any tp.

MoE (``models/mixtral.py``): the expert stacks take JAX's ``P("expert",
None, "model")`` / ``P("expert", "model", None)`` (``ops/moe.py::
moe_param_specs``): ``expert`` set, a rank holds ``E / ep`` consecutive
experts (dim 0, :func:`shard_expert`), and of each its tp slice of the
ffn, ``gate_up``'s ``[gate_r | up_r]`` as the dense ``gate_up``'s.  The
router ``[h, E]`` is replicated, and ``partial`` under tp: the ranks of a
tp group route the same gathered tokens, and each one's gradient of the
combine weights is its ffn slice's part of the sum (so are a router
adapter's, when LoRA names ``router``).  An untied head's adapter, when
LoRA names ``lm_head``, follows the column rule: ``lora_b`` holds the
rank's padded vocab columns, ``lora_a`` is partial.

GPT (``models/gpt.py``, JAX's ``gpt.param_specs``): ``attn.qkv`` is the
fused q / k / v column layer above, its ``bias`` cut into the same parts
(dim 0); ``mlp.up`` is a column layer, cut into ``[gate_r | up_r]`` when the
activation is a glu and plainly otherwise, its ``bias`` likewise; ``attn.o``
and ``mlp.down`` are row layers whose ``bias`` is replicated (JAX's
``P(None)``) and added after the reduce, so ``partial`` under SP.  The
LayerNorm ``bias`` is partial under SP as the ``scale``, and so are the
learned position and tokentype tables (added on the rank's sequence
slice).  The normformer's ``nf_mlp_norm`` spans the whole ffn width and is
replicated, as in JAX; each rank applies its ffn slice of it inside the
full-width norm (``parallel/tensor_parallel.py::full_width_norm``), so its
gradient is a partial sum over tp, with or without SP.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

#: layers whose output dim is sharded (and their LoRA ``lora_b``)
COLUMN = ("qkv", "q", "k", "v", "gate_up", "up")
#: layers whose input dim is sharded (and their LoRA ``lora_a``)
ROW = ("o", "down")


@dataclasses.dataclass(frozen=True)
class Part:
    """One part of a sharded leaf along its dim: a fused leaf's segment, or
    the whole of a plain leaf (``name`` "")."""

    name: str
    size: int  # global size along the dim
    kv_heads: int = 0  # k / v parts: above this many ranks each head is replicated
    padded: bool = False  # vocab rows: tp need not divide ``size``

    def replicas(self, tp: int) -> int:
        """How many consecutive ranks hold each piece (1: none repeated)."""
        if self.kv_heads and tp > self.kv_heads:
            if tp % self.kv_heads:
                raise ValueError(f"tensor_model_parallel_size {tp} and the {self.kv_heads} kv "
                                 f"heads must divide one another")
            return tp // self.kv_heads
        return 1

    def piece(self, rank: int, tp: int) -> tuple[int, int, int]:
        """``(global start, local length, real length)`` of rank ``rank``'s
        piece: a padded piece's rows past the real ones are zero."""
        rep = self.replicas(tp)
        if rep > 1:
            n = self.size // self.kv_heads
            return (rank // rep) * n, n, n
        if self.padded:
            n = -(-self.size // tp)
            return rank * n, n, max(0, min(n, self.size - rank * n))
        if self.size % tp:
            raise ValueError(f"a part of {self.size} is not divisible by tp {tp}")
        n = self.size // tp
        return rank * n, n, n


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    dim: Optional[int] = None
    parts: tuple = ()  # the Parts along dim, in order
    partial: bool = False
    expert: bool = False  # dim 0 holds E / ep experts a rank (expert parallelism)

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    @property
    def segments(self) -> tuple:
        """``(name, global size)`` of each segment of a fused leaf (none for
        a plain one)."""
        return tuple((p.name, p.size) for p in self.parts if p.name)

    @property
    def global_size(self) -> int:
        """The leaf's global size along ``dim`` (JAX's)."""
        return sum(p.size for p in self.parts)

    def uneven(self, tp: int) -> bool:
        """Are some of its parts replicated or padded at ``tp``?"""
        return tp > 1 and any(p.replicas(tp) > 1 or p.size % tp for p in self.parts)


REPLICATED = LeafLayout()


def fused_segments(cfg, module: str) -> tuple:
    """The :class:`Part` s of a fused layer's output."""
    d, nh, nkv = cfg.head_size, cfg.num_attention_heads, cfg.kv_heads
    if module == "qkv":
        return (Part("q", nh * d), Part("k", nkv * d, kv_heads=nkv),
                Part("v", nkv * d, kv_heads=nkv))
    if module == "gate_up" or (module == "up" and getattr(cfg, "is_glu", False)):
        return (Part("gate", cfg.intermediate_size), Part("up", cfg.intermediate_size))
    return ()


def _plain_part(cfg, module: str, row: bool) -> tuple:
    """The one :class:`Part` of a plain layer's sharded dim: its input for a
    row layer, its output for a column one."""
    d, nh, nkv = cfg.head_size, cfg.num_attention_heads, cfg.kv_heads
    if row:
        return (Part("", nh * d if module == "o" else cfg.intermediate_size),)
    if module in ("k", "v"):
        return (Part("", nkv * d, kv_heads=nkv),)
    if module == "up":
        return (Part("", cfg.intermediate_size),)
    return (Part("", nh * d),)


def leaf_layout(name: str, cfg, *, sequence_parallel: bool = False) -> LeafLayout:
    """The layout of one dotted leaf name (``cfg``: ``models/llama.py::
    LlamaConfig``, for the parts' sizes)."""
    parts = name.split(".")
    leaf, module = parts[-1], parts[-2] if len(parts) > 1 else ""
    vocab = (Part("", cfg.vocab_size, padded=True),)
    if module == "experts" and leaf == "gate_up":
        return LeafLayout(dim=2, parts=fused_segments(cfg, "gate_up"), expert=True)
    if module == "experts" and leaf == "down":
        return LeafLayout(dim=1, parts=(Part("", cfg.intermediate_size),), expert=True)
    if module == "router":
        return LeafLayout(partial=True)
    if name == "embed.embedding":
        return LeafLayout(dim=0, parts=vocab)
    if name in ("lm_head.w", "lm_head.lora_b"):
        return LeafLayout(dim=1, parts=vocab)
    if name == "lm_head.lora_a":
        return LeafLayout(partial=True)
    if name in ("pos_embed.embedding", "tokentype_embed.embedding"):
        # added on the rank's sequence slice under SP
        return LeafLayout(partial=bool(sequence_parallel))
    if module in COLUMN:
        if leaf in ("w", "lora_b", "bias"):
            return LeafLayout(dim=0 if leaf == "bias" else 1,
                              parts=fused_segments(cfg, module)
                              or _plain_part(cfg, module, row=False))
        if leaf == "lora_a":
            return LeafLayout(partial=True)
    if module in ROW:
        if leaf in ("w", "lora_a"):
            return LeafLayout(dim=0, parts=_plain_part(cfg, module, row=True))
        if leaf == "lora_b":
            return LeafLayout(partial=True)
        if leaf == "bias":  # added after the reduce: on the seq shard under SP
            return LeafLayout(partial=bool(sequence_parallel))
    if module == "nf_mlp_norm":
        # each rank applies its ffn slice of the whole-width leaf
        return LeafLayout(partial=True)
    if leaf in ("scale", "bias") and module.endswith("norm"):
        # under SP the norms see a seq shard (JAX's ``seq_axes``), so their
        # gradient is a partial sum over tp (a partial sum over context, as
        # every leaf's is under cp, is the train step's (data, context) sum)
        return LeafLayout(partial=bool(sequence_parallel))
    return REPLICATED


def leaf_layouts(names, cfg, *, sequence_parallel: bool = False) -> dict[str, LeafLayout]:
    return {n: leaf_layout(n, cfg, sequence_parallel=sequence_parallel) for n in names}


def vocab_rows(vocab_size: int, rank: int, size: int) -> tuple[int, int]:
    """``(global start, real rows)`` of rank ``rank``'s vocab slice at tp
    ``size`` (each rank holds ``ceil(V / size)`` rows, the last ones
    zero-padded)."""
    start, _, real = Part("", vocab_size, padded=True).piece(rank, size)
    return start, real


def _narrow(t, dim: int, start: int, length: int):
    """``t.narrow`` for a torch tensor or a numpy array (a view)."""
    if isinstance(t, torch.Tensor):
        return t.narrow(dim, start, length)
    index = [slice(None)] * t.ndim
    index[dim] = slice(start, start + length)
    return t[tuple(index)]


def _cat(pieces: list, dim: int):
    if isinstance(pieces[0], torch.Tensor):
        return torch.cat(pieces, dim=dim)
    import numpy as np

    return np.ascontiguousarray(np.concatenate(pieces, axis=dim))


def split_segments(t, layout: LeafLayout, size: int, rank: int = 0) -> list[tuple[str, Any]]:
    """``(part name, view)`` of each part of rank ``rank``'s local tensor
    ``t`` at tp ``size``: its real entries (a padded part's zero rows left
    out); ``[("", t)]`` for a replicated leaf."""
    if not layout.sharded:
        return [("", t)]
    out, offset = [], 0
    for p in layout.parts:
        _, n, real = p.piece(rank, size)
        out.append((p.name, _narrow(t, layout.dim, offset, real)))
        offset += n
    return out


def owned_views(t, layout: LeafLayout, rank: int, size: int) -> list:
    """The views of a sharded leaf's local tensor that count towards a norm
    over the tp group: every real entry, a replicated kv head on the first
    rank that holds it alone."""
    return [v for p, (_, v) in zip(layout.parts, split_segments(t, layout, size, rank))
            if rank % p.replicas(size) == 0]


def shard_leaf(full, layout: LeafLayout, rank: int, size: int):
    """Rank ``rank``'s local tensor of the global leaf ``full`` (torch or
    numpy): a new contiguous tensor, or ``full`` itself at ``size == 1`` and
    for a replicated leaf."""
    if size == 1 or not layout.sharded:
        return full
    dim, out, offset = layout.dim, [], 0
    for p in layout.parts:
        start, n, real = p.piece(rank, size)
        piece = _narrow(full, dim, offset + start, real)
        if real < n:
            shape = list(piece.shape)
            shape[dim] = n - real
            if isinstance(full, torch.Tensor):
                pad = torch.zeros(shape, dtype=full.dtype, device=full.device)
            else:
                import numpy as np

                pad = np.zeros(shape, dtype=full.dtype)
            piece = _cat([piece, pad], dim)
        out.append(piece)
        offset += p.size
    return _cat(out, dim)


def shard_expert(full, layout: LeafLayout, rank: int, size: int):
    """Rank ``rank``'s ``E / size`` experts of an expert leaf (dim 0; a
    view), or ``full`` itself for another leaf or at ``size`` 1."""
    if size == 1 or not layout.expert:
        return full
    n = full.shape[0] // size
    return _narrow(full, 0, rank * n, n)


def local_leaf(full, layout: LeafLayout, tp_rank: int = 0, tp_size: int = 1,
               ep_rank: int = 0, ep_size: int = 1):
    """A rank's local tensor of the global leaf ``full``: its experts, then
    its tp slice."""
    return shard_leaf(shard_expert(full, layout, ep_rank, ep_size), layout, tp_rank, tp_size)


def merge_leaf(parts: list, layout: LeafLayout) -> Any:
    """The global leaf from every rank's local tensor, in rank order (the
    inverse of :func:`shard_leaf`; torch tensors or numpy arrays): each part
    from the ranks in order, one replica of each replicated head, the real
    rows of each padded slice."""
    if len(parts) == 1 or not layout.sharded:
        return parts[0]
    size = len(parts)
    views = [split_segments(t, layout, size, r) for r, t in enumerate(parts)]
    cols = [views[r][i][1] for i, p in enumerate(layout.parts)
            for r in range(0, size, p.replicas(size))]
    return _cat(cols, layout.dim)
