"""Engineered compute/comms overlap for the ZeRO-1 update (counterpart of the
JAX package's ``optim/overlap.py``: its knob block, texts and bucket plan).

Two levers of ``distributed_strategy.overlap`` act here:

- **Bucketed ZeRO-1 gathers** (``zero1_bucket_mb``): the AdamW update runs
  per layer-group bucket (the health plane's ``grad_group_of`` names), and
  per bucket every ZeRO-1 leaf whose param is replicated over the model
  axes packs its updated slice into one ``[dp, cols]`` buffer that ONE
  ``dist.all_gather_into_tensor`` moves, in place of one gather a leaf.
  Buckets run in reverse group order (about the backward's gradient
  order), as JAX's do.
- **Prefetched gathers** (``prefetch_ag``): a bucket's gather is issued with
  ``async_op=True`` and waited for only before its unpack, after the next
  bucket's update is queued: gather ``k`` runs on the communicator's stream
  (gloo's thread on the CPU) while update ``k + 1`` computes.  The torch
  counterpart of JAX's ``optimization_barrier`` chain.

Both move bits and change no arithmetic: each bucket runs the per-leaf AdamW
body of ``optim/adamw.py`` (the one both paths call), so the update is bit
for bit the per-leaf path's.  The gradient sums stay where they are
(``trainer/step.py``), as JAX's bucketing leaves the reductions where GSPMD
put them.  ``pp_double_buffer`` is consumed by ``parallel/pipeline.py``.
``xla_lhs`` exports TPU-only XLA flags in JAX; no XLA runs on the card, so
the trainer logs JAX's no-op text for it (``merge_xla_flags`` is XLA-only
and not ported).
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Callable, Optional

import torch

_OVERLAP_KEYS = ("zero1_bucket_mb", "prefetch_ag", "pp_double_buffer",
                 "xla_lhs")


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """Validated ``distributed_strategy.overlap`` block (all levers off by
    default — the engineered paths are opt-in and graph-changing)."""

    zero1_bucket_mb: float = 0.0  # 0 = monolithic; >0 = coalesce grad groups
                                  # until a bucket holds >= this many MiB of
                                  # fp32 master weights
    prefetch_ag: bool = True      # barrier-chain buckets (no-op when
                                  # zero1_bucket_mb == 0)
    pp_double_buffer: bool = False  # hoist pipeline stage-hop permutes out of
                                    # their compute conds
    xla_lhs: bool = False         # export the TPU latency-hiding flag set

    @classmethod
    def from_config(cls, block: Optional[dict]) -> "OverlapConfig":
        if block is None:
            return cls()
        if not isinstance(block, dict):
            raise ValueError(
                "distributed_strategy.overlap must be a mapping, got "
                f"{type(block).__name__}"
            )
        for k in block:
            if k not in _OVERLAP_KEYS:
                near = difflib.get_close_matches(str(k), _OVERLAP_KEYS, n=1)
                hint = f" — did you mean '{near[0]}'?" if near else ""
                raise ValueError(
                    f"unknown distributed_strategy.overlap key '{k}'{hint} "
                    f"(valid: {', '.join(_OVERLAP_KEYS)})"
                )
        mb = block.get("zero1_bucket_mb", 0.0)
        if isinstance(mb, bool) or not isinstance(mb, (int, float)):
            raise ValueError(
                "distributed_strategy.overlap.zero1_bucket_mb must be a "
                f"number (MiB), got {type(mb).__name__}"
            )
        if mb < 0:
            raise ValueError(
                "distributed_strategy.overlap.zero1_bucket_mb must be >= 0, "
                f"got {mb}"
            )
        out = {"zero1_bucket_mb": float(mb)}
        for k in ("prefetch_ag", "pp_double_buffer", "xla_lhs"):
            if k in block:
                v = block[k]
                if not isinstance(v, bool):
                    raise ValueError(
                        f"distributed_strategy.overlap.{k} must be a bool, "
                        f"got {type(v).__name__}"
                    )
                out[k] = v
        return cls(**out)


# ---------------------------------------------------------------------------
# Bucket planning (static: from the leaves' shapes and ZeRO-1 dims)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AGLeaf:
    """One leaf of a bucket's combined gather: its moments are sharded over
    the whole data-parallel extent on ``dim`` and its param is replicated
    over the model axes, so its updated slice packs shard-contiguously into
    the bucket's ``[dp, cols]`` buffer."""

    name: str           # the leaf's dotted name (JAX: its tree position)
    dim: int            # the ZeRO-1 dim
    cols: int           # numel // dp
    moved_shape: tuple  # the leaf's shape after movedim(dim -> 0)


@dataclasses.dataclass(frozen=True)
class Bucket:
    name: str      # "+".join of member grad groups
    members: tuple  # the member leaves' names, JAX's tree order
    ag: tuple      # AGLeaf entries (combined-gather members)
    bytes: int     # fp32 master bytes in this bucket (global leaves)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: tuple  # processing order: reverse tree-group order
    dp_total: int
    num_leaves: int

    def describe(self) -> str:
        parts = [
            f"{b.name}[{len(b.members)} leaves, {len(b.ag)} packed, "
            f"{b.bytes / 2**20:.1f}MiB]"
            for b in self.buckets
        ]
        return f"zero1 buckets (dp={self.dp_total}): " + ", ".join(parts)


def jax_order(name: str) -> tuple:
    """Sort key of a dotted leaf name in JAX's tree order: JAX stacks the
    layers on one leaf and flattens dicts by sorted key, so the port's
    leaves sort by their names without layer indices, then by the
    indices."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def build_bucket_plan(shapes: dict, moment_dims: dict, dp_total: int, *, bucket_mb: float,
                      group_fn: Callable, model_sharded: Callable = lambda n: False,
                      group_bytes: Optional[dict] = None) -> Optional[BucketPlan]:
    """Group the trainable leaves into collective buckets (JAX's rules).

    ``shapes``: each leaf's global shape by name; ``moment_dims``: its
    ZeRO-1 dim (``opt_state_specs(...)["mu"]``, None: replicated);
    ``model_sharded(name)``: the param itself is sharded over a model axis
    of more than one rank (tp, ep, or pp's stage leaves; an axis of one
    rank partitions nothing, JAX's physical rule).  Leaves are grouped by
    ``group_fn(name)``, groups keep JAX's tree order (:func:`jax_order`),
    and consecutive groups are coalesced until a bucket holds ``bucket_mb``
    MiB of fp32 master weights (``group_bytes``, by group, overrides the
    local count: a pipeline stage holds its layers alone, JAX counts every
    layer); the processing order is reversed.  A leaf joins its bucket's
    combined gather only when the packing is a local reshape: it is ZeRO-1
    sharded and its param is replicated over the model axes (tp- and
    ep-sharded leaves, and stage leaves under pp, fall back to per-leaf
    gathers).  None at ``dp_total`` 1: bucketing is a no-op there."""
    if dp_total <= 1:
        return None
    names = sorted(shapes, key=jax_order)
    order: list = []
    members: dict = {}
    for n in names:
        g = group_fn(n)
        if g not in members:
            members[g] = []
            order.append(g)
        members[g].append(n)

    def ag_leaf(n) -> Optional[AGLeaf]:
        dim = moment_dims.get(n)
        if dim is None:
            return None  # not ZeRO-1 sharded (nothing divides)
        if model_sharded(n):
            return None  # param itself model-sharded: per-leaf fallback
        shape = tuple(shapes[n])
        size = 1
        for d in shape:
            size *= d
        if size == 0 or shape[dim] % dp_total:
            return None
        moved = (shape[dim],) + shape[:dim] + shape[dim + 1:]
        return AGLeaf(name=n, dim=dim, cols=size // dp_total, moved_shape=moved)

    def nbytes(n) -> int:
        size = 1
        for d in shapes[n]:
            size *= d
        return size * 4  # fp32 master

    threshold = float(bucket_mb) * 2**20
    buckets: list = []
    cur_names: list = []
    cur_members: list = []
    cur_ag: list = []
    cur_bytes = 0

    def close():
        nonlocal cur_names, cur_members, cur_ag, cur_bytes
        if cur_members:
            buckets.append(Bucket(name="+".join(cur_names), members=tuple(cur_members),
                                  ag=tuple(cur_ag), bytes=cur_bytes))
        cur_names, cur_members, cur_ag, cur_bytes = [], [], [], 0

    for g in reversed(order):
        cur_names.append(g)
        for n in members[g]:
            cur_members.append(n)
            a = ag_leaf(n)
            if a is not None:
                cur_ag.append(a)
        cur_bytes += (group_bytes[g] if group_bytes and g in group_bytes
                      else sum(nbytes(n) for n in members[g]))
        if cur_bytes >= threshold:
            close()
    close()
    return BucketPlan(buckets=tuple(buckets), dp_total=dp_total, num_leaves=len(names))


# ---------------------------------------------------------------------------
# The bucketed gathers (called from optim/adamw.py::adamw_update)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Gather:
    """One bucket's packed gathers in flight: per param dtype, the leaves,
    the gathered ``[dp * cols]`` buffer, the work (None when issued
    synchronously) and the packed row, held until the unpack."""

    bucket: Bucket
    parts: list  # [(AGLeaf list, gathered buffer, work, row)]


def _gather_single(out, row, **kw):
    """``all_gather_into_tensor`` (``all_gather_single``, its newer name,
    where torch has it)."""
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    return fn(out, row, **kw)


def issue_gather(bucket: Bucket, slices: dict, dp, *, prefetch: bool) -> _Gather:
    """Pack ``slices`` (name -> this rank's updated param slice) of the
    bucket's combined-gather leaves into one ``[cols]`` row a param dtype
    and gather the rows of every data rank with ONE
    ``all_gather_into_tensor`` each (``async_op`` under ``prefetch``)."""
    by_dtype: dict = {}
    for a in bucket.ag:
        if a.name in slices:
            by_dtype.setdefault(slices[a.name].dtype, []).append(a)
    parts = []
    for dtype, leaves in by_dtype.items():
        row = torch.cat([slices[a.name].movedim(a.dim, 0).reshape(-1) for a in leaves])
        out = torch.empty(row.numel() * dp.size, dtype=dtype, device=row.device)
        work = _gather_single(out, row, group=dp.group, async_op=prefetch)
        parts.append((leaves, out, work, row))
    return _Gather(bucket=bucket, parts=parts)


def finish_gather(g: _Gather, params: dict, dp_size: int) -> list:
    """Wait for a bucket's gathers and unpack them into the whole params;
    returns each dtype's gathered ``[dp, cols]`` payload (what the
    tensorstats ``bucket`` phase reads: JAX's packed buffer)."""
    payloads = []
    for leaves, out, work, _ in g.parts:
        if work is not None:
            work.wait()
        packed = out.view(dp_size, -1)
        off = 0
        for a in leaves:
            piece = packed[:, off:off + a.cols].reshape(a.moved_shape)
            params[a.name].copy_(piece.movedim(0, a.dim))
            off += a.cols
        payloads.append(packed)
    return payloads
