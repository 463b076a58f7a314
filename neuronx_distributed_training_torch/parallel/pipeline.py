"""Pipeline parallelism over the ``pipe`` mesh axis (counterpart of the JAX
package's ``parallel/pipeline.py`` at ``virtual_pipeline_model_parallel_size``
1).

Host side, copied from the JAX package with its texts: the stage split
(:func:`stage_layer_slice`, :func:`to_interleaved` / :func:`from_interleaved`
over the port's list of layers), the schedule gate (:func:`blocked_1f1b_reason`,
:func:`supports_1f1b`, :func:`resolve_schedule`), the compacted work table of
the manual-backward schedules (:func:`work_table`, plain numpy) and the bubble
model (:func:`ring_slot_counts`, :func:`bubble_multiplier`,
:func:`predicted_bubble_fraction`), and :func:`ce_denominator`.

Executors.  Pipeline rank ``r`` of ``pp`` holds layers ``[r Lc, (r + 1) Lc)``
(``Lc = L / pp``); the embedding, the final norm and the head are replicated
over ``pipe``.  Rank 0 embeds, the last rank applies the final norm, the head
and the cross-entropy, and the activations cross the stages point to point.
One rank's step is a generator, :func:`stage_body`, that walks its schedule
and *yields* its stage hops: ``("p2p", sends, recvs)``, each a list of
``(offset, tensor)`` with offset +1 (the next stage) or -1 (the previous),
a receive's tensor being the buffer to fill; it is sent back the received
tensors.  The hops are Megatron's: a warm-up forward sends its output alone,
in the steady state a forward's send is batched with the receive of the next
backward's cotangent and a backward's send with the receive of the next
forward's input, so that two neighbours never both wait on a send.
:func:`drive` answers the yields over the pipe group
(``parallel/mesh.py::PipelineParallel``, batched ``isend`` / ``irecv``);
:func:`loopback` answers those of every virtual rank in one process (the
tests, and one card in ``chip_smoke.py``).

Schedules (both give the same loss and gradients: a schedule is an order of
work and changes no number):

- ``1f1b``: a warm-up of ``min(pp - 1 - r, nm)`` forwards, then one forward
  and one backward in turn, then the cool-down's backwards.  Each forward
  keeps its autograd graph until its backward, so rank ``r`` holds at most
  ``pp - r`` microbatches' graphs and recomputes nothing.  JAX's 1F1B is
  O(pp) too, but it runs a ``scan`` over the compacted table, which cannot
  keep a graph across ticks: it recomputes each stage inside its backward
  tick and holds up to ``2 pp - 1`` stage inputs on rank 0.  The port spends
  memory (at most ``pp`` graphs) where JAX spends a forward; the port's
  :func:`work_table` still serves :func:`predicted_bubble_fraction`.
- ``wavefront``: every forward, then every backward.  A forward runs without
  a graph and keeps only its stage input (``nm`` of them); its backward
  recomputes the stage forward first, JAX's ``jax.checkpoint`` wavefront's
  memory class at one stage forward more per microbatch than ``1f1b``.

Each stage's backward is ``torch.autograd.grad`` of its output with the
received cotangent (of ``loss_m / denominator`` on the last rank), over the
rank's trainable leaves and its input; the leaves' gradients accumulate in
fp32 in microbatch order.  The loss is ``sum_m loss_sum_m / denominator``,
``denominator`` the valid-token count of the whole global batch, JAX's
pipelined rule (not the unpipelined mean of the microbatches' means): the
two agree only when every microbatch has the same count.  The replicated
leaves' gradients (the embedding's on rank 0, the final norm's and the
head's on the last rank; with tied embeddings both land on
``embed.embedding``, JAX's ``fold_grads``) and the loss are then summed over
``pipe`` (:func:`sum_over_pipe`), so every rank holds the whole loss and
whole gradients of what it holds.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

PIPE_AXIS = "pipe"


def stage_layer_slice(num_layers: int, pp: int, vp: int = 1) -> int:
    if num_layers % (pp * vp) != 0:
        raise ValueError(
            f"num_layers {num_layers} not divisible by pp*vp = {pp}*{vp}"
        )
    return num_layers // (pp * vp)


def stage_layers(num_layers: int, rank: int, pp: int) -> range:
    """The global indices of the layers pipeline rank ``rank`` holds at vp 1."""
    lc = stage_layer_slice(num_layers, pp)
    return range(rank * lc, (rank + 1) * lc)


def to_interleaved(layers: list, pp: int, vp: int) -> list:
    """``[L]`` layers -> ``[vp][pp][Lc]`` stage-major lists: stage ``s = c*pp
    + r`` (chunk c on rank r) covers layers ``[s*Lc, (s+1)*Lc)``, JAX's
    reshape of the stacked ``[L, ...]`` leaves to ``[vp, pp, Lc, ...]``."""
    lc = stage_layer_slice(len(layers), pp, vp)
    return [[layers[(c * pp + r) * lc:(c * pp + r + 1) * lc] for r in range(pp)]
            for c in range(vp)]


def from_interleaved(layers: list) -> list:
    """Inverse of ``to_interleaved``: ``[vp][pp][Lc]`` -> ``[L]``."""
    return [x for chunk in layers for rank in chunk for x in rank]


PIPELINE_SCHEDULES = ("auto", "1f1b", "1f1b-interleaved", "1f1b-zb",
                      "wavefront")
#: the manual-vjp family (everything but the autodiff wavefront)
MANUAL_VJP_SCHEDULES = ("1f1b", "1f1b-interleaved", "1f1b-zb")


def blocked_1f1b_reason(parallel_cfg: dict,
                        schedule: str = "1f1b") -> Optional[str]:
    """Config-shape constraints on a manual-vjp schedule (no model object
    needed): the blocking reason, or None.  Shared by :func:`supports_1f1b`
    and ``config/loader.py::validate_config``, with the JAX package's texts."""
    pp = int(parallel_cfg.get("pipeline_model_parallel_size", 1) or 1)
    vp = int(parallel_cfg.get("virtual_pipeline_model_parallel_size", 1) or 1)
    cp = int(parallel_cfg.get("context_parallel_size", 1) or 1)
    alignment = parallel_cfg.get("alignment")
    if schedule not in MANUAL_VJP_SCHEDULES:
        raise ValueError(
            f"blocked_1f1b_reason: not a manual-vjp schedule: {schedule!r}"
        )
    if pp <= 1:
        return f"{schedule} requires pipeline_model_parallel_size > 1"
    if vp > 1 and schedule != "1f1b-interleaved":
        return (
            f"the virtual pipeline (virtual_pipeline_model_parallel_size > 1) "
            f"runs under the circular interleaved manual-vjp schedule — set "
            f"pipeline.schedule: 1f1b-interleaved (or auto) — not {schedule}"
        )
    if vp <= 1 and schedule == "1f1b-interleaved":
        return (
            "1f1b-interleaved needs virtual_pipeline_model_parallel_size > 1 "
            "(with vp == 1 there is nothing to interleave; use 1f1b)"
        )
    if cp > 1:
        return (
            f"context parallelism under pp is proven for the autodiff "
            f"wavefront only (blockwise attention vjp inside the manual "
            f"{schedule} tick loop is unvalidated); use schedule: wavefront "
            f"for pp x cp"
        )
    if alignment in ("dpo", "orpo", "kto"):
        return (
            f"preference alignment ({alignment}) pipelines via the "
            f"concatenated-forward wavefront; the manual-vjp schedules "
            f"implement token-level CE only"
        )
    if parallel_cfg.get("lora"):
        return (
            f"LoRA adapters are not wired for the manual-vjp {schedule} head "
            f"(adapter grads on lm_head would be silently dropped)"
        )
    return None


def supports_1f1b(model_cfg: Any, parallel_cfg: dict,
                  schedule: str = "1f1b") -> tuple[bool, str]:
    """Can the manual-vjp ``schedule`` run this model/parallelism combo?
    ``(ok, reason)``; ``parallel_cfg`` as :func:`blocked_1f1b_reason`'s.
    The port's ``models/llama.py::LlamaConfig`` (Llama / Mistral)
    qualifies; a Mixtral or any other config keeps the JAX package's
    reasons."""
    blocked = blocked_1f1b_reason(parallel_cfg, schedule)
    if blocked is not None:
        return False, blocked
    if getattr(model_cfg, "attention_impl", "") == "zigzag_ring":
        return False, "zigzag_ring attention is not supported under pp at all"
    from neuronx_distributed_training_torch.models import llama as _llama

    if isinstance(model_cfg, _llama.LlamaConfig):
        return True, f"llama/mistral: plain matmul head + token CE ({schedule})"
    if type(model_cfg).__name__ == "MixtralConfig":
        return False, (
            "mixtral: dropless-MoE stage vjp has backend-dependent numerics "
            "under the 1f1b tick loop (dense families only for now)"
        )
    return False, (
        f"{type(model_cfg).__name__}: head not wired for the manual-vjp "
        f"{schedule} schedule (supported families: llama/mistral)"
    )


def resolve_schedule(schedule: str, model_cfg: Any, parallel_cfg: dict) -> str:
    """``pipeline.schedule`` knob -> concrete schedule name: ``auto`` takes
    ``1f1b-interleaved`` at vp > 1, else ``1f1b``, whenever
    :func:`supports_1f1b` allows, else ``wavefront``; ``1f1b-zb`` is never
    taken by ``auto``; forcing a manual-vjp schedule on a combination the
    gate blocks raises with its reason."""
    schedule = str(schedule or "auto").lower()
    if schedule not in PIPELINE_SCHEDULES:
        raise ValueError(
            f"pipeline.schedule must be one of {'/'.join(PIPELINE_SCHEDULES)}, "
            f"got {schedule!r}"
        )
    if schedule == "wavefront":
        return "wavefront"
    vp = int(parallel_cfg.get(
        "virtual_pipeline_model_parallel_size", 1) or 1)
    if schedule == "auto":
        preferred = "1f1b-interleaved" if vp > 1 else "1f1b"
        ok, _ = supports_1f1b(model_cfg, parallel_cfg, preferred)
        return preferred if ok else "wavefront"
    ok, reason = supports_1f1b(model_cfg, parallel_cfg, schedule)
    if not ok:
        raise ValueError(
            f"pipeline.schedule: {schedule} is unsupported here: {reason}")
    return schedule


# ---------------------------------------------------------------------------
# Work-compacted schedule tables (the JAX package's, plain numpy)
# ---------------------------------------------------------------------------


def _fwd_order(pp: int, nm: int, vp: int) -> list[tuple[int, int]]:
    """Forward work order (chunk, microbatch), shared by every rank."""
    if vp == 1:
        return [(0, m) for m in range(nm)]
    order = []
    for g0 in range(0, nm, pp):
        group = range(g0, min(g0 + pp, nm))
        for c in range(vp):
            order.extend((c, m) for m in group)
    return order


def _bwd_order(pp: int, nm: int, vp: int) -> list[tuple[int, int]]:
    """Backward work order: same pp-groups, chunks descending."""
    if vp == 1:
        return [(0, m) for m in range(nm)]
    order = []
    for g0 in range(0, nm, pp):
        group = range(g0, min(g0 + pp, nm))
        for c in reversed(range(vp)):
            order.extend((c, m) for m in group)
    return order


def _interval_alloc(items: list[tuple[int, int, Any]]
                    ) -> tuple[dict, int]:
    """Greedy register allocation over (write_tick, last_read_tick, key)
    lifetimes -> ({key: slot}, n_slots); a slot is reused only for a write
    strictly after its previous occupant's last read."""
    out: dict = {}
    busy_until: list[int] = []  # slot -> last read tick of current occupant
    for write, last_read, key in sorted(items, key=lambda it: (it[0], it[1])):
        if last_read < write:
            raise AssertionError(
                f"work table bug: value {key} read at {last_read} before "
                f"its write at {write}")
        for s, until in enumerate(busy_until):
            if until < write:
                out[key] = s
                busy_until[s] = last_read
                break
        else:
            out[key] = len(busy_until)
            busy_until.append(last_read)
    return out, max(1, len(busy_until))


#: per-tick work weights of the table's bubble accounting: a forward ~1, a
#: full-vjp backward ~3, a zb dgrad-only backward ~2, a deferred wgrad ~2
_WORK_UNITS = {"f": 1.0, "b_full": 3.0, "b_dgrad": 2.0, "w": 2.0}


@dataclasses.dataclass(frozen=True)
class WorkTable:
    """Host-side compacted schedule of one manual-vjp variant: ``rank_cols``
    ``[span, pp]`` arrays (one column per pipe rank), ``glob_cols``
    ``[span]`` tick-uniform arrays, and the interval-allocated ring sizes."""

    schedule: str
    pp: int
    nm: int
    vp: int
    span: int
    rank_cols: dict[str, np.ndarray]
    glob_cols: dict[str, np.ndarray]
    ring_sizes: dict[str, int]

    @property
    def lockstep_span(self) -> int:
        """The one-tick-per-global-tick trip count, for reference."""
        return (2 * self.vp - 1) * self.nm + 2 * self.pp - 1

    def tick_counts(self) -> dict[str, int]:
        g = self.glob_cols
        return {
            "span": self.span,
            "f_ticks": int(g["has_f"].sum()),
            "b_ticks": int(g["has_b"].sum()),
            "w_ticks": int(g["has_w"].sum()),
            "head_ticks": int(g["has_h"].sum()),
            "lockstep_span": self.lockstep_span,
        }

    def bubble_fraction(self) -> float:
        """Predicted idle fraction of the compacted execution: the share of
        executed work units that are fill/drain slots (``_WORK_UNITS``
        weights; ``b/(1+b)`` exactly for ``1f1b`` and ``1f1b-interleaved``)."""
        wb = _WORK_UNITS["b_dgrad"] if self.schedule == "1f1b-zb" \
            else _WORK_UNITS["b_full"]
        g, r = self.glob_cols, self.rank_cols
        per_tick = (_WORK_UNITS["f"] * g["has_f"]
                    + wb * g["has_b"] + _WORK_UNITS["w"] * g["has_w"])
        executed = self.pp * float(per_tick.sum())
        useful = (_WORK_UNITS["f"] * float(r["f_valid"].sum())
                  + wb * float(r["b_valid"].sum())
                  + _WORK_UNITS["w"] * float(r["w_valid"].sum()))
        return 1.0 - useful / executed if executed > 0 else 0.0


@functools.lru_cache(maxsize=None)
def work_table(schedule: str, pp: int, nm: int, vp: int = 1) -> WorkTable:
    """The compacted work table of one manual-vjp schedule: per-rank F/B
    streams are one-tick shifts of rank 0's forward and rank ``pp-1``'s
    backward streams; the variable-latency hand-offs ride interval-allocated
    rings."""
    if schedule not in MANUAL_VJP_SCHEDULES:
        raise ValueError(f"work_table: not a manual-vjp schedule: {schedule!r}")
    if pp <= 1 or nm <= 0:
        raise ValueError(f"work_table needs pp > 1 and nm > 0 (pp={pp}, nm={nm})")
    vp = max(int(vp or 1), 1)
    if (vp > 1) != (schedule == "1f1b-interleaved"):
        raise ValueError(
            f"work_table: schedule {schedule} is inconsistent with vp={vp}")
    zb = schedule == "1f1b-zb"

    # -- rank-0 forward stream (greedy ASAP, one F per tick) ---------------
    t0F: dict[tuple[int, int], int] = {}
    prev = -1
    for c, m in _fwd_order(pp, nm, vp):
        dep = t0F[(c - 1, m)] + pp if c > 0 else 0
        prev = max(prev + 1, dep)
        t0F[(c, m)] = prev
    # head(m) shares the tick of the last rank's final-chunk forward
    tH = {m: t0F[(vp - 1, m)] + pp - 1 for m in range(nm)}

    # -- last-rank backward stream (greedy ASAP, one B per tick) -----------
    tLB: dict[tuple[int, int], int] = {}
    prev = -1
    for c, m in _bwd_order(pp, nm, vp):
        dep = tH[m] if c == vp - 1 else tLB[(c + 1, m)] + pp
        prev = max(prev + 1, dep)
        tLB[(c, m)] = prev
    # zb deferred wgrad: rank-uniform at rank 0's dgrad tick
    tW = {m: tLB[(0, m)] + pp - 1 for m in range(nm)} if zb else {}

    span = 1 + max(
        max(t for t in t0F.values()) + pp - 1,
        max(t for t in tLB.values()) + pp - 1,
        max(tW.values()) if tW else 0,
    )

    def ri(dtype=np.int32):
        return np.zeros((span, pp), dtype)

    def gi(dtype=np.int32):
        return np.zeros((span,), dtype)

    rank_cols = {
        "f_m": ri(), "f_c": ri(), "f_valid": ri(bool), "f_slot": ri(),
        "b_m": ri(), "b_c": ri(), "b_valid": ri(bool), "b_slot": ri(),
        "w_m": ri(), "w_valid": ri(bool), "w_x_slot": ri(),
        "bdy_slot": ri(), "w_dy_slot": ri(),
    }
    glob_cols = {
        "has_f": gi(bool), "has_b": gi(bool), "has_w": gi(bool),
        "has_h": gi(bool), "h_m": gi(),
        "dyw_slot": gi(), "dyr_slot": gi(),
        "feed_valid": gi(bool), "feed_src": gi(), "feed_slot": gi(),
        "cpark_valid": gi(bool), "cpark_slot": gi(), "cread_slot": gi(),
        "bpark_valid": gi(bool), "bpark_slot": gi(), "bread_slot": gi(),
        "d0_valid": gi(bool), "d0_dst": gi(), "d0_slot": gi(),
    }

    for (c, m), t0 in t0F.items():
        for r in range(pp):
            t = t0 + r
            rank_cols["f_m"][t, r] = m
            rank_cols["f_c"][t, r] = c
            rank_cols["f_valid"][t, r] = True
        if c == 0:
            glob_cols["feed_valid"][t0] = True
            glob_cols["feed_src"][t0] = m % pp
            glob_cols["feed_slot"][t0] = m // pp
    for (c, m), tl in tLB.items():
        for r in range(pp):
            t = tl + (pp - 1 - r)
            rank_cols["b_m"][t, r] = m
            rank_cols["b_c"][t, r] = c
            rank_cols["b_valid"][t, r] = True
        if c == 0:
            t0b = tl + pp - 1  # rank 0's dgrad tick
            glob_cols["d0_valid"][t0b] = True
            glob_cols["d0_dst"][t0b] = m % pp
            glob_cols["d0_slot"][t0b] = m // pp
    for m, t in tH.items():
        glob_cols["has_h"][t] = True
        glob_cols["h_m"][t] = m
    for m, t in tW.items():
        for r in range(pp):
            rank_cols["w_m"][t, r] = m
            rank_cols["w_valid"][t, r] = True
    glob_cols["has_f"] = rank_cols["f_valid"].any(axis=1)
    glob_cols["has_b"] = rank_cols["b_valid"].any(axis=1)
    glob_cols["has_w"] = rank_cols["w_valid"].any(axis=1)

    ring_sizes: dict[str, int] = {}

    # stage-input store: write at the rank's F tick, last read at its B
    # tick (and the rank-uniform wgrad tick under zb)
    n_inflight = 1
    for r in range(pp):
        items = []
        for (c, m), t0 in t0F.items():
            write = t0 + r
            last = tLB[(c, m)] + (pp - 1 - r)
            if zb:
                last = max(last, tW[m])
            items.append((write, last, (c, m)))
        alloc, n = _interval_alloc(items)
        n_inflight = max(n_inflight, n)
        for (c, m), s in alloc.items():
            rank_cols["f_slot"][t0F[(c, m)] + r, r] = s
            rank_cols["b_slot"][tLB[(c, m)] + (pp - 1 - r), r] = s
            if zb:
                rank_cols["w_x_slot"][tW[m], r] = s
    ring_sizes["inflight"] = n_inflight

    # forward / backward chunk hand-offs (vp > 1)
    if vp > 1:
        items = [(t0F[(c, m)] + pp, t0F[(c + 1, m)], (c, m))
                 for (c, m) in t0F if c < vp - 1]
        alloc, n = _interval_alloc(items)
        ring_sizes["circ"] = n
        for (c, m), s in alloc.items():
            glob_cols["cpark_valid"][t0F[(c, m)] + pp] = True
            glob_cols["cpark_slot"][t0F[(c, m)] + pp] = s
            glob_cols["cread_slot"][t0F[(c + 1, m)]] = s
        items = [(tLB[(c, m)] + pp, tLB[(c - 1, m)], (c, m))
                 for (c, m) in tLB if c >= 1]
        alloc, n = _interval_alloc(items)
        ring_sizes["bcirc"] = n
        for (c, m), s in alloc.items():
            glob_cols["bpark_valid"][tLB[(c, m)] + pp] = True
            glob_cols["bpark_slot"][tLB[(c, m)] + pp] = s
            glob_cols["bread_slot"][tLB[(c - 1, m)]] = s
    else:
        ring_sizes["circ"] = ring_sizes["bcirc"] = 0

    # head-dy park: written at the head tick, read by the last rank's
    # final-chunk B
    items = [(tH[m], tLB[(vp - 1, m)], m) for m in range(nm)]
    alloc, n = _interval_alloc(items)
    ring_sizes["dy"] = n
    for m, s in alloc.items():
        glob_cols["dyw_slot"][tH[m]] = s
        glob_cols["dyr_slot"][tLB[(vp - 1, m)]] = s

    # zb deferred-dy park
    if zb:
        n_wdy = 1
        for r in range(pp):
            items = [(tLB[(0, m)] + (pp - 1 - r), tW[m], m)
                     for m in range(nm)]
            alloc, n = _interval_alloc(items)
            n_wdy = max(n_wdy, n)
            for m, s in alloc.items():
                rank_cols["bdy_slot"][tLB[(0, m)] + (pp - 1 - r), r] = s
                rank_cols["w_dy_slot"][tW[m], r] = s
        ring_sizes["wdy"] = n_wdy
    else:
        ring_sizes["wdy"] = 0

    return WorkTable(schedule=schedule, pp=pp, nm=nm, vp=vp, span=span,
                     rank_cols=rank_cols, glob_cols=glob_cols,
                     ring_sizes=ring_sizes)


def ring_slot_counts(schedule: str, pp: int, nm: int, vp: int = 1
                     ) -> dict[str, int]:
    """Stage-input-sized ring slots JAX's compacted executor allocates for a
    schedule, with a ``total``."""
    sizes = dict(work_table(schedule, pp, nm, vp).ring_sizes)
    sizes["total"] = sum(sizes.values())
    return sizes


def bubble_multiplier(schedule: Optional[str], pp: int, nm: int,
                      vp: int = 1) -> float:
    """Fill/drain time as a fraction of the schedule's useful work:
    ``(pp-1)/nm`` for ``1f1b``, ``(pp-1)/(nm*vp)`` for the wavefront and
    ``1f1b-interleaved``, ``(pp-1)/(3*nm)`` for ``1f1b-zb``."""
    if pp <= 1 or nm <= 0:
        return 0.0
    vp = max(int(vp or 1), 1)
    if schedule == "1f1b-zb":
        return (pp - 1) / (3.0 * nm)
    if schedule == "1f1b":
        return (pp - 1) / float(nm)
    # wavefront + 1f1b-interleaved share the circular-interleave utilization
    return (pp - 1) / float(nm * vp)


def predicted_bubble_fraction(schedule: Optional[str], pp: int, nm: int,
                              vp: int = 1) -> float:
    """Predicted idle fraction of the whole pipelined step (0.0 at pp 1):
    the work table's for the manual-vjp schedules, the closed form
    ``b / (1 + b)`` for the wavefront."""
    if pp <= 1 or nm <= 0:
        return 0.0
    if schedule in MANUAL_VJP_SCHEDULES:
        vp = max(int(vp or 1), 1) if schedule == "1f1b-interleaved" else 1
        if schedule == "1f1b-interleaved" and vp == 1:
            schedule = "1f1b"
        return work_table(schedule, pp, nm, vp).bubble_fraction()
    b = bubble_multiplier(schedule, pp, nm, vp)
    return b / (1.0 + b)


def ce_denominator(microbatches: dict, *, shift_labels: bool,
                   ignore_index: int = -100) -> torch.Tensor:
    """Total valid-token count over all microbatches (leaves ``[nm, mb,
    ...]``): a function of the labels and the loss mask only, as in
    ``ops/cross_entropy.py``."""
    labels = microbatches["labels"]
    loss_mask = microbatches.get("loss_mask")
    if shift_labels:
        labels = labels[..., 1:]
        loss_mask = None if loss_mask is None else loss_mask[..., 1:]
    valid = (labels != ignore_index).float()
    if loss_mask is not None:
        valid = valid * loss_mask.float()
    return torch.sum(valid)


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------


#: the schedules the executors run (vp 1)
EXECUTED_SCHEDULES = ("1f1b", "wavefront")


@dataclasses.dataclass
class Stage:
    """What pipeline rank ``rank`` of ``size`` runs of the model in a step.
    ``embed(mb)`` (rank 0), ``layers(x, mb)`` (the rank's layers) and
    ``loss(y, mb) -> (loss_sum, valid_count)`` (the last rank) are
    ``models/llama.py::pipeline_hooks`` bound to the rank's params;
    ``leaves`` are the rank's trainable leaves by name; ``act_shape(mb)``
    and ``act_dtype`` describe the activations that cross the stages."""

    rank: int
    size: int
    embed: Callable
    layers: Callable
    loss: Callable
    leaves: dict
    act_shape: Callable
    act_dtype: torch.dtype

    @property
    def first(self) -> bool:
        return self.rank == 0

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1


def _p2p(sends: list, recvs: list):
    """Yield one batch of stage hops (none when both lists are empty) and
    return the received tensors."""
    if not sends and not recvs:
        return []
    got = yield "p2p", sends, recvs
    return got


def stage_body(stage: Stage, microbatches: list, denominator, schedule: str, *,
               grad_dtype=torch.float32, stats: Optional[dict] = None,
               timer: Optional[Callable] = None):
    """Generator of one pipeline rank's step (see the module docstring).
    Returns ``(loss, grads)``: on the last rank the fp32 ``sum_m loss_sum_m /
    denominator`` (None on the others), and ``{name: fp32 gradient}`` of the
    leaves that got one.  ``stats`` (a dict) receives ``graphs_max`` (the
    most microbatches whose graphs were alive at once) and ``inputs_max``
    (the most stage inputs held for a recompute); ``timer()``, if given, is
    a context manager around each stage computation."""
    if schedule not in EXECUTED_SCHEDULES:
        raise ValueError(f"the executors run {'/'.join(EXECUTED_SCHEDULES)}, not {schedule!r}")
    nm = len(microbatches)
    names = list(stage.leaves)
    leaves = [stage.leaves[n] for n in names]
    grads: dict = {}
    loss_acc = None
    alive = held = 0
    stats = {} if stats is None else stats
    stats.update(graphs_max=0, inputs_max=0)
    clock = timer or contextlib.nullcontext

    def buffer(m):
        dev = next(iter(microbatches[m].values())).device
        return torch.empty(stage.act_shape(microbatches[m]), dtype=stage.act_dtype, device=dev)

    def recv_forward(m):
        if stage.first:
            return None
        (x,) = yield from _p2p([], [(-1, buffer(m))])
        return x

    def send_forward(y):
        if not stage.last:
            yield from _p2p([(1, y.detach())], [])

    def recv_backward(m):
        if stage.last:
            return None
        (dy,) = yield from _p2p([], [(1, buffer(m))])
        return dy

    def send_backward(dx):
        if not stage.first:
            yield from _p2p([(-1, dx)], [])

    def forward(m, x, graph: bool, count_loss: bool = True):
        nonlocal loss_acc, alive
        mb = microbatches[m]
        with clock(), (contextlib.nullcontext() if graph else torch.no_grad()):
            if stage.first:
                x_in, h = None, stage.embed(mb)
            else:
                x_in = h = x.detach().requires_grad_(graph)
            y = stage.layers(h, mb)
            if stage.last:
                y = stage.loss(y, mb)[0].float() / denominator
                if count_loss:
                    loss_acc = y.detach() if loss_acc is None else loss_acc + y.detach()
        if graph:
            alive += 1
            stats["graphs_max"] = max(stats["graphs_max"], alive)
        return x_in, y

    def backward(x_in, out, dy):
        nonlocal alive
        inputs = leaves + ([] if x_in is None else [x_in])
        with clock():
            got = torch.autograd.grad(out, inputs, grad_outputs=dy, allow_unused=True)
            for n, g in zip(names, got):
                if g is None:
                    continue
                if n in grads:
                    grads[n].add_(g)
                else:
                    grads[n] = g.to(grad_dtype)  # a new tensor of autograd's
        alive -= 1
        return None if x_in is None else got[-1]

    if schedule == "1f1b":
        warm = min(stage.size - 1 - stage.rank, nm)
        rest = nm - warm
        inflight = collections.deque()
        for m in range(warm):
            x = yield from recv_forward(m)
            x_in, out = forward(m, x, True)
            inflight.append((x_in, out))
            yield from send_forward(out)
        x = (yield from recv_forward(warm)) if rest else None
        for i in range(rest):
            m = warm + i
            x_in, out = forward(m, x, True)
            inflight.append((x_in, out))
            # send_forward_recv_backward (the backward's microbatch is i)
            got = yield from _p2p([] if stage.last else [(1, out.detach())],
                                  [] if stage.last else [(1, buffer(i))])
            dy = got[0] if got else None
            x_in_b, out_b = inflight.popleft()
            dx = backward(x_in_b, out_b, dy)
            if i == rest - 1:
                yield from send_backward(dx)
            else:
                # send_backward_recv_forward
                got = yield from _p2p([] if stage.first else [(-1, dx)],
                                      [] if stage.first else [(-1, buffer(m + 1))])
                x = got[0] if got else None
        for i in range(warm):
            dy = yield from recv_backward(rest + i)
            x_in_b, out_b = inflight.popleft()
            dx = backward(x_in_b, out_b, dy)
            yield from send_backward(dx)
    else:  # wavefront: every forward without a graph, then every backward
        saved = [None] * nm
        for m in range(nm):
            x = yield from recv_forward(m)
            _, out = forward(m, x, False)
            if x is not None:
                saved[m] = x
                held += 1
                stats["inputs_max"] = max(stats["inputs_max"], held)
            yield from send_forward(out)
            del out
        for m in range(nm):
            dy = yield from recv_backward(m)
            x_in, out = forward(m, saved[m], True, count_loss=False)
            if saved[m] is not None:
                saved[m] = None
                held -= 1
            dx = backward(x_in, out, dy)
            yield from send_backward(dx)
    return loss_acc, grads


def forward_body(stage: Stage, microbatches: list, denominator):
    """Generator of one rank's forward-only pass (the pipelined eval loss):
    the wavefront's forwards; returns the last rank's ``sum_m loss_sum_m /
    denominator`` (None on the others)."""
    loss_acc = None
    for m, mb in enumerate(microbatches):
        dev = next(iter(mb.values())).device
        x = None
        if not stage.first:
            (x,) = yield from _p2p([], [(-1, torch.empty(stage.act_shape(mb),
                                                          dtype=stage.act_dtype, device=dev))])
        with torch.no_grad():
            y = stage.layers(stage.embed(mb) if stage.first else x, mb)
            if stage.last:
                loss = stage.loss(y, mb)[0].float() / denominator
                loss_acc = loss if loss_acc is None else loss_acc + loss
        if not stage.last:
            yield from _p2p([(1, y)], [])
    return loss_acc


def bind_stage(params, hooks, rank: int, size: int, leaves: dict, act_dtype) -> Stage:
    """Pipeline rank ``rank``'s :class:`Stage` over ``params`` (a stage's
    tree, or in one process the whole model's): ``hooks`` are
    ``models/llama.py::pipeline_hooks``, ``leaves`` the trainable leaves by
    dotted name, of which the stage takes its layers' and the replicated
    ones."""
    embed_fn, stage_fn, loss_fn, act_shape = hooks
    mine = stage_layers(len(params["layers"]), rank, size)
    prefixes = tuple(f"layers.{i}." for i in mine)
    return Stage(rank=rank, size=size,
                 embed=lambda mb: embed_fn(params, mb),
                 layers=lambda x, mb: stage_fn([params["layers"][i] for i in mine], x, mb),
                 loss=lambda y, mb: loss_fn(params, y, mb),
                 leaves={n: t for n, t in leaves.items()
                         if not is_stage_leaf(n) or n.startswith(prefixes)},
                 act_shape=act_shape, act_dtype=act_dtype)


def loopback_step(params, hooks, microbatches: list, denominator, schedule: str, pp: int, *,
                  leaves: dict, act_dtype, grad_dtype=torch.float32,
                  stats: Optional[list] = None, timers: Optional[list] = None) -> tuple:
    """One step of every virtual pipeline rank in this process, on the one
    ``params`` tree they share: ``(loss, {name: gradient})``, each leaf's
    gradient summed over the ranks that computed one (:func:`fold_stage_grads`).
    ``stats`` and ``timers`` (lists of ``pp``) take each rank's
    :func:`stage_body` stats and timer."""
    bodies = [stage_body(bind_stage(params, hooks, r, pp, leaves, act_dtype), microbatches,
                         denominator, schedule, grad_dtype=grad_dtype,
                         stats=None if stats is None else stats[r],
                         timer=None if timers is None else timers[r]) for r in range(pp)]
    outs = loopback(bodies)
    return outs[-1][0], fold_stage_grads([g for _, g in outs])


def drive(body, pipe) -> Any:
    """Run one rank's body to its end, answering its stage hops over the
    pipe group (``parallel/mesh.py::PipelineParallel``); returns what the
    body returns."""
    try:
        request = next(body)
        while True:
            _, sends, recvs = request
            request = body.send(pipe.p2p(sends, recvs))
    except StopIteration as stop:
        return stop.value


def loopback(bodies: list) -> list:
    """Run the bodies of every virtual pipeline rank in this one process:
    each batch of hops delivers its sends to the neighbours' mailboxes (as
    the tensors themselves) and waits until every receive it asks for has
    arrived; returns each body's result, in rank order."""
    n = len(bodies)
    boxes = collections.defaultdict(collections.deque)  # (src, dst) -> tensors
    waiting: list = [None] * n
    out: list = [None] * n
    done = [False] * n

    def advance(r, value):
        try:
            _, sends, recvs = bodies[r].send(value)
        except StopIteration as stop:
            out[r], done[r] = stop.value, True
            return
        for off, t in sends:
            boxes[(r, r + off)].append(t)
        waiting[r] = recvs

    for r in range(n):
        advance(r, None)
    while not all(done):
        moved = False
        for r in range(n):
            if done[r]:
                continue
            need = collections.Counter(r + off for off, _ in waiting[r])
            if any(len(boxes[(src, r)]) < k for src, k in need.items()):
                continue
            got = []
            for off, buf in waiting[r]:
                t = boxes[(r + off, r)].popleft()
                if tuple(t.shape) != tuple(buf.shape) or t.dtype != buf.dtype:
                    raise RuntimeError(f"pipeline loopback: rank {r} expected "
                                       f"{tuple(buf.shape)} {buf.dtype} from rank {r + off}, "
                                       f"got {tuple(t.shape)} {t.dtype}")
                got.append(t)
            advance(r, got)
            moved = True
        if not moved:
            raise RuntimeError(f"pipeline loopback: no rank can proceed (waiting: "
                               f"{[None if d else [r + o for o, _ in w] for d, w in zip(done, waiting)]})")
    return out


def is_stage_leaf(name: str) -> bool:
    """Is the leaf of this dotted name (a state key ``mu/<name>`` too) one
    that a single pipeline stage holds (a layer's), rather than one
    replicated over ``pipe`` (the embedding, the final norm, the head)?"""
    return name.split("/")[-1].startswith("layers.")


def fold_stage_grads(per_rank: list) -> dict:
    """The gradients of a step that every virtual rank ran in one process:
    each leaf's, summed over the ranks that computed one in rank order (the
    embedding's and, tied, the head's on ``embed.embedding``)."""
    out: dict = {}
    for grads in per_rank:
        for n, g in grads.items():
            out[n] = g.clone() if n not in out else out[n].add_(g)
    return out


def sum_over_pipe(loss, grads: dict, shared: dict, pipe, dev) -> tuple:
    """Over the pipe group: the loss (the last rank's; None elsewhere) and
    the gradients of the replicated leaves ``shared`` (name -> leaf; zeros
    where a rank computed none), summed in one flat fp32 all-reduce on
    device ``dev``; returns ``(loss, grads)``."""
    loss = torch.zeros((), dtype=torch.float32, device=dev) if loss is None else loss
    for n, leaf in shared.items():
        if n not in grads:
            grads[n] = torch.zeros(leaf.shape, dtype=torch.float32, device=dev)
    parts = [grads[n] for n in shared] + [loss.reshape(1)]
    flat = pipe.all_reduce_(torch.cat([t.reshape(-1) for t in parts]))
    offset = 0
    for t in parts:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return parts[-1].reshape(()), grads


def trainer_fns(hooks, pipe, schedule: str, *, microbatches_of: Callable,
                denominator_of: Callable, act_dtype, grad_dtype=torch.float32,
                summed: Optional[Callable] = None) -> tuple:
    """``(loss_and_grad, eval_step)`` of a trainer at pp > 1 over the pipe
    group ``pipe``: ``loss_and_grad(params, batch, leaves) -> (loss, {},
    grads)`` for ``trainer/step.py::make_train_step`` (every one of
    ``leaves``'s gradients, the replicated ones and the loss summed over
    ``pipe``), and ``eval_step(params, batch)``, the forward schedule's loss
    summed over ``pipe`` and, with ``summed``, the data axis.
    ``microbatches_of(batch)`` gives the rank's microbatches (its data rows),
    ``denominator_of(batch)`` the whole global batch's valid-token count."""

    def loss_and_grad(params, batch, leaves: dict):
        stage = bind_stage(params, hooks, pipe.rank, pipe.size, leaves, act_dtype)
        loss, grads = drive(stage_body(stage, microbatches_of(batch), denominator_of(batch),
                                       schedule, grad_dtype=grad_dtype), pipe)
        shared = {n: t for n, t in leaves.items() if not is_stage_leaf(n)}
        dev = next(iter(batch.values())).device
        loss, grads = sum_over_pipe(loss, grads, shared, pipe, dev)
        for n, t in leaves.items():
            if n not in grads:
                grads[n] = torch.zeros(t.shape, dtype=grad_dtype, device=t.device)
        return loss, {}, grads

    @torch.no_grad()
    def eval_step(params, batch):
        stage = bind_stage(params, hooks, pipe.rank, pipe.size, {}, act_dtype)
        loss = drive(forward_body(stage, microbatches_of(batch), denominator_of(batch)), pipe)
        dev = next(iter(batch.values())).device
        loss = pipe.all_reduce_(torch.zeros(1, dtype=torch.float32, device=dev)
                                if loss is None else loss.reshape(1))
        return (loss if summed is None else summed(loss)).reshape(())

    return loss_and_grad, eval_step
