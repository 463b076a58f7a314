"""Pipeline parallelism over the ``pipe`` mesh axis (counterpart of the JAX
package's ``parallel/pipeline.py``).

Host side, copied from the JAX package with its texts: the stage split
(:func:`stage_layer_slice`, :func:`to_interleaved` / :func:`from_interleaved`
over the port's list of layers), the schedule gate (:func:`blocked_1f1b_reason`,
:func:`supports_1f1b`, :func:`resolve_schedule`), the compacted work table of
the manual-backward schedules (:func:`work_table`, plain numpy) and the bubble
model (:func:`ring_slot_counts`, :func:`bubble_multiplier`,
:func:`predicted_bubble_fraction`), and :func:`ce_denominator`.

Executors.  Pipeline rank ``r`` of ``pp`` holds ``vp`` chunks
(``virtual_pipeline_model_parallel_size``): chunk ``c`` is stage ``s = c pp
+ r``, layers ``[s Lc, (s + 1) Lc)`` (``Lc = L / (pp vp)``, JAX's
``to_interleaved``; :func:`stage_chunks`); the embedding, the final norm and
the head are replicated over ``pipe``.  Chunk 0 of rank 0 embeds, the last
chunk of the last rank applies the final norm, the head and the
cross-entropy, and the activations cross the stages point to point: rank
``r``'s chunk ``c`` feeds rank ``r + 1``'s, and the last rank's chunk ``c``
feeds rank 0's chunk ``c + 1``, so the hops wrap modulo ``pp``; cotangents
go back the same way.  One rank's step is a generator, :func:`stage_body`,
that walks its part of :func:`exchange_plan` and *yields* its stage hops:
``("p2p", sends, recvs)``, each a list of ``(offset, tensor)`` with offset
+1 (the next rank) or -1 (the previous), a receive's tensor being the
buffer to fill; it is sent back the received tensors.  The plan plays every
rank's order in lockstep ticks, so a send and its receive are in the same
batch of hops on both sides, each batch waits only for work of earlier
ticks and two neighbours never both wait on a send (at pp 2 both are one
rank: the two sides post in one order, activations first).  :func:`drive`
answers the yields over the pipe group (``parallel/mesh.py::
PipelineParallel``, batched ``isend`` / ``irecv``); :func:`loopback`
answers those of every virtual rank in one process (the tests, and one card
in ``chip_smoke.py``).

Schedules (every one gives the same loss and gradients, bit for bit: a
schedule is an order of work, and each rank runs a chunk's backwards in
microbatch order):

- ``1f1b`` (vp 1) and ``1f1b-interleaved`` (vp > 1): forwards in groups of
  ``pp`` microbatches through every chunk (:func:`_fwd_order`; the last
  group ragged when ``pp`` does not divide ``nm``, which must be at least
  ``pp`` at vp > 1, as in JAX), backwards in the same groups with the
  chunks descending (:func:`_bwd_order`), at most Megatron's warm-up plus
  one stage forwards alive on a rank (:func:`warmup_bound`: ``pp - r`` at
  vp 1).  Each forward keeps its autograd graph until its backward and
  nothing is recomputed.  JAX's 1F1B runs a ``scan`` over the compacted
  table, which cannot keep a graph across ticks: it recomputes each stage
  inside its backward tick and holds up to ``2 pp - 1`` stage inputs on
  rank 0.  The port spends memory (the graphs) where JAX spends a forward;
  the port's :func:`work_table` still serves
  :func:`predicted_bubble_fraction`.
- ``1f1b-zb`` (vp 1, JAX's ``zero_bubble``): ``1f1b``'s order, with each
  backward split.  The B pass asks autograd for the stage input's and the
  norms' and embedding's gradients alone, so it skips every layer weight's
  ``x^T dy``; ``ops/linear.py::WeightGradSplit`` records each layer
  ``x @ w`` in the forward and queues ``(w, x, dy)`` as the B pass reaches
  it; microbatch ``m``'s weight pass (W) runs right after the backward of
  ``m + r``, JAX's deferral of ``r`` ticks, so rank ``r`` holds at most
  ``r + 1`` microbatches' queues.  The head's weight keeps its gradient in
  the B pass, as JAX's head tick does.
- ``wavefront`` (any vp): every forward, then every backward.  A forward
  runs without a graph and keeps only its stage input; its backward
  recomputes the stage forward first, JAX's ``jax.checkpoint`` wavefront's
  memory class at one stage forward more per microbatch.

Each stage's backward is ``torch.autograd.grad`` of its output with the
received cotangent (of ``loss_m / denominator`` on the last stage), over
the chunk's trainable leaves and its input; the leaves' gradients
accumulate in fp32 in microbatch order.  The loss is ``sum_m loss_sum_m /
denominator``, ``denominator`` the valid-token count of the whole global
batch (the pair or example count under preference alignment), JAX's
pipelined rule (not the unpipelined mean of the microbatches' means): the
two agree only when every microbatch has the same count.  The replicated
leaves' gradients (the embedding's on rank 0, the final norm's and the
head's on the last rank; with tied embeddings both land on
``embed.embedding``, JAX's ``fold_grads``) and the loss are then summed over
``pipe`` (:func:`sum_over_pipe`), so every rank holds the whole loss and
whole gradients of what it holds.  :func:`forward_rows` runs the forwards
alone for the reference pass of DPO and KTO.

A MoE model's stage returns ``(x, aux)`` (``models/mixtral.py``: the sum of
its layers' router-loss shares; JAX's ``stage_aux``).  With ``aux_scale``
set, each stage forward's ``aux`` is kept with its graph, its backward
asks autograd for ``aux_scale`` times its gradient beside the output's,
and the rank's loss adds ``aux_scale`` times the sum of its ``aux`` over
the microbatches (the trainer's scale is ``1 / (nm num_moe_layers)``), so
the loss summed over ``pipe`` is JAX's ``loss_sum / denominator + aux_scale
aux_sum`` and the gradients are its gradients.
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


#: the schedules the executors run
EXECUTED_SCHEDULES = ("1f1b", "1f1b-interleaved", "1f1b-zb", "wavefront")


def check_microbatches(pp: int, nm: int, vp: int) -> None:
    """The circular schedules' bound on the microbatches, with JAX's text."""
    if vp > 1 and 1 < pp and nm < pp:
        raise ValueError(
            f"interleaved pipeline needs num_microbatches >= pp "
            f"(got nm={nm}, pp={pp}, vp={vp})"
        )


def stage_chunks(num_layers: int, rank: int, pp: int, vp: int = 1) -> list[range]:
    """The global layer indices of each of pipeline rank ``rank``'s ``vp``
    chunks: chunk ``c`` is stage ``s = c pp + rank``, layers ``[s Lc, (s +
    1) Lc)`` (:func:`to_interleaved`)."""
    lc = stage_layer_slice(num_layers, pp, vp)
    return [range((c * pp + rank) * lc, (c * pp + rank + 1) * lc) for c in range(vp)]


def stage_layers(num_layers: int, rank: int, pp: int, vp: int = 1) -> list[int]:
    """The global indices of every layer pipeline rank ``rank`` holds."""
    return [i for chunk in stage_chunks(num_layers, rank, pp, vp) for i in chunk]


def warmup_bound(schedule: str, pp: int, nm: int, vp: int, rank: int) -> int:
    """The most stage forwards rank ``rank`` keeps alive (with their graphs)
    under a manual schedule: Megatron's warm-up count plus one, ``pp - r``
    at vp 1 and ``2 (pp - r - 1) + (vp - 1) pp + 1`` at vp > 1, at most
    ``nm vp``; unbounded (``nm vp``) for the wavefront and the eval pass."""
    total = nm * vp
    if schedule not in MANUAL_VJP_SCHEDULES:
        return total
    warm = 2 * (pp - rank - 1) + (vp - 1) * pp if vp > 1 else pp - rank - 1
    return min(warm + 1, total)


@functools.lru_cache(maxsize=None)
def exchange_plan(schedule: str, pp: int, nm: int, vp: int = 1) -> tuple:
    """Every rank's step as a list of ``(op, sends, recvs)``: ``op`` is
    ``(kind, chunk, microbatch)`` or None, ``kind`` ``f`` a stage forward,
    ``b`` its backward, ``w`` (``1f1b-zb``) a microbatch's deferred weight
    gradients; ``sends`` / ``recvs`` are tuples of ``(offset, key)``,
    offset +1 the next rank and -1 the previous, modulo ``pp``.

    The ranks are played in lockstep ticks.  Each rank runs its forwards
    in :func:`_fwd_order` and its backwards in :func:`_bwd_order` (groups of
    ``pp`` microbatches through every chunk, the last group ragged when
    ``pp`` does not divide ``nm``; chunks descending in the backward).  At a
    tick a rank runs, in this order of preference: a weight pass due
    (``1f1b-zb``: microbatch ``m``'s right after the backward of ``m + r``,
    JAX's deferral of ``r`` ticks); its next backward, once its cotangent
    has arrived (the wavefront: once every forward is done); its next
    forward, once its input has arrived and while fewer than
    :func:`warmup_bound` forwards are alive.  At vp 1 that is Megatron's
    1F1B order, at vp > 1 its interleaved one; a tick where no rank can
    run lifts the bound for that tick (a ragged last group can leave
    Megatron's warm-up short: at pp 4, vp 3, nm 5 for one).  What a tick's
    ops produce crosses to the neighbours in one batch of hops at the
    tick's end, so a send and its receive are in the same tick on both
    sides and each batch waits only for work of earlier ticks: no two
    neighbours ever both wait on a send.  A batch holds at most one
    activation and one cotangent each way, activations first.  Each rank's
    backwards of a chunk run in microbatch order, so every schedule adds a
    leaf's gradients in the same order."""
    fo = _fwd_order(pp, nm, vp)
    bo = [] if schedule == "forward" else _bwd_order(pp, nm, vp)
    total, at = len(fo), {k: i for i, k in enumerate(fo)}
    bound = [warmup_bound(schedule, pp, nm, vp, r) for r in range(pp)]
    fi, bi, alive = [0] * pp, [0] * pp, [0] * pp
    dues: list = [collections.deque() for _ in range(pp)]
    have: list = [set() for _ in range(pp)]
    steps: list = [[] for _ in range(pp)]
    first = lambda c, r: c == 0 and r == 0  # noqa: E731
    last = lambda c, r: c == vp - 1 and r == pp - 1  # noqa: E731

    def ready_b(r):
        if bi[r] == len(bo) or (schedule == "wavefront" and fi[r] < total):
            return False
        c, m = bo[bi[r]]
        return at[(c, m)] < fi[r] and (last(c, r) or ("b", c, m) in have[r])

    def ready_f(r):
        if fi[r] == total:
            return False
        c, m = fo[fi[r]]
        return first(c, r) or ("f", c, m) in have[r]

    while any(fi[r] < total or bi[r] < len(bo) or dues[r] for r in range(pp)):
        ran: list = [None] * pp
        for lift in (False, True):
            for r in range(pp):
                if dues[r]:
                    ran[r] = ("w", 0, dues[r].popleft())
                elif ready_b(r):
                    c, m = bo[bi[r]]
                    ran[r], bi[r], alive[r] = ("b", c, m), bi[r] + 1, alive[r] - 1
                    have[r].discard(("b", c, m))
                    if schedule == "1f1b-zb":
                        dues[r].extend([m - r] if m >= r else [])
                        if bi[r] == len(bo):
                            dues[r].extend(range(max(nm - r, 0), nm))
                elif ready_f(r) and (lift or alive[r] < bound[r]):
                    c, m = fo[fi[r]]
                    ran[r], fi[r], alive[r] = ("f", c, m), fi[r] + 1, alive[r] + 1
                    have[r].discard(("f", c, m))
            if any(ran):
                break
        else:
            raise AssertionError(f"pipeline schedule {schedule} (pp={pp}, nm={nm}, vp={vp}) "
                                 f"cannot finish")
        sends: list = [[] for _ in range(pp)]
        recvs: list = [[] for _ in range(pp)]
        for kind, off in (("f", 1), ("b", -1)):
            for r, op in enumerate(ran):
                if op is None or op[0] != kind or (last if kind == "f" else first)(op[1], r):
                    continue
                dst = (r + off) % pp
                wrap = (r == pp - 1) if kind == "f" else (r == 0)
                key = (kind, op[1] + off * wrap, op[2])
                sends[r].append((off, key))
                recvs[dst].append((-off, key))
                have[dst].add(key)
        for r in range(pp):
            if ran[r] or sends[r] or recvs[r]:
                steps[r].append((ran[r], tuple(sends[r]), tuple(recvs[r])))
    return tuple(tuple(s) for s in steps)


@dataclasses.dataclass
class Stage:
    """What pipeline rank ``rank`` of ``size`` runs of the model in a step.
    ``embed(mb)`` (chunk 0 of rank 0), ``layers[c](x, mb)`` (chunk ``c``'s
    layers, one callable per virtual rank) and ``loss(y, mb) -> (loss_sum,
    valid_count)`` (the last chunk of the last rank) are
    ``models/llama.py::pipeline_hooks`` bound to the rank's params;
    ``leaves`` are the rank's trainable leaves by name, ``chunks`` the
    global layer indices of each chunk; ``act_shape(mb)`` and ``act_dtype``
    describe the activations that cross the stages."""

    rank: int
    size: int
    embed: Callable
    layers: list
    loss: Callable
    leaves: dict
    chunks: list
    act_shape: Callable
    act_dtype: torch.dtype
    #: the layers return ``(x, aux)``, whose sum enters the loss times this
    #: (None: they return ``x``)
    aux_scale: Optional[float] = None

    @property
    def vp(self) -> int:
        return len(self.layers)

    @property
    def first(self) -> bool:
        return self.rank == 0

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1

    def chunk_leaves(self, c: int) -> dict:
        """The leaves chunk ``c`` may touch: its layers' and the replicated
        ones."""
        mine = self.chunks[c]
        return {n: t for n, t in self.leaves.items()
                if not is_stage_leaf(n) or int(n.split(".")[1]) in mine}


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
    """Generator of one pipeline rank's step (see the module docstring),
    walking :func:`exchange_plan`.  Returns ``(loss, grads)``: on the last
    rank the fp32 ``sum_m loss_sum_m / denominator`` (None on the others),
    and ``{name: fp32 gradient}`` of the leaves that got one.  ``stats`` (a
    dict) receives ``graphs_max`` (the most stage forwards whose graphs were
    alive at once), ``inputs_max`` (the most stage inputs held for a
    recompute), and under ``1f1b-zb`` ``deferred_max`` / ``deferred_bytes_max``
    (the most microbatches, and bytes, whose weight pass was pending);
    ``timer()``, if given, is a context manager around each stage
    computation.  ``schedule`` ``forward`` runs the forwards alone, with no
    graph (the eval pass); with ``denominator`` None it returns, on the
    last rank, the list of each microbatch's ``loss(y, mb)[0]`` in place
    of the loss (the reference pass's log-probs)."""
    from neuronx_distributed_training_torch.ops import linear as linear_ops

    if denominator is None and schedule != "forward":
        raise ValueError("a training schedule needs the loss denominator")
    if schedule not in EXECUTED_SCHEDULES + ("forward",):
        raise ValueError(f"the executors run {'/'.join(EXECUTED_SCHEDULES)}, not {schedule!r}")
    nm, r = len(microbatches), stage.rank
    if denominator is not None:
        check_microbatches(stage.size, nm, stage.vp)
    if schedule == "1f1b-zb" and stage.vp > 1:
        raise ValueError("zero_bubble (1f1b-zb) is vp == 1 only; the interleaved chunk "
                         "ring has no per-rank cooldown window to defer wgrads into")
    plan = exchange_plan(schedule, stage.size, nm, stage.vp)[r]
    keep_graph = schedule in MANUAL_VJP_SCHEDULES
    split = linear_ops.WeightGradSplit() if schedule == "1f1b-zb" else None
    names_of = {id(t): n for n, t in stage.leaves.items()}
    chunk_leaves = [list(stage.chunk_leaves(c).items()) for c in range(stage.vp)]
    grads: dict = {}
    loss_acc = None
    aux_acc = None  # the rank's sum of its stages' aux (stage_aux)
    outputs: list = [None] * nm
    inbox: dict = {}
    inflight: dict = {}  # (c, m) -> (stage input, output) with their graph
    saved: dict = {}  # wavefront: (c, m) -> the stage input
    deferred: dict = {}  # 1f1b-zb: m -> [(leaf, x, dy)]
    stats = {} if stats is None else stats
    stats.update(graphs_max=0, inputs_max=0)
    if split is not None:
        stats.update(deferred_max=0, deferred_bytes_max=0)
    clock = timer or contextlib.nullcontext

    def is_first(c):
        return c == 0 and stage.first

    def is_last(c):
        return c == stage.vp - 1 and stage.last

    def buffer(m):
        dev = next(iter(microbatches[m].values())).device
        return torch.empty(stage.act_shape(microbatches[m]), dtype=stage.act_dtype, device=dev)

    def accumulate(n, g):
        if n in grads:
            grads[n].add_(g)
        else:
            grads[n] = g.to(grad_dtype)  # a new tensor of autograd's

    def forward(c, m, graph: bool, count_loss: bool = True):
        nonlocal loss_acc, aux_acc
        mb = microbatches[m]
        x = None if is_first(c) else (saved[(c, m)] if (c, m) in saved
                                      else inbox.pop(("f", c, m)))
        watch = linear_ops.split_weight_grads(split) if split is not None and graph \
            else contextlib.nullcontext()
        with clock(), (contextlib.nullcontext() if graph else torch.no_grad()):
            if x is None:
                x_in, h = None, stage.embed(mb)
            else:
                x_in = h = x.detach().requires_grad_(graph)
            with watch:  # the layers' weights alone: the head's gradient stays in B
                y = stage.layers[c](h, mb)
            aux = None
            if stage.aux_scale is not None:
                y, aux = y
                if count_loss and denominator is not None:
                    a = aux.detach().float()
                    aux_acc = a if aux_acc is None else aux_acc + a
                if not stage.aux_scale or not aux.requires_grad:
                    aux = None  # nothing of it reaches the loss's gradient
            if is_last(c) and denominator is None:
                outputs[m] = y = stage.loss(y, mb)[0]
            elif is_last(c):
                y = stage.loss(y, mb)[0].float() / denominator
                if count_loss:
                    loss_acc = y.detach() if loss_acc is None else loss_acc + y.detach()
        return x, x_in, (y, aux)

    def backward(c, m, x_in, out, dy):
        pairs = chunk_leaves[c]
        if split is not None:
            pairs = [(n, t) for n, t in pairs if id(t) not in split.leaves]
            split.sink = deferred.setdefault(m, [])
        inputs = [t for _, t in pairs] + ([] if x_in is None else [x_in])
        y, aux = out
        outs, dys = [y], [dy]
        if aux is not None:  # the stage's router loss, times its scale
            outs.append(aux)
            dys.append(torch.full_like(aux, stage.aux_scale))
        with clock():
            got = torch.autograd.grad(outs, inputs, grad_outputs=dys, allow_unused=True)
            for (n, _), g in zip(pairs, got):
                if g is not None:
                    accumulate(n, g)
        if split is not None:
            split.sink = None
            stats["deferred_max"] = max(stats["deferred_max"], len(deferred))
            stats["deferred_bytes_max"] = max(stats["deferred_bytes_max"], sum(
                x.numel() * x.element_size() + dy.numel() * dy.element_size()
                for entries in deferred.values() for _, x, dy in entries))
        return None if x_in is None else got[-1]

    def weight_pass(m):
        with clock(), torch.no_grad():
            for leaf, x, dy in deferred.pop(m):
                accumulate(names_of[id(leaf)], linear_ops.weight_grad(leaf, x, dy))

    for op, sends, recvs in plan:
        out_of = {}
        if op is not None:
            kind, c, m = op
            if kind == "f":
                x, x_in, out = forward(c, m, keep_graph)
                if keep_graph:
                    inflight[(c, m)] = (x_in, out)
                    stats["graphs_max"] = max(stats["graphs_max"], len(inflight))
                elif schedule == "wavefront" and x is not None:
                    saved[(c, m)] = x
                    stats["inputs_max"] = max(stats["inputs_max"], len(saved))
                out_of["f"] = out[0].detach()
                del out
            elif kind == "b":
                dy = None if is_last(c) else inbox.pop(("b", c, m))
                if keep_graph:
                    x_in, out = inflight.pop((c, m))
                else:  # wavefront: recompute the stage with its graph
                    _, x_in, out = forward(c, m, True, count_loss=False)
                    saved.pop((c, m), None)
                    stats["graphs_max"] = max(stats["graphs_max"], 1)
                dx = backward(c, m, x_in, out, dy)
                del x_in, out
                if dx is not None:
                    out_of["b"] = dx
            else:
                weight_pass(m)
        got = yield from _p2p([(off, out_of[key[0]]) for off, key in sends],
                              [(off, buffer(key[2])) for off, key in recvs])
        for (_, key), t in zip(recvs, got):
            inbox[key] = t
    if denominator is None:
        return (outputs if stage.last else None), grads
    if aux_acc is not None:  # this rank's layers' router losses join its loss
        aux_acc = stage.aux_scale * aux_acc
        loss_acc = aux_acc if loss_acc is None else loss_acc + aux_acc
    return loss_acc, grads


def forward_body(stage: Stage, microbatches: list, denominator=None):
    """Generator of one rank's forward-only pass (the pipelined eval loss):
    the forwards of :func:`stage_body` without a graph; returns the last
    rank's ``sum_m loss_sum_m / denominator`` (None on the others), or with
    ``denominator`` None the last rank's list of ``loss(y, mb)[0]`` a
    microbatch (:func:`forward_outputs`)."""
    loss, _ = yield from stage_body(stage, microbatches, denominator, "forward")
    return loss


def bind_stage(params, hooks, rank: int, size: int, leaves: dict, act_dtype,
               vp: int = 1, aux_scale: Optional[float] = None) -> Stage:
    """Pipeline rank ``rank``'s :class:`Stage` over ``params`` (a stage's
    tree, or in one process the whole model's): ``hooks`` are
    ``models/llama.py::pipeline_hooks`` (``models/mixtral.py``'s with
    ``aux_scale``), ``leaves`` the trainable leaves by dotted name, of which
    the stage takes its chunks' layers' and the replicated ones.  Chunk
    ``c``'s microbatches carry ``_chunk: c``, as JAX's do, and ``_pipe:
    rank`` (JAX's ``axis_index("pipe")``), the folds of a stage's dropout
    key (``models/gpt.py``)."""
    embed_fn, stage_fn, loss_fn, act_shape = hooks
    chunks = stage_chunks(len(params["layers"]), rank, size, vp)
    mine = {i for chunk in chunks for i in chunk}

    def layers(c):
        return lambda x, mb: stage_fn([params["layers"][i] for i in chunks[c]], x,
                                      {**mb, "_chunk": c, "_pipe": rank})

    return Stage(rank=rank, size=size,
                 embed=lambda mb: embed_fn(params, mb),
                 layers=[layers(c) for c in range(vp)],
                 loss=lambda y, mb: loss_fn(params, y, mb),
                 leaves={n: t for n, t in leaves.items()
                         if not is_stage_leaf(n) or int(n.split(".")[1]) in mine},
                 chunks=chunks, act_shape=act_shape, act_dtype=act_dtype, aux_scale=aux_scale)


def loopback_step(params, hooks, microbatches: list, denominator, schedule: str, pp: int, *,
                  leaves: dict, act_dtype, grad_dtype=torch.float32, vp: int = 1,
                  stats: Optional[list] = None, timers: Optional[list] = None,
                  aux_scale: Optional[float] = None) -> tuple:
    """One step of every virtual pipeline rank in this process, on the one
    ``params`` tree they share: ``(loss, {name: gradient})``, each leaf's
    gradient summed over the ranks that computed one (:func:`fold_stage_grads`).
    ``stats`` and ``timers`` (lists of ``pp``) take each rank's
    :func:`stage_body` stats and timer; with ``aux_scale`` the loss is the
    ranks' losses summed (each adds its router losses)."""
    bodies = [stage_body(bind_stage(params, hooks, r, pp, leaves, act_dtype, vp, aux_scale),
                         microbatches,
                         denominator, schedule, grad_dtype=grad_dtype,
                         stats=None if stats is None else stats[r],
                         timer=None if timers is None else timers[r]) for r in range(pp)]
    outs = loopback(bodies)
    losses = [loss for loss, _ in outs if loss is not None]
    loss = losses[-1] if aux_scale is None else functools.reduce(lambda a, b: a + b, losses)
    return loss, fold_stage_grads([g for _, g in outs])


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
    the tensors themselves; offsets wrap modulo the ranks) and waits until
    every receive it asks for has arrived; returns each body's result, in
    rank order."""
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
            boxes[(r, (r + off) % n)].append(t)
        waiting[r] = recvs

    for r in range(n):
        advance(r, None)
    while not all(done):
        moved = False
        for r in range(n):
            if done[r]:
                continue
            need = collections.Counter((r + off) % n for off, _ in waiting[r])
            if any(len(boxes[(src, r)]) < k for src, k in need.items()):
                continue
            got = []
            for off, buf in waiting[r]:
                src = (r + off) % n
                t = boxes[(src, r)].popleft()
                if tuple(t.shape) != tuple(buf.shape) or t.dtype != buf.dtype:
                    raise RuntimeError(f"pipeline loopback: rank {r} expected "
                                       f"{tuple(buf.shape)} {buf.dtype} from rank {src}, "
                                       f"got {tuple(t.shape)} {t.dtype}")
                got.append(t)
            advance(r, got)
            moved = True
        if not moved:
            raise RuntimeError(f"pipeline loopback: no rank can proceed (waiting: "
                               f"{[None if d else [(r + o) % n for o, _ in w] for r, (d, w) in enumerate(zip(done, waiting))]})")
    return out


def forward_rows(params, hooks, pipe, microbatches: list, *, act_dtype, vp: int = 1,
                 aux_scale: Optional[float] = None) -> torch.Tensor:
    """The pipelined forward of ``microbatches`` over the pipe group
    ``pipe``, with no graph, whose last stage applies ``hooks``'s loss
    hook, there a fp32 value per row: the values of every microbatch's rows
    in order, on every rank (the last rank's, summed over ``pipe`` with
    zeros elsewhere).  The reference pass of DPO and KTO under pipeline
    parallelism takes its log-probs this way."""
    with torch.no_grad():
        stage = bind_stage(params, hooks, pipe.rank, pipe.size, {}, act_dtype, vp, aux_scale)
        outs = drive(forward_body(stage, microbatches), pipe)
        rows = [next(iter(mb.values())).shape[0] for mb in microbatches]
        dev = next(iter(microbatches[0].values())).device
        flat = (torch.zeros(sum(rows), dtype=torch.float32, device=dev) if outs is None
                else torch.cat([o.float().reshape(-1) for o in outs]))
        return pipe.all_reduce_(flat)


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
                summed: Optional[Callable] = None, vp: int = 1,
                aux_scale: Optional[float] = None) -> tuple:
    """``(loss_and_grad, eval_step)`` of a trainer at pp > 1 over the pipe
    group ``pipe``: ``loss_and_grad(params, batch, leaves) -> (loss, {},
    grads)`` for ``trainer/step.py::make_train_step`` (every one of
    ``leaves``'s gradients, the replicated ones and the loss summed over
    ``pipe``), and ``eval_step(params, batch)``, the forward schedule's loss
    summed over ``pipe`` and, with ``summed``, the data axis.
    ``microbatches_of(batch)`` gives the rank's microbatches (its data rows),
    ``denominator_of(batch)`` the whole global batch's valid-token count;
    with a dropout ``key`` (``utils/prng.py``) ``microbatches_of(batch,
    key)`` gives each microbatch its ``_rng``.  ``aux_scale``: the stages
    return ``(x, aux)`` (see :class:`Stage`)."""

    def loss_and_grad(params, batch, leaves: dict, key=None):
        stage = bind_stage(params, hooks, pipe.rank, pipe.size, leaves, act_dtype, vp,
                           aux_scale)
        mbs = microbatches_of(batch) if key is None else microbatches_of(batch, key)
        loss, grads = drive(stage_body(stage, mbs, denominator_of(batch), schedule,
                                       grad_dtype=grad_dtype), pipe)
        shared = {n: t for n, t in leaves.items() if not is_stage_leaf(n)}
        dev = next(iter(batch.values())).device
        loss, grads = sum_over_pipe(loss, grads, shared, pipe, dev)
        for n, t in leaves.items():
            if n not in grads:
                grads[n] = torch.zeros(t.shape, dtype=grad_dtype, device=t.device)
        return loss, {}, grads

    @torch.no_grad()
    def eval_step(params, batch):
        stage = bind_stage(params, hooks, pipe.rank, pipe.size, {}, act_dtype, vp, aux_scale)
        loss = drive(forward_body(stage, microbatches_of(batch), denominator_of(batch)), pipe)
        dev = next(iter(batch.values())).device
        loss = pipe.all_reduce_(torch.zeros(1, dtype=torch.float32, device=dev)
                                if loss is None else loss.reshape(1))
        return (loss if summed is None else summed(loss)).reshape(())

    return loss_and_grad, eval_step
