"""The pre-flight audit, re-based on a run (counterpart of the JAX package's
``analysis/graph_audit.py``).

JAX AOT-lowers the train step a config describes and checks the compiled
artifact.  Eager PyTorch has no such artifact: the port runs **one step**
of the (shrunk) config at the shrunk world and checks what that step did,
with JAX's rule IDs and severities:

- **GA000** the config fails to load, or the trainer fails to assemble or
  to run its step (the message names the failing subsystem);
- **GA001** in place: the optimizer step must update every param and
  optimizer-state leaf in its own storage.  Each leaf's storage pointer is
  compared before and after the step; a reallocated leaf is the port's
  "donated but copied" (its bytes are resident twice at the update).  The
  0-d counters are left out (:func:`storage_pointers`);
- **GA101 / GA102** the collective census (``telemetry/census.py::
  count_collectives``, JAX's kinds) against the parallel config: a kind the
  config cannot explain, or a kind it needs and the step lacks;
- **GA201** the largest tensor the step allocates (every op's output, seen
  through a ``TorchDispatchMode``) against :func:`expected_max_device_bytes`
  times the slack;
- **GA301** an fp32 x fp32 ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` under
  a bf16 compute regime, from the same dispatch mode; an operand widened
  from bf16 by a cast (the policy's own promotion, also after ops that
  only move its values, :data:`MOVEMENT_OPS`) and the MoE router's
  products (a trailing dim of ``num_experts``) are exempt, as in JAX;
- **GA401** a leaf layout (``parallel/sharding.py``) naming an axis the
  mesh lacks, or a dim its leaf lacks (:func:`spec_errors`).

The step runs on the card when the machine has as many cards as the shrunk
world, else on that many spawned gloo ranks on the CPU (``utils/launch.py``
through ``NXDT_*``); a one-rank audit on the CPU runs in this process, and
one on a card in a spawned process, so its kernel launches never count in
the caller's.  The CPU's ranks serve only ``device='cpu'`` or a world larger
than the cards present: with no card and no ``device='cpu'`` the audit
raises.  ``stats["audit_device"]`` names where it ran.  The audit is
a structural check at toy size: the trainer's own run never falls back.
``stats["collectives"]`` (``{kind: count}`` of rank 0) and
``stats["memory_bytes"]`` (``torch.cuda.max_memory_allocated`` on the card;
on the CPU the state's bytes plus the step's peak of live bytes the
dispatch mode saw) feed the planner as JAX's do.  ``stats["fingerprint"]``
is the same step's graph-contract fingerprint (``analysis/graph_contract.py``:
the census by mesh axes with each call's source, the in-place map, the
matmul dtype census, the memory), so a contract check never runs a second
step.

Large configs audit through :func:`shrink_overrides` (JAX's, with one
deliberate change: where flash attention is on, head_dim is 64, not JAX's
16: the Hopper kernels tile d 64 and 128 only, and at 16 the audit would
run the core fallback instead of the structure that trains).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path
from typing import Any, Mapping, Optional

from neuronx_distributed_training_torch.analysis.report import AuditReport

logger = logging.getLogger(__name__)

#: JAX's collective kinds, the census's vocabulary
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute",
                    "all-to-all")
#: the matmul ops GA301 inspects
MATMUL_OPS = ("mm", "bmm", "addmm", "baddbmm")
#: ops that move or copy values without arithmetic: a widened operand's
#: copy (matmul's own reshapes, a GQA repeat) is still bf16-valued data
MOVEMENT_OPS = frozenset({
    "clone", "_unsafe_view", "view", "reshape", "expand", "transpose", "t", "permute",
    "unsqueeze", "squeeze", "repeat_interleave", "repeat", "index_select", "cat", "stack",
    "slice", "select", "narrow", "as_strided", "alias", "detach", "copy", "_to_copy",
    "expand_copy", "view_copy", "unfold"})
#: head_dim of a shrunk config with flash attention (the kernels' d 64 / 128)
FLASH_SHRUNK_HEAD_DIM = 64
#: head_dim of a shrunk config without it (JAX's)
SHRUNK_HEAD_DIM = 16
#: torch threads of each spawned CPU rank (they share the host)
CPU_RANK_THREADS = 2
#: the one-step run's time limit in the spawned ranks, seconds
AUDIT_TIMEOUT_SECONDS = 900.0


# --------------------------------------------------------------------------
# the audit context: what the rules read, from a live trainer
# --------------------------------------------------------------------------


@dataclasses.dataclass
class AuditContext:
    cfg: Any                 # the (possibly shrunk) ConfigDict
    axes: dict               # mesh axis -> size ("data", "model", "pipe", ...)
    policy: Any              # DtypePolicy
    model_cfg: Any
    sched: Mapping[str, int]
    #: ``params/<name>`` and ``opt_state/<group>/<name>`` -> local tensor
    leaves: dict = dataclasses.field(default_factory=dict)
    #: param name -> ``parallel/sharding.py::LeafLayout``
    layouts: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_trainer(cls, trainer: Any) -> "AuditContext":
        from neuronx_distributed_training_torch.parallel.mesh import AXES

        axes = {a: 1 for a in AXES}
        for axis, ax in (("data", trainer.dp), ("model", trainer.tp), ("context", trainer.cp),
                         ("pipe", trainer.pp), ("expert", trainer.ep)):
            if ax is not None:
                axes[axis] = int(getattr(ax, "size", 1) or 1)
        if trainer.ep is not None:
            # the expert axis carves the data axis (JAX's DATA_AXES)
            axes["data"] = max(axes["data"] // axes["expert"], 1)
        return cls(cfg=trainer.cfg, axes=axes, policy=trainer.policy,
                   model_cfg=trainer.model_cfg, sched=trainer.sched,
                   leaves=state_leaves(trainer.params, trainer.opt_state),
                   layouts=dict(trainer.layouts))

    @property
    def ds(self) -> dict:
        return dict(self.cfg.get("distributed_strategy", {}) or {})

    @property
    def fusions(self) -> dict:
        return dict((self.cfg.get("model", {}) or {}).get("fusions", {}) or {})

    def axis(self, name: str) -> int:
        return int(self.axes.get(name, 1))


def _local(t):
    """A DTensor's local shard, else the tensor."""
    to_local = getattr(t, "to_local", None)
    return to_local() if callable(to_local) else t


def state_leaves(params: Any, opt_state: Mapping) -> dict:
    """``params/<name>`` and ``opt_state/<group>[/<name>]`` -> the local
    tensor of each leaf (flatten order: the names sorted)."""
    import torch

    from neuronx_distributed_training_torch.models.llama import named_params

    out = {f"params/{n}": _local(t) for n, t in sorted(named_params(params).items())}

    def walk(prefix: str, v: Any) -> None:
        if isinstance(v, Mapping):
            for k in sorted(v, key=str):
                walk(f"{prefix}/{k}", v[k])
        elif isinstance(v, torch.Tensor):
            out[prefix] = _local(v)

    walk("opt_state", opt_state)
    return out


def storage_pointers(leaves: Mapping) -> dict[str, int]:
    """Each leaf's storage pointer, 0-d leaves left out: the step counter and
    the health counters are 0-d tensors the step replaces on purpose, since
    the window's unfetched metrics hold each step's own values until the
    boundary reads them (``trainer/loop.py``'s cadence)."""
    return {n: int(t.untyped_storage().data_ptr()) for n, t in leaves.items() if t.dim()}


# --------------------------------------------------------------------------
# the step observer
# --------------------------------------------------------------------------


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def _nbytes(t) -> int:
    t = _local(t)
    return int(t.numel() * t.element_size())


def _describe(t) -> str:
    t = _local(t)
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


#: torch dtype name -> the short spelling of JAX's dtype census
_SHORT_DTYPES = {"bfloat16": "bf16", "float16": "f16", "float32": "f32", "float64": "f64"}


def _short_dtype(t) -> str:
    name = str(_local(t).dtype).replace("torch.", "")
    return _SHORT_DTYPES.get(name, name)


@dataclasses.dataclass
class StepObservation:
    """What one observed step did."""

    #: the largest outputs: (bytes, "op dtype[shape]") in decreasing order
    largest: list = dataclasses.field(default_factory=list)
    #: every distinct output above ``threshold_bytes`` (GA201's candidates)
    over: list = dataclasses.field(default_factory=list)
    #: fp32 x fp32 matmuls: "op: dtype[shape] x dtype[shape]" (GA301)
    f32_matmuls: list = dataclasses.field(default_factory=list)
    #: the peak of the bytes the step's own ops held alive at once
    peak_live_bytes: int = 0
    #: every matmul's ``lhs x rhs`` dtype pair (``bf16xbf16``, JAX's
    #: spelling) -> its count, and one sample call of each pair (the
    #: graph contract's dtype census)
    matmul_dtypes: dict = dataclasses.field(default_factory=dict)
    matmul_samples: dict = dataclasses.field(default_factory=dict)


class StepObserver:
    """A ``TorchDispatchMode`` over one step: every op's outputs (their
    sizes, and the live bytes of their storages until each is freed), the
    fp32 x fp32 matmuls, and which storages a cast widened from bf16."""

    def __init__(self, *, threshold_bytes: int = 0, n_experts: int = 0, keep: int = 8):
        from torch.utils._python_dispatch import TorchDispatchMode

        observer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                observer._see(func, args, out)
                return out

        self._mode = _Mode()
        self.threshold_bytes = int(threshold_bytes)
        self.n_experts = int(n_experts)
        self.keep = keep
        self.obs = StepObservation()
        self._live: dict[int, int] = {}
        self._live_bytes = 0
        self._widened: set = set()
        self._over_seen: set = set()

    def __enter__(self) -> "StepObserver":
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, t) -> None:
        t = _local(t)
        try:
            st = t.untyped_storage()
        except Exception:  # noqa: BLE001 — a tensor without storage holds nothing
            return
        key = id(st)
        if key in self._live:
            return
        n = int(st.nbytes())
        self._live[key] = n
        self._live_bytes += n
        self.obs.peak_live_bytes = max(self.obs.peak_live_bytes, self._live_bytes)
        weakref.finalize(st, self._free, key)

    def _storage_key(self, t):
        try:
            return _local(t).untyped_storage().data_ptr()
        except Exception:  # noqa: BLE001
            return None

    def _see(self, func, args, out) -> None:
        import torch

        name = func.overloadpacket.__name__ if hasattr(func, "overloadpacket") else str(func)
        outs = list(_tensors(out))
        for t in outs:
            self._track(t)
            n = _nbytes(t)
            desc = f"{name} {_describe(t)}"
            largest = self.obs.largest
            if len(largest) < self.keep or n > largest[-1][0]:
                largest.append((n, desc))
                largest.sort(key=lambda x: -x[0])
                del largest[self.keep:]
            if self.threshold_bytes and n > self.threshold_bytes and desc not in self._over_seen:
                self._over_seen.add(desc)
                self.obs.over.append((n, desc))
        ins = [a for a in _tensors(list(args)) if a.is_floating_point()]
        if name == "_to_copy" and outs and ins:
            if (ins[0].dtype in (torch.bfloat16, torch.float16)
                    and outs[0].dtype == torch.float32):
                self._widened.add(self._storage_key(outs[0]))
        if (name in MOVEMENT_OPS and outs and ins
                and all(self._storage_key(a) in self._widened for a in ins)):
            for t in outs:
                if t.dtype == torch.float32:
                    self._widened.add(self._storage_key(t))
        if name in MATMUL_OPS:
            mats = ins[-2:]
            if len(mats) == 2:
                pair = f"{_short_dtype(mats[0])}x{_short_dtype(mats[1])}"
                census = self.obs.matmul_dtypes
                census[pair] = census.get(pair, 0) + 1
                self.obs.matmul_samples.setdefault(
                    pair, f"{name}: {_describe(mats[0])} x {_describe(mats[1])}")
            if len(mats) == 2 and all(m.dtype == torch.float32 for m in mats):
                if any(self._storage_key(m) in self._widened for m in mats):
                    return  # the policy's own promotion of bf16 values
                if self.n_experts and any(m.dim() and m.shape[-1] == self.n_experts
                                          for m in mats):
                    return  # the MoE router computes in fp32 on purpose
                self.obs.f32_matmuls.append(
                    f"{name}: {_describe(mats[0])} x {_describe(mats[1])}")


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------


def audit_inplace(report: AuditReport, before: Mapping[str, int],
                  after: Mapping[str, int]) -> None:
    """GA001: every param / optimizer-state leaf must keep its storage."""
    moved = [n for n in before if after.get(n) != before[n]]
    report.stats["inplace_expected"] = len(before)
    report.stats["inplace_kept"] = len(before) - len(moved)
    report.stats["inplace_coverage"] = round(1.0 - len(moved) / max(len(before), 1), 4)
    for path in moved:
        report.add(
            "GA001", "error",
            f"leaf {path}: the step replaced its storage instead of updating it in place "
            f"(the bytes are resident twice at the update)",
            location=f"leaf {path}",
            hint="update the leaf with an in-place op (copy_, add_, torch.where(..., out=)) "
                 "and keep the update dtype-preserving",
        )


def collective_counts(census: Mapping[str, Mapping[str, int]]) -> dict[str, int]:
    """The census's ``{kind: {group size: count}}`` as JAX's ``{kind:
    count}`` (every JAX kind present, zeros included; other kinds the port
    issues, a ``broadcast``, kept)."""
    out = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, by_size in census.items():
        out[kind] = out.get(kind, 0) + sum(int(v) for v in by_size.values())
    return out


def audit_collectives(report: AuditReport, ctx: AuditContext, counts: Mapping[str, int]) -> None:
    """GA101 (unexpected kind) / GA102 (missing kind) against the parallel
    config: JAX's rules over the step's census."""
    report.stats["collectives"] = dict(counts)
    tp, pp, cp, ep = (ctx.axis("model"), ctx.axis("pipe"), ctx.axis("context"),
                      ctx.axis("expert"))
    dp = ctx.axis("data") * ep
    zero1 = bool(ctx.ds.get("zero1", True))
    seq_par = bool(ctx.ds.get("sequence_parallel", False))
    fus = ctx.fusions
    ulysses = bool(fus.get("ulysses_attention"))
    moe = bool((ctx.cfg.get("model", {}) or {}).get("moe"))

    reshardy = (ep > 1 or cp > 1 or seq_par or moe or (ulysses and cp > 1))
    permutey = reshardy or (zero1 and dp > 1)
    if counts.get("all-to-all", 0) and not reshardy:
        report.add(
            "GA101", "warn",
            f"{counts['all-to-all']} all-to-all op(s) but no expert parallelism, "
            f"sequence/context sharding, or MoE configured to explain them",
            location="all-to-all (step census)",
            hint="an unexplained all-to-all means a tensor changes owner mid-step; check "
                 "the layouts at the producer/consumer boundary",
        )
    if counts.get("collective-permute", 0) and pp == 1 and not permutey:
        report.add(
            "GA101", "warn",
            f"{counts['collective-permute']} collective-permute op(s) but no pipeline "
            f"stage transfers, ring attention, or sequence/expert resharding is "
            f"configured",
            location="collective-permute (step census)",
            hint="point-to-point sends appear only at stage boundaries and ring shifts",
        )
    gather_kinds = counts.get("all-gather", 0) + counts.get("reduce-scatter", 0)
    if tp == 1 and cp == 1 and pp == 1 and ep == 1 and not seq_par:
        if gather_kinds and not zero1:
            report.add(
                "GA101", "error",
                f"dp-only config (zero1 off) has {counts.get('all-gather', 0)} all-gather / "
                f"{counts.get('reduce-scatter', 0)} reduce-scatter op(s): something "
                f"(likely full params or optimizer state) is being regathered every step",
                location="all-gather/reduce-scatter (step census)",
                hint="a dp-only step should only all-reduce gradients; a gather here means "
                     "a param or state leaf was left sharded across the step boundary",
            )
        if dp == 1 and any(counts.values()):
            report.add(
                "GA101", "warn",
                f"single-device program contains collectives: {dict(counts)}",
                location="step census",
                hint="collectives on a one-rank group are dead weight",
            )
    if tp > 1 and not any(counts.get(k, 0) for k in
                          ("all-reduce", "all-gather", "reduce-scatter")):
        report.add(
            "GA102", "error",
            f"tensor_model_parallel_size={tp} but the step has no model-axis communication "
            f"at all (no all-reduce/all-gather/reduce-scatter): the model is either fully "
            f"replicated or fully disconnected across the model axis",
            location="step census",
            hint="check that the layouts shard the weights over the model axis",
        )
    if dp > 1 and not any(counts.get(k, 0) for k in ("all-reduce", "reduce-scatter")):
        report.add(
            "GA102", "error",
            f"data-parallel degree {dp} but no all-reduce or reduce-scatter anywhere in the "
            f"step: gradients are never reduced across replicas",
            location="step census",
            hint="the loss must be a global mean over the dp-sharded batch",
        )
    if dp > 1 and zero1 and not counts.get("all-gather", 0):
        report.add(
            "GA102", "warn",
            f"zero1 with dp={dp} but no all-gather in the step: updated params are "
            f"apparently not regathered from their optimizer shards (or ZeRO-1 sharding "
            f"never happened)",
            location="step census",
            hint="opt_state_specs should shard the moments over (data, expert)",
        )
    if pp > 1 and not counts.get("collective-permute", 0):
        report.add(
            "GA102", "warn",
            f"pipeline_model_parallel_size={pp} but no collective-permute: no inter-stage "
            f"transfers were generated",
            location="step census",
            hint="the stage loop should send activations over the pipe axis each tick",
        )
    if seq_par and tp > 1 and not counts.get("all-gather", 0):
        report.add(
            "GA102", "warn",
            f"sequence_parallel expects a pre-QKV all-gather over the model axis; census "
            f"has all-gather=0 (all-reduce={counts.get('all-reduce', 0)})",
            location="step census",
            hint="activations between blocks should be split over the sequence on the "
                 "model axis",
        )
    if moe and ep > 1 and not (counts.get("all-to-all", 0) or counts.get("all-gather", 0)):
        report.add(
            "GA102", "warn",
            f"expert_model_parallel_size={ep} but no all-to-all/all-gather: tokens are "
            f"apparently never exchanged with their experts",
            location="step census",
            hint="expert leaves should be split over the expert axis",
        )


def expected_max_device_bytes(ctx: AuditContext) -> int:
    """Analytic per-rank budget (JAX's): the largest tensor a correctly
    sharded step should hold: the largest local param / state leaf, the
    local batch, and the known activation high-water candidates (ffn block,
    the stacked layer residuals, sharded logits, core-attention scores)."""
    candidates = [max((_nbytes(t) for t in ctx.leaves.values()), default=0)]
    mc = ctx.model_cfg
    lc = getattr(mc, "llama", mc)  # mixtral wraps a llama config
    tp, cp = ctx.axis("model"), ctx.axis("context")
    dp = ctx.axis("data") * ctx.axis("expert")
    seq = int((ctx.cfg.get("data", {}) or {}).get("seq_length")
              or getattr(lc, "max_position_embeddings", 2048))
    gbs = int(ctx.sched.get("global_batch_size", 1))
    mbs = int(ctx.sched.get("micro_batch_size", 1))
    b_local = max(gbs // max(dp, 1), mbs)
    # cotangents and accumulators run in grad_accum_dtype
    abytes = max(_dtype_size(ctx.policy.compute_dtype),
                 _dtype_size(getattr(ctx.policy, "grad_accum_dtype", None)))
    hidden = int(getattr(lc, "hidden_size", 0) or 0)
    ffn = int(getattr(lc, "intermediate_size", 0) or getattr(lc, "ffn_hidden_size", 0)
              or getattr(lc, "ffn_size", 0) or hidden)
    vocab = int(getattr(lc, "vocab_size", 0) or 0)
    heads = int(getattr(lc, "num_attention_heads", 1) or 1)
    n_layers = int(getattr(lc, "num_layers", 1) or 1)
    if hidden:
        candidates.append(b_local * seq * 4)
        candidates.append(b_local * seq * max(hidden, ffn) * abytes)
        candidates.append(n_layers * b_local * seq * hidden * abytes)
        candidates.append(b_local * seq * max(vocab // max(tp, 1), 1) * 4)
        moe_cfg = getattr(mc, "moe", None)
        if moe_cfg is not None:
            k = int(getattr(moe_cfg, "top_k", 1) or 1)
            candidates.append(b_local * seq * k * max(ffn, hidden) * abytes)
        if getattr(lc, "attention_impl", "core") == "core":
            s_att = seq // max(cp, 1)
            candidates.append(b_local * max(heads // max(tp, 1), 1) * s_att * seq * 4)
    return max(candidates + [1])


def _dtype_size(dt) -> int:
    import torch

    return int(torch.empty((), dtype=dt if dt is not None else torch.float32).element_size())


def audit_replication(report: AuditReport, ctx: AuditContext, obs: StepObservation, *,
                      slack: float = 8.0, max_findings: int = 8) -> None:
    """GA201: an output above ``slack`` x the analytic budget."""
    budget = expected_max_device_bytes(ctx)
    threshold = int(budget * slack)
    report.stats["replication_budget_bytes"] = budget
    report.stats["replication_threshold_bytes"] = threshold
    if obs.largest:
        report.stats["largest_output_bytes"] = obs.largest[0][0]
        report.stats["largest_output"] = obs.largest[0][1]
    hits = sorted((x for x in obs.over if x[0] > threshold), key=lambda x: -x[0])
    for n, desc in hits[:max_findings]:
        report.add(
            "GA201", "warn",
            f"per-device intermediate {desc} is {n / 1e6:.1f} MB — "
            f"{n / max(budget, 1):.1f}x the largest tensor a correctly-sharded step should "
            f"hold ({budget / 1e6:.1f} MB)",
            location=desc,
            hint="an oversized intermediate usually means a tensor was gathered whole "
                 "(or never split) where its layout meant a slice",
        )
    if len(hits) > max_findings:
        report.add("GA201", "info",
                   f"{len(hits) - max_findings} further oversized intermediates suppressed "
                   f"(same probable root cause)")


def audit_dtypes(report: AuditReport, ctx: AuditContext, obs: StepObservation, *,
                 max_findings: int = 8) -> None:
    """GA301: fp32 x fp32 matmuls under a bf16 compute regime."""
    import torch

    if ctx.policy.compute_dtype != torch.bfloat16:
        return
    for m in obs.f32_matmuls[:max_findings]:
        report.add(
            "GA301", "warn",
            f"f32 x f32 matmul in a bf16 compute regime ({m})",
            location=m,
            hint="a matmul whose BOTH operands are f32 under precision.type mixed/bf16 "
                 "bypasses the policy cast — check the producing op applies "
                 "policy.compute_dtype",
        )
    if len(obs.f32_matmuls) > max_findings:
        report.add("GA301", "info",
                   f"{len(obs.f32_matmuls) - max_findings} further f32 matmuls suppressed")
    report.stats["f32_matmuls"] = len(obs.f32_matmuls)


def spec_errors(layouts: Mapping, leaves: Mapping, axes: Mapping[str, int]) -> list[str]:
    """GA401's findings: a layout naming an axis the mesh lacks (a sharded
    dim names ``model``, an expert leaf ``expert``), a dim its leaf lacks,
    or one dim split over two axes."""
    errors = []
    for name, lay in sorted(layouts.items()):
        leaf = leaves.get(f"params/{name}", leaves.get(name))
        named = (["model"] if lay.dim is not None else []) + (["expert"] if lay.expert else [])
        for axis in named:
            if axis not in axes:
                errors.append(f"{name}: layout names axis {axis!r}, not in the mesh "
                              f"{tuple(axes)}")
        if leaf is not None and lay.dim is not None and not -leaf.dim() <= lay.dim < leaf.dim():
            errors.append(f"{name}: layout shards dim {lay.dim} of a {leaf.dim()}-d leaf")
        if lay.expert and lay.dim == 0:
            errors.append(f"{name}: dim 0 split over both 'expert' and 'model'")
    return errors


def audit_observation(ctx: AuditContext, obs: StepObservation, counts: Mapping[str, int],
                      before: Mapping[str, int], after: Mapping[str, int], *,
                      replication_slack: float = 8.0, config_name: str = "") -> AuditReport:
    """Every rule against one observed step (the shared core of the
    pre-flight audit and the trainer's live first-step audit)."""
    report = AuditReport(config=config_name or str(ctx.cfg.get("name", "") or ""))
    errors = spec_errors(ctx.layouts, ctx.leaves, ctx.axes)
    for e in errors:
        report.add("GA401", "error", f"invalid layout: {e}",
                   hint="fix the layout; axes must come from the mesh and appear at most "
                        "once per leaf")
    audit_inplace(report, before, after)
    audit_collectives(report, ctx, counts)
    audit_replication(report, ctx, obs, slack=replication_slack)
    audit_dtypes(report, ctx, obs)
    return report


def _n_experts(ctx: AuditContext) -> int:
    moe = getattr(ctx.model_cfg, "moe", None)
    return int(getattr(moe, "num_experts", 0) or 0) if moe is not None else 0


class LiveAudit:
    """The rules over one step of a live trainer: :meth:`observe` wraps the
    step (census, dispatch mode, storage pointers), :meth:`report` judges
    it and carries the step's contract fingerprint in ``stats``
    (``analysis/graph_contract.py``).  ``telemetry.graph_audit`` runs it on
    the trainer's first step."""

    def __init__(self, trainer: Any, *, replication_slack: float = 8.0):
        self.trainer = trainer
        self.slack = replication_slack
        self.ctx = AuditContext.from_trainer(trainer)
        self.before = storage_pointers(self.ctx.leaves)
        self.observer = StepObserver(
            threshold_bytes=int(expected_max_device_bytes(self.ctx) * replication_slack),
            n_experts=_n_experts(self.ctx))
        self.census: dict = {}
        #: each collective call of the step (``telemetry/census.py``)
        self.calls: list = []
        self.memory_bytes: Optional[int] = None

    def observe(self):
        import contextlib

        import torch

        from neuronx_distributed_training_torch.telemetry.census import count_collectives

        audit = self

        @contextlib.contextmanager
        def cm():
            dev = audit.trainer.device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            with count_collectives(audit.calls) as counts, audit.observer:
                yield
            audit.census = counts
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                audit.memory_bytes = int(torch.cuda.max_memory_allocated(dev))
            else:
                resident = sum(int(t.untyped_storage().nbytes()) for t in
                               {id(t.untyped_storage()): t
                                for t in audit.ctx.leaves.values()}.values())
                audit.memory_bytes = resident + audit.observer.obs.peak_live_bytes

        return cm()

    def report(self, *, config_name: str = "") -> AuditReport:
        from neuronx_distributed_training_torch.analysis.graph_contract import (
            fingerprint_observation,
        )

        ctx = AuditContext.from_trainer(self.trainer)  # the leaves after the step
        after = storage_pointers(ctx.leaves)
        rep = audit_observation(ctx, self.observer.obs, collective_counts(self.census),
                                self.before, after,
                                replication_slack=self.slack, config_name=config_name)
        if self.memory_bytes is not None:
            rep.stats["memory_bytes"] = self.memory_bytes
        rep.stats["peak_live_bytes"] = self.observer.obs.peak_live_bytes
        missing = sorted(n for n in self.before if after.get(n) != self.before[n])
        inplace = {"aliased": len(self.before) - len(missing), "expected": len(self.before),
                   "coverage": rep.stats["inplace_coverage"], "missing": missing}
        rep.stats["fingerprint"] = fingerprint_observation(
            ctx, self.observer.obs, self.calls, inplace=inplace,
            memory_bytes=self.memory_bytes, device=self.trainer.device.type,
            config_name=config_name)
        return rep


# --------------------------------------------------------------------------
# config shrinking: audit a 405B config in seconds, preserving structure
# --------------------------------------------------------------------------


def shrink_overrides(cfg: Mapping, *, max_devices: int = 8) -> dict[str, Any]:
    """Dotted-path overrides that shrink a resolved config to audit size
    (JAX's): parallel degrees clamp to 2, model dims shrink to the smallest
    shapes the clamped degrees allow, the batch to one microbatch per dp
    rank (pipeline configs keep ``pp`` microbatches), and everything
    structural (fusions, precision, zero1, alignment, MoE layout) is kept.
    With flash attention on, head_dim is :data:`FLASH_SHRUNK_HEAD_DIM`
    (the module docstring)."""
    ds = dict(cfg.get("distributed_strategy", {}) or {})
    model = dict(cfg.get("model", {}) or {})
    fus = dict(model.get("fusions", {}) or {})

    def clamp(key, default=1):
        return min(int(ds.get(key) or default), 2)

    tp = clamp("tensor_model_parallel_size")
    pp = clamp("pipeline_model_parallel_size")
    cp = clamp("context_parallel_size")
    ep = clamp("expert_model_parallel_size")
    vp = clamp("virtual_pipeline_model_parallel_size")
    world = tp * pp * cp * ep
    if world > max_devices:
        raise ValueError(
            f"shrunk world {world} still exceeds max_devices={max_devices}"
        )
    data_mult = 2 if world * 2 <= max_devices else 1
    dp = data_mult * ep

    o: dict[str, Any] = {
        "distributed_strategy.tensor_model_parallel_size": tp,
        "distributed_strategy.pipeline_model_parallel_size": pp,
        "distributed_strategy.context_parallel_size": cp,
        "distributed_strategy.expert_model_parallel_size": ep,
        "distributed_strategy.virtual_pipeline_model_parallel_size": vp,
    }
    heads = 2 * tp * cp
    kv = tp * cp
    head_dim = FLASH_SHRUNK_HEAD_DIM if fus.get("flash_attention") else SHRUNK_HEAD_DIM
    o["model.num_attention_heads"] = heads
    for key in ("num_key_value_heads", "num_query_groups"):
        if key in model:
            o[f"model.{key}"] = kv
    o["model.hidden_size"] = heads * head_dim
    for key in ("intermediate_size", "ffn_hidden_size"):
        if key in model:
            o[f"model.{key}"] = 2 * heads * head_dim
    if "kv_channels" in model:
        o["model.kv_channels"] = head_dim
    o["model.vocab_size"] = 128 * tp
    if "sliding_window" in model and model.get("sliding_window"):
        o["model.sliding_window"] = 32

    moe = dict(model.get("moe", {}) or {})
    moe_freq = int(model.get("moe_frequency", moe.get("moe_frequency", 1)) or 1)
    chunks = max(pp * vp, 1)
    o["model.num_layers"] = max(moe_freq, 1) * max(chunks, 2 // max(moe_freq, 1))
    if moe:
        o["model.moe.num_experts"] = max(2 * ep, 4)
        if moe.get("top_k"):
            o["model.moe.top_k"] = min(int(moe["top_k"]), 2)

    seq = 64 * max(cp, 1)
    o["data.seq_length"] = seq
    if "max_position_embeddings" in model:
        o["model.max_position_embeddings"] = seq
    if "encoder_seq_length" in model:
        o["model.encoder_seq_length"] = seq
    for key in ("flash_block_q", "flash_block_kv"):
        if fus:
            o[f"model.fusions.{key}"] = 16
    nm = pp if pp > 1 else 1
    o["data.micro_batch_size"] = 1
    o["data.global_batch_size"] = dp * nm
    return o


def _base_world(cfg: Mapping) -> int:
    """The ranks the config's model axes need (tp x pp x cp x ep)."""
    ds = dict(cfg.get("distributed_strategy", {}) or {})
    base = 1
    for k in ("tensor_model_parallel_size", "pipeline_model_parallel_size",
              "context_parallel_size", "expert_model_parallel_size"):
        base *= int(ds.get(k) or 1)
    return base


def _world_of(cfg: Mapping, available: int) -> int:
    """Smallest rank count the config's mesh accepts: the model axes
    exactly, times the largest data factor that fits ``available`` (JAX's)."""
    base = _base_world(cfg)
    if base > available:
        raise ValueError(
            f"config needs at least {base} devices for its parallel degrees; "
            f"{available} available (raise max_devices: the CPU audit spawns that many "
            f"gloo ranks)"
        )
    world = base
    while world * 2 <= available:
        world *= 2
    return min(world, base * 2)


# --------------------------------------------------------------------------
# one step of a config: the batch, the run, the spawned ranks
# --------------------------------------------------------------------------


class _AuditData:
    """The stand-in data module of an audit step: no file is opened."""

    labels_pre_shifted = False
    pad_id = None

    def __init__(self, global_batch_size: int):
        self.global_batch_size = int(global_batch_size)


def audit_batch(cfg: Mapping, vocab: int, seed: int = 0) -> dict:
    """One global batch of seeded tokens, keyed by what the config's loss
    reads (pretraining and SFT, DPO / ORPO, KTO; JAX's ``abstract_batch``
    with values)."""
    import numpy as np

    from neuronx_distributed_training_torch.data.build import alignment_strategy

    rng = np.random.default_rng(seed)
    gbs = int((cfg.get("data", {}) or {}).get("global_batch_size", 1))
    seq = int((cfg.get("data", {}) or {}).get("seq_length") or 2048)

    def ids():
        return rng.integers(0, vocab, size=(gbs, seq), dtype=np.int64)

    ones = np.ones((gbs, seq), np.int64)
    logps = lambda: rng.standard_normal(gbs).astype(np.float32) - 20.0  # noqa: E731
    strategy, params = alignment_strategy(cfg)
    if strategy in ("dpo", "orpo"):
        batch = {"chosen_input_ids": ids(), "rejected_input_ids": ids(),
                 "chosen_loss_mask": ones, "rejected_loss_mask": ones}
        if strategy == "dpo":
            batch["reference_chosen_logps"] = logps()
            batch["reference_rejected_logps"] = logps()
        return batch
    if strategy == "kto":
        batch = {"input_ids": ids(), "loss_mask": ones,
                 "kto_labels": (np.arange(gbs) % 2).astype(np.float32),
                 "reference_logps": logps()}
        if str(params.get("kl_estimator", "batch_mean")) == "mismatched":
            batch["kl_input_ids"] = ids()
            batch["kl_loss_mask"] = ones
            batch["reference_kl_logps"] = logps()
        return batch
    x = ids()
    batch = {"input_ids": x, "labels": x.copy()}
    if strategy == "sft":
        batch["loss_mask"] = ones
    return batch


def _audit_cfg(cfg: Mapping, work: str) -> dict:
    """The config an audit step runs: its exp dir in ``work``, no sinks, no
    resume, no warm start."""
    from neuronx_distributed_training_torch.config.loader import load_config

    em = dict(cfg.get("exp_manager", {}) or {})
    ov: dict[str, Any] = {
        "exp_manager.exp_dir": work, "exp_manager.explicit_log_dir": None,
        "exp_manager.resume_if_exists": False, "exp_manager.create_tensorboard_logger": False,
        "exp_manager.create_wandb_logger": False, "exp_manager.create_mlflow_logger": False,
    }
    if em.get("resume_from_checkpoint"):
        ov["exp_manager.resume_from_checkpoint"] = None
    return load_config(dict(cfg), ov)


def run_audit_step(cfg: Mapping, device: str, *, replication_slack: float = 8.0,
                   config_name: str = "") -> AuditReport:
    """Assemble the trainer of ``cfg`` (this process's rank of it) and audit
    one step.  Assembly and step failures are GA000 findings."""
    import torch

    from neuronx_distributed_training_torch.trainer.loop import Trainer, model_config

    report = AuditReport(config=config_name)
    with tempfile.TemporaryDirectory(prefix="nxdt_audit_") as work:
        try:
            cfg = _audit_cfg(cfg, work)
            gbs = int(cfg["data"]["global_batch_size"])
            trainer = Trainer.from_config(cfg, device=device, data_module=_AuditData(gbs),
                                          enable_checkpointing=False)
            mc = model_config(cfg)
            batch = audit_batch(cfg, int(getattr(mc, "llama", mc).vocab_size))
        except Exception as e:  # noqa: BLE001 — assembly errors ARE the verdict
            report.add("GA000", "error", f"train step assembly failed: {type(e).__name__}: {e}",
                       hint="the config builds no further than assembly; the message "
                            "names the failing subsystem")
            return report
        try:
            live = LiveAudit(trainer, replication_slack=replication_slack)
            with live.observe():
                trainer._dispatch(batch, 0)
            report.extend(live.report(config_name=config_name))
        except Exception as e:  # noqa: BLE001
            report.add("GA000", "error", f"train step failed: {type(e).__name__}: {e}",
                       hint="the step the config describes does not run; the message names "
                            "the failing op")
        finally:
            try:
                trainer.exp.close()
            except Exception:  # noqa: BLE001
                pass
            if trainer.device.type == "cuda":
                torch.cuda.empty_cache()
    return report


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _spawn(cfg: Mapping, world: int, device: str, *, replication_slack: float,
           config_name: str, timeout: float) -> AuditReport:
    """Run :func:`run_audit_step` on ``world`` spawned ranks (NCCL, one card
    each, or gloo on the CPU) and return rank 0's report."""
    pkg_root = str(Path(__file__).resolve().parents[2])
    with tempfile.TemporaryDirectory(prefix="nxdt_audit_spawn_") as tmp:
        spec = Path(tmp) / "spec.json"
        result = Path(tmp) / "result.json"
        spec.write_text(json.dumps({"cfg": dict(cfg), "device": device,
                                    "slack": replication_slack, "name": config_name,
                                    "result": str(result)}, default=str))
        port = _free_port()
        procs, logs = [], []
        for r in range(world):
            env = {k: v for k, v in os.environ.items()
                   if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                                "MASTER_PORT", "LOCAL_WORLD_SIZE", "GROUP_RANK")}
            env.update(NXDT_COORDINATOR=f"127.0.0.1:{port}", NXDT_NUM_PROCESSES=str(world),
                       NXDT_PROCESS_ID=str(r), LOCAL_RANK=str(r),
                       PYTHONPATH=os.pathsep.join(
                           [pkg_root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            log = open(Path(tmp) / f"rank{r}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "neuronx_distributed_training_torch.analysis.graph_audit",
                 "--worker", str(spec)], env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        tails = []
        for r, log in enumerate(logs):
            log.seek(0)
            tails.append((r, log.read()[-2000:]))
            log.close()
        if not result.exists():
            report = AuditReport(config=config_name)
            bad = [(r, t) for (r, t), p in zip(tails, procs) if p.returncode != 0] or tails[:1]
            report.add("GA000", "error",
                       f"the audit's {world} rank(s) on {device} ended without a report "
                       f"(exit codes {[p.returncode for p in procs]}); rank {bad[0][0]}'s "
                       f"last lines: {' | '.join(bad[0][1].strip().splitlines()[-6:])}",
                       hint="run the step alone (the trainer CLI at the shrunk config) to "
                            "see the failure")
            return report
        return report_from_dict(json.loads(result.read_text()))


def report_from_dict(d: Mapping) -> AuditReport:
    from neuronx_distributed_training_torch.analysis.report import Finding

    return AuditReport(findings=[Finding(**f) for f in d.get("findings", [])],
                       config=str(d.get("config", "")), stats=dict(d.get("stats") or {}))


def _worker(spec_path: str) -> int:
    import torch

    from neuronx_distributed_training_torch.utils.launch import initialize_distributed

    spec = json.loads(Path(spec_path).read_text())
    device = spec["device"]
    logging.basicConfig(level=logging.WARNING)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(CPU_RANK_THREADS)
    initialize_distributed(device=device if torch.device(device).type == "cpu" else None)
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        rep = run_audit_step(spec["cfg"], device if torch.device(device).type == "cpu"
                             else None, replication_slack=float(spec["slack"]),
                             config_name=spec["name"])
        if rank == 0:
            tmp = Path(spec["result"]).with_suffix(".tmp")
            tmp.write_text(json.dumps(rep.to_dict(), default=str))
            os.replace(tmp, spec["result"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def audit_devices(device: Optional[str]) -> tuple[str, int]:
    """``(device type, cards)`` an audit can use: the CUDA cards unless
    ``device`` asks for the CPU.  Without a card it raises rather than
    falling back to the CPU."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return "cpu", 0
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' (--device cpu) to "
                           "audit on the CPU's gloo ranks explicitly")
    return "cuda", torch.cuda.device_count()


def audit_config(
    source: str | Path | Mapping,
    *,
    device: Optional[str] = None,
    shrink: bool = True,
    max_devices: Optional[int] = None,
    replication_slack: float = 8.0,
    overrides: Optional[Mapping] = None,
    timeout: float = AUDIT_TIMEOUT_SECONDS,
) -> AuditReport:
    """Load a YAML config, (optionally) shrink it, run one step at its
    world and audit it (the module docstring).  Config-level failures are a
    GA000 error, not an exception: the audit's job is a verdict.

    ``max_devices`` bounds the world (JAX's canonical 8 when shrinking);
    the step runs on the cards when there are that many (``device`` not
    ``cpu``), else on spawned gloo ranks on the CPU; with no card it
    raises unless ``device`` is ``cpu``."""
    from neuronx_distributed_training_torch.config.loader import load_config

    name = Path(source).name if isinstance(source, (str, Path)) else str(
        dict(source).get("name", "<mapping>"))
    report = AuditReport(config=name)
    try:
        cfg = load_config(source, overrides)
    except Exception as e:  # noqa: BLE001 — config errors ARE the verdict
        report.add("GA000", "error", f"config failed validation: {type(e).__name__}: {e}",
                   hint="fix the config; the loader's message names the knob")
        return report
    dev_type, cards = audit_devices(device)
    if max_devices is not None:
        avail = max_devices
    elif shrink:
        avail = 8  # JAX's canonical shrunk world
    else:
        # the config's own size: the cards present, or on the CPU the
        # ranks its mesh needs
        avail = cards if dev_type == "cuda" else _base_world(cfg)
    try:
        if shrink:
            shr = shrink_overrides(cfg, max_devices=avail)
            if overrides:
                shr.update(overrides)
            cfg = load_config(source, shr) if isinstance(
                source, (str, Path)) else load_config(dict(source), shr)
            report.stats["shrunk"] = True
        world = _world_of(cfg, avail)
    except Exception as e:  # noqa: BLE001
        report.add("GA000", "error", f"train step assembly failed: {type(e).__name__}: {e}",
                   hint="the config builds no further than assembly; the message names the "
                        "failing subsystem")
        return report
    on_card = dev_type == "cuda" and cards >= world
    run_on = "cuda" if on_card else "cpu"
    t0 = time.perf_counter()
    if world == 1 and run_on == "cpu":
        sub = run_audit_step(cfg, "cpu", replication_slack=replication_slack, config_name=name)
    else:
        sub = _spawn(cfg, world, run_on, replication_slack=replication_slack,
                     config_name=name, timeout=timeout)
    report.extend(sub)
    report.stats.update(audit_device=run_on, audit_world=world,
                        audit_backend=None if world == 1 and run_on == "cpu" else
                        ("nccl" if on_card else "gloo"),
                        audit_seconds=round(time.perf_counter() - t0, 3))
    return report


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.exit(_worker(sys.argv[2]))
    sys.exit("usage: python -m neuronx_distributed_training_torch.analysis.graph_audit "
             "--worker SPEC.json (the audit's spawned rank; see audit_config)")
