"""Checkpoint manager on ``torch.distributed.checkpoint`` (counterpart of the
JAX package's orbax-backed ``checkpoint/manager.py``, one process).

- save: the state is staged to host memory (pinned buffers for device
  tensors, reused from save to save), which is all the training step waits
  for; with ``async_checkpointing`` the two items (``params``,
  ``opt_state``) are then written by ``dcp.async_save`` threads while a
  commit thread hashes the same staged bytes for the integrity sidecar (few
  threads in all, so that the step keeps the cores it needs),
  writes ``meta.json`` and the sidecar, and renames the staging dir
  ``<step>.tmp-*`` to ``<step>`` (step discovery sees committed steps only);
- retention keeps the best ``save_top_k`` steps by ``monitor`` (lowest
  value) plus the newest one, the JAX package's orbax preservation policy;
- a step that is already saved is not saved again (``save`` returns False),
  as under orbax;
- a failed async save fails the run: the error re-raises at the next
  ``save``/``wait``;
- restore verifies first (``checkpoint/integrity.py``), walks back past
  corrupt steps, and copies the saved values into the live tensors (device,
  dtype and strides kept);
- ``save_bf16`` stores floating params in bf16 (restore casts back up),
  ``use_master_weights_in_ckpt: false`` drops the fp32 master (restore
  re-seeds it from the params);
- under LoRA the ``params`` item holds the whole tree, frozen base included,
  and ``opt_state`` the adapters' state only (the optimizer keeps none for
  frozen leaves).

The layout is DCP's.  Checkpoints written by the JAX package (orbax) are not
read.  Without a process group DCP runs with ``no_dist``
(``integrity.dcp_kwargs``) and the path above is unchanged.  Under a process
group (data parallelism):

- ZeRO-1 state leaves are DTensors; each rank stages and writes its own
  slices, and DCP spreads the replicated leaves' writes over the ranks;
- the checkpointer's collectives run on a gloo group of its own, in one
  thread per rank (the commit thread, or the caller's for a sync save):
  both items are written with ``dcp.save``, each rank hashes what it holds,
  rank 0 merges the digests into the sidecar, writes ``meta.json``, renames
  the staging dir and applies retention, and a barrier ends the commit on
  every rank;
- restore: rank 0 verifies (and quarantines) and tells the others the step;
  every rank then loads with ``dcp.load`` into its live tensors, which
  reshards: a checkpoint saved at dp 2 restores at dp 1 and the other way
  round;
- a failed save is not retried (one rank alone cannot retry a collective).

Tensor parallelism (``layouts`` from ``parallel/sharding.py``, ``tp`` the
``parallel/mesh.py::TensorParallel``): every leaf is written as a DTensor on
the 2-D ``(data, model)`` mesh whose global shape and layout are JAX's, so
DCP reshards across tp as across dp.  A params leaf is ``[Replicate(),
Shard(tp dim)]`` or replicated (DCP writes a replicated chunk once); a
ZeRO-1 leaf adds its ``Shard(dim)`` on ``data``.  A fused leaf (``qkv``,
``gate_up`` and their ``lora_b``, and their moments and master) is saved as
its segments, ``<name>:q``, ``<name>:k``, ``<name>:v`` (``:gate``, ``:up``),
at every tp including 1 and in one process too: a rank's local fused
tensor is ``[q_r | k_r | v_r]``, which is no slice of the global ``[q | k |
v]``.  A checkpoint saved at tp 2 therefore restores at tp 1 and the other
way round; a restore loads a segment into a contiguous buffer and copies it
into the live leaf.

Context parallelism (``cp``): parameters and state are replicated over the
``context`` axis, so the context ranks hand DCP equal shards (on their own
``(data, model)`` meshes, at the same offsets of the same global leaves) and
DCP's planner writes each once; context rank 0's ranks alone hash them.  The
saved layout is the same as without cp, so a cp 2 save restores at cp 1 and
the other way round.

The health counters (``opt_state["health"]``) are saved beside ``step`` as
int64 scalars ``health/<name>``; a checkpoint without them restores with
``steps_seen`` set to its step, as in the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import errno
import json
import logging
import os
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Optional

import torch
import torch.distributed as dist

from neuronx_distributed_training_torch.checkpoint import integrity as ck_integrity
from neuronx_distributed_training_torch.checkpoint.integrity import (
    ITEMS,
    META_NAME,
    SIDECAR_NAME,
    CheckpointIntegrityError,
    IntegrityConfig,
    SaveAuditor,
)
from neuronx_distributed_training_torch.models.llama import named_params as flatten_tree
from neuronx_distributed_training_torch.optim.adamw import (
    dtensor_on,
    init_health_state,
    is_dtensor,
    local,
    shard_of,
)
from neuronx_distributed_training_torch.parallel.sharding import split_segments
from neuronx_distributed_training_torch.utils.io import atomic_write_json

logger = logging.getLogger(__name__)

#: errno values treated as transient save-I/O failures: worth a bounded retry
TRANSIENT_SAVE_ERRNOS = frozenset({
    errno.ENOSPC, errno.EIO, errno.EAGAIN, errno.EBUSY, errno.ETIMEDOUT,
    errno.EINTR, errno.EDQUOT,
})
#: retries of a transiently failed save, and the first backoff (doubling)
SAVE_RETRIES = 3
SAVE_RETRY_BACKOFF_SECONDS = 0.5
#: threads an async save runs beside the training step: DCP writers per
#: item, and blake2b workers at the lowest CPU priority (see
#: :func:`_background_priority`) on half the cores, which the step's host
#: threads still feel when every core hashes
WRITER_THREADS = 1
SAVE_DIGEST_WORKERS = max(1, (os.cpu_count() or 1) // 2)
_OPT_GROUPS = ("mu", "nu", "master")


def is_transient_save_error(exc: BaseException) -> bool:
    """Is ``exc`` (or anything in its cause/context chain, or a rank's
    failure inside DCP's ``CheckpointException``) a transient I/O error worth
    retrying?"""
    seen: set[int] = set()
    todo: list[BaseException] = [exc]
    while todo:
        cur = todo.pop()
        if id(cur) in seen:
            continue
        seen.add(id(cur))
        if isinstance(cur, TimeoutError):
            return True
        if isinstance(cur, OSError) and cur.errno in TRANSIENT_SAVE_ERRNOS:
            return True
        todo += [e for e in (cur.__cause__ or cur.__context__,
                             *dict(getattr(cur, "failures", None) or {}).values())
                 if isinstance(e, BaseException)]
    return False


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """The reference's ``exp_manager.checkpoint_callback_params`` knobs plus
    ``save_bf16`` / ``async_checkpointing`` and the integrity block."""

    dir: str | Path = "checkpoints"
    save_top_k: int = 3
    every_n_train_steps: int = 100
    async_save: bool = True
    monitor: str = "loss"  # metric whose lowest value defines "best"
    save_bf16: bool = False
    use_master_weights_in_ckpt: bool = True
    integrity: IntegrityConfig = dataclasses.field(default_factory=IntegrityConfig)

    @classmethod
    def from_config(cls, cfg: dict[str, Any]) -> "CheckpointConfig":
        em = dict(cfg.get("exp_manager", {}) or {})
        cb = dict(em.get("checkpoint_callback_params", {}) or {})
        return cls(
            dir=em.get("explicit_log_dir") or em.get("exp_dir") or "checkpoints",
            save_top_k=int(cb.get("save_top_k", 3)),
            every_n_train_steps=int(cb.get("every_n_train_steps", 100)),
            async_save=bool(cb.get("async_checkpointing", em.get("async_checkpointing", True))),
            monitor=str(cb.get("monitor", "loss")),
            save_bf16=bool(em.get("save_bf16", cb.get("save_bf16", False))),
            use_master_weights_in_ckpt=bool(cb.get("use_master_weights_in_ckpt", True)),
            integrity=ck_integrity.parse_checkpoint_block(em.get("checkpoint")),
        )


@dataclasses.dataclass
class TrainState:
    """Everything a resume needs."""

    params: Any
    opt_state: Any
    step: int
    consumed_samples: int
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


def retained_steps(metrics_by_step: dict[int, dict], save_top_k: int, monitor: str) -> set[int]:
    """The steps the JAX package's orbax policy keeps: ``BestN(n=save_top_k,
    reverse=True)`` (the lowest ``monitor`` values; steps saved without
    metrics are always kept) plus ``LatestN(1)``, the newest step, which a
    resume needs; everything when ``save_top_k <= 0``."""
    steps = sorted(metrics_by_step)
    if save_top_k <= 0 or not steps:
        return set(steps)
    keep = {s for s in steps if not metrics_by_step[s]}
    with_metrics = [s for s in steps if metrics_by_step[s]]
    ranked = sorted(with_metrics,
                    key=lambda s: float(metrics_by_step[s].get(monitor, float("inf"))),
                    reverse=True)
    keep.update(ranked[-save_top_k:])
    keep.add(steps[-1])
    return keep


def saved_pieces(name: str, t: torch.Tensor, layouts: Optional[dict] = None, tp=None,
                 cast=None) -> list[tuple[str, torch.Tensor, torch.Tensor]]:
    """``(key, saved tensor, live local view)`` of what a checkpoint holds of
    one leaf ``t`` (a param, or a state leaf that may be a ZeRO-1 DTensor):
    the leaf whole, or a fused leaf's segments (``<name>:<segment>``); under
    ``tp`` each as a DTensor on the ``(data, model)`` mesh (see the module
    docstring).  Without ``layouts`` the leaf as it is.  ``cast`` maps the
    local data before it is wrapped (``save_bf16``)."""
    cast = cast or (lambda x: x)
    layout = None if layouts is None else layouts.get(name)
    if layout is None:
        return [(name, cast(t), local(t))]
    size = 1 if tp is None else tp.size
    sh = shard_of(t)
    out = []
    for seg, view in split_segments(local(t), layout, size):
        saved = cast(view)
        if tp is not None:
            saved = dtensor_on(saved, tp.state_mesh,
                               (None if sh is None else sh[0], layout.dim))
        out.append((f"{name}:{seg}" if seg else name, saved, view))
    return out


def _pieces(flat: dict, layouts, tp, prefix: str = "", cast=None) -> dict[str, tuple]:
    return {prefix + k: (saved, view) for n, t in flat.items()
            for k, saved, view in saved_pieces(n, t, layouts, tp, cast)}


def state_trees(params: Any, opt_state: dict, *, save_bf16: bool = False,
                keep_master: bool = True, layouts: Optional[dict] = None,
                tp=None) -> dict[str, dict[str, torch.Tensor]]:
    """The two items a checkpoint holds, as flat dicts of the live tensors:
    ``params`` (bf16 floating leaves with ``save_bf16``) and ``opt_state``
    (``mu/<name>``, ``nu/<name>``, ``master/<name>``, ZeRO-1 leaves as
    DTensors, and ``step`` and ``health/<name>`` as int64 scalars); with
    ``layouts``, leaves as :func:`saved_pieces` gives them."""
    cast = _to_bf16 if save_bf16 else None
    flat = {k: saved for k, (saved, _) in
            _pieces(flatten_tree(params), layouts, tp, cast=cast).items()}
    groups = [g for g in _OPT_GROUPS if g in opt_state and (g != "master" or keep_master)]
    opt_flat = {k: saved for g in groups
                for k, (saved, _) in _pieces(opt_state[g], layouts, tp, f"{g}/").items()}
    opt_flat["step"] = torch.tensor(int(opt_state["step"]), dtype=torch.int64)
    for k, v in (opt_state.get("health") or {}).items():
        opt_flat[f"health/{k}"] = torch.tensor(int(v), dtype=torch.int64)
    return {"params": flat, "opt_state": opt_flat}


def _to_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.is_floating_point() else t


def _views(pieces: dict) -> dict[str, torch.Tensor]:
    """The live local views of :func:`_pieces` (one process: whole leaves)."""
    return {k: view for k, (_, view) in pieces.items()}


def dtensor_like(t, local_t: torch.Tensor):
    """A DTensor with ``t``'s mesh, placements and global shape over
    ``local_t``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_t, t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _is_scalar_key(key: str) -> bool:
    return key == "step" or key.startswith("health/")


def _background_priority() -> None:
    """Lower this thread, and the threads it starts, to the lowest CPU
    priority (Linux: the nice value is per thread and inherited).  The save's
    hashing then yields the cores to the training step's host threads (its
    Python thread and the autograd engine), which otherwise wait for a core
    at every hand-off."""
    try:
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
    except (AttributeError, OSError) as e:
        logger.debug("checkpoint commit thread keeps its priority: %s", e)


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


def _staged_writer(path: Path):
    """A DCP FileSystemWriter whose staging is the identity: the state dict
    handed to ``async_save`` is already the host copy the sidecar hashes, so
    DCP writes exactly those bytes and makes no second copy."""
    dcp = _dcp()

    class _HostStagedWriter(dcp.FileSystemWriter):
        def stage(self, state_dict):
            return state_dict

    return _HostStagedWriter(str(path), thread_count=WRITER_THREADS)


class Checkpointer:
    """Save/restore ``TrainState`` with retention, async writes, integrity
    sidecars and verified auto-resume."""

    def __init__(self, config: CheckpointConfig, *, layouts: Optional[dict] = None, tp=None,
                 cp=None):
        self.config = config
        #: the leaves' tensor-parallel layouts and the model axis (see
        #: :func:`saved_pieces`); None: leaves are saved as they are
        self.layouts, self.tp = layouts, tp
        #: the context axis: its ranks hold the same state, and context rank
        #: 0's shards alone are hashed (DCP writes one copy of equal shards)
        self.cp = cp
        self.directory = Path(config.dir).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        #: restore/audit trail (quarantined steps, walk-backs, verify seconds)
        self.integrity_trail: dict[str, Any] = {}
        #: facts of the last committed save: step, bytes, stage/write/digest seconds
        self.last_save: dict[str, Any] = {}
        #: every step this checkpointer wrote, in order
        self.committed_steps: list[int] = []
        #: facts of the last restore: step, bytes, verify and read/copy seconds
        self.last_restore: dict[str, Any] = {}
        #: how DCP ran the last save: "no_dist" or "process group"
        self.process_group_mode: Optional[str] = None
        self._pending: Optional[concurrent.futures.Future] = None
        self._commit_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="nxdt-ckpt-commit",
            initializer=_background_priority)
        self._pinned: dict[tuple, torch.Tensor] = {}
        self._audit_pending: list[int] = []
        #: under a process group: the checkpointer's own gloo group and rank
        self._pg = None
        self._rank = 0
        if dist.is_available() and dist.is_initialized():
            self._pg = dist.new_group(backend="gloo")
            self._rank = dist.get_rank()
        self._auditor: Optional[SaveAuditor] = None
        if config.integrity.enabled and config.integrity.audit and self._rank == 0:
            self._auditor = SaveAuditor(self.directory)

    def _trail(self) -> dict[str, Any]:
        self.integrity_trail.setdefault("quarantined_steps", [])
        self.integrity_trail.setdefault("verify_seconds", 0.0)
        return self.integrity_trail

    # -- discovery ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Committed steps (digit-named dirs; staging and quarantined dirs
        are invisible)."""
        if not self.directory.exists():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -----------------------------------------------------------------

    def _stage(self, key: tuple, t: torch.Tensor) -> torch.Tensor:
        if is_dtensor(t):
            from torch.distributed.tensor import DTensor

            # this rank's slice staged on the host, keeping its place in the
            # whole leaf (t's spec: mesh, placements, global shape) for DCP;
            # DTensor.from_local would move a host slice to a card mesh's device
            return DTensor(self._stage(key, t.to_local()), t._spec, requires_grad=False)
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone(memory_format=torch.contiguous_format)
        buf = self._pinned.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(t, non_blocking=True)
        return buf

    def _broadcast(self, obj):
        """Rank 0's ``obj`` on every rank (the checkpointer's group)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self._pg)
        return box[0]

    def save(self, state: TrainState, *, metrics: Optional[dict[str, float]] = None,
             force: bool = False) -> bool:
        """Stage and write one step (asynchronously with ``async_save``).
        Returns False without writing when the step is already saved (or,
        unless ``force``, older than the newest saved step)."""
        self.wait()  # one save at a time; a failed previous save raises here
        step = int(state.step)
        steps = self.all_steps()
        if step in steps or (not force and steps and step < steps[-1]):
            if self._rank == 0:
                logger.info("checkpoint step %d: already saved (newest %s); not saved again",
                            step, steps[-1])
            return False
        t0 = time.perf_counter()
        trees = state_trees(state.params, state.opt_state, save_bf16=self.config.save_bf16,
                            keep_master=self.config.use_master_weights_in_ckpt,
                            layouts=self.layouts, tp=self.tp)
        staged = {item: {n: self._stage((item, n), t) for n, t in tree.items()}
                  for item, tree in trees.items()}
        if any(t.device.type == "cuda" for tree in trees.values() for t in tree.values()):
            torch.cuda.synchronize()
        stage_seconds = time.perf_counter() - t0
        del trees
        master_in = any(n.startswith("master/") for n in staged["opt_state"])
        meta = {
            "step": step,
            "consumed_samples": int(state.consumed_samples),
            "save_bf16": bool(self.config.save_bf16),
            "master_in_ckpt": master_in,
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            **state.extra,
        }
        tmp_name = f"{step}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        if self._pg is not None:
            tmp_name = self._broadcast(tmp_name)  # rank 0's, on every rank
        tmp = self.directory / tmp_name
        tmp.mkdir(parents=True, exist_ok=self._pg is not None)
        dcp = _dcp()
        t_write = time.perf_counter()
        try:
            if self._pg is not None:
                # the writes run in the commit (collectives on this group)
                self.process_group_mode = "process group"
                if self.config.async_save:
                    self._pending = self._commit_pool.submit(
                        self._commit, step, tmp, staged, meta, None, stage_seconds, t_write)
                else:
                    self._commit(step, tmp, staged, meta, None, stage_seconds, t_write)
                if self._auditor is not None:
                    self._audit_pending.append(step)
                return True
            kw = ck_integrity.dcp_kwargs(dcp.async_save if self.config.async_save else dcp.save)
            self.process_group_mode = "no_dist" if kw else "process group"
            if self.config.async_save:
                futures = [dcp.async_save(staged[item], storage_writer=_staged_writer(tmp / item),
                                          **kw) for item in ITEMS]
                self._pending = self._commit_pool.submit(
                    self._commit, step, tmp, staged, meta, futures, stage_seconds, t_write)
            else:
                for item in ITEMS:
                    dcp.save(staged[item], storage_writer=_staged_writer(tmp / item), **kw)
                self._commit(step, tmp, staged, meta, [], stage_seconds, t_write)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self._auditor is not None:
            self._audit_pending.append(step)
        return True

    def _commit(self, step, tmp: Path, staged, meta, futures, stage_seconds, t_write) -> None:
        """Hash the staged bytes (while DCP writes them), wait for the
        writes, add meta and sidecar, rename into place, apply retention.
        ``futures`` is None under a process group: see :meth:`_commit_group`."""
        if futures is None:
            return self._commit_group(step, tmp, staged, meta, stage_seconds, t_write)
        try:
            digest_seconds = 0.0
            sidecar = None
            if self.config.integrity.enabled:
                t = time.perf_counter()
                sidecar = ck_integrity.build_sidecar(step=step, trees=staged, meta=meta,
                                                     workers=SAVE_DIGEST_WORKERS)
                digest_seconds = time.perf_counter() - t
            for f in futures:
                f.result()
            atomic_write_json(tmp / META_NAME, meta)
            if sidecar is not None:
                atomic_write_json(tmp / SIDECAR_NAME, sidecar)
            os.rename(tmp, self.directory / str(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._committed(step, staged, stage_seconds, t_write, digest_seconds)
        self._apply_retention()

    def _commit_group(self, step, tmp: Path, staged, meta, stage_seconds, t_write) -> None:
        """The commit under a process group, on every rank: write both items
        (``dcp.save`` on the checkpointer's group), hash this rank's shards,
        merge on rank 0 (sidecar, meta, rename, retention), then a barrier,
        so that a rank's next save sees the step committed."""
        dcp = _dcp()
        for item in ITEMS:
            dcp.save(staged[item], storage_writer=_staged_writer(tmp / item),
                     process_group=self._pg)
        digest_seconds = 0.0
        records = None
        if self.config.integrity.enabled:
            t = time.perf_counter()
            if self.cp is None or self.cp.rank == 0:
                records = ck_integrity.local_shard_records(staged, rank=self._rank,
                                                           workers=SAVE_DIGEST_WORKERS)
            else:  # a replica over context of what context rank 0 hashes
                records = {item: {} for item in staged}
            digest_seconds = time.perf_counter() - t
        gathered = [None] * dist.get_world_size(self._pg) if self._rank == 0 else None
        dist.gather_object(records, gathered, dst=0, group=self._pg)
        error: Optional[BaseException] = None
        if self._rank == 0:
            try:
                atomic_write_json(tmp / META_NAME, meta)
                if records is not None:
                    atomic_write_json(tmp / SIDECAR_NAME, ck_integrity.sidecar_from_records(
                        step=step, trees=staged, records=gathered, meta=meta))
                os.rename(tmp, self.directory / str(step))
                self._apply_retention()
            except BaseException as e:  # noqa: BLE001 — raised after the barrier
                shutil.rmtree(tmp, ignore_errors=True)
                error = e
        dist.barrier(group=self._pg)
        if error is not None:
            raise error
        self._committed(step, staged, stage_seconds, t_write, digest_seconds)

    def _committed(self, step, staged, stage_seconds, t_write, digest_seconds) -> None:
        nbytes = sum(t.numel() * t.element_size() for tree in staged.values()
                     for t in tree.values())
        self.committed_steps.append(step)
        self.last_save = {"step": step, "bytes": nbytes, "stage_seconds": stage_seconds,
                          "write_seconds": time.perf_counter() - t_write,
                          "digest_seconds": digest_seconds,
                          "async": bool(self.config.async_save)}
        if self._rank == 0:
            logger.info("checkpoint step %d committed: %d bytes, staged in %.3f s, written in "
                        "%.3f s (digests %.3f s, %s)", step, nbytes, stage_seconds,
                        self.last_save["write_seconds"], digest_seconds,
                        "async" if self.config.async_save else "sync")

    def _apply_retention(self) -> None:
        steps = self.all_steps()
        metrics = {}
        for s in steps:
            try:
                metrics[s] = dict(json.loads(
                    (self.directory / str(s) / META_NAME).read_text()).get("metrics") or {})
            except (OSError, ValueError):
                metrics[s] = {}
        keep = retained_steps(metrics, self.config.save_top_k, self.config.monitor)
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.directory / str(s), ignore_errors=True)
                logger.info("checkpoint step %d removed by retention (save_top_k=%d on %s, "
                            "keep last)", s, self.config.save_top_k, self.config.monitor)

    # -- post-commit save audit -----------------------------------------------

    def _audit(self) -> None:
        """Hand committed steps to the auditor and quarantine finished
        failures (no save is in flight when this runs)."""
        if self._auditor is None:
            return
        pending, self._audit_pending = self._audit_pending, []
        for s in pending:
            self._auditor.schedule(s)
        trail = self._trail()
        for v in self._auditor.poll():
            if v.status != "corrupt":
                continue
            logger.error("post-commit save audit FAILED for step %d: %s", v.step,
                         "; ".join(v.failures[:4]))
            if self.config.integrity.quarantine:
                ck_integrity.apply_quarantine(self.directory, v.step, reason="save-audit",
                                              failures=v.failures)
                trail.setdefault("audit_quarantined", []).append(v.step)
                if v.step not in trail["quarantined_steps"]:
                    trail["quarantined_steps"].append(v.step)
            else:
                trail.setdefault("corrupt_steps_unquarantined", []).append(v.step)
        trail["audit"] = self._auditor.stats.to_dict()

    def save_with_retry(self, state: TrainState, *, metrics: Optional[dict[str, float]] = None,
                        force: bool = False, drain: bool = False) -> bool:
        """:meth:`save` with up to :data:`SAVE_RETRIES` retries, backing off
        exponentially, on transient I/O errors, cleaning up the partial save
        between attempts.  ``drain=True`` waits for the async write inside
        the loop (the stop path), so a background write error counts as a
        failed attempt."""
        attempts = 1 + SAVE_RETRIES if self._pg is None else 1
        delay = SAVE_RETRY_BACKOFF_SECONDS
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            try:
                saved = self.save(state, metrics=metrics, force=force)
                if drain:
                    self.wait()
                return saved
            except (Exception, ck_integrity._CheckpointException()) as e:  # noqa: BLE001
                self._cleanup_failed_save()
                if not is_transient_save_error(e):
                    raise
                last = e
                remaining = attempts - 1 - attempt
                if remaining == 0:
                    break
                logger.warning("checkpoint save at step %d failed transiently (%s: %s); "
                               "retrying in %.2fs (%d attempt%s left)", state.step,
                               type(e).__name__, e, delay, remaining,
                               "s" if remaining != 1 else "")
                time.sleep(delay)
                delay *= 2.0
        assert last is not None
        raise last

    def _cleanup_failed_save(self) -> None:
        """Drop what a failed save left: the in-flight future (its error is
        being handled) and every staging dir."""
        pending, self._pending = self._pending, None
        if pending is not None:
            try:
                pending.result()
            except BaseException:  # noqa: BLE001 — already being handled
                pass
        if self._rank == 0:
            for p in self.directory.glob("*.tmp-*"):
                shutil.rmtree(p, ignore_errors=True)

    def wait(self) -> None:
        """Block until the in-flight async save commits; its failure raises."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()
        self._audit()

    # -- restore --------------------------------------------------------------

    def verify_step(self, step: int, *, keep: Optional[dict] = None):
        return ck_integrity.verify_step(self.directory, step, keep=keep)

    def verified_latest_step(self, *, quarantine: Optional[bool] = None,
                             keep: Optional[dict] = None) -> Optional[int]:
        """The newest step that passes verification, walking back past
        corrupt steps (each quarantined unless ``quarantine`` is off).
        ``None`` when no checkpoint exists; raises
        :class:`CheckpointIntegrityError` when steps exist but none verifies."""
        quarantine = self.config.integrity.quarantine if quarantine is None else quarantine
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return None
        trail = self._trail()
        verdicts = []
        walked = 0
        for step in steps:
            v = self.verify_step(step, keep=keep)
            verdicts.append(v)
            trail["verify_seconds"] = round(trail["verify_seconds"] + v.seconds, 3)
            if v.status == "gone":
                logger.warning("checkpoint step %d vanished mid-verification; skipping", step)
                continue
            if v.passed:
                if v.status == "legacy":
                    logger.warning("checkpoint step %d predates integrity sidecars; restoring "
                                   "UNVERIFIED (legacy checkpoint)", step)
                    trail["legacy_restore"] = True
                if walked:
                    logger.warning("integrity walk-back: restored step is %d, %d newer "
                                   "step(s) quarantined as corrupt", step, walked)
                trail["verified_step"] = int(step)
                trail["walk_back_count"] = walked
                return int(step)
            walked += 1
            if quarantine:
                ck_integrity.apply_quarantine(
                    self.directory, step,
                    reason=v.failures[0] if v.failures else "digest-mismatch",
                    failures=v.failures)
                if step not in trail["quarantined_steps"]:
                    trail["quarantined_steps"].append(int(step))
            else:
                trail.setdefault("corrupt_steps_unquarantined", [])
                if step not in trail["corrupt_steps_unquarantined"]:
                    trail["corrupt_steps_unquarantined"].append(int(step))
        if all(v.status == "gone" for v in verdicts):
            return None
        detail = "; ".join(f"step {v.step}: {v.failures[0] if v.failures else v.status}"
                           for v in verdicts)
        raise CheckpointIntegrityError(
            f"every retained checkpoint under {self.directory} failed integrity "
            f"verification ({detail}); auto-resume cannot proceed: restore from an older "
            f"backup or relaunch fresh (quarantined step dirs keep the evidence, see "
            f"{ck_integrity.LEDGER_NAME})", verdicts)

    def _resolve_step(self, step: Optional[int], verify: Optional[bool], keep: dict, *,
                      quarantine: Optional[bool] = None, what: str = "checkpoint") -> int:
        """The step to restore (verified, walking back past corrupt steps);
        under a process group rank 0 decides and tells the others."""
        if self._pg is None:
            return self._resolve_step_local(step, verify, keep, quarantine=quarantine,
                                            what=what)
        out: Any = None
        error: Optional[BaseException] = None
        if self._rank == 0:
            try:
                out = ("ok", self._resolve_step_local(step, verify, {}, quarantine=quarantine,
                                                      what=what))
            except Exception as e:  # noqa: BLE001 — re-raised on every rank
                error, out = e, (type(e).__name__, str(e))
        out = self._broadcast(out)
        if error is not None:
            raise error
        if out[0] == "ok":
            return int(out[1])
        if out[0] == "CheckpointIntegrityError":
            raise CheckpointIntegrityError(f"(rank 0) {out[1]}")
        if out[0] == "FileNotFoundError":
            raise FileNotFoundError(f"(rank 0) {out[1]}")
        raise RuntimeError(f"checkpoint resolution failed on rank 0: {out[0]}: {out[1]}")

    def _resolve_step_local(self, step: Optional[int], verify: Optional[bool], keep: dict, *,
                            quarantine: Optional[bool] = None, what: str = "checkpoint") -> int:
        icfg = self.config.integrity
        do_verify = icfg.enabled and icfg.verify_restore if verify is None else bool(verify)
        if step is None:
            step = (self.verified_latest_step(quarantine=quarantine, keep=keep) if do_verify
                    else self.latest_step())
        elif do_verify:
            v = self.verify_step(step, keep=keep)
            if not v.passed:
                raise CheckpointIntegrityError(
                    f"{what} step {step} under {self.directory} failed integrity "
                    f"verification: {'; '.join(v.failures[:4]) or v.status}", [v])
            if v.status == "legacy":
                logger.warning("checkpoint step %d predates integrity sidecars; restoring "
                               "UNVERIFIED (legacy checkpoint)", step)
                self._trail()["legacy_restore"] = True
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        return int(step)

    def _read(self, step: int, item: str, keep: dict) -> dict[str, torch.Tensor]:
        return keep[item] if item in keep else ck_integrity.read_item(
            self.directory / str(step), item, pin_memory=torch.cuda.is_available())

    @staticmethod
    @torch.no_grad()
    def _copy_into(dst: dict[str, torch.Tensor], src: dict[str, torch.Tensor], what: str):
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        if missing or extra:
            raise ValueError(f"checkpoint {what} does not match the model: missing "
                             f"{missing[:4]}, unexpected {extra[:4]}")
        for n, t in dst.items():
            if tuple(src[n].shape) != tuple(t.shape):
                raise ValueError(f"checkpoint {what} leaf {n}: shape {tuple(src[n].shape)}, "
                                 f"model {tuple(t.shape)}")
            t.copy_(src[n])  # casts a save_bf16 leaf back up to the live dtype

    def restore(self, params_template: Any, opt_template: dict, *, step: Optional[int] = None,
                verify: Optional[bool] = None) -> TrainState:
        """Restore the newest verified (or the given) step into the live
        tensors ``params_template`` / ``opt_template`` (updated in place, so
        device, dtype and strides stay those of the model, and a ZeRO-1
        leaf takes this rank's slice) and return them."""
        keep: dict = {}
        t0 = time.perf_counter()
        step = self._resolve_step(step, verify, keep)
        verify_seconds = time.perf_counter() - t0
        t1 = time.perf_counter()
        meta = json.loads((self.directory / str(step) / META_NAME).read_text())
        flat_params = flatten_tree(params_template)
        live_params = _pieces(flat_params, self.layouts, self.tp)
        groups = [g for g in _OPT_GROUPS if g in opt_template]
        reseed_master = "master" in opt_template and not meta.get("master_in_ckpt", True)
        if reseed_master:
            groups.remove("master")
        live = {k: v for g in groups
                for k, v in _pieces(opt_template[g], self.layouts, self.tp, f"{g}/").items()}
        if self._pg is None:
            params = self._read(step, "params", keep)
            opt = self._read(step, "opt_state", keep)
            self._copy_into(_views(live_params), params, "params")
            self._copy_into(_views(live), {k: v for k, v in opt.items() if not _is_scalar_key(k)},
                            "opt_state")
            scalars = {k: int(v) for k, v in opt.items() if _is_scalar_key(k)}
            nbytes = sum(t.numel() * t.element_size() for d in (params, opt) for t in d.values())
        else:
            scalars = self._load_group(step, {"params": live_params, "opt_state": live})
            nbytes = sum(v.numel() * v.element_size()
                         for d in (live_params, live) for _, v in d.values())
        if reseed_master:
            # the master was dropped at save time: re-seed it from the params
            # (the trainable ones: under LoRA the frozen base has no master)
            for n, t in opt_template["master"].items():
                src = flat_params[n].detach()
                sh = shard_of(t)
                if sh is not None:
                    src = src.narrow(*sh)
                local(t).copy_(src)
        opt_template["step"] = scalars["step"]
        if "health" in opt_template:
            health = init_health_state()
            saved = {k[len("health/"):]: v for k, v in scalars.items() if k != "step"}
            # saved without the health counters: steps_seen restarts at the
            # restored step, as in the JAX package
            health.update(saved or {"steps_seen": scalars["step"]})
            opt_template["health"] = health
        if any(t.device.type == "cuda" for t in flat_params.values()):
            torch.cuda.synchronize()
        self.last_restore = {"step": step, "bytes": nbytes, "verify_seconds": verify_seconds,
                             "restore_seconds": time.perf_counter() - t1}
        saved_step, consumed = int(meta.pop("step")), int(meta.pop("consumed_samples"))
        for k in ("save_bf16", "master_in_ckpt", "metrics"):
            meta.pop(k, None)
        return TrainState(params=params_template, opt_state=opt_template, step=saved_step,
                          consumed_samples=consumed, extra=meta)

    def _load_group(self, step: int, targets: dict[str, dict]) -> dict[str, int]:
        """Under a process group: ``dcp.load`` the items of ``step`` into the
        live tensors (``targets``: item -> :func:`_pieces`), which reshards:
        DCP reads each rank's slices whatever the dp and tp at save.  A piece
        whose live view is not contiguous (a fused leaf's segment) is read
        into a contiguous buffer and copied in; returns the int scalars."""
        dcp = _dcp()
        scalars: dict[str, torch.Tensor] = {}
        for item, target in targets.items():
            path = str(self.directory / str(step) / item)
            saved = set(dcp.FileSystemReader(path).read_metadata().state_dict_metadata)
            held = {k for k in saved if item == "opt_state" and _is_scalar_key(k)}
            missing, extra = sorted(set(target) - saved), sorted(saved - set(target) - held)
            if missing or extra:
                raise ValueError(f"checkpoint {item} does not match the model: missing "
                                 f"{missing[:4]}, unexpected {extra[:4]}")
            sd, copies = {}, []
            for k, (saved_t, view) in target.items():
                sd[k] = saved_t
                if view.is_contiguous() and local(saved_t).data_ptr() == view.data_ptr():
                    continue
                buf = torch.empty(view.shape, dtype=view.dtype, device=view.device)
                sd[k] = dtensor_like(saved_t, buf) if is_dtensor(saved_t) else buf
                copies.append((buf, view))
            for k in held:
                sd[k] = scalars[k] = torch.zeros((), dtype=torch.int64)
            dcp.load(sd, storage_reader=dcp.FileSystemReader(path), process_group=self._pg)
            with torch.no_grad():
                for buf, view in copies:
                    view.copy_(buf)
        return {k: int(v) for k, v in scalars.items()}

    def restore_params_only(self, params_template: Any, *, step: Optional[int] = None,
                            verify: Optional[bool] = None) -> Any:
        """Weights without optimizer or loop state (the reference's
        ``weight_init_only`` warm start), verified but never quarantined:
        the source is usually someone else's run dir."""
        keep: dict = {}
        step = self._resolve_step(step, verify, keep, quarantine=False, what="warm-start")
        live = _pieces(flatten_tree(params_template), self.layouts, self.tp)
        if self._pg is None:
            self._copy_into(_views(live), self._read(step, "params", keep), "params")
        else:
            self._load_group(step, {"params": live})
        return params_template

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._auditor is not None:
                self._auditor.drain(self.config.integrity.audit_deadline_seconds)
                self._audit()
                self._auditor.close(timeout=0)
            self._commit_pool.shutdown(wait=True)
            self._pinned.clear()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
