"""DataModules: dataset -> fixed-shape global batches (counterpart of the JAX
package's ``data/loader.py``: the ``DataModule`` base with its transient-read
retry, ``process_global_batch``, the prefetch thread, the batch token stats,
``HFDataModule`` and ``SyntheticDataModule``).

Batches are numpy on the host; the trainer moves each global batch to the
device once per step and splits it into microbatches there.  Under data
parallelism every rank builds the same global batch (the samplers are
deterministic) and computes its own rows of each microbatch
(:func:`dp_rank_rows`), as the JAX package's ``shard_batch`` assumes; under
context parallelism each context rank of a data rank takes its slice of the
sequence of those rows (:func:`context_parallel_batch`).  A daemon
thread (``PrefetchIterator``) keeps the next batches ready so a slow
``fetch_rows`` (arrow page-in, mmap faults) does not stall the step loop.
"""

from __future__ import annotations

import errno
import logging
import os
import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

from neuronx_distributed_training_torch.data.sampler import PretrainingSampler, RandomSampler

logger = logging.getLogger(__name__)

IGNORE_INDEX = -100

#: errno values treated as TRANSIENT data-read failures (an NFS/FUSE mount
#: flap, a stale handle, an object-store hiccup): worth a bounded retry with
#: backoff on the prefetch thread.  Anything else re-raises immediately.
TRANSIENT_READ_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EBUSY, errno.ETIMEDOUT, errno.EINTR,
    errno.ESTALE, errno.ENETDOWN, errno.ENETUNREACH, errno.ECONNRESET,
})


def is_transient_io_error(exc: BaseException) -> bool:
    """Is ``exc`` (or anything in its cause/context chain) a transient read
    I/O error worth retrying?  Dataset libraries wrap the underlying
    ``OSError``, so the chain is walked."""
    seen: set[int] = set()
    cur: Optional[BaseException] = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, TimeoutError):
            return True
        if isinstance(cur, OSError) and cur.errno in TRANSIENT_READ_ERRNOS:
            return True
        cur = cur.__cause__ or cur.__context__
    return False


class DataStallError(RuntimeError):
    """The upstream data iterator produced nothing for longer than the
    configured data-wait timeout (a dead mount, a wedged page-in, a remote
    store hang).  Raised by :class:`PrefetchIterator` instead of blocking the
    step loop forever."""


class PrefetchIterator:
    """Bounded background prefetch over a batch iterator.

    A daemon thread keeps ``depth`` batches ready in a queue; exceptions
    propagate to the consumer at the point they would have occurred.
    ``close()`` (or GC) stops the thread.

    ``timeout_seconds`` (> 0) arms the data-stall watchdog: a ``__next__``
    that finds nothing for that long raises :class:`DataStallError`.  The
    timeout is per batch, not cumulative.  ``activity_fn`` (e.g.
    ``DataModule.last_io_activity``) is the retry handshake: while the
    producer is retrying a transient read error, the stall timer defers, so
    the error fires only after the retries are exhausted or the source is
    silent.
    """

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2,
                 timeout_seconds: Optional[float] = None,
                 activity_fn: Optional[Callable[[], float]] = None):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._timeout = (float(timeout_seconds)
                         if timeout_seconds and timeout_seconds > 0 else None)
        self._activity = activity_fn
        # the thread target captures only the queue, the event and the
        # sentinel (never self), so an abandoned iterator stays collectible
        q, stop, done = self._q, self._stop, PrefetchIterator._DONE

        def put(item) -> bool:
            """Enqueue unless close() intervened: every producer put must
            honour the stop event, or the thread blocks forever on a full
            queue after close()."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def run() -> None:
            try:
                for item in it:
                    if not put(item):
                        return
                put(done)
            except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
                put(e)

        self._thread = threading.Thread(target=run, daemon=True, name="nxdt-prefetch")
        self._thread.start()

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        # timeout loop so a consumer blocked here wakes up after close()
        waited_from = time.monotonic() if self._timeout is not None else None
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
                if (waited_from is not None
                        and time.monotonic() - waited_from > self._timeout):
                    if self._activity is not None:
                        try:
                            act = float(self._activity() or 0.0)
                        except Exception:  # noqa: BLE001 — a seam, not load-bearing
                            act = 0.0
                        if act and time.monotonic() - act <= self._timeout:
                            # the producer is mid-retry: defer the verdict
                            waited_from = time.monotonic()
                            continue
                    state = ("still running: the source itself is hung (dead "
                             "mount? wedged page-in? remote store stall?)"
                             if self._thread.is_alive() else "DEAD without raising")
                    raise DataStallError(
                        f"data_wait exceeded {self._timeout:.0f}s with no batch from "
                        f"the upstream iterator (prefetch thread {state}); raise the "
                        f"data-wait timeout for a legitimately slower source, or 0 "
                        f"to disable this watchdog")
        if item is self._DONE:
            # terminal: repeat next() calls keep raising StopIteration
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()  # the producer is dead; further next() terminates
            raise item
        return item

    def close(self) -> None:
        self._stop.set()

    def __del__(self) -> None:  # pragma: no cover — belt and braces
        self._stop.set()


def batch_token_stats(batch: dict[str, np.ndarray], *,
                      pad_id: Optional[int] = None) -> dict[str, float]:
    """Per-global-batch data-pipeline stats from the host numpy batch.

    - ``data/padding_fraction``: fraction of token positions contributing
      nothing (``input_ids == pad_id`` when the pad token is known, else
      ``loss_mask == 0``);
    - ``data/packing_efficiency``: mean effective row length / row width,
      the effective length being the index of the last active position + 1;
    - ``data/seq_len_{mean,p50,min,max}``: the per-row effective-length spread.
    """
    ids = batch.get("input_ids")
    if ids is None:
        return {}
    ids = np.asarray(ids)
    if ids.ndim != 2 or ids.size == 0:
        return {}
    if pad_id is not None:
        active = ids != pad_id
    elif "loss_mask" in batch:
        active = np.asarray(batch["loss_mask"]) > 0
    else:
        active = np.ones_like(ids, dtype=bool)
    _, width = active.shape
    any_active = active.any(axis=1)
    last = width - 1 - np.argmax(active[:, ::-1], axis=1)
    eff = np.where(any_active, last + 1, 0).astype(np.float64)
    return {
        "data/padding_fraction": float(1.0 - active.mean()),
        "data/packing_efficiency": float(eff.mean() / width),
        "data/seq_len_mean": float(eff.mean()),
        "data/seq_len_p50": float(np.median(eff)),
        "data/seq_len_min": float(eff.min()),
        "data/seq_len_max": float(eff.max()),
    }


class BatchStats:
    """Thread-safe accumulator of :func:`batch_token_stats` across the
    batches between two logging boundaries (one thread calls :meth:`update`
    per global batch, another drains the running means).  Means average
    across batches; min/max extremes survive the window.  The trainer does
    not log these yet: that is the telemetry planes' slice."""

    def __init__(self, *, pad_id: Optional[int] = None) -> None:
        self.pad_id = pad_id
        self._lock = threading.Lock()
        self._sums: dict[str, float] = {}
        self._mins: dict[str, float] = {}
        self._maxs: dict[str, float] = {}
        self._n = 0

    def update(self, batch: dict[str, np.ndarray]) -> None:
        stats = batch_token_stats(batch, pad_id=self.pad_id)
        if not stats:
            return
        with self._lock:
            self._n += 1
            for k, v in stats.items():
                self._sums[k] = self._sums.get(k, 0.0) + v
                if k.endswith("_min"):
                    self._mins[k] = min(self._mins.get(k, v), v)
                elif k.endswith("_max"):
                    self._maxs[k] = max(self._maxs.get(k, v), v)

    def drain(self) -> dict[str, float]:
        """Stats for the batches seen since the last drain ({} when none)."""
        with self._lock:
            if self._n == 0:
                return {}
            out = {k: v / self._n for k, v in self._sums.items()}
            out.update(self._mins)
            out.update(self._maxs)
            self._sums, self._mins, self._maxs = {}, {}, {}
            self._n = 0
        return out


def process_global_batch(
    batch: dict[str, np.ndarray],
    *,
    input_names: Sequence[str] = ("input_ids", "labels", "loss_mask"),
    pad_id: Optional[int] = None,
    derive_loss_mask: bool = True,
) -> dict[str, np.ndarray]:
    """Filter to ``input_names`` and derive missing ``labels`` / ``loss_mask``;
    ``pad_id`` additionally masks padded positions out of the loss."""
    out: dict[str, np.ndarray] = {}
    ids = np.asarray(batch["input_ids"], dtype=np.int32)
    out["input_ids"] = ids
    if "labels" in input_names:
        labels = np.asarray(batch.get("labels", ids), dtype=np.int32)
        out["labels"] = labels
        if "loss_mask" in input_names:
            if "loss_mask" in batch:
                out["loss_mask"] = np.asarray(batch["loss_mask"], dtype=np.float32)
            elif derive_loss_mask:
                mask = labels != IGNORE_INDEX
                if pad_id is not None:
                    mask &= ids != pad_id
                out["loss_mask"] = mask.astype(np.float32)
    for k in input_names:
        if k not in out and k in batch:
            out[k] = np.asarray(batch[k])
    return out


def dp_rank_rows(global_batch_size: int, num_microbatches: int, dp_rank: int,
                 dp_size: int) -> np.ndarray:
    """The global-batch rows data-parallel rank ``dp_rank`` computes, in
    microbatch order (``[num_microbatches * micro_batch_size]``).
    ``dp_rank`` is the process's coordinate on the mesh's ``data`` axis
    (``parallel/mesh.py::DataParallel.rank``), not its world rank: the tp
    ranks of one dp group compute the same rows.

    The train step splits the global batch microbatch-major
    (``trainer/step.py::microbatch_split``: microbatch ``i`` is rows
    ``i * mbs * dp ... (i + 1) * mbs * dp - 1``, as in the JAX package), and
    the rank takes slice ``[r * mbs, (r + 1) * mbs)`` of each.  This is not
    ``sampler.dp_shard``'s contiguous block per rank (NeMo's layout), which
    would put other rows into each microbatch."""
    if global_batch_size % (num_microbatches * dp_size):
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"num_microbatches * dp = {num_microbatches} * {dp_size}")
    per_micro = global_batch_size // num_microbatches
    mbs = per_micro // dp_size
    return np.concatenate([np.arange(i * per_micro + dp_rank * mbs,
                                     i * per_micro + (dp_rank + 1) * mbs)
                           for i in range(num_microbatches)])


def next_token_targets(labels, loss_mask=None):
    """Labels as next-token targets over the whole row (torch ``[b, s]``):
    ``target[i] = labels[i + 1]``, the last slot ``IGNORE_INDEX``, and the
    loss mask shifted with them (its last slot 0).  The in-model shift of a
    whole row computes the same loss; under context parallelism a rank's
    slice lacks its last token's target (the next rank's first token), so
    the shift comes first."""
    import torch

    tgt = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE_INDEX)], dim=1)
    if loss_mask is not None:
        loss_mask = torch.cat([loss_mask[:, 1:], torch.zeros_like(loss_mask[:, :1])], dim=1)
    return tgt, loss_mask


#: the key prefixes of a preference batch's per-token sides: DPO / ORPO's
#: pairs, KTO's completion ("") and its mismatched-KL rows
PREFERENCE_SIDES = ("chosen_", "rejected_", "", "kl_")


def context_parallel_batch(batch: dict, cp_rank: int, cp_size: int, *, positions=None,
                           shift_labels: bool = True, zigzag: bool = False,
                           sides: Optional[Sequence[str]] = None) -> dict:
    """Context rank ``cp_rank``'s part of a microbatch (torch ``[b, s]``
    tensors, the rows ``dp_rank_rows`` gives the data rank): every context
    rank of a data rank takes the same rows, and each its ``s/cp`` slice of
    every per-token array, after what needs the whole row:

    - ``positions``: the rows' RoPE positions, taken on the whole row by the
      caller (``models/llama.py::positions_for``: for a padded row the count
      of real tokens, ``cumsum(attention_mask) - 1``);
    - ``labels`` become next-token targets (:func:`next_token_targets`)
      unless the data comes pre-shifted (``shift_labels=False``, Megatron),
      and ``loss_mask`` holds the attention mask (as the model's loss does)
      shifted with them;
    - ``zigzag``: then every array is permuted into the zig-zag layout
      (``parallel/ring_attention.py::zigzag_positions``), so rank ``r``
      holds chunks ``r`` and ``2 cp - 1 - r``: JAX's
      ``zigzag_transform_batch`` (shift in the original order, then gather)
      followed by the slice.

    The key mask (``attention_mask``) travels with its slice: the ring
    rotates it with K/V, Ulysses all-gathers it.  A GPT's ``tokentype_ids``
    are cut with the chunk; segment ids are left out (both packages'
    loaders refuse ``sft.segment_mask`` under cp).

    A preference batch (DPO / ORPO pairs, KTO rows) is split side by side
    (``sides``, e.g. :data:`PREFERENCE_SIDES`): each ``<side>input_ids``
    present with its
    ``<side>loss_mask``, targets ``<side>labels`` (the ids shifted on the
    whole row) and ``<side>positions`` (``0 .. s-1``, the preference
    forward's); the per-row arrays (reference columns, ``kto_labels``) stay
    whole."""
    if sides is not None:
        import torch

        out = {k: v for k, v in batch.items() if v.ndim == 1}
        for side in sides:
            ids = batch.get(side + "input_ids")
            if ids is None:
                continue
            pos = torch.arange(ids.shape[1], device=ids.device).expand(ids.shape)
            part = _split_rows({"input_ids": ids, "loss_mask": batch.get(side + "loss_mask")},
                               cp_rank, cp_size, positions=pos, shift_labels=True,
                               zigzag=False)
            out.update({side + k: v for k, v in part.items()})
        return out
    return _split_rows(batch, cp_rank, cp_size, positions=positions,
                       shift_labels=shift_labels, zigzag=zigzag)


def _split_rows(batch: dict, cp_rank: int, cp_size: int, *, positions, shift_labels: bool,
                zigzag: bool) -> dict:
    """:func:`context_parallel_batch` of one side's ``input_ids`` and the
    arrays that go with it."""
    ids = batch["input_ids"]
    s = ids.shape[1]
    if s % cp_size:
        raise ValueError(f"sequence {s} not divisible by context_parallel_size {cp_size}")
    labels, mask, am = batch.get("labels", ids), batch.get("loss_mask"), batch.get("attention_mask")
    if am is not None:
        mask = am.float() if mask is None else mask * am.float()
    if shift_labels:
        labels, mask = next_token_targets(labels, mask)
    out = {"input_ids": ids, "labels": labels, "positions": positions}
    if mask is not None:
        out["loss_mask"] = mask
    if am is not None:
        out["attention_mask"] = am
    if batch.get("tokentype_ids") is not None:
        out["tokentype_ids"] = batch["tokentype_ids"]
    if zigzag:
        from neuronx_distributed_training_torch.parallel.ring_attention import zigzag_positions

        order = zigzag_positions(s, cp_size, device=ids.device)
        out = {k: v.index_select(1, order) for k, v in out.items()}
    n = s // cp_size
    return {k: v[:, cp_rank * n:(cp_rank + 1) * n] for k, v in out.items()}


class DataModule:
    """Base: sampler + row fetch + batch processing.  Subclasses implement
    ``fetch_rows``; ``input_names`` lists the keys a batch keeps."""

    def __init__(
        self,
        total_samples: int,
        global_batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 1234,
        consumed_samples: int = 0,
        input_names: Sequence[str] = ("input_ids", "labels", "loss_mask"),
        io_retries: int = 3,
        io_retry_backoff_seconds: float = 0.5,
    ):
        self.global_batch_size = global_batch_size
        #: the batch keys the model sees (``process_global_batch`` drops others)
        self.input_names = tuple(input_names)
        self.io_retries = int(io_retries)
        self.io_retry_backoff_seconds = float(io_retry_backoff_seconds)
        #: cumulative count of transient-read retries
        self.io_retry_count = 0
        self._io_lock = threading.Lock()
        self._io_activity = 0.0
        if shuffle:
            self.sampler: Any = RandomSampler(
                total_samples, global_batch_size, seed=seed, consumed_samples=consumed_samples
            )
        else:
            self.sampler = PretrainingSampler(
                total_samples, global_batch_size, consumed_samples=consumed_samples
            )

    @property
    def consumed_samples(self) -> int:
        """The sampler's yield counter: with a prefetch thread it runs ahead
        of training, so the trainer derives its resume state from trained
        steps instead."""
        return self.sampler.consumed_samples

    def fetch_rows(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def last_io_activity(self) -> float:
        """Monotonic timestamp of the last transient-retry attempt (the
        data-stall watchdog's handshake)."""
        return self._io_activity

    def _fetch_with_retry(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        """``fetch_rows`` with bounded exponential-backoff retry on transient
        read errors (:func:`is_transient_io_error`).  Runs on the prefetch
        thread.  Non-transient errors and exhausted retries re-raise."""
        delay = self.io_retry_backoff_seconds
        for attempt in range(self.io_retries + 1):
            try:
                return self.fetch_rows(idx)
            except Exception as e:  # noqa: BLE001 — classified below
                if attempt >= self.io_retries or not is_transient_io_error(e):
                    raise
                with self._io_lock:
                    self.io_retry_count += 1
                logger.warning("data: transient read error (%s: %s) — retry %d/%d in %.1fs",
                               type(e).__name__, e, attempt + 1, self.io_retries, delay)
                # sleep in short slices, refreshing the activity timestamp
                # each one: a backoff longer than the stall timeout must
                # still defer the stall verdict
                deadline = time.monotonic() + delay
                while True:
                    self._io_activity = time.monotonic()
                    remaining = deadline - self._io_activity
                    if remaining <= 0:
                        break
                    time.sleep(min(remaining, 0.25))
                delay *= 2
                self._io_activity = time.monotonic()
        raise AssertionError("unreachable")  # pragma: no cover

    def global_batches(self) -> Iterator[dict[str, np.ndarray]]:
        """Yield processed host-side global batches (numpy)."""
        for idx in self.sampler:
            yield process_global_batch(self._fetch_with_retry(idx), input_names=self.input_names)


class HFDataModule(DataModule):
    """Pretokenized arrow directory (``datasets.save_to_disk``) with
    fixed-length rows.  ``datasets`` is imported lazily; without it a path
    raises ``ImportError`` naming the package."""

    def __init__(self, dataset_or_path: Any, global_batch_size: int, **kw: Any):
        if isinstance(dataset_or_path, (str, os.PathLike)):
            try:
                import datasets  # lazy: heavy import
            except ImportError as e:
                raise ImportError(
                    f"data.train_dir {str(dataset_or_path)!r} is an arrow directory "
                    f"written by datasets.save_to_disk; reading it needs the "
                    f"'datasets' package, which is not installed here") from e
            self.dataset = datasets.load_from_disk(str(dataset_or_path))
        else:
            self.dataset = dataset_or_path
        super().__init__(len(self.dataset), global_batch_size, **kw)

    def fetch_rows(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        rows = self.dataset[[int(i) for i in idx]]
        return {k: np.asarray(v) for k, v in rows.items() if not k.startswith("__")}


class SyntheticDataModule(DataModule):
    """Deterministic synthetic causal-LM data: each row is a pure function of
    its index, byte-identical to the JAX package's rows for the same seed."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch_size: int, *,
                 total_samples: int = 1 << 16, seed: int = 0, **kw: Any):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self._seed = seed
        super().__init__(total_samples, global_batch_size, **kw)

    def fetch_rows(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        rows = np.empty((len(idx), self.seq_len), dtype=np.int32)
        for r, i in enumerate(idx):
            rng = np.random.Generator(np.random.PCG64(self._seed * 1_000_003 + int(i)))
            rows[r] = rng.integers(0, self.vocab_size, self.seq_len, dtype=np.int32)
        return {"input_ids": rows}
