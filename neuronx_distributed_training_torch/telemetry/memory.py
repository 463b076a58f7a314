"""Memory observability (the PyTorch port's ``exp_manager.telemetry.memory``
and ``device_memory`` planes; counterpart of the JAX package's
``telemetry/memory.py``, with its knobs, metric names, file formats and
texts).

- **allocator sampling** — per-device ``torch.cuda.memory_stats`` (bytes in
  use and their peak) and ``torch.cuda.mem_get_info`` (the card's total as
  the limit) across the local devices at every logging boundary:
  ``memory/bytes_in_use_max/min/p50``, ``memory/peak_hbm_bytes`` (running
  max of the worst device's watermark), ``memory/hbm_headroom_fraction``
  (the WORST device's remaining fraction).  ``device_memory`` logs JAX's
  legacy ``device_*`` keys from the same sweep.  ``memory_stats`` is a host
  query of the caching allocator: no device sync.  A CPU device has no
  allocator signal and logs nothing, as JAX logs nothing where
  ``memory_stats()`` is missing (its CPU devices).

- **live-buffer attribution** — one capture inside the window
  (``start_step``, ``num_steps``) in place of JAX's
  ``device_memory_profile()``: on the card, ``torch.cuda.memory.
  _snapshot()`` with the allocation stacks that ``_record_memory_history``
  (``stacks="python"``, armed from the plane's start to the capture)
  keeps for each live block.  Each active block becomes a profile sample
  (bytes, one count, its Python frames leaf-first, the device); a block
  holding a storage of the params, the optimizer moments (``opt_state``),
  the fp32 master or the EMA is labelled with that class (the exact join
  JAX makes against :func:`tree_bytes_by_subsystem`), the pipeline's and
  the MoE layers' blocks are named by their frames
  (``parallel/pipeline.py``, ``ops/moe.py``), blocks allocated inside the
  train step are the ``activations`` pool, and what nothing explains is
  ``unattributed``.  On the CPU there is no caching allocator to snapshot:
  the profile lists the storages of the state trees the trainer holds (as
  JAX's CPU profile lists the CPU buffers it holds), each under its class.
  The result is ``memory_summary.json`` in JAX's schema
  (:func:`load_memory_summary`, :func:`measured_hbm_categories`,
  ``tools/memory_report.py``).

- **OOM forensics** — a ``torch.OutOfMemoryError`` (or an error carrying
  JAX's markers) escaping the step boundary writes the ``oom_<step>/``
  bundle: the last boundary samples, the attribution (the window's and a
  fresh one at death), the census's memory facts and the predicted bytes.

- **pprof** — :func:`parse_memory_profile` is JAX's stdlib-only walker of
  the pprof format ``device_memory_profile()`` returns.  The port never
  produces that format, but the repo's ``tools/memory_report.py`` and any
  profile a JAX run wrote still read through it, so it is kept, verbatim.

Everything is host-side: zero graph changes, zero extra host syncs between
boundaries.  Import stays stdlib-only (torch is imported inside the
samplers).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import logging
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Optional

logger = logging.getLogger(__name__)

#: the summary artifact, written next to run_summary.json
MEMORY_SUMMARY_NAME = "memory_summary.json"

#: schema version stamped into memory_summary.json
MEMORY_SUMMARY_SCHEMA = 1

#: attribution classes, in render order (JAX's).  ``params``/``opt_state``/
#: ``master``/``ema`` come from the exact storage join; ``chunk_store``/
#: ``moe_workspace``/``batch`` from allocation stacks; ``activations`` is
#: the train step's pool (step transients + in-flight outputs);
#: ``executable`` is JAX's compiled programs (none in the port);
#: ``unattributed`` is the honest remainder.
SUBSYSTEMS = (
    "params", "opt_state", "master", "ema", "activations",
    "chunk_store", "moe_workspace", "batch", "executable", "unattributed",
)

#: boundary sample records retained for OOM forensics
_RING_STEPS = 32

#: the state classes a block can be joined to by storage
STATE_CLASSES = ("params", "opt_state", "master", "ema")


# ---------------------------------------------------------------------------
# allocator sampling (memory_stats across the local devices)
# ---------------------------------------------------------------------------


def device_memory_samples(devices) -> list[dict[str, Any]]:
    """Per-device allocator stats: ``[{device, kind, bytes_in_use,
    peak_bytes_in_use, bytes_limit}, ...]`` for each CUDA device of
    ``devices``; a CPU device has no allocator signal and is skipped (an
    empty list means "no signal", never a crash)."""
    import torch

    out: list[dict[str, Any]] = []
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            continue
        try:
            stats = torch.cuda.memory_stats(d)
            _, total = torch.cuda.mem_get_info(d)
        except Exception:  # noqa: BLE001 — optional observability
            continue
        out.append({
            "device": str(d.index if d.index is not None else torch.cuda.current_device()),
            "kind": torch.cuda.get_device_name(d),
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        })
    return out


def _p50(values: list[float]) -> float:
    s = sorted(values)
    return float(s[len(s) // 2])


def memory_metrics(samples: list[Mapping[str, Any]]) -> dict[str, float]:
    """Boundary ``memory/`` metrics from one mesh-wide sample sweep.

    Max/min/p50 across the local devices plus the PEAK device's index —
    the spread is the point: a skewed-stage pp run shows a tight min but an
    OOM-bound max.  Headroom is the WORST device's remaining fraction of
    its allocator limit (absent when no device reports a limit)."""
    in_use = [float(s["bytes_in_use"]) for s in samples
              if s.get("bytes_in_use") is not None]
    if not in_use:
        return {}
    out = {
        "memory/bytes_in_use_max": max(in_use),
        "memory/bytes_in_use_min": min(in_use),
        "memory/bytes_in_use_p50": _p50(in_use),
    }
    peaks = [float(s["peak_bytes_in_use"]) for s in samples
             if s.get("peak_bytes_in_use") is not None]
    if peaks:
        out["memory/peak_bytes_max"] = max(peaks)
    # name the peak device (by allocator watermark when present, else
    # current in-use) as a numeric index the scalar sinks can carry; the
    # summary/bundles keep the string name
    ranked = sorted(
        samples,
        key=lambda s: float(s.get("peak_bytes_in_use",
                                  s.get("bytes_in_use", 0)) or 0),
    )
    try:
        out["memory/peak_device"] = float(ranked[-1]["device"])
    except (TypeError, ValueError):
        pass
    headrooms = []
    for s in samples:
        limit = s.get("bytes_limit")
        if limit:
            headrooms.append(
                1.0 - float(s.get("bytes_in_use", 0)) / float(limit))
    if headrooms:
        out["memory/hbm_headroom_fraction"] = min(headrooms)
        limits = [float(s["bytes_limit"]) for s in samples
                  if s.get("bytes_limit")]
        out["memory/bytes_limit_min"] = min(limits)
    return out


# ---------------------------------------------------------------------------
# pprof protobuf parsing (stdlib-only)
# ---------------------------------------------------------------------------
#
# ``jax.profiler.device_memory_profile()`` returns a gzipped pprof Profile
# protobuf (github.com/google/pprof/proto/profile.proto).  The fields this
# parser walks:
#
#   Profile:  1 sample_type (ValueType) / 2 sample (Sample) / 4 location /
#             5 function / 6 string_table
#   ValueType: 1 type (string idx) / 2 unit (string idx)
#   Sample:    1 location_id (repeated uint64, usually packed) /
#              2 value (repeated int64, usually packed) / 3 label (Label)
#   Label:     1 key (string idx) / 2 str (string idx) / 3 num
#   Location:  1 id / 4 line (Line)
#   Line:      1 function_id / 2 line
#   Function:  1 id / 2 name (string idx) / 4 filename (string idx)


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _wire_fields(buf: bytes) -> list[tuple[int, Any]]:
    """Decode one protobuf message into ``[(field_number, value), ...]``;
    length-delimited values stay ``bytes`` for the caller to interpret."""
    i, out = 0, []
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:          # varint
            v, i = _varint(buf, i)
            out.append((field, v))
        elif wire == 2:        # length-delimited
            ln, i = _varint(buf, i)
            out.append((field, buf[i:i + ln]))
            i += ln
        elif wire == 5:        # fixed32
            out.append((field, int.from_bytes(buf[i:i + 4], "little")))
            i += 4
        elif wire == 1:        # fixed64
            out.append((field, int.from_bytes(buf[i:i + 8], "little")))
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
    return out


def _packed_varints(v: Any) -> list[int]:
    if not isinstance(v, bytes):
        return [int(v)]
    i, out = 0, []
    while i < len(v):
        x, i = _varint(v, i)
        out.append(x)
    return out


def parse_memory_profile(data: bytes) -> dict[str, Any]:
    """Parse a ``device_memory_profile()`` payload (gzipped or raw pprof)
    into plain dicts::

        {"samples": [{"bytes": int, "count": int,
                      "stack": [fn, ...],          # leaf-first
                      "files": [filename, ...],    # aligned with stack
                      "labels": {"kind": "buffer", "device": "...", ...}},
                     ...],
         "total_bytes": int, "total_count": int,
         "by_device": {device: bytes}}

    The value columns are selected by sample_type name (``space``/bytes and
    ``allocations``/count), not position, so a column reorder in a future
    jax cannot silently swap bytes for counts.
    """
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    top = _wire_fields(data)
    strings: list[str] = []
    for field, v in top:
        if field == 6:
            strings.append(v.decode("utf-8", "replace")
                           if isinstance(v, bytes) else str(v))

    def s(idx: Any) -> str:
        try:
            return strings[int(idx)]
        except (IndexError, TypeError, ValueError):
            return "?"

    # value-column roles from sample_type
    bytes_col = count_col = None
    col = 0
    for field, v in top:
        if field != 1:
            continue
        vt = dict(_wire_fields(v))
        name = s(vt.get(1, 0))
        if name == "space":
            bytes_col = col
        elif name in ("allocations", "objects", "count"):
            count_col = col
        col += 1
    if bytes_col is None:       # fall back to pprof's conventional order
        bytes_col = 1 if col > 1 else 0

    functions: dict[int, tuple[str, str]] = {}
    for field, v in top:
        if field != 5:
            continue
        fn = dict(_wire_fields(v))
        functions[int(fn.get(1, 0))] = (s(fn.get(2, 0)), s(fn.get(4, 0)))

    locations: dict[int, list[tuple[str, str]]] = {}
    for field, v in top:
        if field != 4:
            continue
        loc_id = None
        frames: list[tuple[str, str]] = []
        for f2, v2 in _wire_fields(v):
            if f2 == 1:
                loc_id = int(v2)
            elif f2 == 4:
                line = dict(_wire_fields(v2))
                frames.append(functions.get(int(line.get(1, 0)), ("?", "?")))
        if loc_id is not None:
            locations[loc_id] = frames

    samples: list[dict[str, Any]] = []
    total_bytes = total_count = 0
    by_device: dict[str, int] = {}
    for field, v in top:
        if field != 2:
            continue
        loc_ids: list[int] = []
        values: list[int] = []
        labels: dict[str, Any] = {}
        for f2, v2 in _wire_fields(v):
            if f2 == 1:
                loc_ids.extend(_packed_varints(v2))
            elif f2 == 2:
                values.extend(_packed_varints(v2))
            elif f2 == 3:
                lab = dict(_wire_fields(v2))
                key = s(lab.get(1, 0))
                labels[key] = s(lab[2]) if 2 in lab else lab.get(3)
        stack, files = [], []
        for lid in loc_ids:
            for name, fname in locations.get(lid, ()):
                stack.append(name)
                files.append(fname)
        nbytes = int(values[bytes_col]) if len(values) > bytes_col else 0
        count = (int(values[count_col])
                 if count_col is not None and len(values) > count_col else 0)
        samples.append({"bytes": nbytes, "count": count, "stack": stack,
                        "files": files, "labels": labels})
        total_bytes += nbytes
        total_count += count
        dev = labels.get("device")
        if dev is not None:
            by_device[str(dev)] = by_device.get(str(dev), 0) + nbytes
    return {"samples": samples, "total_bytes": total_bytes,
            "total_count": total_count, "by_device": by_device}


# ---------------------------------------------------------------------------
# attribution: the storage join + stacks
# ---------------------------------------------------------------------------

#: ordered (class, frame-token) scope rules — first match wins, specific
#: before generic.  Tokens match against function names; ``file:`` tokens
#: against the frame's filename suffix.  ``dispatch`` is an internal class:
#: blocks allocated inside the train step, the ``activations`` pool after
#: the state carve-out (the state blocks are labelled by the storage join
#: first, so the carve-out finds nothing left to take).
SCOPE_RULES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("opt_state", ("init_opt_state",)),
    ("params", ("init_params", "add_lora")),
    ("chunk_store", ("file:parallel/pipeline.py",)),
    ("moe_workspace", ("file:ops/moe.py",)),
    ("batch", ("_dispatch", "global_batches", "pin_memory")),
    ("dispatch", ("file:trainer/step.py", "file:optim/adamw.py", "fit")),
)


def _classify_sample(sample: Mapping[str, Any]) -> str:
    labels = sample.get("labels") or {}
    if labels.get("kind") == "executable":
        return "executable"
    if labels.get("owner") in STATE_CLASSES:
        return str(labels["owner"])
    stack = list(sample.get("stack") or ())
    files = list(sample.get("files") or ())
    for cls, tokens in SCOPE_RULES:
        for token in tokens:
            if token.startswith("file:"):
                suffix = token[len("file:"):]
                if any(f.endswith(suffix) for f in files):
                    return cls
            elif any(token in fn for fn in stack):
                return cls
    return "unattributed"


def attribute_profile(
    profile: Mapping[str, Any],
    tree_hints: Optional[Mapping[str, int]] = None,
) -> dict[str, dict[str, int]]:
    """Attribute a parsed profile's live bytes to :data:`SUBSYSTEMS`.

    Stage 1 classifies every sample by its allocation stack
    (:data:`SCOPE_RULES`).  Stage 2 joins the dispatch-site pool against
    ``tree_hints`` — the EXACT addressable byte totals of the live state
    trees (``{"params": b, "opt_state": b, "master": b, "ema": b}``,
    :func:`tree_bytes_by_subsystem`): each state class takes
    ``min(remaining pool, its exact size - whatever stage 1 already found)``
    and the leftover pool is ``activations`` (step transients / in-flight
    outputs).  Without hints the pool itself reports as ``activations``.

    The returned classes PARTITION the profile: their byte (and count)
    totals sum exactly to ``profile["total_bytes"]`` /
    ``["total_count"]`` — the unattributed remainder is a first-class row,
    never a silent drop."""
    out: dict[str, dict[str, int]] = {
        cls: {"bytes": 0, "count": 0} for cls in SUBSYSTEMS}
    pool_bytes = pool_count = 0
    for sample in profile.get("samples") or ():
        cls = _classify_sample(sample)
        if cls == "dispatch":
            pool_bytes += int(sample.get("bytes", 0))
            pool_count += int(sample.get("count", 0))
            continue
        out[cls]["bytes"] += int(sample.get("bytes", 0))
        out[cls]["count"] += int(sample.get("count", 0))
    for cls in ("params", "opt_state", "master", "ema"):
        want = int((tree_hints or {}).get(cls, 0) or 0)
        carve = min(max(want - out[cls]["bytes"], 0), pool_bytes)
        if carve > 0:
            out[cls]["bytes"] += carve
            pool_bytes -= carve
    out["activations"]["bytes"] += pool_bytes
    out["activations"]["count"] += pool_count
    return {cls: rec for cls, rec in out.items()
            if rec["bytes"] or rec["count"]}


def _state_groups(params: Any, opt_state: Any) -> dict[str, list]:
    """The live state tensors by class: params, the optimizer moments and
    other per-leaf state (``opt_state``), ``master``, ``ema``."""
    def leaves(tree):
        if isinstance(tree, Mapping):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from leaves(v)
        elif hasattr(tree, "untyped_storage"):
            yield tree

    opt = dict(opt_state) if isinstance(opt_state, Mapping) else {}
    out = {"params": list(leaves(params)),
           "opt_state": list(leaves({k: v for k, v in opt.items()
                                     if k not in ("master", "ema", "health")}))}
    for key in ("master", "ema"):
        if key in opt:
            out[key] = list(leaves(opt[key]))
    return out


def _local(t: Any) -> Any:
    return t.to_local() if hasattr(t, "to_local") else t


def tree_bytes_by_subsystem(params: Any, opt_state: Any) -> dict[str, int]:
    """Exact byte totals of the live state trees this process holds, by
    subsystem: each leaf's local bytes (a ZeRO-1 DTensor's local slice) —
    host-side metadata, no device work (JAX's addressable totals)."""
    return {cls: sum(int(_local(t).numel()) * int(_local(t).element_size()) for t in ts)
            for cls, ts in _state_groups(params, opt_state).items()}


def state_storages(params: Any, opt_state: Any) -> dict[int, tuple[str, int, str]]:
    """``{storage data_ptr: (class, storage bytes, device)}`` of the live
    state trees (the storage join of the attribution)."""
    out: dict[int, tuple[str, int, str]] = {}
    for cls, ts in _state_groups(params, opt_state).items():
        for t in ts:
            st = _local(t).untyped_storage()
            if st.data_ptr() and st.data_ptr() not in out:
                out[st.data_ptr()] = (cls, int(st.nbytes()), str(_local(t).device))
    return out


def profile_from_snapshot(snapshot: Mapping[str, Any],
                          owners: Mapping[int, tuple[str, int, str]]) -> dict[str, Any]:
    """A profile (:func:`parse_memory_profile`'s schema) of the active blocks
    of a ``torch.cuda.memory._snapshot()``: one sample a block, its frames
    leaf-first, labelled ``owner`` when a state storage starts inside it."""
    starts = sorted(owners)
    import bisect

    samples: list[dict[str, Any]] = []
    total = 0
    by_device: dict[str, int] = {}
    for seg in snapshot.get("segments") or ():
        dev = str(seg.get("device", "?"))
        running = int(seg.get("address", 0))
        for blk in seg.get("blocks") or ():
            # a segment's blocks tile it in address order
            addr, size = int(blk.get("address", running)), int(blk["size"])
            running = addr + size
            if blk.get("state") != "active_allocated":
                continue
            labels: dict[str, Any] = {"kind": "buffer", "device": dev}
            i = bisect.bisect_left(starts, addr)
            if i < len(starts) and starts[i] < addr + size:
                labels["owner"] = owners[starts[i]][0]
            frames = list(blk.get("frames") or
                          ((blk.get("history") or [{}])[-1].get("frames") or ()))
            samples.append({"bytes": size, "count": 1,
                            "stack": [str(f.get("name", "?")) for f in frames],
                            "files": [str(f.get("filename", "?")) for f in frames],
                            "labels": labels})
            total += size
            by_device[dev] = by_device.get(dev, 0) + size
    return {"samples": samples, "total_bytes": total, "total_count": len(samples),
            "by_device": by_device}


def profile_from_storages(owners: Mapping[int, tuple[str, int, str]]) -> dict[str, Any]:
    """The CPU's profile: one sample per state storage, under its class."""
    samples = [{"bytes": n, "count": 1, "stack": [], "files": [],
                "labels": {"kind": "buffer", "device": dev, "owner": cls}}
               for cls, n, dev in owners.values()]
    by_device: dict[str, int] = {}
    for s in samples:
        d = s["labels"]["device"]
        by_device[d] = by_device.get(d, 0) + s["bytes"]
    return {"samples": samples, "total_bytes": sum(s["bytes"] for s in samples),
            "total_count": len(samples), "by_device": by_device}


def capture_profile(devices, params: Any = None, opt_state: Any = None) -> dict[str, Any]:
    """One live-buffer profile of ``devices``: the caching allocator's
    snapshot on a card, the state storages on the CPU."""
    import torch

    owners = state_storages(params, opt_state) if params is not None else {}
    if any(torch.device(d).type == "cuda" for d in devices):
        return profile_from_snapshot(torch.cuda.memory._snapshot(), owners)
    return profile_from_storages(owners)


def start_recording(devices) -> bool:
    """Keep the Python stack of every new block on the cards of
    ``devices`` until :func:`stop_recording` (the attribution's frames);
    False on the CPU."""
    import torch

    if not any(torch.device(d).type == "cuda" for d in devices):
        return False
    torch.cuda.memory._record_memory_history(enabled="state", stacks="python")
    return True


def stop_recording() -> None:
    import torch

    torch.cuda.memory._record_memory_history(enabled=None)


# ---------------------------------------------------------------------------
# the knob block
# ---------------------------------------------------------------------------


def _memory_knobs() -> set[str]:
    return {f.name for f in dataclasses.fields(MemoryConfig)}


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """``exp_manager.telemetry.memory`` knob block (validated at config
    load).

    .. code-block:: yaml

        exp_manager:
          telemetry:
            memory:
              enabled: false       # boundary allocator sampling + the window
              start_step: 1        # profile window start (skip step 0: compile)
              num_steps: 3         # window length
              profile: true        # capture device_memory_profile() in-window
              oom_forensics: true  # RESOURCE_EXHAUSTED -> oom_<step>/ bundle
              headroom_alert_fraction: 0.05  # warn when the worst device's
                                             # headroom falls below this
                                             # (0 disables the warning)
    """

    enabled: bool = False
    start_step: int = 1
    num_steps: int = 3
    profile: bool = True
    oom_forensics: bool = True
    headroom_alert_fraction: float = 0.05

    @classmethod
    def from_config(cls, block: Any) -> "MemoryConfig":
        """Accepts ``None`` (defaults: disabled), a bare bool, or a mapping
        of knobs.  Unknown keys raise with a did-you-mean hint — a typo'd
        knob must not silently observe nothing."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        knobs = _memory_knobs()
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.telemetry.memory must be a mapping of "
                f"{sorted(knobs)} (or a single bool), got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - knobs
        if unknown:
            from neuronx_distributed_training_torch.config.loader import (
                did_you_mean,
            )

            raise ValueError(
                f"unknown exp_manager.telemetry.memory keys "
                f"{sorted(unknown)}; supported: {sorted(knobs)}"
                + did_you_mean(unknown, knobs)
            )
        values = dict(block)
        for key in ("enabled", "profile", "oom_forensics"):
            if key in values and not isinstance(values[key], bool):
                raise ValueError(
                    f"exp_manager.telemetry.memory.{key} must be a boolean, "
                    f"got {values[key]!r}"
                )
        out = cls(
            enabled=bool(values.get("enabled", cls.enabled)),
            start_step=int(values.get("start_step", cls.start_step)),
            num_steps=int(values.get("num_steps", cls.num_steps)),
            profile=bool(values.get("profile", cls.profile)),
            oom_forensics=bool(
                values.get("oom_forensics", cls.oom_forensics)),
            headroom_alert_fraction=float(
                values.get("headroom_alert_fraction",
                           cls.headroom_alert_fraction)),
        )
        if out.start_step < 0:
            raise ValueError(
                f"exp_manager.telemetry.memory.start_step must be >= 0, "
                f"got {out.start_step}"
            )
        if out.num_steps < 1:
            raise ValueError(
                f"exp_manager.telemetry.memory.num_steps must be >= 1, "
                f"got {out.num_steps}"
            )
        if not 0.0 <= out.headroom_alert_fraction < 1.0:
            raise ValueError(
                f"exp_manager.telemetry.memory.headroom_alert_fraction must "
                f"be in [0, 1), got {out.headroom_alert_fraction}"
            )
        return out

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# OOM detection
# ---------------------------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED", "Out of memory",
                "out of memory", "OOM")


def is_oom_error(exc: BaseException) -> bool:
    """Does this exception look like a device allocator exhaustion?  On
    the card that is ``torch.OutOfMemoryError`` (``torch.cuda.
    OutOfMemoryError``); an error carrying JAX's markers
    (``RESOURCE_EXHAUSTED``, ``Out of memory``) counts too."""
    import torch

    if isinstance(exc, getattr(torch, "OutOfMemoryError", ())):
        return True
    msg = f"{type(exc).__name__}: {exc}"
    return any(marker in msg for marker in _OOM_MARKERS)


# ---------------------------------------------------------------------------
# the plane the trainer wires in
# ---------------------------------------------------------------------------


class MemoryPlane:
    """Boundary-cadence allocator sampling + the one windowed profile
    capture + OOM forensics.  Every failure degrades to a warning —
    observability must never kill training."""

    def __init__(
        self,
        cfg: MemoryConfig,
        out_dir: str | Path,
        *,
        devices: Any = None,
        tree_bytes_fn: Optional[Callable[[], Mapping[str, int]]] = None,
        state_fn: Optional[Callable[[], tuple]] = None,
        predicted: Optional[Mapping[str, Any]] = None,
        run_facts: Optional[Mapping[str, Any]] = None,
        write_run_summary: Optional[Callable[[dict], None]] = None,
    ) -> None:
        self.cfg = cfg
        self.out_dir = Path(out_dir)
        self.summary_path = self.out_dir / MEMORY_SUMMARY_NAME
        self._devices = devices
        self._tree_bytes_fn = tree_bytes_fn
        #: ``() -> (params, opt_state)``: the live trees the storage join reads
        self._state_fn = state_fn
        self._recording = False
        if cfg.enabled and cfg.profile:
            try:
                self._recording = start_recording(self._local_devices())
            except Exception as e:  # noqa: BLE001 — capture is best-effort
                logger.warning("memory: allocation-stack recording failed: %s", e)
        self.predicted = dict(predicted) if predicted else None
        self.run_facts = dict(run_facts or {})
        self._write_run_summary = write_run_summary
        self._ring: list[dict[str, Any]] = []
        self._peak_bytes = 0.0
        self._headroom_warned = False
        self.profiled = False
        #: best in-window capture so far: (step, parsed profile, samples)
        self._best: Optional[tuple[int, dict, list]] = None
        self.summary: Optional[dict[str, Any]] = None
        self._oom_dumped = False

    # -- boundary cadence ----------------------------------------------------

    def _local_devices(self) -> list:
        if self._devices is None:
            return []
        devices = self._devices
        if callable(devices):
            devices = devices()
        return list(devices)

    def boundary(self, step: int) -> dict[str, float]:
        """One boundary: sample the local mesh, update the forensic ring +
        running peak, drive the profile window, and return the ``memory/``
        metrics for the sink stream.  Host-side only."""
        if not self.cfg.enabled:
            return {}
        samples = device_memory_samples(self._local_devices())
        metrics = memory_metrics(samples)
        if samples:
            self._ring.append({"step": int(step), "t": round(time.time(), 3),
                               "devices": samples})
            del self._ring[:-_RING_STEPS]
            self._peak_bytes = max(
                self._peak_bytes,
                metrics.get("memory/peak_bytes_max",
                            metrics.get("memory/bytes_in_use_max", 0.0)))
            metrics["memory/peak_hbm_bytes"] = self._peak_bytes
        headroom = metrics.get("memory/hbm_headroom_fraction")
        if (headroom is not None and self.cfg.headroom_alert_fraction > 0
                and headroom < self.cfg.headroom_alert_fraction
                and not self._headroom_warned):
            self._headroom_warned = True
            # only limit-reporting devices can be "near OOM" — a device
            # without a bytes_limit must not be (mis)named in the warning
            worst = min(
                (s for s in samples if s.get("bytes_limit")),
                key=lambda s: 1.0 - float(s.get("bytes_in_use", 0))
                / float(s["bytes_limit"]))
            logger.warning(
                "memory: HBM headroom %.1f%% on device %s (%s) fell below "
                "the %.1f%% alert fraction — OOM proximity; see "
                "memory_summary.json attribution and docs/observability.md "
                "'Memory observability'",
                100 * headroom, worst.get("device"), worst.get("kind"),
                100 * self.cfg.headroom_alert_fraction,
            )
        # the profile window [start_step, start_step + num_steps): every
        # in-window boundary captures and the LARGEST in-use capture wins
        # (the in-window peak); the summary is written when the window
        # passes.  A boundary cadence coarser than the window must not
        # silently skip the capture — the first boundary past it captures
        # late and finalizes immediately.
        if self.cfg.profile and not self.profiled \
                and step >= self.cfg.start_step:
            end = self.cfg.start_step + self.cfg.num_steps
            if step < end:
                self._capture_profile(step, samples)
            else:
                if self._best is None:
                    self._capture_profile(step, samples)
                self._finalize()
        return metrics

    def _profile(self) -> dict[str, Any]:
        state = self._state_fn() if self._state_fn is not None else (None, None)
        return capture_profile(self._local_devices(), *state)

    def _capture_profile(self, step: int, samples: list[dict]) -> None:
        try:
            profile = self._profile()
        except Exception as e:  # noqa: BLE001 — capture is best-effort
            logger.warning("memory: device_memory_profile capture/parse "
                           "failed: %s", e)
            return
        if self._best is None or profile["total_bytes"] \
                > self._best[1]["total_bytes"]:
            self._best = (int(step), profile, list(samples))

    def _stop_recording(self) -> None:
        if self._recording:
            self._recording = False
            try:
                stop_recording()
            except Exception as e:  # noqa: BLE001
                logger.warning("memory: allocation-stack recording stop failed: %s", e)

    def _finalize(self) -> None:
        self._stop_recording()
        if self.profiled or self._best is None:
            self.profiled = True
            return
        self.profiled = True
        step, profile, samples = self._best
        self._best = None  # the parsed stacks are not kept past the summary
        tree_hints: Optional[dict[str, int]] = None
        if self._tree_bytes_fn is not None:
            try:
                tree_hints = dict(self._tree_bytes_fn())
            except Exception as e:  # noqa: BLE001
                logger.warning("memory: tree-byte hints failed: %s", e)
        attribution = attribute_profile(profile, tree_hints)
        n_dev = max(len(profile.get("by_device") or {}), 1)
        self.summary = {
            "schema": MEMORY_SUMMARY_SCHEMA,
            "window": {"start_step": self.cfg.start_step,
                       "num_steps": self.cfg.num_steps},
            "profiled_step": int(step),
            "profile": {
                "total_bytes": profile["total_bytes"],
                "total_count": profile["total_count"],
                "num_samples": len(profile["samples"]),
                "by_device": profile["by_device"],
                "num_devices": n_dev,
            },
            "attribution": attribution,
            "tree_bytes": tree_hints,
            "sampled": {
                "per_device": samples,
                "peak_hbm_bytes": int(self._peak_bytes) or None,
            },
            "predicted": self.predicted,
            "run_facts": self.run_facts or None,
        }
        try:
            tmp = self.summary_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self.summary, indent=1,
                                      sort_keys=True) + "\n")
            tmp.replace(self.summary_path)
        except OSError as e:
            logger.warning("memory: summary write failed: %s", e)
            return
        if self._write_run_summary is not None:
            try:
                self._write_run_summary({"memory": self.summary_block()})
            except Exception as e:  # noqa: BLE001
                logger.warning("memory: run_summary update failed: %s", e)
        logger.info(
            "memory: profile captured at step %d — %d live buffers, "
            "%.1f MB in use, attribution -> %s",
            step, profile["total_count"] or len(profile["samples"]),
            profile["total_bytes"] / 1e6, self.summary_path,
        )

    def summary_block(self) -> dict[str, Any]:
        """Compact block mirrored into ``run_summary.json``."""
        s = self.summary or {}
        prof = s.get("profile") or {}
        return {
            "profiled_step": s.get("profiled_step"),
            "in_use_bytes": prof.get("total_bytes"),
            "peak_hbm_bytes": int(self._peak_bytes) or None,
            "attribution": {cls: rec.get("bytes")
                            for cls, rec in (s.get("attribution")
                                             or {}).items()},
            "predicted_hbm_bytes": ((self.predicted or {}).get("total")),
            "summary_path": str(self.summary_path),
        }

    # -- teardown / forensics -----------------------------------------------

    def close(self) -> None:
        """Teardown: finalize a still-open window (fit() ended inside it)
        — short runs must still produce a summary."""
        if self.cfg.enabled and self.cfg.profile and not self.profiled:
            if self._best is None:
                samples = device_memory_samples(self._local_devices())
                self._capture_profile(-1, samples)
            self._finalize()
        self._stop_recording()

    def dump_oom(
        self,
        step: int,
        exc: BaseException,
        *,
        boundary_metrics: Optional[Mapping[str, Any]] = None,
        memory_analysis: Optional[Mapping[str, Any]] = None,
    ) -> Optional[Path]:
        """Write the ``oom_<step>/`` forensic bundle: the allocator-sample
        ring, the attribution table (last captured — plus a best-effort
        fresh capture: the allocator usually survives the failed
        allocation), the compile census's ``memory_analysis`` bytes, and
        the planner's predicted HBM breakdown.  At most one per process."""
        if not self.cfg.enabled or not self.cfg.oom_forensics \
                or self._oom_dumped:
            return None
        self._oom_dumped = True
        bundle = self.out_dir / f"oom_{int(step):08d}"
        # a fresh profile at death: the failed allocation raised, but live
        # buffers are still registered — this is the attribution that names
        # the culprit.  Never let it mask the bundle write.
        fresh: Optional[dict[str, Any]] = None
        try:
            profile = self._profile()
            hints = (dict(self._tree_bytes_fn())
                     if self._tree_bytes_fn is not None else None)
            fresh = {
                "total_bytes": profile["total_bytes"],
                "by_device": profile["by_device"],
                "attribution": attribute_profile(profile, hints),
            }
        except Exception as e:  # noqa: BLE001 — the device may be gone
            logger.warning("memory: post-OOM profile capture failed: %s", e)
        summary = {
            "kind": "oom",
            "step": int(step),
            "error": f"{type(exc).__name__}: {exc}"[:2000],
            "boundary_metrics": {
                k: v for k, v in (boundary_metrics or {}).items()
                if isinstance(v, (int, float)) and v == v
            },
            "attribution": ((self.summary or {}).get("attribution")),
            "attribution_at_death": (fresh or {}).get("attribution"),
            "in_use_bytes_at_death": (fresh or {}).get("total_bytes"),
            "by_device_at_death": (fresh or {}).get("by_device"),
            "tree_bytes": (self.summary or {}).get("tree_bytes"),
            "peak_hbm_bytes": int(self._peak_bytes) or None,
            # predicted-vs-actual in ONE artifact: the planner's breakdown
            # for the resolved plan and the census's compiled bytes
            "predicted_hbm_breakdown": self.predicted,
            "memory_analysis": dict(memory_analysis or {}) or None,
            "run_facts": self.run_facts or None,
        }
        try:
            bundle.mkdir(parents=True, exist_ok=True)
            with open(bundle / "oom.json", "w") as f:
                json.dump(summary, f, indent=1, sort_keys=True)
                f.write("\n")
            with open(bundle / "samples.json", "w") as f:
                json.dump(self._ring, f, indent=1)
                f.write("\n")
        except Exception as e:  # noqa: BLE001 — forensics must not mask the
            # propagating OOM
            logger.warning("memory: oom bundle write failed: %s", e)
            return None
        if self._write_run_summary is not None:
            try:
                self._write_run_summary({"oom": {
                    "step": int(step), "bundle": bundle.name,
                    "error": summary["error"][:300],
                }})
            except Exception as e:  # noqa: BLE001
                logger.warning("memory: oom run_summary update failed: %s", e)
        logger.error(
            "memory: RESOURCE_EXHAUSTED at step %d — OOM forensic bundle "
            "written to %s (attribution, allocator ring, predicted-vs-"
            "actual)", step, bundle,
        )
        return bundle


# ---------------------------------------------------------------------------
# summary loading (the calibration / report surface)
# ---------------------------------------------------------------------------


def load_memory_summary(source: Any) -> dict[str, Any]:
    """A memory summary from any accepted source: the loaded dict, a
    ``memory_summary.json`` path, or a run dir containing one."""
    if isinstance(source, Mapping):
        return dict(source)
    p = Path(source)
    if p.is_dir():
        p = p / MEMORY_SUMMARY_NAME
    doc = json.loads(p.read_text())
    if not isinstance(doc, dict):
        raise ValueError(f"{p}: not a memory summary (expected an object)")
    return doc


def is_memory_summary(doc: Mapping[str, Any]) -> bool:
    """Distinguish a ``memory_summary.json`` payload from a trace summary
    (``tools/plan.py --calibrate-from`` accepts either)."""
    return "attribution" in doc or (
        isinstance(doc.get("profile"), Mapping)
        and "total_bytes" in doc["profile"])


#: attribution class -> the ``hbm_breakdown`` category it measures.  THE
#: one map ``cost_model.hbm_calibration_from_memory_summary`` and
#: ``tools/memory_report.py`` share (two hand-maintained copies of this
#: join would let the report's predicted-vs-measured table silently
#: disagree with the ratios the planner actually applies).  ``opt_state``
#: folds the state classes the model prices together (moments + master +
#: EMA under ``opt_mult``); the pipeline chunk-store calibrates the
#: ``pipeline_rings`` term, the MoE routing workspace the
#: ``gathered_experts`` term.
MEMORY_CLASS_TO_CATEGORY: dict[str, str] = {
    "params": "params",
    "opt_state": "opt_state",
    "master": "opt_state",
    "ema": "opt_state",
    "activations": "activations",
    "chunk_store": "pipeline_rings",
    "moe_workspace": "gathered_experts",
}


def measured_hbm_categories(summary: Mapping[str, Any]
                            ) -> tuple[dict[str, float], Optional[float]]:
    """``(per-device measured bytes by hbm_breakdown category, per-device
    measured peak)`` out of a memory summary — the measured side of every
    predicted-vs-measured consumer (planner calibration, the report's
    table, PC502's facts).

    Tree bytes are exact and beat the stack-derived attribution for the
    state classes; attribution/tree sums span ALL local devices and divide
    by the profile's device count, while ``sampled.peak_hbm_bytes`` is
    ALREADY per-device (the worst single device's allocator watermark) and
    is taken verbatim — only the profile-total fallback divides."""
    n_dev = max(int((summary.get("profile") or {}).get("num_devices", 1)
                    or 1), 1)
    measured_cls: dict[str, float] = {}
    for cls, rec in (summary.get("attribution") or {}).items():
        b = rec.get("bytes") if isinstance(rec, Mapping) else rec
        if b:
            measured_cls[cls] = float(b)
    for cls, b in (summary.get("tree_bytes") or {}).items():
        if b:
            measured_cls[cls] = float(b)
    per_category: dict[str, float] = {}
    for cls, cat in MEMORY_CLASS_TO_CATEGORY.items():
        if measured_cls.get(cls):
            per_category[cat] = per_category.get(cat, 0.0) \
                + measured_cls[cls] / n_dev
    peak = (summary.get("sampled") or {}).get("peak_hbm_bytes")
    if peak:
        peak = float(peak)
    else:
        total = (summary.get("profile") or {}).get("total_bytes")
        peak = float(total) / n_dev if total else None
    return per_category, peak


#: ``memory/`` metric -> its legacy ``device_*`` key (telemetry.
#: device_memory predates the memory plane; beacons and dashboards key on
#: these names)
LEGACY_DEVICE_MEMORY_KEYS = (
    ("memory/bytes_in_use_max", "device_bytes_in_use"),
    ("memory/peak_bytes_max", "device_peak_bytes_in_use"),
    ("memory/bytes_limit_min", "device_bytes_limit"),
    ("memory/bytes_in_use_min", "device_bytes_in_use_min"),
    ("memory/bytes_in_use_p50", "device_bytes_in_use_p50"),
    ("memory/peak_device", "device_peak_device"),
)


def legacy_device_memory_keys(mm: dict[str, float]) -> dict[str, float]:
    """``memory/`` metrics -> the legacy ``device_*`` names, so a boundary
    with BOTH ``device_memory`` and ``telemetry.memory`` on runs ONE
    allocator sweep (the two keys would otherwise come from two sweeps at
    slightly different instants and disagree within one record)."""
    return {dst: mm[src] for src, dst in LEGACY_DEVICE_MEMORY_KEYS
            if src in mm}


def device_memory_metrics(devices) -> dict[str, float]:
    """The boundary's ``device_*`` keys over ``devices`` ({} on the CPU)."""
    return legacy_device_memory_keys(memory_metrics(device_memory_samples(devices)))
