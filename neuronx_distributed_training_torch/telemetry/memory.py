"""The ``device_memory`` plane (counterpart of the JAX package's
``telemetry/memory.py::device_memory_samples`` and ``memory_metrics``, and
its trainer's ``device_*`` keys).

At each boundary the trainer samples the allocator of every local CUDA
device (``torch.cuda.memory_stats``: bytes in use and their peak;
``torch.cuda.mem_get_info``: the card's total as the limit) and logs JAX's
legacy ``device_*`` keys: the worst device (max in use and peak, min limit),
the min / p50 spread and the peak device's index.  ``memory_stats`` is a
host query of the caching allocator: no device sync.  On the CPU nothing is
logged, as JAX logs nothing where ``memory_stats()`` is missing.  The rest
of the memory plane (the profile window, subsystem attribution, OOM
bundles) is not ported (ROADMAP queue 1 entry 8).
"""

from __future__ import annotations

from typing import Any, Mapping


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
