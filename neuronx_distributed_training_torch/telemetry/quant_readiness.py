"""Quantization-readiness analysis over tensorstats dynamic-range telemetry.

The PyTorch port's copy of the JAX package's
``telemetry/quant_readiness.py``.  The port's
``tools/quant_readiness.py`` runs ``build_report(**load_run_dir(run_dir))``
with the port's cost model's byte volumes.

Host-side and stdlib-only: takes the cumulative per-layer-group statistics
the in-graph plane (``telemetry.tensorstats``) streamed into a run's
artifacts and SIMULATES block-scaled int8 quantization of each collective
class's payload — the study that int8 / block-scaled compressed
collectives (per EQuARX; an item of the JAX package's roadmap, not yet
this port's) need before committing graph changes:

* **what compression would buy** — wire bytes saved per class (a pure
  function of the block size and scale width), joined with the planner's
  per-class byte volumes (``autotune.cost_model.collective_byte_volumes``)
  and, when a ``trace_summary.json`` is present, the MEASURED exposed
  seconds per class (``overlap_by_class``) — so savings are priced in
  exposed step time, not raw bytes;
* **what it would cost in error** — predicted SQNR and RMS relative error
  per layer-group at configurable block sizes, from the log2-exponent
  histograms: for an i.i.d. block of ``B`` elements the block absmax
  exponent is distributed as ``F(e)^B`` (``F`` the per-element exponent
  CDF, zeros counted below the lowest bin), each exponent implies an int8
  scale ``2^(e+1)/127`` (the bin's upper edge bounds the absmax), and
  round-to-nearest contributes ``scale^2/12`` noise variance per element.

The model is deliberately simple enough to hand-check (the unit tests pin a
uniform ``2^-3`` distribution to ``10*log10(12*127^2/4) ~= 46.85 dB``) — it
ranks classes and flags underflow-dominated groups; it does not replace
measuring a real compressed collective.

Collective classes map onto captured phases: ``reduce-scatter`` and
``all-reduce`` carry gradients (the ``pre``-clip phase — what a compressed
grad collective would see); ``all-gather`` carries packed ZeRO-1 bucket
payloads (the ``bucket`` phase, when ``tensorstats.buckets`` was on).
Classes whose payloads are activations (``collective-permute``,
``all-to-all``) still get the bytes/seconds side of the report, with the
error side marked unavailable — the observatory watches optimizer-boundary
tensors only.

CLI: ``tools/quant_readiness.py``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Mapping, Optional, Sequence

__all__ = [
    "CLASS_PHASE",
    "DEFAULT_BLOCK_SIZES",
    "build_report",
    "bytes_saved_fraction",
    "load_run_dir",
    "pool_groups",
    "predict_block_quant",
]

#: which captured tensorstats phase models each collective class's payload
CLASS_PHASE: dict[str, str] = {
    "reduce-scatter": "pre",
    "all-reduce": "pre",
    "all-gather": "bucket",
}

DEFAULT_BLOCK_SIZES: tuple[int, ...] = (32, 128, 512)

#: int8 payload byte per element
_INT8_BYTES = 1.0
#: fp32 per-block scale
_SCALE_BYTES = 4.0


def bytes_saved_fraction(block_size: int,
                         orig_bytes_per_elem: float = 4.0) -> float:
    """Wire fraction saved by int8 + one fp32 scale per ``block_size``
    elements, vs ``orig_bytes_per_elem`` uncompressed.  Distribution-free."""
    b = int(block_size)
    if b < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    comp = _INT8_BYTES + _SCALE_BYTES / b
    return 1.0 - comp / float(orig_bytes_per_elem)


def predict_block_quant(
    hist: Sequence[int],
    hist_lo_exp: int,
    *,
    count: float,
    sumsq: float,
    zero_count: float = 0.0,
    block_size: int = 128,
    orig_bytes_per_elem: float = 4.0,
) -> dict[str, Any]:
    """Predicted block-scaled int8 quantization quality for one pooled
    distribution.

    ``hist[i]`` counts elements whose ``floor(log2 |x|)`` is
    ``hist_lo_exp + i`` (edge bins absorb the out-of-range tails — exactly
    the in-graph capture's convention).  ``count`` includes zeros;
    ``zero_count`` of them are exact zeros (quantized losslessly; an
    all-zero block has scale 0 and contributes no noise).

    Model: i.i.d. elements; P(block absmax exponent bin <= i) = F(i)^B with
    F the cumulative bin mass (zeros below bin 0); bin i implies scale
    ``2^(hist_lo_exp+i+1)/127``; noise variance per element is the scale's
    ``s^2/12`` weighted by the block-max bin distribution; signal is the
    mean square ``sumsq/count``.
    """
    b = int(block_size)
    if b < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    n = float(count)
    out: dict[str, Any] = {
        "block_size": b,
        "bytes_per_elem": _INT8_BYTES + _SCALE_BYTES / b,
        "bytes_saved_frac": bytes_saved_fraction(b, orig_bytes_per_elem),
        "sqnr_db": None,
        "rel_error_rms": None,
    }
    if n <= 0:
        return out
    nz = float(sum(hist))
    total = max(n, nz + float(zero_count))
    signal = float(sumsq) / n
    # exponent CDF including the zero mass below the lowest bin
    cum = float(zero_count)
    prev_pow = (cum / total) ** b
    noise = 0.0
    for i, c in enumerate(hist):
        cum += float(c)
        cur_pow = (cum / total) ** b
        p_max_bin = cur_pow - prev_pow
        prev_pow = cur_pow
        if p_max_bin <= 0.0:
            continue
        scale = (2.0 ** (hist_lo_exp + i + 1)) / 127.0
        noise += p_max_bin * scale * scale / 12.0
    if signal > 0.0 and noise > 0.0:
        out["sqnr_db"] = round(10.0 * math.log10(signal / noise), 3)
        out["rel_error_rms"] = round(math.sqrt(noise / signal), 9)
    return out


def pool_groups(groups: Mapping[str, Mapping[str, Any]]
                ) -> Optional[dict[str, Any]]:
    """Merge decoded per-group records (``tensorstats.decode_cum`` shape)
    into one pooled distribution: counts/sumsq/zero/hist sum, absmax maxes.
    All groups must share the histogram range.  ``None`` for no groups."""
    pooled: Optional[dict[str, Any]] = None
    for g in groups.values():
        if pooled is None:
            pooled = {
                "count": 0.0, "sumsq": 0.0, "zero": 0.0, "absmax": 0.0,
                "hist_lo_exp": int(g["hist_lo_exp"]),
                "hist_hi_exp": int(g["hist_hi_exp"]),
                "hist": [0] * len(g["hist"]),
            }
        if (int(g["hist_lo_exp"]) != pooled["hist_lo_exp"]
                or len(g["hist"]) != len(pooled["hist"])):
            raise ValueError(
                "cannot pool tensorstats groups with different histogram "
                "ranges — re-run with one hist_lo_exp/hist_hi_exp"
            )
        pooled["count"] += float(g["count"])
        pooled["sumsq"] += float(g["sumsq"])
        pooled["zero"] += float(g.get("zero", 0.0))
        pooled["absmax"] = max(pooled["absmax"], float(g["absmax"]))
        pooled["hist"] = [a + int(c)
                          for a, c in zip(pooled["hist"], g["hist"])]
    return pooled


def _predictions(dist: Mapping[str, Any], block_sizes: Sequence[int],
                 orig_bytes_per_elem: float) -> dict[str, dict[str, Any]]:
    return {
        str(b): predict_block_quant(
            dist["hist"], int(dist["hist_lo_exp"]),
            count=float(dist["count"]), sumsq=float(dist["sumsq"]),
            zero_count=float(dist.get("zero", 0.0)), block_size=b,
            orig_bytes_per_elem=orig_bytes_per_elem,
        )
        for b in block_sizes
    }


def _flatten_volumes(volumes: Optional[Mapping[str, Any]]
                     ) -> dict[str, float]:
    """Accept either kind-keyed bytes or the axis-nested shape
    ``collective_byte_volumes`` returns; fold to kind -> total bytes."""
    out: dict[str, float] = {}
    for k, v in (volumes or {}).items():
        if isinstance(v, Mapping):
            for kind, b in v.items():
                out[kind] = out.get(kind, 0.0) + float(b)
        else:
            out[k] = out.get(k, 0.0) + float(v)
    return out


def build_report(
    tensorstats: Optional[Mapping[str, Any]],
    *,
    block_sizes: Sequence[int] = DEFAULT_BLOCK_SIZES,
    byte_volumes: Optional[Mapping[str, Any]] = None,
    overlap_by_class: Optional[Mapping[str, Any]] = None,
    comms: Optional[Mapping[str, Any]] = None,
    orig_bytes_per_elem: float = 4.0,
) -> dict[str, Any]:
    """The quantization-readiness report: one entry per collective class,
    ranked by what compression would buy in EXPOSED step seconds.

    ``tensorstats`` — a streamed record (``run_summary.json["tensorstats"]``
    or a ``tensorstats.jsonl`` line): ``{"step", "groups": {"<phase>/<group>":
    decoded-cum, ...}}``.  ``byte_volumes`` — planner per-class logical wire
    bytes (``autotune.cost_model.collective_byte_volumes`` shape, or already
    kind-keyed).  ``overlap_by_class`` — the ``trace_summary.json`` section;
    supplies measured exposed seconds per class.  ``comms`` — the run/trace
    summary's ``comms`` section (``telemetry.comms.comms_section``): when a
    class carries a MEASURED achieved bus rate + bus bytes per step, saved
    seconds are priced at that wire rate (saved bus bytes / achieved rate)
    instead of the static exposed-seconds fraction — each class names its
    ``savings_source``.  Savings use the LARGEST block size (most
    aggressive) — the per-block table shows what backing off buys in
    error."""
    block_sizes = tuple(sorted({int(b) for b in block_sizes}))
    if not block_sizes:
        raise ValueError("need at least one block size")
    by_phase: dict[str, dict[str, dict[str, Any]]] = {}
    step = None
    if tensorstats:
        step = tensorstats.get("step")
        for key, rec in (tensorstats.get("groups") or {}).items():
            phase, _, group = str(key).partition("/")
            by_phase.setdefault(phase, {})[group or phase] = rec
    volumes = _flatten_volumes(byte_volumes)
    overlap = dict(overlap_by_class or {})
    comms_classes = dict((comms or {}).get("classes") or {}) \
        if isinstance(comms, Mapping) else {}

    classes: dict[str, dict[str, Any]] = {}
    best_b = block_sizes[-1]
    saved_frac = bytes_saved_fraction(best_b, orig_bytes_per_elem)
    for kind in sorted(set(CLASS_PHASE) | set(volumes) | set(overlap)):
        phase = CLASS_PHASE.get(kind)
        groups = by_phase.get(phase, {}) if phase else {}
        entry: dict[str, Any] = {
            "phase": phase,
            "bytes_per_step": volumes.get(kind),
            "bytes_saved_frac": round(saved_frac, 9),
            "block_size": best_b,
        }
        oc = overlap.get(kind) or {}
        exposed = oc.get("exposed_seconds")
        if exposed is None and oc.get("wire_seconds") is not None:
            exposed = float(oc["wire_seconds"]) \
                - float(oc.get("hidden_seconds", 0.0))
        entry["exposed_seconds"] = exposed
        # saved seconds: prefer the MEASURED wire rate (telemetry.comms —
        # saved bus bytes repriced at the class's achieved bandwidth);
        # fall back to the static assumption that exposed seconds shrink
        # proportionally with bytes.  The source is named either way.
        cc = comms_classes.get(kind)
        rate = None
        bus_bytes = None
        if isinstance(cc, Mapping):
            try:
                rate = float(cc.get("achieved_gbps") or 0.0) * 1e9
                bus_bytes = float(cc.get("bus_bytes_per_step") or 0.0)
            except (TypeError, ValueError):
                rate = bus_bytes = None
        if rate and bus_bytes:
            entry["predicted_seconds_saved"] = round(
                bus_bytes * saved_frac / rate, 9)
            entry["savings_source"] = "measured_wire_rate"
        elif exposed is not None:
            entry["predicted_seconds_saved"] = round(
                max(float(exposed), 0.0) * saved_frac, 9)
            entry["savings_source"] = "static_exposed_fraction"
        else:
            entry["predicted_seconds_saved"] = None
        if volumes.get(kind) is not None:
            entry["bytes_saved_per_step"] = round(
                float(volumes[kind]) * saved_frac, 3)
        if groups:
            pooled = pool_groups(groups)
            entry["pooled"] = _predictions(pooled, block_sizes,
                                           orig_bytes_per_elem)
            entry["per_group"] = {
                g: _predictions(rec, block_sizes, orig_bytes_per_elem)
                for g, rec in sorted(groups.items())
            }
        else:
            entry["note"] = (
                "no captured tensor distribution for this class"
                + ("" if phase else " (activation traffic — the observatory"
                   " watches optimizer-boundary tensors only)"))
        classes[kind] = entry

    def _rank_key(kind: str) -> tuple:
        e = classes[kind]
        s = e.get("predicted_seconds_saved")
        b = e.get("bytes_saved_per_step")
        # measured seconds first, byte volume as the tie-break/fallback
        return (-(s if s is not None else 0.0),
                -(b if b is not None else 0.0), kind)

    return {
        "step": step,
        "block_sizes": list(block_sizes),
        "orig_bytes_per_elem": orig_bytes_per_elem,
        "classes": classes,
        "ranking": sorted(classes, key=_rank_key),
    }


def load_run_dir(run_dir: str | os.PathLike) -> dict[str, Any]:
    """Gather a run directory's quant-readiness inputs: the last streamed
    tensorstats record (``run_summary.json["tensorstats"]`` preferred, else
    the last ``tensorstats.jsonl`` line) and, when present, the trace
    summary's ``overlap_by_class``.  Raises ``FileNotFoundError`` when the
    run carries no tensorstats at all."""
    d = os.fspath(run_dir)
    tensorstats: Optional[dict] = None
    rs = os.path.join(d, "run_summary.json")
    if os.path.exists(rs):
        with open(rs) as f:
            tensorstats = (json.load(f) or {}).get("tensorstats")
    if tensorstats is None:
        tj = os.path.join(d, "tensorstats.jsonl")
        if os.path.exists(tj):
            last = None
            with open(tj) as f:
                for line in f:
                    if line.strip():
                        last = line
            if last is not None:
                tensorstats = json.loads(last)
    if tensorstats is None:
        raise FileNotFoundError(
            f"{d} has no tensorstats telemetry (run_summary.json section or "
            f"tensorstats.jsonl) — enable exp_manager.telemetry.tensorstats "
            f"and re-run"
        )
    overlap = None
    comms = None
    ts_path = os.path.join(d, "trace_summary.json")
    if os.path.exists(ts_path):
        with open(ts_path) as f:
            doc = json.load(f) or {}
        overlap = doc.get("overlap_by_class")
        comms = doc.get("comms")
    if comms is None and os.path.exists(rs):
        with open(rs) as f:
            comms = (json.load(f) or {}).get("comms")
    return {"tensorstats": tensorstats, "overlap_by_class": overlap,
            "comms": comms}
