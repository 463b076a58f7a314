"""Fleet observability plane: per-host beacons + the cross-host aggregator.

The PyTorch port's copy of the JAX package's ``telemetry/fleet.py``: the
same beacons and ``fleet_summary.json``.  The trainer's host is a node
(``LOCAL_WORLD_SIZE`` ranks; its first rank writes the beacon), as JAX's is
a process.

Every observability surface before this one (spans, metrics.jsonl,
run_summary.json, health counters, trace analytics) is strictly
per-process: on a 32-host run there is no answer to "which host is slow,
which host is stalling data, which host went quiet" without ssh'ing
around.  This module closes that gap in three layers (docs/observability.md
"Fleet observability"):

- **Beacons** — each host process appends one compact heartbeat record to
  its own ``fleet/host_<id>.jsonl`` at every *existing* logging boundary:
  host id, step, boundary-arrival timestamps (monotonic for per-host window
  durations, wall for cross-host skew — wall comparison assumes NTP-synced
  hosts, the normal fleet posture), the cumulative span snapshot
  (``data_wait``/``host_sync``/``checkpoint``/...), the boundary metrics the
  loop already fetched (mfu, goodput, health counters), the device-memory
  watermark when known, and the last exception on the final record.  Zero
  new host syncs: every value rides the boundary fetch the loop performs
  anyway.  Appends are single ``write()`` calls of one newline-terminated
  JSON line, so a SIGKILL'd host leaves a valid file (at worst one torn
  tail line, which readers skip).

- **Aggregator** — rank 0 (in-loop) and the offline CLI
  (``tools/fleet_monitor.py``) fold the beacon files into
  ``fleet_summary.json``: per-step-window boundary-arrival skew with the
  straggler host named per window and its dominant cause (``compute_slow``
  vs ``data_stall`` vs ``checkpoint_blocked`` — from the straggler's own
  span deltas), per-host MFU/data_wait/goodput spread (min/p50/max with the
  owning host), quiet-host detection (no beacon within
  ``stale_after_seconds`` -> a named ``fleet_stall`` finding that also
  feeds the flight recorder's hang-bundle machinery), and a fleet goodput
  decomposition attributing the lost fraction to the slowest host vs
  overhead every host shares.  Reads are incremental (per-file offsets), so
  a long run's boundary-cadence aggregation stays O(new lines), not O(run).

Straggler semantics: SPMD training is lockstep — the collectives rendezvous
every host at (nearly) the same wall instant, so the *slow* host is not the
one that arrives late but the one that never waits.  Per window the
aggregator computes each host's busy seconds (window duration minus its
``host_sync`` span delta — the time it spent absorbing everyone else's
work); the straggler is the busiest host, and its own span deltas name the
cause.  ``arrival_skew_seconds`` (max-min wall arrival) is reported too:
genuinely non-lockstep skew (pre-rendezvous phases, dying hosts) shows up
there.

This module is deliberately **stdlib-only at import time** (no jax, no
package-wide imports) so ``tools/fleet_monitor.py`` can load it on a login
node the same way ``tools/metrics_report.py`` stays stdlib-only.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Optional

logger = logging.getLogger(__name__)

#: subdirectory of the run dir holding one ``host_<id>.jsonl`` per host
FLEET_DIR = "fleet"

#: metric keys a beacon carries verbatim from the boundary fetch (plus every
#: ``health/``, ``data/``, and ``memory/`` key — the latter is the live HBM
#: watermark/headroom stream, ``telemetry.memory``) — compact on purpose:
#: beacons are appended every boundary for the life of the run
BEACON_METRICS = (
    "loss", "step_time", "mfu", "tokens_per_sec_per_chip",
    "goodput_fraction", "throughput_seqs_per_sec",
    "device_peak_bytes_in_use", "device_bytes_in_use",
)

#: straggler cause classes the aggregator can name
CAUSES = ("compute_slow", "data_stall", "checkpoint_blocked")


def _fleet_knobs() -> set:
    return {f.name for f in dataclasses.fields(FleetConfig)}


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """``exp_manager.telemetry.fleet`` knob block (validated at config load).

    .. code-block:: yaml

        exp_manager:
          telemetry:
            fleet:
              enabled: false           # per-host beacons + rank-0 aggregation
              stale_after_seconds: 600 # quiet-host threshold (fleet_stall)
              aggregate: true          # rank-0 in-loop fleet_summary.json
              max_windows: 64          # skew windows retained in the summary
    """

    enabled: bool = False
    stale_after_seconds: float = 600.0
    aggregate: bool = True
    max_windows: int = 64

    @classmethod
    def from_config(cls, block: Any) -> "FleetConfig":
        """Accepts ``None`` (defaults: disabled), a bare bool, or a mapping.
        Unknown keys raise with a did-you-mean hint — a typo'd knob must not
        silently observe nothing."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        knobs = _fleet_knobs()
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.telemetry.fleet must be a mapping of "
                f"{sorted(knobs)} (or a single bool), got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - knobs
        if unknown:
            from neuronx_distributed_training_torch.config.loader import (
                did_you_mean,
            )

            raise ValueError(
                f"unknown exp_manager.telemetry.fleet keys {sorted(unknown)}; "
                f"supported: {sorted(knobs)}" + did_you_mean(unknown, knobs)
            )
        values = dict(block)
        for key in ("enabled", "aggregate"):
            if key in values and not isinstance(values[key], bool):
                raise ValueError(
                    f"exp_manager.telemetry.fleet.{key} must be a boolean, "
                    f"got {values[key]!r}"
                )
        out = cls(
            enabled=bool(values.get("enabled", cls.enabled)),
            stale_after_seconds=float(
                values.get("stale_after_seconds", cls.stale_after_seconds)),
            aggregate=bool(values.get("aggregate", cls.aggregate)),
            max_windows=int(values.get("max_windows", cls.max_windows)),
        )
        if out.stale_after_seconds <= 0:
            raise ValueError(
                f"exp_manager.telemetry.fleet.stale_after_seconds must be "
                f"> 0, got {out.stale_after_seconds}"
            )
        if out.max_windows < 1:
            raise ValueError(
                f"exp_manager.telemetry.fleet.max_windows must be >= 1, got "
                f"{out.max_windows}"
            )
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# -- layer 1: beacons --------------------------------------------------------


def beacon_path(fleet_dir: str | Path, host: int) -> Path:
    return Path(fleet_dir) / f"host_{int(host)}.jsonl"


class FleetBeacon:
    """One host's heartbeat writer.

    ``emit`` appends a single JSON line per logging boundary; the handle
    stays open for the run (append mode, flushed per write) and ``close``
    writes a final record carrying the clean/dying distinction.  All values
    must already be host floats — the caller passes the boundary metrics it
    has ALREADY fetched, never device arrays.
    """

    def __init__(self, fleet_dir: str | Path, host: int) -> None:
        self.host = int(host)
        self.path = beacon_path(fleet_dir, host)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        self._closed = False

    def emit(
        self,
        step: int,
        metrics: Optional[Mapping[str, Any]] = None,
        *,
        spans: Optional[Mapping[str, float]] = None,
        closing: bool = False,
        last_exception: Optional[str] = None,
    ) -> None:
        if self._closed:
            return
        picked: dict[str, float] = {}
        for k, v in (metrics or {}).items():
            if k in BEACON_METRICS or k.startswith("health/") \
                    or k.startswith("data/") or k.startswith("memory/") \
                    or k.startswith("tensorstats/") \
                    or k.startswith("comms/"):
                try:
                    f = float(v)
                except (TypeError, ValueError):
                    continue
                # strict-JSON beacons: a NaN loss must not make the whole
                # line unparseable for non-Python consumers
                picked[k] = f if f == f and abs(f) != float("inf") else None
        rec: dict[str, Any] = {
            "host": self.host,
            "step": int(step),
            "t_mono": round(time.monotonic(), 6),
            "t_wall": round(time.time(), 6),
            "metrics": picked,
        }
        if spans:
            rec["spans"] = {
                k: round(f, 6)
                for k, v in spans.items()
                for f in [float(v)]
                if f == f and abs(f) != float("inf")
            }
        if closing:
            rec["closing"] = True
        if last_exception:
            rec["last_exception"] = str(last_exception)[:500]
        try:
            # strict JSON (allow_nan=False is belt-and-braces after the
            # sanitizing above), then ONE write() call of one full line: the
            # append is atomic enough that a reader never sees an
            # interleaved or half-flushed record from a live handle, and a
            # dying host leaves a valid file
            line = json.dumps(rec, allow_nan=False) + "\n"
            self._f.write(line)
            self._f.flush()
        except (OSError, ValueError, TypeError) as e:  # pragma: no cover
            # observability must not kill training
            logger.warning("fleet beacon write failed: %s", e)

    def close(self, last_exception: Optional[str] = None,
              step: Optional[int] = None) -> None:
        """Final beacon: ``closing: true`` marks a clean exit (the aggregator
        must not report it as a quiet host); ``last_exception`` marks a dying
        one (a ``host_died`` finding instead of silence)."""
        if self._closed:
            return
        self.emit(int(step if step is not None else -1), {},
                  closing=last_exception is None,
                  last_exception=last_exception)
        self._closed = True
        try:
            self._f.close()
        except OSError:  # pragma: no cover
            pass


# -- layer 2: the aggregator -------------------------------------------------


def _read_new_lines(path: Path, offset: int) -> tuple[list[dict], int]:
    """New COMPLETE records in ``path`` past ``offset`` -> (records, new
    offset).  A torn tail line (host died mid-write, or a live writer mid
    flush) is left for the next refresh; a malformed complete line is
    skipped with a warning."""
    try:
        size = path.stat().st_size
    except OSError:
        return [], offset
    if size <= offset:
        return [], offset
    with open(path) as f:
        f.seek(offset)
        chunk = f.read(size - offset)
    end = chunk.rfind("\n")
    if end < 0:
        return [], offset  # no complete line yet
    out = []
    for line in chunk[: end + 1].splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            logger.warning("fleet: skipping malformed beacon line in %s",
                           path.name)
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out, offset + end + 1


class _HostState:
    """Per-host fold state: the latest record, recent per-step records (for
    window math), and identity facts."""

    def __init__(self, host: int, keep_steps: int) -> None:
        self.host = host
        self.keep_steps = keep_steps
        self.beacons = 0
        self.last: Optional[dict] = None
        self.closed = False
        self.last_exception: Optional[str] = None
        # ordered step -> record of recent NON-final beacons
        self.recent: dict[int, dict] = {}
        # sticky comms/* metrics: the achieved-bandwidth join fires once
        # per trace window, not per beacon — the next regular beacon would
        # otherwise erase it from `last` before anyone reads the spread
        self.comms: dict[str, float] = {}

    def fold(self, rec: dict) -> None:
        self.beacons += 1
        if rec.get("closing") or rec.get("last_exception"):
            self.closed = True
            if rec.get("last_exception"):
                self.last_exception = str(rec["last_exception"])
            # final records carry no window data; keep the previous `last`
            # for metrics but remember the terminal wall time
            if self.last is not None:
                self.last = dict(self.last, t_wall=rec.get(
                    "t_wall", self.last.get("t_wall")))
            else:
                self.last = rec
            return
        self.last = rec
        for k, v in dict(rec.get("metrics") or {}).items():
            if k.startswith("comms/") and v is not None:
                try:
                    self.comms[k] = float(v)
                except (TypeError, ValueError):
                    pass
        try:
            step = int(rec["step"])
        except (KeyError, TypeError, ValueError):
            return
        self.recent[step] = rec
        while len(self.recent) > self.keep_steps:
            self.recent.pop(next(iter(self.recent)))

    def metric(self, key: str) -> Optional[float]:
        m = (self.last or {}).get("metrics") or {}
        v = m.get(key)
        try:
            return float(v) if v is not None else None
        except (TypeError, ValueError):
            return None

    def span(self, rec: dict, key: str) -> float:
        try:
            return float((rec.get("spans") or {}).get(key, 0.0) or 0.0)
        except (TypeError, ValueError):
            return 0.0


def _spread(values: dict[int, float]) -> Optional[dict]:
    """min/p50/max over per-host values, naming the owning hosts."""
    if not values:
        return None
    items = sorted(values.items(), key=lambda kv: kv[1])
    hosts = [h for h, _ in items]
    vals = [v for _, v in items]
    return {
        "min": {"host": hosts[0], "value": round(vals[0], 6)},
        "p50": round(statistics.median(vals), 6),
        "max": {"host": hosts[-1], "value": round(vals[-1], 6)},
    }


class FleetAggregator:
    """Folds ``fleet/host_*.jsonl`` streams into the fleet summary.

    Incremental by construction: ``refresh`` re-scans the directory for new
    host files, reads only bytes past each file's stored offset, and folds
    them into per-host state.  Call it at whatever cadence suits the caller
    (the trainer's rank 0 calls it every boundary; the CLI calls it once, or
    on a ``--follow`` interval)."""

    def __init__(self, fleet_dir: str | Path, *,
                 stale_after_seconds: float = 600.0,
                 max_windows: int = 64) -> None:
        self.fleet_dir = Path(fleet_dir)
        self.stale_after_seconds = float(stale_after_seconds)
        self.max_windows = max(int(max_windows), 1)
        self._offsets: dict[Path, int] = {}
        self._hosts: dict[int, _HostState] = {}
        #: retained cross-host windows, newest last
        self.windows: list[dict] = []
        self._windowed_upto: Optional[int] = None  # last step windowed

    # -- folding ------------------------------------------------------------

    def refresh(self, now: Optional[float] = None) -> dict:
        """Fold any new beacon lines and return the current summary dict.

        ``now`` (wall seconds) is the quiet-host reference for LIVE
        monitoring; offline analysis of a finished run leaves it ``None``
        and the newest beacon across the fleet anchors staleness instead —
        a file set copied off a dead fleet must not report every host quiet.
        """
        for path in sorted(self.fleet_dir.glob("host_*.jsonl")):
            try:
                host = int(path.stem.split("_", 1)[1])
            except (IndexError, ValueError):
                continue
            recs, self._offsets[path] = _read_new_lines(
                path, self._offsets.get(path, 0))
            if recs and host not in self._hosts:
                # windows need the predecessor record too: keep one extra
                self._hosts[host] = _HostState(
                    host, keep_steps=self.max_windows + 1)
            for rec in recs:
                self._hosts[host].fold(rec)
        self._update_windows()
        return self.summary(now=now)

    def _update_windows(self) -> None:
        """Windows over steps EVERY live host has reached.  A window is the
        interval between two consecutive common steps; per host its duration
        comes from the host's own monotonic clock (cross-host monotonic
        origins are not comparable), busy = duration - host_sync delta."""
        live = [h for h in self._hosts.values() if h.recent]
        if len(live) < 2:
            return
        common = set.intersection(*(set(h.recent) for h in live))
        steps = sorted(common)
        for prev_step, step in zip(steps, steps[1:]):
            if self._windowed_upto is not None and step <= self._windowed_upto:
                continue
            win = self._window(live, prev_step, step)
            if win is not None:
                self.windows.append(win)
                self._windowed_upto = step
        del self.windows[: max(0, len(self.windows) - self.max_windows)]

    def _window(self, live: list[_HostState], prev_step: int,
                step: int) -> Optional[dict]:
        busy: dict[int, float] = {}
        causes: dict[int, str] = {}
        arrivals: dict[int, float] = {}
        for h in live:
            a, b = h.recent[prev_step], h.recent[step]
            try:
                duration = float(b["t_mono"]) - float(a["t_mono"])
                arrivals[h.host] = float(b["t_wall"])
            except (KeyError, TypeError, ValueError):
                return None
            if duration <= 0:
                return None
            d_sync = h.span(b, "host_sync") - h.span(a, "host_sync")
            d_data = h.span(b, "data_wait") - h.span(a, "data_wait")
            d_ckpt = h.span(b, "checkpoint") - h.span(a, "checkpoint")
            hb = max(duration - max(d_sync, 0.0), 0.0)
            busy[h.host] = hb
            if d_ckpt > 0.5 * hb:
                causes[h.host] = "checkpoint_blocked"
            elif d_data > 0.5 * hb:
                causes[h.host] = "data_stall"
            else:
                causes[h.host] = "compute_slow"
        ranked = sorted(busy.items(), key=lambda kv: kv[1])
        straggler, worst = ranked[-1]
        fastest = ranked[0][1]
        # a balanced window has no straggler to name: within 10% of each
        # other every host is "the" bottleneck in turn
        balanced = worst <= 1.1 * fastest
        return {
            "step": int(step),
            "window_steps": int(step - prev_step),
            "arrival_skew_seconds": round(
                max(arrivals.values()) - min(arrivals.values()), 6),
            "busy_seconds": {str(h): round(v, 6) for h, v in busy.items()},
            "straggler_host": None if balanced else straggler,
            "cause": None if balanced else causes[straggler],
            "straggler_excess_seconds": round(worst - fastest, 6),
        }

    # -- the summary --------------------------------------------------------

    def quiet_hosts(self, now: Optional[float] = None) -> list[dict]:
        """Hosts with no beacon within ``stale_after_seconds`` of the
        reference time (``now`` for live monitoring, else the fleet's newest
        beacon).  Cleanly-closed hosts are never quiet; a host whose final
        record carried an exception is reported by ``findings`` as
        ``host_died`` rather than here."""
        last_wall: dict[int, float] = {}
        for h in self._hosts.values():
            if h.last is not None and h.last.get("t_wall") is not None:
                last_wall[h.host] = float(h.last["t_wall"])
        if not last_wall:
            return []
        ref = float(now) if now is not None else max(last_wall.values())
        out = []
        for h in sorted(self._hosts.values(), key=lambda s: s.host):
            if h.closed or h.host not in last_wall:
                continue
            silent = ref - last_wall[h.host]
            if silent > self.stale_after_seconds:
                out.append({
                    "host": h.host,
                    "last_step": int((h.last or {}).get("step", -1)),
                    "silent_seconds": round(silent, 3),
                })
        return out

    def summary(self, now: Optional[float] = None) -> dict:
        hosts_block: dict[str, Any] = {}
        per_metric: dict[str, dict[int, float]] = {
            "mfu": {}, "goodput_fraction": {}, "data_wait_seconds": {},
            "step_time": {}, "peak_hbm_bytes": {},
            "hbm_headroom_fraction": {},
        }
        for h in sorted(self._hosts.values(), key=lambda s: s.host):
            last = h.last or {}
            data_wait = h.span(last, "data_wait") if last else 0.0
            # live HBM watermark (telemetry.memory beacons first, the legacy
            # device_memory key as fallback) — per-host memory spread is how
            # a skewed-stage OOM-bound host shows up fleet-wide
            peak_hbm = h.metric("memory/peak_hbm_bytes")
            if peak_hbm is None:
                peak_hbm = h.metric("device_peak_bytes_in_use")
            headroom = h.metric("memory/hbm_headroom_fraction")
            hosts_block[str(h.host)] = {
                "beacons": h.beacons,
                "last_step": int(last.get("step", -1)),
                "last_wall": last.get("t_wall"),
                "closed": h.closed,
                "last_exception": h.last_exception,
                "mfu": h.metric("mfu"),
                "goodput_fraction": h.metric("goodput_fraction"),
                "step_time": h.metric("step_time"),
                "data_wait_seconds": round(data_wait, 6),
                "device_peak_bytes_in_use": h.metric(
                    "device_peak_bytes_in_use"),
                "peak_hbm_bytes": peak_hbm,
                "hbm_headroom_fraction": headroom,
            }
            for key, getter in (
                ("mfu", h.metric("mfu")),
                ("goodput_fraction", h.metric("goodput_fraction")),
                ("step_time", h.metric("step_time")),
                ("data_wait_seconds", data_wait if last else None),
                ("peak_hbm_bytes", peak_hbm),
                ("hbm_headroom_fraction", headroom),
            ):
                if getter is not None:
                    per_metric[key][h.host] = float(getter)
            # achieved interconnect bandwidth (telemetry.comms beacons):
            # per-host spread on comms/*/achieved_gbps is how ONE host's
            # degraded link shows up fleet-wide — the spread table renders
            # whatever keys land here, no per-metric plumbing needed
            for k, v in h.comms.items():
                if k.endswith("/achieved_gbps"):
                    per_metric.setdefault(k, {})[h.host] = float(v)

        quiet = self.quiet_hosts(now=now)
        findings: list[dict] = []
        for q in quiet:
            findings.append({
                "kind": "fleet_stall",
                "host": q["host"],
                "last_step": q["last_step"],
                "silent_seconds": q["silent_seconds"],
                "message": (
                    f"host {q['host']} quiet for {q['silent_seconds']:.0f}s "
                    f"(last beacon at step {q['last_step']}; "
                    f"stale_after_seconds={self.stale_after_seconds:.0f}) — "
                    f"absence of progress, not slow progress"),
            })
        for h in sorted(self._hosts.values(), key=lambda s: s.host):
            if h.last_exception:
                findings.append({
                    "kind": "host_died",
                    "host": h.host,
                    "last_step": int((h.last or {}).get("step", -1)),
                    "message": (f"host {h.host} exited with: "
                                f"{h.last_exception}"),
                })

        # modal straggler across the retained windows
        straggler_block = None
        led: dict[int, int] = {}
        led_causes: dict[int, dict[str, int]] = {}
        attributed = [w for w in self.windows
                      if w.get("straggler_host") is not None]
        for w in attributed:
            s = int(w["straggler_host"])
            led[s] = led.get(s, 0) + 1
            c = led_causes.setdefault(s, {})
            c[w["cause"]] = c.get(w["cause"], 0) + 1
        if led:
            modal = max(led.items(), key=lambda kv: kv[1])[0]
            cause = max(led_causes[modal].items(), key=lambda kv: kv[1])[0]
            straggler_block = {
                "host": modal,
                "cause": cause,
                "windows_led": led[modal],
                "windows_attributed": len(attributed),
                "windows_total": len(self.windows),
            }

        return {
            "n_hosts": len(self._hosts),
            "hosts": hosts_block,
            "windows": list(self.windows),
            "straggler": straggler_block,
            "spread": {k: _spread(v) for k, v in per_metric.items()
                       if _spread(v) is not None},
            "quiet_hosts": quiet,
            "findings": findings,
            "goodput": self._goodput_decomposition(
                per_metric["goodput_fraction"]),
            "stale_after_seconds": self.stale_after_seconds,
        }

    @staticmethod
    def _goodput_decomposition(g: dict[int, float]) -> Optional[dict]:
        """Fleet goodput = the worst host's (the fleet trains at its pace).
        The lost fraction splits into overhead every host shares (what even
        the BEST host loses) and the extra the slowest host adds on top —
        the part a straggler fix would recover."""
        if not g:
            return None
        items = sorted(g.items(), key=lambda kv: kv[1])
        (worst_h, worst), (best_h, best) = items[0], items[-1]
        return {
            "fleet_goodput_fraction": round(worst, 6),
            "common_overhead_fraction": round(max(1.0 - best, 0.0), 6),
            "straggler_loss_fraction": round(max(best - worst, 0.0), 6),
            "best_host": best_h,
            "worst_host": worst_h,
        }


def aggregate_fleet(fleet_dir: str | Path, *,
                    stale_after_seconds: float = 600.0,
                    max_windows: int = 64,
                    now: Optional[float] = None) -> dict:
    """One-shot fold of a beacon directory (the offline CLI's entry)."""
    agg = FleetAggregator(fleet_dir, stale_after_seconds=stale_after_seconds,
                          max_windows=max_windows)
    return agg.refresh(now=now)


def write_fleet_summary(summary: dict, path: str | Path) -> None:
    """Atomic ``fleet_summary.json`` write (same serialize-first +
    temp/fsync/rename contract as ``utils.io.atomic_write_json``, inlined
    here so the stdlib-only CLI can call it without importing the package —
    a SIGKILL mid-write never leaves torn JSON)."""
    data = json.dumps(summary, indent=1, sort_keys=True) + "\n"
    spath = str(path)
    tmp = f"{spath}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:  # pragma: no cover — some filesystems refuse
            pass
    os.replace(tmp, spath)


# -- the trainer-facing facade ----------------------------------------------


class FleetPlane:
    """What the fit loop holds: this host's beacon plus (rank 0 with
    ``aggregate: true``) the in-loop aggregator, quiet-host findings routed
    into the flight recorder's bundle machinery, and the ``fleet/*`` metrics
    the alert engine sees."""

    def __init__(
        self,
        cfg: FleetConfig,
        run_dir: str | Path,
        *,
        host: int = 0,
        aggregate: bool = False,
        write_run_summary: Optional[Callable[[dict], None]] = None,
    ) -> None:
        self.cfg = cfg
        self.run_dir = Path(run_dir)
        self.fleet_dir = self.run_dir / FLEET_DIR
        self.summary_path = self.run_dir / "fleet_summary.json"
        self.beacon = FleetBeacon(self.fleet_dir, host)
        self._write_run_summary = write_run_summary
        self.aggregator = (
            FleetAggregator(self.fleet_dir,
                            stale_after_seconds=cfg.stale_after_seconds,
                            max_windows=cfg.max_windows)
            if aggregate and cfg.aggregate else None
        )
        self._stall_reported: set[int] = set()
        self._closed = False

    def boundary(
        self,
        step: int,
        metrics: Optional[Mapping[str, Any]] = None,
        spans: Optional[Mapping[str, float]] = None,
        monitor: Optional[Any] = None,
    ) -> dict[str, float]:
        """One logging boundary: emit this host's beacon, (rank 0) fold the
        fleet and persist ``fleet_summary.json``, dump a ``fleet_stall``
        bundle through the flight recorder for each NEWLY quiet host, and
        return the ``fleet/*`` metrics for the alert engine.  Everything is
        host-side file I/O — zero device work, zero new syncs."""
        self.beacon.emit(step, metrics, spans=spans)
        if self.aggregator is None:
            return {}
        try:
            summary = self.aggregator.refresh(now=time.time())
            write_fleet_summary(summary, self.summary_path)
        except Exception as e:  # noqa: BLE001 — observability must not kill
            logger.warning("fleet aggregation failed: %s", e)
            return {}
        fresh = []
        for q in summary.get("quiet_hosts") or []:
            h = int(q["host"])
            if h in self._stall_reported:
                continue
            self._stall_reported.add(h)
            fresh.append(q)
            logger.warning(
                "fleet_stall: host %d quiet for %.0fs (last step %d)",
                h, q["silent_seconds"], q["last_step"])
        if fresh and monitor is not None:
            # the same forensic machinery a hung device sync feeds: a quiet
            # host IS a fleet-level hang.  One bundle per boundary covers
            # every host that went quiet in it (the dedupe key is
            # (kind, step), so per-host dumps would collide anyway).
            try:
                monitor.dump(
                    step, kind="fleet_stall", fetch_ring=False,
                    extra={"quiet_hosts": fresh,
                           "stale_after_seconds":
                               self.cfg.stale_after_seconds},
                )
            except Exception as e:  # noqa: BLE001
                logger.warning("fleet_stall bundle failed: %s", e)
        out: dict[str, float] = {
            "fleet/n_hosts": float(summary.get("n_hosts", 0)),
            "fleet/n_quiet_hosts": float(len(summary.get("quiet_hosts") or [])),
        }
        if summary.get("windows"):
            out["fleet/arrival_skew_seconds"] = float(
                summary["windows"][-1]["arrival_skew_seconds"])
        gp = summary.get("goodput") or {}
        if gp.get("fleet_goodput_fraction") is not None:
            out["fleet/goodput_fraction"] = float(
                gp["fleet_goodput_fraction"])
            out["fleet/straggler_loss_fraction"] = float(
                gp.get("straggler_loss_fraction", 0.0))
        sp = (summary.get("spread") or {}).get("mfu")
        if sp:
            out["fleet/mfu_min"] = float(sp["min"]["value"])
        return out

    def close(self, exc: Optional[BaseException] = None,
              step: Optional[int] = None) -> None:
        """Teardown: the final beacon (clean vs dying), one last aggregation
        pass, and the run-summary pointer.  Never raises."""
        if self._closed:
            return
        self._closed = True
        try:
            self.beacon.close(
                last_exception=(f"{type(exc).__name__}: {exc}"
                                if exc is not None else None),
                step=step,
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("fleet beacon close failed: %s", e)
        if self.aggregator is not None:
            try:
                summary = self.aggregator.refresh()
                write_fleet_summary(summary, self.summary_path)
                if self._write_run_summary is not None:
                    self._write_run_summary({"fleet": {
                        "n_hosts": summary.get("n_hosts"),
                        "straggler": summary.get("straggler"),
                        "quiet_hosts": [q["host"] for q in
                                        summary.get("quiet_hosts") or []],
                        "goodput": summary.get("goodput"),
                        "summary_path": str(self.summary_path),
                    }})
            except Exception as e:  # noqa: BLE001
                logger.warning("fleet teardown aggregation failed: %s", e)
