"""Batch-signature change detection (counterpart of the JAX package's
``telemetry/recompile.py``).

In JAX a change of an argument's abstract shape or dtype retraces and
recompiles the step.  The port has no compile, but a new batch signature
still costs the card: new kernel grids, new cuBLAS plan choices and new
allocator block sizes.  ``RecompileDetector`` fingerprints the shapes and
dtypes of each named function's arguments on every call (host metadata
only, never values: no device sync) and, when the signature changes
mid-run, logs a warning under JAX's text naming which leaves changed and
how.  Its signature is the batch fingerprint the flight recorder's ring
keeps for each step (``telemetry/flight_recorder.py``).

Leaves are keyed as JAX's tree paths print them (``arg0['input_ids']``) and
dtypes as numpy names (``int32``), so the same numpy batch gives the same
signature and the same warning text in both packages.
"""

from __future__ import annotations

import logging
from typing import Any

logger = logging.getLogger(__name__)


def _leaf_sig(x: Any) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is None:
        return f"<{type(x).__name__}>"
    return f"{str(dtype).replace('torch.', '')}[{','.join(str(d) for d in shape)}]"


def _flatten(prefix: str, x: Any, out: dict[str, str]) -> None:
    """JAX's ``tree_flatten_with_path`` order and key text: dicts by sorted
    key (``['k']``), lists and tuples by index (``[i]``), None as no leaf."""
    if isinstance(x, dict):
        for k in sorted(x):
            _flatten(f"{prefix}[{k!r}]", x[k], out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _flatten(f"{prefix}[{i}]", v, out)
    elif x is not None:
        out[prefix] = _leaf_sig(x)


def _signature(args: tuple) -> dict[str, str]:
    """{leaf path: "dtype[shape]"} over all positional args."""
    out: dict[str, str] = {}
    for i, arg in enumerate(args):
        _flatten(f"arg{i}", arg, out)
    return out


class RecompileDetector:
    """Warns (once per change) when a step's argument signature changes
    mid-run."""

    #: retained event cap: a loader alternating between two signatures fires
    #: every step; the tail is what run_summary.json reports anyway
    MAX_EVENTS = 100

    def __init__(self) -> None:
        self._seen: dict[str, dict[str, str]] = {}
        self._warned: set[str] = set()
        self.events: list[str] = []

    def check(self, name: str, *args: Any) -> bool:
        """Record ``args``' signature under ``name``; returns True (and
        warns with the diff, once per distinct diff) when it changed since
        the last call."""
        sig = _signature(args)
        prev = self._seen.get(name)
        self._seen[name] = sig
        if prev is None or prev == sig:
            return False
        diff = self.describe_diff(prev, sig)
        event = f"{name}: {diff}"
        self.events.append(event)
        del self.events[:-self.MAX_EVENTS]
        if event not in self._warned:
            self._warned.add(event)
            logger.warning(
                "argument signature for %r changed mid-run: a jitted step now "
                "retraces (a full recompile); an AOT-compiled step will "
                "instead reject the call with an argument mismatch — %s",
                name, diff,
            )
        return True

    def signature(self, name: str) -> dict[str, str] | None:
        """The last recorded signature for ``name``: the batch fingerprint
        the flight recorder ring-buffers per step."""
        return self._seen.get(name)

    @staticmethod
    def describe_diff(prev: dict[str, str], cur: dict[str, str]) -> str:
        parts: list[str] = []
        for key in sorted(set(prev) | set(cur)):
            a, b = prev.get(key), cur.get(key)
            if a == b:
                continue
            if a is None:
                parts.append(f"{key}: added {b}")
            elif b is None:
                parts.append(f"{key}: removed (was {a})")
            else:
                parts.append(f"{key}: {a} -> {b}")
        if len(parts) > 8:
            parts = parts[:8] + [f"... and {len(parts) - 8} more"]
        return "; ".join(parts) or "tree structure changed"
