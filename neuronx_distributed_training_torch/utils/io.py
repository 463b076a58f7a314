"""Crash-safe file I/O helpers (a copy of the JAX package's ``utils/io.py``,
local paths only).

``run_summary.json`` and the checkpoint sidecars are read by resume paths and
report tools: a SIGKILL landing mid-write (preemption, the OOM killer) must
never leave a truncated JSON document behind.  ``atomic_write_json``
serializes first (an unserializable value raises before the target is
touched), writes a same-directory temp file, fsyncs, and renames into place.
"""

from __future__ import annotations

import json
import os
from typing import Any


def atomic_write_json(path: Any, obj: Any, *, indent: int = 1,
                      sort_keys: bool = True) -> None:
    """Write ``obj`` as JSON to ``path`` atomically (temp + rename).

    A non-serializable ``obj`` raises ``TypeError`` with the target file
    untouched: the old contents stay valid."""
    data = json.dumps(obj, indent=indent, sort_keys=sort_keys) + "\n"
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
