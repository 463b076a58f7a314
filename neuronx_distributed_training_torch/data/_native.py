"""Compile-on-demand ctypes loading for the native (C++) data helpers
(counterpart of the JAX package's ``data/_native.py``).

The host C++ compiler builds ``<name>.cpp`` into ``build/torch_native/`` at
the repo root (listed in ``.gitignore``), never beside the source; the
library is named by a digest of the source, so an edited helper is rebuilt
and an unchanged one reused.  Each build writes a per-pid temp file and
``os.replace``s it into place, so concurrent processes racing one output
path cannot leave a torn library.  Returns ``None``, never raises, when no
toolchain is available: the callers keep a numpy path that gives the same
arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"


def library_path(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def compile_and_load(src: Path) -> Optional[ctypes.CDLL]:
    """Build ``src`` (.cpp) into ``build/torch_native/`` if missing, and load it."""
    try:
        lib_path = library_path(src)
        if not lib_path.exists():
            cxx = shutil.which("c++") or shutil.which("g++")
            if cxx is None:
                raise OSError("no host C++ compiler (c++ / g++) on PATH")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp.so")
            subprocess.run([cxx, "-O3", "-shared", "-fPIC", str(src), "-o", str(tmp)],
                           check=True, capture_output=True)
            os.replace(tmp, lib_path)
        return ctypes.CDLL(str(lib_path))
    except Exception as e:  # noqa: BLE001 — the numpy path is always correct
        logger.debug("native helper unavailable (%s): %s", src.name, e)
        return None
