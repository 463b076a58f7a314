"""Doc/sample/shuffle index building for mmap GPT datasets (counterpart of
the JAX package's ``data/megatron/index.py``; the same arrays for the same
inputs).

doc_idx (shuffled docs per epoch), sample_idx (a ``seq_length``-token walk
over the doc stream: the C++ ``index_builder.cpp`` loop through ctypes, with
a numpy path when no compiler is available) and shuffle_idx (shuffled sample
order), cached as .npy by ``dataset.GPTDataset``.
"""

from __future__ import annotations

import ctypes
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from neuronx_distributed_training_torch.data._native import compile_and_load

logger = logging.getLogger(__name__)

_SRC = Path(__file__).with_name("index_builder.cpp")
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the C++ builder; None if no toolchain."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    lib = compile_and_load(_SRC)
    if lib is None:
        logger.warning("C++ index builder unavailable (native index builder "
                       "unavailable); using numpy fallback")
        return None
    lib.build_sample_idx.restype = ctypes.c_int64
    lib.build_sample_idx.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def build_doc_idx(num_docs: int, num_epochs: int, seed: int) -> np.ndarray:
    """Shuffled document order, per epoch."""
    rng = np.random.Generator(np.random.PCG64(seed))
    parts = [rng.permutation(num_docs).astype(np.int32) for _ in range(num_epochs)]
    return np.concatenate(parts)


def _sample_idx_numpy(doc_lens, doc_idx, num_samples, seq_length):
    out = np.zeros((num_samples + 1, 2), np.int64)
    cursor, offset, sample = 0, 0, 0
    n = len(doc_idx)
    while sample < num_samples:
        remaining = seq_length + 1
        while remaining > 0:
            if cursor >= n:
                return out[: sample + 1]
            doc_len = int(doc_lens[doc_idx[cursor]]) - offset
            if doc_len >= remaining:  # boundary stays inside the doc on exact fill
                offset += remaining - 1
                remaining = 0
            else:
                remaining -= doc_len
                cursor += 1
                offset = 0
        sample += 1
        out[sample] = (cursor, offset)
    return out


def build_sample_idx(doc_lens: np.ndarray, doc_idx: np.ndarray, num_samples: int,
                     seq_length: int) -> np.ndarray:
    """``[num_samples+1, 2]`` (doc_idx_index, doc_offset) sample boundaries."""
    doc_lens = np.ascontiguousarray(doc_lens, np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, np.int32)
    lib = _load_native()
    if lib is None:
        return _sample_idx_numpy(doc_lens, doc_idx, num_samples, seq_length)
    out = np.zeros((num_samples + 1, 2), np.int64)
    n = lib.build_sample_idx(
        doc_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        doc_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(doc_idx),
        num_samples,
        seq_length,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out[: n + 1]


def build_shuffle_idx(num_samples: int, seed: int) -> np.ndarray:
    rng = np.random.Generator(np.random.PCG64(seed + 1))
    return rng.permutation(num_samples).astype(np.int64)
