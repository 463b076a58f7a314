"""Mmap indexed dataset (.bin/.idx) and GPTDataset sample assembly
(counterpart of the JAX package's ``data/megatron/dataset.py``: the same file
format, the same index arrays, the same samples).

.idx layout (Megatron MMIDIDX v1):
  magic ``MMIDIDX\\x00\\x00`` | u64 version=1 | u8 dtype_code | u64 count
  | u64 doc_count | i32 sizes[count] | i64 pointers[count]
  | i64 doc_idx[doc_count]

Reading is a numpy memmap (zero-copy); the sample-index walk is the C++ loop
in ``index_builder.cpp``.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from neuronx_distributed_training_torch.data.megatron.index import (
    build_doc_idx,
    build_sample_idx,
    build_shuffle_idx,
)

_MAGIC = b"MMIDIDX\x00\x00"
_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
           6: np.float32, 7: np.float64, 8: np.uint16}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def write_indexed_dataset(path_prefix: str | Path, docs: list[np.ndarray]) -> None:
    """Write .bin/.idx in Megatron format (the offline preprocess step)."""
    path_prefix = Path(path_prefix)
    docs = [np.asarray(d) for d in docs]
    dtype = docs[0].dtype if docs else np.dtype(np.int32)
    with open(path_prefix.with_suffix(".bin"), "wb") as f:
        for d in docs:
            f.write(d.astype(dtype).tobytes(order="C"))
    sizes = np.array([len(d) for d in docs], np.int32)
    pointers = np.zeros(len(docs), np.int64)
    if len(docs) > 1:
        pointers[1:] = np.cumsum(sizes[:-1].astype(np.int64) * dtype.itemsize)
    doc_idx = np.arange(len(docs) + 1, dtype=np.int64)  # Megatron stores n+1 entries
    with open(path_prefix.with_suffix(".idx"), "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<B", _DTYPE_CODES[np.dtype(dtype)]))
        f.write(struct.pack("<Q", len(docs)))
        f.write(struct.pack("<Q", len(doc_idx)))
        f.write(sizes.tobytes())
        f.write(pointers.tobytes())
        f.write(doc_idx.tobytes())


class IndexedDataset:
    """Zero-copy mmap reader for Megatron .bin/.idx pairs."""

    def __init__(self, path_prefix: str | Path):
        path_prefix = Path(path_prefix)
        with open(path_prefix.with_suffix(".idx"), "rb") as f:
            if f.read(9) != _MAGIC:
                raise ValueError(f"bad index magic in {path_prefix}.idx")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != 1:
                raise ValueError(f"unsupported index version {version}")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(_DTYPES[code])
            (count,) = struct.unpack("<Q", f.read(8))
            struct.unpack("<Q", f.read(8))  # doc_count
            offset = f.tell()
        idx = np.memmap(path_prefix.with_suffix(".idx"), mode="r", offset=offset)
        self.sizes = np.frombuffer(idx, np.int32, count, 0)
        self.pointers = np.frombuffer(idx, np.int64, count, count * 4)
        self._bin = np.memmap(path_prefix.with_suffix(".bin"), dtype=self.dtype, mode="r")

    def __len__(self) -> int:
        return len(self.sizes)

    def get(self, doc: int, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        start = self.pointers[doc] // self.dtype.itemsize + offset
        n = (self.sizes[doc] - offset) if length is None else length
        return np.asarray(self._bin[start : start + n])


class GPTDataset:
    """Fixed-length causal-LM samples over an IndexedDataset.

    Deterministic in ``(seed, seq_length, num_samples)``; the index arrays are
    cached as .npy next to the data (``<prefix>_cache/``), written atomically
    (temp + rename) since another process may race on the same cache dir.
    Rows are pre-shifted: ``input_ids = tokens[:-1]``, ``labels = tokens[1:]``.
    """

    def __init__(self, path_prefix: str | Path, seq_length: int, num_samples: int, *,
                 seed: int = 1234, cache_dir: Optional[str | Path] = None):
        self.indexed = IndexedDataset(path_prefix)
        self.seq_length = seq_length
        tokens_per_epoch = max(int(self.indexed.sizes.sum()), 1)
        num_epochs = int(np.ceil((num_samples * (seq_length + 1)) / tokens_per_epoch)) + 1

        cache = Path(cache_dir) if cache_dir else Path(str(path_prefix) + "_cache")
        cache.mkdir(parents=True, exist_ok=True)
        tag = f"s{seed}_l{seq_length}_n{num_samples}"
        doc_p = cache / f"doc_idx_{tag}.npy"
        samp_p = cache / f"sample_idx_{tag}.npy"
        shuf_p = cache / f"shuffle_idx_{tag}.npy"
        if doc_p.exists() and samp_p.exists() and shuf_p.exists():
            self.doc_idx = np.load(doc_p, mmap_mode="r")
            self.sample_idx = np.load(samp_p, mmap_mode="r")
            self.shuffle_idx = np.load(shuf_p, mmap_mode="r")
        else:
            self.doc_idx = build_doc_idx(len(self.indexed), num_epochs, seed)
            self.sample_idx = build_sample_idx(self.indexed.sizes, self.doc_idx,
                                               num_samples, seq_length)
            self.shuffle_idx = build_shuffle_idx(len(self.sample_idx) - 1, seed)
            for path, arr in ((doc_p, self.doc_idx), (samp_p, self.sample_idx),
                              (shuf_p, self.shuffle_idx)):
                tmp = path.with_suffix(f".tmp{os.getpid()}.npy")
                np.save(tmp, arr)
                os.replace(tmp, path)

    def __len__(self) -> int:
        return len(self.shuffle_idx)

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        i = int(self.shuffle_idx[i % len(self.shuffle_idx)])
        (doc_a, off_a), (doc_b, off_b) = self.sample_idx[i], self.sample_idx[i + 1]
        if doc_a == doc_b:
            parts = [self.indexed.get(self.doc_idx[doc_a], off_a, off_b - off_a + 1)]
        else:
            parts = [self.indexed.get(self.doc_idx[doc_a], off_a)]
            parts += [self.indexed.get(self.doc_idx[d]) for d in range(doc_a + 1, doc_b)]
            parts.append(self.indexed.get(self.doc_idx[doc_b], 0, off_b + 1))
        tokens = np.concatenate(parts).astype(np.int32)
        if len(tokens) != self.seq_length + 1:
            raise AssertionError(
                f"sample {i}: got {len(tokens)} tokens, want {self.seq_length + 1}")
        return {"input_ids": tokens[:-1], "labels": tokens[1:]}
