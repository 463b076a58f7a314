"""Sequence packing and fixed-length padding (counterpart of the JAX package's
``data/packing.py``; the same arrays for the same inputs).

- ``pack_sequences``: greedy packing into ``chunk_size`` rows, an EOS after
  each record, records longer than a row dropped, ``IGNORE_INDEX`` labels
  over the padding;
- ``pad_sequences``: every sequence padded (or truncated) to one length;
- ``mask_prompt_labels``: the SFT label rule, ``IGNORE_INDEX`` over the
  prompt;
- ``packed_segment_ids``: per-position record ids of the packed rows, for
  block-diagonal attention inside a row.

The packing loop runs in C++ (``packing_native.cpp``, built into
``build/torch_native/`` by ``data/_native.py``); without a host compiler a
numpy path gives the same arrays, with a warning.
"""

from __future__ import annotations

import ctypes
import logging
from itertools import chain
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from neuronx_distributed_training_torch.data._native import compile_and_load

logger = logging.getLogger(__name__)

IGNORE_INDEX = -100  # loss-masked label value (the HF convention)

_SRC = Path(__file__).with_name("packing_native.cpp")
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the C++ packer; None if no toolchain."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    lib = compile_and_load(_SRC)
    if lib is None:
        logger.warning("C++ sequence packer unavailable; using numpy fallback")
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.pack_count.restype = ctypes.c_int64
    lib.pack_count.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64]
    lib.pack_fill.restype = ctypes.c_int64
    lib.pack_fill.argtypes = [i32p, i32p, i64p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p]
    _lib = lib
    return _lib


def _pack_native(lib, token_lists, chunk_size, eos_id, label_lists, pad_id):
    """The C++ packer's arrays, or None for ragged labels (the numpy path
    then raises its own error)."""
    if label_lists is not None and (len(label_lists) != len(token_lists) or any(
            len(lb) != len(t) for lb, t in zip(label_lists, token_lists))):
        return None
    lens = np.asarray([len(t) for t in token_lists], np.int32)
    offsets = np.zeros(len(token_lists) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    flat_ids = np.fromiter(chain.from_iterable(token_lists), np.int32, count=total)
    flat_lbl = (flat_ids if label_lists is None
                else np.fromiter(chain.from_iterable(label_lists), np.int32, count=total))
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n_chunks = int(lib.pack_count(lens.ctypes.data_as(i32p), len(lens), chunk_size))
    ids = np.empty((n_chunks, chunk_size), np.int32)
    lbl = np.empty_like(ids)
    if n_chunks:
        written = lib.pack_fill(flat_ids.ctypes.data_as(i32p), flat_lbl.ctypes.data_as(i32p),
                                offsets.ctypes.data_as(i64p), len(lens), chunk_size,
                                eos_id, pad_id, IGNORE_INDEX,
                                ids.ctypes.data_as(i32p), lbl.ctypes.data_as(i32p))
        assert written == n_chunks, (written, n_chunks)
    return {"input_ids": ids, "labels": lbl,
            "loss_mask": (lbl != IGNORE_INDEX).astype(np.float32)}


def pack_sequences(
    token_lists: Sequence[Sequence[int]],
    chunk_size: int,
    eos_id: int,
    *,
    label_lists: Optional[Sequence[Sequence[int]]] = None,
    pad_id: int = 0,
) -> dict[str, np.ndarray]:
    """Greedy-pack variable-length sequences into ``[n_chunks, chunk_size]``
    ``input_ids`` / ``labels`` / ``loss_mask`` arrays: ``eos_id`` after each
    record, a new chunk when the next record does not fit, records longer
    than a chunk dropped.  Labels default to the input tokens (per-record
    ``label_lists`` carry SFT's prompt masking) and are ``IGNORE_INDEX`` over
    the padding."""
    lib = _load_native()
    if lib is not None:
        out = _pack_native(lib, token_lists, chunk_size, eos_id, label_lists, pad_id)
        if out is not None:
            return out
    chunks_ids: list[np.ndarray] = []
    chunks_lbl: list[np.ndarray] = []
    cur_ids: list[int] = []
    cur_lbl: list[int] = []

    def flush() -> None:
        if not cur_ids:
            return
        n = len(cur_ids)
        ids = np.full(chunk_size, pad_id, dtype=np.int32)
        lbl = np.full(chunk_size, IGNORE_INDEX, dtype=np.int32)
        ids[:n] = cur_ids
        lbl[:n] = cur_lbl
        chunks_ids.append(ids)
        chunks_lbl.append(lbl)
        cur_ids.clear()
        cur_lbl.clear()

    for i, toks in enumerate(token_lists):
        toks = list(toks) + [eos_id]
        lbls = (list(label_lists[i]) + [eos_id]) if label_lists is not None else list(toks)
        if len(toks) > chunk_size:
            continue  # overflow record dropped
        if len(cur_ids) + len(toks) > chunk_size:
            flush()
        cur_ids.extend(toks)
        cur_lbl.extend(lbls)
    flush()

    if not chunks_ids:
        return {"input_ids": np.zeros((0, chunk_size), np.int32),
                "labels": np.zeros((0, chunk_size), np.int32),
                "loss_mask": np.zeros((0, chunk_size), np.float32)}
    labels = np.stack(chunks_lbl)
    return {"input_ids": np.stack(chunks_ids), "labels": labels,
            "loss_mask": (labels != IGNORE_INDEX).astype(np.float32)}


def pad_sequences(
    token_lists: Sequence[Sequence[int]],
    max_length: int,
    pad_id: int,
    *,
    label_lists: Optional[Sequence[Sequence[int]]] = None,
    left_pad: bool = False,
    truncate: bool = True,
) -> dict[str, np.ndarray]:
    """Pad (or truncate) every sequence to exactly ``max_length``: one shape
    for every batch.  ``left_pad`` is the DPO prompt convention."""
    n = len(token_lists)
    input_ids = np.full((n, max_length), pad_id, dtype=np.int32)
    labels = np.full((n, max_length), IGNORE_INDEX, dtype=np.int32)
    attn = np.zeros((n, max_length), dtype=np.float32)
    for i, toks in enumerate(token_lists):
        toks = list(toks)
        lbls = list(label_lists[i]) if label_lists is not None else list(toks)
        if truncate:
            toks, lbls = toks[:max_length], lbls[:max_length]
        elif len(toks) > max_length:
            raise ValueError(f"sequence {i} length {len(toks)} > max_length {max_length}")
        m = len(toks)
        cols = slice(max_length - m, max_length) if left_pad else slice(0, m)
        input_ids[i, cols] = toks
        labels[i, cols] = lbls
        attn[i, cols] = 1.0
    return {"input_ids": input_ids, "labels": labels,
            "loss_mask": (labels != IGNORE_INDEX).astype(np.float32),
            "attention_mask": attn}


def mask_prompt_labels(prompt_tokens: Sequence[int],
                       response_tokens: Sequence[int]) -> tuple[list[int], list[int]]:
    """SFT tokenization rule: input = prompt + response, labels =
    ``IGNORE_INDEX`` over the prompt."""
    ids = list(prompt_tokens) + list(response_tokens)
    lbl = [IGNORE_INDEX] * len(prompt_tokens) + list(response_tokens)
    return ids, lbl


def packed_segment_ids(token_lists: Sequence[Sequence[int]], chunk_size: int) -> np.ndarray:
    """Per-position record ids of ``pack_sequences``' chunks: ``[n, chunk]``
    int32, records numbered 1.. within each chunk, padding 0.  Replays the
    packer's greedy layout from the record lengths; feed it to
    ``attention(segment_ids=...)`` so that packed records do not attend to
    each other."""
    rows: list[np.ndarray] = []
    cur: list[int] = []
    sid = 1

    def flush() -> None:
        nonlocal sid
        if not cur:
            return
        row = np.zeros(chunk_size, np.int32)
        row[: len(cur)] = cur
        rows.append(row)
        cur.clear()
        sid = 1

    for toks in token_lists:
        ln = len(toks) + 1  # + eos, as pack_sequences adds it
        if ln > chunk_size:
            continue  # dropped record
        if len(cur) + ln > chunk_size:
            flush()
        cur.extend([sid] * ln)
        sid += 1
    flush()
    if not rows:
        return np.zeros((0, chunk_size), np.int32)
    return np.stack(rows)
