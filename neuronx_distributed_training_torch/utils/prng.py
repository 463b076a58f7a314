"""The dropout key discipline (counterpart of the JAX package's
``utils/prng.py`` and of the keys its trainer and GPT model derive).

JAX derives every random stream from one base key with ``fold_in`` on
stable integer tags: the stream tags below (never renumbered), the step key
``fold_in(PRNGKey(0), step)`` of its train loop, the per-microbatch keys of
its pipeline and the stage fold ``fold_in(fold_in(key, pipe rank),
chunk)``.  Torch's Philox cannot draw threefry's bits, so the port keeps the
derivation and not the masks: a :class:`Key` is the path of integer folds
itself, host-side, and a mask row is drawn from a generator seeded by a hash
of ``(STREAM_DROPOUT, path, global row)``, over the whole global sequence,
of which a rank takes the positions it holds.  So a mask is a function of
(step, microbatch, layer, site, global row, global position) and the pipe
rank / chunk folds alone:

- deterministic, and redrawn bit for bit by a recompute (remat, the
  pipeline's wavefront) and by a resumed run, whose step key is the same;
- layout-free: the tp ranks that hold a replicated activation draw the same
  mask, under sequence parallelism a rank takes its slice of the one global
  mask, and a data rank draws its own rows' masks (``Key.rows``: the
  rows' indices in the whole microbatch).

Without pipeline parallelism every microbatch of a step gets the step key,
so their masks repeat, as JAX's do (``trainer/step.py`` hands each
microbatch the same ``step_key``).  A key of None, or a rate of 0, draws
nothing.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

# Stable stream tags (never renumber: the reproducibility contract)
STREAM_PARAMS = 0
STREAM_DATA = 1
STREAM_DROPOUT = 2
STREAM_ROUTER = 3

#: base seed of the per-step key (JAX's ``STEP_KEY_SEED``)
STEP_KEY_SEED = 0
#: the embedding dropout's fold (JAX's ``fold_in(rng, 0x0E)``)
EMBED_TAG = 0x0E
#: the fold before a layer index
LAYER_TAG = 0x1A


@dataclasses.dataclass(frozen=True)
class Key:
    """A fold path of ints, and the global indices of the rows it is used
    for (None: rows ``0 ... b-1`` of the tensor it masks)."""

    path: tuple
    rows: Optional[tuple] = None

    def fold(self, *data: int) -> "Key":
        return dataclasses.replace(self, path=self.path + tuple(int(d) for d in data))

    def with_rows(self, rows) -> "Key":
        return dataclasses.replace(self, rows=tuple(int(r) for r in rows))


def step_key(step: int) -> Key:
    """``fold_in(PRNGKey(STEP_KEY_SEED), step)``."""
    return Key((STEP_KEY_SEED, int(step)))


def stage_key(key: Key, pipe_rank: int, chunk: int) -> Key:
    """A pipeline stage's key: the pipe rank, then the vp chunk, folded in
    (JAX ``models/gpt.py:650-652``)."""
    return key.fold(pipe_rank).fold(chunk)


def seed_of(path: tuple) -> int:
    """A 63-bit seed from a fold path (a stable hash of its int64 bytes)."""
    digest = hashlib.blake2b(np.asarray(path, dtype=np.int64).tobytes(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") & ((1 << 63) - 1)


def keep_mask(key: Key, b: int, seq_len: int, width: int, keep: float, *, positions=None,
              device=None) -> torch.Tensor:
    """``[b, len(positions), width]`` bool: row ``r``'s mask is drawn whole,
    ``[seq_len, width]`` uniforms from a generator seeded by ``(STREAM_DROPOUT,
    key.path, key.rows[r])``, and ``positions`` (a slice or an index tensor
    of the global sequence; None: all of it) taken from it."""
    rows = key.rows if key.rows is not None else tuple(range(b))
    if len(rows) != b:
        raise ValueError(f"a dropout key for {len(rows)} rows used on {b}")
    out = []
    for r in rows:
        gen = torch.Generator(device=device).manual_seed(
            seed_of((STREAM_DROPOUT,) + key.path + (r,)))
        u = torch.rand((seq_len, width), generator=gen, device=device)
        out.append((u if positions is None else u[positions]) < keep)
    return torch.stack(out)


def dropout(x: torch.Tensor, rate: float, key: Optional[Key], *, seq_len: Optional[int] = None,
            positions=None) -> torch.Tensor:
    """Inverted dropout of ``x [b, s, h]`` (JAX's ``where(keep, x / (1 -
    rate), 0)``); ``x`` holds ``positions`` of a sequence of ``seq_len``
    (default: all ``s`` of them)."""
    if rate <= 0.0 or key is None:
        return x
    b, s, h = x.shape
    keep = keep_mask(key, b, seq_len or s, h, 1.0 - rate, positions=positions, device=x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
