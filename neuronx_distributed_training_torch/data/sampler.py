"""Deterministic samplers with consumed-samples resume (a copy of the JAX
package's ``data/sampler.py``; pure numpy).

The reference uses NeMo's ``MegatronPretrainingBatchSampler`` /
``MegatronPretrainingRandomBatchSampler`` keyed by DP rank/size and
``consumed_samples`` (reference ``megatron/data_module.py:132-173``), plus torch
``DistributedSampler`` for the HF path (``hf_data_module.py:15-44``).  Resume
exactness comes from ``compute_consumed_samples`` and the
filename-encoded consumed-samples restore (``data/base.py:33-47``).

Here a sampler is a deterministic pure function ``(epoch, index) -> dataset row``;
"consumed samples" is the single integer of state.  Every DP rank computes the
same global order and slices its own rows, so there is no cross-host coordination.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterator, Optional

import numpy as np

# The reference encodes progress in checkpoint names, e.g.
# ``…-step=1000-consumed_samples=128000.0.ckpt`` (data/base.py:40-47).
_CONSUMED_RE = re.compile(r"consumed_samples[=_](\d+(?:\.\d+)?)")


def consumed_samples_from_name(name: str) -> Optional[int]:
    """Extract consumed-samples from a checkpoint tag/filename
    (reference ``data/base.py:40-47``)."""
    m = _CONSUMED_RE.search(name)
    return int(float(m.group(1))) if m else None


@dataclasses.dataclass
class PretrainingSampler:
    """Sequential sampler over an (optionally shuffled-once) dataset.

    Yields **global-batch index arrays** of shape ``[global_batch_size]``; the
    caller slices the DP-rank-local rows.  Equivalent to NeMo's
    ``MegatronPretrainingBatchSampler`` (reference ``megatron/data_module.py:141-155``):
    wraps around the dataset epoch-by-epoch, restartable from ``consumed_samples``.
    """

    total_samples: int
    global_batch_size: int
    consumed_samples: int = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = self.consumed_samples
        while True:
            batch = np.arange(idx, idx + self.global_batch_size) % self.total_samples
            idx += self.global_batch_size
            self.consumed_samples = idx
            yield batch

    def state(self) -> int:
        return self.consumed_samples


@dataclasses.dataclass
class RandomSampler:
    """Per-epoch-shuffled sampler, deterministic in ``(seed, epoch)``.

    Equivalent to NeMo's ``MegatronPretrainingRandomBatchSampler`` /
    torch ``DistributedSampler(shuffle=True)`` (reference
    ``model_alignment_data_module.py:186-224``): every rank derives the same
    permutation from the seed, so resume only needs ``consumed_samples``.
    """

    total_samples: int
    global_batch_size: int
    seed: int = 1234
    consumed_samples: int = 0

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.Generator(np.random.PCG64(self.seed + epoch))
        return rng.permutation(self.total_samples)

    def __iter__(self) -> Iterator[np.ndarray]:
        # batches never straddle epochs: partial trailing batches are dropped,
        # matching drop_last semantics of the reference samplers
        batches_per_epoch = self.total_samples // self.global_batch_size
        if batches_per_epoch == 0:
            raise ValueError(
                f"dataset of {self.total_samples} rows smaller than "
                f"global_batch_size {self.global_batch_size}"
            )
        samples_per_epoch = batches_per_epoch * self.global_batch_size
        while True:
            epoch = self.consumed_samples // samples_per_epoch
            offset = self.consumed_samples % samples_per_epoch
            # resuming with a changed global_batch_size can leave the offset
            # mid-batch; align down (re-reads a few samples) rather than yield
            # a short batch that would break the fixed-shape contract
            offset -= offset % self.global_batch_size
            perm = self._epoch_perm(epoch)
            for start in range(offset, samples_per_epoch, self.global_batch_size):
                # state updated BEFORE yield so consumed_samples is correct at
                # checkpoint time even mid-iteration
                self.consumed_samples += self.global_batch_size
                yield perm[start : start + self.global_batch_size]

    def state(self) -> int:
        return self.consumed_samples


def dp_shard(batch_idx: np.ndarray, dp_rank: int, dp_size: int) -> np.ndarray:
    """Slice one DP rank's rows out of a global-batch index array (the
    ``DistributedSampler(num_replicas=dp, rank=r)`` role, reference
    ``hf_data_module.py:16-22``)."""
    if batch_idx.shape[0] % dp_size != 0:
        raise ValueError(
            f"global batch {batch_idx.shape[0]} not divisible by dp_size {dp_size}"
        )
    per = batch_idx.shape[0] // dp_size
    return batch_idx[dp_rank * per : (dp_rank + 1) * per]
