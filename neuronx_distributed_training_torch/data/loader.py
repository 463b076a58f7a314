"""DataModules: dataset -> fixed-shape global batches (counterpart of the JAX
package's ``data/loader.py``: the ``DataModule`` base, ``process_global_batch``
and ``SyntheticDataModule``; no prefetch thread yet).

Batches are numpy on the host; the trainer moves each global batch to the
device once per step and splits it into microbatches there.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence

import numpy as np

from neuronx_distributed_training_torch.data.sampler import PretrainingSampler, RandomSampler

IGNORE_INDEX = -100


def process_global_batch(
    batch: dict[str, np.ndarray],
    *,
    input_names: Sequence[str] = ("input_ids", "labels", "loss_mask"),
    pad_id: Optional[int] = None,
    derive_loss_mask: bool = True,
) -> dict[str, np.ndarray]:
    """Filter to ``input_names`` and derive missing ``labels`` / ``loss_mask``;
    ``pad_id`` additionally masks padded positions out of the loss."""
    out: dict[str, np.ndarray] = {}
    ids = np.asarray(batch["input_ids"], dtype=np.int32)
    out["input_ids"] = ids
    if "labels" in input_names:
        labels = np.asarray(batch.get("labels", ids), dtype=np.int32)
        out["labels"] = labels
        if "loss_mask" in input_names:
            if "loss_mask" in batch:
                out["loss_mask"] = np.asarray(batch["loss_mask"], dtype=np.float32)
            elif derive_loss_mask:
                mask = labels != IGNORE_INDEX
                if pad_id is not None:
                    mask &= ids != pad_id
                out["loss_mask"] = mask.astype(np.float32)
    for k in input_names:
        if k not in out and k in batch:
            out[k] = np.asarray(batch[k])
    return out


class DataModule:
    """Base: sampler + row fetch + batch processing.  Subclasses implement
    ``fetch_rows``."""

    def __init__(
        self,
        total_samples: int,
        global_batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 1234,
        consumed_samples: int = 0,
    ):
        self.global_batch_size = global_batch_size
        if shuffle:
            self.sampler: Any = RandomSampler(
                total_samples, global_batch_size, seed=seed, consumed_samples=consumed_samples
            )
        else:
            self.sampler = PretrainingSampler(
                total_samples, global_batch_size, consumed_samples=consumed_samples
            )

    @property
    def consumed_samples(self) -> int:
        return self.sampler.consumed_samples

    def fetch_rows(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def global_batches(self) -> Iterator[dict[str, np.ndarray]]:
        """Yield processed host-side global batches (numpy)."""
        for idx in self.sampler:
            yield process_global_batch(self.fetch_rows(idx))


class SyntheticDataModule(DataModule):
    """Deterministic synthetic causal-LM data: each row is a pure function of
    its index, byte-identical to the JAX package's rows for the same seed."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch_size: int, *,
                 total_samples: int = 1 << 16, seed: int = 0, **kw: Any):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self._seed = seed
        super().__init__(total_samples, global_batch_size, **kw)

    def fetch_rows(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        rows = np.empty((len(idx), self.seq_len), dtype=np.int32)
        for r, i in enumerate(idx):
            rng = np.random.Generator(np.random.PCG64(self._seed * 1_000_003 + int(i)))
            rows[r] = rng.integers(0, self.vocab_size, self.seq_len, dtype=np.int32)
        return {"input_ids": rows}
