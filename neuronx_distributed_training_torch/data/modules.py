"""Megatron pretraining DataModules (counterpart of the pretraining half of
the JAX package's ``data/modules.py``).

``MegatronDataModule`` reads one mmap ``.bin/.idx`` corpus through
``GPTDataset``; ``BlendedMegatronDataModule`` a seeded weighted blend of
several.  Both size their sample count as ``max_steps * global_batch_size``
(the reference sizes its train split the same way), so a run's data order
depends on ``trainer.max_steps``: a resumed run keeps the same value.

``labels_pre_shifted``: GPTDataset emits ``input_ids = tokens[:-1]``,
``labels = tokens[1:]``, so the trainer runs the model with
``shift_labels=False``.  The SFT, DPO and KTO modules are not ported yet
(``data/build.py`` raises for them, naming their ROADMAP item).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np

from neuronx_distributed_training_torch.data.loader import DataModule


def _stack_rows(rows: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    return {"input_ids": np.stack([r["input_ids"] for r in rows]),
            "labels": np.stack([r["labels"] for r in rows])}


class MegatronDataModule(DataModule):
    """Mmap GPT pretraining data over one corpus prefix."""

    labels_pre_shifted = True

    def __init__(self, path_prefix: str | Path, seq_length: int, global_batch_size: int, *,
                 max_steps: int = 1000, num_samples: Optional[int] = None, seed: int = 1234,
                 **kw: Any):
        from neuronx_distributed_training_torch.data.megatron import GPTDataset

        n = num_samples or max_steps * global_batch_size
        self.dataset = GPTDataset(path_prefix, seq_length, n, seed=seed)
        super().__init__(len(self.dataset), global_batch_size, **kw)

    def fetch_rows(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return _stack_rows([self.dataset[int(i)] for i in idx])


class BlendedMegatronDataModule(DataModule):
    """Weighted blend of several mmap corpora (``data_prefix: [w1, p1, w2,
    p2, ...]``).

    A seeded multinomial assigns each global sample index to a corpus
    (deterministic across restarts); the per-corpus inner index is the
    running count of prior assignments, so every corpus is consumed in order
    with its own shuffle.
    """

    labels_pre_shifted = True

    def __init__(self, prefixes_and_weights: Sequence[tuple[float, str | Path]],
                 seq_length: int, global_batch_size: int, *, max_steps: int = 1000,
                 num_samples: Optional[int] = None, seed: int = 1234, **kw: Any):
        from neuronx_distributed_training_torch.data.megatron import GPTDataset

        if not prefixes_and_weights:
            raise ValueError("blended data needs at least one (weight, prefix)")
        n = num_samples or max_steps * global_batch_size
        w = np.asarray([float(wt) for wt, _ in prefixes_and_weights], np.float64)
        if np.any(w <= 0):
            raise ValueError(f"blend weights must be positive, got {w}")
        w = w / w.sum()
        rng = np.random.default_rng(seed)
        self.choices = rng.choice(len(w), size=n, p=w).astype(np.int8)
        self.inner = np.zeros(n, np.int64)
        counts = []
        for k in range(len(w)):
            m = self.choices == k
            self.inner[m] = np.arange(int(m.sum()))
            counts.append(int(m.sum()))
        self.datasets = [
            GPTDataset(p, seq_length, max(c, 1), seed=seed + 17 * k)
            for k, ((_, p), c) in enumerate(zip(prefixes_and_weights, counts))
        ]
        super().__init__(n, global_batch_size, **kw)

    def fetch_rows(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return _stack_rows([self.datasets[int(self.choices[i])][int(self.inner[i])]
                            for i in idx])
