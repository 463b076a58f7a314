"""Megatron pretraining and SFT DataModules (counterpart of the JAX
package's ``data/modules.py``, its DPO and KTO modules aside).

``MegatronDataModule`` reads one mmap ``.bin/.idx`` corpus through
``GPTDataset``; ``BlendedMegatronDataModule`` a seeded weighted blend of
several.  Both size their sample count as ``max_steps * global_batch_size``
(the reference sizes its train split the same way), so a run's data order
depends on ``trainer.max_steps``: a resumed run keeps the same value.

``labels_pre_shifted``: GPTDataset emits ``input_ids = tokens[:-1]``,
``labels = tokens[1:]``, so the trainer runs the model with
``shift_labels=False``.

``SFTDataModule`` tokenizes prompt/completion records (``input``/``output``
or ``prompt``/``completion``, after an optional template), masks the prompt's
labels, and greedy-packs the records into ``seq_length`` rows or pads each to
it; its rows are not shifted, so the model shifts them.  The DPO and KTO
modules are not ported yet (``data/build.py`` raises for them, naming their
ROADMAP item).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np

from neuronx_distributed_training_torch.data.loader import DataModule
from neuronx_distributed_training_torch.data.packing import (
    mask_prompt_labels,
    pack_sequences,
    packed_segment_ids,
    pad_sequences,
)


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


def load_alignment_records(path: str | Path) -> list[dict[str, Any]]:
    """Records of a jsonl file, a json file (a list, or ``{"data": [...]}``)
    or an arrow directory written by ``datasets.save_to_disk``."""
    p = Path(path)
    if p.is_dir():
        try:
            import datasets  # lazy: heavy import
        except ImportError as e:
            raise ImportError(
                f"alignment data {str(p)!r} is an arrow directory written by "
                f"datasets.save_to_disk; reading it needs the 'datasets' package, "
                f"which is not installed here") from e
        return [dict(r) for r in datasets.load_from_disk(str(p))]
    if p.suffix == ".jsonl":
        return [json.loads(line) for line in p.read_text().splitlines() if line.strip()]
    if p.suffix == ".json":
        data = json.loads(p.read_text())
        return data if isinstance(data, list) else data["data"]
    raise ValueError(f"unsupported alignment data format: {p}")


class SFTDataModule(DataModule):
    """SFT rows: ``bos + encode(input)`` as the prompt (labels
    ``IGNORE_INDEX``), ``encode(output)`` as the response, then greedy packing
    into ``seq_length`` rows (``packing``, with an EOS after each record) or
    one padded row per record.  ``segment_mask`` (packing only) adds
    ``segment_ids`` so that packed records do not attend to each other.

    ``tokenizer`` is an object with ``encode`` (and ``eos_token_id`` /
    ``bos_token_id``) or a callable ``str -> list[int]``."""

    def __init__(
        self,
        records: Sequence[dict[str, Any]] | str | Path,
        tokenizer: Any,
        seq_length: int,
        global_batch_size: int,
        *,
        packing: bool = True,
        segment_mask: bool = False,
        bos_id: Optional[int] = None,
        eos_id: Optional[int] = None,
        pad_id: int = 0,
        template: Optional[Any] = None,  # data.templates.Template
        **kw: Any,
    ):
        if isinstance(records, (str, Path)):
            records = load_alignment_records(records)
        encode = tokenizer.encode if hasattr(tokenizer, "encode") else tokenizer
        if eos_id is None:
            eos_id = getattr(tokenizer, "eos_token_id", 0) or 0
        if bos_id is None:
            bos_id = getattr(tokenizer, "bos_token_id", None)

        ids_list, lbl_list = [], []
        for r in records:
            if template is not None:
                r = template(r)
            src = r.get("input", r.get("prompt", ""))
            dst = r.get("output", r.get("completion", ""))
            prompt_toks = ([bos_id] if bos_id is not None else []) + list(encode(src))
            ids, lbl = mask_prompt_labels(prompt_toks, list(encode(dst)))
            ids_list.append(ids)
            lbl_list.append(lbl)

        if packing:
            self.arrays = pack_sequences(ids_list, seq_length, eos_id, label_lists=lbl_list,
                                         pad_id=pad_id)
            if segment_mask:
                self.arrays["segment_ids"] = packed_segment_ids(ids_list, seq_length)
                # the replay must track pack_sequences' layout exactly: a
                # drift fails here instead of training with a wrong mask
                if self.arrays["segment_ids"].shape != self.arrays["input_ids"].shape:
                    raise AssertionError(
                        f"packed_segment_ids layout drifted from "
                        f"pack_sequences: {self.arrays['segment_ids'].shape} "
                        f"vs {self.arrays['input_ids'].shape}"
                    )
        else:
            if segment_mask:
                raise ValueError(
                    "sft segment_mask requires packing: true (unpacked rows "
                    "are single records; the causal mask already isolates them)"
                )
            padded = pad_sequences(ids_list, seq_length, pad_id, label_lists=lbl_list)
            self.arrays = {k: padded[k] for k in ("input_ids", "labels", "loss_mask")}
        n = len(self.arrays["input_ids"])
        if n < global_batch_size:
            raise ValueError(
                f"SFT dataset too small: {n} packed rows < global_batch_size "
                f"{global_batch_size}"
            )
        # input_names must list segment_ids, or process_global_batch drops it
        super().__init__(n, global_batch_size, shuffle=kw.pop("shuffle", True),
                         input_names=tuple(self.arrays), **kw)

    def fetch_rows(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}
