"""Megatron pretraining, SFT and preference DataModules (counterpart of the
JAX package's ``data/modules.py``).

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
it; its rows are not shifted, so the model shifts them.

``DPODataModule`` (DPO and ORPO) and ``KTODataModule`` tokenize preference
records with a prompt-length cap and overlong truncation
(``_encode_prompt_completion``), mask the prompt's labels and right-pad each
row to ``seq_length``; their batches are the arrays' rows as they are (no
causal-LM label derivation), and ``attach_reference_logprobs`` adds the
reference pass's columns.  KTO's ``kl_estimator: mismatched`` adds
``kl_input_ids`` / ``kl_loss_mask``: prompt ``i`` spliced with the
completion of record ``pair[i]``, a seeded pairing across different prompts
(``_mismatched_pairing``).
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np

from neuronx_distributed_training_torch.data.loader import DataModule
from neuronx_distributed_training_torch.data.packing import (
    IGNORE_INDEX,
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


class _ArrayRows(DataModule):
    """A module whose rows are held in ``self.arrays``: a batch is those
    arrays indexed by the sampler's rows."""

    arrays: dict[str, np.ndarray]

    def fetch_rows(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}


class SFTDataModule(_ArrayRows):
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


def _encode_prompt_completion(encode, eos, prompt, completion, seq_length,
                              max_prompt_length, truncation_mode):
    """``(ids, labels)`` of one prompt + completion: the prompt cut to
    ``max_prompt_length`` (its start or its end kept, by
    ``truncation_mode``), the completion plus EOS, then an overlong row
    trimmed by :func:`_trim_overlong`, and the prompt's labels masked.
    Shared by the DPO and KTO modules."""
    p_toks = list(encode(prompt))
    if max_prompt_length and len(p_toks) > int(max_prompt_length):
        m = int(max_prompt_length)
        p_toks = p_toks[:m] if truncation_mode == "keep_start" else p_toks[-m:]
    c_toks = list(encode(completion)) + [eos]
    return mask_prompt_labels(*_trim_overlong(p_toks, c_toks, seq_length, truncation_mode))


def _trim_overlong(p_toks: list, c_toks: list, seq_length: int, truncation_mode: str):
    """``(prompt, completion)`` of a row that fits ``seq_length``: an overlong
    row loses prompt tokens (its start or its end kept, by
    ``truncation_mode``), and the completion survives whole unless it alone
    fills the row, when only its last ``seq_length`` tokens remain."""
    if len(p_toks) + len(c_toks) <= seq_length:
        return p_toks, c_toks
    keep = seq_length - len(c_toks)
    if keep <= 0:
        return [], c_toks[-seq_length:]
    return (p_toks[-keep:] if truncation_mode == "keep_end" else p_toks[:keep]), c_toks


class _PreferenceRows(_ArrayRows):
    """The preference modules' common part: batches of their rows as they
    are, and the reference columns appended after the pass."""

    #: the key whose length is the dataset size
    size_key = "input_ids"

    def attach_reference_logprobs(self, columns: dict[str, np.ndarray]) -> None:
        """Append the reference pass's columns (fp32, one value per record)."""
        n = len(self.arrays[self.size_key])
        for k, v in columns.items():
            if len(v) != n:
                raise ValueError(f"column {k} length {len(v)} != dataset size")
            self.arrays[k] = np.asarray(v, np.float32)
        self.input_names = tuple(self.arrays)

    def global_batches(self):
        # preference batches bypass the causal-LM label derivation
        for idx in self.sampler:
            yield self.fetch_rows(idx)


class DPODataModule(_PreferenceRows):
    """DPO / ORPO pairs: records with ``prompt``, ``chosen`` and
    ``rejected``, each side tokenized with the prompt and right-padded to
    ``seq_length`` (``chosen_input_ids``, ``chosen_loss_mask``,
    ``rejected_input_ids``, ``rejected_loss_mask``)."""

    size_key = "chosen_input_ids"

    def __init__(
        self,
        records: Sequence[dict[str, Any]] | str | Path,
        tokenizer: Any,
        seq_length: int,
        global_batch_size: int,
        *,
        pad_id: int = 0,
        max_prompt_length: Optional[int] = None,
        truncation_mode: str = "keep_start",
        **kw: Any,
    ):
        if isinstance(records, (str, Path)):
            records = load_alignment_records(records)
        encode = tokenizer.encode if hasattr(tokenizer, "encode") else tokenizer
        eos = getattr(tokenizer, "eos_token_id", 0) or 0
        arrays: dict[str, np.ndarray] = {}
        for side in ("chosen", "rejected"):
            ids_list, lbl_list = [], []
            for r in records:
                ids, lbl = _encode_prompt_completion(encode, eos, r["prompt"], r[side],
                                                     seq_length, max_prompt_length,
                                                     truncation_mode)
                ids_list.append(ids)
                lbl_list.append(lbl)
            padded = pad_sequences(ids_list, seq_length, pad_id, label_lists=lbl_list)
            arrays[f"{side}_input_ids"] = padded["input_ids"]
            arrays[f"{side}_loss_mask"] = padded["loss_mask"]
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        super().__init__(len(records), global_batch_size, shuffle=kw.pop("shuffle", True),
                         input_names=tuple(self.arrays), **kw)


def _mismatched_pairing(prompts: Sequence[tuple], rng) -> list[int]:
    """Seeded pairing ``i -> j`` for KTO's mismatched-KL estimator: each
    record borrows the completion of a record with a different prompt.

    Records are grouped by prompt, shuffled within and among groups, laid out
    group by group (the largest first) and paired by a cyclic shift of the
    largest group's size ``m1``.  A group shifted by ``m1`` lands back on
    itself only if ``m_i + m1 > n``, so when the largest group holds at most
    half the records the pairing is a bijection with no matched pair.  When
    one prompt holds more than half, no such bijection exists (Hall's
    theorem): the pairing walks a shuffled cycle past same-prompt records,
    which is not injective, with a warning.  When every prompt is the same it
    is the cyclic successor, with a warning (the estimate then approaches
    ``batch_mean``)."""
    n = len(prompts)
    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(prompts):
        groups.setdefault(p, []).append(i)
    if len(groups) == 1:
        warnings.warn(
            "kto kl_estimator='mismatched': every record shares one "
            "prompt, so no truly mismatched pair exists — the KL "
            "baseline degenerates toward batch_mean",
            stacklevel=3,
        )
        order = rng.permutation(n)
        pos = np.empty(n, dtype=np.int64)
        pos[order] = np.arange(n)
        return [int(order[(pos[i] + 1) % n]) for i in range(n)]
    glist = list(groups.values())
    for g in glist:
        rng.shuffle(g)
    rng.shuffle(glist)
    glist.sort(key=len, reverse=True)  # stable: the random tiebreak survives
    m1 = len(glist[0])
    flat = [i for g in glist for i in g]
    if 2 * m1 <= n:
        pair = [0] * n
        for p, i in enumerate(flat):
            pair[i] = flat[(p + m1) % n]
        return pair
    warnings.warn(
        f"kto kl_estimator='mismatched': one prompt owns {m1} of {n} "
        f"records, so no one-to-one mismatched pairing exists — falling "
        f"back to a non-injective pairing (some completions weigh more "
        f"than once in the z0 KL baseline)",
        stacklevel=3,
    )
    order = rng.permutation(n)
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    pair = []
    for i in range(n):
        j = int(order[(pos[i] + 1) % n])
        while prompts[j] == prompts[i]:
            j = int(order[(pos[j] + 1) % n])
        pair.append(j)
    return pair


class KTODataModule(_PreferenceRows):
    """KTO's unpaired records: ``prompt``, ``completion`` and a ``label``
    (or ``desirable``; true for a desirable completion), tokenized as one
    right-padded row each (``input_ids``, ``loss_mask``, ``kto_labels``).

    ``kl_estimator="mismatched"`` adds ``kl_input_ids`` / ``kl_loss_mask``:
    prompt ``i`` (its row prefix) with the completion of record ``pair[i]``
    from :func:`_mismatched_pairing`, seeded by ``seed``, trimmed from the
    prompt when overlong, as the matched rows are.  Records are grouped by
    their whole encoded prompt, not the row prefix: an overlong row trims its
    prompt by its own completion's length, so two records of one prompt can
    hold different prefixes."""

    def __init__(
        self,
        records: Sequence[dict[str, Any]] | str | Path,
        tokenizer: Any,
        seq_length: int,
        global_batch_size: int,
        *,
        pad_id: int = 0,
        max_prompt_length: Optional[int] = None,
        truncation_mode: str = "keep_start",
        kl_estimator: str = "batch_mean",  # "batch_mean" | "mismatched"
        **kw: Any,
    ):
        if isinstance(records, (str, Path)):
            records = load_alignment_records(records)
        encode = tokenizer.encode if hasattr(tokenizer, "encode") else tokenizer
        eos = getattr(tokenizer, "eos_token_id", 0) or 0
        ids_list, lbl_list, kto_labels = [], [], []
        for r in records:
            ids, lbl = _encode_prompt_completion(encode, eos, r["prompt"], r["completion"],
                                                 seq_length, max_prompt_length, truncation_mode)
            ids_list.append(ids)
            lbl_list.append(lbl)
            if "label" in r:
                label = r["label"]
            elif "desirable" in r:
                label = r["desirable"]
            else:
                # defaulting would train every record as desirable
                raise KeyError(f"KTO record missing 'label' (or 'desirable') key: {sorted(r)}")
            kto_labels.append(1.0 if label else 0.0)
        padded = pad_sequences(ids_list, seq_length, pad_id, label_lists=lbl_list)
        self.arrays = {"input_ids": np.asarray(padded["input_ids"]),
                       "loss_mask": np.asarray(padded["loss_mask"]),
                       "kto_labels": np.asarray(kto_labels, np.float32)}
        if kl_estimator not in ("batch_mean", "mismatched"):
            raise ValueError(f"kto kl_estimator must be batch_mean or mismatched, "
                             f"got {kl_estimator!r}")
        if kl_estimator == "mismatched":
            self.arrays.update(self._mismatched_rows(records, encode, ids_list, lbl_list,
                                                     seq_length, pad_id,
                                                     int(kw.get("seed", 1234))))
        self.kl_estimator = kl_estimator
        super().__init__(len(records), global_batch_size, shuffle=kw.pop("shuffle", True),
                         input_names=tuple(self.arrays), **kw)

    @staticmethod
    def _mismatched_rows(records, encode, ids_list, lbl_list, seq_length, pad_id, seed):
        n = len(ids_list)
        if n < 2:
            raise ValueError(
                "kto kl_estimator='mismatched' needs at least 2 records "
                "(with 1 the 'mismatched' pair IS the matched pair and "
                "the estimator silently degenerates to batch_mean)")
        cuts = [next((k for k, v in enumerate(lbl) if v != IGNORE_INDEX), len(lbl))
                for lbl in lbl_list]
        prompts = [tuple(encode(r["prompt"])) for r in records]
        pair = _mismatched_pairing(prompts, np.random.default_rng(seed))
        kl_ids, kl_lbl = [], []
        for i in range(n):
            j = pair[i]
            # the matched rows' rule, keeping the prompt's start: an
            # overlong splice trims the prompt
            ids_kl, lbl_kl = mask_prompt_labels(*_trim_overlong(
                list(ids_list[i][: cuts[i]]), list(ids_list[j][cuts[j]:]), seq_length,
                "keep_start"))
            kl_ids.append(ids_kl)
            kl_lbl.append(lbl_kl)
        kl_padded = pad_sequences(kl_ids, seq_length, pad_id, label_lists=kl_lbl)
        return {"kl_input_ids": np.asarray(kl_padded["input_ids"]),
                "kl_loss_mask": np.asarray(kl_padded["loss_mask"])}
