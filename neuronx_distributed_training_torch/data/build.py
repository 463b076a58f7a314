"""Config -> DataModule dispatch (counterpart of the JAX package's
``data/build.py``):

    train_dm, val_dm = build_data_module(cfg, sched, seed=seed, vocab_size=v)

- ``data.data_prefix``: Megatron mmap pretraining, one prefix or the blended
  ``[weight, path, weight, path, ...]`` form;
- ``data.train_dir`` (and ``val_dir``): a pretokenized arrow directory;
- ``data.synthetic: true``: random tokens, only when asked for;
- ``model_alignment_strategy: {sft: {...}}``: ``SFTDataModule`` over the
  jsonl / json / arrow records of ``data.train_dir`` (and ``val_dir``),
  tokenized by ``data.tokenizer`` (an HF tokenizer, or the offline
  ``library: char`` one), with ``packing`` (default on), ``segment_mask``,
  ``data.dev_choose_samples`` (a head-N subset) and the prompt templates of
  ``data/templates.py``;
- ``model_alignment_strategy: {dpo | orpo: {...}}``: ``DPODataModule`` over
  prompt / chosen / rejected records, ``{kto: {...}}``: ``KTODataModule``
  over prompt / completion / label records (with the block's
  ``kl_estimator``), both with the block's ``max_prompt_length`` and
  ``truncation_mode``.

A config with no data source is an error, never a silent random-token run.
"""

from __future__ import annotations

from typing import Any, Optional

from neuronx_distributed_training_torch.data.loader import (
    DataModule,
    HFDataModule,
    SyntheticDataModule,
)
from neuronx_distributed_training_torch.data.modules import (
    BlendedMegatronDataModule,
    DPODataModule,
    KTODataModule,
    MegatronDataModule,
    SFTDataModule,
    load_alignment_records,
)
from neuronx_distributed_training_torch.data.templates import build_template


def alignment_strategy(cfg: Any) -> tuple[str, dict]:
    """Normalize ``model_alignment_strategy`` to ``(name, params)``: a dict
    block (``{sft: {packing: true}}``) or a bare string."""
    blk = cfg.get("model_alignment_strategy", None)
    if not blk:
        return "", {}
    if isinstance(blk, str):
        return blk.lower(), {}
    for name in ("sft", "dpo", "orpo", "kto"):
        if name in blk:
            return name, dict(blk.get(name) or {})
    raise ValueError(
        f"model_alignment_strategy must be a string or contain one of "
        f"sft/dpo/orpo/kto, got keys {list(blk)}"
    )


class CharTokenizer:
    """Offline char-level tokenizer (``tokenizer.library: char``) for smoke
    runs and tests where no HF tokenizer files exist: each UTF-8 byte maps to
    ``3 + byte % (vocab_size - 3)``."""

    bos_token_id = 1
    eos_token_id = 2

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list[int]:
        return [3 + (b % (self.vocab_size - 3)) for b in text.encode()]


def build_tokenizer(data_cfg: dict) -> Any:
    """The tokenizer of ``data.tokenizer``: ``library: char`` (offline), else
    an HF tokenizer from ``type`` (or ``name``), a directory or hub name,
    loaded by ``transformers`` (imported here, not at module import)."""
    tok_cfg = dict(data_cfg.get("tokenizer") or {})
    library = str(tok_cfg.get("library", "huggingface")).lower()
    if library == "char":
        return CharTokenizer(int(tok_cfg.get("vocab_size", 512)))
    name = tok_cfg.get("type") or tok_cfg.get("name")
    if not name:
        raise ValueError("data.tokenizer.type is required for this data path")
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"data.tokenizer.type {str(name)!r} is an HF tokenizer; loading it needs "
            f"the 'transformers' package, which is not installed here (use "
            f"data.tokenizer.library: char for an offline run)") from e
    return AutoTokenizer.from_pretrained(str(name))


def build_data_module(
    cfg: Any,
    sched: dict,
    *,
    seed: int = 1234,
    vocab_size: Optional[int] = None,
) -> tuple[Optional[DataModule], Optional[DataModule]]:
    """(train, val) DataModules from ``cfg.data``.

    Returns ``(None, None)`` only for ``data.synthetic: true`` with no vocab
    hint; the caller then builds SyntheticDataModule once the model config
    (and its vocab size) exists."""
    data = dict(cfg.get("data", {}) or {})
    gbs = sched["global_batch_size"]
    seq = int(data.get("seq_length")
              or (cfg.get("model", {}) or {}).get("encoder_seq_length")
              or (cfg.get("model", {}) or {}).get("max_position_embeddings")
              or 2048)
    strategy, strat_params = alignment_strategy(cfg)
    train_dir = data.get("train_dir")
    val_dir = data.get("val_dir")
    data_prefix = data.get("data_prefix")
    max_steps = int((cfg.get("trainer", {}) or {}).get("max_steps", 1000))

    if strategy == "sft":
        tokenizer = build_tokenizer(data)
        packing = bool(strat_params.get("packing", True))
        segment_mask = bool(strat_params.get("segment_mask", False))
        n_head = data.get("dev_choose_samples")
        template = build_template(data, tokenizer)

        def sft(path):
            records = load_alignment_records(path)
            if n_head:
                records = records[: int(n_head)]
            return SFTDataModule(records, tokenizer, seq, gbs, packing=packing,
                                 segment_mask=segment_mask, seed=seed, template=template)

        if not train_dir:
            raise ValueError("SFT needs data.train_dir (jsonl/json/arrow)")
        return sft(train_dir), (sft(val_dir) if val_dir else None)

    if strategy in ("dpo", "orpo", "kto"):
        tokenizer = build_tokenizer(data)
        module_cls = KTODataModule if strategy == "kto" else DPODataModule

        def pref(path):
            extra = {}
            if strategy == "kto":
                extra["kl_estimator"] = str(strat_params.get("kl_estimator", "batch_mean"))
            return module_cls(path, tokenizer, seq, gbs, seed=seed,
                              max_prompt_length=strat_params.get("max_prompt_length"),
                              truncation_mode=str(strat_params.get("truncation_mode",
                                                                   "keep_start")),
                              **extra)

        if not train_dir:
            raise ValueError(f"{strategy.upper()} needs data.train_dir (jsonl/json/arrow)")
        return pref(train_dir), (pref(val_dir) if val_dir else None)

    if data_prefix:
        prefix = data_prefix
        if isinstance(prefix, (list, tuple)):
            items = list(prefix)
            if len(items) == 1:
                prefix = items[0]
            else:
                try:
                    if len(items) % 2 != 0:
                        raise ValueError("odd length")
                    pairs = [(float(items[i]), str(items[i + 1]))
                             for i in range(0, len(items), 2)]
                except (TypeError, ValueError) as e:
                    raise ValueError(
                        f"multi-corpus data_prefix must be [weight, path, "
                        f"weight, path, ...] pairs with numeric weights, "
                        f"got {items}"
                    ) from e
                return BlendedMegatronDataModule(pairs, seq, gbs, max_steps=max_steps,
                                                 seed=seed), None
        return MegatronDataModule(prefix, seq, gbs, max_steps=max_steps, seed=seed), None

    if train_dir:
        train = HFDataModule(train_dir, gbs, seed=seed)
        val = HFDataModule(val_dir, gbs, seed=seed) if val_dir else None
        return train, val

    if data.get("synthetic"):
        if vocab_size is None:
            return None, None
        return SyntheticDataModule(vocab_size=vocab_size, seq_len=seq,
                                   global_batch_size=gbs, seed=seed), None

    raise ValueError(
        "cfg.data has no data source: set data.train_dir (HF arrow dir or "
        "jsonl for alignment), data.data_prefix (Megatron mmap), or "
        "data.synthetic: true for random-token smoke runs"
    )
