"""Config -> DataModule dispatch (counterpart of the JAX package's
``data/build.py``):

    train_dm, val_dm = build_data_module(cfg, sched, seed=seed, vocab_size=v)

- ``data.data_prefix``: Megatron mmap pretraining, one prefix or the blended
  ``[weight, path, weight, path, ...]`` form;
- ``data.train_dir`` (and ``val_dir``): a pretokenized arrow directory;
- ``data.synthetic: true``: random tokens, only when asked for.

A config with no data source is an error, never a silent random-token run.
The alignment strategies' data modules are not ported yet: SFT's (packing
and prompt templates) is ROADMAP queue 1 item 8, DPO/ORPO/KTO's item 14.
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
    MegatronDataModule,
)


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
    strategy, _ = alignment_strategy(cfg)
    train_dir = data.get("train_dir")
    val_dir = data.get("val_dir")
    data_prefix = data.get("data_prefix")
    max_steps = int((cfg.get("trainer", {}) or {}).get("max_steps", 1000))

    if strategy == "sft":
        raise NotImplementedError(
            "the SFT data module (packing, prompt templates) is not ported yet "
            "(ROADMAP queue 1 item 8)")
    if strategy in ("dpo", "orpo", "kto"):
        raise NotImplementedError(
            f"the {strategy.upper()} preference data module is not ported yet "
            f"(ROADMAP queue 1 item 14)")

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
