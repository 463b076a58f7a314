"""DPO: the frozen-policy reference pass and the loss function (counterpart
of the JAX package's ``alignment/dpo.py``, its pipeline hooks aside).

Before training, the frozen initial policy runs over the whole train set and
its chosen / rejected log-probs become two dataset columns
(``reference_chosen_logps``, ``reference_rejected_logps``), which the
batches then carry.  The trainer streams the pass and keeps its cursor in a
sidecar (``trainer/loop.py``).  The loss function makes two policy
forwards per microbatch, chosen then rejected, as the JAX package does.

``forward_logits(params, input_ids) -> logits`` is the policy forward
(``trainer/loop.py`` builds it from the Llama model): ``input_ids`` alone,
so no key-padding mask, positions ``0..s-1``, and the rows' right padding
comes after every real token.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from neuronx_distributed_training_torch.alignment.losses import dpo_loss, sequence_logprobs

ForwardLogits = Callable[[Any, torch.Tensor], torch.Tensor]

#: the DPO pass's columns: {column: (ids key, loss-mask key)}
DPO_SIDES = {"reference_chosen_logps": ("chosen_input_ids", "chosen_loss_mask"),
             "reference_rejected_logps": ("rejected_input_ids", "rejected_loss_mask")}


def reference_columns(params: Any, batch: dict, forward_logits: ForwardLogits,
                      sides: dict, *, tp=None,
                      micro_batch_size: Optional[int] = None) -> dict[str, np.ndarray]:
    """``{column: fp32 [rows]}``: the sequence log-probs of ``batch``'s
    ``sides`` under ``params``, with no autograd, in pieces of
    ``micro_batch_size`` rows (one piece without it), each side's forward
    in turn."""
    first = next(iter(sides.values()))[0]
    n = len(batch[first])
    step = max(1, int(micro_batch_size or n or 1))
    out: dict[str, list] = {col: [] for col in sides}
    with torch.no_grad():
        for i in range(0, n, step):
            for col, (ids_key, mask_key) in sides.items():
                ids = torch.as_tensor(batch[ids_key][i:i + step])
                mask = batch.get(mask_key)
                if mask is not None:
                    mask = torch.as_tensor(mask[i:i + step])
                logps = sequence_logprobs(forward_logits(params, ids), ids, mask, tp=tp)
                out[col].append(logps.cpu().numpy())
    return {col: (np.concatenate(v) if v else np.zeros((0,), np.float32)).astype(np.float32)
            for col, v in out.items()}


def compute_reference_logprobs(params: Any, batches: Iterable[dict],
                               forward_logits: ForwardLogits, **kw) -> dict[str, np.ndarray]:
    """Frozen-policy chosen / rejected log-probs over ``batches``, in order
    (``kw``: those of :func:`reference_columns`)."""
    parts = [reference_columns(params, b, forward_logits, DPO_SIDES, **kw) for b in batches]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def make_dpo_loss_fn(forward_logits: ForwardLogits, *, beta: float = 0.1, tp=None, dp=None):
    """``loss_fn(params, batch, denominator=None) -> (loss, metrics)`` over
    DPO batches: ``chosen_input_ids`` / ``rejected_input_ids``, their loss
    masks, and the two reference columns."""

    def loss_fn(params, batch, denominator=None):
        pc = sequence_logprobs(forward_logits(params, batch["chosen_input_ids"]),
                               batch["chosen_input_ids"], batch.get("chosen_loss_mask"), tp=tp)
        pr = sequence_logprobs(forward_logits(params, batch["rejected_input_ids"]),
                               batch["rejected_input_ids"], batch.get("rejected_loss_mask"),
                               tp=tp)
        return dpo_loss(pc, pr, batch["reference_chosen_logps"],
                        batch["reference_rejected_logps"], beta=beta,
                        denominator=denominator, dp=dp)

    return loss_fn
