"""DPO: the frozen-policy reference pass and the loss function (counterpart
of the JAX package's ``alignment/dpo.py``, its pipeline hooks aside).

Before training, the frozen initial policy runs over the whole train set and
its chosen / rejected log-probs become two dataset columns
(``reference_chosen_logps``, ``reference_rejected_logps``), which the
batches then carry.  The trainer streams the pass and keeps its cursor in a
sidecar (``trainer/loop.py``).  The loss function makes two policy
forwards per microbatch, chosen then rejected, as the JAX package does.

``forward_logits(params, input_ids[, positions]) -> logits`` is the policy
forward (``trainer/loop.py`` builds it from the Llama model): ``input_ids``
alone, so no key-padding mask, positions ``0..s-1``, and the rows' right
padding comes after every real token.  Under context parallelism (``cp``)
the loss function and the pass take each batch's context slices
(``data/loader.py::context_parallel_batch``) and the positions come with
them; the sequence log-probs are summed over the context group
(``alignment/losses.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from neuronx_distributed_training_torch.alignment.losses import count_once, dpo_loss, side_logprobs
from neuronx_distributed_training_torch.data.loader import PREFERENCE_SIDES, context_parallel_batch

ForwardLogits = Callable[[Any, torch.Tensor], torch.Tensor]

#: the DPO pass's columns: {column: (ids key, loss-mask key)}
DPO_SIDES = {"reference_chosen_logps": ("chosen_input_ids", "chosen_loss_mask"),
             "reference_rejected_logps": ("rejected_input_ids", "rejected_loss_mask")}


def reference_columns(params: Any, batch: dict, forward_logits: ForwardLogits,
                      sides: dict, *, tp=None, cp=None,
                      micro_batch_size: Optional[int] = None) -> dict[str, np.ndarray]:
    """``{column: fp32 [rows]}``: the sequence log-probs of ``batch``'s
    ``sides`` under ``params``, with no autograd, in pieces of
    ``micro_batch_size`` rows (one piece without it), each side's forward
    in turn; under ``cp`` each piece's context slices, the log-probs summed
    over the context group, so every context rank gets every column."""
    first = next(iter(sides.values()))[0]
    n = len(batch[first])
    step = max(1, int(micro_batch_size or n or 1))
    keys = [k for pair in sides.values() for k in pair if k in batch]
    out: dict[str, list] = {col: [] for col in sides}
    with torch.no_grad():
        for i in range(0, n, step):
            piece = {k: torch.as_tensor(batch[k][i:i + step]) for k in keys}
            if cp is not None:
                piece = context_parallel_batch(piece, cp.rank, cp.size, sides=PREFERENCE_SIDES)
            for col, (ids_key, _) in sides.items():
                side = ids_key[:-len("input_ids")]
                logps = side_logprobs(forward_logits, params, piece, side, tp=tp, cp=cp)
                out[col].append(logps.cpu().numpy())
    return {col: (np.concatenate(v) if v else np.zeros((0,), np.float32)).astype(np.float32)
            for col, v in out.items()}


def compute_reference_logprobs(params: Any, batches: Iterable[dict],
                               forward_logits: ForwardLogits, **kw) -> dict[str, np.ndarray]:
    """Frozen-policy chosen / rejected log-probs over ``batches``, in order
    (``kw``: those of :func:`reference_columns`)."""
    parts = [reference_columns(params, b, forward_logits, DPO_SIDES, **kw) for b in batches]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def make_dpo_loss_fn(forward_logits: ForwardLogits, *, beta: float = 0.1, tp=None, dp=None,
                     cp=None):
    """``loss_fn(params, batch, denominator=None) -> (loss, metrics)`` over
    DPO batches: ``chosen_input_ids`` / ``rejected_input_ids``, their loss
    masks, and the two reference columns (a context rank's slices under
    ``cp``)."""

    def loss_fn(params, batch, denominator=None):
        pc = side_logprobs(forward_logits, params, batch, "chosen_", tp=tp, cp=cp)
        pr = side_logprobs(forward_logits, params, batch, "rejected_", tp=tp, cp=cp)
        loss, metrics = dpo_loss(pc, pr, batch["reference_chosen_logps"],
                                 batch["reference_rejected_logps"], beta=beta,
                                 denominator=denominator, dp=dp)
        return count_once(loss, cp), metrics

    return loss_fn
