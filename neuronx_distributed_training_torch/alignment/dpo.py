"""DPO: the frozen-policy reference pass, the loss function and the
pipeline hooks of DPO and ORPO (counterpart of the JAX package's
``alignment/dpo.py``).

Before training, the frozen initial policy runs over the whole train set and
its chosen / rejected log-probs become two dataset columns
(``reference_chosen_logps``, ``reference_rejected_logps``), which the
batches then carry.  The trainer streams the pass and keeps its cursor in a
sidecar (``trainer/loop.py``).  The loss function makes two policy
forwards per microbatch, chosen then rejected, as the JAX package does.

``forward_logits(params, input_ids[, positions]) -> logits`` is the policy
forward (``trainer/loop.py`` builds it from the model; a Mixtral's returns
``(logits, reg)``, its router-loss share, which the losses add as
``0.5 (reg_chosen + reg_rejected)``, JAX's ``reg``): ``input_ids``
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

from neuronx_distributed_training_torch.alignment.losses import (
    count_once,
    dpo_loss,
    orpo_loss,
    sequence_logprobs,
    side_logprobs,
)
from neuronx_distributed_training_torch.data.loader import PREFERENCE_SIDES, context_parallel_batch

ForwardLogits = Callable[[Any, torch.Tensor], torch.Tensor]

#: the offset of a rejected row's index in the concatenated forward's
#: dropout rows (past any microbatch's chosen rows)
REJECTED_ROWS = 1 << 32

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
    """``loss_fn(params, batch, denominator=None, key=None) -> (loss,
    metrics)`` over DPO batches: ``chosen_input_ids`` /
    ``rejected_input_ids``, their loss masks, and the two reference columns
    (a context rank's slices under ``cp``).  A dropout ``key`` gives each
    side its own fold (JAX splits it in two)."""

    def loss_fn(params, batch, denominator=None, key=None):
        kc, kr = (None, None) if key is None else (key.fold(0), key.fold(1))
        pc, reg_c = side_logprobs(forward_logits, params, batch, "chosen_", tp=tp, cp=cp,
                                  with_reg=True, key=kc)
        pr, reg_r = side_logprobs(forward_logits, params, batch, "rejected_", tp=tp, cp=cp,
                                  with_reg=True, key=kr)
        loss, metrics = dpo_loss(pc, pr, batch["reference_chosen_logps"],
                                 batch["reference_rejected_logps"], beta=beta,
                                 denominator=denominator, dp=dp)
        # a MoE model's router balance rides along (already a rank's share)
        return count_once(loss, cp) + 0.5 * (reg_c + reg_r), metrics

    return loss_fn


def pipeline_side_logprobs(logits, mb: dict, side: str, *, average: bool = False, tp=None,
                           cp=None) -> torch.Tensor:
    """:func:`side_logprobs` from logits the pipeline's last stage made:
    ``side``'s ids (and loss mask) of the microbatch ``mb``; under ``cp``
    its targets, the context sum taken."""
    if cp is None:
        return sequence_logprobs(logits, mb[side + "input_ids"], mb.get(side + "loss_mask"),
                                 average=average, tp=tp)
    return sequence_logprobs(logits, mb[side + "labels"], mb.get(side + "loss_mask"),
                             shift=False, average=average, tp=tp, cp=cp)


def preference_pipeline_hooks(hooks, head_fn: Callable, *, mode: str = "dpo",
                              beta: float = 0.1, tp=None, cp=None) -> tuple:
    """The model's pipeline hooks (``models/llama.py::pipeline_hooks``) for
    DPO / ORPO under pipeline parallelism, the JAX package's
    ``preference_pipeline_hooks``: the "concatenated forward" (chosen and
    rejected stacked along the batch, so the pipelined model runs once a
    microbatch); the loss hook splits the final hidden states, takes each
    side's sequence log-probs through ``head_fn(params, y) -> logits`` (the
    final norm and the head) and the preference loss.  The ``(loss_sum,
    count)`` contract is weighted by pairs: the sum over the microbatch's
    pairs (the rank's rows under data parallelism), and their count.  Under
    ``cp`` each side is the context rank's slice
    (``data/loader.py::context_parallel_batch`` with its ``sides``), the
    log-probs are summed over the context group, and the loss counts once
    (``alignment/losses.py::count_once``)."""
    embed_fn, stage_fn, _, act_shape = hooks

    def cat(mb):
        ids = torch.cat([mb["chosen_input_ids"], mb["rejected_input_ids"]], dim=0)
        out = {"input_ids": ids}
        if cp is not None:
            out["positions"] = torch.cat([mb["chosen_positions"], mb["rejected_positions"]],
                                         dim=0)
        for k in ("_chunk", "_pipe"):
            if k in mb:
                out[k] = mb[k]
        if "_rng" in mb:
            # the rejected rows draw their own masks: their indices moved
            # past every chosen row's
            key = mb["_rng"]
            rows = key.rows or tuple(range(mb["chosen_input_ids"].shape[0]))
            out["_rng"] = key.with_rows(rows + tuple(r + REJECTED_ROWS for r in rows))
        return out

    def loss2(params, y, mb):
        logits = head_fn(params, y)
        b = mb["chosen_input_ids"].shape[0]
        avg = mode == "orpo"
        pc = pipeline_side_logprobs(logits[:b], mb, "chosen_", average=avg, tp=tp, cp=cp)
        pr = pipeline_side_logprobs(logits[b:], mb, "rejected_", average=avg, tp=tp, cp=cp)
        one = torch.ones((), dtype=torch.float32, device=pc.device)
        if mode == "dpo":
            loss, _ = dpo_loss(pc, pr, mb["reference_chosen_logps"],
                               mb["reference_rejected_logps"], beta=beta, denominator=one)
        else:
            loss, _ = orpo_loss(pc, pr, -pc.sum(), beta=beta, denominator=one)
        return count_once(loss, cp), torch.tensor(float(b), device=pc.device)

    return (lambda params, mb: embed_fn(params, cat(mb)),
            lambda layers, x, mb: stage_fn(layers, x, cat(mb)),
            loss2,
            lambda mb: act_shape(cat(mb)))
