"""Linear and embedding primitives (counterpart of the JAX package's
``ops/linear.py``).

Weights are stored ``[in, out]`` so ``x @ w`` is the product, as in the JAX
package; the embedding table is ``[vocab, hidden]``.  Init draws a normal
truncated at two standard deviations, times ``stddev``, from an explicit
``torch.Generator``.

A linear dict may carry LoRA adapters (``peft/lora.py``): ``lora_a [in, r]``,
``lora_b [r, out]`` and ``lora_scale`` (alpha / r), and ``apply_linear`` adds
``((x @ a) @ b) * scale`` with all three cast to the output dtype.

Tensor parallelism (``parallel/tensor_parallel.py``, ``parallel/
sharding.py``): a column layer's ``w`` holds the rank's output columns and is
applied to the gathered (or replicated) input, a row layer's ``w`` holds the
rank's input rows and gives a partial sum, which the caller reduces
(``tensor_parallel.leave_row``).  ``apply_linear`` is the same local product
for both: under LoRA a column layer's ``lora_b`` holds its output columns
(``lora_a`` replicated), a row layer's ``lora_a`` its input rows (``lora_b``
replicated), so the rank's adapter term is its part of the same sum, and the
row layer's reduce carries it with no extra collective.
:func:`apply_embedding` with ``tp`` is the vocab-parallel embedding.

A linear dict may also carry a ``bias [out]`` (Megatron's biased linears,
``init_linear(use_bias=True)``, zeros).  :func:`apply_linear` adds it after
the LoRA term, as JAX's does: a column layer's bias holds the rank's output
columns, as its ``w``.  A row layer's bias is replicated and added once,
after the reduce over tp (:func:`apply_row_linear`), on the rank's sequence
slice under sequence parallelism, where its gradient is then a partial sum
over tp, as the norms' are.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from neuronx_distributed_training_torch.parallel import tensor_parallel as tp_ops


def _normal_init(gen: torch.Generator, shape, dtype, stddev: float, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (t.mul_(stddev)).to(dtype)


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int, *, dtype=torch.float32,
                stddev: float = 0.02, device=None, use_bias: bool = False):
    out = {"w": _normal_init(gen, (in_dim, out_dim), dtype, stddev, device)}
    if use_bias:
        out["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return out


class WeightGradSplit:
    """The zero-bubble schedule's split of a backward (``parallel/
    pipeline.py``, ``1f1b-zb``).  A forward run under
    :func:`split_weight_grads` records each ``x @ w`` of
    :func:`apply_linear`: the leaf ``w`` joins ``leaves``, and a hook on
    the product hands its cotangent ``dy``, with ``x``, to ``sink`` when a
    backward reaches it.  A backward that asks autograd for the stage input
    and the other leaves alone (autograd then skips each ``x^T dy``) thus
    computes the activation gradients and queues ``(w, x, dy)``;
    :func:`weight_grad` later gives ``w``'s gradient from them, the same
    product autograd takes."""

    def __init__(self):
        self.leaves: set = set()
        self.sink: Optional[list] = None

    def watch(self, w: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
        """Record ``y = x @ w``; ``w`` is a leaf, or its compute-dtype copy
        (``DtypePolicy.cast_to_compute``), whose leaf is then watched."""
        if not (y.requires_grad and w.requires_grad):
            return
        leaf = w
        if w.grad_fn is not None:  # the cast: ToCopyBackward -> AccumulateGrad(leaf)
            leaf = getattr(w.grad_fn.next_functions[0][0], "variable", None)
            if leaf is None:
                raise RuntimeError(f"a split weight gradient needs a leaf or its cast, not "
                                   f"the output of {w.grad_fn.name()}")
        self.leaves.add(id(leaf))

        def hook(dy):
            if self.sink is None:
                raise RuntimeError("a split weight gradient reached no sink: run the "
                                   "backward with WeightGradSplit.sink set")
            self.sink.append((leaf, x, dy))

        y.register_hook(hook)


_SPLIT: Optional[WeightGradSplit] = None


@contextlib.contextmanager
def split_weight_grads(split: WeightGradSplit):
    """Record the forwards inside on ``split`` (see :class:`WeightGradSplit`)."""
    global _SPLIT
    prev, _SPLIT = _SPLIT, split
    try:
        yield split
    finally:
        _SPLIT = prev


def weight_grad(leaf: torch.Tensor, x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gradient of ``leaf`` in ``y = x @ leaf.to(x.dtype)`` from the
    cotangent ``dy``: ``matmul``'s own folded product ``x2^T dy2`` (its
    backward's, for a row-major weight), cast to the leaf's dtype as the
    cast's backward does."""
    x2 = x.reshape(-1, x.shape[-1])
    return x2.t().mm(dy.reshape(-1, dy.shape[-1])).to(leaf.dtype)


def apply_linear(params, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    w = params["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if _SPLIT is not None and torch.is_grad_enabled():
        _SPLIT.watch(w, x, y)
    if "lora_a" in params:
        a = params["lora_a"].to(y.dtype)
        b = params["lora_b"].to(y.dtype)
        y = y + ((x @ a) @ b) * params["lora_scale"].to(y.dtype)
    if "bias" in params:
        b = params["bias"]
        y = y + (b.to(y.dtype) if compute_dtype is not None else b)
    return y


def apply_row_linear(params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """A row-parallel layer: the rank's partial product, its reduce over tp
    (``tensor_parallel.leave_row``: the rank's sequence slice under SP), then
    the replicated bias, once."""
    y = tp_ops.leave_row(apply_linear({k: v for k, v in params.items() if k != "bias"}, x), tp)
    return y + params["bias"] if "bias" in params else y


def init_embedding(gen: torch.Generator, vocab_size: int, hidden: int, *,
                   dtype=torch.float32, stddev: float = 0.02, device=None):
    return {"embedding": _normal_init(gen, (vocab_size, hidden), dtype, stddev, device)}


def apply_embedding(params, ids: torch.Tensor, *, compute_dtype=None, tp=None) -> torch.Tensor:
    """A gather of table rows, then the cast.

    With ``tp`` (``parallel/mesh.py::TensorParallel``) the table holds the
    rank's ``rows`` of the vocab, ``[rank * rows, (rank + 1) * rows)`` (``rows
    = ceil(V/tp)``, zero-padded past the vocab, where no id lands): ids
    outside them gather row 0 and are zeroed, then the ranks' outputs are
    summed (all-reduce), or, under sequence parallelism, reduce-scattered
    along the sequence.  Each element has one non-zero term, so the sum is
    exact in any dtype and the cast may come first."""
    table = params["embedding"]
    if not tp_ops.active(tp):
        out = F.embedding(ids.long(), table)
        return out if compute_dtype is None else out.to(compute_dtype)
    rows = table.shape[0]
    local = ids.long() - tp.rank * rows
    outside = (local < 0) | (local >= rows)
    out = F.embedding(local.masked_fill(outside, 0), table)
    out = out.masked_fill(outside[..., None], 0.0)
    if compute_dtype is not None:
        out = out.to(compute_dtype)
    return tp_ops.leave_row(out, tp)


def pad_vocab_size(vocab_size: int, make_divisible_by: int, tp: int) -> int:
    """Pad vocab so it divides evenly across TP shards — the reference's
    ``make_vocab_size_divisible_by * tp`` padding (``data/base.py:66-89``).
    Neither trainer calls it: the port pads each rank's slice to
    ``pad_vocab_size(V, 1, tp) / tp`` rows inside the leaf's layout
    (``parallel/sharding.py``), so configs and checkpoints keep the vocab."""
    multiple = make_divisible_by * tp
    return ((vocab_size + multiple - 1) // multiple) * multiple
