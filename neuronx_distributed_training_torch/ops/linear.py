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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neuronx_distributed_training_torch.parallel import tensor_parallel as tp_ops


def _normal_init(gen: torch.Generator, shape, dtype, stddev: float, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (t.mul_(stddev)).to(dtype)


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int, *, dtype=torch.float32,
                stddev: float = 0.02, device=None):
    return {"w": _normal_init(gen, (in_dim, out_dim), dtype, stddev, device)}


def apply_linear(params, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    w = params["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "lora_a" in params:
        a = params["lora_a"].to(y.dtype)
        b = params["lora_b"].to(y.dtype)
        y = y + ((x @ a) @ b) * params["lora_scale"].to(y.dtype)
    return y


def init_embedding(gen: torch.Generator, vocab_size: int, hidden: int, *,
                   dtype=torch.float32, stddev: float = 0.02, device=None):
    return {"embedding": _normal_init(gen, (vocab_size, hidden), dtype, stddev, device)}


def apply_embedding(params, ids: torch.Tensor, *, compute_dtype=None, tp=None) -> torch.Tensor:
    """A gather of table rows, then the cast.

    With ``tp`` (``parallel/mesh.py::TensorParallel``) the table holds the
    rank's rows of the vocab, ``[rank * V/tp, (rank + 1) * V/tp)``: ids
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
    Neither the JAX trainer nor the port calls it: the trainer rejects a
    vocab that tp does not divide."""
    multiple = make_divisible_by * tp
    return ((vocab_size + multiple - 1) // multiple) * multiple
