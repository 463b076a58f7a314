"""Linear and embedding primitives (counterpart of the JAX package's
``ops/linear.py``, one device).

Weights are stored ``[in, out]`` so ``x @ w`` is the product, as in the JAX
package; the embedding table is ``[vocab, hidden]``.  Init draws a normal
truncated at two standard deviations, times ``stddev``, from an explicit
``torch.Generator``.

A linear dict may carry LoRA adapters (``peft/lora.py``): ``lora_a [in, r]``,
``lora_b [r, out]`` and ``lora_scale`` (alpha / r), and ``apply_linear`` adds
``((x @ a) @ b) * scale`` with all three cast to the output dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def apply_embedding(params, ids: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """A gather of table rows, then the cast."""
    out = F.embedding(ids.long(), params["embedding"])
    if compute_dtype is not None:
        out = out.to(compute_dtype)
    return out
