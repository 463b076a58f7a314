"""RMSNorm with fp32 internals whatever the compute dtype (counterpart of the
JAX package's ``ops/norm.py``)."""

from __future__ import annotations

import torch


def init_rms_norm(hidden: int, *, dtype=torch.float32, device=None):
    return {"scale": torch.ones((hidden,), dtype=dtype, device=device)}


def apply_rms_norm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * params["scale"].float()).to(x.dtype)
