"""RMSNorm and LayerNorm with fp32 internals whatever the compute dtype
(counterpart of the JAX package's ``ops/norm.py``): the statistics, the
scale and the bias are taken in fp32 and the result is cast back to the
input's dtype."""

from __future__ import annotations

import torch


def init_rms_norm(hidden: int, *, dtype=torch.float32, device=None):
    return {"scale": torch.ones((hidden,), dtype=dtype, device=device)}


def apply_rms_norm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * params["scale"].float()).to(x.dtype)


def init_layer_norm(hidden: int, *, dtype=torch.float32, device=None):
    return {"scale": torch.ones((hidden,), dtype=dtype, device=device),
            "bias": torch.zeros((hidden,), dtype=dtype, device=device)}


def apply_layer_norm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * params["scale"].float() + params["bias"].float()).to(x.dtype)
