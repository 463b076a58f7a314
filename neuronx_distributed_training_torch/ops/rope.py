"""Rotary position embeddings (counterpart of the JAX package's ``ops/rope.py``).

Inverse frequencies are computed in fp64 on the host, then applied in fp32 with
the HF half-rotation layout.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(
    head_dim: int,
    *,
    theta: float = 10000.0,
    position_interpolation_factor: float | None = None,
    abf_scale: float | None = None,
) -> np.ndarray:
    """Inverse frequencies ``[head_dim/2]`` in fp64 (host-side)."""
    base = float(theta)
    if abf_scale is not None:
        base = base * abf_scale
    exponent = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
    inv_freq = 1.0 / (base**exponent)
    if position_interpolation_factor:
        inv_freq = inv_freq / float(position_interpolation_factor)
    return inv_freq


def rope_cos_sin(positions: torch.Tensor, inv_freq: np.ndarray, *, dtype=torch.float32):
    """cos/sin tables for ``positions`` ([batch, seq] or [seq]):
    ``[..., seq, head_dim/2]``."""
    freq = torch.as_tensor(inv_freq.astype(np.float32), device=positions.device)
    angles = positions.float()[..., None] * freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x: [batch, seq, heads, head_dim]``; cos/sin are
    ``[batch, seq, head_dim/2]`` or ``[seq, head_dim/2]``."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    if cos.ndim == 2:
        cos_b, sin_b = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]
    out1 = x1 * cos_b - x2 * sin_b
    out2 = x2 * cos_b + x1 * sin_b
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
