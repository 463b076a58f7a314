"""Analytic FLOPs and MFU (counterpart of the JAX package's ``utils/perf.py``,
Llama accounting only).

FWD FLOPs = num_layers * (attention + mlp) + the lm_head matmul; a train step
is 3 x FWD.  Peaks are the cards' published dense bf16 and HBM rates; the
trainer's MFU and ``chip_smoke.py``'s kernel bounds both read them from here.
"""

from __future__ import annotations

from typing import Optional

#: (dense bf16 FLOP/s, HBM bytes/s) by device-name substring, first match wins
#: (NVIDIA data sheets; the plain "H100" entry is the SXM part)
CARD_PEAKS = {
    "H100 PCIe": (756e12, 2.0e12),
    "H100 NVL": (835e12, 3.9e12),
    "H100": (989e12, 3.35e12),
    "H200": (989e12, 4.8e12),
}


def card_peaks(device_name: str) -> Optional[tuple[float, float]]:
    """Published (bf16 FLOP/s, HBM bytes/s) of a card by its name; None when unknown."""
    for key, peaks in CARD_PEAKS.items():
        if key in device_name:
            return peaks
    return None


def peak_tflops(device_name: str) -> Optional[float]:
    """Published dense bf16 TFLOP/s of a card by its name; None when unknown."""
    peaks = card_peaks(device_name)
    return None if peaks is None else peaks[0] / 1e12


def llama_flops_per_token(
    *,
    num_layers: int,
    hidden_size: int,
    intermediate_size: int,
    num_attention_heads: int,
    num_kv_heads: int | None,
    vocab_size: int,
    seq_len: int,
    head_dim: int | None = None,
    include_causal_half: bool = True,
) -> float:
    """Forward FLOPs per token of a Llama-style decoder: qkv and o
    projections, the score/context matmuls (halved under causal masking),
    the SwiGLU MLP, and the lm_head matmul."""
    h = hidden_size
    d = head_dim or h // num_attention_heads
    nh = num_attention_heads
    nkv = num_kv_heads or nh
    s = seq_len
    qkv = 2 * h * (nh + 2 * nkv) * d
    o = 2 * nh * d * h
    attn_scores = 2 * s * nh * d
    attn_context = 2 * s * nh * d
    if include_causal_half:
        attn_scores /= 2
        attn_context /= 2
    mlp = 2 * h * (3 * intermediate_size)
    per_layer = qkv + o + attn_scores + attn_context + mlp
    logits = 2 * h * vocab_size
    return num_layers * per_layer + logits


def train_step_flops_per_token(fwd_flops_per_token: float) -> float:
    """fwd + bwd, bwd = 2 x fwd."""
    return 3.0 * fwd_flops_per_token


def mfu(tokens_per_sec: float, flops_per_token: float, peak_tflops_per_card: float) -> float:
    """Model FLOPs utilization in [0, 1]."""
    return tokens_per_sec * flops_per_token / (peak_tflops_per_card * 1e12)
