"""Analytic FLOPs and MFU (counterpart of the JAX package's ``utils/perf.py``,
the Llama, Mixtral and GPT accounting).

FWD FLOPs = num_layers * (attention + mlp) + the lm_head matmul; a train step
is 3 x FWD.  A Mixtral counts only the activated experts (``top_k`` SwiGLUs
a token on each MoE layer) and the router matmul, as JAX's
``flops_breakdown_for_model`` does, so its MFU means what JAX's means.  A
GPT counts its own MLP: 3 matmuls under a glu activation, 2 under plain
gelu, and with MoE layers the activated experts and the router as Mixtral.  Peaks are the cards' published dense bf16 and HBM rates; the
trainer's MFU and ``chip_smoke.py``'s kernel bounds both read them from here.

:class:`Throughput` is the JAX package's windowed sequences/s (the logged
``throughput_seqs_per_sec``, ``throughput_peak`` and the windowed ``mfu``).
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


#: the JAX package's nominal CPU peak: keeps the windowed MFU finite in CPU
#: smoke runs (it measures nothing)
CPU_PEAK_TFLOPS = 0.5


def detect_peak_tflops(device) -> float:
    """The peak TFLOP/s the logged windowed ``mfu`` divides by (JAX's
    ``detect_peak_tflops``): a CUDA device's published dense bf16 rate by
    its name (:func:`peak_tflops`; an unknown card raises), and JAX's
    nominal :data:`CPU_PEAK_TFLOPS` for the CPU."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return CPU_PEAK_TFLOPS
    name = torch.cuda.get_device_name(device)
    peak = peak_tflops(name)
    if peak is None:
        raise ValueError(f"no published bf16 peak for card {name!r} (utils/perf.py "
                         f"CARD_PEAKS)")
    return peak


class Throughput:
    """Moving-average sequences/sec with peak tracking (the JAX package's
    ``Throughput``, the reference's ``utils/utils.py:52-77``, window=10).

    ``peak`` is only recorded once the window holds at least
    ``min(window, 3)`` samples: the first one or two windows average over a
    partial history and a single fast boundary there would pin a phantom
    peak no steady-state window can ever reach again.  ``seq_len`` (when
    given) makes ``tokens_per_sec`` the source the windowed MFU derives
    from."""

    def __init__(self, batch_size: int, window: int = 10, seq_len: int = 0):
        self.batch_size = batch_size
        self.window = window
        self.seq_len = int(seq_len or 0)
        self._times: list[float] = []
        self.peak = 0.0
        self.last = 0.0
        self.total_seqs = 0

    def update(self, step_seconds: float, num_steps: int = 1) -> float:
        self._times.append(step_seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        self.total_seqs += self.batch_size * num_steps
        tput = self.batch_size * len(self._times) / sum(self._times)
        self.last = tput
        if len(self._times) >= min(self.window, 3):
            self.peak = max(self.peak, tput)
        return tput

    @property
    def tokens_per_sec(self) -> float:
        """Windowed tokens/sec (seqs/s x seq_len); 0.0 when seq_len unset."""
        return self.last * self.seq_len


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


def flops_for_model(model_cfg, seq_len: int) -> float:
    """Forward FLOPs per token of a Llama (:func:`llama_flops_per_token`)
    or a Mixtral: its attention on every layer, a dense SwiGLU on each dense
    layer, ``top_k`` SwiGLUs and the router on each MoE layer, and the
    head (JAX's ``flops_breakdown_for_model``, summed in its order)."""
    if hasattr(model_cfg, "transformer_block_type"):
        return _gpt_flops_per_token(model_cfg, seq_len)
    lc = getattr(model_cfg, "llama", None)
    if lc is None:
        return llama_flops_per_token(
            num_layers=model_cfg.num_layers, hidden_size=model_cfg.hidden_size,
            intermediate_size=model_cfg.intermediate_size,
            num_attention_heads=model_cfg.num_attention_heads,
            num_kv_heads=model_cfg.num_kv_heads, vocab_size=model_cfg.vocab_size,
            seq_len=seq_len, head_dim=model_cfg.head_dim)
    h = lc.hidden_size
    one_layer = llama_flops_per_token(
        num_layers=1, hidden_size=h, intermediate_size=0,
        num_attention_heads=lc.num_attention_heads, num_kv_heads=lc.num_kv_heads,
        vocab_size=0, seq_len=seq_len, head_dim=lc.head_dim)
    n_moe = lc.num_layers // model_cfg.moe_frequency
    swiglu = 2 * h * 3 * lc.intermediate_size
    breakdown = {
        "attention": lc.num_layers * one_layer,
        "mlp": (lc.num_layers - n_moe) * swiglu + n_moe * model_cfg.moe.top_k * swiglu,
        "router": float(n_moe * 2 * h * model_cfg.moe.num_experts),
        "head": 2.0 * h * lc.vocab_size,
    }
    return float(sum(breakdown.values()))


def _gpt_flops_per_token(gc, seq_len: int) -> float:
    """A ``models/gpt.py::GPTConfig``'s forward FLOPs per token: JAX's
    ``flops_breakdown_for_model`` GPT branch, summed in its order."""
    h = gc.hidden_size
    one_layer = llama_flops_per_token(
        num_layers=1, hidden_size=h, intermediate_size=0,
        num_attention_heads=gc.num_attention_heads, num_kv_heads=gc.kv_heads,
        vocab_size=0, seq_len=seq_len, head_dim=gc.head_size)
    mlp = 2 * h * (3 if gc.is_glu else 2) * gc.ffn_size
    head = 2.0 * h * gc.vocab_size
    if gc.moe is not None:
        n_moe = gc.num_layers // gc.moe_frequency
        breakdown = {"attention": gc.num_layers * one_layer,
                     "mlp": (gc.num_layers - n_moe) * mlp + n_moe * gc.moe.top_k * mlp,
                     "router": float(n_moe * 2 * h * gc.moe.num_experts), "head": head}
    else:
        breakdown = {"attention": gc.num_layers * one_layer,
                     "mlp": float(gc.num_layers * mlp), "router": 0.0, "head": head}
    return float(sum(breakdown.values()))


def flops_breakdown_for_model(model_cfg, seq_len: int) -> dict[str, float]:
    """Per-component forward FLOPs per token, ``{attention, mlp, router,
    head}`` (JAX's ``flops_breakdown_for_model``, its terms in its order):
    what ``autotune/cost_model.py`` prices, since each component scales
    differently under tp, cp and remat."""
    gpt_like = hasattr(model_cfg, "transformer_block_type")
    lc = model_cfg if gpt_like else getattr(model_cfg, "llama", model_cfg)
    h = lc.hidden_size
    attn = lc.num_layers * llama_flops_per_token(
        num_layers=1, hidden_size=h, intermediate_size=0,
        num_attention_heads=lc.num_attention_heads,
        num_kv_heads=lc.kv_heads if gpt_like else lc.num_kv_heads, vocab_size=0,
        seq_len=seq_len, head_dim=lc.head_size if gpt_like else lc.head_dim)
    head = 2.0 * h * lc.vocab_size
    if gpt_like:
        mlp = 2 * h * (3 if model_cfg.is_glu else 2) * model_cfg.ffn_size
    else:
        mlp = 2 * h * 3 * lc.intermediate_size
    moe = getattr(model_cfg, "moe", None)
    if moe is None or lc is model_cfg and not gpt_like:
        return {"attention": attn, "mlp": float(lc.num_layers * mlp), "router": 0.0,
                "head": head}
    from neuronx_distributed_training_torch.models import gpt, mixtral

    n_moe = (gpt if gpt_like else mixtral).num_moe_layers(model_cfg)
    return {"attention": attn,
            "mlp": (lc.num_layers - n_moe) * mlp + n_moe * moe.top_k * mlp,
            "router": float(n_moe * 2 * h * moe.num_experts), "head": head}


def train_step_flops_per_token(fwd_flops_per_token: float) -> float:
    """fwd + bwd, bwd = 2 x fwd."""
    return 3.0 * fwd_flops_per_token


def mfu(tokens_per_sec: float, flops_per_token: float, peak_tflops_per_card: float) -> float:
    """Model FLOPs utilization in [0, 1]."""
    return tokens_per_sec * flops_per_token / (peak_tflops_per_card * 1e12)
