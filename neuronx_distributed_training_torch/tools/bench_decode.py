"""KV-cached decode throughput on one card (counterpart of the JAX package's
``tools/bench_decode.py``): prefill and single-token decode steps of
``models/decode.py``, reported as decode tokens/s and prefill tokens/s.

    python -m neuronx_distributed_training_torch.tools.bench_decode \\
        [--batch 8] [--prompt-len 512] [--new-tokens 128] [--layers N] [--device cpu]

On the card: Llama-3-8B widths (h 4096, ffn 14336, 32 query and 8 kv heads
of 128, vocab 128256, tied embeddings, the flash route, the ``bf16SR``
policy) with the layer count JAX's rule gives (35% of the card's memory for
the bf16 params, at most 32: all 32 layers on an 80 GB card).  On the CPU
(``--device cpu``) a tiny fp32 Llama.  It warms up (one prefill and one
step), then times 3 prefills on fresh prompts and ``--new-tokens`` decode
steps, each run ended by a synchronize, and prints ONE JSON line with the
JAX bench's keys, ``device`` the card's name.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

H, FFN, NH, NKV, VOCAB = 4096, 14336, 32, 8, 128256
PREFILL_REPS = 3


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=128)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def card_layers(total_bytes: int) -> int:
    """JAX's rule: the layers whose bf16 params (and the tied embedding) fit
    in 35% of the card's memory, between 1 and 32."""
    per_layer = H * (NH + 2 * NKV) * (H // NH) + NH * (H // NH) * H + 3 * H * FFN
    return max(1, min(32, int((total_bytes * 0.35 / 2 - VOCAB * H) // per_layer)))


def model(args: argparse.Namespace, device):
    """``(cfg, policy, params)`` of the bench's model on ``device``."""
    import torch

    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

    if device.type == "cuda":
        layers = args.layers or card_layers(torch.cuda.get_device_properties(device).total_memory)
        cfg = llama.LlamaConfig(vocab_size=VOCAB, hidden_size=H, intermediate_size=FFN,
                                num_layers=layers, num_attention_heads=NH, num_kv_heads=NKV,
                                rope_theta=500000.0, tie_word_embeddings=True,
                                attention_impl="flash")
        policy = DtypePolicy.from_precision_config({"type": "bf16SR"})
    else:
        cfg = llama.LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=352,
                                num_layers=args.layers or 2, num_attention_heads=8,
                                num_kv_heads=4, tie_word_embeddings=True)
        policy = DtypePolicy.from_precision_config({"type": "fp32"})
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, policy, llama.init_params(cfg, policy, generator=gen, device=device)


def prompts(cfg, b: int, plen: int, seed: int, device):
    """Seeded prompt ids ``[b, plen]`` in ``[3, vocab)`` on ``device``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(3, cfg.vocab_size, (b, plen), generator=g, device=device,
                         dtype=torch.int32)


def run(args: argparse.Namespace, cfg, policy, params, device) -> dict:
    """The timed prefills and decode steps -> the JSON line's dict."""
    import torch

    from neuronx_distributed_training_torch.models import decode

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    b, plen, n = args.batch, args.prompt_len, args.new_tokens
    total = plen + n
    tok = torch.full((b,), 5, dtype=torch.int32, device=device)
    pos = torch.full((b,), plen, dtype=torch.long, device=device)
    # warm-up: the kernels' first launches, the allocator's pools
    _, cache = decode.prefill(params, prompts(cfg, b, plen, 1, device), cfg, policy,
                              max_len=total)
    decode.decode_step(params, cache, tok, pos, cfg, policy)
    sync()
    t0 = time.perf_counter()
    for r in range(PREFILL_REPS):
        _, cache = decode.prefill(params, prompts(cfg, b, plen, 100 + r, device), cfg, policy,
                                  max_len=total)
        sync()
    prefill_s = (time.perf_counter() - t0) / PREFILL_REPS
    t0 = time.perf_counter()
    for i in range(n):
        decode.decode_step(params, cache, tok, pos + i, cfg, policy)
    sync()
    decode_s = time.perf_counter() - t0
    return {
        "metric": "llama3_8B_cached_decode",
        "value": round(b * n / decode_s, 1),
        "unit": "decode_tokens_per_sec",
        "prefill_tokens_per_sec": round(b * plen / prefill_s, 1),
        "ms_per_decode_step": round(decode_s / n * 1000, 3),
        "batch": b, "prompt_len": plen, "new_tokens": n,
        "num_layers": cfg.num_layers,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "note": ("layer count scaled to the card's memory (35% for the bf16 params)"
                 if device.type == "cuda" else "a tiny fp32 Llama on the CPU"),
    }


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    from neuronx_distributed_training_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg, policy, params = model(args, device)
    out = run(args, cfg, policy, params, device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
