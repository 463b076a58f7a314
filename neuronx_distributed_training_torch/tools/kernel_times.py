"""Times of the three flash kernels at the main-path shape, on the card.

    python -m neuronx_distributed_training_torch.tools.kernel_times [--label NAME]

    # the kernels of another checkout (an A/B of two commits on one card, in turns):
    PYTHONPATH=<checkout> python <this file> --label parent

The main-path shape is Llama-3-8B attention at seq 8192 (b=1, nh=32, nkv=8,
d=128, causal, bf16).  Each kernel is timed with CUDA events over ``ITERS``
launches after one warm-up launch.  ``chip_smoke.py`` phase 3 times the
kernels with these same functions.  Prints one JSON line: the label, the
card's name, and ms per call of ``flash_fwd``, ``flash_dq`` and
``flash_dkv``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import torch

from neuronx_distributed_training_torch.ops import flash_attention as fa

MAIN = dict(b=1, s=8192, nh=32, nkv=8, d=128)  # Llama-3-8B attention, seq 8192
MAIN_SEED = 11
ITERS = 10  # timed launches of each kernel


def cuda_ms(fn, iters: int = ITERS) -> float:
    """ms per call of ``fn`` by CUDA events, over ``iters`` calls after one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def randn_bf16(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(
        torch.bfloat16)


@torch.no_grad()
def main_path_tensors():
    """q, k, v, do at the main-path shape from ``MAIN_SEED``, with the
    kernel forward's o and lse and the backward's delta = rowsum(do * o)."""
    b, s, nh, nkv, d = (MAIN[k] for k in ("b", "s", "nh", "nkv", "d"))
    gen = torch.Generator(device="cuda").manual_seed(MAIN_SEED)
    q, k, v, do = (randn_bf16(gen, b, s, h, d) for h in (nh, nkv, nkv, nh))
    o, lse = fa.flash_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, o, lse, delta


@torch.no_grad()
def kernel_ms(q, k, v, do, lse, delta) -> dict:
    """ms per call of each flash kernel on these (causal) inputs."""
    return {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v)),
        "flash_dq": cuda_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta)),
        "flash_dkv": cuda_ms(lambda: fa.flash_dkv(q, k, v, do, lse, delta)),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA card")
    q, k, v, do, _, lse, delta = main_path_tensors()
    out = {"label": args.label, "card": torch.cuda.get_device_name(0)}
    out.update({f"{name}_ms": ms for name, ms in kernel_ms(q, k, v, do, lse, delta).items()})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
