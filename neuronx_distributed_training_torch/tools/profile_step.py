"""Where a training step's device time goes, by kernel (torch.profiler).

    python -m neuronx_distributed_training_torch.tools.profile_step \\
        --config examples/conf/hf_llama3_8B_config.yaml [--set key=value ...] [--top 15]

Builds the trainer as the CLI does, runs one step to warm up, then profiles one
step on the card and prints: the step's wall seconds, the summed device time of
all kernels and its share of the wall time (the device's busy share; overlap
between streams would count twice, and this path runs on one stream), the
device time of the port's three flash kernels, and the top kernels by device
time.
"""

from __future__ import annotations

import argparse
import time

import torch

from neuronx_distributed_training_torch.config.loader import load_config
from neuronx_distributed_training_torch.trainer.cli import parse_overrides
from neuronx_distributed_training_torch.trainer.loop import Trainer

FLASH_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")
#: kernel-name substrings -> category of the breakdown (first match wins)
CATEGORIES = (("flash attention", FLASH_KERNELS),
              ("matmul", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
              ("elementwise / reduction / copy", ("",)))


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--set", dest="overrides", action="append", default=[])
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    cfg = load_config(args.config, {**parse_overrides(args.overrides), "trainer.max_steps": 2})
    trainer = Trainer.from_config(cfg, enable_checkpointing=False)  # steps only, no fit
    batches = trainer.data_module.global_batches()

    def step():
        batch = {k: torch.as_tensor(v).to(trainer.device) for k, v in next(batches).items()}
        metrics = trainer.train_step(trainer.params, trainer.opt_state, batch)
        return {k: float(v) for k, v in metrics.items()}

    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: CPU-side ops also report the device time of the
    # kernels they launch and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    events.sort(key=_device_us, reverse=True)
    total_us = sum(_device_us(e) for e in events)
    flash_us = {k: sum(_device_us(e) for e in events if k in e.key) for k in FLASH_KERNELS}
    print(f"profiled step: wall {wall:.3f} s, device kernels {total_us / 1e6:.3f} s "
          f"(busy share {total_us / 1e6 / wall:.3f}) [{torch.cuda.get_device_name(0)}]")
    for k, us in flash_us.items():
        print(f"  {k}: {us / 1e3:.1f} ms ({us / max(total_us, 1.0):.3f} of device time)")
    cats = {name: 0.0 for name, _ in CATEGORIES}
    for e in events:
        name = next(n for n, keys in CATEGORIES if any(k in e.key for k in keys))
        cats[name] += _device_us(e)
    for name, us in cats.items():
        print(f"  {name}: {us / 1e3:.1f} ms ({us / max(total_us, 1.0):.3f} of device time)")
    print(f"top {args.top} kernels by device time:")
    for e in events[:args.top]:
        print(f"  {_device_us(e) / 1e3:10.1f} ms  {e.count:5d} calls  {e.key[:110]}")
    return {"wall_s": wall, "device_s": total_us / 1e6,
            "flash_ms": {k: v / 1e3 for k, v in flash_us.items()},
            "category_ms": {k: v / 1e3 for k, v in cats.items()}}


if __name__ == "__main__":
    main()
