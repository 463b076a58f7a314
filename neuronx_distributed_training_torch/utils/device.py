"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU; without a
card they raise instead of carrying on on the CPU.  Under a process group
the card is ``cuda:LOCAL_RANK`` (one card per process).  TF32 is switched off
for matrix products and convolutions: the JAX reference computes fp32
products in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """``None`` means the card (``cuda``, or ``cuda:LOCAL_RANK`` under a
    process group); ``"cpu"`` must be asked for."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU explicitly"
        )
    if device is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            # utils/launch.py set this process's card (its local rank)
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
