"""Autoregressive generation, greedy or sampled (counterpart of the JAX
package's ``models/generate.py``).

Prompts are RIGHT-padded: row ``b`` holds its prompt at ``[0,
prompt_lens[b])``, and each generated token is written at the row's own
front (``prompt_lens[b] + i``), so causal attention never sees padding and
positions are the natural ``0..L``.  :func:`generate` re-runs the whole
buffer for every token (a ``logits_of`` callable); ``models/decode.py::
generate_cached`` is the KV-cached path with the same contract.

Sampling cannot equal JAX's bits (torch cannot draw threefry's).  The
filters are JAX's (:func:`filter_logits`, equal to JAX's but where a top-p
cumulative sum ties with ``top_p`` to within rounding); the draw is
Gumbel-max on the device from a ``torch.Generator`` (:func:`sample`), a
categorical draw from the filtered softmax that reads nothing on the host.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

# logits_of: (params, input_ids [b, L]) -> logits [b, L, vocab]
LogitsFn = Callable[[Any, torch.Tensor], torch.Tensor]


def pad_prompts(prompts: list[list[int]], pad_id: int = 0):
    """Right-pad variable-length prompts -> ``(ids [b, max_len], lens [b])``,
    int32 on the CPU."""
    lens = np.asarray([len(p) for p in prompts], np.int32)
    ids = np.full((len(prompts), int(lens.max())), pad_id, np.int32)
    for i, p in enumerate(prompts):
        ids[i, : len(p)] = p
    return torch.from_numpy(ids), torch.from_numpy(lens)


def filter_logits(logits: torch.Tensor, *, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Top-k / nucleus (top-p) filtering ``[b, vocab]``: tokens not kept ->
    ``finfo(dtype).min``.  Top-k keeps the logits at or above the k-th
    largest (ties included); top-p keeps, in fp32, the smallest prefix of the
    descending distribution whose mass before a token is below ``top_p``
    (the first token always kept)."""
    neg = torch.finfo(logits.dtype).min
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p is not None and 0.0 < top_p < 1.0:
        # fp32 throughout: a bf16 cumsum over a large vocab misplaces the cutoff
        sorted_logits = torch.sort(logits.float(), dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        thresh = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits.float() < thresh, neg, logits)
    return logits


def sample(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw a row from ``softmax(logits)``: Gumbel-max,
    ``argmax(logits - log E)`` with ``E ~ Exp(1)`` drawn on the logits'
    device (no host read)."""
    e = torch.empty(logits.shape, dtype=torch.float32, device=logits.device)
    e.exponential_(generator=generator)
    return torch.argmax(logits.float() - torch.log(e), dim=-1)


def pick(logits: torch.Tensor, *, temperature: float, top_k: Optional[int],
         top_p: Optional[float], generator: Optional[torch.Generator]) -> torch.Tensor:
    """The next token a row: argmax at ``temperature`` 0, else temperature
    FIRST, then the filters (top-p on the distribution actually sampled),
    then :func:`sample`."""
    if temperature > 0:
        return sample(filter_logits(logits / temperature, top_k=top_k, top_p=top_p), generator)
    return torch.argmax(logits, dim=-1)


@torch.inference_mode()
def generate(
    params: Any,
    prompt_ids: torch.Tensor,   # [b, prompt_len] RIGHT-padded with pad_id
    prompt_lens: torch.Tensor,  # [b] true prompt lengths
    logits_of: LogitsFn,
    *,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int = 0,
    temperature: float = 0.0,  # 0 = greedy
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Generate up to ``max_new_tokens`` -> ``[b, prompt_len + max_new]`` on
    ``prompt_ids``' device.  Row ``b``'s completion occupies
    ``[prompt_lens[b], prompt_lens[b] + n)``; positions after a generated
    EOS (and the unused tail) hold ``pad_id``."""
    b, plen = prompt_ids.shape
    device = prompt_ids.device
    buf = torch.full((b, plen + max_new_tokens), pad_id, dtype=prompt_ids.dtype, device=device)
    buf[:, :plen] = prompt_ids
    done = torch.zeros(b, dtype=torch.bool, device=device)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    rows = torch.arange(b, device=device)
    lens = prompt_lens.to(device=device, dtype=torch.long)
    pad = torch.full((b,), pad_id, dtype=buf.dtype, device=device)
    for i in range(max_new_tokens):
        pos = lens + i  # [b] the next position to fill, per row
        # row b predicts from its own front: logits at position pos[b] - 1
        next_logits = logits_of(params, buf)[rows, pos - 1]
        nxt = pick(next_logits, temperature=temperature, top_k=top_k, top_p=top_p,
                   generator=generator).to(buf.dtype)
        nxt = torch.where(done, pad, nxt)
        buf[rows, pos] = nxt
        done = done | (nxt == eos_id)
    return buf
