"""KV-cached autoregressive decoding for Llama, Mistral, Mixtral and Megatron
GPT (counterpart of the JAX package's ``models/decode.py``).

- ``prefill`` (and JAX's names ``prefill_mixtral``, ``prefill_gpt``): one
  causal forward over the right-padded prompts through the model's own
  layers, whose ``attend`` hook writes each layer's rotated keys and values
  into a preallocated cache ``{"k", "v"}: [L, b, max_len, nkv, d]`` in the compute
  dtype whose tail past the prompt stays zero.  It returns the final-normed
  hidden states, not the logits.  On the flash route every layer launches
  the forward kernel once; a prompt length that does not tile falls back to
  core attention, counted in ``ops/flash_attention.py::FALLBACKS``, as in
  training and in the JAX package.
- ``decode_step`` (and ``decode_step_mixtral``, ``decode_step_gpt``): one
  token a row through the same layers with the attention replaced (the same
  hook) by :func:`_cached_attn`, which writes the row's k and v at
  ``pos[row]`` into the cache in place and attends over ``<= pos[row]``.
  Every dense layer at every ``moe_frequency`` and each of GPT's four block
  layouts is the training layer itself; the cache is one flat ``[L, ...]``
  cache whatever the MoE interleave.
- ``generate_cached``: ``models/generate.py::generate``'s contract (right-
  padded prompts, each row writing at its own front, ``pad_id`` after EOS):
  the first token from the prefill's logits at each row's last prompt
  position (only that position's logits are made), then exactly
  ``max_new_tokens - 1`` decode steps.

The cached attention has no Pallas counterpart (it is plain ``jnp`` in JAX)
and runs as torch ops here.  JAX's ``jnp.repeat`` of the cache to the query
heads is a grouped view: q ``[b, nkv, g, d]`` against k ``[b, nkv, L, d]``,
the same function without a copy of the cache a group.

The decode loop reads nothing on the host: no early exit on ``done``, the
sampling on the device (``models/generate.py::sample``).  The only syncs are
dropless MoE's in ``ops/moe.py`` (its group sizes' ``tolist`` and the
``bincount`` calls of the sizes and the router statistics, each of which
reads the card: 5 a MoE layer and step on an H100).
Prefill and decode run under ``torch.inference_mode``; a prefill's cache
is written in place by the decode steps that follow it.

Dropped (capacity-factor) MoE is refused: its capacity is computed over the
current batch, so a b-token decode step would drop routes that the full
forward keeps.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch

from neuronx_distributed_training_torch.models import generate as gen
from neuronx_distributed_training_torch.models import gpt, llama, mixtral
from neuronx_distributed_training_torch.ops import linear as linear_ops
from neuronx_distributed_training_torch.ops import moe as moe_ops
from neuronx_distributed_training_torch.ops import norm as norm_ops
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

_DROPPED = "cached decode with dropped (capacity-factor) MoE; use dropless"


def _cached_attn(q, k_new, v_new, ck, cv, pos, *, sliding_window, softmax_dtype):
    """Write this step's k and v at ``pos`` per row (in place), attend q
    over the cache's keys ``<= pos`` (and ``> pos - window``).

    q / k_new / v_new ``[b, 1, heads, d]``; ck / cv ``[b, max_len, nkv, d]``
    (one layer's views of the cache).  Returns ``[b, 1, nh, d]`` in q's
    dtype.  JAX's rounding: scores in ``softmax_dtype`` scaled by 1/sqrt(d),
    masked with ``finfo(softmax_dtype).min / 2``, probs cast to v's dtype
    before P V."""
    b, _, nh, d = q.shape
    max_len, nkv = ck.shape[1], ck.shape[2]
    rows = torch.arange(b, device=q.device)
    ck[rows, pos] = k_new[:, 0].to(ck.dtype)
    cv[rows, pos] = v_new[:, 0].to(cv.dtype)
    g = nh // nkv
    qg = q.reshape(b, nkv, g, d).to(softmax_dtype)  # head i uses kv head i // g
    scores = torch.matmul(qg, ck.permute(0, 2, 3, 1).to(softmax_dtype)) * (1.0 / (d ** 0.5))
    keys = torch.arange(max_len, device=q.device)[None, :]
    valid = keys <= pos[:, None]
    if sliding_window is not None:
        valid = valid & (keys > pos[:, None] - sliding_window)
    neg = torch.finfo(softmax_dtype).min / 2
    scores = torch.where(valid[:, None, None, :], scores, neg)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(cv.dtype), cv.permute(0, 2, 1, 3))  # [b, nkv, g, d]
    return out.reshape(b, 1, nh, d).to(q.dtype)


class _Family(NamedTuple):
    """What prefill and decode need of a model family."""

    cfg: Any          # the config with the heads, the window and the head's tie
    embed: Callable   # (params, ids [b, s], positions [b, s], policy) -> x
    rope: Callable    # positions -> (cos, sin)
    layer: Callable   # (lp, x, cos, sin, policy, attend) -> x
    final: Callable   # (params, x) -> the final-normed hidden states


def _embed_tokens(params, ids, positions, policy: DtypePolicy):
    return linear_ops.apply_embedding(params["embed"], ids, compute_dtype=policy.compute_dtype)


def _family(cfg) -> _Family:
    """The family of ``cfg`` (Llama / Mistral, Mixtral or Megatron GPT);
    dropped MoE raises JAX's text."""
    if isinstance(cfg, gpt.GPTConfig):
        if cfg.moe is not None and not cfg.moe.dropless:
            raise NotImplementedError(_DROPPED)
        return _Family(
            cfg, lambda params, ids, positions, policy:
                gpt.embed(params, ids, positions, cfg, policy),
            partial(gpt._rope_for, cfg),
            lambda lp, x, cos, sin, policy, attend:
                gpt._decoder_layer(lp, x, cos, sin, cfg, policy, attend=attend)[0],
            lambda params, x: gpt.final_hidden(params, x, cfg))
    if isinstance(cfg, mixtral.MixtralConfig):
        if not cfg.moe.dropless:
            raise NotImplementedError(_DROPPED)
        lc = cfg.llama

        def layer(lp, x, cos, sin, policy, attend):
            # a MoE layer, or a dense Llama layer between them
            if moe_ops.is_moe_mlp(lp["mlp"]):
                return mixtral._moe_layer(lp, x, cos, sin, cfg, policy, attend=attend)[0]
            return llama._decoder_layer(lp, x, cos, sin, lc, policy, attend=attend)
    else:
        lc = cfg

        def layer(lp, x, cos, sin, policy, attend):
            return llama._decoder_layer(lp, x, cos, sin, lc, policy, attend=attend)

    return _Family(lc, _embed_tokens, partial(llama._rope, lc), layer,
                   lambda params, x: norm_ops.apply_rms_norm(params["final_norm"], x,
                                                             eps=lc.rms_norm_eps))


@torch.inference_mode()
def prefill(params, input_ids: torch.Tensor, cfg, policy: DtypePolicy, *,
            max_len: Optional[int] = None):
    """Causal forward capturing the KV cache -> ``(hidden [b, s, h], cache)``:
    the final-normed hidden states and ``{"k","v"}: [L, b, max_len, nkv,
    d]`` with rotated keys, zeros past ``s``.  Any family, by ``cfg``'s
    type: Mixtral's cache is one flat ``[L, ...]`` cache at every
    ``moe_frequency``; GPT's positions are learned or (partial) rotary, its
    four block layouts run with no dropout."""
    fam = _family(cfg)
    s = input_ids.shape[1]
    positions = llama.positions_for(input_ids)
    x = fam.embed(params, input_ids, positions, policy)
    cos, sin = fam.rope(positions)
    shape = (len(params["layers"]), x.shape[0], max_len or s, fam.cfg.kv_heads,
             fam.cfg.head_size)
    cache = {kv: torch.zeros(shape, dtype=policy.compute_dtype, device=x.device)
             for kv in "kv"}

    def store(i):
        def attend(q, k, v, attention):
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
            return attention(q, k, v)

        return attend

    for i, lp in enumerate(params["layers"]):
        x = fam.layer(lp, x, cos, sin, policy, store(i))
    return fam.final(params, x), cache


@torch.inference_mode()
def decode_step(params, cache: dict, tokens: torch.Tensor, pos: torch.Tensor, cfg,
                policy: DtypePolicy):
    """One token a row of any family: write its k and v at ``pos[row]``,
    attend over ``<= pos[row]``.  ``tokens [b]``, ``pos [b]`` (the buffer
    position being filled).  Returns ``(logits [b, vocab], cache)``, the
    cache written in place."""
    fam = _family(cfg)
    x = fam.embed(params, tokens[:, None], pos[:, None], policy)
    cos, sin = fam.rope(pos[:, None])

    def cached(i):
        def attend(q, k, v, attention):
            return _cached_attn(q, k, v, cache["k"][i], cache["v"][i], pos,
                                sliding_window=fam.cfg.sliding_window,
                                softmax_dtype=policy.softmax_dtype)

        return attend

    for i, lp in enumerate(params["layers"]):
        x = fam.layer(lp, x, cos, sin, policy, cached(i))
    return llama.logits_fn(params, fam.final(params, x), fam.cfg, policy)[:, 0], cache


# the JAX package's names for each family
prefill_mixtral = prefill_gpt = prefill
decode_step_mixtral = decode_step_gpt = decode_step


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


@torch.inference_mode()
def generate_cached(
    params: Any,
    cfg,
    policy: DtypePolicy,
    prompt_ids: torch.Tensor,   # [b, plen] RIGHT-padded
    prompt_lens: torch.Tensor,  # [b]
    *,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int = 0,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """KV-cached counterpart of ``models/generate.py::generate`` (same
    contract), on the params' device: ``[b, plen + max_new_tokens]``.
    Sampling (``temperature > 0``) draws from ``generator`` (one on the
    params' device; seed 0 if None)."""
    device = params["embed"]["embedding"].device
    prompt_ids = prompt_ids.to(device)
    b, plen = prompt_ids.shape
    lens = prompt_lens.to(device=device, dtype=torch.long)
    rows = torch.arange(b, device=device)
    buf = torch.full((b, plen + max_new_tokens), pad_id, dtype=prompt_ids.dtype, device=device)
    buf[:, :plen] = prompt_ids
    if max_new_tokens <= 0:  # generate()'s no-op contract
        return buf
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    h, cache = prefill(params, prompt_ids, cfg, policy, max_len=plen + max_new_tokens)
    # logits ONLY at each row's last prompt position ([b, 1, h] -> [b, vocab])
    logits = llama.logits_fn(params, h[rows, lens - 1][:, None], _family(cfg).cfg,
                             policy)[:, 0]
    del h

    def pick(next_logits):
        return gen.pick(next_logits, temperature=temperature, top_k=top_k, top_p=top_p,
                        generator=generator).to(buf.dtype)

    first = pick(logits)
    buf[rows, lens] = first  # the EOS itself stays visible
    done = first == eos_id
    pad = torch.full_like(first, pad_id)
    for i in range(max_new_tokens - 1):
        pos = lens + i  # the position holding the PREVIOUS token
        logits, cache = decode_step(params, cache, buf[rows, pos], pos, cfg, policy)
        nxt = torch.where(done, pad, pick(logits))
        buf[rows, pos + 1] = nxt
        done = done | (nxt == eos_id)
    return buf
