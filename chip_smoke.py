#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (neuronx_distributed_training_torch).

    python3 chip_smoke.py

Needs one CUDA card and the repo checkout beside this file; it imports nothing
of JAX.  Phases, each of which fails the run if it fails:

1. report the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``neuronx_distributed_training_torch/csrc`` (one ``nvcc`` per
   source, in parallel);
   ``ptxas`` must report no spill for any of the three kernels;
2. hold each kernel (flash forward, dq, dk/dv) against its plain PyTorch
   version in bf16: causal + GQA at full Llama-3-8B width (s=4096, and
   s=2048, phase 9's shape), and key-padding (with fully masked rows), segment, sliding-window, q_offset,
   head_dim-64, ragged-tile (s=1088, half a 128-row tile past the end),
   ragged tile with key padding and segments, non-causal sliding window with
   key padding, and fused-QKV (q, k, v strided views of one projection) cases
   at smaller s;
3. time each kernel (``tools/kernel_times.py``), its plain version and, as a
   yardstick only, ``F.scaled_dot_product_attention`` at the main-path shape
   (b=1, nh=32, nkv=8, s=8192, d=128, causal), and compare kernel and plain
   there too;
4. run the trainer CLI for 3 steps at Llama-3-8B widths cut to 4 layers
   (seq 8192, gbs 4, mbs 1: 4 microbatches) with the kernel launch counters
   set to 0 just before and read just after: each kernel must have launched
   layers x microbatches x steps = 48 times, loss and grad_norm must be finite
   and the step-0 loss near its expected value;
5. data, checkpoint and resume, at the same width and depth through the same
   CLI: write a Megatron ``.bin/.idx`` corpus from a seed under ``build/``
   (after checking there is disk for two checkpoints), then
   A. train with ``max_steps=3``, checkpoint every 2 steps (async, top-1 +
      last), SIGTERM raised at step 2's boundary: one save, at step 2, with
      its integrity sidecar;
   B. the same exp dir with ``resume_if_exists``: verify step 2's sidecar
      and resume from it (consumed_samples 8), train step 3, one save at
      step 3 (its cadence save and the final save fall on the same step),
      retention as the save_top_k=1 + keep-last rule gives;
   C. a fresh exp dir (A and B's deleted first), 3 steps straight, a
      cadence save at step 2 whose write and digests must still be in flight
      when step 3 ends, and the final save at step 3;
   B's step 3 must equal C's bit for bit (loss, grad_norm, the blake2b
   digest of every parameter and optimizer leaf, from the two step-3
   sidecars), each run must launch each kernel 16 times per step with no
   fallback, and C's step-0 loss must be near its expected value.  It prints
   the checkpoint's bytes, the saves' staging and write seconds, the verify
   and restore seconds and the step times (C's step 3 beside the steps with
   no save in flight), and deletes the exp dirs.  (Run A keeps
   ``max_steps=3``: the Megatron sample order depends on
   ``max_steps x global_batch_size``.)  The cell's settings are those of
   ``neuronx_distributed_training_torch/tools/step_times.py``;
6. SFT with LoRA through the same CLI, on a jsonl of seeded printable-ASCII
   ``input``/``output`` records that this script writes under
   ``build/chip_smoke/sft/`` (char tokenizer, packed into seq-4096 rows,
   3 steps of 4 microbatches, checkpointing off):
   L. ``hf_llama3_8B_SFT_lora_config.yaml`` at Llama-3-8B's full 32 layers,
      rank-16 adapters on qkv, o, gate_up and down: step-0 loss near its
      expected value, finite loss and grad norm, every ``lora_b`` still zero
      after step 0 (the warmup's lr is 0 there) and changed after step 1,
      every adapter moved and every frozen leaf bit for bit as it was after
      step 3, each kernel launched layers x microbatches times in each step
      with no fallback; it prints the step times, tokens/s, MFU and peak
      device memory;
   S. run L with ``sft.segment_mask=true``: the trained batches carry
      ``segment_ids`` with rows of more than one segment, positions restart
      at each segment, the same launch counts, a finite loss that differs
      from run L's; the three kernels' times inside the run (CUDA events
      around each call);
   F. ``hf_llama3_8B_SFT_config.yaml`` (full fine-tune) at 4 layers: finite
      loss, every leaf moved, the launch counts.

Phase 2 also holds the three kernels at the main-path width (b 1, nh 32,
nkv 8, d 128, s 4096) on the segment ids of the first packed row of phase
6's corpus, and times them there with and without those segments.
7. a. phase 4's cell under ``torchrun --nproc_per_node 1`` (NCCL, ZeRO-1):
      phase 4's losses and grad norms bit for bit; with two and four cards
      also dp=2 and dp=4;
   b. the non-finite step skip: a NaN ``loss_mask`` at step 1 keeps the
      params and moments bit for bit;
8. tensor parallelism:
   a. the three kernels at the per-rank head counts TP gives Llama-3-8B
      (nh, nkv) = (16, 4), (8, 2), (4, 1) for tp 2, 4, 8: against their
      plain versions at s 4096 (and on the packed segment row at tp 8),
      timed at s 8192 (and s 4096 at tp 8) beside their bounds and grids;
   b. with two or more cards, phase 4's cell at tp=2 with SP under
      ``torchrun --nproc_per_node 2``: losses and grad norms within the
      ``mixed_precision`` tolerance of phase 4's, 48 launches a kernel on
      each rank, the step and peak memory per rank, and a save at step 2
      resumed bit for bit; with four cards tp=4 and dp x tp = 2 x 2 too.
      With one card it prints why it did not run.

9. preference alignment through the same CLI, from the shipped configs at
   Llama-3-8B widths cut to 4 layers (char tokenizer, seq 2048, gbs 4 at
   mbs 1: 4 microbatches, 3 steps, tp 1 without SP), on seeded records this
   script writes under ``build/chip_smoke/pref/`` (24 records, three to a
   prompt); with L = 4 layers, M = 4 microbatches and n = 24 records:
   D. ``hf_llama3_8B_DPO_config.yaml``: the reference pass over the train
      set launches fwd 2 L n times and no dq or dk/dv, then each step
      launches each kernel 2 L M times; step 0's loss is ln 2 within 1e-3
      and its ``reward_margin`` and ``rewards_chosen`` 0 within 1e-3 (the
      policy is the reference), every leaf moves;
   D'. a fresh trainer on D's exp dir that only prepares the fit: it reads
      the sidecar, launches nothing, and holds D's columns bit for bit; on
      its initial weights the first pair's policy forward with the flash
      kernels holds against the same forward with core attention (largest
      logit gap within 0.25 of the logits' standard deviation) and equals
      the pass's column for that pair bit for bit;
   O. ``hf_llama3_8B_ORPO_config.yaml``: no pass (0 launches before step
      0), step 0's ``orpo_nll`` within 0.5 of phase 4's expected loss, 2 L M
      launches of each kernel a step;
   K. ``hf_llama3_8B_KTO_config.yaml`` with ``kl_estimator=mismatched``: the
      pass fills both columns (fwd 2 L n), step 0's loss is 0.5 x the mean
      class weight and ``kto_kl`` 0, within 1e-3, and each step launches fwd
      2 L M times and dq, dk/dv L M times (the KL forward has no backward).
   Each run prints its step seconds, sequences/s, the MFU of the sequences
   that run (two with a backward per pair; for KTO one with a backward and
   one forward only) beside the logged ``tokens_per_sec`` and MFU (which
   count a pair once), peak device memory, and the pass's seconds and
   sequences/s; the exp dirs are deleted.

10. context parallelism:
   a. the ring, zig-zag ring and Ulysses bodies of both virtual ranks of
      cp 2 in this one process, a loopback standing in for the shifts, the
      all-to-alls and the key mask's all-gather, forward and backward, at
      ``hf_llama3_70B_CP_config.yaml``'s attention (64 q and 8 kv heads of
      128, seq 32768, bf16) with the per-rank heads of tp 1 and tp 8, and
      the ring with a window of 4096 (past chunks where whole tiles and rows
      see no key): the stitched o and dq/dk/dv against ``flash_attention``
      over the whole sequence and against the plain version (each query
      head of kv head 0's group) at phase 2's tolerances, each case's
      launches exact (ring 3, zig-zag 10, Ulysses 2) with no fallback; then
      each kernel timed at each distinct per-rank call with its bound and
      grid;
   b. with two or more cards, phase 4's cell at cp 2 under ``torchrun
      --nproc_per_node 2`` with each of ``ring_attention``,
      ``zigzag_ring_attention`` and ``ulysses_attention``: losses and grad
      norms within the ``mixed_precision`` tolerance of phase 4's, each
      rank's launches exact, step seconds and peak memory per rank; with
      four cards also the 70B CP config at its width and seq 32768, one
      layer, tp 2 x cp 2.  With one card it prints why it did not run.

The line before the last holds the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Without a card, or without the package,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import logging
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
VOCAB, HIDDEN = 128256, 4096
SEQ = 8192
PHASE5_SEED = 20261016
SFT_SEED = 20261023  # its first packed row holds 3 records (phase 2 tests it)
SFT_SEQ, SFT_MICRO, SFT_STEPS = 4096, 4, 3
SFT_LORA_LAYERS, SFT_FULL_LAYERS = 32, 4
PREF_SEED = 20261030
PREF_SEQ, PREF_LAYERS, PREF_RECORDS = 2048, 4, 24
# tolerances, kernel vs plain version on the same bf16 inputs.  The kernel
# rounds the unnormalized p to bf16 for the p v product (the plain version
# keeps p in fp32) and both round o to bf16, so each element of o may differ
# by about one bf16 ulp of itself plus a rounding noise that scales with its
# row: o_err is max |o_k - o_p| / (2^-7 (|o_p| + rms_row(o_p))), and a sound
# kernel reads about 1 (an emulation of its rounding on the CPU gives 0.97 at
# s=4096), so the limit leaves room for one more ulp.  An error the size of a
# typical |o| reads about 64.  lse is fp32 in both; the gradients are fp32
# sums of bf16-rounded outputs, held relative to each gradient's largest entry.
TOL_O = 2.0
TOL_LSE_ABS = 1e-3
TOL_GRAD_REL = 2e-2
# phase 10a: a ring's (and zig-zag's) stitched o is merged in fp32 from the
# chunks' o, which the forward kernel has already rounded to bf16, and is
# then rounded again: one rounding more than one kernel call (JAX's ring
# merges its chunks' bf16 o the same way).  Against the plain version a
# sound ring reads up to about 2 in o_err's units at phase 10a's shapes on
# an H100 (the phase prints its largest), so the stitched o is held at one
# unit more than TOL_O, far below what a wrong chunk or merge reads;
# Ulysses runs one kernel call a head group and keeps TOL_O.  lse and the
# gradients keep phase 2's tolerances.
TOL_O_STITCHED = 3.0
# phase 9: the Llama-3-8B policy forward (4 layers, bf16, s 2048) on the
# initial weights, flash kernels against core attention on the same row: the
# largest logit gap over the core logits' standard deviation.  The two round
# to bf16 at different points and a sound forward reads about 0.08 (phase 9
# prints it); the limit is three times that.  A wrong mask, window or score
# scale in the attention moves the logits by a good part of their spread.
TOL_POLICY_LOGITS = 0.25
PLAIN_ITERS = 2  # timed calls of each plain version (~100 ms and tens of GB each)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-9))


def abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def o_err(o_k, o_p) -> float:
    """max |o_k - o_p| per element in units of 2^-7 (|o_p| + rms of its row)."""
    ok_, op = o_k.float(), o_p.float()
    unit = (op.abs() + op.pow(2).mean(-1, keepdim=True).sqrt()) * 2.0 ** -7
    # rows with no visible key are 0 in the plain version: any output there fails
    return float(((ok_ - op).abs() / unit.clamp_min(1e-30)).max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_inputs(torch, b, sq, skv, nh, nkv, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(
            torch.bfloat16)

    return randn(b, sq, nh, d), randn(b, skv, nkv, d), randn(b, skv, nkv, d), randn(b, sq, nh, d)


def fused_views(torch, qkv, nh, nkv, d):
    """q, k, v as strided views of one fused [b, s, (nh + 2 nkv) d] projection,
    split and reshaped as models/llama.py does."""
    b, s = qkv.shape[:2]
    q, k, v = torch.split(qkv, [nh * d, nkv * d, nkv * d], dim=-1)
    return q.reshape(b, s, nh, d), k.reshape(b, s, nkv, d), v.reshape(b, s, nkv, d)


def check_case(torch, fa, name, *, b, sq, skv, nh, nkv, d, causal=True, window=None,
               q_offset=0, mask=None, seg=None, seed=0, fused=False, with_lse=False):
    """``with_lse`` takes the gradients through ``flash_attention_with_lse``,
    which keeps a window when not causal (and takes no segments)."""
    q, k, v, do = make_inputs(torch, b, sq, skv, nh, nkv, d, seed)
    qkv = None
    if fused:  # self-attention only (sq == skv)
        qkv = torch.cat([x.reshape(b, sq, -1) for x in (q, k, v)], dim=-1)
        q, k, v = fused_views(torch, qkv, nh, nkv, d)
        if q.is_contiguous() or v.stride(1) != (nh + 2 * nkv) * d:
            fail(f"{name}: the fused views are not strided views")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    kvm = None if mask is None else mask.to(torch.int32).contiguous()
    segi = None if seg is None else seg.to(torch.int32).contiguous()
    with torch.no_grad():
        o_k, lse_k = fa.flash_fwd(q, k, v, kvm, segi, **kw)
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, kvm, segi, **kw)
    # gradients through the autograd Function (its backward runs the dq and
    # dk/dv kernels) against the plain backward of the plain forward
    def attend(qa, ka, va):
        akw = dict(causal=causal, sliding_window=window, q_offset=q_offset,
                   attention_mask=mask)
        if with_lse:
            return fa.flash_attention_with_lse(qa, ka, va, **akw)[0]
        return fa.flash_attention(qa, ka, va, segment_ids=seg, **akw)

    if fused:  # the kernels read the views; the gradients land in the fused leaf
        qkv_g = qkv.clone().requires_grad_(True)
        attend(*fused_views(torch, qkv_g, nh, nkv, d)).backward(do)
        dq_k, dk_k, dv_k = fused_views(torch, qkv_g.grad, nh, nkv, d)
    else:
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
        attend(qg, kg, vg).backward(do)
        dq_k, dk_k, dv_k = qg.grad, kg.grad, vg.grad
    with torch.no_grad():
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
        dq_p = fa.flash_dq_plain(q, k, v, do, lse_p, delta, kvm, segi, **kw)
        dk_p, dv_p = fa.flash_dkv_plain(q, k, v, do, lse_p, delta, kvm, segi, **kw)
    torch.cuda.synchronize()
    res = {
        "o_err": o_err(o_k, o_p), "o_abs": abs_err(o_k, o_p),
        "lse_abs": abs_err(lse_k, lse_p),
        "dq_rel": rel_err(dq_k, dq_p), "dk_rel": rel_err(dk_k, dk_p),
        "dv_rel": rel_err(dv_k, dv_p),
    }
    ok = (res["o_err"] <= TOL_O and res["lse_abs"] <= TOL_LSE_ABS
          and max(res["dq_rel"], res["dk_rel"], res["dv_rel"]) <= TOL_GRAD_REL
          and all(math.isfinite(x) for x in res.values()))
    if mask is not None:
        # rows with no visible key: o = 0, lse = NEG_INF, zero gradient
        dead = lse_p <= fa.NEG_INF / 2
        if bool(dead.any()):
            dead_rows = dead.transpose(1, 2)[..., None]  # [b, sq, nh, 1]
            ok = ok and bool((lse_k[dead] == fa.NEG_INF).all())
            ok = ok and bool((o_k.masked_select(dead_rows) == 0).all())
            ok = ok and bool((dq_k.masked_select(dead_rows) == 0).all())
            res["masked_rows"] = int(dead.sum())
        # no gradient reaches padded keys
        pad = (mask == 0)[:, :, None, None]
        ok = ok and bool((dk_k.masked_select(pad) == 0).all())
        ok = ok and bool((dv_k.masked_select(pad) == 0).all())
    log(f"check {name}: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}" for k, v in res.items())
        + f" (tol o_err {TOL_O:g}, lse {TOL_LSE_ABS:g} abs, grads {TOL_GRAD_REL:g} rel)"
        + ("" if ok else "  <-- FAIL"))
    return ok


def phase_checks(torch, fa, kt, card: str) -> None:
    m = kt.MAIN
    ok = check_case(torch, fa, "causal+gqa s=4096", b=1, sq=4096, skv=4096, nh=m["nh"],
                    nkv=m["nkv"], d=m["d"], seed=1)
    # phase 9's shape: the preference configs' seq_length at mbs 1
    ok &= check_case(torch, fa, f"causal+gqa s={PREF_SEQ} (alignment)", b=1, sq=PREF_SEQ,
                     skv=PREF_SEQ, nh=m["nh"], nkv=m["nkv"], d=m["d"], seed=13)
    s = 1024
    left_pad = torch.ones(2, s, dtype=torch.int32, device="cuda")
    left_pad[1, :300] = 0  # rows < 300 of batch 1 see no key
    left_pad[0, 900:] = 0
    ok &= check_case(torch, fa, "key padding s=1024", b=2, sq=s, skv=s, nh=8, nkv=2, d=128,
                     mask=left_pad, seed=2)
    seg = torch.zeros(2, s, dtype=torch.int32, device="cuda")
    seg[0, 100:] = 1
    seg[0, 700:] = 2
    seg[1, 333:] = 1
    ok &= check_case(torch, fa, "segments s=1024", b=2, sq=s, skv=s, nh=8, nkv=2, d=128,
                     seg=seg, seed=3)
    ok &= check_case(torch, fa, "sliding window 300 s=1024", b=1, sq=s, skv=s, nh=8, nkv=2,
                     d=128, window=300, seed=4)
    ok &= check_case(torch, fa, "q_offset 512 sq=512 skv=1024", b=1, sq=512, skv=s, nh=8,
                     nkv=2, d=128, q_offset=512, seed=5)
    ok &= check_case(torch, fa, "non-causal d=64 s=512", b=2, sq=512, skv=512, nh=4, nkv=4,
                     d=64, causal=False, seed=6)
    # s = 17 x 64: the last 128-row tile of all three kernels is half past the
    # end (zero-filled by TMA, its stores skipped; in dq the bulk copies bring
    # only the rows that exist and the second consumer computes nothing)
    ok &= check_case(torch, fa, "ragged tile s=1088", b=1, sq=1088, skv=1088, nh=8, nkv=2,
                     d=128, seed=7)
    # the producer's kv-tile walk on the ragged tile, with padding and segments
    # skipping and flagging tiles (the CPU tests hold the walk's rule itself)
    rs = 1088
    r_pad = torch.ones(2, rs, dtype=torch.int32, device="cuda")
    r_pad[0, :200] = 0  # rows < 200 of batch 0 see no key
    r_pad[1, 1000:] = 0
    r_seg = torch.zeros(2, rs, dtype=torch.int32, device="cuda")
    r_seg[0, 500:] = 1
    r_seg[1, 130:] = 1
    r_seg[1, 700:] = 2
    ok &= check_case(torch, fa, "ragged tile + padding + segments s=1088", b=2, sq=rs,
                     skv=rs, nh=8, nkv=2, d=128, mask=r_pad, seg=r_seg, seed=9)
    nc_pad = torch.ones(2, rs, dtype=torch.int32, device="cuda")
    nc_pad[1, 960:] = 0  # the last two 64-row kv tiles of batch 1 hold no key
    ok &= check_case(torch, fa, "non-causal window 200 + padding s=1088", b=2, sq=rs,
                     skv=rs, nh=8, nkv=2, d=128, causal=False, window=200, mask=nc_pad,
                     seed=10, with_lse=True)
    ok &= check_case(torch, fa, "fused qkv views s=1024", b=2, sq=s, skv=s, nh=8, nkv=2,
                     d=128, seed=8, fused=True)
    # the segment path at the main-path width, on a real packing layout
    seg = torch.as_tensor(sft_first_row_segments(), device="cuda")[None]
    ok &= check_case(torch, fa, f"packed segments ({int(seg.max())} records) s={SFT_SEQ}", b=1,
                     sq=SFT_SEQ, skv=SFT_SEQ, nh=m["nh"], nkv=m["nkv"], d=m["d"], seg=seg,
                     seed=12)
    if not ok:
        fail("a kernel disagrees with its plain version")
    segment_times(torch, fa, kt, seg, card)


def segment_times(torch, fa, kt, seg, card: str) -> dict:
    """CUDA-event ms per call of each kernel at b 1, nh 32, nkv 8, d 128,
    s 4096, causal, with and without the packed segments ``seg``."""
    m = kt.MAIN
    q, k, v, do = make_inputs(torch, 1, SFT_SEQ, SFT_SEQ, m["nh"], m["nkv"], m["d"], 13)
    out = {}
    with torch.no_grad():
        for label, sg in (("no segments", None), ("packed segments", seg.to(torch.int32))):
            o, lse = fa.flash_fwd(q, k, v, None, sg)
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
            out[label] = {
                "flash_fwd": kt.cuda_ms(lambda: fa.flash_fwd(q, k, v, None, sg)),
                "flash_dq": kt.cuda_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta, None, sg)),
                "flash_dkv": kt.cuda_ms(
                    lambda: fa.flash_dkv(q, k, v, do, lse, delta, None, sg)),
            }
            log(f"time at s={SFT_SEQ}, {label}: " + ", ".join(
                f"{n} {ms:.3f} ms" for n, ms in out[label].items()) + f" [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 3: times at the main-path shape
# ---------------------------------------------------------------------------


def bounds_ms(kt, peaks, shape=None):
    """Least time for each function at the main-path shape (or ``shape``,
    a dict like ``kt.MAIN``): the larger of the
    bytes it must move (each input read once, each output written once) over
    the memory rate and its operations over the tensor cores' bf16 rate,
    counting the causal half only.  The backward's fp32 products (p and ds
    times a bf16 operand) are kept exact as three bf16 products each (see
    csrc/flash_dq.cu and csrc/flash_dkv.cu), so they count three times."""
    b, s, nh, nkv, d = ((shape or kt.MAIN)[k] for k in ("b", "s", "nh", "nkv", "d"))
    return bounds_for(peaks, b=b, sq=s, skv=s, nh=nh, nkv=nkv, d=d,
                      pairs=b * nh * s * (s + 1) / 2)  # visible (query, key) pairs


def bounds_for(peaks, *, b, sq, skv, nh, nkv, d, pairs) -> dict:
    """:func:`bounds_ms` for a call of ``sq`` query rows against ``skv``
    keys with ``pairs`` visible (query, key) pairs over all heads (a
    context-parallel chunk: causal, whole, or cut by a window)."""
    bf16_rate, bw = peaks
    q_bytes, kv_bytes, row_bytes = 2 * b * sq * nh * d, 2 * b * skv * nkv * d, 4 * b * nh * sq
    work = {
        # q k^T and p v
        "flash_fwd": (4 * d * pairs, q_bytes + 2 * kv_bytes + q_bytes + row_bytes),
        # q k^T and do v^T; ds k as three products
        "flash_dq": ((4 + 3 * 2) * d * pairs,
                     2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + q_bytes),
        # q k^T and do v^T; p^T do and ds^T q as three products each
        "flash_dkv": ((4 + 2 * 3 * 2) * d * pairs,
                      2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + 2 * kv_bytes),
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / bf16_rate, nbytes / bw
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_times(torch, fa, kt, card: str, peaks) -> dict:
    import torch.nn.functional as F

    q, k, v, do, o, lse, delta = kt.main_path_tensors()
    res = {name: {"ms": ms} for name, ms in kt.kernel_ms(q, k, v, do, lse, delta).items()}
    with torch.no_grad():
        # kernel against plain at this shape, one function at a time to bound memory
        o_p, lse_p = fa.flash_fwd_plain(q, k, v)
        res["flash_fwd"]["max_abs_err"] = max(abs_err(o, o_p), abs_err(lse, lse_p))
        main_o_err = o_err(o, o_p)
        fwd_ok = main_o_err <= TOL_O and abs_err(lse, lse_p) <= TOL_LSE_ABS
        log(f"check flash_fwd at the main-path shape: o_err={main_o_err:.3f} "
            f"(tol {TOL_O:g}), lse_abs={abs_err(lse, lse_p):.3e} (tol {TOL_LSE_ABS:g})")
        del o_p, lse_p
        res["flash_fwd"]["plain_ms"] = kt.cuda_ms(
            lambda: fa.flash_fwd_plain(q, k, v), PLAIN_ITERS)
        dq = fa.flash_dq(q, k, v, do, lse, delta)
        dq_p = fa.flash_dq_plain(q, k, v, do, lse, delta)
        res["flash_dq"]["max_abs_err"] = abs_err(dq, dq_p)
        dq_ok = rel_err(dq, dq_p) <= TOL_GRAD_REL
        del dq, dq_p
        res["flash_dq"]["plain_ms"] = kt.cuda_ms(
            lambda: fa.flash_dq_plain(q, k, v, do, lse, delta), PLAIN_ITERS)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta)
        dk_p, dv_p = fa.flash_dkv_plain(q, k, v, do, lse, delta)
        res["flash_dkv"]["max_abs_err"] = max(abs_err(dk, dk_p), abs_err(dv, dv_p))
        dkv_ok = max(rel_err(dk, dk_p), rel_err(dv, dv_p)) <= TOL_GRAD_REL
        del dk, dv, dk_p, dv_p
        gc.collect()
        torch.cuda.empty_cache()
        res["flash_dkv"]["plain_ms"] = kt.cuda_ms(
            lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta), PLAIN_ITERS)
        # yardstick only: one library call computing the forward
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        res["flash_fwd"]["library_ms"] = kt.cuda_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                   enable_gqa=True))
    qg, kg, vg = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                       enable_gqa=True).backward(dot)

    sdpa_bwd_ms = kt.cuda_ms(sdpa_fwd_bwd) - res["flash_fwd"]["library_ms"]
    res["flash_dq"]["library_ms"] = None  # no single library call computes dq alone
    res["flash_dkv"]["library_ms"] = None
    for name, (bound, by) in bounds_ms(kt, peaks).items():
        res[name]["bound_ms"] = bound
        res[name]["bound_by"] = by
    for name, r in res.items():
        log(f"time {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 3)}"
            f" ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3e} [{card}]")
    log(f"time sdpa backward (fwd+bwd minus fwd, yardstick for dq + dk/dv together): "
        f"{sdpa_bwd_ms:.3f} ms [{card}]")
    bwd_ms = res["flash_dq"]["ms"] + res["flash_dkv"]["ms"]
    log(f"time dq + dk/dv kernels: {bwd_ms:.3f} ms, {bwd_ms / sdpa_bwd_ms:.3f}x the sdpa "
        f"backward [{card}]")
    del q, k, v, do, o, lse, delta, qg, kg, vg, dot
    gc.collect()
    torch.cuda.empty_cache()
    if not (fwd_ok and dq_ok and dkv_ok):
        fail("a kernel disagrees with its plain version at the main-path shape")
    return res


# ---------------------------------------------------------------------------
# phase 4: the trainer
# ---------------------------------------------------------------------------


def phase_trainer(torch, fa, cell, card: str) -> tuple:
    """``cell`` is ``tools/step_times.py``, which holds the cell's settings.
    Returns the launch counts and the run's history."""
    from neuronx_distributed_training_torch.trainer import cli

    torch.cuda.reset_peak_memory_stats()
    fa.reset_counters()
    history = cli.main(cell.CLI_ARGS)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    fallbacks = dict(fa.FALLBACKS)
    peak = torch.cuda.max_memory_allocated()
    log(f"train peak device memory {peak} bytes ({peak / 2**30:.2f} GiB) [{card}]")
    history[0]["peak_bytes"] = peak
    expect = cell.LAYERS * cell.MICROBATCHES * cell.STEPS
    for rec in history:
        log(f"train step {rec['step']}: loss {rec['loss']:.4f} grad_norm "
            f"{rec['grad_norm']:.4f} step {rec['step_seconds']:.3f} s, "
            f"{rec['tokens_per_sec']:.1f} tokens/s, MFU {rec['mfu']:.4f} [{card}]")
    log(f"train launches {launches} fallbacks {fallbacks} (expected {expect} each)")
    if len(history) != cell.STEPS:
        fail(f"trainer ran {len(history)} steps, expected {cell.STEPS}")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in history):
        fail("non-finite loss or grad_norm")
    loss0 = history[0]["loss"]
    log(f"step-0 loss {loss0:.4f}: expected {expected_loss0():.4f} (ln vocab "
        f"{math.log(VOCAB):.4f} + sigma^2/2)")
    if abs(loss0 - expected_loss0()) > 0.5:
        fail(f"step-0 loss {loss0} not within 0.5 of {expected_loss0():.4f}")
    if any(n != expect for n in launches.values()) or fallbacks["core"]:
        fail(f"kernel launches {launches} (fallbacks {fallbacks}), expected {expect} each")
    return launches, history


# ---------------------------------------------------------------------------
# phase 5: Megatron data, checkpoint and bitwise resume
# ---------------------------------------------------------------------------


def expected_loss0() -> float:
    """Random init: final-norm output has rms 1, lm_head ~ 0.02 x (normal cut
    at +-2 sigma, whose std is 0.8796), so logits ~ N(0, sigma^2) with
    sigma^2 = hidden * (0.02 * 0.8796)^2 and E[loss] = ln(vocab) + sigma^2 / 2."""
    return math.log(VOCAB) + HIDDEN * (0.02 * 0.879626) ** 2 / 2


def checkpoint_bytes(layers: int) -> int:
    """fp32 params, mu and nu of Llama-3-8B width at ``layers`` layers (the
    mixed_precision policy keeps no separate master)."""
    h, inter, nh, nkv, d = HIDDEN, 14336, 32, 8, 128
    per_layer = h * (nh + 2 * nkv) * d + nh * d * h + h * 2 * inter + inter * h + 2 * h
    n = 2 * VOCAB * h + layers * per_layer + h
    return 3 * 4 * n


def write_corpus(prefix: Path, min_tokens: int) -> int:
    """A Megatron corpus from a seed: int32 tokens in [0, vocab), documents
    of 100-20,000 tokens, at least ``min_tokens`` in all."""
    import numpy as np

    from neuronx_distributed_training_torch.data.megatron import write_indexed_dataset

    rng = np.random.default_rng(PHASE5_SEED)
    docs, total = [], 0
    while total < min_tokens:
        n = int(rng.integers(100, 20001))
        docs.append(rng.integers(0, VOCAB, n, dtype=np.int64).astype(np.int32))
        total += n
    prefix.parent.mkdir(parents=True, exist_ok=True)
    write_indexed_dataset(prefix, docs)
    return total


class AtStepEnd(logging.Handler):
    """Calls ``action`` in this process when the trainer logs the end of step
    ``index`` (before that boundary's checkpoint save)."""

    def __init__(self, index: int, action):
        super().__init__()
        self.prefix, self.action = f"step {index}:", action

    def emit(self, record):
        if record.getMessage().startswith(self.prefix):
            self.action()


def run_cli_handlers(fn, *handlers: AtStepEnd):
    """``fn()`` with ``handlers`` on the trainer's logger."""
    train_log = logging.getLogger("nxdt.torch.train")
    for h in handlers:
        train_log.addHandler(h)
    try:
        return fn()
    finally:
        for h in handlers:
            train_log.removeHandler(h)


def run_cli(cli, args: list, *handlers: AtStepEnd):
    """``cli.run(args)`` with ``handlers`` on the trainer's logger."""
    return run_cli_handlers(lambda: cli.run(args), *handlers)


def free_cuda(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_resume(torch, fa, cell, card: str) -> dict:
    """Runs A (preempted after step 2: one save), B (resumed, trains step 3,
    saves once) and C (3 steps straight, saving at steps 2 and 3, so step 3
    runs over step 2's write) through the CLI on a Megatron corpus; B's step 3
    must equal C's bit for bit.  ``cell`` is ``tools/step_times.py``."""
    from neuronx_distributed_training_torch.checkpoint import integrity as ck_integrity
    from neuronx_distributed_training_torch.checkpoint.manager import retained_steps
    from neuronx_distributed_training_torch.trainer import cli

    t_phase = time.perf_counter()
    work, nmb = cell.WORK, cell.MICROBATCHES
    ck_bytes = checkpoint_bytes(cell.LAYERS)
    # two steps on disk at once: B's and C's second save beside the first
    need = 2 * ck_bytes + (8 << 30)
    work.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(work).free
    log(f"resume: torch {torch.__version__}; a checkpoint holds {ck_bytes} bytes; {free} "
        f"bytes free under {work}, {need} needed")
    if free < need:
        fail(f"not enough disk under {work}: {free / 2**30:.1f} GiB free, "
             f"{need / 2**30:.1f} GiB needed for two checkpoints of {ck_bytes / 2**30:.1f} GiB")
    prefix = work / "corpus" / "llama3_random"
    n_tokens = write_corpus(prefix, min_tokens=2 * nmb * cell.STEPS * (SEQ + 1))
    log(f"resume: corpus {prefix} ({n_tokens} tokens, seed {PHASE5_SEED})")
    exp_resume, exp_straight = work / "exp_resume", work / "exp_straight"
    for d in (exp_resume, exp_straight):
        shutil.rmtree(d, ignore_errors=True)
    data_args = cell.MODEL_ARGS + [
        "--set", f"data.data_prefix={prefix}",
        "--set", "data.synthetic=false",
        "--set", "exp_manager.name=phase5",
        "--set", "exp_manager.checkpoint_callback_params.save_top_k=1",
        "--set", "exp_manager.checkpoint_callback_params.monitor=loss",
        "--set", "exp_manager.checkpoint_callback_params.async_checkpointing=true",
    ]
    resume_args = data_args + ["--set", f"exp_manager.exp_dir={exp_resume}",
                               "--set", "exp_manager.resume_if_exists=true"]
    expect = cell.LAYERS * nmb
    report: dict = {}

    def launched(steps: int, what: str) -> dict:
        torch.cuda.synchronize()
        launches, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
        log(f"resume {what}: launches {launches} fallbacks {fallbacks} "
            f"(expected {expect * steps} each)")
        if any(n != expect * steps for n in launches.values()) or fallbacks["core"]:
            fail(f"run {what}: launches {launches} (fallbacks {fallbacks}), expected "
                 f"{expect} each per step")
        return launches

    def check_retention(ck, losses: dict, what: str) -> None:
        want = retained_steps({s: {"loss": v} for s, v in losses.items()}, 1, "loss")
        left = set(ck.all_steps())
        log(f"resume {what}: retention left steps {sorted(left)}; the rule gives "
            f"{sorted(want)} (losses {losses})")
        if left != want:
            fail(f"run {what}: retention left {sorted(left)}, the save_top_k=1 + keep-last "
                 f"rule gives {sorted(want)}")

    try:
        # A: max_steps 3 (the data order and LR schedule are those of a
        # 3-step run) preempted by SIGTERM at step 2's boundary; the stop
        # replaces the cadence save at step 2 with one drained save
        fa.reset_counters()
        t0 = time.perf_counter()
        ta, ha = run_cli(cli, resume_args + [
            "--set", "exp_manager.checkpoint_callback_params.every_n_train_steps=2"],
            AtStepEnd(1, lambda: signal.raise_signal(signal.SIGTERM)))
        report["run_a_seconds"] = time.perf_counter() - t0
        launched(2, "A")
        ck_a, save_a = ta.checkpointer, dict(ta.checkpointer.last_save)
        if ta.stop_class != "preemption" or len(ha) != 2 or ck_a.committed_steps != [2]:
            fail(f"run A: stop {ta.stop_class}, {len(ha)} steps, saves {ck_a.committed_steps}; "
                 f"expected a preemption after 2 steps and one save at step 2")
        if not ck_integrity.read_sidecar(ck_a.directory, 2):
            fail("run A: the step-2 checkpoint carries no integrity sidecar")
        report.update(ck_bytes=save_a["bytes"], save_a=save_a,
                      process_group_mode=ck_a.process_group_mode,
                      step_a1_seconds=ha[1]["step_seconds"], loss_a0=ha[0]["loss"])
        ck_dir, run_dir = ck_a.directory, ta.exp.log_dir
        del ta, ck_a
        free_cuda(torch)

        # B: same exp dir, resumes from step 2 and trains step 3; its cadence
        # save (every 3) and the final save fall on step 3: one write
        fa.reset_counters()
        t0 = time.perf_counter()
        tb, hb = cli.run(resume_args + [
            "--set", "exp_manager.checkpoint_callback_params.every_n_train_steps=3"])
        report["run_b_seconds"] = time.perf_counter() - t0
        launched(1, "B")
        ck_b = tb.checkpointer
        if tb.exp.log_dir != run_dir:
            fail(f"run B opened {tb.exp.log_dir}, not run A's {run_dir}")
        if ck_b.last_restore.get("step") != 2 or len(hb) != 1 or hb[0]["step"] != 2:
            fail(f"run B: restored {ck_b.last_restore}, trained {[r['step'] for r in hb]}; "
                 f"expected a resume from step 2 and step index 2 trained")
        trail = ck_b.integrity_trail
        if trail.get("verified_step") != 2 or trail.get("walk_back_count") or \
                trail.get("quarantined_steps") or trail.get("legacy_restore"):
            fail(f"run B: step 2's sidecar did not verify cleanly: {trail}")
        if hb[0]["consumed_samples"] - nmb != 8:
            fail(f"run B resumed at consumed_samples {hb[0]['consumed_samples'] - nmb}, "
                 f"expected 8")
        if ck_b.committed_steps != [3]:
            fail(f"run B saved steps {ck_b.committed_steps}, expected [3] (the final save of an "
                 f"already saved step must write nothing)")
        check_retention(ck_b, {2: ha[1]["loss"], 3: hb[0]["loss"]}, "B")
        digests_b = ck_integrity.read_sidecar(ck_dir, 3)["leaves"]
        report.update(save_b=dict(ck_b.last_save), restore_b=dict(ck_b.last_restore),
                      loss_b=hb[0]["loss"], grad_norm_b=hb[0]["grad_norm"],
                      step_b_seconds=hb[0]["step_seconds"])
        del tb, ck_b
        free_cuda(torch)
        shutil.rmtree(exp_resume)  # room for C's two checkpoints

        # C: 3 steps straight in a fresh exp dir, a cadence save at step 2
        # (step 3 trains while it is written and hashed) and the final save
        # at step 3, whose sidecar gives C's leaf digests
        in_flight: list[bool] = []
        fa.reset_counters()
        t0 = time.perf_counter()
        tc, hc = run_cli(cli, data_args + [
            "--set", f"exp_manager.exp_dir={exp_straight}",
            "--set", "exp_manager.resume_if_exists=false",
            "--set", "exp_manager.checkpoint_callback_params.every_n_train_steps=2"],
            AtStepEnd(2, lambda: in_flight.append(any(exp_straight.rglob("2.tmp-*")))))
        report["run_c_seconds"] = time.perf_counter() - t0
        launched(3, "C")
        ck_c = tc.checkpointer
        if ck_c.committed_steps != [2, 3] or in_flight != [True]:
            fail(f"run C saved steps {ck_c.committed_steps} (expected [2, 3]); step 2's write "
                 f"in flight through step 3: {in_flight}")
        check_retention(ck_c, {2: hc[1]["loss"], 3: hc[2]["loss"]}, "C")
        digests_c = ck_integrity.read_sidecar(ck_c.directory, 3)["leaves"]
        report["save_c"] = dict(ck_c.last_save)
        del tc, ck_c
        free_cuda(torch)
    finally:
        for d in (exp_resume, exp_straight):
            shutil.rmtree(d, ignore_errors=True)

    if [r["loss"] for r in ha] != [r["loss"] for r in hc[:2]]:
        fail(f"run A's steps differ from run C's: {[r['loss'] for r in ha]} vs "
             f"{[r['loss'] for r in hc[:2]]}")
    same = {k: (report[f"{k}_b"], hc[2][k]) for k in ("loss", "grad_norm")}
    diff_leaves = sorted(f"{item}/{n}" for item in digests_c for n in digests_c[item]
                         if digests_b.get(item, {}).get(n) != digests_c[item][n])
    n_leaves = sum(len(v) for v in digests_c.values())
    log(f"resume: step 3 resumed (B) vs straight (C): loss {same['loss'][0]!r} vs "
        f"{same['loss'][1]!r}, grad_norm {same['grad_norm'][0]!r} vs {same['grad_norm'][1]!r}, "
        f"{n_leaves - len(diff_leaves)}/{n_leaves} leaf digests equal")
    if any(b != c for b, c in same.values()) or diff_leaves or not n_leaves:
        fail(f"resumed step 3 is not bit for bit the straight run's: {same}, leaves that "
             f"differ: {diff_leaves[:8]}")
    loss0 = hc[0]["loss"]
    if not all(math.isfinite(r["loss"]) for r in hc) or abs(loss0 - expected_loss0()) > 0.5:
        fail(f"run C step-0 loss {loss0}, expected finite and within 0.5 of "
             f"{expected_loss0():.4f}")
    sa, sb, sc, rb = report["save_a"], report["save_b"], report["save_c"], report["restore_b"]
    log(f"resume: checkpoint {sa['bytes']} bytes; save A: staged {sa['stage_seconds']:.3f} s, "
        f"written {sa['write_seconds']:.3f} s (digests {sa['digest_seconds']:.3f} s); restore "
        f"in B: verify (read + re-hash) {rb['verify_seconds']:.3f} s, copy to the card "
        f"{rb['restore_seconds']:.3f} s; save B: staged {sb['stage_seconds']:.3f} s, written "
        f"{sb['write_seconds']:.3f} s (digests {sb['digest_seconds']:.3f} s); C's save at "
        f"step 3: staged {sc['stage_seconds']:.3f} s, written {sc['write_seconds']:.3f} s "
        f"(digests {sc['digest_seconds']:.3f} s); DCP process group: "
        f"{report['process_group_mode']} [{card}]")
    log(f"resume: step times with no save in flight: A's second step "
        f"{report['step_a1_seconds']:.3f} s, B's step {report['step_b_seconds']:.3f} s, C's "
        f"first two {hc[0]['step_seconds']:.3f}, {hc[1]['step_seconds']:.3f} s; over step 2's "
        f"in-flight write and digests: C's third {hc[2]['step_seconds']:.3f} s [{card}]")
    log(f"resume: runs A {report['run_a_seconds']:.1f} s, B {report['run_b_seconds']:.1f} s, "
        f"C {report['run_c_seconds']:.1f} s; step-0 loss {loss0:.4f} (expected "
        f"{expected_loss0():.4f}) [{card}]")
    report["phase_seconds"] = time.perf_counter() - t_phase
    log(f"resume: phase wall time {report['phase_seconds']:.1f} s [{card}]")
    return report


# ---------------------------------------------------------------------------
# phase 6: SFT with sequence packing and LoRA
# ---------------------------------------------------------------------------


def sft_corpus() -> Path:
    """A jsonl of ``input``/``output`` records of printable ASCII from
    ``SFT_SEED`` (inputs of 50-1,500 characters, outputs of 50-2,500), with
    at least twice the tokens 3 steps of 4 rows of 4096 hold; written once
    per run under ``build/chip_smoke/sft/``."""
    import numpy as np

    from neuronx_distributed_training_torch.tools import step_times as cell

    path = cell.WORK / "sft" / "train.jsonl"
    if path.exists():
        return path
    rng = np.random.default_rng(SFT_SEED)
    need = 2 * SFT_STEPS * SFT_MICRO * SFT_SEQ
    lines, total = [], 0

    def text(lo: int, hi: int) -> str:
        return rng.integers(32, 127, int(rng.integers(lo, hi + 1)), dtype=np.uint8).tobytes() \
            .decode("ascii")

    while total < need:
        rec = {"input": text(50, 1500), "output": text(50, 2500)}
        total += len(rec["input"]) + len(rec["output"]) + 2  # + bos, + eos
        lines.append(json.dumps(rec))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text("\n".join(lines) + "\n")
    tmp.replace(path)
    log(f"sft: corpus {path}: {len(lines)} records, {total} tokens (seed {SFT_SEED})")
    return path


def sft_first_row_segments():
    """``segment_ids`` of the first packed row of the phase-6 corpus, as the
    SFT data module packs it (char tokenizer, seq 4096)."""
    from neuronx_distributed_training_torch.data.build import CharTokenizer
    from neuronx_distributed_training_torch.data.modules import SFTDataModule

    dm = SFTDataModule(str(sft_corpus()), CharTokenizer(512), SFT_SEQ, SFT_MICRO,
                       segment_mask=True)
    return dm.arrays["segment_ids"][0]


def sft_args(config: str, layers: int, *extra: str) -> list:
    from neuronx_distributed_training_torch.tools import step_times as cell

    return ["--config", str(REPO / "examples" / "conf" / config),
            "--set", f"model.num_layers={layers}",
            "--set", "distributed_strategy.tensor_model_parallel_size=1",
            "--set", "distributed_strategy.sequence_parallel=false",
            "--set", f"data.global_batch_size={SFT_MICRO}",
            "--set", f"trainer.max_steps={SFT_STEPS}",
            "--set", "trainer.log_every_n_steps=1",
            "--set", f"data.train_dir={sft_corpus()}",
            "--set", "data.tokenizer.library=char",
            "--set", f"exp_manager.exp_dir={cell.WORK / 'exp_sft'}",
            "--set", "exp_manager.resume_if_exists=false",
            "--set", "exp_manager.checkpoint_callback_params.every_n_train_steps=0",
            *extra]


def trained_batches(trainer, steps: int) -> list:
    """The host batches of the first ``steps`` steps, from a copy of the
    data module's sampler (the trainer's own sampler is not touched)."""
    import dataclasses
    import itertools

    from neuronx_distributed_training_torch.data.loader import process_global_batch

    dm = trainer.data_module
    sampler = dataclasses.replace(dm.sampler, consumed_samples=0)
    return [process_global_batch(dm.fetch_rows(idx), input_names=dm.input_names)
            for idx in itertools.islice(iter(sampler), steps)]


class KernelEvents:
    """CUDA events around every call of the three kernel wrappers while
    installed (the autograd Function calls them by module attribute)."""

    def __init__(self, torch, fa):
        self.torch, self.fa = torch, fa
        self.events = {n: [] for n in ("flash_fwd", "flash_dq", "flash_dkv")}
        self.real = {n: getattr(fa, n) for n in self.events}

    def __enter__(self):
        for name, fn in self.real.items():
            def timed(*a, _fn=fn, _name=name, **kw):
                start = self.torch.cuda.Event(enable_timing=True)
                end = self.torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*a, **kw)
                end.record()
                self.events[_name].append((start, end))
                return out
            setattr(self.fa, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.fa, name, fn)

    def ms(self) -> dict:
        """{kernel: (median, mean) ms per call}."""
        import statistics

        self.torch.cuda.synchronize()
        out = {}
        for n, ev in self.events.items():
            if ev:
                t = [s.elapsed_time(e) for s, e in ev]
                out[n] = (statistics.median(t), statistics.fmean(t))
        return out


def run_sft(torch, fa, name: str, args: list, card: str, *, layers: int, check_b=False,
            timed=False, expect=None, prepare=None, tag="sft") -> dict:
    """Build the trainer through the CLI, train 3 steps, and check launches
    per step (``expect``: {kernel: launches a step}, by default layers x
    microbatches each), finite metrics, and which leaves moved.
    ``prepare(trainer)`` runs after the build, before anything is counted,
    and its result is the report's ``prepared``.  Returns the report."""
    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.trainer import cli

    t = cli.build(args)
    prepared = prepare(t) if prepare is not None else None
    flat = llama.named_params(t.params)
    trainable = set(flat) if t.trainable is None else t.trainable
    frozen_host = {n: p.detach().cpu() for n, p in flat.items() if n not in trainable}
    trainable_before = {n: flat[n].detach().clone() for n in trainable}
    per_step: list = []
    b_state: list = []

    def at_step_end():
        torch.cuda.synchronize()
        per_step.append(dict(fa.LAUNCHES))
        if check_b:
            nonzero = [bool(flat[n].any()) for n in trainable if n.endswith("lora_b")]
            b_state.append((any(nonzero), all(nonzero)))

    handlers = [AtStepEnd(i, at_step_end) for i in range(SFT_STEPS)]
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counters()
    train_log = logging.getLogger("nxdt.torch.train")
    for h in handlers:
        train_log.addHandler(h)
    t0 = time.perf_counter()
    try:
        if timed:
            with KernelEvents(torch, fa) as ke:
                history = t.fit()
            kernel_ms = ke.ms()
        else:
            history, kernel_ms = t.fit(), None
    finally:
        for h in handlers:
            train_log.removeHandler(h)
    torch.cuda.synchronize()
    run_seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fallbacks = dict(fa.FALLBACKS)
    expect = expect or {k: layers * SFT_MICRO for k in fa.LAUNCHES}
    steps = [{k: v - (per_step[i - 1][k] if i else 0) for k, v in per_step[i].items()}
             for i in range(len(per_step))]
    for rec in history:
        log(f"{tag} {name} step {rec['step']}: loss {rec['loss']:.4f} grad_norm "
            f"{rec['grad_norm']:.4f} lr {rec['lr']:.3e}, step {rec['step_seconds']:.3f} s, "
            f"{rec['tokens_per_sec']:.1f} tokens/s, MFU {rec['mfu']:.4f} (utils/perf.py: 3 x "
            f"forward, skipped weight gradients not discounted) [{card}]")
    log(f"{tag} {name}: {layers} layers, launches per step {steps} fallbacks {fallbacks} "
        f"(expected {expect}); peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB); fit {run_seconds:.1f} s [{card}]")
    if len(history) != SFT_STEPS or len(steps) != SFT_STEPS:
        fail(f"{tag} {name}: trained {len(history)} steps, expected {SFT_STEPS}")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in history):
        fail(f"{tag} {name}: non-finite loss or grad_norm")
    if any(st[k] != n for st in steps for k, n in expect.items()) or fallbacks["core"]:
        fail(f"{tag} {name}: launches per step {steps} (fallbacks {fallbacks}), expected "
             f"{expect}")
    unmoved = [n for n in trainable if torch.equal(flat[n], trainable_before[n])]
    if unmoved:
        fail(f"{tag} {name}: trainable leaves that did not move: {sorted(unmoved)[:6]}")
    changed = [n for n, h in frozen_host.items() if not torch.equal(flat[n].detach().cpu(), h)]
    if changed:
        fail(f"{tag} {name}: frozen leaves changed: {sorted(changed)[:6]}")
    if check_b and b_state[:2] != [(False, False), (True, True)]:
        fail(f"{tag} {name}: (any, every) lora_b non-zero after steps 0 and 1: {b_state[:2]}; "
             f"expected all still zero after step 0 (lr 0) and all changed after step 1")
    log(f"{tag} {name}: {len(trainable)} trainable leaves all moved, {len(frozen_host)} frozen "
        f"leaves bit for bit")
    report = {"history": history, "launches": per_step[-1], "peak_bytes": peak,
              "kernel_ms": kernel_ms, "trainer": t, "run_seconds": run_seconds,
              "prepared": prepared}
    return report


def phase_sft(torch, fa, card: str) -> dict:
    """Runs L (LoRA, 32 layers), S (L with segment_mask) and F (full
    fine-tune, 4 layers) of the SFT configs through the CLI."""

    import numpy as np

    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.tools import step_times as cell

    t_phase = time.perf_counter()
    out: dict = {}
    try:
        lora = "hf_llama3_8B_SFT_lora_config.yaml"
        rep = run_sft(torch, fa, "L", sft_args(lora, SFT_LORA_LAYERS), card,
                      layers=SFT_LORA_LAYERS, check_b=True)
        t = rep.pop("trainer")
        if "segment_ids" in t.data_module.input_names:
            fail("sft L: the batches carry segment_ids without segment_mask")
        loss0 = rep["history"][0]["loss"]
        log(f"sft L: step-0 loss {loss0:.4f}: expected {expected_loss0():.4f}")
        if abs(loss0 - expected_loss0()) > 0.5:
            fail(f"sft L: step-0 loss {loss0} not within 0.5 of {expected_loss0():.4f}")
        out["L"] = rep
        del t
        free_cuda(torch)

        rep = run_sft(torch, fa, "S", sft_args(lora, SFT_LORA_LAYERS,
                                               "--set", "model_alignment_strategy.sft."
                                               "segment_mask=true"), card,
                      layers=SFT_LORA_LAYERS, timed=True)
        t = rep.pop("trainer")
        batches = trained_batches(t, SFT_STEPS)
        multi = 0
        for b in batches:
            if "segment_ids" not in b:
                fail("sft S: a trained batch carries no segment_ids")
            seg = torch.as_tensor(b["segment_ids"])
            pos = llama.positions_for(torch.as_tensor(b["input_ids"]), segment_ids=seg)
            starts = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool),
                                seg[:, 1:] != seg[:, :-1]], dim=1)
            steps_ok = (pos[:, 1:] == pos[:, :-1] + 1) | starts[:, 1:]
            if not (bool((pos[starts] == 0).all()) and bool(steps_ok.all())):
                fail("sft S: positions do not restart at each segment")
            multi += int((np.asarray(b["segment_ids"]).max(axis=1) > 1).sum())
        log(f"sft S: {multi} of {SFT_STEPS * SFT_MICRO} trained rows hold more than one "
            f"segment; positions restart at every segment")
        if not multi:
            fail("sft S: no trained row holds more than one segment")
        ls, ll = [r["loss"] for r in rep["history"]], [r["loss"] for r in out["L"]["history"]]
        if ls == ll:
            fail(f"sft S: losses equal run L's ({ls}): the segment mask changed nothing")
        log(f"sft S: kernel ms per call inside the run (CUDA events, median / mean of "
            f"{SFT_STEPS * SFT_MICRO * SFT_LORA_LAYERS} calls each): " + ", ".join(
                f"{n} {med:.3f} / {mean:.3f}" for n, (med, mean) in rep["kernel_ms"].items())
            + f" [{card}]")
        out["S"] = rep
        del t, batches
        free_cuda(torch)

        rep = run_sft(torch, fa, "F", sft_args("hf_llama3_8B_SFT_config.yaml",
                                               SFT_FULL_LAYERS), card, layers=SFT_FULL_LAYERS)
        del rep["trainer"]
        out["F"] = rep
        free_cuda(torch)
    finally:
        shutil.rmtree(cell.WORK / "exp_sft", ignore_errors=True)
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"sft: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 9: preference alignment (DPO, ORPO, KTO)
# ---------------------------------------------------------------------------


def pref_corpus(kind: str) -> Path:
    """Seeded printable-ASCII preference records under
    ``build/chip_smoke/pref/``: ``PREF_RECORDS`` of them, three completions
    to each prompt (prompts of 100-1,500 characters, completions of
    100-1,500): ``prompt``/``chosen``/``rejected`` for ``dpo``,
    ``prompt``/``completion``/``label`` (about half desirable) for ``kto``."""
    import numpy as np

    from neuronx_distributed_training_torch.tools import step_times as cell

    path = cell.WORK / "pref" / f"{kind}.jsonl"
    if path.exists():
        return path
    rng = np.random.default_rng(PREF_SEED + (kind == "kto"))

    def text() -> str:
        return rng.integers(32, 127, int(rng.integers(100, 1501)), dtype=np.uint8).tobytes() \
            .decode("ascii")

    prompts = [text() for _ in range(PREF_RECORDS // 3)]
    recs = [{"prompt": prompts[i // 3], "completion": text(), "label": bool(rng.random() < 0.5)}
            if kind == "kto" else {"prompt": prompts[i // 3], "chosen": text(), "rejected": text()}
            for i in range(PREF_RECORDS)]
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    tmp.replace(path)
    return path


def pref_args(config: str, kind: str, *extra: str) -> list:
    """The CLI arguments of a phase-9 run: the shipped config at Llama-3-8B
    widths cut to ``PREF_LAYERS`` layers, tp 1 without SP, the char tokenizer,
    seq 2048 (the config's), gbs 4 at mbs 1 (4 microbatches), 3 steps, and
    the checkpointer on (its dir holds the reference sidecar) with no saves
    (phase 5 holds the saves)."""
    from neuronx_distributed_training_torch.tools import step_times as cell

    return ["--config", str(REPO / "examples" / "conf" / config),
            "--set", f"model.num_layers={PREF_LAYERS}",
            "--set", "distributed_strategy.tensor_model_parallel_size=1",
            "--set", "distributed_strategy.sequence_parallel=false",
            "--set", f"data.global_batch_size={SFT_MICRO}",
            "--set", f"trainer.max_steps={SFT_STEPS}",
            "--set", "trainer.log_every_n_steps=1",
            "--set", f"data.train_dir={pref_corpus(kind)}",
            "--set", "data.tokenizer.library=char",
            "--set", f"exp_manager.exp_dir={cell.WORK / 'exp_pref'}",
            "--set", "exp_manager.resume_if_exists=true",
            "--set", "exp_manager.checkpoint_callback_params.every_n_train_steps=0",
            *extra]


def seq_flops(layers: int) -> float:
    """Forward FLOPs of one sequence of ``PREF_SEQ`` at Llama-3-8B widths."""
    from neuronx_distributed_training_torch.utils import perf

    return PREF_SEQ * perf.llama_flops_per_token(
        num_layers=layers, hidden_size=HIDDEN, intermediate_size=14336, num_attention_heads=32,
        num_kv_heads=8, vocab_size=VOCAB, seq_len=PREF_SEQ, head_dim=128)


def policy_against_core(torch, t, cols: dict, card: str) -> dict:
    """The first pair's chosen and rejected rows through the policy forward
    on the initial weights, once with the flash kernels (the model as
    configured) and once with the plain core attention: the largest logit
    gap over the core logits' standard deviation within
    ``TOL_POLICY_LOGITS``, and the flash forward's sequence log-prob equal
    to the reference pass's column for the row bit for bit (the same
    forward at the same shape).  The log-probs' gap to core attention is
    printed: a sum over a whole row, it is no sharper a test than the
    logits."""
    import dataclasses

    from neuronx_distributed_training_torch.alignment.losses import sequence_logprobs
    from neuronx_distributed_training_torch.models import llama

    arr = t.data_module.arrays
    res = {}
    for side in ("chosen", "rejected"):
        ids = torch.as_tensor(arr[f"{side}_input_ids"][:1], device=t.device)
        mask = torch.as_tensor(arr[f"{side}_loss_mask"][:1], device=t.device)
        logits, logps = {}, {}
        with torch.no_grad():
            for impl in ("flash", "core"):
                mc = dataclasses.replace(t.model_cfg, attention_impl=impl)
                logits[impl] = llama.forward(t.params, {"input_ids": ids}, mc, t.policy)[0]
                logps[impl] = float(sequence_logprobs(logits[impl], ids, mask)[0])
            diff = (logits["flash"].float() - logits["core"].float()).abs().max().item()
            spread = logits["core"].float().std().item()
        col = float(cols[f"reference_{side}_logps"][0])
        res[side] = {"logits_gap_over_std": diff / spread, "logits_max_abs": diff,
                     "logits_std": spread, "logps_flash": logps["flash"],
                     "logps_core": logps["core"], "logps_gap": abs(logps["flash"] - logps["core"]),
                     "column_gap": abs(col - logps["flash"])}
        del logits
    log(f"pref D': first pair's policy forward, flash kernels against core attention "
        f"(tol logits gap / std {TOL_POLICY_LOGITS:g}; the column bit for bit): "
        f"{json.dumps(res)} [{card}]")
    bad = [side for side, r in res.items()
           if not (r["logits_gap_over_std"] <= TOL_POLICY_LOGITS and r["column_gap"] == 0.0)]
    if bad:
        fail(f"pref D': the flash policy forward of the {bad} row disagrees with core "
             f"attention or with the reference pass's column")
    return res


def reference_pass(torch, fa, t, name: str, card: str, peak_flops: float) -> dict:
    """``t.pre_fit()`` with the launch counters set to 0 just before: its
    seconds, launches and sequences/s (the forwards that ran: fwd launches
    over layers; none when the sidecar held the columns)."""
    fa.reset_counters()
    t0 = time.perf_counter()
    t.pre_fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
    seqs = launches["flash_fwd"] // PREF_LAYERS
    rate = seqs / seconds
    mfu = rate * seq_flops(PREF_LAYERS) / peak_flops
    log(f"pref {name}: reference pass {seqs} sequences in {seconds:.3f} s, {rate:.1f} "
        f"sequences/s, MFU {mfu:.4f} (forward only), launches {launches} fallbacks "
        f"{fallbacks} [{card}]")
    if fallbacks["core"]:
        fail(f"pref {name}: the reference pass fell back to core attention {fallbacks}")
    return {"seconds": seconds, "launches": launches, "sequences": seqs,
            "sequences_per_s": rate, "mfu": mfu}


def pref_report(rep: dict, name: str, card: str, seqs_fwd_bwd: int, seqs_fwd: int,
                peak_flops: float) -> None:
    """Step seconds, sequences/s and the MFU of the sequences that run (a
    sequence with a backward counts 3 forwards), beside the logged
    ``tokens_per_sec``, which counts a pair once."""
    for rec in rep["history"]:
        flops = (3 * seqs_fwd_bwd + seqs_fwd) * seq_flops(PREF_LAYERS)
        mfu = flops / rec["step_seconds"] / peak_flops
        log(f"pref {name} step {rec['step']}: {rec['step_seconds']:.3f} s, "
            f"{(seqs_fwd_bwd + seqs_fwd) / rec['step_seconds']:.2f} sequences/s, MFU "
            f"{mfu:.4f} of the sequences that run ({seqs_fwd_bwd} with backward, {seqs_fwd} "
            f"forward only); logged tokens/s {rec['tokens_per_sec']:.1f} and MFU "
            f"{rec['mfu']:.4f} count gbs x seq; peak device memory {rep['peak_bytes']} bytes "
            f"({rep['peak_bytes'] / 2**30:.2f} GiB) [{card}]")


def phase_pref(torch, fa, card: str, peak_flops: float) -> dict:
    """Runs D (DPO: the reference pass, then 3 steps), D' (a fresh trainer
    on D's exp dir that only prepares the fit: the sidecar is read), O
    (ORPO) and K (KTO, ``kl_estimator=mismatched``) through the CLI."""
    import numpy as np

    from neuronx_distributed_training_torch.tools import step_times as cell
    from neuronx_distributed_training_torch.trainer import cli

    layers, micro, n = PREF_LAYERS, SFT_MICRO, PREF_RECORDS
    t_phase = time.perf_counter()
    out: dict = {}
    exp = cell.WORK / "exp_pref"
    try:
        for kind, config, name, extra in (
                ("dpo", "hf_llama3_8B_DPO_config.yaml", "D", ()),
                ("dpo", "hf_llama3_8B_ORPO_config.yaml", "O", ()),
                ("kto", "hf_llama3_8B_KTO_config.yaml", "K",
                 ("--set", "model_alignment_strategy.kto.kl_estimator=mismatched"))):
            shutil.rmtree(exp, ignore_errors=True)
            mismatched = name == "K"
            args = pref_args(config, kind, *extra)
            every = 2 * layers * micro
            expect = {"flash_fwd": every, "flash_dq": every // (1 + mismatched),
                      "flash_dkv": every // (1 + mismatched)}
            rep = run_sft(torch, fa, name, args, card, layers=layers, expect=expect, tag="pref",
                          prepare=lambda t, name=name: reference_pass(torch, fa, t, name, card,
                                                                      peak_flops))
            t = rep.pop("trainer")
            ref = rep["prepared"]
            want = ({"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0} if name == "O" else
                    {"flash_fwd": 2 * layers * n, "flash_dq": 0, "flash_dkv": 0})
            if ref["launches"] != want:
                fail(f"pref {name}: reference-pass launches {ref['launches']}, expected {want}")
            h0 = rep["history"][0]
            if name == "D":
                gap = abs(h0["loss"] - math.log(2))
                log(f"pref D: step-0 loss {h0['loss']:.6f}, ln 2 {math.log(2):.6f}, gap {gap:.3g} "
                    f"(expected 0: the policy is the reference); reward_margin "
                    f"{h0['reward_margin']:.3g}, rewards_chosen {h0['rewards_chosen']:.3g}")
                if gap > 1e-3 or abs(h0["reward_margin"]) > 1e-3 or \
                        abs(h0["rewards_chosen"]) > 1e-3:
                    fail("pref D: step 0 is not the reference's (loss ln 2, rewards 0)")
                cols = {k: t.data_module.arrays[k].copy() for k in
                        ("reference_chosen_logps", "reference_rejected_logps")}
                sidecar = Path(t.checkpointer.config.dir) / "dpo_reference_logps.npz"
                del t
                free_cuda(torch)
                again = cli.build(args)
                ref2 = reference_pass(torch, fa, again, "D'", card, peak_flops)
                same = all(np.array_equal(again.data_module.arrays[k], v)
                           for k, v in cols.items())
                log(f"pref D': sidecar {sidecar} exists {sidecar.exists()}, pass launches "
                    f"{ref2['launches']}, columns equal D's bit for bit: {same}")
                if not sidecar.exists() or any(ref2["launches"].values()) or not same:
                    fail("pref D': the sidecar was not reused bit for bit with no launch")
                out["D_policy_vs_core"] = policy_against_core(torch, again, cols, card)
                out["D_ref"] = ref
                again = None
            elif name == "O":
                e0 = expected_loss0()
                log(f"pref O: step-0 orpo_nll {h0['orpo_nll']:.4f}, expected {e0:.4f}")
                if abs(h0["orpo_nll"] - e0) > 0.5:
                    fail(f"pref O: step-0 orpo_nll {h0['orpo_nll']} not within 0.5 of {e0:.4f}")
            else:
                labels = t.data_module.arrays["kto_labels"]
                wd = float(t.cfg["model_alignment_strategy"]["kto"].get("desirable_weight", 1.0))
                wu = float(t.cfg["model_alignment_strategy"]["kto"].get("undesirable_weight",
                                                                        1.0))
                want0 = 0.5 * float(np.mean(np.where(labels > 0.5, wd, wu)))
                log(f"pref K: step-0 loss {h0['loss']:.6f}, expected 0.5 x mean class weight "
                    f"{want0:.6f}; kto_kl {h0['kto_kl']:.3g}; {int(labels.sum())} of "
                    f"{len(labels)} records desirable")
                if abs(h0["loss"] - want0) > 1e-3 or abs(h0["kto_kl"]) > 1e-3:
                    fail("pref K: step 0 is not the reference's (loss 0.5 x weight, kto_kl 0)")
            t = None
            pref_report(rep, name, card, 2 * micro if name != "K" else micro,
                        micro if name == "K" else 0, peak_flops)
            out[name] = rep
            free_cuda(torch)
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"pref: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 7: data parallelism under torchrun, and the non-finite step skip
# ---------------------------------------------------------------------------


def torchrun_cell(cell, nproc: int, exp: Path, timeout: float, *extra: str) -> dict:
    """Phase 4's cell under ``torchrun --standalone --nproc_per_node nproc``
    (NCCL, ``zero1: true`` unless ``extra`` overrides it), as a subprocess;
    returns rank 0's JSON line, with every rank's line under ``"ranks"``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m", "neuronx_distributed_training_torch.tools.step_times",
           "--steps", str(cell.STEPS), "--set", "distributed_strategy.zero1=true",
           "--set", f"exp_manager.exp_dir={exp}", *extra]
    log(f"dp: {' '.join(cmd[1:])}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    try:
        out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"torchrun --nproc_per_node {nproc} did not finish in {timeout:.0f} s")
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    for line in (out.stdout + out.stderr).splitlines():
        if any(k in line for k in (" step ", "distributed via", "zero1")):
            log(f"dp rank log: {line.strip()[:300]}")
    if out.returncode != 0:
        fail(f"torchrun --nproc_per_node {nproc} exited {out.returncode}:\n"
             f"{(out.stdout + out.stderr)[-3000:]}")
    lines = sorted((json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")),
                   key=lambda r: r["rank"])
    if [r["rank"] for r in lines] != list(range(nproc)):
        fail(f"torchrun --nproc_per_node {nproc} printed result lines of ranks "
             f"{[r['rank'] for r in lines]}")
    return dict(lines[0], ranks=lines)


def phase_dp(torch, cell, history4: list, card: str) -> dict:
    """7a: phase 4's cell under torchrun at world size 1 over NCCL with
    ``zero1: true``: the same losses and grad norms bit for bit, each kernel
    launched layers x microbatches x steps times, no fallback."""
    t_phase = time.perf_counter()
    log(f"dp: device memory held by this process before the launch: "
        f"{torch.cuda.memory_allocated()} bytes")
    rep = torchrun_cell(cell, 1, cell.WORK / "exp_dp1", 600)
    expect = cell.LAYERS * cell.MICROBATCHES * cell.STEPS
    want = ([r["loss"] for r in history4], [r["grad_norm"] for r in history4])
    got = (rep["loss"], rep["grad_norm"])
    log(f"dp: world size {rep['dp']}: losses {got[0]} grad_norms {got[1]}; phase 4: "
        f"{want[0]} / {want[1]}")
    log(f"dp: launches {rep['launches']} fallbacks {rep['fallbacks']} (expected {expect} each)")
    med = sorted(rep["step_seconds"][1:])[len(rep["step_seconds"][1:]) // 2]
    med4 = sorted(r["step_seconds"] for r in history4[1:])[(len(history4) - 1) // 2]
    log(f"dp: step seconds {rep['step_seconds']} (median of steps 1-{cell.STEPS - 1} "
        f"{med:.4f} s) against phase 4's {[r['step_seconds'] for r in history4]} "
        f"({med4:.4f} s) [{card}]")
    if rep["dp"] != 1 or got != want:
        fail(f"torchrun at world size 1 is not phase 4 bit for bit: {got} vs {want}")
    if any(n != expect for n in rep["launches"].values()) or rep["fallbacks"]["core"]:
        fail(f"dp launches {rep['launches']} (fallbacks {rep['fallbacks']}), expected "
             f"{expect} each")
    n_cards = torch.cuda.device_count()
    for n in (2, 4):
        if n > n_cards:
            break
        repn = torchrun_cell(cell, n, cell.WORK / f"exp_dp{n}", 600)
        log(f"dp: world size {n}: losses {repn['loss']} grad_norms {repn['grad_norm']} "
            f"steps {repn['step_seconds']}, launches per rank {repn['launches']} [{card}]")
        # the gloo tests' tolerance for dp against dp=1 (tests/test_torch_dp.py)
        if not all(math.isclose(a, b, rel_tol=1e-6) for a, b in zip(repn["loss"], want[0])) or \
                not all(math.isclose(a, b, rel_tol=1e-5)
                        for a, b in zip(repn["grad_norm"], want[1])):
            fail(f"dp={n} on the cards: losses {repn['loss']} / grad norms "
                 f"{repn['grad_norm']}, phase 4 {want}")
        if n == 2:
            phase_dp2_extra(cell, repn, card)
    if n_cards < 2:
        log(f"dp: this machine shows {n_cards} card; dp=2 on the card was not run")
    rep["phase_seconds"] = time.perf_counter() - t_phase
    log(f"dp: phase wall time {rep['phase_seconds']:.1f} s [{card}]")
    return rep


def phase_dp2_extra(cell, rep2: dict, card: str) -> None:
    """With two cards: ZeRO-1 off trains bit for bit as on, and a run saved
    at step 2 (each rank stages and writes its shards) and resumed from it
    (rank 0 verifies, every rank loads its slices) trains step 3 bit for bit
    as the straight run."""
    off = torchrun_cell(cell, 2, cell.WORK / "exp_dp2_off", 600,
                        "--set", "distributed_strategy.zero1=false")
    log(f"dp: world size 2, zero1 off: losses {off['loss']}, steps {off['step_seconds']} "
        f"[{card}]")
    if (off["loss"], off["grad_norm"]) != (rep2["loss"], rep2["grad_norm"]):
        fail(f"dp=2 zero1 off: {off['loss']} / {off['grad_norm']} differ from zero1 on "
             f"{rep2['loss']} / {rep2['grad_norm']}")
    exp = cell.WORK / "exp_dp2_resume"
    shutil.rmtree(exp, ignore_errors=True)
    try:
        # (torchrun_cell empties the exp dir it is given; --exp-dir is kept)
        runs = [torchrun_cell(cell, 2, cell.WORK / "exp_dp2_scratch", 900, "--steps",
                              str(steps), "--save-every", str(steps), "--exp-dir", str(exp))
                for steps in (2, 3)]
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    log(f"dp: world size 2, saved at step 2 then resumed: losses {runs[0]['loss']} + "
        f"{runs[1]['loss']}, steps {runs[0]['step_seconds']} + {runs[1]['step_seconds']} "
        f"[{card}]")
    got = (runs[0]["loss"] + runs[1]["loss"], runs[0]["grad_norm"] + runs[1]["grad_norm"])
    if got != (rep2["loss"], rep2["grad_norm"]):
        fail(f"dp=2 save + resume: {got} differ from the straight run "
             f"{(rep2['loss'], rep2['grad_norm'])}")


# ---------------------------------------------------------------------------
# phase 8: tensor and sequence parallelism
# ---------------------------------------------------------------------------

#: tp degrees of phase 8a: Llama-3-8B's 32 q and 8 kv heads cut by tp
TP_DEGREES = (2, 4, 8)
#: the gloo tests' mixed_precision tolerance against one rank (tests/test_torch_tp.py)
TP_LOSS_RTOL, TP_GRAD_NORM_RTOL = 1e-4, 2e-3


def grid_ctas(kname: str, b: int, s: int, nh: int, nkv: int) -> int:
    """CTAs a kernel launches (csrc: fwd and dq ``nh x ceil(s/128) x b``,
    dk/dv ``nkv x ceil(s/128) x b``)."""
    return (nkv if kname == "flash_dkv" else nh) * -(-s // 128) * b


def phase_tp_kernels(torch, fa, kt, card: str, peaks) -> list:
    """8a: the three kernels at the per-rank head counts tensor parallelism
    gives them (b 1, d 128, causal, bf16): against their plain versions at
    s 4096 with phase 2's tolerances (and on phase 2's packed segment row at
    tp 8), then timed at s 8192 (and at s 4096 for tp 8, the SFT configs'
    TP 8) with their bounds (the tp=1 bound divided by tp) and grids."""
    t_phase = time.perf_counter()
    m = kt.MAIN
    ok = True
    for tp in TP_DEGREES:
        nh, nkv = m["nh"] // tp, m["nkv"] // tp
        ok &= check_case(torch, fa, f"tp {tp}: nh {nh} nkv {nkv} s=4096", b=1, sq=4096,
                         skv=4096, nh=nh, nkv=nkv, d=m["d"], seed=30 + tp)
    seg = torch.as_tensor(sft_first_row_segments(), device="cuda")[None]
    ok &= check_case(torch, fa, f"tp 8: nh 4 nkv 1 packed segments s={SFT_SEQ}", b=1,
                     sq=SFT_SEQ, skv=SFT_SEQ, nh=m["nh"] // 8, nkv=m["nkv"] // 8, d=m["d"],
                     seg=seg, seed=39)
    if not ok:
        fail("a kernel disagrees with its plain version at a per-rank head count")
    rows = []
    cases = [(tp, SEQ) for tp in TP_DEGREES] + [(8, SFT_SEQ)]
    for tp, s in cases:
        shape = dict(m, s=s, nh=m["nh"] // tp, nkv=m["nkv"] // tp)
        gen = torch.Generator(device="cuda").manual_seed(40 + tp)
        q, k, v, do = (kt.randn_bf16(gen, 1, s, h, m["d"])
                       for h in (shape["nh"], shape["nkv"], shape["nkv"], shape["nh"]))
        with torch.no_grad():
            o, lse = fa.flash_fwd(q, k, v)
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        ms = kt.kernel_ms(q, k, v, do, lse, delta)
        bounds = bounds_ms(kt, peaks, shape)
        for kname, t in ms.items():
            row = {"tp": tp, "s": s, "nh": shape["nh"], "nkv": shape["nkv"], "ms": t,
                   "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
                   "grid_ctas": grid_ctas(kname, 1, s, shape["nh"], shape["nkv"]),
                   "kernel": kname}
            rows.append(row)
            log(f"tp time {kname} tp {tp} (nh {row['nh']}, nkv {row['nkv']}) s={s}: "
                f"{t:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
                f"{row['bound_ms'] / t:.3f} of bound, grid {row['grid_ctas']} CTAs [{card}]")
        del q, k, v, do, o, lse, delta
    gc.collect()
    torch.cuda.empty_cache()
    log(f"tp kernels: phase wall time {time.perf_counter() - t_phase:.1f} s [{card}]")
    return rows


def _median(xs: list) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def tp_run(cell, nproc: int, tp: int, name: str, ref: dict, card: str, *extra: str) -> dict:
    """Phase 4's cell at ``tp`` with SP over ``nproc`` cards: each rank
    launches each kernel layers x microbatches-per-rank x steps times with
    no fallback, and the losses and grad norms follow ``ref`` (phase 4's)
    within the mixed_precision tolerance."""
    rep = torchrun_cell(cell, nproc, cell.WORK / f"exp_{name}", 900, "--tp", str(tp), "--sp",
                        *extra)
    dp = nproc // tp
    expect = cell.LAYERS * (cell.MICROBATCHES // dp) * cell.STEPS
    steps = rep["step_seconds"][1:]
    log(f"tp: {name} (dp {rep['dp']} x tp {rep['tp']}, sp {rep['sp']}): losses {rep['loss']} "
        f"grad_norms {rep['grad_norm']}; one card: {ref['loss']} / {ref['grad_norm']}")
    log(f"tp: {name}: step seconds {rep['step_seconds']} (median of steps 1-"
        f"{cell.STEPS - 1} {_median(steps):.4f} s, one card {_median(ref['step_seconds'][1:]):.4f}"
        f" s); peak device memory per rank "
        f"{[r['peak_bytes'] for r in rep['ranks']]} bytes (one card {ref['peak_bytes']}) "
        f"[{card}]")
    for r in rep["ranks"]:
        if any(n != expect for n in r["launches"].values()) or r["fallbacks"]["core"]:
            fail(f"tp {name}: rank {r['rank']} launches {r['launches']} (fallbacks "
                 f"{r['fallbacks']}), expected {expect} each")
        if (r["loss"], r["grad_norm"]) != (rep["loss"], rep["grad_norm"]):
            fail(f"tp {name}: rank {r['rank']} logged other losses than rank 0")
    if rep["tp"] != tp or not rep["sp"] or \
            not all(math.isclose(a, b, rel_tol=TP_LOSS_RTOL)
                    for a, b in zip(rep["loss"], ref["loss"])) or \
            not all(math.isclose(a, b, rel_tol=TP_GRAD_NORM_RTOL)
                    for a, b in zip(rep["grad_norm"], ref["grad_norm"])):
        fail(f"tp {name}: losses {rep['loss']} / grad norms {rep['grad_norm']} against one "
             f"card's {ref['loss']} / {ref['grad_norm']} (rtol {TP_LOSS_RTOL:g} / "
             f"{TP_GRAD_NORM_RTOL:g})")
    return rep


def trainer_ref(history4: list) -> dict:
    """Phase 4's losses, grad norms, step seconds and peak memory: what 8b
    holds each tp run against."""
    return {"loss": [r["loss"] for r in history4],
            "grad_norm": [r["grad_norm"] for r in history4],
            "step_seconds": [r["step_seconds"] for r in history4],
            "peak_bytes": history4[0]["peak_bytes"]}


def phase_tp(torch, cell, ref: dict, card: str) -> dict | None:
    """8b, with two or more cards: ``torchrun --nproc_per_node 2`` of phase
    4's cell at tp=2 with SP over NCCL against ``ref`` (phase 4's losses,
    grad norms, step seconds and peak memory), and a tp=2 save at step 2
    resumed to step 3 bit for bit; with four, tp=4 and dp x tp = 2 x 2 as
    well.  With one card it says why it did not run and returns None."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"tp: phase 8b (tp=2 with SP on two cards) not run: this machine shows "
            f"{n_cards} card, NCCL takes one rank per card, and tp=2 needs two ranks")
        return None
    t_phase = time.perf_counter()
    out = {"tp2": tp_run(cell, 2, 2, "tp2", ref, card)}
    exp = cell.WORK / "exp_tp2_resume"
    shutil.rmtree(exp, ignore_errors=True)
    try:
        runs = [torchrun_cell(cell, 2, cell.WORK / "exp_tp2_scratch", 900, "--tp", "2",
                              "--sp", "--steps", str(steps), "--save-every", str(steps),
                              "--exp-dir", str(exp)) for steps in (2, 3)]
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    got = (runs[0]["loss"] + runs[1]["loss"], runs[0]["grad_norm"] + runs[1]["grad_norm"])
    log(f"tp: tp=2 saved at step 2 then resumed: losses {got[0]}, steps "
        f"{runs[0]['step_seconds']} + {runs[1]['step_seconds']} [{card}]")
    if got != (out["tp2"]["loss"], out["tp2"]["grad_norm"]):
        fail(f"tp=2 save + resume: {got} differ from the straight run "
             f"{(out['tp2']['loss'], out['tp2']['grad_norm'])}")
    if n_cards >= 4:
        out["tp4"] = tp_run(cell, 4, 4, "tp4", ref, card)
        out["dp2_tp2"] = tp_run(cell, 4, 2, "dp2_tp2", ref, card)
    else:
        log(f"tp: this machine shows {n_cards} cards; tp=4 and dp x tp = 2 x 2 were not run")
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"tp: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 10: context parallelism
# ---------------------------------------------------------------------------

#: hf_llama3_70B_CP_config.yaml's attention: 64 q and 8 kv heads of 128, seq 32768, cp 2
CP_SHAPE = dict(nh=64, nkv=8, d=128, s=32768, cp=2)
#: 10a's per-rank heads: those of tp 1 and tp 8
CP_TP = (1, 8)
CP_WINDOW = 4096
#: launches of each kernel by one 10a case's bodies over the two virtual
#: ranks: the ring's rank 0 computes its diagonal chunk, rank 1 that and its
#: past chunk; zig-zag 2 cp + 1 = 5 pairs a rank; Ulysses one call a rank
CP_BODY_LAUNCHES = {"ring": 3, "zigzag_ring": 10, "ulysses": 2}
CP_FUSIONS = {"ring": "ring_attention", "zigzag_ring": "zigzag_ring_attention",
              "ulysses": "ulysses_attention"}
CP_70B_CONFIG = REPO / "examples" / "conf" / "hf_llama3_70B_CP_config.yaml"


def loopback(torch, bodies: list) -> list:
    """Drive the body generator of every virtual context rank in lock step
    (``parallel/ring_attention.py``, ``parallel/ulysses.py``), answering each
    round of yields as the group would: ``post`` (the handle is the previous
    rank's tensors), ``wait`` (the handle back), ``all_to_all`` (chunk ``r`` of every rank's buffer to rank
    ``r``), ``all_gather`` (every rank's slice along dim 1)."""
    n = len(bodies)
    requests = [next(b) for b in bodies]
    while True:
        op = requests[0][0]
        sends = [r[1] for r in requests]
        if op == "post":  # the handle is what the previous rank posted
            recv = [sends[(r - 1) % n] for r in range(n)]
        elif op == "wait":
            recv = sends
        elif op == "all_to_all":
            recv = [[torch.stack([sends[i][j][r] for i in range(n)])
                     for j in range(len(sends[0]))] for r in range(n)]
        else:
            recv = [[torch.cat([sends[i][j] for i in range(n)], dim=1)
                     for j in range(len(sends[0]))] for r in range(n)]
        out, done = [None] * n, 0
        for r, body in enumerate(bodies):
            try:
                requests[r] = body.send(recv[r])
            except StopIteration as stop:
                out[r], done = stop.value, done + 1
        if done:
            if done != n:
                fail(f"loopback: {done} of {n} bodies ended")
            return out


def cp_bodies(torch, ring, uly, impl: str, q, k, v, do, *, cp: int, window=None):
    """o, dq, dk, dv of ``impl``'s bodies over ``cp`` virtual ranks, stitched
    back to the whole sequence in its original order, and the merged lse
    (None for Ulysses).  The ring and zig-zag bodies run their own backward
    (``ring_backward``); Ulysses's goes through autograd, the loopback's
    all-to-alls being torch ops."""
    b, s, nh, d = q.shape
    nkv, sq = k.shape[2], s // cp
    if impl == "ulysses":
        mult = uly.kv_replication(nkv, 1, cp)
        parts = [[x[:, r * sq:(r + 1) * sq].detach().clone().requires_grad_(True)
                  for r in range(cp)] for x in (q, k, v)]

        def body(r):
            kk, vv = (x[r].repeat_interleave(mult, dim=2) for x in parts[1:])
            return uly.ulysses_body(parts[0][r], kk, vv, None, cp=cp, causal=True,
                                    window=window)

        o = torch.cat(loopback(torch, [body(r) for r in range(cp)]), dim=1)
        o.backward(do)
        return (o.detach(), *[torch.cat([p.grad for p in x], dim=1) for x in parts], None)
    order = ring.zigzag_positions(s, cp, device=q.device) if impl == "zigzag_ring" else None
    if order is not None:
        q, k, v, do = (x.index_select(1, order) for x in (q, k, v, do))
    rows = [slice(r * sq, (r + 1) * sq) for r in range(cp)]
    plans = [ring.zigzag_plan(r, cp, sq, d, nh, nkv) if order is not None else
             ring.ring_plan(r, cp, sq, d, nh, nkv, window=window) for r in range(cp)]
    if any(p.route.name != "flash" for p in plans):
        fail(f"cp {impl}: the chunks at these shapes do not take the flash route")
    kvs = [torch.stack([k[:, x], v[:, x]]) for x in rows]
    with torch.no_grad():
        fwd = loopback(torch, [ring.ring_forward(q[:, rows[r]], kvs[r], None, plans[r])
                               for r in range(cp)])
        bwd = loopback(torch, [ring.ring_backward(q[:, rows[r]], kvs[r], None, *fwd[r],
                                                  do[:, rows[r]], plans[r]) for r in range(cp)])
    o, dq = torch.cat([f[0] for f in fwd], 1), torch.cat([g[0] for g in bwd], 1)
    dk, dv = (torch.cat([g[1][i] for g in bwd], 1) for i in (0, 1))
    lse = torch.cat([f[1] for f in fwd], 2)
    del fwd, bwd, kvs
    if order is not None:
        inv = torch.argsort(order)
        o, dq, dk, dv = (x.index_select(1, inv) for x in (o, dq, dk, dv))
        lse = lse.index_select(2, inv)
    return o, dq, dk, dv, lse


def cp_check(torch, fa, ring, uly, name: str, impl: str, *, nh: int, nkv: int, window=None,
             seed: int) -> dict:
    """One 10a case at seq 32768, bf16, causal: every virtual rank's body,
    forward and backward, with the launch counters set to 0 just before; the
    stitched o and dq/dk/dv against ``flash_attention`` over the whole
    sequence (its kernels) and against the plain version on kv head 0's
    group of query heads (each query head alone: the plain scores of all
    heads at this length would not fit), at phase 2's tolerances."""
    d, s, cp = CP_SHAPE["d"], CP_SHAPE["s"], CP_SHAPE["cp"]
    q, k, v, do = make_inputs(torch, 1, s, s, nh, nkv, d, seed)
    fa.reset_counters()
    o, dq, dk, dv, lse = cp_bodies(torch, ring, uly, impl, q, k, v, do, cp=cp, window=window)
    torch.cuda.synchronize()
    launches, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
    res = {"launches": launches}
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o_f = fa.flash_attention(qg, kg, vg, causal=True, sliding_window=window)
    o_f.backward(do)
    o_f = o_f.detach()
    res.update(o_err_flash=o_err(o, o_f), dq_rel_flash=rel_err(dq, qg.grad),
               dk_rel_flash=rel_err(dk, kg.grad), dv_rel_flash=rel_err(dv, vg.grad))
    del qg, kg, vg, o_f
    kw = dict(causal=True, window=window)
    dk_p = torch.zeros((1, s, 1, d), dtype=torch.float32, device="cuda")
    dv_p = torch.zeros_like(dk_p)
    worst = {"o_err": 0.0, "lse_abs": 0.0, "dq_rel": 0.0}
    k0, v0 = k[:, :, :1], v[:, :, :1]
    with torch.no_grad():
        for j in range(nh // nkv):
            qj, doj = q[:, :, j:j + 1], do[:, :, j:j + 1]
            o_p, lse_p = fa.flash_fwd_plain(qj, k0, v0, **kw)
            delta = (doj.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
            worst["o_err"] = max(worst["o_err"], o_err(o[:, :, j:j + 1], o_p))
            if lse is not None:
                worst["lse_abs"] = max(worst["lse_abs"], abs_err(lse[:, j:j + 1], lse_p))
            dq_p = fa.flash_dq_plain(qj, k0, v0, doj, lse_p, delta, **kw)
            worst["dq_rel"] = max(worst["dq_rel"], rel_err(dq[:, :, j:j + 1], dq_p))
            del dq_p
            dkj, dvj = fa.flash_dkv_plain(qj, k0, v0, doj, lse_p, delta, **kw)
            dk_p += dkj.float()
            dv_p += dvj.float()
            del o_p, lse_p, delta, dkj, dvj
    res.update(worst, dk_rel=rel_err(dk[:, :, :1], dk_p), dv_rel=rel_err(dv[:, :, :1], dv_p))
    del q, k, v, do, o, dq, dk, dv, lse, dk_p, dv_p
    gc.collect()
    torch.cuda.empty_cache()
    want = CP_BODY_LAUNCHES[impl]
    tol_o = TOL_O if impl == "ulysses" else TOL_O_STITCHED
    ok = (max(res["o_err"], res["o_err_flash"]) <= tol_o and res["lse_abs"] <= TOL_LSE_ABS
          and max(v for k_, v in res.items() if "_rel" in k_) <= TOL_GRAD_REL
          and all(math.isfinite(v) for k_, v in res.items() if k_ != "launches")
          and all(n == want for n in launches.values())
          and not fallbacks["core"] and not fallbacks["blockwise"])
    log(f"cp check {name}: " + " ".join(
        f"{k_}={v:.3e}" if isinstance(v, float) else f"{k_}={v}" for k_, v in res.items())
        + f" fallbacks={fallbacks} (launches {want} each; tol o_err {tol_o:g}, lse "
        f"{TOL_LSE_ABS:g} abs, grads {TOL_GRAD_REL:g} rel)" + ("" if ok else "  <-- FAIL"))
    if not ok:
        fail(f"cp {name}: the bodies disagree with whole-sequence flash or the plain version, "
             f"or launched other than {want} times each")
    return res


def visible_pairs(torch, sq: int, skv: int, *, causal: bool, window, q_offset: int) -> int:
    """(query, key) pairs one head of a call sees: key ``j`` is visible to
    query ``i`` when ``j <= q_offset + i`` (causal) and ``j > q_offset + i -
    window`` (a window)."""
    qpos = q_offset + torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(qpos, max=skv - 1) if causal else torch.full_like(qpos, skv - 1)
    lo = (torch.clamp(qpos - window + 1, min=0) if window is not None
          else torch.zeros_like(qpos))
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def cp_calls(tp: int) -> dict:
    """The distinct kernel calls of the 10a bodies at tp's per-rank heads:
    ``label: (sq, skv, nh, nkv, causal, window, q_offset)``."""
    s, cp = CP_SHAPE["s"], CP_SHAPE["cp"]
    nh, nkv = CP_SHAPE["nh"] // tp, CP_SHAPE["nkv"] // tp
    sq, hc = s // cp, s // (2 * cp)
    mult = max(1, cp // nkv) if nkv % cp else 1  # Ulysses's kv replication
    calls = {
        "ring diagonal": (sq, sq, nh, nkv, True, None, 0),
        "ring past chunk": (sq, sq, nh, nkv, False, None, 0),
        "zig-zag diagonal half": (hc, hc, nh, nkv, True, None, 0),
        "zig-zag whole half": (hc, hc, nh, nkv, False, None, 0),
        "ulysses whole sequence": (s, s, nh // cp, nkv * mult // cp, True, None, 0),
    }
    if tp == 1:
        calls["ring diagonal, window"] = (sq, sq, nh, nkv, True, CP_WINDOW, 0)
        calls["ring past chunk, window"] = (sq, sq, nh, nkv, False, CP_WINDOW, sq)
    return calls


def cp_times(torch, fa, kt, peaks, card: str) -> list:
    """CUDA-event ms of each kernel at each distinct per-rank call of the
    bodies, beside its bound (by this call's visible pairs) and grid."""
    rows = []
    d = CP_SHAPE["d"]
    for tp in CP_TP:
        for label, (sq, skv, nh, nkv, causal, window, q_offset) in cp_calls(tp).items():
            q, k, v, do = make_inputs(torch, 1, sq, skv, nh, nkv, d, 60 + tp)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            with torch.no_grad():
                o, lse = fa.flash_fwd(q, k, v, **kw)
                delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
                ms = {"flash_fwd": kt.cuda_ms(lambda: fa.flash_fwd(q, k, v, **kw)),
                      "flash_dq": kt.cuda_ms(
                          lambda: fa.flash_dq(q, k, v, do, lse, delta, **kw)),
                      "flash_dkv": kt.cuda_ms(
                          lambda: fa.flash_dkv(q, k, v, do, lse, delta, **kw))}
            pairs = nh * visible_pairs(torch, sq, skv, causal=causal, window=window,
                                       q_offset=q_offset)
            bounds = bounds_for(peaks, b=1, sq=sq, skv=skv, nh=nh, nkv=nkv, d=d, pairs=pairs)
            for kname, t in ms.items():
                row = {"tp": tp, "call": label, "sq": sq, "skv": skv, "nh": nh, "nkv": nkv,
                       "causal": causal, "window": window, "q_offset": q_offset, "ms": t,
                       "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
                       "grid_ctas": (nkv if kname == "flash_dkv" else nh) * -(
                           -(skv if kname == "flash_dkv" else sq) // 128),
                       "kernel": kname}
                rows.append(row)
                log(f"cp time {kname} tp {tp} {label} (sq {sq}, skv {skv}, nh {nh}, nkv "
                    f"{nkv}): {t:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}),"
                    f" {row['bound_ms'] / t:.3f} of bound, grid {row['grid_ctas']} CTAs "
                    f"[{card}]")
            del q, k, v, do, o, lse, delta
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_cp_bodies(torch, fa, kt, card: str, peaks) -> dict:
    """10a: the ring, zig-zag ring and Ulysses bodies of both virtual ranks
    of cp 2 in this process (the loopback stands in for the point-to-point
    shifts and the all-to-alls), forward and backward, at the 70B CP
    config's attention (seq 32768, bf16) with the per-rank heads of tp 1 and
    tp 8, plus the ring with a window of 4096 (past chunks where whole tiles
    and rows see no key); then each distinct kernel call timed."""
    from neuronx_distributed_training_torch.parallel import ring_attention as ring
    from neuronx_distributed_training_torch.parallel import ulysses as uly

    t_phase = time.perf_counter()
    cases = {}
    seed = 50
    for tp in CP_TP:
        nh, nkv = CP_SHAPE["nh"] // tp, CP_SHAPE["nkv"] // tp
        for impl in ("ring", "zigzag_ring", "ulysses"):
            name = f"{impl} tp {tp} (nh {nh}, nkv {nkv})"
            cases[name] = cp_check(torch, fa, ring, uly, name, impl, nh=nh, nkv=nkv,
                                   seed=seed)
            seed += 1
    name = f"ring tp 1 window {CP_WINDOW}"
    cases[name] = cp_check(torch, fa, ring, uly, name, "ring", nh=CP_SHAPE["nh"],
                           nkv=CP_SHAPE["nkv"], window=CP_WINDOW, seed=seed)
    rows = cp_times(torch, fa, kt, peaks, card)
    launches = {k: sum(c["launches"][k] for c in cases.values()) for k in fa.LAUNCHES}
    stitched = max(max(c["o_err"], c["o_err_flash"]) for n, c in cases.items()
                   if not n.startswith("ulysses"))
    log(f"cp bodies: launches over the {len(cases)} cases {launches}; largest stitched "
        f"(ring, zig-zag) o_err {stitched:.3f} of {TOL_O_STITCHED:g}; phase wall time "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"cases": cases, "rows": rows, "launches": launches}


def cp_run_launches(fusion: str, cp_rank: int, layers: int, micro: int, steps: int) -> int:
    """Each kernel's launches on one rank of a cp = 2 trainer run (the
    forward's twice that under full remat, which runs it again in the
    backward)."""
    per = {"ring_attention": cp_rank + 1, "zigzag_ring_attention": 5,
           "ulysses_attention": 1}[fusion]
    return per * layers * micro * steps


def phase_cp(torch, cell, ref: dict, card: str) -> dict | None:
    """10b, with two or more cards: phase 4's cell (Llama-3-8B width, 4
    layers, seq 8192) under ``torchrun --nproc_per_node 2`` at cp 2 with
    each of the three fusions, against ``ref`` (phase 4's) within the
    mixed_precision tolerance, with each rank's launches; with four cards,
    the 70B CP config at its width and seq 32768, one layer, tp 2 x cp 2:
    step seconds and peak memory per rank.  With one card it says why it
    did not run and returns None."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"cp: phase 10b (cp=2 on two cards) not run: this machine shows {n_cards} card, "
            f"NCCL takes one rank per card, and cp=2 needs two ranks")
        return None
    t_phase = time.perf_counter()
    out = {}
    for impl, fusion in CP_FUSIONS.items():
        rep = torchrun_cell(cell, 2, cell.WORK / f"exp_cp_{impl}", 900,
                            "--set", "distributed_strategy.context_parallel_size=2",
                            "--set", f"model.fusions.{fusion}=true")
        steps = rep["step_seconds"][1:]
        log(f"cp: {fusion} at cp {rep['cp']}: losses {rep['loss']} grad_norms "
            f"{rep['grad_norm']}; one card: {ref['loss']} / {ref['grad_norm']}")
        log(f"cp: {fusion}: step seconds {rep['step_seconds']} (median of steps 1-"
            f"{cell.STEPS - 1} {_median(steps):.4f} s, one card "
            f"{_median(ref['step_seconds'][1:]):.4f} s); peak device memory per rank "
            f"{[r['peak_bytes'] for r in rep['ranks']]} bytes; launches per rank "
            f"{[r['launches'] for r in rep['ranks']]} [{card}]")
        for r in rep["ranks"]:
            want = cp_run_launches(fusion, r["rank"], cell.LAYERS, cell.MICROBATCHES, cell.STEPS)
            if any(n != want for n in r["launches"].values()) or any(r["fallbacks"].values()):
                fail(f"cp {fusion}: rank {r['rank']} launches {r['launches']} (fallbacks "
                     f"{r['fallbacks']}), expected {want} each")
            if (r["loss"], r["grad_norm"]) != (rep["loss"], rep["grad_norm"]):
                fail(f"cp {fusion}: rank {r['rank']} logged other losses than rank 0")
        if rep["cp"] != 2 or \
                not all(math.isclose(a, b, rel_tol=TP_LOSS_RTOL)
                        for a, b in zip(rep["loss"], ref["loss"])) or \
                not all(math.isclose(a, b, rel_tol=TP_GRAD_NORM_RTOL)
                        for a, b in zip(rep["grad_norm"], ref["grad_norm"])):
            fail(f"cp {fusion}: losses {rep['loss']} / grad norms {rep['grad_norm']} against "
                 f"one card's {ref['loss']} / {ref['grad_norm']}")
        out[impl] = rep
    if n_cards >= 4:
        rep = torchrun_cell(cell, 4, cell.WORK / "exp_cp_70b", 1500, "--config",
                            str(CP_70B_CONFIG), "--tp", "2", "--sp",
                            "--set", "distributed_strategy.context_parallel_size=2",
                            "--set", "distributed_strategy.pipeline_model_parallel_size=1",
                            "--set", "model.num_layers=1")
        log(f"cp: 70B CP config, 1 layer, tp {rep['tp']} x cp {rep['cp']}, seq 32768: losses "
            f"{rep['loss']} grad_norms {rep['grad_norm']} step seconds {rep['step_seconds']};"
            f" peak device memory per rank {[r['peak_bytes'] for r in rep['ranks']]} bytes "
            f"[{card}]")
        for r in rep["ranks"]:
            # world ranks lay out (context, model): the context rank is rank // tp;
            # the config's full remat runs each forward twice
            want = cp_run_launches("ring_attention", r["rank"] // 2, 1, cell.MICROBATCHES,
                                   cell.STEPS)
            want = {"flash_fwd": 2 * want, "flash_dq": want, "flash_dkv": want}
            if r["launches"] != want or any(r["fallbacks"].values()):
                fail(f"cp 70B: rank {r['rank']} launches {r['launches']} (fallbacks "
                     f"{r['fallbacks']}), expected {want} each")
        if not all(math.isfinite(x) for x in rep["loss"] + rep["grad_norm"]):
            fail(f"cp 70B: non-finite losses {rep['loss']} / grad norms {rep['grad_norm']}")
        out["70b_tp2_cp2"] = rep
    else:
        log(f"cp: this machine shows {n_cards} cards; the 70B CP config at tp 2 x cp 2 was "
            f"not run")
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"cp: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


SKIP_LAYERS = 2


def device_digest(torch, t) -> tuple:
    """Two int64 sums over a tensor's bit pattern (plain and position
    weighted), taken on the card in chunks: equal digests, equal bits."""
    bits = t.detach().reshape(-1).view({1: torch.int8, 2: torch.int16,
                                        4: torch.int32}[t.element_size()])
    s1 = s2 = 0
    for i in range(0, bits.numel(), 1 << 26):
        c = bits[i:i + (1 << 26)].to(torch.int64)
        w = torch.arange(i, i + c.numel(), device=c.device, dtype=torch.int64) % 65521 + 1
        s1 += int(c.sum())
        s2 += int((c * w).sum())
    return s1, s2


def phase_skip(torch, fa, cell, card: str) -> None:
    """7b: 3 steps at Llama-3-8B width and 2 layers, the step-1 batch with a
    NaN ``loss_mask``: step 1 keeps params, mu, nu and the AdamW step bit
    for bit (on-device digests), ``health/skipped_count`` is 1, and step 2
    is finite and moves the params."""
    import numpy as np

    from neuronx_distributed_training_torch.config.loader import load_config
    from neuronx_distributed_training_torch.data.loader import SyntheticDataModule
    from neuronx_distributed_training_torch.models.llama import named_params
    from neuronx_distributed_training_torch.trainer import cli
    from neuronx_distributed_training_torch.trainer.loop import Trainer

    class PoisonedRows(SyntheticDataModule):
        def global_batches(self):
            for i, batch in enumerate(super().global_batches()):
                if i == 1:
                    batch["loss_mask"] = np.full_like(batch["loss_mask"], np.nan)
                yield batch

    t_phase = time.perf_counter()
    args = cell.CLI_ARGS + ["--set", f"model.num_layers={SKIP_LAYERS}",
                            "--set", f"exp_manager.exp_dir={cell.WORK / 'exp_skip'}"]
    overrides = cli.parse_overrides([a for a in args[2:] if a != "--set"])
    cfg = load_config(args[1], overrides)
    health = cfg.exp_manager.telemetry.health
    log(f"skip: telemetry.health {dict(health)}; {SKIP_LAYERS} layers")
    data = PoisonedRows(cfg.model.vocab_size, cfg.data.seq_length, cfg.data.global_batch_size,
                        seed=int(cfg.get("seed", 1234)))
    fa.reset_counters()
    trainer = Trainer.from_config(cfg, data_module=data, enable_checkpointing=False)
    seen: list = []

    def snapshot():
        torch.cuda.synchronize()
        o = trainer.opt_state
        seen.append({
            "params": [device_digest(torch, t) for t in named_params(trainer.params).values()],
            "mu": [device_digest(torch, t) for t in o["mu"].values()],
            "nu": [device_digest(torch, t) for t in o["nu"].values()],
            "step": o["step"], "health": dict(o["health"])})

    try:
        history = run_cli_handlers(trainer.fit, *[AtStepEnd(i, snapshot) for i in range(3)])
    finally:
        shutil.rmtree(cell.WORK / "exp_skip", ignore_errors=True)
    torch.cuda.synchronize()
    launches, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
    expect = SKIP_LAYERS * cell.MICROBATCHES * 3
    for r in history:
        log(f"skip: step {r['step']}: loss {r['loss']} grad_norm {r['grad_norm']} "
            f"updates_finite {r['health/updates_finite']} skipped_count "
            f"{r['health/skipped_count']} ({r['step_seconds']:.3f} s) [{card}]")
    log(f"skip: AdamW step after each step {[s['step'] for s in seen]}, health "
        f"{seen[-1]['health'] if seen else None}; launches {launches} fallbacks {fallbacks}")
    if len(seen) != 3 or len(history) != 3:
        fail(f"skip: {len(history)} steps and {len(seen)} snapshots, expected 3")
    kept = all(seen[1][k] == seen[0][k] for k in ("params", "mu", "nu", "step"))
    if not kept or history[1]["health/skipped_count"] != 1.0 or \
            history[1]["health/updates_finite"] != 0.0:
        fail(f"skip: the NaN step was not skipped bit for bit: kept {kept}, metrics "
             f"{ {k: v for k, v in history[1].items() if k.startswith('health/')} }")
    if not math.isfinite(history[2]["loss"]) or seen[2]["params"] == seen[1]["params"] or \
            seen[2]["step"] != 2 or seen[2]["health"]["skipped_count"] != 1:
        fail(f"skip: step 2 did not train on: loss {history[2]['loss']}, step "
             f"{seen[2]['step']}, health {seen[2]['health']}")
    if any(n != expect for n in launches.values()) or fallbacks["core"]:
        fail(f"skip: launches {launches} (fallbacks {fallbacks}), expected {expect} each")
    log(f"skip: step 1 kept {len(seen[1]['params'])} params and their moments bit for bit; "
        f"phase wall time {time.perf_counter() - t_phase:.1f} s [{card}]")


def ptxas_report(log_text: str) -> dict:
    """{(kernel, head_dim): {"registers": n, "spill_stores": n, "spill_loads": n}}
    from nvcc's ``-Xptxas -v`` output, for the flash kernels."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)",
                      line.strip())
        if m:
            k = re.search(r"(flash_(?:fwd|dq|dkv)_kernel)ILi(\d+)E", m.group(1))
            name = (k.group(1), int(k.group(2))) if k else None
            continue
        if name is None:
            continue
        rec = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rec["spill_stores"], rec["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
    return out


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(REPO))
    try:
        from neuronx_distributed_training_torch.ops import flash_attention as fa
        from neuronx_distributed_training_torch.tools import kernel_times as kt
        from neuronx_distributed_training_torch.tools import step_times as cell
        from neuronx_distributed_training_torch.utils import build as kbuild
        from neuronx_distributed_training_torch.utils import perf
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"card: {card}")
    device_name = torch.cuda.get_device_name(0)
    peaks = perf.card_peaks(device_name)
    if peaks is None:
        fail(f"no published peaks for card {device_name!r} in utils/perf.py CARD_PEAKS")
    t0 = time.perf_counter()
    try:
        kbuild.build_all()
    except RuntimeError as e:
        fail(str(e))
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kbuild.last_build_seconds if kbuild.last_build_seconds else 0.0:.1f} s)")
    ptxas = {}
    for lib_name, lib in kbuild.build_all().items():
        text = lib.with_suffix(".log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {lib_name}: {line.strip()}")
        ptxas.update(ptxas_report(text))
    for kname in ("flash_fwd_kernel", "flash_dkv_kernel", "flash_dq_kernel"):
        for d in (64, 128):
            if "registers" not in ptxas.get((kname, d), {}):
                fail(f"no ptxas report for {kname}<{d}>")
    spilling = {f"{k}<{d}>": r for (k, d), r in ptxas.items()
                if r.get("spill_stores") or r.get("spill_loads")}
    if spilling:
        fail(f"ptxas reports spills: {spilling}")

    phase_checks(torch, fa, kt, card)
    times = phase_times(torch, fa, kt, card, peaks)
    try:
        launches, history4 = phase_trainer(torch, fa, cell, card)
    finally:
        shutil.rmtree(cell.WORK / "exp_synthetic", ignore_errors=True)
    free_cuda(torch)
    phase_resume(torch, fa, cell, card)
    free_cuda(torch)
    sft = phase_sft(torch, fa, card)
    free_cuda(torch)
    dp = phase_dp(torch, cell, history4, card)
    free_cuda(torch)
    phase_skip(torch, fa, cell, card)
    free_cuda(torch)
    tp_rows = phase_tp_kernels(torch, fa, kt, card, peaks)
    tp = phase_tp(torch, cell, trainer_ref(history4), card)
    free_cuda(torch)
    pref = phase_pref(torch, fa, card, peaks[0])
    free_cuda(torch)
    cp_bodies_rep = phase_cp_bodies(torch, fa, kt, card, peaks)
    cp = phase_cp(torch, cell, trainer_ref(history4), card)

    replaces = {
        "flash_fwd": ("neuronx_distributed_training_torch/csrc/flash_fwd.cu",
                      "neuronx_distributed_training_tpu/ops/flash_attention.py:112"),
        "flash_dq": ("neuronx_distributed_training_torch/csrc/flash_dq.cu",
                     "neuronx_distributed_training_tpu/ops/flash_attention.py:253"),
        "flash_dkv": ("neuronx_distributed_training_torch/csrc/flash_dkv.cu",
                      "neuronx_distributed_training_tpu/ops/flash_attention.py:318"),
    }
    kernels = []
    for kname, (src, rep) in replaces.items():
        t = times[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[kname], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "registers": ptxas[(kname + "_kernel", kt.MAIN["d"])]["registers"],
            "launches_by_path": {"pretrain": launches[kname],
                                 **{f"sft_{r}": sft[r]["launches"][kname] for r in "LSF"},
                                 "pretrain_dp": dp["launches"][kname],
                                 "align_dpo": pref["D"]["launches"][kname],
                                 "align_dpo_ref": pref["D_ref"]["launches"][kname],
                                 "align_orpo": pref["O"]["launches"][kname],
                                 "align_kto": pref["K"]["launches"][kname],
                                 **({} if tp is None else
                                    {"pretrain_tp": tp["tp2"]["launches"][kname]}),
                                 "cp_bodies": cp_bodies_rep["launches"][kname],
                                 **({} if cp is None else
                                    {"pretrain_cp": {impl: [r["launches"][kname]
                                                            for r in cp[impl]["ranks"]]
                                                     for impl in CP_FUSIONS}})},
            "per_rank_shapes": [{k: v for k, v in r.items() if k != "kernel"}
                                for r in tp_rows if r["kernel"] == kname],
            "cp_per_rank_shapes": [{k: v for k, v in r.items() if k != "kernel"}
                                   for r in cp_bodies_rep["rows"] if r["kernel"] == kname],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
