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

11. the dense Llama configs at their own meshes:
   a. phase 4's cell again with ``model.fusions.chunked_ce=8`` (the fused
      head + CE of ``hf_llama3.1_405B_config.yaml``, over 8 vocab blocks):
      every microbatch's loss through the chunked head, losses and grad
      norms within the ``mixed_precision`` tolerance of phase 4's, the flash
      launches of phase 4, and a peak device memory below phase 4's; it
      prints both runs' step seconds, tokens/s, MFU and peak memory;
   b. the three kernels at the per-rank heads that KV replication gives the
      flagship's tp 16 (2 q heads, 1 kv head) and tp 32 (1 and 1), s 8192:
      against their plain versions at phase 2's tolerances, then timed with
      their bounds and grids, as 8a;
   c. with two or more cards, DPO from ``hf_llama3_8B_DPO_config.yaml`` (4
      layers, seq 2048, phase 9's records) under torchrun at cp 2 with the
      ring against cp 1: steps 0-1 (policy = reference) at ln 2 with grad
      norms within the ``mixed_precision`` tolerance, step 2 within twice
      the spread of two one-card attentions.  With one card it prints why
      it did not run.

12. pipeline parallelism (``parallel/pipeline.py``) at vp 1:
   a. phase 4's cell (Llama-3-8B width, 4 layers, seq 8192, mbs 1,
      ``mixed_precision``, flash) through the pipeline executor, every
      virtual rank in this one process through the library's loopback (one
      card holds one NCCL rank): pp 2 and pp 4, each with ``1f1b`` and
      ``wavefront``, at 4 and 8 microbatches, and pp 2 ``1f1b`` at 4
      microbatches with a ``loss_mask`` that gives them different valid
      counts; each against the unpipelined forward and backward on the same
      weights and rows (normalized by the global count): the loss within
      1e-4 and each gradient leaf within 2e-3 of its largest entry; the two
      schedules against each other (their largest gap, and whether they are
      bit for bit equal); launches summed over the virtual ranks exact (dq
      and dk/dv layers x microbatches, fwd that under ``1f1b`` and twice
      that under ``wavefront``, whose backward recomputes the stage); per
      virtual rank the stage seconds (CUDA events) and the most
      microbatches' graphs alive at once (``1f1b``: ``pp - r``; ``wavefront``
      one, with its microbatches' stage inputs held), and per run the
      process's peak device memory and the work table's predicted bubble;
   b. ``hf_llama3_70B_config.yaml``'s width (hidden 8192, ffn 28672, 64 / 8
      heads of 128, vocab 128256, seq 8192) at 2 layers, pp 2, 4
      microbatches, ``1f1b``, against the unpipelined pass (its gradients
      kept on the host) at 12a's bars, with the reckoned and the measured
      peak; then the three kernels at this attention shape timed beside
      their bounds and SDPA's forward and backward;
   c. with two or more cards, phase 4's cell through the CLI under
      ``torchrun --nproc_per_node 2`` at pp 2 (``schedule: 1f1b``) against
      phase 4 (losses 1e-4, grad norms 2e-3), each rank's launches exact, a
      save at step 2 resumed bit for bit at pp 2 and restored at pp 1; with
      four cards pp 4 and pp 2 x tp 2 (SP).  With one card it prints why
      it did not run.

13. the rest of pipeline parallelism (the virtual pipeline, ``1f1b-zb``,
   the chunked head, preference alignment and cp under pp), every virtual
   rank in this one process through the loopback unless said otherwise,
   each run against the unpipelined pass on the same weights and rows at
   12a's bars with 12a's launch counts, per rank its stage seconds and
   in-flight counts and per run the process's peak:
   a. ``hf_llama3_70B_v5p_config.yaml``'s pipeline shape (pp 4 x vp 2, one
      layer a chunk, 8 layers, 8 microbatches with an uneven mask, seq
      8192) at the widths its tp 8 gives each card (hidden 8192, 8 q and 1
      kv heads of 128, ffn 3584, vocab slice 16032), ``1f1b-interleaved``
      and the vp 2 wavefront, the two against each other; then the kernels
      at these heads timed beside their bounds;
   b. the 405B config's knobs, ``1f1b-interleaved`` at pp 2 x vp 3 with
      ``fusions.chunked_ce=8``, at phase 4's width (6 layers, 4
      microbatches), against the unpipelined chunked head (each
      microbatch's loss once through it on both sides);
   c. ``1f1b-zb`` at 12a's pp 4, nm 8 cell against ``1f1b`` on the same
      rows, with each rank's pending weight passes and the deferred store's
      bytes;
   d. DPO and KTO at pp 2 (the wavefront over DPO's concatenated forward
      and KTO's loss hook) at phase 9's cell (4 layers, seq 2048, 4
      microbatches of two pairs or examples) against the same hooks run
      unpipelined, and against phase 9's loss functions (the gradients at
      phase 2's tolerance: the concatenated forward rounds each weight
      gradient once where the loss function's two forwards round it
      twice);
   e. with four or more cards, phase 4's cell through the CLI under
      torchrun at pp 2 x cp 2 with the ring against phase 4, each rank's
      launches exact.  With fewer cards it prints why it did not run.

14. Mixtral (MoE), tp and ep cut to 1:
   a. ``hf_mixtral_8x7b_config.yaml`` (dropless) through the CLI at full
      width (hidden 4096, ffn 14336, 8 experts top 2, 32 / 8 heads of 128,
      vocab 32000, seq 4096, window 4096) cut to 2 layers, 4 microbatches,
      3 steps: finite values, the step-0 LM and router losses near their
      expected values, 24 launches of each kernel, the group-size host
      syncs a step (layers x microbatches), a second run from the seed
      equal bit for bit; then the kernels at this attention shape against
      their plain versions and timed beside their bounds;
   b. ``hf_mixtral_8x7b_dropped_config.yaml`` (capacity 1.25) the same way,
      with the share of routes dropped;
   c. one MoE layer at full width alone (4096 tokens, bf16): the dropless
      grouped product against every expert on every token, the dropped
      path against JAX's dispatch / combine einsums, each timed (forward,
      and forward + backward) beside its bound;
   d. with four cards, 14a's cell under torchrun at dp 2 x ep 2 and tp 2 x
      ep 2 against ep 1 at the same microbatching, and an ep 2 save
      restored at ep 1.  With fewer cards it prints why it did not run.
15. The Megatron GPT family (``models/gpt.py``), on one card:
   a. ``megatron_gpt_config.yaml`` through the CLI at its full width
      (hidden 4096, ffn 16384, 32 / 8 heads of 128, vocab 50257, seq 2048,
      layernorm + bias, gelu, tied, rope) cut to 4 layers at tp 1, 4
      microbatches of 2 rows, 3 steps: step 0's loss near ln 50257 +
      sigma^2/2, finite losses and grad norms, 48 launches of each kernel;
      step seconds, tokens/s, MFU (GPT's count) and peak memory printed;
   b. ``megatron_mistral_config.yaml`` (rmsnorm, swiglu, no bias, untied) at
      full width, 4 layers, one seq-4096 row: the GPT forward + backward
      against the port's Llama model on the same weights through
      ``tools/convert.py``, loss and every gradient at 12a's bars, and
      whether bit for bit;
   c. 15a's cell at 2 layers with hidden and embedding dropout 0.1: two runs
      from one seed bit for bit, a SIGTERM at step 2's boundary resumed to
      the straight run's step 3 bit for bit (loss, grad norm, every param's
      digest), the dropout-0 run's losses different;
   d. the shipped ``megatron_mixtral_8x7b`` and ``_dropless`` cut as 14a /
      14b: launches exact, the dropped share printed;
   e. ``megatron_llama_70b_config.yaml``'s pp 4 (the wavefront, as JAX's
      gate keeps GPT) through the loopback at its tp-32 per-card widths
      (hidden 8192, 2 q and 1 kv heads of 128, ffn 896, vocab 1000), 4
      layers, 4 microbatches, against the unpipelined pass at 12a's bars;
   then the three kernels at ``megatron_gpt``'s attention (b 2, s 2048)
   against their plain versions and timed beside their bounds;
   f. with two or more cards, 15a's cell under torchrun at tp 2 (and tp 4
      with four cards; the padded vocab slices) against tp 1, and at
      dropout 0.1 tp 2 against tp 1.  With one card it prints why it did not
      run.

16. the fit loop as shipped, phase 4's cell unless a line says otherwise:
   a. the flagship's own ``exp_manager.telemetry`` block and
      ``log_every_n_steps: 10`` for 20 steps through the CLI:
      ``metrics.jsonl`` holds steps 10 and 20 alone, each with ``time/*``,
      ``goodput_fraction``, ``throughput_seqs_per_sec``,
      ``throughput_peak``, ``step_time``, ``mfu`` and the ``device_*``
      keys; ``run_summary.json`` the census and ``goodput``; steps 0-2 equal
      phase 4's bit for bit; 320 launches of each kernel; no synchronizing
      CUDA call inside steps 2-19's dispatch (``torch.cuda``'s sync debug
      mode around ``Trainer._dispatch``); it prints the windows' step_time
      against phase 4's median step (a sync a step), the spans, goodput,
      the census, and AdamW over phase 4's state with and without the
      skip's select;
   b. phase 7b's NaN ``loss_mask`` at 2 layers under ``skip_update`` at
      ``log_every_n_steps: 2``: ``anomaly_00000001/`` with ``anomaly.json``
      and ``ring.json``, step 1 keeps params, moments and step bit for bit;
      then ``halt`` stops at that boundary without a checkpoint;
   c. EMA (decay 0.99, ``evaluate_ema_weights_instead``) at 2 layers for 3
      steps: the EMA against an fp32 recomputation on the host from each
      step's weights, the validation loss on EMA weights, the params bit for
      bit after the swap back, peak memory with EMA and without (the run
      without saves at step 3);
   d. a warm start from 16c's save: params bit for bit, step, moments and
      data position fresh.
17. the converters and the planes ``tiny_smoke_config.yaml`` turns on:
   a. an HF-named Llama-3-8B-width state dict at SKIP_LAYERS layers, drawn
      from a seed on the card, written as ``pytorch_model.bin`` (bf16);
      ``tools/checkpoint_converter.py hf2native``; the LoRA SFT config
      warm-started from it for 3 steps against the same weights handed over
      in memory (bit for bit, exact launches); ``native2hf`` back bit for
      bit;
   b. 16a's cadence for 40 steps with tiny_smoke's tensorstats, fleet,
      control, memory and alerts blocks: 0 syncs inside a dispatch, the
      windows' step_time against 16a's (window 3 the planes alone),
      tensorstats' share of AdamW, ``memory_summary.json``'s attribution
      against ``tree_bytes_by_subsystem``, a ``tools/run_ctl.py
      checkpoint_now`` enqueued at step 25 saving at the step-30 boundary,
      exact launches;
   c. phase 4's cell at micro batch 64 in a subprocess: an OOM that writes
      ``oom_<step>/`` and exits 1 (the JAX CLI's code for it).

18. the trace plane, profiling windows and engineered overlap:
   a. 16a's cell for 10 steps at ``log_every_n_steps: 1`` with
      ``telemetry.trace: {enabled: true, start_step: 2, num_steps: 3}`` and
      ``profile_start_step: 6, profile_num_steps: 2``: 160 launches of each
      kernel, 48 of each in the window's op table, each one's device time a
      launch within 10% of CUDA events around its launches in the untraced
      steps (phase 3's time printed beside), three per-step attributions within
      their steps' wall time, no overlap (no collectives on one card), the
      raw ``trace/`` removed, ``profile/`` written, ``run_summary.json``'s
      trace section, ``tools/trace_report.py`` rendering the summary, no
      synchronizing call inside a dispatch outside the two windows; it
      prints the traced and untraced step times, the top 10 ops and the
      busy share;
   b. with two or more cards, phase 7's torchrun cell at dp 2 (and dp 4)
      per leaf and with ``overlap: {zero1_bucket_mb: 256, prefetch_ag:
      true}``, and at pp 2 without and with ``pp_double_buffer``, each with a
      trace window: bit for bit (losses, grad norms, every rank's state
      digest), printing each collective class's overlap and exposed seconds,
      the all-gathers a step and the measured bubble.  With one card it
      prints why it did not run.

The script prints each phase's wall time and, before its result lines, its
own.  The line before the last holds the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Without a card, or without the package,
it exits non-zero and prints no result.  ``--only 13`` (or ``13a,13c``,
``13e``, ``14``, ``14a,14c``, ``14d``, ``15``, ``15f``, ``16``, ``17``, ``18``) runs the kernels'
build and those phases alone (13e, 16 and 17 after phase 4, 17 after 16a, 18 after phase 3;
14a and 14b are one function) and prints no result: a partial check while developing.
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
#: the script's start, for its total wall time
T_START = time.perf_counter()
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


# ---------------------------------------------------------------------------
# phase 11: the dense Llama configs at their own meshes
# ---------------------------------------------------------------------------

#: phase 11a: hf_llama3.1_405B_config.yaml's fusions.chunked_ce
CHUNKED_CE = 8
#: phase 11c: DPO's step 2, the first after a non-zero update (the config's
#: warmup gives step 0 lr 0): Adam moves every weight by about lr whatever
#: its gradient's size, and the DPO loss reads the policy-reference margin,
#: a difference of sums over 2048 tokens, so equivalent attentions round
#: it apart.  At cp 1 on an NVIDIA H100 80GB HBM3 (700 W) this step read
#: 0.6607 with flash and 0.6380 with core attention, grad norms 429.3 and
#: 414.1; step 2 is held to about twice that spread, steps 0-1 (the policy
#: is the reference) to the mixed_precision tolerance.
PREF_STEP2_LOSS_ATOL, PREF_STEP2_GRAD_NORM_RTOL = 0.05, 0.07
#: phase 11b: the flagship's tp 16 and tp 32 over its 32 q and 8 kv heads:
#: (tp, per-rank q heads, per-rank kv heads after replication)
REPLICATED_TP = ((16, 2, 1), (32, 1, 1))


def phase_chunked(torch, fa, cell, history4: list, launches4: dict, card: str) -> dict:
    """11a: phase 4's cell again with ``model.fusions.chunked_ce=8`` (the
    fused head + CE over 8 vocab blocks): each microbatch's loss goes
    through the chunked head, the losses and grad norms follow phase 4's
    within the mixed_precision tolerance, the flash kernels launch as in
    phase 4, and the peak device memory is below phase 4's."""
    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.trainer import cli

    t_phase = time.perf_counter()
    calls = []
    fused = llama._chunked_head_loss

    def counted(*a, **kw):
        calls.append(1)
        return fused(*a, **kw)

    llama._chunked_head_loss = counted
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counters()
    try:
        history = cli.main(cell.CLI_ARGS + ["--set", f"model.fusions.chunked_ce={CHUNKED_CE}"])
    finally:
        llama._chunked_head_loss = fused
        shutil.rmtree(cell.WORK / "exp_synthetic", ignore_errors=True)
    torch.cuda.synchronize()
    launches, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
    peak, peak4 = torch.cuda.max_memory_allocated(), history4[0]["peak_bytes"]
    for name, hist, pk in (("unchunked (phase 4)", history4, peak4),
                           (f"chunked_ce={CHUNKED_CE}", history, peak)):
        for r in hist:
            log(f"chunked: {name} step {r['step']}: loss {r['loss']:.6f} grad_norm "
                f"{r['grad_norm']:.6f} step {r['step_seconds']:.3f} s, "
                f"{r['tokens_per_sec']:.1f} tokens/s, MFU {r['mfu']:.4f} [{card}]")
        log(f"chunked: {name}: peak device memory {pk} bytes ({pk / 2**30:.2f} GiB) [{card}]")
    log(f"chunked: head calls {len(calls)}, launches {launches} (phase 4 {launches4}), "
        f"fallbacks {fallbacks}; peak {peak / 2**30:.2f} GiB against phase 4's "
        f"{peak4 / 2**30:.2f} GiB ({(peak4 - peak) / 2**30:.2f} GiB less) [{card}]")
    expect_calls = cell.MICROBATCHES * cell.STEPS
    if len(history) != cell.STEPS or len(calls) != expect_calls:
        fail(f"chunked: {len(history)} steps and {len(calls)} chunked-head calls, expected "
             f"{cell.STEPS} and {expect_calls}")
    if launches != launches4 or fallbacks["core"]:
        fail(f"chunked: launches {launches} (fallbacks {fallbacks}), phase 4 {launches4}")
    for k, rtol in (("loss", TP_LOSS_RTOL), ("grad_norm", TP_GRAD_NORM_RTOL)):
        got, want = [r[k] for r in history], [r[k] for r in history4]
        if not all(math.isfinite(a) and math.isclose(a, b, rel_tol=rtol)
                   for a, b in zip(got, want)):
            fail(f"chunked: {k} {got} against phase 4's {want} (rtol {rtol:g})")
    if peak >= peak4:
        fail(f"chunked: peak device memory {peak} bytes, not below phase 4's {peak4}")
    out = {"history": history, "launches": launches, "peak_bytes": peak,
           "peak_bytes_unchunked": peak4, "phase_seconds": time.perf_counter() - t_phase}
    log(f"chunked: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_replicated_kernels(torch, fa, kt, card: str, peaks) -> list:
    """11b: the three kernels at the per-rank heads that KV replication
    gives the flagship at tp 16 (2 q heads, 1 kv head) and tp 32 (1 and 1),
    b 1, s 8192, d 128, causal, bf16: against their plain versions at phase
    2's tolerances, then timed with their bounds (the per-rank work: the
    tp=1 bound over tp) and grids, as 8a."""
    t_phase = time.perf_counter()
    m = kt.MAIN
    ok = True
    for tp, nh, nkv in REPLICATED_TP:
        ok &= check_case(torch, fa, f"tp {tp}: nh {nh} nkv {nkv} (replicated) s={SEQ}", b=1,
                         sq=SEQ, skv=SEQ, nh=nh, nkv=nkv, d=m["d"], seed=50 + tp)
    if not ok:
        fail("a kernel disagrees with its plain version at KV replication's per-rank heads")
    rows = []
    for tp, nh, nkv in REPLICATED_TP:
        shape = dict(m, s=SEQ, nh=nh, nkv=nkv)
        gen = torch.Generator(device="cuda").manual_seed(60 + tp)
        q, k, v, do = (kt.randn_bf16(gen, 1, SEQ, h, m["d"]) for h in (nh, nkv, nkv, nh))
        with torch.no_grad():
            o, lse = fa.flash_fwd(q, k, v)
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        ms = kt.kernel_ms(q, k, v, do, lse, delta)
        bounds = bounds_ms(kt, peaks, shape)
        for kname, t in ms.items():
            row = {"tp": tp, "s": SEQ, "nh": nh, "nkv": nkv, "ms": t,
                   "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
                   "grid_ctas": grid_ctas(kname, 1, SEQ, nh, nkv), "kernel": kname}
            rows.append(row)
            log(f"replicated kv time {kname} tp {tp} (nh {nh}, nkv {nkv}) s={SEQ}: "
                f"{t:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
                f"{row['bound_ms'] / t:.3f} of bound, grid {row['grid_ctas']} CTAs [{card}]")
        del q, k, v, do, o, lse, delta
    free_cuda(torch)
    log(f"replicated kv kernels: phase wall time {time.perf_counter() - t_phase:.1f} s [{card}]")
    return rows


def phase_pref_cp(torch, cell, card: str) -> dict | None:
    """11c, with two or more cards: DPO from ``hf_llama3_8B_DPO_config.yaml``
    (Llama-3-8B width, 4 layers, seq 2048, gbs 4, 3 steps, phase 9's
    records) under torchrun at cp 2 with the ring against the same at cp 1:
    steps 0-1 (the policy is still the reference) at ln 2 with grad norms
    within the mixed_precision tolerance, step 2 within
    ``PREF_STEP2_*``, no fallback on either rank.  With one card it says
    why it did not run and returns None."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"pref cp: phase 11c (DPO at cp=2 on two cards) not run: this machine shows "
            f"{n_cards} card, NCCL takes one rank per card, and cp=2 needs two ranks")
        return None
    t_phase = time.perf_counter()
    base = ("--config", str(REPO / "examples" / "conf" / "hf_llama3_8B_DPO_config.yaml"),
            "--set", f"data.train_dir={pref_corpus('dpo')}",
            "--set", "data.tokenizer.library=char")
    one = torchrun_cell(cell, 1, cell.WORK / "exp_dpo_cp1", 900, *base)
    two = torchrun_cell(cell, 2, cell.WORK / "exp_dpo_cp2", 900, *base,
                        "--set", "distributed_strategy.context_parallel_size=2",
                        "--set", "model.fusions.ring_attention=true")
    log(f"pref cp: DPO cp 2 (ring): losses {two['loss']} grad_norms {two['grad_norm']} step "
        f"seconds {two['step_seconds']}; cp 1: {one['loss']} / {one['grad_norm']} / "
        f"{one['step_seconds']}; peak per rank {[r['peak_bytes'] for r in two['ranks']]} bytes "
        f"(cp 1 {one['peak_bytes']}); launches per rank {[r['launches'] for r in two['ranks']]}"
        f" [{card}]")
    for r in two["ranks"] + one["ranks"]:
        if r["fallbacks"]["core"] or not all(r["launches"].values()):
            fail(f"pref cp: rank {r['rank']} launches {r['launches']} fallbacks {r['fallbacks']}")
    early = (all(abs(x - math.log(2)) <= 1e-3 for x in two["loss"][:2] + one["loss"][:2])
             and all(math.isclose(a, b, rel_tol=TP_GRAD_NORM_RTOL)
                     for a, b in zip(two["grad_norm"][:2], one["grad_norm"][:2])))
    late = (abs(two["loss"][2] - one["loss"][2]) <= PREF_STEP2_LOSS_ATOL
            and math.isclose(two["grad_norm"][2], one["grad_norm"][2],
                             rel_tol=PREF_STEP2_GRAD_NORM_RTOL))
    if two["cp"] != 2 or len(two["loss"]) != 3 or not (early and late):
        fail(f"pref cp: DPO at cp 2 {two['loss']} / {two['grad_norm']} against cp 1's "
             f"{one['loss']} / {one['grad_norm']}")
    out = {"cp1": one, "cp2": two, "phase_seconds": time.perf_counter() - t_phase}
    log(f"pref cp: phase wall time {out['phase_seconds']:.1f} s [{card}]")
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
            "step": int(o["step"]), "health": {k: int(v) for k, v in o["health"].items()}})

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


# ---------------------------------------------------------------------------
# phase 12: pipeline parallelism
# ---------------------------------------------------------------------------

#: 12a's runs at phase 4's cell: (pp, microbatches), each with both schedules
PP_RUNS = ((2, 4), (2, 8), (4, 4), (4, 8))
PP_SCHEDULES = ("1f1b", "wavefront")
#: each gradient leaf against the unpipelined one, relative to its largest
#: entry (the loss is held at TP_LOSS_RTOL)
PP_GRAD_REL = 2e-3
PP_SEED = 20261101
PP_70B_CONFIG = REPO / "examples" / "conf" / "hf_llama3_70B_config.yaml"
PP_70B_LAYERS, PP_70B_MICRO = 2, 4
#: the 70B configs' attention at seq 8192: 64 q and 8 kv heads of 128
PP_70B_ATTN = dict(b=1, s=SEQ, nh=64, nkv=8, d=128)


class StageTimer:
    """A virtual rank's stage seconds, the ``timer`` of
    ``parallel/pipeline.py::stage_body``: CUDA events around each of its
    computations, summed after a synchronize."""

    def __init__(self, torch):
        self.torch, self.spans = torch, []

    def __call__(self):
        import contextlib

        @contextlib.contextmanager
        def span():
            ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            yield
            ev[1].record()
            self.spans.append(ev)

        return span()

    def total(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans) / 1e3


def pp_model(torch, config: Path, layers: int, pp: int, *, vp: int = 1, card_tp: int = 1,
             extra: dict | None = None):
    """``(LlamaConfig, DtypePolicy, params)`` of ``config`` cut to
    ``layers`` layers at tp 1, as the trainer builds them on the card
    (flash, ``mixed_precision``, random weights from the config's seed), the
    whole model in this one process: the loopback's virtual ranks share it.
    ``card_tp``: the widths that tp gives each card (the heads, the ffn and
    the vocab cut ``card_tp`` ways, the hidden size and head size kept);
    ``extra``: more config overrides."""
    import dataclasses

    from neuronx_distributed_training_torch.config import loader
    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

    cfg = loader.load_config(config, {"model.num_layers": layers,
                                      "distributed_strategy.pipeline_model_parallel_size": pp,
                                      "distributed_strategy.virtual_pipeline_model_parallel_size":
                                          vp,
                                      "distributed_strategy.tensor_model_parallel_size": 1,
                                      "distributed_strategy.sequence_parallel": False,
                                      **(extra or {})})
    mc = llama.LlamaConfig.from_config(cfg["model"], cfg["distributed_strategy"])
    if card_tp > 1:
        mc = dataclasses.replace(
            mc, num_attention_heads=mc.num_attention_heads // card_tp,
            num_kv_heads=max(mc.kv_heads // card_tp, 1), head_dim=mc.head_size,
            intermediate_size=mc.intermediate_size // card_tp,
            vocab_size=-(-mc.vocab_size // card_tp))
    policy = DtypePolicy.from_precision_config(cfg.get("precision"))
    gen = torch.Generator(device="cuda").manual_seed(int(cfg.get("seed", 1234)))
    params = llama.init_params(mc, policy, generator=gen, device="cuda")
    for t in llama.named_params(params).values():
        t.requires_grad_(True)
    return mc, policy, params


def pp_rows(torch, vocab: int, nm: int, masked: bool, seed: int) -> list:
    """``nm`` microbatches of one seeded row each; ``masked``: microbatch m
    loses the first ``m * SEQ / (2 nm)`` positions from its ``loss_mask``,
    so the microbatches hold different valid counts."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, vocab, (nm, 1, SEQ), generator=gen, device="cuda")
    out = []
    for m in range(nm):
        mb = {"input_ids": ids[m], "labels": ids[m]}
        if masked:
            mask = torch.ones(1, SEQ, device="cuda")
            mask[:, :(m * SEQ) // (2 * nm)] = 0.0
            mb["loss_mask"] = mask
        out.append(mb)
    return out


def pp_reference(torch, mc, policy, params, mbs: list, denom, *, host: bool) -> tuple:
    """The unpipelined forward and backward on the same weights and rows,
    normalized by the global count (the pipelined rule): ``(loss, {name:
    fp32 gradient})``, on the host with ``host`` (12b: the card holds the
    pipelined run next), else on the card.  The gradients accumulate in the
    fp32 leaves' ``.grad`` (no second copy on the card), which is left
    empty."""
    from neuronx_distributed_training_torch.models import llama

    leaves = llama.named_params(params)
    loss = None
    for mb in mbs:
        lm = llama.forward(params, mb, mc, policy, loss_denominator=denom)[0].float()
        lm.backward()
        loss = lm.detach() if loss is None else loss + lm.detach()
        del lm
    out = {}
    for n, t in leaves.items():
        out[n] = t.grad.float().cpu() if host else t.grad
        t.grad = None
    free_cuda(torch)
    return float(loss), out


def pp_grad_gap(torch, grads: dict, ref: dict) -> tuple:
    """``(largest gap over leaves, its leaf, bit for bit?)``: each leaf's
    largest |difference| relative to the reference leaf's largest entry,
    on the card (a host reference leaf is moved there one at a time)."""
    worst, where, same = 0.0, None, True
    for n, r in ref.items():
        g = grads[n].float() if n in grads else torch.zeros_like(r, device="cuda")
        r = r.to(g.device)
        gap = float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
        same &= bool(torch.equal(g, r))
        if gap > worst or where is None:
            worst, where = gap, n
    return worst, where, same


def pp_run(torch, fa, pipeline, hooks, params, mbs, denom, schedule: str, pp: int, policy,
           card: str, tag: str, vp: int = 1) -> dict:
    """One loopback step of every virtual rank, with the launch counters set
    to 0 just before and read just after: the loss, the gradients (on the
    card), the launches, each rank's stage seconds and in-flight counts, the
    process's peak memory and the work table's predicted bubble."""
    from neuronx_distributed_training_torch.models import llama

    leaves = llama.named_params(params)
    stats = [{} for _ in range(pp)]
    timers = [StageTimer(torch) for _ in range(pp)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counters()
    t0 = time.perf_counter()
    loss, grads = pipeline.loopback_step(params, hooks, mbs, denom, schedule, pp, leaves=leaves,
                                         act_dtype=policy.compute_dtype,
                                         grad_dtype=policy.grad_accum_dtype, stats=stats,
                                         timers=timers, vp=vp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"loss": float(loss), "grads": grads, "launches": dict(fa.LAUNCHES),
           "fallbacks": dict(fa.FALLBACKS), "stage_seconds": [t.total() for t in timers],
           "stats": stats, "peak_bytes": torch.cuda.max_memory_allocated(), "wall": wall,
           "bubble": pipeline.predicted_bubble_fraction(schedule, pp, len(mbs), vp)}
    for r in range(pp):
        deferred = "" if "deferred_max" not in stats[r] else (
            f", weight passes pending at most {stats[r]['deferred_max']} "
            f"({stats[r]['deferred_bytes_max']} bytes)")
        log(f"pp: {tag} rank {r}: stage {out['stage_seconds'][r]:.4f} s, graphs alive at most "
            f"{stats[r]['graphs_max']}, stage inputs held at most {stats[r]['inputs_max']}"
            f"{deferred} [{card}]")
    log(f"pp: {tag}: loss {out['loss']:.6f}, stage seconds by rank "
        f"{[round(t, 4) for t in out['stage_seconds']]}, wall {wall:.3f} s for all {pp} virtual "
        f"ranks in turn, peak device memory of the process {out['peak_bytes']} bytes "
        f"({out['peak_bytes'] / 2**30:.2f} GiB), predicted bubble {out['bubble']:.4f}, "
        f"launches {out['launches']} [{card}]")
    return out


def pp_check(tag: str, run: dict, ref_loss: float, ref: dict, *, layers: int, nm: int,
             pp: int, schedule: str, torch, vp: int = 1) -> dict:
    """12a / 12b's bars: loss and every leaf against the unpipelined pass,
    exact launches (the wavefront's recompute counted), and the in-flight
    counts of the schedule (``1f1b-interleaved``: at most Megatron's warm-up
    plus one; ``1f1b-zb``: ``1f1b``'s, and at most ``r + 1`` weight passes
    pending)."""
    from neuronx_distributed_training_torch.parallel import pipeline

    gap, leaf, same = pp_grad_gap(torch, run["grads"], ref)
    loss_rel = abs(run["loss"] - ref_loss) / abs(ref_loss)
    log(f"pp: {tag}: against the unpipelined pass: loss {run['loss']:.6f} vs {ref_loss:.6f} "
        f"(rel {loss_rel:.2e}, bar {TP_LOSS_RTOL:g}); largest gradient gap {gap:.3e} of its "
        f"leaf's largest entry ({leaf}; bar {PP_GRAD_REL:g}); bit for bit {same}")
    if not loss_rel <= TP_LOSS_RTOL or not gap <= PP_GRAD_REL:
        fail(f"pp {tag}: against the unpipelined pass, loss rel {loss_rel:.3e}, gradient gap "
             f"{gap:.3e} at {leaf}")
    fwd = layers * nm * (2 if schedule == "wavefront" else 1)
    want = {"flash_fwd": fwd, "flash_dq": layers * nm, "flash_dkv": layers * nm}
    if run["launches"] != want or run["fallbacks"]["core"]:
        fail(f"pp {tag}: launches {run['launches']} (fallbacks {run['fallbacks']}), "
             f"expected {want}")
    graphs = [s["graphs_max"] for s in run["stats"]]
    inputs = [s["inputs_max"] for s in run["stats"]]
    if schedule in ("1f1b", "1f1b-zb"):
        ok = graphs == [min(pp - r, nm) for r in range(pp)] and not any(inputs)
        if schedule == "1f1b-zb":
            ok &= [s["deferred_max"] for s in run["stats"]] == [min(r + 1, nm)
                                                                for r in range(pp)]
    elif schedule == "1f1b-interleaved":
        ok = not any(inputs) and all(
            g <= pipeline.warmup_bound(schedule, pp, nm, vp, r) for r, g in enumerate(graphs))
    else:
        ok = graphs == [1] * pp and inputs == [nm * (vp - 1)] + [nm * vp] * (pp - 1)
    if not ok:
        fail(f"pp {tag}: graphs alive {graphs}, stage inputs held {inputs} per rank")
    return {"loss_rel": loss_rel, "grad_gap": gap, "bitwise_vs_unpipelined": same}


def phase_pp_loopback(torch, fa, card: str) -> dict:
    """12a: phase 4's cell (Llama-3-8B width, 4 layers, seq 8192, mbs 1,
    ``mixed_precision``, flash) through the pipeline executor, every virtual
    rank in this process: pp 2 and 4 at 4 and 8 microbatches with each
    schedule, and pp 2 at 4 microbatches with an uneven ``loss_mask``,
    each against the unpipelined pass on the same weights and rows, and the
    two schedules against each other."""
    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.parallel import pipeline

    t_phase = time.perf_counter()
    cfg_path = REPO / "examples" / "conf" / "hf_llama3_8B_config.yaml"
    mc, policy, params = pp_model(torch, cfg_path, 4, 1)
    hooks = llama.pipeline_hooks(mc, policy)
    out: dict = {"runs": {}}
    cases: dict = {}
    for pp, nm in PP_RUNS:
        cases.setdefault((nm, False), []).append(pp)
    cases[(4, True)] = [2]
    for (nm, masked), pps in cases.items():
        free_cuda(torch)
        mbs = pp_rows(torch, mc.vocab_size, nm, masked, PP_SEED + nm)
        denom = sum(llama.loss_token_count(mb) for mb in mbs)
        t0 = time.perf_counter()
        ref_loss, ref = pp_reference(torch, mc, policy, params, mbs, denom, host=False)
        log(f"pp: unpipelined pass, {nm} microbatches{' masked' if masked else ''}: loss "
            f"{ref_loss:.6f}, valid tokens {float(denom):.0f} ({time.perf_counter() - t0:.2f} s)"
            f" [{card}]")
        for pp in pps:
            prev = None
            for schedule in ("1f1b",) if masked else PP_SCHEDULES:
                tag = f"pp{pp}_nm{nm}_{schedule}{'_masked' if masked else ''}"
                run = pp_run(torch, fa, pipeline, hooks, params, mbs, denom, schedule, pp,
                             policy, card, tag)
                rep = pp_check(tag, run, ref_loss, ref, layers=mc.num_layers, nm=nm, pp=pp,
                               schedule=schedule, torch=torch)
                grads = run.pop("grads")
                if prev is not None:
                    gap, leaf, same = pp_grad_gap(torch, grads, prev[1])
                    same = same and run["loss"] == prev[0]
                    loss_rel = abs(run["loss"] - prev[0]) / abs(prev[0])
                    log(f"pp: pp{pp}_nm{nm}: wavefront against 1f1b: loss rel {loss_rel:.2e}, "
                        f"largest gradient gap {gap:.3e} ({leaf}); bit for bit {same}")
                    if not loss_rel <= TP_LOSS_RTOL or not gap <= PP_GRAD_REL:
                        fail(f"pp pp{pp}_nm{nm}: the schedules disagree: loss rel "
                             f"{loss_rel:.3e}, gradient gap {gap:.3e} at {leaf}")
                    rep.update(vs_1f1b_gap=gap, vs_1f1b_bitwise=same)
                prev = (run["loss"], grads)
                out["runs"][tag] = {**rep, **run}
                del grads
                free_cuda(torch)
            del prev
        del ref, mbs
    del params
    free_cuda(torch)
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"pp: 12a phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_pp_70b(torch, fa, kt, card: str, peaks) -> dict:
    """12b: ``hf_llama3_70B_config.yaml``'s width (hidden 8192, ffn 28672,
    64 / 8 heads of 128, vocab 128256, seq 8192) at 2 layers, pp 2 (a layer
    a stage), 4 microbatches, ``1f1b``, through the loopback against the
    unpipelined pass (its gradients kept on the host), at 12a's bars; then
    the three kernels timed at this attention shape beside their bounds and
    SDPA's time."""
    import torch.nn.functional as F

    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.parallel import pipeline

    t_phase = time.perf_counter()
    free_cuda(torch)
    mc, policy, params = pp_model(torch, PP_70B_CONFIG, PP_70B_LAYERS, 2)
    n_params = sum(t.numel() for t in llama.named_params(params).values())
    h, v, s = mc.hidden_size, mc.vocab_size, SEQ
    reckon = {"params_and_grads": 2 * 4 * n_params,
              # bf16 logits, their fp32 copy and the fp32 softmax of one row
              "head": s * v * (2 + 4 + 4)}
    log(f"pp: 12b: {n_params} params ({n_params / 1e9:.3f} B); reckoning: fp32 params and "
        f"gradients {reckon['params_and_grads'] / 1e9:.1f} GB, one microbatch's head and CE "
        f"{reckon['head'] / 1e9:.1f} GB [{card}]")
    hooks = llama.pipeline_hooks(mc, policy)
    mbs = pp_rows(torch, v, PP_70B_MICRO, False, PP_SEED + 70)
    denom = sum(llama.loss_token_count(mb) for mb in mbs)
    t0 = time.perf_counter()
    ref_loss, ref = pp_reference(torch, mc, policy, params, mbs, denom, host=True)
    log(f"pp: 12b unpipelined pass: loss {ref_loss:.6f} ({time.perf_counter() - t0:.2f} s) "
        f"[{card}]")
    run = pp_run(torch, fa, pipeline, hooks, params, mbs, denom, "1f1b", 2, policy, card,
                 "70b_pp2_nm4_1f1b")
    rep = pp_check("70b_pp2_nm4_1f1b", run, ref_loss, ref, layers=PP_70B_LAYERS,
                   nm=PP_70B_MICRO, pp=2, schedule="1f1b", torch=torch)
    run.pop("grads")
    log(f"pp: 12b peak device memory {run['peak_bytes'] / 1e9:.1f} GB against the reckoning's "
        f"{(reckon['params_and_grads'] + reckon['head']) / 1e9:.1f} GB plus the layers' "
        f"activations, of {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB "
        f"[{card}]")
    del params, ref, mbs
    free_cuda(torch)
    # the kernels at this attention shape, as phase 3
    m = PP_70B_ATTN
    gen = torch.Generator(device="cuda").manual_seed(PP_SEED + 71)
    q, k, vv, do = (kt.randn_bf16(gen, 1, m["s"], hh, m["d"])
                    for hh in (m["nh"], m["nkv"], m["nkv"], m["nh"]))
    with torch.no_grad():
        o, lse = fa.flash_fwd(q, k, vv)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    ms = kt.kernel_ms(q, k, vv, do, lse, delta)
    bounds = bounds_ms(kt, peaks, m)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, vv))
    with torch.no_grad():
        sdpa = kt.cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                                 enable_gqa=True))
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    dot = do.transpose(1, 2)
    sdpa_bwd = kt.cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, kg, vg, is_causal=True, enable_gqa=True).backward(dot)) - sdpa
    rows = []
    for kname, t in ms.items():
        rows.append({"kernel": kname, "ms": t, "bound_ms": bounds[kname][0],
                     "bound_by": bounds[kname][1], **m})
        log(f"pp: 12b time {kname} at b 1, nh {m['nh']}, nkv {m['nkv']}, s {m['s']}, d "
            f"{m['d']}: {t:.3f} ms, bound {bounds[kname][0]:.3f} ms ({bounds[kname][1]}), "
            f"{bounds[kname][0] / t:.3f} of bound [{card}]")
    log(f"pp: 12b sdpa forward {sdpa:.3f} ms, backward (fwd+bwd minus fwd) {sdpa_bwd:.3f} ms; "
        f"dq + dk/dv kernels {ms['flash_dq'] + ms['flash_dkv']:.3f} ms [{card}]")
    del q, k, vv, do, o, lse, delta, qh, kh, vh, qg, kg, vg, dot
    free_cuda(torch)
    out = {"run": {**rep, **run}, "reckoning": reckon, "n_params": n_params, "kernels": rows,
           "sdpa_ms": sdpa, "sdpa_bwd_ms": sdpa_bwd,
           "phase_seconds": time.perf_counter() - t_phase}
    log(f"pp: 12b phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def pp_cli_run(cell, nproc: int, pp: int, name: str, ref: dict, card: str, *extra: str) -> dict:
    """Phase 4's cell under torchrun at ``pp`` (``schedule: 1f1b``) over
    ``nproc`` cards: losses and grad norms within the mixed_precision
    tolerance of ``ref`` (phase 4's: every token counts, so the pipelined
    and unpipelined rules agree), each rank's launches exact."""
    rep = torchrun_cell(cell, nproc, cell.WORK / f"exp_{name}", 900,
                        "--set", f"distributed_strategy.pipeline_model_parallel_size={pp}",
                        "--set", "distributed_strategy.pipeline.schedule=1f1b", *extra)
    tp = rep["tp"]
    dp = nproc // (pp * tp)
    expect = (cell.LAYERS // pp) * (cell.MICROBATCHES // dp) * cell.STEPS
    log(f"pp: {name} (pp {rep['pp']}, dp {rep['dp']}, tp {tp}): losses {rep['loss']} grad_norms "
        f"{rep['grad_norm']}; one card {ref['loss']} / {ref['grad_norm']}; step seconds "
        f"{rep['step_seconds']}; peak device memory per rank "
        f"{[r['peak_bytes'] for r in rep['ranks']]} bytes [{card}]")
    for r in rep["ranks"]:
        if any(n != expect for n in r["launches"].values()) or r["fallbacks"]["core"]:
            fail(f"pp {name}: rank {r['rank']} launches {r['launches']} (fallbacks "
                 f"{r['fallbacks']}), expected {expect} each")
    if rep["pp"] != pp or \
            not all(math.isclose(a, b, rel_tol=TP_LOSS_RTOL)
                    for a, b in zip(rep["loss"], ref["loss"])) or \
            not all(math.isclose(a, b, rel_tol=TP_GRAD_NORM_RTOL)
                    for a, b in zip(rep["grad_norm"], ref["grad_norm"])):
        fail(f"pp {name}: losses {rep['loss']} / grad norms {rep['grad_norm']} against one "
             f"card's {ref['loss']} / {ref['grad_norm']}")
    return rep


def phase_pp_cli(torch, cell, ref: dict, card: str) -> dict | None:
    """12c, with two or more cards: phase 4's cell through the CLI under
    torchrun at pp 2 (``1f1b``) against phase 4, a save at step 2 resumed
    at pp 2 bit for bit and restored at pp 1 (step 3 within the
    mixed_precision tolerance); with four, pp 4 and pp 2 x tp 2 (SP).  With
    one card it says why it did not run and returns None."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"pp: phase 12c (the CLI at pp 2 under torchrun) not run: this machine shows "
            f"{n_cards} card, NCCL takes one rank per card, and pp 2 needs two ranks")
        return None
    t_phase = time.perf_counter()
    out = {"pp2": pp_cli_run(cell, 2, 2, "pp2", ref, card)}
    exp = cell.WORK / "exp_pp2_resume"
    pp2 = ["--set", "distributed_strategy.pipeline_model_parallel_size=2",
           "--set", "distributed_strategy.pipeline.schedule=1f1b"]
    copy = cell.WORK / "exp_pp2_at_pp1"
    for d in (exp, copy):
        shutil.rmtree(d, ignore_errors=True)
    try:
        runs = [torchrun_cell(cell, 2, cell.WORK / "exp_pp2_scratch", 900, *pp2, "--steps", "2",
                              "--save-every", "2", "--exp-dir", str(exp))]
        shutil.copytree(exp, copy)
        at1 = torchrun_cell(cell, 1, cell.WORK / "exp_pp1_scratch", 900, "--steps", "3",
                            "--save-every", "3", "--exp-dir", str(copy))
        runs.append(torchrun_cell(cell, 2, cell.WORK / "exp_pp2_scratch", 900, *pp2, "--steps",
                                  "3", "--save-every", "3", "--exp-dir", str(exp)))
    finally:
        for d in (exp, copy):
            shutil.rmtree(d, ignore_errors=True)
    got = (runs[0]["loss"] + runs[1]["loss"], runs[0]["grad_norm"] + runs[1]["grad_norm"])
    log(f"pp: pp 2 saved at step 2 then resumed: losses {got[0]}; restored at pp 1: step 3 "
        f"loss {at1['loss']} grad_norm {at1['grad_norm']} [{card}]")
    if got != (out["pp2"]["loss"], out["pp2"]["grad_norm"]):
        fail(f"pp 2 save + resume: {got} differ from the straight run "
             f"{(out['pp2']['loss'], out['pp2']['grad_norm'])}")
    if len(at1["loss"]) != 1 or not math.isclose(at1["loss"][0], out["pp2"]["loss"][2],
                                                 rel_tol=TP_LOSS_RTOL):
        fail(f"pp 2 save restored at pp 1: step 3 {at1['loss']} against pp 2's "
             f"{out['pp2']['loss'][2]}")
    if n_cards >= 4:
        out["pp4"] = pp_cli_run(cell, 4, 4, "pp4", ref, card)
        out["pp2_tp2"] = pp_cli_run(cell, 4, 2, "pp2_tp2", ref, card, "--tp", "2", "--sp")
    else:
        log(f"pp: this machine shows {n_cards} cards; pp 4 and pp 2 x tp 2 were not run")
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"pp: 12c phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 13: the rest of pipeline parallelism
# ---------------------------------------------------------------------------

#: 13a: hf_llama3_70B_v5p_config.yaml's pipeline shape (pp 4 x vp 2, one
#: layer a chunk) at the widths its tp 8 gives each card
PP_V5P_CONFIG = REPO / "examples" / "conf" / "hf_llama3_70B_v5p_config.yaml"
PP_V5P = {"pp": 4, "vp": 2, "layers": 8, "nm": 8, "card_tp": 8}
#: 13b: hf_llama3.1_405B_config.yaml's knobs (1f1b-interleaved, chunked_ce 8)
#: at phase 4's width: pp 2 x vp 3, one layer a chunk
PP_405B_KNOBS = {"pp": 2, "vp": 3, "layers": 6, "nm": 4}
#: 13c: 12a's pp 4, nm 8 cell
PP_ZB = {"pp": 4, "nm": 8}
#: 13d: phase 9's cell (4 layers, seq 2048) at pp 2, 4 microbatches of two
#: pairs (examples) each; the preference configs' kl_beta
PP_PREF = {"pp": 2, "nm": 4, "rows": 2, "seq": 2048, "beta": 0.1}
PP_8B_CONFIG = REPO / "examples" / "conf" / "hf_llama3_8B_config.yaml"


def pp_bitwise_pair(torch, tag: str, a: dict, grads_a: dict, b: dict, grads_b: dict) -> dict:
    """Two schedules' runs on the same rows: the largest gap, bit for bit or
    not, failing past 12a's bars."""
    gap, leaf, same = pp_grad_gap(torch, grads_a, grads_b)
    same = same and a["loss"] == b["loss"]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    log(f"pp: {tag}: loss rel {loss_rel:.2e}, largest gradient gap {gap:.3e} ({leaf}); bit "
        f"for bit {same}")
    if not loss_rel <= TP_LOSS_RTOL or not gap <= PP_GRAD_REL:
        fail(f"pp {tag}: the schedules disagree: loss rel {loss_rel:.3e}, gradient gap "
             f"{gap:.3e} at {leaf}")
    return {"gap": gap, "bitwise": same}


def phase_pp_virtual(torch, fa, kt, card: str, peaks) -> dict:
    """13a: ``hf_llama3_70B_v5p_config.yaml``'s pipeline shape through the
    loopback (pp 4 x vp 2, one layer a chunk, 8 layers, 8 microbatches, seq
    8192) at the widths its tp 8 gives each card (hidden 8192, 8 q and 1 kv
    heads of 128, ffn 3584, vocab slice 16032), with ``1f1b-interleaved``
    and the vp 2 wavefront, each against the unpipelined pass (its
    gradients kept on the host) at 12a's bars and the two against each
    other; the stage seconds and graphs in flight by rank, the peak beside
    the reckoning; then the kernels at these heads with their bounds."""
    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.parallel import pipeline

    t_phase = time.perf_counter()
    free_cuda(torch)
    c = PP_V5P
    mc, policy, params = pp_model(torch, PP_V5P_CONFIG, c["layers"], c["pp"], vp=c["vp"],
                                  card_tp=c["card_tp"])
    n_params = sum(t.numel() for t in llama.named_params(params).values())
    bounds_inflight = sum(pipeline.warmup_bound("1f1b-interleaved", c["pp"], c["nm"], c["vp"], r)
                          for r in range(c["pp"]))
    log(f"pp: 13a: {mc}; {n_params} params ({n_params / 1e9:.3f} B): fp32 params and gradients "
        f"{8 * n_params / 1e9:.1f} GB; at most {bounds_inflight} chunk graphs alive over the "
        f"{c['pp']} virtual ranks [{card}]")
    hooks = llama.pipeline_hooks(mc, policy)
    mbs = pp_rows(torch, mc.vocab_size, c["nm"], True, PP_SEED + 130)
    denom = sum(llama.loss_token_count(mb) for mb in mbs)
    t0 = time.perf_counter()
    ref_loss, ref = pp_reference(torch, mc, policy, params, mbs, denom, host=True)
    log(f"pp: 13a unpipelined pass: loss {ref_loss:.6f} ({time.perf_counter() - t0:.2f} s) "
        f"[{card}]")
    out: dict = {"runs": {}, "n_params": n_params}
    prev = None
    for schedule in ("1f1b-interleaved", "wavefront"):
        tag = f"v5p_pp4_vp2_nm8_{schedule}"
        run = pp_run(torch, fa, pipeline, hooks, params, mbs, denom, schedule, c["pp"], policy,
                     card, tag, vp=c["vp"])
        rep = pp_check(tag, run, ref_loss, ref, layers=c["layers"], nm=c["nm"], pp=c["pp"],
                       schedule=schedule, torch=torch, vp=c["vp"])
        grads = run.pop("grads")
        if prev is not None:
            rep["vs_interleaved"] = pp_bitwise_pair(torch, "13a wavefront against "
                                                    "1f1b-interleaved", run, grads, *prev)
        prev = (run, grads)
        out["runs"][tag] = {**rep, **run}
        del grads
        free_cuda(torch)
    del prev, params, ref, mbs
    free_cuda(torch)
    m = {"b": 1, "s": SEQ, "nh": mc.num_attention_heads, "nkv": mc.kv_heads, "d": mc.head_size}
    gen = torch.Generator(device="cuda").manual_seed(PP_SEED + 131)
    q, k, vv, do = (kt.randn_bf16(gen, 1, m["s"], hh, m["d"])
                    for hh in (m["nh"], m["nkv"], m["nkv"], m["nh"]))
    with torch.no_grad():
        o, lse = fa.flash_fwd(q, k, vv)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    ms = kt.kernel_ms(q, k, vv, do, lse, delta)
    bounds = bounds_ms(kt, peaks, m)
    out["kernels"] = []
    for kname, t in ms.items():
        out["kernels"].append({"kernel": kname, "ms": t, "bound_ms": bounds[kname][0],
                               "bound_by": bounds[kname][1], **m})
        log(f"pp: 13a time {kname} at b 1, nh {m['nh']}, nkv {m['nkv']}, s {m['s']}, d "
            f"{m['d']}: {t:.3f} ms, bound {bounds[kname][0]:.3f} ms ({bounds[kname][1]}), "
            f"{bounds[kname][0] / t:.3f} of bound [{card}]")
    del q, k, vv, do, o, lse, delta
    free_cuda(torch)
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"pp: 13a phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_pp_chunked_vp(torch, fa, card: str) -> dict:
    """13b: the 405B config's knob combination, ``1f1b-interleaved`` at pp 2
    x vp 3 with ``fusions.chunked_ce=8``, at phase 4's width (6 layers, one
    a chunk, seq 8192, 4 microbatches, an uneven mask), against the
    unpipelined pass through the same chunked head, at 12a's bars; each
    microbatch's loss once through the chunked head."""
    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.parallel import pipeline

    t_phase = time.perf_counter()
    free_cuda(torch)
    c = PP_405B_KNOBS
    mc, policy, params = pp_model(torch, PP_8B_CONFIG, c["layers"], c["pp"], vp=c["vp"],
                                  extra={"model.fusions.chunked_ce": CHUNKED_CE})
    if mc.vocab_chunks != CHUNKED_CE:
        fail(f"pp 13b: the model's vocab_chunks {mc.vocab_chunks}, expected {CHUNKED_CE}")
    hooks = llama.pipeline_hooks(mc, policy)
    mbs = pp_rows(torch, mc.vocab_size, c["nm"], True, PP_SEED + 140)
    denom = sum(llama.loss_token_count(mb) for mb in mbs)
    calls = []
    fused = llama._chunked_head_loss

    def counted(*a, **kw):
        calls.append(kw.get("reduction", "mean"))
        return fused(*a, **kw)

    llama._chunked_head_loss = counted
    try:
        ref_loss, ref = pp_reference(torch, mc, policy, params, mbs, denom, host=False)
        ref_calls, calls[:] = list(calls), []
        tag = "405b_knobs_pp2_vp3_nm4_1f1b-interleaved"
        run = pp_run(torch, fa, pipeline, hooks, params, mbs, denom, "1f1b-interleaved",
                     c["pp"], policy, card, tag, vp=c["vp"])
    finally:
        llama._chunked_head_loss = fused
    log(f"pp: 13b unpipelined pass: loss {ref_loss:.6f}; chunked-head calls: unpipelined "
        f"{ref_calls}, pipelined {calls} [{card}]")
    if ref_calls != ["mean"] * c["nm"] or calls != ["sum"] * c["nm"]:
        fail(f"pp 13b: chunked-head calls {ref_calls} / {calls}, expected {c['nm']} each")
    rep = pp_check(tag, run, ref_loss, ref, layers=c["layers"], nm=c["nm"], pp=c["pp"],
                   schedule="1f1b-interleaved", torch=torch, vp=c["vp"])
    run.pop("grads")
    del params, ref, mbs
    free_cuda(torch)
    out = {"run": {**rep, **run}, "phase_seconds": time.perf_counter() - t_phase}
    log(f"pp: 13b phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_pp_zb(torch, fa, card: str) -> dict:
    """13c: ``1f1b-zb`` at 12a's pp 4, nm 8 cell (phase 4's width, 4 layers,
    seq 8192): against the unpipelined pass (its gradients on the host) at
    12a's bars and against ``1f1b`` on the same rows; each rank's most
    pending weight passes (``r + 1``) and the deferred store's bytes, and
    the peak beside ``1f1b``'s."""
    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.parallel import pipeline

    t_phase = time.perf_counter()
    free_cuda(torch)
    c = PP_ZB
    mc, policy, params = pp_model(torch, PP_8B_CONFIG, 4, c["pp"])
    hooks = llama.pipeline_hooks(mc, policy)
    mbs = pp_rows(torch, mc.vocab_size, c["nm"], True, PP_SEED + 150)
    denom = sum(llama.loss_token_count(mb) for mb in mbs)
    ref_loss, ref = pp_reference(torch, mc, policy, params, mbs, denom, host=True)
    out: dict = {"runs": {}}
    prev = None
    for schedule in ("1f1b", "1f1b-zb"):
        tag = f"zb_cell_pp4_nm8_{schedule}"
        run = pp_run(torch, fa, pipeline, hooks, params, mbs, denom, schedule, c["pp"], policy,
                     card, tag)
        rep = pp_check(tag, run, ref_loss, ref, layers=mc.num_layers, nm=c["nm"], pp=c["pp"],
                       schedule=schedule, torch=torch)
        grads = run.pop("grads")
        if prev is not None:
            rep["vs_1f1b"] = pp_bitwise_pair(torch, "13c 1f1b-zb against 1f1b", run, grads,
                                             *prev)
            store = [s["deferred_bytes_max"] for s in run["stats"]]
            log(f"pp: 13c deferred store at most {store} bytes by rank ({sum(store) / 2**30:.2f}"
                f" GiB together); peak {run['peak_bytes'] / 2**30:.2f} GiB against 1f1b's "
                f"{prev[0]['peak_bytes'] / 2**30:.2f} GiB [{card}]")
        prev = (run, grads)
        out["runs"][tag] = {**rep, **run}
        del grads
        free_cuda(torch)
    del prev, params, ref, mbs
    free_cuda(torch)
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"pp: 13c phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def pref_pp_rows(torch, vocab: int, kind: str, policy_fwd, c: dict) -> list:
    """13d's microbatches: ``c["rows"]`` seeded pairs (DPO) or examples
    (KTO, one desirable and one not) each, a loss mask over a seeded suffix
    of each row, and the reference log-probs of the initial policy
    (``policy_fwd``) less a seeded offset, so neither loss sits at its
    policy = reference value."""
    from neuronx_distributed_training_torch.alignment.losses import sequence_logprobs

    gen = torch.Generator(device="cuda").manual_seed(PP_SEED + 160 + (kind == "kto"))
    s, n = c["seq"], c["rows"]
    sides = ("",) if kind == "kto" else ("chosen_", "rejected_")
    out = []
    for _ in range(c["nm"]):
        mb = {}
        for side in sides:
            ids = torch.randint(0, vocab, (n, s), generator=gen, device="cuda")
            start = torch.randint(s // 8, s // 2, (n, 1), generator=gen, device="cuda")
            mask = (torch.arange(s, device="cuda")[None, :] >= start).float()
            with torch.no_grad():
                ref = sequence_logprobs(policy_fwd(ids), ids, mask)
            off = torch.rand(n, generator=gen, device="cuda") * 8.0
            mb.update({side + "input_ids": ids, side + "loss_mask": mask})
            mb["reference_" + side + "logps"] = ref - off
        if kind == "kto":
            mb["kto_labels"] = (torch.arange(n, device="cuda") % 2 == 0).float()
        out.append(mb)
    return out


def pref_reference(torch, params, mbs: list, loss_of) -> tuple:
    """An unpipelined pass over ``mbs``: ``loss_of(mb)`` each, backward,
    the gradients accumulated in the leaves' ``.grad`` and moved to the
    host: ``(loss, {name: fp32 gradient})``."""
    from neuronx_distributed_training_torch.models import llama

    leaves = llama.named_params(params)
    loss = None
    for mb in mbs:
        lm = loss_of(mb).float()
        lm.backward()
        loss = lm.detach() if loss is None else loss + lm.detach()
        del lm
    out = {n: t.grad.float().cpu() for n, t in leaves.items()}
    for t in leaves.values():
        t.grad = None
    free_cuda(torch)
    return float(loss), out


def phase_pp_pref(torch, fa, card: str) -> dict:
    """13d: DPO and KTO at pp 2 through the loopback at phase 9's cell
    (``hf_llama3_8B_DPO_config.yaml`` / ``hf_llama3_8B_KTO_config.yaml``,
    Llama-3-8B width, 4 layers, seq 2048, 4 microbatches of two pairs or
    examples), on the wavefront JAX's gate gives them (DPO's concatenated
    forward, KTO's loss hook).  Each run is held at 12a's bars against the
    same hooks run unpipelined (embed, every layer, the loss hook, on one
    stage), and against phase 9's unpipelined loss functions
    (``alignment/dpo.py``, ``alignment/kto.py``) on the same weights and
    rows, each microbatch weighted by its rows: the loss at 12a's bar, each
    gradient leaf at phase 2's ``TOL_GRAD_REL`` of its largest entry.  (The
    concatenated forward rounds a layer weight's bf16 gradient once over
    both sides where the two forwards of the loss function round it twice
    and add, and DPO's gradient is the difference of the two sides: the two
    read up to several bf16 ulps apart relative to the leaf.)"""
    from neuronx_distributed_training_torch.alignment import dpo as dpo_mod
    from neuronx_distributed_training_torch.alignment import kto as kto_mod
    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.ops import norm as norm_ops
    from neuronx_distributed_training_torch.parallel import pipeline

    t_phase = time.perf_counter()
    c = PP_PREF
    out: dict = {}
    for kind, config in (("dpo", "hf_llama3_8B_DPO_config.yaml"),
                         ("kto", "hf_llama3_8B_KTO_config.yaml")):
        free_cuda(torch)
        mc, policy, params = pp_model(torch, REPO / "examples" / "conf" / config, PREF_LAYERS,
                                      c["pp"])

        def fwd(ids, p=params, mc=mc, policy=policy):
            return llama.forward(p, {"input_ids": ids}, mc, policy)[0]

        def head(p, y, mc=mc, policy=policy):
            h = norm_ops.apply_rms_norm(p["final_norm"], y, eps=mc.rms_norm_eps)
            return llama.logits_fn(p, h, mc, policy)

        mbs = pref_pp_rows(torch, mc.vocab_size, kind, fwd, c)
        base = llama.pipeline_hooks(mc, policy)
        if kind == "dpo":
            loss_fn = dpo_mod.make_dpo_loss_fn(lambda p, ids: fwd(ids, p), beta=c["beta"])
            hooks = dpo_mod.preference_pipeline_hooks(base, head, mode="dpo", beta=c["beta"])
        else:
            loss_fn = kto_mod.make_kto_loss_fn(lambda p, ids: fwd(ids, p), beta=c["beta"])
            hooks = kto_mod.kto_pipeline_hooks(base, head, beta=c["beta"])
        rows = torch.tensor(float(c["nm"] * c["rows"]), device="cuda")
        embed_fn, stage_fn, hook_loss, _ = hooks

        def one_stage(mb, hooks=hooks):
            y = stage_fn(params["layers"], embed_fn(params, mb), mb)
            return hook_loss(params, y, mb)[0] / rows

        def loss_function(mb, loss_fn=loss_fn):
            n = float(next(iter(mb.values())).shape[0])
            return loss_fn(params, mb, torch.tensor(n, device="cuda"))[0] * n / rows

        same_loss, same = pref_reference(torch, params, mbs, one_stage)
        fn_loss, fn_grads = pref_reference(torch, params, mbs, loss_function)
        tag = f"{kind}_pp2_nm4_wavefront"
        run = pp_run(torch, fa, pipeline, hooks, params, mbs, rows, "wavefront", c["pp"], policy,
                     card, tag)
        rep = pp_check(tag, run, same_loss, same, layers=mc.num_layers, nm=c["nm"], pp=c["pp"],
                       schedule="wavefront", torch=torch)
        gap, leaf, bitwise = pp_grad_gap(torch, run["grads"], fn_grads)
        loss_rel = abs(run["loss"] - fn_loss) / abs(fn_loss)
        log(f"pp: 13d {kind}: against phase 9's loss function: loss {run['loss']:.6f} vs "
            f"{fn_loss:.6f} (rel {loss_rel:.2e}, bar {TP_LOSS_RTOL:g}); largest gradient gap "
            f"{gap:.3e} of its leaf's largest entry ({leaf}; bar {TOL_GRAD_REL:g}); bit for bit "
            f"{bitwise} [{card}]")
        if not loss_rel <= TP_LOSS_RTOL or not gap <= TOL_GRAD_REL:
            fail(f"pp 13d {kind}: against the loss function, loss rel {loss_rel:.3e}, gradient "
                 f"gap {gap:.3e} at {leaf}")
        run.pop("grads")
        out[kind] = {**rep, **run, "vs_loss_fn": {"loss_rel": loss_rel, "grad_gap": gap,
                                                  "bitwise": bitwise}}
        del params, same, fn_grads, mbs
        free_cuda(torch)
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"pp: 13d phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_pp_cp(torch, cell, ref: dict, card: str) -> dict | None:
    """13e, with four or more cards: phase 4's cell through the CLI under
    torchrun at pp 2 x cp 2 with the ring (``auto``: the wavefront, the ring
    bodies inside each stage's layers) against phase 4 (losses 1e-4, grad
    norms 2e-3), each rank's launches exact.  With fewer cards it says why
    it did not run and returns None."""
    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        log(f"pp: phase 13e (pp 2 x cp 2 under torchrun) not run: this machine shows "
            f"{n_cards} card(s), NCCL takes one rank per card, and pp 2 x cp 2 needs four")
        return None
    t_phase = time.perf_counter()
    rep = torchrun_cell(cell, 4, cell.WORK / "exp_pp2_cp2", 900,
                        "--set", "distributed_strategy.pipeline_model_parallel_size=2",
                        "--set", "distributed_strategy.context_parallel_size=2",
                        "--set", "model.fusions.ring_attention=true")
    log(f"pp: pp 2 x cp 2 (pp {rep['pp']}, cp {rep['cp']}): losses {rep['loss']} grad_norms "
        f"{rep['grad_norm']}; one card {ref['loss']} / {ref['grad_norm']}; step seconds "
        f"{rep['step_seconds']}; peak device memory per rank "
        f"{[r['peak_bytes'] for r in rep['ranks']]} bytes; launches per rank "
        f"{[r['launches'] for r in rep['ranks']]} [{card}]")
    for r in rep["ranks"]:
        # world ranks lay out (pipe, context): the wavefront runs each
        # forward twice, and the ring's context rank c makes c + 1 calls
        per = (r["rank"] % 2 + 1) * (cell.LAYERS // 2) * cell.MICROBATCHES * cell.STEPS
        want = {"flash_fwd": 2 * per, "flash_dq": per, "flash_dkv": per}
        if r["launches"] != want or r["fallbacks"]["core"]:
            fail(f"pp 2 x cp 2: rank {r['rank']} launches {r['launches']} (fallbacks "
                 f"{r['fallbacks']}), expected {want}")
    if rep["pp"] != 2 or rep["cp"] != 2 or \
            not all(math.isclose(a, b, rel_tol=TP_LOSS_RTOL)
                    for a, b in zip(rep["loss"], ref["loss"])) or \
            not all(math.isclose(a, b, rel_tol=TP_GRAD_NORM_RTOL)
                    for a, b in zip(rep["grad_norm"], ref["grad_norm"])):
        fail(f"pp 2 x cp 2: losses {rep['loss']} / grad norms {rep['grad_norm']} against one "
             f"card's {ref['loss']} / {ref['grad_norm']}")
    out = {"pp2_cp2": rep, "phase_seconds": time.perf_counter() - t_phase}
    log(f"pp: 13e phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 14: Mixtral (MoE) at full width
# ---------------------------------------------------------------------------

#: 14a / 14b: the shipped Mixtral configs on one card: 2 layers, 4
#: microbatches of one seq-4096 row, 3 steps (tp and ep cut to 1)
MIX_LAYERS, MIX_MICRO, MIX_STEPS, MIX_SEQ = 2, 4, 3, 4096
MIX_CONFIGS = {"dropless": "hf_mixtral_8x7b_config.yaml",
               "dropped": "hf_mixtral_8x7b_dropped_config.yaml"}
#: 14c: one MoE layer against its plain version, the largest gap over the
#: plain output's largest entry.  Both compute in bf16 with fp32
#: accumulation; the dropless path rounds each weighted row to bf16 before
#: the two rows of a token are added (as JAX's does), the plain version adds
#: in fp32, so they part by about a bf16 ulp of the output (2^-8 = 4e-3 of
#: an entry); the limit is five such ulps.  A row routed to a wrong expert
#: or weighted by a wrong gate moves the output by a good part of its size.
TOL_MOE = 2e-2


def mixtral_args(kind: str, *extra: str) -> list:
    """The CLI arguments of 14a / 14b: the shipped config at one card."""
    config = {**MIX_CONFIGS, **GPT_MIX_CONFIGS}[kind]
    return ["--config", str(REPO / "examples" / "conf" / config),
            "--set", f"model.num_layers={MIX_LAYERS}",
            "--set", "distributed_strategy.tensor_model_parallel_size=1",
            "--set", "distributed_strategy.expert_model_parallel_size=1",
            "--set", "distributed_strategy.sequence_parallel=false",
            "--set", f"data.global_batch_size={MIX_MICRO}",
            "--set", "data.synthetic=true",
            "--set", f"trainer.max_steps={MIX_STEPS}",
            "--set", "trainer.log_every_n_steps=1",
            "--set", f"exp_manager.exp_dir={REPO / 'build' / 'chip_smoke' / 'exp_mixtral'}",
            "--set", "exp_manager.resume_if_exists=false",
            "--set", "exp_manager.create_tensorboard_logger=false",
            "--set", "exp_manager.checkpoint_callback_params.every_n_train_steps=0",
            *extra]


def mixtral_run(torch, fa, kind: str, card: str) -> dict:
    """One 14a / 14b run through the CLI: its history, launches, peak
    memory, the group-size host syncs a step (one a MoE layer forward) and,
    on the dropped path, the share of (token, slot) routes dropped a step;
    a digest of every param after the last step."""
    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.ops import moe as moe_ops
    from neuronx_distributed_training_torch.trainer import cli

    syncs, dropped = [0], [0, 0]
    sorted_rows, keep_mask = moe_ops._sorted_rows, moe_ops.keep_mask

    def counted_rows(*a, **kw):
        syncs[0] += 1
        return sorted_rows(*a, **kw)

    def counted_keep(idx, cfg):
        keep = keep_mask(idx, cfg)
        dropped[0] += int((~keep).sum())
        dropped[1] += keep.numel()
        return keep

    moe_ops._sorted_rows, moe_ops.keep_mask = counted_rows, counted_keep
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counters()
    t0 = time.perf_counter()
    try:
        trainer, history = cli.run(mixtral_args(kind))
        torch.cuda.synchronize()
        launches, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
        digest = [device_digest(torch, t) for t in llama.named_params(trainer.params).values()]
    finally:
        moe_ops._sorted_rows, moe_ops.keep_mask = sorted_rows, keep_mask
        shutil.rmtree(REPO / "build" / "chip_smoke" / "exp_mixtral", ignore_errors=True)
    mc = trainer.model_cfg
    n_params = sum(t.numel() for t in llama.named_params(trainer.params).values())
    del trainer
    peak = torch.cuda.max_memory_allocated()
    free_cuda(torch)
    return {"history": history, "launches": launches, "fallbacks": fallbacks, "peak": peak,
            "syncs_per_step": syncs[0] / MIX_STEPS, "digest": digest, "params": n_params,
            "dropped_share": dropped[0] / dropped[1] if dropped[1] else None,
            "moe": mc.moe, "seconds": time.perf_counter() - t0}


def phase_mixtral(torch, fa, kt, card: str, peaks) -> dict:
    """14a (dropless) and 14b (dropped, capacity 1.25): the shipped Mixtral
    configs through the CLI at full width (hidden 4096, ffn 14336, 8
    experts top 2, 32 / 8 heads of 128, vocab 32000, seq 4096, window 4096)
    cut to 2 layers, tp and ep to 1: finite values, step-0 ``lm_loss``
    near its expected value and ``router_aux_loss`` near its coefficient (0.02: a
    uniform router gives 1 times it; ``lm_loss`` as ``expected_loss0``
    reckons it at vocab 32000), each kernel launched layers x
    microbatches x steps times with no fallback, and a second run from the
    same seed equal bit for bit (losses, grad norms, every param).  Then
    the three kernels at Mixtral's attention shape against their plain
    versions, timed beside their bounds."""
    t_phase = time.perf_counter()
    out = {}
    expect = MIX_LAYERS * MIX_MICRO * MIX_STEPS
    for kind in MIX_CONFIGS:
        tag = "14a" if kind == "dropless" else "14b"
        runs = [mixtral_run(torch, fa, kind, card) for _ in range(2)]
        run = runs[0]
        hist = run["history"]
        for r in hist:
            log(f"mixtral {tag} ({kind}) step {r['step']}: loss {r['loss']:.6f} lm_loss "
                f"{r['lm_loss']:.6f} router_aux_loss {r['router_aux_loss']:.6f} grad_norm "
                f"{r['grad_norm']:.4f} | {r['step_seconds']:.3f} s, {r['tokens_per_sec']:.1f} "
                f"tokens/s, MFU {r['mfu']:.4f} (active experts) [{card}]")
        log(f"mixtral {tag}: {run['params']} params, peak device memory {run['peak']} bytes "
            f"({run['peak'] / 2**30:.2f} GiB), launches {run['launches']} (expected {expect} "
            f"each), fallbacks {run['fallbacks']}, group-size host syncs a step "
            f"{run['syncs_per_step']:g}, run wall time {run['seconds']:.1f} s [{card}]")
        if run["dropped_share"] is not None:
            log(f"mixtral {tag}: share of (token, slot) routes dropped over the run "
                f"{run['dropped_share']:.4f} (capacity factor {run['moe'].capacity_factor}) "
                f"[{card}]")
        same = all(a[k] == b[k] for a, b in zip(hist, runs[1]["history"])
                   for k in ("loss", "grad_norm", "router_aux_loss", "lm_loss"))
        same = same and run["digest"] == runs[1]["digest"]
        log(f"mixtral {tag}: a second run from the same seed equal bit for bit: {same}")
        if len(hist) != MIX_STEPS or not all(
                math.isfinite(r[k]) for r in hist
                for k in ("loss", "grad_norm", "router_aux_loss", "lm_loss")):
            fail(f"mixtral {tag}: {len(hist)} steps, or a non-finite value: {hist}")
        coef = run["moe"].router_aux_loss_coef
        lm0 = math.log(32000) + HIDDEN * (0.02 * 0.879626) ** 2 / 2  # as expected_loss0()
        if abs(hist[0]["lm_loss"] - lm0) > 0.5 or \
                not 0.9 * coef <= hist[0]["router_aux_loss"] <= 1.5 * coef:
            fail(f"mixtral {tag}: step-0 lm_loss {hist[0]['lm_loss']} (expected {lm0:.4f}: "
                 f"ln 32000 + sigma^2/2) or router_aux_loss {hist[0]['router_aux_loss']} "
                 f"(coefficient {coef})")
        if any(n != expect for n in run["launches"].values()) or run["fallbacks"]["core"]:
            fail(f"mixtral {tag}: launches {run['launches']} (fallbacks {run['fallbacks']}), "
                 f"expected {expect} each")
        if run["syncs_per_step"] != MIX_LAYERS * MIX_MICRO:
            fail(f"mixtral {tag}: {run['syncs_per_step']} group-size syncs a step, expected "
                 f"{MIX_LAYERS * MIX_MICRO}")
        if not same:
            fail(f"mixtral {tag}: a second run from the same seed differs")
        if kind == "dropped" and not 0 < run["dropped_share"] < 0.5:
            fail(f"mixtral {tag}: dropped share {run['dropped_share']}")
        out[kind] = dict(run, history=hist)
    # the kernels at Mixtral's attention: b 1, s 4096, 32 / 8 heads of 128,
    # causal, window 4096 (every key of a row is inside it at s 4096)
    shape = dict(kt.MAIN, s=MIX_SEQ)
    if not check_case(torch, fa, f"mixtral attention s={MIX_SEQ} window {MIX_SEQ}", b=1,
                      sq=MIX_SEQ, skv=MIX_SEQ, nh=shape["nh"], nkv=shape["nkv"], d=shape["d"],
                      window=MIX_SEQ, seed=140):
        fail("a kernel disagrees with its plain version at Mixtral's attention")
    gen = torch.Generator(device="cuda").manual_seed(141)
    q, k, v, do = (kt.randn_bf16(gen, 1, MIX_SEQ, h, shape["d"])
                   for h in (shape["nh"], shape["nkv"], shape["nkv"], shape["nh"]))
    with torch.no_grad():
        o, lse = fa.flash_fwd(q, k, v, window=MIX_SEQ)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    ms = {"flash_fwd": kt.cuda_ms(lambda: fa.flash_fwd(q, k, v, window=MIX_SEQ)),
          "flash_dq": kt.cuda_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta, window=MIX_SEQ)),
          "flash_dkv": kt.cuda_ms(lambda: fa.flash_dkv(q, k, v, do, lse, delta,
                                                       window=MIX_SEQ))}
    bounds = bounds_ms(kt, peaks, shape)
    rows = []
    for kname, t in ms.items():
        rows.append({"kernel": kname, "s": MIX_SEQ, "window": MIX_SEQ, "ms": t,
                     "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1]})
        log(f"mixtral attention time {kname} s={MIX_SEQ} window {MIX_SEQ}: {t:.3f} ms, bound "
            f"{bounds[kname][0]:.3f} ms ({bounds[kname][1]}), {bounds[kname][0] / t:.3f} of "
            f"bound [{card}]")
    del q, k, v, do, o, lse, delta
    free_cuda(torch)
    out["kernels"] = rows
    out["seconds"] = time.perf_counter() - t_phase
    log(f"mixtral 14a/14b: phase wall time {out['seconds']:.1f} s [{card}]")
    return out


def moe_dense_plain(torch, params, x, cfg):
    """The dropless layer's plain version: every expert's SwiGLU on every
    token, each token's output the gate-weighted sum over its top-k, in fp32
    (JAX's ``dense_reference``)."""
    import torch.nn.functional as F

    from neuronx_distributed_training_torch.ops import moe as moe_ops

    probs, idx, _ = moe_ops.route(params["router"], x, cfg)
    gu, dn = params["experts"]["gate_up"], params["experts"]["down"]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        gate, up = torch.chunk(x @ gu[e], 2, dim=-1)
        weight = (probs * (idx == e)).sum(-1)
        y += weight[:, None] * ((F.silu(gate) * up) @ dn[e]).float()
    return y.to(x.dtype)


def moe_dropped_plain(torch, params, x, cfg):
    """The dropped layer's plain version: JAX's dense dispatch and combine
    einsums over a ``[T, E, cap]`` one-hot (every capacity slot computed)."""
    import torch.nn.functional as F

    from neuronx_distributed_training_torch.ops import moe as moe_ops

    t, e = x.shape[0], cfg.num_experts
    cap = moe_ops.capacity(cfg, t)
    probs, idx, _ = moe_ops.route(params["router"], x, cfg)
    onehot = F.one_hot(idx, e).float()
    pos = torch.cumsum(onehot.reshape(-1, e), 0).reshape(onehot.shape) - 1.0
    keep = (pos < cap) * onehot
    pos_cap = F.one_hot(pos.clamp(0, cap - 1).long(), cap).float()
    dispatch = torch.einsum("tke,tkec->tec", keep, pos_cap)
    combine = torch.einsum("tk,tke,tkec->tec", probs, keep, pos_cap)
    x_e = torch.einsum("tec,th->ech", dispatch.to(x.dtype), x)
    gate, up = torch.chunk(torch.einsum("ech,ehf->ecf", x_e, params["experts"]["gate_up"]), 2,
                           dim=-1)
    y_e = torch.einsum("ecf,efh->ech", F.silu(gate) * up, params["experts"]["down"])
    return torch.einsum("tec,ech->th", combine.to(x.dtype), y_e)


def phase_moe_layer(torch, card: str, peaks) -> list:
    """14c: one MoE layer at full width alone (T 4096 tokens, hidden 4096,
    ffn 14336, 8 experts top 2, bf16): the dropless grouped product (one
    ``torch.matmul`` per expert over its sorted rows: the route is the
    loop) against every expert on every token, the dropped path (capacity
    1.25) against JAX's dispatch / combine einsums, each within
    ``TOL_MOE``; then each forward and forward + backward timed by CUDA
    events beside its bound: the active experts' operations (the routes
    this run's data keeps) over the bf16 rate, or the bytes (x, every
    expert's weights and y, once) over the memory rate if larger."""
    from neuronx_distributed_training_torch.ops import moe as moe_ops
    from neuronx_distributed_training_torch.tools import kernel_times as kt

    t_phase = time.perf_counter()
    t, h, f, e = MIX_SEQ, HIDDEN, 14336, 8
    gen = torch.Generator(device="cuda").manual_seed(142)
    bf = torch.bfloat16
    params = {"router": {"w": torch.randn(h, e, generator=gen, device="cuda") * 0.02},
              "experts": {"gate_up": (torch.randn(e, h, 2 * f, generator=gen, device="cuda")
                                      * 0.02).to(bf),
                          "down": (torch.randn(e, f, h, generator=gen, device="cuda")
                                   * 0.02).to(bf)}}
    x = torch.randn(t, h, generator=gen, device="cuda").to(bf)
    dy = torch.randn(t, h, generator=gen, device="cuda").to(bf)
    rows = []
    grouped_mm = hasattr(torch, "_grouped_mm")
    for kind, cfg, fn, plain in (
            ("dropless", moe_ops.MoEConfig(num_experts=e, top_k=2), moe_ops.moe_dropless,
             moe_dense_plain),
            ("dropped", moe_ops.MoEConfig(num_experts=e, top_k=2, dropless=False,
                                          capacity_factor=1.25), moe_ops.moe_dropped,
             moe_dropped_plain)):
        with torch.no_grad():
            y = fn(params, x, cfg, compute_dtype=bf)[0]
            y_p = plain(torch, params, x, cfg)
            idx = moe_ops.route(params["router"], x, cfg)[1]
            kept = int(moe_ops.keep_mask(idx, cfg).sum()) if kind == "dropped" else idx.numel()
        err = float((y.float() - y_p.float()).abs().max() / y_p.float().abs().max())
        ops = 2 * kept * 3 * h * f
        nbytes = 2 * (2 * t * h + e * 3 * h * f)
        bound = {"fwd": max(ops / peaks[0], nbytes / peaks[1]) * 1e3,
                 "fwd_bwd": max(3 * ops / peaks[0], 2 * nbytes / peaks[1]) * 1e3}
        by = "operations" if ops / peaks[0] >= nbytes / peaks[1] else "bytes"
        leaves = [params["experts"]["gate_up"], params["experts"]["down"]]
        xg = x.detach().requires_grad_(True)

        def fwd_bwd():
            for w in leaves:
                w.requires_grad_(True)
            out = fn(params, xg, cfg, compute_dtype=bf)[0]
            torch.autograd.grad(out, [xg] + leaves, grad_outputs=dy)
            for w in leaves:
                w.requires_grad_(False)

        with torch.no_grad():
            ms_fwd = kt.cuda_ms(lambda: fn(params, x, cfg, compute_dtype=bf), 5)
            plain_ms = kt.cuda_ms(lambda: plain(torch, params, x, cfg), 2)
        ms_fb = kt.cuda_ms(fwd_bwd, 5)
        top = moe_profile(torch, fwd_bwd)
        row = {"kind": kind, "route": "loop", "tokens": t, "kept_routes": kept,
               "max_rel_err": err, "ms": ms_fwd, "fwd_bwd_ms": ms_fb, "plain_ms": plain_ms,
               "bound_ms": bound["fwd"], "fwd_bwd_bound_ms": bound["fwd_bwd"], "bound_by": by,
               "fwd_bwd_device_ms_by_op": top}
        rows.append(row)
        log(f"moe layer {kind} (14c): max gap {err:.3e} of the plain output's largest "
            f"entry (tol {TOL_MOE:g}); {kept} of {idx.numel()} routes computed; forward "
            f"{ms_fwd:.3f} ms (bound {bound['fwd']:.3f} ms, {by}; {bound['fwd'] / ms_fwd:.3f} "
            f"of bound), forward + backward {ms_fb:.3f} ms (bound {bound['fwd_bwd']:.3f} ms, "
            f"{bound['fwd_bwd'] / ms_fb:.3f} of bound), plain forward {plain_ms:.3f} ms; "
            f"grouped product route: per-expert loop (torch._grouped_mm present: "
            f"{grouped_mm}, not used) [{card}]")
        log(f"moe layer {kind} (14c): forward + backward device ms by op (torch.profiler, "
            f"one call): {top} [{card}]")
        del y, y_p
        if not (math.isfinite(err) and err <= TOL_MOE):
            fail(f"moe layer {kind}: {err:.3e} off its plain version (tol {TOL_MOE:g})")
    del params, x, dy
    free_cuda(torch)
    log(f"moe layer (14c): phase wall time {time.perf_counter() - t_phase:.1f} s [{card}]")
    return rows


def moe_profile(torch, fn, top: int = 8) -> dict:
    """Device ms of ``fn``'s ops by name (``torch.profiler``'s self CUDA
    time over one call after a warm one), the ``top`` largest; empty when
    the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((ev.key, us / 1e3))
    rows.sort(key=lambda r: -r[1])
    return {k: round(ms, 3) for k, ms in rows[:top]}


def mixtral_cli_run(cell, nproc: int, name: str, *extra: str) -> dict:
    """14a's dropless cell under torchrun over ``nproc`` cards (NCCL)."""
    return torchrun_cell(cell, nproc, cell.WORK / f"exp_{name}", 900, "--config",
                         str(REPO / "examples" / "conf" / MIX_CONFIGS["dropless"]),
                         "--set", f"model.num_layers={MIX_LAYERS}",
                         "--set", "exp_manager.create_tensorboard_logger=false", *extra)


def phase_mixtral_cli(torch, cell, card: str) -> dict | None:
    """14d, with four cards (a builder's call): 14a's cell through the CLI
    at dp 2 x ep 2 against dp 4 x ep 1, and at tp 2 (SP) x ep 2 against tp
    2 x dp 2 (the same microbatching on both sides: the router loss is a
    product of means over a microbatch), within the mixed_precision
    tolerance (loss 1e-4, grad norm 2e-3), each rank's launches exact; a
    save at ep 2 (step 2) restored at ep 1 trains step 3 within the same
    tolerance of the straight ep 2 run.  With fewer cards it says why it
    did not run and returns None."""
    if torch.cuda.device_count() < 4:
        log(f"mixtral cli (14d): needs four cards, this machine has "
            f"{torch.cuda.device_count()} [{card}]")
        return None
    # the shipped config sets ep 4: every run names its own
    ep1, ep2 = (["--set", f"distributed_strategy.expert_model_parallel_size={n}"]
                for n in (1, 2))
    sp = ["--tp", "2", "--sp"]
    out = {"dp2_ep2": mixtral_cli_run(cell, 4, "mx_dp2_ep2", *ep2),
           "dp4_ep1": mixtral_cli_run(cell, 4, "mx_dp4_ep1", *ep1),
           "tp2_ep2": mixtral_cli_run(cell, 4, "mx_tp2_ep2", *sp, *ep2),
           "tp2_dp2": mixtral_cli_run(cell, 4, "mx_tp2_dp2", *sp, *ep1)}
    for name, ep, tp in (("dp2_ep2", 2, 1), ("dp4_ep1", 1, 1), ("tp2_ep2", 2, 2),
                         ("tp2_dp2", 1, 2)):
        rep = out[name]
        expect = MIX_LAYERS * (MIX_MICRO * tp // 4) * cell.STEPS  # microbatches a rank
        if (rep["ep"], rep["tp"]) != (ep, tp) or any(
                n != expect for r in rep["ranks"] for n in r["launches"].values()):
            fail(f"mixtral cli (14d) {name}: ep {rep['ep']} tp {rep['tp']}, launches "
                 f"{[r['launches'] for r in rep['ranks']]} (expected ep {ep}, tp {tp}, "
                 f"{expect} each)")
    for a, b in (("dp2_ep2", "dp4_ep1"), ("tp2_ep2", "tp2_dp2")):
        ra, rb = out[a], out[b]
        log(f"mixtral cli (14d) {a}: losses {ra['loss']} grad norms {ra['grad_norm']}; {b}: "
            f"{rb['loss']} / {rb['grad_norm']}; step seconds {ra['step_seconds']} / "
            f"{rb['step_seconds']}; peak per rank {[r['peak_bytes'] for r in ra['ranks']]} "
            f"[{card}]")
        if not all(math.isclose(x, y, rel_tol=TP_LOSS_RTOL) for x, y in zip(ra["loss"],
                                                                             rb["loss"])) or \
                not all(math.isclose(x, y, rel_tol=TP_GRAD_NORM_RTOL)
                        for x, y in zip(ra["grad_norm"], rb["grad_norm"])):
            fail(f"mixtral cli (14d): {a} against {b}")
    exp = cell.WORK / "exp_mx_ck"
    ck = ["--save-every", "2", "--exp-dir", str(exp)]
    try:
        mixtral_cli_run(cell, 4, "mx_pre", *ep2, *ck, "--set", "trainer.max_steps=2")
        restored = mixtral_cli_run(cell, 4, "mx_restore", *ep1, *ck)
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    step3 = (restored["loss"][-1], restored["grad_norm"][-1])
    want = (out["dp2_ep2"]["loss"][2], out["dp2_ep2"]["grad_norm"][2])
    log(f"mixtral cli (14d): ep 2 save at step 2 restored at ep 1: step 3 loss / grad norm "
        f"{step3}, straight ep 2 {want} [{card}]")
    if not (math.isclose(step3[0], want[0], rel_tol=TP_LOSS_RTOL)
            and math.isclose(step3[1], want[1], rel_tol=TP_GRAD_NORM_RTOL)):
        fail("mixtral cli (14d): the ep 2 save restored at ep 1 trains another step 3")
    out["restored_step3"] = step3
    return out


# ---------------------------------------------------------------------------
# phase 15: the Megatron GPT family
# ---------------------------------------------------------------------------

GPT_CONF = REPO / "examples" / "conf"
#: 15a: megatron_gpt_config.yaml at full width (hidden 4096, ffn 16384, 32 /
#: 8 heads of 128, vocab 50257, seq 2048, layernorm + bias, gelu, tied,
#: rope) cut to 4 layers at tp 1: 4 microbatches of 2 rows, 3 steps
GPT_LAYERS, GPT_MICRO, GPT_MBS, GPT_STEPS, GPT_SEQ, GPT_VOCAB = 4, 4, 2, 3, 2048, 50257
GPT_EXP = REPO / "build" / "chip_smoke" / "exp_gpt"
#: 15b: megatron_mistral_config.yaml at full width, 4 layers, one seq-4096 row
GPT_MISTRAL = {"layers": 4, "seq": 4096}
#: 15c: 15a's cell at 2 layers with hidden and embedding dropout 0.1
GPT_DROP = {"layers": 2, "rate": 0.1}
#: 15d: the shipped Megatron Mixtral configs (14a / 14b's cut)
GPT_MIX_CONFIGS = {"megatron_dropless": "megatron_mixtral_8x7b_dropless_config.yaml",
                   "megatron_dropped": "megatron_mixtral_8x7b_config.yaml"}
#: 15e: megatron_llama_70b_config.yaml's pp 4 at the widths its tp 32 gives
#: each card (hidden 8192, 2 q and 1 kv heads of 128, ffn 896, vocab 1000)
GPT_70B = {"pp": 4, "layers": 4, "nm": 4, "card_tp": 32, "seq": 4096}


def gpt_args(config: str, layers: int, exp: Path, *extra: str) -> list:
    """A Megatron config's CLI arguments on one card: ``layers`` layers,
    tp 1, synthetic data, ``GPT_STEPS`` steps, no cadence save."""
    return ["--config", str(GPT_CONF / config),
            "--set", f"model.num_layers={layers}",
            "--set", "distributed_strategy.tensor_model_parallel_size=1",
            "--set", "distributed_strategy.sequence_parallel=false",
            "--set", "distributed_strategy.pipeline_model_parallel_size=1",
            "--set", "data.synthetic=true",
            "--set", f"trainer.max_steps={GPT_STEPS}",
            "--set", "trainer.log_every_n_steps=1",
            "--set", f"exp_manager.exp_dir={exp}",
            "--set", "exp_manager.create_tensorboard_logger=false",
            "--set", "exp_manager.checkpoint_callback_params.every_n_train_steps=0",
            *extra]


def gpt_run(torch, fa, args: list, *handlers) -> dict:
    """One CLI run with the launch counters set to 0 just before and read
    just after: its history, launches, peak memory, a digest of every param
    after the last step, and the model's FLOPs a token."""
    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.trainer import cli
    from neuronx_distributed_training_torch.utils import perf

    torch.cuda.reset_peak_memory_stats()
    fa.reset_counters()
    t0 = time.perf_counter()
    trainer, history = run_cli(cli, args, *handlers)
    torch.cuda.synchronize()
    flat = llama.named_params(trainer.params)
    out = {"history": history, "launches": dict(fa.LAUNCHES), "fallbacks": dict(fa.FALLBACKS),
           "peak": torch.cuda.max_memory_allocated(), "params": sum(t.numel() for t in flat.values()),
           "digest": [device_digest(torch, t) for t in flat.values()],
           "flops_per_token": perf.train_step_flops_per_token(
               perf.flops_for_model(trainer.model_cfg, trainer.seq_len)),
           "seconds": time.perf_counter() - t0}
    del trainer, flat
    free_cuda(torch)
    return out


def gpt_expected_loss0(vocab: int) -> float:
    """Step 0's loss at random weights: ln V plus half the logits' variance
    (a unit-variance final hidden state times head rows of std 0.02 x
    0.8796, the truncated normal's), as ``expected_loss0``."""
    return math.log(vocab) + HIDDEN * (0.02 * 0.879626) ** 2 / 2


def phase_gpt_pretrain(torch, fa, card: str) -> dict:
    """15a: ``megatron_gpt_config.yaml`` through the CLI at its full width,
    cut to 4 layers at tp 1, 4 microbatches of 2 rows, 3 steps: step 0's
    loss near ln 50257 + sigma^2 / 2, finite losses and grad norms, each
    kernel launched layers x microbatches x steps times with no fallback;
    the step seconds, tokens/s, MFU (GPT's count: 2 MLP matmuls under gelu)
    and peak memory printed."""
    t_phase = time.perf_counter()
    exp = GPT_EXP / "pretrain"
    args = gpt_args("megatron_gpt_config.yaml", GPT_LAYERS, exp,
                    "--set", f"data.micro_batch_size={GPT_MBS}",
                    "--set", f"data.global_batch_size={GPT_MBS * GPT_MICRO}",
                    "--set", "exp_manager.resume_if_exists=false")
    try:
        run = gpt_run(torch, fa, args)
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    hist, expect = run["history"], GPT_LAYERS * GPT_MICRO * GPT_STEPS
    for r in hist:
        log(f"gpt 15a step {r['step']}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.4f} | "
            f"{r['step_seconds']:.3f} s, {r['tokens_per_sec']:.1f} tokens/s, MFU {r['mfu']:.4f} "
            f"(GPT's count, {run['flops_per_token'] / 1e9:.3f} GFLOP a token) [{card}]")
    log(f"gpt 15a: {run['params']} params ({run['params'] / 1e9:.3f} B), peak device memory "
        f"{run['peak']} bytes ({run['peak'] / 2**30:.2f} GiB), launches {run['launches']} "
        f"(expected {expect} each), fallbacks {run['fallbacks']}, run wall time "
        f"{run['seconds']:.1f} s [{card}]")
    loss0 = gpt_expected_loss0(GPT_VOCAB)
    if len(hist) != GPT_STEPS or not all(math.isfinite(r[k]) for r in hist
                                          for k in ("loss", "grad_norm")):
        fail(f"gpt 15a: {len(hist)} steps, or a non-finite value: {hist}")
    if abs(hist[0]["loss"] - loss0) > 1.0:
        fail(f"gpt 15a: step-0 loss {hist[0]['loss']} (expected {loss0:.4f}: ln {GPT_VOCAB} + "
             f"sigma^2/2)")
    if any(n != expect for n in run["launches"].values()) or run["fallbacks"]["core"]:
        fail(f"gpt 15a: launches {run['launches']} (fallbacks {run['fallbacks']}), expected "
             f"{expect} each")
    run.pop("digest")
    run["phase_seconds"] = time.perf_counter() - t_phase
    log(f"gpt 15a: phase wall time {run['phase_seconds']:.1f} s [{card}]")
    return run


def gpt_mistral_pair(torch, fa, card: str) -> dict:
    """15b: ``megatron_mistral_config.yaml`` (rmsnorm, swiglu, no bias,
    untied, 32 / 8 heads, window 4096) at full width, 4 layers, one seq-4096
    row: the GPT forward + backward against the port's Llama model on the
    same weights, carried through ``tools/convert.py`` (GPT's ``mlp.up``
    is Llama's ``mlp.gate_up``): loss and every gradient within 12a's bars,
    and bit for bit where the op sequence is the same (it is: the two
    models call the same functions in the same order at these knobs)."""
    from neuronx_distributed_training_torch.config import loader
    from neuronx_distributed_training_torch.models import gpt, llama
    from neuronx_distributed_training_torch.tools.convert import params_from_jax, params_to_jax
    from neuronx_distributed_training_torch.trainer import loop
    from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

    t_phase = time.perf_counter()
    c = GPT_MISTRAL
    cfg = loader.load_config(GPT_CONF / "megatron_mistral_config.yaml",
                             {"model.num_layers": c["layers"],
                              "distributed_strategy.tensor_model_parallel_size": 1,
                              "distributed_strategy.sequence_parallel": False})
    gc = loop.model_config(cfg)
    policy = DtypePolicy.from_precision_config(cfg.get("precision"))
    gen = torch.Generator(device="cuda").manual_seed(int(cfg.get("seed", 1234)))
    gparams = gpt.init_params(gc, policy, generator=gen, device="cuda")
    tree = params_to_jax(gparams)
    tree["layers"]["mlp"]["gate_up"] = tree["layers"]["mlp"].pop("up")
    lparams = params_from_jax(tree, device="cuda")
    del tree
    lc = llama.LlamaConfig(
        vocab_size=gc.vocab_size, hidden_size=gc.hidden_size, intermediate_size=gc.ffn_size,
        num_layers=gc.num_layers, num_attention_heads=gc.num_attention_heads,
        num_kv_heads=gc.kv_heads, rope_theta=gc.rope_theta, rms_norm_eps=gc.layernorm_epsilon,
        tie_word_embeddings=False, sliding_window=gc.sliding_window,
        attention_impl=gc.attention_impl,
        activations_checkpoint_granularity=gc.activations_checkpoint_granularity)
    ids = torch.randint(0, gc.vocab_size, (1, c["seq"]),
                        generator=torch.Generator(device="cuda").manual_seed(150), device="cuda")
    batch = {"input_ids": ids, "labels": ids}
    out = {"gpt": gc, "llama": lc}
    grads = {}
    for name, params, fwd in (("gpt", gparams, lambda p: gpt.forward(p, batch, gc, policy)[0]),
                              ("llama", lparams, lambda p: llama.forward(p, batch, lc, policy)[0])):
        flat = llama.named_params(params)
        for t in flat.values():
            t.requires_grad_(True)
        fa.reset_counters()
        loss = fwd(params).float()
        got = torch.autograd.grad(loss, list(flat.values()))
        torch.cuda.synchronize()
        out[name + "_launches"] = dict(fa.LAUNCHES)
        out[name + "_loss"] = float(loss)
        grads[name] = {n.replace("mlp.up.", "mlp.gate_up."): g for n, g in zip(flat, got)}
        del loss, got
    gap, leaf, same = pp_grad_gap(torch, grads["gpt"], grads["llama"])
    same = same and out["gpt_loss"] == out["llama_loss"]
    loss_rel = abs(out["gpt_loss"] - out["llama_loss"]) / abs(out["llama_loss"])
    log(f"gpt 15b (megatron_mistral, {c['layers']} layers, s {c['seq']}): GPT loss "
        f"{out['gpt_loss']:.6f}, Llama loss {out['llama_loss']:.6f} (rel {loss_rel:.2e}, bar "
        f"{TP_LOSS_RTOL:g}); largest gradient gap {gap:.3e} of its leaf's largest entry ({leaf}; "
        f"bar {PP_GRAD_REL:g}); bit for bit {same}; launches GPT {out['gpt_launches']}, Llama "
        f"{out['llama_launches']} [{card}]")
    want = {k: c["layers"] for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    if not loss_rel <= TP_LOSS_RTOL or not gap <= PP_GRAD_REL:
        fail(f"gpt 15b: the GPT and Llama models disagree: loss rel {loss_rel:.3e}, gradient "
             f"gap {gap:.3e} at {leaf}")
    if out["gpt_launches"] != want or out["llama_launches"] != want:
        fail(f"gpt 15b: launches {out['gpt_launches']} / {out['llama_launches']}, expected {want}")
    out.update(loss_rel=loss_rel, grad_gap=gap, bitwise=same)
    del gparams, lparams, grads
    free_cuda(torch)
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"gpt 15b: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_gpt_dropout(torch, fa, card: str) -> dict:
    """15c: 15a's cell at 2 layers with ``hidden_dropout`` and
    ``embedding_dropout`` 0.1: two straight runs from one seed equal bit for
    bit; a run stopped by SIGTERM at step 2's boundary (one save) and
    resumed equals the straight run's step 3 bit for bit (loss, grad norm,
    every param's digest); the dropout-0 run's losses differ; the launches
    exact."""
    t_phase = time.perf_counter()
    c = GPT_DROP
    common = ("--set", f"data.micro_batch_size={GPT_MBS}",
              "--set", f"data.global_batch_size={GPT_MBS * GPT_MICRO}")

    def args(exp, rate, resume):
        return gpt_args("megatron_gpt_config.yaml", c["layers"], GPT_EXP / exp, *common,
                        "--set", f"model.hidden_dropout={rate}",
                        "--set", f"model.embedding_dropout={rate}",
                        "--set", f"exp_manager.resume_if_exists={str(resume).lower()}")

    runs = {}
    try:
        runs["A"] = gpt_run(torch, fa, args("drop_a", c["rate"], False))
        runs["A2"] = gpt_run(torch, fa, args("drop_a2", c["rate"], False))
        runs["P"] = gpt_run(torch, fa, args("drop_resume", c["rate"], True),
                            AtStepEnd(1, lambda: signal.raise_signal(signal.SIGTERM)))
        runs["R"] = gpt_run(torch, fa, args("drop_resume", c["rate"], True))
        runs["Z"] = gpt_run(torch, fa, args("drop_zero", 0.0, False))
    finally:
        shutil.rmtree(GPT_EXP, ignore_errors=True)
    a, a2, p, r, z = (runs[k]["history"] for k in ("A", "A2", "P", "R", "Z"))
    for k, h in runs.items():
        log(f"gpt 15c {k}: steps {[x['step'] for x in h['history']]}, losses "
            f"{[round(x['loss'], 6) for x in h['history']]}, grad norms "
            f"{[round(x['grad_norm'], 6) for x in h['history']]}, launches {h['launches']}, "
            f"run wall time {h['seconds']:.1f} s [{card}]")
    repeat = all(x[k] == y[k] for x, y in zip(a, a2) for k in ("loss", "grad_norm")) and \
        runs["A"]["digest"] == runs["A2"]["digest"]
    resumed = ([x["step"] for x in p] == [0, 1] and [x["step"] for x in r] == [2]
               and r[0]["loss"] == a[2]["loss"] and r[0]["grad_norm"] == a[2]["grad_norm"]
               and runs["R"]["digest"] == runs["A"]["digest"])
    differs = all(x["loss"] != y["loss"] for x, y in zip(a, z))
    log(f"gpt 15c: a second run bit for bit {repeat}; the resume's step 3 and params equal the "
        f"straight run's bit for bit {resumed}; the dropout-0 losses differ at every step "
        f"{differs} (step 0: {a[0]['loss']:.6f} against {z[0]['loss']:.6f}) [{card}]")
    expect = c["layers"] * GPT_MICRO * GPT_STEPS
    if not (repeat and resumed and differs):
        fail(f"gpt 15c: repeat {repeat}, resume {resumed}, differs from dropout 0 {differs}")
    if any(n != expect for n in runs["A"]["launches"].values()) or \
            runs["A"]["fallbacks"]["core"]:
        fail(f"gpt 15c: launches {runs['A']['launches']}, expected {expect} each")
    out = {"launches": runs["A"]["launches"], "repeat": repeat, "resume": resumed,
           "phase_seconds": time.perf_counter() - t_phase}
    log(f"gpt 15c: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_gpt_mixtral(torch, fa, card: str) -> dict:
    """15d: the shipped ``megatron_mixtral_8x7b`` (dropped, capacity 1.25)
    and ``_dropless`` configs, GPT-MoE, cut as 14a / 14b (2 layers, tp and
    ep 1, 4 microbatches of one seq-4096 row, 3 steps): finite values, step
    0's ``lm_loss`` and ``router_aux_loss`` as 14a's bars, launches exact,
    the dropped share printed."""
    t_phase = time.perf_counter()
    out, expect = {}, MIX_LAYERS * MIX_MICRO * MIX_STEPS
    for kind in GPT_MIX_CONFIGS:
        run = mixtral_run(torch, fa, kind, card)
        hist = run["history"]
        for r in hist:
            log(f"gpt 15d ({kind}) step {r['step']}: loss {r['loss']:.6f} lm_loss "
                f"{r['lm_loss']:.6f} router_aux_loss {r['router_aux_loss']:.6f} grad_norm "
                f"{r['grad_norm']:.4f} | {r['step_seconds']:.3f} s, {r['tokens_per_sec']:.1f} "
                f"tokens/s, MFU {r['mfu']:.4f} (active experts) [{card}]")
        share = run["dropped_share"]
        log(f"gpt 15d ({kind}): {run['params']} params, peak {run['peak'] / 2**30:.2f} GiB, "
            f"launches {run['launches']} (expected {expect} each), fallbacks {run['fallbacks']}"
            f", share of (token, slot) routes dropped "
            f"{'none (dropless)' if share is None else f'{share:.4f}'} [{card}]")
        coef = run["moe"].router_aux_loss_coef
        lm0 = math.log(32000) + HIDDEN * (0.02 * 0.879626) ** 2 / 2
        if len(hist) != MIX_STEPS or not all(
                math.isfinite(r[k]) for r in hist
                for k in ("loss", "grad_norm", "router_aux_loss", "lm_loss")):
            fail(f"gpt 15d {kind}: {len(hist)} steps, or a non-finite value: {hist}")
        if abs(hist[0]["lm_loss"] - lm0) > 0.5 or \
                not 0.9 * coef <= hist[0]["router_aux_loss"] <= 1.5 * coef:
            fail(f"gpt 15d {kind}: step-0 lm_loss {hist[0]['lm_loss']} (expected {lm0:.4f}) or "
                 f"router_aux_loss {hist[0]['router_aux_loss']} (coefficient {coef})")
        if any(n != expect for n in run["launches"].values()) or run["fallbacks"]["core"]:
            fail(f"gpt 15d {kind}: launches {run['launches']}, expected {expect} each")
        if kind == "megatron_dropped" and not 0 < share < 0.5:
            fail(f"gpt 15d {kind}: dropped share {share}")
        run.pop("digest")
        out[kind] = run
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"gpt 15d: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_gpt_pp_70b(torch, fa, card: str) -> dict:
    """15e: ``megatron_llama_70b_config.yaml``'s pp 4 (the wavefront, as
    JAX's gate keeps GPT) through the loopback, as 13a, at the widths its
    tp 32 gives each card (hidden 8192, 2 q and 1 kv heads of 128, ffn 896,
    vocab 1000), 4 layers, 4 microbatches of one seq-4096 row with uneven
    loss masks: against the unpipelined GPT pass at 12a's bars, the
    launches exact (the wavefront's recompute counted)."""
    import dataclasses

    from neuronx_distributed_training_torch.config import loader
    from neuronx_distributed_training_torch.models import gpt, llama
    from neuronx_distributed_training_torch.parallel import pipeline
    from neuronx_distributed_training_torch.trainer import loop
    from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

    @dataclasses.dataclass(frozen=True)
    class CardGPT(gpt.GPTConfig):
        """A card's share of the heads: GPT derives the head size from the
        hidden size, so the per-card config keeps it here."""
        card_head_size: int = 128

        @property
        def head_size(self) -> int:
            return self.card_head_size

    t_phase = time.perf_counter()
    free_cuda(torch)
    c = GPT_70B
    cfg = loader.load_config(GPT_CONF / "megatron_llama_70b_config.yaml",
                             {"model.num_layers": c["layers"],
                              "distributed_strategy.tensor_model_parallel_size": 1,
                              "distributed_strategy.sequence_parallel": False})
    full = loop.model_config(cfg)
    fields = {f.name: getattr(full, f.name) for f in dataclasses.fields(full)}
    fields.update(num_attention_heads=full.num_attention_heads // c["card_tp"],
                  num_query_groups=max(full.kv_heads // c["card_tp"], 1),
                  ffn_hidden_size=full.ffn_size // c["card_tp"],
                  vocab_size=-(-full.vocab_size // c["card_tp"]))
    gc = CardGPT(**fields, card_head_size=full.head_size)
    policy = DtypePolicy.from_precision_config(cfg.get("precision"))
    gen = torch.Generator(device="cuda").manual_seed(int(cfg.get("seed", 1234)))
    params = gpt.init_params(gc, policy, generator=gen, device="cuda")
    leaves = llama.named_params(params)
    for t in leaves.values():
        t.requires_grad_(True)
    n_params = sum(t.numel() for t in leaves.values())
    log(f"gpt 15e: per-card widths {gc}; {n_params} params [{card}]")
    schedule = pipeline.resolve_schedule("auto", gc, {"pipeline_model_parallel_size": c["pp"]})
    gen = torch.Generator(device="cuda").manual_seed(PP_SEED + 150)
    ids = torch.randint(0, gc.vocab_size, (c["nm"], 1, c["seq"]), generator=gen, device="cuda")
    mbs = []
    for m in range(c["nm"]):
        mask = torch.ones(1, c["seq"], device="cuda")
        mask[:, :(m * c["seq"]) // (2 * c["nm"])] = 0.0
        mbs.append({"input_ids": ids[m], "labels": ids[m], "loss_mask": mask})
    denom = sum(llama.loss_token_count(mb) for mb in mbs)
    ref_loss, ref = None, {}
    for mb in mbs:
        lm = gpt.forward(params, mb, gc, policy, loss_denominator=denom)[0].float()
        lm.backward()
        ref_loss = lm.detach() if ref_loss is None else ref_loss + lm.detach()
    for n, t in leaves.items():
        ref[n], t.grad = t.grad, None
    ref_loss = float(ref_loss)
    log(f"gpt 15e: schedule {schedule}; unpipelined pass loss {ref_loss:.6f} [{card}]")
    run = pp_run(torch, fa, pipeline, gpt.pipeline_hooks(gc, policy), params, mbs, denom,
                 schedule, c["pp"], policy, card, f"gpt_70b_pp4_nm4_{schedule}")
    rep = pp_check("15e", run, ref_loss, ref, layers=c["layers"], nm=c["nm"], pp=c["pp"],
                   schedule=schedule, torch=torch)
    if schedule != "wavefront":
        fail(f"gpt 15e: auto resolved to {schedule}, JAX's gate keeps GPT on the wavefront")
    run.pop("grads")
    del params, leaves, ref, mbs
    free_cuda(torch)
    out = {"run": {**rep, **run}, "n_params": n_params,
           "phase_seconds": time.perf_counter() - t_phase}
    log(f"gpt 15e: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_gpt_kernels(torch, fa, kt, card: str, peaks) -> list:
    """The three kernels at ``megatron_gpt``'s attention (b 2, s 2048, 32 /
    8 heads of 128, causal) against their plain versions, then timed beside
    their bounds."""
    shape = dict(b=GPT_MBS, s=GPT_SEQ, nh=32, nkv=8, d=128)
    if not check_case(torch, fa, f"megatron_gpt attention b={GPT_MBS} s={GPT_SEQ}",
                      b=GPT_MBS, sq=GPT_SEQ, skv=GPT_SEQ, nh=shape["nh"], nkv=shape["nkv"],
                      d=shape["d"], seed=151):
        fail("a kernel disagrees with its plain version at megatron_gpt's attention")
    gen = torch.Generator(device="cuda").manual_seed(152)
    q, k, v, do = (kt.randn_bf16(gen, GPT_MBS, GPT_SEQ, h, shape["d"])
                   for h in (shape["nh"], shape["nkv"], shape["nkv"], shape["nh"]))
    with torch.no_grad():
        o, lse = fa.flash_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    ms = kt.kernel_ms(q, k, v, do, lse, delta)
    bounds = bounds_ms(kt, peaks, shape)
    rows = []
    for kname, t in ms.items():
        rows.append({"kernel": kname, "ms": t, "bound_ms": bounds[kname][0],
                     "bound_by": bounds[kname][1], **shape})
        log(f"gpt attention time {kname} b={GPT_MBS} s={GPT_SEQ} nh 32 nkv 8 d 128: {t:.3f} ms, "
            f"bound {bounds[kname][0]:.3f} ms ({bounds[kname][1]}), "
            f"{bounds[kname][0] / t:.3f} of bound [{card}]")
    del q, k, v, do, o, lse, delta
    free_cuda(torch)
    return rows


def phase_gpt_tp(torch, cell, card: str) -> dict | None:
    """15f, with two or more cards: 15a's cell (``megatron_gpt`` at full
    width, 4 layers, 4 microbatches of 2 rows) under torchrun over NCCL at
    tp 2 with SP (vocab 50257 in padded 25129-row slices) and, with four
    cards, tp 4 (12565 rows), each against tp 1 under torchrun at the tp
    bars (loss rtol 1e-4, grad norm 2e-3), with exact launches on every
    rank; and at dropout 0.1, tp 2 against tp 1 (each rank draws its slice
    of one card's masks) at the same bars.  With one card it says why it
    did not run and returns None."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"gpt: phase 15f (megatron_gpt at tp 2 / 4 against tp 1) not run: this machine "
            f"shows {n_cards} card, and NCCL takes one rank per card")
        return None
    t_phase = time.perf_counter()
    base = ("--config", str(GPT_CONF / "megatron_gpt_config.yaml"),
            "--set", f"data.global_batch_size={GPT_MBS * GPT_MICRO}")
    expect = GPT_LAYERS * GPT_MICRO * cell.STEPS

    def run(tp: int, name: str, *extra: str) -> dict:
        rep = torchrun_cell(cell, tp, cell.WORK / f"exp_gpt_{name}", 900, *base, "--tp", str(tp),
                            *(("--sp",) if tp > 1 else ()), *extra)
        for r in rep["ranks"]:
            if any(k != expect for k in r["launches"].values()) or r["fallbacks"]["core"]:
                fail(f"gpt 15f {name}: rank {r['rank']} launches {r['launches']}, expected "
                     f"{expect} each")
        log(f"gpt 15f {name} (tp {rep['tp']}, sp {rep['sp']}): losses {rep['loss']}, grad norms "
            f"{rep['grad_norm']}, step seconds {rep['step_seconds']}, peak per rank "
            f"{[r['peak_bytes'] for r in rep['ranks']]} bytes [{card}]")
        return rep

    def against(rep: dict, ref: dict, name: str) -> None:
        ok = all(math.isclose(a, b, rel_tol=TP_LOSS_RTOL) for a, b in zip(rep["loss"], ref["loss"]))
        ok &= all(math.isclose(a, b, rel_tol=TP_GRAD_NORM_RTOL)
                  for a, b in zip(rep["grad_norm"], ref["grad_norm"]))
        log(f"gpt 15f {name}: within the tp bars of tp 1: {ok}")
        if not ok:
            fail(f"gpt 15f {name}: losses {rep['loss']} / grad norms {rep['grad_norm']} against "
                 f"tp 1's {ref['loss']} / {ref['grad_norm']}")

    out = {"tp1": run(1, "tp1")}
    tps = (2, 4) if n_cards >= 4 else (2,)
    for tp in tps:
        out[f"tp{tp}"] = run(tp, f"tp{tp}")
        against(out[f"tp{tp}"], out["tp1"], f"tp{tp}")
    drop = ("--set", "model.hidden_dropout=0.1")
    out["drop_tp1"] = run(1, "drop_tp1", *drop)
    out["drop_tp2"] = run(2, "drop_tp2", *drop)
    against(out["drop_tp2"], out["drop_tp1"], "dropout 0.1, tp2")
    if out["drop_tp1"]["loss"] == out["tp1"]["loss"]:
        fail("gpt 15f: the dropout run's losses equal the dropout-0 run's")
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"gpt 15f: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_gpt(torch, fa, kt, card: str, peaks) -> dict:
    """Phase 15, 15a-15e and the kernels at GPT's attention."""
    t_phase = time.perf_counter()
    out = {"pretrain": phase_gpt_pretrain(torch, fa, card)}
    out["mistral"] = gpt_mistral_pair(torch, fa, card)
    out["dropout"] = phase_gpt_dropout(torch, fa, card)
    out["mixtral"] = phase_gpt_mixtral(torch, fa, card)
    out["pp_70b"] = phase_gpt_pp_70b(torch, fa, card)
    out["kernels"] = phase_gpt_kernels(torch, fa, kt, card, peaks)
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"gpt 15a-15e: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 16: the fit loop as shipped (cadence, telemetry, recorder, EMA, warm start)
# ---------------------------------------------------------------------------

#: 16a: the flagship's own cadence over 20 steps
CADENCE_STEPS, CADENCE_LOG_EVERY = 20, 10
#: 16c's EMA decay
EMA_DECAY = 0.99
#: the keys every 16a record carries (and one time/* key at least)
CADENCE_KEYS = ("goodput_fraction", "throughput_seqs_per_sec", "throughput_peak", "step_time",
                "mfu", "tokens_per_sec", "device_bytes_in_use", "device_peak_bytes_in_use",
                "device_bytes_limit")
#: the census keys 16a's run_summary.json carries
CENSUS_KEYS = ("compile_seconds", "collectives", "memory", "fwd_flops_per_token",
               "train_step_flops_per_token", "peak_tflops_per_chip", "model_family", "n_chips",
               "seq_len", "global_batch_size", "pipeline_schedule",
               "bubble_fraction_predicted")


def cell_cfg(cell, *sets: str):
    """The phase-4 cell's config (``tools/step_times.py``) with more
    ``key=value`` overrides."""
    from neuronx_distributed_training_torch.config.loader import load_config
    from neuronx_distributed_training_torch.trainer import cli

    args = cell.CLI_ARGS + [x for kv in sets for x in ("--set", kv)]
    return load_config(args[1], cli.parse_overrides([a for a in args[2:] if a != "--set"]))


class SyncWatch:
    """Records every synchronizing CUDA call inside each step's dispatch
    (``Trainer._dispatch``: the batch's copy and the train step) from step
    ``first`` on, through ``torch.cuda``'s sync debug mode: each such call
    warns, and the warning's source line is kept.  The mode is the
    process's, so a background thread's syncs in that time (an async
    checkpoint's commit) warn too: they are counted apart (``others``), by
    the warning thread."""

    def __init__(self, torch, first: int):
        self.torch, self.first, self.syncs, self.others = torch, first, [], 0

    def __enter__(self):
        import threading
        import warnings

        from neuronx_distributed_training_torch.trainer.loop import Trainer

        self.real = real = Trainer._dispatch
        torch, watch = self.torch, self

        def dispatch(trainer, host_batch, index):
            if index < watch.first:
                return real(trainer, host_batch, index)
            seen: list = []

            def show(message, category, filename, lineno, file=None, line=None):
                seen.append((threading.get_ident(), str(message), filename, lineno))

            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = real(trainer, host_batch, index)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            me = threading.get_ident()
            syncs = [w for w in seen if "called a synchronizing" in w[1]]
            watch.syncs += [(index, f"{fn}:{ln}", msg[:160]) for tid, msg, fn, ln in syncs
                            if tid == me]
            watch.others += sum(1 for w in syncs if w[0] != me)
            return out

        Trainer._dispatch = dispatch
        return self

    def __exit__(self, *exc):
        from neuronx_distributed_training_torch.trainer.loop import Trainer

        Trainer._dispatch = self.real


def skip_cost(torch, trainer, card: str) -> dict:
    """The skip's select in phase 4's step: AdamW over the trained 4-layer
    state with finite zero gradients, with the health probes as under
    ``dump_and_continue`` (no select) and under ``skip_update`` (each leaf
    written through ``torch.where``), CUDA-event ms, alternated 3 times
    each (the state is garbage afterwards)."""
    import statistics

    from neuronx_distributed_training_torch.models.llama import named_params
    from neuronx_distributed_training_torch.optim.adamw import AdamWConfig, adamw_update
    from neuronx_distributed_training_torch.telemetry.health import grad_group_of

    flat = named_params(trainer.params)
    grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in flat.items()}
    out = {False: [], True: []}
    for _ in range(3):
        for skip in (False, True):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            adamw_update(flat, grads, trainer.opt_state, 1e-6, AdamWConfig(), trainer.policy,
                         grad_group_fn=grad_group_of, skip_nonfinite=skip)
            end.record()
            torch.cuda.synchronize()
            out[skip].append(start.elapsed_time(end))
    rep = {"plain_ms": statistics.median(out[False]), "skip_ms": statistics.median(out[True]),
           "params": sum(p.numel() for p in flat.values())}
    log(f"cadence 16a: AdamW over phase 4's state ({rep['params']} params): no select "
        f"{out[False]} ms, skip_update's select {out[True]} ms (medians {rep['plain_ms']:.2f} / "
        f"{rep['skip_ms']:.2f}) [{card}]")
    del grads
    return rep


def phase_cadence(torch, fa, cell, history4: list, card: str) -> dict:
    """16a: the flagship's telemetry block and ``log_every_n_steps: 10``
    for 20 steps through the CLI, phase 4's cell otherwise."""
    from neuronx_distributed_training_torch.trainer import cli

    t_phase = time.perf_counter()
    exp = cell.WORK / "exp_cadence"
    shutil.rmtree(exp, ignore_errors=True)
    args = cell.CLI_ARGS + ["--set", f"trainer.max_steps={CADENCE_STEPS}",
                            "--set", f"trainer.log_every_n_steps={CADENCE_LOG_EVERY}",
                            "--set", f"exp_manager.exp_dir={exp}"]
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counters()
    try:
        with SyncWatch(torch, first=2) as watch:
            trainer, history = cli.run(args)
        torch.cuda.synchronize()
        launches, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
        peak = torch.cuda.max_memory_allocated()
        records = [json.loads(x) for x in
                   (trainer.exp.log_dir / "metrics.jsonl").read_text().splitlines()]
        summary = json.loads((trainer.exp.log_dir / "run_summary.json").read_text())
        cost = skip_cost(torch, trainer, card)
        del trainer
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    expect = cell.LAYERS * cell.MICROBATCHES * CADENCE_STEPS
    med4 = _median([r["step_seconds"] for r in history4[1:]])
    for r in records:
        log(f"cadence 16a: boundary {r['step']}: step_time {r['step_time']:.4f} s, "
            f"time/dispatch {r.get('time/dispatch', 0.0):.3f} s, time/host_sync "
            f"{r.get('time/host_sync', 0.0):.3f} s, time/data_wait "
            f"{r.get('time/data_wait', 0.0):.3f} s, time/compile "
            f"{r.get('time/compile', 0.0):.3f} s, goodput {r.get('goodput_fraction')}, "
            f"{r.get('tokens_per_sec', 0.0):.1f} tokens/s, throughput "
            f"{r.get('throughput_seqs_per_sec')} seqs/s (peak {r.get('throughput_peak')}), "
            f"mfu {r.get('mfu')}, device bytes in use {r.get('device_bytes_in_use')} "
            f"(peak {r.get('device_peak_bytes_in_use')}) [{card}]")
    log(f"cadence 16a: window step_time {[r['step_time'] for r in records]} s against phase "
        f"4's median step with a sync a step {med4:.4f} s ({[r['step_seconds'] for r in history4]})"
        f" [{card}]")
    census = {k: summary.get(k) for k in CENSUS_KEYS}
    log(f"cadence 16a: census {json.dumps(census)}; goodput {json.dumps(summary.get('goodput'))}; "
        f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB) [{card}]")
    log(f"cadence 16a: launches {launches} fallbacks {fallbacks} (expected {expect} each); "
        f"host syncs inside steps 2-{CADENCE_STEPS - 1}'s dispatch: {len(watch.syncs)}")
    if len(history) != CADENCE_STEPS:
        fail(f"cadence: {len(history)} steps, expected {CADENCE_STEPS}")
    if [r["step"] for r in records] != list(range(CADENCE_LOG_EVERY, CADENCE_STEPS + 1,
                                                  CADENCE_LOG_EVERY)):
        fail(f"cadence: metrics.jsonl has steps {[r['step'] for r in records]}")
    for r in records:
        missing = [k for k in CADENCE_KEYS if k not in r]
        if missing or not any(k.startswith("time/") for k in r):
            fail(f"cadence: the step-{r['step']} record lacks {missing} or time/*: {sorted(r)}")
    missing = [k for k in CENSUS_KEYS if k not in summary] + \
        (["goodput"] if "goodput" not in summary else [])
    if missing or summary.get("compile_seconds") is None or not summary.get("memory"):
        fail(f"cadence: run_summary.json lacks {missing} (or an empty census): {sorted(summary)}")
    got = [(r["loss"], r["grad_norm"]) for r in history[:len(history4)]]
    want = [(r["loss"], r["grad_norm"]) for r in history4]
    if got != want:
        fail(f"cadence: steps 0-{len(history4) - 1} are not phase 4's bit for bit: {got} vs "
             f"{want}")
    if not all(math.isfinite(r["loss"]) for r in history):
        fail("cadence: a non-finite loss")
    if any(n != expect for n in launches.values()) or fallbacks["core"]:
        fail(f"cadence: launches {launches} (fallbacks {fallbacks}), expected {expect} each")
    if watch.syncs:
        fail(f"cadence: host syncs between boundaries: {watch.syncs[:12]}")
    out = {"launches": launches, "records": records, "census": census,
           "goodput": summary.get("goodput"), "peak_bytes": peak, "skip_cost": cost,
           "phase_seconds": time.perf_counter() - t_phase}
    log(f"cadence 16a: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def state_digests(torch, trainer) -> dict:
    """Digests of the params, mu and nu and the AdamW step, after a sync."""
    from neuronx_distributed_training_torch.models.llama import named_params

    torch.cuda.synchronize()
    o = trainer.opt_state
    return {"params": [device_digest(torch, t) for t in named_params(trainer.params).values()],
            "mu": [device_digest(torch, t) for t in o["mu"].values()],
            "nu": [device_digest(torch, t) for t in o["nu"].values()],
            "step": int(o["step"])}


def phase_cadence_skip(torch, fa, cell, card: str) -> dict:
    """16b: phase 7b's NaN ``loss_mask`` at step 1 under ``skip_update`` at
    ``log_every_n_steps: 2``: the boundary after step 1 writes
    ``anomaly_00000001/``, step 1 keeps the state bit for bit; then
    ``halt`` stops at that boundary without a checkpoint."""
    import numpy as np

    from neuronx_distributed_training_torch.data.loader import SyntheticDataModule
    from neuronx_distributed_training_torch.trainer.loop import Trainer

    class PoisonedRows(SyntheticDataModule):
        def global_batches(self):
            for i, batch in enumerate(super().global_batches()):
                if i == 1:
                    batch["loss_mask"] = np.full_like(batch["loss_mask"], np.nan)
                yield batch

    t_phase = time.perf_counter()
    out = {}
    for policy in ("skip_update", "halt"):
        exp = cell.WORK / f"exp_cadence_{policy}"
        shutil.rmtree(exp, ignore_errors=True)
        # halt saves every 2 steps: the halt at step 2's boundary must not
        every = 2 if policy == "halt" else 0
        cfg = cell_cfg(cell, f"model.num_layers={SKIP_LAYERS}", "trainer.max_steps=4",
                       "trainer.log_every_n_steps=2", f"exp_manager.exp_dir={exp}",
                       f"exp_manager.telemetry.health.policy={policy}",
                       f"exp_manager.checkpoint_callback_params.every_n_train_steps={every}")
        data = PoisonedRows(cfg.model.vocab_size, cfg.data.seq_length,
                            cfg.data.global_batch_size, seed=int(cfg.get("seed", 1234)))
        fa.reset_counters()
        try:
            trainer = Trainer.from_config(cfg, data_module=data)
            seen = {}
            real = trainer._dispatch

            def dispatch(host_batch, index, _t=trainer, _real=real, _seen=seen):
                if index in (1, 2):
                    _seen[index] = state_digests(torch, _t)  # the state before the step
                return _real(host_batch, index)

            trainer._dispatch = dispatch
            history = trainer.fit()
            log_dir = trainer.exp.log_dir
            bundles = sorted(p.name for p in log_dir.glob("anomaly_*"))
            files = sorted(p.name for p in (log_dir / "anomaly_00000001").glob("*")) \
                if bundles else []
            rec = {"steps": [h["step"] for h in history], "stop_class": trainer.stop_class,
                   "committed": list(trainer.checkpointer.committed_steps),
                   "bundles": bundles, "files": files,
                   "finite": [h["health/updates_finite"] for h in history],
                   "skipped": [h["health/skipped_count"] for h in history],
                   "kept": seen.get(1) == seen.get(2), "launches": dict(fa.LAUNCHES)}
            # the wrapper and the trainer hold each other: drop every name
            # of them, so free_cuda's collection frees the card
            del trainer, real, dispatch
        finally:
            shutil.rmtree(exp, ignore_errors=True)
        free_cuda(torch)
        log(f"cadence 16b ({policy}): steps {rec['steps']}, updates_finite {rec['finite']}, "
            f"skipped_count {rec['skipped']}, stop {rec['stop_class']}, saves "
            f"{rec['committed']}, bundles {rec['bundles']} {rec['files']}, step 1 kept the "
            f"state bit for bit: {rec['kept']}; launches {rec['launches']}")
        if rec["bundles"] != ["anomaly_00000001"] or rec["files"] != ["anomaly.json", "ring.json"]:
            fail(f"cadence 16b ({policy}): bundles {rec['bundles']} {rec['files']}")
        if policy == "skip_update":
            if rec["steps"] != [0, 1, 2, 3] or rec["finite"] != [1.0, 0.0, 1.0, 1.0] or \
                    not rec["kept"] or rec["skipped"][1] != 1.0 or rec["committed"]:
                fail(f"cadence 16b: the NaN step was not skipped on the card: {rec}")
        elif rec["steps"] != [0, 1] or rec["stop_class"] != "health_halt" or rec["committed"]:
            fail(f"cadence 16b: halt did not stop at the boundary without a save: {rec}")
        out[policy] = rec
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"cadence 16b: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_ema(torch, fa, cell, card: str) -> dict:
    """16c: EMA (decay 0.99, ``evaluate_ema_weights_instead``) at 2 layers
    for 3 steps, validation at step 3: the EMA against a plain fp32
    recomputation (on the host) from each step's weights, the params bit
    for bit after the swap back; peak memory beside the same run without
    EMA, which saves at step 3 for 16d."""
    from neuronx_distributed_training_torch.data.loader import SyntheticDataModule
    from neuronx_distributed_training_torch.models.llama import named_params
    from neuronx_distributed_training_torch.trainer.loop import Trainer

    t_phase = time.perf_counter()
    out = {}
    base = (f"model.num_layers={SKIP_LAYERS}", "trainer.max_steps=3",
            "trainer.val_check_interval=3", "trainer.limit_val_batches=1")
    for ema in (True, False):
        exp = cell.WORK / f"exp_ema_{ema}"
        shutil.rmtree(exp, ignore_errors=True)
        sets = base + (f"exp_manager.exp_dir={exp}",)
        if ema:
            sets += ("exp_manager.ema.enable=true", f"exp_manager.ema.decay={EMA_DECAY}",
                     "exp_manager.ema.evaluate_ema_weights_instead=true")
        else:
            sets += ("exp_manager.checkpoint_callback_params.every_n_train_steps=3",
                     "exp_manager.checkpoint_callback_params.async_checkpointing=false")
        cfg = cell_cfg(cell, *sets)
        val = SyntheticDataModule(cfg.model.vocab_size, cfg.data.seq_length,
                                  cfg.data.global_batch_size, seed=99)
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer.from_config(cfg, val_data_module=val, enable_checkpointing=not ema)
        rec: dict = {}
        if ema:
            d = torch.tensor(EMA_DECAY, dtype=torch.float32)
            c = 1.0 - d
            ref = {n: p.detach().float().cpu() for n, p in named_params(trainer.params).items()}
            real, real_val = trainer._dispatch, trainer.validate
            swaps = []

            def dispatch(host_batch, index, _t=trainer, _real=real):
                metrics = _real(host_batch, index)
                for n, p in named_params(_t.params).items():  # after the step
                    ref[n] = d * ref[n] + c * p.detach().float().cpu()
                return metrics

            def validate(limit, _t=trainer, _real=real_val):
                before = state_digests(torch, _t)["params"]
                loss = _real(limit)
                swaps.append(before == state_digests(torch, _t)["params"])
                return loss

            trainer._dispatch, trainer.validate = dispatch, validate
        history = trainer.fit()
        torch.cuda.synchronize()
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["val_loss"] = history[-1].get("val_loss")
        if ema:
            gaps, bitwise = [], True
            for n, e in trainer.opt_state["ema"].items():
                e = e.float().cpu()
                gaps.append(float((e - ref[n]).abs().max()))
                bitwise = bitwise and torch.equal(e, ref[n])
            rec.update(max_gap=max(gaps), bitwise=bitwise, swapped_back=swaps,
                       largest=max(float(r.abs().max()) for r in ref.values()))
            del ref
        else:
            rec["checkpoint"] = str(trainer.checkpointer.directory)
            rec["committed"] = list(trainer.checkpointer.committed_steps)
            rec["params"] = state_digests(torch, trainer)["params"]
            out["exp"] = exp
        if ema:
            # the wrappers and the trainer hold each other: drop every name
            # of them, so free_cuda's collection frees the card
            del real, real_val, dispatch, validate
        log(f"ema 16c ({'ema' if ema else 'no ema'}): losses "
            f"{[h['loss'] for h in history]}, val loss {rec['val_loss']}, peak device memory "
            f"{rec['peak_bytes']} bytes ({rec['peak_bytes'] / 2**30:.2f} GiB)"
            + (f"; EMA against the host recomputation: largest gap {rec['max_gap']} (weights "
               f"up to {rec['largest']:.3f}), bit for bit {rec['bitwise']}; params after the "
               f"swap back bit for bit {rec['swapped_back']}" if ema else
               f"; saves {rec['committed']}") + f" [{card}]")
        del trainer
        free_cuda(torch)
        if ema and (rec["max_gap"] > 1e-6 * max(rec["largest"], 1.0)
                    or rec["swapped_back"] != [True] or not math.isfinite(rec["val_loss"])):
            fail(f"ema 16c: {rec}")
        if not ema and rec["committed"] != [3]:
            fail(f"ema 16c: the run without EMA saved {rec['committed']}, expected [3]")
        out["ema" if ema else "plain"] = rec
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"ema 16c: peak with EMA {out['ema']['peak_bytes']} bytes against "
        f"{out['plain']['peak_bytes']} without (+{(out['ema']['peak_bytes'] - out['plain']['peak_bytes']) / 2**30:.2f} GiB); "
        f"phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_warm(torch, fa, cell, ema_rep: dict, card: str) -> dict:
    """16d: a warm start (``model.weight_init_only`` with
    ``exp_manager.resume_from_checkpoint``) from 16c's step-3 save: the
    params are the saved ones bit for bit, the step, the moments and the
    data position fresh."""
    from neuronx_distributed_training_torch.trainer.loop import Trainer

    t_phase = time.perf_counter()
    exp = cell.WORK / "exp_warm"
    shutil.rmtree(exp, ignore_errors=True)
    try:
        cfg = cell_cfg(cell, f"model.num_layers={SKIP_LAYERS}", "model.weight_init_only=true",
                       f"exp_manager.resume_from_checkpoint={ema_rep['plain']['checkpoint']}",
                       f"exp_manager.exp_dir={exp}")
        t0 = time.perf_counter()
        trainer = Trainer.from_config(cfg, enable_checkpointing=False)
        build_s = time.perf_counter() - t0
        digests = state_digests(torch, trainer)
        moments_zero = all(not bool(m.any()) for g in ("mu", "nu")
                           for m in trainer.opt_state[g].values())
        rec = {"params_equal": digests["params"] == ema_rep["plain"]["params"],
               "step": digests["step"], "loop_step": trainer.step,
               "consumed": trainer.data_module.sampler.consumed_samples,
               "moments_zero": moments_zero, "build_seconds": build_s}
        del trainer
    finally:
        shutil.rmtree(exp, ignore_errors=True)
        shutil.rmtree(ema_rep["exp"], ignore_errors=True)
    free_cuda(torch)
    rec["phase_seconds"] = time.perf_counter() - t_phase
    log(f"warm 16d: params bit for bit {rec['params_equal']}, AdamW step {rec['step']}, loop "
        f"step {rec['loop_step']}, consumed samples {rec['consumed']}, moments zero "
        f"{rec['moments_zero']}; build with the restore {rec['build_seconds']:.1f} s; phase "
        f"wall time {rec['phase_seconds']:.1f} s [{card}]")
    if not (rec["params_equal"] and rec["step"] == 0 and rec["loop_step"] == 0
            and rec["consumed"] == 0 and rec["moments_zero"]):
        fail(f"warm 16d: {rec}")
    return rec


def phase_fit(torch, fa, cell, history4: list, card: str) -> dict:
    """Phase 16, 16a-16d."""
    t_phase = time.perf_counter()
    out = {"cadence": phase_cadence(torch, fa, cell, history4, card)}
    free_cuda(torch)
    out["skip"] = phase_cadence_skip(torch, fa, cell, card)
    out["ema"] = phase_ema(torch, fa, cell, card)
    out["warm"] = phase_warm(torch, fa, cell, out["ema"], card)
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"fit 16a-16d: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 17: the converters and the planes tiny_smoke turns on
# ---------------------------------------------------------------------------

CONVERT_SEED = 20261118
#: the LoRA SFT config 17a warm-starts from the converted checkpoint
LORA_SFT = "hf_llama3_8B_SFT_lora_config.yaml"
#: the tiny_smoke telemetry blocks 17b turns on over phase 16a's cadence
PLANE_BLOCKS = ("tensorstats", "fleet", "control", "memory", "alerts")
#: 17b's steps: four windows of 16a's cadence.  The first runs the memory
#: window's allocation-stack recording; the second holds the profile's
#: capture at the step-10 boundary (the boundary's work after its window
#: is timed lands in the next, as in JAX); the third is the planes alone;
#: the fourth runs beside the checkpoint that tools/run_ctl.py's
#: checkpoint_now, enqueued before step CHECKPOINT_NOW_AT's dispatch, asks
#: for at the step-30 boundary
PLANES_STEPS = 40
CHECKPOINT_NOW_AT = 25


def phase_convert(torch, fa, card: str) -> dict:
    """17a: an HF-named Llama-3-8B-width state dict at SKIP_LAYERS layers,
    drawn from a seed on the card and written as ``pytorch_model.bin``
    (bf16, as HF ships); ``checkpoint_converter hf2native``; the LoRA SFT
    config warm-started from it for SFT_STEPS steps against a run handed the
    same weights in memory (losses and grad norms bit for bit, exact
    launches); ``native2hf`` back equals the written dict bit for bit."""
    from neuronx_distributed_training_torch.config.loader import load_config
    from neuronx_distributed_training_torch.models import llama
    from neuronx_distributed_training_torch.tools import checkpoint_converter as cc
    from neuronx_distributed_training_torch.tools import convert
    from neuronx_distributed_training_torch.tools import step_times as cell
    from neuronx_distributed_training_torch.trainer import cli
    from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

    t_phase = time.perf_counter()
    work = cell.WORK / "convert"
    shutil.rmtree(work, ignore_errors=True)
    (work / "hf").mkdir(parents=True)
    args = sft_args(LORA_SFT, SKIP_LAYERS)
    cfg = load_config(args[1], cli.parse_overrides([a for a in args[2:] if a != "--set"]))
    mc = llama.LlamaConfig.from_config(cfg["model"], cfg["distributed_strategy"])
    rep: dict = {}
    try:
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(CONVERT_SEED)
        base = llama.init_params(mc, DtypePolicy.from_precision_config({"type": "fp32"}),
                                 generator=gen, device="cuda")
        host = {k: v.to(torch.bfloat16).cpu()
                for k, v in convert.native_to_hf_llama(base, mc).items()}
        del base
        torch.save(host, work / "hf" / "pytorch_model.bin")
        rep["hf_bytes"] = sum(v.numel() * v.element_size() for v in host.values())
        rep["write_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cc.main(["--direction", "hf2native", "--input", str(work / "hf"),
                 "--output", str(work / "native"), *args])
        rep["hf2native_seconds"] = time.perf_counter() - t0
        warm_args = args + ["--set", "model.weight_init_only=true",
                            "--set", f"exp_manager.resume_from_checkpoint={work / 'native'}"]
        runs = {}
        for name in ("warm", "memory"):
            fa.reset_counters()
            t0 = time.perf_counter()
            t = cli.build(warm_args if name == "warm" else args)
            if name == "memory":
                src = llama.named_params(convert.hf_llama_to_native(host, mc, device="cuda"))
                with torch.no_grad():
                    for n, p in llama.named_params(t.params).items():
                        if n in src:
                            p.copy_(src[n])
                del src
            history = t.fit()
            torch.cuda.synchronize()
            runs[name] = {"history": [(h["loss"], h["grad_norm"]) for h in history],
                          "launches": dict(fa.LAUNCHES), "fallbacks": dict(fa.FALLBACKS),
                          "seconds": time.perf_counter() - t0}
            del t
            free_cuda(torch)
        t0 = time.perf_counter()
        cc.main(["--direction", "native2hf", "--input", str(work / "native"),
                 "--output", str(work / "back"), *args])
        back = torch.load(work / "back" / "pytorch_model.bin")
        rep["native2hf_seconds"] = time.perf_counter() - t0
        rep["round_trip_equal"] = (set(back) == set(host)
                                   and all(torch.equal(back[k], host[k]) for k in host))
        del back, host
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(cell.WORK / "exp_sft", ignore_errors=True)
    expect = SKIP_LAYERS * SFT_MICRO * SFT_STEPS
    rep.update(runs=runs, expect=expect, phase_seconds=time.perf_counter() - t_phase)
    for name, r in runs.items():
        log(f"convert 17a: {name} run losses/grad norms {r['history']}, launches "
            f"{r['launches']} fallbacks {r['fallbacks']} (expected {expect} each), "
            f"{r['seconds']:.1f} s [{card}]")
    log(f"convert 17a: HF dict {rep['hf_bytes']} bytes written in {rep['write_seconds']:.1f} s, "
        f"hf2native {rep['hf2native_seconds']:.1f} s, native2hf {rep['native2hf_seconds']:.1f} s, "
        f"round trip bit for bit {rep['round_trip_equal']}; phase wall time "
        f"{rep['phase_seconds']:.1f} s [{card}]")
    if runs["warm"]["history"] != runs["memory"]["history"]:
        fail(f"convert 17a: the warm start is not the in-memory run bit for bit: {runs}")
    if not all(math.isfinite(loss) for loss, _ in runs["warm"]["history"]):
        fail("convert 17a: a non-finite loss")
    for name, r in runs.items():
        if any(n != expect for n in r["launches"].values()) or r["fallbacks"]["core"]:
            fail(f"convert 17a: {name} launches {r['launches']} (fallbacks {r['fallbacks']}), "
                 f"expected {expect} each")
    if not rep["round_trip_equal"]:
        fail("convert 17a: native2hf does not give the written dict back bit for bit")
    return rep


def smoke_plane_sets() -> list:
    """``--set`` pairs putting tiny_smoke's tensorstats, fleet, control,
    memory and alerts blocks into a config (JSON is YAML)."""
    import yaml

    tel = yaml.safe_load((REPO / "examples" / "conf" / "tiny_smoke_config.yaml").read_text()
                         )["exp_manager"]["telemetry"]
    return [x for b in PLANE_BLOCKS
            for x in ("--set", f"exp_manager.telemetry.{b}={json.dumps(tel[b])}")]


def tensorstats_cost(torch, trainer, card: str) -> dict:
    """Tensorstats' share of the step: AdamW over the trained state with
    gradients drawn from a seed (the histograms' exponents spread as a real
    step's do), with and without the pre- and post-clip statistics,
    CUDA-event ms, alternated 3 times each (the state is garbage
    afterwards)."""
    import statistics

    from neuronx_distributed_training_torch.models.llama import named_params
    from neuronx_distributed_training_torch.optim.adamw import AdamWConfig, adamw_update
    from neuronx_distributed_training_torch.telemetry.health import grad_group_of

    flat = named_params(trainer.params)
    gen = torch.Generator(device="cuda").manual_seed(CONVERT_SEED)
    grads = {n: 1e-4 * torch.randn(p.shape, generator=gen, device=p.device)
             for n, p in flat.items()}
    ts = trainer.exp.telemetry.tensorstats
    out = {False: [], True: []}
    for _ in range(3):
        for on in (False, True):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            adamw_update(flat, grads, trainer.opt_state, 1e-6, AdamWConfig(), trainer.policy,
                         grad_group_fn=grad_group_of, tensorstats=ts if on else None)
            end.record()
            torch.cuda.synchronize()
            out[on].append(start.elapsed_time(end))
    rep = {"plain_ms": statistics.median(out[False]), "stats_ms": statistics.median(out[True]),
           "params": sum(p.numel() for p in flat.values())}
    log(f"planes 17b: AdamW over phase 4's state ({rep['params']} params): without tensorstats "
        f"{out[False]} ms, with the pre- and post-clip statistics {out[True]} ms (medians "
        f"{rep['plain_ms']:.2f} / {rep['stats_ms']:.2f}) [{card}]")
    del grads
    return rep


def phase_planes(torch, fa, cell, cadence: dict, card: str) -> dict:
    """17b: phase 16a's cadence with tiny_smoke's planes on: 0 syncs inside
    a dispatch, the windows' step_time against 16a's, memory_summary.json's
    subsystem bytes against ``tree_bytes_by_subsystem``, the tensorstats
    records, and a ``tools/run_ctl.py checkpoint_now`` enqueued before step
    CHECKPOINT_NOW_AT's dispatch saving at the next boundary."""
    from neuronx_distributed_training_torch.telemetry.memory import tree_bytes_by_subsystem
    from neuronx_distributed_training_torch.trainer import cli
    from neuronx_distributed_training_torch.trainer.loop import Trainer

    t_phase = time.perf_counter()
    exp = cell.WORK / "exp_planes"
    shutil.rmtree(exp, ignore_errors=True)
    args = cell.CLI_ARGS + ["--set", f"trainer.max_steps={PLANES_STEPS}",
                            "--set", f"trainer.log_every_n_steps={CADENCE_LOG_EVERY}",
                            "--set", f"exp_manager.exp_dir={exp}", *smoke_plane_sets()]
    enqueued: list = []
    real = Trainer._dispatch

    def dispatch(trainer, host_batch, index):
        if index == CHECKPOINT_NOW_AT:
            out = subprocess.run([sys.executable, str(REPO / "tools" / "run_ctl.py"),
                                  str(trainer.exp.log_dir), "checkpoint_now"],
                                 capture_output=True, text=True, timeout=60)
            enqueued.append(out.returncode)
        return real(trainer, host_batch, index)

    torch.cuda.reset_peak_memory_stats()
    fa.reset_counters()
    Trainer._dispatch = dispatch
    try:
        with SyncWatch(torch, first=2) as watch:
            trainer, history = cli.run(args)
        torch.cuda.synchronize()
        launches, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
        run = Path(trainer.exp.log_dir)
        records = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
        ts_lines = [json.loads(x) for x in (run / "tensorstats.jsonl").read_text().splitlines()]
        mem = json.loads((run / "memory_summary.json").read_text())
        tree = tree_bytes_by_subsystem(trainer.params, trainer.opt_state)
        summary = json.loads((run / "run_summary.json").read_text())
        fleet = sorted(p.name for p in (run / "fleet").iterdir())
        committed = list(trainer.checkpointer.committed_steps)
        cost = tensorstats_cost(torch, trainer, card)
        del trainer
    finally:
        Trainer._dispatch = real
        shutil.rmtree(exp, ignore_errors=True)
    free_cuda(torch)
    expect = cell.LAYERS * cell.MICROBATCHES * PLANES_STEPS
    ref = [r["step_time"] for r in cadence["records"]]
    attribution = {c: r["bytes"] for c, r in mem["attribution"].items()}
    log(f"planes 17b: window step_time {[r['step_time'] for r in records]} s against 16a's "
        f"{ref} s (tensorstats, fleet, control, memory, alerts on; window 1 runs the memory "
        f"window's allocation-stack recording, window 2 holds the profile's capture, window 4 "
        f"runs beside the checkpoint_now save; window 3, the planes alone, "
        f"{records[2]['step_time'] / _median(ref):.4f} x 16a's median) [{card}]")
    for r in records:
        log(f"planes 17b: boundary {r['step']}: time/dispatch {r.get('time/dispatch', 0.0):.3f} s, "
            f"time/host_sync {r.get('time/host_sync', 0.0):.3f} s, time/checkpoint "
            f"{r.get('time/checkpoint', 0.0):.3f} s, memory/hbm_headroom_fraction "
            f"{r.get('memory/hbm_headroom_fraction')}, memory/peak_hbm_bytes "
            f"{r.get('memory/peak_hbm_bytes')}, tensorstats/pre/embed/rms "
            f"{r.get('tensorstats/pre/embed/rms')} [{card}]")
    log(f"planes 17b: memory_summary.json (profiled step {mem['profiled_step']}, "
        f"{mem['profile']['total_count']} live blocks, {mem['profile']['total_bytes']} bytes): "
        f"attribution {attribution} against tree_bytes_by_subsystem {tree} [{card}]")
    log(f"planes 17b: tensorstats.jsonl {len(ts_lines)} records of "
        f"{len(ts_lines[-1]['groups']) if ts_lines else 0} groups; fleet/{fleet}; control "
        f"{json.dumps(summary.get('control'))}; committed {committed}; launches {launches} "
        f"fallbacks {fallbacks} (expected {expect} each); host syncs inside steps "
        f"2-{PLANES_STEPS - 1}'s dispatch: {len(watch.syncs)} (other threads' inside it: "
        f"{watch.others})")
    if enqueued != [0]:
        fail(f"planes 17b: tools/run_ctl.py checkpoint_now exited {enqueued}")
    nxt = -(-(CHECKPOINT_NOW_AT + 1) // CADENCE_LOG_EVERY) * CADENCE_LOG_EVERY
    if nxt not in committed:
        fail(f"planes 17b: checkpoint_now did not save at step {nxt}: committed {committed}")
    if len(history) != PLANES_STEPS or not all(math.isfinite(h["loss"]) for h in history):
        fail(f"planes 17b: {len(history)} steps or a non-finite loss")
    if watch.syncs:
        fail(f"planes 17b: host syncs between boundaries: {watch.syncs[:12]}")
    if any(n != expect for n in launches.values()) or fallbacks["core"]:
        fail(f"planes 17b: launches {launches} (fallbacks {fallbacks}), expected {expect} each")
    if [r["step"] for r in ts_lines] != [r["step"] for r in records] or \
            not any(k.startswith("tensorstats/") for k in records[-1]) or \
            "memory/hbm_headroom_fraction" not in records[-1]:
        fail(f"planes 17b: the plane keys are missing: {sorted(records[-1])[:40]}")
    if fleet != ["host_0.jsonl"] or attribution.get("params") != tree["params"]:
        fail(f"planes 17b: fleet {fleet}; params attributed {attribution.get('params')} "
             f"against {tree['params']}")
    out = {"launches": launches, "records": records, "attribution": attribution,
           "tree_bytes": tree, "committed": committed, "tensorstats_cost": cost,
           "phase_seconds": time.perf_counter() - t_phase}
    log(f"planes 17b: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def phase_oom(cell, card: str) -> dict:
    """17c: phase 4's cell with a micro batch that cannot fit, in a
    subprocess with the memory plane on: it must write ``oom_<step>/`` and
    exit with the JAX CLI's code for an unclassified failure (1)."""
    from neuronx_distributed_training_torch.trainer.control import EXIT_ERROR

    t_phase = time.perf_counter()
    exp = cell.WORK / "exp_oom"
    shutil.rmtree(exp, ignore_errors=True)
    cmd = [sys.executable, "-m", "neuronx_distributed_training_torch.trainer.cli",
           *cell.CLI_ARGS, "--set", "data.micro_batch_size=64",
           "--set", "data.global_batch_size=64", "--set", "trainer.max_steps=2",
           "--set", f"exp_manager.exp_dir={exp}",
           "--set", "exp_manager.telemetry.memory={enabled: true}"]
    try:
        out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        bundles = sorted(exp.rglob("oom_*"))
        oom = json.loads((bundles[0] / "oom.json").read_text()) if bundles else {}
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    rep = {"returncode": out.returncode, "bundles": [b.name for b in bundles],
           "error": oom.get("error", "")[:200], "step": oom.get("step"),
           "phase_seconds": time.perf_counter() - t_phase}
    log(f"oom 17c: exit code {rep['returncode']} (expected {EXIT_ERROR}), bundles "
        f"{rep['bundles']}, error {rep['error']!r}, attribution at death "
        f"{oom.get('attribution_at_death')}; phase wall time {rep['phase_seconds']:.1f} s "
        f"[{card}]")
    if out.returncode != EXIT_ERROR or not bundles or "out of memory" not in rep["error"].lower():
        fail(f"oom 17c: {rep}; stderr tail {out.stderr[-1500:]}")
    return rep


def phase_convert_planes(torch, fa, cell, cadence: dict, card: str) -> dict:
    """Phase 17, 17a-17c."""
    t_phase = time.perf_counter()
    out = {"convert": phase_convert(torch, fa, card)}
    free_cuda(torch)
    out["planes"] = phase_planes(torch, fa, cell, cadence, card)
    out["oom"] = phase_oom(cell, card)
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"convert and planes 17a-17c: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 18: the trace plane, profiling windows and engineered overlap
# ---------------------------------------------------------------------------

#: 18a: steps, the telemetry.trace window, the profile window
TRACE_STEPS = 10
TRACE_WINDOW = {"start_step": 2, "num_steps": 3}
PROFILE_WINDOW = {"start": 6, "steps": 2}
#: each flash kernel's device time a launch in the trace against CUDA events
#: around its launches in the trainer's untraced steps (phase 3's time
#: printed beside)
TRACE_TIME_RTOL = 0.10
#: the flash kernels' rows of the trace summary's op table (the end of their
#: base names: ``nxdt::fwd::flash_fwd_kernel``)
TRACE_KERNELS = {"flash_fwd": "flash_fwd_kernel", "flash_dq": "flash_dq_kernel",
                 "flash_dkv": "flash_dkv_kernel"}
#: 18b: the trace window of the torchrun runs (raw traces kept: the window's
#: first step, which holds the profiler's start, is analyzed apart), and the
#: bucket size (MiB of fp32 master weights): at the cell's widths every layer
#: group but the norms holds more (attn 671 MB, mlp 2.8 GB, embed and head
#: 2.1 GB each), so the buckets are about the groups: 27 ZeRO-1 leaves
#: gather in 4 buckets
MULTI_TRACE = "{enabled: true, start_step: 2, num_steps: 3, keep_raw: true}"
MULTI_STEPS = 6
BUCKET_MB = 256
#: the trace summary's pipeline keys 18b prints
PIPE_KEYS = ("bubble_fraction_measured", "bubble_fraction_predicted", "lane_resolution",
             "num_lanes", "straggler_stage", "ticks_detected")


class ClockSampler:
    """The card's SM clock and power draw, sampled by ``nvidia-smi`` every
    ``period`` seconds on a thread while the block runs."""

    def __init__(self, period: float = 0.25):
        self.period, self.rows = period, []

    def __enter__(self):
        import threading

        self.stop = threading.Event()

        def run():
            while not self.stop.is_set():
                try:
                    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                          "--format=csv,noheader,nounits", "-i", "0"],
                                         capture_output=True, text=True, timeout=10)
                except (OSError, subprocess.TimeoutExpired):
                    return
                try:
                    mhz, watts = (float(x) for x in out.stdout.strip().split(","))
                    self.rows.append((mhz, watts))
                except ValueError:
                    pass
                self.stop.wait(self.period)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()

    def mean(self) -> tuple:
        if not self.rows:
            return (math.nan, math.nan)
        return tuple(sum(r[i] for r in self.rows) / len(self.rows) for i in (0, 1))


class KernelProbe:
    """While the block runs, records the strides of the operands of each
    flash kernel's first call (the trainer's own layouts) and a pair of
    CUDA events around every call (recorded on the stream, read after the
    block: no sync is added)."""

    NAMES = {"flash_fwd": ("q", "k", "v"), "flash_dq": ("q", "k", "v", "do"),
             "flash_dkv": ("q", "k", "v", "do")}

    def __init__(self, torch, fa):
        self.torch, self.fa, self.strides = torch, fa, {}
        self.events = {n: [] for n in self.NAMES}

    def __enter__(self):
        self.real = {n: getattr(self.fa, n) for n in self.NAMES}
        torch = self.torch
        for n, fn in self.real.items():
            def probe(*args, _n=n, _fn=fn, **kw):
                if _n not in self.strides:
                    self.strides[_n] = [list(t.stride()) for t in args[:len(self.NAMES[_n])]]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args, **kw)
                end.record()
                self.events[_n].append((start, end))
                return out
            setattr(self.fa, n, probe)
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.fa, n, fn)

    def call_ms(self, name: str) -> list:
        """ms of each call of ``name``, in order (after a sync)."""
        return [a.elapsed_time(b) for a, b in self.events[name]]


def strided_like(torch, t, stride):
    """A copy of ``t`` laid out with ``stride`` (in a storage just large
    enough), the values the same."""
    size = 1 + sum((n - 1) * st for n, st in zip(t.shape, stride))
    out = torch.empty(size, dtype=t.dtype, device=t.device).as_strided(t.shape, stride)
    out.copy_(t)
    return out


def cold_ms(torch, fn, iters: int) -> float:
    """Median CUDA-event ms of ``fn`` with the 50 MB L2 flushed before each
    launch (256 MB written between launches), as the trainer's kernels find
    it: each reads operands the step's other kernels evicted."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del flush
    return _median([a.elapsed_time(b) for a, b in pairs])


def trace_fidelity(torch, fa, kt, work: Path, strides: dict, card: str) -> dict:
    """What the 18a comparison rests on, at phase 3's shape: each kernel's
    CUDA-event ms on phase 3's contiguous operands and on operands laid out
    as the trainer's (``strides``), warm (phase 3's repeated launches) and
    with the L2 flushed before each launch (``cold_ms``), and the
    profiler's per-launch time of the same launches against CUDA events
    taken around them inside the window, with the SM clock sampled in
    each."""
    from neuronx_distributed_training_torch.telemetry.trace import trace_steps

    q, k, v, do, _, lse, delta = kt.main_path_tensors()
    calls = {"flash_fwd": lambda a: fa.flash_fwd(*a[:3]),
             "flash_dq": lambda a: fa.flash_dq(*a, lse, delta),
             "flash_dkv": lambda a: fa.flash_dkv(*a, lse, delta)}
    base = (q, k, v, do)
    out = {}
    for name, fn in calls.items():
        laid = tuple(strided_like(torch, t, st) for t, st in zip(base, strides.get(name, [])))
        laid = laid + base[len(laid):]
        with torch.no_grad(), ClockSampler() as clk:
            ms_c = kt.cuda_ms(lambda: fn(base))
            ms_l = kt.cuda_ms(lambda: fn(laid))
            ms_cold = cold_ms(torch, lambda: fn(laid), kt.ITERS)
        events = []

        def step(i):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(kt.ITERS):
                fn(laid)
            end.record()
            torch.cuda.synchronize()
            events.append(start.elapsed_time(end) / kt.ITERS)

        with torch.no_grad():
            fn(laid)
            summary = trace_steps(step, 3, work / f"fidelity_{name}", top_k=50, cuda=True)
        row = next((r for r in (summary or {}).get("top_ops", [])
                    if r["op"].endswith(TRACE_KERNELS[name])), None)
        out[name] = {"contiguous_ms": ms_c, "trainer_layout_ms": ms_l, "cold_l2_ms": ms_cold,
                     "events_in_window_ms": sorted(events)[1],
                     "profiler_ms": None if row is None else row["mean_us"] / 1e3,
                     "sm_mhz": clk.mean()[0], "watts": clk.mean()[1]}
        log(f"trace 18a fidelity {name}: contiguous {ms_c:.4f} ms, the trainer's layout "
            f"{strides.get(name)} {ms_l:.4f} ms, with the L2 flushed before each launch "
            f"{ms_cold:.4f} ms (SM {out[name]['sm_mhz']:.0f} MHz, "
            f"{out[name]['watts']:.0f} W); inside a profiler window CUDA events "
            f"{out[name]['events_in_window_ms']:.4f} ms, the profiler "
            f"{out[name]['profiler_ms']} ms [{card}]")
    del q, k, v, do, lse, delta, base
    return out


def window_steps() -> set:
    t, p = TRACE_WINDOW, PROFILE_WINDOW
    return (set(range(t["start_step"], t["start_step"] + t["num_steps"]))
            | set(range(p["start"], p["start"] + p["steps"])))


def phase_trace(torch, fa, kt, cell, times: dict, card: str) -> dict:
    """18a: phase 16a's cell for TRACE_STEPS steps with a
    ``telemetry.trace`` window and a ``profile_start_step`` window, through
    the CLI at ``log_every_n_steps: 1``: exact launches, the trace summary's
    window, steps, op table (each flash kernel counted once a launch of the
    window, its device time per launch against phase 3's), no overlap
    without collectives, the raw trace removed, the profile's trace kept,
    the repository's ``tools/trace_report.py`` rendering the summary, and no
    synchronizing call inside a dispatch outside the two windows."""
    from neuronx_distributed_training_torch.trainer import cli

    t_phase = time.perf_counter()
    exp = cell.WORK / "exp_trace"
    shutil.rmtree(exp, ignore_errors=True)
    t, p = TRACE_WINDOW, PROFILE_WINDOW
    args = cell.CLI_ARGS + [
        "--set", f"trainer.max_steps={TRACE_STEPS}", "--set", "trainer.log_every_n_steps=1",
        "--set", f"exp_manager.exp_dir={exp}",
        "--set", "exp_manager.telemetry.trace={enabled: true, start_step: %d, num_steps: %d}"
        % (t["start_step"], t["num_steps"]),
        "--set", f"exp_manager.profile_start_step={p['start']}",
        "--set", f"exp_manager.profile_num_steps={p['steps']}"]
    fa.reset_counters()
    try:
        with SyncWatch(torch, first=2) as watch, KernelProbe(torch, fa) as probe, \
                ClockSampler() as clk:
            trainer, history = cli.run(args)
        torch.cuda.synchronize()
        launches, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
        call_ms = {k: probe.call_ms(k) for k in TRACE_KERNELS}
        log_dir = trainer.exp.log_dir
        summary_path = log_dir / "trace_summary.json"
        summary = json.loads(summary_path.read_text()) if summary_path.exists() else None
        records = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
        run = json.loads((log_dir / "run_summary.json").read_text())
        raw_left = (log_dir / "trace").exists()
        profiles = sorted(x.name for x in (log_dir / "profile").glob("*.pt.trace.json")) \
            if (log_dir / "profile").exists() else []
        report = subprocess.run([sys.executable, str(REPO / "tools" / "trace_report.py"),
                                 str(log_dir)], capture_output=True, text=True, timeout=120)
        del trainer
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    if summary is None:
        fail("trace 18a: no trace_summary.json after the window")
    if "GPU 0" not in summary.get("devices", []):
        fail(f"trace 18a: the window asked for CUDA activity and the trace holds none: "
             f"devices {summary.get('devices')}")
    expect = cell.LAYERS * cell.MICROBATCHES * TRACE_STEPS
    in_window = cell.LAYERS * cell.MICROBATCHES * t["num_steps"]
    rows = {k: next((r for r in summary["top_ops"] if r["op"].endswith(op)), None)
            for k, op in TRACE_KERNELS.items()}
    step_time = {r["step"] - 1: r["step_time"] for r in records}  # record step n: n steps done
    traced = sorted(int(s) for s in summary["steps"])
    window_wall = sum(step_time[s] for s in traced)
    # the window's first step also pays the profiler's start: the busy share
    # is a step's device seconds over the later traced steps' median wall
    busy = (summary["total_device_seconds"] / len(traced)) / _median(
        [step_time[s] for s in traced[1:]])
    profiled = [s for s in sorted(step_time) if s in window_steps() and s not in traced]
    log(f"trace 18a: step_time of the traced steps {[step_time[s] for s in traced]} s against "
        f"the untraced {[step_time[s] for s in sorted(step_time) if s not in window_steps()]} "
        f"s (the profiled {[step_time[s] for s in profiled]} s) [{card}]")
    log(f"trace 18a: window {summary['window']}: {summary['num_op_events']} device ops on "
        f"{summary['devices']}, device {summary['total_device_seconds']:.4f} s in "
        f"{window_wall:.4f} s of wall (the first step with the profiler's start): busy share "
        f"{busy:.4f} a step; achieved_overlap {summary['achieved_overlap']}; per step "
        f"{json.dumps(summary['steps'])}; SM clock {clk.mean()[0]:.0f} MHz, "
        f"{clk.mean()[1]:.0f} W over the run [{card}]")
    for r in summary["top_ops"][:10]:
        log(f"trace 18a: top op {r['op'][:90]}: {r['count']} launches, "
            f"{r['total_seconds'] * 1e3:.3f} ms, mean {r['mean_us']:.1f} us, share "
            f"{r['share']:.4f} [{card}]")
    per_launch, events_ms = {}, {}
    per_step = cell.LAYERS * cell.MICROBATCHES
    for k, op in TRACE_KERNELS.items():
        row = rows[k]
        if row is None:
            fail(f"trace 18a: {op} is not in the op table: "
                 f"{[r['op'] for r in summary['top_ops']]}")
        per_launch[k] = row["mean_us"] / 1e3
        # CUDA events around the trainer's own launches: the window's, and
        # the last two (untraced) steps', the gate's reference (an event
        # pair also times any wait of the card for the host between its
        # record and the launch, and the profiler slows the host in the
        # window)
        lo = t["start_step"] * per_step
        in_win = call_ms[k][lo:lo + in_window]
        late = call_ms[k][-2 * per_step:]
        win_ms = sum(in_win) / max(len(in_win), 1)
        events_ms[k] = sum(late) / max(len(late), 1)
        log(f"trace 18a: {row['op']}: {row['count']} launches in the window (expected "
            f"{in_window}), {per_launch[k]:.4f} ms a launch by the profiler, {win_ms:.4f} "
            f"ms by CUDA events around the same launches, {events_ms[k]:.4f} ms in "
            f"the last two untraced steps; phase 3's (warm, repeated launches) "
            f"{times[k]['ms']:.4f} ms ({per_launch[k] / times[k]['ms'] - 1:+.3%}); operand "
            f"strides in the trainer {probe.strides.get(k)} [{card}]")
    fidelity = trace_fidelity(torch, fa, kt, cell.WORK, probe.strides, card)
    outside = [s for s in watch.syncs if s[0] not in window_steps()]
    log(f"trace 18a: launches {launches} fallbacks {fallbacks} (expected {expect} each); "
        f"host syncs inside a dispatch outside the windows: {len(outside)} (inside: "
        f"{len(watch.syncs) - len(outside)}); profile window files {profiles}")
    if len(history) != TRACE_STEPS or not all(math.isfinite(r["loss"]) for r in history):
        fail(f"trace 18a: {len(history)} steps or a non-finite loss")
    if any(n != expect for n in launches.values()) or fallbacks["core"]:
        fail(f"trace 18a: launches {launches} (fallbacks {fallbacks}), expected {expect} each")
    if summary["window"] != TRACE_WINDOW or traced != list(range(
            t["start_step"], t["start_step"] + t["num_steps"])):
        fail(f"trace 18a: window {summary['window']}, steps {traced}")
    for s, d in summary["steps"].items():
        if not 0 < d["device_seconds"] <= step_time[int(s)]:
            fail(f"trace 18a: step {s}'s device time {d['device_seconds']} s is not within "
                 f"its wall time {step_time[int(s)]} s")
    if summary["achieved_overlap"] is not None or summary["collective_seconds"]:
        fail(f"trace 18a: collectives on one card: {summary['overlap_by_class']}")
    for k, op in TRACE_KERNELS.items():
        if rows[k]["count"] != in_window:
            fail(f"trace 18a: {op} counted {rows[k]['count']} in the window, expected "
                 f"{in_window}")
        # the profiler's device time a launch against CUDA events around the
        # trainer's untraced launches (phase 3's isolated, warm time reads
        # 12-19% below the backward kernels' in the loop: printed beside)
        if abs(per_launch[k] / events_ms[k] - 1) > TRACE_TIME_RTOL:
            fail(f"trace 18a: {op} takes {per_launch[k]:.4f} ms a launch in the trace, "
                 f"{events_ms[k]:.4f} ms by CUDA events around the untraced steps' launches "
                 f"(phase 3: {times[k]['ms']:.4f} ms; tolerance {TRACE_TIME_RTOL:.0%})")
    if raw_left:
        fail("trace 18a: the raw trace/ directory was left behind (keep_raw is off)")
    if not profiles:
        fail("trace 18a: the profile window wrote no trace under profile/")
    if (run.get("trace") or {}).get("window") != TRACE_WINDOW:
        fail(f"trace 18a: run_summary.json's trace section: {run.get('trace')}")
    if report.returncode != 0 or "device-time trace (steps 2..4)" not in report.stdout:
        fail(f"trace 18a: tools/trace_report.py exited {report.returncode}:\n"
             f"{(report.stdout + report.stderr)[-2000:]}")
    if outside:
        fail(f"trace 18a: host syncs inside a dispatch outside the windows: {outside[:12]}")
    out = {"launches": launches, "per_launch_ms": per_launch, "events_ms": events_ms,
           "busy_share": busy, "fidelity": fidelity,
           "steps": summary["steps"], "step_time": step_time,
           "top_ops": summary["top_ops"][:10], "phase_seconds": time.perf_counter() - t_phase}
    log(f"trace 18a: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


def compute_bubble(pipe) -> str:
    """The pipeline section's idle share with the stage hops counted idle:
    ``1 - compute / (lanes x window)``.  JAX's measured bubble counts a
    collective's time busy; an NCCL ``SendRecv`` kernel runs while it waits
    for its peer, so on the card the wait hides in it."""
    if not pipe:
        return ""
    compute = sum(st["compute_seconds"] for st in pipe["stages"].values())
    share = 1 - compute / (pipe["num_lanes"] * pipe["window_seconds"])
    return f"; idle share with the hops counted idle {share:.6f}"


def multi_trace(cell, nproc: int, name: str, *extra: str) -> dict:
    """Phase 4's cell under torchrun on ``nproc`` cards for MULTI_STEPS
    steps with MULTI_TRACE's window and the state digest."""
    rep = torchrun_cell(cell, nproc, cell.WORK / f"exp_{name}", 900, "--steps",
                        str(MULTI_STEPS), "--digest", "--set",
                        f"exp_manager.telemetry.trace={MULTI_TRACE}", *extra)
    for what, tr in (("window", rep["trace"]), ("steady", rep["trace_steady"])):
        tr = tr or {}
        by = tr.get("overlap_by_class") or {}
        steps = len(tr.get("steps") or {}) * nproc  # the traced steps, on every rank
        log(f"trace 18b {name} ({what}): achieved_overlap {tr.get('achieved_overlap')} "
            f"exposed {tr.get('exposed_collective_seconds')} s of "
            f"{tr.get('collective_seconds')} s; all-reduce {by.get('all-reduce')}; "
            f"all-gather {by.get('all-gather')} "
            f"({(by.get('all-gather') or {}).get('count', 0) / max(steps, 1)} a step a rank); "
            f"collective-permute {by.get('collective-permute')}; device "
            f"{tr.get('total_device_seconds')} s over {steps} rank-steps; pipeline "
            f"{json.dumps({k: (tr.get('pipeline') or {}).get(k) for k in PIPE_KEYS})}"
            f"{compute_bubble(tr.get('pipeline'))}")
    log(f"trace 18b {name}: losses {rep['loss']} grad norms {rep['grad_norm']} steps "
        f"{rep['step_seconds']}")
    tr = rep["trace"] or {}
    if not tr or not any(d.startswith("GPU") for d in tr.get("devices", [])):
        fail(f"trace 18b {name}: no trace summary with device lanes: {tr.get('devices')}")
    if not rep["trace_steady"]:
        fail(f"trace 18b {name}: no steady-state summary (raw traces kept?)")
    return rep


def phase_trace_multi(torch, cell, card: str) -> dict | None:
    """18b (two or more cards): phase 7's torchrun cell at dp 2 (and dp 4)
    per leaf and bucketed with a trace window in both, bit for bit
    (losses, grad norms, every rank's state digest), recording each
    collective class's overlap and exposed seconds, the step time and the
    all-gathers a step; and pp 2 with and without the double buffer, bit
    for bit, with the measured bubble beside the predicted one."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"trace 18b: this machine shows {n_cards} card; the multi-card trace runs need two "
            f"or more and did not run")
        return None
    t_phase = time.perf_counter()
    out = {"runs": {}}
    pairs = [(f"dp{n}", n, (), ("--set", f"distributed_strategy.overlap={{zero1_bucket_mb: "
                                 f"{BUCKET_MB}, prefetch_ag: true}}"))
             for n in (2, 4) if n <= n_cards]
    pairs.append(("pp2", 2, ("--set", "distributed_strategy.pipeline_model_parallel_size=2",
                             "--set", "distributed_strategy.pipeline.schedule=1f1b"),
                  ("--set", "distributed_strategy.overlap={pp_double_buffer: true}")))
    for tag, n, base, change in pairs:
        a = multi_trace(cell, n, f"{tag}_base", *base)
        b = multi_trace(cell, n, f"{tag}_overlap", *base, *change)
        out["runs"][tag] = {"base": a, "overlap": b}
        if (a["loss"], a["grad_norm"]) != (b["loss"], b["grad_norm"]) or \
                [r["state_digest"] for r in a["ranks"]] != [r["state_digest"] for r in b["ranks"]]:
            fail(f"trace 18b {tag}: the overlap run is not the base run bit for bit: "
                 f"{(b['loss'], b['grad_norm'])} vs {(a['loss'], a['grad_norm'])}")
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"trace 18b: phase wall time {out['phase_seconds']:.1f} s [{card}]")
    return out


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

    only = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else None
    if only is not None:
        # a partial run: the named phases (13e and 16 after phase 4,
        # their reference), no result lines
        if "13e" in only or "16" in only or "17" in only:
            try:
                _, history4 = phase_trainer(torch, fa, cell, card)
            finally:
                shutil.rmtree(cell.WORK / "exp_synthetic", ignore_errors=True)
            free_cuda(torch)
            if "13e" in only:
                phase_pp_cp(torch, cell, trainer_ref(history4), card)
            if "16" in only:
                phase_fit(torch, fa, cell, history4, card)
            if "17" in only:
                cadence = phase_cadence(torch, fa, cell, history4, card)
                free_cuda(torch)
                phase_convert_planes(torch, fa, cell, cadence, card)
        if "18b" in only:
            phase_trace_multi(torch, cell, card)
        if "18" in only:
            times = phase_times(torch, fa, kt, card, peaks)
            free_cuda(torch)
            phase_trace(torch, fa, kt, cell, times, card)
            free_cuda(torch)
            phase_trace_multi(torch, cell, card)
        for name, fn in (("13a", lambda: phase_pp_virtual(torch, fa, kt, card, peaks)),
                         ("13b", lambda: phase_pp_chunked_vp(torch, fa, card)),
                         ("13c", lambda: phase_pp_zb(torch, fa, card)),
                         ("13d", lambda: phase_pp_pref(torch, fa, card)),
                         ("14a", lambda: phase_mixtral(torch, fa, kt, card, peaks)),
                         ("14c", lambda: phase_moe_layer(torch, card, peaks)),
                         ("14d", lambda: phase_mixtral_cli(torch, cell, card)),
                         ("15", lambda: phase_gpt(torch, fa, kt, card, peaks)),
                         ("15f", lambda: phase_gpt_tp(torch, cell, card))):
            if name in only or (name[:2] in only and name != "15f") or \
                    (name == "14a" and "14b" in only):
                fn()
                free_cuda(torch)
        log(f"phases {only} passed (a partial run prints no result); script wall time "
            f"{time.perf_counter() - T_START:.1f} s")
        return

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
    free_cuda(torch)
    chunked = phase_chunked(torch, fa, cell, history4, launches, card)
    free_cuda(torch)
    replicated_rows = phase_replicated_kernels(torch, fa, kt, card, peaks)
    pref_cp = phase_pref_cp(torch, cell, card)
    free_cuda(torch)
    pp_loop = phase_pp_loopback(torch, fa, card)
    pp_70b = phase_pp_70b(torch, fa, kt, card, peaks)
    pp_cli = phase_pp_cli(torch, cell, trainer_ref(history4), card)
    free_cuda(torch)
    pp_virtual = phase_pp_virtual(torch, fa, kt, card, peaks)
    pp_chunked_vp = phase_pp_chunked_vp(torch, fa, card)
    pp_zb = phase_pp_zb(torch, fa, card)
    pp_pref = phase_pp_pref(torch, fa, card)
    pp_cp = phase_pp_cp(torch, cell, trainer_ref(history4), card)
    free_cuda(torch)
    mixtral = phase_mixtral(torch, fa, kt, card, peaks)
    moe_layer = phase_moe_layer(torch, card, peaks)
    free_cuda(torch)
    gpt_rep = phase_gpt(torch, fa, kt, card, peaks)
    free_cuda(torch)
    gpt_tp = phase_gpt_tp(torch, cell, card)
    free_cuda(torch)
    fit = phase_fit(torch, fa, cell, history4, card)
    free_cuda(torch)
    conv = phase_convert_planes(torch, fa, cell, fit["cadence"], card)
    free_cuda(torch)
    trace = phase_trace(torch, fa, kt, cell, times, card)
    free_cuda(torch)
    trace_multi = phase_trace_multi(torch, cell, card)

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
                                                     for impl in CP_FUSIONS}}),
                                 "pretrain_chunked_ce": chunked["launches"][kname],
                                 **({} if pref_cp is None else
                                    {"align_dpo_cp2": [r["launches"][kname]
                                                       for r in pref_cp["cp2"]["ranks"]]}),
                                 "pp_loopback": {tag: r["launches"][kname]
                                                 for tag, r in pp_loop["runs"].items()},
                                 "pp_loopback_70b": pp_70b["run"]["launches"][kname],
                                 **({} if pp_cli is None else
                                    {"pretrain_pp2": [r["launches"][kname]
                                                      for r in pp_cli["pp2"]["ranks"]]}),
                                 "pp_virtual": {tag: r["launches"][kname]
                                                for tag, r in pp_virtual["runs"].items()},
                                 "pp_chunked_vp": pp_chunked_vp["run"]["launches"][kname],
                                 "pp_zb": {tag: r["launches"][kname]
                                           for tag, r in pp_zb["runs"].items()},
                                 "pp_pref": {k: pp_pref[k]["launches"][kname]
                                             for k in ("dpo", "kto")},
                                 **({} if pp_cp is None else
                                    {"pretrain_pp2_cp2": [r["launches"][kname] for r in
                                                          pp_cp["pp2_cp2"]["ranks"]]}),
                                 "mixtral_dropless": mixtral["dropless"]["launches"][kname],
                                 "mixtral_dropped": mixtral["dropped"]["launches"][kname],
                                 "gpt_pretrain": gpt_rep["pretrain"]["launches"][kname],
                                 "gpt_vs_llama": gpt_rep["mistral"]["gpt_launches"][kname],
                                 "gpt_dropout": gpt_rep["dropout"]["launches"][kname],
                                 **{f"gpt_mixtral_{k.split('_')[1]}":
                                    gpt_rep["mixtral"][k]["launches"][kname]
                                    for k in GPT_MIX_CONFIGS},
                                 "gpt_pp_70b": gpt_rep["pp_70b"]["run"]["launches"][kname],
                                 **({} if gpt_tp is None else
                                    {"gpt_tp2": [r["launches"][kname]
                                                 for r in gpt_tp["tp2"]["ranks"]]}),
                                 "fit_cadence": fit["cadence"]["launches"][kname],
                                 "convert_warm_start": conv["convert"]["runs"]["warm"][
                                     "launches"][kname],
                                 "convert_in_memory": conv["convert"]["runs"]["memory"][
                                     "launches"][kname],
                                 "fit_planes": conv["planes"]["launches"][kname],
                                 "fit_trace": trace["launches"][kname],
                                 **({} if trace_multi is None else
                                    {f"trace_{tag}_{how}": [r["launches"][kname]
                                                            for r in run[how]["ranks"]]
                                     for tag, run in trace_multi["runs"].items()
                                     for how in ("base", "overlap")})},
            "per_rank_shapes": [{k: v for k, v in r.items() if k != "kernel"}
                                for r in tp_rows + replicated_rows if r["kernel"] == kname],
            "cp_per_rank_shapes": [{k: v for k, v in r.items() if k != "kernel"}
                                   for r in cp_bodies_rep["rows"] if r["kernel"] == kname],
            "pp_70b_shape": [{k: v for k, v in r.items() if k != "kernel"}
                             for r in pp_70b["kernels"] if r["kernel"] == kname],
            "pp_v5p_card_shape": [{k: v for k, v in r.items() if k != "kernel"}
                                  for r in pp_virtual["kernels"] if r["kernel"] == kname],
            "mixtral_shape": [{k: v for k, v in r.items() if k != "kernel"}
                              for r in mixtral["kernels"] if r["kernel"] == kname],
            "gpt_shape": [{k: v for k, v in r.items() if k != "kernel"}
                          for r in gpt_rep["kernels"] if r["kernel"] == kname],
        })
    log(f"moe layer (14c): {json.dumps(moe_layer)}")
    log(f"chip_smoke: every phase passed; script wall time {time.perf_counter() - T_START:.1f} "
        f"s [{card}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
