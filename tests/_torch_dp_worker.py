"""One rank of the port's data-, tensor-, context-, pipeline- and
expert-parallel tests (``tests/test_torch_dp.py``, ``tests/test_torch_tp.py``,
``tests/test_torch_cp.py``, ``tests/test_torch_pipeline.py``,
``tests/test_torch_mixtral.py``).

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_dp_worker.py <spec.json>

Starts the gloo process group through ``utils/launch.py`` (as the CLI does
under torchrun), runs the spec's scenarios in order, each a trainer built
from a config under this group, and writes ``<out>/rank<r>.json`` (and, on
rank 0, ``.pt`` files of the trained state).  Imports torch and the port,
never jax.

A scenario is ``{"name", "cfg", "steps", "weights"?, "data"?, "max_steps"?,
"dump"?, "dump_init"?, "grads"?, "poison"?}``, or ``{"name", "kind": "units"}`` for
the vocab-parallel cross-entropy and embedding against the plain ones,
``{"name", "kind": "cp_units"}`` for the ring, zig-zag ring and Ulysses
attention over the world as one context group against core attention on the
whole sequence, or ``{"name", "kind": "overlap_units", "tps": [...]}`` for
the bucketed ZeRO-1 update (``optim/overlap.py``) against the per-leaf one
at each tp of ``tps`` (dp = world / tp):
- ``weights``: a ``.pt`` dict of dotted param names to start from, global
  leaves in the JAX layout, which each rank cuts to its tensor-parallel
  slices and its experts (the optimizer state is re-initialised from them);
- ``data``: ``{"kind": "sft_mask", "seed": s}`` for :class:`MaskedRows`,
  ``{"kind": "nan_rows", "step": i, "rows": [...]}`` for synthetic rows with
  a NaN ``loss_mask`` in those global rows of step ``i``,
  ``{"kind": "padded", "seed": s}`` for right-padded rows with an
  ``attention_mask`` (:class:`PaddedRows`);
- ``poison``: ``{"step": i, "cp_rank": r}``: at step ``i`` the ranks of
  context coordinate ``r`` alone compute a NaN loss;
- ``max_steps``: stop the fit there (a preempted run; the config's
  ``max_steps`` still sets the schedule);
- ``dump``: write the trained params and the gathered optimizer state, as
  global leaves in the JAX layout (the tp ranks' slices merged);
- ``dump_init``: write the initial params so, before any step;
- ``grads``: write the gradients the first step hands AdamW (after the tp
  and dp all-reduces), merged so, to this path;
- ``poison_grad``: ``{"step": i, "pp_rank": r}``: at step ``i`` the ranks
  of pipeline stage ``r`` alone see a NaN in one of their layer gradients.
- ``val``: ``{"gbs": n, "seed": s}``: a synthetic validation module;
- ``expect_error``: a ``ValueError`` the trainer's build raises is reported
  as ``{"error": text}``;
- ``sigterm``: ``{"step": i, "rank": r}``: world rank ``r`` alone raises
  SIGTERM inside step ``i`` (a preemption notice on one rank).

Each rank also reports its mesh coordinates (``coords``) and a digest of its
local params and moments after the fit (``state_digest``), and a digest of
the rows of each microbatch it computed
(``rows``; of ``chosen_input_ids`` for preference pairs), so a test sees
which ranks compute the same rows, and for KTO batches the desirable rows of
each (``kto_desirable``).  A preference config builds its data module from
its jsonl, and its reference pass runs from the ``weights``; the rows that
pass computed on this rank (``reference_rows``, 0 when a sidecar held them)
and the train module's reference columns (``reference_columns``) are
reported.
"""

from __future__ import annotations

import json
import signal
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neuronx_distributed_training_torch.config.loader import load_config  # noqa: E402
from neuronx_distributed_training_torch.data.loader import (  # noqa: E402
    DataModule,
    SyntheticDataModule,
)
from neuronx_distributed_training_torch.models import llama  # noqa: E402
from neuronx_distributed_training_torch.optim.adamw import (  # noqa: E402
    init_opt_state,
    is_dtensor,
    local,
    opt_state_specs,
)
from neuronx_distributed_training_torch.parallel import sharding  # noqa: E402
from neuronx_distributed_training_torch.trainer import step as step_mod  # noqa: E402
from neuronx_distributed_training_torch.trainer.loop import Trainer  # noqa: E402
from neuronx_distributed_training_torch.utils.launch import (  # noqa: E402
    initialize_distributed,
)


def masked_rows(idx, *, seq: int, vocab: int, seed: int) -> dict:
    """SFT-like rows: random tokens, and a loss mask over a random suffix of
    each row, so rows (and ranks) hold different numbers of loss tokens."""
    ids = np.empty((len(idx), seq), np.int32)
    mask = np.zeros((len(idx), seq), np.float32)
    for r, i in enumerate(idx):
        rng = np.random.default_rng(seed * 1_000_003 + int(i))
        ids[r] = rng.integers(0, vocab, seq)
        mask[r, int(rng.integers(1, seq - 1)):] = 1.0
    return {"input_ids": ids, "labels": ids.copy(), "loss_mask": mask}


class MaskedRows(DataModule):
    def __init__(self, vocab_size: int, seq_len: int, global_batch_size: int, *, seed: int):
        self.vocab_size, self.seq_len, self.seed = vocab_size, seq_len, seed
        super().__init__(1 << 12, global_batch_size)

    def fetch_rows(self, idx):
        return masked_rows(idx, seq=self.seq_len, vocab=self.vocab_size, seed=self.seed)


def padded_rows(idx, *, seq: int, vocab: int, seed: int) -> dict:
    """Right-padded rows: a random count of real tokens (at least seq/4),
    then pad id 0; ``loss_mask`` and ``attention_mask`` mark the real ones."""
    ids = np.zeros((len(idx), seq), np.int32)
    am = np.zeros((len(idx), seq), np.int32)
    for r, i in enumerate(idx):
        rng = np.random.default_rng(seed * 1_000_003 + int(i))
        n = int(rng.integers(seq // 4, seq))
        ids[r, :n] = rng.integers(1, vocab, n)
        am[r, :n] = 1
    return {"input_ids": ids, "labels": ids.copy(), "loss_mask": am.astype(np.float32),
            "attention_mask": am}


PADDED_NAMES = ("input_ids", "labels", "loss_mask", "attention_mask")


class PaddedRows(DataModule):
    def __init__(self, vocab_size: int, seq_len: int, global_batch_size: int, *, seed: int):
        self.vocab_size, self.seq_len, self.seed = vocab_size, seq_len, seed
        super().__init__(1 << 12, global_batch_size, input_names=PADDED_NAMES)

    def fetch_rows(self, idx):
        return padded_rows(idx, seq=self.seq_len, vocab=self.vocab_size, seed=self.seed)


class NanRows(SyntheticDataModule):
    """Synthetic rows; the global batch of step ``step`` gets a NaN
    ``loss_mask`` in ``rows`` (how ``tests/test_health.py`` poisons one)."""

    def __init__(self, *a, step: int, rows: list, **kw):
        super().__init__(*a, **kw)
        self.poison_step, self.poison_rows = step, list(rows)

    def global_batches(self):
        for i, batch in enumerate(super().global_batches()):
            if i == self.poison_step:
                batch["loss_mask"] = batch["loss_mask"].copy()
                batch["loss_mask"][self.poison_rows] = np.nan
            yield batch


def _data(cfg, spec):
    d = spec.get("data")
    if d is None:
        return None
    m, data = cfg["model"], cfg["data"]
    if d["kind"] == "sft_mask":
        return MaskedRows(m["vocab_size"], data["seq_length"], data["global_batch_size"],
                          seed=d["seed"])
    if d["kind"] == "padded":
        return PaddedRows(m["vocab_size"], data["seq_length"], data["global_batch_size"],
                          seed=d["seed"])
    return NanRows(m["vocab_size"], data["seq_length"], data["global_batch_size"],
                   seed=int(cfg.get("seed", 1234)), step=d["step"], rows=d["rows"])


def _tp_local(t, layout, tp, ep=None) -> torch.Tensor:
    """The rank's tensor-parallel slice (and experts) of a state leaf,
    gathered over the data axis (a collective for a DTensor: every rank
    calls it)."""
    if not is_dtensor(t):
        return t.detach().clone()
    full = t.full_tensor()
    if layout.sharded and tp.size > 1:
        full = full.chunk(tp.size, layout.dim)[tp.rank]
    if layout.expert and ep is not None and ep.size > 1:
        full = full.chunk(ep.size, 0)[ep.rank]
    return full.detach().clone()


def _coords(trainer) -> dict:
    """The rank's mesh coordinates (``pp`` only under pipeline parallelism;
    with an expert axis, a MoE model's, ``dp`` is the true data-parallel
    rank and ``data`` and ``ep`` are its parts)."""
    out = {"dp": trainer.dp.rank, "tp": trainer.tp.rank,
           "cp": 0 if trainer.cp is None else trainer.cp.rank}
    if trainer.pp is not None:
        out["pp"] = trainer.pp.rank
    if trainer.ep is not None:
        out.update(data=trainer.ep.data.rank, ep=trainer.ep.rank)
    return out


def merged(trainer, named: dict):
    """The global leaves (JAX layout) of ``named`` (every rank's local
    leaves), on world rank 0 (None on the others): each leaf from the ranks
    of data and context coordinate 0 on the first pipeline stage that holds
    it, their tp slices merged."""
    import torch.distributed as dist

    tp = trainer.tp
    mine = {n: _tp_local(t, trainer.layouts[n.split("/")[-1]], tp, trainer.ep)
            for n, t in named.items()}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, (_coords(trainer), mine))
    if dist.get_rank() != 0:
        return None
    out = {}
    for n in dict.fromkeys(k for _, m in everyone for k in m):
        leaf = n.split("/")[-1]  # another stage's leaf: the layout from its name
        layout = trainer.layouts.get(leaf) or sharding.leaf_layout(
            leaf, trainer.model_cfg, sequence_parallel=tp.sequence_parallel)
        holders = [(c, m[n]) for c, m in everyone if n in m and c.get("data", c["dp"]) == 0
                   and c["cp"] == 0 and (layout.expert or c.get("ep", 0) == 0)]
        stage = min(c.get("pp", 0) for c, _ in holders)
        per_ep = {}
        for c, t in sorted(((c, t) for c, t in holders if c.get("pp", 0) == stage),
                           key=lambda ct: (ct[0].get("ep", 0), ct[0]["tp"])):
            per_ep.setdefault(c.get("ep", 0), []).append(t)
        merged_ep = [sharding.merge_leaf(parts, layout) for _, parts in sorted(per_ep.items())]
        out[n] = merged_ep[0] if len(merged_ep) == 1 else torch.cat(merged_ep, dim=0)
    return out


def _save(obj, path) -> None:
    if obj is not None:
        torch.save(obj, Path(path))


def run_units(rank: int) -> dict:
    """The vocab-parallel cross-entropy and embedding on this rank's vocab
    slice, against the plain functions on the whole vocab: max abs
    differences of the loss, the logits' and the table's gradients and the
    embedding output (all ranks hold the same whole inputs)."""
    import torch.distributed as dist

    from neuronx_distributed_training_torch.ops import cross_entropy as ce
    from neuronx_distributed_training_torch.ops import linear
    from neuronx_distributed_training_torch.parallel.mesh import (
        MeshConfig,
        TensorParallel,
        build_mesh,
    )

    size = dist.get_world_size()
    out = {}
    for sp in (False, True):
        mesh = build_mesh(MeshConfig(tensor_model_parallel_size=size, sequence_parallel=sp),
                          device_type="cpu")
        tp = TensorParallel.from_mesh(mesh, sequence_parallel=sp)
        gen = torch.Generator().manual_seed(3)
        b, s, v, h = 2, 8, 16, 4
        logits = torch.randn(b, s, v, generator=gen, dtype=torch.float64).float()
        labels = torch.randint(0, v, (b, s), generator=gen)
        labels[0, :3] = -100  # ignore_index
        labels[1, 0], labels[1, 1] = 0, v - 1  # in the first and the last shard
        mask = (torch.rand(b, s, generator=gen) > 0.2).float()
        rows = v // size
        whole = logits.clone().requires_grad_(True)
        want = ce.cross_entropy_loss(whole, labels, loss_mask=mask)
        want.backward()
        part = logits[..., tp.rank * rows:(tp.rank + 1) * rows].clone().requires_grad_(True)
        got = ce.cross_entropy_loss(part, labels, loss_mask=mask, tp=tp)
        got.backward()
        table = torch.randn(v, h, generator=gen)
        ids = torch.randint(0, v, (b, s), generator=gen)
        dy = torch.randn(b, s, h, generator=gen)
        t_whole = table.clone().requires_grad_(True)
        e_want = linear.apply_embedding({"embedding": t_whole}, ids)
        (e_want * dy).sum().backward()
        t_part = table[tp.rank * rows:(tp.rank + 1) * rows].clone().requires_grad_(True)
        e_got = linear.apply_embedding({"embedding": t_part}, ids, tp=tp)
        seq = slice(tp.rank * s // size, (tp.rank + 1) * s // size) if sp else slice(None)
        (e_got * dy[:, seq]).sum().backward()
        out["sp" if sp else "no_sp"] = {
            "loss": abs(float(got) - float(want)),
            "dlogits": float((part.grad - whole.grad[..., tp.rank * rows:(tp.rank + 1) * rows])
                             .abs().max()),
            "embedding": float((e_got - e_want[:, seq]).abs().max()),
            "dtable": float((t_part.grad - t_whole.grad[tp.rank * rows:(tp.rank + 1) * rows])
                            .abs().max()),
            "labels_per_shard": [int(((labels >= r * rows) & (labels < (r + 1) * rows)).sum())
                                 for r in range(size)],
        }
    return out


def run_cp_units() -> dict:
    """The context-parallel attention over the world as one context group
    (real point-to-point shifts, all-to-alls and all-gathers), fp32, against
    core attention on the whole sequence: max abs differences of this rank's
    o, dq, dk and dv, and how many chunks took the blockwise route and how
    many calls the core fallback."""
    import torch.distributed as dist

    from neuronx_distributed_training_torch.ops import attention as attn_ops
    from neuronx_distributed_training_torch.ops import flash_attention as fa
    from neuronx_distributed_training_torch.parallel.mesh import (
        ContextParallel,
        MeshConfig,
        build_mesh,
    )
    from neuronx_distributed_training_torch.parallel.ring_attention import zigzag_positions

    n = dist.get_world_size()
    cp = ContextParallel.from_mesh(build_mesh(MeshConfig(context_parallel_size=n),
                                              device_type="cpu"))
    out = {}
    # (name, impl, d, s per rank, window, padded)
    for name, impl, d, sq, window, padded in (
            ("ring_blockwise", "ring", 16, 16, None, True),
            ("ring_flash", "ring", 64, 64, None, True),
            ("ring_flash_window", "ring", 64, 64, 80, False),
            ("zigzag_blockwise", "zigzag_ring", 16, 16, None, False),
            ("zigzag_flash", "zigzag_ring", 64, 128, None, False),
            ("ulysses_core", "ulysses", 16, 16, 24, True),
            ("ulysses_flash", "ulysses", 64, 64, None, True)):
        gen = torch.Generator().manual_seed(sum(map(ord, name)))
        b, s, h, kvh = 2, sq * n, 4, 2
        q, k, v, do = (torch.randn(b, s, x, d, generator=gen) for x in (h, kvh, kvh, h))
        am = None
        if padded:
            am = torch.ones(b, s, dtype=torch.int32)
            am[0, s - s // 3:] = 0
            am[1, s - 5:] = 0
        whole = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ref = attn_ops.attention(*whole, impl="core", sliding_window=window,
                                 attention_mask=am)
        ref.backward(do)
        want = [ref.detach()] + [x.grad for x in whole]
        order = zigzag_positions(s, n) if impl == "zigzag_ring" else torch.arange(s)
        mine = order[cp.rank * sq:(cp.rank + 1) * sq]
        parts = [x.index_select(1, mine).clone().requires_grad_(True) for x in (q, k, v)]
        before = dict(fa.FALLBACKS)
        o = attn_ops.attention(*parts, impl=impl, sliding_window=window,
                               attention_mask=None if am is None else am.index_select(1, mine),
                               cp=cp)
        o.backward(do.index_select(1, mine))
        got = [o.detach()] + [x.grad for x in parts]
        out[name] = {"errs": [float((g - w.index_select(1, mine)).abs().max())
                              for g, w in zip(got, want)],
                     **{k: fa.FALLBACKS[k] - before[k] for k in before}}
    return out


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(local(t).detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run_overlap_units(tps: list) -> dict:
    """At each tp of ``tps`` (the rest of the world is dp) and each
    precision, three copies of the tiny model's state take the same two
    AdamW updates with the health skip (step 1's gradients non-finite):
    per leaf, bucketed with prefetch, bucketed without.  Reports whether
    the bucketed copies' params, moments, master weights and step equal the
    per-leaf copy's bit for bit, the plan's buckets, and the gathers each
    path issued (one a packed bucket against one a leaf)."""
    import torch.distributed as dist

    from neuronx_distributed_training_torch.optim import overlap as ov
    from neuronx_distributed_training_torch.optim.adamw import AdamWConfig, adamw_update
    from neuronx_distributed_training_torch.parallel.mesh import (
        DataParallel,
        MeshConfig,
        TensorParallel,
        build_mesh,
    )
    from neuronx_distributed_training_torch.telemetry.health import grad_group_of
    from neuronx_distributed_training_torch.trainer import loop
    from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

    world = dist.get_world_size()
    mc = llama.LlamaConfig.from_config({"vocab_size": 128, "hidden_size": 64,
                                        "intermediate_size": 128, "num_layers": 2,
                                        "num_attention_heads": 4, "num_key_value_heads": 2})
    out: dict = {}
    for tp_size in tps:
        mesh = build_mesh(MeshConfig(tensor_model_parallel_size=tp_size,
                                     sequence_parallel=tp_size > 1), device_type="cpu")
        dp = DataParallel.from_mesh(mesh)
        tp = TensorParallel.from_mesh(mesh, sequence_parallel=tp_size > 1)
        for precision in ("fp32", "mixed_precision"):
            policy = DtypePolicy.from_precision_config({"type": precision})

            def state():
                params = llama.init_params(mc, policy, generator=torch.Generator().manual_seed(2),
                                           device="cpu", tp_rank=tp.rank, tp_size=tp.size)
                flat = llama.named_params(params)
                layouts = sharding.leaf_layouts(flat, mc, sequence_parallel=tp_size > 1)
                specs = opt_state_specs(flat, dp.size, policy=policy, health=True,
                                        layouts=layouts)
                return flat, layouts, init_opt_state(flat, policy, health=True, specs=specs,
                                                     dp=dp, tp=tp, layouts=layouts)

            plan = None
            runs, gathers = {}, {}
            for how in ("per_leaf", "prefetch", "no_prefetch"):
                flat, layouts, opt_state = state()
                if plan is None:
                    plan = loop._bucket_plan(flat, layouts, dp.size,
                                             ov.OverlapConfig(zero1_bucket_mb=0.0625), tp=tp)
                sharded = {n: layouts[n] for n in flat if layouts[n].sharded}
                count = {"n": 0}
                real = dist.all_gather_into_tensor, dist.all_gather, \
                    getattr(dist, "all_gather_single", None)

                def counted(fn):
                    def call(*a, **kw):
                        count["n"] += 1
                        return fn(*a, **kw)
                    return call

                dist.all_gather = counted(real[1])
                if real[2] is not None:
                    dist.all_gather_single = counted(real[2])
                else:
                    dist.all_gather_into_tensor = counted(real[0])
                try:
                    for step in range(2):
                        gen = torch.Generator().manual_seed(100 + 10 * step + tp.rank)
                        grads = {n: torch.randn(p.shape, generator=gen) for n, p in flat.items()}
                        if step == 1:
                            next(iter(grads.values())).view(-1)[0] = float("nan")
                        adamw_update(flat, grads, opt_state, 1e-2, AdamWConfig(), policy,
                                     grad_group_fn=grad_group_of, skip_nonfinite=True, dp=dp,
                                     tp=tp, tp_sharded=sharded,
                                     bucket_plan=None if how == "per_leaf" else plan,
                                     prefetch_ag=how == "prefetch")
                finally:
                    dist.all_gather = real[1]
                    if real[2] is not None:
                        dist.all_gather_single = real[2]
                    else:
                        dist.all_gather_into_tensor = real[0]
                gathers[how] = count["n"]
                runs[how] = _digest(list(flat.values())
                                    + [t for g in ("mu", "nu", "master")
                                       for t in opt_state.get(g, {}).values()]
                                    + [opt_state["step"]])
            out[f"tp{tp_size}_dp{dp.size}_{precision}"] = {
                "equal": {k: runs[k] == runs["per_leaf"] for k in ("prefetch", "no_prefetch")},
                "buckets": [[b.name, len(b.members), len(b.ag)] for b in plan.buckets],
                "gathers": gathers,
                "packed_buckets": sum(1 for b in plan.buckets if b.ag),
                "zero1_leaves": sum(1 for n, t in opt_state["mu"].items() if is_dtensor(t)),
                "packed_leaves": sum(len(b.ag) for b in plan.buckets)}
    return out


def run(spec: dict, rank: int) -> dict:
    if spec.get("kind") == "units":
        return run_units(rank)
    if spec.get("kind") == "overlap_units":
        return run_overlap_units(spec["tps"])
    if spec.get("kind") == "cp_units":
        return run_cp_units()
    cfg = load_config(spec["cfg"])
    val = spec.get("val")
    if val is not None:
        val = SyntheticDataModule(cfg["model"]["vocab_size"], cfg["data"]["seq_length"],
                                  val["gbs"], seed=val["seed"])
    try:
        trainer = Trainer.from_config(cfg, device="cpu", data_module=_data(cfg, spec),
                                      val_data_module=val)
    except ValueError as e:
        if spec.get("expect_error"):
            return {"error": str(e)}
        raise
    out: dict = {"zero1_shards": {}, "rows": []}
    tp = trainer.tp
    if spec.get("weights"):
        src = torch.load(spec["weights"])
        ep_rank, ep_size = (0, 1) if trainer.ep is None else (trainer.ep.rank, trainer.ep.size)
        with torch.no_grad():
            for n, p in llama.named_params(trainer.params).items():
                p.copy_(sharding.local_leaf(src[n], trainer.layouts[n], tp.rank, tp.size,
                                            ep_rank, ep_size))
        flat = llama.named_params(trainer.params)
        flat = {n: t for n, t in flat.items() if trainer.trainable is None
                or n in trainer.trainable}
        ts = trainer.exp.telemetry.tensorstats
        ts = ts if ts.enabled else None
        plan = trainer.bucket_plan
        buckets = (tuple(b.name for b in plan.buckets if b.ag)
                   if plan is not None and ts is not None and ts.buckets else ())
        specs = opt_state_specs(flat, trainer.dp.size,
                                zero1=bool(cfg.distributed_strategy.get("zero1", True)),
                                policy=trainer.policy, health=trainer.health.enabled,
                                layouts=trainer.layouts, ep=trainer.ep, tensorstats=ts,
                                bucket_groups=buckets)
        trainer.opt_state = init_opt_state(flat, trainer.policy, health=trainer.health.enabled,
                                           specs=specs, dp=trainer.dp, tp=tp,
                                           layouts=trainer.layouts, ep=trainer.ep,
                                           tensorstats=ts, bucket_groups=buckets)
    for n, t in trainer.opt_state["mu"].items():
        out["zero1_shards"][n] = [list(t.shape), list(local(t).shape)]
    if spec.get("command") and rank == 0:
        from neuronx_distributed_training_torch.trainer.control import append_command

        append_command(trainer.exp.log_dir, spec["command"])  # polled at the first boundary
    if spec.get("dump_init"):
        _save(merged(trainer, llama.named_params(trainer.params)), spec["dump_init"])
    if spec.get("max_steps"):
        trainer.max_steps = int(spec["max_steps"])
    microbatches, update = step_mod._microbatches, step_mod.adamw_update
    captured: dict = {}

    sigterm = spec.get("sigterm")

    def record_rows(batch, *a, **kw):
        if sigterm and trainer.step == sigterm["step"] and rank == sigterm["rank"]:
            signal.raise_signal(signal.SIGTERM)
        mbs = microbatches(batch, *a, **kw)
        out["rows"].append([float(mb.get("input_ids", mb.get("chosen_input_ids")).double().sum())
                            for mb, _ in mbs])
        if "kto_labels" in batch:
            out.setdefault("kto_desirable", []).append([float(mb["kto_labels"].sum())
                                                        for mb, _ in mbs])
        return mbs

    poison_grad = spec.get("poison_grad")

    def capture(params, grads, *a, **kw):
        if not captured:
            captured.update({n: g.detach().clone() for n, g in grads.items()})
        if (poison_grad and trainer.step == poison_grad["step"]
                and trainer.pp.rank == poison_grad["pp_rank"]):
            # one stage's own layer gradient only: the others see it only
            # through the norm's sum over the stages
            name = next(n for n in grads if n.startswith("layers."))
            grads[name].view(-1)[0] = float("nan")
        return update(params, grads, *a, **kw)

    call_loss = step_mod._call_loss
    poison = spec.get("poison")

    def poisoned_loss(*a, **kw):
        loss, aux = call_loss(*a, **kw)
        if trainer.step == poison["step"] and trainer.cp.rank == poison["cp_rank"]:
            loss = loss * float("nan")
        return loss, aux

    reference_rows = trainer._reference_rows
    out["reference_rows"] = 0

    def count_reference(batch, m, names):
        out["reference_rows"] += m
        return reference_rows(batch, m, names)

    trainer._reference_rows = count_reference
    step_mod._microbatches, step_mod.adamw_update = record_rows, capture
    if poison:
        step_mod._call_loss = poisoned_loss
    try:
        history = trainer.fit()
    finally:
        step_mod._microbatches, step_mod.adamw_update = microbatches, update
        step_mod._call_loss = call_loss
    if trainer.reference is not None:
        out["reference_columns"] = {k: trainer.data_module.arrays[k].tolist()
                                    for k in trainer.reference.names(trainer.data_module.arrays)}
    if spec.get("grads"):
        _save(merged(trainer, captured), spec["grads"])
    out["history"] = history
    out["log_dir"] = str(trainer.exp.log_dir)
    out["stop_class"] = trainer.stop_class
    out["opt_step"] = trainer.opt_state["step"]
    out["health"] = trainer.opt_state.get("health")
    out["committed"] = trainer.checkpointer.committed_steps if trainer.checkpointer else []
    out["coords"] = _coords(trainer)
    out["schedule"] = trainer.pipeline_schedule
    out["state_digest"] = _digest(list(llama.named_params(trainer.params).values())
                                  + [t for g in ("mu", "nu", "master")
                                     for t in trainer.opt_state.get(g, {}).values()])
    if spec.get("dump"):
        state = {f"params/{n}": p for n, p in llama.named_params(trainer.params).items()}
        for g in ("mu", "nu", "master"):
            state.update({f"{g}/{n}": t for n, t in trainer.opt_state.get(g, {}).items()})
        _save(merged(trainer, state), spec["dump"])
    return out


def main() -> None:
    spec = json.loads(Path(sys.argv[1]).read_text())
    cluster = initialize_distributed(device="cpu")
    rank = cluster.process_id
    results = {}
    try:
        for scenario in spec["scenarios"]:
            results[scenario["name"]] = run(scenario, rank)
    except BaseException:
        results["error"] = traceback.format_exc()
        raise
    finally:
        Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(results, default=float))
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
