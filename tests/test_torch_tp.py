"""Tensor and sequence parallelism in the port, over gloo in CPU processes.

- the pure pieces: the segment cut and merge of the fused leaves (``qkv``,
  ``gate_up`` and their ``lora_b``) at tp 1, 2 and 4 bit for bit,
  ``params_from_jax`` / ``params_to_jax`` round trips, ``zero1_leaf_spec``
  on global shapes with a TP dim against JAX's specs on a ``("data",
  "model")`` mesh, the layouts against JAX's ``param_specs`` and
  ``lora_param_specs``, the health ``grad_norm`` groups, and the rows each
  rank of a dp x tp mesh computes;
- 2 gloo ranks (``tests/_torch_dp_worker.py``) at tp=2 with SP against the
  JAX trainer on 2 of the 8 virtual CPU devices with ``zero1: true``, 3
  steps from the same weights (fp32: loss and grad norm rtol 1e-5;
  ``mixed_precision``: loss 1e-4, grad norm 2e-3; params to
  ``test_torch_step.py``'s bar, merged from the ranks' slices), LoRA SFT at
  tp=2 with SP against JAX with the frozen leaves bit for bit, and 4 ranks
  at dp x tp = 2 x 2 with SP the same way;
- inside the port, fp32: tp=2 against the port at tp=1, the loss within
  rtol 1e-6 and every gradient AdamW receives, merged, within 1e-5
  relative (the norm scales under SP and LoRA's replicated factors too);
  the initial params at tp=2 are the tp=1 run's slices bit for bit;
- the vocab-parallel cross-entropy and embedding against the plain ones at
  tp=2, with labels in both shards and ``ignore_index``, with and without
  SP, for the loss, the output and the gradients;
- checkpoints: a tp=2 save at step 2 resumes to step 3 bit for bit at
  tp=2, restores at tp=1 (one process) with the params bit for bit and
  trains on within the tolerance, a tp=1 save restores at tp=2, a dp x tp
  2 x 2 save restores at tp=2, and a flipped byte in any rank's file
  fails verification;
- the CLI under ``python -m torch.distributed.run --nproc_per_node 2 ...
  --device cpu`` at tp=2 with SP.

Each launch picks a free ``MASTER_PORT`` and waits for each rank with its
own timeout (``tests/test_torch_dp.py::launch``).
"""

import importlib.util
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.checkpoint import integrity as ck_integrity
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.data.loader import dp_rank_rows
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.optim import adamw as t_adamw
from neuronx_distributed_training_torch.optim.adamw import init_opt_state
from neuronx_distributed_training_torch.parallel import sharding
from neuronx_distributed_training_torch.peft import LoraConfig, add_lora
from neuronx_distributed_training_torch.telemetry.health import grad_group_of
from neuronx_distributed_training_torch.tools.convert import params_from_jax, params_to_jax
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.trainer import step as t_step
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.models import llama as j_llama
from neuronx_distributed_training_tpu.optim import adamw as j_adamw
from neuronx_distributed_training_tpu.parallel import mesh as j_mesh
from neuronx_distributed_training_tpu.peft import lora as j_lora
from neuronx_distributed_training_tpu.telemetry import health as j_health

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "examples" / "conf" / "tiny_smoke_config.yaml"
SEQ = 128


def _dp_tests():
    spec = importlib.util.spec_from_file_location(
        "_torch_dp_helpers", Path(__file__).resolve().parent / "test_torch_dp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DPT = _dp_tests()
LR = DPT.LR


def tp_cfg(tmp, exp, *, tp=2, sp=True, precision="fp32", **kw):
    cfg = DPT.dp_cfg(tmp, exp, precision=precision, **kw)
    cfg["distributed_strategy"].update(tensor_model_parallel_size=tp, sequence_parallel=sp)
    cfg["data"]["seq_length"] = SEQ
    cfg["model"]["max_position_embeddings"] = SEQ
    return cfg


def lora_cfg(tmp, data, exp, *, tp=2, sp=True, precision="fp32"):
    cfg = {
        "name": "sft_lora", "model_source": "hf", "seed": 5,
        "model_alignment_strategy": {"sft": {"packing": True}},
        "trainer": {"max_steps": 3, "log_every_n_steps": 1},
        "exp_manager": {"exp_dir": str(tmp / exp), "create_tensorboard_logger": False,
                        "log_files": False, "resume_if_exists": False,
                        "telemetry": {"compile_census": False},
                        "checkpoint_callback_params": {"every_n_train_steps": 0}},
        "distributed_strategy": {"tensor_model_parallel_size": tp, "sequence_parallel": sp},
        "data": {"global_batch_size": 4, "micro_batch_size": 2, "seq_length": 64,
                 "train_dir": str(data), "tokenizer": {"library": "char", "vocab_size": 128}},
        "model": {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
                  "num_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                  "max_position_embeddings": 64,
                  "lora": {"lora_rank": 4, "lora_alpha": 16,
                           "target_modules": ["qkv_proj", "o_proj", "gate_up_proj",
                                              "down_proj"]},
                  "optim": {"name": "adamw_fp32OptState", "lr": 1e-2, "weight_decay": 0.1,
                            "sched": {"name": "CosineAnnealing", "warmup_steps": 0,
                                      "max_steps": 3}}},
        "precision": {"type": precision},
    }
    return cfg


def _sft_jsonl(path, n=120, seed=21):
    rng = np.random.default_rng(seed)

    def text(lo, hi):
        return "".join(chr(int(c)) for c in rng.integers(32, 127, int(rng.integers(lo, hi))))

    path.write_text("\n".join(json.dumps({"input": text(3, 25), "output": text(3, 30)})
                              for _ in range(n)))
    return path


def _model_cfg(cfg) -> t_llama.LlamaConfig:
    return t_llama.LlamaConfig.from_config(cfg["model"])


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------


SMALL = t_llama.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=48, num_layers=1,
                            num_attention_heads=8, num_kv_heads=4)


@pytest.mark.parametrize("name", ["layers.0.attn.qkv.w", "layers.0.mlp.gate_up.w",
                                  "layers.0.attn.qkv.lora_b", "layers.0.mlp.gate_up.lora_b"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_fused_leaves_cut_and_merge_by_segment_bitwise(name, tp):
    lay = sharding.leaf_layout(name, SMALL)
    width = sum(n for _, n in lay.segments)
    rows = 4 if "lora" in name else SMALL.hidden_size
    full = torch.randn(rows, width, generator=torch.Generator().manual_seed(1))
    parts = [sharding.shard_leaf(full, lay, r, tp) for r in range(tp)]
    assert torch.equal(sharding.merge_leaf(parts, lay), full)
    assert all(p.shape == (rows, width // tp) for p in parts)
    # rank r holds the r-th slice of each segment, not of the whole
    start = 0
    for seg, n in lay.segments:
        for r, p in enumerate(parts):
            view = dict(sharding.split_segments(p, lay, tp))[seg]
            assert torch.equal(view, full[:, start + r * n // tp:start + (r + 1) * n // tp])
        start += n
    np_parts = [sharding.shard_leaf(full.numpy(), lay, r, tp) for r in range(tp)]
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(np_parts, parts))
    assert np.array_equal(sharding.merge_leaf(np_parts, lay), full.numpy())


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_convert_round_trip_bitwise_at_tp(tp):
    cfg = SMALL
    params = t_llama.init_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    params = add_lora(params, LoraConfig(rank=4), torch.Generator().manual_seed(3))
    for lp in params["layers"]:
        for mod in ("qkv", "o"):
            lp["attn"][mod]["lora_b"].normal_(generator=torch.Generator().manual_seed(4))
    tree = params_to_jax(params)
    ranks = [params_from_jax(tree, device="cpu", cfg=cfg, tp_rank=r, tp_size=tp)
             for r in range(tp)]
    back = params_to_jax(ranks, cfg=cfg)
    flat_a = t_llama.named_params(params_from_jax(tree, device="cpu"))
    flat_b = t_llama.named_params(params_from_jax(back, device="cpu"))
    assert flat_a.keys() == flat_b.keys()
    assert all(torch.equal(flat_a[n], flat_b[n]) for n in flat_a)
    if tp > 1:
        local = t_llama.named_params(ranks[1])
        assert local["layers.0.attn.qkv.w"].shape == (32, (8 + 2 * 4) * 4 // tp)
        assert local["layers.0.attn.o.lora_a"].shape == (32 // tp, 4)
        assert local["layers.0.attn.o.lora_b"].shape == (4, 32)


def test_layouts_follow_jax_param_and_lora_specs():
    from jax.sharding import PartitionSpec as P

    cfg = SMALL
    jcfg = j_llama.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                               num_layers=1, num_attention_heads=8, num_kv_heads=4)
    specs = j_lora.lora_param_specs(j_llama.param_specs(jcfg),
                                    j_lora.LoraConfig(target_modules=("qkv", "o", "gate_up",
                                                                      "down")))
    flat = {}

    def visit(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                visit(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = v

    visit(specs, "")
    checked = 0
    for jname, spec in flat.items():
        name = jname.replace("layers.", "layers.0.")
        entries = tuple(spec)[1:] if jname.startswith("layers.") else tuple(spec)
        model = [i for i, e in enumerate(entries) if e == "model"]
        lay = sharding.leaf_layout(name, cfg, sequence_parallel=True)
        assert lay.dim == (model[0] if model else None), (name, spec)
        assert lay.partial == (lay.dim is None and (name.endswith(("scale", "lora_a", "lora_b"))
                                                     and "lora_scale" not in name)), name
        checked += 1
    assert checked >= 12 and isinstance(flat["embed.embedding"], P)
    assert not sharding.leaf_layout("final_norm.scale", cfg).partial  # no SP: whole grads


@pytest.mark.parametrize("shape,tp_dim", [((128, 64), 1), ((128, 64), 0), ((64, 96), 1),
                                          ((96, 64), 0), ((64,), None), ((6, 4, 8), 2),
                                          ((2, 64), 1)])
@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 2), (2, 4)])
def test_zero1_leaf_spec_with_a_tp_dim_matches_jax(shape, tp_dim, dp, tp, devices8):
    from jax.sharding import PartitionSpec as P

    mesh = j_mesh.build_mesh(j_mesh.MeshConfig(tensor_model_parallel_size=tp),
                             devices=devices8[:dp * tp])
    pspec = P(*["model" if i == tp_dim else None for i in range(len(shape))])
    jspec = j_adamw.zero1_leaf_spec(pspec, shape, mesh)
    jdim = next((i for i, e in enumerate(jspec) if e not in (None, "model")), None)
    assert t_adamw.zero1_leaf_spec(shape, dp, tp_dim) == jdim


@pytest.mark.parametrize("name", ["layers.3.attn.qkv.w", "layers.0.mlp.down.lora_a",
                                  "embed.embedding", "final_norm.scale", "lm_head.w",
                                  "layers.1.input_norm.scale"])
def test_grad_groups_match_jax(name):
    path = tuple(jax.tree_util.DictKey(p) for p in name.split(".") if not p.isdigit())
    assert grad_group_of(name) == j_health.grad_group_of(path)


def test_tp_norm_counts_replicated_leaves_once():
    """``grouped_sq_norms`` on two ranks' slices, with a stand-in all-reduce:
    the sharded leaves' squares summed over ranks, the replicated leaf
    once."""
    full = {"a.w": torch.arange(8.0).reshape(2, 4), "b.scale": torch.ones(3)}

    class FakeTP:
        size = 2

        def __init__(self, other):
            self.other = other

        def all_reduce_(self, t):
            return t.add_(self.other)

    slices = [{"a.w": full["a.w"][:, :2], "b.scale": full["b.scale"]},
              {"a.w": full["a.w"][:, 2:], "b.scale": full["b.scale"]}]
    sq = [t_adamw.grouped_sq_norms(s, grad_group_of, FakeTP(torch.zeros(2)), {"a.w"})
          for s in slices]
    other = torch.stack([sq[1]["a"], torch.zeros(())])  # rank 1's sharded sums
    got = t_adamw.grouped_sq_norms(slices[0], grad_group_of, FakeTP(other), {"a.w"})
    assert float(got["a"]) == float((full["a.w"] ** 2).sum())
    assert float(got["b"]) == 3.0


@pytest.mark.parametrize("tp_size", [None, 1])
def test_norm_without_tp_is_the_sequential_sum(tp_size):
    """Without an active tp group the sharded names change nothing: the
    norm is the in-order sum of every leaf's squares, bit for bit, as one
    rank computed it before tensor parallelism."""
    rng = np.random.default_rng(7)
    leaves = {n: torch.tensor(rng.standard_normal(s).astype(np.float32))
              for n, s in [("embed.embedding", (5, 3)), ("a.scale", (3,)),
                           ("lm_head.w", (3, 5)), ("b.scale", (3,))]}
    tp = None if tp_size is None else types.SimpleNamespace(size=tp_size)
    total = None
    for t in leaves.values():
        s = torch.sum(torch.square(t))
        total = s if total is None else total + s
    got = t_adamw.global_norm(leaves, tp, {"embed.embedding", "lm_head.w"})
    assert torch.equal(got, torch.sqrt(total))
    assert torch.equal(t_adamw.global_norm(list(leaves.values())), torch.sqrt(total))


@pytest.mark.parametrize("gbs,nm,dp,tp", [(8, 2, 2, 2), (8, 4, 1, 2), (16, 2, 2, 4)])
def test_tp_ranks_of_a_dp_group_get_the_same_rows(gbs, nm, dp, tp):
    """The rows follow the data coordinate of the mesh (world rank // tp,
    ``model`` innermost), so the tp ranks of one dp group compute the same
    rows; the world rank would give them different ones."""
    by_world = [dp_rank_rows(gbs, nm, w // tp, dp).tolist() for w in range(dp * tp)]
    for d in range(dp):
        group = by_world[d * tp:(d + 1) * tp]
        assert all(g == group[0] for g in group)
    assert sorted(sum(by_world[::tp], [])) == list(range(gbs))


def test_tp_above_kv_heads_and_uneven_vocab_are_rejected():
    """Once rejected (ROADMAP entries 2a and 2b), tp above the kv heads and a
    vocab tp does not divide now pass ``check_supported``; kv heads and a tp
    that do not divide one another, heads tp does not divide, and an SP
    sequence tp does not divide are still refused with JAX's texts."""
    cfg = t_loader.load_config(TINY, {"distributed_strategy.tensor_model_parallel_size": 4,
                                      "distributed_strategy.sequence_parallel": True})
    t_loop.check_supported(cfg)
    cfg = t_loader.load_config(TINY, {"distributed_strategy.tensor_model_parallel_size": 2,
                                      "model.vocab_size": 511})
    t_loop.check_supported(cfg)
    cfg = t_loader.load_config(TINY, {"distributed_strategy.tensor_model_parallel_size": 4,
                                      "model.num_attention_heads": 12,
                                      "model.num_key_value_heads": 3})
    with pytest.raises(ValueError, match="kv_heads 3 and tp 4 must divide one another"):
        t_loop.check_supported(cfg)
    cfg = t_loader.load_config(TINY, {"distributed_strategy.tensor_model_parallel_size": 8})
    with pytest.raises(ValueError, match="num_heads 4 must be divisible by tp 8"):
        t_loop.check_supported(cfg)
    cfg = t_loader.load_config(TINY, {"distributed_strategy.tensor_model_parallel_size": 2,
                                      "distributed_strategy.sequence_parallel": True,
                                      "data.seq_length": 127})
    with pytest.raises(ValueError, match="seq_length"):
        t_loop.check_supported(cfg)
    cfg = t_loader.load_config(TINY, {"distributed_strategy.tensor_model_parallel_size": 2})
    t_loop.check_supported(cfg)
    with pytest.raises(ValueError, match="torchrun"):
        t_loop.Trainer.from_config(cfg, device="cpu")


# ---------------------------------------------------------------------------
# gloo launches: tp=2 (2 ranks) and dp x tp = 2 x 2 (4 ranks) against JAX
# ---------------------------------------------------------------------------


def _jax_start(cfg, n, data=None) -> tuple:
    """The JAX trainer of ``cfg`` on ``n`` virtual devices, built but not
    fitted, and its initial params (a fixture starts its launch from them,
    then fits the JAX trainers while the ranks run)."""
    from neuronx_distributed_training_tpu.trainer.loop import Trainer as JTrainer

    jt = JTrainer.from_config(j_loader.load_config(cfg), devices=jax.devices()[:n],
                              enable_checkpointing=False, data_module=data)
    return jt, jax.tree_util.tree_map(np.asarray, jt.params)


def _jax_finish(jt) -> tuple:
    """Fit a :func:`_jax_start` trainer: ``(final params, metric lines)``."""
    jt.fit()
    lines = [json.loads(x) for x in (jt.exp.log_dir / "metrics.jsonl").read_text().splitlines()]
    return jax.tree_util.tree_map(np.asarray, jt.params), [x for x in lines if "loss" in x]


def _jax_run(cfg, n, data=None):
    jt, j0 = _jax_start(cfg, n, data)
    return (j0, *_jax_finish(jt))


def _global_weights(jparams, path: Path) -> Path:
    flat = t_llama.named_params(params_from_jax(jparams, device="cpu"))
    torch.save({n: t.detach().clone() for n, t in flat.items()}, path)
    return path


PARITY2 = ("fp32", "mixed_precision", "lora", "no_sp")
PARITY4 = ("fp32", "mixed_precision")


def _tp4_build(tmp: Path) -> dict:
    jts, scenarios = {}, []
    for case in PARITY4:
        jts[case], j0 = _jax_start(tp_cfg(tmp, f"jax_{case}", precision=case), 4)
        scenarios.append({"name": case, "cfg": tp_cfg(tmp, f"port_{case}", precision=case),
                          "steps": 3, "dump": str(tmp / f"{case}.pt"),
                          "weights": str(_global_weights(j0, tmp / f"{case}_w.pt"))})
    scenarios.append({"name": "save", "cfg": tp_cfg(tmp, "ck", every=2), "steps": 3,
                      "max_steps": 2, "dump": str(tmp / "ck2.pt")})
    run = DPT.Launch(tmp, scenarios, nproc=4)
    jax_side = {case: _jax_finish(jt) for case, jt in jts.items()}
    ranks = run.results()
    out = {case: (*jax_side[case], [r[case] for r in ranks], torch.load(tmp / f"{case}.pt"))
           for case in PARITY4}
    out["ck"] = (tmp / "ck", torch.load(tmp / "ck2.pt"), [r["save"] for r in ranks])
    return out


@pytest.fixture(scope="module")
def tp4_runs(tmp_path_factory):
    """dp x tp = 2 x 2 with SP on 4 ranks, once a run: the JAX parity cases
    (fitted while the ranks run), and a save at step 2 for the tp=2 launch
    to restore.  ``{case: (jax final params, jax lines, rank results, port
    dump)}`` and ``"ck"``: the exp dir."""
    return DPT.shared(tmp_path_factory, "tp4", _tp4_build)


@pytest.fixture(scope="module")
def tp2_runs(tmp_path_factory, tp4_runs):
    """tp=2 on 2 ranks, with SP but for ``no_sp`` (fp32 without SP, the
    copy/reduce regions), once a run: the JAX parity cases, the internal
    runs (gradients and initial params, fp32), the units, and the
    checkpoint scenarios.  Returns a dict of everything the tests read."""
    return DPT.shared(tmp_path_factory, "tp2", lambda tmp: _tp2_build(tmp, tp4_runs))


def _tp2_build(tmp: Path, tp4_runs: dict) -> dict:
    jts, scenarios = {}, []
    data = _sft_jsonl(tmp / "train.jsonl")
    for case in PARITY2:
        if case == "lora":
            cfg, port = lora_cfg(tmp, data, "jax_lora"), lora_cfg(tmp, data, "port_lora")
        elif case == "no_sp":
            cfg, port = tp_cfg(tmp, "jax_no_sp", sp=False), tp_cfg(tmp, "port_no_sp", sp=False)
        else:
            cfg = tp_cfg(tmp, f"jax_{case}", precision=case)
            port = tp_cfg(tmp, f"port_{case}", precision=case)
        jts[case], j0 = _jax_start(cfg, 2)
        jts[case] = (j0, jts[case])
        scenarios.append({"name": case, "cfg": port, "steps": 3, "dump": str(tmp / f"{case}.pt"),
                          "weights": str(_global_weights(j0, tmp / f"{case}_w.pt"))})
    # LoRA weights with non-zero B, so that the column layers' replicated A
    # gets a gradient at step 0
    lw = torch.load(tmp / "lora_w.pt")
    gen = torch.Generator().manual_seed(8)
    for n in lw:
        if n.endswith("lora_b"):
            lw[n] = 0.02 * torch.randn(lw[n].shape, generator=gen)
    torch.save(lw, tmp / "lora_wb.pt")
    # a tp=1 checkpoint at step 2 (one process), for tp=2 to restore
    solo = t_loop.Trainer.from_config(
        t_loader.load_config(tp_cfg(tmp, "solo", tp=1, sp=False, every=2)), device="cpu")
    solo.max_steps = 2
    solo.fit()
    shutil.copytree(tmp / "solo", tmp / "solo_copy")
    # the 2 x 2 save at step 2, restored at tp=2
    ck4 = tp4_runs["ck"][0]
    shutil.copytree(ck4, tmp / "from4")
    scenarios += [
        {"name": "units", "kind": "units"},
        {"name": "grads", "cfg": tp_cfg(tmp, "grads"), "steps": 1, "max_steps": 1,
         "grads": str(tmp / "grads.pt"), "dump_init": str(tmp / "init.pt")},
        {"name": "grads_no_sp", "cfg": tp_cfg(tmp, "grads_no_sp", sp=False), "steps": 1,
         "max_steps": 1, "grads": str(tmp / "grads_no_sp.pt")},
        {"name": "lora_grads", "cfg": lora_cfg(tmp, data, "lora_grads"), "steps": 1,
         "max_steps": 1, "grads": str(tmp / "lora_grads.pt"),
         "weights": str(tmp / "lora_wb.pt")},
        {"name": "straight", "cfg": tp_cfg(tmp, "a", every=2), "steps": 3,
         "dump": str(tmp / "straight.pt")},
        {"name": "pre", "cfg": tp_cfg(tmp, "b", every=2), "steps": 3, "max_steps": 2,
         "dump": str(tmp / "pre.pt")},
        {"name": "resume", "cfg": tp_cfg(tmp, "b", every=2), "steps": 3,
         "dump": str(tmp / "resume.pt")},
        {"name": "from_tp1", "cfg": tp_cfg(tmp, "solo", every=2), "steps": 3},
        {"name": "from_2x2", "cfg": tp_cfg(tmp, "from4", every=2), "steps": 3,
         "dump": str(tmp / "from4_3.pt")},
    ]
    run = DPT.Launch(tmp, scenarios, nproc=2)
    jax_side = {case: (j0, *_jax_finish(jt)) for case, (j0, jt) in jts.items()}
    ranks = run.results()
    return {"tmp": tmp, "jax": jax_side, "ranks": ranks, "data": data,
            "dump": {case: torch.load(tmp / f"{case}.pt") for case in PARITY2}}


def _assert_matches_jax(lines, hist, dump, jparams, precision):
    fp32 = precision == "fp32"
    np.testing.assert_allclose([h["loss"] for h in hist], [x["loss"] for x in lines],
                               rtol=1e-5 if fp32 else 1e-4, atol=0)
    np.testing.assert_allclose([h["grad_norm"] for h in hist], [x["grad_norm"] for x in lines],
                               rtol=1e-5 if fp32 else 2e-3, atol=0)
    # the health groups' norms (sharded leaves summed over tp, replicated
    # ones counted once) and the param norm, as JAX logs them
    keys = {k for k in lines[0] if k.startswith("health/grad_norm/")} | {"health/param_norm"}
    assert len(keys) == 8 and keys <= set(hist[0]), sorted(keys - set(hist[0]))
    for k in sorted(keys):
        np.testing.assert_allclose([h[k] for h in hist], [x[k] for x in lines],
                                   rtol=1e-5 if fp32 else 2e-3, atol=0, err_msg=k)
    DPT._assert_params_bar(dump, jparams, fp32=fp32)


@pytest.mark.parametrize("case", PARITY2)
def test_tp2_sp_matches_jax(tp2_runs, case):
    j0, j1, lines = tp2_runs["jax"][case]
    ranks = [r[case] for r in tp2_runs["ranks"]]
    h0, h1 = (r["history"] for r in ranks)
    assert [(a["loss"], a["grad_norm"]) for a in h0] == [(b["loss"], b["grad_norm"]) for b in h1]
    dump = tp2_runs["dump"][case]
    if case == "lora":
        lr = 1e-2
        np.testing.assert_allclose([h["loss"] for h in h0], [x["loss"] for x in lines],
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose([h["grad_norm"] for h in h0],
                                   [x["grad_norm"] for x in lines], rtol=1e-5, atol=0)
        start = t_llama.named_params(params_from_jax(j0, device="cpu"))
        final = t_llama.named_params(params_from_jax(j1, device="cpu"))
        for n, t in start.items():
            got = dump[f"params/{n}"]
            if n.endswith(("lora_a", "lora_b")):
                assert float((got - final[n]).abs().max()) <= 2 * lr * 3, n
                assert not torch.equal(got, t), n
            else:
                assert torch.equal(got, t), n  # the frozen base, bit for bit
        assert h0[0]["loss"] != h0[-1]["loss"]
    else:
        _assert_matches_jax(lines, h0, dump, j1, "fp32" if case == "no_sp" else case)
    # every rank of the tp group computed the same rows
    assert ranks[0]["rows"] == ranks[1]["rows"]


@pytest.mark.parametrize("case", PARITY4)
def test_dp2_tp2_sp_zero1_matches_jax(tp4_runs, case):
    jparams, lines, ranks, dump = tp4_runs[case]
    hist = [r["history"] for r in ranks]
    assert all([(h["loss"], h["grad_norm"]) for h in x] ==
               [(h["loss"], h["grad_norm"]) for h in hist[0]] for x in hist)
    _assert_matches_jax(lines, hist[0], dump, jparams, case)
    # rows follow the data coordinate: world ranks 0, 1 (dp 0) and 2, 3 (dp 1)
    rows = [r["rows"] for r in ranks]
    assert rows[0] == rows[1] and rows[2] == rows[3] and rows[0] != rows[2]
    # the ZeRO-1 shards are half the rank's tp slice on a dim tp does not shard
    for n, (full, part) in ranks[0]["zero1_shards"].items():
        assert part != full, n


@pytest.mark.parametrize("case", PARITY4)
def test_zero1_bytes_tool_counts_the_2x2_ranks_state(tp4_runs, case):
    """``tools/zero1_bytes.py`` at dp 2, tp 2 on the tiny model's shapes:
    the bytes of ``mu`` and ``nu`` (and ``master`` under mixed precision)
    that each rank of the 2 x 2 run held."""
    from neuronx_distributed_training_torch.tools import zero1_bytes as zb
    from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

    policy = DtypePolicy.from_precision_config(case)
    cfg = _model_cfg(tp_cfg(Path("/unused"), "x", precision=case))
    want = zb.state_bytes_per_rank(zb.param_shapes(cfg), 2, policy, tp=2, cfg=cfg)
    copies = 2 + (policy.param_dtype != policy.optimizer_dtype)
    for r in tp4_runs[case][2]:
        held = sum(int(np.prod(part)) for _, part in r["zero1_shards"].values())
        assert held * 4 * copies == want["bytes"], (held, want)


def _single(cfg, weights=None):
    """The port at tp=1 in this process, from ``weights`` (global leaves)."""
    t = t_loop.Trainer.from_config(t_loader.load_config(cfg), device="cpu",
                                   enable_checkpointing=False)
    if weights is not None:
        with torch.no_grad():
            for n, p in t_llama.named_params(t.params).items():
                p.copy_(weights[n])
        flat = t_llama.named_params(t.params)
        t.opt_state = init_opt_state({n: flat[n] for n in flat if t.trainable is None
                                      or n in t.trainable}, t.policy, health=t.health.enabled)
    return t


def _first_grads(trainer) -> tuple[dict, float]:
    captured = {}
    update = t_step.adamw_update

    def capture(params, grads, *a, **kw):
        if not captured:
            captured.update({n: g.detach().clone() for n, g in grads.items()})
        return update(params, grads, *a, **kw)

    t_step.adamw_update = capture
    try:
        trainer.max_steps = 1
        hist = trainer.fit()
    finally:
        t_step.adamw_update = update
    return captured, hist[0]["loss"]


@pytest.mark.parametrize("case", ["dense", "lora", "dense_no_sp"])
def test_tp2_gradients_equal_tp1(tp2_runs, case):
    """Every gradient AdamW receives at tp=2 with SP (after the tp and dp
    all-reduces), merged from the two ranks, equals the port's at tp=1
    within 1e-5 relative, and the loss within rtol 1e-6: the three norm
    scales under SP, and LoRA's replicated ``lora_a`` on column layers and
    ``lora_b`` on row layers, whose tp=2 gradients are partial sums.
    The LoRA weights carry a non-zero B, so the column layers' A has a
    gradient at step 0.  Without the train step's all-reduce of the partial
    gradients (``trainer/step.py::_flat_sum_``) this test fails:
    with that call removed, on a copy of the tree, the five norm scales'
    gradients were 16-78% off and the eight replicated LoRA factors' 61-86%,
    every other leaf within 5e-7.  ``dense_no_sp`` is tp=2 without SP,
    through the copy/reduce regions, where the norm scales' gradients are
    whole on each rank; with the all-reduce in ``_CopyToTP``'s backward
    removed, on a copy of the tree, it failed with the embedding's gradient
    73% off (and ``no_sp``'s two ranks logged different grad norms)."""
    tmp = tp2_runs["tmp"]
    r0 = tp2_runs["ranks"][0]
    if case != "lora":
        cfg = tp_cfg(tmp, f"{case}_one", tp=1, sp=False)
        one = _single(cfg)
        run = "grads" if case == "dense" else "grads_no_sp"
        got, hist = torch.load(tmp / f"{run}.pt"), r0[run]["history"]
    else:
        cfg = lora_cfg(tmp, tp2_runs["data"], "lora_one", tp=1, sp=False)
        one = _single(cfg, torch.load(tmp / "lora_wb.pt"))
        got, hist = torch.load(tmp / "lora_grads.pt"), r0["lora_grads"]["history"]
    want, loss = _first_grads(one)
    assert np.isclose(hist[0]["loss"], loss, rtol=1e-6, atol=0)
    assert got.keys() == want.keys()
    norms = [n for n in got if n.endswith("norm.scale")]
    assert (len(norms) == 5) if case != "lora" else not norms
    if case == "lora":
        assert {n.rsplit(".", 2)[-2] for n in got} == {"qkv", "o", "gate_up", "down"}
    for n in got:
        rel = float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30))
        assert rel <= 1e-5, (n, rel)


def test_tp2_initial_params_are_tp1_slices(tp2_runs):
    tmp = tp2_runs["tmp"]
    init = torch.load(tmp / "init.pt")
    cfg = t_loader.load_config(tp_cfg(tmp, "init_one", tp=1, sp=False))
    one = t_llama.named_params(t_llama.init_params(
        _model_cfg(cfg), t_loop.DtypePolicy.from_precision_config("fp32"),
        generator=torch.Generator().manual_seed(int(cfg.seed)), device="cpu"))
    assert init.keys() == one.keys()
    assert all(torch.equal(init[n], one[n]) for n in one), [n for n in one
                                                           if not torch.equal(init[n], one[n])]


@pytest.mark.parametrize("sp", ["no_sp", "sp"])
@pytest.mark.parametrize("what", ["loss", "dlogits", "embedding", "dtable"])
def test_vocab_parallel_ce_and_embedding_match_plain(tp2_runs, sp, what):
    for r in tp2_runs["ranks"]:
        u = r["units"][sp]
        assert all(n > 0 for n in u["labels_per_shard"])
        assert u[what] <= (1e-6 if what in ("loss", "dlogits") else 0.0), (what, u)


def test_tp2_checkpoints_resume_bitwise_and_reshard(tp2_runs, tp4_runs):
    tmp, r0 = tp2_runs["tmp"], tp2_runs["ranks"][0]
    assert r0["straight"]["committed"] == [2, 3] and r0["pre"]["committed"] == [2]
    assert [h["step"] for h in r0["resume"]["history"]] == [2]
    assert (r0["resume"]["history"][0]["loss"], r0["resume"]["history"][0]["grad_norm"]) == \
        (r0["straight"]["history"][2]["loss"], r0["straight"]["history"][2]["grad_norm"])
    a, b = torch.load(tmp / "straight.pt"), torch.load(tmp / "resume.pt")
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]
    # the saved leaves are JAX's global ones, fused leaves by segment
    ck_b = tmp / "b" / "dp" / "version_0" / "checkpoints"
    side = json.loads((ck_b / "2" / "integrity.json").read_text())
    tree = side["tree"]["params"]
    assert tree["layers.0.attn.qkv.w:q"]["shape"] == [64, 64]
    assert tree["layers.0.attn.qkv.w:k"]["shape"] == [64, 32]
    assert tree["layers.0.mlp.gate_up.w:up"]["shape"] == [64, 128]
    assert tree["embed.embedding"]["shape"] == [128, 64]
    assert "layers.0.attn.qkv.w" not in tree and side["shards"]["params"]
    # the tp=2 step-2 checkpoint restores at tp=1 (one process) exactly, and
    # step 3 there follows tp=2's within the tolerance
    dst = tmp / "c" / "dp" / "version_0" / "checkpoints"
    shutil.copytree(ck_b / "2", dst / "2")
    c = t_loop.Trainer.from_config(t_loader.load_config(tp_cfg(tmp, "c", tp=1, sp=False)),
                                   device="cpu")
    assert c.maybe_resume() and c.step == 2
    pre = torch.load(tmp / "pre.pt")
    live = {f"params/{n}": t for n, t in t_llama.named_params(c.params).items()}
    live.update({f"{g}/{n}": t for g in ("mu", "nu") for n, t in c.opt_state[g].items()})
    assert all(torch.equal(pre[k], live[k]) for k in live), [k for k in live
                                                            if not torch.equal(pre[k], live[k])]
    h3 = c.fit()
    assert np.isclose(h3[0]["loss"], r0["straight"]["history"][2]["loss"], rtol=1e-6, atol=0)
    # the tp=1 checkpoint resumed at tp=2; the same continuation at tp=1
    assert [h["step"] for h in r0["from_tp1"]["history"]] == [2]
    cont = t_loop.Trainer.from_config(
        t_loader.load_config(tp_cfg(tmp, "solo_copy", tp=1, sp=False)), device="cpu").fit()
    assert np.isclose(r0["from_tp1"]["history"][0]["loss"], cont[0]["loss"], rtol=1e-6, atol=0)
    # the dp x tp = 2 x 2 save at step 2 restores at tp=1 exactly, and at
    # tp=2 (dp 1) it trains step 3 as tp=1 does from it
    ck4, ck2, saves = tp4_runs["ck"]
    assert saves[0]["committed"] == [2]
    shutil.copytree(ck4, tmp / "c4")
    c4 = t_loop.Trainer.from_config(t_loader.load_config(tp_cfg(tmp, "c4", tp=1, sp=False)),
                                    device="cpu")
    assert c4.maybe_resume() and c4.step == 2
    live = {f"params/{n}": t for n, t in t_llama.named_params(c4.params).items()}
    live.update({f"{g}/{n}": t for g in ("mu", "nu") for n, t in c4.opt_state[g].items()})
    assert all(torch.equal(ck2[k], live[k]) for k in live)
    h3 = c4.fit()
    assert [h["step"] for h in r0["from_2x2"]["history"]] == [2]
    assert np.isclose(r0["from_2x2"]["history"][0]["loss"], h3[0]["loss"], rtol=1e-6, atol=0)
    # a flipped byte in any rank's file fails verification
    ck_a = tmp / "a" / "dp" / "version_0" / "checkpoints" / "3"
    files = sorted((ck_a / "params").glob("*.distcp")) + sorted(
        (ck_a / "opt_state").glob("*.distcp"))
    assert len(files) == 4
    for f in files:
        bad = tmp / f"bad_{f.parent.name}_{f.stem}"
        shutil.copytree(ck_a, bad / "3")
        assert ck_integrity.verify_step(bad, 3).status == "ok"
        g = bad / "3" / f.parent.name / f.name
        raw = bytearray(g.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        g.write_bytes(bytes(raw))
        v = ck_integrity.verify_step(bad, 3)
        assert v.status == "corrupt" and any(f.parent.name in x for x in v.failures), v.failures


def test_cli_trains_tp2_sp_under_torch_distributed_run(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "neuronx_distributed_training_torch.trainer.cli",
           "--config", str(TINY), "--set", "trainer.max_steps=2",
           "--set", "distributed_strategy.tensor_model_parallel_size=2",
           "--set", "distributed_strategy.sequence_parallel=true",
           "--set", "exp_manager.checkpoint_callback_params.every_n_train_steps=2",
           "--set", f"exp_manager.exp_dir={tmp_path}",
           "--set", "exp_manager.create_tensorboard_logger=false", "--device", "cpu"]
    out = subprocess.run(cmd, cwd=REPO, env=DPT._env(), capture_output=True, text=True,
                         timeout=DPT.RANK_TIMEOUT)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    assert "tp 2, sp True" in out.stdout + out.stderr
    run = next(tmp_path.glob("*/version_0"))
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["loss"]) and x["consumed_samples"] == 8 * x["step"]
               for x in lines)
    assert abs(lines[0]["loss"] - np.log(512)) < 0.5
    assert ck_integrity.verify_step(run / "checkpoints", 2).status == "ok"
