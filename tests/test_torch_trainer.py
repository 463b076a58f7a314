"""The port's config loader, synthetic data, trainer CLI and package hygiene.

- ``load_config`` resolves every ``examples/conf/*.yaml`` to the same dict as
  the JAX package's loader;
- ``SyntheticDataModule`` batches are byte-identical to the JAX ones for the
  same seed and ``consumed_samples``;
- the CLI trains ``tiny_smoke_config.yaml``-sized settings on the CPU;
- the fit loop: a resumed run equals a straight run bit for bit,
  ``metrics.jsonl`` has one line per logged step, ``trainer.max_time`` and
  an in-process SIGTERM stop at the step boundary with a checkpoint, and
  validation runs every ``val_check_interval``;
- the port's trainer and the JAX trainer, from the same weights on the same
  Megatron corpus, give the same loss at every step within the fp32
  tolerance of ``test_torch_step.py`` (rtol 1e-5), and a port that shifted
  the pre-shifted labels again would not;
- SFT with LoRA: the port's trainer and the JAX trainer, from the same
  weights (adapters included) on the same char-tokenized jsonl, give the same
  loss at every step within rtol 1e-5 (fp32), with ``segment_mask`` off and
  on; a LoRA run resumed from a checkpoint equals a straight run bit for
  bit, and ``fit`` leaves the frozen base bit for bit as it was; the CLI
  trains the LoRA SFT config at a tiny width on the CPU;
- the port imports neither ``jax`` nor the JAX package (checked in a fresh
  subprocess, since this test process imported jax already, and by a source
  scan), the data, checkpoint, exp-manager, SFT and LoRA modules included.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.data import loader as t_data
from neuronx_distributed_training_torch.trainer import cli as t_cli
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.data import loader as j_data
from neuronx_distributed_training_tpu.trainer import cli as j_cli

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "neuronx_distributed_training_torch"
CONFIGS = sorted((REPO / "examples" / "conf").glob("*.yaml"))
#: the modules of the data / checkpoint / exp-manager slice, the SFT / LoRA slice, the
#: data-parallel slice, the tensor-parallel slice and the preference-alignment slice
NEW_MODULES = tuple(f"neuronx_distributed_training_torch.{m}" for m in (
    "data._native", "data.build", "data.modules", "data.megatron", "data.megatron.dataset",
    "data.megatron.index", "checkpoint", "checkpoint.integrity", "checkpoint.manager",
    "trainer.exp_manager", "utils.io", "data.packing", "data.templates", "peft",
    "peft.lora", "telemetry", "telemetry.health", "parallel.mesh", "utils.launch",
    "tools.zero1_bytes", "parallel.sharding", "parallel.tensor_parallel", "alignment",
    "alignment.losses", "alignment.dpo", "alignment.orpo", "alignment.kto", "ops.moe",
    "models.mixtral", "models.gpt", "utils.prng", "tools.convert_megatron",
    "telemetry.alerts", "telemetry.fleet", "telemetry.memory", "telemetry.tensorstats",
    "telemetry.quant_readiness", "trainer.control", "tools.checkpoint_converter",
    "tools.ckpt_verify", "tools.prepare_dataset", "models.generate", "models.decode",
    "tools.evaluate", "tools.run_sft_evaluation", "tools.bench_decode", "autotune",
    "autotune.topology", "autotune.space", "autotune.cost_model", "autotune.planner",
    "analysis", "analysis.report", "analysis.graph_audit", "trainer.elastic", "tools.plan",
    "tools.preflight_audit", "tools.elastic_drill", "telemetry.comms",
    "analysis.perf_contract", "analysis.graph_contract", "tools.comms_bench",
    "tools.comms_report", "tools.perf_contract", "tools.graph_contract",
    "tools.quant_readiness"))
TINY = REPO / "examples" / "conf" / "tiny_smoke_config.yaml"


def test_all_example_configs_present():
    assert len(CONFIGS) == 24


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_load_config_matches_jax(path):
    overrides = {"trainer.max_steps": 7, "data.global_batch_size": 16}
    assert t_loader.load_config(path, overrides) == j_loader.load_config(path, overrides)


def test_loader_rejections_and_batch_schedule():
    for bad in ({"distributed_strategy": {"sequence_parallel": True}},
                {"data": {"global_batch_size": 6, "micro_batch_size": 4}},
                {"precision": {"type": "fp8"}},
                {"autotune": {"top_kk": 3}},
                {"model": {"model_alignment_strategy": "dpo"}}):
        with pytest.raises(ValueError):
            t_loader.load_config(bad)
        with pytest.raises(ValueError):
            j_loader.load_config(bad)
    cfg = t_loader.load_config({"data": {"global_batch_size": 8, "micro_batch_size": 2}})
    assert t_loader.batch_schedule(cfg, 2) == j_loader.batch_schedule(
        j_loader.load_config(dict(cfg)), 2)
    assert t_cli.parse_overrides(["a.b=3", "c=x", "d=[1, 2]"]) == j_cli.parse_overrides(
        ["a.b=3", "c=x", "d=[1, 2]"])


@pytest.mark.parametrize("shuffle,consumed", [(False, 0), (False, 8), (True, 12)])
def test_synthetic_batches_match_jax(shuffle, consumed):
    kw = dict(total_samples=64, seed=7, shuffle=shuffle, consumed_samples=consumed)
    t = t_data.SyntheticDataModule(512, 32, 4, **kw).global_batches()
    j = j_data.SyntheticDataModule(512, 32, 4, **kw).global_batches()
    for _ in range(3):
        tb, jb = next(t), next(j)
        assert tb.keys() == jb.keys()
        for k in tb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


def test_cli_trains_tiny_config_on_cpu(tmp_path):
    history = t_cli.main(["--config", str(TINY), "--set", "trainer.max_steps=2",
                          "--set", f"exp_manager.exp_dir={tmp_path}", "--device", "cpu"])
    assert len(history) == 2
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in history)
    # random init at vocab 512: the loss starts near ln(512)
    assert abs(history[0]["loss"] - np.log(512)) < 0.5
    assert history[-1]["consumed_samples"] == 2 * 8
    assert np.isnan(history[0]["mfu"])  # no device peak on the CPU


def test_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_loader.load_config(TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_loop.Trainer.from_config(cfg)
    from neuronx_distributed_training_torch.utils.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("override,item", [
    # tp above the tiny config's 2 kv heads: KV replication (ported)
    ({"distributed_strategy.tensor_model_parallel_size": 4,
      "distributed_strategy.sequence_parallel": True}, None),
    # pipeline parallelism at vp 1 (ported)
    ({"distributed_strategy.pipeline_model_parallel_size": 2}, None),
    # context parallelism under pipeline parallelism (ported)
    ({"distributed_strategy.pipeline_model_parallel_size": 2,
      "distributed_strategy.context_parallel_size": 2,
      "model.fusions.ring_attention": True}, None),
    # tp above the kv heads under cp too (ported)
    ({"distributed_strategy.context_parallel_size": 2,
      "distributed_strategy.tensor_model_parallel_size": 4,
      "model.fusions.ring_attention": True}, None),
    # preference alignment under cp (ported)
    ({"distributed_strategy.context_parallel_size": 2, "model.fusions.ring_attention": True,
      "model_alignment_strategy": "dpo"}, None),
    # a moe block on a llama architecture: ignored, the model trains dense (as JAX)
    ({"model.moe.num_experts": 4}, None),
    # model_source megatron on the llama architecture: a Llama, as JAX's
    # build_model dispatches (GPT is ported: the case once asserted its refusal)
    pytest.param({"model_source": "megatron"}, None, id="override6-item 14"),
    # the chunked head + CE (ported)
    ({"model.fusions.chunked_ce": 4}, None),
    # the virtual pipeline, the zero-bubble schedule, the chunked head and
    # preference alignment under pipeline parallelism (ported)
    ({"distributed_strategy.pipeline_model_parallel_size": 2,
      "distributed_strategy.virtual_pipeline_model_parallel_size": 2, "model.num_layers": 4},
     None),
    ({"distributed_strategy.pipeline_model_parallel_size": 2,
      "distributed_strategy.pipeline": {"schedule": "1f1b-zb"}}, None),
    ({"distributed_strategy.pipeline_model_parallel_size": 2, "model.fusions.chunked_ce": 4},
     None),
    ({"distributed_strategy.pipeline_model_parallel_size": 2,
      "model_alignment_strategy": "dpo"}, None),
])
def test_unported_knobs_are_rejected_with_their_roadmap_item(override, item):
    """Each unported knob is refused naming its ROADMAP entry and item; the
    cases whose entries are ported (``item`` None) pass ``check_supported``,
    and the trainer then asks for torchrun where they need several ranks."""
    cfg = t_loader.load_config(TINY, override)
    if item is None:
        t_loop.check_supported(cfg)
        ranks = [v for k, v in override.items() if k.endswith("parallel_size")]
        if ranks:
            with pytest.raises(ValueError, match="needs .* processes: launch under torchrun"):
                t_loop.Trainer.from_config(cfg, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=item):
        t_loop.Trainer.from_config(cfg, device="cpu")


@pytest.mark.parametrize("fusion", ["ring_attention", "ulysses_attention",
                                    "zigzag_ring_attention"])
def test_context_parallel_fusions_are_accepted(fusion):
    """cp 2 with each cp fusion passes check_supported; in one process the
    trainer asks for torchrun (a context group needs cp processes)."""
    cfg = t_loader.load_config(TINY, {"distributed_strategy.context_parallel_size": 2,
                                      f"model.fusions.{fusion}": True})
    t_loop.check_supported(cfg)
    with pytest.raises(ValueError, match="context_parallel_size 2 needs 2 processes"):
        t_loop.Trainer.from_config(cfg, device="cpu")


def test_cp_fusion_at_cp1_trains_as_core_attention(tmp_path):
    """At cp 1 the ring and Ulysses are core attention (JAX's fallback): one
    step with either fusion gives the core run's loss bit for bit."""
    losses = {}
    for fusion in (None, "ring_attention", "ulysses_attention"):
        over = {"trainer.max_steps": 1, "exp_manager.exp_dir": str(tmp_path / str(fusion)),
                "exp_manager.create_tensorboard_logger": False,
                "exp_manager.checkpoint_callback_params.every_n_train_steps": 0}
        if fusion:
            over[f"model.fusions.{fusion}"] = True
        trainer = t_loop.Trainer.from_config(t_loader.load_config(TINY, over), device="cpu",
                                             enable_checkpointing=False)
        assert trainer.model_cfg.attention_impl == {None: "core", "ring_attention": "ring",
                                                    "ulysses_attention": "ulysses"}[fusion]
        losses[fusion] = trainer.fit()[0]["loss"]
    assert losses["ring_attention"] == losses[None] == losses["ulysses_attention"]


@pytest.mark.parametrize("strategy", ["dpo", "kto"])
def test_alignment_strategies_pass_check_supported(strategy):
    """DPO and KTO (and ORPO) train in the port: check_supported accepts them."""
    t_loop.check_supported(t_loader.load_config(TINY, {"model_alignment_strategy": strategy}))


def test_ignored_blocks_are_logged_once(caplog):
    cfg = t_loader.load_config(TINY)
    t_loop._logged_ignored.clear()
    with caplog.at_level("INFO", logger="nxdt.torch.train"):
        t_loop.check_supported(cfg)
        t_loop._log_ignored(cfg)
        t_loop._log_ignored(cfg)
    # the health policy and its flight recorder, the default planes, ZeRO-1,
    # the planes tiny_smoke turns on (tensorstats, fleet, alerts, control,
    # memory) and, since the overlap slice, its distributed_strategy.overlap
    # block are acted on: nothing of tiny_smoke is ignored
    msgs = [r.getMessage() for r in caplog.records if "ignored" in r.getMessage()]
    assert msgs == []
    # what is still ignored is named, once: a TPU generation as the
    # planner's topology (the port prices the detected card); the trace
    # plane, the W&B / MLflow sinks, the profiling window, the elastic block
    # and autotune are acted on now
    rest = t_loader.load_config(TINY, {
        "exp_manager.telemetry.trace": {"enabled": True}, "exp_manager.elastic": {},
        "exp_manager.create_wandb_logger": True, "exp_manager.create_mlflow_logger": True,
        "exp_manager.profile_start_step": 2, "autotune": {"topology": "v5e"}})
    t_loop._logged_ignored.clear()
    caplog.clear()
    with caplog.at_level("INFO", logger="nxdt.torch.train"):
        t_loop._log_ignored(rest)
        t_loop._log_ignored(rest)
    msgs = [r.getMessage() for r in caplog.records if "ignored" in r.getMessage()]
    assert len(msgs) == 1
    assert "data and tensor parallelism" in msgs[0] and "data parallelism only" not in msgs[0]
    assert "engineered overlap" in msgs[0] and "trace, fleet" in msgs[0]
    assert set(msgs[0].split(": ", 1)[1].split(", ")) == {"autotune.topology (v5e)"}


def test_port_imports_no_jax_in_a_fresh_process():
    code = (
        "import importlib, pkgutil, sys\n"
        "import neuronx_distributed_training_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('neuronx_distributed_training_tpu')]\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {NEW_MODULES!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 34  # every module of the port was imported


def test_port_sources_mention_no_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax)|neuronx_distributed_training_tpu",
                         re.MULTILINE)
    # the port's own copy of the host C++ index builder is scanned too: it
    # must not point back into the JAX package's sources
    files = list(PORT.rglob("*.py")) + list(PORT.rglob("*.cpp")) + [REPO / "chip_smoke.py"]
    scanned = {str(f.relative_to(REPO)).replace("/", ".").rsplit(".", 1)[0]
               .removesuffix(".__init__") for f in files}
    assert set(NEW_MODULES) <= scanned, set(NEW_MODULES) - scanned
    offenders = []
    for f in files:
        src = f.read_text()
        if f.name == "chip_smoke.py":
            # it names the TPU kernels it replaces, as file:line strings
            src = re.sub(r'"neuronx_distributed_training_tpu/ops/flash_attention\.py:\d+"', "",
                         src)
        if pattern.search(src):
            offenders.append(str(f.relative_to(REPO)))
    assert not offenders, offenders


# ---------------------------------------------------------------------------
# the fit loop: resume, metrics, stops (one CPU process)
# ---------------------------------------------------------------------------


def tiny_cfg(tmp_path, max_steps=5, exp="exp", **over):
    cfg = {
        "name": "tiny", "model_source": "hf", "seed": 7,
        "trainer": {"max_steps": max_steps, "log_every_n_steps": 1},
        "exp_manager": {
            "exp_dir": str(tmp_path / exp), "resume_if_exists": True,
            "create_tensorboard_logger": False,
            "checkpoint_callback_params": {"save_top_k": 2, "every_n_train_steps": 2},
        },
        "data": {"global_batch_size": 8, "micro_batch_size": 4, "seq_length": 32,
                 "synthetic": True},
        "model": {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
                  "num_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                  "max_position_embeddings": 32,
                  "optim": {"name": "adamw_fp32OptState", "lr": 1e-3,
                            "sched": {"name": "LinearAnnealingWithWarmUp", "warmup_steps": 2,
                                      "max_steps": max_steps}}},
        "precision": {"type": "mixed_precision"},
    }
    for k, v in over.items():
        cfg[k] = {**cfg.get(k, {}), **v} if isinstance(v, dict) else v
    return t_loader.load_config(cfg)


def _trainer(cfg, **kw):
    return t_loop.Trainer.from_config(cfg, device="cpu", **kw)


def _state(trainer):
    from neuronx_distributed_training_torch.checkpoint.manager import state_trees

    return {f"{i}/{n}": t.detach().clone()
            for i, tree in state_trees(trainer.params, trainer.opt_state).items()
            for n, t in tree.items()}


def test_resume_continues_exactly(tmp_path):
    t1 = _trainer(tiny_cfg(tmp_path, max_steps=4))
    t1.fit()  # saves at steps 2 and 4
    assert t1.checkpointer.committed_steps == [2, 4]
    t2 = _trainer(tiny_cfg(tmp_path, max_steps=6))
    assert t2.maybe_resume()
    assert t2.step == 4 and t2.data_module.consumed_samples == 32
    history = t2.fit()
    assert [r["step"] for r in history] == [4, 5]
    assert history[-1]["consumed_samples"] == 48


def test_resume_bitwise_params(tmp_path):
    """A run that checkpoints at step 2 and resumes to step 4 equals an
    uninterrupted 4-step run bit for bit: every param and optimizer leaf,
    and the last step's loss and grad_norm."""
    straight = _trainer(tiny_cfg(tmp_path, max_steps=4, exp="exp_a"))
    hs = straight.fit()
    first = _trainer(tiny_cfg(tmp_path, max_steps=2, exp="exp_b"))
    first.fit()
    second = _trainer(tiny_cfg(tmp_path, max_steps=4, exp="exp_b"))
    hr = second.fit()
    assert [r["step"] for r in hr] == [2, 3]
    assert [(r["loss"], r["grad_norm"]) for r in hr] == [(r["loss"], r["grad_norm"])
                                                         for r in hs[2:]]
    a, b = _state(straight), _state(second)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]
    assert second.opt_state["step"] == straight.opt_state["step"] == 4


@pytest.mark.parametrize("every,logged", [(1, [1, 2, 3, 4, 5]), (2, [2, 4])])
def test_metrics_jsonl_one_line_per_logged_step(tmp_path, every, logged):
    import json

    t = _trainer(tiny_cfg(tmp_path, trainer={"log_every_n_steps": every}))
    history = t.fit()
    assert len(history) == 5 and history[-1]["consumed_samples"] == 40
    lines = [json.loads(x) for x in (t.exp.log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == logged
    assert all({"loss", "lr", "grad_norm", "consumed_samples"} <= r.keys() for r in lines)
    summary = json.loads((t.exp.log_dir / "run_summary.json").read_text())
    assert summary["steps"] == 5 and summary["stop_class"] is None
    # saves at the cadence steps 2 and 4, then the final save at step 5
    assert t.checkpointer.committed_steps == [2, 4, 5]
    assert summary["checkpoint"]["last_save"]["step"] == 5


def test_max_time_stops_and_saves(tmp_path):
    from neuronx_distributed_training_tpu.trainer.loop import parse_max_time as j_parse

    for v in (None, 0, 30, 12.5, "00:01:02:03"):
        assert t_loop.parse_max_time(v) == j_parse(v)
    with pytest.raises(ValueError, match="DD:HH:MM:SS"):
        t_loop.parse_max_time("1:2")
    t = _trainer(tiny_cfg(tmp_path, trainer={"max_time": 1e-9}))
    history = t.fit()
    assert len(history) == 1 and t.stop_class == "max_time"
    assert t.checkpointer.committed_steps == [1]
    from neuronx_distributed_training_torch.checkpoint import integrity as ck_integrity

    assert ck_integrity.verify_step(t.checkpointer.directory, 1).status == "ok"


def test_sigterm_stops_at_the_step_boundary_with_a_save(tmp_path):
    import signal

    t = _trainer(tiny_cfg(tmp_path, trainer={"max_steps": 5}))
    real, calls = t.train_step, {"n": 0}

    def step_then_preempt(*a):
        out = real(*a)
        calls["n"] += 1
        if calls["n"] == 3:
            signal.raise_signal(signal.SIGTERM)  # lands mid-step
        return out

    t.train_step = step_then_preempt
    before = signal.getsignal(signal.SIGTERM)
    history = t.fit()
    assert len(history) == 3 and t.stop_class == "preemption"
    # step 3's boundary: the stop replaces no cadence save (3 is off cadence)
    # and the emergency save writes step 3 once, after the cadence save at 2
    assert t.checkpointer.committed_steps == [2, 3]
    assert signal.getsignal(signal.SIGTERM) == before  # handler restored
    t2 = _trainer(tiny_cfg(tmp_path, trainer={"max_steps": 5}))
    h2 = t2.fit()
    assert [r["step"] for r in h2] == [3, 4] and h2[0]["consumed_samples"] == 32


def test_validation_every_interval(tmp_path):
    val = t_data.SyntheticDataModule(vocab_size=128, seq_len=32, global_batch_size=8, seed=99)
    t = _trainer(tiny_cfg(tmp_path, max_steps=4,
                          trainer={"val_check_interval": 2, "limit_val_batches": 2}),
                 val_data_module=val)
    history = t.fit()
    assert [("val_loss" in r) for r in history] == [False, True, False, True]
    assert all(np.isfinite(r["val_loss"]) for r in history if "val_loss" in r)
    assert val.consumed_samples == 2 * 2 * 8  # two validations of two batches, no more


# ---------------------------------------------------------------------------
# the port's trainer against the JAX trainer on a Megatron corpus
# ---------------------------------------------------------------------------

#: loss tolerance, as tests/test_torch_step.py holds three fp32 steps
FP32_LOSS_RTOL = 1e-5


def _megatron_cfg(tmp_path, prefix, exp):
    return {
        "name": "parity", "model_source": "hf", "seed": 3,
        "trainer": {"max_steps": 4, "log_every_n_steps": 1},
        "exp_manager": {"exp_dir": str(tmp_path / exp), "create_tensorboard_logger": False,
                        "log_files": False, "telemetry": {"compile_census": False}},
        "distributed_strategy": {"tensor_model_parallel_size": 1},
        "data": {"global_batch_size": 4, "micro_batch_size": 2, "seq_length": 48,
                 "data_prefix": str(prefix)},
        "model": {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
                  "num_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                  "max_position_embeddings": 48,
                  "optim": {"name": "adamw_fp32OptState", "lr": 1e-3, "weight_decay": 0.1,
                            "sched": {"name": "CosineAnnealing", "warmup_steps": 0,
                                      "max_steps": 4}}},
        "precision": {"type": "fp32"},
    }


def _port_losses_from_jax_weights(tmp_path, prefix, jparams, *, shift_labels=None):
    import jax

    from neuronx_distributed_training_torch.models import llama as t_llama
    from neuronx_distributed_training_torch.optim.adamw import init_opt_state
    from neuronx_distributed_training_torch.tools.convert import params_from_jax

    exp = "port" if shift_labels is None else "port_shift"
    t = _trainer(t_loader.load_config(_megatron_cfg(tmp_path, prefix, exp)),
                 enable_checkpointing=False)
    if shift_labels is not None:  # the fault this test exists to catch
        real = t_llama.forward
        t.train_step = t_loop.make_train_step(
            lambda p, b: real(p, b, t.model_cfg, t.policy, shift_labels=shift_labels),
            t_loop.AdamWConfig.from_config(t.cfg.model.optim, t.cfg.trainer),
            t_loop.build_lr_schedule(t.cfg.model.optim), t.policy,
            num_microbatches=t.sched["num_microbatches"])
    src = t_llama.named_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                               device="cpu"))
    with torch.no_grad():
        for n, p in t_llama.named_params(t.params).items():
            p.copy_(src[n])
    t.opt_state = init_opt_state(t_llama.named_params(t.params), t.policy)
    return [r["loss"] for r in t.fit()]


def test_trainer_losses_match_jax_on_a_megatron_corpus(tmp_path):
    """4 steps of the port's trainer and the JAX trainer (one CPU device) from
    the same weights on the same Megatron corpus: every step's loss within
    the fp32 tolerance.  Megatron rows are pre-shifted; a port that shifted
    them again would train on the token two ahead, and the negative control
    shows this comparison sees it."""
    import json

    import jax

    from neuronx_distributed_training_tpu.data.megatron import (
        write_indexed_dataset as j_write,
    )
    from neuronx_distributed_training_tpu.trainer.loop import Trainer as JTrainer

    rng = np.random.default_rng(17)
    docs = [rng.integers(0, 128, int(rng.integers(5, 120))).astype(np.int32)
            for _ in range(80)]
    for side in ("t", "j"):
        (tmp_path / side).mkdir()
    j_write(tmp_path / "j" / "corpus", docs)
    from neuronx_distributed_training_torch.data.megatron import write_indexed_dataset

    write_indexed_dataset(tmp_path / "t" / "corpus", docs)
    jt = JTrainer.from_config(
        j_loader.load_config(_megatron_cfg(tmp_path, tmp_path / "j" / "corpus", "jax")),
        devices=jax.devices()[:1], enable_checkpointing=False)
    jparams = jax.tree_util.tree_map(np.asarray, jt.params)
    jt.fit()
    lines = (jt.exp.log_dir / "metrics.jsonl").read_text().splitlines()
    jax_losses = [json.loads(x)["loss"] for x in lines if "loss" in json.loads(x)]
    assert len(jax_losses) == 4
    port = _port_losses_from_jax_weights(tmp_path, tmp_path / "t" / "corpus", jparams)
    np.testing.assert_allclose(port, jax_losses, rtol=FP32_LOSS_RTOL, atol=0)
    shifted = _port_losses_from_jax_weights(tmp_path, tmp_path / "t" / "corpus", jparams,
                                            shift_labels=True)
    assert not np.allclose(shifted, jax_losses, rtol=FP32_LOSS_RTOL, atol=0)


# ---------------------------------------------------------------------------
# SFT with LoRA: the port's trainer against the JAX trainer, resume, freeze
# ---------------------------------------------------------------------------

SFT_LORA = REPO / "examples" / "conf" / "hf_llama3_8B_SFT_lora_config.yaml"
#: the tiny width both trainers and the CLI case run at
TINY_WIDTH = {"model.vocab_size": 128, "model.hidden_size": 64, "model.intermediate_size": 128,
              "model.num_layers": 2, "model.num_attention_heads": 4,
              "model.num_key_value_heads": 2}


def _sft_jsonl(path, n=120, seed=21):
    import json

    rng = np.random.default_rng(seed)

    def text(lo, hi):
        return "".join(chr(int(c)) for c in rng.integers(32, 127, int(rng.integers(lo, hi))))

    path.write_text("\n".join(json.dumps({"input": text(3, 25), "output": text(3, 30)})
                              for _ in range(n)))
    return path


def _sft_lora_cfg(tmp_path, data, exp, *, segment_mask=False, max_steps=4, precision="fp32",
                  every=0):
    return {
        "name": "sft_lora", "model_source": "hf", "seed": 5,
        "model_alignment_strategy": {"sft": {"packing": True, "segment_mask": segment_mask}},
        "trainer": {"max_steps": max_steps, "log_every_n_steps": 1},
        "exp_manager": {"exp_dir": str(tmp_path / exp), "create_tensorboard_logger": False,
                        "log_files": False, "resume_if_exists": True,
                        "telemetry": {"compile_census": False},
                        "checkpoint_callback_params": {"save_top_k": 2,
                                                       "every_n_train_steps": every}},
        "distributed_strategy": {"tensor_model_parallel_size": 1},
        "data": {"global_batch_size": 4, "micro_batch_size": 2, "seq_length": 64,
                 "train_dir": str(data), "tokenizer": {"library": "char", "vocab_size": 128}},
        "model": {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
                  "num_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                  "max_position_embeddings": 64,
                  "lora": {"lora_rank": 4, "lora_alpha": 16, "lora_dropout": 0.05,
                           "target_modules": ["qkv_proj", "o_proj", "gate_up_proj",
                                              "down_proj"]},
                  "optim": {"name": "adamw_fp32OptState", "lr": 1e-2, "weight_decay": 0.1,
                            "sched": {"name": "CosineAnnealing", "warmup_steps": 0,
                                      "max_steps": max_steps}}},
        "precision": {"type": precision},
    }


def _frozen(trainer):
    from neuronx_distributed_training_torch.models import llama as t_llama

    return {n: p.detach().clone() for n, p in t_llama.named_params(trainer.params).items()
            if n not in trainer.trainable}


@pytest.mark.parametrize("segment_mask", [False, True])
def test_sft_lora_trainer_losses_match_jax(tmp_path, segment_mask):
    """4 steps of the port's trainer and the JAX trainer (one CPU device)
    with LoRA on the same packed SFT jsonl, from the JAX trainer's weights
    and adapters: every step's loss within the fp32 tolerance, the batches
    carrying segment_ids when asked, and the base unchanged."""
    import json

    import jax

    from neuronx_distributed_training_torch.models import llama as t_llama
    from neuronx_distributed_training_torch.optim.adamw import init_opt_state
    from neuronx_distributed_training_torch.tools.convert import params_from_jax
    from neuronx_distributed_training_tpu.trainer.loop import Trainer as JTrainer

    data = _sft_jsonl(tmp_path / "train.jsonl")
    jt = JTrainer.from_config(
        j_loader.load_config(_sft_lora_cfg(tmp_path, data, "jax", segment_mask=segment_mask)),
        devices=jax.devices()[:1], enable_checkpointing=False)
    jparams = jax.tree_util.tree_map(np.asarray, jt.params)
    jt.fit()
    lines = (jt.exp.log_dir / "metrics.jsonl").read_text().splitlines()
    jax_losses = [json.loads(x)["loss"] for x in lines if "loss" in json.loads(x)]
    assert len(jax_losses) == 4

    t = _trainer(t_loader.load_config(_sft_lora_cfg(tmp_path, data, "port",
                                                    segment_mask=segment_mask)),
                 enable_checkpointing=False)
    assert ("segment_ids" in t.data_module.input_names) == segment_mask
    assert t.trainable == {n for n in t_llama.named_params(t.params)
                           if n.endswith(("lora_a", "lora_b"))}
    src = t_llama.named_params(params_from_jax(jparams, device="cpu"))
    with torch.no_grad():
        for n, p in t_llama.named_params(t.params).items():
            p.copy_(src[n])
    flat = t_llama.named_params(t.params)
    t.opt_state = init_opt_state({n: flat[n] for n in t.trainable}, t.policy)
    frozen = _frozen(t)
    losses = [r["loss"] for r in t.fit()]
    np.testing.assert_allclose(losses, jax_losses, rtol=FP32_LOSS_RTOL, atol=0)
    assert losses[0] != losses[-1]
    after = _frozen(t)
    assert all(torch.equal(frozen[n], after[n]) for n in frozen)


def test_sft_lora_segment_mask_changes_the_loss(tmp_path):
    data = _sft_jsonl(tmp_path / "train.jsonl")
    runs = [_trainer(t_loader.load_config(_sft_lora_cfg(tmp_path, data, f"e{m}",
                                                        segment_mask=m, max_steps=1)),
                     enable_checkpointing=False).fit()[0]["loss"] for m in (False, True)]
    assert np.isfinite(runs).all() and runs[0] != runs[1]


def test_sft_lora_resume_bitwise_and_frozen_base(tmp_path):
    """A LoRA run checkpointed at step 2 and resumed to step 4 equals a
    straight 4-step run bit for bit (loss, grad_norm, every param and
    optimizer leaf); the checkpoint holds the whole param tree and the
    adapters' optimizer state only; fit leaves the frozen base as it was."""
    data = _sft_jsonl(tmp_path / "train.jsonl")
    straight = _trainer(t_loader.load_config(
        _sft_lora_cfg(tmp_path, data, "a", precision="mixed_precision", every=2)))
    base = _frozen(straight)
    hs = straight.fit()
    after = _frozen(straight)
    assert base.keys() == after.keys() and all(torch.equal(base[n], after[n]) for n in base)
    first = _trainer(t_loader.load_config(
        _sft_lora_cfg(tmp_path, data, "b", precision="mixed_precision", max_steps=4, every=2)))
    first.max_steps = 2
    first.fit()
    assert first.checkpointer.committed_steps == [2]
    second = _trainer(t_loader.load_config(
        _sft_lora_cfg(tmp_path, data, "b", precision="mixed_precision", every=2)))
    hr = second.fit()
    assert second.checkpointer.last_restore["step"] == 2
    assert [r["step"] for r in hr] == [2, 3]
    assert [(r["loss"], r["grad_norm"]) for r in hr] == [(r["loss"], r["grad_norm"])
                                                         for r in hs[2:]]
    a, b = _state(straight), _state(second)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]
    opt = {k.split("/", 2)[2] for k in a if k.startswith("opt_state/mu/")}
    assert opt == straight.trainable
    assert {k.split("/", 1)[1] for k in a if k.startswith("params/")} >= set(base)


def test_cli_trains_the_sft_lora_config_on_cpu_and_needs_the_card_otherwise(tmp_path,
                                                                           monkeypatch):
    data = _sft_jsonl(tmp_path / "train.jsonl")
    args = ["--config", str(SFT_LORA), "--set", "distributed_strategy.tensor_model_parallel_size=1",
            "--set", "distributed_strategy.sequence_parallel=false",
            "--set", "data.global_batch_size=4", "--set", "data.seq_length=64",
            "--set", "trainer.max_steps=2", "--set", f"data.train_dir={data}",
            "--set", "data.tokenizer.library=char", "--set", "data.tokenizer.vocab_size=128",
            "--set", f"exp_manager.exp_dir={tmp_path / 'exp'}"]
    for k, v in TINY_WIDTH.items():
        args += ["--set", f"{k}={v}"]
    trainer, history = t_cli.run(args + ["--device", "cpu"])
    assert len(history) == 2 and all(np.isfinite(r["loss"]) for r in history)
    assert abs(history[0]["loss"] - np.log(128)) < 0.5
    assert len(trainer.trainable) == 2 * 4 * 2 and "segment_ids" not in trainer.data_module.arrays
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.run(args)
