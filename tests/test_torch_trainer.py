"""The port's config loader, synthetic data, trainer CLI and package hygiene.

- ``load_config`` resolves every ``examples/conf/*.yaml`` to the same dict as
  the JAX package's loader;
- ``SyntheticDataModule`` batches are byte-identical to the JAX ones for the
  same seed and ``consumed_samples``;
- the CLI trains ``tiny_smoke_config.yaml``-sized settings on the CPU;
- the port imports neither ``jax`` nor the JAX package (checked in a fresh
  subprocess, since this test process imported jax already, and by a source
  scan).
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


def test_cli_trains_tiny_config_on_cpu():
    history = t_cli.main(["--config", str(TINY), "--set", "trainer.max_steps=2",
                          "--device", "cpu"])
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
    ({"distributed_strategy.tensor_model_parallel_size": 2,
      "distributed_strategy.sequence_parallel": True}, "item 7"),
    ({"distributed_strategy.pipeline_model_parallel_size": 2}, "item 12"),
    ({"distributed_strategy.context_parallel_size": 2,
      "model.fusions.ring_attention": True}, "item 11"),
    ({"model.fusions.ulysses_attention": True}, "item 11"),
    ({"model.moe.num_experts": 4}, "item 13"),
    ({"model_source": "megatron"}, "item 14"),
    ({"model_alignment_strategy": "dpo"}, "item 14"),
    ({"data.synthetic": False}, "item 8"),
    ({"model.fusions.chunked_ce": 4}, "item 2"),
])
def test_unported_knobs_are_rejected_with_their_roadmap_item(override, item):
    cfg = t_loader.load_config(TINY, override)
    with pytest.raises(NotImplementedError, match=item):
        t_loop.Trainer.from_config(cfg, device="cpu")


def test_ignored_blocks_are_logged_once(caplog):
    cfg = t_loader.load_config(TINY)
    t_loop._logged_ignored.clear()
    with caplog.at_level("INFO", logger="nxdt.torch.train"):
        t_loop.check_supported(cfg)
        t_loop._log_ignored(cfg)
        t_loop._log_ignored(cfg)
    msgs = [r.getMessage() for r in caplog.records if "ignored" in r.getMessage()]
    assert len(msgs) == 1 and "exp_manager.telemetry" in msgs[0]


def test_port_imports_no_jax_in_a_fresh_process():
    code = (
        "import importlib, pkgutil, sys\n"
        "import neuronx_distributed_training_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('neuronx_distributed_training_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module of the port was imported


def test_port_sources_mention_no_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax)|neuronx_distributed_training_tpu",
                         re.MULTILINE)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
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
