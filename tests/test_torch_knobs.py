"""The reference knobs the JAX trainer reads, and the checkpoint dir: each
is acted on by the port or named in its "ignored" log.

- A sweep over the shipped configs: every key the JAX trainer reads through
  its accessors (``exp_block.get``, the data block's retry knobs in
  ``trainer/loop.py``; ``fusions.get`` and ``ds.get`` in
  ``models/llama.py::LlamaConfig.from_config``), found in the JAX sources,
  is either acted on by the port (:data:`ACTED`, each held below or by its
  slice's tests) or named in ``trainer/loop.py::_log_ignored``'s line.
- ``exp_manager.log_parameter_norm`` / ``log_gradient_norm`` log
  ``param_norm`` (after the update) and ``gradient_norm`` (the pre-clip
  norm), as JAX's ``trainer/step.py`` does; ``data.io_retries`` /
  ``io_retry_backoff_seconds`` reach the data module.
- A ``gs://`` or ``s3://`` checkpoint dir is refused with the JAX package's
  text, and no local ``gs:`` directory is made.
"""

import logging
import math
import re
from pathlib import Path

import pytest
import torch

from neuronx_distributed_training_torch.checkpoint import CheckpointConfig, Checkpointer
from neuronx_distributed_training_torch.checkpoint.manager import resolve_checkpoint_dir
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.trainer import loop as t_loop

REPO = Path(__file__).resolve().parents[1]
CONF = REPO / "examples" / "conf"
TINY = CONF / "tiny_smoke_config.yaml"
JAX = REPO / "neuronx_distributed_training_tpu"

#: where the JAX trainer reads knobs: (source, accessor pattern, block)
JAX_READS = [
    (JAX / "trainer" / "loop.py", r'exp_block\.get\("(\w+)"', "exp_manager"),
    (JAX / "trainer" / "loop.py", r'\("(\w+)", (?:int|float)\)', "data"),
    (JAX / "models" / "llama.py", r'fusions\.get\("(\w+)"', "model.fusions"),
    (JAX / "models" / "llama.py", r'ds\.get\("(\w+)"', "distributed_strategy"),
    (JAX / "trainer" / "loop.py", r'ds\.get\("(\w+)"', "distributed_strategy"),
]

#: the keys the port acts on, and where
ACTED = {
    "exp_manager.log_parameter_norm": "trainer/step.py: param_norm",
    "exp_manager.log_gradient_norm": "trainer/step.py: gradient_norm",
    "data.io_retries": "trainer/loop.py: set on the data module",
    "data.io_retry_backoff_seconds": "trainer/loop.py: set on the data module",
    "model.fusions.flash_attention": "models/llama.py: attention_impl",
    "model.fusions.ring_attention": "models/llama.py: attention_impl",
    "model.fusions.ulysses_attention": "models/llama.py: attention_impl",
    "model.fusions.zigzag_ring_attention": "models/llama.py: attention_impl",
    "model.fusions.chunked_ce": "models/llama.py: vocab_chunks",
    "distributed_strategy.sequence_parallel": "parallel/mesh.py: MeshConfig",
    "distributed_strategy.context_parallel_size": "parallel/mesh.py: MeshConfig",
    "distributed_strategy.pipeline_model_parallel_size": "parallel/mesh.py: MeshConfig",
    "distributed_strategy.virtual_pipeline_model_parallel_size":
        "trainer/loop.py: check_supported",
}


def jax_read_keys() -> set:
    keys = set()
    for src, pattern, block in JAX_READS:
        keys |= {f"{block}.{k}" for k in re.findall(pattern, src.read_text())}
    return keys


def _present(cfg, dotted: str) -> bool:
    node = cfg
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return False
        node = node[part]
    return True


def test_the_jax_reads_are_found():
    keys = jax_read_keys()
    assert {"exp_manager.log_parameter_norm", "exp_manager.log_gradient_norm",
            "data.io_retries", "data.io_retry_backoff_seconds",
            "model.fusions.flash_block_q", "model.fusions.flash_block_kv"} <= keys


@pytest.mark.parametrize("config", sorted(p.name for p in CONF.glob("*.yaml")))
def test_shipped_config_knobs_are_acted_on_or_logged(config, caplog):
    cfg = t_loader.load_config(CONF / config)
    t_loop._logged_ignored.clear()
    with caplog.at_level(logging.INFO, logger="nxdt.torch.train"):
        t_loop._log_ignored(cfg)
    lines = [r.getMessage() for r in caplog.records if "ignored by this slice" in r.getMessage()]
    logged = set(lines[0].split(": ", 1)[1].split(", ")) if lines else set()
    for key in sorted(jax_read_keys()):
        if _present(cfg, key):
            assert key in ACTED or key in logged, (config, key, sorted(logged))


#: the reads of JAX's GPTConfig.from_config, and the port's GPTConfig
GPT_READS = [(r'm\.get\(\s*"(\w+)"', "model"), (r'fusions\.get\("(\w+)"', "model.fusions"),
             (r'ds\.get\("(\w+)"', "distributed_strategy"),
             (r'\(moe_block or \{\}\)\.get\("(\w+)"', "model.moe")]


def gpt_read_keys(src: Path) -> set:
    text = src.read_text()
    return {f"{block}.{k}" for pattern, block in GPT_READS for k in re.findall(pattern, text)}


@pytest.mark.parametrize("config", sorted(p.name for p in CONF.glob("megatron_*.yaml")))
def test_megatron_config_knobs_are_read_by_the_port_gpt(config, caplog):
    """The seven Megatron GPT configs: each key JAX's ``GPTConfig.from_config``
    reads is read by the port's too (``models/gpt.py``; the Pallas tiles
    ``flash_block_q`` / ``flash_block_kv`` are named in the ignored log
    instead), and the trainer's sweep above holds for them as well."""
    jax_keys = gpt_read_keys(JAX / "models" / "gpt.py")
    port_keys = gpt_read_keys(REPO / "neuronx_distributed_training_torch" / "models" / "gpt.py")
    assert {"model.has_bias", "model.rotary_base", "model.num_moe_experts",
            "model.sliding_window_size", "model.moe.frequency"} <= jax_keys
    cfg = t_loader.load_config(CONF / config)
    t_loop._logged_ignored.clear()
    with caplog.at_level(logging.INFO, logger="nxdt.torch.train"):
        t_loop._log_ignored(cfg)
    lines = [r.getMessage() for r in caplog.records if "ignored by this slice" in r.getMessage()]
    logged = set(lines[0].split(": ", 1)[1].split(", ")) if lines else set()
    for key in sorted(jax_keys):
        if _present(cfg, key):
            assert key in port_keys or key in logged, (config, key)
    assert jax_keys - port_keys <= {"model.fusions.flash_block_q", "model.fusions.flash_block_kv"}


def test_flash_tiles_are_logged_as_ignored(caplog):
    cfg = t_loader.load_config(TINY, {"model.fusions.flash_block_q": 256,
                                      "model.fusions.flash_block_kv": 512})
    t_loop._logged_ignored.clear()
    with caplog.at_level(logging.INFO, logger="nxdt.torch.train"):
        t_loop._log_ignored(cfg)
    msg = next(r.getMessage() for r in caplog.records if "ignored" in r.getMessage())
    assert "model.fusions.flash_block_q" in msg and "model.fusions.flash_block_kv" in msg
    assert "the virtual pipeline" in msg and "distributed_strategy.pipeline" not in msg


def test_norm_logging_and_io_retries_are_acted_on(tmp_path):
    over = {"trainer.max_steps": 2, "exp_manager.exp_dir": str(tmp_path),
            "exp_manager.create_tensorboard_logger": False,
            "exp_manager.checkpoint_callback_params.every_n_train_steps": 0,
            "exp_manager.log_parameter_norm": True, "exp_manager.log_gradient_norm": True,
            "data.io_retries": 7, "data.io_retry_backoff_seconds": 0.125}
    trainer = t_loop.Trainer.from_config(t_loader.load_config(TINY, over), device="cpu",
                                         enable_checkpointing=False)
    assert trainer.data_module.io_retries == 7
    assert trainer.data_module.io_retry_backoff_seconds == 0.125
    hist = trainer.fit()
    for h in hist:
        assert h["gradient_norm"] == h["grad_norm"]
    with torch.no_grad():
        sq = sum(float(torch.sum(torch.square(t.float())))
                 for t in t_llama.named_params(trainer.params).values())
    assert math.isclose(hist[-1]["param_norm"], math.sqrt(sq), rel_tol=1e-6)
    plain = t_loop.Trainer.from_config(
        t_loader.load_config(TINY, {k: v for k, v in over.items() if "norm" not in k}),
        device="cpu", enable_checkpointing=False)
    plain.max_steps = 1
    assert "param_norm" not in plain.fit()[0]


@pytest.mark.parametrize("uri", ["gs://bucket/run", "s3://bucket/run/ckpt"])
def test_remote_checkpoint_dir_is_refused(uri, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="unsupported checkpoint URI scheme"):
        resolve_checkpoint_dir(uri)
    with pytest.raises(ValueError, match=re.escape(repr(uri))):
        Checkpointer(CheckpointConfig(dir=uri))
    assert not any(tmp_path.iterdir())  # no local "gs:" / "s3:" directory
    assert resolve_checkpoint_dir("run/ck") == tmp_path / "run" / "ck"
