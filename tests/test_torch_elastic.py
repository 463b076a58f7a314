"""The port's elastic resume (``trainer/elastic.py``, the manifest item of
``checkpoint/``) against the JAX package's.

- ``ElasticConfig``'s values and error texts are JAX's; the save retries
  come from it (``exp_manager.elastic``), and a save makes that many
  attempts without a process group.
- ``build_manifest``'s fields equal JAX's for the same config on the same
  mesh (one device; dp 2 x tp 2 on four); every save writes it as
  ``manifest.json``, read back without templates and covered by the
  sidecar: a changed byte fails the step's verification.
- The drill (``tools/elastic_drill.py``): a dp 2 run over gloo killed at
  step 3, resumed on one rank through the CLI's replan; the resumed losses
  within the pin of the control's, and the replan's record and chosen plan
  those of JAX's ``maybe_replan`` on the same config and manifest.  A
  SIGTERM at the save phase with the same world: no replan, the resumed
  steps bit for bit the control's.
- The refusals (a different model, a layout no plan keeps) carry JAX's
  texts; ``FaultInjector`` fires once, at its phase and step, in each mode.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from neuronx_distributed_training_tpu.config.loader import load_config as j_load
from neuronx_distributed_training_tpu.trainer import elastic as j_el

from neuronx_distributed_training_torch.checkpoint import integrity as t_integrity
from neuronx_distributed_training_torch.checkpoint import manager as t_manager
from neuronx_distributed_training_torch.config.loader import load_config as t_load
from neuronx_distributed_training_torch.tools import elastic_drill as t_drill
from neuronx_distributed_training_torch.trainer import cli as t_cli
from neuronx_distributed_training_torch.trainer import elastic as t_el
from neuronx_distributed_training_torch.trainer import loop as t_loop

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "examples" / "conf" / "tiny_smoke_config.yaml"


@pytest.mark.parametrize("block", [
    None, True, False, {}, {"enabled": True, "replan_top_k": 3, "grace_period_seconds": 5},
    {"grace_period": 3}, {"save_retries": 1.5}, {"grace_period_seconds": -1.0}, "on",
    {"replan_top_k": 0}, {"replan_audit": "yes"}, {"save_retries": True}])
def test_elastic_config_is_jaxs(block):
    try:
        want = dataclasses.asdict(j_el.ElasticConfig.from_config(block))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_el.ElasticConfig.from_config(block)
        assert str(got.value) == str(e)
        return
    assert dataclasses.asdict(t_el.ElasticConfig.from_config(block)) == want


def test_save_retry_knobs_come_from_the_elastic_block(tmp_path, monkeypatch):
    import torch.distributed.checkpoint as dcp

    cfg = t_load(TINY, {"exp_manager.exp_dir": str(tmp_path),
                        "exp_manager.elastic": {"save_retries": 1,
                                                "save_retry_backoff_seconds": 0.01}})
    ck_cfg = dataclasses.replace(t_manager.CheckpointConfig.from_config(cfg), dir=tmp_path,
                                 async_save=False)
    assert (ck_cfg.save_retries, ck_cfg.save_retry_backoff_seconds) == (1, 0.01)
    assert t_manager.CheckpointConfig().save_retries is None  # the module default
    real, calls = dcp.save, {"n": 0, "fails": 1}

    def flaky(*a, no_dist=False, **k):
        calls["n"] += 1
        if calls["n"] <= calls["fails"]:
            raise OSError(28, "No space left on device")
        return real(*a, no_dist=no_dist, **k)

    p = {"w": torch.ones(4, 4)}
    o = {"step": torch.zeros((), dtype=torch.int64), "mu": {"w": torch.zeros(4, 4)},
         "nu": {"w": torch.zeros(4, 4)}}
    ck = t_manager.Checkpointer(ck_cfg)
    monkeypatch.setattr(dcp, "save", flaky)
    assert ck.save_with_retry(t_manager.TrainState(p, o, 1, 8))  # one retry: enough
    calls.update(n=0, fails=2)
    with pytest.raises(OSError, match="No space"):
        ck.save_with_retry(t_manager.TrainState(p, o, 2, 8))  # two failures: past the knob
    assert calls["n"] == 2 and ck.all_steps() == [1]
    ck.close()


@pytest.mark.parametrize("ov,n,axes", [
    ({}, 1, {"pipe": 1, "data": 1, "expert": 1, "context": 1, "model": 1}),
    ({"distributed_strategy.tensor_model_parallel_size": 2,
      "distributed_strategy.sequence_parallel": True}, 4,
     {"pipe": 1, "data": 2, "expert": 1, "context": 1, "model": 2}),
])
def test_manifest_fields_are_jaxs(ov, n, axes):
    import jax

    from neuronx_distributed_training_tpu.parallel.mesh import MeshConfig, build_mesh

    jcfg, tcfg = j_load(str(TINY), ov), t_load(TINY, ov)
    mesh = build_mesh(MeshConfig.from_config(jcfg["distributed_strategy"]),
                      devices=jax.devices()[:n])
    want = j_el.build_manifest(jcfg, mesh, step=7, schedule=None, model_family="LlamaConfig",
                               save_bf16=False)
    got = t_el.build_manifest(tcfg, axes, step=7, schedule=None, model_family="LlamaConfig",
                              save_bf16=False)
    assert got == want


def test_every_save_carries_a_verified_manifest(tmp_path):
    t_loop._logged_ignored.clear()
    trainer = t_cli.build(["--config", str(TINY), "--device", "cpu",
                           "--set", "trainer.max_steps=2",
                           "--set", f"exp_manager.exp_dir={tmp_path}",
                           "--set", "exp_manager.create_tensorboard_logger=false"])
    trainer.fit()
    ck = trainer.checkpointer
    manifest = ck.read_manifest()
    assert manifest == t_el.build_manifest(trainer.cfg, trainer.mesh_axes, step=2,
                                           schedule=None, model_family="LlamaConfig",
                                           save_bf16=False)
    assert manifest["world_size"] == 1 and manifest["plan"]["dp"] == 1
    sidecar = t_integrity.read_sidecar(ck.directory, 2)
    assert sidecar["manifest_digest"] == t_integrity.json_digest(manifest)
    assert t_el.read_latest_manifest(ck.directory) == manifest
    assert ck.verify_step(2).status == "ok"
    path = ck.directory / "2" / t_manager.MANIFEST_NAME
    path.write_text(path.read_text().replace('"world_size": 1', '"world_size": 2'))
    v = ck.verify_step(2)
    assert v.status == "corrupt" and any("manifest: digest mismatch" in f for f in v.failures)
    assert t_manager.Checkpointer(t_manager.CheckpointConfig(dir=tmp_path / "none")) \
        .read_manifest() is None


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """dp 2 over gloo killed at step 3, resumed on one rank (the replan)."""
    work = tmp_path_factory.mktemp("drill")
    return work, t_drill.run_drill(work, world=2, resume_world=1, at_step=3, phase="step",
                                   mode="kill", device="cpu")


def test_drill_kill_dp2_resumes_on_one_rank(drill):
    _, rep = drill
    assert rep["ok"], rep["problems"]
    assert rep["faulted"]["killed"] and rep["faulted"]["committed"] == [2]
    assert rep["resumed"]["step"] == 6 and rep["max_gap"] <= t_drill.DEFAULT_LOSS_TOL
    rec = rep["resumed"]["replan"]
    assert (rec["old_world"], rec["new_world"], rec["checkpoint_step"]) == (2, 1, 2)


def test_replan_record_is_jaxs(drill, monkeypatch):
    work, rep = drill
    raw = t_drill.tiny_llama_config(work / "exp", name="drill", max_steps=6, save_every=2)
    ck_dir = work / "exp" / "drill" / "version_0" / "checkpoints"
    # the faulted dp 2 run's step-2 save (retention has dropped it since)
    manifest = t_el.build_manifest(t_load(raw), {"pipe": 1, "data": 2, "expert": 1,
                                                 "context": 1, "model": 1},
                                   step=2, schedule=None, model_family="LlamaConfig",
                                   save_bf16=False)
    monkeypatch.setattr(j_el, "discover_checkpoint_dir", lambda cfg: ck_dir)
    monkeypatch.setattr(j_el, "read_latest_manifest", lambda d, **k: manifest)
    want = j_el.maybe_replan(j_load(raw), 1)
    got = dict(rep["resumed"]["replan"])
    for r in (got, want.record):
        r.pop("replan_seconds")
    assert got == json.loads(json.dumps(want.record))


def _refusal(module, load, raw, chips, manifest, monkeypatch, tmp_path, **kw):
    monkeypatch.setattr(module, "discover_checkpoint_dir", lambda cfg: tmp_path)
    monkeypatch.setattr(module, "read_latest_manifest", lambda d, **k: manifest)
    with pytest.raises(module.ElasticResumeError) as e:
        module.maybe_replan(load(raw), chips, **kw)
    return str(e.value)


def test_refusal_texts_are_jaxs(tmp_path, monkeypatch):
    raw = t_drill.tiny_llama_config(tmp_path, max_steps=4)
    base = {"world_size": 4, "step": 2, "model": {"num_layers": 2, "hidden_size": 64,
                                                  "vocab_size": 128},
            "plan": {"pp": 1, "vp": 1, "dp": 4, "tp": 1}, "layer_layout": "flat"}
    other = dict(base, model={"num_layers": 3, "hidden_size": 64, "vocab_size": 128})
    # a layout no plan at one chip keeps: the layers saved in 2 stages
    staged = dict(base, plan={"pp": 2, "vp": 1, "dp": 2, "tp": 1})
    for manifest, want in ((other, "not the same model"),
                           (staged, "no plan for 1 chips keeps the checkpoint's layer layout")):
        t = _refusal(t_el, t_load, raw, 1, manifest, monkeypatch, tmp_path, device="cpu")
        j = _refusal(j_el, j_load, raw, 1, manifest, monkeypatch, tmp_path)
        assert t == j and want in t


def test_fault_injector_is_jaxs():
    for kw in ({"at_step": 1, "mode": "nope"}, {"at_step": 1, "phase": "nope"}):
        with pytest.raises(ValueError) as je:
            j_el.FaultInjector(**kw)
        with pytest.raises(ValueError) as te:
            t_el.FaultInjector(**kw)
        assert str(te.value) == str(je.value)
    inj = t_el.FaultInjector(at_step=2, mode="sigterm", phase="save")
    assert not inj.maybe_fire("step", 5) and not inj.maybe_fire("save", 1)
    assert inj.maybe_fire("save", 2) and not inj.maybe_fire("save", 3)
    with pytest.raises(t_el.SimulatedPreemption, match="injected step kill at step 4"):
        t_el.FaultInjector(at_step=3).maybe_fire("step", 4)
    from neuronx_distributed_training_torch.telemetry.memory import is_oom_error

    with pytest.raises(t_el.SimulatedOOM) as e:
        t_el.FaultInjector(at_step=0, mode="oom").maybe_fire("step", 0)
    assert is_oom_error(e.value)


def test_sigterm_injection_takes_the_grace_window_save(tmp_path):
    """In process: a preemption notice before step index 1 stops after it
    with one drained save carrying the manifest, and run_summary.json's
    elastic section records why."""
    t_loop._logged_ignored.clear()
    trainer = t_cli.build(["--config", str(TINY), "--device", "cpu",
                           "--set", "trainer.max_steps=4",
                           "--set", f"exp_manager.exp_dir={tmp_path}",
                           "--set", "exp_manager.create_tensorboard_logger=false",
                           "--set", "exp_manager.elastic.grace_period_seconds=60"])
    trainer.fault_injector = t_el.FaultInjector(at_step=1, mode="sigterm")
    history = trainer.fit()
    assert len(history) == 2 and trainer.stop_class == "preemption"
    assert trainer.checkpointer.committed_steps == [2]
    assert trainer.checkpointer.read_manifest(2)["step"] == 2
    run = json.loads((Path(trainer.exp.log_dir) / "run_summary.json").read_text())
    assert run["elastic"]["stop_reason"] == "injected preemption notice"
    assert run["elastic"]["stop_class"] == "preemption" and not run["elastic"]["resumed"]
