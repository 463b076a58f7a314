"""The observability planes ``examples/conf/tiny_smoke_config.yaml`` turns on
(tensorstats, fleet, alerts, control, memory), the port's against the JAX
package's, on the CPU.

- ``tiny_smoke`` on both trainers from the same weights (fp32, 4 steps, a
  ``loss`` alert with ``action: dump`` added to both so a bundle is
  written): the same plane keys in ``metrics.jsonl``, ``tensorstats.jsonl``
  at rtol 1e-5 (histogram counts too), the same ``fleet_summary.json``,
  ``fleet/host_0.jsonl``, ``memory_summary.json`` and ``alert_<step>/``
  layouts, each read unchanged by the repo's stdlib readers
  (``tools/metrics_report.py``, ``fleet_monitor.py``, ``memory_report.py``,
  ``run_ctl.py``, ``anomaly_report.py``), and ``telemetry/
  quant_readiness.py``'s report equal to JAX's on the port's run dir;
- the pieces against JAX's on the same inputs: ``leaf_stats_vec`` (zeros,
  subnormals, inf, NaN; rtol 1e-6), ``decode_cum``, the pprof parser on a
  profile JAX took, the control word and exit codes, the alert engine;
- the port alone: ``tools/run_ctl.py``'s ``checkpoint_now`` / ``dump`` /
  ``stop`` act at the next boundary; an alert ``halt`` stops with its
  reason and JAX's exit code, with and without the control plane; the
  watchdog's hang escape runs its hooks and exits with ``EXIT_HANG_ESCAPE``
  through ``os._exit`` (patched); an OOM escaping the step writes
  ``oom_<step>/``; the memory plane on the CPU logs no ``memory/`` keys and
  attributes the state's storages exactly; a resume that turns tensorstats
  on (JAX's retry text) or off.
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.optim import adamw as t_adamw
from neuronx_distributed_training_torch.telemetry import alerts as t_alerts
from neuronx_distributed_training_torch.telemetry import memory as t_memory
from neuronx_distributed_training_torch.telemetry import quant_readiness as t_qr
from neuronx_distributed_training_torch.telemetry import tensorstats as t_ts
from neuronx_distributed_training_torch.telemetry.flight_recorder import HangWatchdog
from neuronx_distributed_training_torch.tools.convert import params_from_jax
from neuronx_distributed_training_torch.trainer import control as t_control
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.telemetry import alerts as j_alerts
from neuronx_distributed_training_tpu.telemetry import memory as j_memory
from neuronx_distributed_training_tpu.telemetry import quant_readiness as j_qr
from neuronx_distributed_training_tpu.telemetry import tensorstats as j_ts
from neuronx_distributed_training_tpu.trainer import control as j_control

import test_torch_dp as DPT

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "examples" / "conf" / "tiny_smoke_config.yaml"
#: tensorstats.jsonl against JAX's (fp32); a histogram is held on its
#: cumulative counts, to TS_RTOL of the group's count and at least
#: HIST_MOVES values: a gradient within fp32 rounding of a power of two
#: lands in the bin beside JAX's (seen: 1 of ~100k in pre/layers/attn)
TS_RTOL = 1e-5
HIST_MOVES = 2
#: a rule that fires at the first boundary (every loss is >= 0): a bundle
DUMP_RULE = {"name": "loss_seen", "metric": "loss", "threshold": 0.0, "action": "dump"}


def smoke_cfg(tmp, exp, *, steps=4, alerts_extra=(), **telemetry) -> dict:
    cfg = yaml.safe_load(TINY.read_text())
    cfg["trainer"]["max_steps"] = steps
    cfg["precision"] = {"type": "fp32"}
    cfg["model"]["optim"]["sched"]["max_steps"] = steps
    em = cfg["exp_manager"]
    em.update(exp_dir=str(Path(tmp) / exp), create_tensorboard_logger=False)
    em["checkpoint_callback_params"]["every_n_train_steps"] = 0
    tel = em["telemetry"]
    tel["alerts"] = list(tel["alerts"]) + list(alerts_extra)
    tel.update(telemetry)
    return cfg


def _lines(path) -> list:
    return [json.loads(x) for x in Path(path).read_text().splitlines() if x.strip()]


def _run_both(where: Path) -> dict:
    from neuronx_distributed_training_tpu.trainer.loop import Trainer as JTrainer

    cfg = smoke_cfg(where, "jax", alerts_extra=[DUMP_RULE])
    jt = JTrainer.from_config(j_loader.load_config(cfg), devices=jax.devices()[:1],
                              enable_checkpointing=False)
    jparams = jax.tree_util.tree_map(np.asarray, jt.params)
    jt.fit()
    t = t_loop.Trainer.from_config(
        t_loader.load_config(smoke_cfg(where, "port", alerts_extra=[DUMP_RULE])),
        device="cpu", enable_checkpointing=False)
    src = t_llama.named_params(params_from_jax(jparams, device="cpu"))
    with torch.no_grad():
        for n, p in t_llama.named_params(t.params).items():
            p.copy_(src[n])
    t.opt_state = t_adamw.init_opt_state(
        t_llama.named_params(t.params), t.policy, health=True,
        tensorstats=t.exp.telemetry.tensorstats)
    t.fit()
    return {"jax": str(jt.exp.log_dir), "port": str(t.exp.log_dir)}


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    """``tiny_smoke`` on both trainers, once a run for every xdist worker:
    ``{"jax": run dir, "port": run dir}``."""
    return {k: Path(v) for k, v in DPT.shared(tmp_path_factory, "smoke_planes",
                                                _run_both).items()}


def _plane_keys(records) -> set:
    return {k for r in records for k in r
            if k.split("/")[0] in ("tensorstats", "memory", "fleet", "health")}


def test_tiny_smoke_metrics_carry_jax_plane_keys(smoke_runs):
    j, t = (_lines(smoke_runs[k] / "metrics.jsonl") for k in ("jax", "port"))
    assert [r["step"] for r in t] == [r["step"] for r in j] == [1, 2, 3, 4]
    assert _plane_keys(t) == _plane_keys(j)
    assert any(k.startswith("tensorstats/pre/") for k in _plane_keys(t))
    # the CPU reports no allocator stats, in either package
    assert not any(k.startswith("memory/") for k in _plane_keys(t))


def test_tiny_smoke_tensorstats_jsonl_matches_jax(smoke_runs):
    j, t = (_lines(smoke_runs[k] / "tensorstats.jsonl") for k in ("jax", "port"))
    assert [r["step"] for r in t] == [r["step"] for r in j]
    for a, b in zip(t, j):
        assert (a["hist_lo_exp"], a["hist_hi_exp"]) == (b["hist_lo_exp"], b["hist_hi_exp"])
        assert set(a["groups"]) == set(b["groups"])
        assert {g.split("/")[0] for g in a["groups"]} == {"pre", "post"}  # no bucket plan
        for g in a["groups"]:
            x, y = a["groups"][g], b["groups"][g]
            assert set(x) == set(y)
            for k in x:
                if k == "hist":
                    assert sum(x[k]) == sum(y[k]), g
                    moved = np.abs(np.cumsum(x[k]) - np.cumsum(y[k])).max()
                    assert moved <= max(HIST_MOVES, TS_RTOL * x["count"]), (g, moved)
                    continue
                np.testing.assert_allclose(x[k], y[k], rtol=TS_RTOL, atol=0, err_msg=f"{g}/{k}")
    # the last record is run_summary.json's tensorstats section
    ts = json.loads((smoke_runs["port"] / "run_summary.json").read_text())["tensorstats"]
    assert ts == t[-1]


def _keys(path) -> set:
    return set(json.loads(Path(path).read_text()))


def test_tiny_smoke_artifacts_have_jax_layouts(smoke_runs):
    j, t = smoke_runs["jax"], smoke_runs["port"]
    for name in ("fleet_summary.json", "memory_summary.json"):
        assert _keys(t / name) == _keys(j / name), name
    jb, tb = _lines(j / "fleet" / "host_0.jsonl"), _lines(t / "fleet" / "host_0.jsonl")
    assert len(tb) == len(jb) and set(tb[0]) == set(jb[0]) and set(tb[-1]) == set(jb[-1])
    assert tb[-1].get("closing") is True
    jm, tm = (json.loads((d / "memory_summary.json").read_text()) for d in (j, t))
    assert set(tm["profile"]) == set(jm["profile"]) and tm["schema"] == jm["schema"]
    assert tm["window"] == jm["window"]
    assert tm["profiled_step"] in range(1, 1 + tm["window"]["num_steps"])
    # the storages of the state trees, exactly the tree bytes
    assert {c: r["bytes"] for c, r in tm["attribution"].items()} == tm["tree_bytes"]
    ja, ta = sorted(j.glob("alert_*")), sorted(t.glob("alert_*"))
    assert [p.name for p in ta] == [p.name for p in ja] and ta
    assert sorted(p.name for p in ta[0].iterdir()) == sorted(p.name for p in ja[0].iterdir())
    ja_s, ta_s = (json.loads(next(p.glob("*.json")).read_text()) for p in (ja[0], ta[0]))
    assert set(ta_s) <= set(ja_s) | {"rank"} and ta_s["alert"]["rule"] == ja_s["alert"]["rule"]
    sj, st = (json.loads((d / "run_summary.json").read_text()) for d in (j, t))
    assert [a["rule"] for a in st["alerts"]] == [a["rule"] for a in sj["alerts"]]
    assert set(st["fleet"]) == set(sj["fleet"]) and set(st["memory"]) == set(sj["memory"])


@pytest.mark.parametrize("tool,args", [
    ("metrics_report.py", []), ("fleet_monitor.py", ["--json", "-"]),
    ("memory_report.py", ["--json", "-"]), ("run_ctl.py", ["list", "--json", "-"]),
    ("anomaly_report.py", [])])
def test_repo_readers_read_the_port_run_dir(smoke_runs, tool, args):
    target = smoke_runs["port"]
    if tool == "anomaly_report.py":
        target = next(target.glob("alert_*"))
    out = subprocess.run([sys.executable, str(REPO / "tools" / tool), str(target), *args],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    if "--json" in args:
        assert json.loads(out.stdout.strip().splitlines()[-1])
    else:
        assert out.stdout.strip()


def test_quant_readiness_report_equals_jax(smoke_runs):
    loaded = t_qr.load_run_dir(smoke_runs["port"])
    assert loaded == j_qr.load_run_dir(smoke_runs["port"])
    report = t_qr.build_report(**loaded)
    assert report == j_qr.build_report(**loaded)
    assert report["classes"]


# ---------------------------------------------------------------------------
# the pieces against JAX's
# ---------------------------------------------------------------------------


def test_leaf_stats_vec_and_decode_match_jax():
    cfg = t_ts.TensorStatsConfig(enabled=True)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 33)) * np.exp2(rng.integers(-30, 12, (64, 33)))).astype(
        np.float32)
    x[0, :5] = 0.0
    x[2, 0], x[2, 1] = np.inf, -np.inf
    # a subnormal is counted as one (the stats' definition): XLA's CPU
    # backend flushes it to zero first, so JAX is held on normal values only
    sub = x.copy()
    sub[1, :3] = np.float32(1e-40)
    v = t_ts.leaf_stats_vec(torch.from_numpy(sub), cfg)
    assert (float(v[3]), float(v[4])) == (5.0, 3.0)
    for arr in (x, np.where(np.isinf(x), np.float32(np.nan), x)):
        t = t_ts.leaf_stats_vec(torch.from_numpy(arr), cfg).numpy()
        j = np.asarray(j_ts.leaf_stats_vec(arr, j_ts.TensorStatsConfig(enabled=True)))
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
        cum = t_ts.merge_cum(torch.zeros(cfg.vec_len), torch.from_numpy(t))
        jcum = np.asarray(j_ts.merge_cum(np.zeros(cfg.vec_len, np.float32), j))
        np.testing.assert_allclose(cum.numpy(), jcum, rtol=1e-6, atol=0)
        assert t_ts.decode_cum(cum.tolist(), cfg) == j_ts.decode_cum(jcum.tolist(), -24)
    assert t_ts.state_key("pre", "layers/attn") == j_ts.state_key("pre", "layers/attn")


def test_pprof_parser_reads_a_jax_profile_as_jax_does():
    import jax.numpy as jnp

    keep = jnp.ones((256, 256))  # noqa: F841 — a live buffer in the profile
    payload = jax.profiler.device_memory_profile()
    assert t_memory.parse_memory_profile(payload) == j_memory.parse_memory_profile(payload)
    prof = t_memory.parse_memory_profile(payload)
    assert prof["total_bytes"] >= 256 * 256 * 4
    # the port's attribution partitions it too (its rules read torch frames)
    parts = t_memory.attribute_profile(prof)
    assert sum(r["bytes"] for r in parts.values()) == prof["total_bytes"]


def test_control_word_exit_codes_and_alert_engine_are_jax_s(tmp_path):
    assert t_control.CONDITION_BITS == j_control.CONDITION_BITS
    assert t_control.EXIT_CODES == j_control.EXIT_CODES
    for w in (0, 1, 0b1010110, 255):
        assert t_control.words_from_bits(t_control.word_bits(w)) == w
        assert t_control.fold_word_fleet(w) == w  # one process: no collective
        assert t_control.condition_names(w) == j_control.condition_names(w)
    for sc in (None, "preemption", "health_halt", "alert_halt", "data_stall", "max_time"):
        assert t_control.exit_code_for_stop(sc) == j_control.exit_code_for_stop(sc)
    rules = [{"metric": "mfu", "window": 2, "rel_drop": 0.3, "action": "dump"},
             {"metric": "data_wait", "threshold": 1.0, "action": "halt"}]
    te = t_alerts.AlertEngine(t_alerts.parse_alerts(rules))
    je = j_alerts.AlertEngine(j_alerts.parse_alerts(rules))
    stream = [{"mfu": 0.5, "time/data_wait": 0.1}, {"mfu": 0.5}, {"mfu": 0.2},
              {"mfu": 0.1, "time/data_wait": 3.0}, {"mfu": 0.5, "time/data_wait": 0.0}]
    for s, m in enumerate(stream):
        assert [f.to_dict() for f in te.observe(s, m)] == [f.to_dict() for f in je.observe(s, m)]
    rec = t_control.append_command(tmp_path, "checkpoint_now", note="n")
    assert json.loads(t_control.commands_path(tmp_path).read_text())["id"] == rec["id"]


# ---------------------------------------------------------------------------
# the port's planes in its fit loop
# ---------------------------------------------------------------------------


def _port(tmp, exp, *, steps=4, every=0, **kw) -> t_loop.Trainer:
    cfg = smoke_cfg(tmp, exp, steps=steps, **kw)
    cfg["exp_manager"]["checkpoint_callback_params"]["every_n_train_steps"] = every
    cfg["data"]["seq_length"] = 32
    cfg["model"]["max_position_embeddings"] = 32
    return t_loop.Trainer.from_config(t_loader.load_config(cfg), device="cpu")


def test_run_ctl_commands_act_at_the_next_boundary(tmp_path, monkeypatch):
    t = _port(tmp_path, "ctl", steps=6)
    run = Path(t.exp.log_dir)
    for cmd in ("checkpoint_now", "dump"):
        out = subprocess.run([sys.executable, str(REPO / "tools" / "run_ctl.py"), str(run), cmd],
                             capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
    dispatch = t_loop.Trainer._dispatch

    def stop_at_3(self, batch, index):
        if index == 3:
            t_control.append_command(run, "stop", note="operator")
        return dispatch(self, batch, index)

    monkeypatch.setattr(t_loop.Trainer, "_dispatch", stop_at_3)
    history = t.fit()
    # checkpoint_now at the first boundary (step 1), the stop at step 4's
    assert [h["step"] for h in history] == [0, 1, 2, 3]
    assert t.checkpointer.committed_steps == [1, 4]
    assert t.stop_class == "operator_stop"
    assert t_control.exit_code_for_stop(t.stop_class) == 0
    assert sorted(p.name for p in run.glob("control_*")) == ["control_00000001"]
    trail = json.loads((run / "run_summary.json").read_text())["control"]
    assert [(c["command"], c["status"], c["step"]) for c in trail["commands"]] == [
        ("checkpoint_now", "accepted", 1), ("dump", "accepted", 1), ("stop", "accepted", 4)]
    assert trail["decisions"][-1]["stop"] and trail["decisions"][-1]["source"] == "operator"


@pytest.mark.parametrize("control", [False, True], ids=["local", "control"])
def test_alert_halt_stops_with_its_reason_and_exit_code(tmp_path, control):
    rule = {"name": "loss_high", "metric": "loss", "threshold": 0.0, "action": "halt"}
    t = _port(tmp_path, "halt", steps=5, alerts_extra=[rule],
              control={"enabled": control})
    history = t.fit()
    assert [h["step"] for h in history] == [0]  # halted at the first boundary
    assert t.stop_class == "alert_halt" and t.checkpointer.committed_steps == [1]
    assert t_control.exit_code_for_stop(t.stop_class) == t_control.EXIT_ALERT_HALT == 87
    summary = json.loads((Path(t.exp.log_dir) / "run_summary.json").read_text())
    assert summary["stop_reason"].startswith("alert loss_high")
    assert summary["alerts"][0]["rule"] == "loss_high"


def test_hang_escape_runs_its_hooks_and_exits_tagged(tmp_path, monkeypatch):
    codes = []
    monkeypatch.setattr(os, "_exit", codes.append)
    dispatch = t_loop.Trainer._dispatch

    def slow_first(self, batch, index):
        if index == 0:
            import time

            time.sleep(2.5)
        return dispatch(self, batch, index)

    monkeypatch.setattr(t_loop.Trainer, "_dispatch", slow_first)
    t = _port(tmp_path, "hang", steps=2,
              health={"enabled": True, "policy": "skip_update", "watchdog_timeout_seconds": 1})
    t.fit()
    assert codes == [t_control.EXIT_HANG_ESCAPE] == [83]
    run = Path(t.exp.log_dir)
    decisions = json.loads((run / "run_summary.json").read_text())["control"]["decisions"]
    assert decisions[0]["conditions"] == ["hang_escape"] and decisions[0]["exit"]
    assert "first_step" in decisions[0]["reason"]
    assert any("hang escape" in str(r.get("last_exception")) for r in
               _lines(run / "fleet" / "host_0.jsonl"))
    assert list(run.glob("hang_*"))
    # the seam itself: hooks, then the code, whatever abort says
    calls = []
    wd = HangWatchdog(5.0, None, abort=False)
    wd._exit_fn = lambda code: calls.append(("exit", code))
    wd.arm_escape(83, lambda what, step: calls.append((what, step)))
    wd._fire("host_sync", 7)
    assert calls == [("host_sync", 7), ("exit", 83)]


def test_oom_escaping_the_step_writes_a_bundle(tmp_path, monkeypatch):
    dispatch = t_loop.Trainer._dispatch

    def oom_at_2(self, batch, index):
        if index == 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return dispatch(self, batch, index)

    monkeypatch.setattr(t_loop.Trainer, "_dispatch", oom_at_2)
    t = _port(tmp_path, "oom", steps=4)
    with pytest.raises(torch.OutOfMemoryError):
        t.fit()
    run = Path(t.exp.log_dir)
    bundle = run / "oom_00000002"
    assert sorted(p.name for p in bundle.iterdir()) == ["oom.json", "samples.json"]
    oom = json.loads((bundle / "oom.json").read_text())
    assert oom["kind"] == "oom" and oom["step"] == 2 and "out of memory" in oom["error"]
    assert set(oom["attribution_at_death"]) == {"params", "opt_state"}
    assert json.loads((run / "run_summary.json").read_text())["oom"]["bundle"] == bundle.name
    assert t_memory.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: x"))
    assert not t_memory.is_oom_error(ValueError("shape"))


def test_memory_plane_on_the_cpu(tmp_path):
    t = _port(tmp_path, "mem", steps=3)
    history = t.fit()
    assert not any(k.startswith("memory/") for h in history for k in h)
    s = t_memory.load_memory_summary(t.exp.log_dir)
    assert s["tree_bytes"] == t_memory.tree_bytes_by_subsystem(t.params, t.opt_state)
    cats, peak = t_memory.measured_hbm_categories(s)
    assert cats == j_memory.measured_hbm_categories(s)[0] and peak == s["profile"]["total_bytes"]
    assert t_memory.is_memory_summary(s)


def test_tensorstats_turned_on_or_off_at_resume(tmp_path, caplog):
    def trainer(steps, on):
        cfg = smoke_cfg(tmp_path, "ts", steps=steps)
        cfg["exp_manager"]["resume_if_exists"] = True
        cfg["exp_manager"]["checkpoint_callback_params"]["every_n_train_steps"] = 2
        cfg["data"]["seq_length"] = 32
        cfg["model"]["max_position_embeddings"] = 32
        cfg["exp_manager"]["telemetry"]["tensorstats"]["enabled"] = on
        return t_loop.Trainer.from_config(t_loader.load_config(cfg), device="cpu")

    trainer(2, False).fit()  # a save without the record
    on = trainer(3, True)
    with caplog.at_level("INFO"):
        history = on.fit()
    assert [h["step"] for h in history] == [2]
    msgs = [r.getMessage() for r in caplog.records]
    assert any("retrying without the telemetry tensorstats subtree(s)" in m for m in msgs)
    assert any("predates telemetry tensorstats" in m for m in msgs)
    assert int(on.opt_state["tensorstats"]["steps"]) == 1  # the record starts fresh
    # a save that holds the record resumes with tensorstats off
    back = trainer(4, False)
    assert [h["step"] for h in back.fit()] == [3] and "tensorstats" not in back.opt_state
