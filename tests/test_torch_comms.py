"""The port's comms plane (``telemetry/comms.py``, ``tools/comms_bench.py``,
``tools/comms_report.py``, the trainer's bandwidth join) and
``tools/quant_readiness.py`` against the JAX package's.

- Every copied pure function of ``telemetry/comms.py`` gives JAX's output
  on the same seeded inputs (the bus math, the section and its metrics,
  the alert rule, which the port's ``AlertRule.from_config`` accepts, the
  fit, the skew findings, the summary and its I/O, the bench facts).
- ``comms_bench --smoke`` on four gloo ranks (dp 2 x tp 2, two tiny sizes)
  writes a summary JAX's and the port's ``comms_calibration_from_summary``
  read to the same ratios, and its JSON line gives equal perf facts in both
  packages.
- One ``tiny_smoke`` run at dp 2 on two gloo ranks under torchrun with a
  trace window: its ``trace_summary.json`` carries a ``comms`` section equal
  to JAX's ``comms_section`` on JAX's own cost-model facts and the port's
  measured classes (also in ``run_summary.json`` and as ``comms/*``
  metrics); ``perf_facts_from_run`` of the run dir is equal in both
  packages; the port's and the repo's ``comms_report`` and
  ``quant_readiness`` give equal output on it.
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from neuronx_distributed_training_tpu.analysis import perf_contract as j_pc
from neuronx_distributed_training_tpu.autotune import cost_model as j_cm
from neuronx_distributed_training_tpu.autotune import topology as j_topo
from neuronx_distributed_training_tpu.config.loader import load_config as j_load
from neuronx_distributed_training_tpu.telemetry import comms as j_comms

from neuronx_distributed_training_torch.analysis import perf_contract as t_pc
from neuronx_distributed_training_torch.autotune import cost_model as t_cm
from neuronx_distributed_training_torch.telemetry import comms as t_comms
from neuronx_distributed_training_torch.telemetry.alerts import AlertRule
from neuronx_distributed_training_torch.telemetry.trace_analysis import COLLECTIVE_KINDS

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "examples" / "conf" / "tiny_smoke_config.yaml"
SEEDS = (0, 1, 2)
TIMEOUT = 600


def _env() -> dict:
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]))
    return env


# ---------------------------------------------------------------------------
# the pure functions, on seeded inputs
# ---------------------------------------------------------------------------


def test_vocabulary_is_jaxs():
    assert t_comms.COMMS_KINDS == j_comms.COMMS_KINDS == COLLECTIVE_KINDS
    assert t_comms.AXIS_TO_MESH == j_comms.AXIS_TO_MESH
    assert t_comms.MESH_TO_AXIS == j_comms.MESH_TO_AXIS
    assert t_comms.SKEW_REL_THRESHOLD == j_comms.SKEW_REL_THRESHOLD
    assert t_comms.COMMS_SUMMARY_NAME == j_comms.COMMS_SUMMARY_NAME


@pytest.mark.parametrize("seed", SEEDS)
def test_bus_math_is_jaxs(seed):
    rng = np.random.RandomState(seed)
    for kind in t_comms.COMMS_KINDS:
        for _ in range(8):
            b, n = float(rng.uniform(0, 1e9)), int(rng.randint(0, 17))
            assert t_comms.bus_bytes(kind, b, n) == j_comms.bus_bytes(kind, b, n)
            assert t_comms.ring_hops(kind, n) == j_comms.ring_hops(kind, n)
    for mod in (t_comms, j_comms):
        with pytest.raises(ValueError):
            mod.bus_bytes("broadcast", 8.0, 4)


def _volumes(rng) -> tuple[dict, dict]:
    vols = {axis: {k: float(rng.uniform(1e3, 1e9)) for k in
                   rng.choice(t_comms.COMMS_KINDS, rng.randint(1, 4), replace=False)}
            for axis in ("tp", "dp", "pp", "cp", "ep") if rng.rand() < 0.8}
    sizes = {axis: int(rng.randint(1, 9)) for axis in vols}
    return vols, sizes


@pytest.mark.parametrize("seed", SEEDS)
def test_section_and_metrics_are_jaxs(seed):
    rng = np.random.RandomState(seed)
    vols, sizes = _volumes(rng)
    assert t_comms.class_bus_bytes_per_step(vols, sizes) == \
        j_comms.class_bus_bytes_per_step(vols, sizes)
    by_class = {k: {"wire_seconds": float(rng.uniform(0, 0.5)) if rng.rand() < 0.8 else 0.0,
                    "count": int(rng.randint(1, 100))} for k in t_comms.COMMS_KINDS}
    facts = {"byte_volumes": vols, "axis_sizes": sizes, "topology": "h100",
             "peak_bandwidth_bytes": 360e9 if seed else 0.0}
    for steps in (0, 1, 3):
        t = t_comms.comms_section(facts, by_class, window_steps=steps)
        assert t == j_comms.comms_section(facts, by_class, window_steps=steps)
        assert t_comms.comms_metrics(t) == j_comms.comms_metrics(t)
    assert t_comms.comms_section({}, by_class, window_steps=2) is None


def test_degraded_link_rule_is_jaxs_and_validates():
    for kw in ({}, {"kind": "all-reduce", "window": 5, "rel_drop": 0.3, "action": "halt"}):
        rule = t_comms.degraded_link_alert_rule(**kw)
        assert rule == j_comms.degraded_link_alert_rule(**kw)
        parsed = AlertRule.from_config(rule)
        assert parsed.metric == rule["metric"] and parsed.rel_drop == rule["rel_drop"]


@pytest.mark.parametrize("seed", SEEDS)
def test_fit_skew_and_summary_are_jaxs(seed, tmp_path):
    rng = np.random.RandomState(seed)
    bw, lat = float(rng.uniform(1e9, 4e11)), float(rng.uniform(1e-6, 1e-4))
    results = {}
    for axis, n in (("dp", 4), ("tp", 2), ("pp", 2)):
        rows = []
        for kind in ("all-reduce", "all-gather", "collective-permute"):
            for size in (1 << 16, 1 << 20, 1 << 24):
                bb = t_comms.bus_bytes(kind, size, n)
                hops = t_comms.ring_hops(kind, n)
                t = (bb / bw + hops * lat) * float(rng.uniform(0.9, 1.1))
                rows.append({"collective": kind, "payload_bytes": size, "bus_bytes": bb,
                             "hops": hops, "seconds_median": t, "seconds_min": t,
                             "reps": 3, "bus_gbps": bb / t / 1e9})
        results[axis] = {"mesh_axis": t_comms.AXIS_TO_MESH[axis], "size": n, "sweep": rows}
        pts = [{"bus_bytes": r["bus_bytes"], "hops": r["hops"], "seconds": r["seconds_median"]}
               for r in rows]
        assert t_comms.fit_axis_bandwidth(pts) == j_comms.fit_axis_bandwidth(pts)
        assert t_comms.fit_axis_bandwidth(pts[:1]) == j_comms.fit_axis_bandwidth(pts[:1])
    assert t_comms.fit_axis_bandwidth([]) is None and j_comms.fit_axis_bandwidth([]) is None
    skew = {str(i): float(rng.uniform(1e-4, 2e-4)) for i in range(8)}
    skew["5"] = skew["5"] * 4  # a slow device
    t_f, j_f = t_comms.skew_findings(skew), j_comms.skew_findings(skew)
    assert t_f == j_f and [f["device"] for f in t_f] == ["5"]
    kw = dict(topology_name="h100", prior_bandwidth_bytes=360e9, prior_latency_seconds=5e-6,
              device_skew=skew)
    t_s = t_comms.build_comms_summary(results, **kw)
    assert t_s == j_comms.build_comms_summary(results, **kw)
    assert t_comms.is_comms_summary(t_s) and j_comms.is_comms_summary(t_s)
    assert t_comms.bench_comms_facts(t_s) == j_comms.bench_comms_facts(t_s)
    # the byte-stable write, read back by both loaders
    t_comms.write_comms_summary(t_s, tmp_path / "t.json")
    j_comms.write_comms_summary(t_s, tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert t_comms.load_comms_summary(tmp_path / "t.json") == \
        j_comms.load_comms_summary(tmp_path / "t.json") == json.loads(json.dumps(t_s))
    for bad in (tmp_path / "missing.json", tmp_path):
        with pytest.raises(ValueError):
            t_comms.load_comms_summary(bad)


# ---------------------------------------------------------------------------
# comms_bench on four gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comms_bench")
    cmd = [sys.executable, "-m", "neuronx_distributed_training_torch.tools.comms_bench",
           "--device", "cpu", "--devices", "4", "--tp", "2", "--pp", "1", "--smoke",
           "--out", str(tmp), "--json", "-"]
    out = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    return tmp / "comms_summary.json", json.loads(out.stdout.strip().splitlines()[-1])


def test_comms_bench_summary_calibrates_as_in_jax(bench):
    path, line = bench
    doc = json.loads(path.read_text())
    assert doc["kind"] == "comms_summary" and doc["topology"] == "cpu"
    assert {a: (e["mesh_axis"], e["size"]) for a, e in doc["axes"].items()} == \
        {"dp": ("data", 2), "tp": ("model", 2)}
    for entry in doc["axes"].values():
        assert [r["payload_bytes"] for r in entry["sweep"]] == [1 << 16, 1 << 18] * 3
        assert entry["fit"]["bandwidth_bytes_per_s"] > 0
    assert doc["device_skew"]["per_device"].keys() == {"0", "1", "2", "3"}
    t = t_cm.comms_calibration_from_summary(path)
    assert t == j_cm.comms_calibration_from_summary(path) and set(t) >= {"dp", "tp"}
    # the JSON line: JAX's metric and facts, and a perf-contract verdict
    assert line["metric"] == "comms_bench_sweep" and line["device"] == "cpu"
    assert line["mesh"] == {"data": 2, "model": 2}
    assert line["comms"] == t_comms.bench_comms_facts(doc)
    assert t_pc.perf_facts_from_bench(line) == j_pc.perf_facts_from_bench(line)
    assert t_pc.default_key(t_pc.perf_facts_from_bench(line)) == "cpu_comms"
    assert line["perf_contract"]["key"] == "cpu_comms" and line["perf_contract"]["verdict"]


def test_comms_bench_refuses_one_card_and_a_bad_mesh(tmp_path):
    from neuronx_distributed_training_torch.tools import comms_bench

    if not __import__("torch").cuda.is_available():
        assert comms_bench.main(["--out", str(tmp_path)]) == 2
    out = subprocess.run([sys.executable, "-m",
                          "neuronx_distributed_training_torch.tools.comms_bench", "--device",
                          "cpu", "--devices", "2", "--tp", "4", "--pp", "1", "--smoke",
                          "--out", str(tmp_path), "--json", "-", "--no-skew"],
                         cwd=REPO, env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 2 and "mesh build failed for 2 ranks" in out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["perf_contract"] == {
        "verdict": "no_measurement"}


# ---------------------------------------------------------------------------
# tiny_smoke at dp 2 with a trace window: the in-loop join and the run dir
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dp2_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp2_trace")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "neuronx_distributed_training_torch.trainer.cli",
           "--config", str(TINY), "--device", "cpu", "--set", "trainer.max_steps=4",
           "--set", "exp_manager.checkpoint_callback_params.every_n_train_steps=0",
           "--set", f"exp_manager.exp_dir={tmp}",
           "--set", "exp_manager.create_tensorboard_logger=false",
           "--set", "exp_manager.telemetry.trace={enabled: true, start_step: 1, num_steps: 2}"]
    out = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    return next(tmp.glob("*/version_0"))


def test_dp2_trace_run_agrees_with_jax(dp2_run, capsys):
    """One test over the run (a module fixture split across xdist workers
    would run the torchrun job once a worker)."""
    _comms_section_is_jaxs(dp2_run)
    _perf_facts_are_jaxs(dp2_run)
    _tools_equal_the_repos(dp2_run, capsys)


def _comms_section_is_jaxs(dp2_run):
    summary = json.loads((dp2_run / "trace_summary.json").read_text())
    cfg = j_load(str(TINY))
    facts = j_cm.ModelFacts.from_config(cfg)
    topo = j_topo.resolve_topology("cpu")
    jfacts = {"byte_volumes": j_cm.collective_byte_volumes(facts, facts.declared_plan_for(2)),
              "axis_sizes": {"dp": 2, "tp": 1, "pp": 1, "cp": 1, "ep": 1},
              "peak_bandwidth_bytes": topo.ici_bandwidth_bytes, "topology": topo.name}
    want = j_comms.comms_section(jfacts, summary["overlap_by_class"],
                                 window_steps=summary["window"]["num_steps"])
    assert want and "all-gather" in want["classes"]  # ZeRO-1's bucketed gathers
    assert summary["comms"] == want
    run = json.loads((dp2_run / "run_summary.json").read_text())
    assert run["comms"] == want
    metrics = [json.loads(x) for x in (dp2_run / "metrics.jsonl").read_text().splitlines()]
    assert any(m.get("comms/all-gather/achieved_gbps") ==
               want["classes"]["all-gather"]["achieved_gbps"] for m in metrics)


def _perf_facts_are_jaxs(dp2_run):
    t, j = t_pc.perf_facts_from_run(dp2_run), j_pc.perf_facts_from_run(dp2_run)
    assert t == j and t["step_time_ms"] > 0 and t["comms"]["classes"]
    assert t_pc.load_facts(dp2_run) == j_pc.load_facts(dp2_run)
    assert t_pc.default_key(t) == j_pc.default_key(j) == "llamaconfig_run"
    assert t_pc.default_key(t, "cpu") == "cpu_run"


def _repo_tool(name: str, *args) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, str(REPO / "tools" / f"{name}.py"), *args],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=TIMEOUT)


def _port_tool(main, argv, capsys) -> tuple:
    code = main(argv)
    return code, capsys.readouterr().out


def _tools_equal_the_repos(dp2_run, capsys):
    from neuronx_distributed_training_torch.tools import comms_report, quant_readiness

    args = [str(dp2_run), "--config", str(TINY), "--chips", "2", "--json", "-"]
    code, out = _port_tool(quant_readiness.main, args, capsys)
    repo = _repo_tool("quant_readiness", *args)
    assert code == repo.returncode == 0, repo.stderr[-2000:]
    t, j = json.loads(out.strip().splitlines()[-1]), json.loads(
        repo.stdout.strip().splitlines()[-1])
    assert t == j and t["ok"] and t["classes"]
    # ZeRO-1 at dp 2: the cost model prices the gathers (and JAX's
    # reduce-scatters), and the join's measured wire rate prices the saving
    assert t["classes"]["all-gather"]["bytes_per_step"] > 0
    assert t["classes"]["all-gather"]["savings_source"] == "measured_wire_rate"
    code, out = _port_tool(comms_report.main, [str(dp2_run), "--json", "-"], capsys)
    repo = _repo_tool("comms_report", str(dp2_run), "--json", "-")
    assert code == repo.returncode == 0 and out == repo.stdout


def test_comms_report_renders_a_summary_as_the_repos(tmp_path, capsys):
    from neuronx_distributed_training_torch.tools import comms_report

    rows = [{"collective": "all-reduce", "payload_bytes": 1 << 20, "bus_bytes": 1048576.0,
             "hops": 2, "seconds_median": 1e-4, "seconds_min": 9e-5, "reps": 3,
             "bus_gbps": 10.48576}]
    doc = t_comms.build_comms_summary(
        {"dp": {"mesh_axis": "data", "size": 2, "sweep": copy.deepcopy(rows)}},
        topology_name="h100", prior_bandwidth_bytes=360e9, prior_latency_seconds=5e-6,
        device_skew={"0": 1e-4, "1": 1e-4, "2": 5e-4})
    t_comms.write_comms_summary(doc, tmp_path / "comms_summary.json")
    code, out = _port_tool(comms_report.main, [str(tmp_path)], capsys)
    repo = _repo_tool("comms_report", str(tmp_path))
    assert code == repo.returncode == 0 and out == repo.stdout
    assert "FINDING [degraded_link]" in out
