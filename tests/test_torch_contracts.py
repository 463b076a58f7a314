"""The port's perf and graph contracts (``analysis/perf_contract.py``,
``analysis/graph_contract.py``, their tools) against the JAX package's.

- The perf contract's copied functions give JAX's output on the same seeded
  facts: the extraction from a JSON line and a trace summary, every PC rule
  of ``diff_facts`` (exact rule IDs, severities, messages and hints), the
  calibration and sweep gates on fixture facts (PC203, PC302, PC303,
  PC502), ``residual_report``, ``default_key``, the ratchet's files (byte
  for byte) and ``bench_verdict``.
- The graph contract's copied functions likewise: ``declared_source_classes``
  has JAX's labels, kinds, hints and source-predicate slots for every
  shipped config; ``attribution_report`` and ``diff_fingerprint`` give
  JAX's findings on seeded fingerprints and their mutations; the census's
  ranks name JAX's mesh axes.
- The ratchets' cases: write then check, growth refused without a
  justification and recorded with one, an unattributed collective refused
  without a waiver, byte-stable files, one section per audit device.
- Every committed contract (one per shipped config) and baseline loads and
  names its config or key.

The live checks (a step's fingerprint against its committed contract, the
attributed labels against JAX's) ride ``tests/test_torch_audit.py``'s gloo
audits.
"""

import copy
import dataclasses
import glob
import json
from pathlib import Path

import numpy as np
import pytest

from neuronx_distributed_training_tpu.analysis import graph_contract as j_gc
from neuronx_distributed_training_tpu.analysis import perf_contract as j_pc

from neuronx_distributed_training_torch.analysis import graph_audit as t_ga
from neuronx_distributed_training_torch.analysis import graph_contract as t_gc
from neuronx_distributed_training_torch.analysis import perf_contract as t_pc
from neuronx_distributed_training_torch.config.loader import batch_schedule
from neuronx_distributed_training_torch.config.loader import load_config as t_load
from neuronx_distributed_training_torch.telemetry import census as t_census

REPO = Path(__file__).resolve().parents[1]
CONF = REPO / "examples" / "conf"
CONFIGS = sorted(Path(p).name for p in glob.glob(str(CONF / "*.yaml")))
SEEDS = (0, 1, 2, 3)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute", "all-to-all")


def _findings(rep) -> list:
    return [dataclasses.asdict(f) for f in rep.findings]


# ---------------------------------------------------------------------------
# the perf contract
# ---------------------------------------------------------------------------


def _facts(rng) -> dict:
    """A canonical facts record with every field a rule reads."""
    def cls():
        return {k: {"achieved_overlap": float(rng.uniform(0, 1)),
                    "exposed_seconds": float(rng.uniform(0, 0.05)),
                    "wire_seconds": float(rng.uniform(0.01, 0.1))}
                for k in KINDS[:int(rng.randint(1, 6))]}

    return {
        "version": t_pc.FACTS_VERSION,
        "workload": {"source": "run", "model_family": "LlamaConfig", "n_chips": 8,
                     "seq_len": 4096, "schedule": "1f1b"},
        "step_time_ms": float(rng.uniform(100, 2000)),
        "mfu": float(rng.uniform(0.1, 0.6)),
        "tokens_per_sec": float(rng.uniform(1e3, 1e5)),
        "achieved_overlap": float(rng.uniform(0, 1)),
        "exposed_collective_seconds": float(rng.uniform(0, 0.2)),
        "overlap_by_class": cls(),
        "bubble_fraction_measured": float(rng.uniform(0, 0.4)),
        "bubble_fraction_predicted": float(rng.uniform(0, 0.4)),
        "peak_hbm_bytes": float(rng.uniform(1e9, 8e10)),
        "hbm_headroom_fraction": float(rng.uniform(0, 0.5)),
        "predicted_hbm_bytes": float(rng.uniform(1e9, 8e10)),
        "residuals": {"total": {"ratio": float(rng.uniform(0.5, 2.0))}},
        "comms": {"classes": {k: {"achieved_gbps": float(rng.uniform(1, 300)),
                                  "efficiency": float(rng.uniform(0, 1))} for k in KINDS[:3]},
                  "axes": {"dp": {"bandwidth_gbps": float(rng.uniform(10, 300)),
                                  "latency_us": 5.0, "bandwidth_ratio": 0.8}}},
    }


def _mutate(facts: dict, rng) -> dict:
    """Every number scaled by a factor around 1, some far off."""
    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        if isinstance(v, float):
            return v * float(rng.choice([0.3, 0.8, 0.97, 1.0, 1.03, 1.3, 2.5]))
        return v
    out = walk(copy.deepcopy(facts))
    out["workload"] = dict(facts["workload"])
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_diff_facts_is_jaxs(seed):
    rng = np.random.RandomState(seed)
    old = _facts(rng)
    for _ in range(4):
        new = _mutate(old, rng)
        t = t_pc.diff_facts(old, new, config_name="x")
        j = j_pc.diff_facts(old, new, config_name="x")
        assert _findings(t) == _findings(j) and t.stats == j.stats
        noise = dict(t_pc.DEFAULT_NOISE, step_time_frac=0.05)
        assert _findings(t_pc.diff_facts(old, new, noise=noise)) == \
            _findings(j_pc.diff_facts(old, new, noise=noise))
    # the version and workload gates
    bad = dict(old, version=0)
    assert _findings(t_pc.diff_facts(old, bad)) == _findings(j_pc.diff_facts(old, bad))
    other = dict(old, workload=dict(old["workload"], seq_len=8192))
    assert _findings(t_pc.diff_facts(old, other)) == _findings(j_pc.diff_facts(old, other))


def _sweeps(rng) -> dict:
    return {
        "version": t_pc.FACTS_VERSION, "workload": {"source": "bench"},
        "schedule_sweep": [{"schedule": s, "step_time_ms": float(rng.uniform(90, 130)),
                            "bubble_fraction_measured": float(rng.uniform(0, 0.3)),
                            "bubble_fraction_predicted": float(rng.uniform(0, 0.3)),
                            "bubble_residual": float(rng.uniform(-0.2, 0.2))}
                           for s in ("1f1b", "1f1b-interleaved", "wavefront")],
        "overlap_sweep": [{"variant": v, "n_buckets": n,
                           "step_time_ms": float(rng.uniform(90, 130)),
                           "exposed_collective_seconds": float(rng.uniform(0.001, 0.05)),
                           "achieved_overlap": float(rng.uniform(0, 1)), "overlap_by_class": {}}
                          for v, n in (("off", 1), ("bucketed_prefetch", 4))],
        "bubble_fraction_measured": float(rng.uniform(0, 0.4)),
        "bubble_fraction_predicted": float(rng.uniform(0, 0.4)),
        "peak_hbm_bytes": float(rng.uniform(1e9, 8e10)),
        "predicted_hbm_bytes": float(rng.uniform(1e9, 8e10)),
    }


@pytest.mark.parametrize("seed", SEEDS)
def test_calibration_and_sweep_gates_are_jaxs(seed):
    from neuronx_distributed_training_torch.analysis.report import AuditReport
    from neuronx_distributed_training_tpu.analysis.report import AuditReport as JReport

    rng = np.random.RandomState(seed)
    facts = _sweeps(rng)
    t, j = AuditReport(config="s"), JReport(config="s")
    t_pc.calibration_findings(facts, t_pc.DEFAULT_NOISE, t)
    j_pc.calibration_findings(facts, j_pc.DEFAULT_NOISE, j)
    assert _findings(t) == _findings(j)
    new = _mutate(facts, rng)
    new["schedule_sweep"] = [dict(r, schedule=o["schedule"]) for r, o in
                             zip(new["schedule_sweep"], facts["schedule_sweep"])]
    new["overlap_sweep"] = [dict(r, variant=o["variant"], n_buckets=o["n_buckets"]) for r, o in
                            zip(new["overlap_sweep"], facts["overlap_sweep"])]
    assert _findings(t_pc.diff_facts(facts, new)) == _findings(j_pc.diff_facts(facts, new))
    # orderings broken on purpose: interleaved slower than plain 1f1b (PC303),
    # the bucketed gathers exposing more than the monolithic one (PC203), a
    # measured peak far above the prediction (PC502)
    bad = copy.deepcopy(facts)
    bad["schedule_sweep"][0]["step_time_ms"] = 100.0
    bad["schedule_sweep"][1]["step_time_ms"] = 150.0
    bad["overlap_sweep"][0]["exposed_collective_seconds"] = 0.01
    bad["overlap_sweep"][1]["exposed_collective_seconds"] = 0.05
    bad["peak_hbm_bytes"] = bad["predicted_hbm_bytes"] * 2
    t, j = AuditReport(config="s"), JReport(config="s")
    t_pc.calibration_findings(bad, t_pc.DEFAULT_NOISE, t)
    j_pc.calibration_findings(bad, j_pc.DEFAULT_NOISE, j)
    assert _findings(t) == _findings(j) and {"PC203", "PC303", "PC502"} <= {
        f.rule for f in t.findings}


@pytest.mark.parametrize("seed", SEEDS)
def test_extraction_residuals_and_keys_are_jaxs(seed, tmp_path):
    rng = np.random.RandomState(seed)
    line = {"metric": "comms_bench_sweep", "value": 0.5, "device": "NVIDIA H100 80GB HBM3",
            "ms_per_step": float(rng.uniform(1, 100)), "mfu": 0.3,
            "overlap_by_class": {"all-gather": float(rng.uniform(0, 1))},
            "comms": _facts(rng)["comms"], "schedule_sweep": {"rows": _sweeps(rng)[
                "schedule_sweep"]}}
    assert t_pc.perf_facts_from_bench(line) == j_pc.perf_facts_from_bench(line)
    trace = {"overlap_by_class": _facts(rng)["overlap_by_class"], "achieved_overlap": 0.4,
             "pipeline": {"schedule": "1f1b", "bubble_fraction_measured": 0.1}}
    assert t_pc.perf_facts_from_trace_summary(trace) == j_pc.perf_facts_from_trace_summary(trace)
    (tmp_path / "line.jsonl").write_text("noise\n" + json.dumps(line) + "\n")
    assert t_pc.load_facts(tmp_path / "line.jsonl") == j_pc.load_facts(tmp_path / "line.jsonl")
    for facts in (t_pc.perf_facts_from_bench(line), t_pc.perf_facts_from_trace_summary(trace),
                  _facts(rng)):
        assert t_pc.default_key(facts) == j_pc.default_key(facts)
    est = {"step_seconds": 0.5, "compute_seconds": 0.4, "comms_seconds": 0.08,
           "bubble_seconds": 0.02}
    measured = {"step_seconds": float(rng.uniform(0.4, 1.2)),
                "exposed_collective_seconds": float(rng.uniform(0, 0.1)),
                "bubble_fraction_measured": float(rng.uniform(0, 0.2)),
                "comms": _facts(rng)["comms"]}
    assert t_pc.residual_report(est, measured) == j_pc.residual_report(est, measured)
    assert t_pc.residual_report(est, {"step_seconds": 0.9}) == \
        j_pc.residual_report(est, {"step_seconds": 0.9})


def test_perf_ratchet_files_and_verdicts_are_jaxs(tmp_path):
    rng = np.random.RandomState(7)
    facts = _facts(rng)
    td, jd = tmp_path / "t", tmp_path / "j"
    for pc, d in ((t_pc, td), (j_pc, jd)):
        pc.write_baseline("cpu_run", facts, justifications=["initial perf baseline"],
                          noise={"step_time_frac": 1.5}, baselines_dir=d)
    assert (td / "cpu_run.json").read_bytes() == (jd / "cpu_run.json").read_bytes()
    # write then check: clean; the same verdict block as JAX's
    assert t_pc.verdict_of(t_pc.check_perf("cpu_run", facts, baselines_dir=td)) in (
        "clean", "info")
    worse = dict(facts, step_time_ms=facts["step_time_ms"] * 3)
    tv = t_pc.bench_verdict("cpu_run", worse, baselines_dir=td)
    assert tv == j_pc.bench_verdict("cpu_run", worse, baselines_dir=jd)
    assert tv["verdict"] == "error" and tv["findings"][0]["rule"] == "PC101"
    assert t_pc.bench_verdict("none", facts, baselines_dir=td) == \
        j_pc.bench_verdict("none", facts, baselines_dir=jd)
    # a regression is refused without a justification, recorded with one
    with pytest.raises(t_pc.PerfContractError, match="REGRESSES"):
        t_pc.update_baseline("cpu_run", worse, baselines_dir=td)
    for pc, d in ((t_pc, td), (j_pc, jd)):
        pc.update_baseline("cpu_run", worse, justify="a slower host", baselines_dir=d)
    assert (td / "cpu_run.json").read_bytes() == (jd / "cpu_run.json").read_bytes()
    doc = json.loads((td / "cpu_run.json").read_text())
    assert doc["justifications"][-1] == "a slower host" and doc["noise"]["step_time_frac"] == 1.5
    # an improvement commits silently and keeps the justifications
    better = dict(worse, step_time_ms=worse["step_time_ms"] / 4)
    t_pc.update_baseline("cpu_run", better, baselines_dir=td)
    assert json.loads((td / "cpu_run.json").read_text())["justifications"] == \
        doc["justifications"]


def test_committed_baselines_load_and_name_their_key():
    paths = sorted(t_pc.BASELINES_DIR.glob("*.json"))
    assert {p.stem for p in paths} >= {"cpu_comms", "cpu_run"}
    for p in paths:
        doc = json.loads(p.read_text())
        assert doc["key"] == p.stem and doc["facts"]["version"] == t_pc.FACTS_VERSION
        assert set(doc["noise"]) == set(t_pc.DEFAULT_NOISE) and doc["justifications"]
        assert t_pc.load_baseline(p.stem) == doc


# ---------------------------------------------------------------------------
# the graph contract
# ---------------------------------------------------------------------------


def _shrunk_ctx(config: str):
    cfg = t_load(CONF / config)
    cfg = t_load(CONF / config, t_ga.shrink_overrides(cfg, max_devices=8))
    world = t_ga._world_of(cfg, 8)
    ds = cfg["distributed_strategy"]
    tp, pp, cp, ep = (int(ds.get(k) or 1) for k in (
        "tensor_model_parallel_size", "pipeline_model_parallel_size", "context_parallel_size",
        "expert_model_parallel_size"))
    axes = {"pipe": pp, "data": world // (tp * pp * cp) // ep, "expert": ep, "context": cp,
            "model": tp}
    return t_ga.AuditContext(cfg=cfg, axes=axes, policy=None, model_cfg=None,
                             sched=batch_schedule(cfg, n_devices=world))


@pytest.mark.parametrize("config", CONFIGS)
def test_declared_source_classes_are_jaxs(config):
    d = t_gc.DeclaredComms.from_ctx(_shrunk_ctx(config))
    t = t_gc.declared_source_classes(d)
    j = j_gc.declared_source_classes(j_gc.DeclaredComms(**dataclasses.asdict(d)))
    assert [(r[0], r[1], r[4], r[3] is None) for r in t] == \
        [(r[0], r[1], r[4], r[3] is None) for r in j]
    # the axes predicates agree on every axis set
    sets = [set(), {"model"}, {"data"}, {"pipe"}, {"context"}, {"expert"}, {"data", "expert"},
            {"data", "model"}, {"context", "model"}, {"pipe", "data"},
            {"data", "expert", "model"}]
    assert [[bool(r[2](a)) for a in sets] for r in t] == [[bool(r[2](a)) for a in sets]
                                                          for r in j]


def _fingerprint(rng, *, unattributed: bool = True) -> dict:
    labels = ["tp/SP layer collective", "dp gradient/loss all-reduce", "pp stage hop", None]
    coll = {}
    for kind in KINDS:
        for axes in ("data", "model", "pipe", "data+model"):
            if rng.rand() < 0.4:
                src = labels[int(rng.randint(0, len(labels) - (0 if unattributed else 1)))]
                coll[f"{kind}|{axes}"] = {"count": int(rng.randint(1, 50)), "source": src,
                                          "hint": "" if src is None else f"{src} hint",
                                          "sample_source_ops": [f"pkg.mod.fn{kind}"]}
    n = int(rng.randint(10, 60))
    return {"version": 1, "config": "x.yaml", "device": "cpu",
            "mesh": {"pipe": 1, "data": 2, "expert": 1, "context": 1, "model": 2},
            "collectives": dict(sorted(coll.items())),
            "donation": {"aliased": n, "expected": n, "coverage": 1.0, "missing": []},
            "matmul_dtypes": {"counts": {"bf16xbf16": int(rng.randint(5, 40)),
                                         "f32xf32": int(rng.randint(0, 4))},
                              "samples": {"bf16xbf16": "mm: a x b", "f32xf32": "bmm: c x d"}},
            "memory": {"resident_bytes": int(rng.randint(10 ** 6, 10 ** 7))}}


def _grow(fp: dict, rng) -> dict:
    new = copy.deepcopy(fp)
    for rec in new["collectives"].values():
        rec["count"] = max(rec["count"] + int(rng.randint(-3, 4)), 1)
    new["collectives"]["all-to-all|model"] = {"count": 2, "source": None, "hint": "",
                                              "sample_source_ops": ["pkg.new.fn"]}
    if rng.rand() < 0.5:
        new["donation"] = {"aliased": fp["donation"]["aliased"] - 1,
                           "expected": fp["donation"]["expected"],
                           "coverage": 0.9, "missing": ["params/layers.0.w"]}
    new["matmul_dtypes"]["counts"]["f32xf32"] += int(rng.randint(0, 3))
    new["memory"]["resident_bytes"] = int(fp["memory"]["resident_bytes"] *
                                          float(rng.choice([0.7, 1.0, 1.3])))
    return new


@pytest.mark.parametrize("seed", SEEDS)
def test_attribution_and_differ_are_jaxs(seed):
    rng = np.random.RandomState(seed)
    old = _fingerprint(rng)
    assert t_gc.unattributed_entries(old) == j_gc.unattributed_entries(old)
    t, j = t_gc.attribution_report(old), j_gc.attribution_report(old)
    assert _findings(t) == _findings(j) and t.stats == j.stats
    new = _grow(old, rng)
    waivers = {k: "known" for k in list(t_gc.unattributed_entries(new))[:1]}
    for kw in ({}, {"waivers": waivers}, {"memory_tolerance": 0.5}):
        t, j = t_gc.diff_fingerprint(old, new, **kw), j_gc.diff_fingerprint(old, new, **kw)
        assert _findings(t) == _findings(j) and t.stats == j.stats
        assert _findings(t_gc.diff_fingerprint(new, old, **kw)) == \
            _findings(j_gc.diff_fingerprint(new, old, **kw))
    moved = dict(new, mesh=dict(new["mesh"], data=4))
    assert _findings(t_gc.diff_fingerprint(old, moved)) == \
        _findings(j_gc.diff_fingerprint(old, moved))


def test_attribute_picks_jaxs_first_matching_class():
    d = t_gc.DeclaredComms(tp=2, pp=2, cp=1, ep=1, dp=2, zero1=True, seq_par=True, moe=False,
                           ulysses=False, ring=False, zero1_bucket=True)
    t = t_gc.declared_source_classes(d)
    j = j_gc.declared_source_classes(j_gc.DeclaredComms(**dataclasses.asdict(d)))
    for kind, axes in (("all-reduce", ("data",)), ("all-gather", ("model",)),
                       ("collective-permute", ("pipe",)), ("all-reduce", ("pipe",)),
                       ("reduce-scatter", ("data",)), ("all-to-all", ("expert",)),
                       ("all-gather", ("data",)), ("all-reduce", None)):
        assert t_gc.attribute(kind, axes, ["pkg.mod.fn"], t) == \
            j_gc.attribute(kind, axes, ["pkg.mod.fn"], j)
    # the corroborated classes read the port's modules where JAX reads op_name
    bucket = t_gc.attribute("all-gather", ("data",),
                            ["neuronx_distributed_training_torch.optim.overlap._gather_single"], t)
    assert bucket[0] == j_gc.attribute("all-gather", ("data",),
                                       ["jit(step)/zero1_bucket/all-gather"], j)[0] == \
        "zero1-bucket combined all-gather"


def test_census_ranks_name_the_mesh_axes():
    axes = {"pipe": 2, "data": 2, "expert": 1, "context": 1, "model": 2}
    # ranks row-major over (pipe, data, expert, context, model)
    assert t_census.axes_of_ranks([0, 1], axes) == ("model",)
    assert t_census.axes_of_ranks([0, 2], axes) == ("data",)
    assert t_census.axes_of_ranks([1, 5], axes) == ("pipe",)
    assert t_census.axes_of_ranks([0, 1, 2, 3], axes) == ("data", "model")
    assert t_census.axes_of_ranks([3], axes) == ()
    assert t_census.axes_of_ranks([0, 9], axes) is None
    calls = [{"kind": "all-reduce", "ranks": [0, 2], "source": "a.b"},
             {"kind": "all-reduce", "ranks": [0, 2], "source": "a.c"},
             {"kind": "all-gather", "ranks": [0, 1], "source": "a.b"},
             {"kind": "collective-permute", "ranks": [0], "source": "a.d"}]
    assert t_census.collectives_by_axes(calls, axes) == {
        "all-gather|model": {"kind": "all-gather", "axes": ("model",), "count": 1,
                             "sources": ["a.b"]},
        "all-reduce|data": {"kind": "all-reduce", "axes": ("data",), "count": 2,
                            "sources": ["a.b", "a.c"]}}


def test_graph_ratchet_cases(tmp_path):
    rng = np.random.RandomState(11)
    fp = _fingerprint(rng, unattributed=False)
    cfg = "x_config.yaml"
    path, rep = t_gc.update_contract(cfg, fp, contracts_dir=tmp_path)
    first = path.read_bytes()
    assert path.name == "x_config.json" and not rep.findings
    assert t_gc.check_contract(cfg, fp, contracts_dir=tmp_path).worst() is None
    t_gc.update_contract(cfg, fp, contracts_dir=tmp_path)
    assert path.read_bytes() == first  # byte-stable
    # the same check on another device has no section: GC000
    on_card = dict(fp, device="cuda")
    assert [f.rule for f in t_gc.check_contract(cfg, on_card, contracts_dir=tmp_path)
            .findings] == ["GC000"]
    t_gc.update_contract(cfg, on_card, contracts_dir=tmp_path)
    doc = json.loads(path.read_text())
    assert sorted(doc["devices"]) == ["cpu", "cuda"] and doc["config"] == cfg
    # growth: refused without a justification, recorded with one
    grown = copy.deepcopy(fp)
    key = next(iter(grown["collectives"]))
    grown["collectives"][key]["count"] += 5
    assert ("GC101", "error") in [(f.rule, f.severity) for f in t_gc.check_contract(
        cfg, grown, contracts_dir=tmp_path).findings]
    with pytest.raises(t_gc.ContractError, match="GROWS"):
        t_gc.update_contract(cfg, grown, contracts_dir=tmp_path)
    t_gc.update_contract(cfg, grown, justify="a new class", contracts_dir=tmp_path)
    doc = json.loads(path.read_text())
    assert doc["justifications"][-1] == "a new class" and "cuda" in doc["devices"]
    # an unattributed collective: refused without --waive, a named waiver with it
    stray = copy.deepcopy(grown)
    stray["collectives"]["all-to-all|context"] = {"count": 1, "source": None, "hint": "",
                                                "sample_source_ops": ["pkg.x.y"]}
    assert ("GC201", "error") in [(f.rule, f.severity) for f in t_gc.check_contract(
        cfg, stray, contracts_dir=tmp_path).findings]
    with pytest.raises(t_gc.ContractError, match="--waive"):
        t_gc.update_contract(cfg, stray, justify="why", contracts_dir=tmp_path)
    t_gc.update_contract(cfg, stray, justify="a known exchange", waive=True,
                         contracts_dir=tmp_path)
    doc = json.loads(path.read_text())
    assert doc["devices"]["cpu"]["waivers"] == {"all-to-all|context": "a known exchange"}
    assert t_gc.check_contract(cfg, stray, contracts_dir=tmp_path).worst() is None
    # the stray gone: its waiver drops, silently (a shrink)
    t_gc.update_contract(cfg, grown, contracts_dir=tmp_path)
    assert json.loads(path.read_text())["devices"]["cpu"]["waivers"] == {}


def test_graph_contract_tool_checks_and_updates(tmp_path, monkeypatch, capsys):
    from neuronx_distributed_training_torch.tools import graph_contract as tool

    rng = np.random.RandomState(5)
    fp = _fingerprint(rng, unattributed=False)
    monkeypatch.setattr(t_gc, "fingerprint_config", lambda path, **kw: dict(
        fp, config=Path(path).name))
    argv = ["--config", str(CONF / "tiny_smoke_config.yaml"), "--device", "cpu",
            "--contracts-dir", str(tmp_path), "--json", "-"]
    assert tool.main(argv) == 1 and "GC000" in capsys.readouterr().out
    assert tool.main(argv + ["--update-contracts"]) == 0
    capsys.readouterr()
    assert tool.main(argv) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["reports"][0]
    assert rep["verdict"] == "clean" and rep["fingerprint"]["config"] == "tiny_smoke_config.yaml"
    with pytest.raises(SystemExit):
        tool.main(argv + ["--waive"])


def test_committed_contracts_name_every_shipped_config():
    paths = sorted(t_gc.CONTRACTS_DIR.glob("*.json"))
    assert sorted(p.stem for p in paths) == sorted(Path(c).stem for c in CONFIGS)
    for p in paths:
        doc = json.loads(p.read_text())
        assert doc["config"] == f"{p.stem}.yaml" and doc["justifications"]
        assert "cpu" in doc["devices"] and set(doc["devices"]) <= {"cpu", "cuda"}
        for device, section in doc["devices"].items():
            fp = section["fingerprint"]
            assert fp["device"] == device and fp["version"] == t_gc.FINGERPRINT_VERSION
            assert not t_gc.unattributed_entries(fp) or set(
                t_gc.unattributed_entries(fp)) <= set(section["waivers"])
    for name in ("tiny_smoke_config", "hf_llama3_8B_config"):
        assert "cuda" in json.loads((t_gc.CONTRACTS_DIR / f"{name}.json").read_text())["devices"]
