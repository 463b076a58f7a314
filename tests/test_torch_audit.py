"""The port's pre-flight audit (``neuronx_distributed_training_torch/analysis``)
against the JAX package's.

- ``shrink_overrides`` equals JAX's for every shipped config, except the
  recorded head_dim: 64 where flash attention is on (the Hopper kernels
  tile d 64 / 128 only), JAX's 16 elsewhere.
- Each rule (GA001 in place, GA101 / GA102 the census, GA201 the
  replication budget, GA301 fp32 matmuls, GA401 layouts) has a case built
  to fail it and one that passes, as JAX's ``tests/test_graph_audit.py``
  builds them by mutation.
- ``audit_config`` on ``tiny_smoke_config.yaml`` and on its shrunk dp 2,
  tp 2 (+ SP) and dp 2 + ZeRO-1 structures, one step each on gloo ranks:
  the verdict is JAX's, and so are the collective classes, except at tp 2,
  where GSPMD's resharding permutes and all-to-alls have no counterpart
  (the port's sequence parallelism issues its reduce-scatters itself).
- The same audits' contract fingerprints (``analysis/graph_contract.py``):
  each attributed ``kind|axes`` class carries the source label JAX's
  fingerprint of the same structure gives it (tp 2 aside, as above), and
  tiny_smoke's checks clean against its committed ``cpu`` contract.
- ``--audit-only`` through the port's CLI, the pre-flight tool's
  ``--contracts`` and refused ``--lint``, and the live first-step audit
  (``telemetry.graph_audit``) writing run_summary.json's section with its
  collectives attributed.
"""

import concurrent.futures
import dataclasses
import glob
import json
from pathlib import Path

import pytest
import torch

from neuronx_distributed_training_tpu.analysis import graph_audit as j_ga
from neuronx_distributed_training_tpu.analysis import graph_contract as j_gc
from neuronx_distributed_training_tpu.config.loader import load_config as j_load

from neuronx_distributed_training_torch.analysis import graph_audit as t_ga
from neuronx_distributed_training_torch.analysis import graph_contract as t_gc
from neuronx_distributed_training_torch.analysis.report import AuditReport
from neuronx_distributed_training_torch.config.loader import load_config as t_load
from neuronx_distributed_training_torch.parallel.sharding import LeafLayout
from neuronx_distributed_training_torch.trainer import cli as t_cli
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

REPO = Path(__file__).resolve().parents[1]
CONF = REPO / "examples" / "conf"
CONFIGS = sorted(Path(p).name for p in glob.glob(str(CONF / "*.yaml")))
TINY = CONF / "tiny_smoke_config.yaml"
#: tiny_smoke's shrunk structures: (port overrides, JAX overrides)
STRUCTURES = {
    "tiny": None,
    "dp2": {"distributed_strategy.zero1": False,
            "distributed_strategy.overlap.zero1_bucket_mb": 0.0},
    "tp2": {"distributed_strategy.tensor_model_parallel_size": 2,
            "distributed_strategy.sequence_parallel": True},
    "dp2_zero1": {"distributed_strategy.zero1": True},
}


@pytest.mark.parametrize("config", CONFIGS)
def test_shrink_overrides_are_jaxs_but_head_dim(config):
    t_cfg, j_cfg = t_load(CONF / config), j_load(str(CONF / config))
    for devices in (8, 4):
        try:
            j = j_ga.shrink_overrides(j_cfg, max_devices=devices)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                t_ga.shrink_overrides(t_cfg, max_devices=devices)
            continue
        t = t_ga.shrink_overrides(t_cfg, max_devices=devices)
        flash = bool(t_cfg["model"].get("fusions", {}).get("flash_attention"))
        hd = t_ga.FLASH_SHRUNK_HEAD_DIM if flash else t_ga.SHRUNK_HEAD_DIM
        heads = j["model.num_attention_heads"]
        want = dict(j)
        want["model.hidden_size"] = heads * hd
        for key in ("intermediate_size", "ffn_hidden_size"):
            if f"model.{key}" in want:
                want[f"model.{key}"] = 2 * heads * hd
        if "model.kv_channels" in want:
            want["model.kv_channels"] = hd
        assert t == want, config
        assert j["model.hidden_size"] == heads * 16  # JAX's head_dim
        shrunk = t_load(CONF / config, t)
        assert t_ga._world_of(shrunk, devices) == j_ga._world_of(j_load(str(CONF / config), j),
                                                                 devices)


# ---------------------------------------------------------------------------
# the rules, each failed and passed by construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TinyModel:
    hidden_size: int = 8
    intermediate_size: int = 8
    vocab_size: int = 8
    num_attention_heads: int = 1
    num_layers: int = 1
    max_position_embeddings: int = 8
    attention_impl: str = "flash"


def make_ctx(*, axes=None, zero1=True, policy=None, leaves=None, layouts=None, ds_extra=None,
             model=None):
    full = {a: 1 for a in ("pipe", "data", "expert", "context", "model")}
    full.update(axes or {})
    return t_ga.AuditContext(
        cfg={"distributed_strategy": {"zero1": zero1, **(ds_extra or {})},
             "data": {"seq_length": 8}, "model": model or {}},
        axes=full, policy=policy or DtypePolicy.from_precision_config("fp32"),
        model_cfg=TinyModel(), sched={"global_batch_size": 8, "micro_batch_size": 1},
        leaves=leaves if leaves is not None else {"params/w": torch.zeros(8, 8)},
        layouts=layouts or {})


def rules(report):
    return sorted({(f.rule, f.severity) for f in report.findings})


def test_ga001_a_replaced_leaf_fails_an_updated_one_passes():
    w, m = torch.zeros(8, 8), torch.zeros(8, 8)
    leaves = {"params/w": w, "opt_state/mu/w": m, "opt_state/step": torch.zeros((), dtype=torch.int64)}
    before = t_ga.storage_pointers(leaves)
    assert set(before) == {"params/w", "opt_state/mu/w"}  # 0-d counters left out
    w.add_(1.0)  # in place
    rep = AuditReport()
    t_ga.audit_inplace(rep, before, t_ga.storage_pointers(leaves))
    assert rep.findings == [] and rep.stats["inplace_coverage"] == 1.0
    leaves["opt_state/mu/w"] = m + 1.0  # a new storage: donated but copied
    rep = AuditReport()
    t_ga.audit_inplace(rep, before, t_ga.storage_pointers(leaves))
    assert rules(rep) == [("GA001", "error")] and "opt_state/mu/w" in rep.findings[0].message


@pytest.mark.parametrize("axes,zero1,ds,counts,want", [
    # single device with collectives
    ({}, True, {}, {"all-reduce": 2}, [("GA101", "warn")]),
    ({}, True, {}, {}, []),
    # dp-only, zero1 off, regathering
    ({"data": 2}, False, {}, {"all-reduce": 3, "all-gather": 1}, [("GA101", "error")]),
    ({"data": 2}, False, {}, {"all-reduce": 3}, []),
    # an all-to-all nothing explains / a permute without pp or a ring
    ({"data": 2}, True, {}, {"all-reduce": 1, "all-gather": 1, "all-to-all": 2},
     [("GA101", "warn")]),
    ({"model": 2}, True, {}, {"all-reduce": 1, "collective-permute": 1}, [("GA101", "warn")]),
    # tp without model-axis traffic
    ({"model": 2}, True, {}, {}, [("GA102", "error")]),
    ({"model": 2}, True, {}, {"all-reduce": 4}, []),
    # dp without a reduction; zero1 without a gather
    ({"data": 2}, True, {}, {"all-gather": 2}, [("GA102", "error")]),
    ({"data": 2}, True, {}, {"all-reduce": 2}, [("GA102", "warn")]),
    ({"data": 2}, True, {}, {"all-reduce": 2, "all-gather": 1}, []),
    # pp without a stage transfer; SP without its gather
    ({"pipe": 2}, True, {}, {}, [("GA102", "warn")]),
    ({"pipe": 2}, True, {}, {"collective-permute": 4}, []),
    ({"model": 2}, True, {"sequence_parallel": True}, {"all-reduce": 2, "reduce-scatter": 2},
     [("GA102", "warn")]),
    ({"model": 2}, True, {"sequence_parallel": True}, {"all-reduce": 2, "all-gather": 2}, []),
])
def test_ga101_ga102_census_rules(axes, zero1, ds, counts, want):
    rep = AuditReport()
    t_ga.audit_collectives(rep, make_ctx(axes=axes, zero1=zero1, ds_extra=ds),
                           {**{k: 0 for k in t_ga.COLLECTIVE_KINDS}, **counts})
    assert rules(rep) == want


def test_ga201_an_oversized_output_fails_a_budgeted_one_passes():
    ctx = make_ctx(leaves={"params/w": torch.zeros(4, 4)})
    budget = t_ga.expected_max_device_bytes(ctx)
    for n, want in ((budget // 4, []), (budget * 4, [("GA201", "warn")])):
        obs = t_ga.StepObserver(threshold_bytes=budget * 2)
        with obs:
            torch.zeros(n // 4 or 1, dtype=torch.float32) + 1.0
        rep = AuditReport()
        t_ga.audit_replication(rep, ctx, obs.obs, slack=2.0)
        assert rules(rep) == want, (n, budget, obs.obs.largest)


def test_ga301_fp32_matmuls_under_bf16():
    ctx = make_ctx(policy=DtypePolicy.from_precision_config("mixed_precision"))
    a, b = torch.randn(8, 8), torch.randn(8, 8)
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    cases = [
        (lambda: a @ b, [("GA301", "warn")]),                       # never cast
        (lambda: ab @ bb, []),                                      # bf16
        (lambda: ab.float() @ b, []),                               # widened bf16 values
        (lambda: ab.float().t().contiguous().t() @ bb.float(), []),  # widened, then moved
        (lambda: torch.bmm(a[None], b[None]), [("GA301", "warn")]),
    ]
    for fn, want in cases:
        obs = t_ga.StepObserver()
        with obs:
            fn()
        rep = AuditReport()
        t_ga.audit_dtypes(rep, ctx, obs.obs)
        assert rules(rep) == want
    # the MoE router's fp32 products (a trailing dim of num_experts) are exempt
    obs = t_ga.StepObserver(n_experts=4)
    with obs:
        torch.randn(8, 16) @ torch.randn(16, 4)
    rep = AuditReport()
    t_ga.audit_dtypes(rep, ctx, obs.obs)
    assert rules(rep) == []
    # fp32 compute: nothing to check
    rep = AuditReport()
    obs = t_ga.StepObserver()
    with obs:
        a @ b
    t_ga.audit_dtypes(rep, make_ctx(), obs.obs)
    assert rules(rep) == []


def test_ga401_layouts_against_the_mesh():
    leaves = {"params/w": torch.zeros(8, 8), "params/e": torch.zeros(4, 8, 8)}
    axes = {"data": 2, "model": 2}
    ok = {"w": LeafLayout(dim=1), "e": LeafLayout(dim=2, expert=True)}
    assert t_ga.spec_errors(ok, leaves, {**axes, "expert": 1}) == []
    bad = {"w": LeafLayout(dim=2), "e": LeafLayout(dim=0, expert=True)}
    errs = t_ga.spec_errors(bad, leaves, axes)
    assert any("shards dim 2 of a 2-d leaf" in e for e in errs)
    assert any("'expert', not in the mesh" in e for e in errs)
    assert any("dim 0 split over both" in e for e in errs)
    obs = t_ga.StepObservation()
    rep = t_ga.audit_observation(make_ctx(leaves=leaves, layouts=bad, axes=axes), obs,
                                 {k: 0 for k in t_ga.COLLECTIVE_KINDS}, {}, {})
    assert ("GA401", "error") in rules(rep)


# ---------------------------------------------------------------------------
# the audit of tiny_smoke's structures over gloo, against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def structures():
    """The port's audits (spawned gloo ranks, in threads) beside JAX's, and
    JAX's contract fingerprint of each structure (from the same lowering)."""
    with concurrent.futures.ThreadPoolExecutor(len(STRUCTURES)) as pool:
        futs = {name: pool.submit(t_ga.audit_config, str(TINY), device="cpu", overrides=ov)
                for name, ov in STRUCTURES.items()}
        jax_reps, jax_fps = {}, {}
        for name, ov in STRUCTURES.items():
            arts: dict = {}
            jax_reps[name] = j_ga.audit_config(str(TINY), shrink=True, overrides=ov,
                                               artifacts_out=arts)
            jax_fps[name] = j_gc.fingerprint_artifacts(arts["ctx"], arts["compiled"],
                                                       arts["stablehlo"])
        return {name: (futs[name].result(), jax_reps[name], jax_fps[name])
                for name in STRUCTURES}


def classes(counts):
    return {k for k, v in (counts or {}).items() if v}


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_shrunk_structures_agree_with_jax(structures, name):
    t, j, jfp = structures[name]
    assert t.worst() == j.worst() and t.by_severity() == j.by_severity(), \
        (name, t.format(), j.format())
    assert t.stats["audit_device"] == "cpu" and t.stats["audit_backend"] == "gloo"
    assert t.stats["audit_world"] == j_ga._world_of(
        j_load(str(TINY), {**j_ga.shrink_overrides(j_load(str(TINY), STRUCTURES[name]),
                                                   max_devices=8), **(STRUCTURES[name] or {})}),
        8)
    tc, jc = classes(t.stats["collectives"]), classes(j.stats["collectives"])
    if name == "tp2":
        # the model axis's classes both show; GSPMD's reshards are JAX's own
        assert {"all-reduce", "all-gather"} <= tc & jc
        assert jc - tc <= {"collective-permute", "all-to-all"}
        assert tc - jc <= {"reduce-scatter"}
    else:
        assert tc == jc, (name, t.stats["collectives"], j.stats["collectives"])
    assert t.stats["memory_bytes"] > 0 and t.stats["inplace_coverage"] == 1.0
    # the contract fingerprint: every collective attributed, with JAX's label
    # where both packages issue the class
    fp = t.stats["fingerprint"]
    assert fp["device"] == "cpu" and not t_gc.unattributed_entries(fp), fp["collectives"]
    assert fp["mesh"] == {a: int(jfp["mesh"][a]) for a in fp["mesh"]}
    shared = set(fp["collectives"]) & set(jfp["collectives"])
    assert shared or name == "tp2", (fp["collectives"], jfp["collectives"])
    if name != "tp2":
        assert {k: fp["collectives"][k]["source"] for k in shared} == \
            {k: jfp["collectives"][k]["source"] for k in shared}
    if name == "tiny":
        rep = t_gc.check_contract(str(TINY), dict(fp, config=TINY.name, shrunk=True))
        assert rep.worst() is None, rep.format()


def test_assembly_failure_is_ga000():
    tp2 = {"distributed_strategy.tensor_model_parallel_size": 2}
    rep = t_ga.audit_config(str(TINY), device="cpu", max_devices=1, overrides=tp2)
    assert rules(rep) == [("GA000", "error")] and "shrunk world 2 still exceeds " \
        "max_devices=1" in rep.findings[0].message
    rep = t_ga.audit_config(str(TINY), device="cpu", shrink=False, max_devices=1, overrides=tp2)
    assert rules(rep) == [("GA000", "error")] and "needs at least 2 devices" in \
        rep.findings[0].message
    rep = t_ga.audit_config(str(TINY), device="cpu",
                            overrides={"exp_manager.elastic.grace_period": 3})
    assert rules(rep) == [("GA000", "error")] and "config failed validation" in \
        rep.findings[0].message


def test_audit_only_cli(capsys):
    with pytest.raises(SystemExit) as e:
        t_cli.build(["--config", str(TINY), "--device", "cpu", "--audit-only"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "audit [tiny_smoke_config.yaml]: clean (0 findings)" in out
    assert "audit device: cpu x 1" in out


def test_preflight_tool_refuses_lint_and_contracts(capsys, monkeypatch):
    from neuronx_distributed_training_torch.tools import preflight_audit as t_pf

    with pytest.raises(SystemExit):
        t_pf.main(["--config", str(TINY), "--lint"])
    assert "jaxlint" in capsys.readouterr().err and "left out by decision" in t_pf.UNPORTED
    assert t_pf.main(["--config", str(TINY), "--device", "cpu", "--no-shrink", "--json",
                      "-"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["reports"][0]
    assert rep["verdict"] == "clean" and rep["stats"]["audit_world"] == 1
    assert "fingerprint" not in rep["stats"] and "contract" not in rep
    # --contracts checks the audit's own fingerprint against the committed
    # contract: the committed one itself (its step is the structures'
    # fixture's, checked live above) is clean; a grown one fails
    fp = t_gc.load_contract(TINY.name)["devices"]["cpu"]["fingerprint"]
    for grow, code, verdict in ((0, 0, "clean"), (3, 1, "error")):
        fresh = json.loads(json.dumps(fp))
        fresh["collectives"]["all-reduce|data"]["count"] += grow
        monkeypatch.setattr(t_ga, "audit_config", lambda *a, **kw: AuditReport(
            config=TINY.name, stats={"audit_device": "cpu", "audit_world": 2,
                                     "fingerprint": fresh}))
        assert t_pf.main(["--config", str(TINY), "--device", "cpu", "--contracts", "--json",
                          "-"]) == code
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["reports"][0]
        assert rep["contract"]["verdict"] == verdict


def test_live_first_step_audit_writes_its_section(tmp_path):
    from neuronx_distributed_training_torch.trainer import loop as t_loop

    t_loop._logged_ignored.clear()
    t_cli.main(["--config", str(TINY), "--device", "cpu", "--set", "trainer.max_steps=2",
                "--set", "exp_manager.telemetry.graph_audit=true",
                "--set", f"exp_manager.exp_dir={tmp_path}",
                "--set", "exp_manager.create_tensorboard_logger=false"])
    run = json.loads((tmp_path / "tiny_smoke" / "version_0" / "run_summary.json").read_text())
    ga = run["graph_audit"]
    assert ga["verdict"] == "clean" and ga["stats"]["inplace_coverage"] == 1.0
    assert set(ga["stats"]["collectives"]) >= set(t_ga.COLLECTIVE_KINDS)
    # JAX's contract section: one process, no collective, every matmul bf16
    # or the core attention's fp32 products
    assert ga["contract"]["collectives_total"] == ga["contract"]["collectives_unattributed"] == 0
    assert ga["contract"]["collectives"] == {} and ga["contract"]["matmul_dtypes"]["bf16xbf16"]
    assert "fingerprint" not in ga["stats"]
