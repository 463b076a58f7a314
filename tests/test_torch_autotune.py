"""The port's launch planner (``neuronx_distributed_training_torch/autotune``)
against the JAX package's.

- ``plan_config(..., audit=False, topology="cpu")`` for every shipped config
  at 1, 8, 32 and 64 chips: the same lattice size, fit count, candidates in
  the same order and ``PlanReport.to_dict()`` equal (ints and strings
  exactly, floats to rtol 1e-9); a plan the port's trainer refuses
  (``trainer/loop.py::check_supported``) may only differ by its
  ``discarded`` text, which must be the refusal's.
- ``predicted_breakdown_for_config`` and ``collective_byte_volumes`` equal
  JAX's; the topology table's ``cpu`` entry is JAX's, the ``h100`` one
  prices from ``utils/perf.py::CARD_PEAKS`` and a TPU generation is refused
  with the known set.
- The calibrations read a port-written ``trace_summary.json`` (the trace
  plane's analysis of a relabeled fixture) and ``memory_summary.json`` (a
  CLI run with the memory plane) to the ratios JAX reads from the same
  documents; a comms summary of JAX's schema likewise.
- The CLI: ``--autotune`` on ``tiny_smoke_config.yaml`` imposes the winner
  and records it, ``memory_summary.json`` carries the predicted bytes, a
  winner that does not fit is refused with JAX's text, and ``--trace``'s
  parse and error text are JAX's.
"""

import glob
import json
import math
from pathlib import Path

import pytest

from neuronx_distributed_training_tpu.autotune import cost_model as j_cm
from neuronx_distributed_training_tpu.autotune import planner as j_planner
from neuronx_distributed_training_tpu.autotune import space as j_space
from neuronx_distributed_training_tpu.autotune import topology as j_topo
from neuronx_distributed_training_tpu.config.loader import load_config as j_load

from neuronx_distributed_training_torch.autotune import cost_model as t_cm
from neuronx_distributed_training_torch.autotune import planner as t_planner
from neuronx_distributed_training_torch.autotune import space as t_space
from neuronx_distributed_training_torch.autotune import topology as t_topo
from neuronx_distributed_training_torch.config.loader import load_config as t_load
from neuronx_distributed_training_torch.trainer import cli as t_cli
from neuronx_distributed_training_torch.trainer import loop as t_loop

REPO = Path(__file__).resolve().parents[1]
CONF = REPO / "examples" / "conf"
CONFIGS = sorted(Path(p).name for p in glob.glob(str(CONF / "*.yaml")))
TINY = CONF / "tiny_smoke_config.yaml"
CHIPS = (1, 8, 32, 64)
RTOL = 1e-9


def _close(a, b, where=""):
    """Ints, strings and structure exactly; floats to ``RTOL``."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (where, sorted(a), sorted(b))
        for k in b:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(b, float) and not isinstance(b, bool):
        assert a == pytest.approx(b, rel=RTOL, abs=0.0), (where, a, b)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


@pytest.mark.parametrize("config", CONFIGS)
def test_analytic_plans_equal_jax(config):
    for chips in CHIPS:
        t = t_planner.plan_config(str(CONF / config), chips=chips, topology="cpu", audit=False)
        j = j_planner.plan_config(str(CONF / config), chips=chips, topology="cpu", audit=False)
        td, jd = t.to_dict(), j.to_dict()
        refused = {}
        for c in td["candidates"]:
            if "discarded" in c:
                refused[c["rank"]] = c.pop("discarded")
        tw, jw = td.pop("winner"), jd.pop("winner")
        _close(td, jd, f"{config}@{chips}")
        for cand in t.candidates:
            if cand.rank in refused:
                # only a plan the trainer refuses, with the trainer's text
                with pytest.raises((NotImplementedError, ValueError)) as e:
                    t_loop.check_supported(t_load(str(CONF / config),
                                                  cand.plan.overrides(t.facts)))
                assert refused[cand.rank] == str(e.value)
        if not refused:
            assert tw == jw, (config, chips)


def test_refused_plans_are_discarded_with_the_trainer_text():
    """A LoRA Mixtral: the port's trainer once refused it (ROADMAP entry
    10), and the planner discarded every candidate with that text; LoRA on
    Mixtral is ported, so no candidate is discarded, the ranking is JAX's
    and the port's planner picks JAX's winner."""
    ov = {"model.lora": {"rank": 8}, "model.num_layers": 2}
    src = str(CONF / "hf_mixtral_8x7b_config.yaml")
    t = t_planner.plan_config(src, chips=8, topology="cpu", audit=False, overrides=ov)
    j = j_planner.plan_config(src, chips=8, topology="cpu", audit=False, overrides=ov)
    assert [dataclass_tuple(c.plan) for c in t.candidates] == \
        [dataclass_tuple(c.plan) for c in j.candidates]
    assert not any(c.discarded for c in t.candidates)
    assert j.winner is not None and dataclass_tuple(t.winner.plan) == \
        dataclass_tuple(j.winner.plan)


@pytest.mark.parametrize("config,chips", [("hf_llama3_8B_config.yaml", 32),
                                          ("hf_mixtral_8x7b_config.yaml", 8),
                                          ("hf_llama3_70B_CP_config.yaml", 64),
                                          ("megatron_gpt_config.yaml", 8),
                                          ("hf_llama3.1_405B_config.yaml", 64)])
def test_breakdown_and_byte_volumes_equal_jax(config, chips):
    src = str(CONF / config)
    tc, jc = t_load(src), j_load(src)
    _close(t_cm.predicted_breakdown_for_config(tc, chips),
           j_cm.predicted_breakdown_for_config(jc, chips))
    tf, jf = t_space.ModelFacts.from_config(tc), j_space.ModelFacts.from_config(jc)
    tplans = t_space.enumerate_plans(tf, chips)
    jplans = j_space.enumerate_plans(jf, chips)
    assert [dataclass_tuple(p) for p in tplans] == [dataclass_tuple(p) for p in jplans]
    for tp, jp in list(zip(tplans, jplans))[:: max(len(tplans) // 12, 1)]:
        _close(t_cm.collective_byte_volumes(tf, tp), j_cm.collective_byte_volumes(jf, jp))
        _close(t_cm.hbm_breakdown(tf, tp), j_cm.hbm_breakdown(jf, jp))


def dataclass_tuple(p):
    import dataclasses

    return tuple(dataclasses.asdict(p).items())


def test_topology_table():
    import dataclasses

    # JAX's fields, plus the port's measured fit ratio (1: JAX's fit test)
    assert dataclasses.asdict(t_topo.TOPOLOGIES["cpu"]) == \
        dict(dataclasses.asdict(j_topo.TOPOLOGIES["cpu"]), hbm_total_ratio=1.0)
    assert t_topo.TOPOLOGIES["cpu"].peak_flops == j_topo.TOPOLOGIES["cpu"].peak_flops
    from neuronx_distributed_training_torch.utils import perf

    h = t_topo.resolve_topology("H100")
    assert h.name == "h100" and h.peak_flops == perf.CARD_PEAKS["H100"][0]
    assert t_topo.resolve_topology() is t_topo.TOPOLOGIES["cpu"]
    assert t_topo.resolve_topology(device="cpu") is t_topo.TOPOLOGIES["cpu"]
    with pytest.raises(ValueError, match=r"unknown topology 'v5e'; known: cpu/h100"):
        t_topo.resolve_topology("v5e")
    assert set(t_topo.TPU_TOPOLOGIES) == set(j_topo.TOPOLOGIES) - {"cpu"}


def test_kendall_tau_and_overlap_priors_equal_jax():
    for a, b in [([1, 2, 3], [1, 2, 3]), ([1, 2, 3, 4], [4, 3, 2, 1]), ([1.0, 2.0], [2.0, 2.0]),
                 ([3, 1, 2, 5], [2, 1, 3, 4]), ([1], [1])]:
        assert t_cm.kendall_tau(a, b) == j_cm.kendall_tau(a, b)
    cpu_t, cpu_j = t_topo.TOPOLOGIES["cpu"], j_topo.TOPOLOGIES["cpu"]
    for ov in (None, 0.3, {"dp": 0.9, "default": 0.2}, {"tp": 1.5}):
        assert t_cm.resolve_overlap(ov, cpu_t) == j_cm.resolve_overlap(ov, cpu_j)


# ---------------------------------------------------------------------------
# calibration: port-written summaries, read by both
# ---------------------------------------------------------------------------


def test_trace_calibration_reads_a_port_written_summary(tmp_path):
    from neuronx_distributed_training_torch.telemetry import trace_analysis as t_ta

    import test_torch_trace as tt

    events = tt.relabel(tt._events(tt.FIXTURES[0]))
    summary = t_ta.analyze_events(events, top_k=10)
    (tmp_path / "trace_summary.json").write_text(json.dumps(summary))
    assert summary.get("overlap_by_class"), "the fixture carries no collectives"
    t = t_cm.overlap_from_trace_summary(tmp_path)
    j = j_cm.overlap_from_trace_summary(tmp_path)
    _close(t, j)
    rep_t = t_planner.plan_config(str(TINY), chips=8, topology="cpu", audit=False,
                                  calibration=str(tmp_path / "trace_summary.json"))
    rep_j = j_planner.plan_config(str(TINY), chips=8, topology="cpu", audit=False,
                                  calibration=str(tmp_path / "trace_summary.json"))
    _close({k: v for k, v in rep_t.to_dict().items() if k != "winner"},
           {k: v for k, v in rep_j.to_dict().items() if k != "winner"})


def test_comms_calibration_equals_jax(tmp_path):
    doc = {"kind": "comms_summary", "prior": {"ici_bandwidth_bytes": 2e9},
           "axes": {"dp": {"fit": {"bandwidth_bytes_per_s": 1.2e9}},
                    "tp": {"bandwidth_ratio": 80.0}, "pp": {"fit": {}}}}
    path = tmp_path / "comms_summary.json"
    path.write_text(json.dumps(doc))
    assert t_cm.comms_calibration_from_summary(path) == j_cm.comms_calibration_from_summary(path)
    for bad in ({"axes": {}, "prior": {}}, {"axes": [1], "prior": {}}):
        with pytest.raises(ValueError) as te:
            t_cm.comms_calibration_from_summary(bad)
        with pytest.raises(ValueError) as je:
            j_cm.comms_calibration_from_summary(bad)
        assert str(te.value) == str(je.value)


@pytest.fixture(scope="module")
def autotune_run(tmp_path_factory):
    """One CLI run of tiny_smoke with ``--autotune 2`` on the CPU (the
    memory plane on, as the config has it)."""
    exp = tmp_path_factory.mktemp("autotune")
    t_loop._logged_ignored.clear()
    history = t_cli.main(["--config", str(TINY), "--device", "cpu", "--autotune", "2",
                          "--set", "trainer.max_steps=2", "--set", f"exp_manager.exp_dir={exp}",
                          "--set", "exp_manager.create_tensorboard_logger=false"])
    run = exp / "tiny_smoke" / "version_0"
    return {"history": history, "run": run,
            "summary": json.loads((run / "run_summary.json").read_text())}


def test_cli_autotune_imposes_and_records_the_winner(autotune_run):
    s = autotune_run["summary"]
    at = s["autotune"]
    t = t_planner.plan_config(str(TINY), chips=1, topology="cpu", top_k=2, device="cpu")
    assert at["winner"] == t.to_dict()["winner"]
    assert s["autotune_plan"] == t.winner.plan.describe()
    assert all(c["audit"]["verdict"] == "clean" and c["audit"]["device"] == "cpu"
               for c in at["candidates"])
    assert len(autotune_run["history"]) == 2
    assert all(math.isfinite(h["loss"]) for h in autotune_run["history"])


def test_memory_summary_carries_the_prediction_and_calibrates(autotune_run):
    mem_path = autotune_run["run"] / "memory_summary.json"
    doc = json.loads(mem_path.read_text())
    # the breakdown of the config as it ran: the winner imposed
    winner = t_space.Plan(**autotune_run["summary"]["autotune"]["winner"])
    facts = t_space.ModelFacts.from_config(t_load(str(TINY)))
    cfg = t_load(str(TINY), winner.overrides(facts))
    assert doc["predicted"] == t_cm.predicted_breakdown_for_config(cfg, 1)
    assert autotune_run["summary"]["memory"]["predicted_hbm_bytes"] == doc["predicted"]["total"]
    _close(t_cm.hbm_calibration_from_memory_summary(mem_path),
           j_cm.hbm_calibration_from_memory_summary(mem_path))


def test_cli_refuses_a_winner_that_does_not_fit(tmp_path):
    """Nothing fits: JAX's "no surviving plan" text (JAX's winner ignores
    the fit; the port's CLI does not impose a plan the model says OOMs)."""
    with pytest.raises(SystemExit, match=r"autotune: no surviving plan for 1 chips \(none of "
                                         r"the 9 plans fits 0.9 of the card's memory"):
        t_cli.build(["--config", str(CONF / "hf_llama3_8B_config.yaml"), "--device", "cpu",
                     "--autotune", "--set", "distributed_strategy.tensor_model_parallel_size=1",
                     "--set", "distributed_strategy.sequence_parallel=false",
                     "--set", "data.global_batch_size=4", "--set", "data.train_dir=null",
                     "--set", "data.synthetic=true", "--set", f"exp_manager.exp_dir={tmp_path}"])


#: phase 4's cell of chip_smoke.py (tools/step_times.py): the flagship on one
#: card at 4 layers, gbs 4, as declared (selective remat, mbs 1)
CELL = {"model.num_layers": 4, "distributed_strategy.tensor_model_parallel_size": 1,
        "distributed_strategy.sequence_parallel": False, "data.global_batch_size": 4}


def test_h100_fit_keeps_a_declared_plan_that_fits():
    """The h100 entry prices the fit at its measured peak / predicted
    ratio: at phase 4's cell the declared plan (which peaks at 54.24 GiB on
    the card) fits, so the winner is no slower than it (not full remat);
    at the flagship's 32 layers nothing fits."""
    flagship = str(CONF / "hf_llama3_8B_config.yaml")
    rep = t_planner.plan_config(flagship, chips=1, topology="h100", audit=False,
                                overrides=CELL, top_k=9)
    d = rep.facts.declared_plan_for(1)
    declared = next(c for c in rep.candidates if (c.plan.micro_batch_size, c.plan.remat)
                    == (d.micro_batch_size, d.remat))
    assert (d.micro_batch_size, d.remat) == (1, "selective") and declared.estimate.fits
    w = rep.winner
    assert w.estimate.fits and w.plan.remat != "full"
    assert w.estimate.step_seconds <= declared.estimate.step_seconds
    assert "HBM fit: the model's total x 0.753" in rep.format()
    full = t_planner.plan_config(flagship, chips=1, topology="h100", audit=False,
                                 overrides={**CELL, "model.num_layers": 32})
    assert full.n_fit == 0


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """Without a card, pricing and auditing need ``--device cpu`` (or a
    named topology): neither quietly takes the CPU."""
    import torch

    from neuronx_distributed_training_torch.analysis import graph_audit as t_ga

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_topo.pricing_device()
    assert t_topo.pricing_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_planner.plan_config(str(TINY), chips=1, audit=False)
    assert t_planner.plan_config(str(TINY), chips=1, audit=False,
                                 device="cpu").topology == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ga.audit_devices(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ga.audit_config(str(TINY), max_devices=1)
    assert t_ga.audit_devices("cpu") == ("cpu", 0)
    from neuronx_distributed_training_torch.tools import plan as t_plan
    from neuronx_distributed_training_torch.tools import preflight_audit as t_pf

    for main in (t_plan.main, t_pf.main):
        with pytest.raises(SystemExit) as e:
            main(["--config", str(TINY)])
        assert e.value.code == 2


def test_trace_flag_parses_as_jax():
    assert t_cli.trace_overrides(None) == {}
    assert t_cli.trace_overrides("") == {"exp_manager.telemetry.trace.enabled": True}
    assert t_cli.trace_overrides("4:2") == {"exp_manager.telemetry.trace.enabled": True,
                                            "exp_manager.telemetry.trace.start_step": 4,
                                            "exp_manager.telemetry.trace.num_steps": 2}
    with pytest.raises(SystemExit, match=r"--trace wants START\[:NUM\] step numbers, got 'x:1'"):
        t_cli.trace_overrides("x:1")
    args = t_cli.parser().parse_args(["--config", "c.yaml", "--trace"])
    assert args.trace == ""
    cfg = t_load(str(TINY), t_cli.trace_overrides("3"))
    assert cfg["exp_manager"]["telemetry"]["trace"]["start_step"] == 3


def test_plan_tool_refuses_a_tpu_topology_and_reports(capsys):
    from neuronx_distributed_training_torch.tools import plan as t_plan

    with pytest.raises(SystemExit):
        t_plan.main(["--config", str(TINY), "--topology", "v5e"])
    assert "unknown topology 'v5e'; known: cpu/h100" in capsys.readouterr().err
    assert t_plan.main(["--config", str(TINY), "--chips", "8", "--topology", "cpu",
                        "--no-audit", "--json", "-"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["reports"][0]
    j = j_planner.plan_config(str(TINY), chips=8, topology="cpu", audit=False).to_dict()
    _close(rep, json.loads(json.dumps(j)))


def test_compile_only_assembles_and_exits(tmp_path):
    """``--compile-only``: the trainer assembled (the kernels built on a
    card), no step trained and no checkpoint written."""
    trainer, history = t_cli.run(["--config", str(TINY), "--device", "cpu", "--compile-only",
                                  "--set", f"exp_manager.exp_dir={tmp_path}",
                                  "--set", "exp_manager.create_tensorboard_logger=false"])
    assert history == [] and trainer.step == 0 and trainer.checkpointer is None
    assert not list(tmp_path.rglob("checkpoints/*"))
