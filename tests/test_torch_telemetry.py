"""The port's fit-loop cadence and telemetry planes against the JAX
package's (``telemetry/``, ``utils/perf.py::Throughput``, the loader's knob
blocks, ``trainer/exp_manager.py`` and the loop), on the CPU.

- ``SpanTimer``, ``RecompileDetector``, ``Throughput`` and the
  ``exp_manager.telemetry`` / ``elastic`` / ``overlap`` knob blocks on the
  same inputs as JAX's: the same outputs, or the same error texts (the
  cases of ``tests/test_telemetry.py`` and ``tests/test_config.py::
  TestUnknownKnobRejection``);
- the dispatch-ahead contract (JAX's ``TestDispatchAheadContract``): a stub
  step whose metrics count their ``float()``; at ``log_every_n_steps: 3``
  over 6 steps they are read after steps 2 and 5 only, and the train step
  with the skip policy reads no tensor on the host;
- the cadence changes no number: at ``log_every_n_steps`` 3 the losses,
  grad norms and counters equal those at 1, bit for bit;
- a tiny config through both trainers with the flagship's telemetry block
  and an EMA: the boundary records' key sets, ``run_summary.json``'s
  sections (JAX's ``memory_analysis`` is the port's ``memory``), and the
  EMA after 3 steps (fp32, 1e-6 relative);
- the flight recorder (JAX's ``tests/test_health.py`` monitor cases on both
  sides: the same bundles), ``halt`` at a boundary, the watchdog's fire
  path through its seam;
- the warm start: params bit for bit from the saved ones, step and moments
  fresh.
"""

import importlib.util
import json
import logging
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.optim import adamw as t_adamw
from neuronx_distributed_training_torch.telemetry import config as t_tel
from neuronx_distributed_training_torch.telemetry import flight_recorder as t_fr
from neuronx_distributed_training_torch.telemetry import recompile as t_rc
from neuronx_distributed_training_torch.telemetry import spans as t_spans
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.utils import perf as t_perf
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.telemetry import flight_recorder as j_fr
from neuronx_distributed_training_tpu.telemetry import recompile as j_rc
from neuronx_distributed_training_tpu.telemetry import spans as j_spans
from neuronx_distributed_training_tpu.utils import perf as j_perf

WORKER = Path(__file__).resolve().parent / "_torch_dp_worker.py"

#: the flagship's exp_manager.telemetry block (hf_llama3_8B_config.yaml)
FLAGSHIP_TELEMETRY = {"spans": True, "mfu": True, "compile_census": True, "device_memory": True,
                      "goodput": True,
                      "health": {"enabled": True, "policy": "skip_update",
                                 "ring_buffer_steps": 64, "watchdog_timeout_seconds": 1800},
                      "tensorstats": {"enabled": False}}


def tiny_cfg(tmp_path, *, exp="exp", max_steps=3, log_every=1, every=0, telemetry=None,
             ema=None, extra_em=None, precision="fp32", **over):
    em = {"exp_dir": str(tmp_path / exp), "create_tensorboard_logger": False,
          "log_files": False, "resume_if_exists": True,
          "checkpoint_callback_params": {"save_top_k": 5, "every_n_train_steps": every}}
    if telemetry is not None:
        em["telemetry"] = telemetry
    if ema is not None:
        em["ema"] = ema
    em.update(extra_em or {})
    cfg = {"name": "tel", "model_source": "hf", "seed": 7,
           "trainer": {"max_steps": max_steps, "log_every_n_steps": log_every},
           "exp_manager": em,
           "data": {"global_batch_size": 8, "micro_batch_size": 4, "seq_length": 32,
                    "synthetic": True},
           "model": {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
                     "num_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                     "max_position_embeddings": 32,
                     "optim": {"name": "adamw_fp32OptState", "lr": 1e-3,
                               "sched": {"name": "CosineAnnealing", "warmup_steps": 1,
                                         "max_steps": max_steps}}},
           "precision": {"type": precision}}
    for dotted, v in over.items():
        cur = cfg
        parts = dotted.split("__")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return cfg


def _trainer(cfg, **kw):
    return t_loop.Trainer.from_config(t_loader.load_config(cfg), device="cpu", **kw)


def _records(trainer) -> list:
    return [json.loads(x) for x in (trainer.exp.log_dir / "metrics.jsonl").read_text().splitlines()]


def _summary(log_dir) -> dict:
    return json.loads((Path(log_dir) / "run_summary.json").read_text())


# ---------------------------------------------------------------------------
# the stdlib pieces against JAX's, on the same inputs
# ---------------------------------------------------------------------------


def test_span_timer_matches_jax():
    for mod in (t_spans, j_spans):
        assert mod.NON_PRODUCTIVE_SPANS == j_spans.NON_PRODUCTIVE_SPANS
    got = []
    for mod in (t_spans, j_spans):
        spans = mod.SpanTimer()
        spans.add("checkpoint", 2.0)
        out = [spans.drain(), spans.drain()]
        spans.add("checkpoint", 1.0)
        spans.add("dispatch", 5.0)
        spans.add("validate", 1.5)
        spans.add("compile", 2.0)
        out += [spans.nonproductive_seconds(), spans.take_excluded(), spans.take_excluded(),
                spans.snapshot()]
        summary = spans.goodput_summary()
        out += [summary["nonproductive_seconds"], summary["breakdown_seconds"],
                summary["goodput_fraction"]]
        off = mod.SpanTimer(enabled=False)
        with off.span("validate"):
            pass
        off.add("checkpoint", 9.0)
        out += [off.drain(), off.take_excluded()]
        got.append(out)
    assert got[0] == got[1]
    # the decomposition covers the wall and never exceeds it
    spans = t_spans.SpanTimer()
    t0 = time.perf_counter()
    with spans.span("data_wait"):
        time.sleep(0.01)
    with spans.span("host_sync"):
        time.sleep(0.005)
    wall = time.perf_counter() - t0
    total = sum(spans.drain().values())
    assert wall - 0.02 <= total <= wall + 1e-6


def test_recompile_detector_matches_jax(caplog):
    b1 = {"input_ids": np.zeros((8, 32), np.int32), "loss_mask": np.ones((8, 32), np.float32)}
    b2 = {"input_ids": np.zeros((5, 32), np.int32), "loss_mask": np.ones((5, 32), np.float32)}
    b3 = {**b1, "segment_ids": np.zeros((8, 32), np.int32)}
    results = []
    for mod in (t_rc, j_rc):
        det = mod.RecompileDetector()
        with caplog.at_level(logging.WARNING, logger=mod.__name__):
            caplog.clear()
            checks = [det.check("train_step", b) for b in (b1, b1, b2, b3, b3)]
            checks.append(det.check("eval_step", b2))
            msgs = [r.getMessage() for r in caplog.records]
        results.append((checks, det.events, det.signature("train_step"), msgs))
    assert results[0] == results[1]
    assert results[0][0] == [False, False, True, True, False, False]
    assert "8,32" in results[0][3][0] and "5,32" in results[0][3][0]
    assert "added" in results[0][1][-1]
    # a tensor batch signs as its numpy twin
    det = t_rc.RecompileDetector()
    det.check("f", {k: torch.as_tensor(v) for k, v in b1.items()})
    assert det.signature("f") == results[0][2] or det.signature("f") == \
        j_rc._signature((b1,))


def test_throughput_matches_jax():
    out = []
    for mod in (t_perf, j_perf):
        t = mod.Throughput(batch_size=8, window=3, seq_len=32)
        vals = [t.tokens_per_sec]
        for dt, n in ((0.001, 1), (1.0, 2), (1.0, 1), (0.5, 3), (2.0, 1)):
            vals += [t.update(dt, num_steps=n), t.peak, t.last, t.tokens_per_sec, t.total_seqs]
        small = mod.Throughput(batch_size=8, window=1)
        small.update(1.0)
        vals.append(small.peak)
        out.append(vals)
    assert out[0] == out[1]
    assert out[0][2] == 0.0  # no phantom peak before min(window, 3) samples
    assert t_perf.detect_peak_tflops("cpu") == j_perf.PEAK_TFLOPS_PER_CHIP["cpu"]


def test_exp_manager_step_timed_and_mfu_match_jax(tmp_path, monkeypatch):
    from neuronx_distributed_training_torch.trainer import exp_manager as t_em
    from neuronx_distributed_training_tpu.trainer import exp_manager as j_em

    got = []
    for mod, kw in ((t_em, {}), (j_em, {})):
        clock = {"t": 100.0}
        monkeypatch.setattr(mod.time, "perf_counter", lambda: clock["t"])
        exp = mod.ExpManager(exp_dir=str(tmp_path / mod.__name__.split(".")[0]),
                             log_files=False, create_tensorboard_logger=False,
                             global_batch_size=4, seq_len=128, log_every_n_steps=1, **kw)
        exp.set_mfu_reference(train_step_flops_per_token=6e6, n_chips=2,
                              peak_tflops_per_chip=0.5)
        first = exp.step_timed()
        clock["t"] = 110.0
        dt = exp.step_timed(2, exclude_seconds=6.0)
        exp.log_metrics(2, {"loss": 1.0})
        exp.close()
        rec = json.loads((exp.log_dir / "metrics.jsonl").read_text().splitlines()[-1])
        got.append((first, dt, exp.throughput.last, rec))
    assert got[0] == got[1]
    assert got[0][1] == pytest.approx(2.0)
    assert {"throughput_seqs_per_sec", "throughput_peak", "tokens_per_sec_per_chip",
            "mfu"} <= got[0][3].keys()


# ---------------------------------------------------------------------------
# the knob blocks: JAX's texts
# ---------------------------------------------------------------------------

def _base(**over):
    cfg = {"distributed_strategy": {"tensor_model_parallel_size": 1},
           "data": {"global_batch_size": 8, "micro_batch_size": 1, "seq_length": 64},
           "model": {"num_layers": 4, "num_attention_heads": 4}}
    for dotted, v in over.items():
        cur = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return cfg


KNOB_REJECTIONS = {
    "telemetry_typo": {"exp_manager.telemetry.spanss": True},
    "telemetry_not_mapping": {"exp_manager.telemetry": [1, 2]},
    "telemetry_not_bool": {"exp_manager.telemetry.mfu": "yes"},
    "telemetry_far_key": {"exp_manager.telemetry.zzz": True},
    "health_typo": {"exp_manager.telemetry.health.polcy": "halt"},
    "health_policy": {"exp_manager.telemetry.health.policy": "explode"},
    "health_not_mapping": {"exp_manager.telemetry.health": [1]},
    "watchdog_without_monitor": {"exp_manager.telemetry.health.watchdog_timeout_seconds": 5},
    "trace_typo": {"exp_manager.telemetry.trace.start_stpe": 1},
    "trace_steps": {"exp_manager.telemetry.trace.num_steps": 0},
    "fleet_typo": {"exp_manager.telemetry.fleet.stale_after": 5},
    "fleet_stale": {"exp_manager.telemetry.fleet.stale_after_seconds": 0},
    "alerts_mapping": {"exp_manager.telemetry.alerts": {"metric": "mfu"}},
    "alerts_key": {"exp_manager.telemetry.alerts": [{"metric": "mfu", "below": 1,
                                                     "windw": 2}]},
    "alerts_modes": {"exp_manager.telemetry.alerts": [{"metric": "mfu"}]},
    "alerts_action": {"exp_manager.telemetry.alerts": [{"metric": "mfu", "below": 1,
                                                        "action": "page"}]},
    "alerts_dupes": {"exp_manager.telemetry.alerts": [{"metric": "mfu", "below": 1},
                                                      {"metric": "mfu", "below": 2}]},
    "control_typo": {"exp_manager.telemetry.control.hang_escap": True},
    "control_trail": {"exp_manager.telemetry.control.max_trail": "x"},
    "memory_typo": {"exp_manager.telemetry.memory.profil": True},
    "memory_headroom": {"exp_manager.telemetry.memory.headroom_alert_fraction": 1.5},
    "tensorstats_typo": {"exp_manager.telemetry.tensorstats.pre_clp": True},
    "tensorstats_bins": {"exp_manager.telemetry.tensorstats.hist_hi_exp": -30},
    "elastic_typo": {"exp_manager.elastic.grace_period": 3},
    "elastic_type": {"exp_manager.elastic.save_retries": 1.5},
    "elastic_negative": {"exp_manager.elastic.grace_period_seconds": -1.0},
    "elastic_not_mapping": {"exp_manager.elastic": "on"},
    "overlap_typo": {"distributed_strategy.overlap.zero1_bucket": 4},
    "overlap_type": {"distributed_strategy.overlap.zero1_bucket_mb": "4"},
    "overlap_zero1_off": {"distributed_strategy.overlap.zero1_bucket_mb": 4,
                          "distributed_strategy.zero1": False},
    "overlap_pp": {"distributed_strategy.overlap.pp_double_buffer": True},
    "overlap_not_mapping": {"distributed_strategy.overlap": [1]},
}


@pytest.mark.parametrize("case", sorted(KNOB_REJECTIONS))
def test_knob_block_rejections_match_jax(case):
    over = KNOB_REJECTIONS[case]
    with pytest.raises(ValueError) as je:
        j_loader.load_config(_base(**over))
    with pytest.raises(ValueError) as te:
        t_loader.load_config(_base(**over))
    assert str(te.value) == str(je.value)


def test_telemetry_config_matches_jax():
    from neuronx_distributed_training_tpu.telemetry import config as j_tel

    assert t_tel.TELEMETRY_KNOBS == j_tel.TELEMETRY_KNOBS
    for block in (None, True, False, {"device_memory": True, "goodput": False},
                  FLAGSHIP_TELEMETRY,
                  {"trace": True, "fleet": {"enabled": True}, "memory": {"num_steps": 2},
                   "control": True, "alerts": [{"metric": "data_wait", "threshold": 3.0,
                                                "action": "dump"}]}):
        t, j = t_tel.TelemetryConfig.from_config(block), j_tel.TelemetryConfig.from_config(block)
        assert t.to_dict() == j.to_dict(), block
    assert t_loader.did_you_mean({"spanz", "zzz"}, t_tel.TELEMETRY_KNOBS) == \
        j_loader.did_you_mean({"spanz", "zzz"}, j_tel.TELEMETRY_KNOBS)
    # graph_audit runs (analysis/graph_audit.py on the first step), parsed as JAX parses it
    over = {"exp_manager.telemetry.graph_audit": True}
    t = t_tel.TelemetryConfig.from_config(t_loader.load_config(_base(**over)).exp_manager.telemetry)
    j = j_tel.TelemetryConfig.from_config(j_loader.load_config(_base(**over)).exp_manager.telemetry)
    assert t.graph_audit is True and t.to_dict() == j.to_dict()


# ---------------------------------------------------------------------------
# the cadence: one read of the card per boundary, no number changed
# ---------------------------------------------------------------------------


def test_dispatch_ahead_contract(tmp_path):
    """JAX's ``TestDispatchAheadContract``: a stub step whose metrics count
    their ``float()``; every read happens at a boundary (after steps 2 and
    5 at log_every 3 over 6 steps), none between."""
    t = _trainer(tiny_cfg(tmp_path, max_steps=6, log_every=3))
    conversions: list = []

    class Scalar:
        def __float__(self):
            conversions.append(t.step - 1)  # the last step dispatched
            return 1.0

    t.train_step = lambda params, opt_state, batch: {"loss": Scalar(), "grad_norm": Scalar()}
    history = t.fit()
    assert [h["step"] for h in history] == list(range(6))
    assert conversions and set(conversions) == {2, 5}, conversions
    lines = _records(t)
    assert [r["step"] for r in lines] == [3, 6]


def test_train_step_reads_nothing_on_the_host(tmp_path, monkeypatch):
    """The step path with the skip policy on a NaN batch converts no tensor
    to a host value: ``bool``, ``float``, ``int``, ``item`` and ``tolist``
    raise inside it."""
    t = _trainer(tiny_cfg(tmp_path, telemetry={"health": {"enabled": True,
                                                          "policy": "skip_update"}}))
    batch = next(t.data_module.global_batches())
    batch["loss_mask"] = np.full_like(batch["loss_mask"], np.nan)
    # the first call builds the LR table on the card (a one-time copy)
    t.train_step(t.params, t.opt_state, {k: torch.as_tensor(v) for k, v in batch.items()})

    def refuse(*a, **kw):
        raise AssertionError("a tensor was read on the host inside the step")

    for name in ("__bool__", "__float__", "__int__", "__index__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    metrics = t.train_step(t.params, t.opt_state,
                           {k: torch.as_tensor(v) for k, v in batch.items()})
    monkeypatch.undo()
    assert float(metrics["health/updates_finite"]) == 0.0
    assert int(t.opt_state["step"]) == 0 and int(t.opt_state["health"]["skipped_count"]) == 2


def test_cadence_changes_no_number(tmp_path):
    """The same run at log_every 3 and at 1: every step's loss, grad norm,
    lr and health counters, and the final state, bit for bit (a NaN batch at
    step 1 under skip_update)."""
    mod = _worker()
    tel = {"health": {"enabled": True, "policy": "skip_update"}}
    runs = []
    for every in (1, 3):
        t = _trainer(tiny_cfg(tmp_path, exp=f"e{every}", max_steps=5, log_every=every,
                              telemetry=tel),
                     data_module=mod.NanRows(128, 32, 8, seed=7, step=1, rows=[0, 3]))
        history = t.fit()
        state = {n: p.detach().clone() for n, p in t_llama.named_params(t.params).items()}
        state.update({f"mu/{n}": m.clone() for n, m in t.opt_state["mu"].items()})
        runs.append((history, state, int(t.opt_state["step"])))
    keys = ("loss", "grad_norm", "lr", "health/updates_finite", "health/skipped_count",
            "health/nonfinite_count")
    # bit for bit, the skipped step's NaN loss and norm included
    np.testing.assert_array_equal([[h[k] for k in keys] for h in runs[0][0]],
                                  [[h[k] for k in keys] for h in runs[1][0]])
    assert runs[0][0][1]["health/updates_finite"] == 0.0
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    assert runs[0][2] == runs[1][2] == 4


# ---------------------------------------------------------------------------
# both trainers with the flagship's telemetry block and an EMA
# ---------------------------------------------------------------------------

EMA = {"enable": True, "decay": 0.5, "evaluate_ema_weights_instead": True}


@pytest.fixture(scope="module")
def flagship_runs(tmp_path_factory):
    """One tiny fit of each trainer with the flagship's telemetry block and
    an EMA, from the same weights on the same rows (3 steps, log_every 1,
    validation at step 3)."""
    import jax

    from neuronx_distributed_training_torch.tools.convert import params_from_jax
    from neuronx_distributed_training_tpu.data import SyntheticDataModule as JSynth
    from neuronx_distributed_training_tpu.trainer.loop import Trainer as JTrainer
    from neuronx_distributed_training_torch.data.loader import SyntheticDataModule as TSynth

    tmp = tmp_path_factory.mktemp("flagship")
    over = {"trainer__val_check_interval": 3, "trainer__limit_val_batches": 1}
    jt = JTrainer.from_config(
        j_loader.load_config(tiny_cfg(tmp, exp="jax", telemetry=FLAGSHIP_TELEMETRY, ema=EMA,
                                      **over)),
        devices=jax.devices()[:1], enable_checkpointing=False,
        val_data_module=JSynth(vocab_size=128, seq_len=32, global_batch_size=8, seed=9))
    jparams = jax.tree_util.tree_map(np.asarray, jt.params)
    jt.fit()
    j_ema = {n: t.float() for n, t in t_llama.named_params(params_from_jax(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jt.opt_state["ema"]),
        device="cpu")).items()}
    t = _trainer(tiny_cfg(tmp, exp="port", telemetry=FLAGSHIP_TELEMETRY, ema=EMA, **over),
                 enable_checkpointing=False,
                 val_data_module=TSynth(128, 32, 8, seed=9))
    src = t_llama.named_params(params_from_jax(jparams, device="cpu"))
    with torch.no_grad():
        for n, p in t_llama.named_params(t.params).items():
            p.copy_(src[n])
    t.opt_state = t_adamw.init_opt_state(t_llama.named_params(t.params), t.policy,
                                         health=True, ema=True)
    before = {n: p.detach().clone() for n, p in t_llama.named_params(t.params).items()}
    history = t.fit()
    return {"jax": (_records(jt), _summary(jt.exp.log_dir), j_ema),
            "port": (_records(t), _summary(t.exp.log_dir), t, history, before)}


def test_boundary_records_carry_jax_keys(flagship_runs):
    j_records, _, _ = flagship_runs["jax"]
    t_records, _, _, _, _ = flagship_runs["port"]
    j_keys = set().union(*(r.keys() for r in j_records))
    t_keys = set().union(*(r.keys() for r in t_records))
    # the port's own step metric (PERF.md's) is its one extra key
    assert t_keys - j_keys == {"tokens_per_sec"}, t_keys ^ j_keys
    assert j_keys <= t_keys, j_keys - t_keys
    assert [r["step"] for r in t_records] == [r["step"] for r in j_records]
    assert {"time/data_wait", "time/dispatch", "time/host_sync", "goodput_fraction",
            "throughput_seqs_per_sec", "mfu", "step_time"} <= t_keys


def test_run_summary_carries_jax_sections(flagship_runs):
    _, j_summary, _ = flagship_runs["jax"]
    _, t_summary, _, _, _ = flagship_runs["port"]
    assert (set(j_summary) - {"memory_analysis"}) | {"memory"} <= set(t_summary)
    assert set(t_summary) - set(j_summary) - {"memory"} <= {
        "steps", "resumed", "stop_class", "stop_reason", "checkpoint"}
    for k in ("model_family", "n_chips", "seq_len", "global_batch_size", "pipeline_schedule",
              "bubble_fraction_predicted", "fwd_flops_per_token",
              "train_step_flops_per_token", "peak_tflops_per_chip"):
        assert t_summary[k] == j_summary[k], k
    assert t_summary["compile_seconds"] >= 0.0 and t_summary["memory"] == {}
    assert t_summary["collectives"] == {}  # one process: no collective
    assert set(t_summary["goodput"]) == set(j_summary["goodput"])


def test_ema_matches_jax_and_swaps_back(flagship_runs):
    _, _, j_ema = flagship_runs["jax"]
    _, _, t, history, before = flagship_runs["port"]
    t_ema = t.opt_state["ema"]
    assert set(t_ema) == set(j_ema)
    for n, e in t_ema.items():
        assert e.dtype == torch.float32
        # 1e-6 relative, with a 1e-7 floor: near-zero entries carry the two
        # frameworks' fp32 AdamW rounding (~3e-8 after 3 steps) as a large
        # relative gap
        np.testing.assert_allclose(e.numpy(), j_ema[n].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=n)
    assert np.isfinite(history[-1]["val_loss"])
    # validation ran on the EMA and the params came back bit for bit: they
    # are the master the update wrote (fp32: the params themselves)
    params = t_llama.named_params(t.params)
    assert not all(torch.equal(params[n], t_ema[n]) for n in t_ema)
    saved = {n: p.detach().clone() for n, p in params.items()}
    t.validate(1)
    assert all(torch.equal(saved[n], params[n]) for n in params)
    assert any(not torch.equal(before[n], params[n]) for n in params)


# ---------------------------------------------------------------------------
# the flight recorder and the watchdog
# ---------------------------------------------------------------------------


def _mons(tmp_path, **kw):
    from neuronx_distributed_training_tpu.telemetry.health import HealthConfig as JHealth

    defaults = dict(enabled=True, policy="dump_and_continue", ring_buffer_steps=4)
    defaults.update(kw)
    out = []
    for side, mod, cfg in (("port", t_fr, t_fr.HealthConfig(**defaults)),
                           ("jax", j_fr, JHealth(**defaults))):
        out.append(mod.HealthMonitor(cfg, dump_dir=tmp_path / side,
                                     run_facts={"model_family": "LlamaConfig"}))
    return out


def _bundles(root: Path) -> dict:
    out = {}
    for b in sorted(root.glob("*_*")):
        summary = json.loads((b / "anomaly.json").read_text())
        summary.pop("compile_census")
        out[b.name] = (summary, json.loads((b / "ring.json").read_text()))
    return out


MONITOR_CASES = {
    # (ring depth, max bundles, per step: nonfinite_count, boundaries: (step, count, last bad))
    "healthy": (4, 8, [0, 0, 0, 0, 0], [(5, 0, -1)]),
    "one_bad_step_once": (4, 8, [0, 0, 1, 1], [(4, 1, 2), (5, 1, 2)]),
    "ring_deeper_than_run": (8, 8, [0, 0, 1], [(3, 1, 2)]),
    "ring_rotated": (4, 8, [0, 0, 0, 0, 0, 0, 1], [(7, 1, 6)]),
    "two_bad_in_one_window": (8, 8, [0, 0, 0, 1, 1, 2], [(6, 2, 5)]),
    "bundle_cap": (4, 2, [1, 2, 3], [(2, 1, 1), (3, 2, 2), (4, 3, 3)]),
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_health_monitor_bundles_match_jax(tmp_path, case):
    ring, cap, counts, boundaries = MONITOR_CASES[case]
    mons = _mons(tmp_path, ring_buffer_steps=ring, max_bundles=cap)
    actions = []
    for mon in mons:
        prev = 0
        for s, c in enumerate(counts):
            mon.record(s, {"loss": torch.tensor(float(s)) if mon.__module__.startswith(
                "neuronx_distributed_training_torch") else float(s),
                "health/updates_finite": 0.0 if c > prev else 1.0,
                "health/nonfinite_count": c},
                fingerprint={"arg0['x']": "f32[8]"}, spans={"dispatch": 0.1 * s})
            prev = c
        actions.append([mon.check_boundary(step, {"health/nonfinite_count": float(c),
                                                  "health/last_nonfinite_step": float(last)})
                        for step, c, last in boundaries])
    assert actions[0] == actions[1]
    assert _bundles(tmp_path / "port") == _bundles(tmp_path / "jax")
    assert mons[0].anomalies == mons[1].anomalies
    # a hang bundle reads nothing: the ring's tensors are named, not fetched
    hang = mons[0].dump_hang(99, "host_sync", "stacks")
    ring = json.loads((hang / "ring.json").read_text())
    assert all(set(e["metrics"]) == {"keys"} for e in ring)


def test_watchdog_fires_through_its_seam(tmp_path):
    mon = _mons(tmp_path)[0]
    mon.record(7, {"loss": torch.tensor(1.0), "health/nonfinite_count": torch.tensor(0)})
    aborted = []
    wd = t_fr.HangWatchdog(0.05, mon, abort=True)
    wd._abort_fn = lambda: aborted.append(True)
    with wd.guard("host_sync", 7):
        pass  # a fast block does not fire
    assert not wd.fired
    with wd.guard("host_sync", 7):
        time.sleep(0.4)
    with wd.guard("host_sync", 8):
        time.sleep(0.3)
    assert wd.fired and aborted == [True, True]
    (bundle,) = (tmp_path / "port").glob("hang_*")  # one bundle a process
    assert "thread" in (bundle / "stacks.txt").read_text()
    summary = json.loads((bundle / "anomaly.json").read_text())
    assert summary["kind"] == "hang" and summary["hung_operation"] == "host_sync"
    ring = json.loads((bundle / "ring.json").read_text())
    assert ring[-1]["metrics"] == {"keys": ["health/nonfinite_count", "loss"]}


def _worker():
    spec = importlib.util.spec_from_file_location("_torch_dp_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_halt_stops_at_the_boundary_with_a_bundle(tmp_path):
    """A NaN batch at step 2 under ``halt`` at log_every 2: the loop runs
    on to step 3, the boundary after it finds the counter, writes
    ``anomaly_00000002/`` (and step 3's: the applied update poisoned it)
    and stops there without a checkpoint."""
    t = _trainer(tiny_cfg(tmp_path, max_steps=6, log_every=2, every=2,
                          telemetry={"health": {"enabled": True, "policy": "halt"}}),
                 data_module=_worker().NanRows(128, 32, 8, seed=7, step=2, rows=[1]))
    history = t.fit()
    assert [h["step"] for h in history] == [0, 1, 2, 3]
    assert t.stop_class == "health_halt" and t.checkpointer.committed_steps == [2]
    bundle = t.exp.log_dir / "anomaly_00000002"
    assert (bundle / "anomaly.json").exists() and (bundle / "ring.json").exists()
    ring = json.loads((bundle / "ring.json").read_text())
    assert [e["step"] for e in ring] == [0, 1, 2, 3]
    assert ring[2]["metrics"]["health/updates_finite"] == 0.0
    summary = _summary(t.exp.log_dir)
    assert summary["stop_class"] == "health_halt"
    # halt applies the poisoned update (as in JAX), so step 3 is non-finite
    # too: the window's counter rose by 2 and each bad step has its bundle
    assert summary["anomalies"] == [{"step": s, "bundle": f"anomaly_0000000{s}",
                                     "policy": "halt"} for s in (2, 3)]


# ---------------------------------------------------------------------------
# the warm start
# ---------------------------------------------------------------------------


def test_warm_start_restores_params_bit_for_bit(tmp_path):
    """A run saves at step 2; a second run with ``weight_init_only`` and
    ``resume_from_checkpoint`` on that dir starts from the saved params bit
    for bit (its master and EMA from them), with a fresh step, fresh
    moments and no consumed samples."""
    first = _trainer(tiny_cfg(tmp_path, exp="src", max_steps=2, every=2,
                              precision="mixed_precision"))
    first.fit()
    saved = {n: p.detach().clone() for n, p in t_llama.named_params(first.params).items()}
    warm = _trainer(tiny_cfg(tmp_path, exp="warm", max_steps=4, ema={"enable": True},
                             precision="mixed_precision",
                             extra_em={"resume_from_checkpoint": str(first.checkpointer.directory)},
                             model__weight_init_only=True))
    params = t_llama.named_params(warm.params)
    assert all(torch.equal(params[n], saved[n]) for n in saved)
    o = warm.opt_state
    assert int(o["step"]) == 0 and warm.step == 0 and warm.consumed_samples == 0
    assert all(not bool(m.any()) for m in o["mu"].values())
    for g in ("ema",) + (("master",) if "master" in o else ()):
        assert all(torch.equal(o[g][n], saved[n].float()) for n in saved), g
    assert not warm.maybe_resume()  # its own exp dir holds no checkpoint
