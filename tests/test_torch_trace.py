"""The port's trace plane (``telemetry/trace.py``, ``trace_analysis.py``,
``step_timeline.py``), its profiling windows and the W&B / MLflow sinks
(``trainer/exp_manager.py``), against the JAX package's.

- The analysis on the committed fixtures, relabeled mechanically to
  ``torch.profiler``'s Chrome trace: TPU process lanes become ``GPU <n>``
  kernel lanes on a stream, HLO op names the kernel names the port's
  ``collective_kind_of`` maps (NCCL's for collectives), what JAX drops on a
  device lane a ``gpu_user_annotation``, JAX's step annotation
  ``ProfilerStep#<n>`` and the host's other ops ``cpu_op`` events (which a
  capture with device events ignores).  ``analyze_events`` and
  ``analyze_pipeline`` equal JAX's on the originals: every total, overlap,
  attribution and bubble number to 1e-9, the op table and the lanes up to
  the name map.
- The CPU lane rule on a host capture's shape (gloo's annotations on its
  worker threads, the outermost ``cpu_op`` of the other threads).
- The session guard, the profile window and the capture window with a fake
  profiler (JAX's ``TestSessionGuard``, ``TestExpManagerProfileGuard``,
  ``TestTraceCaptureWindow``), then one real ``torch.profiler`` CPU capture
  through the port's ``Trainer.fit`` on ``tiny_smoke``: the summary is
  written, the raw dir removed, and the repository's ``tools/trace_report.py``
  renders it without importing JAX, as the port's tool does.
- The sinks: stub ``wandb`` and ``mlflow`` modules see the same calls from
  the port's ``ExpManager`` as from JAX's.
"""

import copy
import gzip
import json
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.telemetry import step_timeline as t_st
from neuronx_distributed_training_torch.telemetry import trace as t_trace
from neuronx_distributed_training_torch.telemetry import trace_analysis as t_ta
from neuronx_distributed_training_torch.telemetry.config import TelemetryConfig
from neuronx_distributed_training_torch.trainer import exp_manager as t_exp
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_tpu.telemetry import config as j_tel
from neuronx_distributed_training_tpu.telemetry import step_timeline as j_st
from neuronx_distributed_training_tpu.telemetry import trace as j_trace
from neuronx_distributed_training_tpu.telemetry import trace_analysis as j_ta
from neuronx_distributed_training_tpu.trainer import exp_manager as j_exp

REPO = Path(__file__).resolve().parents[1]
DATA = Path(__file__).parent / "data"
FIXTURES = ("device_trace_fixture.trace.json", "pipeline_trace_fixture.trace.json",
            "pipeline_trace_compacted_fixture.trace.json")
TINY = REPO / "examples" / "conf" / "tiny_smoke_config.yaml"
#: the relabeled fixtures' numbers against JAX's
ATOL = 1e-9

#: JAX's HLO base names -> the kernel names the relabel gives them (NCCL's
#: for the collectives; a ``.N`` uniquifier becomes a template argument)
COLLECTIVE_KERNELS = {
    "all-reduce": "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
    "all-reduce-start": "ncclDevKernel_AllReduce_Sum_f32_RING_SIMPLE",
    "all-gather": "ncclDevKernel_AllGather_RING_LL",
    "all-gather-start": "ncclDevKernel_AllGather_RING_SIMPLE",
    "reduce-scatter": "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL",
    "collective-permute": "ncclDevKernel_SendRecv",
    "collective-permute-start": "ncclDevKernel_SendRecv_",
}


@pytest.fixture(autouse=True)
def _reset_session_guard():
    """The profiler session guard is process-global state."""
    t_trace._SESSION_OWNER, t_trace._SESSION = None, None
    yield
    t_trace._SESSION_OWNER, t_trace._SESSION = None, None


def kernel_of(hlo_base: str) -> str:
    return COLLECTIVE_KERNELS.get(hlo_base, f"{hlo_base.replace('-', '_')}_kernel")


def _jax_keeps(name: str) -> bool:
    bare = name.lstrip("%")
    return bool(j_ta._HLO_NAME_RE.match(name)) and bare not in j_ta._NOT_OPS \
        and not j_ta._COLLECTIVE_DONE_RE.match(bare)


def relabel(events: list) -> list:
    """A JAX (TPU) Chrome trace as ``torch.profiler`` writes a card's (the
    module docstring), event for event."""
    procs = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    out = []
    for e in events:
        e = copy.deepcopy(e)
        proc = procs.get(e.get("pid"), "")
        device = "/device:" in proc
        if e.get("ph") == "M":
            if e.get("name") == "process_name" and device:
                e["args"]["name"] = f"GPU {proc.rsplit(':', 1)[1]}"
            elif e.get("name") == "thread_name" and device:
                e["args"]["name"] = "stream 7"
            out.append(e)
            continue
        name = e["name"]
        if device:
            dev = int(proc.rsplit(":", 1)[1])
            e["args"] = {"device": dev, "stream": 7}
            if _jax_keeps(name):
                bare = name.lstrip("%")
                m = re.match(r"^(.*?)(?:\.(\d+))?$", bare)
                e["cat"] = "kernel"
                e["name"] = f"void {kernel_of(m.group(1))}<{m.group(2) or 0}>(float*)" \
                    if not m.group(1) in COLLECTIVE_KERNELS else \
                    f"{kernel_of(m.group(1))}(ncclDevKernelArgsStorage<4096ul>)"
            else:
                e["cat"] = "gpu_user_annotation"
        elif "step_num" in (e.get("args") or {}):
            e["name"] = f"ProfilerStep#{int(e['args']['step_num'])}"
            e["cat"] = "user_annotation"
            e["args"] = {}
        else:
            e["cat"] = "cpu_op"
        out.append(e)
    return out


def lane_of(jax_lane: str) -> str:
    return f"GPU {jax_lane.rsplit(':', 1)[1]}" if "/device:" in jax_lane else jax_lane


def _events(fixture: str) -> list:
    return json.loads((DATA / fixture).read_text())["traceEvents"]


def _assert_close(a, b, where=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (where, a, b)
        for k in b:
            _assert_close(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{where}[{i}]")
    elif isinstance(b, float) and not isinstance(b, bool):
        assert a == pytest.approx(b, abs=ATOL), (where, a, b)
    else:
        assert a == b, (where, a, b)


def _port_view_of_jax(j: dict) -> dict:
    """JAX's summary with its lane and op names mapped to the relabeled
    trace's."""
    j = copy.deepcopy(j)
    if "devices" in j:
        j["devices"] = sorted(lane_of(d) for d in j["devices"])
    for row in j.get("top_ops", []):
        row["op"] = kernel_of(row["op"])
    pipe = j.get("pipeline", j if "stages" in j else None)
    if pipe is not None:
        pipe["stages"] = {lane_of(k): v for k, v in pipe["stages"].items()}
        pipe["straggler_stage"] = lane_of(pipe["straggler_stage"])
    return j


# ---------------------------------------------------------------------------
# collective kinds and the knob block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kind", [
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "all-reduce"),
    ("ncclKernel_AllReduce_RING_LL_Sum_float(ncclWorkElem)", "all-reduce"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "all-gather"),
    ("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(x)", "reduce-scatter"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", "collective-permute"),
    ("ncclDevKernel_Broadcast_RING_LL(x)", "all-gather"),
    ("ncclDevKernel_Reduce_Sum_f32_RING_LL(x)", "all-reduce"),
    ("gloo:all_reduce", "all-reduce"), ("gloo:all_gather", "all-gather"),
    ("gloo:reduce_scatter", "reduce-scatter"), ("gloo:send", "collective-permute"),
    ("gloo:recv", "collective-permute"), ("gloo:all_to_all", "all-to-all"),
    ("void flash_fwd_kernel(Params)", None), ("aten::mm", None),
    ("c10d::allreduce_", None), ("Memcpy HtoD (Pinned -> Device)", None),
])
def test_collective_kind_of_maps_onto_jax_kinds(name, kind):
    assert t_ta.collective_kind_of(name) == kind
    assert t_ta.COLLECTIVE_KINDS == j_ta.COLLECTIVE_KINDS
    assert t_ta.AXIS_COLLECTIVE_KINDS == __import__(
        "neuronx_distributed_training_tpu.utils.debug", fromlist=["x"]).AXIS_COLLECTIVE_KINDS


@pytest.mark.parametrize("block", [None, True, False, {"enabled": True, "start_step": 5,
                                                       "num_steps": 2, "keep_raw": True},
                                   {"start_stpe": 1}, {"enabled": 1}, {"num_steps": 0},
                                   {"start_step": -1}, [1]])
def test_trace_config_is_jaxs(block):
    def parse(cls):
        try:
            return dataclass_dict(cls.from_config(block))
        except ValueError as e:
            return str(e)

    assert parse(t_trace.TraceConfig) == parse(j_trace.TraceConfig)
    # the block moved out of telemetry/config.py: the telemetry block holds it
    if isinstance(block, (bool, dict)) and not isinstance(parse(j_trace.TraceConfig), str):
        assert TelemetryConfig.from_config({"trace": block}).to_dict() == \
            j_tel.TelemetryConfig.from_config({"trace": block}).to_dict()


def dataclass_dict(x) -> dict:
    import dataclasses

    return dataclasses.asdict(x)


# ---------------------------------------------------------------------------
# the analysis against JAX's, on the relabeled fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture", FIXTURES)
def test_analyze_events_equals_jax_on_relabeled_fixture(fixture):
    events = _events(fixture)
    facts = t_st.pipeline_facts("1f1b", 2, 3, 1, 0.25)
    j = j_ta.analyze_events(events, top_k=10, pipeline=j_st.pipeline_facts("1f1b", 2, 3, 1, 0.25))
    t = t_ta.analyze_events(relabel(events), top_k=10, pipeline=facts)
    _assert_close(t, _port_view_of_jax(j))
    assert t["num_op_events"] > 0 and t["devices"]


@pytest.mark.parametrize("fixture", FIXTURES[1:])
@pytest.mark.parametrize("cut", ["whole", "one_lane", "no_steps", "capped"])
def test_analyze_pipeline_equals_jax_on_relabeled_fixture(fixture, cut):
    events = _events(fixture)
    rel = relabel(events)
    kw = {}
    if cut == "one_lane":  # every stage on one device: the aggregate lane
        events = [e for e in events if e.get("pid") != 2]
        rel = [e for e in rel if e.get("pid") != 2]
    elif cut == "no_steps":  # the span falls back to the ops' extent
        events = [e for e in events if "step_num" not in (e.get("args") or {})]
        rel = [e for e in rel if not str(e.get("name", "")).startswith("ProfilerStep#")]
    elif cut == "capped":
        kw["max_tick_rows"] = 5
    j = j_st.analyze_pipeline(events, facts=j_st.pipeline_facts("1f1b", 2, 3), **kw)
    t = t_st.analyze_pipeline(rel, facts=t_st.pipeline_facts("1f1b", 2, 3), **kw)
    assert j is not None
    _assert_close(t, _port_view_of_jax(j))
    if cut == "one_lane":
        assert t["lane_resolution"] == "aggregate"


def test_multi_device_lanes_do_not_cross_hide():
    s = t_ta.analyze_events(relabel(_events(FIXTURES[0])))
    ag = s["overlap_by_class"]["all-gather"]
    assert ag["wire_seconds"] == pytest.approx(50e-6) and ag["hidden_seconds"] == 0.0
    ar = s["overlap_by_class"]["all-reduce"]
    assert ar["hidden_seconds"] == pytest.approx(60e-6)
    # every stream of a device is one lane: a collective on NCCL's stream is
    # hidden by compute on another stream of the same card
    evs = [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 0, "dur": 100,
            "name": "void gemm_kernel(float*)", "args": {"device": 0, "stream": 7}},
           {"ph": "X", "cat": "kernel", "pid": 0, "tid": 20, "ts": 50, "dur": 100,
            "name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)",
            "args": {"device": 0, "stream": 20}},
           {"ph": "X", "cat": "kernel", "pid": 1, "tid": 7, "ts": 150, "dur": 100,
            "name": "void gemm_kernel(float*)", "args": {"device": 1, "stream": 7}}]
    s = t_ta.analyze_events(evs)
    assert s["devices"] == ["GPU 0", "GPU 1"]
    assert s["overlap_by_class"]["all-reduce"]["hidden_seconds"] == pytest.approx(50e-6)
    assert s["achieved_overlap"] == pytest.approx(0.5)


def test_no_collectives_means_null_overlap():
    evs = [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 0, "dur": 10,
            "name": "void flash_fwd_kernel(Params)", "args": {"device": 0}}]
    s = t_ta.analyze_events(evs)
    assert s["achieved_overlap"] is None and s["collective_seconds"] == 0.0
    assert s["top_ops"][0]["op"] == "flash_fwd_kernel"


def test_cpu_lane_rule():
    """A host capture (no device events): gloo's annotations on its worker
    threads are the collectives, the outermost ``cpu_op`` of the other
    threads the compute; nested ops, the ``c10d::`` dispatch and the ops
    inside gloo's threads are neither; each process is one lane."""
    def x(name, ts, dur, tid, cat="cpu_op", pid=10):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts,
                "dur": dur, "args": {}}

    evs = [
        {"ph": "M", "name": "thread_name", "pid": 10, "tid": 2,
         "args": {"name": "thread 2 (pt_gloo_runloop)"}},
        x("ProfilerStep#4", 0, 1000, 1, "user_annotation"),
        x("aten::linear", 0, 300, 1), x("aten::addmm", 10, 200, 1),  # nested
        x("c10d::allreduce_", 300, 50, 1),
        x("aten::mul", 400, 100, 1),
        x("gloo:all_reduce", 250, 200, 2, "user_annotation"),
        x("aten::copy_", 260, 20, 2),  # inside gloo's thread
        x("aten::mm", 0, 500, 1, pid=11),  # another process: its own lane
    ]
    s = t_ta.analyze_events(evs)
    assert s["devices"] == ["host:10", "host:11"]
    assert s["num_op_events"] == 4
    ar = s["overlap_by_class"]["all-reduce"]
    # [250, 450) against the compute union [0, 300) + [400, 500): 100 us hidden
    assert ar["wire_seconds"] == pytest.approx(200e-6)
    assert ar["hidden_seconds"] == pytest.approx(100e-6)
    assert s["steps"]["4"]["device_seconds"] == pytest.approx(1100e-6)
    assert {o["op"] for o in s["top_ops"]} == {"aten::linear", "aten::mul", "gloo:all_reduce",
                                               "aten::mm"}


def test_load_from_gz_and_directory(tmp_path):
    doc = {"traceEvents": relabel(_events(FIXTURES[0]))}
    want = t_ta.analyze_events(doc["traceEvents"])
    d = tmp_path / "trace"
    d.mkdir()
    with gzip.open(d / "rank0.1.pt.trace.json.gz", "wt") as f:
        json.dump(doc, f)
    s = t_ta.analyze_trace_dir(d)
    assert s["num_op_events"] == want["num_op_events"]
    assert s["achieved_overlap"] == want["achieved_overlap"]
    with pytest.raises(FileNotFoundError):
        t_ta.load_trace_events(tmp_path / "empty_does_not_exist_dir_is_a_file")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        t_ta.load_trace_events(tmp_path / "empty")
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "trace_summary.json").write_text(json.dumps(want))
    assert t_ta.load_trace_summary(tmp_path / "run") == json.loads(json.dumps(want))


# ---------------------------------------------------------------------------
# the session guard and the windows (a fake profiler)
# ---------------------------------------------------------------------------


class _FakeProfiler:
    """Counts starts and stops; a stop without a live session raises, as
    torch.profiler's does."""

    def __init__(self):
        self.starts = self.stops = 0
        self.active = False
        self.dirs = []

    def open(self, log_dir, cuda, worker):
        fake = self

        class Prof:
            def start(self):
                if fake.active:
                    raise RuntimeError("profiler already started")
                fake.active = True
                fake.starts += 1
                fake.dirs.append((log_dir, cuda, worker))

            def stop(self):
                if not fake.active:
                    raise RuntimeError("No profiler session active")
                fake.active = False
                fake.stops += 1
        return Prof()


@pytest.fixture()
def fake_profiler(monkeypatch):
    fake = _FakeProfiler()
    monkeypatch.setattr(t_trace, "_open_profiler", fake.open)
    return fake


class TestSessionGuard:
    def test_start_stop_round_trip(self, tmp_path, fake_profiler):
        assert t_trace.start_session(str(tmp_path), "a")
        assert t_trace.session_owner() == "a"
        assert t_trace.stop_session("a")
        assert t_trace.session_owner() is None
        assert fake_profiler.starts == 1 and fake_profiler.stops == 1
        assert fake_profiler.dirs == [(str(tmp_path), False, None)]

    def test_second_owner_refused_not_raised(self, tmp_path, fake_profiler, caplog):
        assert t_trace.start_session(str(tmp_path), "a")
        with caplog.at_level("WARNING"):
            assert not t_trace.start_session(str(tmp_path), "b")
        assert fake_profiler.starts == 1
        assert "'a' already holds the session" in caplog.text

    def test_stop_by_non_owner_is_noop(self, tmp_path, fake_profiler):
        assert t_trace.start_session(str(tmp_path), "a")
        assert not t_trace.stop_session("b")
        assert fake_profiler.stops == 0
        assert t_trace.stop_session("a")

    def test_double_stop_never_raises(self, tmp_path, fake_profiler):
        assert t_trace.start_session(str(tmp_path), "a")
        assert t_trace.stop_session("a")
        assert not t_trace.stop_session("a")
        assert fake_profiler.stops == 1

    def test_out_of_band_stop_swallowed(self, tmp_path, fake_profiler):
        assert t_trace.start_session(str(tmp_path), "a")
        t_trace._SESSION.stop()  # someone else closed the profiler
        assert not t_trace.stop_session("a")  # logged, not raised


class TestExpManagerProfileGuard:
    def _exp(self, tmp_path, **kw):
        return t_exp.ExpManager(exp_dir=str(tmp_path), log_files=False,
                                create_tensorboard_logger=False, **kw)

    def test_teardown_after_closed_window_does_not_double_stop(self, tmp_path, fake_profiler):
        exp = self._exp(tmp_path, profile_start_step=1, profile_num_steps=1, trace_cuda=True,
                        rank=3)
        exp.maybe_profile(1)
        assert fake_profiler.starts == 1 and exp.profile_active
        assert fake_profiler.dirs == [(str(exp.log_dir / "profile"), True, "rank3")]
        exp.maybe_profile(2)
        assert fake_profiler.stops == 1 and not exp.profile_active
        exp.close()
        assert fake_profiler.stops == 1

    def test_teardown_closes_a_still_open_window_once(self, tmp_path, fake_profiler):
        exp = self._exp(tmp_path, profile_start_step=1, profile_num_steps=5)
        exp.maybe_profile(1)
        exp.close()
        assert fake_profiler.stops == 1
        exp.close()
        assert fake_profiler.stops == 1

    def test_profile_window_yields_to_live_trace_capture(self, tmp_path, fake_profiler):
        t_trace.start_session(str(tmp_path / "t"), "telemetry.trace")
        exp = self._exp(tmp_path, profile_start_step=1, profile_num_steps=1)
        exp.maybe_profile(1)
        assert fake_profiler.starts == 1
        exp.close()
        assert fake_profiler.stops == 0

    def test_profile_off_by_default(self, tmp_path, fake_profiler):
        exp = self._exp(tmp_path)
        for step in range(4):
            exp.maybe_profile(step)
        assert fake_profiler.starts == 0 and not exp.profile_active


def _fixture_dir(log_dir, name="rank0.1.pt.trace.json"):
    d = Path(log_dir)
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text(json.dumps({"traceEvents": relabel(_events(FIXTURES[0]))}))


class TestTraceCaptureWindow:
    def _capture(self, tmp_path, monkeypatch, **cfg_kw):
        def fake_start(log_dir, owner, **kw):
            _fixture_dir(log_dir)
            return True

        monkeypatch.setattr(t_trace, "start_session", fake_start)
        monkeypatch.setattr(t_trace, "stop_session", lambda owner: True)
        return t_trace.TraceCapture(t_trace.TraceConfig(enabled=True, **cfg_kw), tmp_path)

    def test_window_produces_summary_and_cleans_raw(self, tmp_path, monkeypatch):
        cap = self._capture(tmp_path, monkeypatch, start_step=2, num_steps=2)
        assert cap.maybe_update(0) is None
        assert cap.maybe_update(2) is None and cap.active
        assert cap.maybe_update(3) is None and cap.active
        summary = cap.maybe_update(4)
        assert summary is not None and cap.done
        assert summary["achieved_overlap"] == pytest.approx(1 / 3, abs=1e-5)
        assert summary["window"] == {"start_step": 2, "num_steps": 2}
        on_disk = json.loads((tmp_path / "trace_summary.json").read_text())
        assert on_disk["achieved_overlap"] == summary["achieved_overlap"]
        assert not (tmp_path / "trace").exists()
        assert cap.maybe_update(5) is None

    def test_keep_raw(self, tmp_path, monkeypatch):
        cap = self._capture(tmp_path, monkeypatch, start_step=0, num_steps=1, keep_raw=True)
        cap.maybe_update(0)
        assert cap.maybe_update(1) is not None
        assert (tmp_path / "trace").exists()

    def test_close_inside_window_analyzes(self, tmp_path, monkeypatch):
        cap = self._capture(tmp_path, monkeypatch, start_step=0, num_steps=100)
        cap.maybe_update(0)
        assert cap.close() is not None
        assert (tmp_path / "trace_summary.json").exists()
        assert cap.close() is None

    def test_disabled_is_inert(self, tmp_path):
        cap = t_trace.TraceCapture(t_trace.TraceConfig(enabled=False), tmp_path)
        assert cap.maybe_update(1) is None and not cap.active
        assert cap.close() is None

    def test_busy_session_retries_within_window(self, tmp_path, monkeypatch):
        busy = {"until": 1}

        def fake_start(log_dir, owner, **kw):
            if busy["until"] > 0:
                busy["until"] -= 1
                return False
            _fixture_dir(log_dir)
            return True

        monkeypatch.setattr(t_trace, "start_session", fake_start)
        monkeypatch.setattr(t_trace, "stop_session", lambda owner: True)
        cap = t_trace.TraceCapture(t_trace.TraceConfig(enabled=True, start_step=1,
                                                       num_steps=2), tmp_path)
        assert cap.maybe_update(1) is None and not cap.active
        assert cap.maybe_update(2) is None and cap.active
        assert cap.maybe_update(3) is not None

    def test_window_fully_missed_gives_up_once(self, tmp_path, monkeypatch):
        calls = {"n": 0}

        def always_busy(log_dir, owner, **kw):
            calls["n"] += 1
            return False

        monkeypatch.setattr(t_trace, "start_session", always_busy)
        cap = t_trace.TraceCapture(t_trace.TraceConfig(enabled=True, start_step=1,
                                                       num_steps=2), tmp_path)
        for step in range(6):
            assert cap.maybe_update(step) is None
        assert cap.done and calls["n"] == 2

    def test_writer_gathers_every_ranks_file_others_do_not_analyze(self, tmp_path,
                                                                   monkeypatch):
        """Two ranks: each writes its own file; the non-writer analyzes
        nothing and leaves ``trace/``, the writer waits for both files and
        analyzes them together."""
        monkeypatch.setattr(t_trace, "stop_session", lambda owner: True)
        monkeypatch.setattr(t_trace, "GATHER_SECONDS", 5.0)
        cfg = t_trace.TraceConfig(enabled=True, start_step=0, num_steps=1)
        ranks = []
        for r in (1, 0):
            monkeypatch.setattr(t_trace, "start_session",
                                lambda log_dir, owner, r=r, **kw: _fixture_dir(
                                    log_dir, f"rank{r}.1.pt.trace.json") or True)
            cap = t_trace.TraceCapture(cfg, tmp_path, rank=r, world=2, writer=r == 0)
            cap.maybe_update(0)
            ranks.append(cap)
        assert ranks[0].maybe_update(1) is None and (tmp_path / "trace").exists()
        summary = ranks[1].maybe_update(1)
        one = t_ta.analyze_events(relabel(_events(FIXTURES[0])))
        assert summary["num_op_events"] == 2 * one["num_op_events"]
        assert not (tmp_path / "trace").exists()


def test_exp_manager_records_trace_section(tmp_path, monkeypatch):
    def fake_start(log_dir, owner, **kw):
        d = Path(log_dir)
        d.mkdir(parents=True, exist_ok=True)
        (d / "rank0.1.pt.trace.json").write_text(json.dumps(
            {"traceEvents": relabel(_events(FIXTURES[1]))}))
        return True

    monkeypatch.setattr(t_trace, "start_session", fake_start)
    monkeypatch.setattr(t_trace, "stop_session", lambda owner: True)
    tel = TelemetryConfig.from_config({"trace": {"enabled": True, "start_step": 0,
                                                 "num_steps": 1}})
    exp = t_exp.ExpManager(exp_dir=str(tmp_path), log_files=False,
                           create_tensorboard_logger=False, telemetry=tel)
    exp.set_pipeline_facts(t_st.pipeline_facts("1f1b", 2, 3, 1, 0.25))
    exp.maybe_trace(0)
    assert exp.trace_active
    exp.maybe_trace(1)
    run = json.loads((exp.log_dir / "run_summary.json").read_text())
    assert run["trace"]["pipeline"]["lane_resolution"] == "device"
    assert run["bubble_fraction_measured"] == pytest.approx(0.15625)
    assert run["trace"]["summary_path"] == str(exp.log_dir / "trace_summary.json")
    exp.close()


# ---------------------------------------------------------------------------
# a real torch.profiler capture through the port's trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traced")
    cfg = t_loader.load_config(TINY, {
        "exp_manager.exp_dir": str(tmp), "trainer.max_steps": 5,
        "exp_manager.create_tensorboard_logger": False,
        "exp_manager.checkpoint_callback_params.every_n_train_steps": 0,
        "exp_manager.telemetry.trace": {"enabled": True, "start_step": 1, "num_steps": 2},
        "exp_manager.profile_start_step": 4, "exp_manager.profile_num_steps": 1})
    annotated = []
    real = t_loop.step_annotation

    def counted(step):
        annotated.append(step)
        return real(step)

    t_loop.step_annotation = counted
    try:
        trainer = t_loop.Trainer.from_config(cfg, device="cpu")
        history = trainer.fit()
    finally:
        t_loop.step_annotation = real
    return trainer.exp.log_dir, history, annotated


def test_real_capture_writes_summary_and_removes_raw(traced_run):
    log_dir, history, annotated = traced_run
    assert len(history) == 5
    s = json.loads((log_dir / "trace_summary.json").read_text())
    assert s["window"] == {"start_step": 1, "num_steps": 2}
    assert set(s["steps"]) == {"1", "2"}  # the window's steps alone
    assert s["devices"] and all(d.startswith("host:") for d in s["devices"])
    assert s["num_op_events"] > 0 and s["achieved_overlap"] is None
    for step in s["steps"].values():
        assert 0 < step["device_seconds"] == pytest.approx(step["compute_seconds"])
    assert not (log_dir / "trace").exists()
    run = json.loads((log_dir / "run_summary.json").read_text())
    assert run["trace"]["window"] == s["window"]
    # the profile window (step 4, closed at teardown) wrote its trace for
    # TensorBoard's plugin
    assert sorted(p.name.split(".")[0] for p in (log_dir / "profile").glob("*.pt.trace.json")) \
        == ["rank0"]
    # the steps of the two windows are annotated, no other
    assert annotated == [1, 2, 4]


def test_steady_summary_drops_the_windows_first_step(tmp_path):
    """``tools/step_times.py``'s steady-state re-analysis of a kept raw
    window: the window's first step (the profiler's start) is cut."""
    from neuronx_distributed_training_torch.tools import step_times

    cfg = t_loader.load_config(TINY, {
        "exp_manager.exp_dir": str(tmp_path), "trainer.max_steps": 4,
        "exp_manager.create_tensorboard_logger": False,
        "exp_manager.checkpoint_callback_params.every_n_train_steps": 0,
        "exp_manager.telemetry": {"trace": {"enabled": True, "start_step": 1, "num_steps": 3,
                                            "keep_raw": True}}})
    trainer = t_loop.Trainer.from_config(cfg, device="cpu")
    trainer.fit()
    whole = json.loads((trainer.exp.log_dir / "trace_summary.json").read_text())
    steady = step_times.steady_summary(trainer.exp.log_dir / "trace", None)
    assert set(whole["steps"]) == {"1", "2", "3"} and set(steady["steps"]) == {"2", "3"}
    assert 0 < steady["total_device_seconds"] < whole["total_device_seconds"]
    assert trainer.exp.trace_pipeline is not None and "pipeline" not in steady


def test_repo_trace_report_renders_port_summary_without_jax(traced_run):
    log_dir, _, _ = traced_run
    code = ("import runpy, sys\n"
            f"sys.argv = ['trace_report', {str(log_dir)!r}]\n"
            "try:\n"
            f"    runpy.run_path({str(REPO / 'tools' / 'trace_report.py')!r}, "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n")
    repo = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert repo.returncode == 0, repo.stderr[-2000:]
    port = subprocess.run([sys.executable, "-m",
                           "neuronx_distributed_training_torch.tools.trace_report",
                           str(log_dir)], capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert port.returncode == 0, port.stderr[-2000:]
    assert "device-time trace (steps 1..2)" in repo.stdout
    assert "per-step device-time attribution" in repo.stdout
    assert port.stdout.strip() == repo.stdout.split("\ncalibrate the launch planner")[0].strip()


# ---------------------------------------------------------------------------
# the W&B and MLflow sinks
# ---------------------------------------------------------------------------


def _stub_sinks(calls: list) -> dict:
    wandb = types.ModuleType("wandb")

    class Run:
        def log(self, flat, step=None):
            calls.append(("wandb.log", dict(flat), step))

        def finish(self):
            calls.append(("wandb.finish",))

    def init(**kw):
        calls.append(("wandb.init", sorted(kw)))
        return Run()

    wandb.init = init
    mlflow = types.ModuleType("mlflow")
    mlflow.set_tracking_uri = lambda uri: calls.append(("mlflow.uri", uri.split("/")[-1]))
    mlflow.set_experiment = lambda name: calls.append(("mlflow.experiment", name))
    mlflow.start_run = lambda run_name=None: calls.append(("mlflow.start_run", run_name))
    mlflow.log_metrics = lambda flat, step=None: calls.append(("mlflow.log", dict(flat), step))
    mlflow.end_run = lambda: calls.append(("mlflow.end_run",))
    return {"wandb": wandb, "mlflow": mlflow}


def _sink_calls(cls, tmp_path, monkeypatch, stub=True, kwargs=None) -> list:
    calls: list = []
    for name, mod in _stub_sinks(calls).items():
        if stub:
            monkeypatch.setitem(sys.modules, name, mod)
        else:
            monkeypatch.setitem(sys.modules, name, None)  # import fails
    exp = cls(exp_dir=str(tmp_path), name="sinks", log_files=False,
              create_tensorboard_logger=False, log_every_n_steps=2,
              create_wandb_logger=True, create_mlflow_logger=True,
              wandb_kwargs={"project": "p"}, **(kwargs or {}))
    for step in range(5):
        exp.log_metrics(step, {"loss": 1.0 / (step + 1), "lr": 0.1, "grad_norm": 2.0 + step,
                               "vector": [1.0, 2.0]})
    exp.log_metrics(7, {"val_loss": 0.5}, force=True)
    exp.close()
    return calls


def test_sinks_log_what_jax_logs(tmp_path, monkeypatch):
    port = _sink_calls(t_exp.ExpManager, tmp_path / "port", monkeypatch)
    jax_calls = _sink_calls(j_exp.ExpManager, tmp_path / "jax", monkeypatch)
    assert port == jax_calls
    assert [c[2] for c in port if c[0] == "wandb.log"] == [0, 2, 4, 7]
    assert ("mlflow.start_run", "version_0") in port


def test_missing_sink_warns_and_training_goes_on(tmp_path, monkeypatch, caplog):
    with caplog.at_level("WARNING"):
        calls = _sink_calls(t_exp.ExpManager, tmp_path, monkeypatch, stub=False)
    assert calls == []
    assert "W&B logger unavailable" in caplog.text
    assert "MLflow logger unavailable" in caplog.text
    assert (tmp_path / "sinks" / "version_0" / "metrics.jsonl").read_text().count("\n") == 4


def test_sinks_only_on_the_writer(tmp_path, monkeypatch):
    calls = _sink_calls(t_exp.ExpManager, tmp_path, monkeypatch, kwargs={"writer": False})
    assert calls == []


def test_profile_and_sinks_read_from_config(tmp_path):
    cfg = t_loader.load_config(TINY, {
        "exp_manager.exp_dir": str(tmp_path), "exp_manager.profile_start_step": 4,
        "exp_manager.profile_num_steps": 2, "exp_manager.create_tensorboard_logger": False,
        "exp_manager.log_files": False})
    exp = t_exp.ExpManager.from_config(cfg, trace_cuda=True, rank=2, world=4)
    assert (exp.profile_start_step, exp.profile_num_steps) == (4, 2)
    assert (exp.trace_cuda, exp.rank, exp.world) == (True, 2, 4)
    assert exp._wandb is None and exp._mlflow is None
    exp.close()
    shutil.rmtree(tmp_path, ignore_errors=True)
