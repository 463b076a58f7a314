"""Data parallelism with ZeRO-1 in the port, over gloo in CPU processes.

- the pure pieces against the JAX package: ``utils/launch.py`` on fake
  environments (the JAX ``tests/test_launch.py`` cases that need no jax,
  plus torchrun's variables, which come first), ``MeshConfig.validate``'s
  errors, ``zero1_leaf_spec`` and the rows each rank computes (JAX splits
  microbatches microbatch-major);
- 2 gloo processes (``tests/_torch_dp_worker.py``) against the JAX trainer
  on 2 of the 8 virtual CPU devices with ``zero1: true``, 3 steps from the
  same weights: ``fp32`` (loss and grad norm rtol 1e-5), ``mixed_precision``
  (loss 1e-4, grad norm 2e-3), and fp32 rows whose ``loss_mask`` gives the
  two ranks different numbers of loss tokens, which a mean of per-rank means
  would miss (shown on the same rows); params to ``test_torch_step.py``'s
  bar;
- inside the port: at dp=2 ZeRO-1 on and off train bit for bit alike, the
  moment shards are half their leaf along ``zero1_leaf_spec``'s dim, dp=2
  and dp=1 agree on the loss within rtol 1e-6, and a NaN in rank 1's rows
  alone skips the step on both ranks;
- checkpoints: a dp=2 run saved at step 2 and resumed to step 3 equals a
  straight run bit for bit, the step-2 checkpoint restores at dp=1 exactly
  and trains step 3 within the dp tolerance, a dp=1 checkpoint resumes at
  dp=2, and a flipped byte in either rank's file fails verification; in
  the same launch a warm start at dp=2 (``weight_init_only`` with
  ``resume_from_checkpoint``, ZeRO-1, an EMA) starts from the saved params
  bit for bit with a fresh step, and a SIGTERM on rank 1 alone at a step
  that is no log boundary stops both ranks at the next log boundary (the
  stop agreed there), with one emergency save;
- the CLI under ``python -m torch.distributed.run --nproc_per_node 2 ...
  --device cpu``: rank 0 alone writes ``metrics.jsonl``.

Each launch picks a free ``MASTER_PORT`` from a bound socket (the suite runs
under xdist) and waits for each rank with its own timeout.
"""

import fcntl
import importlib.util
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.checkpoint import integrity as ck_integrity
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.data.loader import dp_rank_rows
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.optim import adamw as t_adamw
from neuronx_distributed_training_torch.parallel import mesh as t_mesh
from neuronx_distributed_training_torch.parallel import sharding
from neuronx_distributed_training_torch.tools.convert import params_from_jax
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.utils import launch as t_launch
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.data import loader as j_data
from neuronx_distributed_training_tpu.optim import adamw as j_adamw
from neuronx_distributed_training_tpu.parallel import mesh as j_mesh
from neuronx_distributed_training_tpu.trainer.step import microbatch_split as j_split
from neuronx_distributed_training_tpu.utils import launch as j_launch

#: torch's CPU threads in a test process, the gloo ranks' count (``_env``):
#: the suite runs six xdist workers on the host's cores beside the ranks,
#: and at torch's default (every core) each worker's small ops wait on
#: threads the others hold.  pytest imports every test module in every
#: worker, so this sets each worker's torch (JAX's threads are its own)
TORCH_THREADS = 2
torch.set_num_threads(TORCH_THREADS)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_dp_worker.py"
TINY = REPO / "examples" / "conf" / "tiny_smoke_config.yaml"
#: seconds each rank may take
RANK_TIMEOUT = 180
LR = 1e-3


def _worker_module():
    spec = importlib.util.spec_from_file_location("_torch_dp_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(TORCH_THREADS),
               PYTHONPATH=os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]), **extra)
    return env


def shared(tmp_path_factory, name: str, build):
    """``build(dir)`` once for every xdist worker of this run (a module's
    tests spread over the workers, each of which would build its own
    module fixture): the first worker to take the lock builds in a
    directory the workers share and pickles the result, the others load it.
    A worker that dies while building releases the lock, and the next one
    builds."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    where = root / f"shared_{name}"
    where.mkdir(exist_ok=True)
    done = where / "result.pkl"
    with open(root / f"shared_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            result = build(where)
            (where / "result.tmp").write_bytes(pickle.dumps(result))
            os.replace(where / "result.tmp", done)
    return pickle.loads(done.read_bytes())


class Launch:
    """The worker on ``nproc`` gloo ranks, started and not waited for: the
    caller computes its JAX references while the ranks run, then calls
    :meth:`results` (each rank given ``timeout`` seconds from the start)."""

    def __init__(self, tmp_path: Path, scenarios: list, nproc: int = 2,
                 timeout: float = RANK_TIMEOUT):
        self.out = Path(tempfile.mkdtemp(prefix="ranks_", dir=tmp_path))
        spec = self.out / "spec.json"
        spec.write_text(json.dumps({"out": str(self.out), "scenarios": scenarios}))
        port = _free_port()
        self.nproc, self.deadline = nproc, time.monotonic() + timeout
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(spec)],
            env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(nproc),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(nproc)]

    def results(self) -> list[dict]:
        """Each rank's results, once every rank has exited 0."""
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=max(self.deadline - time.monotonic(), 1))[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
        return [json.loads((self.out / f"rank{r}.json").read_text()) for r in range(self.nproc)]


def launch(tmp_path: Path, scenarios: list, nproc: int = 2,
           timeout: float = RANK_TIMEOUT) -> list[dict]:
    """Run the worker on ``nproc`` gloo ranks, each given ``timeout``
    seconds; returns each rank's results."""
    return Launch(tmp_path, scenarios, nproc, timeout).results()


def dp_cfg(tmp_path, exp, *, precision="fp32", zero1=True, max_steps=3, every=0, **over):
    cfg = {
        "name": "dp", "model_source": "hf", "seed": 11,
        "trainer": {"max_steps": max_steps, "log_every_n_steps": 1, "gradient_clip_val": 1.0},
        "exp_manager": {
            "exp_dir": str(tmp_path / exp), "resume_if_exists": True,
            "create_tensorboard_logger": False, "log_files": False,
            "checkpoint_callback_params": {"save_top_k": 2, "every_n_train_steps": every},
            "telemetry": {"compile_census": False,
                          "health": {"enabled": True, "policy": "skip_update"}},
        },
        "distributed_strategy": {"tensor_model_parallel_size": 1, "zero1": zero1},
        "data": {"global_batch_size": 8, "micro_batch_size": 2, "seq_length": 32,
                 "synthetic": True},
        "model": {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
                  "num_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                  "max_position_embeddings": 32,
                  "optim": {"name": "adamw_fp32OptState", "lr": LR, "weight_decay": 0.1,
                            "sched": {"name": "CosineAnnealing", "warmup_steps": 0,
                                      "max_steps": 6}}},
        "precision": {"type": precision},
    }
    for k, v in over.items():
        cfg[k] = {**cfg.get(k, {}), **v} if isinstance(v, dict) else v
    return cfg


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nodelist", ["node7", "a1,b2,c3", "node[3-17,20]", "trn-[003-017]",
                                      "gpu[12]"])
def test_expand_first_host_matches_jax(nodelist):
    assert t_launch.expand_first_host(nodelist) == j_launch.expand_first_host(nodelist)


@pytest.mark.parametrize("env", [
    {},
    {"NXDT_COORDINATOR": "10.0.0.1:9999", "NXDT_NUM_PROCESSES": "4", "NXDT_PROCESS_ID": "2",
     "SLURM_NTASKS": "8"},
    {"SLURM_NTASKS": "16", "SLURM_PROCID": "5", "SLURM_STEP_NODELIST": "trn[001-004]",
     "SLURM_RESTART_COUNT": "2", "NXDT_COORDINATOR_PORT": "8476"},
    {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "3",
     "MASTER_ADDR": "head.cluster.local", "MASTER_PORT": "1234"},
    {"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "1"},
    {"SLURM_NTASKS": "1"},
], ids=["single", "nxdt_env", "slurm", "ompi", "ompi_auto", "slurm_one_task"])
def test_detect_cluster_matches_jax(env):
    t, j = t_launch.detect_cluster(env), j_launch.detect_cluster(env)
    assert (t.coordinator_address, t.num_processes, t.process_id, t.managed_by,
            t.restart_count) == (j.coordinator_address, j.num_processes, j.process_id,
                                 j.managed_by, j.restart_count)
    assert t.wants_process_group == j.is_multiprocess
    assert t_launch.restart_log_dir("/logs", env) == j_launch.restart_log_dir("/logs", env)


def test_torchrun_variables_come_first():
    spec = t_launch.detect_cluster({
        "RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "10.1.2.3",
        "MASTER_PORT": "29511", "NXDT_COORDINATOR": "x:1", "NXDT_NUM_PROCESSES": "8",
        "NXDT_PROCESS_ID": "0", "SLURM_NTASKS": "8", "SLURM_RESTART_COUNT": "1"})
    assert spec == t_launch.ClusterSpec("10.1.2.3:29511", 4, 3, "torchrun", 1, 1)
    one = t_launch.detect_cluster({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "h"})
    assert one.coordinator_address == "h:29500"
    assert one.wants_process_group and not one.is_multiprocess  # torchrun at world size 1
    with pytest.raises(RuntimeError, match="NODELIST"):
        t_launch.detect_cluster({"SLURM_NTASKS": "2"})
    # a single process outside torchrun starts no process group
    assert t_launch.initialize_distributed(t_launch.detect_cluster({}), device="cpu") is None


@pytest.mark.parametrize("kw,n", [
    ({"tensor_model_parallel_size": 3}, 8),
    ({"tensor_model_parallel_size": 2, "expert_model_parallel_size": 3}, 8),
    ({"sequence_parallel": True}, 8),
    ({"context_parallel_size": 0}, 8),
    ({"tensor_model_parallel_size": 2, "pipeline_model_parallel_size": 2}, 8),
    ({}, 2),
])
def test_mesh_config_validate_matches_jax(kw, n):
    t, j = t_mesh.MeshConfig(**kw), j_mesh.MeshConfig(**kw)
    try:
        j.validate(n)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            t.validate(n)
        assert str(te.value) == str(e)
    else:
        t.validate(n)
        assert t.dp_size(n) == j.dp_size(n) and t.shape(n) == j.shape(n)
    assert t_mesh.AXES == j_mesh.AXES and t_mesh.DATA_AXES == j_mesh.DATA_AXES
    assert t_mesh.MeshConfig.from_config(dict(kw)) == t


def test_dp_degree_is_data_times_expert(devices8):
    class Mesh:  # the two attributes dp_degree reads of a DeviceMesh
        mesh_dim_names = t_mesh.AXES
        shape = (1, 2, 2, 1, 2)

    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(tensor_model_parallel_size=2,
                                                expert_model_parallel_size=2),
                              devices=devices8)
    assert t_mesh.dp_degree(Mesh()) == j_mesh.dp_degree(jmesh) == 4


@pytest.mark.parametrize("shape", [(128, 64), (63, 64), (7, 5), (64,), (6, 4, 8), ()])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_zero1_leaf_spec_matches_jax(shape, dp, devices8):
    from jax.sharding import PartitionSpec as P

    mesh = j_mesh.build_mesh(j_mesh.MeshConfig(), devices=devices8[:dp])
    jspec = j_adamw.zero1_leaf_spec(P(), shape, mesh)
    jdim = next((i for i, e in enumerate(jspec) if e is not None), None)
    assert t_adamw.zero1_leaf_spec(shape, dp) == jdim


@pytest.mark.parametrize("gbs,nm,dp", [(8, 2, 2), (8, 4, 2), (16, 2, 4), (4, 4, 1)])
def test_rank_rows_are_the_rows_of_each_jax_microbatch(gbs, nm, dp):
    """Rank r computes slice [r*mbs, (r+1)*mbs) of each JAX microbatch (a
    microbatch-major split of the global batch), not dp_shard's block."""
    mbs = gbs // (nm * dp)
    micro = np.asarray(j_split({"i": np.arange(gbs)}, nm)["i"])  # [nm, mbs * dp]
    rows = [dp_rank_rows(gbs, nm, r, dp) for r in range(dp)]
    for r in range(dp):
        np.testing.assert_array_equal(rows[r].reshape(nm, mbs), micro[:, r * mbs:(r + 1) * mbs])
    assert sorted(np.concatenate(rows).tolist()) == list(range(gbs))
    with pytest.raises(ValueError, match="not divisible"):
        dp_rank_rows(gbs + 1, nm, 0, dp)


# ---------------------------------------------------------------------------
# dp=2 against the JAX trainer
# ---------------------------------------------------------------------------


class _JaxMaskedRows(j_data.DataModule):
    def __init__(self, vocab_size, seq_len, global_batch_size, *, seed):
        self.vocab_size, self.seq_len, self.seed = vocab_size, seq_len, seed
        self._rows = _worker_module().masked_rows
        super().__init__(1 << 12, global_batch_size)

    def fetch_rows(self, idx):
        return self._rows(idx, seq=self.seq_len, vocab=self.vocab_size, seed=self.seed)


def _jax_start(cfg, data=None):
    """The JAX trainer of ``cfg`` on 2 virtual devices, built but not
    fitted, and its initial params."""
    from neuronx_distributed_training_tpu.trainer.loop import Trainer as JTrainer

    jt = JTrainer.from_config(j_loader.load_config(cfg), devices=jax.devices()[:2],
                              enable_checkpointing=False, data_module=data)
    return jt, jax.tree_util.tree_map(np.asarray, jt.params)


def _jax_finish(jt) -> tuple:
    """Fit a :func:`_jax_start` trainer: ``(final params, metric lines)``."""
    jt.fit()
    lines = [json.loads(x) for x in (jt.exp.log_dir / "metrics.jsonl").read_text().splitlines()]
    return jax.tree_util.tree_map(np.asarray, jt.params), [x for x in lines if "loss" in x]


def _jax_run(cfg, data=None):
    jt, jparams = _jax_start(cfg, data)
    return (jparams, *_jax_finish(jt))


def _port_weights(jparams, path: Path) -> Path:
    flat = t_llama.named_params(params_from_jax(jparams, device="cpu"))
    torch.save({n: t.detach().clone() for n, t in flat.items()}, path)
    return path


def _assert_params_bar(port: dict, jax_params, *, fp32: bool, steps: int = 3):
    """``test_torch_step.py``'s bar on every entry of every param leaf."""
    apart, max_frac = (1e-6, 1e-2) if fp32 else (1e-4, 5e-2)
    ref = t_llama.named_params(params_from_jax(jax_params, device="cpu"))
    for n, j in ref.items():
        d = (port[f"params/{n}"].float() - j.float()).abs()
        assert float(d.max()) <= 2 * LR * steps, (n, float(d.max()))
        assert float((d > apart).float().mean()) <= max_frac, n


PARITY_CASES = ("fp32", "mixed_precision", "unequal_tokens", "tensorstats")
#: the tensorstats case: the observatory under ZeRO-1 at dp 2 (fp32)
TENSORSTATS = {"exp_manager": {"telemetry": {
    "compile_census": False, "health": {"enabled": True, "policy": "skip_update"},
    "tensorstats": {"enabled": True}}}}
#: tensorstats.jsonl against JAX's (tests/test_torch_planes.py's rule)
TS_RTOL, HIST_MOVES = 1e-5, 2


def _parity_build(tmp: Path) -> dict:
    """The JAX trainers are built first (the port's scenarios start from
    their initial weights) and fit while the launch runs."""
    jts, j0s, scenarios = {}, {}, []
    for case in PARITY_CASES:
        precision = "fp32" if case in ("unequal_tokens", "tensorstats") else case
        data, jdata = None, None
        if case == "unequal_tokens":
            data = {"kind": "sft_mask", "seed": 5}
            jdata = _JaxMaskedRows(128, 32, 8, seed=5)
        over = TENSORSTATS if case == "tensorstats" else {}
        cfg = dp_cfg(tmp, f"jax_{case}", precision=precision, **over)
        jts[case], j0s[case] = _jax_start(cfg, jdata)
        jts[case] = (cfg, jts[case])
        scenarios.append({"name": case, "cfg": dp_cfg(tmp, f"port_{case}", precision=precision,
                                                      **over),
                          "steps": 3, "data": data, "dump": str(tmp / f"{case}.pt"),
                          "weights": str(_port_weights(j0s[case], tmp / f"{case}_w.pt"))})
    run = Launch(tmp, scenarios)
    fitted = {case: (cfg, j0s[case], *_jax_finish(jt)) for case, (cfg, jt) in jts.items()}
    ranks = run.results()
    return {case: (*fitted[case], [r[case] for r in ranks], torch.load(tmp / f"{case}.pt"))
            for case in PARITY_CASES}


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    """The JAX trainer's runs of the parity cases, and the port's, all in one
    launch of 2 ranks, once a run: ``{case: (cfg, jax initial params, jax
    final params, jax metrics lines, rank results, port dump)}``."""
    return shared(tmp_path_factory, "dp_parity", _parity_build)


@pytest.mark.parametrize("case", PARITY_CASES)
def test_dp2_zero1_matches_jax(parity_runs, case):
    precision = "fp32" if case in ("unequal_tokens", "tensorstats") else case
    cfg, jparams0, jparams, lines, ranks, dump = parity_runs[case]
    h0, h1 = (r["history"] for r in ranks)
    assert [(a["loss"], a["grad_norm"]) for a in h0] == [(b["loss"], b["grad_norm"]) for b in h1]
    fp32 = precision == "fp32"
    np.testing.assert_allclose([h["loss"] for h in h0], [x["loss"] for x in lines],
                               rtol=1e-5 if fp32 else 1e-4, atol=0)
    np.testing.assert_allclose([h["grad_norm"] for h in h0], [x["grad_norm"] for x in lines],
                               rtol=1e-5 if fp32 else 2e-3, atol=0)
    _assert_params_bar(dump, jparams, fp32=fp32)
    if case == "tensorstats":
        # the observatory under ZeRO-1 at dp 2: rank 0's tensorstats.jsonl
        # against the JAX trainer's on 2 devices (no overlap: no bucket phase)
        ts = [json.loads(x) for x in
              (Path(ranks[0]["log_dir"]) / "tensorstats.jsonl").read_text().splitlines()]
        jts = [json.loads(x) for x in
               (Path(cfg["exp_manager"]["exp_dir"]) / "dp" / "version_0" /
                "tensorstats.jsonl").read_text().splitlines()]
        assert [r["step"] for r in ts] == [r["step"] for r in jts] == [1, 2, 3]
        for a, b in zip(ts, jts):
            assert set(a["groups"]) == set(b["groups"])
            for g, x in a["groups"].items():
                y = b["groups"][g]
                moved = np.abs(np.cumsum(x["hist"]) - np.cumsum(y["hist"])).max()
                assert moved <= max(HIST_MOVES, TS_RTOL * x["count"]), (g, moved)
                np.testing.assert_allclose([x[k] for k in x if k != "hist"],
                                           [y[k] for k in x if k != "hist"],
                                           rtol=TS_RTOL, atol=0, err_msg=g)
        assert not (Path(ranks[1]["log_dir"]) / "tensorstats.jsonl").exists() or \
            ranks[1]["log_dir"] == ranks[0]["log_dir"]
    if case == "unequal_tokens":
        # the two ranks hold different numbers of loss tokens, and a mean of
        # per-rank means misses JAX's step-0 loss where the port meets it
        w = _worker_module()
        batch = w.masked_rows(np.arange(8), seq=32, vocab=128, seed=5)
        mc = t_llama.LlamaConfig.from_config(cfg["model"])
        pol = t_loop.DtypePolicy.from_precision_config("fp32")
        params = params_from_jax(jparams0, device="cpu")
        counts, means = [], []
        with torch.no_grad():
            for r in range(2):
                rows = dp_rank_rows(8, 2, r, 2)
                for i in range(2):
                    mb = {k: torch.as_tensor(v[rows[i * 2:(i + 1) * 2]])
                          for k, v in batch.items()}
                    counts.append(float(mb["loss_mask"][:, 1:].sum()))
                    means.append(float(t_llama.forward(params, mb, mc, pol)[0]))
        assert counts[0] != counts[2] or counts[1] != counts[3], counts
        mean_of_means = (means[0] + means[2]) / 4 + (means[1] + means[3]) / 4
        assert not np.isclose(mean_of_means, lines[0]["loss"], rtol=1e-5, atol=0)
        assert np.isclose(h0[0]["loss"], lines[0]["loss"], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------


def test_dp2_zero1_on_off_bitwise_shards_and_nan_on_one_rank(tmp_path):
    nan_rows = dp_rank_rows(8, 2, 1, 2).tolist()  # rank 1's rows of step 1
    ranks = launch(tmp_path, [
        {"name": "z1", "cfg": dp_cfg(tmp_path, "z1"), "steps": 3,
         "dump": str(tmp_path / "z1.pt")},
        {"name": "z0", "cfg": dp_cfg(tmp_path, "z0", zero1=False), "steps": 3,
         "dump": str(tmp_path / "z0.pt")},
        {"name": "nan", "cfg": dp_cfg(tmp_path, "nan"), "steps": 3,
         "data": {"kind": "nan_rows", "step": 1, "rows": nan_rows}},
    ])
    z1, z0 = torch.load(tmp_path / "z1.pt"), torch.load(tmp_path / "z0.pt")
    assert z1.keys() == z0.keys()
    assert all(torch.equal(z1[k], z0[k]) for k in z1), [k for k in z1
                                                        if not torch.equal(z1[k], z0[k])]
    for r in ranks:
        assert [h["loss"] for h in r["z1"]["history"]] == [h["loss"] for h in
                                                            r["z0"]["history"]]
        mc = t_llama.LlamaConfig.from_config(dp_cfg(tmp_path, "z1")["model"])
        for n, (full, part) in r["z1"]["zero1_shards"].items():
            # the first divisible dim the (size-1) model axis does not
            # shard, as JAX extends the param spec
            dim = t_adamw.zero1_leaf_spec(full, 2, sharding.leaf_layout(n, mc).dim)
            assert dim is not None, n
            assert part == [s // 2 if i == dim else s for i, s in enumerate(full)], n
        assert all(part == full for full, part in r["z0"]["zero1_shards"].values())
        # NaN rows on rank 1 only: both ranks skip step 1, then train on
        nan = r["nan"]
        assert [h["health/updates_finite"] for h in nan["history"]] == [1.0, 0.0, 1.0]
        assert nan["health"]["skipped_count"] == 1 and nan["opt_step"] == 2
        assert nan["health"]["last_nonfinite_step"] == 1
        assert np.isfinite(nan["history"][2]["loss"])
    # dp=2 and the port at dp=1 (one process, no group): the same loss
    one = t_loop.Trainer.from_config(t_loader.load_config(dp_cfg(tmp_path, "one")),
                                     device="cpu", enable_checkpointing=False).fit()
    np.testing.assert_allclose([h["loss"] for h in ranks[0]["z1"]["history"]],
                               [h["loss"] for h in one], rtol=1e-6, atol=0)


def test_dp2_checkpoints_resume_bitwise_and_reshard(tmp_path):
    # a dp=1 checkpoint at step 2, for dp=2 to resume from
    solo = t_loop.Trainer.from_config(t_loader.load_config(dp_cfg(tmp_path, "solo", every=2)),
                                      device="cpu")
    solo.max_steps = 2
    solo.fit()
    assert solo.checkpointer.committed_steps == [2]
    shutil.copytree(tmp_path / "solo", tmp_path / "solo_copy")
    ranks = launch(tmp_path, [
        {"name": "straight", "cfg": dp_cfg(tmp_path, "a", every=2), "steps": 3,
         "dump": str(tmp_path / "straight.pt")},
        {"name": "pre", "cfg": dp_cfg(tmp_path, "b", every=2), "steps": 3, "max_steps": 2,
         "dump": str(tmp_path / "pre.pt")},
        {"name": "resume", "cfg": dp_cfg(tmp_path, "b", every=2), "steps": 3,
         "dump": str(tmp_path / "resume.pt")},
        {"name": "from_dp1", "cfg": dp_cfg(tmp_path, "solo", every=2), "steps": 3},
        {"name": "warm", "steps": 1, "max_steps": 1, "dump_init": str(tmp_path / "warm0.pt"),
         "cfg": dp_cfg(tmp_path, "warm", exp_manager={
             "resume_from_checkpoint": str(tmp_path / "a" / "dp" / "version_0" / "checkpoints"),
             "ema": {"enable": True, "decay": 0.9}}, model={"weight_init_only": True})},
        {"name": "agree", "cfg": dp_cfg(tmp_path, "agree", max_steps=6,
                                        trainer={"log_every_n_steps": 2}),
         "steps": 6, "sigterm": {"step": 2, "rank": 1}},
        # the control word at dp 2: an operator checkpoint_now polled by
        # rank 0 and a SIGTERM on rank 1 alone, each folded by the
        # boundary's one all-reduce, so both ranks save and stop alike
        {"name": "control", "cfg": dp_cfg(tmp_path, "control", max_steps=6,
                                          trainer={"log_every_n_steps": 2},
                                          exp_manager={"telemetry": {
                                              "compile_census": False,
                                              "health": {"enabled": True,
                                                         "policy": "skip_update"},
                                              "control": {"enabled": True}}}),
         "steps": 6, "sigterm": {"step": 3, "rank": 1}, "command": "checkpoint_now"},
    ])
    r0 = ranks[0]
    assert r0["straight"]["committed"] == [2, 3] and r0["pre"]["committed"] == [2]
    assert [h["step"] for h in r0["resume"]["history"]] == [2]
    assert (r0["resume"]["history"][0]["loss"], r0["resume"]["history"][0]["grad_norm"]) == \
        (r0["straight"]["history"][2]["loss"], r0["straight"]["history"][2]["grad_norm"])
    a, b = torch.load(tmp_path / "straight.pt"), torch.load(tmp_path / "resume.pt")
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]
    assert r0["resume"]["health"]["steps_seen"] == 3
    # the warm start: step 3's params (the straight run's newest save), each
    # rank its ZeRO-1 slices; the step, moments and data position fresh
    warm0, straight = torch.load(tmp_path / "warm0.pt"), torch.load(tmp_path / "straight.pt")
    assert warm0.keys() == {k[len("params/"):] for k in straight if k.startswith("params/")}
    assert all(torch.equal(warm0[n], straight[f"params/{n}"]) for n in warm0)
    for r in ranks:
        w = r["warm"]
        assert [h["step"] for h in w["history"]] == [0] and w["opt_step"] == 1
        assert w["history"][0]["consumed_samples"] == 8 and w["committed"] == []
    # a SIGTERM on rank 1 inside step 2 (no log boundary at log_every 2):
    # both ranks go on to step 3, agree at the step-4 boundary and save there
    for r in ranks:
        a = r["agree"]
        assert [h["step"] for h in a["history"]] == [0, 1, 2, 3]
        assert a["stop_class"] == "preemption" and a["committed"] == [4]
        # the control word: checkpoint_now at the step-2 boundary, rank 1's
        # SIGTERM (inside step 3) folded at step 4's, on both ranks
        c = r["control"]
        assert [h["step"] for h in c["history"]] == [0, 1, 2, 3]
        assert c["stop_class"] == "preemption" and c["committed"] == [2, 4]
    trail = json.loads((Path(r0["control"]["log_dir"]) / "run_summary.json").read_text())[
        "control"]
    assert [(x["command"], x["status"], x["step"]) for x in trail["commands"]] == [
        ("checkpoint_now", "accepted", 2)]
    assert trail["decisions"][-1]["source"] == "fleet"  # rank 0 got no SIGTERM
    assert trail["decisions"][-1]["reason"] == "fleet consensus: preemption requested on " \
        "another host"
    # the dp=1 checkpoint resumed at dp=2; the same continuation at dp=1
    assert [h["step"] for h in r0["from_dp1"]["history"]] == [2]
    cont = t_loop.Trainer.from_config(
        t_loader.load_config(dp_cfg(tmp_path, "solo_copy", every=0)), device="cpu").fit()
    assert np.isclose(r0["from_dp1"]["history"][0]["loss"], cont[0]["loss"], rtol=1e-6, atol=0)
    # the dp=2 step-2 checkpoint restores at dp=1 exactly, and step 3 there
    # follows dp=2's within the dp tolerance
    ck_b = tmp_path / "b" / "dp" / "version_0" / "checkpoints"
    dst = tmp_path / "c" / "dp" / "version_0" / "checkpoints"
    shutil.copytree(ck_b / "2", dst / "2")
    c = t_loop.Trainer.from_config(t_loader.load_config(dp_cfg(tmp_path, "c")), device="cpu")
    assert c.maybe_resume() and c.step == 2
    pre = torch.load(tmp_path / "pre.pt")
    live = {f"params/{n}": t for n, t in t_llama.named_params(c.params).items()}
    live.update({f"{g}/{n}": t for g in ("mu", "nu") for n, t in c.opt_state[g].items()})
    assert all(torch.equal(pre[k], live[k]) for k in live), [k for k in live
                                                            if not torch.equal(pre[k], live[k])]
    c.step = 2
    h3 = c.fit()
    assert np.isclose(h3[0]["loss"], r0["straight"]["history"][2]["loss"], rtol=1e-6, atol=0)
    # a flipped byte in either rank's file fails verification
    for rank_file, item in (("__0_0.distcp", "params"), ("__1_0.distcp", "opt_state")):
        bad = tmp_path / f"bad_{item}"
        shutil.copytree(tmp_path / "a" / "dp" / "version_0" / "checkpoints" / "3", bad / "3")
        assert ck_integrity.verify_step(bad, 3).status == "ok"
        f = bad / "3" / item / rank_file
        raw = bytearray(f.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        f.write_bytes(bytes(raw))
        v = ck_integrity.verify_step(bad, 3)
        assert v.status == "corrupt" and any(item in x for x in v.failures), v.failures


def test_cli_trains_under_torch_distributed_run(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "neuronx_distributed_training_torch.trainer.cli",
           "--config", str(TINY), "--set", "trainer.max_steps=2",
           "--set", "exp_manager.checkpoint_callback_params.every_n_train_steps=2",
           "--set", f"exp_manager.exp_dir={tmp_path}",
           "--set", "exp_manager.create_tensorboard_logger=false", "--device", "cpu"]
    out = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True,
                         timeout=RANK_TIMEOUT)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    run = next(tmp_path.glob("*/version_0"))
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2]  # rank 0 alone writes
    assert all(np.isfinite(x["loss"]) and x["consumed_samples"] == 8 * x["step"]
               for x in lines)
    assert lines[-1]["health/updates_finite"] == 1.0
    assert sorted(p.name for p in run.glob("nxdt_log_*")) == [
        "nxdt_log_globalrank-0_localrank-0.txt", "nxdt_log_globalrank-1_localrank-1.txt"]
    assert ck_integrity.verify_step(run / "checkpoints", 2).status == "ok"
    side = json.loads((run / "checkpoints" / "2" / "integrity.json").read_text())
    assert side["shards"]["opt_state"]  # ZeRO-1 leaves hashed shard by shard
