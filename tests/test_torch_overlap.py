"""Engineered overlap in the port (``optim/overlap.py``, the bucketed path of
``optim/adamw.py``, ``parallel/pipeline.py``'s double buffer), against the
JAX package's ``optim/overlap.py``.

- ``OverlapConfig`` and the loader's cross-constraints give JAX's values
  and texts.
- The bucket plan equals JAX's ``build_bucket_plan`` on ``tiny_smoke``'s
  model (its own ``zero1_bucket_mb: 0.0625``) at dp 4 and at tp 2 x dp 4,
  where the tp-sharded leaves fall back to per-leaf gathers, and on a tiny
  Mixtral at data 2 x expert 2, where the expert leaves fall back: bucket
  names, members, packed leaves and bytes (the port's per-layer leaves
  name JAX's stacked leaf they belong to).  At dp 1 both plans are None.
  The plan is static: no launch.
- The bucketed update equals the per-leaf update bit for bit over gloo at
  dp 2, dp 4 and tp 2 x dp 2, with prefetch on and off, in fp32 and
  ``mixed_precision``, through a non-finite step the health skip keeps; it
  issues one gather a bucket (``overlap_units`` scenarios of the dp and tp
  launches, ``tests/_torch_dp_worker.py``).  A bucketed trainer at dp 2
  equals the per-leaf trainer bit for bit and the JAX trainer to the dp
  parity bar, its ``tensorstats.jsonl`` (with the ``bucket`` phase) to the
  tensorstats bar.
- The ``bucket`` phase's vector equals JAX's ``leaf_stats_vec`` on the same
  packed payload.
- ``pp_double_buffer`` equals the run without it bit for bit over gloo at
  pp 2 under ``1f1b``, ``1f1b-interleaved`` and the wavefront, and with the
  bucketed update at pp 2 x dp 2 (scenarios of the pipeline file's launch).
"""

import copy
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_torch_dp as DPT
import test_torch_pipeline as PPT
import test_torch_tp as TPT
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.models import mixtral as t_mixtral
from neuronx_distributed_training_torch.optim import overlap as t_ov
from neuronx_distributed_training_torch.parallel import sharding
from neuronx_distributed_training_torch.telemetry import tensorstats as t_ts
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.optim import adamw as j_adamw
from neuronx_distributed_training_tpu.optim import overlap as j_ov
from neuronx_distributed_training_tpu.parallel import mesh as j_mesh
from neuronx_distributed_training_tpu.telemetry import tensorstats as j_ts
from neuronx_distributed_training_tpu.telemetry.health import grad_group_of as j_group_of
from neuronx_distributed_training_tpu.trainer import loop as j_loop
from neuronx_distributed_training_tpu.utils import dtypes as j_dtypes

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "examples" / "conf" / "tiny_smoke_config.yaml"
MIXTRAL = REPO / "examples" / "conf" / "hf_mixtral_8x7b_config.yaml"
#: tiny_smoke's own bucket size (MiB)
BUCKET_MB = 0.0625


# ---------------------------------------------------------------------------
# the knob block and the loader's rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [
    None, {}, {"zero1_bucket_mb": 64, "prefetch_ag": False, "pp_double_buffer": True,
               "xla_lhs": True},
    {"zero1_bucket_md": 32}, {"bogus": 1}, [("zero1_bucket_mb", 32)], {"zero1_bucket_mb": True},
    {"zero1_bucket_mb": "32"}, {"zero1_bucket_mb": None}, {"zero1_bucket_mb": -1},
    {"prefetch_ag": 1}, {"pp_double_buffer": "yes"}, {"xla_lhs": 0}])
def test_overlap_config_is_jaxs(block):
    def parse(cls):
        try:
            return vars(cls.from_config(block))
        except ValueError as e:
            return str(e)

    assert parse(t_ov.OverlapConfig) == parse(j_ov.OverlapConfig)


@pytest.mark.parametrize("ds", [
    {"zero1": False, "overlap": {"zero1_bucket_mb": 32}},
    {"overlap": {"pp_double_buffer": True}},
    {"overlap": {"prefetch_agg": True}},
    {"pipeline_model_parallel_size": 2, "zero1": True,
     "overlap": {"zero1_bucket_mb": 32, "pp_double_buffer": True}}])
def test_loader_cross_constraints_are_jaxs(ds):
    base = {"distributed_strategy": ds,
            "data": {"global_batch_size": 8, "micro_batch_size": 1, "seq_length": 64},
            "model": {"num_layers": 4, "num_attention_heads": 4}}

    def load(loader):
        try:
            return dict(loader.load_config(copy.deepcopy(base))["distributed_strategy"]["overlap"])
        except ValueError as e:
            return str(e)

    assert load(t_loader) == load(j_loader)


# ---------------------------------------------------------------------------
# the bucket plan against JAX's
# ---------------------------------------------------------------------------


def _jax_leaf(name: str) -> str:
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _jax_plan(cfg_path, overrides: dict, n: int):
    """JAX's plan of the config's model on ``n`` virtual devices, as plain
    data (None at dp 1)."""
    cfg = j_loader.load_config(cfg_path, overrides)
    policy = j_dtypes.DtypePolicy.from_precision_config(cfg.get("precision", {}))
    _, _, init_fn, specs_fn = j_loop.build_model(cfg, policy)
    abstract = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    pspecs = specs_fn()
    mesh = j_mesh.build_mesh(j_mesh.MeshConfig.from_config(cfg["distributed_strategy"]),
                             devices=jax.devices()[:n])
    mspecs = j_adamw.opt_state_specs(abstract, pspecs, mesh, zero1=True, policy=policy)["mu"]
    plan = j_ov.build_bucket_plan(abstract, pspecs, mspecs, mesh, bucket_mb=BUCKET_MB,
                                  group_fn=j_group_of)
    if plan is None:
        return None
    paths = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(abstract)[0]]
    return plan.dp_total, [{"name": b.name, "members": sorted(paths[i] for i in b.idxs),
                            "packed": sorted(paths[a.pos] for a in b.ag), "bytes": b.bytes}
                           for b in plan.buckets]


def _port_plan(cfg_path, overrides: dict, *, dp: int, tp: int = 1, ep: int = 1):
    cfg = t_loader.load_config(cfg_path, overrides)
    mc = t_loop.model_config(cfg)
    policy = DtypePolicy.from_precision_config(cfg.get("precision"))
    gen = torch.Generator().manual_seed(0)
    if ep > 1:
        params = t_mixtral.init_params(mc, policy, generator=gen, device="cpu", tp_rank=0,
                                       tp_size=tp, ep_rank=0, ep_size=ep)
    else:
        params = t_llama.init_params(mc, policy, generator=gen, device="cpu", tp_rank=0,
                                     tp_size=tp)
    flat = t_llama.named_params(params)
    layouts = sharding.leaf_layouts(flat, mc, sequence_parallel=tp > 1)
    ep_axis = (types.SimpleNamespace(size=ep, data=types.SimpleNamespace(size=dp // ep))
               if ep > 1 else None)
    plan = t_loop._bucket_plan(flat, layouts, dp, t_ov.OverlapConfig(zero1_bucket_mb=BUCKET_MB),
                               tp=types.SimpleNamespace(size=tp), ep=ep_axis)
    if plan is None:
        return None
    assert plan.num_leaves == len(flat)
    assert sorted(n for b in plan.buckets for n in b.members) == sorted(flat)
    return plan.dp_total, [{"name": b.name,
                            "members": sorted({_jax_leaf(n) for n in b.members}),
                            "packed": sorted({_jax_leaf(a.name) for a in b.ag}),
                            "bytes": b.bytes} for b in plan.buckets]


#: (tp, dp) meshes of tiny_smoke's plan
TINY_MESHES = {"dp4": (1, 4), "tp2_dp4": (2, 4), "dp1": (1, 1)}


@pytest.mark.parametrize("mesh", TINY_MESHES)
def test_bucket_plan_equals_jax_on_tiny_smoke(mesh):
    tp, dp = TINY_MESHES[mesh]
    over = {"distributed_strategy.tensor_model_parallel_size": tp}
    want = _jax_plan(TINY, over, tp * dp)
    got = _port_plan(TINY, over, dp=dp, tp=tp)
    assert got == want
    if dp == 1:
        assert got is None
        return
    dp_total, buckets = got
    assert dp_total == dp and len(buckets) > 1
    packed = {leaf for b in buckets for leaf in b["packed"]}
    members = {leaf for b in buckets for leaf in b["members"]}
    if tp == 1:
        assert packed == members  # every leaf's gather is combined
    else:  # the tp-sharded leaves fall back, the replicated ones pack
        assert "layers/attn/qkv/w" not in packed and "final_norm/scale" in packed


def test_bucket_plan_equals_jax_on_the_expert_mesh():
    over = {"distributed_strategy.tensor_model_parallel_size": 1,
            "distributed_strategy.sequence_parallel": False,
            "distributed_strategy.expert_model_parallel_size": 2,
            "distributed_strategy.pipeline_model_parallel_size": 1,
            "distributed_strategy.overlap": {"zero1_bucket_mb": BUCKET_MB},
            "model.num_layers": 2, "model.hidden_size": 64, "model.intermediate_size": 96,
            "model.num_attention_heads": 4, "model.num_key_value_heads": 2,
            "model.vocab_size": 256, "data.seq_length": 64, "model.sliding_window": 64,
            "data.global_batch_size": 8}
    want = _jax_plan(MIXTRAL, over, 4)
    got = _port_plan(MIXTRAL, over, dp=4, ep=2)
    assert got == want
    dp_total, buckets = got
    assert dp_total == 4
    packed = {leaf for b in buckets for leaf in b["packed"]}
    assert "layers/mlp/experts/gate_up" not in packed and "layers/mlp/router/w" in packed


def test_bucket_plan_orders_groups_as_jax_and_reverses():
    shapes = {"embed.embedding": (8, 4), "layers.0.attn.w": (4, 4), "layers.1.attn.w": (4, 4),
              "layers.0.mlp.w": (4, 8), "layers.1.mlp.w": (4, 8), "final_norm.scale": (4,),
              "lm_head.w": (4, 8)}
    dims = {n: 0 for n in shapes}
    tiny = t_ov.build_bucket_plan(shapes, dims, 2, bucket_mb=1e-9,
                                  group_fn=lambda n: t_loop.grad_group_of(n))
    assert [b.name for b in tiny.buckets] == ["lm_head", "layers/mlp", "layers/attn",
                                              "final_norm", "embed"]
    assert tiny.buckets[1].members == ("layers.0.mlp.w", "layers.1.mlp.w")
    one = t_ov.build_bucket_plan(shapes, dims, 2, bucket_mb=1024, group_fn=t_loop.grad_group_of)
    assert [b.name for b in one.buckets] == ["lm_head+layers/mlp+layers/attn+final_norm+embed"]
    assert one.describe() == "zero1 buckets (dp=2): lm_head+layers/mlp+layers/attn+" \
        "final_norm+embed[7 leaves, 7 packed, 0.0MiB]"
    # a model-sharded leaf stays in its bucket but leaves the combined gather
    fall = t_ov.build_bucket_plan(shapes, dims, 2, bucket_mb=1024,
                                  group_fn=t_loop.grad_group_of,
                                  model_sharded=lambda n: n.startswith("layers."))
    assert len(fall.buckets[0].members) == 7 and len(fall.buckets[0].ag) == 3
    assert t_ov.build_bucket_plan(shapes, dims, 1, bucket_mb=1,
                                  group_fn=t_loop.grad_group_of) is None


# ---------------------------------------------------------------------------
# the bucketed update over gloo (the dp and tp launches' scenarios)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    return DPT.shared(tmp_path_factory, "dp_parity", DPT._parity_build)


@pytest.fixture(scope="module")
def tp4_runs(tmp_path_factory):
    return DPT.shared(tmp_path_factory, "tp4", TPT._tp4_build)


def _units(dp_runs, tp4_runs) -> dict:
    out = {}
    for ranks in (dp_runs["overlap"]["overlap_units"], tp4_runs["overlap_units"]):
        for r in ranks:
            for case, rep in r.items():
                out.setdefault(case, []).append(rep)
    return out


UNIT_CASES = [f"tp{tp}_dp{dp}_{p}" for tp, dp in ((1, 2), (1, 4), (2, 2))
              for p in ("fp32", "mixed_precision")]


@pytest.mark.parametrize("case", UNIT_CASES)
def test_bucketed_update_is_per_leaf_bit_for_bit(dp_runs, tp4_runs, case):
    reps = _units(dp_runs, tp4_runs)[case]
    assert len(reps) == (2 if case.startswith("tp1_dp2") else 4)
    for rep in reps:
        assert rep["equal"] == {"prefetch": True, "no_prefetch": True}, rep
        # one gather a packed bucket in place of one a leaf (two steps)
        leaf, packed = rep["zero1_leaves"], rep["packed_leaves"]
        assert rep["gathers"]["per_leaf"] == 2 * leaf
        assert rep["gathers"]["prefetch"] == rep["gathers"]["no_prefetch"] == \
            2 * (leaf - packed + rep["packed_buckets"])
        assert packed == (leaf if case.startswith("tp1") else 5)
    assert all(rep["buckets"] == reps[0]["buckets"] for rep in reps)


def test_bucketed_trainer_is_per_leaf_and_matches_jax(dp_runs):
    cfg, _, jparams, lines, ranks, dump = dp_runs["buckets"]
    per_leaf = dp_runs["overlap"]["buckets_per_leaf"]
    for r, p in zip(ranks, per_leaf):
        assert [(h["loss"], h["grad_norm"]) for h in r["history"]] == \
            [(h["loss"], h["grad_norm"]) for h in p["history"]]
        assert r["state_digest"] == p["state_digest"]
    h0 = ranks[0]["history"]
    np.testing.assert_allclose([h["loss"] for h in h0], [x["loss"] for x in lines],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose([h["grad_norm"] for h in h0], [x["grad_norm"] for x in lines],
                               rtol=1e-5, atol=0)
    DPT._assert_params_bar(dump, jparams, fp32=True)


def test_bucket_phase_in_tensorstats_jsonl_matches_jax(dp_runs):
    import json

    cfg, _, _, _, ranks, _ = dp_runs["buckets"]
    ts = [json.loads(x) for x in
          (Path(ranks[0]["log_dir"]) / "tensorstats.jsonl").read_text().splitlines()]
    jts = [json.loads(x) for x in (Path(cfg["exp_manager"]["exp_dir"]) / "dp" / "version_0" /
                                   "tensorstats.jsonl").read_text().splitlines()]
    assert [r["step"] for r in ts] == [r["step"] for r in jts] == [1, 2, 3]
    for a, b in zip(ts, jts):
        assert set(a["groups"]) == set(b["groups"])
        buckets = [g for g in a["groups"] if g.startswith("bucket/")]
        assert len(buckets) > 1
        for g in buckets:
            x, y = a["groups"][g], b["groups"][g]
            moved = np.abs(np.cumsum(x["hist"]) - np.cumsum(y["hist"])).max()
            assert moved <= max(DPT.HIST_MOVES, DPT.TS_RTOL * x["count"]), (g, moved)
            np.testing.assert_allclose([x[k] for k in x if k != "hist"],
                                       [y[k] for k in x if k != "hist"],
                                       rtol=DPT.TS_RTOL, atol=0, err_msg=g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucket_phase_vector_is_jaxs(dtype):
    """The ``bucket`` phase's vector of one packed ``[dp, cols]`` payload
    (zeros and a wide exponent range; XLA's CPU flushes subnormals to zero,
    so none is in it) against JAX's."""
    rng = np.random.default_rng(7)
    packed = (rng.standard_normal((4, 257)) * np.exp2(rng.integers(-30, 10, (4, 257))))
    packed[0, :9] = 0.0
    packed = packed.astype(np.float32)
    cfg_t = t_ts.TensorStatsConfig(enabled=True, buckets=True)
    cfg_j = j_ts.TensorStatsConfig(enabled=True, buckets=True)
    t = torch.from_numpy(packed).to(getattr(torch, dtype))
    j = jax.numpy.asarray(packed).astype(getattr(jax.numpy, dtype))
    got = t_ts.leaf_stats_vec(t, cfg_t).numpy()
    want = np.asarray(j_ts.leaf_stats_vec(j, cfg_j))
    np.testing.assert_array_equal(got[[0, 2, 3, 4]], want[[0, 2, 3, 4]])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)  # sumsq: an fp32 sum
    np.testing.assert_array_equal(got[5:], want[5:])


# ---------------------------------------------------------------------------
# the pipeline's double buffer (the pipeline launch's scenarios)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    return PPT._shared(tmp_path_factory, "pp_runs", PPT._pp_launch)


#: double-buffered scenario -> the run without it (same weights)
DOUBLE_BUFFERED = {"db_1f1b": "straight", "db_vp2": "vp2_dp2", "db_wavefront": "pp2_cp2",
                   "db_buckets": "straight"}


@pytest.mark.parametrize("name", DOUBLE_BUFFERED)
def test_double_buffer_is_bit_for_bit(pp_runs, name):
    base = DOUBLE_BUFFERED[name]
    got = [r[name] for r in pp_runs["ranks"]]
    want = [r[base] for r in pp_runs["ranks"]]
    assert [r["schedule"] for r in got] == [r["schedule"] for r in want]
    for g, w in zip(got, want):
        assert [(h["loss"], h["grad_norm"]) for h in g["history"]] == \
            [(h["loss"], h["grad_norm"]) for h in w["history"]]
        assert g["state_digest"] == w["state_digest"]
    a = torch.load(pp_runs["tmp"] / f"{name}.pt")
    b = torch.load(pp_runs["tmp"] / f"{base}.pt")
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
