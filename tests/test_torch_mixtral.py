"""Mixtral and expert parallelism in the port against the JAX package, on the
CPU (``models/mixtral.py``, the MoE trainer, ``parallel/mesh.py::
ExpertParallel``).

Model: a tiny Mixtral (4 layers, hidden 64, ffn 96, 4 / 2 heads, 4 experts
top 2, a sliding window below the sequence), weights crossing with
``tools/convert.py``; inputs are seeded numpy.  Bars, as JAX's own tests':
fp32 outputs rtol 2e-5, gradients rtol 1e-3 / atol 1e-5, the routes
identical; ``mixed_precision`` loss and LM loss rtol 1e-4, with the count
of (token, slot) routes that a bf16 rounding moved reported
(``flipped_routes`` in the test's properties: 2 and 3 of 576 and 288 here),
not hidden, and the router loss held to rtol 1e-4 plus what those routes
can move it (``coef E / (k T)`` each).

- ``forward`` (fp32 and mixed, ``moe_frequency`` 1 and 2, left padding);
- ``params_from_jax`` / ``params_to_jax``: flat, grouped (``frequency`` 2),
  grouped under the virtual pipeline's interleave, tp 2 x ep 2;
- ``pipeline_hooks`` (``stage_aux``) at pp 2 through the loopback's
  wavefront against ``jax.grad(pipeline_loss(stage_aux=True))``;
- DPO's loss on a Mixtral (the router term ``0.5 (reg_c + reg_r)``);
- the loader's MoE texts, ``check_supported``'s Mixtral rules, the ignored
  ``model.moe`` on a Llama, the MFU accounting;
- the trainer at one rank against the JAX trainer, 3 steps: loss,
  ``router_aux_loss``, ``lm_loss`` and grad norm (fp32, rtol 1e-5);
- one 4-rank gloo launch (``tests/_torch_dp_worker.py``), running in a
  thread while the JAX trainers fit on 4 virtual devices: dp 2 x ep 2
  dropless, tp 2 (SP) x ep 2, dp 2 x ep 2 dropped at a binding capacity
  (cf 0.5), each 3 steps against the JAX trainer at the same mesh (fp32,
  rtol 1e-5); a save at ep 2 restored at ep 1 (dp 4) bit for bit, and
  resumed at ep 2 bit for bit against the straight dp 2 x ep 2 run.
"""

import concurrent.futures
import dataclasses
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_pipeline_1f1b as JP
import test_torch_dp as DPT
import test_torch_pipeline as PPT
import test_torch_tp as TPT
from neuronx_distributed_training_torch.alignment import dpo as t_dpo
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.models import mixtral as t_mixtral
from neuronx_distributed_training_torch.ops import moe as t_moe
from neuronx_distributed_training_torch.parallel import pipeline as t_pipe
from neuronx_distributed_training_torch.tools.convert import params_from_jax, params_to_jax
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.utils import perf as t_perf
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy as TPolicy
from neuronx_distributed_training_tpu.alignment import dpo as j_dpo
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.models import llama as j_llama
from neuronx_distributed_training_tpu.models import mixtral as j_mixtral
from neuronx_distributed_training_tpu.ops import moe as j_moe
from neuronx_distributed_training_tpu.parallel import pipeline as j_pipe
from neuronx_distributed_training_tpu.parallel.mesh import MeshConfig as JMeshConfig
from neuronx_distributed_training_tpu.parallel.mesh import build_mesh as j_build_mesh
from neuronx_distributed_training_tpu.trainer import loop as j_loop
from neuronx_distributed_training_tpu.utils import perf as j_perf
from neuronx_distributed_training_tpu.utils.dtypes import DtypePolicy as JPolicy

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "examples" / "conf" / "tiny_smoke_config.yaml"
LC = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_layers=4,
          num_attention_heads=4, num_kv_heads=2, sliding_window=12,
          activations_checkpoint_granularity=None)
RTOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-3, 1e-5
#: seconds each rank of the launch may take (beside a loaded xdist run)
LAUNCH_TIMEOUT = 600


def _cfgs(freq: int = 1, layers: int = 4, **moe):
    j = j_mixtral.MixtralConfig(llama=j_llama.LlamaConfig(**{**LC, "num_layers": layers}),
                                moe=j_moe.MoEConfig(num_experts=4, top_k=2, **moe),
                                moe_frequency=freq)
    t = t_mixtral.MixtralConfig(llama=t_llama.LlamaConfig(**{**LC, "num_layers": layers}),
                                moe=t_moe.MoEConfig(**dataclasses.asdict(j.moe)),
                                moe_frequency=freq)
    return j, t


def _policies(precision: str):
    return (JPolicy.from_precision_config({"type": precision}),
            TPolicy.from_precision_config({"type": precision}))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named(jtree) -> dict:
    return t_llama.named_params(params_from_jax(_np(jtree), device="cpu"))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _record_routes(monkeypatch) -> tuple:
    """Each MoE layer's expert indices as routed, JAX's (through a debug
    callback in its scan) and the port's, in layer order."""
    jax_routes, port_routes = [], []
    j_route, t_route = j_moe.route, t_moe.route

    def j_rec(*a, **k):
        out = j_route(*a, **k)
        jax.debug.callback(lambda i: jax_routes.append(np.asarray(i)), out[1])
        return out

    def t_rec(*a, **k):
        out = t_route(*a, **k)
        port_routes.append(out[1].numpy().copy())
        return out

    monkeypatch.setattr(j_moe, "route", j_rec)
    monkeypatch.setattr(t_moe, "route", t_rec)
    return jax_routes, port_routes


@pytest.mark.parametrize("precision", ["fp32", "mixed_precision"])
@pytest.mark.parametrize("freq", [1, 2])
def test_forward_matches_jax(precision, freq, monkeypatch, record_property):
    """Loss, ``router_aux_loss`` and ``lm_loss`` on left-padded rows, and in
    fp32 every gradient and every route."""
    jc, tc = _cfgs(freq)
    jpol, tpol = _policies(precision)
    jp = j_mixtral.init_params(jax.random.PRNGKey(0), jc, jpol)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 128, (3, 24)).astype(np.int32)
    am = np.ones((3, 24), np.int32)
    am[1, :6], am[2, :3] = 0, 0  # left padding
    batch = {"input_ids": ids, "labels": ids, "attention_mask": am}
    jax_routes, port_routes = _record_routes(monkeypatch)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: j_mixtral.forward(p, {k: jnp.asarray(v) for k, v in batch.items()}, jc, jpol),
        has_aux=True))(jp)
    jax.effects_barrier()
    tp = params_from_jax(_np(jp), device="cpu")
    flat = t_llama.named_params(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, taux = t_mixtral.forward(tp, {k: torch.tensor(v) for k, v in batch.items()}, tc, tpol)
    tl.backward()
    assert len(port_routes) == len(jax_routes) == 4 // freq
    flips = sum(int((a != b).sum()) for a, b in zip(jax_routes, port_routes))
    record_property("flipped_routes", flips)
    rtol = RTOL if precision == "fp32" else 1e-4
    _close(float(tl.detach()), float(jl), rtol)
    _close(float(taux["lm_loss"]), float(jaux["lm_loss"]), rtol)
    # a moved route shifts one expert's token fraction by 1/T, so the
    # router loss (coef E/k sum_e frac_tokens_e frac_probs_e, a mean over
    # the MoE layers) by at most coef E / (k T) over the layers
    moe = tc.moe
    per_flip = moe.router_aux_loss_coef * moe.num_experts / (moe.top_k * ids.size)
    _close(float(taux["router_aux_loss"]), float(jaux["router_aux_loss"]), rtol,
           flips * per_flip / len(port_routes))
    if precision != "fp32":
        return
    assert flips == 0
    want = _named(jg)
    assert set(want) == set(flat)
    for n, t in flat.items():
        _close(t.grad, want[n], GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("case", ["flat", "grouped", "grouped_vp", "tp2_ep2"])
def test_params_round_trip_through_jax_layout(case):
    """JAX trees -> the port's -> JAX's, equal leaf for leaf: the grouped
    ``{"moe": [G], "dense": [G, f-1]}`` layout, its virtual-pipeline
    interleave (pp 2 x vp 2, every rank's tree), and the tp 2 x ep 2 slices
    (each rank holds 2 of the 4 experts and its ffn halves)."""
    freq, layers = (1, 4) if case in ("flat", "tp2_ep2") else (2, 8)
    jc, tc = _cfgs(freq, layers)
    jp = _np(j_mixtral.init_params(jax.random.PRNGKey(2), jc))
    if case == "grouped_vp":
        jp = dict(jp, layers=_np(j_pipe.to_interleaved(jp["layers"], 2, 2)))
        trees = [params_from_jax(jp, device="cpu", pp_rank=r, pp_size=2, vp=2)
                 for r in range(2)]
        assert [i for i, lp in enumerate(trees[0]["layers"]) if lp is not None] == [0, 1, 4, 5]
        back = params_to_jax(trees, pp_size=2, vp=2)
    elif case == "tp2_ep2":
        trees = [params_from_jax(jp, device="cpu", cfg=tc, tp_rank=t, tp_size=2, ep_rank=e,
                                 ep_size=2) for e in range(2) for t in range(2)]
        gate_up = trees[1]["layers"][0]["mlp"]["experts"]["gate_up"]
        assert tuple(gate_up.shape) == (2, 64, 96)
        assert torch.equal(gate_up[:, :, :48], torch.tensor(
            jp["layers"]["mlp"]["experts"]["gate_up"][0, :2, :, 48:96]))
        back = params_to_jax(trees, tc, ep_size=2)
    else:
        tree = params_from_jax(jp, device="cpu")
        kinds = ["router" in lp["mlp"] for lp in tree["layers"]]
        assert kinds == [i % freq == 0 for i in range(layers)]
        back = params_to_jax(tree)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jp)
    assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.array_equal, back, jp)))


def test_pipeline_stage_aux_matches_jax(devices8):
    """``pipeline_hooks`` at pp 2 (each stage 2 MoE layers, returning ``(x,
    aux)``), 4 microbatches with uneven loss masks, through the loopback's
    wavefront with ``aux_scale = 1 / (nm num_moe_layers)``, against JAX's
    ``pipeline_loss(stage_aux=True)``: the loss (the router term summed over
    the stages) and every gradient."""
    jc, tc = _cfgs()
    jp = j_mixtral.init_params(jax.random.PRNGKey(3), jc, JP.FP32)
    ids, mask = PPT._batch(4)
    nm, scale = 4, 1.0 / (4 * 4)
    mbs = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids),
           "loss_mask": jnp.asarray(mask)}
    mesh = j_build_mesh(JMeshConfig(pipeline_model_parallel_size=2), devices=devices8[:2])
    sh_params, sh_mbs = JP.shard_for(mesh, jc, jp, mbs,
                                     specs=j_mixtral.param_specs(jc, pipeline=True))
    jl, jg = JP.wavefront_loss_and_grad(mesh, j_mixtral.pipeline_hooks(jc, JP.FP32), sh_params,
                                        sh_mbs, stage_aux=True, aux_scale=scale)
    tp = params_from_jax(_np(jp), device="cpu")
    leaves = t_llama.named_params(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    t_mbs = [{"input_ids": torch.tensor(ids[m]), "labels": torch.tensor(ids[m]),
              "loss_mask": torch.tensor(mask[m])} for m in range(nm)]
    denom = t_pipe.ce_denominator({"labels": torch.tensor(ids), "loss_mask": torch.tensor(mask)},
                                  shift_labels=True)
    loss, grads = t_pipe.loopback_step(tp, t_mixtral.pipeline_hooks(tc, PPT.FP32), t_mbs, denom,
                                       "wavefront", 2, leaves=leaves, act_dtype=torch.float32,
                                       aux_scale=scale)
    _close(float(loss.detach()), float(jl), 1e-5)
    want = _named(jg)
    for n in leaves:
        _close(grads[n], want[n], 5e-4, 1e-5)


def test_dpo_on_mixtral_matches_jax():
    """DPO's loss on a Mixtral policy, whose forward adds its router loss
    (``0.5 (reg_chosen + reg_rejected)``, JAX's ``reg``): loss, rewards and
    every gradient in fp32."""
    jc, tc = _cfgs()
    jpol, tpol = _policies("fp32")
    jp = j_mixtral.init_params(jax.random.PRNGKey(4), jc, jpol)
    rng = np.random.default_rng(5)
    batch = {f"{side}_{k}": v for side in ("chosen", "rejected")
             for k, v in (("input_ids", rng.integers(0, 128, (2, 20)).astype(np.int32)),
                          ("loss_mask", (rng.random((2, 20)) > 0.3).astype(np.float32)))}
    batch["reference_chosen_logps"] = rng.normal(-60, 3, 2).astype(np.float32)
    batch["reference_rejected_logps"] = rng.normal(-60, 3, 2).astype(np.float32)
    j_fn = j_dpo.make_dpo_loss_fn(j_loop._forward_logits_for(jc, jpol), beta=0.2)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: j_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, None),
        has_aux=True))(jp)

    def forward_logits(p, input_ids, positions=None):
        logits, aux = t_mixtral.forward(p, {"input_ids": input_ids}, tc, tpol)
        return logits, aux["router_aux_share"]

    tp = params_from_jax(_np(jp), device="cpu")
    flat = t_llama.named_params(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, tm = t_dpo.make_dpo_loss_fn(forward_logits, beta=0.2)(
        tp, {k: torch.tensor(v) for k, v in batch.items()})
    tl.backward()
    _close(float(tl.detach()), float(jl), 1e-5)
    for k in ("rewards_chosen", "rewards_rejected"):
        _close(float(tm[k]), float(jm[k]), 1e-4, 1e-5)
    want = _named(jg)
    for n, t in flat.items():
        _close(t.grad, want[n], GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("override", [
    {"model.moe": {"moe_frequency": 3}},
    {"model.moe": {"moe_frequency": 4}, "distributed_strategy.pipeline_model_parallel_size": 2},
    {"model.moe": {"dropless": True, "capacity_factor": 1.25}},
])
def test_loader_moe_rules_match_jax(override):
    msgs = []
    for ld in (t_loader, j_loader):
        with pytest.raises(ValueError) as e:
            ld.load_config(TINY, override)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _mixtral_tiny(extra: dict):
    base = {"model.architecture": "mixtral",
            "model.moe": {"num_experts": 4, "top_k": 2, "dropless": True}}
    return t_loader.load_config(TINY, {**base, **extra})


def test_check_supported_mixtral_rules(caplog):
    """Mixtral's rules: zig-zag refused with JAX's text, a pipeline that cuts
    a MoE + dense group refused with JAX's, an expert axis that does not
    divide the experts refused; LoRA on a Mixtral and the dropped path
    under cp pass (once refused naming entry 10 [item 13], now ported); a
    ``model.moe`` block on a Llama trains dense and is named in the ignored
    log."""
    with pytest.raises(NotImplementedError, match="zigzag_ring_attention is llama/mistral-only"):
        t_loop.check_supported(_mixtral_tiny({"model.fusions.zigzag_ring_attention": True,
                                              "distributed_strategy.context_parallel_size": 2}))
    with pytest.raises(ValueError, match=r"= 1 groups, not divisible by pp\*vp = 2\*1"):
        t_loop.check_supported(_mixtral_tiny({
            "model.moe": {"num_experts": 4, "frequency": 2},
            "distributed_strategy.pipeline_model_parallel_size": 2}))
    with pytest.raises(ValueError, match="num_experts 4 not divisible by "
                                         "expert_model_parallel_size 8"):
        t_loop.check_supported(_mixtral_tiny({
            "distributed_strategy.expert_model_parallel_size": 8}))
    for extra in ({"model.lora": {"lora_rank": 4}},
                  {"model.moe": {"num_experts": 4, "dropless": False, "capacity_factor": 1.0},
                   "model.fusions.ring_attention": True,
                   "distributed_strategy.context_parallel_size": 2}):
        t_loop.check_supported(_mixtral_tiny(extra))
    t_loop.check_supported(_mixtral_tiny({"distributed_strategy.expert_model_parallel_size": 2,
                                          "distributed_strategy.pipeline_model_parallel_size":
                                              2}))
    cfg = t_loader.load_config(TINY, {"model.moe": {"num_experts": 4}})
    assert type(t_loop.model_config(cfg)).__name__ == "LlamaConfig"
    t_loop._logged_ignored.discard("model.moe")
    with caplog.at_level(logging.INFO, logger="nxdt.torch.train"):
        t_loop._log_ignored(cfg)
    assert "model.moe" in caplog.text


def test_mfu_counts_the_activated_experts_as_jax():
    for freq in (1, 2):
        jc, tc = _cfgs(freq)
        assert t_perf.flops_for_model(tc, 24) == pytest.approx(
            j_perf.flops_for_model(jc, 24), rel=1e-12)
    jl, tl = j_llama.LlamaConfig(**LC), t_llama.LlamaConfig(**LC)
    assert t_perf.flops_for_model(tl, 24) == pytest.approx(j_perf.flops_for_model(jl, 24),
                                                           rel=1e-12)


# ---------------------------------------------------------------------------
# the trainer: one rank, and the 4-rank gloo launch, against the JAX trainer
# ---------------------------------------------------------------------------


def mx_cfg(tmp, exp, *, ep=1, tp=1, dropless=True, every=0, layers=2, **kw):
    cfg = DPT.dp_cfg(tmp, exp, every=every, **kw)
    cfg["distributed_strategy"].update(expert_model_parallel_size=ep,
                                       tensor_model_parallel_size=tp, sequence_parallel=tp > 1)
    moe = {"num_experts": 4, "top_k": 2, "dropless": dropless, "router_aux_loss_coef": 0.02}
    if not dropless:
        moe["capacity_factor"] = 0.5  # binds: half the routes of a skew-free load
    cfg["model"].update(architecture="mixtral", num_layers=layers, moe=moe, sliding_window=24)
    return cfg


#: the launch's JAX-parity cases: (expert, tensor, dropless)
MESHES = {"dp2_ep2": (2, 1, True), "tp2_ep2": (2, 2, True), "dp2_ep2_dropped": (2, 1, False)}


def _launch(tmp: Path) -> dict:
    """The JAX trainers are built first (the port's scenarios start from
    their initial weights), then the 4-rank launch runs in a thread while
    they fit, and the port at one rank trains from the dp 2 x ep 2 case's
    weights with that case's one microbatch of all 8 rows (the router loss
    is a product of means over a microbatch, so the microbatching must be
    the same; JAX's numbers at one device and at that mesh then agree to
    fp32 rounding).  The ep 2 save starts from the same weights, so its
    resume is held to the dp 2 x ep 2 run bit for bit."""
    jts, scenarios = {}, []
    for name, (ep, tp, dropless) in MESHES.items():
        jts[name], j0 = PPT._jax_start(mx_cfg(tmp, f"jax_{name}", ep=ep, tp=tp,
                                              dropless=dropless), 4)
        scenarios.append({"name": name, "steps": 3, "dump": str(tmp / f"{name}.pt"),
                          "cfg": mx_cfg(tmp, f"port_{name}", ep=ep, tp=tp, dropless=dropless),
                          "weights": str(TPT._global_weights(j0, tmp / f"{name}_w.pt"))})
    weights = scenarios[0]["weights"]
    scenarios += [
        {"name": "pre", "cfg": mx_cfg(tmp, "ck", ep=2, every=2), "steps": 3, "max_steps": 2,
         "weights": weights, "dump": str(tmp / "pre.pt")},
        {"name": "at_ep1", "cfg": mx_cfg(tmp, "ck", ep=1, every=2), "steps": 3,
         "max_steps": 2, "dump": str(tmp / "at_ep1.pt")},
        {"name": "resume", "cfg": mx_cfg(tmp, "ck", ep=2, every=2), "steps": 3,
         "dump": str(tmp / "resume.pt")},
    ]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(DPT.launch, tmp, scenarios, 4, LAUNCH_TIMEOUT)
        fitted = {name: PPT._jax_finish(jt)[1] for name, jt in jts.items()}
        one = TPT._single(mx_cfg(tmp, "port_one", data={"micro_batch_size": 8}),
                          torch.load(weights)).fit()
        ranks = ranks.result()
    load = {k: torch.load(tmp / f"{k}.pt") for k in list(MESHES) + ["pre", "at_ep1", "resume"]}
    return {"jax": fitted, "one": one, "ranks": ranks, "dumps": load}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return PPT._shared(tmp_path_factory, "mixtral_runs", _launch)


def _same_history(got: list, want: list, rtol: float = 1e-5):
    assert [r["step"] for r in got] == [0, 1, 2]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "router_aux_loss", "lm_loss"):
            assert np.isclose(g[k], w[k], rtol=rtol, atol=0), (k, g[k], w[k])


def test_trainer_matches_jax_at_one_rank(runs):
    _same_history(runs["one"], runs["jax"]["dp2_ep2"])
    assert all(np.isnan(r["mfu"]) for r in runs["one"])  # no device peak on the CPU


@pytest.mark.parametrize("name", list(MESHES))
def test_expert_parallel_trainer_matches_jax(runs, name):
    """dp 2 x ep 2 (dropless and dropped at a binding capacity) and tp 2 x
    ep 2 (SP) on 4 gloo ranks, each against the JAX trainer at the same
    mesh, every rank logging the same numbers."""
    ranks = [r[name] for r in runs["ranks"]]
    _same_history(ranks[0]["history"], runs["jax"][name])
    for r in ranks[1:]:
        assert [h["loss"] for h in r["history"]] == [h["loss"] for h in ranks[0]["history"]]
    coords = sorted((r["coords"]["data"], r["coords"]["ep"], r["coords"]["tp"]) for r in ranks)
    ep, tp, _ = MESHES[name]
    assert coords == sorted((d, e, t) for d in range(4 // (ep * tp)) for e in range(ep)
                            for t in range(tp))
    # ZeRO-1: an expert leaf's moments over data alone (none at data 1), a
    # dense one's over (data, expert)
    shards = ranks[0]["zero1_shards"]
    dp = 4 // (ep * tp)
    local = [4 // ep, 64 // dp, 256 // tp]
    assert shards["layers.0.mlp.experts.gate_up"] == [[4, 64, 256] if dp > 1 else local, local]
    assert shards["layers.0.input_norm.scale"] == [[64], [64 // (dp * ep)]]


def test_ep2_save_restores_at_ep1_and_resumes_bit_for_bit(runs):
    """The dp 2 x ep 2 run saved at step 2: restored at ep 1 (dp 4) its
    params and moments are the saved ones bit for bit; resumed at ep 2 its
    step 3 and final state equal the straight dp 2 x ep 2 run's."""
    d = runs["dumps"]
    assert d["pre"].keys() == d["at_ep1"].keys()
    for k, v in d["pre"].items():
        assert torch.equal(v, d["at_ep1"][k]), k
    straight = d["dp2_ep2"]
    assert d["resume"].keys() == straight.keys()
    for k, v in d["resume"].items():
        assert torch.equal(v, straight[k]), k
    for r in runs["ranks"]:
        assert [h["step"] for h in r["resume"]["history"]] == [2]
        assert r["resume"]["history"][0]["loss"] == r["dp2_ep2"]["history"][2]["loss"]
        assert r["resume"]["history"][0]["grad_norm"] == r["dp2_ep2"]["history"][2]["grad_norm"]
