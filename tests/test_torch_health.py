"""The port's non-finite step policy against the JAX package's numerics
health probes (``telemetry/health.py``, ``optim/adamw.py``, the step's
counters and the loop's ``halt``).

- the cases of ``tests/test_health.py`` that hold the semantics, run on the
  same seeded inputs through JAX and the port: NaN and Inf gradients and a
  false ``extra_finite`` skip the update (the port keeps params, ``mu``,
  ``nu``, ``master`` and ``step`` bit for bit), finite gradients update
  exactly as without the skip, a NaN batch in a two-layer llama step is
  suppressed with JAX's counters and the clean step after it stays within
  ``test_torch_step.py``'s fp32 bar (loss and grad norm rtol 1e-5), and
  ``dump_and_continue`` counts the step and applies it;
- the knob block: unknown keys, bad policies and bad values raise with the
  JAX messages, at ``load_config`` too; ``grad_group_of`` names the JAX
  groups;
- the loop: ``halt`` stops at the non-finite step with no checkpoint and
  ``stop_class == "health_halt"``; the counters are checkpointed and come
  back on resume; the recorder knobs are logged as ignored.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.optim import adamw as t_adamw
from neuronx_distributed_training_torch.optim import lr as t_lr
from neuronx_distributed_training_torch.telemetry import health as t_health
from neuronx_distributed_training_torch.tools.convert import params_from_jax
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.trainer import step as t_step
from neuronx_distributed_training_torch.utils import dtypes as t_dtypes
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.models import llama as j_llama
from neuronx_distributed_training_tpu.optim import adamw as j_adamw
from neuronx_distributed_training_tpu.optim import lr as j_lr
from neuronx_distributed_training_tpu.telemetry import health as j_health
from neuronx_distributed_training_tpu.trainer import step as j_step
from neuronx_distributed_training_tpu.utils import dtypes as j_dtypes

MODEL = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=16)
WORKER = Path(__file__).resolve().parent / "_torch_dp_worker.py"


def _flat(jtree) -> dict:
    """A JAX tree as the port's flat dict, in its dtypes (bf16 goes through
    fp32, exactly)."""
    leaves = jax.tree_util.tree_leaves(jtree)
    flat = t_llama.named_params(params_from_jax(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jtree), device="cpu"))
    if leaves and leaves[0].dtype == jnp.bfloat16:
        flat = {n: t.to(torch.bfloat16) for n, t in flat.items()}
    return flat


def _clone(d: dict) -> dict:
    return {k: (v.clone() if isinstance(v, torch.Tensor) else
                _clone(v) if isinstance(v, dict) else v) for k, v in d.items()}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b) or bool(torch.all((a == b) | (a.isnan() & b.isnan())))
    return a == b


def _optimizer_case(case: str):
    """One AdamW update on both sides: (port metrics, port state before and
    after, JAX metrics) for the ``tests/test_health.py`` optimizer cases."""
    jcfg = j_llama.LlamaConfig.from_config(MODEL)
    jpol = j_dtypes.DtypePolicy.from_precision_config("mixed_precision")
    params = j_llama.init_params(jax.random.PRNGKey(0), jcfg, jpol)
    grads = jax.tree_util.tree_map(lambda p: 0.1 * p, params)
    extra = None
    if case == "nan_grads_freeze_everything":
        grads["layers"]["attn"]["qkv"]["w"] = grads["layers"]["attn"]["qkv"]["w"].at[
            0, 0, 0].set(jnp.nan)
    elif case == "inf_grads_also_skip":
        grads["embed"]["embedding"] = grads["embed"]["embedding"].at[0, 0].set(jnp.inf)
    elif case == "extra_finite_flag_forces_skip":
        extra = False
    # bf16 params with an fp32 master, so that the master is held too
    jpol = j_dtypes.DtypePolicy.from_precision_config("bf16SR")
    params = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    jopt = j_adamw.init_opt_state(params, jpol)
    _, _, jm = jax.jit(lambda p, g, o: j_adamw.adamw_update(
        p, g, o, 1e-3, j_adamw.AdamWConfig(), jpol, skip_nonfinite=True,
        extra_finite=extra))(params, grads, jopt)
    tpol = t_dtypes.DtypePolicy.from_precision_config("bf16SR")
    tp, tg = _flat(params), _flat(grads)
    topt = t_adamw.init_opt_state(tp, tpol)
    assert "master" in topt
    before = _clone({"params": tp, **topt})
    grads_before = _clone(tg)  # the update clips fp32 gradients in place
    tm = t_adamw.adamw_update(tp, tg, topt, 1e-3, t_adamw.AdamWConfig(), tpol,
                              skip_nonfinite=True, extra_finite=extra)
    return tm, before, {"params": tp, **topt}, jm, (tp, grads_before, tpol)


def _step_case(policy: str):
    """Three steps of a two-layer llama, clean / NaN loss_mask / clean, on
    both sides with the health probes on; returns the per-step metrics and
    the port's state after each step."""
    jcfg = j_llama.LlamaConfig.from_config(MODEL)
    jpol = j_dtypes.DtypePolicy.from_precision_config("fp32")
    jparams = j_llama.init_params(jax.random.PRNGKey(0), jcfg, jpol)
    jopt = j_adamw.init_opt_state(jparams, jpol, health=True)
    jstep = jax.jit(j_step.make_train_step(
        lambda p, b, k: j_llama.forward(p, b, jcfg, jpol), j_adamw.AdamWConfig(),
        j_lr.constant_lr(1e-3), jpol,
        health_cfg=j_health.HealthConfig(enabled=True, policy=policy)))
    tcfg = t_llama.LlamaConfig.from_config(MODEL)
    tpol = t_dtypes.DtypePolicy.from_precision_config("fp32")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    topt = t_adamw.init_opt_state(t_llama.named_params(tparams), tpol, health=True)
    tstep = t_step.make_train_step(
        lambda p, b: t_llama.forward(p, b, tcfg, tpol), t_adamw.AdamWConfig(),
        t_lr.build_lr_schedule({"lr": 1e-3, "sched": {"name": "constant"}}), tpol,
        health=t_health.HealthConfig(enabled=True, policy=policy))
    ids = np.random.default_rng(1).integers(0, 64, (4, 16)).astype(np.int32)
    clean = {"input_ids": ids, "labels": ids, "loss_mask": np.ones((4, 16), np.float32)}
    poisoned = dict(clean, loss_mask=np.full((4, 16), np.nan, np.float32))
    jms, tms, states = [], [], []
    for i, b in enumerate((clean, poisoned, clean)):
        jparams, jopt, jm = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()},
                                  jax.random.PRNGKey(i))
        tms.append({k: float(v) for k, v in tstep(
            tparams, topt, {k: torch.as_tensor(v) for k, v in b.items()}).items()})
        jms.append({k: float(v) for k, v in jm.items()})
        states.append(_clone({"params": t_llama.named_params(tparams), **topt}))
    assert topt["health"] == {k: int(v) for k, v in jopt["health"].items()}
    assert topt["step"] == int(jopt["step"])
    return jms, tms, states


HEALTH_COUNTERS = ("health/updates_finite", "health/loss_finite", "health/nonfinite_count",
                   "health/skipped_count", "health/last_nonfinite_step")


@pytest.mark.parametrize("case", [
    "nan_grads_freeze_everything", "inf_grads_also_skip", "extra_finite_flag_forces_skip",
    "finite_grads_update_exactly_as_without_skip", "nan_batch_suppresses_update_bitwise",
    "dump_and_continue_counts_but_applies",
])
def test_skip_semantics_match_jax(case):
    if case in ("nan_batch_suppresses_update_bitwise", "dump_and_continue_counts_but_applies"):
        policy = "skip_update" if case.startswith("nan_batch") else "dump_and_continue"
        jms, tms, states = _step_case(policy)
        for jm, tm in zip(jms, tms):
            assert {k: tm[k] for k in HEALTH_COUNTERS} == {k: jm[k] for k in HEALTH_COUNTERS}
            assert {k for k in tm if k.startswith("health/grad_norm/")} == \
                {k for k in jm if k.startswith("health/grad_norm/")}
        assert tms[1]["health/updates_finite"] == 0.0 and tms[1]["health/nonfinite_count"] == 1
        if policy == "skip_update":
            assert tms[1]["health/skipped_count"] == 1.0
            assert _equal(states[1], {**states[0], "health": states[1]["health"]})
            assert states[1]["health"]["steps_seen"] == 2 and states[1]["step"] == 1
            # training goes on: the clean step after the skip updates, as JAX's
            assert not _equal(states[2]["params"], states[1]["params"])
            assert all(bool(torch.isfinite(t).all()) for t in states[2]["params"].values())
            for k in ("loss", "grad_norm", "health/param_norm"):
                assert np.isclose(tms[2][k], jms[2][k], rtol=1e-5, atol=0), k
        else:
            assert tms[1]["health/skipped_count"] == 0.0
            assert not _equal(states[1]["params"], states[0]["params"])
            assert states[1]["step"] == states[0]["step"] + 1
        return
    tm, before, after, jm, (tp, tg, tpol) = _optimizer_case(case)
    assert bool(tm["updates_finite"]) == bool(jm["updates_finite"])
    if case == "finite_grads_update_exactly_as_without_skip":
        assert bool(tm["updates_finite"])
        plain = _clone(before)
        plain_params = plain.pop("params")
        t_adamw.adamw_update(plain_params, tg, plain, 1e-3, t_adamw.AdamWConfig(), tpol)
        assert _equal(after, {"params": plain_params, **plain})
        assert not _equal(after["params"], before["params"])
    else:
        assert not bool(tm["updates_finite"])
        assert _equal(after, before)  # params, mu, nu, master and step, bit for bit


@pytest.mark.parametrize("block", [
    {"polcy": "halt"}, {"policy": "ignore"}, {"ring_buffer_steps": 0},
    {"watchdog_timeout_seconds": -1}, {"enabled": "yes"}, {"max_bundles": 0},
    {"data_wait_timeout_seconds": -1}, "on",
], ids=["unknown_key", "bad_policy", "ring", "watchdog", "not_bool", "bundles",
        "data_wait", "not_mapping"])
def test_health_block_errors_match_jax(block):
    with pytest.raises(ValueError) as je:
        j_health.HealthConfig.from_config(block)
    with pytest.raises(ValueError) as te:
        t_health.HealthConfig.from_config(block)
    assert str(te.value) == str(je.value)
    if isinstance(block, dict) and ("polcy" in block or "policy" in block):
        cfg = {"exp_manager": {"telemetry": {"health": block}},
               "data": {"global_batch_size": 8, "micro_batch_size": 1}}
        with pytest.raises(ValueError, match="polcy" if "polcy" in block else "halt"):
            t_loader.load_config(cfg)
        with pytest.raises(ValueError):
            j_loader.load_config(cfg)


@pytest.mark.parametrize("block", [None, True, False, {"enabled": True, "policy": "halt"},
                                   {"policy": "skip_update", "ring_buffer_steps": 4,
                                    "watchdog_timeout_seconds": 9.0, "param_norm": False}])
def test_health_block_parses_as_jax(block):
    t, j = t_health.HealthConfig.from_config(block), j_health.HealthConfig.from_config(block)
    assert t.to_dict() == j.to_dict()
    assert t_health.HEALTH_POLICIES == j_health.HEALTH_POLICIES
    assert t_adamw.HEALTH_STATE_KEYS == j_adamw.HEALTH_STATE_KEYS


def test_grad_groups_match_jax():
    jcfg = j_llama.LlamaConfig.from_config(MODEL)
    jparams = j_llama.init_params(jax.random.PRNGKey(0), jcfg,
                                  j_dtypes.DtypePolicy.from_precision_config("fp32"))
    jgroups = {j_health.grad_group_of(path)
               for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {t_health.grad_group_of(n) for n in _flat(jparams)} == jgroups
    assert t_health.grad_group_of("layers.3.attn.qkv.lora_a") == "layers/attn"
    assert t_health.grad_group_of("embed.embedding") == "embed"
    assert t_health.grad_group_of("final_norm.scale") == "final_norm"


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def _nan_rows(step: int):
    spec = importlib.util.spec_from_file_location("_torch_dp_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.NanRows(128, 32, 8, seed=7, step=step, rows=list(range(8)))


def _cfg(tmp_path, policy, *, exp="exp", max_steps=4, every=1):
    return t_loader.load_config({
        "name": "health", "seed": 7,
        "trainer": {"max_steps": max_steps, "log_every_n_steps": 1},
        "exp_manager": {"exp_dir": str(tmp_path / exp), "resume_if_exists": True,
                        "create_tensorboard_logger": False, "log_files": False,
                        "checkpoint_callback_params": {"save_top_k": 5,
                                                       "every_n_train_steps": every},
                        "telemetry": {"health": {"enabled": True, "policy": policy}}},
        "data": {"global_batch_size": 8, "micro_batch_size": 4, "seq_length": 32,
                 "synthetic": True},
        "model": {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
                  "num_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                  "optim": {"lr": 1e-3, "sched": {"name": "constant"}}},
        "precision": {"type": "fp32"},
    })


def test_halt_stops_at_the_step_without_a_checkpoint(tmp_path):
    t = t_loop.Trainer.from_config(_cfg(tmp_path, "halt"), device="cpu",
                                   data_module=_nan_rows(1))
    history = t.fit()
    assert [h["step"] for h in history] == [0, 1]
    assert t.stop_class == "health_halt"
    assert t.checkpointer.committed_steps == [1]  # step 0's save; none at the halt
    assert t.opt_state["step"] == 2  # halt applies the update, as in JAX
    summary = json.loads((t.exp.log_dir / "run_summary.json").read_text())
    assert summary["stop_class"] == "health_halt"


def test_health_counters_are_checkpointed_and_restored(tmp_path):
    t = t_loop.Trainer.from_config(_cfg(tmp_path, "skip_update", max_steps=3, every=3),
                                   device="cpu", data_module=_nan_rows(1))
    history = t.fit()
    assert [h["health/updates_finite"] for h in history] == [1.0, 0.0, 1.0]
    assert t.opt_state["health"] == {"steps_seen": 3, "nonfinite_count": 1,
                                     "skipped_count": 1, "last_nonfinite_step": 1}
    assert t.opt_state["step"] == 2
    r = t_loop.Trainer.from_config(_cfg(tmp_path, "skip_update", max_steps=4, every=0),
                                   device="cpu")
    assert r.maybe_resume() and r.step == 3
    assert r.opt_state["health"] == t.opt_state["health"] and r.opt_state["step"] == 2
    # a checkpoint saved with health off restores with steps_seen = its step
    off = _cfg(tmp_path, "skip_update", exp="off", max_steps=2, every=2)
    off["exp_manager"]["telemetry"]["health"]["enabled"] = False
    t_loop.Trainer.from_config(off, device="cpu").fit()
    on = t_loop.Trainer.from_config(_cfg(tmp_path, "skip_update", exp="off", max_steps=3,
                                         every=0), device="cpu")
    assert on.maybe_resume()
    assert on.opt_state["health"] == {"steps_seen": 2, "nonfinite_count": 0,
                                      "skipped_count": 0, "last_nonfinite_step": -1}


def test_recorder_knobs_are_logged_as_ignored(caplog):
    """The flight recorder's knobs, the spans plane and (since the planes
    of ``tiny_smoke_config.yaml`` were ported) tensorstats and (since the
    trace slice) the trace plane are acted on, so they leave the ignored
    log, and so (since the planner slice) does ``exp_manager.elastic``; a
    knob the port does not act on (a TPU generation as the planner's
    topology) stays in it."""
    cfg = t_loader.load_config({
        "exp_manager": {"telemetry": {"spans": True, "tensorstats": {"enabled": True},
                                      "trace": {"enabled": True},
                                      "health": {"enabled": True, "policy": "skip_update",
                                                 "ring_buffer_steps": 4}},
                        "elastic": {}},
        "autotune": {"topology": "v5e"},
        "data": {"global_batch_size": 8, "micro_batch_size": 1}})
    t_loop._logged_ignored.clear()
    with caplog.at_level("INFO", logger="nxdt.torch.train"):
        t_loop._log_ignored(cfg)
    (msg,) = [r.getMessage() for r in caplog.records if "ignored" in r.getMessage()]
    assert "autotune.topology (v5e)" in msg and "exp_manager.elastic" not in msg
    assert "exp_manager.telemetry.trace" not in msg
    assert "exp_manager.telemetry.tensorstats" not in msg
    assert "exp_manager.telemetry.spans" not in msg
    assert "ring_buffer_steps" not in msg
    assert not any(f"health.{k}" in msg for k in ("enabled", "policy", "param_norm"))
