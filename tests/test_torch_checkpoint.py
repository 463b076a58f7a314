"""The port's checkpointer (``torch.distributed.checkpoint``) and its
integrity layer, on the CPU: the cases of the JAX package's
``tests/test_integrity.py`` and checkpoint tests, over the port's layout.

- save/restore round trips are bitwise (fp32 and bf16 leaves, the int
  optimizer step);
- retention keeps the best ``save_top_k`` by ``monitor`` plus the newest
  step (the JAX package's orbax ``BestN(reverse=True) + LatestN(1)`` policy);
- an async save followed by ``wait`` commits; a step already saved is not
  written again; a failed async save raises;
- each corruption kind is quarantined and walked back; with nothing that
  verifies, the restore raises ``CheckpointIntegrityError``;
- the ``exp_manager.checkpoint`` knob block parses as the JAX one does.
"""

import concurrent.futures
import json
import logging
import os
import re
import threading

import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.checkpoint import integrity as I
from neuronx_distributed_training_torch.checkpoint import manager as M
from neuronx_distributed_training_torch.checkpoint.integrity import (
    CheckpointIntegrityError,
    IntegrityConfig,
)
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.trainer import exp_manager as t_exp
from neuronx_distributed_training_tpu.checkpoint import integrity as J


def _trees(scale: float = 1.0, master: bool = False):
    g = torch.Generator().manual_seed(int(scale * 10))
    p = {"embed": {"embedding": torch.randn(8, 4, generator=g) * scale},
         "layers": [{"w": (torch.randn(4, 6, generator=g) * scale).to(torch.bfloat16)},
                    {"w": torch.full((4, 6), scale).to(torch.bfloat16)}],
         "final_norm": {"scale": torch.full((4,), scale)}}
    flat = M.flatten_tree(p)
    o = {"step": int(scale), "mu": {n: torch.randn(t.shape, generator=g) for n, t in flat.items()},
         "nu": {n: torch.rand(t.shape, generator=g) for n, t in flat.items()}}
    if master:
        o["master"] = {n: t.float().clone() for n, t in flat.items()}
    return p, o


def _save_steps(tmp_path, steps=(1, 2), *, integrity=None, top_k=5, losses=None, **over):
    ck = M.Checkpointer(M.CheckpointConfig(
        dir=tmp_path, async_save=over.pop("async_save", False), save_top_k=top_k,
        integrity=integrity if integrity is not None else IntegrityConfig(), **over))
    for i, s in enumerate(steps):
        p, o = _trees(float(s))
        metrics = {"loss": losses[i]} if losses is not None else {"loss": 10.0 - s}
        assert ck.save(M.TrainState(p, o, s, s * 8), metrics=metrics)
    ck.wait()
    return ck


def _assert_tree_equal(a, b):
    fa, fb = M.flatten_tree(a), M.flatten_tree(b)
    assert fa.keys() == fb.keys()
    for n in fa:
        assert fa[n].dtype == fb[n].dtype, n
        assert torch.equal(fa[n], fb[n]), n


# ---------------------------------------------------------------------------
# the knob block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [None, True, False, {}, {"audit": True},
                                   {"quarantine": False, "audit_deadline_seconds": 3}])
def test_integrity_config_parses_as_jax(block):
    t, j = IntegrityConfig.from_config(block), J.IntegrityConfig.from_config(block)
    assert {f: getattr(t, f) for f in I.INTEGRITY_KNOBS} == \
        {f: getattr(j, f) for f in J.INTEGRITY_KNOBS}


@pytest.mark.parametrize("block,match", [
    ({"quarantene": True}, "quarantine"),
    ({"audit": "yes"}, "boolean"),
    ({"audit_deadline_seconds": "fast"}, "number"),
    ({"audit_deadline_seconds": -1}, ">= 0"),
])
def test_integrity_config_rejections_match_jax(block, match):
    with pytest.raises(ValueError, match=match) as te:
        IntegrityConfig.from_config(block)
    with pytest.raises(ValueError) as je:
        J.IntegrityConfig.from_config(block)
    assert str(te.value) == str(je.value)


def test_checkpoint_block_validated_at_load_with_did_you_mean():
    with pytest.raises(ValueError, match="'integrety' -> 'integrity'"):
        t_loader.load_config({"exp_manager": {"checkpoint": {"integrety": {}}}})
    with pytest.raises(ValueError, match="enabled"):
        t_loader.load_config({"exp_manager": {"checkpoint": {"integrity": {"enabeld": True}}}})
    cfg = t_loader.load_config({"exp_manager": {
        "exp_dir": "/x", "save_bf16": True,
        "checkpoint_callback_params": {"save_top_k": 2, "every_n_train_steps": 7,
                                       "async_checkpointing": False, "monitor": "val_loss"},
        "checkpoint": {"integrity": {"audit": True}}}})
    c = M.CheckpointConfig.from_config(cfg)
    assert (c.save_top_k, c.every_n_train_steps, c.async_save, c.monitor, c.save_bf16) == \
        (2, 7, False, "val_loss", True)
    assert c.integrity.audit and c.integrity.enabled


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("master", [False, True])
def test_round_trip_is_bitwise(tmp_path, async_save, master):
    ck = M.Checkpointer(M.CheckpointConfig(dir=tmp_path, async_save=async_save))
    p, o = _trees(3.0, master=master)
    assert ck.save(M.TrainState(p, o, 3, 24, extra={"layer_layout": "flat"}),
                   metrics={"loss": 1.5})
    ck.wait()
    assert ck.committed_steps == [3] and ck.last_save["bytes"] > 0
    assert ck.process_group_mode == "no_dist"
    p2, o2 = _trees(0.5, master=master)
    st = ck.restore(p2, o2)
    assert (st.step, st.consumed_samples, st.extra) == (3, 24, {"layer_layout": "flat"})
    _assert_tree_equal(st.params, p)
    for g in ("mu", "nu") + (("master",) if master else ()):
        _assert_tree_equal(st.opt_state[g], o[g])
    # the step counter comes back as the 0-d int64 tensor the update keeps
    assert st.opt_state["step"] == 3 and st.opt_state["step"].dtype == torch.int64
    assert st.opt_state["step"].ndim == 0
    assert st.params is p2  # restored into the live tensors
    ck.close()


def test_async_save_overlaps_and_wait_commits(tmp_path):
    ck = M.Checkpointer(M.CheckpointConfig(dir=tmp_path, async_save=True))
    p, o = _trees(2.0)
    assert ck.save(M.TrainState(p, o, 2, 16))
    # the staged copy is what gets written: training may update in place now
    for t in M.flatten_tree(p).values():
        t.add_(1)
    ck.wait()
    assert ck.all_steps() == [2]
    assert not list(tmp_path.glob("*.tmp-*"))
    p2, o2 = _trees(0.0)
    ck.restore(p2, o2)
    _assert_tree_equal(p2, {k: v for k, v in _trees(2.0)[0].items()})
    ck.close()


def test_async_save_hashes_at_the_lowest_priority(tmp_path, monkeypatch):
    """The commit thread and the digest workers it starts run at nice 19;
    the caller's thread keeps its priority."""
    def nice() -> int:
        return os.getpriority(os.PRIO_PROCESS, threading.get_native_id())

    seen = []
    real = I.leaf_digests

    def spy(flat, workers=0):
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            seen.extend(ex.map(lambda _: nice(), range(4)))
        return real(flat, workers=workers)

    monkeypatch.setattr(I, "leaf_digests", spy)
    before = nice()
    ck = M.Checkpointer(M.CheckpointConfig(dir=tmp_path, async_save=True))
    p, o = _trees(1.0)
    assert ck.save(M.TrainState(p, o, 1, 8))
    ck.close()
    assert set(seen) == {19} and nice() == before


def test_saving_a_saved_step_writes_nothing(tmp_path):
    ck = _save_steps(tmp_path, steps=(2,), async_save=True)
    before = {p: p.stat().st_mtime_ns for p in (tmp_path / "2").rglob("*")}
    p, o = _trees(9.0)
    assert not ck.save(M.TrainState(p, o, 2, 16))
    assert not ck.save(M.TrainState(p, o, 2, 16), force=True)
    assert not ck.save(M.TrainState(p, o, 1, 8))  # older than the newest, not forced
    ck.wait()
    assert ck.committed_steps == [2]
    assert {p: p.stat().st_mtime_ns for p in (tmp_path / "2").rglob("*")} == before
    ck.close()


def test_failed_async_save_raises_and_leaves_no_staging(tmp_path, monkeypatch):
    import torch.distributed.checkpoint as dcp

    ck = M.Checkpointer(M.CheckpointConfig(dir=tmp_path, async_save=True))
    real = dcp.async_save

    def broken(*a, no_dist=False, **k):
        fut = real(*a, no_dist=no_dist, **k)
        fut.result()
        from concurrent.futures import Future

        bad = Future()
        bad.set_exception(OSError(28, "No space left on device"))
        return bad

    monkeypatch.setattr(dcp, "async_save", broken)
    p, o = _trees(1.0)
    assert ck.save(M.TrainState(p, o, 1, 8))
    with pytest.raises(OSError, match="No space"):
        ck.wait()
    assert ck.all_steps() == [] and not list(tmp_path.glob("*.tmp-*"))
    # transient: save_with_retry retries and the second attempt commits
    calls = {"n": 0}

    def flaky(*a, no_dist=False, **k):
        calls["n"] += 1
        return (broken if calls["n"] <= 2 else real)(*a, no_dist=no_dist, **k)

    monkeypatch.setattr(dcp, "async_save", flaky)
    monkeypatch.setattr(M, "SAVE_RETRY_BACKOFF_SECONDS", 0.01)
    assert ck.save_with_retry(M.TrainState(p, o, 1, 8), drain=True)
    assert ck.all_steps() == [1]
    ck.close()


def test_non_transient_save_error_is_not_retried(tmp_path, monkeypatch):
    import torch.distributed.checkpoint as dcp

    ck = M.Checkpointer(M.CheckpointConfig(dir=tmp_path, async_save=False))
    calls = {"n": 0}

    def bad(*a, no_dist=False, **k):
        calls["n"] += 1
        raise PermissionError(13, "read-only")

    monkeypatch.setattr(dcp, "save", bad)
    monkeypatch.setattr(M, "SAVE_RETRY_BACKOFF_SECONDS", 0.01)
    p, o = _trees(1.0)
    with pytest.raises(PermissionError):
        ck.save_with_retry(M.TrainState(p, o, 1, 8))
    assert calls["n"] == 1 and not list(tmp_path.glob("*.tmp-*"))
    assert M.is_transient_save_error(OSError(28, "full"))
    assert not M.is_transient_save_error(PermissionError(13, "ro"))
    ck.close()


def test_dcp_without_no_dist_or_process_group_is_refused():
    def old_save(state_dict, storage_writer=None):
        raise AssertionError("not called")

    import torch.distributed.checkpoint as dcp

    assert I.dcp_kwargs(dcp.load) == {"no_dist": True}
    version = re.escape(f"torch {torch.__version__}: ")
    with pytest.raises(RuntimeError, match=version + ".*old_save"):
        I.dcp_kwargs(old_save)


def test_save_bf16_and_dropped_master(tmp_path):
    ck = M.Checkpointer(M.CheckpointConfig(dir=tmp_path, save_bf16=True,
                                           use_master_weights_in_ckpt=False, async_save=False))
    p, o = _trees(2.0, master=True)
    ck.save(M.TrainState(p, o, 2, 16))
    assert ck.verify_step(2).status == "ok"
    side = I.read_sidecar(tmp_path, 2)
    assert side["tree"]["params"]["embed.embedding"]["dtype"] == "bfloat16"
    assert not any(k.startswith("master/") for k in side["tree"]["opt_state"])
    p2, o2 = _trees(0.0, master=True)
    ck.restore(p2, o2)
    want = M.flatten_tree(p)["embed.embedding"].to(torch.bfloat16).float()
    assert torch.equal(M.flatten_tree(p2)["embed.embedding"], want)
    assert p2["embed"]["embedding"].dtype == torch.float32
    # the master is re-seeded from the restored params
    assert torch.equal(o2["master"]["embed.embedding"], want)
    ck.close()


def test_restore_params_only_and_shape_mismatch(tmp_path):
    ck = _save_steps(tmp_path, steps=(4,))
    p, _ = _trees(0.0)
    ck.restore_params_only(p)
    _assert_tree_equal(p, _trees(4.0)[0])
    bad, bo = _trees(0.0)
    bad["embed"]["embedding"] = torch.zeros(9, 4)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(bad, bo)
    bad, bo = _trees(0.0)
    del bad["final_norm"]
    with pytest.raises(ValueError, match="unexpected"):
        ck.restore(bad, bo)
    ck.close()


# ---------------------------------------------------------------------------
# retention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("losses,top_k,kept", [
    ([5.0, 4.0, 3.0, 2.0], 1, [4]),          # improving: the newest is also the best
    ([2.0, 4.0, 3.0, 5.0], 1, [1, 4]),       # best stays, plus the newest
    ([2.0, 4.0, 1.0, 5.0], 2, [1, 3, 4]),    # best two plus the newest
    ([3.0, 3.0, 3.0], 1, [3]),               # ties: the later step ranks higher
    ([5.0, 1.0, 4.0], 0, [1, 2, 3]),         # save_top_k <= 0 keeps everything
])
def test_retention_best_k_plus_last(tmp_path, losses, top_k, kept):
    steps = list(range(1, len(losses) + 1))
    ck = _save_steps(tmp_path, steps=steps, top_k=top_k, losses=losses)
    assert ck.all_steps() == kept
    assert sorted(M.retained_steps({s: {"loss": v} for s, v in zip(steps, losses)},
                                   top_k, "loss")) == kept
    ck.close()


def test_retention_rule_edges():
    # saved without metrics: always kept; a missing monitor ranks last
    assert M.retained_steps({1: {}, 2: {"loss": 3.0}, 3: {"loss": 1.0}}, 1, "loss") == {1, 3}
    assert M.retained_steps({1: {"x": 1.0}, 2: {"loss": 3.0}, 3: {"loss": 4.0}}, 1, "loss") \
        == {2, 3}
    assert M.retained_steps({}, 3, "loss") == set()


# ---------------------------------------------------------------------------
# integrity: sidecar, verification, quarantine, walk-back
# ---------------------------------------------------------------------------


def test_sidecar_deterministic_and_grouped():
    p, o = _trees(1.0, master=True)
    trees = M.state_trees(p, o)
    a = I.build_sidecar(step=1, trees=trees, meta={"step": 1})
    b = I.build_sidecar(step=1, trees=M.state_trees(*_trees(1.0, master=True)),
                        meta={"step": 1})
    assert a == b
    assert set(a["groups"]) == {"params", "opt_state/mu", "opt_state/nu", "opt_state/master",
                                "opt_state/step"}
    assert a["tree"]["params"]["layers.0.w"] == {"dtype": "bfloat16", "shape": [4, 6]}
    o["nu"]["final_norm.scale"][0] += 1
    c = I.build_sidecar(step=1, trees=M.state_trees(p, o), meta={"step": 1})
    changed = {g for g in a["groups"] if a["groups"][g] != c["groups"][g]}
    assert changed == {"opt_state/nu"}
    assert I.json_digest({"a": 1, "b": [1.0]}) == I.json_digest({"b": [1.0], "a": 1}) == \
        J.json_digest({"a": 1, "b": [1.0]})


def test_leaf_digests_cover_every_chunk(monkeypatch):
    monkeypatch.setattr(I, "CHUNK_BYTES", 64)
    t = torch.arange(100, dtype=torch.float32)
    d0 = I.leaf_digests({"t": t}, workers=3)["t"]
    for i in (0, 40, 99):  # first, middle and last chunk
        u = t.clone()
        u[i] += 1
        assert I.leaf_digests({"t": u}, workers=3)["t"] != d0
    assert I.leaf_digests({"t": t.clone()}, workers=1)["t"] == d0


def test_clean_save_verifies(tmp_path):
    with _save_steps(tmp_path) as ck:
        v = ck.verify_step(2)
        assert v.status == "ok" and not v.failures and v.groups_checked == 5
        assert ck.verified_latest_step() == 2
        assert ck.integrity_trail["verified_step"] == 2
        assert ck.integrity_trail["walk_back_count"] == 0


def test_legacy_checkpoint_restores_with_warning(tmp_path, caplog):
    ck = _save_steps(tmp_path, integrity=IntegrityConfig(enabled=False))
    assert not (tmp_path / "2" / I.SIDECAR_NAME).exists()
    assert ck.verify_step(2).status == "legacy"
    p, o = _trees()
    with caplog.at_level(logging.WARNING):
        assert ck.restore(p, o, verify=True).step == 2
    assert "legacy" in caplog.text.lower() and ck.integrity_trail["legacy_restore"] is True
    ck.close()


def test_explicit_corrupt_step_raises(tmp_path):
    ck = _save_steps(tmp_path)
    I.inject_corruption(ck.directory, 2, "byte_flip")
    p, o = _trees()
    with pytest.raises(CheckpointIntegrityError, match="step 2"):
        ck.restore(p, o, step=2)
    ck.close()


@pytest.mark.parametrize("kind", I.CORRUPTION_KINDS)
def test_corruption_is_quarantined_and_walked_back(tmp_path, kind):
    assert I.CORRUPTION_KINDS == J.CORRUPTION_KINDS
    ck = _save_steps(tmp_path, steps=(1, 2, 3))
    what = I.inject_corruption(ck.directory, 3, kind)
    assert kind.split("_")[0] in what
    v = ck.verify_step(3)
    assert v.status == "corrupt" and v.failures, (kind, v)
    assert ck.verified_latest_step() == 2
    trail = ck.integrity_trail
    assert (trail["verified_step"], trail["walk_back_count"], trail["quarantined_steps"]) == \
        (2, 1, [3])
    assert [e["step"] for e in I.read_ledger(ck.directory)] == [3]
    assert len([p for p in ck.directory.iterdir() if I.parse_quarantine_name(p.name) == 3]) == 1
    assert ck.latest_step() == 2
    p, o = _trees()
    restored = ck.restore(p, o)
    assert restored.step == 2
    _assert_tree_equal(restored.params, _trees(2.0)[0])
    ck.close()


def test_nothing_verifies_raises_with_every_verdict(tmp_path):
    ck = _save_steps(tmp_path, steps=(1, 2))
    I.inject_corruption(ck.directory, 2, "byte_flip")
    I.inject_corruption(ck.directory, 1, "delete_item", item="opt_state")
    p, o = _trees()
    with pytest.raises(CheckpointIntegrityError) as ei:
        ck.restore(p, o)
    msg = str(ei.value)
    assert "every retained checkpoint" in msg and "step 2" in msg and "step 1" in msg
    assert I.LEDGER_NAME in msg and len(ei.value.verdicts) == 2
    assert ck.latest_step() is None
    ck.close()


def test_quarantine_off_reports_honestly(tmp_path):
    ck = _save_steps(tmp_path, integrity=IntegrityConfig(quarantine=False))
    I.inject_corruption(ck.directory, 2, "byte_flip")
    assert ck.verified_latest_step() == 1
    assert ck.integrity_trail["quarantined_steps"] == []
    assert ck.integrity_trail["corrupt_steps_unquarantined"] == [2]
    assert (ck.directory / "2").exists() and I.read_ledger(ck.directory) == []
    ck.close()


def test_gone_step_is_skipped(tmp_path, monkeypatch):
    ck = _save_steps(tmp_path)
    real = ck.verify_step
    monkeypatch.setattr(ck, "verify_step", lambda s, keep=None: (
        I.StepVerification(step=s, status="gone") if s == 2 else real(s, keep=keep)))
    assert ck.verified_latest_step() == 1
    assert ck.integrity_trail["walk_back_count"] == 0
    monkeypatch.setattr(ck, "verify_step",
                        lambda s, keep=None: I.StepVerification(step=s, status="gone"))
    assert ck.verified_latest_step() is None
    ck.close()


def test_save_audit_detects_post_commit_corruption(tmp_path):
    ck = M.Checkpointer(M.CheckpointConfig(dir=tmp_path, async_save=False,
                                           integrity=IntegrityConfig(audit=True)))
    p, o = _trees(1.0)
    assert ck.save(M.TrainState(p, o, 1, 8), metrics={"loss": 9.0})
    # corrupt before the auditor is handed the step (``wait`` hands it over;
    # a corruption after that races the auditor's read)
    I.inject_corruption(ck.directory, 1, "byte_flip")
    ck.wait()  # hands step 1 to the auditor
    assert ck._auditor.drain(30)
    p, o = _trees(2.0)
    ck.save(M.TrainState(p, o, 2, 16))  # applies the finished verdict first
    assert ck.integrity_trail["audit_quarantined"] == [1]
    ck.close()
    assert ck.integrity_trail["audit"]["audited"] == 2
    assert ck.integrity_trail["audit"]["failed"] == 1


def test_quarantine_names_and_version_parse(tmp_path):
    name = I.quarantine_name(42, "params: content digest mismatch")
    assert name == J.quarantine_name(42, "params: content digest mismatch")
    assert I.parse_quarantine_name(name) == 42 and I.parse_quarantine_name("42") is None
    base = tmp_path / "exp" / "run"
    for d in ("version_0", "version_3", "version_backup_9", name):
        (base / d).mkdir(parents=True)
    assert t_exp.latest_version(base) == 3


def test_injection_rejects_unknown_kind(tmp_path):
    ck = _save_steps(tmp_path, steps=(1,))
    with pytest.raises(ValueError, match="unknown corruption kind"):
        I.inject_corruption(ck.directory, 1, "melt")
    with pytest.raises(FileNotFoundError):
        I.inject_corruption(ck.directory, 7, "byte_flip")
    ck.close()


def test_meta_and_sidecar_are_json(tmp_path):
    ck = _save_steps(tmp_path, steps=(5,))
    meta = json.loads((tmp_path / "5" / I.META_NAME).read_text())
    assert meta["step"] == 5 and meta["consumed_samples"] == 40 and meta["metrics"]["loss"] == 5.0
    side = I.read_sidecar(tmp_path, 5)
    assert side["algo"] == J.DIGEST_ALGO and side["step"] == 5
    assert np.all([len(d) == 32 for d in side["leaves"]["params"].values()])
    ck.close()


@pytest.mark.parametrize("losses,top_k", [([5.0, 4.0, 3.0, 2.0], 1), ([2.0, 4.0, 3.0, 5.0], 1),
                                          ([2.0, 4.0, 1.0, 5.0], 2), ([3.0, 3.0, 3.0], 1)])
def test_retention_matches_the_jax_checkpointer(tmp_path, losses, top_k):
    """The same saves with the same metrics leave the same steps under the
    port's checkpointer and the JAX package's (orbax) one."""
    import jax.numpy as jnp

    from neuronx_distributed_training_tpu.checkpoint import manager as JM

    jck = JM.Checkpointer(JM.CheckpointConfig(dir=tmp_path / "j", save_top_k=top_k,
                                              async_save=False))
    if not jck.preservation_api:
        pytest.skip("this orbax has no preservation policy: the JAX package keeps newest-N")
    for s, loss in enumerate(losses, start=1):
        jck.save(JM.TrainState({"w": jnp.full((2,), float(s))}, {"step": jnp.asarray(s)}, s,
                               s * 8), metrics={"loss": loss})
    jck.wait()
    ck = _save_steps(tmp_path / "t", steps=range(1, len(losses) + 1), top_k=top_k,
                     losses=losses)
    assert ck.all_steps() == sorted(jck._mgr.all_steps())
    jck.close()
    ck.close()
