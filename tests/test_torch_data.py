"""The port's data layer against the JAX package's (and the JAX data tests'
cases, ported one for one).

- Megatron corpus format: the two packages write byte-identical ``.bin/.idx``
  files, and each reads the other's;
- index arrays: ``doc_idx``, ``sample_idx`` and ``shuffle_idx`` equal the JAX
  ``GPTDataset``'s for several seeds and lengths, through the C++ builder and
  through the numpy path;
- batches: ``build_data_module`` gives the JAX function's batches exactly
  (``data_prefix``, blended ``data_prefix``, an arrow ``train_dir``,
  ``synthetic``) at consumed-samples offsets 0 and k x gbs;
- samplers, the prefetch iterator, the transient-read retry and the batch
  token stats.

Every comparison is exact (``assert_array_equal``): the two pipelines are the
same integer and permutation arithmetic.  Each package builds its index
arrays from its own copy of the corpus, so neither reads the other's .npy
cache.
"""

import errno
import itertools
import sys
import threading
import time

import numpy as np
import pytest

from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.data import build as t_build
from neuronx_distributed_training_torch.data import loader as t_data
from neuronx_distributed_training_torch.data import sampler as t_sampler
from neuronx_distributed_training_torch.data.megatron import dataset as t_ds
from neuronx_distributed_training_torch.data.megatron import index as t_index
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.data import build as j_build
from neuronx_distributed_training_tpu.data import loader as j_data
from neuronx_distributed_training_tpu.data.megatron import dataset as j_ds
from neuronx_distributed_training_tpu.data.megatron import index as j_index

VOCAB = 512


def _docs(seed: int, n_docs: int = 60, dtype=np.int32, lo: int = 3, hi: int = 90):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, int(rng.integers(lo, hi))).astype(dtype)
            for _ in range(n_docs)]


def _corpus_pair(tmp_path, seed: int, name: str = "c", **kw):
    """The same corpus written by each package under its own dir."""
    docs = _docs(seed, **kw)
    (tmp_path / "t").mkdir(exist_ok=True)
    (tmp_path / "j").mkdir(exist_ok=True)
    t_ds.write_indexed_dataset(tmp_path / "t" / name, docs)
    j_ds.write_indexed_dataset(tmp_path / "j" / name, docs)
    return tmp_path / "t" / name, tmp_path / "j" / name, docs


# ---------------------------------------------------------------------------
# corpus format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.int64])
def test_indexed_files_are_byte_identical_and_cross_readable(tmp_path, dtype):
    tp, jp, docs = _corpus_pair(tmp_path, 3, dtype=dtype)
    for suffix in (".bin", ".idx"):
        assert tp.with_suffix(suffix).read_bytes() == jp.with_suffix(suffix).read_bytes()
    for reader, prefix in ((t_ds.IndexedDataset, jp), (j_ds.IndexedDataset, tp)):
        ds = reader(prefix)
        assert len(ds) == len(docs) and ds.dtype == np.dtype(dtype)
        for i in (0, 7, len(docs) - 1):
            np.testing.assert_array_equal(ds.get(i), docs[i])
            np.testing.assert_array_equal(ds.get(i, 2, 1), docs[i][2:3])


def test_bad_index_magic_is_rejected(tmp_path):
    tp, _, _ = _corpus_pair(tmp_path, 1)
    raw = bytearray(tp.with_suffix(".idx").read_bytes())
    raw[0] ^= 0xFF
    tp.with_suffix(".idx").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="bad index magic"):
        t_ds.IndexedDataset(tp)


# ---------------------------------------------------------------------------
# index arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("seed,seq,n", [(1234, 16, 40), (7, 33, 25), (99, 64, 12), (5, 8, 200)])
def test_gpt_dataset_index_arrays_match_jax(tmp_path, monkeypatch, builder, seed, seq, n):
    if builder == "native":
        assert t_index._load_native() is not None, "the C++ index builder did not build"
    else:
        monkeypatch.setattr(t_index, "_load_native", lambda: None)
    tp, jp, _ = _corpus_pair(tmp_path, seed)
    t = t_ds.GPTDataset(tp, seq, n, seed=seed, cache_dir=tmp_path / "tc")
    j = j_ds.GPTDataset(jp, seq, n, seed=seed, cache_dir=tmp_path / "jc")
    for name in ("doc_idx", "sample_idx", "shuffle_idx"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    for i in range(len(t)):
        tr, jr = t[i], j[i]
        np.testing.assert_array_equal(tr["input_ids"], jr["input_ids"])
        np.testing.assert_array_equal(tr["labels"], jr["labels"])
        np.testing.assert_array_equal(tr["input_ids"][1:], tr["labels"][:-1])  # pre-shifted
    # the cache is reused: a second build reads the same arrays back
    again = t_ds.GPTDataset(tp, seq, n, seed=seed, cache_dir=tmp_path / "tc")
    np.testing.assert_array_equal(again.shuffle_idx, t.shuffle_idx)


@pytest.mark.parametrize("seq,n", [(10, 30), (1, 100), (57, 9)])
def test_sample_idx_builders_agree(seq, n):
    rng = np.random.default_rng(seq)
    lens = rng.integers(1, 40, 50).astype(np.int32)
    doc_idx = j_index.build_doc_idx(50, 3, seed=seq)
    np.testing.assert_array_equal(t_index.build_doc_idx(50, 3, seed=seq), doc_idx)
    want = j_index._sample_idx_numpy(lens, doc_idx, n, seq)
    np.testing.assert_array_equal(t_index._sample_idx_numpy(lens, doc_idx, n, seq), want)
    np.testing.assert_array_equal(t_index.build_sample_idx(lens, doc_idx, n, seq), want)
    np.testing.assert_array_equal(t_index.build_shuffle_idx(n, seq),
                                  j_index.build_shuffle_idx(n, seq))


def test_native_library_is_built_under_build_not_beside_the_source():
    from neuronx_distributed_training_torch.data import _native

    assert t_index._load_native() is not None
    lib = _native.library_path(t_index._SRC)
    assert lib.exists() and lib.parent == _native.BUILD_DIR
    assert _native.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    assert not t_index._SRC.with_suffix(".so").exists()


# ---------------------------------------------------------------------------
# batches through build_data_module
# ---------------------------------------------------------------------------


def _cfgs(data: dict, max_steps: int = 6):
    raw = {"seed": 11, "trainer": {"max_steps": max_steps},
           "data": {"global_batch_size": 4, "micro_batch_size": 2, "seq_length": 24, **data},
           "model": {"vocab_size": VOCAB}}
    return t_loader.load_config(raw), j_loader.load_config(raw)


def _assert_same_batches(t_dm, j_dm, offset: int, n: int = 3):
    t_dm.sampler.consumed_samples = offset
    j_dm.sampler.consumed_samples = offset
    t_it, j_it = t_dm.global_batches(), j_dm.global_batches()
    for _ in range(n):
        tb, jb = next(t_it), next(j_it)
        assert tb.keys() == jb.keys()
        for k in tb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def _build_pair(tmp_path, kind):
    if kind == "data_prefix":
        tp, jp, _ = _corpus_pair(tmp_path, 21)
        return _cfgs({"data_prefix": str(tp)})[0], _cfgs({"data_prefix": str(jp)})[1]
    if kind == "blended":
        tp1, jp1, _ = _corpus_pair(tmp_path, 22, name="a")
        tp2, jp2, _ = _corpus_pair(tmp_path, 23, name="b")
        return (_cfgs({"data_prefix": [0.3, str(tp1), 0.7, str(tp2)]})[0],
                _cfgs({"data_prefix": [0.3, str(jp1), 0.7, str(jp2)]})[1])
    if kind == "train_dir":
        import datasets

        rows = np.random.default_rng(24).integers(0, VOCAB, (40, 24)).astype(np.int32)
        datasets.Dataset.from_dict({"input_ids": rows.tolist()}).save_to_disk(
            str(tmp_path / "arrow"))
        return _cfgs({"train_dir": str(tmp_path / "arrow")})
    return _cfgs({"synthetic": True})


@pytest.mark.parametrize("offset", [0, 8])
@pytest.mark.parametrize("kind", ["data_prefix", "blended", "train_dir", "synthetic"])
def test_build_data_module_batches_match_jax(tmp_path, kind, offset):
    tcfg, jcfg = _build_pair(tmp_path, kind)
    sched = t_loader.batch_schedule(tcfg, 1)
    t_dm, t_val = t_build.build_data_module(tcfg, sched, seed=11, vocab_size=VOCAB)
    j_dm, j_val = j_build.build_data_module(jcfg, j_loader.batch_schedule(jcfg, 1), seed=11,
                                            vocab_size=VOCAB)
    assert type(t_dm).__name__ == type(j_dm).__name__
    assert t_val is None and j_val is None
    assert getattr(t_dm, "labels_pre_shifted", False) == getattr(j_dm, "labels_pre_shifted",
                                                                 False)
    _assert_same_batches(t_dm, j_dm, offset)


def test_build_data_module_errors_match_jax(tmp_path):
    tcfg, jcfg = _cfgs({})
    sched = t_loader.batch_schedule(tcfg, 1)
    with pytest.raises(ValueError) as te:
        t_build.build_data_module(tcfg, sched)
    with pytest.raises(ValueError) as je:
        j_build.build_data_module(jcfg, sched)
    assert str(te.value) == str(je.value)
    tcfg, jcfg = _cfgs({"data_prefix": [0.5, "a", 0.5]})
    with pytest.raises(ValueError) as te:
        t_build.build_data_module(tcfg, sched)
    with pytest.raises(ValueError) as je:
        j_build.build_data_module(jcfg, sched)
    assert str(te.value) == str(je.value)
    assert t_build.build_data_module(_cfgs({"synthetic": True})[0], sched) == (None, None)


@pytest.mark.parametrize("strategy,module", [("orpo", "DPODataModule"),
                                             ({"dpo": {}}, "DPODataModule"),
                                             ("kto", "KTODataModule")])
def test_alignment_data_modules_match_jax(tmp_path, strategy, module):
    """The preference configs build the JAX package's module class, with its
    arrays bit for bit."""
    import json

    rng = np.random.default_rng(2)
    kto = module == "KTODataModule"
    recs = [{"prompt": f"p{i % 3}", "completion": "c" * int(rng.integers(1, 20)),
             "label": bool(i % 2)} if kto else
            {"prompt": f"p{i % 3}", "chosen": "c" * int(rng.integers(1, 20)),
             "rejected": "r" * int(rng.integers(1, 20))} for i in range(8)]
    path = tmp_path / "pref.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs))
    raw = {"data": {"global_batch_size": 4, "micro_batch_size": 2, "seq_length": 24,
                    "train_dir": str(path), "tokenizer": {"library": "char"}},
           "model_alignment_strategy": strategy}
    tc, jc = t_loader.load_config(raw), j_loader.load_config(raw)
    sched = t_loader.batch_schedule(tc, 1)
    (t, t_val), (j, j_val) = (t_build.build_data_module(tc, sched),
                              j_build.build_data_module(jc, sched))
    assert type(t).__name__ == type(j).__name__ == module and t_val is j_val is None
    assert t.arrays.keys() == j.arrays.keys()
    for k in j.arrays:
        np.testing.assert_array_equal(t.arrays[k], j.arrays[k])
        assert t.arrays[k].dtype == j.arrays[k].dtype


def test_hf_data_module_without_datasets_names_the_package(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="'datasets' package"):
        t_data.HFDataModule(str(tmp_path), 4)


def test_hf_data_module_from_dict_dataset_matches_jax():
    import datasets

    ds = datasets.Dataset.from_dict({"input_ids": [[i] * 8 for i in range(10)]})
    _assert_same_batches(t_data.HFDataModule(ds, 4), j_data.HFDataModule(ds, 4), 4)


# ---------------------------------------------------------------------------
# samplers (the JAX data tests' cases)
# ---------------------------------------------------------------------------


def _take(it, n):
    return [next(it) for _ in range(n)]


def test_sequential_sampler_wraps_and_resumes():
    s = t_sampler.PretrainingSampler(total_samples=10, global_batch_size=4)
    batches = _take(iter(s), 3)
    assert batches[0].tolist() == [0, 1, 2, 3]
    assert batches[2].tolist() == [8, 9, 0, 1]
    assert s.consumed_samples == 12
    s2 = t_sampler.PretrainingSampler(total_samples=10, global_batch_size=4, consumed_samples=8)
    assert next(iter(s2)).tolist() == batches[2].tolist()


def test_random_sampler_deterministic_and_resumable():
    a = _take(iter(t_sampler.RandomSampler(100, 8, seed=7)), 5)
    b = _take(iter(t_sampler.RandomSampler(100, 8, seed=7)), 5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    s = t_sampler.RandomSampler(100, 8, seed=7)
    _take(iter(s), 3)
    resumed = t_sampler.RandomSampler(100, 8, seed=7, consumed_samples=s.consumed_samples)
    np.testing.assert_array_equal(next(iter(resumed)), a[3])


def test_random_sampler_epoch_reshuffles():
    batches = _take(iter(t_sampler.RandomSampler(16, 8, seed=3)), 4)
    epoch0, epoch1 = np.concatenate(batches[:2]), np.concatenate(batches[2:])
    assert sorted(epoch0.tolist()) == list(range(16))
    assert sorted(epoch1.tolist()) == list(range(16))
    assert epoch0.tolist() != epoch1.tolist()


def test_dp_shard():
    batch = np.arange(8)
    assert t_sampler.dp_shard(batch, 0, 4).tolist() == [0, 1]
    assert t_sampler.dp_shard(batch, 3, 4).tolist() == [6, 7]
    with pytest.raises(ValueError):
        t_sampler.dp_shard(np.arange(6), 0, 4)


def test_consumed_samples_from_name():
    f = t_sampler.consumed_samples_from_name
    assert f("x-step=10-consumed_samples=128000.0.ckpt") == 128000
    assert f("step_5_consumed_samples=64") == 64
    assert f("nothing") is None


# ---------------------------------------------------------------------------
# prefetch iterator (the JAX data tests' cases)
# ---------------------------------------------------------------------------


def test_prefetch_order_preserved():
    assert list(t_data.PrefetchIterator(iter(range(50)), depth=4)) == list(range(50))


def test_prefetch_exception_propagates():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = t_data.PrefetchIterator(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetch_close_stops_producer():
    produced = []

    def gen():
        for i in itertools.count():
            produced.append(i)
            yield i

    it = t_data.PrefetchIterator(gen(), depth=2)
    next(it)
    it.close()
    time.sleep(0.3)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n


def test_prefetch_runs_ahead():
    produced = []

    def gen():
        for i in range(10):
            produced.append(i)
            yield i

    it = t_data.PrefetchIterator(gen(), depth=3)
    time.sleep(0.3)
    assert len(produced) >= 3
    assert list(it) == list(range(10))


def test_prefetch_close_with_full_queue_unblocks_producer():
    it = t_data.PrefetchIterator(iter(range(3)), depth=1)
    time.sleep(0.2)
    it.close()
    time.sleep(0.3)
    assert not it._thread.is_alive()
    list(it)


def test_prefetch_repeat_next_after_exhaustion_raises():
    it = t_data.PrefetchIterator(iter([1, 2]), depth=1)
    assert list(it) == [1, 2]
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(it)


def test_prefetch_next_after_exception_terminates():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = t_data.PrefetchIterator(gen(), depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


# ---------------------------------------------------------------------------
# transient-read retry and the data-stall watchdog (the JAX cases)
# ---------------------------------------------------------------------------


def test_transient_classifier_walks_cause_chain():
    inner = OSError(errno.ESTALE, "stale NFS handle")
    outer = RuntimeError("arrow read failed")
    outer.__cause__ = inner
    for f in (t_data.is_transient_io_error, j_data.is_transient_io_error):
        assert f(outer)
        assert f(TimeoutError("slow store"))
        assert not f(KeyError("bad column"))
        assert not f(OSError(errno.ENOENT, "gone"))


def _flaky(dm, n_fail, exc=None):
    real, fails = dm.fetch_rows, {"n": n_fail}

    def flaky(idx):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise exc or OSError(errno.EIO, "flaky mount")
        return real(idx)

    dm.fetch_rows = flaky


def test_fetch_retries_then_succeeds():
    dm = t_data.SyntheticDataModule(16, 8, 2, io_retry_backoff_seconds=0.01)
    _flaky(dm, 2)
    batch = next(dm.global_batches())
    assert isinstance(batch["input_ids"], np.ndarray)
    assert dm.io_retry_count == 2 and dm.last_io_activity() > 0


def test_non_transient_raises_immediately():
    dm = t_data.SyntheticDataModule(16, 8, 2)
    _flaky(dm, 1, KeyError("missing column"))
    with pytest.raises(KeyError):
        next(dm.global_batches())
    assert dm.io_retry_count == 0


def test_retries_exhausted_reraises_the_real_error():
    dm = t_data.SyntheticDataModule(16, 8, 2, io_retries=2, io_retry_backoff_seconds=0.01)
    _flaky(dm, 100, OSError(errno.EIO, "dead mount"))
    with pytest.raises(OSError, match="dead mount"):
        next(dm.global_batches())
    assert dm.io_retry_count == 2


def test_stall_deferred_while_retrying():
    activity = {"t": 0.0}
    release = threading.Event()

    def slow():
        release.wait(10.0)
        yield {"x": 1}

    it = t_data.PrefetchIterator(slow(), timeout_seconds=0.3, activity_fn=lambda: activity["t"])

    def keep_active():
        for _ in range(8):
            activity["t"] = time.monotonic()
            time.sleep(0.1)
        release.set()

    t = threading.Thread(target=keep_active)
    t.start()
    try:
        assert next(it) == {"x": 1}
    finally:
        t.join()
        it.close()


def test_stall_deferred_through_backoff_longer_than_timeout():
    dm = t_data.SyntheticDataModule(16, 8, 2, io_retries=1, io_retry_backoff_seconds=0.8)
    _flaky(dm, 1)
    it = t_data.PrefetchIterator(dm.global_batches(), timeout_seconds=0.3,
                                 activity_fn=dm.last_io_activity)
    try:
        assert next(it)["input_ids"].shape == (2, 8)
    finally:
        it.close()


def test_stall_fires_when_activity_goes_silent():
    def never():
        time.sleep(30)
        yield {}

    it = t_data.PrefetchIterator(never(), timeout_seconds=0.2, activity_fn=lambda: 0.0)
    with pytest.raises(t_data.DataStallError):
        next(it)
    it.close()


# ---------------------------------------------------------------------------
# batch token stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad_id", [None, 0])
def test_batch_token_stats_match_jax(pad_id):
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 50, (4, 12)).astype(np.int32)
    ids[1, 7:] = 0
    ids[3, :] = 0
    mask = (ids != 0).astype(np.float32)
    batch = {"input_ids": ids, "loss_mask": mask}
    assert t_data.batch_token_stats(batch, pad_id=pad_id) == \
        j_data.batch_token_stats(batch, pad_id=pad_id)
    t_acc, j_acc = t_data.BatchStats(pad_id=pad_id), j_data.BatchStats(pad_id=pad_id)
    for b in (batch, {"input_ids": ids[:2], "loss_mask": mask[:2]}):
        t_acc.update(b)
        j_acc.update(b)
    assert t_acc.drain() == j_acc.drain()
    assert t_acc.drain() == {}


def test_process_global_batch_matches_jax():
    ids = np.array([[1, 2, 0, 0], [3, 4, 5, 0]])
    labels = np.array([[1, 2, -100, -100], [3, 4, 5, -100]])
    for kw in ({}, {"pad_id": 0}):
        t = t_data.process_global_batch({"input_ids": ids, "labels": labels}, **kw)
        j = j_data.process_global_batch({"input_ids": ids, "labels": labels}, **kw)
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
