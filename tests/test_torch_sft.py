"""The port's SFT data path against the JAX package's.

- ``pack_sequences`` (through the C++ packer and through the numpy path),
  ``pad_sequences``, ``mask_prompt_labels`` and ``packed_segment_ids`` give
  the JAX functions' arrays exactly, overflow records dropped;
- templates, ``CharTokenizer`` and ``build_tokenizer`` behave as the JAX
  ones, with the same error texts; the HF tokenizer and its chat template
  are built in the test, with no files from outside;
- ``SFTDataModule`` batches, built directly and through
  ``build_data_module``, equal the JAX module's at two consumed-samples
  offsets, with packing on and off and with ``segment_mask``; the same
  inputs raise the same errors.

Every comparison is exact: the two pipelines are the same integer arithmetic.
"""

import json
import sys

import numpy as np
import pytest

from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.data import build as t_build
from neuronx_distributed_training_torch.data import modules as t_modules
from neuronx_distributed_training_torch.data import packing as t_packing
from neuronx_distributed_training_torch.data import templates as t_templates
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.data import build as j_build
from neuronx_distributed_training_tpu.data import modules as j_modules
from neuronx_distributed_training_tpu.data import packing as j_packing
from neuronx_distributed_training_tpu.data import templates as j_templates


def _token_lists(seed, n=40, lo=0, hi=30, vocab=500):
    rng = np.random.default_rng(seed)
    toks = [rng.integers(3, vocab, int(rng.integers(lo, hi))).tolist() for _ in range(n)]
    lbls = [[-100 if rng.random() < 0.3 else t for t in ts] for ts in toks]
    return toks, lbls


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# packing and padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("seed,chunk,labels", [(0, 32, True), (1, 32, False), (2, 17, True),
                                               (3, 64, True), (4, 8, False)])
def test_pack_sequences_matches_jax(monkeypatch, path, seed, chunk, labels):
    if path == "native":
        assert t_packing._load_native() is not None, "the C++ packer did not build"
    else:
        monkeypatch.setattr(t_packing, "_load_native", lambda: None)
    toks, lbls = _token_lists(seed)
    kw = dict(label_lists=lbls if labels else None, pad_id=7)
    t = t_packing.pack_sequences(toks, chunk, 2, **kw)
    j = j_packing.pack_sequences(toks, chunk, 2, **kw)
    _assert_same(t, j)
    # records longer than a chunk (with their eos) are dropped, the rest kept
    kept = sum(len(x) + 1 for x in toks if len(x) + 1 <= chunk)
    assert (t["labels"] != -100).sum() <= kept
    np.testing.assert_array_equal(t["loss_mask"], (t["labels"] != -100).astype(np.float32))
    seg = t_packing.packed_segment_ids(toks, chunk)
    np.testing.assert_array_equal(seg, j_packing.packed_segment_ids(toks, chunk))
    assert seg.shape == t["input_ids"].shape
    assert int((seg > 0).sum()) == kept  # every kept token (and eos) has a segment


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_pack_sequences_edge_cases_match_jax(monkeypatch, path):
    if path == "numpy":
        monkeypatch.setattr(t_packing, "_load_native", lambda: None)
    for toks in ([], [[5] * 40], [[5] * 3, [6] * 40, [7] * 4], [[1, 2, 3]] * 5):
        _assert_same(t_packing.pack_sequences(toks, 8, 2), j_packing.pack_sequences(toks, 8, 2))
        np.testing.assert_array_equal(t_packing.packed_segment_ids(toks, 8),
                                      j_packing.packed_segment_ids(toks, 8))


@pytest.mark.parametrize("left_pad,truncate", [(False, True), (True, True), (False, False)])
def test_pad_sequences_matches_jax(left_pad, truncate):
    toks, lbls = _token_lists(5, n=12, hi=20 if truncate else 16)
    kw = dict(label_lists=lbls, left_pad=left_pad, truncate=truncate)
    _assert_same(t_packing.pad_sequences(toks, 16, 0, **kw),
                 j_packing.pad_sequences(toks, 16, 0, **kw))
    _assert_same(t_packing.pad_sequences(toks, 16, 0), j_packing.pad_sequences(toks, 16, 0))
    with pytest.raises(ValueError, match="length 30 > max_length 16"):
        t_packing.pad_sequences([[1] * 30], 16, 0, truncate=False)


def test_mask_prompt_labels_matches_jax():
    assert t_packing.mask_prompt_labels([1, 5, 6], [7, 8]) == \
        j_packing.mask_prompt_labels([1, 5, 6], [7, 8]) == ([1, 5, 6, 7, 8],
                                                             [-100, -100, -100, 7, 8])
    assert t_packing.IGNORE_INDEX == j_packing.IGNORE_INDEX


def test_packer_builds_under_build_and_warns_without_a_compiler(monkeypatch, caplog):
    from neuronx_distributed_training_torch.data import _native

    assert t_packing._load_native() is not None
    lib = _native.library_path(t_packing._SRC)
    assert lib.exists() and lib.parent == _native.BUILD_DIR
    monkeypatch.setattr(t_packing, "_lib", None)
    monkeypatch.setattr(t_packing, "_lib_tried", False)
    monkeypatch.setattr(t_packing, "compile_and_load", lambda src: None)
    with caplog.at_level("WARNING"):
        assert t_packing._load_native() is None
    assert "numpy fallback" in caplog.text


# ---------------------------------------------------------------------------
# templates and tokenizers
# ---------------------------------------------------------------------------


def _hf_tokenizer():
    """A byte-level HF fast tokenizer with a chat template, built here."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2}
    for i, ch in enumerate(pre_tokenizers.ByteLevel.alphabet()):
        vocab[ch] = 3 + i
    tok = Tokenizer(models.WordPiece(vocab, unk_token="<pad>", max_input_chars_per_word=1000))
    tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.ByteLevel(add_prefix_space=False),
                                                 pre_tokenizers.Split("", "isolated")])
    tok.decoder = decoders.ByteLevel()
    hf = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                                 pad_token="<pad>")
    hf.chat_template = ("{% for m in messages %}<|{{ m['role'] }}|>{{ m['content'] }}\n"
                        "{% endfor %}{% if add_generation_prompt %}<|assistant|>{% endif %}")
    return hf


def test_format_and_missing_templates_match_jax():
    for cfg in ({"prompt_template": {"input": "Q: {question}\nA:", "output": " {answer}"}},
                {"prompt_template": "Q: {question} ({answer})"}):
        rec = {"question": "why", "answer": "because", "output": "kept"}
        assert t_templates.build_template(cfg)(rec) == j_templates.build_template(cfg)(rec)
    assert t_templates.build_template({}) is None and j_templates.build_template({}) is None
    for mod in (t_templates, j_templates):
        with pytest.raises(ImportError, match="optional promptsource"):
            mod.build_template({"dataset_name": "glue", "prompt_name": "p"})


def test_chat_template_over_an_hf_tokenizer_matches_jax():
    hf = _hf_tokenizer()
    rec = {"messages": [{"role": "system", "content": "be brief"},
                        {"role": "user", "content": "hi there"},
                        {"role": "assistant", "content": "hello"}]}
    t = t_templates.build_template({"chat_template": True}, hf)(rec)
    assert t == j_templates.build_template({"chat_template": True}, hf)(rec)
    assert t["input"].endswith("<|assistant|>") and t["output"] == "hello"
    for mod in (t_templates, j_templates):
        with pytest.raises(ValueError, match="must end with an assistant turn"):
            mod.ChatTemplate(hf)({"messages": [{"role": "user", "content": "x"}]})
        with pytest.raises(ValueError, match="HF tokenizer with a chat template"):
            mod.build_template({"chat_template": True}, t_build.CharTokenizer())


@pytest.mark.parametrize("vocab", [64, 512])
def test_char_tokenizer_matches_jax(vocab):
    text = "Hello, wörld! ☃ " + "".join(chr(c) for c in range(32, 127))
    cfg = {"tokenizer": {"library": "char", "vocab_size": vocab}}
    t, j = t_build.build_tokenizer(cfg), j_build.build_tokenizer(cfg)
    assert t.encode(text) == j.encode(text)
    assert (t.bos_token_id, t.eos_token_id, t.vocab_size) == \
        (j.bos_token_id, j.eos_token_id, j.vocab_size)


def test_build_tokenizer_hf_and_errors_match_jax(tmp_path, monkeypatch):
    _hf_tokenizer().save_pretrained(tmp_path / "tok")
    cfg = {"tokenizer": {"type": str(tmp_path / "tok")}}
    t, j = t_build.build_tokenizer(cfg), j_build.build_tokenizer(cfg)
    assert t.encode("the packed rows") == j.encode("the packed rows")
    assert t.eos_token_id == j.eos_token_id == 2
    for mod in (t_build, j_build):
        with pytest.raises(ValueError, match="data.tokenizer.type is required"):
            mod.build_tokenizer({})
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="'transformers' package"):
        t_build.build_tokenizer(cfg)
    assert t_build.build_tokenizer({"tokenizer": {"library": "char"}}).vocab_size == 512


# ---------------------------------------------------------------------------
# the SFT data module
# ---------------------------------------------------------------------------


def _records(seed, n=48):
    rng = np.random.default_rng(seed)

    def text(lo, hi):
        return "".join(chr(int(c)) for c in rng.integers(32, 127, int(rng.integers(lo, hi))))

    return [{"input": text(2, 30), "output": text(2, 40)} if i % 5 else
            {"prompt": text(2, 30), "completion": text(2, 40)} for i in range(n)]


def _batches(dm, n=2):
    it = dm.global_batches()
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("packing,segment_mask", [(True, False), (True, True), (False, False)])
@pytest.mark.parametrize("consumed", [0, 8])
def test_sft_module_batches_match_jax(packing, segment_mask, consumed):
    recs = _records(11)
    tok = t_build.CharTokenizer(128)
    kw = dict(packing=packing, segment_mask=segment_mask, seed=3, consumed_samples=consumed)
    t = t_modules.SFTDataModule(recs, tok, 128, 4, **kw)
    j = j_modules.SFTDataModule(recs, tok, 128, 4, **kw)
    _assert_same(t.arrays, j.arrays)
    assert t.input_names == j.input_names
    assert ("segment_ids" in t.input_names) == segment_mask
    for tb, jb in zip(_batches(t), _batches(j)):
        _assert_same(tb, jb)
    if segment_mask:
        assert "segment_ids" in tb and (tb["segment_ids"].max(axis=1) > 1).any()


def test_sft_module_template_and_errors_match_jax():
    recs = [{"question": f"q{i}", "answer": "a" * 8} for i in range(8)]
    tok = t_build.CharTokenizer(64)
    tm = t_templates.FormatTemplate("Q: {question}", "{answer}")
    jm = j_templates.FormatTemplate("Q: {question}", "{answer}")
    _assert_same(t_modules.SFTDataModule(recs, tok, 32, 4, packing=False, template=tm).arrays,
                 j_modules.SFTDataModule(recs, tok, 32, 4, packing=False, template=jm).arrays)
    for mod in (t_modules, j_modules):
        with pytest.raises(ValueError, match="segment_mask requires packing: true"):
            mod.SFTDataModule(recs, tok, 32, 4, packing=False, segment_mask=True)
        with pytest.raises(ValueError, match="SFT dataset too small: 1 packed rows"):
            mod.SFTDataModule(recs, tok, 512, 4)


def test_sft_module_layout_assertion(monkeypatch):
    monkeypatch.setattr(t_modules, "packed_segment_ids",
                        lambda ids, seq: np.zeros((1, seq), np.int32))
    with pytest.raises(AssertionError, match="layout drifted"):
        t_modules.SFTDataModule(_records(1), t_build.CharTokenizer(), 48, 4, segment_mask=True)


def test_load_alignment_records_matches_jax(tmp_path, monkeypatch):
    recs = _records(2, n=6)
    (tmp_path / "a.jsonl").write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    (tmp_path / "b.json").write_text(json.dumps(recs))
    (tmp_path / "c.json").write_text(json.dumps({"data": recs}))
    for name in ("a.jsonl", "b.json", "c.json"):
        assert t_modules.load_alignment_records(tmp_path / name) == \
            j_modules.load_alignment_records(tmp_path / name) == recs
    import datasets

    datasets.Dataset.from_list(recs[1:5]).save_to_disk(str(tmp_path / "arrow"))
    assert t_modules.load_alignment_records(tmp_path / "arrow") == \
        j_modules.load_alignment_records(tmp_path / "arrow") == recs[1:5]
    for mod in (t_modules, j_modules):
        with pytest.raises(ValueError, match="unsupported alignment data format"):
            mod.load_alignment_records(tmp_path / "x.csv")
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="'datasets' package"):
        t_modules.load_alignment_records(tmp_path / "arrow")


def _sft_cfg(tmp_path, **strategy):
    recs = _records(4, n=64)
    path = tmp_path / "train.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs))
    return {"trainer": {"max_steps": 3},
            "model_alignment_strategy": {"sft": {"packing": True, **strategy}},
            "data": {"global_batch_size": 4, "micro_batch_size": 2, "seq_length": 64,
                     "train_dir": str(path), "val_dir": str(path), "dev_choose_samples": 40,
                     "tokenizer": {"library": "char", "vocab_size": 96}}}


@pytest.mark.parametrize("strategy", [{}, {"segment_mask": True}, {"packing": False}])
def test_build_data_module_sft_matches_jax(tmp_path, strategy):
    cfg = _sft_cfg(tmp_path, **strategy)
    tc, jc = t_loader.load_config(cfg), j_loader.load_config(cfg)
    sched = t_loader.batch_schedule(tc, 1)
    t_train, t_val = t_build.build_data_module(tc, sched, seed=5)
    j_train, j_val = j_build.build_data_module(jc, sched, seed=5)
    assert isinstance(t_train, t_modules.SFTDataModule) and isinstance(t_val, type(t_train))
    assert not getattr(t_train, "labels_pre_shifted", False)
    for t, j in ((t_train, j_train), (t_val, j_val)):
        _assert_same(t.arrays, j.arrays)
        for tb, jb in zip(_batches(t, 3), _batches(j, 3)):
            _assert_same(tb, jb)
    # dev_choose_samples: the first 40 records only
    head = t_modules.SFTDataModule(_records(4, n=64)[:40], t_build.CharTokenizer(96), 64, 4,
                                   packing=strategy.get("packing", True),
                                   segment_mask=strategy.get("segment_mask", False))
    _assert_same(t_train.arrays, head.arrays)


def test_build_data_module_sft_errors_match_jax(tmp_path):
    for bad, match in (({"train_dir": None}, "SFT needs data.train_dir"),
                       ({"tokenizer": {}}, "data.tokenizer.type is required")):
        cfg = _sft_cfg(tmp_path)
        cfg["data"].update(bad)
        for ld, bd in ((t_loader, t_build), (j_loader, j_build)):
            c = ld.load_config(cfg)
            with pytest.raises(ValueError, match=match):
                bd.build_data_module(c, ld.batch_schedule(c, 1))
    # the same config under dpo builds the JAX package's DPO module and arrays
    cfg = _sft_cfg(tmp_path)
    cfg["model_alignment_strategy"] = {"dpo": {"max_prompt_length": 16}}
    pairs = [{"prompt": r.get("input", r.get("prompt")), "chosen": r.get("output", "c"),
              "rejected": r.get("completion", r.get("output", ""))[::-1]}
             for r in _records(4, n=16)]
    pref = tmp_path / "pref.jsonl"
    pref.write_text("\n".join(json.dumps(r) for r in pairs))
    cfg["data"].update(train_dir=str(pref), val_dir=None)
    tc, jc = t_loader.load_config(cfg), j_loader.load_config(cfg)
    t_dm = t_build.build_data_module(tc, t_loader.batch_schedule(tc, 1))[0]
    j_dm = j_build.build_data_module(jc, j_loader.batch_schedule(jc, 1))[0]
    assert type(t_dm).__name__ == type(j_dm).__name__ == "DPODataModule"
    _assert_same(t_dm.arrays, j_dm.arrays)


@pytest.mark.parametrize("bad,match", [
    ({"model_alignment_strategy": {"sft": {}, "dpo": {}}}, "exactly one of"),
    ({"model_alignment_strategy": {"ppo": {}}}, "names none of"),
    ({"model_alignment_strategy": "ppo"}, "unknown model_alignment_strategy"),
    ({"model": {"model_alignment_strategy": "sft"}}, "must sit at the config ROOT"),
    ({"model_alignment_strategy": {"sft": {"segment_mask": True}},
      "distributed_strategy": {"context_parallel_size": 2},
      "model": {"fusions": {"ring_attention": True}}}, "segment_mask: true"),
    ({"model_alignment_strategy": {"kto": {"kl_estimator": "mismatched"}},
      "distributed_strategy": {"pipeline_model_parallel_size": 2}}, "kl_estimator: mismatched"),
])
def test_alignment_config_checks_match_jax(bad, match):
    msgs = []
    for ld in (t_loader, j_loader):
        with pytest.raises(ValueError, match=match) as e:
            ld.load_config(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
