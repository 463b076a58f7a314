"""The port's HF converters and offline tools (``tools/convert.py``,
``tools/checkpoint_converter.py``, ``tools/ckpt_verify.py``,
``tools/prepare_dataset.py``) against the JAX package's and against
``transformers``, on the CPU.

- HF -> port -> HF is bit for bit for Llama (tied and untied) and Mixtral
  (``moe_frequency`` 1 and 2), and JAX's stacked trees (vp-interleaved,
  MoE-grouped) go to the same HF dicts;
- the port's converters equal ``params_from_jax`` of JAX's on the same
  numpy state dict, bit for bit, and their HF dicts equal JAX's;
- the port's logits equal ``transformers.LlamaForCausalLM`` /
  ``MixtralForCausalLM`` (built from a config after
  ``torch.manual_seed(0)``) at JAX's tolerance (``tests/test_convert.py``:
  atol 2e-4, rtol 1e-3);
- the converter CLI writes a port checkpoint that a ``weight_init_only``
  fit starts from bit for bit (against the same weights in memory), and
  ``native2hf`` gives the written dict back; ``nnm2native`` reads a
  sharded Megatron dir;
- ``prepare_dataset``'s ``.bin/.idx`` are byte-identical to the repo
  tool's; ``ckpt_verify`` passes a clean checkpoint and flags and
  quarantines a flipped byte with the repo tool's exit code and report
  keys.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.models import mixtral as t_mixtral
from neuronx_distributed_training_torch.ops import moe as t_moe
from neuronx_distributed_training_torch.tools import checkpoint_converter as t_cc
from neuronx_distributed_training_torch.tools import ckpt_verify as t_verify
from neuronx_distributed_training_torch.tools import convert as t_convert
from neuronx_distributed_training_torch.tools.convert import params_from_jax
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy as TPolicy
from neuronx_distributed_training_tpu.models import llama as j_llama
from neuronx_distributed_training_tpu.models import mixtral as j_mixtral
from neuronx_distributed_training_tpu.ops import moe as j_moe
from neuronx_distributed_training_tpu.parallel import pipeline as j_pipe
from neuronx_distributed_training_tpu.tools import convert as j_convert

REPO = Path(__file__).resolve().parents[1]
LC = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_layers=4,
          num_attention_heads=4, num_kv_heads=2, activations_checkpoint_granularity=None)
#: JAX's tolerance for logits against transformers (tests/test_convert.py)
ATOL, RTOL = 2e-4, 1e-3
FP32 = TPolicy.from_precision_config({"type": "fp32"})


def _llama_cfgs(tie=False):
    kw = {**LC, "tie_word_embeddings": tie}
    return j_llama.LlamaConfig(**kw), t_llama.LlamaConfig(**kw)


def _mixtral_cfgs(freq=1):
    j = j_mixtral.MixtralConfig(llama=j_llama.LlamaConfig(**LC),
                                moe=j_moe.MoEConfig(num_experts=4, top_k=2), moe_frequency=freq)
    t = t_mixtral.MixtralConfig(llama=t_llama.LlamaConfig(**LC),
                                moe=t_moe.MoEConfig(num_experts=4, top_k=2), moe_frequency=freq)
    return j, t


def _hf_llama(tie=False):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=LC["vocab_size"], hidden_size=LC["hidden_size"],
        intermediate_size=LC["intermediate_size"], num_hidden_layers=LC["num_layers"],
        num_attention_heads=LC["num_attention_heads"], num_key_value_heads=LC["num_kv_heads"],
        max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
        attention_bias=False, tie_word_embeddings=tie)).eval()


def _hf_mixtral():
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(0)
    return MixtralForCausalLM(MixtralConfig(
        vocab_size=LC["vocab_size"], hidden_size=LC["hidden_size"],
        intermediate_size=LC["intermediate_size"], num_hidden_layers=LC["num_layers"],
        num_attention_heads=LC["num_attention_heads"], num_key_value_heads=LC["num_kv_heads"],
        num_local_experts=4, num_experts_per_tok=2, max_position_embeddings=64,
        rope_theta=10000.0, rms_norm_eps=1e-5, sliding_window=None,
        tie_word_embeddings=False)).eval()


def _mixtral_state(freq, seed=3):
    """An HF-named Mixtral state dict (numpy fp32) with layer i MoE iff
    ``i % freq == 0`` and the others dense under the Llama names."""
    rng = np.random.default_rng(seed)
    h, f, v, e = LC["hidden_size"], LC["intermediate_size"], LC["vocab_size"], 4
    d = h // LC["num_attention_heads"]
    kv = LC["num_kv_heads"] * d
    w = lambda *s: rng.standard_normal(s).astype(np.float32)
    state = {"model.embed_tokens.weight": w(v, h), "model.norm.weight": w(h),
             "lm_head.weight": w(v, h)}
    for i in range(LC["num_layers"]):
        pre = f"model.layers.{i}."
        state.update({pre + "self_attn.q_proj.weight": w(h, h),
                      pre + "self_attn.k_proj.weight": w(kv, h),
                      pre + "self_attn.v_proj.weight": w(kv, h),
                      pre + "self_attn.o_proj.weight": w(h, h),
                      pre + "input_layernorm.weight": w(h),
                      pre + "post_attention_layernorm.weight": w(h)})
        if i % freq == 0:
            state[pre + "block_sparse_moe.gate.weight"] = w(e, h)
            for j in range(e):
                state.update({pre + f"block_sparse_moe.experts.{j}.w1.weight": w(f, h),
                              pre + f"block_sparse_moe.experts.{j}.w3.weight": w(f, h),
                              pre + f"block_sparse_moe.experts.{j}.w2.weight": w(h, f)})
        else:
            state.update({pre + "mlp.gate_proj.weight": w(f, h), pre + "mlp.up_proj.weight": w(f, h),
                          pre + "mlp.down_proj.weight": w(h, f)})
    return state


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}.{i}")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


def _assert_hf_equal(a: dict, b: dict):
    assert set(a) == set(b), set(a) ^ set(b)
    bad = [k for k in a if not torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))]
    assert not bad, bad


# -- Llama ---------------------------------------------------------------------


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_llama_hf_round_trip_is_bitwise_and_equals_jax(tie):
    jcfg, tcfg = _llama_cfgs(tie)
    hf = {k: v.detach().clone() for k, v in _hf_llama(tie).state_dict().items()}
    if tie:
        hf.pop("lm_head.weight")  # a tied checkpoint has no head tensor
    port = t_convert.hf_llama_to_native(hf, tcfg, device="cpu")
    np_state = {k: v.numpy() for k, v in hf.items()}
    _assert_trees_equal(port, params_from_jax(j_convert.hf_llama_to_native(np_state, jcfg),
                                              device="cpu"))
    back = t_convert.native_to_hf_llama(port, tcfg)
    _assert_hf_equal(back, hf)
    _assert_hf_equal(back, j_convert.native_to_hf_llama(
        j_convert.hf_llama_to_native(np_state, jcfg), jcfg))


def test_llama_vp_interleaved_tree_to_hf():
    """JAX's stacked tree at pp 2 x vp 2 ([vp, pp, Lc, ...]) goes to the same
    HF dict, with the layout named and by the shape rule."""
    jcfg, tcfg = _llama_cfgs()
    hf = {k: v.detach().clone() for k, v in _hf_llama().state_dict().items()}
    jtree = j_convert.hf_llama_to_native({k: v.numpy() for k, v in hf.items()}, jcfg)
    inter = {**jtree, "layers": jax.tree_util.tree_map(
        np.asarray, j_pipe.to_interleaved(jtree["layers"], 2, 2))}
    assert inter["layers"]["attn"]["qkv"]["w"].shape[:3] == (2, 2, 1)
    for layout in ("interleaved", None):
        _assert_hf_equal(t_convert.native_to_hf_llama(inter, tcfg, layer_layout=layout), hf)
    with pytest.raises(ValueError, match="unknown layer layout"):
        t_convert.native_to_hf_llama(inter, tcfg, layer_layout="zigzag")


def test_llama_logits_match_transformers():
    _, tcfg = _llama_cfgs()
    model = _hf_llama()
    params = t_convert.hf_llama_to_native(model.state_dict(), tcfg, device="cpu")
    ids = torch.arange(16, dtype=torch.int64)[None, :] % tcfg.vocab_size
    with torch.no_grad():
        ref = model(ids).logits
        ours, _ = t_llama.forward(params, {"input_ids": ids}, tcfg, FP32)
    torch.testing.assert_close(ours.float(), ref, atol=ATOL, rtol=RTOL)


# -- Mixtral -------------------------------------------------------------------


@pytest.mark.parametrize("freq", [1, 2])
def test_mixtral_hf_round_trip_is_bitwise_and_equals_jax(freq):
    jcfg, tcfg = _mixtral_cfgs(freq)
    np_state = _mixtral_state(freq)
    state = {k: torch.from_numpy(v) for k, v in np_state.items()}
    port = t_convert.hf_mixtral_to_native(state, tcfg, device="cpu")
    jtree = j_convert.hf_mixtral_to_native(np_state, jcfg)
    _assert_trees_equal(port, params_from_jax(jtree, device="cpu"))
    _assert_hf_equal(t_convert.native_to_hf_mixtral(port, tcfg), state)
    _assert_hf_equal(t_convert.native_to_hf_mixtral(port, tcfg),
                     j_convert.native_to_hf_mixtral(jtree, jcfg))
    # JAX's stacked tree (grouped at freq 2), flat and vp-interleaved
    _assert_hf_equal(t_convert.native_to_hf_mixtral(jtree, tcfg), state)
    inter = {**jtree, "layers": jax.tree_util.tree_map(
        np.asarray, j_pipe.to_interleaved(jtree["layers"], 2, 2 // freq if freq > 1 else 2))}
    _assert_hf_equal(t_convert.native_to_hf_mixtral(inter, tcfg, layer_layout="interleaved"),
                     state)


def test_mixtral_logits_match_transformers():
    _, tcfg = _mixtral_cfgs()
    model = _hf_mixtral()
    params = t_convert.hf_mixtral_to_native(model.state_dict(), tcfg, device="cpu")
    ids = torch.arange(16, dtype=torch.int64)[None, :] % LC["vocab_size"]
    with torch.no_grad():
        ref = model(ids).logits
        ours, _ = t_mixtral.forward(params, {"input_ids": ids}, tcfg, FP32)
    torch.testing.assert_close(ours.float(), ref, atol=ATOL, rtol=RTOL)


# -- loading HF files --------------------------------------------------------


def test_load_torch_state_dict_reads_bin_and_names_a_missing_safetensors(tmp_path,
                                                                        monkeypatch):
    sd = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4, dtype=torch.bfloat16)}
    torch.save(sd, tmp_path / "pytorch_model.bin")
    got = t_convert.load_torch_state_dict(tmp_path)
    assert set(got) == {"a", "b"} and all(torch.equal(got[k], sd[k]) for k in sd)
    assert got["b"].dtype == torch.bfloat16  # the dtype is kept
    st = tmp_path / "st"
    st.mkdir()
    (st / "model.safetensors").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match=r"model\.safetensors.*safetensors package"):
        t_convert.load_torch_state_dict(st)
    with pytest.raises(FileNotFoundError):
        t_convert.load_torch_state_dict(tmp_path / "st" / "nothing")


def test_load_torch_state_dict_reads_safetensors_where_installed(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    sd = {"w": torch.randn(3, 2, generator=torch.Generator().manual_seed(0))}
    st.save_file(sd, str(tmp_path / "model.safetensors"))
    assert torch.equal(t_convert.load_torch_state_dict(tmp_path)["w"], sd["w"])


# -- the converter CLI and the warm start --------------------------------------


def _tiny_cfg(tmp_path, exp, **model):
    cfg = yaml.safe_load((REPO / "examples" / "conf" / "tiny_smoke_config.yaml").read_text())
    cfg["model"].update(hidden_size=32, intermediate_size=64, num_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, vocab_size=96, **model)
    cfg["trainer"].update(max_steps=3, log_every_n_steps=1)
    cfg["exp_manager"].update(exp_dir=str(tmp_path / exp), create_tensorboard_logger=False,
                              telemetry={"compile_census": False})
    cfg["exp_manager"]["checkpoint_callback_params"]["every_n_train_steps"] = 0
    cfg["distributed_strategy"].pop("overlap", None)
    return cfg


def _convert(*args, capsys=None) -> str:
    """The converter CLI's ``main`` in this process (what ``python -m ...``
    runs; the Megatron test runs it as a subprocess): its stdout."""
    t_cc.main([*map(str, args), "--device", "cpu"])
    return capsys.readouterr().out if capsys is not None else ""


def _convert_subprocess(*args) -> str:
    out = subprocess.run([sys.executable, "-m",
                          "neuronx_distributed_training_torch.tools.checkpoint_converter",
                          *map(str, args), "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    return out.stdout


@pytest.mark.parametrize("lora", [None, {"lora_rank": 4, "lora_alpha": 8}],
                         ids=["full", "lora"])
def test_converter_cli_checkpoint_warm_starts_bitwise(tmp_path, lora, capsys):
    """A LoRA run warm-starts from the base weights alone: its adapters are
    not in the converted checkpoint and keep their init (drawn from the
    seed, the same in both runs)."""
    extra = {} if lora is None else {"lora": lora}
    cfg = _tiny_cfg(tmp_path, "src")
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg))
    mc = t_llama.LlamaConfig.from_config(cfg["model"], cfg["distributed_strategy"])
    gen = torch.Generator().manual_seed(5)
    weights = t_llama.init_params(mc, FP32, generator=gen, device="cpu")
    with torch.no_grad():  # not the trainer's own draw
        for t in t_llama.named_params(weights).values():
            t.add_(0.01 * torch.randn(t.shape, generator=gen))
    hf = t_convert.native_to_hf_llama(weights, mc)
    (tmp_path / "hf").mkdir()
    torch.save(hf, tmp_path / "hf" / "pytorch_model.bin")
    assert "wrote native checkpoint" in _convert(
        "--direction", "hf2native", "--config", tmp_path / "c.yaml", "--input", tmp_path / "hf",
        "--output", tmp_path / "native", capsys=capsys)
    assert t_verify.verify_dir(tmp_path / "native")["ok"]
    # native2hf gives the written dict back, bit for bit
    _convert("--direction", "native2hf", "--config", tmp_path / "c.yaml",
             "--input", tmp_path / "native", "--output", tmp_path / "back")
    _assert_hf_equal(torch.load(tmp_path / "back" / "pytorch_model.bin"), hf)
    # the warm start from it against the same weights handed over in memory
    warm = t_loop.Trainer.from_config(t_loader.load_config(
        _tiny_cfg(tmp_path, "warm", weight_init_only=True, **extra),
        {"exp_manager.resume_from_checkpoint": str(tmp_path / "native")}), device="cpu")
    mem = t_loop.Trainer.from_config(t_loader.load_config(_tiny_cfg(tmp_path, "mem", **extra)),
                                     device="cpu")
    base = {n: t for n, t in t_llama.named_params(warm.params).items() if ".lora_" not in n}
    assert all(torch.equal(t, t_llama.named_params(weights)[n]) for n, t in base.items())
    assert len(base) == len(t_llama.named_params(weights))
    with torch.no_grad():
        for n, t in t_llama.named_params(mem.params).items():
            if n in base:
                t.copy_(t_llama.named_params(weights)[n])
        for n, t in mem.opt_state.get("master", {}).items():
            if n in base:
                t.copy_(t_llama.named_params(weights)[n])
    hw, hm = warm.fit(), mem.fit()
    assert [(h["loss"], h["grad_norm"]) for h in hw] == [(h["loss"], h["grad_norm"]) for h in hm]
    _assert_trees_equal(warm.params, mem.params)


def test_converter_cli_reads_a_sharded_megatron_dir(tmp_path):
    """nnm2native of a tp 2 Megatron dir (``mp_rank_XX``) equals the port's
    ``megatron_gpt_to_native`` of the whole state dict, and native2nnm
    writes that state dict back."""
    from neuronx_distributed_training_torch.models import gpt as t_gpt
    from neuronx_distributed_training_torch.tools import convert_megatron as t_meg

    cfg = yaml.safe_load((REPO / "examples" / "conf" / "megatron_gpt_config.yaml").read_text())
    # gelu: a glu up-projection's shards would hold [gate; up] halves each
    cfg["model"].update(num_layers=2, hidden_size=32, ffn_hidden_size=64, num_attention_heads=4,
                        num_query_groups=2, vocab_size=64, activation="gelu")
    (tmp_path / "g.yaml").write_text(yaml.safe_dump(cfg))
    mc = t_gpt.GPTConfig.from_config(cfg["model"], cfg["distributed_strategy"])
    params = t_gpt.init_params(mc, FP32, generator=torch.Generator().manual_seed(2),
                               device="cpu")
    full = t_meg.native_to_megatron_gpt(params, mc)
    for r in range(2):
        shard = {}
        for k, v in full.items():
            ax = t_meg._tp_axis_for(k)
            shard[k] = v if ax is None else torch.chunk(v, 2, dim=ax)[r].clone()
        (tmp_path / "nnm" / f"mp_rank_{r:02d}").mkdir(parents=True)
        torch.save({"state_dict": shard}, tmp_path / "nnm" / f"mp_rank_{r:02d}" /
                   "model_optim_rng.ckpt")
    assert "wrote native checkpoint" in _convert_subprocess(
        "--model", "gpt", "--direction", "nnm2native", "--config", tmp_path / "g.yaml",
        "--input", tmp_path / "nnm", "--output", tmp_path / "native", "--tp", 2)
    got = t_cc.load_native(tmp_path / "native", mc, device="cpu")
    _assert_trees_equal(got, t_meg.megatron_gpt_to_native(full, mc, device="cpu"))
    _convert("--model", "gpt", "--direction", "native2nnm", "--config", tmp_path / "g.yaml",
             "--input", tmp_path / "native", "--output", tmp_path / "nnm_back")
    back = torch.load(tmp_path / "nnm_back" / "model_optim_rng.ckpt")
    _assert_hf_equal(back, {k: v.contiguous() for k, v in full.items()})


# -- prepare_dataset and ckpt_verify -------------------------------------------


def test_prepare_dataset_megatron_files_are_byte_identical_to_the_repo_tool(tmp_path):
    docs = [{"text": t} for t in ("hello world", "", "a longer document, with ünïcode",
                                  "x" * 300, "last")]
    src = tmp_path / "c.jsonl"
    src.write_text("\n".join(json.dumps(d) for d in docs) + "\n")
    for tool, out in ((["tools/prepare_dataset.py"], "repo"),
                      (["-m", "neuronx_distributed_training_torch.tools.prepare_dataset"],
                       "port")):
        run = subprocess.run([sys.executable, *tool, "--input", str(src), "--tokenizer", "char",
                              "--format", "megatron", "--output", str(tmp_path / out)],
                             cwd=REPO, capture_output=True, text=True, timeout=300,
                             env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
        assert run.returncode == 0, run.stderr[-2000:]
    for ext in (".bin", ".idx"):
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"repo{ext}").read_bytes()
    from neuronx_distributed_training_torch.tools.prepare_dataset import iter_docs

    (tmp_path / "c.txt").write_text("one\n\ntwo\n")
    assert list(iter_docs(tmp_path / "c.txt", "text")) == ["one", "two"]


def test_ckpt_verify_passes_clean_and_quarantines_a_flipped_byte(tmp_path, capsys):
    cfg = _tiny_cfg(tmp_path, "run")
    cfg["exp_manager"]["checkpoint_callback_params"]["every_n_train_steps"] = 1
    cfg["trainer"]["max_steps"] = 2
    t = t_loop.Trainer.from_config(t_loader.load_config(cfg), device="cpu")
    t.fit()
    run = Path(t.exp.log_dir)
    assert t_verify.main([str(run), "--json", "-"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] and [s["step"] for s in report["steps"]] == [1, 2]
    assert set(report) == {"ok", "checkpoint_dir", "steps", "corrupt_steps", "legacy_steps",
                           "quarantined", "ledger_entries"}
    # a flipped byte in the middle of the largest leaf's entry (its tensor
    # bytes, not the entry's zip headers)
    import torch.distributed.checkpoint as dcp

    item = run / "checkpoints" / "2" / "params"
    entry = max(dcp.FileSystemReader(str(item)).read_metadata().storage_data.values(),
                key=lambda e: e.length)
    f = item / entry.relative_path
    raw = bytearray(f.read_bytes())
    raw[entry.offset + entry.length // 2] ^= 0xFF
    f.write_bytes(bytes(raw))
    assert t_verify.main([str(run)]) == 1  # report only: nothing moved
    assert (run / "checkpoints" / "2").is_dir()
    assert t_verify.main([str(run.parent), "--quarantine", "--json",
                          str(tmp_path / "r.json")]) == 1
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["corrupt_steps"] == [2] and report["quarantined"] == [2]
    assert report["ledger_entries"] == 1 and not (run / "checkpoints" / "2").exists()
    assert t_verify.main([str(run), "--step", "1"]) == 0
    assert t_verify.main([str(tmp_path / "nowhere")]) == 1
