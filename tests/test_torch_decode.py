"""KV-cached decode, generation, sampling and the SFT evaluation in the port
against the JAX package, on the CPU (``models/decode.py``,
``models/generate.py``, ``tools/evaluate.py``, ``tools/run_sft_evaluation.py``,
``tools/bench_decode.py`` and the ``attend`` hook of the Llama, Mixtral
and GPT layers).

Models: tiny (hidden 32, 4 heads over 2 kv groups, head_dim 8, 2 layers, 4
at ``moe_frequency`` 2, vocab 97), weights drawn by the JAX package's
``init_params`` with every norm scale, every bias and every LoRA ``B``
perturbed by seeded noise (none is trivially one or zero), carried to the
port by ``tools/convert.py::params_from_jax``; prompts ragged and
right-padded.  The flash route runs at head_dim 64 and prompt 64 (JAX's
Pallas kernel in interpret mode, the port's wrapper on its plain version).

Tolerances (fp32 unless said):
- prefill's hidden states and cache, and ``decode_step``'s logits and
  cache: atol 1e-5 (fp32 sums in other orders; measured at most ~1e-6);
  the flash route's prefill atol 1e-5;
- greedy tokens: exact, against JAX's ``generate_cached`` and the port's
  uncached ``generate``;
- ``mixed_precision``: the decode logits within 3e-2 of their largest
  magnitude, the port's Llama tests' bar for bf16 activations rounded at
  other points (``tests/test_torch_llama.py``);
- ``filter_logits``: the same kept set as JAX's; with top-p a token may
  differ only where its cumulative mass ties ``top_p`` to within 1e-6
  (fp32 cumulative sums in another order), and the test says where;
- sampling cannot equal JAX's bits (threefry): held on its properties
  instead (every token in the kept set, a seed repeats its tokens, and a
  chi-square test of 20000 draws against the filtered softmax at p 1e-3);
- metrics: equal to JAX's.
"""

import dataclasses
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.models import decode as t_decode
from neuronx_distributed_training_torch.models import generate as t_gen
from neuronx_distributed_training_torch.models import gpt as t_gpt
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.models import mixtral as t_mixtral
from neuronx_distributed_training_torch.ops import flash_attention as t_fa
from neuronx_distributed_training_torch.ops import moe as t_moe
from neuronx_distributed_training_torch.tools import bench_decode as t_bench
from neuronx_distributed_training_torch.tools import evaluate as t_eval
from neuronx_distributed_training_torch.tools import run_sft_evaluation as t_cli
from neuronx_distributed_training_torch.tools.convert import params_from_jax
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy as TPolicy
from neuronx_distributed_training_tpu.models import decode as j_decode
from neuronx_distributed_training_tpu.models import generate as j_gen
from neuronx_distributed_training_tpu.models import gpt as j_gpt
from neuronx_distributed_training_tpu.models import llama as j_llama
from neuronx_distributed_training_tpu.models import mixtral as j_mixtral
from neuronx_distributed_training_tpu.ops import moe as j_moe
from neuronx_distributed_training_tpu.peft import lora as j_lora
from neuronx_distributed_training_tpu.tools import evaluate as j_eval
from neuronx_distributed_training_tpu.utils.dtypes import DtypePolicy as JPolicy

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
MIXED_REL = 3e-2
EOS, NEW = 96, 8
PROMPTS = [[5, 6, 7, 8, 9], [10, 11, 12]]
LLAMA = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_layers=2,
             num_attention_heads=4, num_kv_heads=2, activations_checkpoint_granularity=None)
GPT = dict(vocab_size=97, hidden_size=32, ffn_hidden_size=64, num_layers=2,
           num_attention_heads=4, num_query_groups=2, max_position_embeddings=64,
           activations_checkpoint_granularity=None)
MOE = dict(num_experts=4, top_k=2, dropless=True)
LORA = {"lora_rank": 4, "lora_alpha": 16,
        "target_modules": ["qkv_proj", "o_proj", "gate_up_proj", "down_proj"]}


def _llama(**kw):
    c = {**LLAMA, **kw}
    return j_llama.LlamaConfig(**c), t_llama.LlamaConfig(**c)


def _mixtral(freq):
    c = {**LLAMA, "num_layers": 2 * freq}
    jm = j_moe.MoEConfig(**MOE)
    return (j_mixtral.MixtralConfig(llama=j_llama.LlamaConfig(**c), moe=jm, moe_frequency=freq),
            t_mixtral.MixtralConfig(llama=t_llama.LlamaConfig(**c),
                                    moe=t_moe.MoEConfig(**dataclasses.asdict(jm)),
                                    moe_frequency=freq))


def _gpt(moe_freq=None, **kw):
    c = {**GPT, **kw}
    jm = tm = None
    if moe_freq is not None:
        c.update(num_layers=2 * moe_freq, moe_frequency=moe_freq)
        jm = j_moe.MoEConfig(**MOE)
        tm = t_moe.MoEConfig(**dataclasses.asdict(jm))
    return j_gpt.GPTConfig(**c, moe=jm), t_gpt.GPTConfig(**c, moe=tm)


#: name -> (JAX config, port config, LoRA on the JAX init)
FAMILIES = {
    "llama": (*_llama(), False),
    "mistral_window": (*_llama(sliding_window=4), False),
    "llama_lora": (*_llama(), True),
    "mixtral_f1": (*_mixtral(1), False),
    "mixtral_f2": (*_mixtral(2), False),
    "gpt_learned": (*_gpt(), False),
    "gpt_rope": (*_gpt(position_embedding_type="rope", normalization="rmsnorm"), False),
    "gpt_partial_rotary": (*_gpt(position_embedding_type="rope", rotary_percentage=0.5),
                           False),
    "gpt_post_ln": (*_gpt(transformer_block_type="post_ln"), False),
    "gpt_normformer": (*_gpt(transformer_block_type="normformer", activation="swiglu"),
                       False),
    "gpt_j": (*_gpt(transformer_block_type="gpt_j", share_embeddings_and_output_weights=False),
              False),
    "gpt_moe_f1": (*_gpt(moe_freq=1, position_embedding_type="rope"), False),
    "gpt_moe_f2": (*_gpt(moe_freq=2), False),
}


def _policies(precision="fp32"):
    return (JPolicy.from_precision_config({"type": precision}),
            TPolicy.from_precision_config({"type": precision}))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(jc, lora: bool, seed=0):
    """JAX's init (and LoRA adapters), every norm scale, bias and LoRA B
    perturbed, as numpy."""
    init = (j_mixtral.init_params if isinstance(jc, j_mixtral.MixtralConfig) else
            j_gpt.init_params if isinstance(jc, j_gpt.GPTConfig) else j_llama.init_params)
    params = init(jax.random.PRNGKey(seed), jc, _policies()[0])
    if lora:
        params = j_lora.add_lora(params, j_lora.LoraConfig.from_config(LORA),
                                 jax.random.PRNGKey(seed + 1))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        a = np.array(a)
        last = str(path[-1])
        if any(k in last for k in ("scale", "bias", "lora_b")):
            a = a + rng.normal(0, 0.1 if "lora_b" not in last else 0.05, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def _port_logits_of(tc, policy):
    fwd = (t_mixtral.forward if isinstance(tc, t_mixtral.MixtralConfig) else
           t_gpt.forward if isinstance(tc, t_gpt.GPTConfig) else t_llama.forward)
    return lambda p, ids: fwd(p, {"input_ids": ids}, tc, policy)[0]


def _step_inputs():
    """Ragged prompts, their lengths, and one decode step's tokens and
    positions (numpy)."""
    ids, lens = (np.array(a) for a in j_gen.pad_prompts(PROMPTS))
    return ids, lens, np.asarray([11, 23], np.int32), lens.copy()


#: the JAX side of each family, built once a process
_JAX: dict = {}


def _jax_side(name):
    if name not in _JAX:
        jc, _, lora = FAMILIES[name]
        jp = _policies()[0]
        params = _init(jc, lora)
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        prefill_fn, decode_fn, _ = j_decode._family(jc)

        @jax.jit
        def run(p, ids, lens, tok, pos):  # one compile a family
            h, cache = prefill_fn(p, ids, jc, jp, max_len=ids.shape[1] + 4)
            logits, cache2 = decode_fn(p, cache, tok, pos, jc, jp)
            greedy = j_decode.generate_cached(p, jc, jp, ids, lens, max_new_tokens=NEW,
                                              eos_id=EOS)
            return dict(h=h, cache=cache, logits=logits, cache2=cache2, greedy=greedy)

        _JAX[name] = dict(_np(run(jparams, *map(jnp.asarray, _step_inputs()))), params=params)
    return _JAX[name]


def _port(name):
    _, tc, _ = FAMILIES[name]
    return tc, params_from_jax(_jax_side(name)["params"], device="cpu")


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_prefill_and_decode_step_match_jax(name):
    """Prefill's final-normed hidden states and its cache (rotated keys, the
    zero tail), then one decode step's logits and the cache it wrote."""
    j = _jax_side(name)
    tc, params = _port(name)
    policy = _policies()[1]
    ids, _, tok, pos = _step_inputs()
    h, cache = t_decode.prefill(params, torch.from_numpy(ids), tc, policy,
                          max_len=ids.shape[1] + 4)
    _close(h, j["h"], what="hidden")
    for kv in "kv":
        assert tuple(cache[kv].shape) == j["cache"][kv].shape
        _close(cache[kv], j["cache"][kv], what=f"prefill cache {kv}")
        assert not cache[kv][:, :, ids.shape[1]:].any()
    logits, cache = t_decode.decode_step(params, cache, torch.as_tensor(tok), torch.as_tensor(pos).long(),
                              tc, policy)
    _close(logits, j["logits"], what="decode logits")
    for kv in "kv":
        _close(cache[kv], j["cache2"][kv], what=f"decode cache {kv}")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_greedy_tokens_equal_jax_and_the_uncached_path(name):
    j = _jax_side(name)
    tc, params = _port(name)
    policy = _policies()[1]
    ids, lens = t_gen.pad_prompts(PROMPTS)
    cached = t_decode.generate_cached(params, tc, policy, ids, lens, max_new_tokens=NEW,
                                      eos_id=EOS)
    np.testing.assert_array_equal(cached.numpy(), j["greedy"])
    uncached = t_gen.generate(params, ids, lens, _port_logits_of(tc, policy),
                              max_new_tokens=NEW, eos_id=EOS)
    np.testing.assert_array_equal(uncached.numpy(), j["greedy"])


def test_rope_rotates_the_cached_keys():
    """The cache holds the rotated keys (the KV-cache contract): with RoPE
    positions shifted the cached keys change, the values do not; partial
    rotary leaves the last dims of each key as projected."""
    tc, params = _port("gpt_partial_rotary")
    ids = torch.as_tensor(np.asarray(j_gen.pad_prompts(PROMPTS)[0]))
    _, cache = t_decode.prefill_gpt(params, ids, tc, _policies()[1])
    rot = int(tc.head_size * tc.rotary_percentage) // 2 * 2
    cos, sin = t_gpt._rope_for(tc, torch.zeros_like(ids))  # every position 0
    x = t_gpt.embed(params, ids, torch.zeros_like(ids), tc, _policies()[1])
    seen = []

    def attend(q, k, v, attention):
        seen.append((k, v))
        return attention(q, k, v)

    t_gpt._decoder_layer(params["layers"][0], x, cos, sin, tc, _policies()[1], attend=attend)
    (k0, v0), = seen
    s = ids.shape[1]
    assert torch.equal(cache["v"][0, :, :s], v0)
    assert torch.equal(cache["k"][0, :, 0, :, :], k0[:, 0])  # position 0 rotates by 0
    assert not torch.allclose(cache["k"][0, :, 1:s, :, :rot], k0[:, 1:, :, :rot])
    assert torch.equal(cache["k"][0, :, :s, :, rot:], k0[..., rot:])


@pytest.mark.parametrize("prompt_len", [64, 60])
def test_prefill_on_the_flash_route_matches_jax(prompt_len):
    """The flash route (head_dim 64): prompts that tile take the kernel's
    wrapper once a layer, with no fallback; a length that does not tile
    falls back to core attention, counted, once a layer (JAX the same)."""
    c = dict(LLAMA, hidden_size=128, num_attention_heads=2, num_kv_heads=1)
    jc = j_llama.LlamaConfig(**c, attention_impl="flash", flash_block_q=64, flash_block_kv=64)
    tc = t_llama.LlamaConfig(**c, attention_impl="flash")
    params = _init(jc, False, seed=3)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 97, (2, prompt_len)).astype(np.int32)
    jp, tp = _policies()
    h, cache = jax.jit(lambda p, i: j_decode.prefill(p, i, jc, jp, max_len=prompt_len + 8))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids))
    t_fa.reset_counters()
    th, tcache = t_decode.prefill(params_from_jax(params, device="cpu"), torch.as_tensor(ids),
                                  tc, tp, max_len=prompt_len + 8)
    assert t_fa.FALLBACKS["core"] == (0 if prompt_len % 64 == 0 else 2)
    _close(th, h, what="hidden")
    for kv in "kv":
        _close(tcache[kv], cache[kv], what=kv)


def test_ragged_batch_equals_each_row_alone():
    tc, params = _port("llama")
    policy = _policies()[1]
    short, long = [5, 6], [9, 10, 11, 12, 13, 14]
    ids, lens = t_gen.pad_prompts([short, long])
    both = t_decode.generate_cached(params, tc, policy, ids, lens, max_new_tokens=5, eos_id=EOS)
    for row, p in enumerate([short, long]):
        i, n = t_gen.pad_prompts([p])
        alone = t_decode.generate_cached(params, tc, policy, i, n, max_new_tokens=5, eos_id=EOS)
        np.testing.assert_array_equal(both[row, :len(p) + 5].numpy(), alone[0].numpy())


def test_eos_is_kept_and_followed_by_padding():
    """A row writes its EOS and then ``pad_id`` to the end; the other row
    keeps generating.  The EOS is a token greedy decoding writes at the
    third new position of row 0."""
    tc, params = _port("llama")
    policy = _policies()[1]
    ids, lens = t_gen.pad_prompts(PROMPTS)
    free = t_decode.generate_cached(params, tc, policy, ids, lens, max_new_tokens=NEW,
                                    eos_id=EOS).numpy()
    eos = int(free[0, 5 + 2])
    out = t_decode.generate_cached(params, tc, policy, ids, lens, max_new_tokens=NEW,
                                   eos_id=eos, pad_id=1).numpy()
    first = 5 + list(free[0, 5:]).index(eos)
    np.testing.assert_array_equal(out[0, :first + 1], free[0, :first + 1])
    assert (out[0, first + 1:] == 1).all()
    jout = j_decode.generate_cached(jax.tree_util.tree_map(jnp.asarray, _jax_side("llama")[
        "params"]), FAMILIES["llama"][0], _policies()[0], *j_gen.pad_prompts(PROMPTS),
        max_new_tokens=NEW, eos_id=eos, pad_id=1)
    np.testing.assert_array_equal(out, np.asarray(jout))


def test_zero_new_tokens_is_a_noop():
    tc, params = _port("llama")
    ids, lens = t_gen.pad_prompts(PROMPTS)
    out = t_decode.generate_cached(params, tc, _policies()[1], ids, lens, max_new_tokens=0,
                                   eos_id=EOS)
    np.testing.assert_array_equal(out.numpy(), ids.numpy())


def test_mixed_precision_decode_logits_within_the_llama_bar():
    jc, tc, _ = FAMILIES["llama"]
    jp, tp = _policies("mixed_precision")
    params = _init(jc, False)
    ids, _, tok, pos = _step_inputs()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    _, cache = j_decode.prefill(jparams, ids, jc, jp, max_len=ids.shape[1] + 4)
    want, _ = j_decode.decode_step(jparams, cache, jnp.asarray(tok), jnp.asarray(pos), jc, jp)
    tparams = params_from_jax(params, device="cpu")
    _, tcache = t_decode.prefill(tparams, torch.from_numpy(ids), tc, tp,
                                 max_len=ids.shape[1] + 4)
    assert tcache["k"].dtype == torch.bfloat16
    got, _ = t_decode.decode_step(tparams, tcache, torch.as_tensor(tok),
                                  torch.as_tensor(pos).long(), tc, tp)
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err < MIXED_REL, err


@pytest.mark.parametrize("family", ["mixtral", "gpt"])
def test_dropped_moe_is_refused_with_jax_text(family):
    if family == "mixtral":
        _, tc = _mixtral(1)
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, dropless=False))
    else:
        _, tc = _gpt(moe_freq=1)
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, dropless=False))
    ids, lens = t_gen.pad_prompts(PROMPTS)
    with pytest.raises(NotImplementedError,
                       match=r"cached decode with dropped \(capacity-factor\) MoE; use dropless"):
        t_decode.generate_cached({"embed": {"embedding": torch.zeros(1)}}, tc, _policies()[1],
                                 ids, lens, max_new_tokens=2, eos_id=EOS)


# ---------------------------------------------------------------------------
# filters and sampling
# ---------------------------------------------------------------------------


FILTERS = [
    ([[1.0, 5.0, 3.0, 2.0, 4.0]], dict(top_k=2)),
    (np.log([[0.64, 0.24, 0.09, 0.03]]).tolist(), dict(top_p=0.7)),
    ([[10.0, 0.0, 0.0]], dict(top_p=0.1)),  # the first token is always kept
    ([[2.0, 2.0, 2.0, 1.0, 0.0]], dict(top_k=2)),  # ties at the k-th are kept
    ("seeded", dict(top_k=20)),
    ("seeded", dict(top_p=0.9)),
    ("seeded", dict(top_k=30, top_p=0.8)),
    ("seeded_bf16", dict(top_p=0.95)),
]


@pytest.mark.parametrize("logits,kw", FILTERS)
def test_filter_logits_matches_jax(logits, kw):
    dtype = jnp.bfloat16 if logits == "seeded_bf16" else jnp.float32
    if isinstance(logits, str):
        logits = np.random.default_rng(7).normal(0, 3, (16, 500))
    jl = jnp.asarray(np.asarray(logits, np.float32), dtype)
    tl = torch.from_numpy(np.asarray(jl.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    want = np.asarray(j_gen.filter_logits(jl, **kw).astype(jnp.float32))
    got = t_gen.filter_logits(tl, **kw).float().numpy()
    for r, c in np.argwhere(got != want):
        # only a top-p boundary tie may differ: the mass before the token
        # within 1e-6 of top_p
        assert "top_p" in kw, (r, c)
        row = np.sort(tl[r].float().numpy().astype(np.float64))[::-1]
        p = np.exp(row - row[0]) / np.exp(row - row[0]).sum()
        before = (np.cumsum(p) - p)[np.searchsorted(-row, -float(tl[r, c]))]
        assert abs(before - kw["top_p"]) < 1e-6, (r, c, before)
    kept = got > np.finfo(np.float32).min / 2
    assert kept.any(axis=-1).all()
    assert kept[np.arange(len(got)), got.argmax(-1)].all()


def test_sampled_tokens_lie_in_the_kept_set_and_repeat_with_the_seed():
    """JAX's ``test_sampled_generation_respects_top_k`` on the port's
    ``generate``, and on ``generate_cached``: every sampled token is one the
    filters keep; the same generator seed gives the same tokens, another
    seed other tokens."""
    vocab = 16
    base = torch.full((vocab,), -10.0)
    base[3], base[5] = 5.0, 4.0

    def logits_of(_, ids):
        return base.expand(*ids.shape, vocab)

    ids = torch.zeros((2, 4), dtype=torch.int32)
    lens = torch.tensor([4, 4], dtype=torch.int32)
    out = t_gen.generate(None, ids, lens, logits_of, max_new_tokens=8, eos_id=15,
                         temperature=1.0, top_k=2, generator=torch.Generator().manual_seed(0))
    assert set(np.unique(out[:, 4:].numpy())) <= {3, 5}

    tc, params = _port("llama")
    policy = _policies()[1]
    pids, plens = t_gen.pad_prompts(PROMPTS)

    def sampled(seed, **kw):
        return t_decode.generate_cached(params, tc, policy, pids, plens, max_new_tokens=NEW,
                                        eos_id=EOS, temperature=0.9, top_k=5,
                                        generator=torch.Generator().manual_seed(seed), **kw)

    a, b, c = sampled(1), sampled(1), sampled(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # each sampled token (up to the row's EOS) is in the top 5 of its step's logits
    for row, n in enumerate(PROMPTS):
        for i in range(NEW):
            if EOS in a[row, len(n):len(n) + i]:
                break
            prefix = a[row:row + 1, :len(n) + i]
            step = t_llama.forward(params, {"input_ids": prefix}, tc, policy)[0][0, -1]
            assert a[row, len(n) + i] in torch.topk(step, 5).indices


@pytest.mark.parametrize("kw", [dict(top_k=5), dict(top_p=0.9), dict(temperature=0.5)])
def test_sampling_frequencies_match_the_filtered_softmax(kw):
    """20000 draws of one row against ``softmax(filter(logits / T))``: a
    chi-square statistic below its 1e-3 quantile."""
    from scipy.stats import chi2

    t = kw.pop("temperature", 1.0)
    logits = torch.from_numpy(np.random.default_rng(11).normal(0, 1.5, 12).astype(np.float32))
    n = 20000
    rows = logits.expand(n, -1)
    draws = t_gen.pick(rows, temperature=t, top_k=kw.get("top_k"), top_p=kw.get("top_p"),
                       generator=torch.Generator().manual_seed(3))
    probs = torch.softmax(t_gen.filter_logits(logits[None] / t, **kw)[0], -1).numpy()
    counts = np.bincount(draws.numpy(), minlength=12)
    kept = probs > 0
    assert counts[~kept].sum() == 0
    expected = n * probs[kept]
    stat = ((counts[kept] - expected) ** 2 / expected).sum()
    assert stat < chi2.ppf(1 - 1e-3, kept.sum() - 1), (stat, counts, expected)


# ---------------------------------------------------------------------------
# metrics, the CLI and the bench
# ---------------------------------------------------------------------------


def _words(rng, n):
    vocab = ["the", "cat", "sat", "on", "a", "mat", "Dog", "ran!", "4", "x_y"]
    return " ".join(rng.choice(vocab, int(n)))


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    pairs = [(_words(rng, rng.integers(0, 9)), _words(rng, rng.integers(0, 9)))
             for _ in range(60)] + [("The Cat!", "the cat"), ("", ""), ("a", "")]
    for p, r in pairs:
        for m in ("rouge_l", "exact_match", "token_f1"):
            assert getattr(t_eval, m)(p, r) == getattr(j_eval, m)(p, r), (m, p, r)
    preds, refs = zip(*pairs)
    assert t_eval.score(preds, refs) == j_eval.score(preds, refs)
    assert t_eval.score(preds, refs, ["f1"]) == j_eval.score(preds, refs, ["f1"])
    with pytest.raises(ValueError, match="predictions/references length mismatch"):
        t_eval.score(["a"], [])
    records = [{"input": p, "output": r, "id": i} for i, (p, r) in enumerate(pairs)]

    def gen_fn(prompt):
        return prompt.upper()[::2]

    kw = dict(prompt_template="Q{id}: {input}", target_field="output")
    assert t_eval.evaluate_sft(records, gen_fn, **kw) == j_eval.evaluate_sft(records, gen_fn,
                                                                             **kw)


class ByteTokenizer:
    """A byte-level stub: ids are bytes + 3 (0..2 reserved, 2 the EOS)."""

    eos_token_id = 2

    def encode(self, text):
        return [b + 3 for b in text.encode()]

    def decode(self, ids):
        return bytes(int(i) - 3 for i in ids if 3 <= int(i) < 259).decode("utf-8", "replace")


def _sft_config(tmp_path, data):
    import yaml

    cfg = {
        "name": "sft_eval", "model_source": "hf", "seed": 5,
        "model_alignment_strategy": {"sft": {"packing": True}},
        "trainer": {"max_steps": 2, "log_every_n_steps": 1},
        "exp_manager": {"exp_dir": str(tmp_path / "exp"), "create_tensorboard_logger": False,
                        "log_files": False,
                        "telemetry": {"compile_census": False},
                        "checkpoint_callback_params": {"save_top_k": 1,
                                                       "every_n_train_steps": 2}},
        "distributed_strategy": {"tensor_model_parallel_size": 1},
        "data": {"global_batch_size": 4, "micro_batch_size": 2, "seq_length": 64,
                 "train_dir": str(data), "tokenizer": {"library": "char", "vocab_size": 300}},
        "model": {"vocab_size": 300, "hidden_size": 32, "intermediate_size": 64,
                  "num_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                  "max_position_embeddings": 64, "lora": dict(LORA, lora_dropout=0.0),
                  "optim": {"name": "adamw_fp32OptState", "lr": 5e-2,
                            "sched": {"name": "CosineAnnealing", "warmup_steps": 0,
                                      "max_steps": 2}}},
        "precision": {"type": "fp32"},
    }
    path = tmp_path / "sft_eval.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_sft_evaluation_cli_end_to_end(tmp_path, monkeypatch):
    """The trainer writes a LoRA SFT checkpoint (2 steps); the CLI restores
    it and its generations equal ``generate_cached`` on the restored weights
    token for token, its scores JAX's ``score`` of the same predictions; a
    sampled run repeats itself; without ``--device cpu`` and a card it
    raises."""
    from neuronx_distributed_training_torch.config.loader import load_config
    from neuronx_distributed_training_torch.trainer import loop as t_loop

    rng = np.random.default_rng(21)
    train = tmp_path / "train.jsonl"
    train.write_text("\n".join(json.dumps({"input": _words(rng, 6), "output": _words(rng, 6)})
                               for _ in range(40)))
    records = [{"input": _words(rng, rng.integers(1, 6)), "output": _words(rng, 3)}
               for _ in range(5)]
    data = tmp_path / "eval.jsonl"
    data.write_text("\n".join(json.dumps(r) for r in records))
    config = _sft_config(tmp_path, train)
    trainer = t_loop.Trainer.from_config(load_config(config), device="cpu")
    trainer.fit()
    trainer.checkpointer.close()
    ckpt = trainer.checkpointer.directory
    lora_b = [t for n, t in t_llama.named_params(trainer.params).items() if n.endswith("lora_b")]
    assert lora_b and any(t.abs().max() > 0 for t in lora_b)  # the adapters decode

    argv = ["--config", str(config), "--checkpoint", str(ckpt), "--data", str(data),
            "--tokenizer", "unused", "--max-new-tokens", "6", "--batch-size", "2",
            "--device", "cpu"]
    tok = ByteTokenizer()
    with redirect_stdout(io.StringIO()) as out:
        scores, generations = t_cli.main(argv, tokenizer=tok)
    assert json.loads(out.getvalue()) == scores
    mc, policy, params = t_cli.restore_model(load_config(config), str(ckpt), None,
                                             torch.device("cpu"))
    for n, t in t_llama.named_params(params).items():
        assert torch.equal(t, t_llama.named_params(trainer.params)[n]), n
    preds = []
    for i in range(0, len(records), 2):
        prompts = [tok.encode(r["input"]) for r in records[i:i + 2]]
        ids, lens = t_gen.pad_prompts(prompts, pad_id=tok.eos_token_id)
        want = t_decode.generate_cached(params, mc, policy, ids, lens, max_new_tokens=6,
                                        eos_id=2, pad_id=2)
        for b, row in enumerate(want.tolist()):
            assert generations[i + b] == row
            gen_ids = np.asarray(row[int(lens[b]):])
            preds.append(tok.decode(gen_ids[gen_ids != 2]))
    assert scores == j_eval.score(preds, [r["output"] for r in records])
    with redirect_stdout(io.StringIO()):
        sampled = [t_cli.main(argv + ["--temperature", "0.8", "--top-p", "0.9"],
                              tokenizer=tok)[1] for _ in range(2)]
    assert sampled[0] == sampled[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(argv[:-2], tokenizer=tok)


# the JAX bench's JSON keys (its ``tools/bench_decode.py``)
BENCH_KEYS = {"metric", "value", "unit", "prefill_tokens_per_sec", "ms_per_decode_step",
              "batch", "prompt_len", "new_tokens", "num_layers", "device", "note"}


def test_bench_decode_prints_one_json_line_with_jax_keys(monkeypatch):
    with redirect_stdout(io.StringIO()) as out:
        t_bench.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--new-tokens", "3"])
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == BENCH_KEYS
    assert rec["unit"] == "decode_tokens_per_sec" and rec["device"] == "cpu"
    assert (rec["batch"], rec["prompt_len"], rec["new_tokens"], rec["num_layers"]) == (2, 8, 3, 2)
    assert rec["value"] > 0 and rec["prefill_tokens_per_sec"] > 0
    # JAX's layer rule: all 32 layers on an 80 GB card, at least 1
    assert t_bench.card_layers(80 * 10 ** 9) == 32 and t_bench.card_layers(2 * 10 ** 9) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_bench.main([])
