"""LoRA on Mixtral and on Megatron GPT in the port against the JAX package,
on the CPU (``peft/lora.py``, ``parallel/sharding.py``, the trainer's
freeze).

Models: a tiny Mixtral (hidden 64, ffn 96, 4 / 2 heads, 4 experts top 2)
and a tiny GPT (hidden 64, ffn 96, 4 / 2 heads, biased linears), weights
crossing with ``tools/convert.py``; inputs are seeded numpy.  Bars, as the
families' own parity tests (``test_torch_mixtral.py``,
``test_torch_gpt.py``): fp32 outputs rtol 2e-5, gradients rtol 1e-3 / atol
1e-5; trainer losses and grad norms rtol 1e-5.

- which linears get adapters: JAX's ``add_lora`` and the port's give the
  same adapter leaves, at the same shapes, on Mixtral (its MoE layers'
  attention only, no expert; at ``moe_frequency`` 2 the dense layers' MLP
  too; the router only when named) and on GPT (gelu and glu, a named glu ``up``, a named untied
  head, a tied head that has no linear, GPT-MoE), and the same trainable
  mask;
- the adapted forward: loss and every adapter's gradient against JAX's,
  with a non-zero B (GPT: biased swiglu, learned positions, the head and
  ``up`` adapted; Mixtral: the router adapted too);
- the adapters' tp layouts against JAX's ``lora_param_specs``;
- the A draw is the same at every tp and pp: a GPT-MoE and a Mixtral at
  ``moe_frequency`` 2 (MoE and dense layers adapt different linears) at tp
  2 and at pp 2 draw the one-rank numbers;
- the converters drop the adapters as JAX's do (Mixtral to HF, GPT to
  Megatron), from the same tree;
- the trainer at one process against the JAX trainer, 3 steps (fp32): loss,
  grad norm, every adapter at ``test_torch_step.py``'s bar, every frozen
  leaf (the experts and the router included) bit for bit, no optimizer
  state for a frozen leaf;
- under tp, ep and ZeRO-1 (the 4-rank launch of ``test_torch_cp_families.
  py``): Mixtral at tp 2 x ep 2 and at dp 2 x ep 2, each against the same
  JAX trainer, the experts holding no ZeRO-1 state (GPT's LoRA at cp 2 x tp
  2 is held there);
- a LoRA run saved at step 2 and resumed equals the straight run bit for
  bit, for both families;
- the CLI trains the shipped Mixtral and GPT configs with a ``model.lora``
  block at a tiny width.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cp_families as CPF
from test_torch_cp_families import families  # noqa: F401  (the shared launch)
from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import gpt as t_gpt
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.models import mixtral as t_mixtral
from neuronx_distributed_training_torch.ops import moe as t_moe
from neuronx_distributed_training_torch.parallel import sharding
from neuronx_distributed_training_torch.peft import lora as t_lora
from neuronx_distributed_training_torch.tools import convert as t_convert
from neuronx_distributed_training_torch.tools import convert_megatron as t_cm
from neuronx_distributed_training_torch.tools.convert import params_from_jax
from neuronx_distributed_training_torch.trainer import cli as t_cli
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy as TPolicy
from neuronx_distributed_training_tpu.models import gpt as j_gpt
from neuronx_distributed_training_tpu.models import llama as j_llama
from neuronx_distributed_training_tpu.models import mixtral as j_mixtral
from neuronx_distributed_training_tpu.ops import moe as j_moe
from neuronx_distributed_training_tpu.peft import lora as j_lora
from neuronx_distributed_training_tpu.tools import convert as j_convert
from neuronx_distributed_training_tpu.tools import convert_megatron as j_cm
from neuronx_distributed_training_tpu.utils.dtypes import DtypePolicy as JPolicy

REPO = Path(__file__).resolve().parents[1]
CONF = REPO / "examples" / "conf"
RTOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-3, 1e-5
LC = dict(vocab_size=96, hidden_size=64, intermediate_size=96, num_layers=2,
          num_attention_heads=4, num_kv_heads=2, activations_checkpoint_granularity=None)
GPT = dict(vocab_size=96, hidden_size=64, ffn_hidden_size=96, num_layers=2,
           num_attention_heads=4, num_query_groups=2, max_position_embeddings=32,
           activations_checkpoint_granularity=None)
FP32 = (JPolicy.from_precision_config({"type": "fp32"}),
        TPolicy.from_precision_config({"type": "fp32"}))


def _mixtral(freq=1, layers=2, **moe):
    block = {"num_experts": 4, "top_k": 2, **moe}
    j = j_mixtral.MixtralConfig(llama=j_llama.LlamaConfig(**{**LC, "num_layers": layers}),
                                moe=j_moe.MoEConfig(**block), moe_frequency=freq)
    t = t_mixtral.MixtralConfig(llama=t_llama.LlamaConfig(**{**LC, "num_layers": layers}),
                                moe=t_moe.MoEConfig(**dataclasses.asdict(j.moe)),
                                moe_frequency=freq)
    return j, t


def _gpt(moe=None, **kw):
    c = {**GPT, **kw}
    jm = j_moe.MoEConfig(**{"num_experts": 4, **moe}) if moe is not None else None
    tm = t_moe.MoEConfig(**dataclasses.asdict(jm)) if jm is not None else None
    return j_gpt.GPTConfig(**c, moe=jm), t_gpt.GPTConfig(**c, moe=tm)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named(jtree) -> dict:
    return t_llama.named_params(params_from_jax(_np(jtree), device="cpu"))


def _close(got, want, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _port_init(tc, **kw):
    init = t_gpt.init_params if isinstance(tc, t_gpt.GPTConfig) else t_mixtral.init_params
    return init(tc, FP32[1], generator=torch.Generator().manual_seed(0), device="cpu", **kw)


def _jax_init(jc, seed=0, lora=None, shapes=False):
    """JAX's initial tree, with ``lora``'s adapters (``add_lora`` keyed by
    ``seed + 1``), in one jitted call; ``shapes``: zeros of its leaves'
    shapes and dtypes, traced and not run."""
    init = j_gpt.init_params if isinstance(jc, j_gpt.GPTConfig) else j_mixtral.init_params

    def build(key):
        tree = init(key, jc, FP32[0])
        return tree if lora is None else j_lora.add_lora(tree, lora, jax.random.fold_in(key, 1))

    key = jax.random.PRNGKey(seed)
    if shapes:
        return jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype),
                                      jax.eval_shape(build, key))
    return jax.jit(build)(key)


#: name -> (configs, target modules or None for the defaults)
TREES = {
    "mixtral_freq2": (lambda: _mixtral(freq=2, layers=4), None),
    "mixtral_router": (lambda: _mixtral(), ("qkv", "o", "router")),
    "gpt_gelu": (lambda: _gpt(), None),
    "gpt_glu_up": (lambda: _gpt(activation="swiglu"), ("qkv", "o", "up", "down")),
    "gpt_untied_head": (lambda: _gpt(share_embeddings_and_output_weights=False),
                        ("qkv", "lm_head")),
    "gpt_tied_head": (lambda: _gpt(), ("qkv", "lm_head")),
    "gpt_moe_freq2": (lambda: _gpt(moe={"top_k": 2}, moe_frequency=2, num_layers=4), None),
}


def _lora_cfgs(targets):
    kw = {} if targets is None else {"target_modules": tuple(targets)}
    return j_lora.LoraConfig(rank=4, alpha=16.0, **kw), t_lora.LoraConfig(rank=4, alpha=16.0,
                                                                          **kw)


def _kinds(tc):
    return t_loop._layer_kinds(tc)


@pytest.mark.parametrize("name", list(TREES))
def test_adapter_leaves_match_jax(name):
    """The port's ``add_lora`` adapts exactly the linears JAX's does: the
    same adapter leaf names (by the port's per-layer names) at the same
    shapes, no expert stack, a router or a head only when named (a tied
    head never), and the same trainable leaves."""
    (jc, tc), targets = TREES[name][0](), TREES[name][1]
    jl, tl = _lora_cfgs(targets)
    jtree = _jax_init(jc, lora=jl, shapes=True)
    want = {n: tuple(t.shape) for n, t in _named(jtree).items() if "lora_" in n}
    ttree = t_lora.add_lora(_port_init(tc), tl, torch.Generator().manual_seed(1),
                            layer_kinds=_kinds(tc))
    flat = t_llama.named_params(ttree)
    got = {n: tuple(t.shape) for n, t in flat.items() if "lora_" in n}
    assert got == want and got
    assert not any(".experts." in n for n in got)
    assert any(".router." in n for n in got) == (name == "mixtral_router")
    assert any(n.startswith("lm_head.") for n in got) == (name == "gpt_untied_head")
    mask = jax.tree_util.tree_map(lambda m, x: np.full(np.shape(x), m, np.float32),
                                  j_lora.trainable_mask(jtree), jtree)
    jmask = {n for n, m in _named(mask).items() if float(m.max()) == 1.0}
    assert {n for n, m in t_lora.trainable_mask(flat).items() if m} == jmask
    for n, t in flat.items():
        if n.endswith("lora_b"):
            assert not t.any(), n
        if n.endswith("lora_scale"):
            assert float(t) == 4.0


def _nonzero_b(jtree, seed=3):
    """``jtree`` with every ``lora_b`` drawn non-zero, so that the adapter
    term and every A's gradient count."""
    key = [jax.random.PRNGKey(seed)]

    def visit(path, x):
        if str(getattr(path[-1], "key", "")) == "lora_b":
            key[0], sub = jax.random.split(key[0])
            return 0.05 * jax.random.normal(sub, x.shape, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(visit, jtree)


@pytest.mark.parametrize("name", ["mixtral_router", "gpt_glu_up_head"])
def test_adapted_forward_and_adapter_grads_match_jax(name):
    """The adapted forward with a non-zero B (the adapter term, then the
    bias, as JAX's ``apply_linear``): the loss, and the gradient of every
    adapter (and, with it, of the frozen leaves the freeze drops) against
    JAX's, fp32; GPT biased swiglu with learned positions, its glu ``up``
    and untied head adapted, Mixtral with its router adapted (whose
    adapters neither package's routing reads)."""
    if name == "mixtral_router":
        (jc, tc), targets = _mixtral(), ("qkv", "o", "router")
        fwd_j, fwd_t = j_mixtral.forward, t_mixtral.forward
    else:
        jc, tc = _gpt(activation="swiglu", position_embedding_type="learned_absolute",
                      share_embeddings_and_output_weights=False)
        targets = ("qkv", "o", "up", "down", "lm_head")
        fwd_j = lambda p, b, c, pol: j_gpt.forward(p, b, c, pol)  # noqa: E731
        fwd_t = t_gpt.forward
    jl, _ = _lora_cfgs(targets)
    jp = _nonzero_b(_jax_init(jc, seed=2, lora=jl))
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 96, (2, 16)).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids}
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: fwd_j(p, {k: jnp.asarray(v) for k, v in batch.items()}, jc, FP32[0])[0]))(jp)
    tp = params_from_jax(_np(jp), device="cpu")
    flat = t_llama.named_params(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tloss, _ = fwd_t(tp, {k: torch.tensor(v) for k, v in batch.items()}, tc, FP32[1])
    tloss.backward()
    _close(float(tloss.detach()), float(jloss))
    want = _named(jg)
    adapters = [n for n in flat if n.endswith(("lora_a", "lora_b"))]
    assert len(adapters) >= 8
    for n in adapters:
        # a router's adapters are read by neither package's routing (JAX's
        # ``route`` multiplies by ``w`` alone): no gradient here, zeros there
        got = flat[n].grad if flat[n].grad is not None else torch.zeros_like(flat[n])
        _close(got, want[n], GRAD_RTOL, GRAD_ATOL, msg=n)
        assert (".router." in n) == (not want[n].any()), n


@pytest.mark.parametrize("family", ["mixtral", "gpt"])
def test_adapter_layouts_follow_jax_lora_specs(family):
    """Each adapter leaf's tp dim is the ``model`` entry of JAX's
    ``lora_param_specs`` over the family's ``param_specs`` (a column
    layer's B and a row layer's A sharded; the router's and the head's as
    their base), and the replicated factors' gradients are partial."""
    if family == "mixtral":
        jc, tc = _mixtral()
        specs, targets = j_mixtral.param_specs(jc), ("qkv", "o", "router")
    else:
        jc, tc = _gpt(activation="swiglu", share_embeddings_and_output_weights=False)
        specs, targets = j_gpt.param_specs(jc), ("qkv", "o", "up", "down", "lm_head")
    jspecs = j_lora.lora_param_specs(specs, j_lora.LoraConfig(target_modules=targets))
    flat = {}

    def visit(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                visit(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = v

    visit(jspecs, "")
    checked = 0
    for jname, spec in flat.items():
        if not jname.endswith(("lora_a", "lora_b")):
            continue
        name = jname.replace("layers.", "layers.0.")
        entries = tuple(spec)[1:] if jname.startswith("layers.") else tuple(spec)
        model = [i for i, e in enumerate(entries) if e == "model"]
        lay = sharding.leaf_layout(name, tc, sequence_parallel=True)
        assert lay.dim == (model[0] if model else None), (name, spec)
        assert lay.partial == (lay.dim is None), name
        checked += 1
    assert checked == 2 * len(targets)


@pytest.mark.parametrize("family", ["mixtral_freq2", "gpt_moe_freq2"])
def test_a_draw_is_the_same_at_every_tp_and_pp(family):
    """The adapters drawn at tp 2 (merged back by their layouts) and at pp
    2 (each stage's layers, the other stage's drawn and dropped) equal the
    one-rank draw bit for bit, on a model whose MoE and dense layers adapt
    different linears."""
    _, tc = TREES[family][0]()
    _, tl = _lora_cfgs(None)

    def adapters(tp_rank=0, tp_size=1, pp_rank=0, pp_size=1):
        tree = _port_init(tc, tp_rank=tp_rank, tp_size=tp_size, pp_rank=pp_rank,
                          pp_size=pp_size)
        tree = t_lora.add_lora(tree, tl, torch.Generator().manual_seed(1), tp_rank=tp_rank,
                               tp_size=tp_size, layer_kinds=_kinds(tc))
        return {n: t for n, t in t_llama.named_params(tree).items() if "lora_" in n}

    one = adapters()
    ranks = [adapters(tp_rank=r, tp_size=2) for r in range(2)]
    for n, t in one.items():
        lay = sharding.leaf_layout(n, tc)
        assert torch.equal(sharding.merge_leaf([r[n] for r in ranks], lay), t), n
    stages = [adapters(pp_rank=r, pp_size=2) for r in range(2)]
    assert set(stages[0]) | set(stages[1]) == set(one)
    for stage in stages:
        for n, t in stage.items():
            assert torch.equal(t, one[n]), n


@pytest.mark.parametrize("family", ["mixtral", "gpt"])
def test_converters_drop_the_adapters_as_jax(family):
    """From one tree with adapters (and a non-zero B), the port's exporter
    (Mixtral to HF, GPT to Megatron) writes JAX's exporter's tensors, key
    for key: the base weights, no adapter (neither merges it)."""
    if family == "mixtral":
        jc, tc = _mixtral()
        j_out, t_out = j_convert.native_to_hf_mixtral, t_convert.native_to_hf_mixtral
    else:
        jc, tc = _gpt(activation="swiglu", position_embedding_type="learned_absolute",
                      share_embeddings_and_output_weights=False)
        j_out, t_out = j_cm.native_to_megatron_gpt, t_cm.native_to_megatron_gpt
    jl, _ = _lora_cfgs(("qkv", "o", "down"))
    jp = _np(_nonzero_b(_jax_init(jc, lora=jl)))
    want = j_out(jp, jc)
    got = t_out(params_from_jax(jp, device="cpu"), tc)
    assert set(got) == set(want) and not any("lora" in k for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


# ---------------------------------------------------------------------------
# the trainer: one process, and the 4-rank launch, against the JAX trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["lora_mx", "lora_gpt"])
def test_lora_trainer_matches_jax_at_one_process(families, name):  # noqa: F811
    """3 steps of the port's trainer at one process (Mixtral; GPT biased
    swiglu with learned positions, its ``up`` and untied head adapted)
    against the JAX trainer from the same weights: loss and grad norm at
    fp32 rtol 1e-5; the frozen leaves (the experts and the router
    included) bit for bit as they started; the optimizer holding state
    for the adapters alone."""
    jparams, lines = families["jax"][name]
    CPF.same_history(families["one"][name], lines)
    moved, opt_leaves, trainable = families["one"][name + "_frozen"]
    assert moved == [] and opt_leaves == trainable
    assert all(n.endswith(("lora_a", "lora_b")) for n in trainable)
    if name == "lora_mx":
        assert len(trainable) == 2 * 2 * 2  # qkv and o, a and b, 2 layers
    else:
        assert len(trainable) == 2 * 4 * 2 + 2  # 4 linears a layer, and the head


@pytest.mark.parametrize("name", ["lora_mx", "lora_mx_dp2_ep2"])
def test_lora_mixtral_under_tp_and_ep_matches_jax(families, name):  # noqa: F811
    """LoRA Mixtral at tp 2 x ep 2 (SP) and at dp 2 x ep 2 (ZeRO-1) on 4
    gloo ranks against the JAX trainer at one device: loss, grad norm,
    router and LM losses, the adapters at the bar and the frozen base bit
    for bit; ZeRO-1 holds moments for the adapters alone, no expert."""
    ranks = CPF.matches_jax(families, name, "lora_mx",
                            keys=("loss", "grad_norm", "router_aux_loss", "lm_loss"))
    shards = ranks[0]["zero1_shards"]
    assert shards and all(n.endswith(("lora_a", "lora_b")) for n in shards)
    if name == "lora_mx_dp2_ep2":  # the adapters' state split over (data, expert)
        assert any(full != part for full, part in shards.values())


def _resume_case(tmp, family, exp, **kw):
    if family == "mixtral":
        return CPF.mx_cfg(tmp, exp, every=2, lora=CPF.LORA, **kw)
    return CPF.gpt_cfg(tmp, exp, every=2, **CPF.GPT_LORA_MODEL, **kw)


@pytest.mark.parametrize("family", ["mixtral", "gpt"])
def test_lora_resume_is_bit_for_bit(tmp_path, family):
    """A LoRA run saved at step 2 and resumed to step 4 equals a straight
    4-step run bit for bit (loss, grad norm, every param and optimizer
    leaf); the checkpoint holds the whole tree and the adapters' moments."""
    def trainer(exp, max_steps=None):
        cfg = _resume_case(tmp_path, family, exp)
        cfg["trainer"]["max_steps"] = 4
        t = t_loop.Trainer.from_config(t_loader.load_config(cfg), device="cpu")
        if max_steps:
            t.max_steps = max_steps
        return t

    straight = trainer("a")
    hs = straight.fit()
    first = trainer("b", max_steps=2)
    first.fit()
    assert first.checkpointer.committed_steps == [2]
    second = trainer("b")
    hr = second.fit()
    assert second.checkpointer.last_restore["step"] == 2
    assert [(r["loss"], r["grad_norm"]) for r in hr] == [(r["loss"], r["grad_norm"])
                                                         for r in hs[2:]]
    a, b = (t_llama.named_params(t.params) for t in (straight, second))
    assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)
    for g in ("mu", "nu"):
        sa, sb = straight.opt_state[g], second.opt_state[g]
        assert sorted(sa) == sorted(sb) == sorted(straight.trainable)
        assert all(torch.equal(sa[n], sb[n]) for n in sa)


@pytest.mark.parametrize("config,width", [
    ("hf_mixtral_8x7b_config.yaml", {"model.intermediate_size": 96,
                                     "model.num_key_value_heads": 2,
                                     "distributed_strategy.expert_model_parallel_size": 1}),
    ("megatron_gpt_config.yaml", {"model.ffn_hidden_size": 128, "model.num_query_groups": 2}),
])
def test_cli_trains_lora_on_the_shipped_families(tmp_path, config, width):
    """``trainer/cli.py`` trains the shipped Mixtral and GPT configs with a
    ``model.lora`` block (rank 16, the default targets) at a tiny width on
    the CPU: finite losses near ln V, only the adapters trainable."""
    args = ["--config", str(CONF / config), "--device", "cpu",
            "--set", "distributed_strategy.tensor_model_parallel_size=1",
            "--set", "distributed_strategy.sequence_parallel=false",
            "--set", "model.num_layers=2", "--set", "model.hidden_size=64",
            "--set", "model.num_attention_heads=4", "--set", "model.vocab_size=128",
            "--set", "data.seq_length=32", "--set", "data.global_batch_size=4",
            "--set", "data.synthetic=true", "--set", "data.train_dir=null",
            "--set", "trainer.max_steps=2", "--set", "model.lora={lora_rank: 16}",
            "--set", "exp_manager.create_tensorboard_logger=false",
            "--set", f"exp_manager.exp_dir={tmp_path}"]
    if "mixtral" in config:
        args += ["--set", "model.sliding_window=32"]
    for k, v in width.items():
        args += ["--set", f"{k}={v}"]
    trainer, history = t_cli.run(args)
    assert len(history) == 2 and all(np.isfinite(r["loss"]) for r in history)
    assert abs(history[0]["loss"] - np.log(128)) < 0.5
    assert trainer.trainable and all(n.endswith(("lora_a", "lora_b"))
                                     for n in trainer.trainable)
