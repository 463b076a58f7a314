"""The chunked head + cross-entropy (``fusions.chunked_ce``) of the port
against the JAX package's ``chunked_cross_entropy_from_hidden``, on the CPU.

- the function, fp32, from one seeded numpy draw: tied (``embedding.T``) and
  untied heads, ``ignore_index`` rows and a ``loss_mask``, the reductions
  ``sum`` / ``mean`` / ``none``; the value against JAX and against the
  port's unchunked ``cross_entropy_loss`` (rtol 1e-5), the gradients of
  ``hidden`` and of the head weight against JAX's VJP (1e-5 of each
  gradient's largest entry);
- what autograd keeps: no saved tensor (``torch.autograd.graph.
  saved_tensors_hooks``) holds more than ``b s V / num_chunks`` elements;
- the vocab's check, in JAX's words;
- 3 trainer steps with ``model.fusions.chunked_ce`` from the JAX trainer's
  weights against the JAX trainer on one device (fp32: loss and grad norm
  rtol 1e-5; ``mixed_precision``: 1e-4 and 2e-3).

tp 2 with SP is held against JAX in ``tests/test_torch_dense_meshes.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_training_torch.config import loader as t_loader
from neuronx_distributed_training_torch.models import llama as t_llama
from neuronx_distributed_training_torch.ops import cross_entropy as t_ce
from neuronx_distributed_training_torch.optim.adamw import init_opt_state
from neuronx_distributed_training_torch.tools.convert import params_from_jax
from neuronx_distributed_training_torch.trainer import loop as t_loop
from neuronx_distributed_training_tpu.config import loader as j_loader
from neuronx_distributed_training_tpu.ops import cross_entropy as j_ce
from neuronx_distributed_training_tpu.trainer import loop as j_loop

B, S, H, V, CHUNKS = 2, 16, 8, 64, 4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, H)).astype(np.float32)
    table = (0.5 * rng.standard_normal((V, H))).astype(np.float32)  # [V, h]: tied head's
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, 3] = -100
    mask = (rng.random((B, S)) > 0.25).astype(np.float32)
    cot = rng.standard_normal((B, S)).astype(np.float32)
    return hidden, table, labels, mask, cot


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_chunked_ce_matches_jax_and_the_unchunked_loss(tied, reduction):
    hidden, table, labels, mask, cot = _inputs()
    # tied: the head is the embedding's transpose; untied: its own [h, V]
    head = table if tied else np.ascontiguousarray(table.T)

    def j_fn(x, w):
        w = w.T if tied else w
        return j_ce.chunked_cross_entropy_from_hidden(
            x, w, jnp.asarray(labels), num_chunks=CHUNKS, loss_mask=jnp.asarray(mask),
            reduction=reduction)

    j_out, j_vjp = jax.vjp(j_fn, jnp.asarray(hidden), jnp.asarray(head))
    j_cot = jnp.asarray(cot) if reduction == "none" else jnp.asarray(1.0)
    j_dx, j_dw = j_vjp(j_cot)

    def t_fn(x, w, chunked):
        w = w.T if tied else w
        if chunked:
            return t_ce.chunked_cross_entropy_from_hidden(
                x, w, torch.tensor(labels), num_chunks=CHUNKS, loss_mask=torch.tensor(mask),
                reduction=reduction)
        return t_ce.cross_entropy_loss(x @ w, torch.tensor(labels),
                                       loss_mask=torch.tensor(mask), reduction=reduction)

    outs = {}
    for chunked in (True, False):
        x = torch.tensor(hidden, requires_grad=True)
        w = torch.tensor(head, requires_grad=True)
        out = t_fn(x, w, chunked)
        (out * torch.tensor(cot)).sum().backward() if reduction == "none" else out.backward()
        outs[chunked] = (out.detach(), x.grad, w.grad)
    out, dx, dw = outs[True]
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), outs[False][0].numpy(), rtol=1e-5, atol=1e-6)
    assert _rel(dx, j_dx) <= 1e-5 and _rel(dw, j_dw) <= 1e-5
    assert _rel(dx, outs[False][1].numpy()) <= 1e-5 and _rel(dw, outs[False][2].numpy()) <= 1e-5
    if reduction == "none":
        # ignored and masked positions contribute nothing
        assert float(out[0, :5].abs().max()) == 0.0
        assert float(out[torch.tensor(mask) == 0].abs().max()) == 0.0


def test_chunked_ce_saves_no_tensor_above_one_chunk_of_logits():
    """Autograd keeps ``hidden``, the head weight, the labels, the mask and
    the fp32 lse; the largest is well under one chunk's ``b s V / chunks``
    logits (the test's widths keep ``h`` below ``V / chunks`` and ``h V``
    below ``b s V / chunks``, so a saved block of logits would show)."""
    hidden, table, labels, mask, _ = _inputs(1)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    x = torch.tensor(hidden, requires_grad=True)
    w = torch.tensor(np.ascontiguousarray(table.T), requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = t_ce.chunked_cross_entropy_from_hidden(
            x, w, torch.tensor(labels), num_chunks=CHUNKS, loss_mask=torch.tensor(mask))
    loss.backward()
    assert saved and max(saved) <= B * S * V // CHUNKS, saved
    assert x.grad is not None and w.grad is not None
    # the unchunked loss keeps the whole logits: the check would see it
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        t_ce.cross_entropy_loss(x @ w, torch.tensor(labels), loss_mask=torch.tensor(mask))
    assert max(saved) >= B * S * V


def test_chunked_ce_vocab_check_is_jax_s():
    hidden, table, labels, _, _ = _inputs()
    w = np.ascontiguousarray(table.T)
    msgs = []
    for fn, arr in ((t_ce.chunked_cross_entropy_from_hidden, torch.tensor),
                    (j_ce.chunked_cross_entropy_from_hidden, jnp.asarray)):
        with pytest.raises(ValueError) as e:
            fn(arr(hidden), arr(w), arr(labels), num_chunks=5)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == f"vocab {V} not divisible by num_chunks 5"


def _cfg(tmp, exp, precision):
    from test_torch_dp import dp_cfg

    cfg = dp_cfg(tmp, exp, precision=precision, every=0)
    cfg["model"]["fusions"] = {"chunked_ce": 4}
    cfg["exp_manager"]["resume_if_exists"] = False
    return cfg


@pytest.mark.parametrize("precision", ["fp32", "mixed_precision"])
def test_trainer_with_chunked_ce_matches_jax(tmp_path, precision, monkeypatch):
    """3 steps of the tiny model (vocab 128 in 4 chunks) with
    ``fusions.chunked_ce`` from the JAX trainer's initial weights, against
    the JAX trainer on one device; the port's run goes through the chunked
    head (``forward`` gets no logits) and its loss equals the unchunked
    port's within the tolerance."""
    jt = j_loop.Trainer.from_config(j_loader.load_config(_cfg(tmp_path, "jax", precision)),
                                    devices=jax.devices()[:1], enable_checkpointing=False)
    assert jt.model_cfg.vocab_chunks == 4
    j0 = jax.tree_util.tree_map(np.asarray, jt.params)
    jt.fit()
    lines = [json.loads(x) for x in (jt.exp.log_dir / "metrics.jsonl").read_text().splitlines()]
    lines = [x for x in lines if "loss" in x]
    calls = []
    fused = t_llama._chunked_head_loss
    monkeypatch.setattr(t_llama, "_chunked_head_loss",
                        lambda *a, **kw: calls.append(1) or fused(*a, **kw))
    hist = {}
    for chunked in (True, False):
        cfg = _cfg(tmp_path, f"port_{chunked}", precision)
        if not chunked:
            cfg["model"]["fusions"] = {}
        t = t_loop.Trainer.from_config(t_loader.load_config(cfg), device="cpu",
                                       enable_checkpointing=False)
        assert t.model_cfg.vocab_chunks == (4 if chunked else None)
        src = t_llama.named_params(params_from_jax(j0, device="cpu"))
        with torch.no_grad():
            for n, p in t_llama.named_params(t.params).items():
                p.copy_(src[n])
        t.opt_state = init_opt_state(t_llama.named_params(t.params), t.policy,
                                     health=t.health.enabled)
        hist[chunked] = t.fit()
    fp32 = precision == "fp32"
    for chunked, h in hist.items():
        np.testing.assert_allclose([x["loss"] for x in h], [x["loss"] for x in lines],
                                   rtol=1e-5 if fp32 else 1e-4, atol=0, err_msg=str(chunked))
        np.testing.assert_allclose([x["grad_norm"] for x in h], [x["grad_norm"] for x in lines],
                                   rtol=1e-5 if fp32 else 2e-3, atol=0, err_msg=str(chunked))
    assert len(hist[True]) == 3 and hist[True][0]["loss"] != hist[True][-1]["loss"]
    assert len(calls) == 3 * 4  # each microbatch of the chunked run, none of the other
