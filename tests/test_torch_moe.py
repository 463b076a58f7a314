"""The port's ``ops/moe.py`` against the JAX package's, on the CPU, fp32.

Same inputs, drawn with numpy from a seed, through both: the router (top-k
and sinkhorn, ties to the lower index), the dropless and the dropped paths
(a binding capacity, with and without the stride shuffle) with the
gradients of the input, the router and the experts (outputs rtol 2e-5,
gradients rtol 1e-3 / atol 1e-5; routing identical), the losses, the
grouped product against a per-token plain version, the config parser.

The two global quantities of the distributed path, each on two simulated
data ranks whose routing differs:
- the router loss is JAX's product of global means: the shares of the two
  ranks sum to JAX's loss on all their tokens and their gradients are
  JAX's, while a mean of per-rank losses is another number;
- the dropped path's capacity and queues are the whole microbatch's: each
  rank's output is its rows of JAX's on the whole microbatch, while a
  per-rank capacity keeps other routes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_training_tpu.ops import moe as j_moe
from neuronx_distributed_training_torch.ops import moe as t_moe

H, FFN, E = 16, 24, 4
RTOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-3, 1e-5


def _cfgs(**kw):
    j = j_moe.MoEConfig(**{"num_experts": E, "top_k": 2, **kw})
    return j, t_moe.MoEConfig(**dataclasses.asdict(j))


def _params(seed=0, skew=0.0):
    """Router and expert weights from a numpy seed; ``skew`` tilts the
    router towards expert 0 (a skewed load that a capacity binds on)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((H, E)).astype(np.float32) * 0.5
    w[:, 0] += skew
    return {"router": {"w": w},
            "experts": {"gate_up": rng.standard_normal((E, H, 2 * FFN)).astype(np.float32) * 0.2,
                        "down": rng.standard_normal((E, FFN, H)).astype(np.float32) * 0.2}}


def _x(t, seed=1, shift=0.0):
    x = np.random.default_rng(seed).standard_normal((t, H)).astype(np.float32)
    x[:, 0] += shift
    return x


def _to_j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_t(tree, grad=False):
    return jax.tree_util.tree_map(lambda a: torch.tensor(a, requires_grad=grad), tree)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _jax_block_grads(fn, params, x, cotangent):
    """JAX's outputs and the gradients of ``sum(y * cotangent)``."""
    def f(p, xx):
        y, aux = fn(p, xx)
        return jnp.sum(y * cotangent), (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)
    return y, aux, grads


@pytest.mark.parametrize("router", ["top_k", "sinkhorn"])
def test_route_matches_jax(router):
    jc, tc = _cfgs(router_type=router, top_k=2 if router == "top_k" else 1)
    p, x = _params(), _x(48)
    jp, jidx, jlog = j_moe.route(_to_j(p["router"]), jnp.asarray(x), jc)
    tp = _to_t(p["router"], grad=True)
    tx = torch.tensor(x, requires_grad=True)
    pp, tidx, tlog = t_moe.route(tp, tx, tc)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    _close(pp.detach(), jp)
    _close(tlog.detach(), jlog)
    cot = np.random.default_rng(2).standard_normal(pp.shape).astype(np.float32)
    jg = jax.grad(lambda w, xx: jnp.sum(j_moe.route({"w": w}, xx, jc)[0] * cot),
                  argnums=(0, 1))(jnp.asarray(p["router"]["w"]), jnp.asarray(x))
    (pp * torch.tensor(cot)).sum().backward()
    _close(tp["w"].grad, jg[0], GRAD_RTOL, GRAD_ATOL)
    _close(tx.grad, jg[1], GRAD_RTOL, GRAD_ATOL)


def test_top_k_ties_go_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25], [0.4, 0.2, 0.4, 0.0]],
                     np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = t_moe.top_k(torch.tensor(probs), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji)), k
        assert np.array_equal(tv.numpy(), np.asarray(jv))


BLOCKS = {
    "dropless": dict(dropless=True),
    "dropless_sinkhorn": dict(dropless=True, router_type="sinkhorn"),
    "dropped": dict(dropless=False, capacity_factor=0.75),
    "dropped_shuffle": dict(dropless=False, capacity_factor=0.75, token_shuffle_group_size=4),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_moe_block_matches_jax(case):
    """``moe_block`` on ``[2, 24, h]`` with a skewed router: y and the
    routing equal JAX's, and every gradient (x, router, gate_up, down)."""
    jc, tc = _cfgs(router_z_loss_coef=1e-3, **BLOCKS[case])
    p, x = _params(skew=0.8), _x(48, shift=1.0).reshape(2, 24, H)
    cot = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    y, aux, (gp, gx) = _jax_block_grads(
        lambda pp, xx: j_moe.moe_block(pp, xx, jc, compute_dtype=jnp.float32), _to_j(p),
        jnp.asarray(x), cot)
    tp, tx = _to_t(p, grad=True), torch.tensor(x, requires_grad=True)
    ty, taux = t_moe.moe_block(tp, tx, tc, compute_dtype=torch.float32)
    assert np.array_equal(taux["expert_idx"].numpy(), np.asarray(aux["expert_idx"]))
    _close(taux["router_logits"].detach(), aux["router_logits"])
    _close(ty.detach(), y, RTOL, 1e-7)
    (ty * torch.tensor(cot)).sum().backward()
    _close(tx.grad, gx, GRAD_RTOL, GRAD_ATOL)
    _close(tp["router"]["w"].grad, gp["router"]["w"], GRAD_RTOL, GRAD_ATOL)
    for k in ("gate_up", "down"):
        _close(tp["experts"][k].grad, gp["experts"][k], GRAD_RTOL, GRAD_ATOL)
    if not tc.dropless:  # the capacity binds: some routes are dropped
        keep = t_moe.keep_mask(taux["expert_idx"], tc)
        assert 0 < int((~keep).sum()) < keep.numel()


def test_grouped_product_matches_the_per_token_plain_version():
    """The dropless path against every token through its top-k experts one
    by one (JAX's ``dense_reference``), with an expert that gets no row."""
    _, tc = _cfgs(dropless=True)
    p, x = _params(skew=3.0, seed=4), _x(40, seed=5, shift=2.0)
    tp = _to_t(p)
    y, (probs, idx, _) = t_moe.moe_dropless(tp, torch.tensor(x), tc,
                                            compute_dtype=torch.float32)
    want = np.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(tc.top_k):
            e = int(idx[t, j])
            g, u = np.split(x[t] @ p["experts"]["gate_up"][e], 2)
            act = (g / (1 + np.exp(-g))) * u
            want[t] += float(probs[t, j]) * (act @ p["experts"]["down"][e])
    _close(y, want, 1e-5, 1e-6)


@pytest.mark.parametrize("z", [0.0, 1e-3])
def test_router_losses_match_jax(z):
    jc, tc = _cfgs(router_z_loss_coef=z)
    logits = np.random.default_rng(6).standard_normal((40, E)).astype(np.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), 2)
    tl = torch.tensor(logits, requires_grad=True)
    ti = torch.tensor(np.asarray(idx))
    for jf, tf in ((j_moe.load_balancing_loss, t_moe.load_balancing_loss),
                   (lambda lg, i, c: j_moe.router_z_loss(lg),
                    lambda lg, i, c: t_moe.router_z_loss(lg)),
                   (j_moe.weighted_router_loss, t_moe.weighted_router_loss)):
        want, jg = jax.value_and_grad(lambda lg: jf(lg, idx, jc))(jnp.asarray(logits))
        tl.grad = None
        got = tf(tl, ti, tc)
        got.backward()
        _close(got.detach(), want)
        _close(tl.grad, jg, GRAD_RTOL, GRAD_ATOL)


def _two_ranks(rows=32):
    """Two data ranks' router logits whose routing differs (rank 1's lean
    to expert 0), and JAX's top-2 of each."""
    rng = np.random.default_rng(7)
    logits = [rng.standard_normal((rows, E)).astype(np.float32) for _ in range(2)]
    logits[1][:, 0] += 2.0
    idx = [np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(lg)), 2)[1]) for lg in logits]
    return logits, idx


def _fake_allreduce(stats: list):
    """A SUM over simulated ranks: the first pass records each rank's
    vector, the second returns their sum."""
    def record(t):
        stats.append(t.clone())
        return t

    def total(t):
        return torch.stack(stats).sum(0)

    return record, total


def test_router_loss_is_the_global_product_of_means():
    jc, tc = _cfgs(router_z_loss_coef=1e-3)
    logits, idx = _two_ranks()
    whole = np.concatenate(logits)
    want, jg = jax.value_and_grad(lambda lg: j_moe.weighted_router_loss(
        lg, jnp.asarray(np.concatenate(idx)), jc))(jnp.asarray(whole))
    stats: list = []
    record, total = _fake_allreduce(stats)
    for lg, i in zip(logits, idx):
        t_moe.router_loss_share(torch.tensor(lg), torch.tensor(i), tc, reduce=record)
    shares, grads, values = [], [], []
    for lg, i in zip(logits, idx):
        tl = torch.tensor(lg, requires_grad=True)
        share, value = t_moe.router_loss_share(tl, torch.tensor(i), tc, reduce=total)
        share.backward()
        shares.append(float(share.detach()))
        values.append(float(value))
        grads.append(tl.grad.numpy())
    _close(sum(shares), float(want))
    _close(values, [float(want)] * 2)
    _close(np.concatenate(grads), jg, GRAD_RTOL, GRAD_ATOL)
    per_rank = np.mean([float(j_moe.weighted_router_loss(jnp.asarray(lg), jnp.asarray(i), jc))
                        for lg, i in zip(logits, idx)])
    assert abs(per_rank - float(want)) > 1e-3 * abs(float(want)), (per_rank, float(want))


class _Tokens:
    """A simulated data rank of ``ranks``, whose ``gather_tokens`` hands
    back every rank's expert indices in rank order (JAX's row order)."""

    def __init__(self, rank, every):
        self.token_rank, self.token_size, self.every = rank, len(every), every

    def gather_tokens(self, idx, rows=1):
        assert torch.equal(idx, self.every[self.token_rank])
        return torch.cat(self.every)

    def own_tokens(self, full, rows=1):
        n = full.shape[0] // self.token_size
        return full[self.token_rank * n:(self.token_rank + 1) * n]


@pytest.mark.parametrize("shuffle", [0, 4])
def test_dropped_keep_follows_the_global_capacity_and_queue(shuffle):
    """dp 2 with a binding capacity (cf 0.75) and rank 1's tokens skewed to
    expert 0: each rank's output equals its rows of JAX's ``moe_block`` on
    the whole microbatch, while each rank alone would keep other routes."""
    jc, tc = _cfgs(dropless=False, capacity_factor=0.75, token_shuffle_group_size=shuffle)
    p = _params(skew=0.5)
    xs = [_x(24, seed=8), _x(24, seed=9, shift=2.0)]
    want, _ = j_moe.moe_block(_to_j(p), jnp.asarray(np.concatenate(xs))[None], jc,
                              compute_dtype=jnp.float32)
    want = np.asarray(want)[0]
    tp = _to_t(p)
    idx = [t_moe.route(tp["router"], torch.tensor(x), tc)[1] for x in xs]
    differs = 0
    for r, x in enumerate(xs):
        y, (_, i, _) = t_moe.moe_dropped(tp, torch.tensor(x), tc, compute_dtype=torch.float32,
                                         tokens=_Tokens(r, idx))
        _close(y, want[r * 24:(r + 1) * 24], RTOL, 1e-7)
        glob = t_moe.keep_mask(torch.cat(idx), tc)[r * 24:(r + 1) * 24]
        differs += int((glob != t_moe.keep_mask(i, tc)).sum())
    assert differs > 0


def test_config_and_init_match_jax():
    for block in ({}, {"num_experts": 8, "top_k": 2, "dropless": True},
                  {"dropless": False, "capacity_factor": 1.25, "router_z_loss_coef": 1e-3,
                   "token_shuffle_group_size": 8},
                  {"num_moe_experts": 4, "moe_top_k": 1, "router_type": "sinkhorn"}):
        assert dataclasses.asdict(t_moe.MoEConfig.from_config(block)) == dataclasses.asdict(
            j_moe.MoEConfig.from_config(block))
    jc, tc = _cfgs()
    jp = j_moe.init_moe_params(jax.random.PRNGKey(0), H, FFN, jc, dtype=jnp.bfloat16)
    tp = t_moe.init_moe_params(torch.Generator().manual_seed(0), H, FFN, tc,
                               dtype=torch.bfloat16)
    for path in (("router", "w"), ("experts", "gate_up"), ("experts", "down")):
        a, b = jp[path[0]][path[1]], tp[path[0]][path[1]]
        assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == str(b.dtype).split(".")[-1]
    assert abs(float(tp["experts"]["gate_up"].float().std()) - 0.02) < 0.002
    for t, n in zip(range(40, 47), range(1, 8)):
        assert np.array_equal(t_moe._shuffle_permutation(t, n).numpy(),
                              np.asarray(j_moe._shuffle_permutation(t, n)))
