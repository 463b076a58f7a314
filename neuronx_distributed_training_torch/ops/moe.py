"""Mixture-of-Experts: routers, expert compute (dropped and dropless), the
router losses (counterpart of the JAX package's ``ops/moe.py``).

Plain functions on tensors:

- **router** (:func:`route`): top-k softmax routing (Mixtral) or sinkhorn
  (Megatron top-1), always in fp32; ties go to the lower expert index, as
  ``lax.top_k``'s do (a stable descending sort);
- **dropless** (:func:`moe_dropless`): the ``T*k`` (token, slot) rows sorted
  by expert (a stable sort, as ``jnp.argsort``), then one product per expert
  over its rows (:func:`grouped_swiglu`, the counterpart of
  ``lax.ragged_dot``).  The group sizes are read on the host once a layer
  (``tolist``): one device sync a MoE layer.  The combine inverts the sort
  and adds each token's ``k`` weighted rows in slot order, JAX's
  ``.at[token_of].add`` onto zeros with the same terms; there is no
  ``index_add_``, whose CUDA atomics would make the step nondeterministic;
- **dropped** (:func:`moe_dropped`, capacity factor): ``cap = round(cf T k
  / E)`` and each (token, slot)'s place in its expert's queue, a cumsum in
  token order (after ``token_shuffle_group_size``'s stride permutation,
  :func:`_shuffle_permutation`), decide which routes are kept
  (:func:`keep_mask`).  A token's output depends only on which of its
  routes are kept, each expert MLP being row-wise, so the kept rows go
  through :func:`grouped_swiglu` as the dropless ones do and the dropped
  ones add nothing: JAX's ``[T, E, cap]`` dispatch and combine einsums,
  without the empty slots;
- **losses**: the Switch / Mixtral load-balancing loss and the ST-MoE
  z-loss (:func:`weighted_router_loss`), and :func:`router_loss_share`,
  the same loss over tokens that several ranks hold.

Under data (and expert, and context) parallelism the JAX package computes
all of this on the whole microbatch in one program.  Here each rank holds
its rows, so the two quantities that are global there are made global
here: the router loss is a product of means over every token of the
microbatch (:func:`router_loss_share` all-reduces the per-expert counts and
sums first), and the dropped path's capacity and queue order are those of
the whole microbatch (``tokens``, a ``parallel/mesh.py::ExpertParallel``,
gathers the small ``[T_local, k]`` expert indices over the data ranks, and
under cp the context ranks, in JAX's token order, and every rank computes
the same keep mask).

SwiGLU experts: ``gate_up [E, h, 2 ffn]`` (``[gate | up]``), ``down [E,
ffn, h]``.  Under tensor parallelism a rank holds ``[gate_r | up_r]`` and
``down``'s rows ``r`` (``parallel/sharding.py``); under expert parallelism
``E / ep`` experts, which ``models/mixtral.py`` gathers over the expert axis
before calling these functions (:func:`gather_experts`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The ``model.moe`` block (JAX's ``MoEConfig``, same defaults)."""

    num_experts: int = 8
    top_k: int = 2
    capacity_factor: Optional[float] = None  # None/0 -> dropless
    dropless: bool = True
    router_type: str = "top_k"  # "top_k" | "sinkhorn"
    router_aux_loss_coef: float = 0.02
    router_z_loss_coef: float = 0.0
    normalize_top_k_affinities: bool = True
    sinkhorn_iterations: int = 8
    token_shuffle_group_size: int = 0  # dropped path only

    @classmethod
    def from_config(cls, moe_cfg: dict[str, Any]) -> "MoEConfig":
        m = dict(moe_cfg or {})
        cap = m.get("capacity_factor")
        dropless = bool(m.get("dropless", not cap))
        return cls(
            num_experts=int(m.get("num_experts", m.get("num_moe_experts", 8))),
            top_k=int(m.get("top_k", m.get("moe_top_k", 2))),
            capacity_factor=None if dropless else float(cap or 1.0),
            dropless=dropless,
            router_type=str(m.get("router_type", "top_k")),
            router_aux_loss_coef=float(m.get("router_aux_loss_coef", 0.02)),
            router_z_loss_coef=float(m.get("router_z_loss_coef", 0.0)),
            normalize_top_k_affinities=bool(m.get("normalize_top_k_affinities", True)),
            token_shuffle_group_size=int(m.get("token_shuffle_group_size", 0) or 0),
        )


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_moe_params(gen: torch.Generator, hidden: int, ffn: int, cfg: MoEConfig, *,
                    dtype=torch.float32, stddev: float = 0.02, device=None, cut=None):
    """Router (fp32) and fused SwiGLU expert weights, expert-major, drawn
    from ``gen`` in that order (normal times ``stddev``, as JAX's).
    ``cut(name, tensor)`` (``router.w``, ``experts.gate_up``,
    ``experts.down``) keeps a rank's slice of each whole draw."""
    cut = cut or (lambda name, t: t)
    e = cfg.num_experts

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * stddev

    router = cut("router.w", normal((hidden, e)))
    gate_up = cut("experts.gate_up", normal((e, hidden, 2 * ffn)).to(dtype))
    down = cut("experts.down", normal((e, ffn, hidden)).to(dtype))
    return {"router": {"w": router}, "experts": {"gate_up": gate_up, "down": down}}


def is_moe_mlp(mlp: dict) -> bool:
    """Is this layer's ``mlp`` dict a MoE block (router + experts)?"""
    return "router" in mlp


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def top_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries of the last dim,
    ties to the lower index (``lax.top_k``'s rule)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _sinkhorn(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Sinkhorn normalisation of router logits (Megatron's balanced top-1)."""
    cost = torch.exp(cost)
    d0 = torch.ones(cost.shape[:-1] + (1,), dtype=cost.dtype, device=cost.device)
    d1 = torch.ones(cost.shape[-1:], dtype=cost.dtype, device=cost.device)
    eps = 1e-8
    for _ in range(n_iters):
        d0 = 1.0 / (torch.sum(d1 * cost, dim=-1, keepdim=True) + eps)
        d1 = 1.0 / (torch.sum(d0 * cost, dim=-2, keepdim=True).squeeze(-2) / cost.shape[-2]
                    + eps)
    return d0 * cost * d1


def route(router: dict, x: torch.Tensor, cfg: MoEConfig):
    """``x [T, h]`` -> ``(probs [T, k], idx [T, k], logits [T, E])``, fp32."""
    logits = x.float() @ router["w"].float()
    if cfg.router_type == "sinkhorn":
        # balanced assignment selects; the gate values are the plain softmax's
        _, idx = top_k(_sinkhorn(logits, cfg.sinkhorn_iterations), cfg.top_k)
        probs = torch.gather(torch.softmax(logits, dim=-1), -1, idx)
    else:
        probs, idx = top_k(torch.softmax(logits, dim=-1), cfg.top_k)
    if cfg.normalize_top_k_affinities and cfg.top_k > 1:
        probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    return probs, idx, logits


def _expert_counts(idx: torch.Tensor, e: int) -> torch.Tensor:
    """fp32 ``[E]``: how many (token, slot) routes each expert got."""
    return torch.bincount(idx.reshape(-1), minlength=e).float()


def load_balancing_loss(router_logits: torch.Tensor, idx: torch.Tensor,
                        cfg: MoEConfig) -> torch.Tensor:
    """``E * sum_e(frac_tokens_e * frac_probs_e) / k``, unweighted."""
    e = cfg.num_experts
    probs = torch.softmax(router_logits.float(), dim=-1)
    frac_tokens = _expert_counts(idx, e) / idx.shape[0]
    frac_probs = torch.mean(probs, dim=0)
    return e * torch.sum(frac_tokens * frac_probs) / max(cfg.top_k, 1)


def router_z_loss(router_logits: torch.Tensor) -> torch.Tensor:
    """``mean(logsumexp(logits)^2)``."""
    z = torch.logsumexp(router_logits.float(), dim=-1)
    return torch.mean(z ** 2)


def weighted_router_loss(router_logits: torch.Tensor, idx: torch.Tensor,
                         cfg: MoEConfig) -> torch.Tensor:
    """``aux_coef * load_balancing + z_coef * z`` of one layer."""
    loss = cfg.router_aux_loss_coef * load_balancing_loss(router_logits, idx, cfg)
    if cfg.router_z_loss_coef > 0:
        loss = loss + cfg.router_z_loss_coef * router_z_loss(router_logits)
    return loss


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward multiplies the gradient by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def router_loss_share(router_logits: torch.Tensor, idx: torch.Tensor, cfg: MoEConfig, *,
                      reduce=None, grad_scale: float = 1.0) -> tuple:
    """``(share, value)`` of one layer's :func:`weighted_router_loss` over
    tokens that the ranks of a group hold between them.  ``reduce(t)`` SUMs
    a tensor in place over those ranks (None: this rank holds them all, and
    both are the plain loss).  ``value`` is the loss of every token of the
    group, detached; ``share`` is this rank's part of it: summed over the
    ranks it gives the loss, and its gradient reaches this rank's logits as
    the whole loss's does.  The load-balancing term is a product of two
    means over all the tokens, so the per-expert counts (no gradient) and
    the token count are summed first, and the share is ``E / k * sum_e
    frac_tokens_e * probsum_e / T`` with this rank's ``probsum``; a mean of
    per-rank losses would be another number.  ``grad_scale`` scales the
    share's gradient alone (the tensor-parallel ranks that each compute the
    same share give ``1 / tp`` each)."""
    if grad_scale != 1.0:
        router_logits = _ScaleGrad.apply(router_logits, grad_scale)
    if reduce is None:
        loss = weighted_router_loss(router_logits, idx, cfg)
        return loss, loss.detach()
    e, k = cfg.num_experts, max(cfg.top_k, 1)
    logits = router_logits.float()
    probs = torch.softmax(logits, dim=-1)
    psum = torch.sum(probs, dim=0)
    z = None
    parts = [_expert_counts(idx, e), psum.detach(),
             torch.full((1,), float(idx.shape[0]), device=logits.device)]
    if cfg.router_z_loss_coef > 0:
        z = torch.sum(torch.logsumexp(logits, dim=-1) ** 2)
        parts.append(z.detach().reshape(1))
    stats = reduce(torch.cat(parts))
    counts, psum_all, total = stats[:e], stats[e:2 * e], stats[2 * e]
    frac_tokens = counts / total
    share = cfg.router_aux_loss_coef * (e * torch.sum(frac_tokens * (psum / total)) / k)
    value = cfg.router_aux_loss_coef * (e * torch.sum(frac_tokens * (psum_all / total)) / k)
    if z is not None:
        share = share + cfg.router_z_loss_coef * (z / total)
        value = value + cfg.router_z_loss_coef * (stats[2 * e + 1] / total)
    return share, value.detach()


# ---------------------------------------------------------------------------
# expert compute
# ---------------------------------------------------------------------------


class _GatherExperts(torch.autograd.Function):
    """The expert axis's weight gather: forward an all-gather along the
    expert dim (``[E/ep, ...] -> [E, ...]``), backward a reduce-scatter
    SUM, so each rank's slice gets every rank's gradient of it."""

    @staticmethod
    def forward(ctx, w, ep):
        import torch.distributed as dist

        ctx.ep = ep
        w = w.contiguous()
        out = torch.empty((ep.size * w.shape[0],) + tuple(w.shape[1:]), dtype=w.dtype,
                          device=w.device)
        dist.all_gather_into_tensor(out, w, group=ep.group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous()
        out = torch.empty((g.shape[0] // ctx.ep.size,) + tuple(g.shape[1:]), dtype=g.dtype,
                          device=g.device)
        dist.reduce_scatter_tensor(out, g, group=ctx.ep.group)
        return out, None


def gather_experts(experts: dict, ep) -> dict:
    """Every expert's weights from each rank's ``E / ep`` (``ep`` a
    ``parallel/mesh.py::ExpertParallel``; the dict itself at ep 1), JAX's
    weight-gather EP (``ops/moe.py`` constrains the weights to
    ``P(None, None, "model")`` for the compute): one all-gather a leaf and
    MoE layer, whose backward reduce-scatters the gradients."""
    if ep is None or ep.size == 1:
        return experts
    return {k: _GatherExperts.apply(v, ep) for k, v in experts.items()}


def _swiglu_rows(rows: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor):
    gate, up = torch.chunk(rows @ gate_up, 2, dim=-1)
    return (F.silu(gate) * up) @ down


def grouped_swiglu(xs: torch.Tensor, sizes: list, experts: dict) -> torch.Tensor:
    """``xs [n, h]`` sorted by expert, ``sizes[e]`` rows each (host ints)
    -> ``[n, h]``: each expert's SwiGLU on its rows, one product per expert
    (``lax.ragged_dot``'s counterpart).  The stacks are unbound once, so
    the backward stacks the experts' weight gradients in one tensor (an
    index per expert would write a whole-stack gradient per expert)."""
    gus, dns = experts["gate_up"].unbind(0), experts["down"].unbind(0)
    outs = [_swiglu_rows(rows, gu, dn)
            for rows, gu, dn in zip(torch.split(xs, sizes, dim=0), gus, dns)]
    return torch.cat(outs, dim=0)


def _sorted_rows(flat_expert: torch.Tensor, n_groups: int):
    """``(order, sizes, position)`` of the (token, slot) rows sorted by
    expert, stably: ``sizes`` the host counts of the first ``n_groups``
    experts, ``position[i]`` the sorted place of row ``i``."""
    order = torch.argsort(flat_expert, stable=True)
    sizes = torch.bincount(flat_expert, minlength=n_groups)[:n_groups].tolist()  # host sync
    position = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    return order, sizes, position


def moe_dropless(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                 compute_dtype=torch.bfloat16):
    """``x [T, h]`` -> ``(y [T, h], (probs, idx, logits))``: every route
    computed, one product per expert over its sorted rows."""
    t, h = x.shape
    e, k = cfg.num_experts, cfg.top_k
    probs, idx, logits = route(params["router"], x, cfg)
    flat = idx.reshape(-1)
    order, sizes, position = _sorted_rows(flat, e)
    xs = x.to(compute_dtype)[order // k]
    experts = {n: w.to(compute_dtype) for n, w in params["experts"].items()}
    ys = grouped_swiglu(xs, sizes, experts)
    w = probs.reshape(-1)[order].to(compute_dtype)
    rows = (ys * w[:, None])[position].reshape(t, k, h)
    y = rows[:, 0]
    for j in range(1, k):  # slot order: JAX's adds onto zeros, term by term
        y = y + rows[:, j]
    return y.to(x.dtype), (probs, idx, logits)


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Each expert's queue length over ``tokens`` tokens (the global count)."""
    return int(max(1, round((cfg.capacity_factor or 1.0) * tokens * cfg.top_k
                            / cfg.num_experts)))


def _shuffle_permutation(t: int, group: int) -> torch.Tensor:
    """JAX's deterministic stride permutation of ``t`` tokens: the token
    stream read as ``[t/g, g]`` column-major, ``g`` the largest divisor of
    ``t`` at most ``group``."""
    g = max(1, min(group, t))
    while t % g:
        g -= 1
    return torch.arange(t).reshape(t // g, g).T.reshape(-1)


def keep_mask(idx: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """``idx [T, k]`` (every token of the microbatch, in order) -> bool
    ``[T, k]``: the routes within their expert's capacity, queue positions
    counted in (token, slot) order, after the stride shuffle under
    ``token_shuffle_group_size``."""
    t, k = idx.shape
    cap = capacity(cfg, t)
    perm = None
    if (cfg.token_shuffle_group_size or 0) > 1:
        perm = _shuffle_permutation(t, int(cfg.token_shuffle_group_size)).to(idx.device)
        idx = idx[perm]
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, cfg.num_experts)
    pos = torch.gather(torch.cumsum(onehot, dim=0), 1, flat[:, None]).squeeze(1) - 1
    keep = (pos < cap).reshape(t, k)
    if perm is not None:
        keep = torch.empty_like(keep).index_copy_(0, perm, keep)
    return keep


def moe_dropped(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                compute_dtype=torch.bfloat16, tokens=None, rows: int = 1):
    """Capacity-factor MoE: ``x [T, h]`` (``rows`` rows of ``T / rows``
    positions, row after row) -> ``(y, (probs, idx, logits))``, a route
    over its expert's capacity adding nothing.  ``tokens`` (a
    ``parallel/mesh.py::ExpertParallel``, or None when ``x`` is the whole
    microbatch) gathers every rank's expert indices in JAX's token order
    (the data ranks' rows, and under cp each row's context chunks), so the
    capacity and the queues are the whole microbatch's; every rank computes
    the same keep mask and takes its own tokens' part of it."""
    t, h = x.shape
    e, k = cfg.num_experts, cfg.top_k
    probs, idx, logits = route(params["router"], x, cfg)
    if tokens is None or tokens.token_size == 1:
        keep = keep_mask(idx, cfg)
    else:
        keep = tokens.own_tokens(keep_mask(tokens.gather_tokens(idx, rows), cfg), rows)
    flat = torch.where(keep, idx, torch.full_like(idx, e)).reshape(-1)  # dropped: group E
    order, sizes, position = _sorted_rows(flat, e)
    kept = sum(sizes)
    xs = x.to(compute_dtype)[order[:kept] // k]
    experts = {n: w.to(compute_dtype) for n, w in params["experts"].items()}
    ys = grouped_swiglu(xs, sizes, experts)
    ys = torch.cat([ys, ys.new_zeros((1, h))])  # the dropped routes' row
    rows = ys[torch.clamp(position, max=kept)].reshape(t, k, h).float()
    w = (probs * keep).to(compute_dtype).float()
    y = rows[:, 0] * w[:, 0, None]
    for j in range(1, k):  # JAX's combine einsum: fp32 terms, one rounding
        y = y + rows[:, j] * w[:, j, None]
    return y.to(compute_dtype).to(x.dtype), (probs, idx, logits)


def moe_block(params: dict, x: torch.Tensor, cfg: MoEConfig, *, compute_dtype=torch.bfloat16,
              tokens=None):
    """``x [b, s, h]`` through the dropped or the dropless path ->
    ``(y [b, s, h], {"router_logits": [b s, E], "expert_idx": [b s, k]})``
    (the stride shuffle of the dropped path lives in :func:`keep_mask`:
    only the queue order depends on it)."""
    b, s, h = x.shape
    flat = x.reshape(b * s, h)
    if cfg.dropless:
        y, (_, idx, logits) = moe_dropless(params, flat, cfg, compute_dtype=compute_dtype)
    else:
        y, (_, idx, logits) = moe_dropped(params, flat, cfg, compute_dtype=compute_dtype,
                                          tokens=tokens, rows=b)
    return y.reshape(b, s, h), {"router_logits": logits, "expert_idx": idx}
