"""``exp_manager.telemetry.tensorstats`` — the tensor numerics observatory
(the PyTorch port's counterpart of the JAX package's
``telemetry/tensorstats.py``: its knobs, packed vector, metric names and
``tensorstats.jsonl`` records).

Per layer-group streaming dynamic-range statistics of the gradients at the
optimizer boundary — absmax, rms, zero/subnormal fraction, and a compact
log2-exponent histogram — computed on the card inside AdamW
(``optim/adamw.py::adamw_update(tensorstats=...)``), pre- and post-clip.

- the cumulative record lives in ``opt_state["tensorstats"]`` (one packed
  fp32 vector per phase x layer-group, see :data:`CUM_HEADER`, and a
  ``steps`` counter), replicated on every rank as in JAX (the vectors are
  tiny), kept on a skipped step, and checkpointed with the optimizer state
  (``tensorstats/<phase>.<group>``);
- the pre-clip rms reuses the per-group squared sums that already give the
  clipping norm (``optim/adamw.py::grouped_sq_norms``);
- per-step scalars stream under ``tensorstats/<phase>/<group>/<stat>`` as
  0-d tensors and the cumulative vectors under
  ``tensorstats_hist/<phase>/<group>``; both reach the host in the
  boundary's one transfer (``trainer/loop.py::_fetch_window``), the
  vectors into ``tensorstats.jsonl`` (``ExpManager.log_tensorstats``) and
  the last one into ``run_summary.json``.

The gradients the optimizer sees are whole on every data rank (all-reduced,
with or without ZeRO-1), so data parallelism needs no collective here.
Under tensor parallelism a sharded leaf's slices are counted on each rank
(a kv head held by several ranks and padded vocab rows once, as the norm
counts them) and the vectors are added over the model axis, their absmax
taken as a MAX; under pipeline and expert parallelism the stage and expert
leaves' vectors are added over ``pipe`` and ``expert`` the same way.

The ``bucket`` phase (the packed ZeRO-1 bucket payloads) needs
``distributed_strategy.overlap``'s bucket plan, which the port does not
build (ROADMAP queue 1 entry 8c); without a plan JAX skips the phase, and
so does the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Optional, Sequence

import torch

#: per-step scalar metric prefix — every key under it is float-coercible and
#: rides the ordinary scalar sinks (metrics.jsonl, ring, beacons, alerts)
SCALAR_PREFIX = "tensorstats/"

#: packed cumulative-vector metric prefix — array-valued, routed AROUND the
#: scalar sinks into tensorstats.jsonl.  Deliberately NOT under
#: ``tensorstats/`` so prefix filters on the scalar stream never admit it.
HIST_PREFIX = "tensorstats_hist/"

#: slot names of the packed cumulative vector, before the histogram bins:
#: ``vec = [count, sumsq, absmax, zero, subnormal, hist_0 .. hist_{n-1}]``.
#: count/sumsq/zero/subnormal accumulate across steps; absmax is a running
#: max; hist accumulates per-bin counts of nonzero values by floor(log2|x|).
CUM_HEADER = ("count", "sumsq", "absmax", "zero", "subnormal")

#: phases a stat record can belong to
PHASES = ("pre", "post", "bucket")

_COUNT, _SUMSQ, _ABSMAX, _ZERO, _SUBNORMAL = range(len(CUM_HEADER))


def _tensorstats_knobs() -> set[str]:
    return {f.name for f in dataclasses.fields(TensorStatsConfig)}


@dataclasses.dataclass(frozen=True)
class TensorStatsConfig:
    enabled: bool = False
    pre_clip: bool = True
    post_clip: bool = True
    buckets: bool = False
    hist_lo_exp: int = -24
    hist_hi_exp: int = 8

    @property
    def nbins(self) -> int:
        return self.hist_hi_exp - self.hist_lo_exp + 1

    @property
    def vec_len(self) -> int:
        return len(CUM_HEADER) + self.nbins

    @classmethod
    def from_config(cls, block: Any) -> "TensorStatsConfig":
        """Parse (and validate) an ``exp_manager.telemetry.tensorstats``
        block: ``None`` (defaults: disabled), a bare bool, or a mapping.
        Unknown keys and out-of-range values raise ``ValueError``."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        knobs = _tensorstats_knobs()
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.telemetry.tensorstats must be a mapping of "
                f"{sorted(knobs)} (or a single bool), got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - knobs
        if unknown:
            from neuronx_distributed_training_torch.config.loader import (
                did_you_mean,
            )

            raise ValueError(
                f"unknown exp_manager.telemetry.tensorstats keys "
                f"{sorted(unknown)}; supported: {sorted(knobs)}"
                + did_you_mean(unknown, knobs)
            )
        values = dict(block)
        for key in ("enabled", "pre_clip", "post_clip", "buckets"):
            if key in values and not isinstance(values[key], bool):
                raise ValueError(
                    f"exp_manager.telemetry.tensorstats.{key} must be a "
                    f"boolean, got {values[key]!r}"
                )
        for key in ("hist_lo_exp", "hist_hi_exp"):
            v = values.get(key)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int)):
                raise ValueError(
                    f"exp_manager.telemetry.tensorstats.{key} must be an "
                    f"integer log2 exponent, got {values[key]!r}"
                )
        out = cls(
            enabled=bool(values.get("enabled", cls.enabled)),
            pre_clip=bool(values.get("pre_clip", cls.pre_clip)),
            post_clip=bool(values.get("post_clip", cls.post_clip)),
            buckets=bool(values.get("buckets", cls.buckets)),
            hist_lo_exp=int(values.get("hist_lo_exp", cls.hist_lo_exp)),
            hist_hi_exp=int(values.get("hist_hi_exp", cls.hist_hi_exp)),
        )
        if out.hist_hi_exp <= out.hist_lo_exp:
            raise ValueError(
                f"exp_manager.telemetry.tensorstats.hist_hi_exp "
                f"({out.hist_hi_exp}) must be > hist_lo_exp "
                f"({out.hist_lo_exp})"
            )
        if out.nbins > 256:
            raise ValueError(
                f"exp_manager.telemetry.tensorstats histogram spans "
                f"{out.nbins} bins ({out.hist_lo_exp}..{out.hist_hi_exp}); "
                f"cap is 256 — the point is a COMPACT record"
            )
        if out.enabled and not (out.pre_clip or out.post_clip or out.buckets):
            raise ValueError(
                "exp_manager.telemetry.tensorstats is enabled but every "
                "phase (pre_clip/post_clip/buckets) is off — nothing to "
                "record; disable it instead"
            )
        return out

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# state layout (opt_state["tensorstats"])
# ---------------------------------------------------------------------------


def state_key(phase: str, group: str) -> str:
    """State-dict key for one phase x layer-group cumulative vector.  Group
    names carry ``/`` (``layers/attn``) which checkpoint path-naming must not
    see — state keys use ``.`` (``pre.layers.attn``); metric keys keep the
    ``/`` spelling."""
    return f"{phase}.{group.replace('/', '.')}"


def split_state_key(key: str) -> tuple[str, str]:
    """Inverse of :func:`state_key` -> ``(phase, group)`` with ``/`` groups."""
    phase, _, rest = key.partition(".")
    return phase, rest.replace(".", "/")


def param_groups(names, group_fn: Optional[Callable] = None) -> tuple[str, ...]:
    """Sorted layer-group names of the leaves ``names`` under ``group_fn``
    (default: ``telemetry/health.py::grad_group_of``)."""
    if group_fn is None:
        from neuronx_distributed_training_torch.telemetry.health import grad_group_of

        group_fn = grad_group_of
    return tuple(sorted({group_fn(n) for n in names}))


def state_keys(cfg: TensorStatsConfig, groups: Sequence[str],
               bucket_groups: Sequence[str] = ()) -> tuple[str, ...]:
    keys: list[str] = []
    if cfg.pre_clip:
        keys += [state_key("pre", g) for g in groups]
    if cfg.post_clip:
        keys += [state_key("post", g) for g in groups]
    if cfg.buckets:
        keys += [state_key("bucket", g) for g in bucket_groups]
    return tuple(keys)


def init_tensorstats_state(cfg: TensorStatsConfig, names=(), *,
                           groups: Optional[Sequence[str]] = None,
                           bucket_groups: Sequence[str] = (), device=None) -> dict:
    """Fresh cumulative state: a zero packed vector per phase x group plus a
    ``steps`` counter (a 0-d int64 tensor, as the port's other counters)."""
    if groups is None:
        groups = param_groups(names)
    state: dict[str, Any] = {"steps": torch.zeros((), dtype=torch.int64, device=device)}
    for k in state_keys(cfg, groups, bucket_groups):
        state[k] = torch.zeros((cfg.vec_len,), dtype=torch.float32, device=device)
    return state


# ---------------------------------------------------------------------------
# statistics on the card (called from optim/adamw.py::adamw_update)
# ---------------------------------------------------------------------------


#: the exponent codes of one pass: a nonzero |x| is floor(log2 |x|) in
#: [-149, 128] (+inf 129), a zero -151 (log2's -inf), NaN outside the range
_ZERO_CODE, _TOP_CODE, _NAN_CODE = -151.0, 129.0, -1000.0
#: histc bins over the codes, one unit-wide bin a code from -151 to 130
_CODE_BINS, _CODE_MIN = 282, -151.5
#: elements a histc call counts at once: 2^24, so its fp32 counters stay
#: exact integers (the chunks' counts add in float64)
HIST_CHUNK = 1 << 24


def exponent_counts(ax: torch.Tensor) -> torch.Tensor:
    """float64 counts of ``|x|``'s exponent codes: index 0 the zeros, index
    ``i >= 1`` the nonzero values with ``floor(log2 |x|) == i - 151`` (+inf
    at 129); NaN is not counted.  One ``histc`` a chunk over bounds given
    (``bincount`` would read its length back from the card)."""
    codes = torch.nan_to_num(torch.floor(torch.log2(ax)), nan=_NAN_CODE, posinf=_TOP_CODE,
                             neginf=_ZERO_CODE).reshape(-1)
    out = torch.zeros(_CODE_BINS, dtype=torch.float64, device=ax.device)
    for part in codes.split(HIST_CHUNK):
        out += torch.histc(part, bins=_CODE_BINS, min=_CODE_MIN,
                           max=_CODE_MIN + _CODE_BINS).to(torch.float64)
    return out


def leaf_stats_vec(x: torch.Tensor, cfg: TensorStatsConfig, *,
                   sumsq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This-step packed stats vector of ONE tensor (see :data:`CUM_HEADER`).

    Non-finite values: NaN joins neither the zero count nor the histogram
    (``|x| > 0`` is False for NaN) but poisons absmax/sumsq — honest for the
    per-step trajectory; the cumulative merge sanitizes (:func:`merge_cum`).
    +/-inf lands in the top histogram bin.  Subnormal means
    ``0 < |x| < finfo(float32).tiny``, an exponent below -126.  The zero
    and subnormal counts and the histogram come from one pass of exponent
    codes (:func:`exponent_counts`); ``sumsq``, when the caller has it (the
    clipping norm's), is used instead of a pass of its own."""
    x = x.float()
    n = x.numel()
    ax = torch.abs(x)
    absmax = torch.amax(ax) if n else torch.zeros((), device=x.device)
    if sumsq is None:
        flat = x.reshape(-1)
        sumsq = torch.dot(flat, flat) if n else torch.zeros((), device=x.device)
    counts = exponent_counts(ax)
    expo = counts[1:]  # expo[i]: exponent i - 150
    lo, hi = cfg.hist_lo_exp + 150, cfg.hist_hi_exp + 150
    hist = torch.cat([expo[:lo + 1].sum().reshape(1), expo[lo + 1:hi],
                      expo[hi:].sum().reshape(1)])
    head = torch.stack([torch.full((), float(n), dtype=torch.float64, device=x.device),
                        sumsq.to(torch.float64), absmax.to(torch.float64), counts[0],
                        expo[:24].sum()])
    return torch.cat([head, hist]).to(torch.float32)


def merge_step_vecs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two this-step vectors (sum slots add, absmax slot maxes)."""
    s = a + b
    s[_ABSMAX] = torch.maximum(a[_ABSMAX], b[_ABSMAX])
    return s


def _reduce(vecs: torch.Tensor, group) -> torch.Tensor:
    """``[n, L]`` this-step vectors added over ``group``, the absmax slot
    taken as a MAX (two all-reduces)."""
    import torch.distributed as dist

    summed = vecs.clone()
    summed[:, _ABSMAX] = 0
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    top = vecs[:, _ABSMAX].contiguous()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    summed[:, _ABSMAX] = top
    return summed


def _leaf_vec(t: torch.Tensor, layout, tp, cfg: TensorStatsConfig,
              sumsq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The vector of what a rank's slice ``t`` adds to its global leaf: its
    owned views when the layout replicates kv heads or pads vocab rows
    (``parallel/sharding.py::owned_views``, the norm's rule)."""
    if layout is None or tp is None or not layout.uneven(tp.size):
        return leaf_stats_vec(t, cfg, sumsq=sumsq)
    from neuronx_distributed_training_torch.parallel.sharding import owned_views

    vec = None
    for v in owned_views(t, layout, tp.rank, tp.size):
        s = leaf_stats_vec(v, cfg, sumsq=sumsq)
        vec = s if vec is None else merge_step_vecs(vec, s)
    if vec is None:
        vec = torch.zeros((cfg.vec_len,), dtype=torch.float32, device=t.device)
    return vec


def group_step_vectors(tensors: Mapping[str, torch.Tensor], group_fn: Callable,
                       cfg: TensorStatsConfig, *,
                       group_sq: Optional[Mapping[str, torch.Tensor]] = None,
                       tp=None, sharded=frozenset(), pp=None, ep=None) -> dict:
    """Per layer-group this-step vectors over a rank's gradient leaves
    (``{name: tensor}``), as ``optim/adamw.py::grouped_sq_norms`` groups and
    reduces them: the tp-sharded leaves (``sharded``: names, or a dict of
    their layouts) added over the model axis and the replicated ones
    counted once, the expert leaves added over ``expert`` and the stage
    leaves over ``pipe``.  ``group_sq`` — the per-group squared sums the
    clipping norm already computed — replaces the sumsq slot."""
    from neuronx_distributed_training_torch.parallel.pipeline import is_stage_leaf
    from neuronx_distributed_training_torch.parallel.tensor_parallel import active

    on = active(tp)
    pipe = pp is not None and pp.size > 1
    layouts = sharded if isinstance(sharded, dict) else {}
    experts = ep is not None and ep.size > 1
    parts: dict[tuple, list] = {}
    # with group_sq the sumsq slot is replaced below: no pass of its own
    skip = None if group_sq is None else next(iter(tensors.values())).new_zeros(
        (), dtype=torch.float32)
    for n, t in tensors.items():
        key = (group_fn(n), pipe and is_stage_leaf(n))
        acc = parts.setdefault(key, [None, None, None])
        lay = layouts.get(n)
        i = 2 if experts and lay is not None and lay.expert else 0 if on and n in sharded else 1
        v = (_leaf_vec(t, lay, tp, cfg, skip) if i != 1
             else leaf_stats_vec(t, cfg, sumsq=skip))
        acc[i] = v if acc[i] is None else merge_step_vecs(acc[i], v)
    zero = next(iter(tensors.values())).new_zeros((cfg.vec_len,), dtype=torch.float32)
    keys = list(parts)
    if experts and any(parts[k][2] is not None for k in keys):
        red = _reduce(torch.stack([zero if parts[k][2] is None else parts[k][2] for k in keys]),
                      ep.group)
        for k, v in zip(keys, red):
            acc = parts[k]
            i = 0 if on else 1
            acc[i] = v if acc[i] is None else merge_step_vecs(acc[i], v)
    if on:
        red = _reduce(torch.stack([zero if parts[k][0] is None else parts[k][0] for k in keys]),
                      tp.group)
        vecs = {k: red[j] if parts[k][1] is None else merge_step_vecs(red[j], parts[k][1])
                for j, k in enumerate(keys)}
    else:
        vecs = {k: parts[k][1] for k in keys}
    if pipe:
        owned = sorted(k for k in vecs if k[1])
        if owned:
            for k, v in zip(owned, _reduce(torch.stack([vecs[k] for k in owned]), pp.group)):
                vecs[k] = v
    out: dict[str, torch.Tensor] = {}
    for (g, _), v in vecs.items():
        out[g] = v if g not in out else merge_step_vecs(out[g], v)
    if group_sq is not None:
        for g, sq in group_sq.items():
            if g in out:
                out[g] = out[g].clone()
                out[g][_SUMSQ] = sq
    return out


def merge_cum(cum: torch.Tensor, step_vec: torch.Tensor) -> torch.Tensor:
    """Fold one this-step vector into the cumulative record.  Non-finite
    step contributions are dropped (a single NaN step must not poison the
    whole run's distribution — the per-step scalars still show it)."""
    safe = torch.where(torch.isfinite(step_vec), step_vec, torch.zeros_like(step_vec))
    new = cum + safe
    new[_ABSMAX] = torch.maximum(cum[_ABSMAX], safe[_ABSMAX])
    return new


def step_scalar_metrics(phase: str, group: str, vec: torch.Tensor) -> dict:
    """Per-step float-coercible metrics (0-d tensors) of one this-step
    vector."""
    n = torch.clamp(vec[_COUNT], min=1.0)
    base = f"{SCALAR_PREFIX}{phase}/{group}"
    return {
        f"{base}/absmax": vec[_ABSMAX],
        f"{base}/rms": torch.sqrt(vec[_SUMSQ] / n),
        f"{base}/zero_frac": vec[_ZERO] / n,
        f"{base}/subnormal_frac": vec[_SUBNORMAL] / n,
    }


def tensorstats_update(prev_state: Mapping[str, torch.Tensor], cfg: TensorStatsConfig, *,
                       pre: Optional[Mapping[str, torch.Tensor]] = None,
                       post: Optional[Mapping[str, torch.Tensor]] = None) -> tuple[dict, dict]:
    """One step of the observatory from this step's per-group vectors
    (:func:`group_step_vectors` of the pre- and post-clip gradients).

    Returns ``(new_state, metrics)``: the updated cumulative state (same
    keys as ``prev_state``, new tensors) and the boundary metrics — per-step
    scalars under :data:`SCALAR_PREFIX` plus the cumulative packed vectors
    under :data:`HIST_PREFIX`."""
    new_state = dict(prev_state)
    new_state["steps"] = prev_state["steps"] + 1
    metrics: dict[str, Any] = {}

    def fold(phase: str, vectors: Mapping[str, torch.Tensor]) -> None:
        for g, sv in vectors.items():
            key = state_key(phase, g)
            if key not in prev_state:
                raise KeyError(
                    f"tensorstats state has no slot {key!r} — init_opt_state "
                    f"and adamw_update disagree on the layer groups"
                )
            cum = merge_cum(prev_state[key], sv)
            new_state[key] = cum
            metrics.update(step_scalar_metrics(phase, g, sv))
            metrics[f"{HIST_PREFIX}{phase}/{g}"] = cum

    if cfg.pre_clip and pre is not None:
        fold("pre", pre)
    if cfg.post_clip and post is not None:
        fold("post", post)
    return new_state, metrics


# ---------------------------------------------------------------------------
# host-side decode (boundary fetch -> tensorstats.jsonl / run_summary)
# ---------------------------------------------------------------------------


def decode_cum(vec: Any, cfg_or_lo: Any) -> dict:
    """Decode one fetched packed cumulative vector into the JSON record the
    ``tensorstats.jsonl`` stream and ``run_summary.json`` carry.  Accepts a
    :class:`TensorStatsConfig` or a bare ``hist_lo_exp`` int (the histogram
    length is self-describing).  Stdlib-only — numpy arrays arrive as any
    float-indexable sequence."""
    vals = [float(v) for v in vec]
    head = vals[:len(CUM_HEADER)]
    hist = vals[len(CUM_HEADER):]
    lo = (cfg_or_lo.hist_lo_exp if hasattr(cfg_or_lo, "hist_lo_exp")
          else int(cfg_or_lo))
    count = head[_COUNT]
    rec = {
        "count": count,
        "sumsq": head[_SUMSQ],
        "absmax": head[_ABSMAX],
        "zero": head[_ZERO],
        "subnormal": head[_SUBNORMAL],
        "rms": math.sqrt(head[_SUMSQ] / count) if count > 0 else 0.0,
        "zero_frac": head[_ZERO] / count if count > 0 else 0.0,
        "subnormal_frac": head[_SUBNORMAL] / count if count > 0 else 0.0,
        "hist_lo_exp": lo,
        "hist_hi_exp": lo + len(hist) - 1,
        "hist": [int(h) for h in hist],
    }
    return rec
