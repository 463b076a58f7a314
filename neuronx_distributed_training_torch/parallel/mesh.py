"""The device mesh (counterpart of the JAX package's ``parallel/mesh.py``).

The JAX package keeps one ``jax.sharding.Mesh`` whose named axes are the
parallel groups; here the same axes name a ``torch.distributed``
``DeviceMesh`` over the processes of the group, one card (or CPU process)
each, outermost first:

    (pipe, data, expert, context, model)

``world = dp * cp * tp * pp`` and ``dp = world / (tp * pp * cp)`` as in the
reference, and ``ep`` must divide it.  ``model`` is innermost, so a tp group
is consecutive ranks (on one host), and a context group strides over tp.
The port runs data, expert, context, tensor (with Megatron sequence
parallelism) and pipeline parallelism (with the virtual pipeline).

:class:`DataParallel` is what the train step and the optimizer need of the
true data-parallel axis, JAX's ``DATA_AXES``: ``data`` alone at ep 1, the
compound ``(data, expert)`` at ep > 1 (rank ``data * ep + expert``, JAX's
row order: data-major, then expert): the rank, the size, its process group,
the 1-D mesh of the axis, and the two collectives they run.
:class:`ExpertParallel` is the ``expert`` axis: the MoE weight gather
(``ops/moe.py::gather_experts``), the ``data`` axis alone (the expert
leaves' ZeRO-1 and, over ``(data[, context])``, their gradient sum: the
gather's backward has already summed them over ``expert``), and the groups
over which the tokens of a microbatch are split (the router statistics and
the dropped path's keep mask).  :class:`TensorParallel` is the
same of the ``model`` axis, plus the sequence-parallel switch and the 2-D
``(data, model)`` mesh that sharded state lives on as DTensors (ZeRO-1
moments, and every leaf as a checkpoint writes it).  :class:`ContextParallel`
is the ``context`` axis: the ring's neighbours and the collectives the
context-parallel attention runs (``parallel/ring_attention.py``,
``parallel/ulysses.py``; Ulysses's key-mask all-gather is
``parallel/tensor_parallel.py::gather_seq`` over its group), and the
``(data, context)`` group over which the train step sums gradients and the
loss.  Parameters and optimizer state are replicated over ``context``:
ZeRO-1 shards over ``data`` alone.  :class:`PipelineParallel` is the
``pipe`` axis: the rank's stage, the world ranks of its previous and next
stages, the stage hops (batched ``isend`` / ``irecv``, NCCL on cards) and the
sum over the stages (``parallel/pipeline.py``).  Every other axis's groups
lie within one stage, so ZeRO-1 shards over the ``data`` ranks of a stage.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

#: canonical mesh axis names, outermost first
AXES = ("pipe", "data", "expert", "context", "model")

#: the compound axis the global batch is split over (true data parallelism)
DATA_AXES = ("data", "expert")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallel degrees, from the ``distributed_strategy`` block."""

    tensor_model_parallel_size: int = 1
    pipeline_model_parallel_size: int = 1
    virtual_pipeline_model_parallel_size: int = 1
    context_parallel_size: int = 1
    expert_model_parallel_size: int = 1
    sequence_parallel: bool = False

    @classmethod
    def from_config(cls, cfg: dict[str, Any]) -> "MeshConfig":
        """Build from a ``distributed_strategy`` mapping (unknown keys ignored)."""
        ds = dict(cfg or {})
        vp = ds.get("virtual_pipeline_model_parallel_size")
        return cls(
            tensor_model_parallel_size=int(ds.get("tensor_model_parallel_size", 1)),
            pipeline_model_parallel_size=int(ds.get("pipeline_model_parallel_size", 1)),
            virtual_pipeline_model_parallel_size=int(vp) if vp else 1,
            context_parallel_size=int(ds.get("context_parallel_size", 1)),
            expert_model_parallel_size=int(ds.get("expert_model_parallel_size", 1)),
            sequence_parallel=bool(ds.get("sequence_parallel", False)),
        )

    @property
    def tp(self) -> int:
        return self.tensor_model_parallel_size

    @property
    def pp(self) -> int:
        return self.pipeline_model_parallel_size

    @property
    def cp(self) -> int:
        return self.context_parallel_size

    @property
    def ep(self) -> int:
        return self.expert_model_parallel_size

    def validate(self, n_devices: int) -> None:
        for name, v in (
            ("tensor_model_parallel_size", self.tp),
            ("pipeline_model_parallel_size", self.pp),
            ("context_parallel_size", self.cp),
            ("expert_model_parallel_size", self.ep),
            ("virtual_pipeline_model_parallel_size", self.virtual_pipeline_model_parallel_size),
        ):
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        denom = self.tp * self.pp * self.cp
        if n_devices % denom != 0:
            raise ValueError(
                f"world size {n_devices} not divisible by tp*pp*cp = "
                f"{self.tp}*{self.pp}*{self.cp} = {denom}")
        dp = n_devices // denom
        if dp % self.ep != 0:
            raise ValueError(
                f"data-parallel degree {dp} not divisible by "
                f"expert_model_parallel_size {self.ep}")
        if self.sequence_parallel and self.tp == 1:
            raise ValueError(
                "sequence_parallel requires tensor_model_parallel_size > 1 "
                "(reference megatron_base_model.py:76-80)")

    def dp_size(self, n_devices: int) -> int:
        """True data-parallel degree: world / (tp * pp * cp)."""
        return n_devices // (self.tp * self.pp * self.cp)

    def shape(self, n_devices: int) -> dict[str, int]:
        dp = self.dp_size(n_devices)
        return {"pipe": self.pp, "data": dp // self.ep, "expert": self.ep,
                "context": self.cp, "model": self.tp}


def build_mesh(config: MeshConfig, *, device_type: str = "cuda"):
    """The global ``DeviceMesh`` over the process group's ranks, with the
    axes :data:`AXES` (``init_device_mesh``; the process group must be up).
    ``device_type`` is ``"cuda"`` on cards, ``"cpu"`` for gloo runs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    config.validate(n)
    shape = config.shape(n)
    return init_device_mesh(device_type, tuple(shape[a] for a in AXES), mesh_dim_names=AXES)


def mesh_axis_size(mesh, axis: str) -> int:
    return int(dict(zip(mesh.mesh_dim_names, mesh.shape)).get(axis, 1))


def dp_degree(mesh) -> int:
    """True data-parallel degree (``data`` x ``expert`` axes)."""
    return mesh_axis_size(mesh, "data") * mesh_axis_size(mesh, "expert")


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place on the ``data`` axis."""

    rank: int
    size: int
    group: Any  # the data axis's ProcessGroup
    mesh: Any  # the 1-D DeviceMesh of the data axis (ZeRO-1 DTensors)

    @classmethod
    def from_mesh(cls, mesh, *, data_only: bool = False) -> "DataParallel":
        """The true data-parallel axis of ``mesh``: ``(data, expert)`` when
        the expert axis has more than one rank, else ``data`` (``data_only``:
        ``data`` whatever the expert axis)."""
        if data_only or mesh_axis_size(mesh, "expert") == 1:
            dm = mesh["data"]
        else:
            dm = _compound(mesh, ("data", "expert"), "dp")
        return cls(rank=dm.get_local_rank(), size=dm.size(), group=dm.get_group(), mesh=dm)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the data axis, in place (the identity on one rank)."""
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather_into(self, out: torch.Tensor, local: torch.Tensor, dim: int) -> None:
        """``out`` (the whole leaf) <- every rank's ``local`` slice, laid
        end to end along ``dim`` in rank order."""
        import torch.distributed as dist

        parts = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        out.copy_(torch.cat(parts, dim=dim))


def _compound(mesh, axes: tuple, name: str):
    """The 1-D DeviceMesh of the adjacent ``axes`` of ``mesh`` flattened
    into one, outer axis major (a DeviceMesh over the same ranks with those
    dims merged; every rank builds it, as its process groups need)."""
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names)
    i = names.index(axes[0])
    if names[i:i + len(axes)] != list(axes):
        raise ValueError(f"mesh axes {axes} are not adjacent in {names}")
    shape = list(mesh.mesh.shape)
    merged = shape[:i] + [math.prod(shape[i:i + len(axes)])] + shape[i + len(axes):]
    dims = tuple(names[:i] + [name] + names[i + len(axes):])
    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(merged), mesh_dim_names=dims)[name]


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This process's place on the ``model`` axis.  With ``kv_replicas``
    above 1 (tp above the kv heads) the model axis also splits into
    ``("kv", "replica")``: the ranks of a ``replica`` group hold the same kv
    head (``parallel/sharding.py``), sum their gradients of it over
    ``kv_group``, and a checkpoint writes it once from ``kv_mesh`` (the
    state mesh with ``model`` split so, ``expert`` kept at ep > 1)."""

    rank: int
    size: int
    group: Any  # the model axis's ProcessGroup
    mesh: Any  # the 1-D DeviceMesh of the model axis
    state_mesh: Any  # the 2-D ("data", "model") DeviceMesh of sharded state
    sequence_parallel: bool = False
    kv_replicas: int = 1
    kv_group: Any = None  # the ranks that share this rank's kv head
    kv_mesh: Any = None  # ("data"[, "expert"], "kv", "replica"): the state mesh, model split

    @classmethod
    def from_mesh(cls, mesh, *, sequence_parallel: bool = False,
                  kv_replicas: int = 1) -> "TensorParallel":
        mm = mesh["model"]
        kv_group = kv_mesh = None
        if kv_replicas > 1:
            from torch.distributed.device_mesh import DeviceMesh

            names = tuple(mesh.mesh_dim_names)
            shape = tuple(mesh.mesh.shape)
            split = DeviceMesh(mesh.device_type,
                               mesh.mesh.reshape(*shape[:-1], shape[-1] // kv_replicas,
                                                 kv_replicas),
                               mesh_dim_names=names[:-1] + ("kv", "replica"))
            # at ep > 1 the state's data-parallel dims are (data, expert)
            dims = (("data", "expert") if mesh_axis_size(mesh, "expert") > 1 else ("data",))
            kv_group, kv_mesh = split["replica"].get_group(), split[dims + ("kv", "replica")]
        state = (mesh["data", "expert", "model"] if mesh_axis_size(mesh, "expert") > 1
                 else mesh["data", "model"])
        return cls(rank=mm.get_local_rank(), size=mm.size(), group=mm.get_group(), mesh=mm,
                   state_mesh=state,
                   sequence_parallel=bool(sequence_parallel and mm.size() > 1),
                   kv_replicas=kv_replicas, kv_group=kv_group, kv_mesh=kv_mesh)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the model axis, in place (nothing on one rank)."""
        import torch.distributed as dist

        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce_kv_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the ranks that share this rank's kv head, in place."""
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.kv_group)
        return t


def axes_group(mesh, axes: tuple):
    """The process group over ``axes`` of ``mesh`` that holds this rank
    (e.g. ``("data", "context")``), from ``dist.new_group`` on every such
    group in the same order on every rank, as ``new_group`` requires."""
    import torch.distributed as dist

    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    size = math.prod(mesh.mesh.shape[i] for i in keep)
    ranks = mesh.mesh.permute(*rest, *keep).reshape(-1, size)
    mine = None
    me = dist.get_rank()
    for row in ranks.tolist():
        group = dist.new_group(row)
        if me in row:
            mine = group
    return mine


@dataclasses.dataclass(frozen=True)
class ContextParallel:
    """This process's place on the ``context`` axis."""

    rank: int
    size: int
    group: Any  # the context axis's ProcessGroup
    prev: int  # the world rank ring chunks arrive from (context rank - 1)
    next: int  # the world rank ring chunks go to (context rank + 1)
    reduce_group: Any  # the (data, expert, context) group: gradient and loss sums

    @classmethod
    def from_mesh(cls, mesh) -> "ContextParallel":
        cm = mesh["context"]
        ranks = [int(r) for r in cm.mesh.reshape(-1).tolist()]
        r, n = cm.get_local_rank(), cm.size()
        return cls(rank=r, size=n, group=cm.get_group(), prev=ranks[(r - 1) % n],
                   next=ranks[(r + 1) % n],
                   reduce_group=axes_group(mesh, ("data", "expert", "context")))

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the ``(data, expert, context)`` group, in place."""
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.reduce_group)
        return t

    def sum_context(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor: the SUM of ``t`` over the context axis alone."""
        import torch.distributed as dist

        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def post(self, tensors: list) -> tuple:
        """Start one ring shift: each tensor (None passes through) goes to
        the next rank, and a buffer of its shape receives the previous
        rank's, in one batch of point-to-point messages that runs beside
        the kernels launched until :meth:`wait`.  Returns the handle."""
        import torch.distributed as dist

        ops, sent, out = [], [], []
        for t in tensors:
            if t is None:
                out.append(None)
                continue
            t = t.contiguous()
            buf = torch.empty_like(t)
            ops += [dist.P2POp(dist.isend, t, self.next, group=self.group),
                    dist.P2POp(dist.irecv, buf, self.prev, group=self.group)]
            sent.append(t)
            out.append(buf)
        return dist.batch_isend_irecv(ops) if ops else [], sent, out

    def wait(self, handle: tuple) -> list:
        """End the shift :meth:`post` started: the tensors the previous rank
        sent, in the order posted."""
        reqs, _sent, out = handle  # _sent: the send buffers live until here
        for req in reqs:
            req.wait()
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t [cp, ...]``: chunk ``j`` goes to context rank ``j``; chunk
        ``i`` of the result came from context rank ``i``."""
        import torch.distributed as dist

        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out


@dataclasses.dataclass(frozen=True)
class PipelineParallel:
    """This process's place on the ``pipe`` axis: stage ``rank`` of
    ``size``, and the world ranks of the previous and next stages, which
    hold the same ``(data, expert, context, model)`` coordinates (they
    wrap: the last stage's next is rank 0, whose chunk ``c + 1`` follows
    its chunk ``c`` under the virtual pipeline)."""

    rank: int
    size: int
    group: Any  # the pipe axis's ProcessGroup
    prev: Any
    next: Any

    @classmethod
    def from_mesh(cls, mesh) -> "PipelineParallel":
        pm = mesh["pipe"]
        ranks = [int(r) for r in pm.mesh.reshape(-1).tolist()]
        r, n = pm.get_local_rank(), pm.size()
        return cls(rank=r, size=n, group=pm.get_group(),
                   prev=ranks[(r - 1) % n], next=ranks[(r + 1) % n])

    def p2p(self, sends: list, recvs: list, *, wait: bool = True):
        """One batch of stage hops: each ``(offset, tensor)`` of ``sends``
        goes to the next (+1) or previous (-1) stage, and each ``(offset,
        buffer)`` of ``recvs`` is filled from that stage, all in one
        ``batch_isend_irecv`` that this waits for; returns the buffers
        (``wait=False``: posted and not waited for, returns ``(buffers,
        works, sent tensors)``; each work must then be waited for once).
        At pp 2 both neighbours are one rank: the two sides post their hops
        to it in the same order (activations first), which pairs them."""
        import torch.distributed as dist

        peer = {1: self.next, -1: self.prev}
        sent = [t.contiguous() for _, t in sends]
        ops = [dist.P2POp(dist.isend, t, peer[off], group=self.group)
               for (off, _), t in zip(sends, sent)]
        ops += [dist.P2POp(dist.irecv, buf, peer[off], group=self.group) for off, buf in recvs]
        works = dist.batch_isend_irecv(ops)
        bufs = [buf for _, buf in recvs]
        if not wait:
            return bufs, works, sent
        for req in works:
            req.wait()
        return bufs

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the pipe axis, in place."""
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t


@dataclasses.dataclass(frozen=True)
class ExpertParallel:
    """This process's place on the ``expert`` axis, and the groups the MoE
    layers and the train step need of it:

    - ``rank`` / ``size`` / ``group``: the expert axis (the weight gather);
    - ``data``: the ``data`` axis alone (a :class:`DataParallel`), the
      expert leaves' ZeRO-1 axis;
    - ``grad_group``: ``(data, context)``, over which the expert leaves'
      gradients are summed (the gather's backward sums them over
      ``expert``);
    - ``token_rank`` / ``token_size`` / ``token_group``: the ranks that
      split a microbatch's tokens, ``(data, expert[, context])``: the
      true data-parallel ranks hold its rows in JAX's order, and under cp
      (``context_size`` above 1) each context rank holds ``s/cp`` positions
      of each of them: the dropped path's keep mask (:meth:`gather_tokens`),
      and the router loss's statistics and the logged losses, summed over
      them (:meth:`sum_stats_`).

    At ep 1 the expert axis has one rank and the gather is the identity;
    the other groups are still the data (and context) ones."""

    rank: int
    size: int
    group: Any
    data: DataParallel
    grad_group: Any
    token_rank: int
    token_size: int
    token_group: Any
    context_size: int = 1

    @classmethod
    def from_mesh(cls, mesh, *, context: bool = False) -> "ExpertParallel":
        import torch.distributed as dist

        em = mesh["expert"]
        tokens = DataParallel.from_mesh(mesh)
        grad = axes_group(mesh, ("data", "context")) if context else mesh["data"].get_group()
        group, rank, size, cp = tokens.group, tokens.rank, tokens.size, 1
        if context:
            # (data, expert, context): the group's ranks are sorted world
            # ranks, so its order is the mesh's, context innermost
            group = axes_group(mesh, ("data", "expert", "context"))
            rank, size = dist.get_group_rank(group, dist.get_rank()), dist.get_world_size(group)
            cp = mesh_axis_size(mesh, "context")
        return cls(rank=em.get_local_rank(), size=em.size(), group=em.get_group(),
                   data=DataParallel.from_mesh(mesh, data_only=True), grad_group=grad,
                   token_rank=rank, token_size=size, token_group=group, context_size=cp)

    def grad_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM of an expert leaf's gradient over ``(data[, context])``, in
        place."""
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.grad_group)
        return t

    def sum_stats_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the ranks that split a microbatch's tokens, in place."""
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.token_group)
        return t

    def gather_tokens(self, t: torch.Tensor, rows: int = 1) -> torch.Tensor:
        """``[n, ...]``, this rank's ``rows`` rows of ``n / rows`` positions
        each, row after row -> ``[token_size n, ...]``: every rank's, in
        JAX's token order over the whole microbatch (row after row, the
        data ranks' rows in turn; under cp a row's context chunks in
        order, chunk 0 first)."""
        import torch.distributed as dist

        t = t.contiguous()
        out = torch.empty((self.token_size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.token_group)
        return tokens_in_order(out, self.token_size, self.context_size, rows)

    def own_tokens(self, full: torch.Tensor, rows: int = 1) -> torch.Tensor:
        """This rank's ``[n, ...]`` of :meth:`gather_tokens`' output (its
        rows' positions, in its own order)."""
        return own_tokens(full, self.token_rank, self.token_size, self.context_size, rows)


def tokens_in_order(gathered: torch.Tensor, size: int, context: int,
                    rows: int) -> torch.Tensor:
    """A token group's gather (``[size n, ...]``: its ``size`` ranks' in
    ``(data, expert, context)`` order, each rank's ``rows`` rows of ``n /
    rows`` positions) in JAX's token order over the microbatch: row after
    row, the data ranks' rows in turn, and within a row its ``context``
    chunks in order."""
    if context == 1:
        return gathered
    tail = tuple(gathered.shape[1:])
    # [data, context, row, position] -> [data, row, context, position]
    return gathered.reshape((size // context, context, rows, -1) + tail).transpose(
        1, 2).reshape((-1,) + tail)


def own_tokens(full: torch.Tensor, rank: int, size: int, context: int,
               rows: int) -> torch.Tensor:
    """Rank ``rank``'s ``[n, ...]`` of :func:`tokens_in_order`'s output."""
    n = full.shape[0] // size
    if context == 1:
        return full[rank * n:(rank + 1) * n]
    d, c = divmod(rank, context)
    tail = tuple(full.shape[1:])
    return full.reshape((size // context, rows, context, -1) + tail)[d, :, c].reshape(
        (n,) + tail)
