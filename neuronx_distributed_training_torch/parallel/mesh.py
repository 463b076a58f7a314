"""The device mesh (counterpart of the JAX package's ``parallel/mesh.py``).

The JAX package keeps one ``jax.sharding.Mesh`` whose named axes are the
parallel groups; here the same axes name a ``torch.distributed``
``DeviceMesh`` over the processes of the group, one card (or CPU process)
each, outermost first:

    (pipe, data, expert, context, model)

``world = dp * cp * tp * pp`` and ``dp = world / (tp * pp * cp)`` as in the
reference, and ``ep`` must divide it.  ``model`` is innermost, so a tp group
is consecutive ranks (on one host), and a context group strides over tp.
The port runs data, context and tensor parallelism (with Megatron sequence
parallelism); the trainer rejects pp and ep above 1 with the ROADMAP item
that ports them.

:class:`DataParallel` is what the train step and the optimizer need of the
``data`` axis: the rank, the size, its process group, the 1-D mesh of the
axis, and the two collectives they run.  :class:`TensorParallel` is the
same of the ``model`` axis, plus the sequence-parallel switch and the 2-D
``(data, model)`` mesh that sharded state lives on as DTensors (ZeRO-1
moments, and every leaf as a checkpoint writes it).  :class:`ContextParallel`
is the ``context`` axis: the ring's neighbours and the collectives the
context-parallel attention runs (``parallel/ring_attention.py``,
``parallel/ulysses.py``; Ulysses's key-mask all-gather is
``parallel/tensor_parallel.py::gather_seq`` over its group), and the
``(data, context)`` group over which the train step sums gradients and the
loss.  Parameters and optimizer state are replicated over ``context``:
ZeRO-1 shards over ``data`` alone.
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
    def from_mesh(cls, mesh) -> "DataParallel":
        dm = mesh["data"]
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


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This process's place on the ``model`` axis."""

    rank: int
    size: int
    group: Any  # the model axis's ProcessGroup
    mesh: Any  # the 1-D DeviceMesh of the model axis
    state_mesh: Any  # the 2-D ("data", "model") DeviceMesh of sharded state
    sequence_parallel: bool = False

    @classmethod
    def from_mesh(cls, mesh, *, sequence_parallel: bool = False) -> "TensorParallel":
        mm = mesh["model"]
        return cls(rank=mm.get_local_rank(), size=mm.size(), group=mm.get_group(), mesh=mm,
                   state_mesh=mesh["data", "model"],
                   sequence_parallel=bool(sequence_parallel and mm.size() > 1))

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the model axis, in place (nothing on one rank)."""
        import torch.distributed as dist

        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
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
    reduce_group: Any  # the (data, context) group: gradient and loss sums

    @classmethod
    def from_mesh(cls, mesh) -> "ContextParallel":
        cm = mesh["context"]
        ranks = [int(r) for r in cm.mesh.reshape(-1).tolist()]
        r, n = cm.get_local_rank(), cm.size()
        return cls(rank=r, size=n, group=cm.get_group(), prev=ranks[(r - 1) % n],
                   next=ranks[(r + 1) % n], reduce_group=axes_group(mesh, ("data", "context")))

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the ``(data, context)`` group, in place."""
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.reduce_group)
        return t

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
