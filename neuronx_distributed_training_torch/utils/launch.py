"""Cluster detection and process-group start (counterpart of the JAX package's
``utils/launch.py``, the ``train_setup.sh`` layer).

The reference's launch script cases on the cluster environment: SLURM
(``SLURM_NNODES``, nodelist -> ``MASTER_ADDR``), MPI (``OMPI_COMM_WORLD_*``),
else one node, and exports the rendezvous for torchrun.  Here torchrun's own
variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) come first, then the explicit ``NXDT_*`` triple, SLURM, Open
MPI and a single process.  Everything but :func:`initialize_distributed` is a
pure function of an env mapping.

:func:`initialize_distributed` starts ``torch.distributed``: NCCL with each
process on ``cuda:LOCAL_RANK``, or gloo when the caller asked for the CPU.
A run under torchrun gets a process group even at world size 1, so one card
runs the same collectives as many.  The world is ``pp x dp x cp x tp``
processes (ep is not ported; ``parallel/mesh.py`` lays the ranks out), one
card each.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Mapping, Optional

logger = logging.getLogger("nxdt.torch.launch")

DEFAULT_COORDINATOR_PORT = 29500  # torchrun's own default MASTER_PORT


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """The rendezvous triple, plus bookkeeping for devices and log paths."""

    coordinator_address: str  # host:port
    num_processes: int
    process_id: int
    managed_by: str  # "torchrun" | "nxdt-env" | "slurm" | "ompi" | "ompi-auto" | "single"
    restart_count: int = 0  # SLURM_RESTART_COUNT
    local_rank: int = 0  # the process's index on its host: its card

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1

    @property
    def wants_process_group(self) -> bool:
        """Multi-process runs, and any run torchrun started (world size 1
        included)."""
        return self.is_multiprocess or self.managed_by == "torchrun"


def expand_first_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, without DNS: ``node[3-17,20]`` ->
    ``node3`` (zero-padding kept: ``node[003-017]`` -> ``node003``),
    ``a1,b2`` -> ``a1``."""
    nodelist = nodelist.strip()
    m = re.match(r"^([^,\[]+)\[([^\]]+)\]", nodelist)
    if m:
        prefix, ranges = m.group(1), m.group(2)
        return prefix + ranges.split(",")[0].split("-")[0]
    return nodelist.split(",")[0]


def _int(env: Mapping[str, str], key: str, default: int = 0) -> int:
    return int(env.get(key, str(default)) or default)


def detect_cluster(env: Optional[Mapping[str, str]] = None) -> ClusterSpec:
    """Case on the cluster environment.  Priority: torchrun (``RANK`` and
    ``WORLD_SIZE`` with ``MASTER_ADDR``) > the explicit ``NXDT_*`` triple >
    SLURM > Open MPI > single process."""
    env = os.environ if env is None else env
    restart = _int(env, "SLURM_RESTART_COUNT")

    if env.get("RANK") and env.get("WORLD_SIZE") and env.get("MASTER_ADDR"):
        port = env.get("MASTER_PORT") or str(DEFAULT_COORDINATOR_PORT)
        return ClusterSpec(
            coordinator_address=f"{env['MASTER_ADDR']}:{port}",
            num_processes=int(env["WORLD_SIZE"]), process_id=int(env["RANK"]),
            managed_by="torchrun", restart_count=restart,
            local_rank=_int(env, "LOCAL_RANK"))

    if (env.get("NXDT_COORDINATOR") and env.get("NXDT_NUM_PROCESSES")
            and env.get("NXDT_PROCESS_ID")):
        return ClusterSpec(
            coordinator_address=env["NXDT_COORDINATOR"],
            num_processes=int(env["NXDT_NUM_PROCESSES"]),
            process_id=int(env["NXDT_PROCESS_ID"]),
            managed_by="nxdt-env", restart_count=restart,
            local_rank=_int(env, "LOCAL_RANK"))

    ntasks = int(env.get("SLURM_NTASKS", env.get("SLURM_NPROCS", "0")) or 0)
    if ntasks > 1:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        if not nodelist:
            raise RuntimeError(
                "SLURM environment without SLURM_STEP_NODELIST/SLURM_NODELIST; "
                "set NXDT_COORDINATOR explicitly")
        host = expand_first_host(nodelist)
        port = env.get("NXDT_COORDINATOR_PORT", str(DEFAULT_COORDINATOR_PORT))
        return ClusterSpec(
            coordinator_address=f"{host}:{port}", num_processes=ntasks,
            process_id=_int(env, "SLURM_PROCID"), managed_by="slurm",
            restart_count=restart, local_rank=_int(env, "SLURM_LOCALID"))

    world = _int(env, "OMPI_COMM_WORLD_SIZE")
    if world > 1:
        # mpirun exports no coordinator host; the MPI recipe provides
        # MASTER_ADDR.  Without one the caller must supply the address.
        host = env.get("MASTER_ADDR") or env.get("NXDT_COORDINATOR")
        if host:
            port = env.get("MASTER_PORT", str(DEFAULT_COORDINATOR_PORT))
            addr = host if ":" in host else f"{host}:{port}"
        else:
            addr = ""
        return ClusterSpec(
            coordinator_address=addr, num_processes=world,
            process_id=_int(env, "OMPI_COMM_WORLD_RANK"),
            managed_by="ompi" if addr else "ompi-auto", restart_count=restart,
            local_rank=_int(env, "OMPI_COMM_WORLD_LOCAL_RANK"))

    return ClusterSpec(coordinator_address="", num_processes=1, process_id=0,
                       managed_by="single", restart_count=restart)


def restart_log_dir(base_dir: str, env: Optional[Mapping[str, str]] = None) -> str:
    """Per-restart log directory: a SLURM relaunch writes under
    ``restart_<N>/`` so earlier logs survive."""
    env = os.environ if env is None else env
    restart = _int(env, "SLURM_RESTART_COUNT")
    return os.path.join(base_dir, f"restart_{restart}") if restart > 0 else base_dir


def initialize_distributed(spec: Optional[ClusterSpec] = None, *,
                           device: Optional[str] = None) -> Optional[ClusterSpec]:
    """Start ``torch.distributed`` from the detected (or given) spec and
    return it; ``None`` (and nothing started) for a single process outside
    torchrun, or when a process group is already up.

    The backend is NCCL, with this process on ``cuda:local_rank``; gloo only
    when ``device`` is ``"cpu"``.  Without a card and without ``cpu`` it
    raises rather than falling back to gloo."""
    import torch
    import torch.distributed as dist

    spec = spec or detect_cluster()
    if not spec.wants_process_group or dist.is_initialized():
        return None
    if not spec.coordinator_address:
        raise RuntimeError(
            f"{spec.num_processes} processes ({spec.managed_by}) but no coordinator "
            f"address: set MASTER_ADDR/MASTER_PORT or NXDT_COORDINATOR")
    kw = {}
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) to run the "
                "process group on gloo and the CPU explicitly")
        backend = "nccl"
        torch.cuda.set_device(spec.local_rank)
        kw["device_id"] = torch.device("cuda", spec.local_rank)
    dist.init_process_group(backend=backend, init_method=f"tcp://{spec.coordinator_address}",
                            world_size=spec.num_processes, rank=spec.process_id, **kw)
    logger.info("distributed via %s: process %d/%d (local rank %d), %s, coordinator %s",
                spec.managed_by, spec.process_id, spec.num_processes, spec.local_rank,
                backend, spec.coordinator_address)
    return spec
