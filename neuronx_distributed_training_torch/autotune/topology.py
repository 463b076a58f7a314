"""Card/interconnect facts the cost model prices plans against (counterpart
of the JAX package's ``autotune/topology.py``).

One :class:`ChipTopology` per card: peak matmul throughput (the same table
MFU uses, ``utils/perf.py::CARD_PEAKS``, one source of truth through
``peak_tflops_key``), device memory, and the interconnect numbers analytic
collective costs are built from.  ``ici_bandwidth_bytes`` is the usable
per-card ring-collective figure (per direction, derated for protocol
overhead) and ``ici_latency_seconds`` the per-hop latency that dominates
small transfers; the field names are JAX's, so the cost model is a copy.

The ``h100`` entry is an H100 SXM (80 GB HBM3, NVLink 4 through NVSwitch).
Its NVLink bandwidth and latency are **data-sheet priors**, not
measurements: 18 NVLink 4 links give 450 GB/s a direction, derated to 80%
usable as JAX derates ICI; the hop latency is a few microseconds of NCCL's
launch and handshake.  ``tools/comms_bench.py`` measures them on two or
more cards (``comms_summary.json``), and ``tools/plan.py --calibrate-from
comms_summary.json`` prices the comms term from the measured wire rates.
The inter-node figure is one 400 Gb/s NDR InfiniBand port a card.  When a card is present
:func:`resolve_topology` takes its memory from
``torch.cuda.get_device_properties`` and its peak from ``CARD_PEAKS`` by
its name.

The ``cpu`` entry is JAX's, unchanged: it keeps the planner exercisable
(and its ranking comparable with JAX's in the tests) off the card.

A TPU generation (``v5e``, ``v5p``, ...) is a fact of a TPU fleet, not of
this port: :func:`resolve_topology` refuses it with the known set, and the
trainer logs a config's ``autotune.topology: v5e`` as ignored and prices
the detected card.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional

logger = logging.getLogger(__name__)

#: TPU generations a config of the JAX package may name in
#: ``autotune.topology`` (JAX's table): valid there, ignored here
TPU_TOPOLOGIES = ("v4", "v5e", "v5p", "v6e")


@dataclasses.dataclass(frozen=True)
class ChipTopology:
    """Static per-card facts."""

    name: str
    #: key into utils/perf.py's CARD_PEAKS ("cpu": its nominal CPU peak)
    peak_tflops_key: str
    hbm_bytes: int
    #: usable ring-collective bandwidth per card, bytes/s (per direction)
    ici_bandwidth_bytes: float
    #: per-hop latency floor, seconds
    ici_latency_seconds: float
    #: inter-node bandwidth per card, bytes/s
    dcn_bandwidth_bytes: float = 25.0e9 / 8
    #: matmul efficiency the compute roofline assumes (JAX's prior)
    compute_efficiency: float = 0.55
    #: default fraction of collective wire time hidden under compute (the
    #: prior a measured ``trace_summary.json`` replaces)
    comms_overlap: float = 0.5
    #: the card's measured peak over the HBM model's predicted total: the
    #: fit test prices ``total x`` this (the model's constants are JAX's,
    #: fitted to XLA's compiled memory)
    hbm_total_ratio: float = 1.0

    @property
    def peak_flops(self) -> float:
        from neuronx_distributed_training_torch.utils import perf

        if self.peak_tflops_key == "cpu":
            return perf.CPU_PEAK_TFLOPS * 1e12
        peaks = perf.card_peaks(self.peak_tflops_key)
        if peaks is None:
            raise ValueError(f"no published peak for {self.peak_tflops_key!r} in "
                             f"utils/perf.py CARD_PEAKS")
        return peaks[0]


#: the topology table ``--topology`` selects from
TOPOLOGIES: dict[str, ChipTopology] = {
    "h100": ChipTopology(
        name="h100",
        peak_tflops_key="H100",
        # the data sheet's 80 GB; a live card's total_memory replaces it
        hbm_bytes=80 * 10**9,
        # data-sheet prior: NVLink 4, 18 links x 25 GB/s a direction =
        # 450 GB/s, 80% usable
        ici_bandwidth_bytes=360e9,
        # data-sheet prior: a few us of NCCL launch and handshake a hop
        ici_latency_seconds=5e-6,
        # one 400 Gb/s NDR InfiniBand port a card
        dcn_bandwidth_bytes=400e9 / 8,
        # measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W) at phase 4's
        # cell: max_memory_allocated 58237381632 bytes against the predicted
        # 77323362304 under its selective remat (0.753), 49307316224 against
        # 74773225472 under full remat (20a, 0.659).  The model charges 4.5
        # fp32 gradient buffers where the port holds one; the larger ratio
        # keeps the fit test on the side of refusing
        hbm_total_ratio=58237381632 / 77323362304,
    ),
    # off-hardware planning/test fallback (JAX's entry, unchanged)
    "cpu": ChipTopology(
        name="cpu",
        peak_tflops_key="cpu",
        hbm_bytes=8 * 1024**3,
        ici_bandwidth_bytes=2e9,
        ici_latency_seconds=20e-6,
        compute_efficiency=0.5,
    ),
}


def _card_topology(device) -> ChipTopology:
    """The table entry for a live CUDA card, its memory and peak read from
    the card (an unknown NVIDIA card prices as an H100, loudly)."""
    import torch

    from neuronx_distributed_training_torch.utils import perf

    name = torch.cuda.get_device_name(device)
    base = TOPOLOGIES["h100"]
    if "H100" not in name:
        # an unrecognized card priced with the wrong memory table would
        # approve plans that OOM: be loud, not silently wrong
        logger.warning(
            "unrecognized CUDA card %r: pricing as h100 — pass an explicit "
            "topology (known: %s) if that table is wrong for this card",
            name, "/".join(sorted(TOPOLOGIES)))
    key = name if perf.card_peaks(name) is not None else base.peak_tflops_key
    total = int(torch.cuda.get_device_properties(device).total_memory)
    return dataclasses.replace(base, peak_tflops_key=key, hbm_bytes=total)


def resolve_topology(name: Optional[str] = None,
                     device: Optional[Any] = None) -> ChipTopology:
    """Topology by explicit name, else detected from a live torch device
    (a CUDA card by its name), else the ``cpu`` fallback.  Unknown names
    raise with the valid set (the CLI's ``--topology`` funnels through
    here); a TPU generation is unknown here."""
    if name:
        key = str(name).lower()
        if key not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {name!r}; known: "
                f"{'/'.join(sorted(TOPOLOGIES))}"
            )
        return TOPOLOGIES[key]
    if device is not None:
        import torch

        device = torch.device(device)
        if device.type == "cuda":
            return _card_topology(device)
    return TOPOLOGIES["cpu"]


def pricing_device(device: Optional[Any] = None):
    """The device a plan without ``--topology`` is priced for: ``device``
    when given (``cpu`` prices the ``cpu`` entry), else the first CUDA card.
    With neither it raises rather than pricing the CPU."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: name a topology (--topology h100) or "
                           "pass device='cpu' (--device cpu) to price the cpu entry")
    return torch.device("cuda", 0)
