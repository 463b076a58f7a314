"""Interconnect microbenchmark (the repo's ``tools/comms_bench.py`` on the
port): measured collective bandwidth per mesh axis.

Sweeps all-reduce, all-gather, reduce-scatter, collective-permute and
all-to-all x mesh axis x message size through ``torch.distributed`` over
the port's mesh groups (``telemetry/comms.py::run_comms_sweep``), fits each
axis's bandwidth and latency (the bus-bandwidth conventions the cost model
prices with), probes each device's timing skew, and writes a byte-stable
``comms_summary.json``: the measured interconnect that
``tools/plan.py --calibrate-from`` prices the comms term from, and that the
perf contract gates (PC204).

    torchrun --nproc_per_node 2 -m neuronx_distributed_training_torch.tools.comms_bench \\
        --tp 1 --pp 1 --sizes 1048576,16777216,268435456 --out run_dir
    python -m neuronx_distributed_training_torch.tools.comms_bench --device cpu \\
        --devices 4 --tp 2 --pp 1 --smoke --json -

On cards it runs under torchrun, one rank a card (without torchrun it
starts one rank a card itself); with one card it refuses, since a one-rank
sweep measures nothing.  ``--device cpu`` starts ``--devices`` gloo ranks.
A device whose probe sits beyond ``--skew-threshold`` x the median lands in
the summary's ``findings`` as a ``degraded_link``.  With ``--json -`` the
last stdout line is the ``comms_bench_sweep`` JSON line with the perf
contract's verdict (``tools/ckpt_verify.py::write_json``).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

#: the launcher's environment, which a spawned rank must not inherit
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "LOCAL_WORLD_SIZE", "GROUP_RANK", "NXDT_COORDINATOR", "NXDT_NUM_PROCESSES",
               "NXDT_PROCESS_ID")
#: torch threads of each spawned CPU rank (they share the host)
CPU_RANK_THREADS = 2
#: the spawned sweep's time limit, seconds
SPAWN_TIMEOUT_SECONDS = 900.0


def _fmt(v, nd=3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        a = abs(v)
        if a != 0 and (a >= 1e6 or a < 1e-3):
            return f"{v:.3e}"
        return f"{v:.{nd}f}"
    return str(v)


def render(summary: dict) -> str:
    """The bench's echo of a comms summary (``tools/comms_report.py`` has
    the full table)."""
    prior = dict(summary.get("prior") or {})
    lines = [f"interconnect sweep — topology={summary.get('topology')} "
             f"prior={float(prior.get('ici_bandwidth_bytes') or 0) / 1e9:g} GB/s"]
    for axis, entry in sorted((summary.get("axes") or {}).items()):
        fit = entry.get("fit") or {}
        head = f"  {axis} (mesh axis {entry.get('mesh_axis')}, size {entry.get('size')}):"
        if fit.get("bandwidth_bytes_per_s"):
            bw = float(fit["bandwidth_bytes_per_s"]) / 1e9
            lat = float(fit.get("latency_seconds") or 0) * 1e6
            head += f"  bw={bw:.3f} GB/s  lat={lat:.1f}us"
            if entry.get("bandwidth_ratio") is not None:
                head += f"  measured/prior={entry['bandwidth_ratio']:.2f}"
        lines.append(head)
        for row in entry.get("sweep") or ():
            lines.append(
                f"    {row['collective']:<18s} payload={int(row['payload_bytes']):>9d}B  "
                f"bus={_fmt(row.get('bus_gbps'))} GB/s  t={_fmt(row.get('seconds_median'), 6)}s")
    for f in summary.get("findings") or ():
        lines.append(f"  FINDING [{f.get('kind')}]: {f.get('message')}")
    if not summary.get("findings"):
        lines.append("  no degraded-link findings")
    return "\n".join(lines)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="'cpu': gloo ranks on the CPU (default: the cards, NCCL)")
    ap.add_argument("--devices", type=int, default=8,
                    help="gloo ranks to start with --device cpu (default 8: tp 2 x pp 2 x dp 2)")
    ap.add_argument("--tp", type=int, default=2, help="tensor-parallel degree of the sweep mesh")
    ap.add_argument("--pp", type=int, default=2,
                    help="pipeline-parallel degree of the sweep mesh")
    ap.add_argument("--cp", type=int, default=1, help="context-parallel degree of the sweep mesh")
    ap.add_argument("--ep", type=int, default=1, help="expert-parallel degree of the sweep mesh")
    ap.add_argument("--sizes", default="1048576,4194304",
                    help="comma-separated payload sizes in bytes (default 1MiB,4MiB)")
    ap.add_argument("--kinds", default=None,
                    help="comma-separated collective kinds to sweep (default: every kind the "
                         "axis carries, AXIS_COLLECTIVE_KINDS)")
    ap.add_argument("--reps", type=int, default=3, help="timed repetitions a point (median)")
    ap.add_argument("--warmup", type=int, default=1, help="untimed warmup calls a point")
    ap.add_argument("--smoke", action="store_true",
                    help="fast shape: 64K / 256K payloads, 2 reps")
    ap.add_argument("--no-skew", dest="skew", action="store_false",
                    help="skip the per-device timing-skew probe")
    ap.add_argument("--skew-threshold", type=float, default=None,
                    help="flag a device beyond this multiple of the median probe time as a "
                         "degraded link (default telemetry/comms.py's SKEW_REL_THRESHOLD)")
    ap.add_argument("--out", default="comms_summary.json", metavar="PATH",
                    help="where to write comms_summary.json (a directory gets the file name)")
    ap.add_argument("--contract-key", default=None, metavar="NAME",
                    help="perf-contract baseline key (default: from the device, e.g. "
                         "cpu_comms)")
    ap.add_argument("--json", metavar="PATH",
                    help="the comms_bench_sweep JSON line ('-' = stdout, last line)")
    return ap


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def spawn_ranks(argv: list[str], world: int, timeout: float = SPAWN_TIMEOUT_SECONDS) -> int:
    """Run this tool on ``world`` spawned ranks (``NXDT_*``, one card each
    or gloo): rank 0 writes to this process's stdout, the others to logs;
    returns rank 0's exit code, or the first failing rank's with its last
    lines on stderr."""
    pkg_root = str(Path(__file__).resolve().parents[2])
    port = _free_port()
    procs, logs = [], []
    with tempfile.TemporaryDirectory(prefix="nxdt_comms_bench_") as tmp:
        for r in range(world):
            env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
            env.update(NXDT_COORDINATOR=f"127.0.0.1:{port}", NXDT_NUM_PROCESSES=str(world),
                       NXDT_PROCESS_ID=str(r), LOCAL_RANK=str(r),
                       PYTHONPATH=os.pathsep.join(
                           [pkg_root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            out = None if r == 0 else open(Path(tmp) / f"rank{r}.log", "w+")
            logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "neuronx_distributed_training_torch.tools.comms_bench",
                 *argv], env=env, stdout=out, stderr=subprocess.STDOUT if out else None))
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            print(f"comms_bench: the sweep's {world} ranks did not end in {timeout:.0f} s",
                  file=sys.stderr)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        for r, (code, log) in enumerate(zip(codes, logs)):
            if code and log is not None:
                log.seek(0)
                print(f"comms_bench: rank {r} exited {code}: "
                      f"{' | '.join(log.read().strip().splitlines()[-8:])}", file=sys.stderr)
        for log in logs:
            if log is not None:
                log.close()
    return codes[0] or next((c for c in codes if c), 0)


def _rank_main(args, sizes, reps, warmup, kinds) -> int:
    """One rank of the sweep (the process group is up)."""
    import torch
    import torch.distributed as dist

    from neuronx_distributed_training_torch.analysis import perf_contract as pc
    from neuronx_distributed_training_torch.autotune.topology import resolve_topology
    from neuronx_distributed_training_torch.parallel.mesh import MeshConfig, build_mesh
    from neuronx_distributed_training_torch.telemetry import comms
    from neuronx_distributed_training_torch.tools.ckpt_verify import write_json

    on_cpu = dist.get_backend() == "gloo"
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        mesh = build_mesh(MeshConfig(tensor_model_parallel_size=args.tp,
                                     pipeline_model_parallel_size=args.pp,
                                     context_parallel_size=args.cp,
                                     expert_model_parallel_size=args.ep),
                          device_type="cpu" if on_cpu else "cuda")
    except (ValueError, AssertionError, RuntimeError) as e:
        if rank == 0:
            print(f"comms_bench: mesh build failed for {world} ranks: {e}", file=sys.stderr)
            if args.json:
                write_json({"ok": False, "metric": "comms_bench_sweep", "error": str(e),
                            "perf_contract": {"verdict": "no_measurement"}}, args.json)
        return 2
    axis_results = comms.run_comms_sweep(mesh, sizes_bytes=sizes, kinds=kinds, warmup=warmup,
                                         reps=reps)
    skew = comms.measure_device_skew() if args.skew else None
    if rank != 0:
        return 0
    device = torch.device("cpu") if on_cpu else torch.device("cuda", torch.cuda.current_device())
    topo = resolve_topology(device=device)
    summary = comms.build_comms_summary(
        axis_results, topology_name=topo.name,
        prior_bandwidth_bytes=topo.ici_bandwidth_bytes,
        prior_latency_seconds=topo.ici_latency_seconds, device_skew=skew,
        skew_rel_threshold=(args.skew_threshold if args.skew_threshold is not None
                            else comms.SKEW_REL_THRESHOLD))
    out = Path(args.out)
    if out.is_dir() or args.out.endswith(os.sep):
        out = out / comms.COMMS_SUMMARY_NAME
    comms.write_comms_summary(summary, out)
    print(render(summary))
    print(f"wrote {out}")
    facts_block = comms.bench_comms_facts(summary)
    ratios = [a.get("bandwidth_ratio") for a in (facts_block.get("axes") or {}).values()
              if a.get("bandwidth_ratio") is not None]
    shape = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))
    payload = {
        "metric": "comms_bench_sweep",
        "value": round(min(ratios), 6) if ratios else 0.0,
        "unit": "min_axis_bandwidth_measured_over_prior",
        "device": "cpu" if on_cpu else torch.cuda.get_device_name(device),
        "mesh": {k: v for k, v in shape.items() if v > 1},
        "sizes_bytes": list(sizes),
        "comms": facts_block,
        "findings": summary.get("findings") or [],
        "comms_summary_path": str(out),
        "note": ("bus-bandwidth conventions (all-reduce 2B(n-1)/n, AG/RS/A2A B(n-1)/n, "
                 "permute B) — the same factors the cost model's _ring_seconds prices with"),
    }
    # the perf contract's verdict: PC204 gates the measured bandwidth against
    # the committed per-device baseline (cpu_comms on the CPU smoke)
    try:
        facts = pc.perf_facts_from_bench(payload)
        key = args.contract_key or pc.default_key(facts)
        payload["perf_contract"] = pc.bench_verdict(key, facts)
        print(f"perf contract [{key}]: {payload['perf_contract']['verdict']}")
    except Exception as e:  # noqa: BLE001 — the line must survive, its reason shown
        payload["perf_contract"] = {"verdict": "unavailable",
                                    "error": f"{type(e).__name__}: {e}"[:300]}
    if args.json:
        write_json(payload, args.json)
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    if args.smoke:
        sizes, reps, warmup = (1 << 16, 1 << 18), 2, 1
    else:
        sizes = tuple(int(s) for s in args.sizes.split(",") if s)
        reps, warmup = args.reps, args.warmup
    kinds = tuple(k.strip() for k in args.kinds.split(",") if k.strip()) if args.kinds else None
    on_cpu = args.device is not None and args.device.split(":")[0] == "cpu"

    from neuronx_distributed_training_torch.utils.launch import detect_cluster

    if not detect_cluster().wants_process_group:
        # not a rank: start the ranks
        if on_cpu:
            return spawn_ranks(argv, args.devices)
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < 2:
            print(f"comms_bench: a sweep needs two or more ranks and this machine has "
                  f"{cards} card(s): a one-rank sweep measures nothing (pass --device cpu "
                  f"for gloo ranks on the CPU)", file=sys.stderr)
            return 2
        return spawn_ranks(argv, cards)

    import torch
    import torch.distributed as dist

    from neuronx_distributed_training_torch.utils.launch import initialize_distributed

    if on_cpu:
        torch.set_num_threads(CPU_RANK_THREADS)
    initialize_distributed(device="cpu" if on_cpu else None)
    try:
        return _rank_main(args, sizes, reps, warmup, kinds)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
