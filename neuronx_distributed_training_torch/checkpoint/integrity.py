"""Checkpoint integrity: digests, verified restore, quarantine (counterpart of
the JAX package's ``checkpoint/integrity.py`` over the port's
``torch.distributed.checkpoint`` layout).

A committed step directory holds::

    <step>/params/          DCP checkpoint of {dotted param name: tensor}
    <step>/opt_state/       DCP checkpoint of {"mu/<name>", "nu/<name>",
                             "master/<name>": tensor, "step": int64 scalar}
    <step>/meta.json        step, consumed_samples, save knobs, metrics
    <step>/integrity.json   the sidecar (below)

- every save carries the sidecar (:func:`build_sidecar`): blake2b-128
  digests per leaf group (``params``, ``opt_state/mu``, ``opt_state/nu``,
  ``opt_state/master``, ``opt_state/step``) over the exact bytes handed to
  DCP, each leaf's own digest, the meta digest, and a name/shape/dtype
  summary;
- restore verifies first (:func:`verify_step` is template-free: each item
  is read back from its DCP metadata alone and re-hashed); a step that fails
  is quarantined (renamed ``quarantined.<step>.<reason>``, invisible to step
  discovery and to the exp manager's ``version_N`` parse, plus a ledger
  entry) and the walk-back goes on to the newest step that verifies;
- a step without a sidecar restores as ``legacy``, with a warning;
- :class:`SaveAuditor` re-reads committed steps on a background thread
  (``exp_manager.checkpoint.integrity.audit``).

Digests: a leaf's digest is blake2b-128 over the blake2b-128 digests of its
bytes in 64 MiB chunks (chunks hash in parallel, hashlib releases the GIL);
a group's digest is blake2b-128 over ``name|dtype|shape`` and the leaf
digest of each leaf in name order.

Under a process group each rank writes its own shards: a ZeRO-1 or
tensor-parallel leaf is a ``DTensor`` on the ``data`` or ``(data, model)``
mesh whose block only its rank (or its replicas) holds, and DCP spreads the
writes of replicated blocks over the ranks.  Each block is hashed by its
first holder (rank 0 the plain replicated leaves), rank 0 merges the
records (:func:`sidecar_from_records`), and a sharded leaf's sidecar
entry keeps one digest per shard with its offsets and sizes
(``shards[item][name]``); its leaf digest is blake2b-128 over those.
Verification reads each leaf whole and hashes the recorded slices, so a
checkpoint verifies whatever the reader's world size, and a flipped byte
in any rank's file shows.

The knob block (validated at config load with did-you-mean hints):

.. code-block:: yaml

    exp_manager:
      checkpoint:
        integrity:
          enabled: true                 # digest sidecar in every save
          verify_restore: true          # verify + walk back before restore
          quarantine: true              # rename + ledger corrupt steps
          audit: false                  # post-commit read-back audit
          audit_deadline_seconds: 120.0 # teardown drain bound
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import logging
import os
import queue
import re
import shutil
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Mapping, Optional

logger = logging.getLogger(__name__)
# one process saves and loads alone: DCP says so on every call
warnings.filterwarnings("ignore", message="torch.distributed is disabled, unavailable or "
                        "uninitialized")

INTEGRITY_FORMAT = 1
SIDECAR_NAME = "integrity.json"
META_NAME = "meta.json"
ITEMS = ("params", "opt_state")
DIGEST_ALGO = "blake2b-128"
CHUNK_BYTES = 64 << 20
QUARANTINE_PREFIX = "quarantined."
LEDGER_NAME = "quarantine_ledger.json"
CORRUPTION_KINDS = ("byte_flip", "truncate", "delete_item", "stale_sidecar")

#: knob name -> default (the validator and ``from_config`` share it)
INTEGRITY_KNOBS: dict[str, Any] = {
    "enabled": True,
    "verify_restore": True,
    "quarantine": True,
    "audit": False,
    "audit_deadline_seconds": 120.0,
}

#: keys the ``exp_manager.checkpoint`` block accepts
CHECKPOINT_BLOCK_KEYS = frozenset({"integrity"})


class CheckpointIntegrityError(RuntimeError):
    """No retained checkpoint verifies (or an explicitly requested step does
    not).  Carries the per-step verdicts."""

    def __init__(self, message: str, verdicts: Optional[list] = None):
        super().__init__(message)
        self.verdicts = list(verdicts or [])


def _did_you_mean(unknown, options) -> str:
    from neuronx_distributed_training_torch.config.loader import did_you_mean

    return did_you_mean(unknown, options)


@dataclasses.dataclass(frozen=True)
class IntegrityConfig:
    """``exp_manager.checkpoint.integrity``: the checkpoint-integrity policy."""

    enabled: bool = True
    verify_restore: bool = True
    quarantine: bool = True
    audit: bool = False
    audit_deadline_seconds: float = 120.0

    @classmethod
    def from_config(cls, block: Any) -> "IntegrityConfig":
        """Parse and validate the block: ``None``/``{}`` gives the defaults,
        a bare bool toggles ``enabled``; unknown keys and ill-typed values
        raise ``ValueError`` with a did-you-mean hint."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.checkpoint.integrity must be a mapping of "
                f"{sorted(INTEGRITY_KNOBS)} (or a single bool), got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - set(INTEGRITY_KNOBS)
        if unknown:
            raise ValueError(
                f"unknown exp_manager.checkpoint.integrity keys "
                f"{sorted(unknown)}; supported: {sorted(INTEGRITY_KNOBS)}"
                + _did_you_mean(unknown, INTEGRITY_KNOBS)
            )
        values: dict[str, Any] = {}
        for k, v in block.items():
            if isinstance(INTEGRITY_KNOBS[k], bool):
                if not isinstance(v, bool):
                    raise ValueError(
                        f"exp_manager.checkpoint.integrity.{k} must be a boolean, got {v!r}")
                values[k] = v
            else:
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ValueError(
                        f"exp_manager.checkpoint.integrity.{k} must be a number, got {v!r}")
                values[k] = float(v)
                if values[k] < 0.0:
                    raise ValueError(
                        f"exp_manager.checkpoint.integrity.{k} must be >= 0, got {v!r}")
        return cls(**values)


def parse_checkpoint_block(block: Any) -> IntegrityConfig:
    """Validate an ``exp_manager.checkpoint`` block and return its
    :class:`IntegrityConfig` (``None`` gives the defaults)."""
    if block is None:
        return IntegrityConfig()
    if not isinstance(block, Mapping):
        raise ValueError(
            f"exp_manager.checkpoint must be a mapping of "
            f"{sorted(CHECKPOINT_BLOCK_KEYS)}, got {type(block).__name__}"
        )
    unknown = set(block) - CHECKPOINT_BLOCK_KEYS
    if unknown:
        raise ValueError(
            f"unknown exp_manager.checkpoint keys {sorted(unknown)}; "
            f"supported: {sorted(CHECKPOINT_BLOCK_KEYS)}"
            + _did_you_mean(unknown, CHECKPOINT_BLOCK_KEYS)
        )
    return IntegrityConfig.from_config(block.get("integrity"))


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------


def _hasher():
    return hashlib.blake2b(digest_size=16)


def json_digest(obj: Any) -> str:
    """Digest of a JSON-serializable object over its normalized form (one
    dumps/loads round trip first, so the in-memory dict and the one read back
    from disk digest alike)."""
    normalized = json.loads(json.dumps(obj, default=str))
    h = _hasher()
    h.update(json.dumps(normalized, sort_keys=True, separators=(",", ":")).encode())
    return h.hexdigest()


def _host_bytes(t) -> memoryview:
    """The bytes of a host tensor, as saved (no copy for a contiguous one)."""
    import torch

    t = t.detach()
    if t.device.type != "cpu":
        raise ValueError("digests are taken from host tensors (the staged copy)")
    return memoryview(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def _chunk_digest(buf: memoryview) -> bytes:
    h = _hasher()
    h.update(buf)
    return h.digest()


def leaf_digests(flat: Mapping[str, Any], *, workers: int = 0) -> dict[str, str]:
    """``{name: digest}`` of host tensors, chunks hashed on ``workers``
    threads (default: the CPU count)."""
    jobs = []  # (name, chunk index, memoryview)
    for name, t in flat.items():
        buf = _host_bytes(t)
        n = max(1, -(-len(buf) // CHUNK_BYTES))
        jobs += [(name, i, buf[i * CHUNK_BYTES:(i + 1) * CHUNK_BYTES]) for i in range(n)]
    workers = workers or min(32, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        chunks = list(ex.map(lambda j: _chunk_digest(j[2]), jobs))
    per_leaf: dict[str, list] = {name: [] for name in flat}
    for (name, i, _), d in zip(jobs, chunks):
        per_leaf[name].append((i, d))
    out = {}
    for name, parts in per_leaf.items():
        h = _hasher()
        for _, d in sorted(parts):
            h.update(d)
        out[name] = h.hexdigest()
    return out


def _shard_box(t) -> tuple[Any, list[int], list[int]]:
    """``(local tensor, offsets, sizes)`` of what this rank holds of a
    leaf: a DTensor's block (``Shard`` on any dims of a 1-D or 2-D mesh;
    the leaves divide evenly), else the whole."""
    from neuronx_distributed_training_torch.optim.adamw import is_dtensor

    if not is_dtensor(t):
        return t, [0] * t.dim(), list(t.shape)
    loc = t.to_local()
    coord = t.device_mesh.get_coordinate()
    offsets = [0] * t.dim()
    for i, placement in enumerate(t.placements):
        if placement.is_shard():
            offsets[placement.dim] += coord[i] * loc.shape[placement.dim]
    return loc, offsets, list(loc.shape)


def _hashes_here(t, rank: int) -> bool:
    """Does this rank hash ``t``?  A plain (replicated) tensor on rank 0; a
    DTensor's block on the rank whose coordinate is 0 on every mesh dim the
    leaf is replicated over, so each block is hashed once."""
    from neuronx_distributed_training_torch.optim.adamw import is_dtensor

    if not is_dtensor(t):
        return rank == 0
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, t.placements) if not p.is_shard())


def _combine_shards(records: list[dict]) -> str:
    """The leaf digest of a sharded leaf (``records`` in offset order)."""
    h = _hasher()
    for r in records:
        h.update(f"{r['offsets']}|{r['sizes']}|{r['digest']}".encode())
    return h.hexdigest()


def local_shard_records(trees: Mapping[str, Mapping[str, Any]], *, rank: int = 0,
                        workers: int = 0) -> dict[str, dict[str, dict]]:
    """This rank's digest records ``{item: {name: {offsets, sizes, digest}}}``
    over the host tensors it hands DCP: every DTensor block it is the first
    holder of (:func:`_hashes_here`), and on rank 0 the plain tensors."""
    pieces: dict[str, Any] = {}
    where: dict[str, tuple] = {}
    for item, flat in trees.items():
        for name, t in flat.items():
            if not _hashes_here(t, rank):
                continue
            loc, offsets, sizes = _shard_box(t)
            key = f"{item}/{name}"
            pieces[key], where[key] = loc, (item, name, offsets, sizes)
    digests = leaf_digests(pieces, workers=workers)
    out: dict[str, dict[str, dict]] = {item: {} for item in trees}
    for key, (item, name, offsets, sizes) in where.items():
        out[item][name] = {"offsets": offsets, "sizes": sizes, "digest": digests[key]}
    return out


def _group_of(item: str, path: str) -> str:
    """``params`` is one group; ``opt_state`` splits on its top-level key."""
    if item != "opt_state":
        return item
    return f"{item}/{path.split('/', 1)[0]}"


def _leaf_summary(t) -> dict[str, Any]:
    return {"dtype": str(t.dtype).replace("torch.", ""), "shape": list(t.shape)}


def _groups(item: str, flat: Mapping[str, Any], leaves: Mapping[str, str]
            ) -> tuple[dict[str, dict], dict[str, dict]]:
    """``(groups, structure)`` of one item from its leaves' digests."""
    hashers: dict[str, Any] = {}
    counts: dict[str, int] = {}
    sizes: dict[str, int] = {}
    structure: dict[str, dict] = {}
    for path in sorted(flat):
        t = flat[path]
        structure[path] = _leaf_summary(t)
        g = _group_of(item, path)
        h = hashers.setdefault(g, _hasher())
        h.update(f"{path}|{structure[path]['dtype']}|{tuple(t.shape)}".encode())
        h.update(leaves[path].encode())
        counts[g] = counts.get(g, 0) + 1
        sizes[g] = sizes.get(g, 0) + t.numel() * t.element_size()
    groups = {g: {"digest": h.hexdigest(), "leaves": counts[g], "bytes": sizes[g]}
              for g, h in hashers.items()}
    return groups, structure


def tree_digest_groups(item: str, flat: Mapping[str, Any], *, workers: int = 0,
                       shards: Optional[Mapping[str, list]] = None
                       ) -> tuple[dict[str, dict], dict[str, dict], dict[str, str]]:
    """``(groups, structure, leaves)`` for one item's flat host tensors (whole
    leaves): ``groups`` maps group -> ``{digest, leaves, bytes}``,
    ``structure`` maps name -> ``{dtype, shape}``, ``leaves`` maps name ->
    leaf digest.  A leaf named in ``shards`` (a sidecar's shard records) is
    hashed slice by slice as recorded; its records' ``digest`` entries are
    then the digests read back."""
    shards = {} if shards is None else shards
    pieces: dict[str, Any] = {}
    for name, t in flat.items():
        if name not in shards:
            pieces[name] = t
            continue
        for i, r in enumerate(shards[name]):
            sl = t
            for d, (o, n) in enumerate(zip(r["offsets"], r["sizes"])):
                sl = sl.narrow(d, o, n)
            pieces[f"{name}\0{i}"] = sl
    digests = leaf_digests(pieces, workers=workers)
    leaves = {}
    for name in flat:
        if name in shards:
            shards[name] = [dict(r, digest=digests[f"{name}\0{i}"])
                            for i, r in enumerate(shards[name])]
            leaves[name] = _combine_shards(shards[name])
        else:
            leaves[name] = digests[name]
    groups, structure = _groups(item, flat, leaves)
    return groups, structure, leaves


def sidecar_from_records(*, step: int, trees: Mapping[str, Mapping[str, Any]],
                         records: list[Mapping[str, Mapping[str, dict]]],
                         meta: Mapping[str, Any]) -> dict[str, Any]:
    """The sidecar from every rank's :func:`local_shard_records` (``trees``
    gives the names, dtypes and global shapes).  A leaf one record covers
    whole keeps that digest; a sharded one lists its shards."""
    groups: dict[str, Any] = {}
    tree: dict[str, Any] = {}
    leaves: dict[str, Any] = {}
    shards: dict[str, Any] = {}
    for item in ITEMS:
        lv: dict[str, str] = {}
        for name, t in trees[item].items():
            recs = sorted((r[item][name] for r in records if name in r.get(item, {})),
                          key=lambda r: r["offsets"])
            if not recs:
                raise ValueError(f"no rank hashed {item}/{name}")
            if len(recs) == 1 and recs[0]["sizes"] == list(t.shape):
                lv[name] = recs[0]["digest"]
            else:
                shards.setdefault(item, {})[name] = recs
                lv[name] = _combine_shards(recs)
        g, tree[item] = _groups(item, trees[item], lv)
        groups.update(g)
        leaves[item] = lv
    out = {
        "format": INTEGRITY_FORMAT,
        "algo": DIGEST_ALGO,
        "chunk_bytes": CHUNK_BYTES,
        "step": int(step),
        "content": True,
        "groups": groups,
        "tree": tree,
        "leaves": leaves,
        "meta_digest": json_digest(dict(meta)),
    }
    if shards:
        out["shards"] = shards
    return out


def build_sidecar(*, step: int, trees: Mapping[str, Mapping[str, Any]],
                  meta: Mapping[str, Any], workers: int = 0) -> dict[str, Any]:
    """The sidecar of a one-process save, over the exact host tensors handed
    to DCP (``trees``: item -> flat dict), hashed on ``workers`` threads
    (default: the CPU count)."""
    return sidecar_from_records(
        step=step, trees=trees, meta=meta,
        records=[local_shard_records({i: trees[i] for i in ITEMS}, workers=workers)])


# ---------------------------------------------------------------------------
# template-free reads and verification
# ---------------------------------------------------------------------------


def read_item(step_dir: Path, item: str, *, pin_memory: bool = False) -> dict[str, Any]:
    """Read one DCP item back as host tensors from its metadata alone
    (``pin_memory`` for tensors that go on to a card)."""
    import torch
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = Path(step_dir) / item
    md = dcp.FileSystemReader(str(path)).read_metadata()
    sd = {}
    for key, m in md.state_dict_metadata.items():
        if not isinstance(m, TensorStorageMetadata):
            raise ValueError(f"{item}/{key}: not a tensor entry ({type(m).__name__})")
        sd[key] = torch.empty(tuple(m.size), dtype=m.properties.dtype, pin_memory=pin_memory)
    # a rank-local read, under a process group too (only rank 0 verifies)
    dcp.load(sd, storage_reader=dcp.FileSystemReader(str(path)),
             **dcp_kwargs(dcp.load, local=True))
    return sd


def _CheckpointException() -> type:
    """DCP's error type, which derives from ``BaseException``."""
    from torch.distributed.checkpoint.api import CheckpointException

    return CheckpointException


def dcp_kwargs(fn, *, local: bool = False) -> dict:
    """How the DCP function ``fn`` (``save``, ``async_save``, ``load``) runs
    here: ``{}`` under a live process group, ``{"no_dist": True}`` for one
    process alone or (``local``) a read this rank makes on its own.  A torch
    whose ``fn`` takes no ``no_dist`` is refused."""
    import inspect

    import torch
    import torch.distributed as dist

    if not local and dist.is_available() and dist.is_initialized():
        return {}
    if "no_dist" in inspect.signature(fn).parameters:
        return {"no_dist": True}
    raise RuntimeError(
        f"torch {torch.__version__}: torch.distributed.checkpoint.{fn.__name__} takes no "
        f"no_dist and no process group is up; start one before checkpointing")


@dataclasses.dataclass
class StepVerification:
    """One step's verdict: ``ok`` (every digest matches), ``legacy`` (no
    sidecar; restorable with a warning), ``corrupt`` (a mismatch or an
    unreadable item) or ``gone`` (the step dir vanished mid-verify)."""

    step: int
    status: str
    failures: list[str] = dataclasses.field(default_factory=list)
    groups_checked: int = 0
    seconds: float = 0.0

    @property
    def passed(self) -> bool:
        return self.status != "corrupt"

    def to_dict(self) -> dict[str, Any]:
        return {"step": self.step, "status": self.status, "failures": list(self.failures),
                "groups_checked": self.groups_checked, "seconds": round(self.seconds, 3)}


def _step_dir(directory, step: int) -> Path:
    return Path(directory) / str(int(step))


def read_sidecar(directory, step: int) -> Optional[dict]:
    path = _step_dir(directory, step) / SIDECAR_NAME
    return json.loads(path.read_text()) if path.exists() else None


def verify_step(directory, step: int, *, keep: Optional[dict] = None) -> StepVerification:
    """Template-free verification of one committed step: read the sidecar,
    read every item back from its DCP metadata, re-hash and compare.  Any
    read failure of a digested item is a verification failure.  With
    ``keep`` (a dict), a step that verifies leaves its host tensors there
    (``keep[item]``) so a restore need not read them twice."""
    t0 = time.perf_counter()
    sdir = _step_dir(directory, step)
    if not sdir.exists():
        return StepVerification(step=int(step), status="gone", seconds=time.perf_counter() - t0)
    if not (sdir / SIDECAR_NAME).exists():
        return StepVerification(step=int(step), status="legacy",
                                seconds=time.perf_counter() - t0)
    failures: list[str] = []
    groups_checked = 0
    try:
        sidecar = json.loads((sdir / SIDECAR_NAME).read_text())
    except Exception as e:  # noqa: BLE001 — an unreadable sidecar is corruption
        return StepVerification(
            step=int(step), status="corrupt" if sdir.exists() else "gone",
            failures=[f"integrity sidecar unreadable: {type(e).__name__}: {e}"]
            if sdir.exists() else [], seconds=time.perf_counter() - t0)
    if sidecar.get("algo") != DIGEST_ALGO or sidecar.get("chunk_bytes") != CHUNK_BYTES:
        return StepVerification(
            step=int(step), status="corrupt",
            failures=[f"unknown digest algo {sidecar.get('algo')!r} / chunk "
                      f"{sidecar.get('chunk_bytes')!r} (this build computes {DIGEST_ALGO} "
                      f"over {CHUNK_BYTES}-byte chunks)"],
            seconds=time.perf_counter() - t0)
    if int(sidecar.get("step", -1)) != int(step):
        failures.append(f"stale sidecar: records step {sidecar.get('step')} but lives in "
                        f"step {step}")
    want_meta = sidecar.get("meta_digest")
    if want_meta is not None:
        groups_checked += 1
        try:
            have = json_digest(json.loads((sdir / META_NAME).read_text()))
            if have != want_meta:
                failures.append(f"meta: digest mismatch (saved {want_meta}, read back {have})")
        except Exception as e:  # noqa: BLE001 — read failure = corrupt
            failures.append(f"meta: unreadable ({type(e).__name__}: {e})")
    expected = dict(sidecar.get("groups") or {})
    read_back = {}
    for item in ITEMS:
        item_groups = {g: v for g, v in expected.items()
                       if g == item or g.startswith(item + "/")}
        if not item_groups:
            continue
        try:
            import torch

            flat = read_item(sdir, item,
                             pin_memory=keep is not None and torch.cuda.is_available())
        except (Exception, _CheckpointException()) as e:  # noqa: BLE001 — read failure = corrupt
            failures.append(f"{item}: unreadable ({type(e).__name__}: {str(e)[:300]})")
            continue
        item_shards = {n: [dict(r) for r in recs] for n, recs in
                       ((sidecar.get("shards") or {}).get(item) or {}).items()}
        got_groups, got_struct, got_leaves = tree_digest_groups(item, flat, shards=item_shards)
        for name, recs in sorted(item_shards.items()):
            want = {tuple(r["offsets"]): r["digest"]
                    for r in (sidecar["shards"][item].get(name) or [])}
            for r in recs:
                if want.get(tuple(r["offsets"])) != r["digest"]:
                    failures.append(f"{item}/{name}: shard at offsets {r['offsets']} "
                                    f"(sizes {r['sizes']}) digest mismatch")
        want_struct = dict((sidecar.get("tree") or {}).get(item) or {})
        for path in sorted(set(want_struct) | set(got_struct))[:2048]:
            if want_struct.get(path) != got_struct.get(path):
                failures.append(f"{item}/{path}: structure drift (saved "
                                f"{want_struct.get(path)}, read back {got_struct.get(path)})")
        want_leaves = dict((sidecar.get("leaves") or {}).get(item) or {})
        for g in sorted(item_groups):
            groups_checked += 1
            want_d = item_groups[g].get("digest")
            have_d = (got_groups.get(g) or {}).get("digest")
            if have_d != want_d:
                bad = [p for p in sorted(got_leaves)
                       if _group_of(item, p) == g and want_leaves.get(p) != got_leaves[p]]
                failures.append(f"{g}: content digest mismatch (saved {want_d}, read back "
                                f"{have_d}; leaves {bad[:4]})")
        read_back[item] = flat
    if failures and not sdir.exists():
        # deleted under the read (retention or a concurrent quarantine): a
        # race, not corruption
        return StepVerification(step=int(step), status="gone",
                                seconds=time.perf_counter() - t0)
    if not failures and keep is not None:
        keep.update(read_back)
    return StepVerification(step=int(step), status="corrupt" if failures else "ok",
                            failures=failures, groups_checked=groups_checked,
                            seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------


def _reason_slug(reason: str) -> str:
    slug = re.sub(r"[^A-Za-z0-9]+", "-", reason).strip("-").lower()
    return (slug or "corrupt")[:48]


def quarantine_name(step: int, reason: str) -> str:
    return f"{QUARANTINE_PREFIX}{int(step)}.{_reason_slug(reason)}"


def parse_quarantine_name(name: str) -> Optional[int]:
    """Step number of a quarantined dir name, or ``None`` for anything else."""
    if not name.startswith(QUARANTINE_PREFIX):
        return None
    head = name[len(QUARANTINE_PREFIX):].split(".", 1)[0]
    return int(head) if head.isdigit() else None


def read_ledger(directory) -> list[dict[str, Any]]:
    """Entries of the quarantine ledger (empty when none)."""
    path = Path(directory) / LEDGER_NAME
    try:
        if not path.exists():
            return []
        return list(json.loads(path.read_text()).get("entries") or [])
    except Exception as e:  # noqa: BLE001 — a torn ledger must not block
        logger.warning("quarantine ledger %s unreadable: %s", path, e)
        return []


def apply_quarantine(directory, step: int, *, reason: str,
                     failures: Optional[list[str]] = None) -> bool:
    """Rename ``<dir>/<step>`` out of the discovery namespace and record the
    ledger entry; True when the step dir was moved."""
    from neuronx_distributed_training_torch.utils.io import atomic_write_json

    directory = Path(directory)
    src = _step_dir(directory, step)
    dst = directory / quarantine_name(step, reason)
    moved = False
    try:
        if src.exists():
            src.rename(dst)
            moved = True
    except OSError as e:
        logger.error("quarantine of step %d failed to rename %s -> %s: %s (the corrupt "
                     "step remains discoverable; remove it by hand)", step, src, dst, e)
    entries = read_ledger(directory)
    entries.append({"step": int(step), "reason": reason, "failures": list(failures or [])[:16],
                    "quarantined_to": dst.name if moved else None,
                    "time": time.strftime("%Y-%m-%d %H:%M:%S")})
    try:
        atomic_write_json(directory / LEDGER_NAME, {"entries": entries})
    except OSError as e:
        logger.warning("quarantine ledger write failed for step %d: %s", step, e)
    logger.error("checkpoint step %d QUARANTINED (%s): %s", step, reason,
                 "; ".join((failures or ["no detail"])[:4]))
    return moved


# ---------------------------------------------------------------------------
# corruption injection (for tests and drills)
# ---------------------------------------------------------------------------


def inject_corruption(directory, step: int, kind: str, *, item: str = "params") -> str:
    """Damage a committed step on purpose; returns what was done.

    - ``byte_flip``      flip one byte in the middle of the largest data file
      of ``item``;
    - ``truncate``       cut that file in half;
    - ``delete_item``    remove the whole ``item`` directory;
    - ``stale_sidecar``  replace the step's sidecar with the next-older
      step's (or zero every group digest when there is none).
    """
    if kind not in CORRUPTION_KINDS:
        raise ValueError(f"unknown corruption kind {kind!r}; supported: "
                         f"{'/'.join(CORRUPTION_KINDS)}")
    directory = Path(directory)
    sdir = _step_dir(directory, step)
    if not sdir.exists():
        raise FileNotFoundError(f"no committed step {step} under {directory}")
    if kind in ("byte_flip", "truncate"):
        root = sdir / item
        files = sorted((p for p in root.rglob("*.distcp") if p.is_file()),
                       key=lambda p: p.stat().st_size, reverse=True) if root.exists() else []
        if not files:
            raise FileNotFoundError(f"no data files under {root} to corrupt")
        target = files[0]
        size = target.stat().st_size
        if kind == "byte_flip":
            pos = max(size // 2 - 1, 0)
            with open(target, "r+b") as f:
                f.seek(pos)
                b = f.read(1)
                f.seek(pos)
                f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))
            return f"byte_flip: flipped byte {pos} of {target.relative_to(sdir)} ({size} bytes)"
        with open(target, "r+b") as f:
            f.truncate(max(size // 2, 1))
        return f"truncate: {target.relative_to(sdir)} {size} -> {max(size // 2, 1)} bytes"
    if kind == "delete_item":
        root = sdir / item
        if not root.exists():
            raise FileNotFoundError(f"no item {item} under {sdir}")
        shutil.rmtree(root)
        return f"delete_item: removed {item}/"
    dst = sdir / SIDECAR_NAME
    if not dst.exists():
        raise FileNotFoundError(f"step {step} has no integrity sidecar to go stale")
    older = sorted((int(p.name) for p in directory.iterdir()
                    if p.name.isdigit() and int(p.name) < int(step)
                    and (p / SIDECAR_NAME).exists()), reverse=True)
    if older:
        dst.write_text((directory / str(older[0]) / SIDECAR_NAME).read_text())
        return f"stale_sidecar: copied step {older[0]}'s sidecar over {step}'s"
    side = json.loads(dst.read_text())
    for g in side.get("groups", {}).values():
        g["digest"] = "0" * 32
    dst.write_text(json.dumps(side))
    return "stale_sidecar: zeroed every group digest (no older sidecar)"


# ---------------------------------------------------------------------------
# post-commit save audit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AuditStats:
    audited: int = 0
    failed: int = 0
    seconds: float = 0.0
    incomplete: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {"audited": self.audited, "failed": self.failed,
                "seconds": round(self.seconds, 3), "incomplete": self.incomplete}


class SaveAuditor:
    """Background read-back verification of committed steps.

    :meth:`schedule` enqueues a committed step; a daemon thread verifies it;
    :meth:`poll` returns finished verdicts without waiting; :meth:`drain`
    bounds the teardown wait, counting unfinished jobs ``incomplete``."""

    def __init__(self, directory, *,
                 verify_fn: Optional[Callable[[Any, int], StepVerification]] = None):
        self.directory = directory
        self._verify = verify_fn or (lambda d, s: verify_step(d, s))
        self._q: "queue.Queue[Optional[int]]" = queue.Queue()
        self._cond = threading.Condition()
        self._pending = 0
        self._done: list[StepVerification] = []
        self.stats = AuditStats()
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="nxdt-ckpt-audit")
            self._thread.start()

    def _run(self) -> None:
        while True:
            step = self._q.get()
            if step is None:
                return
            t0 = time.perf_counter()
            try:
                v = self._verify(self.directory, int(step))
            except Exception as e:  # noqa: BLE001 — the audit failing is a verdict
                v = StepVerification(step=int(step), status="corrupt",
                                     failures=[f"audit error: {type(e).__name__}: {e}"])
            v.seconds = time.perf_counter() - t0
            with self._cond:
                self._done.append(v)
                self.stats.audited += 1
                self.stats.seconds += v.seconds
                if v.status == "corrupt":
                    self.stats.failed += 1
                self._pending -= 1
                self._cond.notify_all()

    def schedule(self, step: int) -> None:
        if self._closed:
            return
        self._ensure_thread()
        with self._cond:
            self._pending += 1
        self._q.put(int(step))

    def poll(self) -> list[StepVerification]:
        with self._cond:
            out, self._done = self._done, []
            return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending > 0:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    self.stats.incomplete += self._pending
                    logger.warning("save audit: %d verification(s) still running at the "
                                   "drain deadline", self._pending)
                    return False
                self._cond.wait(timeout=remaining)
        return True

    def close(self, timeout: Optional[float] = None) -> list[StepVerification]:
        self._closed = True
        self.drain(timeout)
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
        return self.poll()
