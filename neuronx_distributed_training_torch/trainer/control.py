"""Coordinated fleet control: consensus stop decisions + the operator channel.

Every *recovery* ingredient this repo ships — elastic resume, integrity
walk-back, per-host beacons and alerts — is host-local at the DECISION
layer: an ``action: halt`` alert, a health-policy halt, or a SIGTERM notice
on one host used to stop that host alone, deadlocking every other host at
the next collective rendezvous.  This module makes every stop/checkpoint
decision fleet-consistent (docs/observability.md "Fleet control"):

- **Control word** — each host folds its local conditions (alert halt,
  health halt, SIGTERM/preemption notice, max_time, operator command) into
  a small bitmask.  At every *deterministic* logging boundary (cadence
  steps every host computes identically — never a host-local trigger) the
  word rides ONE tiny replicated collective (:func:`fold_word_fleet`, a
  per-bit max ≡ bitwise OR across processes), so all hosts derive the SAME
  decision — ``stop`` (graceful, with the grace-window emergency save),
  ``halt`` (numerics: stop WITHOUT a checkpoint), ``checkpoint_now`` or
  ``dump`` — at the same step.  A SIGTERM that only one host received
  becomes a fleet-wide drained emergency save at the next boundary.

- **Operator command channel** — ``control/commands.jsonl`` in the run
  dir: ``tools/run_ctl.py`` appends one JSON line per command
  (``stop`` / ``checkpoint_now`` / ``dump``); rank 0 polls the file at the
  boundary, dedupes by command id, folds the bits into the same control
  word, and records parse/dedupe/ack as the ``control`` trail in
  ``run_summary.json``.

- **Exit-code table** — one table for the failure classes an orchestrator
  keys restart-vs-page policy off: hang escape, all-corrupt store, elastic
  refusal, alert/health halt, data stall, clean stop.  ``nxdt-train``
  exits with these codes and the drills assert them.

Deliberately **stdlib-only at import time** (the ``telemetry.fleet``
posture) so ``tools/run_ctl.py`` can load this file by path on a login
node; the one torch touch (:func:`fold_word_fleet`) imports lazily and is a
no-op in a single-process run.  (The PyTorch port's copy of the JAX
package's ``trainer/control.py``: the same bits, texts, files and exit
codes; the fold is a ``torch.distributed`` MAX all-reduce of the bits.)
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Mapping, Optional

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# the control word
# ---------------------------------------------------------------------------

#: condition name -> bit.  The word is the bitwise OR of every host's local
#: conditions; per-bit max across processes == bitwise OR, so the fold is a
#: plain integer max/or collective.
CONDITION_BITS: dict[str, int] = {
    "preemption": 1 << 0,      # SIGTERM / preemption notice (graceful stop)
    "alert_halt": 1 << 1,      # alert rule with action: halt (graceful stop)
    "operator_stop": 1 << 2,   # run_ctl stop command (graceful stop)
    "max_time": 1 << 3,        # trainer.max_time budget spent (graceful stop)
    "health_halt": 1 << 4,     # numerics halt: stop WITHOUT a checkpoint
    "checkpoint_now": 1 << 5,  # operator checkpoint_now (one-shot)
    "dump": 1 << 6,            # operator dump: forensic bundle (one-shot)
    "data_stall": 1 << 7,      # data source stalled (exit-path annotation)
}

#: graceful-stop bits: the run checkpoints (grace-window emergency save)
#: and exits clean — an orchestrator just restarts it
STOP_MASK = (CONDITION_BITS["preemption"] | CONDITION_BITS["alert_halt"]
             | CONDITION_BITS["operator_stop"] | CONDITION_BITS["max_time"])

#: halt bits: the model state is poisoned — stop WITHOUT a checkpoint so
#: auto-resume finds the last good save
HALT_MASK = CONDITION_BITS["health_halt"]

#: one-shot bits: acted on at the deciding boundary, then cleared (a second
#: checkpoint_now command sets them again)
ONESHOT_MASK = CONDITION_BITS["checkpoint_now"] | CONDITION_BITS["dump"]

#: reason-priority order when several conditions land in one word
_PRIORITY = ("health_halt", "preemption", "alert_halt", "operator_stop",
             "max_time", "checkpoint_now", "dump", "data_stall")


def condition_names(word: int) -> list[str]:
    """The condition names set in ``word``, priority-ordered."""
    return [n for n in _PRIORITY if word & CONDITION_BITS[n]]


def fold_word_fleet(word: int) -> int:
    """The boundary's ONE tiny replicated collective: every process
    contributes its local word; the fold is a per-bit max (== bitwise OR).
    Single-process runs skip the collective entirely — zero cost, and the
    return value is exact either way.  Must ONLY be called at a step every
    host reaches (the deterministic boundary cadence): a host-local call
    site would be exactly the rendezvous mismatch this module exists to
    kill.  Under the trainer's control plane this is the boundary's one
    collective: the stop agreement it replaces is not made as well."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return int(word)
    return words_from_bits(_all_reduce_bits(word_bits(word)))


def word_bits(word: int) -> list[int]:
    """``word`` as one 0/1 entry per :data:`CONDITION_BITS` bit (NCCL has
    no bitwise-or reduction: a MAX all-reduce of the bits is the OR)."""
    return [1 if int(word) & bit else 0 for bit in CONDITION_BITS.values()]


def words_from_bits(bits) -> int:
    """Inverse of :func:`word_bits`."""
    return sum(bit for bit, b in zip(CONDITION_BITS.values(), bits) if int(b))


def _all_reduce_bits(bits: list[int]) -> list[int]:
    import torch
    import torch.distributed as dist

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor(bits, dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


# ---------------------------------------------------------------------------
# exit-code table
# ---------------------------------------------------------------------------

#: THE exit-code table (docs/observability.md "Fleet control").  One module
#: owns it; ``nxdt-train`` exits with these and the drills assert them, so
#: an orchestrator can pick restart-vs-page policy from the code alone.
#: 0 = clean (completion OR a graceful consensus stop — resumable, just
#: restart); 1 = unclassified failure; the 83+ block is deliberately above
#: the shell/signal range (a SIGKILL'd process reports 137 = 128+9).
EXIT_OK = 0                  # clean completion / graceful stop: restart
EXIT_ERROR = 1               # unclassified failure: inspect
EXIT_HANG_ESCAPE = 83        # watchdog killed a hung collective: restart
EXIT_ALL_CORRUPT = 84        # every retained checkpoint corrupt: page
EXIT_ELASTIC_REFUSED = 85    # no legal plan resumes this save here: page
EXIT_HEALTH_HALT = 86        # numerics halt (state poisoned): restart+page
EXIT_ALERT_HALT = 87         # alert rule stopped the run: page
EXIT_DATA_STALL = 88         # data source hung past the watchdog: page

EXIT_CODES: dict[str, int] = {
    "ok": EXIT_OK,
    "error": EXIT_ERROR,
    "hang_escape": EXIT_HANG_ESCAPE,
    "all_corrupt": EXIT_ALL_CORRUPT,
    "elastic_refused": EXIT_ELASTIC_REFUSED,
    "health_halt": EXIT_HEALTH_HALT,
    "alert_halt": EXIT_ALERT_HALT,
    "data_stall": EXIT_DATA_STALL,
}

_EXIT_NAMES = {v: k for k, v in EXIT_CODES.items()}


def exit_code_name(code: int) -> str:
    """Reverse lookup for reports/drills; unknown codes render as the
    number."""
    return _EXIT_NAMES.get(int(code), str(int(code)))


def exit_code_for_stop(stop_class: Optional[str]) -> int:
    """Map a run's recorded stop class (``Trainer.stop_class``) to its exit
    code.  Graceful stops (preemption, operator, max_time, clean
    completion) are EXIT_OK — an orchestrator just restarts; only the
    classes that want a human land nonzero."""
    if stop_class in ("health_halt", "alert_halt", "data_stall"):
        return EXIT_CODES[stop_class]
    return EXIT_OK


# ---------------------------------------------------------------------------
# knob block: exp_manager.telemetry.control
# ---------------------------------------------------------------------------


def _control_knobs() -> set:
    return {f.name for f in dataclasses.fields(ControlConfig)}


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """``exp_manager.telemetry.control`` (validated at config load).

    .. code-block:: yaml

        exp_manager:
          telemetry:
            control:
              enabled: false      # consensus control word at each boundary
              poll_commands: true # rank 0 polls control/commands.jsonl
              hang_escape: true   # armed watchdog exits EXIT_HANG_ESCAPE
              max_trail: 64       # decisions/commands kept in run_summary
    """

    enabled: bool = False
    poll_commands: bool = True
    hang_escape: bool = True
    max_trail: int = 64

    @classmethod
    def from_config(cls, block: Any) -> "ControlConfig":
        """Accepts ``None`` (defaults: disabled), a bare bool, or a mapping.
        Unknown keys raise with a did-you-mean hint — a typo'd knob must not
        silently leave the fleet uncoordinated."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        knobs = _control_knobs()
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.telemetry.control must be a mapping of "
                f"{sorted(knobs)} (or a single bool), got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - knobs
        if unknown:
            from neuronx_distributed_training_torch.config.loader import (
                did_you_mean,
            )

            raise ValueError(
                f"unknown exp_manager.telemetry.control keys "
                f"{sorted(unknown)}; supported: {sorted(knobs)}"
                + did_you_mean(unknown, knobs)
            )
        values = dict(block)
        for key in ("enabled", "poll_commands", "hang_escape"):
            if key in values and not isinstance(values[key], bool):
                raise ValueError(
                    f"exp_manager.telemetry.control.{key} must be a "
                    f"boolean, got {values[key]!r}"
                )
        if "max_trail" in values and (isinstance(values["max_trail"], bool)
                                      or not isinstance(values["max_trail"],
                                                        int)):
            raise ValueError(
                f"exp_manager.telemetry.control.max_trail must be an "
                f"integer, got {values['max_trail']!r}"
            )
        out = cls(
            enabled=bool(values.get("enabled", cls.enabled)),
            poll_commands=bool(values.get("poll_commands",
                                          cls.poll_commands)),
            hang_escape=bool(values.get("hang_escape", cls.hang_escape)),
            max_trail=int(values.get("max_trail", cls.max_trail)),
        )
        if out.max_trail < 1:
            raise ValueError(
                f"exp_manager.telemetry.control.max_trail must be >= 1, "
                f"got {out.max_trail}"
            )
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# the operator command channel
# ---------------------------------------------------------------------------

#: subdirectory of the run dir holding the command queue (+ room for future
#: control artifacts)
CONTROL_DIR = "control"
COMMANDS_FILE = "commands.jsonl"

#: operator command -> control-word condition
COMMAND_CONDITIONS: dict[str, str] = {
    "stop": "operator_stop",
    "checkpoint_now": "checkpoint_now",
    "dump": "dump",
}


def commands_path(run_dir: str | Path) -> Path:
    return Path(run_dir) / CONTROL_DIR / COMMANDS_FILE


def append_command(run_dir: str | Path, command: str,
                   note: Optional[str] = None) -> dict[str, Any]:
    """Enqueue one operator command (the ``tools/run_ctl.py`` entry): a
    single ``write()`` of one newline-terminated JSON line in append mode —
    the same torn-tail-tolerant contract the fleet beacons use, so a
    concurrent poll never sees half a record.  Returns the enqueued record
    (with its generated id)."""
    if command not in COMMAND_CONDITIONS:
        raise ValueError(
            f"unknown control command {command!r}; supported: "
            f"{sorted(COMMAND_CONDITIONS)}"
        )
    rec: dict[str, Any] = {
        "id": uuid.uuid4().hex[:12],
        "command": command,
        "t_wall": round(time.time(), 6),
    }
    if note:
        rec["note"] = str(note)[:200]
    path = commands_path(run_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    line = json.dumps(rec) + "\n"
    with open(path, "a") as f:
        f.write(line)
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:  # pragma: no cover — some filesystems refuse
            pass
    return rec


def _read_new_lines(path: Path, offset: int) -> tuple[list[dict], int]:
    """New COMPLETE records past ``offset`` -> (records, new offset).  A
    torn tail line waits for the next poll; a malformed complete line is
    returned as ``{"_malformed": line}`` so the ack trail can name it
    instead of silently dropping an operator's command."""
    try:
        size = path.stat().st_size
    except OSError:
        return [], offset
    if size <= offset:
        return [], offset
    with open(path) as f:
        f.seek(offset)
        chunk = f.read(size - offset)
    end = chunk.rfind("\n")
    if end < 0:
        return [], offset
    out: list[dict] = []
    for line in chunk[: end + 1].splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            out.append({"_malformed": line[:200]})
            continue
        out.append(rec if isinstance(rec, dict)
                   else {"_malformed": repr(rec)[:200]})
    return out, offset + end + 1


# ---------------------------------------------------------------------------
# the boundary decision
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ControlDecision:
    """What ONE deterministic boundary decided, identically on every host."""

    step: int
    word: int
    conditions: list[str]
    stop: bool = False          # graceful stop (emergency save, exit clean)
    halt: bool = False          # numerics halt (NO checkpoint)
    checkpoint_now: bool = False
    dump: bool = False
    reason: str = ""
    source: str = "local"       # local | operator | fleet

    @property
    def any(self) -> bool:
        return bool(self.word)

    def to_dict(self) -> dict:
        out = {
            "step": int(self.step),
            "word": int(self.word),
            "conditions": list(self.conditions),
            "reason": self.reason,
            "source": self.source,
        }
        for k in ("stop", "halt", "checkpoint_now", "dump"):
            if getattr(self, k):
                out[k] = True
        return out


class ControlPlane:
    """What the fit loop holds: this host's local-condition register, the
    rank-0 command poll, the boundary fold, and the ``control`` trail in
    ``run_summary.json``.

    All methods are host-side bookkeeping except :meth:`boundary`'s fold,
    which is the documented one-per-boundary collective.  ``peer_words``
    is the drill/test seam: a callable returning extra word bits that
    stand in for other hosts' contributions on a single-process mesh (the
    production path folds real processes via :func:`fold_word_fleet`).
    """

    def __init__(
        self,
        cfg: ControlConfig,
        run_dir: str | Path,
        *,
        host: int = 0,
        poll_commands: Optional[bool] = None,
        write_run_summary: Optional[Callable[[dict], None]] = None,
        peer_words: Optional[Callable[[], int]] = None,
        fold: Optional[Callable[[int], int]] = None,
    ) -> None:
        self.cfg = cfg
        self.run_dir = Path(run_dir)
        self.host = int(host)
        # rank 0 polls by default; every host COULD poll (the file is
        # host-local on non-shared filesystems anyway) but one poller keeps
        # the ack trail single-writer
        self.poll = (cfg.poll_commands if poll_commands is None
                     else bool(poll_commands))
        self._write_run_summary = write_run_summary
        self._peer_words = peer_words
        self._fold = fold if fold is not None else fold_word_fleet
        self._offset = 0
        self._seen_ids: set[str] = set()
        # local conditions: persistent stop/halt bits + one-shot bits,
        # each with the host-local reason that requested it
        self._word = 0
        self._reasons: dict[str, str] = {}
        #: mirrored to run_summary.json "control" as things happen
        self.commands: list[dict] = []
        self.decisions: list[dict] = []
        # a restarted incarnation re-reads commands.jsonl from offset 0: a
        # command the PREVIOUS incarnation already acted on (an operator
        # `stop` that was obeyed, saved, and restarted) must come back as a
        # `duplicate`, not re-stop the run into a permanent stop/restart
        # loop — re-seed the dedupe set from the ack trail the previous
        # incarnation left in run_summary.json (the flight recorder's
        # anomaly-trail pattern).  The trail is capped at max_trail, so an
        # id older than the cap could in principle replay; operators should
        # not let hundreds of commands accumulate in one run dir.
        if self.poll:
            try:
                with open(self.run_dir / "run_summary.json") as f:
                    prior = (json.load(f).get("control") or {}).get(
                        "commands") or []
            except (OSError, ValueError, AttributeError):
                prior = []
            for ack in prior:
                try:
                    if ack.get("id"):
                        self._seen_ids.add(str(ack["id"]))
                except AttributeError:
                    continue

    # -- local conditions ---------------------------------------------------

    def request(self, condition: str, reason: str = "") -> None:
        """Register a host-local condition (alert halt, SIGTERM notice,
        health halt, max_time).  The bit rides the next boundary fold; the
        reason string stays host-local and becomes the decision's reason
        when this host's bit wins."""
        bit = CONDITION_BITS[condition]
        self._word |= bit
        if reason and condition not in self._reasons:
            self._reasons[condition] = reason

    @property
    def pending(self) -> bool:
        return bool(self._word)

    # -- the command poll (rank 0) ------------------------------------------

    def _poll_commands(self, step: int) -> None:
        recs, self._offset = _read_new_lines(
            commands_path(self.run_dir), self._offset)
        for rec in recs:
            if "_malformed" in rec:
                self._ack(step, {"id": None, "command": None},
                          "malformed", note=rec["_malformed"])
                continue
            cid = str(rec.get("id") or "")
            command = str(rec.get("command") or "")
            if cid and cid in self._seen_ids:
                self._ack(step, rec, "duplicate")
                continue
            if command not in COMMAND_CONDITIONS:
                self._ack(step, rec, "unknown")
                if cid:
                    self._seen_ids.add(cid)
                continue
            if cid:
                self._seen_ids.add(cid)
            cond = COMMAND_CONDITIONS[command]
            self.request(cond, f"operator command {command}"
                               + (f" ({rec['note']})" if rec.get("note")
                                  else ""))
            # operator-sourced bits report "operator", not "local"
            self._reasons.setdefault("_source_" + cond, "operator")
            self._ack(step, rec, "accepted")

    def _ack(self, step: int, rec: Mapping, status: str,
             note: Optional[str] = None) -> None:
        ack = {
            "id": rec.get("id"),
            "command": rec.get("command"),
            "step": int(step),
            "status": status,
        }
        if note or rec.get("note"):
            ack["note"] = note or rec.get("note")
        self.commands.append(ack)
        del self.commands[: max(0, len(self.commands) - self.cfg.max_trail)]
        logger.info("control: command %s (%s) %s at step %d",
                    ack["command"], ack["id"], status, step)
        self._write_trail()

    # -- the boundary -------------------------------------------------------

    def boundary(self, step: int) -> ControlDecision:
        """One deterministic logging boundary: poll the command channel
        (rank 0), fold every host's word through the one replicated
        collective, derive the decision all hosts share, record it in the
        trail, and clear this host's one-shot bits."""
        if self.poll:
            self._poll_commands(step)
        local = self._word
        word = local
        if self._peer_words is not None:
            try:
                word |= int(self._peer_words())
            except Exception as e:  # noqa: BLE001 — a drill seam must not kill
                logger.warning("control peer_words failed: %s", e)
        word = int(self._fold(word))
        decision = self._decide(step, word, local)
        # one-shot bits are consumed by this decision (locally; a remote
        # host's one-shot bit was cleared on ITS side the same boundary)
        self._word &= ~ONESHOT_MASK
        for cond in ("checkpoint_now", "dump"):
            self._reasons.pop(cond, None)
            self._reasons.pop("_source_" + cond, None)
        if decision.any:
            self.decisions.append(decision.to_dict())
            del self.decisions[
                : max(0, len(self.decisions) - self.cfg.max_trail)]
            self._write_trail()
        return decision

    def _decide(self, step: int, word: int, local: int) -> ControlDecision:
        conds = condition_names(word)
        decision = ControlDecision(step=int(step), word=int(word),
                                   conditions=conds)
        if not word:
            return decision
        decision.halt = bool(word & HALT_MASK)
        decision.stop = decision.halt or bool(word & STOP_MASK)
        decision.checkpoint_now = bool(
            word & CONDITION_BITS["checkpoint_now"])
        decision.dump = bool(word & CONDITION_BITS["dump"])
        # the deciding condition: highest-priority bit set; its reason is
        # host-local when this host requested it, an honest "fleet
        # consensus" marker when the bit arrived through the fold
        deciding = conds[0]
        if CONDITION_BITS[deciding] & local:
            src = self._reasons.get("_source_" + deciding, "local")
            reason = self._reasons.get(
                deciding, f"{deciding} requested on this host")
        else:
            src = "fleet"
            reason = (f"fleet consensus: {deciding} requested on another "
                      f"host")
        decision.source = src
        decision.reason = reason
        logger.warning(
            "control: boundary %d decided %s (word=0x%x, conditions=%s, "
            "source=%s): %s", step,
            "halt" if decision.halt else "stop" if decision.stop
            else "/".join(c for c in ("checkpoint_now", "dump")
                          if getattr(decision, c)) or "note",
            word, conds, src, reason)
        return decision

    def note_exit(self, condition: str, reason: str) -> None:
        """Record a terminal condition that never reaches a boundary fold
        (data stall raising out of the step path, the hang-escape exit) so
        the ``control`` trail still names the deciding condition."""
        self.decisions.append({
            "step": -1,
            "word": int(CONDITION_BITS.get(condition, 0)),
            "conditions": [condition],
            "reason": reason,
            "source": "local",
            "exit": True,
        })
        del self.decisions[: max(0, len(self.decisions) - self.cfg.max_trail)]
        self._write_trail()

    def _write_trail(self) -> None:
        if self._write_run_summary is None:
            return
        try:
            self._write_run_summary({"control": self.trail()})
        except Exception as e:  # noqa: BLE001 — observability must not kill
            logger.warning("control trail write failed: %s", e)

    def trail(self) -> dict:
        return {
            "enabled": True,
            "commands": list(self.commands),
            "decisions": list(self.decisions),
        }
