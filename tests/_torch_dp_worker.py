"""One rank of the port's data-parallel tests (``tests/test_torch_dp.py``).

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_dp_worker.py <spec.json>

Starts the gloo process group through ``utils/launch.py`` (as the CLI does
under torchrun), runs the spec's scenarios in order, each a trainer built
from a config under this group, and writes ``<out>/rank<r>.json`` (and, on
rank 0, ``.pt`` files of the trained state).  Imports torch and the port,
never jax.

A scenario is ``{"name", "cfg", "steps", "weights"?, "data"?, "max_steps"?,
"dump"?}``:
- ``weights``: a ``.pt`` dict of dotted param names to start from (the
  optimizer state is re-initialised from them);
- ``data``: ``{"kind": "sft_mask", "seed": s}`` for :class:`MaskedRows`,
  ``{"kind": "nan_rows", "step": i, "rows": [...]}`` for synthetic rows with
  a NaN ``loss_mask`` in those global rows of step ``i``;
- ``max_steps``: stop the fit there (a preempted run; the config's
  ``max_steps`` still sets the schedule);
- ``dump``: write the trained params and the gathered optimizer state.
"""

from __future__ import annotations

import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neuronx_distributed_training_torch.config.loader import load_config  # noqa: E402
from neuronx_distributed_training_torch.data.loader import (  # noqa: E402
    DataModule,
    SyntheticDataModule,
)
from neuronx_distributed_training_torch.models import llama  # noqa: E402
from neuronx_distributed_training_torch.optim.adamw import (  # noqa: E402
    init_opt_state,
    local,
    opt_state_specs,
)
from neuronx_distributed_training_torch.trainer.loop import Trainer  # noqa: E402
from neuronx_distributed_training_torch.utils.launch import (  # noqa: E402
    initialize_distributed,
)


def masked_rows(idx, *, seq: int, vocab: int, seed: int) -> dict:
    """SFT-like rows: random tokens, and a loss mask over a random suffix of
    each row, so rows (and ranks) hold different numbers of loss tokens."""
    ids = np.empty((len(idx), seq), np.int32)
    mask = np.zeros((len(idx), seq), np.float32)
    for r, i in enumerate(idx):
        rng = np.random.default_rng(seed * 1_000_003 + int(i))
        ids[r] = rng.integers(0, vocab, seq)
        mask[r, int(rng.integers(1, seq - 1)):] = 1.0
    return {"input_ids": ids, "labels": ids.copy(), "loss_mask": mask}


class MaskedRows(DataModule):
    def __init__(self, vocab_size: int, seq_len: int, global_batch_size: int, *, seed: int):
        self.vocab_size, self.seq_len, self.seed = vocab_size, seq_len, seed
        super().__init__(1 << 12, global_batch_size)

    def fetch_rows(self, idx):
        return masked_rows(idx, seq=self.seq_len, vocab=self.vocab_size, seed=self.seed)


class NanRows(SyntheticDataModule):
    """Synthetic rows; the global batch of step ``step`` gets a NaN
    ``loss_mask`` in ``rows`` (how ``tests/test_health.py`` poisons one)."""

    def __init__(self, *a, step: int, rows: list, **kw):
        super().__init__(*a, **kw)
        self.poison_step, self.poison_rows = step, list(rows)

    def global_batches(self):
        for i, batch in enumerate(super().global_batches()):
            if i == self.poison_step:
                batch["loss_mask"] = batch["loss_mask"].copy()
                batch["loss_mask"][self.poison_rows] = np.nan
            yield batch


def _data(cfg, spec):
    d = spec.get("data")
    if d is None:
        return None
    m, data = cfg["model"], cfg["data"]
    if d["kind"] == "sft_mask":
        return MaskedRows(m["vocab_size"], data["seq_length"], data["global_batch_size"],
                          seed=d["seed"])
    return NanRows(m["vocab_size"], data["seq_length"], data["global_batch_size"],
                   seed=int(cfg.get("seed", 1234)), step=d["step"], rows=d["rows"])


def _gathered(t) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def run(spec: dict, rank: int) -> dict:
    cfg = load_config(spec["cfg"])
    trainer = Trainer.from_config(cfg, device="cpu", data_module=_data(cfg, spec))
    out: dict = {"zero1_shards": {}}
    if spec.get("weights"):
        src = torch.load(spec["weights"])
        with torch.no_grad():
            for n, p in llama.named_params(trainer.params).items():
                p.copy_(src[n])
        flat = llama.named_params(trainer.params)
        specs = opt_state_specs(flat, trainer.dp.size,
                                zero1=bool(cfg.distributed_strategy.get("zero1", True)),
                                policy=trainer.policy, health=trainer.health.enabled)
        trainer.opt_state = init_opt_state(flat, trainer.policy, health=trainer.health.enabled,
                                           specs=specs, dp=trainer.dp)
    for n, t in trainer.opt_state["mu"].items():
        out["zero1_shards"][n] = [list(t.shape), list(local(t).shape)]
    if spec.get("max_steps"):
        trainer.max_steps = int(spec["max_steps"])
    history = trainer.fit()
    out["history"] = history
    out["stop_class"] = trainer.stop_class
    out["opt_step"] = trainer.opt_state["step"]
    out["health"] = trainer.opt_state.get("health")
    out["committed"] = trainer.checkpointer.committed_steps if trainer.checkpointer else []
    if spec.get("dump"):
        state = {f"params/{n}": p.detach().clone()
                 for n, p in llama.named_params(trainer.params).items()}
        for g in ("mu", "nu", "master"):
            for n, t in trainer.opt_state.get(g, {}).items():
                state[f"{g}/{n}"] = _gathered(t).detach().clone()
        if rank == 0:
            torch.save(state, Path(spec["dump"]))
    return out


def main() -> None:
    spec = json.loads(Path(sys.argv[1]).read_text())
    cluster = initialize_distributed(device="cpu")
    rank = cluster.process_id
    results = {}
    try:
        for scenario in spec["scenarios"]:
            results[scenario["name"]] = run(scenario, rank)
    except BaseException:
        results["error"] = traceback.format_exc()
        raise
    finally:
        Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(results, default=float))
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
