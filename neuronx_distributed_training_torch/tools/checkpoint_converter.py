"""Checkpoint converter CLI of the port: HF / NeMo-Megatron <-> the port's
native DCP checkpoint (counterpart of the repo's
``examples/checkpoint_converter.py``, with its modes and flags):

    python -m neuronx_distributed_training_torch.tools.checkpoint_converter \\
        --model llama --direction hf2native \\
        --config examples/conf/hf_llama3_8B_SFT_lora_config.yaml \\
        --input /path/to/hf_checkpoint_dir --output /path/to/native_ckpt [--device cpu]

- ``--model llama | mixtral | gpt``; ``--direction hf2native | native2hf |
  nnm2native | native2nnm`` (the Megatron directions, and ``--model gpt``,
  go through ``tools/convert_megatron.py``; ``--tp`` / ``--pp`` name a
  sharded NNM dir's degrees, ``mp_rank_XX`` or
  ``tp_rank_XX_pp_rank_XXX/model_optim_rng.ckpt``);
- the native side is a checkpoint in the port's layout
  (``checkpoint/manager.py``: DCP, digests in ``integrity.json``) at
  ``<output>/<step>/`` (``--step``, default 0) holding the weights, no
  optimizer state and step 0.  ``model.weight_init_only: true`` with
  ``exp_manager.resume_from_checkpoint: <output>`` warm-starts a run from
  it;
- ``native2hf`` verifies the step's digests, reads its params and writes
  ``pytorch_model.bin`` (``torch.save`` of the HF state dict; the card's
  machine has no ``safetensors``), ``native2nnm`` a Megatron
  ``model_optim_rng.ckpt``;
- HF inputs are read by ``tools/convert.py::load_torch_state_dict``
  (``pytorch_model*.bin``; ``*.safetensors`` only where the package is
  installed).

The tensors are placed on ``--device`` (the card unless ``--device cpu``
is asked for; without a card and without ``--device cpu`` it raises) and
keep their dtype.  Imports neither JAX nor orbax.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Any, Callable, Optional

import torch

logger = logging.getLogger("nxdt.torch.convert")


def _load_nnm_state(path: str, tp: int, pp: int, num_layers: int, glu: bool):
    """A NeMo-Megatron checkpoint: one state-dict file, or the rank-sharded
    ``tp_rank_XX_pp_rank_XXX/model_optim_rng.ckpt`` (``mp_rank_XX`` at pp 1)
    layout, merged (``tools/convert_megatron.py::merge_nnm_shards``)."""
    from neuronx_distributed_training_torch.tools import convert, convert_megatron

    p = Path(path)
    if p.is_file():
        sd = torch.load(str(p), map_location="cpu", weights_only=False)
        return sd.get("state_dict", sd) if isinstance(sd, dict) else sd
    if not (p / "mp_rank_00").exists() and not (p / "tp_rank_00_pp_rank_000").exists():
        return convert.load_torch_state_dict(str(p))
    shards = {}
    for r in range(tp):
        for s in range(pp):
            name = f"tp_rank_{r:02d}_pp_rank_{s:03d}" if pp > 1 else f"mp_rank_{r:02d}"
            ck = p / name / "model_optim_rng.ckpt"
            if not ck.exists():
                ck = p / name / "model_weights.ckpt"
            sd = torch.load(str(ck), map_location="cpu", weights_only=False)
            sd = sd.get("state_dict", sd)
            shards[(r, s)] = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    return convert_megatron.merge_nnm_shards(shards, tp=tp, pp=pp, num_layers=num_layers,
                                             glu=glu)


def model_and_mappings(cfg: dict, model: str, direction: str) -> tuple[Any, Callable, Callable]:
    """``(model config, to_native(state, device), to_hf(params))`` for a
    loaded YAML config: GPT (and every Megatron direction) through
    ``tools/convert_megatron.py``, Llama and Mixtral through
    ``tools/convert.py``."""
    from neuronx_distributed_training_torch.models import gpt, llama, mixtral
    from neuronx_distributed_training_torch.tools import convert, convert_megatron

    model_block = dict(cfg.get("model", {}) or {})
    ds_block = dict(cfg.get("distributed_strategy", {}) or {})
    if direction in ("nnm2native", "native2nnm") or model == "gpt":
        mc = gpt.GPTConfig.from_config(model_block, ds_block)
        return (mc, lambda sd, dev: convert_megatron.megatron_gpt_to_native(sd, mc, device=dev),
                lambda p: convert_megatron.native_to_megatron_gpt(p, mc))
    if model == "llama":
        mc = llama.LlamaConfig.from_config(model_block, ds_block)
        return (mc, lambda sd, dev: convert.hf_llama_to_native(sd, mc, device=dev),
                lambda p: convert.native_to_hf_llama(p, mc))
    mc = mixtral.MixtralConfig.from_config(model_block, ds_block)
    return (mc, lambda sd, dev: convert.hf_mixtral_to_native(sd, mc, device=dev),
            lambda p: convert.native_to_hf_mixtral(p, mc))


def save_native(params: Any, mc, out: Path, step: int = 0) -> Path:
    """Write ``params`` (the port's tree) as a port checkpoint at
    ``out/<step>/``: the weights, no optimizer state, step 0."""
    from neuronx_distributed_training_torch.checkpoint import CheckpointConfig, Checkpointer
    from neuronx_distributed_training_torch.checkpoint.manager import TrainState
    from neuronx_distributed_training_torch.models.llama import named_params
    from neuronx_distributed_training_torch.parallel import sharding

    layouts = sharding.leaf_layouts(named_params(params), mc)
    dev = next(iter(named_params(params).values())).device
    with Checkpointer(CheckpointConfig(dir=str(out), async_save=False), layouts=layouts) as ck:
        ck.save(TrainState(params=params, opt_state={
            "step": torch.zeros((), dtype=torch.int64, device=dev)}, step=step,
            consumed_samples=0), force=True)
    return out / str(step)


def load_native(path: Path, mc, step: Optional[int] = None, device=None) -> Any:
    """The params of a port checkpoint dir (its newest step, or ``step``),
    verified against ``integrity.json`` first, as the port's tree on
    ``device``: the fused leaves' saved segments (``<name>:q|k|v``,
    ``:gate|up``) concatenated back."""
    from neuronx_distributed_training_torch.checkpoint import integrity
    from neuronx_distributed_training_torch.checkpoint.manager import resolve_checkpoint_dir
    from neuronx_distributed_training_torch.parallel import sharding
    from neuronx_distributed_training_torch.utils.device import resolve_device

    directory = resolve_checkpoint_dir(path)
    if step is None:
        steps = sorted(int(p.name) for p in directory.iterdir()
                       if p.is_dir() and p.name.isdigit())
        if not steps:
            raise FileNotFoundError(f"no committed checkpoint step under {directory}")
        step = steps[-1]
    keep: dict = {}
    verdict = integrity.verify_step(directory, step, keep=keep)
    if not verdict.passed:
        raise integrity.CheckpointIntegrityError(
            f"checkpoint step {step} under {directory} failed verification: "
            f"{verdict.failures[:4]}")
    flat = keep.get("params") or integrity.read_item(directory / str(step), "params")
    pieces: dict[str, dict[str, torch.Tensor]] = {}
    for key, t in flat.items():
        name, _, part = key.partition(":")
        pieces.setdefault(name, {})[part] = t
    dev = resolve_device(device)
    leaves = {}
    for name, parts in pieces.items():
        if list(parts) == [""]:
            leaves[name] = parts[""]
            continue
        lay = sharding.leaf_layout(name, mc)
        leaves[name] = torch.cat([parts[p.name] for p in lay.parts], dim=lay.dim)
    return unflatten({n: t.to(dev) for n, t in leaves.items()})


def unflatten(flat: dict[str, torch.Tensor]) -> dict[str, Any]:
    """``named_params``'s dotted names -> the port's tree (``layers`` a
    list, one dict per layer)."""
    tree: dict[str, Any] = {}
    for name, t in flat.items():
        node = tree
        parts = name.split(".")
        for k in parts[:-1]:
            if k == "layers" and node is tree:
                node = node.setdefault("layers", {})
                continue
            node = node.setdefault(k, {})
        node[parts[-1]] = t
    if "layers" in tree:
        layers = tree["layers"]
        tree["layers"] = [layers[str(i)] for i in range(len(layers))]
    return tree


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=["llama", "mixtral", "gpt"], default="llama")
    ap.add_argument("--direction", choices=["hf2native", "native2hf", "nnm2native", "native2nnm"],
                    required=True)
    ap.add_argument("--config", required=True, help="YAML config (reference schema)")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step to write (default 0) or read (default the newest)")
    ap.add_argument("--tp", type=int, default=1, help="TP degree of a sharded NNM checkpoint dir")
    ap.add_argument("--pp", type=int, default=1, help="PP degree of a sharded NNM checkpoint dir")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    ap.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VAL",
                    help="dotted config override")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from neuronx_distributed_training_torch.config.loader import load_config
    from neuronx_distributed_training_torch.trainer.cli import parse_overrides
    from neuronx_distributed_training_torch.tools import convert
    from neuronx_distributed_training_torch.utils.device import resolve_device

    cfg = load_config(args.config, parse_overrides(args.overrides))
    mc, to_native, to_hf = model_and_mappings(cfg, args.model, args.direction)
    dev = resolve_device(args.device)
    out = Path(args.output)
    if args.direction in ("hf2native", "nnm2native"):
        if args.direction == "nnm2native":
            model_block = dict(cfg.get("model", {}) or {})
            state = _load_nnm_state(args.input, args.tp, args.pp,
                                    num_layers=int(model_block.get("num_layers", 12)),
                                    glu=str(model_block.get("activation", "gelu")) in
                                    ("swiglu", "geglu", "reglu"))
        else:
            state = convert.load_torch_state_dict(args.input)
        where = save_native(to_native(state, dev), mc, out, args.step or 0)
        print(f"wrote native checkpoint: {where}")
    else:
        sd = {k: v.detach().cpu().contiguous()
              for k, v in to_hf(load_native(Path(args.input), mc, args.step, dev)).items()}
        out.mkdir(parents=True, exist_ok=True)
        name = "model_optim_rng.ckpt" if args.direction == "native2nnm" else "pytorch_model.bin"
        torch.save(sd, out / name)
        print(f"wrote {out / name} ({len(sd)} tensors)")


if __name__ == "__main__":
    main()
