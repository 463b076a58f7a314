"""SFT evaluation CLI: a port checkpoint + eval records -> ROUGE-L / F1 / EM
(counterpart of the repo's ``examples/run_sft_evaluation.py``), driving the
KV-cached decoder (``models/decode.py::generate_cached``):

    python -m neuronx_distributed_training_torch.tools.run_sft_evaluation \\
        --config examples/conf/hf_llama3_8B_SFT_config.yaml \\
        --checkpoint <exp_dir>/<name>/version_0/checkpoints --step 500 \\
        --data /path/to/eval.jsonl --tokenizer /path/to/tok \\
        --prompt-template "{input}" --max-new-tokens 256 \\
        [--temperature 0.7 --top-p 0.9 --top-k 50] [--device cpu]

``--checkpoint`` is the port trainer's checkpoint dir (its newest step, or
``--step``), restored into a tree built from the config's ``model:`` block
(``trainer/loop.py::model_config``; LoRA adapters when it has a
``model.lora`` block, which decode through ``ops/linear.py::apply_linear``)
in the policy of its ``precision:`` block.  Records are read by
``data/modules.py::load_alignment_records``; the tokenizer is
``transformers.AutoTokenizer.from_pretrained(--tokenizer)``, or the object
passed to :func:`main`.  Batch ``i`` (its first record's index) samples
from a ``torch.Generator`` seeded with ``i``.  Runs on the card unless
``--device cpu`` is given.  The scores are printed as JSON on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Optional


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True, help="the port trainer's checkpoint dir")
    ap.add_argument("--step", type=int, default=0, help="0 = latest")
    ap.add_argument("--data", required=True, help="jsonl/json/arrow eval records")
    ap.add_argument("--tokenizer", required=True)
    ap.add_argument("--prompt-template", default="{input}")
    ap.add_argument("--target-field", default="output")
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def restore_model(cfg, checkpoint: str, step: Optional[int], device):
    """``(model config, policy, params)`` of the config's model, the
    params restored from the port checkpoint dir ``checkpoint``."""
    import torch

    from neuronx_distributed_training_torch.checkpoint import CheckpointConfig, Checkpointer
    from neuronx_distributed_training_torch.models import gpt, llama, mixtral
    from neuronx_distributed_training_torch.parallel import sharding
    from neuronx_distributed_training_torch.peft import LoraConfig, add_lora
    from neuronx_distributed_training_torch.trainer.loop import model_config
    from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

    policy = DtypePolicy.from_precision_config(cfg.get("precision", {}))
    mc = model_config(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    init = (gpt.init_params if isinstance(mc, gpt.GPTConfig) else
            mixtral.init_params if isinstance(mc, mixtral.MixtralConfig) else llama.init_params)
    params = init(mc, policy, generator=gen, device=device)
    lora = dict(dict(cfg.get("model", {}) or {}).get("lora", {}) or {})
    if lora:
        params = add_lora(params, LoraConfig.from_config(lora), gen)
    layouts = sharding.leaf_layouts(llama.named_params(params), mc)
    with Checkpointer(CheckpointConfig(dir=str(checkpoint)), layouts=layouts) as ck:
        ck.restore_params_only(params, step=step)
    return mc, policy, params


def main(argv: Optional[list] = None, tokenizer: Any = None) -> tuple[dict, list]:
    """Run the evaluation -> ``(scores, generations)``: the printed scores
    and each record's generated buffer row (prompt, completion, padding) as
    a list of token ids."""
    args = parse_args(argv)
    import torch

    from neuronx_distributed_training_torch.config.loader import load_config
    from neuronx_distributed_training_torch.data.modules import load_alignment_records
    from neuronx_distributed_training_torch.models import decode
    from neuronx_distributed_training_torch.models import generate as gen
    from neuronx_distributed_training_torch.tools.evaluate import render_prompt, score
    from neuronx_distributed_training_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    eos = tokenizer.eos_token_id or 0
    cfg = load_config(args.config)
    mc, policy, params = restore_model(cfg, args.checkpoint, args.step or None, device)

    records = load_alignment_records(args.data)
    if args.limit:
        records = records[: args.limit]
    preds, refs, generations = [], [], []
    for i in range(0, len(records), args.batch_size):
        batch = records[i:i + args.batch_size]
        prompts = [tokenizer.encode(render_prompt(args.prompt_template, r)) for r in batch]
        ids, lens = gen.pad_prompts(prompts, pad_id=eos)
        out = decode.generate_cached(
            params, mc, policy, ids, lens, max_new_tokens=args.max_new_tokens, eos_id=eos,
            pad_id=eos, temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            generator=torch.Generator(device=device).manual_seed(i)).cpu().numpy()
        for b, r in enumerate(batch):
            generations.append(out[b].tolist())
            gen_ids = out[b, int(lens[b]):]
            preds.append(tokenizer.decode(gen_ids[gen_ids != eos]))
            refs.append(str(r[args.target_field]))
        print(f"generated {min(i + args.batch_size, len(records))}/{len(records)}",
              file=sys.stderr)
    scores = score(preds, refs)
    print(json.dumps(scores, indent=2))
    return scores, generations


if __name__ == "__main__":
    main()
