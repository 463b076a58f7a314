"""Per-rank AdamW state bytes under ZeRO-1 and tensor parallelism, computed
from shapes (no card, no allocation): for each (data, tensor)-parallel
degree, the bytes of ``mu``, ``nu`` and (when the params are stored in
another dtype) ``master`` that one rank holds.  Each leaf is first cut to
the rank's tensor-parallel slice (``parallel/sharding.py``; replicated
leaves stay whole), then sharded over dp on the dim
``optim/adamw.py::zero1_leaf_spec`` picks from the global shape (never the
tp dim), or kept whole where no dim divides.

    python -m neuronx_distributed_training_torch.tools.zero1_bytes \\
        [--layers 4 32] [--dp 1 2 8] [--tp 1 8] [--precision mixed_precision]

Prints one JSON line per (layers, dp, tp) at Llama-3-8B width
(``examples/conf/hf_llama3_8B_config.yaml``'s model block).  These are
computed, not measured.
"""

from __future__ import annotations

import argparse
import json

from neuronx_distributed_training_torch.models.llama import LlamaConfig
from neuronx_distributed_training_torch.optim.adamw import zero1_leaf_spec
from neuronx_distributed_training_torch.parallel.sharding import leaf_layout
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

#: Llama-3-8B's widths (hf_llama3_8B_config.yaml)
LLAMA3_8B = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_attention_heads=32, num_kv_heads=8)


def param_shapes(cfg: LlamaConfig) -> dict[str, tuple]:
    """``named_params`` names and shapes of ``models/llama.py::init_params``."""
    h, d, nh, nkv = cfg.hidden_size, cfg.head_size, cfg.num_attention_heads, cfg.kv_heads
    out: dict[str, tuple] = {"embed.embedding": (cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        out[p + "input_norm.scale"] = (h,)
        out[p + "post_attn_norm.scale"] = (h,)
        out[p + "attn.qkv.w"] = (h, (nh + 2 * nkv) * d)
        out[p + "attn.o.w"] = (nh * d, h)
        out[p + "mlp.gate_up.w"] = (h, 2 * cfg.intermediate_size)
        out[p + "mlp.down.w"] = (cfg.intermediate_size, h)
    out["final_norm.scale"] = (h,)
    if not cfg.tie_word_embeddings:
        out["lm_head.w"] = (h, cfg.vocab_size)
    return out


def state_bytes_per_rank(shapes: dict[str, tuple], dp: int, policy: DtypePolicy, *,
                         tp: int = 1, cfg: LlamaConfig | None = None) -> dict:
    """One rank's ``mu`` + ``nu`` (+ ``master``) bytes, and how many leaves
    ZeRO-1 shards (``cfg``: the model, for the tp layouts at ``tp > 1``)."""
    itemsize = policy.optimizer_dtype.itemsize
    copies = 2 + (policy.param_dtype != policy.optimizer_dtype)
    total = sharded = 0
    for name, shape in shapes.items():
        n = 1
        for s in shape:
            n *= s
        tp_dim = leaf_layout(name, cfg).dim if tp > 1 else None
        if tp_dim is not None:
            n //= tp
        dim = zero1_leaf_spec(shape, dp, tp_dim)
        if dim is not None:
            n //= dp
            sharded += 1
        total += n * itemsize * copies
    return {"bytes": total, "leaves": len(shapes), "sharded_leaves": sharded}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 32])
    ap.add_argument("--dp", type=int, nargs="+", default=[1, 2, 8])
    ap.add_argument("--tp", type=int, nargs="+", default=[1])
    ap.add_argument("--precision", default="mixed_precision")
    args = ap.parse_args(argv)
    policy = DtypePolicy.from_precision_config(args.precision)
    for layers in args.layers:
        cfg = LlamaConfig(num_layers=layers, **LLAMA3_8B)
        shapes = param_shapes(cfg)
        for tp in args.tp:
            for dp in args.dp:
                print(json.dumps({"layers": layers, "dp": dp, "tp": tp,
                                  "precision": args.precision,
                                  **state_bytes_per_rank(shapes, dp, policy, tp=tp, cfg=cfg)}),
                      flush=True)


if __name__ == "__main__":
    main()
