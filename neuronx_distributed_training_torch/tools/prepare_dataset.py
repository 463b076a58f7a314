"""Offline dataset preparation: raw text -> training-ready data (the port's
counterpart of the repo's ``tools/prepare_dataset.py``, with its flags and,
for the same input, byte-identical output).

    # Megatron mmap (.bin/.idx, one doc per record):
    python -m neuronx_distributed_training_torch.tools.prepare_dataset \\
        --input corpus.jsonl --tokenizer char --format megatron --output my_corpus_text_document

    # HF arrow (fixed-length input_ids rows, datasets.save_to_disk):
    python -m neuronx_distributed_training_torch.tools.prepare_dataset \\
        --input corpus.jsonl --tokenizer meta-llama/... --seq-length 8192 --output tokenized_8k

Input: .jsonl/.json with a ``text`` field (configurable), or plain .txt (one
doc per line).  ``--tokenizer char`` is the port's offline
``data/build.py::CharTokenizer``; any other value is an HF tokenizer dir or
hub name, loaded through ``transformers``, and the arrow format writes
through ``datasets``: both are imported only on those branches.  The
Megatron pair is written by ``data/megatron/dataset.py::
write_indexed_dataset``, which the port's ``data.data_prefix`` reads.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np


def iter_docs(path: Path, text_key: str):
    if path.suffix == ".jsonl":
        for line in path.open():
            line = line.strip()
            if line:
                yield json.loads(line)[text_key]
    elif path.suffix == ".json":
        data = json.loads(path.read_text())
        for rec in data if isinstance(data, list) else data["data"]:
            yield rec[text_key]
    else:  # plain text, one doc per line
        for line in path.open():
            if line.strip():
                yield line.rstrip("\n")


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True, help=".jsonl/.json/.txt corpus")
    ap.add_argument("--tokenizer", required=True,
                    help="HF tokenizer dir or hub name (or 'char' for testing)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--seq-length", type=int, default=8192,
                    help="row length for arrow format (+1 token kept for the "
                         "in-model label shift)")
    ap.add_argument("--format", choices=["arrow", "megatron"], default="arrow")
    ap.add_argument("--text-key", default="text")
    ap.add_argument("--append-eos", action="store_true", default=True)
    args = ap.parse_args(argv)

    if args.tokenizer == "char":
        from neuronx_distributed_training_torch.data.build import CharTokenizer

        tok = CharTokenizer()
    else:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.tokenizer)
    eos = getattr(tok, "eos_token_id", None)

    docs = []
    for text in iter_docs(Path(args.input), args.text_key):
        ids = tok.encode(text)
        if args.append_eos and eos is not None:
            ids = list(ids) + [eos]
        docs.append(np.asarray(ids, dtype=np.int32))
    if not docs:
        sys.exit("no documents found")
    print(f"tokenized {len(docs)} docs, {sum(len(d) for d in docs):,} tokens")

    if args.format == "megatron":
        from neuronx_distributed_training_torch.data.megatron.dataset import (
            write_indexed_dataset,
        )

        write_indexed_dataset(args.output, docs)
        print(f"wrote {args.output}.bin/.idx (Megatron mmap)")
        return

    # arrow: concatenate-and-chunk to fixed rows (every row the same length)
    import datasets

    stream = np.concatenate(docs)
    row = args.seq_length
    n_rows = len(stream) // row
    if n_rows == 0:
        sys.exit(f"corpus ({len(stream)} tokens) shorter than one row ({row})")
    rows = stream[: n_rows * row].reshape(n_rows, row)
    ds = datasets.Dataset.from_dict({"input_ids": rows.tolist()})
    ds.save_to_disk(args.output)
    print(f"wrote {args.output}: {n_rows} rows x {row} tokens (arrow)")


if __name__ == "__main__":
    main()
