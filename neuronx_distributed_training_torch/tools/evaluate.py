"""Post-SFT generation evaluation: prompts -> generations -> metrics
(the port's own copy of the JAX package's ``tools/evaluate.py``; pure Python).

Dependency-free ROUGE-L, exact match and token F1, ``{field}`` prompt
templates, and :func:`evaluate_sft`, which scores a ``generate_fn`` over records
against their targets.  ``tools/run_sft_evaluation.py`` is the CLI that
drives ``models/decode.py::generate_cached`` with them.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Any, Callable, Sequence


def _tokens(s: str) -> list[str]:
    return re.findall(r"\w+", s.lower())


def rouge_l(prediction: str, reference: str) -> float:
    """ROUGE-L F-measure on word tokens (LCS-based)."""
    p, r = _tokens(prediction), _tokens(reference)
    if not p or not r:
        return float(p == r)
    # LCS via DP over the shorter dimension
    prev = [0] * (len(r) + 1)
    for i in range(1, len(p) + 1):
        cur = [0] * (len(r) + 1)
        for j in range(1, len(r) + 1):
            cur[j] = prev[j - 1] + 1 if p[i - 1] == r[j - 1] else max(prev[j], cur[j - 1])
        prev = cur
    lcs = prev[-1]
    if lcs == 0:
        return 0.0
    prec, rec = lcs / len(p), lcs / len(r)
    return 2 * prec * rec / (prec + rec)


def exact_match(prediction: str, reference: str) -> float:
    return float(" ".join(_tokens(prediction)) == " ".join(_tokens(reference)))


def token_f1(prediction: str, reference: str) -> float:
    p, r = Counter(_tokens(prediction)), Counter(_tokens(reference))
    overlap = sum((p & r).values())
    if overlap == 0:
        return 0.0
    prec = overlap / sum(p.values())
    rec = overlap / sum(r.values())
    return 2 * prec * rec / (prec + rec)


METRICS: dict[str, Callable[[str, str], float]] = {
    "rouge_l": rouge_l,
    "exact_match": exact_match,
    "f1": token_f1,
}


def render_prompt(template: str, record: dict[str, Any]) -> str:
    """``{field}``-style prompt templating (the jinja-template role,
    reference ``evaluate.py`` prompt handling)."""
    return template.format(**record)


def score(
    predictions: Sequence[str],
    references: Sequence[str],
    metrics: Sequence[str] = ("rouge_l", "f1", "exact_match"),
) -> dict[str, float]:
    if len(predictions) != len(references):
        raise ValueError("predictions/references length mismatch")
    out = {}
    for m in metrics:
        fn = METRICS[m]
        vals = [fn(p, r) for p, r in zip(predictions, references)]
        out[m] = sum(vals) / max(len(vals), 1)
    return out


def evaluate_sft(
    records: Sequence[dict[str, Any]],
    generate_fn: Callable[[str], str],
    *,
    prompt_template: str = "{input}",
    target_field: str = "output",
    metrics: Sequence[str] = ("rouge_l", "f1", "exact_match"),
) -> dict[str, float]:
    """Run generation over records and score against targets."""
    preds, refs = [], []
    for r in records:
        preds.append(generate_fn(render_prompt(prompt_template, r)))
        refs.append(str(r[target_field]))
    return score(preds, refs, metrics)
