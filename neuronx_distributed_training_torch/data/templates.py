"""Prompt templates for alignment data (counterpart of the JAX package's
``data/templates.py``).

A template maps a raw record to one with ``input``/``output`` keys before
tokenization.  ``build_template`` picks one from ``cfg.data``, in this order:

1. ``data.prompt_template: {input: "...{field}...", output: "...{field}..."}``
   (or one string for the input): format strings over the record's fields;
2. ``data.chat_template: true``: an HF tokenizer's ``apply_chat_template``
   over ``messages`` records;
3. ``data.dataset_name`` + ``prompt_name``: a promptsource template, when
   that package is installed.

It returns ``None`` when no template is configured.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

Template = Callable[[dict], dict]


class FormatTemplate:
    """``{field}``-style format templates for the input and output columns."""

    def __init__(self, input_template: str, output_template: str = "{output}"):
        self.input_template = input_template
        self.output_template = output_template

    def __call__(self, record: dict) -> dict:
        out = dict(record)
        out["input"] = self.input_template.format(**record)
        out["output"] = self.output_template.format(**record)
        return out


class ChatTemplate:
    """An HF tokenizer's chat template over ``messages`` records: the last
    assistant turn becomes ``output`` (the trained completion), everything
    before it renders, with the generation prompt, into ``input``."""

    def __init__(self, tokenizer: Any):
        if not hasattr(tokenizer, "apply_chat_template"):
            raise ValueError(
                "data.chat_template needs an HF tokenizer with a chat template"
            )
        self.tokenizer = tokenizer

    def __call__(self, record: dict) -> dict:
        msgs = record["messages"]
        if not msgs or msgs[-1].get("role") != "assistant":
            raise ValueError("chat records must end with an assistant turn")
        out = dict(record)
        out["input"] = self.tokenizer.apply_chat_template(
            msgs[:-1], tokenize=False, add_generation_prompt=True
        )
        out["output"] = msgs[-1]["content"]
        return out


class PromptsourceTemplate:
    """A named dataset's promptsource template (an optional package)."""

    def __init__(self, dataset_name: str, prompt_name: str,
                 subset_name: Optional[str] = None):
        try:
            from promptsource.templates import DatasetTemplates
        except ImportError as e:
            raise ImportError(
                "data.dataset_name/prompt_name need the optional promptsource "
                "package; use data.prompt_template format strings instead"
            ) from e
        self.template = DatasetTemplates(dataset_name, subset_name)[prompt_name]

    def __call__(self, record: dict) -> dict:
        out = dict(record)
        rendered = self.template.apply(record)  # [input] or [input, target]
        out["input"] = rendered[0]
        if len(rendered) > 1:
            out["output"] = rendered[1]
        return out


def build_template(data_cfg: dict, tokenizer: Any = None) -> Optional[Template]:
    """The template of a ``cfg.data`` block; None when none is configured."""
    d = dict(data_cfg or {})
    pt = d.get("prompt_template")
    if pt:
        if isinstance(pt, str):
            return FormatTemplate(pt)
        return FormatTemplate(str(pt.get("input", "{input}")), str(pt.get("output", "{output}")))
    if d.get("chat_template"):
        return ChatTemplate(tokenizer)
    if d.get("dataset_name") and d.get("prompt_name"):
        return PromptsourceTemplate(str(d["dataset_name"]), str(d["prompt_name"]),
                                    d.get("subset_name"))
    return None
