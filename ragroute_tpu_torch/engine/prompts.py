"""LLM message construction with token-budget context truncation.

Parity port of reference ``ragroute/llm_message.py``: per-world context
formatting ("Document [i] (Title: …) …"), truncation of the joined context
to the model's ``docs_context_length`` TOKENS (encode → slice → decode,
``llm_message.py:22-23``), liquid-template user prompts, and the special
llama-3 style raw prompt for the wikipedia/MMLU world
(``llm_message.py:33-64``).

Improvements over the reference: tokenizers are cached per model (the
reference reloads the HF tokenizer on every call, ``llm_message.py:11``),
and an offline-safe whitespace tokenizer stands in when HF weights are not
fetchable (token counts then approximate, clearly flagged).
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Sequence, Tuple

from ragroute_tpu_torch.config import LLM_MODELS, SYSTEM_PROMPTS, USER_PROMPT_TEMPLATES
from ragroute_tpu_torch.utils.template import render

logger = logging.getLogger("prompts")

_TOKENIZERS: Dict[str, object] = {}


class _WhitespaceTokenizer:
    """Offline fallback: regex word/punct tokens, identity decode."""

    is_fallback = True
    _re = re.compile(r"\S+|\n")

    def encode(self, text: str, add_special_tokens: bool = False):
        return self._re.findall(text)

    def decode(self, tokens) -> str:
        return " ".join(tokens)


def get_tokenizer(model: str):
    """HF tokenizer for the model, cached; offline-safe fallback."""
    if model in _TOKENIZERS:
        return _TOKENIZERS[model]
    hf_name = LLM_MODELS[model]["hf_name"]
    tok = None
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(
            hf_name, cache_dir=None, local_files_only=True)
    except Exception:
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(hf_name, cache_dir=None)
        except Exception:
            logger.warning(
                "tokenizer for %s unavailable; using whitespace fallback "
                "(docs_tokens counts are approximate)", hf_name)
            tok = _WhitespaceTokenizer()
    _TOKENIZERS[model] = tok
    return tok


def _format_contexts(dataset: str, context: Sequence) -> List[str]:
    """Per-world document line formatting (``llm_message.py:13-18``)."""
    if dataset == "medrag":
        return [
            "Document [{:d}] (Title: {:s}) {:s}".format(
                idx, context[idx]["title"], context[idx]["content"])
            for idx in range(len(context))
        ]
    if dataset == "feb4rag":
        return [
            "Document [{:d}] (Title: {:s}) {:s}".format(
                idx, context[idx].get("title") or f"Doc {idx}",
                context[idx]["text"])
            for idx in range(len(context))
        ]
    # wikipedia: (title, text) tuples
    return [
        "Document [{:d}] (Title: {:s}) {:s}".format(idx, title, text)
        for idx, (title, text) in enumerate(context)
    ]


def generate_llm_message(
    dataset: str,
    question: str,
    context: Sequence,
    options,
    model: str,
) -> Tuple[List[Dict[str, str]], int]:
    """Build chat messages + truncated-context token count
    (reference ``llm_message.py:9-31``)."""
    model_info = LLM_MODELS[model]
    tokenizer = get_tokenizer(model)

    contexts = _format_contexts(dataset, context)
    if len(contexts) == 0:
        contexts = [""]

    encoded = tokenizer.encode("\n".join(contexts), add_special_tokens=False)
    encoded = encoded[: model_info["docs_context_length"]]
    ctx = tokenizer.decode(encoded)

    prompt = render(
        USER_PROMPT_TEMPLATES[dataset],
        {"context": ctx, "question": question, "options": options},
    )
    return (
        [
            {"role": "system", "content": SYSTEM_PROMPTS[dataset]},
            {"role": "user", "content": prompt},
        ],
        len(encoded),
    )


def generate_llm_message_wikipedia(
    question: str,
    top_docs: Sequence[Tuple[str, str]],
    options: Sequence[str],
    model: str,
) -> Tuple[List[Dict[str, str]], int]:
    """Wikipedia/MMLU variant: one raw llama-3-format user message
    (reference ``llm_message.py:33-64``)."""
    model_info = LLM_MODELS[model]
    tokenizer = get_tokenizer(model)

    docs_context = [
        f"##### Document {j + 1} [{title}] #####\n{text}"
        for j, (title, text) in enumerate(top_docs)
    ]
    joined = "\n\n".join(docs_context)
    encoded = tokenizer.encode(joined, add_special_tokens=False)
    encoded = encoded[: model_info["docs_context_length"]]

    ctx_prompt = (
        "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
        "You are an assistant for answering multiple-choice questions. "
        "Below are relevant parts of documents retrieved for the question. "
        "Use the provided context to choose the correct answer. If the "
        "context does not help, use the question and options alone.<|eot_id|>\n"
        "<|start_header_id|>user<|end_header_id|>\n\n"
        "Given the following context, question, and four candidate answers "
        "(A, B, C, and D), choose the best answer.\n"
        f"Context:\n{joined}\n"
        f"Question: {question}\n"
        f"A. {options[0]}\n"
        f"B. {options[1]}\n"
        f"C. {options[2]}\n"
        f"D. {options[3]}\n"
        "Your response should end with \"The best answer is "
        "[the_answer_letter]\". Your response should be a single letter: "
        "A, B, C, or D. Only output one letter.<|eot_id|>"
        "<|start_header_id|>assistant<|end_header_id|>\n\nThe best answer is"
    )
    return [{"role": "user", "content": ctx_prompt}], len(encoded)
