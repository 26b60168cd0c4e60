"""Benchmark loading and answer checking.

Parity port of reference ``ragroute/benchmark.py``: loads the MIRAGE QA
suite (single JSON of question banks), FeB4RAG queries (jsonl), and MMLU
(HF ``cais/mmlu`` test split, gated for offline runs), plus a synthetic
benchmark backed by :mod:`ragroute_tpu_torch.index.synthetic` so the full client
path runs with no external data.

Answer checking reproduces the reference's extraction exactly: the MIRAGE
checker scans the tail after ``"answer_choice": "`` with the same ten
regex patterns (``benchmark.py:39-87``), and the MMLU checker compares the
letter after "The best answer is" (``benchmark.py:89-97``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

_MIRAGE_PATTERNS = [
    r"^\s*(A|B|C|D)$",
    r"^\s*(A|B|C|D) or",
    r"^\s*(A|B|C|D) and",
    r"^\s*(A|B|C|D)/",
    r"^\s*(A|B|C|D),",
    r"[Oo]ption (A|B|C|D)",
    r":\s*(A|B|C|D)",
    r"^\s*(A|B|C|D)\.",
    r"^\s*(A|B|C|D)\"",
    r"^\s*(A|B|C|D):",
]


def locate_answer(sentence: str) -> str:
    """First-match extraction over the reference's pattern cascade."""
    for i, pat in enumerate(_MIRAGE_PATTERNS):
        ans = re.findall(pat, sentence)
        if ans:
            # pattern 6 ("Option X") is returned as-is in the reference;
            # all others are uppercased (no-op for A-D but kept for parity)
            return ans[0] if i == 5 else ans[0].upper()
    return ""


class Benchmark:
    """Question-bank container: ``benchmark_data[bank][qid] -> question``."""

    def __init__(self, benchmark_path: str, benchmark_name: str):
        self.name = benchmark_name
        self.benchmark_data: Dict[str, Dict[str, dict]] = {}
        if benchmark_name == "MIRAGE":
            with open(os.path.join(benchmark_path, "MIRAGE.json")) as f:
                self.benchmark_data = json.load(f)
        elif benchmark_name == "FeB4RAG":
            self.benchmark_data = {"FeB4RAG": {}}
            with open(os.path.join(benchmark_path, "FeB4RAG.jsonl")) as f:
                for line in f:
                    obj = json.loads(line)
                    self.benchmark_data["FeB4RAG"][str(obj["_id"])] = {
                        "question": obj["text"],
                        "options": [],
                    }
        elif benchmark_name == "MMLU":
            from datasets import load_dataset

            dataset = load_dataset("cais/mmlu", "all", split="test")
            for qid, qd in enumerate(dataset):
                subject = qd["subject"]
                self.benchmark_data.setdefault(subject, {})[str(qid)] = {
                    "question": qd["question"],
                    "options": qd["choices"],
                    "answer": qd["answer"],
                    "subject": subject,
                }
        elif benchmark_name == "SYNTHETIC":
            # synthetic bank written by scripts/make_synthetic_data.py
            with open(os.path.join(benchmark_path, "SYNTHETIC.json")) as f:
                self.benchmark_data = json.load(f)
        else:
            raise ValueError(f"Unsupported benchmark name: {benchmark_name}")

    # -- answer checkers (reference parity) ------------------------------

    def check_mirage_answer(self, data_question: dict, llm_output: str) -> bool:
        answer_list = ["A", "B", "C", "D"]
        ans = locate_answer(
            llm_output.split('"answer_choice": "')[-1].strip())
        if ans in answer_list and data_question.get("answer") in answer_list:
            return ans == data_question["answer"]
        return False

    def check_mmlu_answer(self, data_question: dict, llm_output: str) -> int:
        out = (
            llm_output.split("The best answer is")[-1]
            .strip().replace(".", "").replace('"', "").strip()
        )
        answer = data_question["answer"]
        gold = chr(65 + answer) if isinstance(answer, int) else answer
        return int(out == gold)

    def check(self, data_question: dict, llm_output: str):
        """Dispatch like the reference client (run_benchmark.py:122-129)."""
        if self.name in ("MIRAGE", "SYNTHETIC"):
            return self.check_mirage_answer(data_question, llm_output)
        if self.name == "MMLU":
            return self.check_mmlu_answer(data_question, llm_output)
        return True  # FeB4RAG has no gold answers


def write_synthetic_benchmark(path: str, questions: List[dict],
                              bank: str = "synthetic") -> str:
    """Persist a synthetic world's questions as a SYNTHETIC benchmark file."""
    os.makedirs(path, exist_ok=True)
    data = {bank: {}}
    for q in questions:
        data[bank][q["qid"]] = {
            "question": q["question"],
            "options": q["options"],
            "answer": q["answer"],
        }
    out = os.path.join(path, "SYNTHETIC.json")
    with open(out, "w") as f:
        json.dump(data, f)
    return out
