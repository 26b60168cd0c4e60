"""SGPT-specb and INSTRUCTOR encoder semantics, and their encoder classes.

Port of :mod:`ragroute_tpu.encoders.custom`. Two reference encoders need
more than (pooling, prefix, normalize) specs:

* **SGPT specb** (reference ``custom_models.py:183-229``): queries are
  wrapped in bracket TOKENS — token ids ``[ "[" ] + ids(text) + [ "]" ]``,
  NOT string concatenation (the reference prepends a ``[SOS]`` placeholder
  and swaps its id for ``[``'s id precisely so the bracket cannot merge
  with adjacent text during BPE). Docs use ``{`` / ``}``. Pooling is the
  SGPT position-weighted mean (weights 1..L over unmasked tokens).

* **INSTRUCTOR** (reference ``instructor/instructor_model.py:223-386``):
  queries are (instruction, text) pairs; the model runs on the tokenized
  CONCATENATION while mean pooling masks out the instruction's tokens:
  ``context_len = sum(attn(tok(instruction))) - 1`` (dropping the
  instruction-only tokenization's trailing EOS; floored to 0 when <= 1),
  then ``attention_mask[:context_len] = 0``. Instructions per (model,
  dataset, side) live in ``instructor_instructions.json`` (the port's own
  copy of the JAX package's table).

The numpy helpers (``specb_bracket_ids``, ``specb_tokenize``,
``weighted_mean_pool``, ``instructor_tokenize``, ``masked_mean_pool``,
``instructor_instruction(s)``) are copies of the JAX module's, held to them
by ``tests/test_torch_vendored.py``. The encoder classes run the port's
GPT-J and T5 forwards on their device: one class each stands for the JAX
package's forward and its host fallback (``JaxSGPTEncoder`` /
``SGPTEncoder``, ``JaxInstructorEncoder`` / ``InstructorEncoder``).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_INSTRUCTIONS_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "instructor_instructions.json")


@functools.lru_cache(maxsize=1)
def instructor_instructions() -> Dict:
    with open(_INSTRUCTIONS_PATH) as f:
        return json.load(f)


def instructor_instruction(model: str, dataset: str, side: str) -> str:
    """Instruction string for (model, dataset, query|corpus)."""
    table = instructor_instructions()
    model_key = model if model in table else f"hkunlp/{model}"
    return table[model_key][dataset][side]


# ---------------------------------------------------------------------------
# SGPT specb token scheme
# ---------------------------------------------------------------------------

def specb_bracket_ids(tokenizer) -> Tuple[int, int, int, int]:
    """(query_open, query_close, doc_open, doc_close) single-token ids."""
    def one(tok: str) -> int:
        ids = tokenizer.encode(tok, add_special_tokens=False)
        return ids[0]

    return one("["), one("]"), one("{"), one("}")


def specb_tokenize(
    tokenizer, texts: Sequence[str], *, is_query: bool = True,
    max_length: int = 512, pad_to: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Tokenize with the specb bracket scheme, padded to the batch max
    (or to a fixed ``pad_to`` length for jit-stable shapes).

    Returns ``{"input_ids", "attention_mask"}`` numpy int arrays.
    """
    q_open, q_close, d_open, d_close = specb_bracket_ids(tokenizer)
    open_id, close_id = (q_open, q_close) if is_query else (d_open, d_close)

    limit = min(max_length, pad_to) if pad_to else max_length
    seqs = []
    for t in texts:
        ids = tokenizer.encode(t, add_special_tokens=False,
                               truncation=True, max_length=limit - 2)
        seqs.append([open_id] + list(ids) + [close_id])

    longest = pad_to or max(len(s) for s in seqs)
    pad_id = tokenizer.pad_token_id
    if pad_id is None:
        pad_id = 0
    input_ids = np.full((len(seqs), longest), pad_id, np.int64)
    mask = np.zeros((len(seqs), longest), np.int64)
    for i, s in enumerate(seqs):
        input_ids[i, :len(s)] = s
        mask[i, :len(s)] = 1
    return {"input_ids": input_ids, "attention_mask": mask}


def weighted_mean_pool(hidden: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """SGPT position-weighted mean: weights 1..L over unmasked tokens."""
    m = mask.astype(np.float32)[:, :, None]
    w = np.arange(1, hidden.shape[1] + 1,
                  dtype=np.float32)[None, :, None] * m
    return (hidden * w).sum(1) / np.maximum(w.sum(1), 1e-9)


# ---------------------------------------------------------------------------
# INSTRUCTOR instruction-masked pooling
# ---------------------------------------------------------------------------

def instructor_tokenize(
    tokenizer, instruction: str, texts: Sequence[str], *,
    max_length: int = 512, pad_to: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Tokenize instruction+text pairs with per-row context masks.

    Returns ``{"input_ids", "attention_mask", "pool_mask"}`` where
    ``pool_mask`` is the attention mask with the instruction's tokens
    zeroed (what mean pooling must use). ``attention_mask`` (instruction
    visible) is what the model forward must use.
    """
    joined = [instruction + t.strip() for t in texts]
    pad = ("max_length" if pad_to else True)
    batch = tokenizer(joined, padding=pad, truncation=True,
                      max_length=pad_to or max_length, return_tensors="np")
    ctx = tokenizer([instruction], padding=True, truncation=True,
                    max_length=max_length, return_tensors="np")
    context_len = int(ctx["attention_mask"].sum()) - 1
    if context_len <= 1:
        context_len = 0
    pool_mask = np.array(batch["attention_mask"], np.int64)
    pool_mask[:, :context_len] = 0
    return {
        "input_ids": np.asarray(batch["input_ids"], np.int64),
        "attention_mask": np.asarray(batch["attention_mask"], np.int64),
        "pool_mask": pool_mask,
    }


def masked_mean_pool(hidden: np.ndarray, pool_mask: np.ndarray) -> np.ndarray:
    m = pool_mask.astype(np.float32)[:, :, None]
    return (hidden * m).sum(1) / np.maximum(m.sum(1), 1e-9)


# ---------------------------------------------------------------------------
# Encoder classes: the port's forwards on their device
# ---------------------------------------------------------------------------

def device_of(model) -> "torch.device":
    return next(model.parameters()).device


def backend_of(model) -> str:
    """``"torch:cuda"`` / ``"torch:cpu"``: where the encoder runs."""
    return f"torch:{device_of(model).type}"


def trim(*arrays: np.ndarray, mask: np.ndarray) -> List[np.ndarray]:
    """The ``[B, L]`` arrays cut to the batch's longest row of ``mask``.
    Masked keys add nothing to any attention (their logits meet -1e9 or
    the f32 minimum), so the forward gives what the full width gives."""
    width = max(int(mask.sum(1).max()), 1)
    return [a[:, :width] for a in arrays]


def run_forward(model, input_ids, attention_mask, token_type_ids=None):
    """One forward on the model's device from numpy ``[B, L]`` arrays;
    returns ``(outputs, mask tensor)``."""
    import torch

    dev = device_of(model)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    mask = put(attention_mask)
    types = None if token_type_ids is None else put(token_type_ids)
    return model(put(input_ids), mask, types), mask


def normalized(emb, on: bool):
    if not on:
        return emb
    return emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-12)


class SGPTEncoder:
    """SGPT: the port's GPT-J forward + the specb scheme + position-weighted
    mean pooling (f32), tokenized at ``pad_to`` as the JAX encoder is."""

    def __init__(self, spec, model, tokenizer, pad_to: int = 128):
        self.spec = spec
        self.model = model
        self.tokenizer = tokenizer
        self.pad_to = pad_to
        self.backend = backend_of(model)

    def encode(self, texts: List[str], *, is_query: bool = True) -> np.ndarray:
        import torch

        from ragroute_tpu_torch.encoders.bert import pool

        batch = specb_tokenize(self.tokenizer, texts, is_query=is_query,
                               max_length=self.spec.max_length,
                               pad_to=self.pad_to)
        ids, mask = trim(batch["input_ids"], batch["attention_mask"],
                         mask=batch["attention_mask"])
        with torch.inference_mode():
            outs, m = run_forward(self.model, ids, mask)
            emb = normalized(pool(outs, m, "weightedmean"),
                             self.spec.normalize)
            return emb.cpu().numpy().astype(np.float32)

    def encode_corpus(self, texts: List[str]) -> np.ndarray:
        """Doc-side encode: {SOS}/{EOS} brace brackets
        (custom_models.py:183-229 doc scheme)."""
        return self.encode(texts, is_query=False)


class InstructorEncoder:
    """INSTRUCTOR: the port's T5 encoder + instruction-masked mean pooling
    (the model attends to the instruction; pooling excludes it), then the
    checkpoint's sentence-transformers ``2_Dense`` projection where it ships
    one (``dense``: ``(kernel [d_in, d_out], bias | None)``), applied to the
    pooled f32 embedding before normalization."""

    def __init__(self, spec, model, tokenizer,
                 default_dataset: str = "msmarco", pad_to: int = 128,
                 dense=None):
        import torch

        self.spec = spec
        self.model = model
        self.tokenizer = tokenizer
        self.default_dataset = default_dataset
        self.pad_to = pad_to
        self.backend = backend_of(model)
        self.dense = None
        if dense is not None:
            w, b = dense
            put = functools.partial(torch.as_tensor, dtype=torch.float32,
                                    device=device_of(model))
            self.dense = (put(w), None if b is None else put(b))

    def encode(self, texts: List[str], *, dataset: Optional[str] = None,
               side: str = "query") -> np.ndarray:
        import torch

        instruction = instructor_instruction(
            self.spec.hf_name, dataset or self.default_dataset, side)
        batch = instructor_tokenize(self.tokenizer, instruction, texts,
                                    max_length=self.spec.max_length,
                                    pad_to=self.pad_to)
        ids, mask, pool_mask = trim(
            batch["input_ids"], batch["attention_mask"], batch["pool_mask"],
            mask=batch["attention_mask"])
        with torch.inference_mode():
            outs, _ = run_forward(self.model, ids, mask)
            pm = torch.from_numpy(pool_mask.astype(np.float32)).to(
                device_of(self.model))[:, :, None]
            emb = (outs["last_hidden"] * pm).sum(1) / pm.sum(1).clamp(
                min=1e-9)
            if self.dense is not None:
                emb = emb @ self.dense[0]
                if self.dense[1] is not None:
                    emb = emb + self.dense[1]
            emb = normalized(emb, self.spec.normalize)
            return emb.cpu().numpy().astype(np.float32)

    def encode_corpus(self, texts: List[str], *,
                      dataset: Optional[str] = None) -> np.ndarray:
        """Doc-side encode with the corpus-side instruction
        (instructor_definitions per-(model, dataset, side) table)."""
        return self.encode(texts, dataset=dataset, side="corpus")
