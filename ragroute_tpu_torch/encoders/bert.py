"""BERT-family text encoder (BERT and XLM-RoBERTa) with checkpoint import.

Port of :mod:`ragroute_tpu.encoders.bert`: one forward serves every
BERT-architecture query encoder of the zoo (MedCPT, DPR, e5-base / large,
multilingual-e5-large, gte-base, ember-v1, UAE-Large-V1); what differs
between them (pooling, prefixes, normalization) is data in
:mod:`ragroute_tpu_torch.encoders.registry`.

One difference from the JAX module, on purpose: a checkpoint whose
``model_type`` is ``xlm-roberta`` (multilingual-e5-large) gets XLM-R's
padding-aware positions, ``cumsum(mask) * mask + pad_token_id``, and its
config's ``layer_norm_eps`` (1e-5). The JAX module runs that checkpoint with
BERT's ``arange`` positions and eps 1e-12 (ROADMAP queue 3, R6); the port is
held to ``transformers.XLMRobertaModel`` there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch import nn

from ragroute_tpu_torch.encoders import layers as L

PREFIXES = ("", "bert.", "question_encoder.bert_model.", "0.auto_model.")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    model_type: str = "bert"         # "xlm-roberta": padding-aware positions
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def padded_positions(self) -> bool:
        return self.model_type == "xlm-roberta"


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position = nn.Embedding(cfg.max_position_embeddings,
                                     cfg.hidden_size, **kw)
        self.token_type = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size,
                                       **kw)
        self.ln = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)


class _Layer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.q, self.k, self.v = (L.linear(h, h, **kw) for _ in range(3))
        self.att_out = L.linear(h, h, **kw)
        self.att_ln = L.LayerNorm(h, cfg.layer_norm_eps, device)
        self.ffn_in = L.linear(h, f, **kw)
        self.ffn_out = L.linear(f, h, **kw)
        self.ffn_ln = L.LayerNorm(h, cfg.layer_norm_eps, device)


class BertEncoder(nn.Module):
    """The BERT / XLM-R encoder stack (eval mode); ``pooler`` adds the
    tanh pooler head (DPR's ``pooler_output``)."""

    def __init__(self, cfg: BertConfig, pooler: bool = True, device=None,
                 dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg, device, dtype)
        self.layers = nn.ModuleList(_Layer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.pooler = (L.linear(cfg.hidden_size, cfg.hidden_size,
                                device=device, dtype=dtype)
                       if pooler else None)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``{"last_hidden": [B, L, H], "cls": [B, H], "pooler": [B, H]}``
        in f32 (``pooler`` only with the pooler head)."""
        cfg = self.cfg
        seq = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if cfg.padded_positions:
            m = attention_mask.long()
            pos = torch.cumsum(m, dim=1) * m + cfg.pad_token_id
        else:
            pos = torch.arange(seq, device=input_ids.device)[None]
        e = self.embeddings
        emb = (e.word(input_ids).float() + e.position(pos).float()
               + e.token_type(token_type_ids).float())
        h = e.ln(emb)
        bias = L.padding_bias(attention_mask, -1e9)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        for lay in self.layers:
            ctx = L.attend(L.heads(L.dense(h, lay.q), cfg.num_heads),
                           L.heads(L.dense(h, lay.k), cfg.num_heads),
                           L.heads(L.dense(h, lay.v), cfg.num_heads),
                           bias, scale)
            h = lay.att_ln(L.dense(ctx, lay.att_out) + h)
            ffn = torch.nn.functional.gelu(L.dense(h, lay.ffn_in))
            h = lay.ffn_ln(L.dense(ffn, lay.ffn_out) + h)
        out = {"last_hidden": h, "cls": h[:, 0]}
        if self.pooler is not None:
            out["pooler"] = torch.tanh(L.dense(h[:, 0], self.pooler))
        return out


# ---------------------------------------------------------------------------
# Pooling modes (reference: custom_sentence_transformer.py CLS force;
# custom_models.py E5 mean pooling; instructor_model.py weightedmean/
# lasttoken), in f32
# ---------------------------------------------------------------------------

def pool(outputs: Dict, attention_mask: torch.Tensor, mode: str
         ) -> torch.Tensor:
    h = outputs["last_hidden"].float()
    m = attention_mask.to(h.dtype)[:, :, None]
    if mode == "cls":
        return outputs["cls"].float()
    if mode == "pooler":
        return outputs.get("pooler", outputs["cls"]).float()
    if mode == "mean":
        return (h * m).sum(1) / m.sum(1).clamp(min=1e-9)
    if mode == "weightedmean":
        # position-weighted mean (SGPT scheme, instructor_model.py:25-195)
        seq = h.shape[1]
        w = torch.arange(1, seq + 1, dtype=h.dtype,
                         device=h.device)[None, :, None] * m
        return (h * w).sum(1) / w.sum(1).clamp(min=1e-9)
    if mode == "lasttoken":
        idx = (attention_mask.long().sum(1) - 1).clamp(min=0)
        return h[torch.arange(h.shape[0], device=h.device), idx]
    raise ValueError(f"unknown pooling mode {mode!r}")


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def config_from_hf(hf_config) -> BertConfig:
    """From a ``config.json`` dict or a ``transformers`` config object."""
    get = L.config_getter(hf_config)
    model_type = get("model_type") or "bert"
    return BertConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        intermediate_size=get("intermediate_size"),
        max_position_embeddings=get("max_position_embeddings"),
        type_vocab_size=get("type_vocab_size", 2),
        model_type=model_type,
        layer_norm_eps=get("layer_norm_eps", 1e-12),
        pad_token_id=get("pad_token_id", 0) or 0,
    )


_LAYER_KEYS = (("q", "attention.self.query"), ("k", "attention.self.key"),
               ("v", "attention.self.value"),
               ("att_out", "attention.output.dense"),
               ("att_ln", "attention.output.LayerNorm"),
               ("ffn_in", "intermediate.dense"),
               ("ffn_out", "output.dense"), ("ffn_ln", "output.LayerNorm"))


def params_from_state_dict(state_dict, cfg: BertConfig
                           ) -> Dict[str, torch.Tensor]:
    """A ``transformers`` ``BertModel`` / ``XLMRobertaModel`` (or DPR /
    sentence-transformers wrapped) state dict as :class:`BertEncoder`'s,
    f32; the prefixes stripped are those of ``params_from_torch_bert``."""
    get = L.getter(state_dict, PREFIXES)
    out = {
        "embeddings.word.weight": get("embeddings.word_embeddings.weight"),
        "embeddings.position.weight": get(
            "embeddings.position_embeddings.weight"),
        "embeddings.token_type.weight": get(
            "embeddings.token_type_embeddings.weight"),
        "embeddings.ln.weight": get("embeddings.LayerNorm.weight"),
        "embeddings.ln.bias": get("embeddings.LayerNorm.bias"),
    }
    for i in range(cfg.num_layers):
        for ours, theirs in _LAYER_KEYS:
            for p in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{p}"] = get(
                    f"encoder.layer.{i}.{theirs}.{p}")
    try:
        out["pooler.weight"] = get("pooler.dense.weight")
        out["pooler.bias"] = get("pooler.dense.bias")
    except KeyError:
        pass
    return out


def params_from_jax(jax_params, cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's pytree (``params_from_torch_bert``) as
    :class:`BertEncoder`'s state dict."""
    with torch.device("meta"):
        shape = BertEncoder(cfg, pooler="pooler" in jax_params)
    return L.state_from_jax(shape, jax_params)


def from_state(cfg: BertConfig, state: Dict[str, torch.Tensor],
               device="cpu") -> BertEncoder:
    with torch.device("meta"):
        model = BertEncoder(cfg, pooler="pooler.weight" in state)
    return L.build(model, state, device)
