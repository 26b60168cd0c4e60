"""MPNet text encoder with checkpoint import.

Port of :mod:`ragroute_tpu.encoders.mpnet` (``all-mpnet-base-v2``, 2 of the
13 feb4rag sources: mean pooling + L2 normalize). MPNet is BERT-shaped with
two differences, both kept:

* **Relative position bias**: a T5-style bucketed relative-position table
  (32 buckets, max distance 128) shared across layers, added to every
  layer's attention logits;
* **Padding-aware absolute positions**: ``cumsum(mask) * mask +
  padding_idx`` (fairseq convention, pad = 1), and no token-type
  embeddings. Layer norms use eps 1e-5.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch import nn

from ragroute_tpu_torch.encoders import layers as L

PADDING_IDX = 1
LN_EPS = 1e-5  # MPNet layer_norm_eps
PREFIXES = ("", "mpnet.", "0.auto_model.")

relative_position_bucket = L.relative_position_bucket


@dataclasses.dataclass(frozen=True)
class MPNetConfig:
    vocab_size: int = 30527
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    relative_attention_num_buckets: int = 32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class _Embeddings(nn.Module):
    def __init__(self, cfg: MPNetConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position = nn.Embedding(cfg.max_position_embeddings,
                                     cfg.hidden_size, **kw)
        self.ln = L.LayerNorm(cfg.hidden_size, LN_EPS, device)


class _Layer(nn.Module):
    def __init__(self, cfg: MPNetConfig, device=None, dtype=None):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.q, self.k, self.v = (L.linear(h, h, **kw) for _ in range(3))
        self.att_out = L.linear(h, h, **kw)
        self.att_ln = L.LayerNorm(h, LN_EPS, device)
        self.ffn_in = L.linear(h, f, **kw)
        self.ffn_out = L.linear(f, h, **kw)
        self.ffn_ln = L.LayerNorm(h, LN_EPS, device)


class MPNetEncoder(nn.Module):
    def __init__(self, cfg: MPNetConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg, device, dtype)
        self.rel_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                     cfg.num_heads, device=device,
                                     dtype=dtype)
        self.layers = nn.ModuleList(_Layer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids=None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        seq = input_ids.shape[1]
        m = attention_mask.long()
        pos = torch.cumsum(m, dim=1) * m + PADDING_IDX
        e = self.embeddings
        h = e.ln(e.word(input_ids).float() + e.position(pos).float())
        bias = (L.relative_bias(self.rel_bias, seq,
                                cfg.relative_attention_num_buckets)
                + L.padding_bias(attention_mask, -1e9))
        scale = 1.0 / math.sqrt(cfg.head_dim)
        for lay in self.layers:
            ctx = L.attend(L.heads(L.dense(h, lay.q), cfg.num_heads),
                           L.heads(L.dense(h, lay.k), cfg.num_heads),
                           L.heads(L.dense(h, lay.v), cfg.num_heads),
                           bias, scale)
            h = lay.att_ln(L.dense(ctx, lay.att_out) + h)
            ffn = torch.nn.functional.gelu(L.dense(h, lay.ffn_in))
            h = lay.ffn_ln(L.dense(ffn, lay.ffn_out) + h)
        return {"last_hidden": h, "cls": h[:, 0]}


_LAYER_KEYS = (("q", "attention.attn.q"), ("k", "attention.attn.k"),
               ("v", "attention.attn.v"), ("att_out", "attention.attn.o"),
               ("att_ln", "attention.LayerNorm"),
               ("ffn_in", "intermediate.dense"), ("ffn_out", "output.dense"),
               ("ffn_ln", "output.LayerNorm"))


def params_from_state_dict(state_dict, cfg: MPNetConfig
                           ) -> Dict[str, torch.Tensor]:
    """A ``transformers`` ``MPNetModel`` state dict as
    :class:`MPNetEncoder`'s, f32."""
    get = L.getter(state_dict, PREFIXES)
    out = {
        "embeddings.word.weight": get("embeddings.word_embeddings.weight"),
        "embeddings.position.weight": get(
            "embeddings.position_embeddings.weight"),
        "embeddings.ln.weight": get("embeddings.LayerNorm.weight"),
        "embeddings.ln.bias": get("embeddings.LayerNorm.bias"),
        "rel_bias.weight": get("encoder.relative_attention_bias.weight"),
    }
    for i in range(cfg.num_layers):
        for ours, theirs in _LAYER_KEYS:
            for p in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{p}"] = get(
                    f"encoder.layer.{i}.{theirs}.{p}")
    return out


def params_from_jax(jax_params, cfg: MPNetConfig) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        shape = MPNetEncoder(cfg)
    return L.state_from_jax(shape, jax_params)


def config_from_hf(hf_config) -> MPNetConfig:
    get = L.config_getter(hf_config)
    return MPNetConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        intermediate_size=get("intermediate_size"),
        max_position_embeddings=get("max_position_embeddings"),
        relative_attention_num_buckets=get("relative_attention_num_buckets",
                                           32),
    )


def from_state(cfg: MPNetConfig, state: Dict[str, torch.Tensor],
               device="cpu") -> MPNetEncoder:
    with torch.device("meta"):
        model = MPNetEncoder(cfg)
    return L.build(model, state, device)
