"""T5 encoder with checkpoint import.

Port of :mod:`ragroute_tpu.encoders.t5`, the forward under INSTRUCTOR
(reference ``instructor/instructor_model.py`` wraps a torch T5 encoder
stack). T5-encoder specifics kept:

* RMS norm (scale only, no mean subtraction, pre-norm);
* UNSCALED attention logits (T5 folds 1/sqrt(d) into its weights);
* a bucketed relative position bias from layer 0's table, computed once and
  shared by every layer;
* no biases; both FFN variants: ReLU (t5) and gated-GELU (t5-v1_1 / GTR /
  instructor).

Instruction-masked pooling is in :mod:`ragroute_tpu_torch.encoders.custom`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from ragroute_tpu_torch.encoders import layers as L

PREFIXES = ("", "encoder.", "0.auto_model.", "0.auto_model.encoder.")


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    hidden_size: int = 1024          # d_model
    num_layers: int = 24
    num_heads: int = 16
    head_dim: int = 64               # d_kv (NOT necessarily d_model/heads)
    intermediate_size: int = 2816    # d_ff
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    gated_act: bool = True           # t5-v1_1/GTR/instructor family
    layer_norm_eps: float = 1e-6


class _Layer(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        inner = cfg.num_heads * cfg.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.ln_att = L.RMSNorm(h, cfg.layer_norm_eps, device)
        self.q, self.k, self.v = (L.linear(h, inner, **kw) for _ in range(3))
        self.o = L.linear(inner, h, **kw)
        self.ln_ffn = L.RMSNorm(h, cfg.layer_norm_eps, device)
        if cfg.gated_act:
            self.wi_0 = L.linear(h, f, **kw)
            self.wi_1 = L.linear(h, f, **kw)
        else:
            self.wi = L.linear(h, f, **kw)
        self.wo = L.linear(f, h, **kw)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                  device=device, dtype=dtype)
        self.rel_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                     cfg.num_heads, device=device,
                                     dtype=dtype)
        self.ln_final = L.RMSNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.layers = nn.ModuleList(_Layer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids=None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        seq = input_ids.shape[1]
        h = self.embed(input_ids).float()
        bias = (L.relative_bias(self.rel_bias, seq,
                                cfg.relative_attention_num_buckets,
                                cfg.relative_attention_max_distance)
                + L.padding_bias(attention_mask,
                                 torch.finfo(torch.float32).min))
        nh = cfg.num_heads
        gelu = torch.nn.functional.gelu
        for lay in self.layers:
            x = lay.ln_att(h)
            ctx = L.attend(L.heads(L.dense(x, lay.q), nh),
                           L.heads(L.dense(x, lay.k), nh),
                           L.heads(L.dense(x, lay.v), nh), bias, None)
            h = h + L.dense(ctx, lay.o)
            x = lay.ln_ffn(h)
            if cfg.gated_act:
                ff = (gelu(L.dense(x, lay.wi_0), approximate="tanh")
                      * L.dense(x, lay.wi_1))
            else:
                ff = torch.relu(L.dense(x, lay.wi))
            h = h + L.dense(ff, lay.wo)
        h = self.ln_final(h)
        return {"last_hidden": h, "cls": h[:, 0]}


def params_from_state_dict(state_dict, cfg: T5Config
                           ) -> Dict[str, torch.Tensor]:
    """A ``transformers`` ``T5EncoderModel`` state dict as
    :class:`T5Encoder`'s, f32 (a file that keeps the tied table only as
    ``shared.weight`` is read too)."""
    get = L.getter(state_dict, PREFIXES)
    out = {
        "embed.weight": get("embed_tokens.weight", "shared.weight"),
        "rel_bias.weight": get(
            "block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "ln_final.weight": get("final_layer_norm.weight"),
    }
    ffn = ("wi_0", "wi_1") if cfg.gated_act else ("wi",)
    for i in range(cfg.num_layers):
        e, o = f"block.{i}", f"layers.{i}"
        out[f"{o}.ln_att.weight"] = get(f"{e}.layer.0.layer_norm.weight")
        for n in ("q", "k", "v", "o"):
            out[f"{o}.{n}.weight"] = get(f"{e}.layer.0.SelfAttention.{n}.weight")
        out[f"{o}.ln_ffn.weight"] = get(f"{e}.layer.1.layer_norm.weight")
        for n in ffn + ("wo",):
            out[f"{o}.{n}.weight"] = get(
                f"{e}.layer.1.DenseReluDense.{n}.weight")
    return out


def params_from_jax(jax_params, cfg: T5Config) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        shape = T5Encoder(cfg)
    return L.state_from_jax(shape, jax_params)


def config_from_hf(hf_config) -> T5Config:
    get = L.config_getter(hf_config)
    proj = get("feed_forward_proj", "relu")
    gated = get("is_gated_act")
    if gated is None:
        gated = proj.split("-")[0] == "gated"
    return T5Config(
        vocab_size=get("vocab_size"),
        hidden_size=get("d_model"),
        num_layers=get("num_layers"),
        num_heads=get("num_heads"),
        head_dim=get("d_kv"),
        intermediate_size=get("d_ff"),
        relative_attention_num_buckets=get("relative_attention_num_buckets",
                                           32),
        relative_attention_max_distance=get(
            "relative_attention_max_distance", 128),
        gated_act=bool(gated),
        layer_norm_eps=get("layer_norm_epsilon", 1e-6),
    )


def from_state(cfg: T5Config, state: Dict[str, torch.Tensor],
               device="cpu") -> T5Encoder:
    with torch.device("meta"):
        model = T5Encoder(cfg)
    return L.build(model, state, device)
