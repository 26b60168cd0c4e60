"""GPT-J causal encoder with checkpoint import.

Port of :mod:`ragroute_tpu.encoders.gptj`, the forward of
SGPT-5.8B-weightedmean-msmarco-specb-bitfit. GPT-J specifics kept:

* rotary position embeddings on the first ``rotary_dim`` head dims, in
  the interleaved (rotate-every-two) convention;
* PARALLEL attention + MLP: both read the same ``ln_1(x)`` and the block
  output is ``x + attn + mlp`` (no second layer norm);
* no biases on the q/k/v/out projections; biased fc_in / fc_out;
* causal masking combined with padding-key masking; attention logits in
  f32.

SGPT pooling (position-weighted mean over the specb-bracketed tokens) is in
:func:`ragroute_tpu_torch.encoders.bert.pool` and
:mod:`ragroute_tpu_torch.encoders.custom`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from ragroute_tpu_torch.encoders import layers as L

PREFIXES = ("", "transformer.", "0.auto_model.")


@dataclasses.dataclass(frozen=True)
class GPTJConfig:
    vocab_size: int = 50400
    hidden_size: int = 4096
    num_layers: int = 28
    num_heads: int = 16
    rotary_dim: int = 64
    intermediate_size: int = 16384
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class _Layer(nn.Module):
    def __init__(self, cfg: GPTJConfig, device=None, dtype=None):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.ln1 = L.LayerNorm(h, cfg.layer_norm_eps, device)
        self.q, self.k, self.v, self.out = (L.linear(h, h, bias=False, **kw)
                                            for _ in range(4))
        self.fc_in = L.linear(h, f, **kw)
        self.fc_out = L.linear(f, h, **kw)


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).reshape(x.shape)


def rotary_sincos(seq: int, rotary_dim: int, device) -> tuple:
    """``(sin, cos)`` ``[L, rotary_dim]``, each angle repeated for its
    interleaved pair (f32, computed as the JAX module computes them)."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, rotary_dim, 2) / rotary_dim))
    ang = np.einsum("i,j->ij", np.arange(seq, dtype=np.float32),
                    inv_freq.astype(np.float32))
    ang = np.repeat(ang, 2, axis=1)
    return (torch.from_numpy(np.sin(ang)).to(device),
            torch.from_numpy(np.cos(ang)).to(device))


class GPTJEncoder(nn.Module):
    def __init__(self, cfg: GPTJConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                device=device, dtype=dtype)
        self.ln_f = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.layers = nn.ModuleList(_Layer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))

    def _rotary(self, x, sin, cos):
        rd = self.cfg.rotary_dim
        head = x[..., :rd]
        return torch.cat([head * cos + _rotate_every_two(head) * sin,
                          x[..., rd:]], dim=-1)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids=None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        seq = input_ids.shape[1]
        dev = input_ids.device
        h = self.wte(input_ids).float()
        sin, cos = rotary_sincos(seq, cfg.rotary_dim, dev)   # [L, rd]
        causal = torch.ones(seq, seq, dtype=torch.bool, device=dev).tril()
        keep = causal[None, None] & (attention_mask[:, None, None, :] > 0)
        bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        nh = cfg.num_heads
        for lay in self.layers:
            x = lay.ln1(h)
            q = L.heads(L.dense(x, lay.q), nh)          # [B, n, L, d]
            k = L.heads(L.dense(x, lay.k), nh)
            v = L.heads(L.dense(x, lay.v), nh)
            q, k = self._rotary(q, sin, cos), self._rotary(k, sin, cos)
            attn = L.dense(L.attend(q, k, v, bias, scale), lay.out)
            mlp = L.dense(torch.nn.functional.gelu(
                L.dense(x, lay.fc_in), approximate="tanh"), lay.fc_out)
            h = h + attn + mlp          # parallel attention + MLP
        h = self.ln_f(h)
        return {"last_hidden": h, "cls": h[:, 0]}


def params_from_state_dict(state_dict, cfg: GPTJConfig
                           ) -> Dict[str, torch.Tensor]:
    """A ``transformers`` ``GPTJModel`` (or ``GPTJForCausalLM``) state dict
    as :class:`GPTJEncoder`'s, f32."""
    get = L.getter(state_dict, PREFIXES)
    out = {"wte.weight": get("wte.weight"),
           "ln_f.weight": get("ln_f.weight"), "ln_f.bias": get("ln_f.bias")}
    for i in range(cfg.num_layers):
        e, o = f"h.{i}", f"layers.{i}"
        out[f"{o}.ln1.weight"] = get(f"{e}.ln_1.weight")
        out[f"{o}.ln1.bias"] = get(f"{e}.ln_1.bias")
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("out", "out_proj")):
            out[f"{o}.{ours}.weight"] = get(f"{e}.attn.{theirs}.weight")
        for ours in ("fc_in", "fc_out"):
            for p in ("weight", "bias"):
                out[f"{o}.{ours}.{p}"] = get(f"{e}.mlp.{ours}.{p}")
    return out


def params_from_jax(jax_params, cfg: GPTJConfig) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        shape = GPTJEncoder(cfg)
    return L.state_from_jax(shape, jax_params)


def config_from_hf(hf_config) -> GPTJConfig:
    get = L.config_getter(hf_config)
    n_embd, n_head = get("n_embd"), get("n_head")
    return GPTJConfig(
        vocab_size=get("vocab_size"),
        hidden_size=n_embd,
        num_layers=get("n_layer"),
        num_heads=n_head,
        rotary_dim=get("rotary_dim") or (n_embd // n_head),
        intermediate_size=get("n_inner") or 4 * n_embd,
        layer_norm_eps=get("layer_norm_epsilon", 1e-5),
    )


def from_state(cfg: GPTJConfig, state: Dict[str, torch.Tensor],
               device="cpu") -> GPTJEncoder:
    with torch.device("meta"):
        model = GPTJEncoder(cfg)
    return L.build(model, state, device)
