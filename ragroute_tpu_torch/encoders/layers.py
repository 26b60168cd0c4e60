"""Pieces shared by the port's encoder forwards (BERT / XLM-R, MPNet, GPT-J,
T5).

The JAX package's encoders reach no Pallas kernel: their products are
``jnp.dot`` / ``einsum`` with f32 accumulation. The port keeps them as
``torch`` matmuls in the same order. Weights may be bf16 (the serving dtype,
``config.ENCODER_COMPUTE_DTYPE``): a projection casts its input to the
weight's dtype and returns f32, so the residual stream, the norms, the
attention logits and the softmax stay f32, as the JAX forwards' ``f32``
outputs of ``preferred_element_type`` keep them. Norm parameters stay f32.

Every module's parameter names mirror the JAX pytree (``w`` / ``scale`` ->
``weight``, ``b`` -> ``bias``, a bare table -> ``<name>.weight``), so
:func:`state_from_jax` maps a JAX pytree onto any of them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    """LayerNorm with f32 parameters whatever the weights' dtype."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """T5's scale-only norm, in f32: ``x * rsqrt(mean(x^2) + eps) * w``."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        var = x.pow(2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.weight


def linear(d_in: int, d_out: int, bias: bool = True, device=None,
           dtype=None) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=bias, device=device, dtype=dtype)


def dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``x @ w + b`` in the weight's dtype, returned in f32."""
    return lin(x.to(lin.weight.dtype)).float()


def heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``[B, L, n * d]`` -> ``[B, n, L, d]``."""
    b, l, _ = x.shape
    return x.view(b, l, n_heads, -1).transpose(1, 2)


def attend(q, k, v, bias, scale: Optional[float]) -> torch.Tensor:
    """f32 logits (scaled unless ``scale`` is None), the additive bias,
    softmax, then the weighted values: ``[B, n, L, d]`` in, ``[B, L, n * d]``
    out."""
    att = torch.matmul(q, k.transpose(-1, -2))
    if scale is not None:
        att = att * scale
    att = torch.softmax(att + bias, dim=-1)
    ctx = torch.matmul(att, v)
    b, n, l, d = ctx.shape
    return ctx.transpose(1, 2).reshape(b, l, n * d)


def padding_bias(mask: torch.Tensor, fill: float) -> torch.Tensor:
    """``[B, 1, 1, L]`` additive key bias: 0 where kept, ``fill`` where
    masked (``(1 - mask) * fill``)."""
    return (1.0 - mask[:, None, None, :].float()) * fill


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5-style bidirectional bucketing of relative positions (MPNet and
    T5)."""
    n = -relative_position
    half = num_buckets // 2
    ret = (n < 0).long() * half
    n = n.abs()
    max_exact = half // 2
    large = max_exact + (
        torch.log(n.float().clamp(min=1) / max_exact)
        / math.log(max_distance / max_exact) * (half - max_exact)).long()
    large = large.clamp(max=half - 1)
    return ret + torch.where(n < max_exact, n, large)


def relative_bias(table: nn.Embedding, seq: int, num_buckets: int,
                  max_distance: int = 128) -> torch.Tensor:
    """``[1, heads, L, L]`` bias from the bucket table ``[buckets,
    heads]``, f32."""
    pos = torch.arange(seq, device=table.weight.device)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                       num_buckets, max_distance)
    return table(buckets).float().permute(2, 0, 1)[None]


# ---- weights ----------------------------------------------------------------

def config_getter(hf_config):
    """``get(key, default)`` over a ``config.json`` dict or a
    ``transformers`` config object."""
    if isinstance(hf_config, dict):
        return hf_config.get
    return lambda key, default=None: getattr(hf_config, key, default)


def getter(state_dict, prefixes):
    """``get(name)``: the f32 tensor under the first prefix that has it."""

    def get(name, *aliases):
        for n in (name, *aliases):
            for prefix in prefixes:
                key = prefix + n
                if key in state_dict:
                    t = state_dict[key]
                    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(
                        np.asarray(t))
                    return t.detach().to("cpu", torch.float32)
        raise KeyError(name)

    return get


def state_from_jax(module: nn.Module, params) -> Dict[str, torch.Tensor]:
    """The JAX pytree ``params`` (numpy or JAX arrays) as ``module``'s state
    dict: ``w`` / ``scale`` become ``weight``, ``b`` / ``bias`` stay ``bias``,
    a bare array becomes ``<name>.weight``; a weight of an ``nn.Linear`` is
    transposed (JAX keeps ``[in, out]``)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            *owner, leaf = path
            name = {"w": "weight", "scale": "weight", "b": "bias",
                    "bias": "bias"}.get(leaf)
            if name is None:
                owner, name = path, "weight"
            t = torch.from_numpy(np.array(node, dtype=np.float32))
            if name == "weight" and isinstance(
                    module.get_submodule(".".join(owner)), nn.Linear):
                t = t.T.contiguous()
            out[".".join(owner + [name])] = t
    walk(params, [])
    return out


def build(module: nn.Module, state: Dict[str, torch.Tensor], device
          ) -> nn.Module:
    """``module`` (made on the ``meta`` device) with ``state`` loaded,
    moved to ``device``."""
    module.load_state_dict(state, strict=True, assign=True)
    return module.to(device).eval()


def cast_(module: nn.Module, dtype) -> nn.Module:
    """Projections and tables to ``dtype``; norm parameters stay f32."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.to(dtype)
    return module
