"""Llama-family causal decoder with KV-cache generation, in PyTorch.

Port of :mod:`ragroute_tpu.llm.model`: the decoder behind ``LLMClient(
backend="jax")`` (the flag value is the JAX package's; here it means
generation on the card with this module). One architecture covers the
registry models (Llama-3.1-8B-Instruct, Qwen3-8B, Qwen3-0.6B):

* RMSNorm (f32 accumulation), SwiGLU MLP, no biases;
* rotary embeddings in the half-rotation (NeoX) convention, with the
  optional Llama-3.1 frequency rescale (``rope_scaling``);
* grouped-query attention with an explicit ``head_dim`` and Qwen3's
  optional per-head q/k RMSNorm;
* tied or untied LM head; weight-only int8 (per-channel) or int4
  (group-wise, through the K5 kernel ``ops/int4_matmul``) quantization.

The weights are :class:`Decoder` / :class:`DecoderLayer` modules whose
tensors are buffers (nothing here trains); the steps are plain functions on
tensors. Generation has the JAX package's shapes and semantics: prompts
LEFT-padded to a bucket so every row's next token lands in the same cache
slot, a dense ``[L, B, S, Hkv, Dh]`` cache written in place, and a decode
loop of fixed length (``max_new``) with no host read inside it, so one batch
costs one synchronisation; rows emit ``pad_id`` after their EOS or past
their budget.

Random numbers come from an explicit ``torch.Generator``; they are not the
JAX package's, so sampling at T > 0 is held by its properties (top-k
membership, the top-p nucleus, determinism per seed) and greedy decoding
(T = 0) token for token.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ragroute_tpu_torch.ops.int4_matmul import int4_matmul, quantize_int4

Tensor = torch.Tensor
NEG = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    qk_norm: bool = False           # Qwen3: RMSNorm on q/k per head
    tie_embeddings: bool = False
    # Llama-3.1 rope rescale: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None = plain RoPE.
    rope_scaling: Optional[Tuple[float, float, float, int]] = None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

class QuantW(nn.Module):
    """int8 weight-only quantization of a ``[in, out]`` matrix with
    per-output-channel symmetric scales (``q`` int8, ``scale`` f32)."""

    def __init__(self, q: Tensor, scale: Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @classmethod
    def quantize(cls, w: Tensor, axis: int = 0) -> "QuantW":
        wf = w.to(torch.float32).contiguous()
        amax = wf.abs().amax(dim=axis).clamp_min(1e-12)
        scale = amax / 127.0
        q = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127, 127)
        return cls(q.to(torch.int8).contiguous(), scale)


class QuantW4(nn.Module):
    """int4 weight-only quantization: packed nibbles ``q`` int8 ``[in/2,
    out]`` and group scales ``scale`` f32 ``[in//group, out]``, multiplied
    by the K5 kernel (``ops/int4_matmul``)."""

    def __init__(self, q: Tensor, scale: Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def group(self) -> int:
        return (2 * self.q.shape[0]) // self.scale.shape[0]

    @classmethod
    def quantize(cls, w: Tensor, group: int = 128) -> "QuantW4":
        g = _int4_group(w.shape[0], group)
        return cls(*quantize_int4(w, group=g))


Weight = Union[Tensor, QuantW, QuantW4]
LAYER_MATS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


class _Weights(nn.Module):
    """Named weights: tensors as buffers, quantized matrices as modules."""

    def __init__(self, weights: Dict[str, Weight]):
        super().__init__()
        self._names: List[str] = list(weights)
        for name, w in weights.items():
            if isinstance(w, nn.Module):
                self.add_module(name, w)
            else:
                self.register_buffer(name, w)

    def items(self):
        return [(n, getattr(self, n)) for n in self._names]


class DecoderLayer(_Weights):
    """``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, ``gate``, ``up``,
    ``down`` (matrices ``[in, out]``) and, with qk-norm, ``q_norm`` and
    ``k_norm``."""


class Decoder(_Weights):
    """``embed`` (``[V, D]``; int8 per-row, or int4 head-form ``[D/2, V]``),
    ``ln_f``, ``lm_head`` when untied, and ``layers``."""

    def __init__(self, weights: Dict[str, Weight],
                 layers: List[DecoderLayer]):
        super().__init__(weights)
        self.layers = nn.ModuleList(layers)

    # The engines reach the weights through these five methods only;
    # ``llm/sharding.TPDecoder`` implements them over a mesh's cells.

    def embed_lookup(self, ids: Tensor) -> Tensor:
        return _embed_lookup(self, ids)

    def logits(self, cfg: DecoderConfig, h: Tensor) -> Tensor:
        return _logits(self, cfg, h)

    def init_cache(self, cfg: DecoderConfig, batch: int, max_len: int,
                   dtype) -> Dict[str, Tensor]:
        return init_cache(cfg, batch, max_len, dtype, device=self.ln_f.device)

    def prefill_layers(self, cfg, h, positions, kmask, *, inv_freq,
                       prefix_kv=None):
        return prefill_layers(self, cfg, h, positions, kmask,
                              inv_freq=inv_freq, prefix_kv=prefix_kv)

    def decode_layers(self, cfg, h, positions, kmask, cache, write, *,
                      inv_freq, prefix_kv=None) -> Tensor:
        return decode_layers(self, cfg, h, positions, kmask, cache, write,
                             inv_freq=inv_freq, prefix_kv=prefix_kv)


def _int4_group(in_dim: int, group: int = 128) -> int:
    """Largest group size <= ``group`` dividing in_dim/2."""
    half = in_dim // 2
    g = min(group, half)
    while half % g:
        g -= 1
    return g


# ---------------------------------------------------------------------------
# Layer math
# ---------------------------------------------------------------------------

def _rms(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def _mm(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` accumulated in f32, returned as f32."""
    return torch.matmul(x, w).to(torch.float32)


def _dot(x: Tensor, w: Weight) -> Tensor:
    if isinstance(w, QuantW4):
        shape = x.shape
        y = int4_matmul(x.reshape(-1, shape[-1]), w.q, w.scale,
                        group=w.group)
        return y.reshape(*shape[:-1], y.shape[-1]).to(x.dtype)
    if isinstance(w, QuantW):
        return (_mm(x, w.q.to(x.dtype)) * w.scale).to(x.dtype)
    return _mm(x, w).to(x.dtype)


def _inv_freq(cfg: DecoderConfig) -> np.ndarray:
    inv = 1.0 / (cfg.rope_theta
                 ** (np.arange(0, cfg.head_dim, 2) / cfg.head_dim))
    if cfg.rope_scaling is not None:
        # HF modeling_rope_utils._compute_llama3_parameters semantics
        factor, low_ff, high_ff, orig_max = cfg.rope_scaling
        low_wl = orig_max / low_ff
        high_wl = orig_max / high_ff
        wavelen = 2 * math.pi / inv
        inv_scaled = np.where(wavelen > low_wl, inv / factor, inv)
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        smoothed = (1 - smooth) / factor * inv + smooth * inv
        is_medium = (wavelen >= high_wl) & (wavelen <= low_wl)
        inv = np.where(is_medium, smoothed, inv_scaled)
    return inv.astype(np.float32)


def inv_freq_tensor(cfg: DecoderConfig, device) -> Tensor:
    return torch.from_numpy(_inv_freq(cfg)).to(device)


def _rope(x: Tensor, positions: Tensor, inv_freq: Tensor) -> Tensor:
    """Half-rotation RoPE. x: [B, T, H, Dh], positions: [B, T] int."""
    ang = positions.to(torch.float32)[..., None] * inv_freq   # [B,T,Dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    half = x.shape[-1] // 2
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def _qkv(layer: DecoderLayer, cfg: DecoderConfig, x: Tensor,
         positions: Tensor, inv_freq: Tensor):
    """Project + (qk-norm) + rope. Returns q [B,T,H,Dh], k/v [B,T,Hkv,Dh]."""
    b, t = x.shape[:2]
    q = _dot(x, layer.wq).reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = _dot(x, layer.wk).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = _dot(x, layer.wv).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = _rms(q, layer.q_norm, cfg.rms_eps)
        k = _rms(k, layer.k_norm, cfg.rms_eps)
    return _rope(q, positions, inv_freq), _rope(k, positions, inv_freq), v


def _attend(q: Tensor, k: Tensor, v: Tensor, kmask: Tensor,
            cfg: DecoderConfig, k_scale: Optional[Tensor] = None,
            v_scale: Optional[Tensor] = None, prefix_kv=None) -> Tensor:
    """GQA attention. q: [B,Tq,H,Dh]; k/v: [B,S,Hkv,Dh]; kmask: [B,Tq,S]
    True where the key may be attended. f32 scores and softmax.

    ``k_scale``/``v_scale`` ([B,S,Hkv] f32) are an int8 cache's dequant
    scales, applied to the score matrix and to the weights, never to the
    operands. ``prefix_kv`` = ``(pk, pv)``, each ``[P0,Hkv,Dh]``: a shared
    prompt prefix attended by every row before its own keys, in one
    softmax over the concatenated ``[P0 + S]`` axis."""
    groups = cfg.num_heads // cfg.num_kv_heads
    b, tq = q.shape[:2]
    qg = q.reshape(b, tq, cfg.num_kv_heads, groups,
                   cfg.head_dim).to(torch.float32)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    att = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    if k_scale is not None:
        att.mul_(k_scale.transpose(1, 2)[:, :, None, None, :])
    att.mul_(scale)
    att.masked_fill_(~kmask[:, None, None], NEG)
    if prefix_kv is not None:
        pk, pv = prefix_kv
        patt = torch.einsum("bqhgd,khd->bhgqk", qg,
                            pk.to(torch.float32)) * scale
        att = torch.cat([patt, att], dim=-1)          # [.., P0 + S]
    att = torch.softmax(att, dim=-1)
    if prefix_kv is not None:
        p0 = prefix_kv[0].shape[0]
        pctx = torch.einsum("bhgqk,khd->bqhgd", att[..., :p0],
                            pv.to(torch.float32))
        att = att[..., p0:]
    if v_scale is not None:
        att = att * v_scale.transpose(1, 2)[:, :, None, None, :]
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", att, v.to(torch.float32))
    if prefix_kv is not None:
        ctx = ctx + pctx
    return ctx.reshape(b, tq, cfg.q_dim).to(q.dtype)


def _mlp(layer: DecoderLayer, x: Tensor) -> Tensor:
    return _dot(torch.nn.functional.silu(_dot(x, layer.gate))
                * _dot(x, layer.up), layer.down)


def _embed_lookup(params: Decoder, ids: Tensor) -> Tensor:
    e = params.embed
    if isinstance(e, QuantW4):
        # head-form [D/2, V] packed along D: gather the token columns and
        # unpack them (B columns, never the V x D table)
        d2 = e.q.shape[0]
        g = e.scale.shape[0]
        flat = ids.reshape(-1)
        cols = e.q[:, flat].to(torch.int32)                  # [D/2, N]
        lo = ((cols & 0x0F) ^ 8) - 8
        hi = cols >> 4
        codes = torch.cat([lo, hi], dim=0)                   # [D, N]
        s = e.scale[:, flat]                                 # [G, N]
        deq = (codes.to(torch.float32).reshape(g, (2 * d2) // g, -1)
               * s[:, None])
        emb = deq.reshape(2 * d2, -1).T
        return emb.reshape(*ids.shape, 2 * d2).to(params.ln_f.dtype)
    if isinstance(e, QuantW):  # q [V, D] int8, scale [V]
        return (e.q[ids].to(torch.float32)
                * e.scale[ids][..., None]).to(params.ln_f.dtype)
    return e[ids]


def _logits(params: Decoder, cfg: DecoderConfig, h: Tensor) -> Tensor:
    h = _rms(h, params.ln_f, cfg.rms_eps)

    def head4(w4: QuantW4) -> Tensor:
        shape = h.shape
        y = int4_matmul(h.reshape(-1, shape[-1]), w4.q, w4.scale,
                        group=w4.group)
        return y.reshape(*shape[:-1], y.shape[-1])

    if cfg.tie_embeddings:
        e = params.embed
        if isinstance(e, QuantW4):  # stored head-form [D/2, V]
            return head4(e)
        if isinstance(e, QuantW):   # head = embed.T -> per-COLUMN scales
            return _mm(h, e.q.T.to(h.dtype)) * e.scale
        head = e.T
    else:
        head = params.lm_head
        if isinstance(head, QuantW4):
            return head4(head)
        if isinstance(head, QuantW):
            return _mm(h, head.q.to(h.dtype)) * head.scale
    return _mm(h, head)


def quantize_decoder_params(params: Decoder, cfg: DecoderConfig,
                            quantize_embed: bool = True, bits: int = 8,
                            group: int = 128) -> Decoder:
    """Weight-only quantization of every layer matrix, the LM head and
    (optionally) the embedding table, on the weights' own device.

    ``bits=8``: per-output-channel int8 scales. ``bits=4``: packed int4
    with group-wise scales through the K5 kernel; the embedding table is
    stored head-form (``embed.T`` quantized along D) so the tied head rides
    the kernel and lookups gather + unpack columns."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def qmat(w):
        if bits == 8:
            return QuantW.quantize(w)
        return QuantW4.quantize(w, group=group)

    layers = [DecoderLayer({k: (qmat(v) if k in LAYER_MATS else v)
                            for k, v in layer.items()})
              for layer in params.layers]
    out = {"ln_f": params.ln_f}
    if quantize_embed:
        if bits == 8:
            # [V, D] with per-ROW scales: exact for both the lookup and the
            # tied head (columns of embed.T)
            out["embed"] = QuantW.quantize(params.embed, axis=1)
        else:
            out["embed"] = QuantW4.quantize(params.embed.T, group=group)
    else:
        out["embed"] = params.embed
    if not cfg.tie_embeddings:
        out["lm_head"] = qmat(params.lm_head)
    return Decoder(out, layers)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: DecoderConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cpu") -> Dict[str, Tensor]:
    """KV cache ``[L, B, S, Hkv, Dh]``. ``dtype="int8"`` quantizes it: int8
    codes with per-(position, head) f32 scales (``ks``/``vs``)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if isinstance(dtype, str):
        if dtype != "int8":
            raise ValueError(f"unknown cache dtype {dtype!r}")
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device),
                "vs": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quant_kv(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric int8 per-(..., head) quantization over head_dim:
    ``x [..., Dh]`` -> ``(codes int8 [..., Dh], scales f32 [...])``."""
    s = x.abs().amax(dim=-1).clamp_min(1e-12).to(torch.float32) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / s[..., None]),
                    -127, 127).to(torch.int8)
    return q, s


def cache_write(cache: Dict[str, Tensor], name: str, val: Tensor,
                index: tuple) -> None:
    """The one quantize-aware KV-cache write of every engine: ``val`` goes
    to ``plane[index]`` of the ``name`` plane (and its scales to the
    ``name + "s"`` plane of an int8 cache). ``index`` names leading axes
    only, ``(layer, batch rows, positions)``, so the same index serves the
    code plane ``[..., Dh]`` and the scale plane ``[...]``. A tensor-parallel
    decoder's head-split K/V (``llm/sharding.Split``) write themselves into
    its cells' caches."""
    if not isinstance(val, Tensor):
        val.write_into(cache, name, index)
        return
    if name + "s" in cache:
        q, s = quant_kv(val)
        cache[name][index] = q
        cache[name + "s"][index] = s
    else:
        cache[name][index] = val.to(cache[name].dtype)


def cache_read(cache: Dict[str, Tensor], name: str, li: int):
    """Layer ``li``'s K or V codes plus the dequant scale (``None`` for a
    float cache); ``_attend`` folds the scales into the scores."""
    s = cache.get(name + "s")
    return cache[name][li], (None if s is None else s[li])


def stack_layers(kv: List[Tensor]) -> Tensor:
    """Per-layer K or V ``[n, P, Hkv, Dh]`` stacked as ``[L, n, P, Hkv,
    Dh]`` (a tensor-parallel decoder's head-split ones stack cell by cell)."""
    if isinstance(kv[0], Tensor):
        return torch.stack(kv)
    return type(kv[0]).stack(kv)


# ---------------------------------------------------------------------------
# Layer stacks and steps
# ---------------------------------------------------------------------------

def prefill_layers(params: Decoder, cfg: DecoderConfig, h: Tensor,
                   positions: Tensor, kmask: Tensor, *, inv_freq: Tensor,
                   prefix_kv=None):
    """The stack for prefill-side engines (lockstep prefill, continuous
    admission). Returns (h, ks, vs) with per-layer fresh K/V lists."""
    ks, vs = [], []
    for li, layer in enumerate(params.layers):
        x = _rms(h, layer.ln1, cfg.rms_eps)
        q, k, v = _qkv(layer, cfg, x, positions, inv_freq)
        ks.append(k)
        vs.append(v)
        pkv = (None if prefix_kv is None
               else (prefix_kv[0][li], prefix_kv[1][li]))
        h = h + _dot(_attend(q, k, v, kmask, cfg, prefix_kv=pkv), layer.wo)
        h = h + _mlp(layer, _rms(h, layer.ln2, cfg.rms_eps))
    return h, ks, vs


def decode_layers(params: Decoder, cfg: DecoderConfig, h: Tensor,
                  positions: Tensor, kmask: Tensor, cache, write, *,
                  inv_freq: Tensor, prefix_kv=None) -> Tensor:
    """The stack for decode-side engines (lockstep step, continuous chunk,
    speculative window). ``write(cache, li, k, v)`` stores fresh K/V in the
    caller's cache layout: the only thing that differs between engines."""
    for li, layer in enumerate(params.layers):
        x = _rms(h, layer.ln1, cfg.rms_eps)
        q, k, v = _qkv(layer, cfg, x, positions, inv_freq)
        write(cache, li, k, v)
        ck, ksc = cache_read(cache, "k", li)
        cv, vsc = cache_read(cache, "v", li)
        pkv = (None if prefix_kv is None
               else (prefix_kv[0][li], prefix_kv[1][li]))
        h = h + _dot(_attend(q, ck, cv, kmask, cfg, k_scale=ksc,
                             v_scale=vsc, prefix_kv=pkv), layer.wo)
        h = h + _mlp(layer, _rms(h, layer.ln2, cfg.rms_eps))
    return h


def prefill(params: Decoder, cfg: DecoderConfig, input_ids: Tensor,
            attention_mask: Tensor, cache) -> Tuple[Tensor, Dict]:
    """Run the prompt (LEFT-padded to its bucket length P <= S) and fill
    cache slots [0, P). Returns (last-position logits [B, V] f32, cache)."""
    b, p = input_ids.shape
    dev = input_ids.device
    inv_freq = inv_freq_tensor(cfg, dev)
    mask = attention_mask.to(torch.int32)
    # absolute position of each prompt token (0 for pads; they're masked)
    positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0)
    causal = torch.tril(torch.ones((p, p), dtype=torch.bool, device=dev))
    kmask = causal[None] & (mask[:, None, :] > 0)

    h = params.embed_lookup(input_ids)
    h, new_k, new_v = params.prefill_layers(cfg, h, positions, kmask,
                                            inv_freq=inv_freq)
    for li in range(cfg.num_layers):
        at_origin = (li, slice(None, b), slice(None, p))
        cache_write(cache, "k", new_k[li], at_origin)
        cache_write(cache, "v", new_v[li], at_origin)
    return params.logits(cfg, h[:, -1:])[:, 0], cache


def decode_step(params: Decoder, cfg: DecoderConfig, cache, token: Tensor,
                lengths: Tensor, prompt_pad: int, t: int
                ) -> Tuple[Tensor, Dict]:
    """One decode step: ``token`` [B] goes to cache slot ``prompt_pad + t``;
    row b's rotary position is ``lengths[b] + t``. Returns (logits [B, V]
    f32, cache)."""
    s = cache["k"].shape[2]
    dev = token.device
    inv_freq = inv_freq_tensor(cfg, dev)
    positions = (lengths + t)[:, None]            # [B, 1]
    slot = prompt_pad + t
    iota = torch.arange(s, device=dev)
    # valid keys: prompt tokens [P - len_b, P) plus generated [P, P + t]
    kmask = ((iota[None, :] >= prompt_pad - lengths[:, None])
             & (iota[None, :] <= slot))[:, None, :]  # [B, 1, S]

    def write(cache, li, k, v):
        at_slot = (li, slice(None), slice(slot, slot + 1))
        cache_write(cache, "k", k, at_slot)
        cache_write(cache, "v", v, at_slot)

    h = params.embed_lookup(token)[:, None]       # [B, 1, D]
    h = params.decode_layers(cfg, h, positions, kmask, cache, write,
                             inv_freq=inv_freq)
    return params.logits(cfg, h)[:, 0], cache


def sample_token(logits: Tensor, generator: Optional[torch.Generator],
                 temperature: float, top_k: int = 0,
                 top_p: float = 1.0) -> Tensor:
    """Greedy at temperature 0 (the first maximum, as ``jnp.argmax``), else
    categorical over f32 logits [B, V] by the Gumbel-max draw, optionally
    truncated: ``top_k`` keeps the k highest logits, ``top_p`` the smallest
    nucleus whose mass reaches p (top-k first). Returns int32 [B]."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    l = logits.to(torch.float32) / temperature
    if top_k and top_k < l.shape[-1]:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, NEG, l)
    if top_p < 1.0:
        srt = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        # keep a sorted token while the mass BEFORE it is < p (so the
        # nucleus always contains at least the argmax)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        thresh = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
        l = torch.where(l < thresh, NEG, l)
    u = torch.rand(l.shape, generator=generator, device=l.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(l + gumbel, dim=-1).to(torch.int32)


def make_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def generate(params: Decoder, cfg: DecoderConfig, input_ids: Tensor,
             attention_mask: Tensor, max_new: int, *, eos_id: int,
             pad_id: int = 0, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 1.0, rng_seed: int = 0,
             cache_dtype=torch.float32,
             first_token: Optional[Tensor] = None,
             budgets: Optional[Tensor] = None,
             cache=None) -> Tuple[Tensor, Tensor]:
    """Prefill + ``max_new - 1`` lockstep decode steps.

    Returns (tokens [B, max_new] int32, done [B] bool). Rows emit
    ``pad_id`` after their EOS; ``budgets`` [B] caps each row's emitted
    tokens below ``max_new`` (rows past their budget emit ``pad_id``). The
    loop reads nothing back from the device."""
    b, p = input_ids.shape
    dev = input_ids.device
    lengths = attention_mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
    if budgets is None:
        budgets = torch.full((b,), max_new, dtype=torch.int32, device=dev)
    if cache is None:
        cache = params.init_cache(cfg, b, p + max_new, cache_dtype)
    logits0, cache = prefill(params, cfg, input_ids, attention_mask, cache)
    gen = make_generator(dev, rng_seed) if temperature > 0.0 else None
    tok0 = (first_token if first_token is not None
            else sample_token(logits0, gen, temperature, top_k, top_p))
    done = (tok0 == eos_id) | (budgets <= 1)
    tok = torch.where(budgets <= 0, pad_id, tok0).to(torch.int32)
    out = [tok]
    for t in range(max_new - 1):
        logits, cache = decode_step(params, cfg, cache, tok, lengths, p, t)
        nxt = sample_token(logits, gen, temperature, top_k, top_p)
        nxt = torch.where(done, pad_id, nxt).to(torch.int32)
        # emitting index t+1 (0-based); a row is done once it has emitted
        # budget tokens, i.e. after index budget-1
        done = done | (nxt == eos_id) | (t + 2 >= budgets)
        out.append(nxt)
        tok = nxt
    tokens = torch.stack(out, dim=1)
    if max_new <= 1:
        return tokens, done
    # mask everything after the first eos to pad
    is_eos = tokens == eos_id
    after = torch.cumsum(is_eos.to(torch.int32), dim=1)
    keep = (after == 0) | (is_eos & (after == 1))
    return torch.where(keep, tokens, pad_id).to(torch.int32), done


# ---------------------------------------------------------------------------
# Weights from elsewhere
# ---------------------------------------------------------------------------

def params_from_torch_causal_lm(state_dict, cfg: DecoderConfig,
                                dtype=torch.float32) -> Decoder:
    """A HF llama/qwen3 causal-LM state dict as a :class:`Decoder`
    (matrices transposed to ``[in, out]``)."""

    def get(name):
        for prefix in ("", "model."):
            if prefix + name in state_dict:
                t = state_dict[prefix + name]
                t = t if isinstance(t, Tensor) else torch.as_tensor(
                    np.asarray(t))
                return t.detach().to("cpu", torch.float32)
        raise KeyError(name)

    def w(name):  # torch Linear stores [out, in]; we want [in, out]
        return get(name).T.contiguous().to(dtype)

    top = {"embed": get("embed_tokens.weight").to(dtype),
           "ln_f": get("norm.weight").to(dtype)}
    if not cfg.tie_embeddings:
        top["lm_head"] = w("lm_head.weight")
    layers = []
    for i in range(cfg.num_layers):
        e = f"layers.{i}"
        layer = {
            "ln1": get(f"{e}.input_layernorm.weight").to(dtype),
            "ln2": get(f"{e}.post_attention_layernorm.weight").to(dtype),
            "wq": w(f"{e}.self_attn.q_proj.weight"),
            "wk": w(f"{e}.self_attn.k_proj.weight"),
            "wv": w(f"{e}.self_attn.v_proj.weight"),
            "wo": w(f"{e}.self_attn.o_proj.weight"),
            "gate": w(f"{e}.mlp.gate_proj.weight"),
            "up": w(f"{e}.mlp.up_proj.weight"),
            "down": w(f"{e}.mlp.down_proj.weight"),
        }
        if cfg.qk_norm:
            layer["q_norm"] = get(f"{e}.self_attn.q_norm.weight").to(dtype)
            layer["k_norm"] = get(f"{e}.self_attn.k_norm.weight").to(dtype)
        layers.append(DecoderLayer(layer))
    return Decoder(top, layers)


def _tensor(a) -> Tensor:
    """A numpy array (bfloat16 ones as the ml_dtypes type) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _weight_from_tree(node) -> Weight:
    if hasattr(node, "q") and hasattr(node, "scale"):
        q, scale = _tensor(node.q), _tensor(node.scale)
        return QuantW4(q, scale) if scale.dim() == 2 else QuantW(q, scale)
    return _tensor(node)


def params_from_jax(tree) -> Decoder:
    """The JAX package's parameter pytree as a :class:`Decoder`: a dict
    with ``embed``, ``ln_f``, optional ``lm_head`` and ``layers`` (a list of
    dicts), whose leaves are arrays (numpy, or anything ``np.asarray``
    takes) and whose quantized matrices are objects with ``.q`` and
    ``.scale`` (``QuantW``: 1-D scales; ``QuantW4``: 2-D group scales)."""
    top = {k: _weight_from_tree(v) for k, v in tree.items() if k != "layers"}
    layers = [DecoderLayer({k: _weight_from_tree(v) for k, v in l.items()})
              for l in tree["layers"]]
    return Decoder(top, layers)


def config_from_hf(hf_config) -> DecoderConfig:
    """DecoderConfig from a HF LlamaConfig / Qwen3Config."""
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads)
    scaling = None
    rs = getattr(hf_config, "rope_scaling", None)
    if rs:
        kind = rs.get("rope_type", rs.get("type"))
        if kind == "llama3":
            scaling = (rs["factor"], rs["low_freq_factor"],
                       rs["high_freq_factor"],
                       rs["original_max_position_embeddings"])
        elif kind not in (None, "default"):
            # silently using plain RoPE would generate garbage beyond the
            # original context window — refuse loudly
            raise ValueError(
                f"unsupported rope_scaling type {kind!r} (supported: "
                "llama3, default); the checkpoint needs a frequency "
                "schedule this decoder does not implement yet")
    return DecoderConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", None)
        or hf_config.num_attention_heads,
        head_dim=head_dim,
        intermediate_size=hf_config.intermediate_size,
        rms_eps=hf_config.rms_norm_eps,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        qk_norm=type(hf_config).__name__.startswith("Qwen3"),
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        rope_scaling=scaling,
    )


def init_decoder_params(seed, cfg: DecoderConfig, dtype=torch.float32,
                        device="cpu") -> Decoder:
    """Deterministic random weights (demo / test / measurement) from a seed
    or a ``torch.Generator`` on ``device``: normal draws scaled by
    ``1/sqrt(in)`` (the embedding by 0.02), norms at one."""
    gen = (seed if isinstance(seed, torch.Generator)
           else make_generator(device, seed))

    def mat(shape, scale=None):
        s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return x.mul_(s).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    d = cfg.hidden_size
    top = {"embed": mat((cfg.vocab_size, d), 0.02), "ln_f": ones(d)}
    if not cfg.tie_embeddings:
        top["lm_head"] = mat((d, cfg.vocab_size))
    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "ln1": ones(d), "ln2": ones(d),
            "wq": mat((d, cfg.q_dim)), "wk": mat((d, cfg.kv_dim)),
            "wv": mat((d, cfg.kv_dim)), "wo": mat((cfg.q_dim, d)),
            "gate": mat((d, cfg.intermediate_size)),
            "up": mat((d, cfg.intermediate_size)),
            "down": mat((cfg.intermediate_size, d)),
        }
        if cfg.qk_norm:
            layer["q_norm"] = ones(cfg.head_dim)
            layer["k_norm"] = ones(cfg.head_dim)
        layers.append(DecoderLayer(layer))
    return Decoder(top, layers)
