"""One-token GQA attention over one layer of the folded KV cache (K6).

PyTorch/CUDA counterpart of ``ragroute_tpu/ops/decode_attention.py``. As in
the JAX package, it serves no engine: the decoders attend through the
einsum path of :func:`ragroute_tpu_torch.llm.model._attend`, and this module
is the measured alternative, held to that path's math (``chip_smoke.py``
times it against ``_attend`` on the card). Whether to wire it in is a
question for a measurement, not for this module.

:func:`decode_attention` takes the query ``[B, H, Dh]`` and the cache planes
``[L, B, S, Hkv*Dh]``: a contiguous ``[L, B, S, Hkv, Dh]`` cache seen as its
folded view, so the kernel reads the engines' own cache with no copy, and
the layer is an argument, not a slice. On a CUDA tensor it launches
``csrc/decode_attention.cu`` or raises; on a CPU tensor it runs
:func:`decode_attention_reference`, the plain version (``_attend``'s
einsums on layer ``li``). :func:`fused_ok` says whether the kernel can serve
a call.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

GMAX = 8                 # csrc/decode_attention.cu: query heads a kv head
THREADS = 128            # threads a block
DMAX = 256               # head dim at most
TILE = 32                # positions a tile (one a lane in the score phase)
STAGES = 3               # tiles in the shared-memory ring
SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)
SM_SMEM = 233_472        # shared memory of an SM (H100)
BLOCK_SMEM_RESERVED = 1024  # shared memory the card keeps for each block
BLOCKS_PER_SM = 4        # split target: blocks in flight an SM, at most
MIN_CHUNK = 64           # fewest positions a split
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def decode_attention_reference(q: Tensor, k: Tensor, v: Tensor, ok: Tensor,
                               *, li: int, num_kv_heads: int, head_dim: int,
                               k_scale: Optional[Tensor] = None,
                               v_scale: Optional[Tensor] = None) -> Tensor:
    """Plain version, ``_attend``'s math for one query token on layer
    ``li``: f32 scores, times ``k_scale``, times ``1/sqrt(Dh)``, masked to
    ``finfo(f32).min``, softmax, times ``v_scale``, weights . V."""
    b, h, dh = q.shape
    hkv, groups = num_kv_heads, h // num_kv_heads
    s = k.shape[2]
    kk = k[li].reshape(b, s, hkv, dh).to(torch.float32)
    vv = v[li].reshape(b, s, hkv, dh).to(torch.float32)
    qg = q.reshape(b, hkv, groups, dh).to(torch.float32)
    att = torch.einsum("bhgd,bkhd->bhgk", qg, kk)
    if k_scale is not None:
        att = att * k_scale[li].transpose(1, 2)[:, :, None, :]
    att = att * (1.0 / math.sqrt(dh))
    valid = (ok > 0)[:, None, None, :]
    att = torch.where(valid, att, torch.finfo(torch.float32).min)
    att = torch.softmax(att, dim=-1)
    if v_scale is not None:
        att = att * v_scale[li].transpose(1, 2)[:, :, None, :]
    ctx = torch.einsum("bhgk,bkhd->bhgd", att, vv)
    return ctx.reshape(b, h, dh)


def row_bytes(head_dim: int, itemsize: int) -> int:
    """Bytes of one cached row's ``Dh`` slice in the kernel's shared memory:
    whole 16-byte chunks and one more (bank spread)."""
    return -(-head_dim * itemsize // 16) * 16 + 16


def smem_bytes(num_heads: int, num_kv_heads: int, head_dim: int,
               itemsize: int) -> int:
    """Shared memory of one split block: the ring of K and V tiles (which
    at the end holds the position stripes' context sums), one tile's
    weights, the per-head softmax terms and the queries."""
    g = num_heads // num_kv_heads
    ring = STAGES * 2 * TILE * row_bytes(head_dim, itemsize)
    sums = 16 * THREADS * g    # the stripes' context sums, in the ring
    return max(ring, sums) + 4 * (TILE * GMAX + 2 * GMAX + g * head_dim)


@functools.lru_cache(maxsize=None)
def split_plan(b: int, num_heads: int, num_kv_heads: int, head_dim: int,
               s: int, sms: int, itemsize: int) -> Tuple[int, int]:
    """(splits, chunk): cut the ``s`` positions of every (row, kv head) into
    runs of ``chunk`` (a multiple of ``TILE``, none empty) so that the blocks
    fill the card in one wave (as many as fit an SM, at most
    ``BLOCKS_PER_SM``), with at least ``MIN_CHUNK`` positions a run. Shared
    memory does not depend on the run's length."""
    smem = smem_bytes(num_heads, num_kv_heads, head_dim, itemsize)
    per_sm = max(1, min(BLOCKS_PER_SM, SM_SMEM // (smem + BLOCK_SMEM_RESERVED)))
    pairs = b * num_kv_heads
    splits = max(1, min(per_sm * sms // pairs, -(-s // MIN_CHUNK)))
    chunk = -(-(-(-s // splits)) // TILE) * TILE
    return -(-s // chunk), chunk


def fused_ok(num_heads: int, num_kv_heads: int, head_dim: int,
             kplane: Tensor) -> bool:
    """Whether the kernel can serve this decode-attention call.

    Gates, as in the JAX package: the ``RAGROUTE_DECODE_ATTN`` override
    (``xla``: never; ``fused``: also for a CPU plane, where the wrapper runs
    the plain version), the device (a CUDA plane), whole query groups, and
    what the kernel holds: at most 8 query heads a kv head, ``head_dim`` at
    most 256, an f32 / bf16 / int8 cache. Any cache length fits: a block
    keeps a ring of position tiles in shared memory, not its split.
    ``kplane`` is the folded cache plane ``[L, B, S, Hkv*Dh]``."""
    mode = os.environ.get("RAGROUTE_DECODE_ATTN", "auto")
    if mode == "xla":
        return False
    if mode != "fused" and not kplane.is_cuda:
        return False
    if num_heads % num_kv_heads or num_heads // num_kv_heads > GMAX:
        return False
    return head_dim <= DMAX and kplane.dtype in _KV_TYPES


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib():
    from ragroute_tpu_torch.ops import _build

    lib, _ = _build.load("decode_attention")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = (
            [vp] * 9 + [ci] * 10 + [ctypes.c_longlong, vp])
        lib.decode_attention_launch.restype = ci
        lib._argtypes_set = True
    return lib


def _launch(q, k, v, ok, li, hkv, dh, k_scale, v_scale) -> Tensor:
    b, h, _ = q.shape
    nl, _, s, hkvdh = k.shape
    dev = k.device
    if k.dtype not in _KV_TYPES or v.dtype != k.dtype:
        raise TypeError(f"decode_attention: cache dtype {k.dtype} / {v.dtype}"
                        " (float32, bfloat16 or int8, both alike)")
    if (k_scale is None) != (v_scale is None) or (
            k.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("decode_attention: an int8 cache needs both scales, "
                         "a float cache none")
    if h % hkv or h // hkv > GMAX or dh > DMAX:
        raise ValueError(
            f"decode_attention: the kernel does not take H={h}, Hkv={hkv}, "
            f"Dh={dh} (at most {GMAX} query heads a kv head, Dh <= "
            f"{DMAX})")
    for name, t in (("k", k), ("v", v), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is not None and (t.device != dev or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"decode_attention: {name} must be a contiguous,"
                             f" 16-byte aligned tensor on {dev}")
    if k_scale is not None and (k_scale.dtype != torch.float32
                                or tuple(k_scale.shape) != (nl, b, s, hkv)
                                or tuple(v_scale.shape) != (nl, b, s, hkv)):
        raise ValueError("decode_attention: scales must be f32 [L, B, S, Hkv]")
    if tuple(ok.shape) != (b, s):
        raise ValueError(f"decode_attention: ok must be [B, S] = {(b, s)}, "
                         f"got {tuple(ok.shape)}")
    # no copy of what is already f32 / one byte a key, contiguous, on the card
    qf = q.to(device=dev, dtype=torch.float32).contiguous()
    if ok.dtype not in (torch.bool, torch.uint8):
        ok = ok > 0
    okb = ok.to(device=dev).contiguous().view(torch.uint8)
    item = k.element_size()
    splits, chunk = split_plan(b, h, hkv, dh, s, _sm_count(dev), item)
    g = h // hkv
    # one allocation: the output, then the splits' scratch when there is any
    n_out, n_o = b * h * dh, b * hkv * splits * g * dh
    ws = torch.empty(n_out + (n_o + n_o // dh * 2 if splits > 1 else 0),
                     dtype=torch.float32, device=dev)
    out = ws[:n_out].view(b, h, dh)
    ws_o = ws_ml = None
    if splits > 1:
        ws_o = ws.data_ptr() + 4 * n_out
        ws_ml = ws_o + 4 * n_o
    err = _lib().decode_attention_launch(
        qf.data_ptr(), k.data_ptr(), v.data_ptr(), okb.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(), ws_o, ws_ml,
        out.data_ptr(), b, h, hkv, dh, s, nl, li, _KV_TYPES[k.dtype], splits,
        chunk, smem_bytes(h, hkv, dh, item),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


def decode_attention(q: Tensor, k: Tensor, v: Tensor, ok: Tensor, *,
                     li: int, num_kv_heads: int, head_dim: int,
                     k_scale: Optional[Tensor] = None,
                     v_scale: Optional[Tensor] = None) -> Tensor:
    """One-token GQA attention for layer ``li``: ``[B, H, Dh]`` f32.

    Args as the JAX package's ``decode_attention``: ``q`` ``[B, H, Dh]``;
    ``k``, ``v`` the folded planes ``[L, B, S, Hkv*Dh]`` (f32 / bf16, or
    int8 codes with ``k_scale`` / ``v_scale`` ``[L, B, S, Hkv]`` f32);
    ``ok`` ``[B, S]`` key validity (bool or 0/1)."""
    b, h, dh = q.shape
    nl, _, s, hkvdh = k.shape
    if dh != head_dim or hkvdh != num_kv_heads * dh or not 0 <= li < nl:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, planes "
                         f"{tuple(k.shape)}, li {li}")
    if k.is_cuda:
        return _launch(q, k, v, ok, li, num_kv_heads, dh, k_scale, v_scale)
    return decode_attention_reference(q, k, v, ok, li=li,
                                      num_kv_heads=num_kv_heads,
                                      head_dim=head_dim, k_scale=k_scale,
                                      v_scale=v_scale)


decode_attention.launches = 0   # kernel launches since the count was last reset
