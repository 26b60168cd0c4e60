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
THREADS = 256            # threads a block (so Dh <= 256)
SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)
BLOCKS_PER_SM = 4        # split target: blocks in flight an SM
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


def smem_bytes(num_heads: int, num_kv_heads: int, head_dim: int,
               chunk: int) -> int:
    """Shared memory of one split block over ``chunk`` positions."""
    g = num_heads // num_kv_heads
    return 4 * (g * head_dim + g * chunk + THREADS * GMAX)


def split_plan(b: int, num_heads: int, num_kv_heads: int, head_dim: int,
               s: int, sms: int) -> Tuple[int, int]:
    """(splits, chunk): cut the ``s`` positions of every (row, kv head) into
    runs of ``chunk`` (none empty) so that about ``BLOCKS_PER_SM`` blocks an
    SM are in flight, at least ``MIN_CHUNK`` positions a run, and one run's
    scores fit in shared memory."""
    want = max(1, -(-BLOCKS_PER_SM * sms // (b * num_kv_heads)))
    splits = max(1, min(want, s // MIN_CHUNK))
    chunk = -(-s // splits)
    while smem_bytes(num_heads, num_kv_heads, head_dim, chunk) > SMEM_LIMIT:
        chunk = -(-chunk // 2)
    return -(-s // chunk), chunk


def fused_ok(num_heads: int, num_kv_heads: int, head_dim: int,
             kplane: Tensor) -> bool:
    """Whether the kernel can serve this decode-attention call.

    Gates, as in the JAX package: the ``RAGROUTE_DECODE_ATTN`` override
    (``xla``: never; ``fused``: also for a CPU plane, where the wrapper runs
    the plain version), the device (a CUDA plane), whole query groups, and
    what the kernel holds: at most 8 query heads a kv head, ``head_dim`` at
    most 256, an f32 / bf16 / int8 cache. Any cache length fits: the
    positions are split until a split's scores fit in shared memory.
    ``kplane`` is the folded cache plane ``[L, B, S, Hkv*Dh]``."""
    mode = os.environ.get("RAGROUTE_DECODE_ATTN", "auto")
    if mode == "xla":
        return False
    if mode != "fused" and not kplane.is_cuda:
        return False
    if num_heads % num_kv_heads or num_heads // num_kv_heads > GMAX:
        return False
    return head_dim <= THREADS and kplane.dtype in _KV_TYPES


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
    if h % hkv or h // hkv > GMAX or dh > THREADS:
        raise ValueError(
            f"decode_attention: the kernel does not take H={h}, Hkv={hkv}, "
            f"Dh={dh} (at most {GMAX} query heads a kv head, Dh <= "
            f"{THREADS})")
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
    qf = q.to(device=dev, dtype=torch.float32).contiguous()
    okb = (ok > 0).to(device=dev, dtype=torch.uint8).contiguous()
    splits, chunk = split_plan(b, h, hkv, dh, s, _sm_count(dev))
    g = h // hkv
    ws_o = torch.empty((b, hkv, splits, g, dh), dtype=torch.float32,
                       device=dev)
    ws_ml = torch.empty((b, hkv, splits, g, 2), dtype=torch.float32,
                        device=dev)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    err = _lib().decode_attention_launch(
        qf.data_ptr(), k.data_ptr(), v.data_ptr(), okb.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(), ws_o.data_ptr(),
        ws_ml.data_ptr(), out.data_ptr(), b, h, hkv, dh, s, nl, li,
        _KV_TYPES[k.dtype], splits, chunk, smem_bytes(h, hkv, dh, chunk),
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
