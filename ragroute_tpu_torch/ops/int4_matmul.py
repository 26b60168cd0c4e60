"""int4 weight-only matmul for the decoder (the K5 kernel).

PyTorch/CUDA counterpart of ``ragroute_tpu/ops/int4_matmul.py``. Layout, as
there: a ``[IN, OUT]`` matrix of int4 codes packs to int8 ``[IN/2, OUT]``,
byte row ``i`` holding code row ``i`` in its low nibble and row ``i + IN/2``
in its high nibble; scales are f32 ``[IN/group, OUT]``, one per group of
``group`` code rows and output column, the low half's groups first.

:func:`int4_matmul` is the wrapper: on a CUDA tensor it launches
``csrc/int4_matmul.cu`` or raises. :func:`_plan`, a pure function of the
shape, picks the kernel: from :data:`M_SWITCH` rows of bf16 activations
(prefill), the wgmma kernel fed by a TMA ring; below it (decode), the
decode kernel, also wgmma from a TMA ring, with its contraction split where
the column blocks leave SMs idle and the splits summed in the same launch
(one launch a call; a persistent workspace a device and stream); f32
activations, ragged OUT and groups off the 64-row grid take the first
kernel (``mma.sync`` for bf16, FMA for f32; every packed byte read from
device memory once, split contractions summed by a second launch). On a
CPU tensor it runs :func:`int4_matmul_reference`, the plain version, which
computes each group's partial product in f32, multiplies it by the group's
scale and adds it to the running f32 sum, as the TPU kernel does.

:func:`pack_int4_rows`, :func:`quantize_int4` and :func:`dequant_int4` are
this package's copies of the JAX package's host functions, written on
tensors so that quantization runs on the card; their codes and scales are
bit-equal to the numpy originals'.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor

TK = 64                  # csrc/int4_matmul.cu: packed rows a tile
BN = 128                 # output columns a block
BLOCKS_PER_SM = 2        # split target at small M: blocks in flight an SM
# rows of bf16 activations from which the wgmma kernel (128 tokens x 128
# columns a block, groups of whole 64-row stages) takes a call: measured at
# the Qwen3-8B gate/up shape by ``measure.py --kernels`` (PERF.md;
# device ms, first kernel against wgmma: M = 16 0.042 / 0.060, M = 64
# 0.134 / 0.058, M = 8,192 11.26 / 2.76)
M_SWITCH = 64
WG_TK = 64               # int4_mm_wgmma_kernel: packed rows a stage
# the decode kernel (int4_mm_decode_kernel): output columns a block, and the
# blocks an SM holds at once, by tokens (two up to 16 rows, where the
# accumulators leave room for a second block's registers)
DEC_BN = 128
DEC_BLOCKS_PER_SM = {16: 2, 64: 1}

def pack_int4_rows(codes: Tensor) -> Tensor:
    """Pack int4 codes ``[IN, OUT]`` (values in [-8, 7]) to int8 ``[IN/2,
    OUT]``: row ``i`` in the low nibble, row ``i + IN/2`` in the high
    nibble. IN must be even."""
    n = codes.shape[0]
    assert n % 2 == 0, "pack_int4_rows needs an even row count"
    c = codes.to(torch.int8)
    lo = c[: n // 2] & 0x0F
    hi = (c[n // 2:] & 0x0F) << 4
    return lo | hi


def quantize_int4(w: Tensor, group: int = 128) -> Tuple[Tensor, Tensor]:
    """Group-wise symmetric int4 quantization of ``[IN, OUT]``.

    Returns ``(packed int8 [IN/2, OUT], scales f32 [IN/group, OUT])`` on
    ``w``'s device, the scale rows ordered as :func:`int4_matmul` reads
    them. ``group`` must divide IN/2."""
    wf = w.to(torch.float32).contiguous()
    in_dim, out = wf.shape
    assert in_dim % 2 == 0 and (in_dim // 2) % group == 0, (in_dim, group)
    g = in_dim // group
    wg = wf.reshape(g, group, out)
    amax = wg.abs().amax(dim=1).clamp_min(1e-12)          # [g, out]
    scale = amax / 7.0
    codes = torch.clamp(torch.round(wg / scale[:, None]), -7, 7)
    return (pack_int4_rows(codes.reshape(in_dim, out)).contiguous(),
            scale.contiguous())


def unpack_int4_rows(packed: Tensor) -> Tensor:
    """Codes ``[IN, OUT]`` (int8, sign-extended nibbles) of packed bytes."""
    p = packed.to(torch.int8)
    return torch.cat([((p & 0x0F) ^ 8) - 8, p >> 4], dim=0)


def dequant_int4(packed: Tensor, scales: Tensor, group: int) -> Tensor:
    """Reference dequantization (tests / non-kernel paths): f32 ``[IN, OUT]``."""
    codes = unpack_int4_rows(packed).to(torch.float32)
    g = codes.shape[0] // group
    return (codes.reshape(g, group, -1) * scales[:, None]).reshape(codes.shape)


def int4_matmul_reference(x: Tensor, w_packed: Tensor, scales: Tensor, *,
                          group: int) -> Tensor:
    """Plain version: ``y[M, OUT] f32``; group by group, the f32 product of
    the activations with the group's codes, times the group's scale, added
    to the running f32 sum, in the kernels' order (for each group of the
    low half, its own sum and then that of the matching high-half group)."""
    _check(x, w_packed, scales, group)
    half = w_packed.shape[0]
    codes = unpack_int4_rows(w_packed).to(torch.float32)
    xf = x.to(torch.float32)
    y = torch.zeros((x.shape[0], w_packed.shape[1]), dtype=torch.float32,
                    device=x.device)
    n_half = half // group
    for g in range(n_half):
        for gg in (g, n_half + g):
            rows = slice(gg * group, (gg + 1) * group)
            y = y + (xf[:, rows] @ codes[rows]) * scales[gg]
    return y


def _check(x: Tensor, w_packed: Tensor, scales: Tensor, group: int) -> None:
    m, in_dim = x.shape
    half, out = w_packed.shape
    if half * 2 != in_dim:
        raise ValueError(f"int4_matmul: x [{m}, {in_dim}] against packed "
                         f"[{half}, {out}] (IN/2 rows expected)")
    if group < 1 or half % group:
        raise ValueError(f"int4_matmul: group {group} does not divide "
                         f"IN/2 = {half}")
    if tuple(scales.shape) != (in_dim // group, out):
        raise ValueError(f"int4_matmul: scales {tuple(scales.shape)}, "
                         f"expected ({in_dim // group}, {out})")


def _lib():
    from ragroute_tpu_torch.ops import _build

    lib, _ = _build.load("int4_matmul")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.int4_matmul_launch.argtypes = [vp] * 5 + [ci] * 8 + [vp]
        lib.int4_matmul_launch.restype = ci
        lib.int4_matmul_wgmma_launch.argtypes = [vp] * 4 + [ci] * 4 + [vp]
        lib.int4_matmul_wgmma_launch.restype = ci
        lib.int4_matmul_decode_launch.argtypes = [vp] * 6 + [ci] * 6 + [vp]
        lib.int4_matmul_decode_launch.restype = ci
        lib._argtypes_set = True
    return lib


class Plan(NamedTuple):
    """How one call runs: ``kernel`` is ``"wgmma"`` (prefill), ``"decode"``
    or ``"mma"`` (the first kernel), with ``splits`` of ``rows_per_split``
    packed rows (1 and all of them for the wgmma kernel)."""
    kernel: str
    splits: int
    rows_per_split: int


@functools.lru_cache(maxsize=None)
def _plan(m: int, half: int, out: int, group: int, bf16: bool,
          aligned: bool, sms: int, kernel: Optional[str] = None) -> Plan:
    """The launch for ``x [m, 2 half]`` against packed ``[half, out]`` with
    scale groups of ``group`` code rows on a card of ``sms`` SMs; a pure
    function of these (``aligned``: x, the packed bytes and the scales
    start on 16 bytes). ``kernel`` names one to plan for instead of
    choosing (the measurements time the kernels against each other at one
    shape). Where the TMA tiles fit the operands (bf16 activations, OUT a
    multiple of 16, groups of whole 64-row stages), the wgmma kernel takes
    :data:`M_SWITCH` rows and more and the decode kernel fewer; otherwise
    the first kernel. The decode kernel and the first kernel cut the
    contraction when their column blocks alone leave SMs idle, at whole
    groups (where a group spans whole tiles), so that each group's partial
    sum meets its scale once. Cached: a decode step asks for the same few
    shapes hundreds of times."""
    fits = bf16 and aligned and out % 16 == 0 and group % WG_TK == 0
    if kernel is None:
        kernel = ("mma" if not fits else
                  "wgmma" if m >= M_SWITCH else "decode")
    if kernel in ("wgmma", "decode") and not fits:
        raise ValueError(f"int4_matmul: the {kernel} kernel does not take "
                         f"x [{m}, {2 * half}] (bf16 {bf16}, aligned "
                         f"{aligned}) @ [{half}, {out}] group {group}")
    if kernel == "wgmma":
        return Plan("wgmma", 1, half)
    if kernel == "decode":
        if m >= M_SWITCH:
            raise ValueError(f"int4_matmul: the decode kernel takes fewer "
                             f"than {M_SWITCH} rows, not {m}")
        # splits of whole groups for about one and a half waves of the SMs'
        # block slots beside the column blocks, rounded down to a power of
        # two (the readings of ``measure.py --kernels``' K5 split sweep,
        # PERF.md: Qwen3-8B q/o 8, k/v 16, gate/up 4, down 8, the head 1)
        slots = sms * DEC_BLOCKS_PER_SM[16 if m <= 16 else 64]
        groups = half // group
        want = max(1, 3 * slots // (2 * -(-out // DEC_BN)))
        want = min(groups, 1 << (want.bit_length() - 1))
        per = -(-groups // want)
        return Plan("decode", -(-groups // per), per * group)
    bm = 16 if m <= 16 else 64
    blocks = -(-out // BN) * -(-m // bm)
    tiles = -(-half // TK)
    want = max(1, min(tiles, math.ceil(BLOCKS_PER_SM * sms / blocks)))
    per = -(-tiles // want)
    unit = group // TK if group % TK == 0 else 1
    per = -(-per // unit) * unit
    return Plan("mma", -(-tiles // per), per * TK)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's SM count (asked once: a decode step launches the kernel
    hundreds of times)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(x: Tensor, w_packed: Tensor, scales: Tensor, group: int,
            kernel: Optional[str] = None) -> Tensor:
    m, in_dim = x.shape
    half, out = w_packed.shape
    dev = w_packed.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int4_matmul: x dtype {x.dtype} (bf16 or f32)")
    if w_packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("int4_matmul: packed weights must be int8 and "
                        "scales float32")
    for name, t in (("x", x), ("scales", scales)):
        if t.device != dev:
            raise ValueError(f"int4_matmul: {name} on {t.device}, weights "
                             f"on {dev}")
    x = x.contiguous()
    if not (w_packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("int4_matmul: weights and scales must be contiguous")
    out_t = torch.empty((m, out), dtype=torch.float32, device=dev)
    if m == 0:
        return out_t
    bf16 = x.dtype == torch.bfloat16
    aligned = (x.data_ptr() % 16 == 0 and w_packed.data_ptr() % 16 == 0
               and scales.data_ptr() % 16 == 0)
    plan = _plan(m, half, out, group, bf16, aligned, _sm_count(dev), kernel)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.kernel == "wgmma":
        err = _lib().int4_matmul_wgmma_launch(
            x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            out_t.data_ptr(), m, in_dim, out, group, stream)
    elif plan.kernel == "decode":
        ws, counters = (None, None)
        if plan.splits > 1:
            ws, counters = _decode_workspace(dev, stream,
                                             plan.splits * m * out,
                                             -(-out // DEC_BN))
        err = _lib().int4_matmul_decode_launch(
            x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            out_t.data_ptr(), None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), m, in_dim,
            out, group, plan.splits, plan.rows_per_split, stream)
    else:
        ws = (torch.empty((plan.splits, m, out), dtype=torch.float32,
                          device=dev) if plan.splits > 1 else None)
        vec = (out % 16 == 0 and half % (8 if bf16 else 4) == 0 and aligned)
        err = _lib().int4_matmul_launch(
            x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            out_t.data_ptr(), None if ws is None else ws.data_ptr(), m,
            in_dim, out, group, plan.splits, plan.rows_per_split, int(bf16),
            int(vec), stream)
    if err != 0:
        raise RuntimeError(f"int4_matmul {plan.kernel} launch failed for x "
                           f"[{m}, {in_dim}] {x.dtype} @ packed [{half}, "
                           f"{out}] group {group}: CUDA error {err}")
    int4_matmul.launches += 1
    return out_t


# the decode kernel's split partials and column-block counters, kept a
# (device, stream): the launches of one stream run in order, so one
# workspace serves them all; the kernel leaves its counters at zero
_DECODE_WS: dict = {}


def _decode_workspace(dev: torch.device, stream: int, floats: int,
                      counters: int) -> Tuple[Tensor, Tensor]:
    key = (dev.index, stream)
    ws, cnt = _DECODE_WS.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(counters, dtype=torch.int32, device=dev)
    _DECODE_WS[key] = (ws, cnt)
    return ws, cnt


def int4_matmul(x: Tensor, w_packed: Tensor, scales: Tensor, *,
                group: int) -> Tensor:
    """``y[M, OUT] f32 = x[M, IN] @ dequant(w_packed)``.

    Args as the JAX package's ``int4_matmul``: ``x`` ``[M, IN]`` activations
    (bf16 or f32); ``w_packed`` int8 ``[IN/2, OUT]``; ``scales`` f32
    ``[IN // group, OUT]``; ``group`` divides IN/2. A CUDA tensor runs the
    kernel (a shape or type it does not take raises, naming it); a CPU
    tensor runs :func:`int4_matmul_reference`."""
    _check(x, w_packed, scales, group)
    if w_packed.is_cuda:
        return _launch(x, w_packed, scales, group)
    return int4_matmul_reference(x, w_packed, scales, group=group)


int4_matmul.launches = 0   # kernel launches since the count was last reset
