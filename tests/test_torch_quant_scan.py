"""K1's wgmma scan over int8 and int4 docs and K4's wgmma kernel, on the CPU.

The kernels run only on a card (``tests/test_torch_kernel.py``). Here:

* ``ops/fused_topk.py::_plan`` sends int8 and int4 docs (per-doc and
  per-group scales) to the scan at the serving shapes and up to k = 64,
  lists past 64 to the scan's deep fold at every width (it beat the scan
  and the deep launch at every width read), and keeps the first design for
  f32 and for int4 rows that are not a whole number of 16 bytes;
* the converters' bit arithmetic (``csrc/codes.cuh``), emulated in plain
  torch integer and float operations over every int8 code and every
  nibble, gives the codes of a plain cast and of ``unpack_int4``, and the
  per-group dequant rounds as the plain version's;
* ``ops/grouped_topk.py::_plan``, K4's launch plan, as a pure function.
"""

import numpy as np
import pytest
import torch

from ragroute_tpu_torch.ops import fused_topk as ft
from ragroute_tpu_torch.ops import grouped_topk as gt
from ragroute_tpu_torch.ops.topk import unpack_int4

SMS = 132       # an H100 SXM
F32, BF16, I8, I4, I4G = 0, 1, 2, 3, 4


# ---- K1's plan -----------------------------------------------------------------

@pytest.mark.parametrize("doc_type", [I8, I4, I4G])
@pytest.mark.parametrize("bsz,n", [(8, 734_003), (512, 734_003),
                                   (2048, 734_003), (512, 346_112),
                                   (512, 104_857)])
def test_plan_sends_int8_and_int4_to_the_scan_at_the_serving_shapes(
        doc_type, bsz, n):
    plan = ft._plan(bsz, n, 768, 32, doc_type, SMS)
    assert plan.kernel == "wgmma" and plan.tile_d == ft.W_TILE_D
    assert plan == ft._plan(bsz, n, 768, 32, BF16, SMS)   # the same splits


@pytest.mark.parametrize("doc_type", [I8, I4, I4G])
@pytest.mark.parametrize("k", [1, 10, 32, 64, 65, 128, 160])
def test_plan_keeps_the_scan_at_the_serving_width(doc_type, k):
    """At d = 768 lists up to 64 take the scan and deeper ones its deep
    fold, for every type, past 160 too."""
    scan = k <= ft.SHALLOW_K
    assert ft._plan(512, 734_003, 768, k, doc_type,
                    SMS).kernel == ("wgmma" if scan else "fold")
    assert ft._plan(512, 734_003, 768, k + 161, doc_type,
                    SMS).kernel == "fold"


@pytest.mark.parametrize("doc_type", [I8, I4, I4G])
def test_plan_uses_the_measured_deep_thresholds(doc_type):
    """The measured crossover left no width threshold: lists past 64 take
    the deep fold at every width (hostrefine's 128-wide coarse slab at k' =
    128 and 256 among them); up to 64 the scan keeps them; the deep launch
    only past the fold's depth."""
    for d in (128, 256, 512, 768):
        assert ft._plan(512, 2_936_320, d, 128, doc_type, SMS).kernel == "fold"
        assert ft._plan(512, 2_936_320, d, 256, doc_type, SMS).kernel == "fold"
        assert ft._plan(512, 2_936_320, d, 64, doc_type, SMS).kernel == "wgmma"
    assert ft._plan(512, 2_936_320, 128, 1100, doc_type, SMS).kernel == "deep"


@pytest.mark.parametrize("doc_type,d,want", [
    # f32 docs stay off the tensor cores: the f32 scan at k <= 64
    (F32, 768, "f32"), (F32, 128, "f32"),
    (I4, 80, "shallow"), (I4G, 80, "shallow"), (I4, 48, "shallow"),
    (I4, 96, "wgmma"), (I4G, 64, "wgmma"),      # rows of 48 and 32 bytes
    (I8, 80, "wgmma"), (I8, 16, "wgmma"),
])
def test_int4_plan_keeps_the_first_kernel_where_the_tma_tiles_do_not_fit(
        doc_type, d, want):
    assert ft._plan(512, 20_000, d, 32, doc_type, SMS).kernel == want
    assert ft.scan_takes(d, doc_type) == (want == "wgmma")
    if want != "wgmma":
        with pytest.raises(ValueError, match="does not take"):
            ft._plan(512, 20_000, d, 32, doc_type, SMS, "wgmma")


# ---- the converters' bit arithmetic (csrc/codes.cuh), emulated -------------------

def _bits_bf16(bits16: torch.Tensor) -> torch.Tensor:
    """bf16 values from their 16-bit patterns (int32 holding 0..65535)."""
    return bits16.to(torch.int32).to(torch.int16).view(torch.bfloat16)


def _byte_perm_0x7650(word: torch.Tensor, sel: int) -> torch.Tensor:
    """``__byte_perm(word, 0x4B000000, 0x7650 + sel)``: byte ``sel`` of the
    word in byte 0, zeros in bytes 1 and 2, 0x4B in byte 3."""
    return ((word >> (8 * sel)) & 0xFF) | 0x4B000000


def _emulate_int8x4(codes: torch.Tensor) -> torch.Tensor:
    """``codes::int8x4_bf16`` over words of four codes: xor 0x80 in every
    byte, each byte under the f32 exponent of 2^23, minus 2^23 + 128,
    rounded to bf16 (exact)."""
    b = codes.to(torch.int64).reshape(-1, 4) & 0xFF
    word = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    u = word ^ 0x80808080
    out = []
    for sel in range(4):
        f = _byte_perm_0x7650(u, sel).to(torch.int32).view(torch.float32)
        out.append((f - 8388736.0).to(torch.bfloat16))
    return torch.stack(out, dim=1).reshape(-1)


def _emulate_nibbles(packed: torch.Tensor, high: bool) -> torch.Tensor:
    """``codes::nibbles4_bf16`` over words of four packed bytes: bytes 0, 1
    (and 2, 3) to bits 0-7 and 16-23 (``__byte_perm(w, 0, 0x4140)``), >> 4
    for the high nibbles, then ``nibbles_bf16x2``: (t ^ 0x00080008) &
    0x000F000F | 0x43004300, each half a bf16, minus 136 in bf16."""
    b = packed.to(torch.int64).reshape(-1, 4) & 0xFF
    out = []
    for lo, hi in ((0, 1), (2, 3)):
        t = b[:, lo] | (b[:, hi] << 16)
        if high:
            t = t >> 4
        v = ((t ^ 0x00080008) & 0x000F000F) | 0x43004300
        for half in (v & 0xFFFF, v >> 16):
            out.append(_bits_bf16(half) - torch.tensor(136.0,
                                                       dtype=torch.bfloat16))
    return torch.stack(out, dim=1).reshape(-1)


def _round_bf16_rne(x: torch.Tensor) -> torch.Tensor:
    """f32 to bf16, round to nearest even, by the bits (``mul.bf16x2`` of an
    exact product)."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    return _bits_bf16(bits & 0xFFFF)


def test_int8_converter_gives_every_code_exactly():
    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    got = _emulate_int8x4(codes)
    want = codes.to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got.to(torch.int32), codes.to(torch.int32))


def test_nibble_converter_equals_unpack_int4():
    """Every byte value, as four bytes a word: the low nibbles are dims j,
    the high nibbles dims j + D/2 of ``unpack_int4``."""
    packed = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    rows = packed.reshape(8, 32)                      # [N, D/2], D = 64
    plain = unpack_int4(rows).to(torch.float32)       # [N, D]
    low = _emulate_nibbles(rows.reshape(-1), high=False).reshape(8, 32)
    high = _emulate_nibbles(rows.reshape(-1), high=True).reshape(8, 32)
    assert torch.equal(low.to(torch.float32), plain[:, :32])
    assert torch.equal(high.to(torch.float32), plain[:, 32:])
    assert set(plain.unique().tolist()) == set(range(-8, 8))


def test_per_group_dequant_rounds_as_the_plain_version():
    """kI4G: each code times its group's scale, both bf16, rounded once to
    bf16 (the converters' ``scale_bf16x2``), equals the plain version's
    ``docs.to(bf16) * scale.to(bf16)`` for every nibble and scales across
    many binades, some off the bf16 grid."""
    rng = np.random.default_rng(0)
    scales = np.concatenate([
        rng.uniform(0.005, 0.01, 500), 2.0 ** rng.integers(-12, 4, 100),
        rng.lognormal(0, 3, 400)]).astype(np.float32)
    n = scales.shape[0]
    packed = torch.from_numpy(rng.integers(-128, 128, (n, 8)).astype(np.int8))
    codes = unpack_int4(packed)                              # [n, 16]
    sc = torch.from_numpy(scales)
    plain = (codes.to(torch.bfloat16) * sc[:, None].to(torch.bfloat16))
    low = _emulate_nibbles(packed.reshape(-1), high=False).reshape(n, 8)
    high = _emulate_nibbles(packed.reshape(-1), high=True).reshape(n, 8)
    emu_codes = torch.cat([low, high], dim=1)
    assert torch.equal(emu_codes.to(torch.float32), codes.to(torch.float32))
    # the product of a 4-bit code and an 8-bit significand is exact in f32
    prod = emu_codes.to(torch.float32) * sc[:, None].to(torch.bfloat16).to(
        torch.float32)
    emu = _round_bf16_rne(prod.contiguous())
    assert torch.equal(emu.view(torch.int16), plain.view(torch.int16))
    # and the rounding matters here: the products are not all on the grid
    assert not torch.equal(prod, plain.to(torch.float32))


# ---- K4's plan -----------------------------------------------------------------

@pytest.mark.parametrize("r,s,kappa,want", [
    (128, 1584, 8, "wgmma"),      # the serving shape: 2 tiles, 4 ranks
    (128, 1584, 16, "wgmma"),     # a cap of 16: 8 ranks, kw 16
    (128, 1024, 8, "wgmma"),      # one tile, 8 ranks
    (128, 1024, 16, "shallow"),   # one tile, 16 ranks
    (128, 568, 9, "shallow"),     # 9 ranks
    (128, 2056, 12, "wgmma"),     # 3 tiles, 4 ranks, kw 12
    (128, 2056, 24, "shallow"),   # 3 tiles, 8 ranks: kw 24
    (128, 1096, 128, "shallow"),  # 64 ranks
    (32, 72, 160, "shallow"),
    (144, 1584, 8, "shallow"),    # deeper than the resident rows
    (128, 568, 256, "deep"),      # --refine-mult 8 under an open cap
    (128, 1096, 512, "deep"),
])
def test_pair_plan(r, s, kappa, want):
    _, _, ranks, kw = gt.tiling(s, kappa)
    assert gt._plan(r, ranks, kw) == want
    assert gt._plan(r, ranks, kw, want) == want


def test_pair_plan_names_a_launch_and_refuses_what_it_does_not_take():
    assert gt._plan(128, 4, 8, "shallow") == "shallow"
    assert gt._plan(128, 4, 8, "deep") == "deep"
    for r, ranks, kw, kernel in ((128, 9, 9, "wgmma"), (144, 4, 8, "wgmma"),
                                 (128, 6, 18, "wgmma"),
                                 (128, 161, 161, "shallow")):
        with pytest.raises(ValueError, match="does not take"):
            gt._plan(r, ranks, kw, kernel)
    assert (gt.W_MAX_RANKS, gt.W_MAX_KW, gt.W_MAX_DEPTH) == (8, 16, 128)
    assert gt.tiling(1584, 8) == (1024, 2, 4, 8)
