"""Kernel-against-plain checks for the decoder's kernels on the card.

Shared by the card-only tests (``tests/test_torch_int4_matmul.py``,
``tests/test_torch_decode_attention.py``) and ``chip_smoke.py llm``: both
run the wrappers on CUDA tensors, which launches ``csrc/int4_matmul.cu``
(K5) and ``csrc/decode_attention.cu`` (K6), and hold each against its plain
version on the same device and operands.

int4 matmul (:func:`int4_matmul` against :func:`int4_matmul_reference`):

* :func:`int4_exact_cases`: small integer activations (bf16 and f32), random
  nibbles and power-of-two scales, so every product and sum is exact in any
  order: outputs equal. The DEMO_CFG shapes (OUT = 260 and 64, off the
  16-byte grid), groups that are not a multiple of 16 (24, 12, 6), M from 1
  to 100 (one and several M tiles) and a contraction long enough to be split;
  then :func:`int4_decode_exact_cases` (the decode kernel at M = 1, 16, 40
  and 63, splits summed in the launch) and
  :func:`int4_prefill_exact_cases`, on the prefill kernel's side of
  ``M_SWITCH``.
* :func:`int4_path_cases`: Qwen3-8B's projections at decode (B = 16) and its
  gate and down at prefill (M = 16 * 512), Qwen3-0.6B's tied head; held
  within ``1e-4 * max|y|`` at bf16 activations.

decode attention (:func:`decode_attention` against
:func:`decode_attention_reference`): :func:`attn_small_cases` (f32 within
1e-5: f32 and int8 caches, MHA and GQA, a row with one valid key, a row with
none, every layer) and :func:`attn_path_cases` (the Qwen3-8B decode shape and
the JAX package's measured shape, bf16 and int8 caches, ragged masks).

:func:`k5_bound` and :func:`k6_bound` give the least time an H100 SXM could
take for a call (``kernel_checks``' data-sheet peaks); :func:`device_ms` a
call's kernel time from the profiler, without the wrapper's host work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import torch

from ragroute_tpu_torch.llm.shapes import QWEN3_06B, QWEN3_8B
from ragroute_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from ragroute_tpu_torch.ops.int4_matmul import _launch as _int4_launch
from ragroute_tpu_torch.ops.int4_matmul import (M_SWITCH, int4_matmul,
                                                int4_matmul_reference)
from ragroute_tpu_torch.ops.kernel_checks import PEAK_FLOPS, _bound

Tensor = torch.Tensor


# ---- K5: int4 matmul ---------------------------------------------------------

@dataclasses.dataclass
class MatCase:
    name: str
    x: Tensor
    w: Tensor          # packed int8 [IN/2, OUT]
    scale: Tensor      # f32 [IN/group, OUT]
    group: int


def _rand_case(name, device, m, in_dim, out, group, dtype, gen, exact):
    half = in_dim // 2
    w = torch.randint(-128, 128, (half, out), generator=gen, device=device,
                      dtype=torch.int16).to(torch.int8)
    if exact:
        x = torch.randint(-2, 3, (m, in_dim), generator=gen, device=device)
        scale = 2.0 ** torch.randint(-2, 2, (in_dim // group, out),
                                     generator=gen, device=device)
    else:
        x = torch.randn((m, in_dim), generator=gen, device=device)
        scale = torch.rand((in_dim // group, out), generator=gen,
                           device=device) * 0.02 + 1e-3
    return MatCase(name, x.to(dtype), w, scale.to(torch.float32), group)


def int4_exact_cases(device, seed: int = 0) -> Iterator[MatCase]:
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = [  # (M, IN, OUT, group)
        (4, 128, 260, 64),      # DEMO_CFG tied head (OUT off the 16 grid)
        (4, 128, 128, 64), (4, 128, 64, 64), (4, 256, 128, 128),
        (1, 48, 40, 24), (3, 48, 40, 12), (16, 48, 96, 6),
        (17, 256, 300, 64),     # one 64-row M tile, 17 rows used
        (100, 512, 256, 128),   # several 64-row M tiles
        (16, 8192, 128, 128),   # split contraction
        (5, 4096, 1024, 128),
    ]
    for m, i, o, g in shapes:
        for dt in (torch.bfloat16, torch.float32):
            yield _rand_case(f"M{m}-{i}x{o}-g{g}-{str(dt)[6:]}", device, m, i,
                             o, g, dt, gen, exact=True)
    yield from int4_decode_exact_cases(device, seed + 2)
    yield from int4_prefill_exact_cases(device, seed + 1)


def int4_decode_exact_cases(device, seed: int = 2) -> Iterator[MatCase]:
    """Exact cases of the decode kernel, bf16 activations below
    ``M_SWITCH``: M of one token tile of 8, 16, 32 and 64 (1, 16, 40, 63),
    each over a contraction cut into 16 splits (wk/wv's plan) and over
    OUT off the 128-column block (208) with groups of one and of two 64-row
    stages; then M = ``M_SWITCH``, where the prefill kernel takes over."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in (1, 16, 40, 63, M_SWITCH):
        for i, o, g in ((4096, 1024, 128), (512, 208, 64), (1024, 208, 128)):
            yield _rand_case(f"decode-M{m}-{i}x{o}-g{g}-bfloat16", device, m,
                             i, o, g, torch.bfloat16, gen, exact=True)


def int4_prefill_exact_cases(device, seed: int = 1) -> Iterator[MatCase]:
    """Exact cases of the prefill (wgmma) kernel, bf16 activations from
    ``M_SWITCH`` rows: M at the switch and 37 past it (a ragged last token
    block), OUT off the 128-column block (208), groups of one 64-row stage,
    of two and of four (a group over several stages)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for m, i, o, g in ((M_SWITCH, 256, 128, 64),
                       (M_SWITCH + 37, 512, 208, 128),
                       (M_SWITCH + 37, 1024, 256, 256),
                       (2 * M_SWITCH + 5, 2048, 384, 128)):
        yield _rand_case(f"prefill-M{m}-{i}x{o}-g{g}-bfloat16", device, m, i,
                         o, g, torch.bfloat16, gen, exact=True)


def int4_path_cases(device, seed: int = 1) -> List[MatCase]:
    """Qwen3-8B at decode (B = 16) for each distinct (IN, OUT) of a layer
    and the untied head, gate and down at prefill (16 x 512 rows), and the
    tied Qwen3-0.6B head at B = 16; bf16 activations, group 128."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, kv = QWEN3_8B.hidden_size, QWEN3_8B.kv_dim
    ff, v = QWEN3_8B.intermediate_size, QWEN3_8B.vocab_size
    out = []
    for label, m, i, o in (("qwen3-8b decode wq/wo", 16, d, d),
                           ("qwen3-8b decode wk/wv", 16, d, kv),
                           ("qwen3-8b decode gate/up", 16, d, ff),
                           ("qwen3-8b decode down", 16, ff, d),
                           ("qwen3-8b decode head", 16, d, v),
                           ("qwen3-8b prefill gate", 16 * 512, d, ff),
                           ("qwen3-8b prefill down", 16 * 512, ff, d),
                           ("qwen3-0.6b tied head", 16,
                            QWEN3_06B.hidden_size, QWEN3_06B.vocab_size)):
        out.append(_rand_case(label, device, m, i, o, 128, torch.bfloat16,
                              gen, exact=False))
    return out


def run_int4(case: MatCase, kernel: Optional[str] = None) -> Tensor:
    """The wrapper on CUDA tensors; ``kernel`` (``"wgmma"`` or ``"mma"``)
    names the kernel in place of the wrapper's plan, to time the two
    against each other at one shape."""
    if kernel is None:
        return int4_matmul(case.x, case.w, case.scale, group=case.group)
    return _int4_launch(case.x, case.w, case.scale, case.group, kernel)


def run_int4_plain(case: MatCase) -> Tensor:
    return int4_matmul_reference(case.x, case.w, case.scale,
                                 group=case.group)


def dequant_matmul_note(case: MatCase) -> Tensor:
    """For a note beside the kernel's time: dequantize to bf16, then one
    ``torch.matmul`` (no single PyTorch call computes this function)."""
    from ragroute_tpu_torch.ops.int4_matmul import dequant_int4

    w = dequant_int4(case.w, case.scale, case.group).to(torch.bfloat16)
    return torch.matmul(case.x.to(torch.bfloat16), w)


def k5_bound(case: MatCase) -> Dict[str, float]:
    """Activations, packed bytes and scales read once, the f32 output
    written once, against ``2 * M * IN * OUT`` operations at the bf16
    peak (the codes are multiplied as bf16)."""
    m, in_dim = case.x.shape
    out = case.w.shape[1]
    nbytes = (case.x.numel() * case.x.element_size() + case.w.numel()
              + case.scale.numel() * 4 + m * out * 4)
    return _bound(nbytes, 2.0 * m * in_dim * out,
                  PEAK_FLOPS[torch.bfloat16])


# ---- K6: decode attention ---------------------------------------------------

@dataclasses.dataclass
class AttnCase:
    name: str
    q: Tensor          # [B, H, Dh] f32
    k: Tensor          # [L, B, S, Hkv, Dh]
    v: Tensor
    ok: Tensor         # [B, S] bool
    li: int
    ks: Optional[Tensor] = None   # [L, B, S, Hkv] f32
    vs: Optional[Tensor] = None

    @property
    def hkv(self) -> int:
        return self.k.shape[3]

    @property
    def dh(self) -> int:
        return self.k.shape[4]

    def planes(self):
        """The folded ``[L, B, S, Hkv*Dh]`` views (no copy)."""
        return (self.k.reshape(*self.k.shape[:3], -1),
                self.v.reshape(*self.v.shape[:3], -1))


def _ragged_ok(b, s, gen, device, *, single_row=None, empty_row=None):
    start = torch.randint(0, s // 2, (b,), generator=gen, device=device)
    length = torch.randint(1, s // 2, (b,), generator=gen, device=device)
    iota = torch.arange(s, device=device)
    ok = (iota[None] >= start[:, None]) & (iota[None] < start[:, None]
                                            + length[:, None])
    if single_row is not None:
        ok[single_row] = False
        ok[single_row, s // 3] = True
    if empty_row is not None:
        ok[empty_row] = False
    return ok


def attn_case(name, device, *, b, s, h, hkv, dh, layers, li, kv, gen,
              single_row=None, empty_row=None) -> AttnCase:
    """Random queries and cache; ``kv`` is the cache dtype or ``"int8"``
    (codes and scales from ``quant_kv``, as the engines write them)."""
    from ragroute_tpu_torch.llm.model import quant_kv

    q = torch.randn((b, h, dh), generator=gen, device=device)
    shape = (layers, b, s, hkv, dh)
    k = torch.randn(shape, generator=gen, device=device)
    v = torch.randn(shape, generator=gen, device=device)
    ok = _ragged_ok(b, s, gen, device, single_row=single_row,
                    empty_row=empty_row)
    if kv == "int8":
        (k, ks), (v, vs) = quant_kv(k), quant_kv(v)
        return AttnCase(name, q, k, v, ok, li, ks, vs)
    return AttnCase(name, q, k.to(kv), v.to(kv), ok, li)


def attn_small_cases(device, seed: int = 0) -> Iterator[AttnCase]:
    gen = torch.Generator(device=device).manual_seed(seed)
    for kv in (torch.float32, "int8"):
        for h, hkv in ((4, 2), (4, 4), (16, 8), (32, 8)):
            for li in (0, 2):
                yield attn_case(f"{kv}-H{h}-Hkv{hkv}-li{li}", device, b=3,
                                s=200, h=h, hkv=hkv, dh=128, layers=3, li=li,
                                kv=kv, gen=gen, single_row=1, empty_row=2)
    yield attn_case("demo-shape-f32", device, b=4, s=96, h=8, hkv=4, dh=16,
                    layers=2, li=1, kv=torch.float32, gen=gen, single_row=0)
    yield attn_case("bf16-dh64", device, b=2, s=33, h=6, hkv=2, dh=64,
                    layers=1, li=0, kv=torch.bfloat16, gen=gen)
    # shorter than a tile and off its grid; G = 1 and 8; Dh = 64 and 256
    for name, s, h, hkv, dh, kv in (
            ("f32-S5-G8-dh64", 5, 8, 1, 64, torch.float32),
            ("bf16-S45-G1-dh256", 45, 4, 4, 256, torch.bfloat16),
            ("int8-S77-G8-dh256", 77, 16, 2, 256, "int8"),
            ("int8-S100-G1-dh64", 100, 4, 4, 64, "int8"),
            # rows that are not whole 16-byte chunks (plain loads)
            ("int8-S70-G2-dh24", 70, 4, 2, 24, "int8"),
            ("bf16-S40-G4-dh20", 40, 8, 2, 20, torch.bfloat16),
            # many splits of one (row, head), merged
            ("bf16-S3000-G4-dh128", 3000, 8, 2, 128, torch.bfloat16)):
        yield attn_case(name, device, b=3, s=s, h=h, hkv=hkv, dh=dh,
                        layers=2, li=1, kv=kv, gen=gen, single_row=1,
                        empty_row=2)


def attn_path_cases(device, seed: int = 2) -> Iterator[AttnCase]:
    """Qwen3-8B decode (B = 16, S = 2,080, H = 32, Hkv = 8, Dh = 128, 36
    layers) with a bf16 cache and with an int8 cache, ragged masks; then
    the JAX package's measured shape (B = 32, S = 640, H = 16, Hkv = 8, Dh
    = 128, int8, 28 layers). Each case is made on demand (the planes take
    GBs)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    big, small = QWEN3_8B, QWEN3_06B
    for kv in (torch.bfloat16, "int8"):
        yield attn_case(f"qwen3-8b B=16 S=2080 {kv}", device, b=16, s=2080,
                        h=big.num_heads, hkv=big.num_kv_heads,
                        dh=big.head_dim, layers=big.num_layers,
                        li=big.num_layers - 1, kv=kv, gen=gen)
    yield attn_case("measured shape B=32 S=640 H=16 int8", device, b=32,
                    s=640, h=small.num_heads, hkv=small.num_kv_heads,
                    dh=small.head_dim, layers=small.num_layers, li=13,
                    kv="int8", gen=gen)


def run_attn(case: AttnCase) -> Tensor:
    k, v = case.planes()
    return decode_attention(case.q, k, v, case.ok, li=case.li,
                            num_kv_heads=case.hkv, head_dim=case.dh,
                            k_scale=case.ks, v_scale=case.vs)


def run_attn_plain(case: AttnCase) -> Tensor:
    k, v = case.planes()
    return decode_attention_reference(case.q, k, v, case.ok, li=case.li,
                                      num_kv_heads=case.hkv, head_dim=case.dh,
                                      k_scale=case.ks, v_scale=case.vs)


def run_attend(case: AttnCase) -> Tensor:
    """The engines' einsum path (``llm.model._attend``) on the same layer,
    as a decode step calls it."""
    from ragroute_tpu_torch.llm.model import DecoderConfig, _attend

    b, h, dh = case.q.shape
    cfg = DecoderConfig(vocab_size=1, hidden_size=h * dh, num_layers=1,
                        num_heads=h, num_kv_heads=case.hkv, head_dim=dh,
                        intermediate_size=1)
    kmask = case.ok[:, None, :]
    out = _attend(case.q[:, None], case.k[case.li], case.v[case.li], kmask,
                  cfg, k_scale=None if case.ks is None else case.ks[case.li],
                  v_scale=None if case.vs is None else case.vs[case.li])
    return out.reshape(b, h, dh)


def sdpa_note(case: AttnCase) -> Tensor:
    """``scaled_dot_product_attention`` with GQA over the float cache's
    layer (the library time for a float cache; no int8 scales)."""
    b, h, dh = case.q.shape
    k = case.k[case.li].transpose(1, 2)          # [B, Hkv, S, Dh]
    v = case.v[case.li].transpose(1, 2)
    return torch.nn.functional.scaled_dot_product_attention(
        case.q[:, :, None].to(k.dtype), k, v,
        attn_mask=case.ok[:, None, None, :], enable_gqa=True)


def k6_bound(case: AttnCase) -> Dict[str, float]:
    """Layer ``li``'s K and V (and scales) of the batch read once, the
    queries and mask read and the f32 context written once, against ``4 *
    B * H * S * Dh`` operations (f32, outside the tensor cores)."""
    b, h, dh = case.q.shape
    s = case.k.shape[2]
    plane = case.k[case.li].numel() * case.k.element_size()
    nbytes = (2 * plane + b * h * dh * 8 + b * s
              + (0 if case.ks is None else 2 * case.ks[case.li].numel() * 4))
    return _bound(nbytes, 4.0 * b * h * s * dh, PEAK_FLOPS[torch.float32])


def device_ms(fn, wrapper, *, warmup: int = 3, reps: int = 20) -> float:
    """Device time of one call of ``fn`` in ms: the CUDA kernels a
    ``torch.profiler`` window over ``reps`` calls records, summed, over
    ``reps``; the wrapper's host work between launches is left out (at
    decode shapes it is longer than the kernel). ``wrapper``'s launch
    count must rise by ``reps``: the window saw the kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    before = wrapper.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    if wrapper.launches - before != reps:
        raise AssertionError("the profiled calls did not launch the kernel")
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / reps


def attn_close(got: Tensor, want: Tensor, tol: float = 1e-5) -> Dict:
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    return {"max_abs_err": err, "tol": tol * scale, "ok": err <= tol * scale}


def matmul_close(got: Tensor, want: Tensor, rel: float = 1e-4) -> Dict:
    err = float((got - want).abs().max())
    tol = rel * float(want.abs().max())
    return {"max_abs_err": err, "tol": tol, "ok": err <= tol}

