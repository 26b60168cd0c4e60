"""The launch plans of the wgmma kernels, as pure functions, on the CPU.

K5 (``ops/int4_matmul.py::_plan``) sends bf16 activations, with OUT on the
16-column grid, groups of whole 64-row stages and 16-byte aligned operands,
to the prefill kernel (``int4_mm_wgmma_kernel``) from ``M_SWITCH`` rows and
to the decode kernel (``int4_mm_decode_kernel``) below it, and every other
call to the first kernel. The decode kernel's splits (whole groups, summed
in the launch) cover every packed row once; a torch model of that sum
(each split's groups in order, then the splits in order) equals the plain
version on exact integer cases and stays within tolerance on random ones.
K1 (``ops/fused_topk.py::_plan``) sends bf16, int8 and int4 docs to the
wgmma scan up to k = 64 (the scan takes no deeper list, even when named)
and past it to its deep fold at every shard size; f32 docs to the f32 scan up to k = 64
from 65 query rows (smaller batches to the first design), to the first
design from k = 65 to 160 and to the deep launch past it; int4
rows off the 16-byte grid to the first design, or past k = 160 to the deep
launch. The wgmma launches' and the f32 scan's doc splits cover the shard
without an empty split and fill the card at B = 8 as at B = 512; the f32
scan's ring and lists fit an H100's shared memory at every depth it takes,
and its threads' 8 x 8 tiles cover the 128 x 128 gain tile once, each warp
owning 16 rows whole.
K3 (``ops/grouped_gains.py::_plan``) sends bf16, int8 and int4 slabs to
the wgmma kernel (f32 to the f32 kernel) with the deepest ring that fits,
or to the first design where not even two stages fit; a torch model of the
wgmma kernel's walk (persistent blocks over (pair block, pass) items, the
query rows' and slab's chunks, int4's two walks of the packed rows) equals
the plain version on exact integer cases. The kernels themselves run only
on a card (``tests/test_torch_kernel.py``).
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu_torch.ops import deep_topk
from ragroute_tpu_torch.ops import fused_topk as ft
from ragroute_tpu_torch.ops import grouped_gains as gg
from ragroute_tpu_torch.ops import int4_matmul as im
from ragroute_tpu_torch.ops.decoder_checks import matmul_close

SMS = 132       # an H100 SXM


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


# ---- K5 ----------------------------------------------------------------------

@pytest.mark.parametrize("m,want", [(im.M_SWITCH - 1, "decode"),
                                    (im.M_SWITCH, "wgmma"),
                                    (im.M_SWITCH + 37, "wgmma"),
                                    (8192, "wgmma"), (16, "decode"),
                                    (1, "decode")])
def test_int4_plan_switches_at_m_switch(m, want):
    plan = im._plan(m, 2048, 12288, 128, True, True, SMS)
    assert plan.kernel == want
    if want == "wgmma":    # one launch over the whole contraction
        assert (plan.splits, plan.rows_per_split) == (1, 2048)


@pytest.mark.parametrize("out,group,bf16,aligned", [
    (12_290, 128, True, True),     # OUT off the 16-column grid
    (12_288, 96, True, True),      # groups off the 64-row stages
    (12_288, 32, True, True),
    (12_288, 128, False, True),    # f32 activations
    (12_288, 128, True, False),    # unaligned operands
])
def test_int4_plan_keeps_the_first_kernel_where_the_tma_tiles_do_not_fit(
        out, group, bf16, aligned):
    plan = im._plan(8192, 2048, out, group, bf16, aligned, SMS)
    assert plan.kernel == "mma"
    with pytest.raises(ValueError, match="wgmma kernel does not take"):
        im._plan(8192, 2048, out, group, bf16, aligned, SMS, "wgmma")
    # at decode too: the first kernel, its splits as before
    for m in (1, 16, 40, 63):
        assert im._plan(m, 2048, out, group, bf16, aligned,
                        SMS).kernel == "mma"
    with pytest.raises(ValueError, match="decode kernel does not take"):
        im._plan(16, 2048, out, group, bf16, aligned, SMS, "decode")


@pytest.mark.parametrize("m,half,out,group,kernel,splits,rows", [
    # the decode kernel, 128 columns a block, two blocks an SM up to 16
    # rows: splits of whole groups for about one and a half waves, a power
    # of two
    (16, 2048, 1024, 128, "decode", 16, 128),   # Qwen3-8B k/v: 8 blocks
    (16, 2048, 4096, 128, "decode", 8, 256),    # q/o: 32 blocks
    (16, 2048, 12288, 128, "decode", 4, 512),   # gate/up: 96 blocks
    (16, 6144, 4096, 128, "decode", 8, 768),    # down
    (16, 2048, 151936, 128, "decode", 1, 2048),  # the untied head
    (40, 2048, 1024, 128, "decode", 16, 128),   # a verify step's rows
    (63, 6144, 4096, 128, "decode", 4, 1536),   # one block an SM
    (1, 24, 40, 24, "mma", 1, 64),              # a group off the tile
])
def test_int4_plan_keeps_the_decode_splits(m, half, out, group, kernel,
                                           splits, rows):
    plan = im._plan(m, half, out, group, True, True, SMS)
    assert plan == im.Plan(kernel, splits, rows)
    assert plan.splits * plan.rows_per_split >= half
    assert (plan.splits - 1) * plan.rows_per_split < half
    if kernel == "decode":   # whole groups a split
        assert plan.rows_per_split % group == 0


def _qwen_decode_shapes():
    from ragroute_tpu_torch.llm.shapes import QWEN3_06B, QWEN3_8B

    c = QWEN3_8B
    q_out = c.num_heads * c.head_dim
    return [("8b wq", c.hidden_size, q_out), ("8b wo", q_out, c.hidden_size),
            ("8b wk/wv", c.hidden_size, c.kv_dim),
            ("8b gate/up", c.hidden_size, c.intermediate_size),
            ("8b down", c.intermediate_size, c.hidden_size),
            ("8b head", c.hidden_size, c.vocab_size),
            ("0.6b tied head", QWEN3_06B.hidden_size, QWEN3_06B.vocab_size)]


@pytest.mark.parametrize("label,in_dim,out", _qwen_decode_shapes())
@pytest.mark.parametrize("m", [1, 16, 40, 63])
def test_int4_plan_takes_the_decode_kernel_at_every_decode_shape(
        label, in_dim, out, m):
    """bf16 activations below ``M_SWITCH`` rows take the decode kernel at
    every projection of Qwen3-8B and at Qwen3-0.6B's tied head; its splits
    are whole groups and cover every packed row once; f32 activations keep
    the first kernel."""
    half = in_dim // 2
    plan = im._plan(m, half, out, 128, True, True, SMS)
    assert plan.kernel == "decode"
    assert plan.rows_per_split % 128 == 0
    assert (plan.splits - 1) * plan.rows_per_split < half
    assert plan.splits * plan.rows_per_split >= half
    # at most one and a half waves of blocks, or one split when the columns
    # fill them
    blocks = -(-out // im.DEC_BN) * plan.splits
    slots = SMS * im.DEC_BLOCKS_PER_SM[16 if m <= 16 else 64]
    assert 2 * blocks <= 3 * slots or plan.splits == 1
    assert im._plan(m, half, out, 128, False, True, SMS).kernel == "mma"


def _model_decode(x, w, scales, group, plan):
    """The decode kernel's arithmetic in torch: each split sums its groups
    in order, the low group's scaled partial before the high group's, two
    roundings each; the last block then adds the splits' partials in split
    order."""
    half = w.shape[0]
    codes = im.unpack_int4_rows(w).to(torch.float32)
    xf = x.to(torch.float32)
    n_half = half // group
    parts = []
    for s in range(plan.splits):
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
        end = min(half, (s + 1) * plan.rows_per_split)
        for r0 in range(s * plan.rows_per_split, end, group):
            g = r0 // group
            for rows, sc in ((slice(r0, r0 + group), scales[g]),
                             (slice(half + r0, half + r0 + group),
                              scales[n_half + g])):
                acc = acc + (xf[:, rows] @ codes[rows]) * sc
        parts.append(acc)
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


@pytest.mark.parametrize("m,in_dim,out,group", [
    (1, 4096, 1024, 128), (16, 4096, 1024, 128), (40, 512, 208, 64),
    (63, 1024, 208, 128), (16, 2048, 384, 128)])
@pytest.mark.parametrize("exact", [True, False])
def test_decode_split_sum_model_matches_the_plain_version(m, in_dim, out,
                                                          group, exact):
    """Integer activations and power-of-two scales: every sum is exact in
    any order, so the split sum equals the plain version; random ones stay
    within ``matmul_close``'s tolerance (1e-4 of the largest output)."""
    from ragroute_tpu_torch.ops.decoder_checks import _rand_case

    gen = torch.Generator().manual_seed(m * 7 + in_dim)
    case = _rand_case("t", torch.device("cpu"), m, in_dim, out, group,
                      torch.bfloat16, gen, exact=exact)
    plan = im._plan(m, in_dim // 2, out, group, True, True, SMS)
    assert plan.kernel == "decode"
    got = _model_decode(case.x, case.w, case.scale, group, plan)
    want = im.int4_matmul_reference(case.x, case.w, case.scale, group=group)
    if exact:
        assert torch.equal(got, want)
    else:
        assert matmul_close(got, want)["ok"]


# ---- K1 ----------------------------------------------------------------------

BF16, I8, F32, I4, I4G = 1, 2, 0, 3, 4


@pytest.mark.parametrize("k,d,want", [
    (10, 768, "wgmma"), (32, 768, "wgmma"), (64, 768, "wgmma"),
    (65, 768, "fold"), (160, 768, "fold"), (161, 768, "fold"),
    (64, 128, "wgmma"), (65, 128, "fold"), (128, 128, "fold"),
    (160, 624, "fold"), (160, 640, "fold"), (256, 768, "fold"),
    (deep_topk.FOLD_MAX_K, 128, "fold"), (deep_topk.FOLD_MAX_K + 1, 128,
                                          "deep"), (1100, 768, "deep"),
])
def test_fused_plan_for_bf16_docs(k, d, want):
    assert ft._plan(512, 734_003, d, k, BF16, SMS).kernel == want


@pytest.mark.parametrize("k,want,doc_type,d", [
    pytest.param(k, want, dt, d, id=f"{k}-{want}-{dt}-{d}")
    for k, want in ((32, "shallow"), (160, "shallow"), (161, "deep"))
    for dt, d in ((F32, 128), (F32, 768), (I4, 80), (I4G, 80), (I4, 48))
    # f32 lists up to 64 take the f32 scan (test_fused_plan_for_f32_docs)
    if not (dt == F32 and k <= 64)])
def test_fused_plan_keeps_the_first_design_off_bf16(doc_type, d, k, want):
    """f32 docs past k = 64 (TF32 would change their answers) and int4 rows
    that are not a whole number of 16 bytes (d % 32: TMA's row stride) keep
    the first design up to k = 160; the scan refuses them when named."""
    assert ft._plan(512, 734_003, d, k, doc_type, SMS).kernel == want
    assert deep_topk.SHALLOW_MAX == ft.MAX_SHALLOW_K == 160
    with pytest.raises(ValueError, match="does not take"):
        ft._plan(512, 734_003, d, k, doc_type, SMS, "wgmma")


@pytest.mark.parametrize("bsz", [1, 8, 37, 130, 512, 2048])
@pytest.mark.parametrize("n,k", [(734_003, 32), (734_003, 128),
                                 (104_857, 64), (845, 10), (20_000, 160)])
def test_wgmma_splits_cover_the_shard_and_fill_the_card(bsz, n, k):
    """The scan (k <= 64) and its deep fold (past it, named, and the plan's
    own choice at every shard size: no list the fold takes goes to the deep
    launch; 128 query rows a block, as the scan at the serving depths)."""
    deep = k > ft.SHALLOW_K
    plan = ft._plan(bsz, n, 768, k, BF16, SMS, "fold" if deep else None)
    assert plan.kernel == ("fold" if deep else "wgmma")
    if deep:
        assert ft._plan(bsz, n, 768, k, BF16, SMS) == plan
    assert plan.tile_d == ft.W_TILE_D
    n_tiles = -(-n // plan.tile_d)
    # every tile in exactly one split, no split empty
    assert (plan.splits - 1) * plan.tiles_per_split < n_tiles
    assert plan.splits * plan.tiles_per_split >= n_tiles
    q_tile = ft.W_TILE_Q
    blocks = -(-bsz // q_tile) * plan.splits
    # a shard of a few hundred tiles fills the card: the blocks of the
    # last wave leave at most a sixth of it idle
    if n_tiles >= 4 * SMS:
        waves = -(-blocks // SMS)
        assert waves <= ft.W_MAX_WAVES
        assert blocks >= waves * SMS * 5 // 6, (blocks, waves)


def test_wgmma_split_plan_at_the_serving_batches():
    """734,003 docs in 3,823 tiles of 192: B = 8 takes one query tile in
    132 splits of 29 tiles; B = 512 4 query tiles x 33 splits = 132
    blocks, one wave; B = 2,048 16 x 33, four full waves."""
    for bsz in (8, 512, 2048):
        plan = ft._plan(bsz, 734_003, 768, 32, BF16, SMS)
        assert plan[:3] == (("wgmma", 132, 29) if bsz == 8 else
                            ("wgmma", 33, 116))
    # the scan takes no list past 64, even when named
    with pytest.raises(ValueError, match="does not take"):
        ft._plan(2048, 734_003, 768, 128, BF16, SMS, "wgmma")
    # the deep fold there: 128-row query tiles, 16 x 8 blocks in one wave,
    # 512 candidate slots a (row, split)
    assert ft._plan(2048, 734_003, 768, 128, BF16,
                    SMS) == ("fold", 8, 478, 192, 512)


def test_fused_plan_names_a_kernel_for_measurements():
    """``kernel`` plans the named launch at any shape it takes: the
    measurements time the launches against each other."""
    assert ft._plan(512, 734_003, 768, 32, BF16, SMS, "deep").kernel == "deep"
    sh = ft._plan(512, 734_003, 768, 32, BF16, SMS, "shallow")
    assert sh.kernel == "shallow" and sh.tile_d == ft.TILE_D
    assert ft._plan(512, 734_003, 128, 128, BF16, SMS,
                    "fold").kernel == "fold"
    assert ft._plan(20_000, 104_857, 128, 128, BF16, SMS,
                    "deep").kernel == "deep"


# ---- K1 over f32 docs: the f32 scan ------------------------------------------

@pytest.mark.parametrize("k,want", [(1, "f32"), (10, "f32"), (32, "f32"),
                                    (64, "f32"), (65, "shallow"),
                                    (160, "shallow"), (161, "deep"),
                                    (1100, "deep")])
@pytest.mark.parametrize("d", [128, 768])
def test_fused_plan_for_f32_docs(k, want, d):
    """f32 lists up to 64 take the f32 scan (full f32 FMA: no TF32), deeper
    ones the first design to 160 and the deep launch past it (f32 docs
    never reach the wgmma scan or its fold); the scan takes f32 docs at
    k <= 64 only, even when named."""
    plan = ft._plan(512, 734_003, d, k, F32, SMS)
    assert plan.kernel == want
    if want == "f32":
        assert plan.tile_d == ft.F32_TILE_D
        assert ft._plan(512, 734_003, d, k, F32, SMS, "f32") == plan
    else:
        with pytest.raises(ValueError, match="f32 scan does not take"):
            ft._plan(512, 734_003, d, k, F32, SMS, "f32")
    with pytest.raises(ValueError, match="does not take"):
        ft._plan(512, 734_003, d, k, F32, SMS, "wgmma")


@pytest.mark.parametrize("doc_type", [BF16, I8, I4, I4G])
def test_fused_f32_scan_refuses_other_docs(doc_type):
    with pytest.raises(ValueError, match="f32 scan does not take"):
        ft._plan(512, 734_003, 768, 32, doc_type, SMS, "f32")


@pytest.mark.parametrize("bsz,want", [(1, "f32_small"), (8, "f32_small"),
                                      (32, "f32_small"), (64, "f32_small"),
                                      (65, "f32"), (96, "f32"),
                                      (128, "f32"), (129, "f32"),
                                      (192, "f32"), (193, "f32"),
                                      (320, "f32"), (512, "f32"),
                                      (2048, "f32")])
def test_f32_plan_takes_the_small_batch_scan_below_the_crossover(bsz, want):
    """f32 lists up to 64 take the small-batch scan up to the crossover
    that ``f32_scan_pays`` sets from the card's readings (PERF.md) and the
    f32 scan past it; each of the two, and the first design, by name at
    any batch."""
    assert ft._plan(bsz, 734_003, 768, 32, F32, SMS).kernel == want
    assert ft.f32_scan_pays(bsz) == (want == "f32")
    for kernel in ("f32", "f32_small", "shallow"):
        assert ft._plan(bsz, 734_003, 768, 32, F32, SMS,
                        kernel).kernel == kernel


@pytest.mark.parametrize("bsz", [1, 8, 130, 512, 2048])
@pytest.mark.parametrize("n", [4_097, 104_857, 734_003])
def test_f32_scan_splits_cover_the_shard_and_fill_the_card(bsz, n):
    plan = ft._plan(bsz, n, 768, 32, F32, SMS, "f32")
    assert plan.kernel == "f32"
    n_tiles = -(-n // plan.tile_d)
    assert (plan.splits - 1) * plan.tiles_per_split < n_tiles
    assert plan.splits * plan.tiles_per_split >= n_tiles
    blocks = -(-bsz // ft.F32_TILE_Q) * plan.splits
    if n_tiles >= 4 * SMS:
        waves = -(-blocks // SMS)
        assert waves <= ft.W_MAX_WAVES
        assert blocks >= waves * SMS * 5 // 6, (blocks, waves)


@pytest.mark.parametrize("k", [1, 10, 32, 33, 64])
def test_f32_scan_ring_fits_shared_memory(k):
    """4 to 6 stages of a [128 x 32] f32 query box and doc box (TMA boxes of
    128-byte rows in the 128-byte swizzle) beside the 128 rows' lists and
    buffers: under an H100's 227 KB."""
    stages = ft.f32_stages(k)
    assert stages == {1: 6, 10: 5, 32: 5, 33: 5, 64: 4}[k]
    assert ft.f32_smem_bytes(stages, k) <= ft.SMEM_OPTIN == 232_448
    assert ft.f32_smem_bytes(stages + 1, k) > ft.SMEM_OPTIN or \
        stages == ft.F32_MAX_STAGES
    assert ft.F32_STAGE_BYTES == 2 * ft.F32_TILE_Q * 32 * 4
    assert (32 * 4) == 128 and ft.F32_STAGE_BYTES % 1024 == 0


def test_f32_scan_threads_cover_the_tile_once():
    """Thread (ty, tx) = (2 warp + lane / 16, lane % 16) of 256 keeps rows
    ty + 16 i and docs tx + 16 j (i, j < 8): every (row, doc) of the 128 x
    128 tile once; a warp's 16 rows (lane l < 16 names row 2 warp + (l & 1)
    + 16 (l >> 1)) are exactly its threads' rows, so it merges them alone;
    K3's f32 kernel: thread (tid / 16, tid % 16) of 128 keeps rows ty + 8 i
    and columns 4 tx + e, 64 + 4 tx + e: the 64 x 128 tile once."""
    seen = np.zeros((128, 128), np.int32)
    for tid in range(256):
        warp, lane = tid // 32, tid % 32
        ty, tx = 2 * warp + lane // 16, lane % 16
        for i in range(8):
            for j in range(8):
                seen[ty + 16 * i, tx + 16 * j] += 1
    assert (seen == 1).all()
    for warp in range(8):
        threads = {2 * warp + lane // 16 + 16 * i for lane in range(32)
                   for i in range(8)}
        named = {2 * warp + (lane & 1) + 16 * (lane >> 1)
                 for lane in range(16)}
        assert threads == named and len(named) == 16
    seen = np.zeros((64, 128), np.int32)
    for tid in range(128):
        ty, tx = tid // 16, tid % 16
        for i in range(8):
            for e in range(4):
                seen[ty + 8 * i, 4 * tx + e] += 1
                seen[ty + 8 * i, 64 + 4 * tx + e] += 1
    assert (seen == 1).all()


# ---- K1 over f32 docs at small batch: the small-batch scan ------------------

@pytest.mark.parametrize("bsz,rows", [(1, 8), (8, 8), (9, 32), (16, 32),
                                      (32, 32), (33, 64), (64, 64),
                                      (65, 64), (200, 64)])
def test_f32_small_plan_sizes_the_query_tile_to_the_batch(bsz, rows):
    """The batcher's buckets 1 and 8 take the 8-row tile, 32 the 32-row
    one, up to 64 rows the 64-row one (past it, named, 64-row tiles); doc
    tiles of 256 in splits that cover the shard once and fill the card: at
    B <= 64 over 734,003 docs, 131 splits of 22 tiles, one wave."""
    assert ft.f32_small_rows(bsz) == rows
    plan = ft._plan(bsz, 734_003, 768, 32, F32, SMS, "f32_small")
    assert plan.kernel == "f32_small" and plan.tile_d == ft.F32S_TILE_D
    n_tiles = -(-734_003 // plan.tile_d)
    assert (plan.splits - 1) * plan.tiles_per_split < n_tiles
    assert plan.splits * plan.tiles_per_split >= n_tiles
    blocks = -(-bsz // rows) * plan.splits
    waves = -(-blocks // SMS)
    assert waves <= ft.W_MAX_WAVES
    assert blocks >= waves * SMS * 5 // 6, (blocks, waves)
    if bsz <= 64:
        assert plan[:3] == ("f32_small", 131, 22)
    with pytest.raises(ValueError, match="f32 scan does not take"):
        ft._plan(bsz, 734_003, 768, 65, F32, SMS, "f32_small")
    with pytest.raises(ValueError, match="f32 scan does not take"):
        ft._plan(bsz, 734_003, 768, 32, BF16, SMS, "f32_small")


@pytest.mark.parametrize("k", [1, 32, 64])
@pytest.mark.parametrize("rows", ft.F32S_ROWS)
def test_f32_small_ring_fits_shared_memory(rows, k):
    """Stages of a [256 x 32] f32 doc box and the [rows x 32] query box
    (TMA boxes of 128-byte rows in the 128-byte swizzle, each on a 1024-byte
    boundary) beside the rows' lists and buffers of 64: under an H100's 227
    KB, with at least 4 stages (128 KB of docs in flight an SM)."""
    stages = ft.f32_small_stages(rows, k)
    assert stages == {8: 6, 32: 5, 64: 4}[rows]
    assert ft.f32_small_smem_bytes(rows, stages, k) <= ft.SMEM_OPTIN == 232_448
    assert ft.f32_small_smem_bytes(rows, stages + 1, k) > ft.SMEM_OPTIN or \
        stages == ft.F32S_MAX_STAGES
    assert (ft.F32S_TILE_D * 32 * 4) % 1024 == 0 and (rows * 32 * 4) % 1024 == 0
    assert stages * ft.F32S_TILE_D * 32 * 4 >= 128 * 1024


@pytest.mark.parametrize("rows", ft.F32S_ROWS)
def test_f32_small_threads_cover_the_tile_once(rows):
    """Thread (ty, tx) = (lane % 8, 4 warp + lane / 8) of the 8 consumer
    warps keeps rows ty + 8 i (i < rows / 8) and docs tx + 32 j (j < 8):
    every (row, doc) of the rows x 256 tile once and no row past the
    template's tile; every warp holds all the tile's rows, so the lanes
    reading one doc (a quad: ty 0 to 7) serve every row from one address;
    in a step (one j) a row takes one doc from each of 32 threads, so a
    buffer of 64 that holds at most 32 before a step never overflows; the
    swizzled loads of a warp hit distinct 16-byte bank groups."""
    tm = rows // 8
    seen = np.zeros((rows, 256), np.int32)
    step_takers = np.zeros((8, rows), np.int32)
    for tid in range(256):
        warp, lane = tid // 32, tid % 32
        ty, tx = lane % 8, 4 * warp + lane // 8
        for i in range(tm):
            assert ty + 8 * i < rows
            for j in range(8):
                seen[ty + 8 * i, tx + 32 * j] += 1
            step_takers[:, ty + 8 * i] += 1
    assert (seen == 1).all()
    assert (step_takers == 32).all() and ft.F32S_CAP - 32 + 32 == 64
    for warp in range(8):
        lanes = range(32)
        warp_rows = {lane % 8 + 8 * i for lane in lanes for i in range(tm)}
        assert warp_rows == set(range(rows))
        for kq in range(8):      # 16-byte chunk kq of a 128-byte row
            q_rows = {lane % 8 for lane in lanes}
            d_rows = {4 * warp + lane // 8 for lane in lanes}
            for group in (q_rows, d_rows):
                banks = {(kq ^ (r % 8)) for r in group}
                assert len(banks) == len(group)


# ---- K2's collect: the plan's walk and the merge in the launch ---------------

@pytest.mark.parametrize("bsz,m,k", [(512, 131_072, 32), (8, 131_072, 32),
                                     (16, 131_072, 32), (9, 20_003, 64),
                                     (3, 8_193, 1), (2048, 131_072, 64)])
def test_collect_plan_walks_every_position_once_in_whole_waves(bsz, m, k):
    """Persistent warps take items gw, gw + warps, ..: every (row, split)
    once, every position of a row in one split; the grid is at most the
    card's resident blocks, and the waves are whole: no warp takes an item
    more than one wave after another; at [512, 131,072] the 4,096 items
    fill one wave of the 4,224 resident warps to 97%."""
    from ragroute_tpu_torch.ops import stream_topk as st

    p = st.plan(bsz, m, k, SMS)
    assert p.path == st.COLLECT
    items = bsz * p.splits
    warps = p.grid * st.COLLECT_WARPS
    assert p.grid <= SMS * st.COLLECT_BLOCKS_PER_SM
    taken = np.zeros(items, np.int32)
    per_warp = []
    for gw in range(warps):
        mine = list(range(gw, items, warps))
        taken[mine] += 1
        per_warp.append(len(mine))
    assert (taken == 1).all()
    assert max(per_warp) - min(per_warp) <= 1
    assert max(per_warp) == -(-items // warps)
    covered = np.zeros(m, np.int32)
    for s in range(p.splits):
        covered[s * p.chunk:min((s + 1) * p.chunk, m)] += 1
    assert (covered == 1).all()
    if (bsz, m) == (512, 131_072):
        assert (p.splits, p.chunk, p.grid) == (8, 16_384, 512)
        assert items / (SMS * st.COLLECT_BLOCKS_PER_SM * st.COLLECT_WARPS) \
            > 0.96


class _WarpList:
    """A warp's list and candidate buffer as ``collect_kernel`` keeps them:
    a value at the threshold (the list's k-th best, at least the lowest
    finite gain) goes to the buffer in lane order; a buffer that cannot
    take a ballot's values is merged into the list first, by rank under
    (gain desc, position asc)."""

    def __init__(self, k):
        self.k = k
        self.g = np.full(k, -np.inf, np.float32)
        self.i = np.zeros(k, np.int64)
        self.bg, self.bi = [], []
        self.thr = np.float32(-np.finfo(np.float32).max)

    def flush(self):
        if not self.bg:
            return
        g = np.concatenate([self.g, np.float32(self.bg)])
        i = np.concatenate([self.i, np.int64(self.bi)])
        order = np.lexsort((i, -g.astype(np.float64)))[:self.k]
        self.g, self.i = g[order], i[order]
        self.i[np.isneginf(self.g)] = 0
        self.bg, self.bi = [], []
        self.thr = max(self.g[-1], np.float32(-np.finfo(np.float32).max))

    def offer(self, x, ids):
        passing = x >= self.thr
        if not passing.any():
            return
        if len(self.bg) + int(passing.sum()) > 32:
            self.flush()
        self.bg += list(x[passing])
        self.bi += list(ids[passing])


def _collect_model(g: np.ndarray, k: int, p, offset: int, order):
    """``collect_kernel`` on ``g`` [B, M] whose first element sits
    ``offset`` floats past a 16-byte boundary, its items finished in
    ``order``: each item's head and tail one a lane, its aligned body in
    rounds of ``COLLECT_ROUND / 128`` float4 a lane, the first round's
    threshold raised to the
    k-th largest lane maximum (k <= 32), each lane's passing values
    offered one a ballot, lowest first; the row's last item merges every
    split's list into an empty one at the best of their k-th bests."""
    bsz, m = g.shape
    lanes = np.arange(32)
    from ragroute_tpu_torch.ops import stream_topk as st
    p_round = st.COLLECT_ROUND          # 32 lanes x `unroll` float4
    unroll = p_round // 128
    parts, done, out = {}, np.zeros(bsz, np.int32), {}
    for item in order:
        row, split = divmod(int(item), p.splits)
        begin, end = split * p.chunk, min((split + 1) * p.chunk, m)
        w = _WarpList(k)
        mis = (offset + row * m + begin) % 4
        a0 = min(end, begin + (4 - mis) % 4)
        a1 = a0 + ((end - a0) & ~3)
        pos = np.where(lanes < a0 - begin, begin + lanes,
                       np.where((lanes >= 4) & (lanes - 4 < end - a1),
                                a1 + lanes - 4, -1))
        w.offer(np.where(pos >= 0, g[row, np.maximum(pos, 0)], -np.inf),
                pos)
        for p0 in range(a0, a1, p_round):
            # lane l's values q = 4 u + c, at p0 + 128 u + 4 l + c
            at = (p0 + 128 * np.arange(unroll)[None, :, None]
                  + 4 * lanes[:, None, None]
                  + np.arange(4)[None, None, :]).reshape(32, 4 * unroll)
            v = np.where(at < a1, g[row, np.minimum(at, m - 1)], -np.inf)
            if p0 == a0 and k <= 32:   # the first round's bound
                w.thr = max(w.thr, np.sort(v.max(axis=1))[::-1][k - 1])
            pending = v >= w.thr
            while pending.any():       # each lane's lowest pending value
                has = pending.any(axis=1)
                q = np.argmax(pending, axis=1)
                pending[lanes[has], q[has]] = False
                w.offer(np.where(has, v[lanes, q], -np.inf), at[lanes, q])
        w.flush()
        if p.splits == 1:
            out[row] = (w.g, w.i)
            continue
        parts[row, split] = (w.g, w.i)
        done[row] += 1
        if done[row] < p.splits:
            continue
        last = _WarpList(k)       # at the best of the splits' k-th bests
        last.thr = max(last.thr, max(parts[row, s][0][-1]
                                     for s in range(p.splits)))
        pg = np.concatenate([parts[row, s][0] for s in range(p.splits)])
        pi = np.concatenate([parts[row, s][1] for s in range(p.splits)])
        for e0 in range(0, pg.size, 32 * unroll):
            for u in range(unroll):
                e = e0 + 32 * u + lanes
                last.offer(np.where(e < pg.size, pg[np.minimum(e, pg.size - 1)],
                                    -np.inf),
                           np.where(e < pg.size, pi[np.minimum(e, pg.size - 1)],
                                    0))
        last.flush()
        out[row] = (last.g, last.i)
    return (np.stack([out[r][0] for r in range(bsz)]),
            np.stack([out[r][1] for r in range(bsz)]))


@pytest.mark.parametrize("k", [1, 32, 64])
@pytest.mark.parametrize("offset", [0, 3])
def test_collect_merge_in_the_launch_matches_the_plain_version(k, offset):
    """A model of the collect over tied small integers with -inf entries, a
    row of nothing but -inf, one with fewer finite values than k and one
    all tied, rows of 20,003 positions (each row's start off the 16-byte
    grid) in the plan's splits, the items finished in a shuffled order:
    the same gains and positions as ``stream_topk_reference``."""
    from ragroute_tpu_torch.ops import stream_topk as st

    rng = np.random.default_rng(k + offset)
    g = rng.integers(-3, 4, (6, 20_003)).astype(np.float32)
    g[rng.random(g.shape) < 0.2] = -np.inf
    g[1] = -np.inf
    g[2] = -np.inf
    g[2, [5, 7_000, 20_002]] = [1.0, 1.0, 2.0]
    g[3] = 0.0
    p = st.plan(6, 20_003, k, SMS)
    assert p.path == st.COLLECT and p.splits > 1
    order = rng.permutation(6 * p.splits)
    mg, mi = _collect_model(g, k, p, offset, order)
    rg, ri = st.stream_topk_reference(torch.from_numpy(g), k)
    np.testing.assert_array_equal(mg, rg.numpy())
    np.testing.assert_array_equal(mi, ri.numpy())


# ---- K3: the grouped GEMM's plan ---------------------------------------------

GF32, GBF16, GI8, GI4 = 0, 1, 2, 3


@pytest.mark.parametrize("s", [8, 104, 128, 160, 256, 328, 1584])
@pytest.mark.parametrize("doc_type", [GF32, GBF16, GI8, GI4])
@pytest.mark.parametrize("d", [64, 768])
def test_grouped_plan_over_slab_type_and_width(d, s, doc_type):
    """bf16, int8 and int4 slabs take the wgmma kernel: B tiles of 64
    columns, at most 4 a pass (the widest wgmma), the passes cover S, a
    persistent grid of at most one block an SM, the deepest ring that fits;
    f32 slabs take the f32 kernel (passes of 128 columns)."""
    g = 6028 + 4096
    plan = gg._plan(g, d, s, doc_type, SMS)
    if doc_type == GF32:
        assert plan.kernel == "f32"
        assert plan.passes == -(-s // gg.GF_COLS) and plan.grid == g * \
            plan.passes
        with pytest.raises(ValueError, match="wgmma kernel does not take"):
            gg._plan(g, d, s, doc_type, SMS, "wgmma")
        return
    assert plan.kernel == "wgmma"
    assert plan.tiles == min(4, -(-s // 64))
    assert (plan.passes - 1) * 64 * plan.tiles < s <= \
        plan.passes * 64 * plan.tiles
    assert plan.grid == min(g * plan.passes, SMS)
    raw = doc_type != GBF16
    assert plan.smem == gg.gw_smem_bytes(plan.tiles, plan.stages,
                                         plan.staging)
    assert 2 <= plan.stages <= gg.GW_MAX_STAGES
    assert (2 <= plan.staging <= gg.GW_MAX_STAGING) if raw else \
        plan.staging == 0
    assert plan.smem <= gg.SMEM_OPTIN
    if plan.stages < gg.GW_MAX_STAGES:
        assert gg.gw_smem_bytes(plan.tiles, plan.stages + 1,
                                plan.staging) > gg.SMEM_OPTIN
    with pytest.raises(ValueError, match="f32 kernel does not take"):
        gg._plan(g, d, s, doc_type, SMS, "f32")
    assert gg._plan(g, d, s, doc_type, SMS, "first").kernel == "first"


def _staging_reads_what_it_loaded(staging: int, chunks: int, items: int,
                                  int4: bool) -> bool:
    """The int8 / int4 staging ring's order (loads of chunks 0 ..
    staging - 2, then per chunk i its publication, which reads chunk i's
    slot and, for int4, the raw bytes in its even chunk's slot, and the
    load of chunk i + staging - 1): every read finds the chunk it wants."""
    total = chunks * items
    held = {}
    for j in range(min(staging - 1, total)):
        held[j % staging] = j
    for i in range(total):
        if held.get(i % staging) != i:
            return False
        raw = i & ~1 if int4 else i
        if held.get(raw % staging) != raw:
            return False
        if i + staging - 1 < total:
            held[(i + staging - 1) % staging] = i + staging - 1
    return True


@pytest.mark.parametrize("doc_type,s,stages,staging", [
    (GBF16, 256, 5, 0), (GI8, 256, 2, 5), (GI4, 256, 2, 5),   # pubmed's S
    (GBF16, 104, 8, 0), (GI8, 104, 3, 8), (GI4, 160, 2, 7)])  # the others'
def test_grouped_wgmma_ring_at_the_served_shapes(doc_type, s, stages,
                                                 staging):
    """The served widths (S 104 to 256): the ring's stages and the staging
    ring's slots (int8 / int4: the copies in flight), the ring's tiles on
    the 1024-byte swizzle grid, all under 227 KB; a staging slot is loaded
    again only after its last read (an int4 raw chunk feeds two stages)."""
    plan = gg._plan(8192, 768, s, doc_type, SMS)
    assert (plan.stages, plan.staging) == (stages, staging)
    assert plan.smem <= gg.SMEM_OPTIN
    assert gg.gw_stage_bytes(plan.tiles) % 1024 == 0
    assert gg.GW_COLS * 2 == 128          # a B tile row: the swizzle's span
    if doc_type == GBF16:
        # issuing chunk i + ahead waits for the stage the consumer frees
        # after chunk i + ahead - stages + 1, which must be published by then
        assert 0 <= gg.gw_ahead(plan.stages) <= plan.stages - 2
    else:
        assert gg.gw_staging_bytes(plan.tiles) % 16 == 0
        for chunks in (1, 2, 12):
            assert _staging_reads_what_it_loaded(
                plan.staging, chunks if doc_type == GI8 else 2 * chunks, 5,
                doc_type == GI4)


def test_grouped_plan_keeps_the_first_design_where_the_ring_does_not_fit():
    """The shared-memory fit: under a block budget that two wgmma stages do
    not fit the plan takes the first design, and the wgmma kernel refuses
    the shape when named; bad widths raise."""
    small = gg.gw_smem_bytes(4, 2) - 1
    assert gg._plan(100, 768, 256, GBF16, SMS, smem_optin=small).kernel == \
        "first"
    assert gg._plan(100, 768, 64, GBF16, SMS, smem_optin=small).kernel == \
        "wgmma"
    with pytest.raises(ValueError, match="wgmma kernel does not take"):
        gg._plan(100, 768, 256, GBF16, SMS, "wgmma", smem_optin=small)
    for d, s in ((40, 256), (768, 100), (768, 4)):
        with pytest.raises(ValueError, match="d % 16 == 0"):
            gg._plan(100, d, s, GBF16, SMS)
    with pytest.raises(ValueError, match="no kernel named"):
        gg._plan(100, 768, 256, GBF16, SMS, "tiles")


def _model_grouped_wgmma(q, docs, bias, scale, blk_cluster, rows, n_real,
                         packed4):
    """grouped_wgmma_kernel's walk in torch (f64): persistent blocks over
    (pair block, pass) items; per item the 64-deep chunks, each pairing the
    query rows' columns with the slab rows the kernel loads (int4: chunk
    2 p the low nibbles of byte rows 64 p .., against query columns 64 p ..;
    2 p + 1 their high nibbles, against D/2 + 64 p ..), masked past the
    slab's rows and S; then x scale + bias."""
    c_n, ds, s = docs.shape
    d = q.shape[1]
    g = blk_cluster.shape[0]
    plan = gg._plan(g, d, s, gg._INT4 if packed4 else
                    gg._DOC_TYPES[docs.dtype], SMS)
    n = 64 * plan.tiles
    half = ds if packed4 else d
    chunks = 2 * -(-ds // 64) if packed4 else -(-d // 64)
    out = torch.full((g * 64, s), float("nan"), dtype=torch.float64)
    items = min(g, int(n_real)) * plan.passes
    done = []
    for b in range(plan.grid):
        for it in range(b, items, plan.grid):
            blk, pas = divmod(it, plan.passes)
            done.append(it)
            n0 = pas * n
            cl = min(max(int(blk_cluster[blk]), 0), c_n - 1)
            qrows = q[rows[blk * 64:(blk + 1) * 64].long()].double()
            acc = torch.zeros((64, n), dtype=torch.float64)
            for c in range(chunks):
                local0 = (c >> 1 if packed4 else c) * 64
                qbase = ds if packed4 and c & 1 else 0
                a = torch.zeros((64, 64), dtype=torch.float64)
                w = min(64, half - local0)
                a[:, :w] = qrows[:, qbase + local0:qbase + local0 + w]
                bm = torch.zeros((64, n), dtype=torch.float64)
                hr, hc = min(64, ds - local0), min(n, s - n0)
                raw = docs[cl, local0:local0 + hr, n0:n0 + hc]
                if packed4:
                    x = raw.to(torch.int32)
                    raw = (x >> 4) if c & 1 else ((x << 28) >> 28)
                bm[:hr, :hc] = raw.double()
                acc += a @ bm
            cols = slice(n0, min(s, n0 + n))
            w = cols.stop - n0
            x = acc[:, :w].float()
            if scale is not None:
                x = x * scale[cl, cols]
            out[blk * 64:(blk + 1) * 64, cols] = (x + bias[cl, cols]).double()
    assert sorted(done) == list(range(items))     # every item once
    return out.float()


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("d,s", [(64, 8), (96, 104), (64, 256), (160, 328)])
def test_grouped_wgmma_walk_model_matches_the_plain_version(kind, d, s):
    """Integer data: the model of the wgmma kernel's chunk walk equals
    grouped_gains_reference on every real row (d = 96 and 160: a chunk
    past the contraction's end; int4 d = 96: halves of 48 rows)."""
    from ragroute_tpu_torch.index.shard import _pack_int4

    rng = np.random.default_rng(d * 1000 + s)
    c_n, g, bsz = 5, 7, 23
    slab = rng.integers(-4, 5, (c_n, d, s)).astype(np.float32)
    q = torch.from_numpy(rng.integers(-4, 5, (bsz, d)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, bsz, g * 64).astype(np.int32))
    blk = torch.tensor([3, 0, 0, 4, 1, 3, 2], dtype=torch.int32)
    bias = torch.from_numpy(rng.integers(-8, 9, (c_n, s)).astype(np.float32))
    scale = torch.from_numpy((2.0 ** rng.integers(-3, 2, (c_n, s))
                              ).astype(np.float32))
    if kind == "bf16":
        docs, sc = torch.from_numpy(slab).to(torch.bfloat16), None
    elif kind == "int8":
        docs, sc = torch.from_numpy(slab).to(torch.int8), scale
    else:
        packed = _pack_int4(slab.transpose(0, 2, 1).reshape(c_n * s, d)
                            .astype(np.int8)).reshape(c_n, s, d // 2)
        docs = torch.from_numpy(np.ascontiguousarray(
            packed.transpose(0, 2, 1)))
        sc = scale
    qb = q.to(torch.bfloat16)
    n_real = g - 2
    got = _model_grouped_wgmma(qb, docs, bias, sc, blk, rows, n_real,
                               kind == "int4")
    want = gg.grouped_gains_reference(qb, docs, bias, sc, blk[:n_real],
                                      kind == "int4", rows[:n_real * 64])
    assert torch.equal(got[:n_real * 64], want)
    assert torch.isnan(got[n_real * 64:]).all()    # padding blocks skipped


def _ring_completes(stages: int, ahead: int, chunks: int, items: int) -> bool:
    """The wgmma kernel's ring protocol as a state machine: the producer
    issues chunk j once the stage of chunk j - stages is back (its own loop:
    the first `ahead` issues, then per chunk i the issue of i + ahead and
    the publication of i); the consumer takes chunk i once published and
    frees the stage of chunk i - 1 after it (within an item), an item's
    last chunk after the epilogue. True when both run to the end."""
    total = chunks * items
    prod = [("issue", j) for j in range(ahead)]
    for i in range(total):
        prod += [("issue", i + ahead), ("publish", i)]
    published, released = set(), set()
    p = c = 0
    while p < len(prod) or c < total:
        moved = False
        while p < len(prod):
            op, j = prod[p]
            if op == "issue" and j < total and j >= stages and \
                    j - stages not in released:
                break
            if op == "publish":
                published.add(j)
            p += 1
            moved = True
        while c < total and c in published:
            if c % chunks:
                released.add(c - 1)
            if c % chunks == chunks - 1:
                released.add(c)
            c += 1
            moved = True
        if not moved:
            return False
    return True


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("stages", range(2, gg.GW_MAX_STAGES + 1))
@pytest.mark.parametrize("chunks", [1, 2, 12])
def test_grouped_wgmma_ring_protocol_completes(raw, stages, chunks):
    """The ring never deadlocks at the planned lookahead (bf16: at most
    stages - 2; int8 / int4 wait for a stage only when they publish into
    it: none), and would at stages - 1: the issue of chunk i + stages - 1
    waits for a stage the consumer frees only after chunk i, which the
    producer publishes after that issue."""
    ahead = 0 if raw else gg.gw_ahead(stages)
    assert _ring_completes(stages, ahead, chunks, 5)
    if chunks > 1:
        assert not _ring_completes(stages, stages - 1, chunks, 5)


@pytest.mark.parametrize("staging", range(2, gg.GW_MAX_STAGING + 1))
@pytest.mark.parametrize("int4", [False, True])
def test_grouped_staging_ring_is_read_before_it_is_loaded_again(staging,
                                                                int4):
    for chunks in (2, 4, 12):
        assert _staging_reads_what_it_loaded(staging, chunks, 4, int4)
