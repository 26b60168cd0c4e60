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
and past it to its deep fold over shards of ``FOLD_MIN_DOCS`` docs or more
(smaller ones to the deep launch), and f32 docs and int4 rows off the
16-byte grid to the first design, or past k = 160 to the deep launch. The wgmma launches' doc splits cover the shard without an
empty split and fill the card at B = 8 as at B = 512. The kernels
themselves run only on a card (``tests/test_torch_kernel.py``).
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu_torch.ops import deep_topk
from ragroute_tpu_torch.ops import fused_topk as ft
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


@pytest.mark.parametrize("doc_type,d", [(F32, 128), (F32, 768), (I4, 80),
                                        (I4G, 80), (I4, 48)])
@pytest.mark.parametrize("k,want", [(32, "shallow"), (160, "shallow"),
                                    (161, "deep")])
def test_fused_plan_keeps_the_first_design_off_bf16(doc_type, d, k, want):
    """f32 docs (TF32 would change their answers) and int4 rows that are
    not a whole number of 16 bytes (d % 32: TMA's row stride) keep the
    first design up to k = 160; the scan refuses them when named."""
    assert ft._plan(512, 734_003, d, k, doc_type, SMS).kernel == want
    assert deep_topk.SHALLOW_MAX == ft.MAX_SHALLOW_K == 160
    with pytest.raises(ValueError, match="does not take"):
        ft._plan(512, 734_003, d, k, doc_type, SMS, "wgmma")


@pytest.mark.parametrize("bsz", [1, 8, 37, 130, 512, 2048])
@pytest.mark.parametrize("n,k", [(734_003, 32), (734_003, 128),
                                 (104_857, 64), (845, 10), (20_000, 160)])
def test_wgmma_splits_cover_the_shard_and_fill_the_card(bsz, n, k):
    """The scan (k <= 64) and its deep fold (past it, named: the plan sends
    lists past 64 over shards below ``FOLD_MIN_DOCS`` to the deep launch;
    128 query rows a block, as the scan at the serving depths)."""
    deep = k > ft.SHALLOW_K
    plan = ft._plan(bsz, n, 768, k, BF16, SMS, "fold" if deep else None)
    assert plan.kernel == ("fold" if deep else "wgmma")
    if deep and n < ft.FOLD_MIN_DOCS:
        assert ft._plan(bsz, n, 768, k, BF16, SMS).kernel == "deep"
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
