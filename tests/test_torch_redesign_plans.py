"""The launch plans of the two wgmma kernels, as pure functions, on the CPU.

K5 (``ops/int4_matmul.py::_plan``) sends bf16 activations from ``M_SWITCH``
rows, with OUT on the 16-column grid, groups of whole 64-row stages and
16-byte aligned operands, to the prefill kernel (``int4_mm_wgmma_kernel``),
and every other call to the first kernel, whose contraction splits are as
before. K1 (``ops/fused_topk.py::_plan``) sends bf16 docs to the wgmma scan
up to k = 160, except lists past 64 over docs narrower than
``W_DEEP_BELOW_D``, which take the deep launch like every list past 160;
f32, int8 and int4 docs keep the first design. The wgmma scan's doc splits
cover the shard without an empty split and fill the card at B = 8 as at
B = 512. The kernels themselves run only on a card
(``tests/test_torch_kernel.py``).
"""

import pytest

from ragroute_tpu_torch.ops import deep_topk
from ragroute_tpu_torch.ops import fused_topk as ft
from ragroute_tpu_torch.ops import int4_matmul as im

SMS = 132       # an H100 SXM


# ---- K5 ----------------------------------------------------------------------

@pytest.mark.parametrize("m,want", [(im.M_SWITCH - 1, "mma"),
                                    (im.M_SWITCH, "wgmma"),
                                    (im.M_SWITCH + 37, "wgmma"),
                                    (8192, "wgmma"), (16, "mma"), (1, "mma")])
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


@pytest.mark.parametrize("m,half,out,group,splits,rows", [
    (16, 2048, 1024, 128, 16, 128),     # Qwen3-8B k/v at decode: 8 blocks
    (16, 2048, 4096, 128, 8, 256),      # q/o
    (16, 2048, 12288, 128, 3, 768),     # gate/up: 96 column blocks
    (16, 6144, 4096, 128, 8, 768),      # down
    (1, 24, 40, 24, 1, 64),             # a group off the tile: no cut
])
def test_int4_plan_keeps_the_decode_splits(m, half, out, group, splits, rows):
    plan = im._plan(m, half, out, group, True, True, SMS)
    assert plan == im.Plan("mma", splits, rows)
    assert plan.splits * plan.rows_per_split >= half
    assert (plan.splits - 1) * plan.rows_per_split < half


# ---- K1 ----------------------------------------------------------------------

BF16, I8, F32, I4, I4G = 1, 2, 0, 3, 4


@pytest.mark.parametrize("k,d,want", [
    (10, 768, "wgmma"), (32, 768, "wgmma"), (64, 768, "wgmma"),
    (65, 768, "wgmma"), (160, 768, "wgmma"), (161, 768, "deep"),
    (64, 128, "wgmma"), (65, 128, "deep"), (128, 128, "deep"),
    (160, ft.W_DEEP_BELOW_D[BF16] - 16, "deep"),
    (160, ft.W_DEEP_BELOW_D[BF16], "wgmma"), (256, 768, "deep"),
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
    plan = ft._plan(bsz, n, 768, k, BF16, SMS)
    assert plan.kernel == "wgmma" and plan.tile_d == ft.W_TILE_D
    n_tiles = -(-n // plan.tile_d)
    # every tile in exactly one split, no split empty
    assert (plan.splits - 1) * plan.tiles_per_split < n_tiles
    assert plan.splits * plan.tiles_per_split >= n_tiles
    q_tile = ft.W_TILE_Q if k <= ft.SHALLOW_K else ft.W_TILE_Q_DEEP
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
    # k = 128: 64-row query tiles, B = 2,048 in 8 full waves of 132
    assert ft._plan(2048, 734_003, 768, 128, BF16, SMS)[:3] == ("wgmma", 33,
                                                                116)


def test_fused_plan_names_a_kernel_for_measurements():
    """``kernel`` plans the named launch at any shape it takes: the
    measurements time the launches against each other."""
    assert ft._plan(512, 734_003, 768, 32, BF16, SMS, "deep").kernel == "deep"
    sh = ft._plan(512, 734_003, 768, 32, BF16, SMS, "shallow")
    assert sh.kernel == "shallow" and sh.tile_d == ft.TILE_D
    assert ft._plan(512, 734_003, 128, 128, BF16, SMS,
                    "wgmma").kernel == "wgmma"
