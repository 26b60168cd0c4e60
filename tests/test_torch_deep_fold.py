"""K1's deep fold (lists past 64 on the wgmma scan), on the CPU.

The fold runs only on a card (``csrc/fused_topk.cu``, ``wgmma_topk_kernel``
with ``DEEP``; its exact cases are in ``tests/test_torch_kernel.py``). Here
its plan and its arithmetic are checked without one:

* ``ops/fused_topk.py::_plan`` sends lists past 64 over bf16, int8 and int4
  docs to the fold at the low-rank and hostrefine coarse scans' shapes
  (shards of ``FOLD_MIN_DOCS`` docs or more; smaller ones keep the deep
  launch), keeps f32 docs and int4 rows off the 16-byte grid on the first
  design and the deep launch, and keeps the fold's workspace (every row's
  candidate words and lists) under ``deep_topk.WORKSPACE_CAP`` at B =
  2,048;
* a torch model of the fold (each row a lower bound that starts at -inf
  and only rises, strict compares, candidates staged a step of 16 docs at
  a time and moved to the row's buffer 48 or more at once, a full buffer
  cut to its k best and up to k / 2 more by (gain desc, position asc) and
  the bound raised to the least kept, the split lists merged) equals the
  stable top-k over gains with many ties, -inf and NaN (which never enter,
  as in every kernel of the port), at k' = 65, 128, 256 and 1,100, with
  buffers that overflow many times.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu_torch.ops import deep_topk
from ragroute_tpu_torch.ops import fused_topk as ft
from ragroute_tpu_torch.ops.topk import topk_stable

SMS = 132
F32, BF16, I8, I4, I4G = 0, 1, 2, 3, 4
NEG_INF = float("-inf")
STEP = 16          # docs of a fold step: a row's candidates are staged after it
SB = 64            # a row's staging slots (csrc/fused_topk.cu W_SB)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


# ---- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("n,d,doc_type", [
    (734_003, 128, BF16),        # the low-rank coarse scan
    (2_936_320, 128, I8),        # hostrefine's flat coarse slab (smoke)
    (5_872_128, 128, I8),        # the same at the full host-tier world
    (734_003, 128, I4), (734_003, 768, I4G), (734_003, 768, BF16)])
@pytest.mark.parametrize("k", [65, 128, 160, 256, 1024])
@pytest.mark.parametrize("bsz", [8, 512, 2048])
def test_the_fold_takes_lists_past_64_at_the_coarse_shapes(n, d, doc_type,
                                                           k, bsz):
    plan = ft._plan(bsz, n, d, k, doc_type, SMS)
    assert plan.kernel == "fold" and plan.tile_d == ft.W_TILE_D
    assert plan.cap == deep_topk.fold_cap(k) >= k + deep_topk.FOLD_SLACK
    n_tiles = -(-n // plan.tile_d)
    assert (plan.splits - 1) * plan.tiles_per_split < n_tiles
    assert plan.splits * plan.tiles_per_split >= n_tiles
    assert (deep_topk.fold_bytes(bsz, plan.splits, k)
            <= deep_topk.WORKSPACE_CAP)
    # the serving batch fills the card: one wave of 132 blocks
    if bsz == 512 and k <= 256:
        assert -(-bsz // ft.W_TILE_Q) * plan.splits == SMS


@pytest.mark.parametrize("doc_type,d", [(F32, 128), (F32, 768), (I4, 80),
                                        (I4G, 80), (I4, 48)])
@pytest.mark.parametrize("k,want", [(65, "shallow"), (160, "shallow"),
                                    (161, "deep"), (256, "deep")])
def test_f32_and_unaligned_int4_keep_the_first_design_and_deep_launch(
        doc_type, d, k, want):
    assert ft._plan(512, 734_003, d, k, doc_type, SMS).kernel == want
    with pytest.raises(ValueError, match="deep fold does not take"):
        ft._plan(512, 734_003, d, k, doc_type, SMS, "fold")


@pytest.mark.parametrize("n", [83_886, 104_857, 125_829, 262_144])
@pytest.mark.parametrize("k", [65, 128, 256])
def test_small_shards_keep_the_deep_launch(n, k):
    """Below ``FOLD_MIN_DOCS`` docs the fold's fixed cost a (row, split)
    loses to the deep launch (the low-rank world's three small shards):
    the plan takes the deep launch there, and the fold when named."""
    assert n < ft.FOLD_MIN_DOCS
    assert ft._plan(512, n, 128, k, BF16, SMS).kernel == "deep"
    assert ft._plan(512, n, 128, k, BF16, SMS, "fold").kernel == "fold"


@pytest.mark.parametrize("k", [64, deep_topk.FOLD_MAX_K + 1])
def test_the_fold_refuses_depths_outside_its_range(k):
    want = "wgmma" if k <= ft.SHALLOW_K else "deep"
    assert ft._plan(512, 734_003, 128, k, BF16, SMS).kernel == want
    with pytest.raises(ValueError, match="deep fold does not take"):
        ft._plan(512, 734_003, 128, k, BF16, SMS, "fold")


def test_a_small_cap_cuts_the_splits_and_then_takes_the_deep_launch():
    one = deep_topk.fold_bytes(512, 1, 256)
    plan = ft._plan(512, 734_003, 128, 256, BF16, SMS, cap=3 * one)
    assert plan.kernel == "fold" and plan.splits <= 3
    assert ft._plan(512, 734_003, 128, 256, BF16, SMS,
                    cap=one - 1).kernel == "deep"


# ---- a model of the fold -----------------------------------------------------------

def _best(g, p, k):
    """The k best of (g, p) by (gain desc, position asc); -0 ties +0."""
    order = np.lexsort((p, -g))[:k]
    return g[order], p[order]


def _model_fold(gains: np.ndarray, k: int, split_docs: int, cap: int,
                rng: np.random.Generator):
    """One row through the fold as the kernel runs it: per split of
    ``split_docs`` docs, the candidates above the row's lower bound are
    staged a step at a time; staging that could not take another step's
    (more than ``SB - STEP``) goes to the row's buffer; a buffer that could
    not take another staging's (more than ``cap - SB``) is cut to its k best
    and up to k / 2 more (here a random number of them: any keeps the answer
    exact) and the bound raised to the least word kept; at the split's end
    the buffer is cut to k and sorted. The split lists merge by (gain desc,
    position asc). Returns (gains, positions) padded with (-inf, 0), the
    cuts, and whether the bound only rose."""
    lists, cuts, rising = [], 0, True
    for a in range(0, gains.size, split_docs):
        b = min(gains.size, a + split_docs)
        t = NEG_INF
        sg, sp = [], []                       # staged
        bg, bp = np.empty(0, np.float32), np.empty(0, np.int64)
        for s in range(a, b, STEP):
            g = gains[s:min(s + STEP, b)]
            keep = g > t               # NaN and -inf never pass
            sg.extend(g[keep].tolist())
            sp.extend(np.arange(s, s + g.size)[keep].tolist())
            if len(sg) > SB - STEP:
                bg = np.concatenate([bg, np.asarray(sg, np.float32)])
                bp = np.concatenate([bp, np.asarray(sp, np.int64)])
                sg, sp = [], []
                if bg.size > cap - SB:
                    bg, bp = _best(bg, bp, k + int(rng.integers(0, k // 2 + 1)))
                    cuts += 1
                    rising &= bool(bg.min() >= t)
                    t = float(bg.min())
        bg = np.concatenate([bg, np.asarray(sg, np.float32)])
        bp = np.concatenate([bp, np.asarray(sp, np.int64)])
        lists.append(_best(bg, bp, k))
    g = np.concatenate([x[0] for x in lists])
    p = np.concatenate([x[1] for x in lists])
    g, p = _best(g, p, k)
    pad = k - g.size
    g = np.concatenate([g, np.full(pad, NEG_INF, np.float32)])
    p = np.concatenate([p, np.zeros(pad, np.int64)])
    return g, p, cuts, rising


@pytest.mark.parametrize("k,split_docs,splits", [
    (65, 3 * 192, 12), (128, 8 * 192, 12), (256, 8 * 192, 12),
    (1100, 48 * 192, 6)])
def test_fold_model_gives_the_stable_top_k(k, split_docs, splits):
    """Gains on a 1/2 grid in [-20, 20] (ties by the hundred, across steps,
    splits and the k cut), 2% -inf, 1% NaN, a row of -inf past its first
    k / 2 docs and a row of one value: the model's lists equal the stable
    top-k with NaN read as -inf (index 0 past the finite entries)."""
    rng = np.random.default_rng(k)
    n = splits * split_docs + 77
    gains = (rng.integers(-40, 41, (5, n)) / 2).astype(np.float32)
    gains[rng.random((5, n)) < 0.02] = NEG_INF
    gains[rng.random((5, n)) < 0.01] = np.nan
    gains[1, k // 2:] = NEG_INF
    gains[2] = 1.5
    gains[3, ::7] = -0.0
    cap = deep_topk.fold_cap(k)
    t = torch.from_numpy(gains)
    want_g, want_i = topk_stable(torch.where(t.isnan(), NEG_INF, t), k)
    want_i = torch.where(torch.isneginf(want_g), 0, want_i)
    for r in range(gains.shape[0]):
        g, p, cuts, rising = _model_fold(gains[r], k, split_docs, cap, rng)
        assert rising
        np.testing.assert_array_equal(g, want_g[r].numpy())
        np.testing.assert_array_equal(p, want_i[r].numpy())
        # the rows of spread gains overflowed their buffers in every full
        # split (the first fill at least)
        if r in (0, 3, 4):
            assert cuts >= splits, (r, cuts, splits)
