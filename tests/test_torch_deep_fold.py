"""K1's deep fold (lists past 64 on the wgmma scan), on the CPU.

The fold runs only on a card (``csrc/fused_topk.cu``, ``wgmma_topk_kernel``
with ``DEEP``; its exact cases are in ``tests/test_torch_kernel.py``). Here
its plan and its arithmetic are checked without one:

* ``ops/fused_topk.py::_plan`` sends lists past 64 over bf16, int8 and int4
  docs to the fold at every shard size (the low-rank world's small shards
  as well as the coarse scans' large ones), keeps f32 docs and int4 rows off
  the 16-byte grid on the first design and the deep launch, and keeps the
  fold's workspace (every (row, split)'s candidate words, every row's
  sample words and running list) under ``deep_topk.WORKSPACE_CAP`` at B =
  2,048;
* a numpy model of the fold (the row's owner seeds a shared bound with the
  k-th best word of a strided sample; each split compares gains with the
  larger of that bound, read at every tile, and its own, admitting ties;
  each lane of a row's quad fills its quarter of the buffer, and a lane
  near its quarter cuts the buffer to its k best and up to k / 2 more,
  raising both bounds; after the scan the splits, in a random order, bring
  their words at or above the shared bound to the row's running list,
  which publishes its last word as the shared bound) equals the stable
  top-k over gains with many ties, -inf and NaN (which never enter, as in
  every kernel of the port), at k' = 65, 128, 256 and 1,100, and on rows
  whose k-th best ties across splits, with a -inf tail, all -inf, fewer
  finite gains than k', and splits of one tile.
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
    assert plan.cap == deep_topk.fold_cap(k, plan.tiles_per_split)
    assert plan.cap >= k + deep_topk.FOLD_SLACK
    n_tiles = -(-n // plan.tile_d)
    assert (plan.splits - 1) * plan.tiles_per_split < n_tiles
    assert plan.splits * plan.tiles_per_split >= n_tiles
    assert (deep_topk.fold_bytes(bsz, plan.splits, k, plan.tiles_per_split)
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
    """The low-rank world's three small shards (and one between them and
    pubmed's) no longer keep the deep launch: the fold takes them as it
    takes every shard size, one launch with no gains in device memory; the
    deep launch stays nameable for measurements. Their splits are short, so
    lists up to 128 get the wider buffer (no cut in the scan)."""
    plan = ft._plan(512, n, 128, k, BF16, SMS)
    assert plan.kernel == "fold"
    assert plan.cap == deep_topk.fold_cap(k, plan.tiles_per_split)
    assert (plan.cap == 2 * deep_topk.fold_cap(k)) == (
        k <= deep_topk.FOLD_WIDE_K
        and plan.tiles_per_split <= deep_topk.FOLD_SHORT_TILES)
    assert ft._plan(512, n, 128, k, BF16, SMS, "deep").kernel == "deep"
    for doc_type, d in ((I8, 128), (I4, 128), (I4G, 768)):
        assert ft._plan(512, n, d, k, doc_type, SMS).kernel == "fold"


@pytest.mark.parametrize("k", [64, deep_topk.FOLD_MAX_K + 1])
def test_the_fold_refuses_depths_outside_its_range(k):
    want = "wgmma" if k <= ft.SHALLOW_K else "deep"
    assert ft._plan(512, 734_003, 128, k, BF16, SMS).kernel == want
    with pytest.raises(ValueError, match="deep fold does not take"):
        ft._plan(512, 734_003, 128, k, BF16, SMS, "fold")


def test_a_small_cap_cuts_the_splits_and_then_takes_the_deep_launch():
    one = deep_topk.fold_bytes(512, 1, 256)
    rows = deep_topk.fold_bytes(512, 0, 256)   # the rows' sample and list
    plan = ft._plan(512, 734_003, 128, 256, BF16, SMS,
                    cap=rows + 3 * (one - rows))
    assert plan.kernel == "fold" and plan.splits <= 3
    assert ft._plan(512, 734_003, 128, 256, BF16, SMS,
                    cap=one - 1).kernel == "deep"


# ---- a model of the fold -----------------------------------------------------------

TILE = 192
SUB_ROOM = 4       # a lane adds at most 4 words to a row a step
F32_MAX = np.finfo(np.float32).max


def _words(g, pos):
    """The kernel's candidate words, order_key(gain) << 32 | ~position, as
    uint64; 0 for -inf and NaN (never a candidate). Larger words come first
    in the lists' order (gain desc, position asc); -0 keys as +0."""
    g = np.asarray(g, np.float32)
    u = np.where(g == 0, 0, g.view(np.uint32)).astype(np.uint64)
    key = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    low = ~np.asarray(pos).astype(np.uint64) & 0xFFFFFFFF
    return np.where(g >= -F32_MAX, (key << 32) | low, 0).astype(np.uint64)


def _gain(w):
    """The gain a word's key decodes to (the kernel's key_gain)."""
    key = (int(w) >> 32) & 0xFFFFFFFF
    u = key & 0x7FFFFFFF if key & 0x80000000 else ~key & 0xFFFFFFFF
    return float(np.array([u], np.uint32).view(np.float32)[0])


def _top(words, k):
    """The k largest words, largest first (the words are distinct)."""
    return np.sort(np.asarray(words, np.uint64))[::-1][:k]


def _model_fold(gains: np.ndarray, k: int, tiles_per_split: int, cap: int,
                sample_tiles: int, rng: np.random.Generator):
    """One row through the fold as the kernel runs it, in one of the orders
    its splits may take.

    The row's owner first keeps every finite gain of the sample's tiles
    (``sample_tiles`` of them, strided over the shard) and, with k of them
    or more, publishes their k-th best word as the row's shared bound.
    Each split then scans its tiles 16 docs a step: it reads the shared
    bound at every tile, and a gain at or above the larger of that and its
    own bound goes to its lane's part of the buffer (lane = the doc's place
    in its step, ``(doc % 8) // 2``); a lane near its quarter of ``cap``
    cuts the row's buffer to its k best and up to k / 2 more (here a random
    number), raising its own bound and the shared one to the least word
    kept, or, with fewer than k words in all, only packs it (its lanes'
    shares balanced, no bound raised). After the scan the splits, in a random order, keep their words at
    or above the shared bound, cut them to k, and merge them into the
    row's running list of k; a full running list publishes its last word
    as the shared bound; the split that counts last writes the row out.

    Returns (gains, positions) padded with (-inf, 0), the cuts in the scan,
    the words each split brought to the merge, and the packs in the
    scan."""
    n = gains.size
    n_tiles = -(-n // TILE)
    splits = -(-n_tiles // tiles_per_split)
    pos_all = np.arange(n)
    seed = 0
    # the owner's sample
    s_tiles = min(sample_tiles, n_tiles)
    if s_tiles:
        stride = n_tiles // s_tiles
        docs = np.concatenate([pos_all[t * TILE:(t + 1) * TILE]
                               for t in range(0, s_tiles * stride, stride)])
        w = _words(gains[docs], docs)
        w = w[w != 0]
        if w.size >= k:
            seed = max(seed, int(_top(w, k)[-1]))
    sub = cap // 4
    buffers, cuts, packs = [], 0, 0
    for s in range(splits):
        own_t = -F32_MAX
        lanes = [[] for _ in range(4)]
        for t in range(s * tiles_per_split,
                       min((s + 1) * tiles_per_split, n_tiles)):
            shared_t = _gain(seed) if seed else -F32_MAX
            for a in range(t * TILE, min((t + 1) * TILE, n), 16):
                thr = max(own_t, shared_t)
                for d in range(a, min(a + 16, n)):
                    g = gains[d]
                    if g >= thr and g >= -F32_MAX:     # NaN, -inf never pass
                        lanes[(d % 8) // 2].append(int(_words(g, d)))
                if max(len(x) for x in lanes) > sub - SUB_ROOM:
                    every = [w for x in lanes for w in x]
                    if len(every) < k:      # bounds nothing: packed only
                        packs += 1
                        lanes = [every[i::4] for i in range(4)]
                        continue
                    kept = _top(every, k + int(rng.integers(0, k // 2 + 1)))
                    cuts += 1
                    least = int(kept[-1])
                    own_t = max(own_t, _gain(least))
                    seed = max(seed, least)
                    lanes = [list(map(int, kept[i::4])) for i in range(4)]
        buffers.append([w for x in lanes for w in x])
    run, brought = np.zeros(0, np.uint64), []
    for c, s in enumerate(rng.permutation(splits)):
        mine = [w for w in buffers[s] if w >= seed]
        brought.append(len(mine))
        run = _top(np.concatenate([run, _top(mine, k)]), k)
        if run.size == k and c < splits - 1:
            seed = max(seed, int(run[-1]))
    g = np.array([_gain(w) for w in run], np.float32)
    p = np.array([~int(w) & 0xFFFFFFFF for w in run], np.int64)
    pad = k - g.size
    g = np.concatenate([g, np.full(pad, NEG_INF, np.float32)])
    p = np.concatenate([p, np.zeros(pad, np.int64)])
    return g, p, cuts, brought, packs


def _want(gains: np.ndarray, k: int):
    t = torch.from_numpy(gains)
    want_g, want_i = topk_stable(torch.where(t.isnan(), NEG_INF, t), k)
    return want_g, torch.where(torch.isneginf(want_g), 0, want_i)


@pytest.mark.parametrize("k,tiles,splits", [
    (65, 3, 12), (128, 8, 12), (256, 8, 12), (1100, 48, 6)])
def test_fold_model_gives_the_stable_top_k(k, tiles, splits):
    """Gains on a 1/2 grid in [-20, 20] (ties by the hundred, across steps,
    splits and the k cut), 2% -inf, 1% NaN, a row of -inf past its first
    k / 2 docs and a row of one value: the model's lists equal the stable
    top-k with NaN read as -inf (index 0 past the finite entries), with the
    sample the wrapper plans, and the running list's bound leaves the later
    splits fewer words than the first ones brought."""
    rng = np.random.default_rng(k)
    n = splits * tiles * TILE + 77
    gains = (rng.integers(-40, 41, (5, n)) / 2).astype(np.float32)
    gains[rng.random((5, n)) < 0.02] = NEG_INF
    gains[rng.random((5, n)) < 0.01] = np.nan
    gains[1, k // 2:] = NEG_INF
    gains[2] = 1.5
    gains[3, ::7] = -0.0
    want_g, want_i = _want(gains, k)
    for r in range(gains.shape[0]):
        g, p, _, brought, _ = _model_fold(gains[r], k, tiles,
                                       deep_topk.fold_cap(k, tiles),
                                       deep_topk.fold_sample_tiles(k), rng)
        np.testing.assert_array_equal(g, want_g[r].numpy())
        np.testing.assert_array_equal(p, want_i[r].numpy())
        if r == 0:
            assert sum(brought[-3:]) < sum(brought[:3]), brought


def _edge_row(case: str, k: int, rng: np.random.Generator) -> np.ndarray:
    n = 6 * TILE + 40
    if case == "ties at the k-th place across splits":
        # a handful of values only: the k-th best ties with hundreds of
        # gains in every split
        return rng.choice(np.float32([3.0, 2.5, 2.0]), n, p=[0.1, 0.3, 0.6])
    if case == "-inf padded tail":
        g = rng.standard_normal(n).astype(np.float32)
        g[n - 300:] = NEG_INF
        return g
    if case == "all -inf":
        return np.full(n, NEG_INF, np.float32)
    if case == "fewer valid docs than k'":
        g = np.full(n, NEG_INF, np.float32)
        g[rng.choice(n, k // 2, replace=False)] = rng.standard_normal(k // 2)
        return g
    if case == "passing gains at one lane of the quad":
        return _one_lane_row(n, rng)
    return (rng.integers(-6, 7, n) / 2).astype(np.float32)  # one-tile splits


def _one_lane_row(n: int, rng: np.random.Generator) -> np.ndarray:
    """Finite gains only at positions 0 and 1 mod 8 (a -inf bias elsewhere):
    every candidate of a row falls to lane 0 of its quad, which nears its
    quarter of the buffer while the row holds fewer than k words (a third
    of those docs -inf too, so that the lane's count is not a multiple of
    4 there). The gains fall along the row (three docs a value, a few
    swapped), so the words a split holds at that point are its best: a
    bound raised to the least of them would drop the rest of the row's top
    k."""
    g = np.full(n, NEG_INF, np.float32)
    at = np.flatnonzero((np.arange(n) % 8 < 2) & (rng.random(n) > 0.3))
    vals = -(np.arange(at.size) // 3) / 2
    swap = rng.choice(at.size - 1, at.size // 20, replace=False)
    vals[swap], vals[swap + 1] = vals[swap + 1], vals[swap]
    g[at] = vals.astype(np.float32)
    return g


@pytest.mark.parametrize("case,tiles", [
    ("ties at the k-th place across splits", 2),
    ("-inf padded tail", 2), ("all -inf", 2),
    ("fewer valid docs than k'", 2), ("splits of one tile", 1),
    ("passing gains at one lane of the quad", 2)])
@pytest.mark.parametrize("k", [65, 128])
def test_fold_model_edge_cases(case, tiles, k):
    """The model against the stable top-k on the rows the seeded bound must
    not break: the k-th best tied across splits (the compare admits ties;
    the words order them), a -inf tail, a row of -inf (no seed, nothing
    merged), fewer finite gains than k (no seed: the bound stays at the
    lowest finite gain), splits of one tile, candidates at one lane of the
    quad only (a buffer packed, not cut, below k words); with the wrapper's
    sample and with none, and with small buffers that cut often."""
    rng = np.random.default_rng(k + tiles)
    row = _edge_row(case, k, rng)
    want_g, want_i = _want(row[None], k)
    for sample, cap in ((deep_topk.fold_sample_tiles(k), deep_topk.fold_cap(
            k, tiles)), (0, deep_topk.fold_cap(k)), (2, k + 32)):
        g, p, _, _, _ = _model_fold(row, k, tiles, cap, sample, rng)
        np.testing.assert_array_equal(g, want_g[0].numpy(), err_msg=case)
        np.testing.assert_array_equal(p, want_i[0].numpy(), err_msg=case)


@pytest.mark.parametrize("k,tiles", [(128, deep_topk.FOLD_SHORT_TILES + 2),
                                     (256, 16)])
def test_fold_model_packs_one_lane_rows_without_a_bound(k, tiles):
    """Finite gains only at positions 0 and 1 mod 8 at the plan's buffers
    (4k: k' = 128 over splits of more than ``FOLD_SHORT_TILES`` tiles, and
    k' = 256): lane 0 nears its quarter of the buffer with fewer than k
    words in the row, which are packed and bound nothing; the lists equal
    the stable top-k, with the wrapper's sample and with none."""
    rng = np.random.default_rng(k + tiles)
    row = _one_lane_row(3 * tiles * TILE + 50, rng)
    want_g, want_i = _want(row[None], k)
    cap = deep_topk.fold_cap(k, tiles)
    assert cap == 4 * k
    for sample in (deep_topk.fold_sample_tiles(k), 0):
        g, p, cuts, _, packs = _model_fold(row, k, tiles, cap, sample, rng)
        assert packs > 0 and cuts > 0, (packs, cuts)
        np.testing.assert_array_equal(g, want_g[0].numpy())
        np.testing.assert_array_equal(p, want_i[0].numpy())
