"""Deep candidate lists (k past 160) against the JAX package (CPU).

``--refine-mult M`` asks the coarse scans for k' = M * k candidates, and the
TPU kernels take any depth: the fused top-k (``pallas_topk``), the streaming
top-k over stored gains (``pallas_stream_topk``) and the probed scan's
rank-capped winners (``_grouped_pair_topk``). Here the same numpy-seeded
inputs go through each of them in interpret mode, as the JAX package's own
tests run them off the TPU, and through the port's wrappers on CPU tensors
(their plain versions), at depths past 160; then the low-rank and hostrefine
engines of both packages at ``k_refine = 8 * k``. Values sit on a 1/8 grid,
so gains tie within and across the k' cut and every sum is exact: indices
and scores are equal, ties to the lower index. The engines are held to
equal winner ids with scores within 1e-5 relative.

The deep launch's plans (``ops/deep_topk.py``) are pure functions, checked
without a card: their runs, chunks and slices cover every position once,
their workspace stays under the cap, and a model of the launch's reduction
(each run cut to its best, lists merged in pairs and cut to k) gives the
stable top-k.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from ragroute_tpu.engine.streamed import StreamedSearchEngine as JEngine
from ragroute_tpu.index import streamed as jst
from ragroute_tpu.ops import grouped_topk as jgt
from ragroute_tpu.ops.pallas_topk import pallas_stream_topk, pallas_topk
from ragroute_tpu.router import RouterBank as JBank
from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine
from ragroute_tpu_torch.index import make_synthetic_world
from ragroute_tpu_torch.index.streamed import streamed_from_reference
from ragroute_tpu_torch.ops import deep_topk
from ragroute_tpu_torch.ops.fused_topk import fused_topk
from ragroute_tpu_torch.ops.grouped_topk import (PAIR_ROWS,
                                                 clustered_from_reference,
                                                 grouped_pair_topk, tiling)
from ragroute_tpu_torch.ops.stream_topk import MAX_SHALLOW_K, stream_topk
from ragroute_tpu_torch.ops.topk import topk_stable
from ragroute_tpu_torch.router import RouterBank
from test_torch_engine import _pair
from test_torch_streamed import _carry, _router

NEG_INF = float("-inf")


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _grid(rng, shape, lo=-8, hi=8):
    """Values on a 1/8 grid in [lo/8, hi/8]: exact in bf16, sums exact."""
    return (rng.integers(lo, hi + 1, shape) / 8.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the kernels' functions at deep depth -------------------------------------

@pytest.mark.parametrize("k", [161, 300])
@pytest.mark.parametrize("kind", ["bf16", "int8-scale", "inf-tail"])
def test_fused_topk_deep_matches_pallas(kind, k):
    rng = np.random.default_rng(k)
    n, d = 700, 64
    q = _grid(rng, (6, d), -2, 2)
    docs = _grid(rng, (n, d), -2, 2)
    docs[400:430] = docs[11]                 # ties across the kernel's tiles
    scale = bias = None
    if kind == "int8-scale":
        docs = rng.integers(-6, 7, (n, d)).astype(np.float32)
        scale = (2.0 ** rng.integers(-2, 2, n)).astype(np.float32)
    if kind == "inf-tail":
        bias = np.zeros(n, np.float32)
        bias[120:] = -np.inf                 # fewer finite gains than k
    jdt, tdt = ((jnp.int8, torch.int8) if kind == "int8-scale"
                else (jnp.bfloat16, torch.bfloat16))
    opt = lambda a, f: None if a is None else f(a)       # noqa: E731
    js, ji = pallas_topk(jnp.asarray(q), jnp.asarray(docs).astype(jdt), k,
                         scale=opt(scale, jnp.asarray),
                         bias=opt(bias, jnp.asarray))
    before = fused_topk.launches
    s, i = fused_topk(_t(q), _t(docs).to(tdt), k, scale=opt(scale, _t),
                      bias=opt(bias, _t))
    assert fused_topk.launches == before     # CPU tensors: the plain version
    assert s.shape == i.shape == (6, k)
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_array_equal(s.numpy(), js)
    valid = np.isfinite(js)
    np.testing.assert_array_equal(i.numpy()[valid], ji[valid])
    assert (i.numpy()[~valid] == 0).all()
    if kind == "inf-tail":
        assert (~valid).any()
    # ties straddle the cut: the k-th gain continues past it
    full = np.sort(np.asarray(q) @ docs.T, axis=1)[:, ::-1]
    if kind == "bf16":
        assert (full[:, k] == full[:, k - 1]).any()


@pytest.mark.parametrize("k", [161, 900])
def test_stream_topk_deep_matches_pallas(k):
    """k past 160 up to ``k = M``."""
    rng = np.random.default_rng(k)
    gains = _grid(rng, (7, 900), lo=-16, hi=16)
    gains[rng.random(gains.shape) < 0.1] = -np.inf
    gains[2] = -np.inf                       # a fully invalid row
    jg, jp = pallas_stream_topk(jnp.asarray(gains), k)
    tg, tp = stream_topk(_t(gains), k)
    assert k > MAX_SHALLOW_K
    jg, jp = np.asarray(jg), np.asarray(jp)
    np.testing.assert_array_equal(tg.numpy(), jg)
    valid = jg > NEG_INF
    np.testing.assert_array_equal(tp.numpy()[valid], jp[valid])
    assert (tp.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("s,kappa", [(384, 200), (1096, 400)])
def test_pair_topk_deep_ranks_match_the_pallas_kernel(s, kappa):
    """ranks = ceil(kappa / tiles) of 200 over one tile of 384 slots and
    200 a tile over two (1,024 + 72 slots); integer codes, rows and biases
    with power-of-two scales: every gain exact, so gains and slots are
    equal wherever the gain is finite."""
    rng = np.random.default_rng(s + kappa)
    c, r, g = 3, 32, 2
    docs = rng.integers(-4, 5, (c, r, s)).astype(np.int8)
    scale = (2.0 ** rng.integers(-2, 2, (c, s))).astype(np.float32)
    bias = -rng.integers(0, 20, (c, s)).astype(np.float32)
    bias[rng.random((c, s)) < 0.15] = -np.inf
    bias[2, :] = -np.inf                     # an empty cluster
    qd = rng.integers(-4, 5, (g * PAIR_ROWS, r)).astype(np.float32)
    blk = np.array([1, 2], np.int32)
    jcc = jgt.ClusteredCoarse(
        centroids=jnp.zeros((c, r)), cbias=jnp.zeros(c),
        docs=jnp.asarray(docs), bias=jnp.asarray(bias),
        scale=jnp.asarray(scale),
        perm=jnp.arange(c * s, dtype=jnp.int32).reshape(c, s),
        n_clusters=c, capacity=s)
    jg, ji = jgt._grouped_pair_topk(jnp.asarray(qd).astype(jnp.bfloat16),
                                    jcc, jnp.asarray(blk), kappa)
    jg, ji = np.asarray(jg), np.asarray(ji)
    tcc = clustered_from_reference(
        {f: np.asarray(getattr(jcc, f)) for f in (
            "centroids", "cbias", "docs", "bias", "scale", "perm")})
    tg, ti = grouped_pair_topk(_t(qd).to(torch.bfloat16), tcc, _t(blk),
                               kappa)
    _, n_tiles, ranks, kw = tiling(s, kappa)
    assert ranks > MAX_SHALLOW_K and tg.shape == jg.shape == (g * PAIR_ROWS,
                                                              kw)
    np.testing.assert_array_equal(tg.numpy(), jg)
    fin = np.isfinite(jg)
    np.testing.assert_array_equal(ti.numpy()[fin], ji[fin])
    assert np.isneginf(jg[PAIR_ROWS:]).all()


# -- the engines at k_refine = 8 k --------------------------------------------

def _same_winners(t, j):
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_array_equal(t.merged_valid, j.merged_valid)
    ok = j.merged_shard >= 0
    np.testing.assert_array_equal(t.merged_shard, j.merged_shard)
    np.testing.assert_array_equal(np.where(ok, t.merged_local, -1),
                                  np.where(ok, j.merged_local, -1))
    np.testing.assert_allclose(t.merged_score[ok], j.merged_score[ok],
                               rtol=1e-5, atol=0)


def test_lowrank_engine_at_refine_mult_8_matches_jax(tmp_path):
    syn, jeng, teng = _pair("medrag", dtype="bfloat16", impl="lowrank",
                            nq=16, docs=600, tmp_path=tmp_path, lowrank=-1,
                            engine_kw={"k_refine": 8 * 32})
    assert syn.world.k == 32 and teng.k_refine == 256 > MAX_SHALLOW_K
    embs = dict(syn.query_embs)
    for strategy in ("all", "ragroute"):
        _same_winners(teng.search(embs, strategy=strategy),
                      jeng.search(embs, strategy=strategy))


@pytest.mark.parametrize("cluster", [False, True])
def test_hostrefine_engine_at_refine_mult_8_matches_jax(cluster):
    """Flat and clustered coarse slabs (the clustered one probed at the
    engines' default nprobe and kappa), k' = 256 over 1,024-doc sources."""
    syn = make_synthetic_world("medrag", docs_per_source=1024,
                               num_queries=12, seed=8, with_payloads=False,
                               subclusters=8)
    params, router = _router(syn.world)
    jss = jst.StreamedShardSet.build(
        syn.world, syn.embeddings, dtype=jnp.int8, tier="hostrefine",
        hbm_budget_bytes=0, cluster_coarse=cluster)
    assert all((s.coarse_cl is not None) == cluster for s in jss.sources)
    jeng = JEngine(jss, params, JBank.create(syn.world, syn.centroids),
                   k_refine=8 * syn.world.k)
    teng = StreamedSearchEngine(
        streamed_from_reference(_carry(jss, "int8")), router,
        RouterBank.create(syn.world, syn.centroids),
        k_refine=8 * syn.world.k)
    assert teng.k_refine == 256
    embs = dict(syn.query_embs)
    for fetch in (False, True):      # global merge and per-source refine
        _same_winners(teng.search(embs, strategy="all",
                                  fetch_candidates=fetch),
                      jeng.search(embs, strategy="all",
                                  fetch_candidates=fetch))


# -- the deep launch's plans --------------------------------------------------

def _final_length(splits, kr, k):
    """Entries of a row's last list (``kr`` for one run)."""
    levels = deep_topk.list_levels(splits, kr, k)
    return levels[-1][1] if levels else kr


def _model_reduce(gains: torch.Tensor, run: int, kr: int, k: int, pos0=0):
    """The launch's reduction in plain torch: each run's kr best (stable),
    then lists merged in pairs and cut to k, a level at a time, as
    ``list_levels`` says; pads are (-inf, -1)."""
    rows, m = gains.shape
    lists = []
    for a in range(0, m, run):
        g, i = topk_stable(gains[:, a:a + run], min(kr, gains[:, a:a + run]
                                                    .shape[1]))
        g = torch.nn.functional.pad(g, (0, kr - g.shape[1]), value=NEG_INF)
        i = torch.nn.functional.pad(i + a + pos0, (0, kr - i.shape[1]),
                                    value=-1)
        lists.append((g, torch.where(torch.isneginf(g), -1, i)))
    for n_out, length in deep_topk.list_levels(len(lists), kr, k):
        nxt = []
        for p in range(n_out):
            pair = lists[2 * p:2 * p + 2]
            g = torch.cat([x[0] for x in pair], 1)
            i = torch.cat([x[1] for x in pair], 1)
            # (gain desc, index asc): pads (index -1) last among -inf
            key = torch.where(i < 0, torch.iinfo(torch.int64).max, i)
            order = torch.argsort(key, dim=1, stable=True)
            g, i = torch.gather(g, 1, order), torch.gather(i, 1, order)
            top, pos = topk_stable(g, g.shape[1])
            i = torch.gather(i, 1, pos)
            pad = length - top.shape[1]
            top = torch.nn.functional.pad(top[:, :length], (0, max(0, pad)),
                                          value=NEG_INF)
            i = torch.nn.functional.pad(i[:, :length], (0, max(0, pad)),
                                        value=-1)
            nxt.append((top, i))
        assert len(nxt) == n_out and all(x[0].shape[1] == length for x in nxt)
        lists = nxt
    assert len(lists) == 1
    return lists[0]


@pytest.mark.parametrize("m,k", [(900, 300), (20_003, 161), (20_003, 1100),
                                 (20_003, 20_003), (70_000, 2048)])
def test_reduction_model_gives_the_stable_top_k(m, k):
    """Ties on a 1/8 grid across runs and the cut: the plan's runs and
    merge levels keep exactly the stable top-k, in order."""
    rng = np.random.default_rng(m + k)
    gains = _t(_grid(rng, (3, m), lo=-40, hi=40))
    gains[1, ::3] = NEG_INF
    p = deep_topk.stream_plan(3, m, k)
    assert p.kr == min(k, p.run)
    g, i = _model_reduce(gains, p.run, p.kr, k)
    assert g.shape[1] == _final_length(p.splits, p.kr, k) >= k
    want_g, want_i = topk_stable(gains, k)
    np.testing.assert_array_equal(g[:, :k].numpy(), want_g.numpy())
    fin = torch.isfinite(want_g)
    np.testing.assert_array_equal(i[:, :k][fin].numpy(),
                                  want_i[fin].numpy())


def _spans(total, step):
    return [(a, min(a + step, total)) for a in range(0, total, step)]


def _covers(spans, total, limit=None):
    assert spans[0][0] == 0 and spans[-1][1] == total
    assert all(b > a for a, b in spans)
    assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
    if limit is not None:
        assert all(b - a <= limit for a, b in spans)


@pytest.mark.parametrize("bsz", [1, 8, 64, 512, 2048])
@pytest.mark.parametrize("n_rows", [161, 8192, 20_000, 734_003, 2_936_320,
                                    6_000_000])
@pytest.mark.parametrize("k", [161, 256, 1100, 2048])
def test_fused_plan_covers_every_doc_and_fits_the_cap(bsz, n_rows, k):
    if k > n_rows:
        k = n_rows
    p = deep_topk.fused_plan(bsz, n_rows, k)
    assert p == deep_topk.fused_plan(bsz, n_rows, k)          # pure
    assert p.workspace_bytes <= deep_topk.WORKSPACE_CAP
    assert 1 <= p.rows <= bsz and p.chunk <= deep_topk.MAX_CHUNK
    assert p.chunk <= deep_topk.RUN or p.chunk % deep_topk.RUN == 0
    _covers(_spans(bsz, p.rows), bsz)                         # row slices
    chunks = _spans(n_rows, p.chunk)
    _covers(chunks, n_rows, p.chunk)
    for a, b in chunks:                                       # runs
        _covers(_spans(b - a, deep_topk.RUN), b - a, deep_topk.RUN)
        assert deep_topk.list_entries(-(-(b - a) // deep_topk.RUN), p.kr,
                                      k) <= p.entries
    # the gain kernel's grid.y and one chunk's doc tiles of 64
    assert -(-p.chunk // 64) <= 65535


@pytest.mark.parametrize("bsz,m,k", [
    (512, 4096, 256), (64, 16_384, 256), (512, 131_072, 256), (9, 20_003, 161),
    (9, 20_003, 20_003), (37, 5000, 5000), (2048, 1_000_000, 2048),
    (3, 8192, 8192), (3, 8193, 8193)])
def test_stream_plan_covers_every_position_and_fits_the_cap(bsz, m, k):
    p = deep_topk.stream_plan(bsz, m, k)
    assert p == deep_topk.stream_plan(bsz, m, k)
    runs = _spans(m, p.run)
    assert len(runs) == p.splits and p.run <= deep_topk.RUN
    _covers(runs, m, deep_topk.RUN)
    _covers(_spans(bsz, p.rows), bsz)
    if p.splits == 1:
        assert p.entries == 0 and p.workspace_bytes == 0
    if k <= 2048:
        assert p.workspace_bytes <= deep_topk.WORKSPACE_CAP
    # the probed collect at k' = 256 is one select launch a row
    assert deep_topk.stream_plan(512, 4096, 256).splits == 1


@pytest.mark.parametrize("n_blocks,s,kappa", [(6, 72, 200), (6, 1096, 512),
                                              (1200, 568, 256),
                                              (5000, 1584, 2048),
                                              (20_000, 4700, 2048)])
def test_pair_plan_covers_every_block_and_fits_the_cap(n_blocks, s, kappa):
    tds, n_tiles, ranks, kw = tiling(s, kappa)
    p = deep_topk.pair_plan(n_blocks, s, tds, ranks, kw)
    assert p == deep_topk.pair_plan(n_blocks, s, tds, ranks, kw)
    _covers(_spans(n_blocks, p.blocks), n_blocks)
    _covers(_spans(s, tds), s, tds)                            # the tiles
    assert p.entries == deep_topk.list_entries(n_tiles, ranks, kw)
    assert p.workspace_bytes <= deep_topk.WORKSPACE_CAP
    assert _final_length(n_tiles, ranks, kw) == kw


def test_list_levels_halve_and_cut():
    assert deep_topk.list_levels(1, 256, 256) == []
    assert deep_topk.list_levels(5, 100, 300) == [(3, 200), (2, 300),
                                                  (1, 300)]
    assert deep_topk.list_entries(5, 100, 300) == 600
    assert _final_length(1, 256, 256) == 256
    assert deep_topk.list_entries(1, 256, 256) == 0


def test_jax_is_on_the_cpu():
    assert jax.default_backend() == "cpu"
