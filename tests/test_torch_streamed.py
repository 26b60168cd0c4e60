"""The host-RAM capacity tiers of the port against the JAX package (CPU).

Builds: the host side of both packages is numpy with the same arithmetic, so
host codes, scales, biases, centres, ``n_res``, the slab layout and the
coarse slab are bit-equal (no tolerance); bf16 rows are compared as their
uint16 bit patterns. ``refine`` / ``refine_flat`` are numpy in both
packages: exact equality on the same candidates.

Engines: ``tier="stream"`` scans the same bytes as the flat engine, so ids,
their order and the valid counts are equal and scores agree within 2e-4
(f32 sums in another order over slabs). ``tier="hostrefine"`` is held to
the JAX ``StreamedSearchEngine`` on a shard set carried across as numpy:
merged ids equal position by position, except where the two scores at that
position are within 2e-4 (relative, plus 2e-4 absolute) of each other (a
near-tie either summation order may break), and every returned score equals
the flat engine's exact stored-form score for that doc within the same.
"""

import asyncio

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from ragroute_tpu.engine.streamed import StreamedSearchEngine as JEngine
from ragroute_tpu.index import streamed as jst
from ragroute_tpu.index import synthetic as jsyn
from ragroute_tpu.router import RouterBank as JBank
from ragroute_tpu.router import init_router_params
from ragroute_tpu_torch.engine import FederatedSearchEngine
from ragroute_tpu_torch.engine.batcher import QueryBatcher
from ragroute_tpu_torch.engine.engine import build_payload_tables
from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.index import streamed as tst
from ragroute_tpu_torch.index import synthetic as tsyn
from ragroute_tpu_torch.index.streamed import (RowSource, StreamedShardSet,
                                               _water_fill,
                                               streamed_from_reference)
from ragroute_tpu_torch.router import (CorpusRouter, RouterBank,
                                       params_from_jax)

TOL = 2e-4
FEB4RAG_SMALL = {"trec-covid": 512}     # docs of the one 4096-d source
JDT = {"int8": jnp.int8, "int4": "int4", "bfloat16": jnp.bfloat16,
       "float32": jnp.float32}
TDT = {"int8": torch.int8, "int4": "int4", "bfloat16": torch.bfloat16,
       "float32": torch.float32}


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _np(a):
    """A device array of either package as numpy (bf16 as uint16 bits)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _row_bytes(d, dtype):
    return (d // 2 if dtype == "int4"
            else d * jnp.dtype(JDT[dtype]).itemsize) + 8


def _router(world, key=0):
    params = init_router_params(jax.random.key(key), world.router_input_dim)
    router = CorpusRouter(world.router_input_dim)
    router.load_state_dict(params_from_jax(params))
    return params, router.eval()


def _carry(jss, dtype):
    """A JAX ``StreamedShardSet`` as the numpy mapping
    ``streamed_from_reference`` takes."""
    srcs = []
    for s in jss.sources:
        f = {k: getattr(s, k) for k in (
            "name", "score_mode", "encoder", "embed_dim", "n_docs", "n_res",
            "host_row0", "slab_rows", "n_slabs", "rank")}
        f["center"] = s.center
        for k in ("res_docs", "res_bias", "res_scale", "basis", "mu_lr",
                  "coarse_docs", "coarse_scale", "coarse_bias"):
            f[k] = _np(getattr(s, k))
        if s.host is not None:
            f["host_codes"] = _np(s.host.codes)
            f["host_bias"] = s.host.bias
            f["host_scale"] = s.host.scale
        if s.coarse_cl is not None:
            f["coarse_cl"] = {k: np.asarray(getattr(s.coarse_cl, k)) for k in (
                "centroids", "cbias", "docs", "bias", "scale", "perm")}
        srcs.append(f)
    return {"world": jss.world.name, "tier": jss.tier,
            "packed4": jss.packed4, "dtype_name": dtype, "sources": srcs}


# -- build -----------------------------------------------------------------------

def test_water_fill_equals_the_jax_rule():
    for sizes, budget in (([100, 50, 400], 300), ([10, 10, 10], 1000),
                          ([500, 500], 0), ([7, 900, 30, 30], 200), ([5], 3)):
        assert _water_fill(sizes, budget) == jst._water_fill(sizes, budget)
    assert _water_fill([100, 50, 400], 300) == [100, 50, 150]


@pytest.mark.parametrize("dtype", ["int8", "int4", "bfloat16"])
def test_build_is_bit_equal_to_the_jax_build(dtype, monkeypatch):
    """Both tiers, with build blocks of 300 rows so that blocks straddle
    the resident boundary: every stored array equals the JAX build's."""
    monkeypatch.setattr(jst, "_BUILD_BLOCK", 300)
    monkeypatch.setattr(tst, "_BUILD_BLOCK", 300)
    world_name = "wikipedia" if dtype == "int8" else "medrag"   # l2 | dot
    syn = make_synthetic_world(world_name, docs_per_source=1600,
                               num_queries=4, seed=11, with_payloads=False)
    row_b = _row_bytes(syn.world.sources[0].embed_dim, dtype)
    n_src = syn.world.num_sources
    for tier, budget, rank in (("stream", 300 * row_b * n_src, None),
                               ("hostrefine", 0, 24)):
        kw = dict(tier=tier, hbm_budget_bytes=budget, slab_bytes=256 * row_b,
                  rank=rank)
        a = jst.StreamedShardSet.build(syn.world, syn.embeddings,
                                       dtype=JDT[dtype], **kw)
        b = StreamedShardSet.build(syn.world, syn.embeddings,
                                   dtype=TDT[dtype], **kw)
        assert b.packed4 == a.packed4 and b.tier == a.tier
        assert b.index_bytes > 0 and b.host_bytes == a.host_bytes
        for sa, sb in zip(a.sources, b.sources):
            for f in ("name", "score_mode", "n_docs", "n_res", "host_row0",
                      "slab_rows", "n_slabs", "rank"):
                assert getattr(sb, f) == getattr(sa, f), f
            if tier == "stream":
                assert sb.n_res == 512 and sb.n_slabs == 3
            for f in ("center", "res_docs", "res_bias", "res_scale", "mu_lr"):
                x, y = _np(getattr(sa, f)), _np(getattr(sb, f))
                assert (x is None) == (y is None), f
                if x is not None:
                    np.testing.assert_array_equal(y, x, err_msg=f)
            np.testing.assert_array_equal(sb.host.codes, _np(sa.host.codes))
            np.testing.assert_array_equal(sb.host.bias, sa.host.bias)
            assert (sb.host.scale is None) == (sa.host.scale is None)
            if sa.host.scale is not None:
                np.testing.assert_array_equal(sb.host.scale, sa.host.scale)
            # the upload views share the host rows' memory
            assert sb.host.tensors[0].data_ptr() == sb.host.codes.ctypes.data
            if tier == "hostrefine":
                r = sa.rank
                assert sb.basis.shape[1] == sb.coarse_docs.shape[1] == 32
                np.testing.assert_array_equal(_np(sb.basis)[:, :r],
                                              _np(sa.basis))
                np.testing.assert_array_equal(_np(sb.coarse_docs)[:, :r],
                                              _np(sa.coarse_docs))
                assert (_np(sb.coarse_docs)[:, r:] == 0).all()
                for f in ("coarse_scale", "coarse_bias"):
                    np.testing.assert_array_equal(_np(getattr(sb, f)),
                                                  _np(getattr(sa, f)))


def test_row_source_generator_blocks():
    """The block-streamed synthetic generator gives both packages the same
    rows, and a generator-backed ``RowSource`` builds the tier an in-RAM
    array builds."""
    sizes = {"pubmed": 70_000, "statpearls": 600, "textbooks": 600,
             "wikipedia": 600}
    a = jsyn.make_streamed_world("medrag", docs_per_source_map=sizes,
                                 num_queries=8, seed=3, subclusters=4)
    b = tsyn.make_streamed_world("medrag", docs_per_source_map=sizes,
                                 num_queries=8, seed=3, subclusters=4)
    assert isinstance(b.row_sources["pubmed"], RowSource)
    for lo, hi in ((0, 100), (65_500, 65_600), (69_990, 70_000)):
        np.testing.assert_array_equal(b.row_sources["pubmed"].get(lo, hi),
                                      a.row_sources["pubmed"].get(lo, hi))
    for enc in b.query_embs:
        np.testing.assert_array_equal(b.query_embs[enc], a.query_embs[enc])
    np.testing.assert_array_equal(b.relevant, a.relevant)
    for name in sizes:
        np.testing.assert_array_equal(b.centroids[name], a.centroids[name])

    syn = make_synthetic_world("medrag", docs_per_source=1024, num_queries=8,
                               seed=3, with_payloads=False)
    name = syn.world.sources[0].name
    arr = syn.embeddings[name]
    row_sources = dict(syn.embeddings)
    row_sources[name] = RowSource(
        n_docs=arr.shape[0], dim=arr.shape[1],
        get=lambda lo, hi: np.asarray(arr[lo:hi], np.float32))
    kw = dict(dtype=torch.int8, tier="stream", hbm_budget_bytes=1 << 20)
    x = StreamedShardSet.build(syn.world, syn.embeddings, **kw)
    y = StreamedShardSet.build(syn.world, row_sources, **kw)
    assert x.sources[0].host is not None
    assert torch.equal(x.sources[0].res_docs, y.sources[0].res_docs)
    np.testing.assert_array_equal(x.sources[0].host.codes,
                                  y.sources[0].host.codes)


def test_load_streams_from_the_saved_world(tmp_path):
    syn = make_synthetic_world("medrag", docs_per_source=600, num_queries=4,
                               seed=2)
    tsyn.save_world(syn, str(tmp_path))
    kw = dict(dtype="int8", tier="hostrefine", hbm_budget_bytes=0, rank=16)
    a = StreamedShardSet.load(str(tmp_path), syn.world, **kw)
    b = StreamedShardSet.build(syn.world, syn.embeddings, **kw)
    assert a.doc_ids["pubmed"] == syn.doc_ids["pubmed"]
    assert [s.n_docs for s in a.shards] == [600] * 4 == [
        s.n_docs for s in b.shards]
    assert a.total_docs == 2400 and a.device.type == "cpu"
    for sa, sb in zip(a.sources, b.sources):
        np.testing.assert_array_equal(sa.host.codes, sb.host.codes)
        assert torch.equal(sa.coarse_docs, sb.coarse_docs)
    # rows given for a source stand in for its file: the other sources
    # still load from theirs, and no file is asked for where all are given
    other = np.ascontiguousarray(syn.embeddings["pubmed"][::-1])
    c = StreamedShardSet.load(str(tmp_path), syn.world,
                              row_sources={"pubmed": other}, **kw)
    assert c.doc_ids["pubmed"] == syn.doc_ids["pubmed"]
    want = StreamedShardSet.build(
        syn.world, {**syn.embeddings, "pubmed": other}, **kw)
    for sc, sw in zip(c.sources, want.sources):
        np.testing.assert_array_equal(sc.host.codes, sw.host.codes)
    assert not np.array_equal(c.sources[0].host.codes,
                              a.sources[0].host.codes)
    d = StreamedShardSet.load(str(tmp_path / "nope"), syn.world,
                              row_sources=syn.embeddings, **kw)
    np.testing.assert_array_equal(d.sources[1].host.codes,
                                  b.sources[1].host.codes)
    with pytest.raises(FileNotFoundError):
        StreamedShardSet.load(str(tmp_path / "nope"), syn.world, **kw)
    with pytest.raises(ValueError, match="tier"):
        StreamedShardSet.build(syn.world, syn.embeddings, tier="other")


@pytest.mark.parametrize("world_name,dtype", [("medrag", "int8"),
                                              ("medrag", "int4"),
                                              ("wikipedia", "int8"),
                                              ("feb4rag", "bfloat16")])
def test_refine_and_refine_flat_equal_the_jax_methods(world_name, dtype):
    # (the 4096-d feb4rag source stays at 512 docs, resident and without a
    # coarse build: its 4096 x 4096 eigh would cost more than the test)
    syn = make_synthetic_world(world_name, docs_per_source=600, num_queries=6,
                               seed=4, with_payloads=False,
                               docs_per_source_map=FEB4RAG_SMALL)
    a = jst.StreamedShardSet.build(syn.world, syn.embeddings,
                                   dtype=JDT[dtype], tier="hostrefine",
                                   hbm_budget_bytes=0, rank=16)
    b = streamed_from_reference(_carry(a, dtype))
    rng = np.random.default_rng(0)
    for si in (0, len(a.sources) - 1):
        assert a.sources[si].host is not None
        src = syn.world.sources[si]
        q = syn.query_embs[src.encoder]
        cand = rng.integers(-3, 640, (q.shape[0], 48)).astype(np.int32)
        cand[:, 5] = cand[:, 4]                      # a duplicate candidate
        js, ji = a.refine(si, q, cand, syn.world.k)
        ts, ti = b.refine(si, q, cand, syn.world.k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
        flat = rng.integers(-2, 620, 500).astype(np.int32)
        fq = rng.integers(0, q.shape[0], 500)
        np.testing.assert_array_equal(
            b.refine_flat(si, q, flat, fq, chunk=128),
            a.refine_flat(si, q, flat, fq, chunk=128))


# -- the stream tier ---------------------------------------------------------------

def _port_world(world_name, dtype, tier, *, docs=1024, nq=16, seed=5,
                budget_rows=0, sizes=None, **kw):
    syn = make_synthetic_world(world_name, docs_per_source=docs,
                               docs_per_source_map=sizes, num_queries=nq,
                               seed=seed, with_payloads=False)
    _, router = _router(syn.world)
    bank = RouterBank.create(syn.world, syn.centroids)
    ref = FederatedSearchEngine(
        ShardSet.build(syn.world, syn.embeddings, dtype=TDT[dtype]), router,
        bank)
    row_b = _row_bytes(syn.world.sources[0].embed_dim, dtype)
    kw.setdefault("hbm_budget_bytes",
                  budget_rows * row_b * syn.world.num_sources)
    if tier == "stream":
        kw.setdefault("slab_bytes", 256 * row_b)
    sset = StreamedShardSet.build(syn.world, syn.embeddings,
                                  dtype=TDT[dtype], tier=tier, **kw)
    return syn, ref, sset, router, bank


def _outputs_equal(a, b):
    np.testing.assert_array_equal(a.mask, b.mask)
    ok = a.merged_shard >= 0
    np.testing.assert_array_equal(a.merged_shard, b.merged_shard)
    np.testing.assert_array_equal(np.where(ok, a.merged_local, -1),
                                  np.where(ok, b.merged_local, -1))
    np.testing.assert_array_equal(a.merged_valid, b.merged_valid)
    np.testing.assert_allclose(np.where(ok, a.merged_score, 0.0),
                               np.where(ok, b.merged_score, 0.0),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("world_name,dtype", [
    ("medrag", "int8"),          # dot, mean-centred int8
    ("medrag", "int4"),          # packed nibbles through the slab scan
    ("wikipedia", "int8"),       # l2 (centred queries, exact bias)
    ("feb4rag", "bfloat16"),     # heterogeneous dims, cos + dot
])
def test_stream_tier_matches_flat_engine(world_name, dtype):
    syn, ref, sset, router, bank = _port_world(world_name, dtype, "stream",
                                               docs=1600)
    assert all(s.n_slabs >= 2 for s in sset.sources)
    eng = StreamedSearchEngine(sset, router, bank)
    assert not eng.supports_pipelined_dispatch
    embs = dict(syn.query_embs)
    for strategy in ("ragroute", "all"):
        a = ref.search(embs, strategy=strategy, staged=False)
        b = eng.search(embs, strategy=strategy)
        _outputs_equal(a, b)
    # routing "all": every per-source list is defined
    np.testing.assert_array_equal(a.shard_ids, b.shard_ids)
    np.testing.assert_allclose(a.shard_scores, b.shard_scores, rtol=TOL,
                               atol=TOL)
    assert eng.last_phases["slabs"] == sum(s.n_slabs for s in sset.sources)
    assert eng.last_phases["h2d_bytes"] == sset.host_bytes
    # slabs of a shard no query routes to are skipped
    none = eng.search(embs, strategy="none")
    assert eng.last_phases["slabs"] == 0 and (none.merged_valid == 0).all()
    done = eng.search_submit(embs, strategy="all", fetch_candidates=False)
    _outputs_equal(ref.search(embs, strategy="all"), done.wait())


def test_streamed_mixed_residency():
    """Sources that fit the budget stay fully resident (exact); the large
    one streams: both in one world, and the outputs still match."""
    sizes = {"pubmed": 2048, "statpearls": 512, "textbooks": 512,
             "wikipedia": 1024}
    row_b = 768 + 8
    syn, ref, sset, router, bank = _port_world(
        "medrag", "int8", "stream", sizes=sizes, seed=7,
        hbm_budget_bytes=(512 * 3 + 1024) * row_b, slab_bytes=512 * row_b)
    assert [s.host is None for s in sset.sources] == [False, True, True, True]
    eng = StreamedSearchEngine(sset, router, bank)
    embs = dict(syn.query_embs)
    for strategy in ("all", "ragroute"):
        _outputs_equal(ref.search(embs, strategy=strategy),
                       eng.search(embs, strategy=strategy))


# -- the hostrefine tier against the JAX engine ---------------------------------------

@pytest.fixture(scope="module")
def hostrefine_pair():
    """One world, the JAX engine and the port's on the carried-across shard
    set (mixed residency: two exact resident sources, two coarse + host)."""
    torch.set_num_threads(1)
    sizes = {"pubmed": 1024, "statpearls": 512, "textbooks": 1024,
             "wikipedia": 512}
    syn = make_synthetic_world("medrag", docs_per_source_map=sizes,
                               num_queries=16, seed=7, with_payloads=False)
    params, router = _router(syn.world)
    with threadpool_limits(limits=1):
        jss = jst.StreamedShardSet.build(
            syn.world, syn.embeddings, dtype=jnp.int8, tier="hostrefine",
            hbm_budget_bytes=2 * 512 * (768 + 8) + 1024)
    assert [s.coarse_docs is None for s in jss.sources] == [
        False, True, False, True]
    jeng = JEngine(jss, params, JBank.create(syn.world, syn.centroids))
    tss = streamed_from_reference(_carry(jss, "int8"))
    bank = RouterBank.create(syn.world, syn.centroids)
    teng = StreamedSearchEngine(tss, router, bank)
    flat = FederatedSearchEngine(
        ShardSet.build(syn.world, syn.embeddings, dtype=torch.int8), router,
        bank)
    return syn, jeng, teng, flat


def _assert_same_merged(t, j):
    """Position by position; a differing entry must be a near-tie."""
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_array_equal(t.merged_valid, j.merged_valid)
    for r in range(t.merged_shard.shape[0]):
        tk = list(zip(t.merged_shard[r], t.merged_local[r]))
        jk = list(zip(j.merged_shard[r], j.merged_local[r]))
        for p, (a, b) in enumerate(zip(tk, jk)):
            if a[0] < 0 and b[0] < 0:
                continue
            tol = TOL * (1.0 + abs(j.merged_score[r, p]))
            assert abs(t.merged_score[r, p] - j.merged_score[r, p]) <= tol
            if a != b:
                assert a in jk or abs(t.merged_score[r, p]
                                      - j.merged_score[r, -1]) <= tol


def _assert_exact_scores(out, flat_out):
    """Every returned winner carries the flat engine's exact stored-form
    score for that doc."""
    seen = 0
    for q in range(out.merged_shard.shape[0]):
        for j in range(out.merged_shard.shape[1]):
            si, li = int(out.merged_shard[q, j]), int(out.merged_local[q, j])
            if si < 0:
                continue
            pos = np.nonzero(flat_out.shard_ids[q, si] == li)[0]
            if len(pos):
                seen += 1
                np.testing.assert_allclose(
                    out.merged_score[q, j],
                    flat_out.shard_scores[q, si, pos[0]], rtol=TOL, atol=TOL)
    assert seen > out.merged_shard.shape[0]


@pytest.mark.parametrize("strategy", ["ragroute", "all"])
def test_hostrefine_matches_the_jax_engine(hostrefine_pair, strategy):
    syn, jeng, teng, flat = hostrefine_pair
    assert teng.supports_pipelined_dispatch
    embs = dict(syn.query_embs)
    j = jeng.search(embs, strategy=strategy, fetch_candidates=False)
    t = teng.search(embs, strategy=strategy, fetch_candidates=False)
    _assert_same_merged(t, j)
    assert t.selection_time == 0.0 and t.shard_scores is None
    # the message-size ids are the coarse-ordered ids of both packages
    np.testing.assert_array_equal(t.shard_ids, j.shard_ids)
    assert set(teng.last_phases) == {"device_and_fetch_s", "refine_merge_s"}
    a = flat.search(embs, strategy=strategy, fetch_candidates=True)
    _assert_exact_scores(t, a)
    hits = tot = 0
    for q in range(a.merged_shard.shape[0]):
        want = {(int(s), int(l)) for s, l in zip(
            a.merged_shard[q], a.merged_local[q]) if s >= 0}
        got = {(int(s), int(l)) for s, l in zip(
            t.merged_shard[q], t.merged_local[q]) if s >= 0}
        hits += len(want & got)
        tot += len(want)
    assert hits >= 0.95 * tot


def test_hostrefine_device_message_sizes_match_jax(hostrefine_pair):
    """With payload tables the ``[B, N]`` sizes come from the device, from
    the coarse-ordered ids, as in the JAX engine."""
    syn, jeng, teng, _ = hostrefine_pair
    rng = np.random.default_rng(1)
    per = [(rng.integers(20, 90, s.n_docs).astype(np.int32),
            rng.integers(5, 12, s.n_docs).astype(np.int32))
           for s in teng.shard_set.shards]
    names = [s.name for s in syn.world.sources]
    embs = dict(syn.query_embs)
    jeng.set_payload_tables(per, names)
    teng.set_payload_tables(per, names)
    try:
        j = jeng.search(embs, strategy="all", fetch_candidates=False)
        t = teng.search(embs, strategy="all", fetch_candidates=False)
    finally:
        jeng.set_payload_tables(None, names)
        teng.set_payload_tables(None, names)
    assert t.shard_ids is None and j.shard_ids is None
    np.testing.assert_array_equal(t.msg_base, j.msg_base)


def test_dispatch_complete_interleaved_and_search_submit(hostrefine_pair):
    """Two batches in flight complete with the outputs of two blocking
    searches; ``search_submit`` defers the completion the same way."""
    syn, _, teng, _ = hostrefine_pair
    embs = dict(syn.query_embs)
    half = {e: v[:8] for e, v in embs.items()}
    other = {e: v[8:] for e, v in embs.items()}
    seq = [teng.search(x, strategy="all", fetch_candidates=False)
           for x in (half, other)]
    h1 = teng.dispatch_hostrefine(half, strategy="all",
                                  fetch_candidates=False)
    h2 = teng.dispatch_hostrefine(other, strategy="all",
                                  fetch_candidates=False)
    outs = [teng.complete_hostrefine(h1), teng.complete_hostrefine(h2)]
    pend = teng.search_submit(half, strategy="all", fetch_candidates=False)
    outs.append(pend.wait())
    with pytest.raises(RuntimeError, match="twice"):
        pend.wait()
    for want, got in zip(seq + seq[:1], outs):
        np.testing.assert_array_equal(want.merged_shard, got.merged_shard)
        np.testing.assert_array_equal(want.merged_local, got.merged_local)
        np.testing.assert_array_equal(want.merged_score, got.merged_score)


def test_hostrefine_per_source_mode_feb4rag():
    """feb4rag (the qrels world) takes per-source candidates and refines
    per source; per-source top-k recall against the flat engine is high
    and the per-source lists carry exact scores."""
    syn, ref, sset, router, bank = _port_world(
        "feb4rag", "bfloat16", "hostrefine", docs=768, nq=8,
        sizes=FEB4RAG_SMALL)
    assert sum(s.host is not None for s in sset.sources) == 12
    eng = StreamedSearchEngine(sset, router, bank)
    embs = dict(syn.query_embs)
    a = ref.search(embs, strategy="all", fetch_candidates=True)
    b = eng.search(embs, strategy="all", fetch_candidates=True)
    hits = 0
    for q in range(a.shard_ids.shape[0]):
        for si in range(a.shard_ids.shape[1]):
            hits += len(set(a.shard_ids[q, si].tolist())
                        & set(b.shard_ids[q, si].tolist()))
    assert hits >= 0.95 * a.shard_ids.size
    same = a.shard_ids == b.shard_ids
    np.testing.assert_allclose(b.shard_scores[same], a.shard_scores[same],
                               rtol=TOL, atol=TOL)


def test_fully_resident_world_takes_the_per_source_path():
    """Every source fits the budget: no coarse slab exists, the global cut
    has nothing to concatenate, and the engine answers from the exact
    resident lists."""
    syn, ref, sset, router, bank = _port_world(
        "medrag", "int8", "hostrefine", docs=512, hbm_budget_bytes=1 << 30)
    assert all(s.host is None and s.coarse_docs is None
               for s in sset.sources)
    eng = StreamedSearchEngine(sset, router, bank)
    embs = dict(syn.query_embs)
    for fetch in (False, True):
        _outputs_equal(ref.search(embs, strategy="ragroute"),
                       eng.search(embs, strategy="ragroute",
                                  fetch_candidates=fetch))


def test_hostrefine_refine_depth_exceeds_slab():
    """k' beyond a coarse slab's height clamps per source and pads with
    never-wins sentinels; the coarse cut then keeps everything and the
    exact rescore reproduces the flat engine."""
    sizes = {"pubmed": 1024, "statpearls": 512, "textbooks": 512,
             "wikipedia": 512}
    syn, ref, sset, router, bank = _port_world(
        "medrag", "int8", "hostrefine", sizes=sizes, seed=9, nq=12)
    eng = StreamedSearchEngine(sset, router, bank, k_refine=1100)
    embs = dict(syn.query_embs)
    for fetch in (False, True):      # global merge AND per-source refine
        _outputs_equal(ref.search(embs, strategy="all"),
                       eng.search(embs, strategy="all",
                                  fetch_candidates=fetch))


def test_message_size_ids_are_clamped_on_both_coarse_paths():
    """The intended behaviour where the JAX engine differs between its two
    coarse paths (its flat path hands ``ci[:, :k]`` on unclamped, its
    clustered path clamps): the port clamps both, so a ``-1`` pad id never
    reaches the length tables and the sizes equal the host estimator's."""
    syn, _, flat_set, router, bank = _port_world(
        "medrag", "int8", "hostrefine", docs=600, nq=8, rank=16)
    cl_set = StreamedShardSet.build(
        syn.world, syn.embeddings, dtype=torch.int8, tier="hostrefine",
        hbm_budget_bytes=0, rank=16, cluster_coarse=True)
    assert all(s.coarse_cl is not None and s.coarse_docs is None
               for s in cl_set.sources)
    embs = dict(syn.query_embs)
    k = syn.world.k
    rng = np.random.default_rng(2)
    per = [(rng.integers(20, 90, 600).astype(np.int32), None)
           for _ in syn.world.sources]
    names = [s.name for s in syn.world.sources]
    tab, inv, const, nvalid = (
        t.numpy() for t in build_payload_tables(per, names, k))
    # one probe of kappa 2: fewer reachable candidates than k, so the
    # clustered coarse lists end in -1 ids
    for sset, kw in ((flat_set, {}), (cl_set, {"nprobe": 1, "kappa": 2})):
        eng = StreamedSearchEngine(sset, router, bank, **kw)
        out = eng.search(embs, strategy="all", fetch_candidates=False)
        assert out.shard_ids.shape == (8, 4, k)
        assert out.shard_ids.min() >= 0 and out.shard_ids.max() < 600
        eng.set_payload_tables(per, names)
        sized = eng.search(embs, strategy="all", fetch_candidates=False)
        ids = out.shard_ids
        want = const[None, :] + np.take_along_axis(
            np.broadcast_to(tab[None], (8,) + tab.shape), ids, axis=2
        ).sum(axis=2)
        np.testing.assert_array_equal(sized.msg_base, want)


def test_hostrefine_clustered_coarse_recall():
    """The probed coarse scan in the engine: a full probe with an open cap
    returns the flat-coarse engine's winners, the partial probe clears
    the tier's gate on a topical world."""
    syn = make_synthetic_world("medrag", docs_per_source=1024, num_queries=16,
                               seed=5, with_payloads=False, subclusters=16)
    _, router = _router(syn.world)
    bank = RouterBank.create(syn.world, syn.centroids)
    kw = dict(dtype=torch.int8, tier="hostrefine", hbm_budget_bytes=0)
    flat = StreamedSearchEngine(
        StreamedShardSet.build(syn.world, syn.embeddings, **kw), router, bank)
    cl_set = StreamedShardSet.build(syn.world, syn.embeddings,
                                    cluster_coarse=True, **kw)
    embs = dict(syn.query_embs)

    def sets(out):
        return [{(int(s), int(l)) for s, l in zip(
            out.merged_shard[q], out.merged_local[q]) if s >= 0}
            for q in range(out.merged_shard.shape[0])]

    want = sets(flat.search(embs, strategy="all", fetch_candidates=False))
    tot = sum(len(w) for w in want)
    c = cl_set.sources[0].coarse_cl.n_clusters
    full = StreamedSearchEngine(cl_set, router, bank, nprobe=c, kappa=512)
    got = sets(full.search(embs, strategy="all", fetch_candidates=False))
    assert sum(len(a & b) for a, b in zip(want, got)) >= 0.99 * tot
    part = StreamedSearchEngine(cl_set, router, bank, nprobe=c // 4, kappa=64)
    for fetch in (False, True):
        got = sets(part.search(embs, strategy="all", fetch_candidates=fetch))
        assert sum(len(a & b) for a, b in zip(want, got)) >= 0.9 * tot


# -- the pipelined batcher worker ---------------------------------------------------

class _FakeEngine:
    """dispatch/complete engine that records its call order."""

    supports_pipelined_dispatch = True

    def __init__(self, world, fail_on=None):
        self.world = world
        self.calls = []
        self.fail_on = fail_on

    def dispatch_hostrefine(self, embs, *, strategy, fetch_candidates):
        n = sum(c[0] == "dispatch" for c in self.calls)
        self.calls.append(("dispatch", n))
        if self.fail_on == "dispatch":
            raise RuntimeError("device step failed")
        return n, next(iter(embs.values())).shape[0]

    def complete_hostrefine(self, handle):
        from ragroute_tpu_torch.engine import SearchOutput

        n, bsz = handle
        self.calls.append(("complete", n))
        if self.fail_on == "complete":
            raise RuntimeError("host rescore failed")
        k, ns = self.world.k, self.world.num_sources
        return SearchOutput(
            probs=np.zeros((bsz, ns), np.float32),
            mask=np.ones((bsz, ns), bool), shard_scores=None, shard_ids=None,
            merged_score=np.zeros((bsz, k), np.float32),
            merged_shard=np.zeros((bsz, k), np.int32),
            merged_local=np.tile(np.arange(k, dtype=np.int32), (bsz, 1)),
            merged_valid=np.full(bsz, k, np.int32))


@pytest.mark.parametrize("fail_on", [None, "dispatch", "complete"])
def test_pipelined_worker_delivers_or_fails_every_waiter(fail_on):
    from ragroute_tpu_torch.config import get_world

    world = get_world("medrag")
    engine = _FakeEngine(world, fail_on)
    q = {enc: np.zeros(768, np.float32) for enc in world.encoders}

    async def run():
        batcher = QueryBatcher(engine, strategy="all", window_ms=1.0,
                               buckets=(4,))
        await batcher.start()
        try:
            return await asyncio.gather(
                *[batcher.submit(dict(q)) for _ in range(10)],
                return_exceptions=True)
        finally:
            await batcher.stop()

    results = asyncio.run(run())
    assert len(results) == 10
    if fail_on is None:
        assert all(r.merged_valid == world.k and r.batch_size <= 4
                   for r in results)
        assert len([c for c in engine.calls if c[0] == "dispatch"]) >= 3
        # at most one completion in flight: batch n completes before batch
        # n + 2 is dispatched
        order = {c: i for i, c in enumerate(engine.calls)}
        for n in range(len(engine.calls) // 2 - 2):
            assert order[("complete", n)] < order[("dispatch", n + 2)]
    else:
        assert all(isinstance(r, RuntimeError) and "failed" in str(r)
                   for r in results)


def test_a_stopped_worker_is_never_seen_as_a_dead_one():
    """``stop()`` forgets its task before awaiting it, so the system's
    watchdog (which restarts a worker whose task is done) cannot start a
    second worker beside one that is being stopped and started again."""
    from ragroute_tpu_torch.config import get_world

    engine = _FakeEngine(get_world("medrag"))

    async def run():
        batcher = QueryBatcher(engine, strategy="all", window_ms=1.0,
                               buckets=(4,))
        await batcher.start()
        seen = []

        async def watch():
            for _ in range(6):
                task = batcher._task
                seen.append(task is not None and task.done())
                await asyncio.sleep(0)

        watcher = asyncio.create_task(watch())
        await batcher.stop()
        await watcher
        await batcher.start()
        assert batcher._task is not None and not batcher._task.done()
        await batcher.stop()
        return seen

    assert not any(asyncio.run(run()))
