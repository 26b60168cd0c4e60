"""The port's engine step against the JAX ``FederatedSearchEngine`` (CPU).

Same world, same router parameters, same queries: probabilities within
``atol=1e-5``; masks equal (rows with a probability within 1e-5 of the
threshold are left out); merged shard / local equal; per-shard candidates
likewise. Scores are f32 sums taken in another order by XLA:CPU and by
torch, and a score is built from terms as large as the largest score (l2
even cancels: |q|^2 - (2 q.d - |d|^2)), so they agree within ``rtol=1e-5``
and ``atol = 1e-5 * max|score|``. Compacted must equal uncompacted, submit
must equal blocking, and the device-side ``msg_base`` must equal the
server's host estimator.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ragroute_tpu.engine import FederatedSearchEngine as JEngine
from ragroute_tpu.index import ShardSet as JShardSet
from ragroute_tpu.router import RouterBank as JBank
from ragroute_tpu.router import init_router_params
from ragroute_tpu_torch.engine import FederatedSearchEngine
from ragroute_tpu_torch.engine.engine import payload_base
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.router import (CorpusRouter, RouterBank,
                                       params_from_jax)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want):
    """f32 scores: rtol 1e-5, atol 1e-5 x the largest finite |score|."""
    finite = np.abs(want[np.isfinite(want)])
    np.testing.assert_allclose(got, want, rtol=1e-5, equal_nan=True,
                               atol=1e-5 * float(finite.max(initial=1.0)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def carry_layouts(jss, tss, tmp_path):
    """Give the port's shards the JAX shards' IVF / low-rank layouts,
    through the ``.npz`` files either package reads: k-means is not
    bit-equal across packages, so a search is compared on one layout."""
    from ragroute_tpu.index.ivf import save_ivf
    from ragroute_tpu.index.lowrank import save_lowrank
    from ragroute_tpu_torch.index.ivf import load_ivf
    from ragroute_tpu_torch.index.lowrank import load_lowrank

    for js, ts in zip(jss.shards, tss.shards):
        if js.ivf is not None:
            path = str(tmp_path / f"{js.name}_ivf.npz")
            save_ivf(js.ivf, path)
            ts.ivf = load_ivf(path)
        if js.lr is not None:
            path = str(tmp_path / f"{js.name}_lr.npz")
            save_lowrank(js.lr, path)
            ts.lr = load_lowrank(path)
    tss.lowrank_built = jss.lowrank_built


def _pair(world_name="medrag", *, dtype="float32", impl="exact",
          docs=600, nq=32, seed=0, key=3, tmp_path=None, engine_kw=None,
          **build_kw):
    """The JAX engine and the port's on one world with the same router
    parameters; ``build_kw`` (``ivf_clusters`` / ``lowrank``) builds the
    approximate modes' layouts in the JAX package and carries them over."""
    syn = make_synthetic_world(world_name, docs_per_source=docs,
                               num_queries=nq, seed=seed)
    params = init_router_params(jax.random.key(key),
                                syn.world.router_input_dim)
    jss = JShardSet.build(syn.world, syn.embeddings, doc_ids=syn.doc_ids,
                          dtype=dtype if dtype == "int4"
                          else getattr(jnp, dtype), **build_kw)
    tss = ShardSet.build(syn.world, syn.embeddings, doc_ids=syn.doc_ids,
                         dtype=dtype if dtype == "int4"
                         else getattr(torch, dtype))
    if build_kw:
        carry_layouts(jss, tss, tmp_path)
    engine_kw = engine_kw or {}
    jeng = JEngine(jss, params, JBank.create(syn.world, syn.centroids),
                   impl=impl, **engine_kw)
    router = CorpusRouter(syn.world.router_input_dim)
    router.load_state_dict(params_from_jax(params))
    teng = FederatedSearchEngine(
        tss, router.eval(), RouterBank.create(syn.world, syn.centroids),
        impl=impl, **engine_kw)
    return syn, jeng, teng


def _assert_same_merge(t, j, rows):
    """Merged (shard, local) lists equal position by position, except
    where two entries' scores are within the f32 tolerance of each other
    (a near-tie the two summation orders may break either way): a doc in
    only one list, or at another position, must score within tolerance of
    the score the other list holds there."""
    finite = np.abs(j.merged_score[np.isfinite(j.merged_score)])
    tol = 1e-5 * float(finite.max(initial=1.0))
    for r in np.flatnonzero(rows):
        tk = list(zip(t.merged_shard[r], t.merged_local[r]))
        jk = list(zip(j.merged_shard[r], j.merged_local[r]))
        for p, (a, b) in enumerate(zip(tk, jk)):
            if a[0] < 0 and b[0] < 0:
                continue                    # invalid slots: no doc
            if a != b:
                assert abs(t.merged_score[r, p] - j.merged_score[r, p]) \
                    <= tol, (r, p, a, b)
                assert a in jk or abs(t.merged_score[r, p]
                                      - j.merged_score[r, -1]) <= tol


def _assert_same(t, j, world):
    np.testing.assert_allclose(t.probs, j.probs, atol=1e-5, rtol=0)
    near = (np.abs(j.probs - world.router_threshold) < 1e-5).any(axis=1)
    rows = ~near
    assert rows.sum() > 0
    np.testing.assert_array_equal(t.mask[rows], j.mask[rows])
    np.testing.assert_array_equal(t.merged_valid[rows], j.merged_valid[rows])
    _assert_same_merge(t, j, rows)
    if j.shard_ids is not None:
        np.testing.assert_array_equal(t.shard_ids[rows], j.shard_ids[rows])
        _close(t.shard_scores[rows], j.shard_scores[rows])


@pytest.mark.parametrize("world_name,impl,strategy", [
    ("medrag", "exact", "ragroute"), ("medrag", "chunked", "ragroute"),
    ("medrag", "exact", "all"), ("wikipedia", "exact", "ragroute"),
    ("wikipedia", "chunked", "all"),
])
def test_engine_matches_jax(world_name, impl, strategy):
    syn, jeng, teng = _pair(world_name, impl=impl)
    embs = dict(syn.query_embs)
    j = jeng.search(embs, strategy=strategy)
    t = teng.search(embs, strategy=strategy)
    if strategy == "ragroute":
        assert 0 < t.mask.mean() < 1       # a mixed mask: skip/compaction
    _assert_same(t, j, syn.world)


def test_engine_int8_matches_jax():
    syn, jeng, teng = _pair("medrag", dtype="int8", nq=16)
    embs = dict(syn.query_embs)
    _assert_same(teng.search(embs, strategy="all"),
                 jeng.search(embs, strategy="all"), syn.world)


def test_compacted_equals_uncompacted_and_skips_unrouted_shards():
    syn, _, teng = _pair("medrag", nq=32)
    full = FederatedSearchEngine(teng.shard_set, teng.router, teng.bank,
                                 compaction=False)
    embs = dict(syn.query_embs)
    a = teng.search(embs)
    b = full.search(embs)
    counts = a.mask.sum(axis=0)
    # this world routes some shards to <= B/4 or <= B/2 of the batch
    assert (counts <= 16).any()
    for f in ("mask", "merged_shard", "merged_valid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    valid = a.merged_shard >= 0           # invalid slots carry no doc
    np.testing.assert_array_equal(a.merged_local[valid],
                                  b.merged_local[valid])
    np.testing.assert_allclose(a.merged_score, b.merged_score,
                               equal_nan=True, **TOL)
    routed = a.mask[:, :, None].repeat(syn.world.k, axis=2)
    np.testing.assert_array_equal(a.shard_ids[routed], b.shard_ids[routed])


def test_submit_equals_blocking_and_staged_equals_fused():
    syn, _, teng = _pair("medrag", nq=16)
    embs = dict(syn.query_embs)
    blocking = teng.search(embs, staged=False)
    staged = teng.search(embs, staged=True)
    pending = teng.search_submit(embs)
    submitted = pending.wait()
    with pytest.raises(RuntimeError):
        pending.wait()
    for other in (staged, submitted):
        for f in ("probs", "mask", "merged_shard", "merged_local",
                  "merged_score", "shard_ids", "shard_scores"):
            np.testing.assert_array_equal(getattr(other, f),
                                          getattr(blocking, f), err_msg=f)
    assert staged.selection_time > 0 and blocking.selection_time == 0


def test_query_table_rows_equal_dense():
    syn, _, teng = _pair("medrag", nq=16)
    teng.set_query_table(dict(syn.query_embs))
    dense = teng.search(dict(syn.query_embs))
    rows = teng.search({"__rows__": np.arange(16, dtype=np.int32)})
    np.testing.assert_array_equal(rows.merged_local, dense.merged_local)
    np.testing.assert_array_equal(rows.merged_score, dense.merged_score)


def test_random_strategy_routes_exact_subset():
    syn, _, teng = _pair("wikipedia", nq=16)
    out = teng.search(dict(syn.query_embs), strategy="random")
    assert (out.mask.sum(axis=1) == syn.world.random_subset).all()
    assert ((out.merged_shard < 0) | out.mask[
        np.arange(16)[:, None], np.maximum(out.merged_shard, 0)]).all()


def test_msg_base_equals_host_estimator():
    from ragroute_tpu_torch.engine.batcher import QueryResult
    from ragroute_tpu_torch.engine.server import FederationServer
    from ragroute_tpu_torch.index.store import MemoryDocStore

    syn, _, teng = _pair("medrag", nq=8)
    store = MemoryDocStore.from_synthetic(syn)
    server = FederationServer(teng, strategy="all", doc_store=store,
                              disable_llm=True, warmup=False, port=0)
    assert teng._ptables is None          # CPU engine: host estimator
    teng.set_payload_tables(
        [server._size_tables(si) for si in range(syn.world.num_sources)],
        [s.name for s in syn.world.sources])
    embs = dict(syn.query_embs)
    with_ids = teng.search(embs, strategy="all", fetch_candidates=True)
    with_msg = teng.search(embs, strategy="all", fetch_candidates=False)
    assert with_msg.shard_ids is None and with_msg.msg_base is not None
    qid = "q" * 36
    for r in range(8):
        res = QueryResult(
            probs=None, mask=None, shard_scores=None,
            shard_ids=with_ids.shard_ids[r], merged_score=None,
            merged_shard=None, merged_local=None, merged_valid=0,
            selection_time=0, doc_select_time=0, batch_size=8)
        for si in range(syn.world.num_sources):
            assert (int(with_msg.msg_base[r, si]) + len(qid)
                    == server._estimate_message_size(res, si, qid))
    # crafted ids: pads, boundaries and out-of-range rows
    n0 = teng.shard_set.shards[0].n_docs
    ids = np.zeros((1, syn.world.num_sources, syn.world.k), np.int64)
    ids[0, :, :4] = [-1, n0 - 1, n0, n0 + 5]
    dev = payload_base(teng._ptables, torch.from_numpy(ids)).numpy()
    res = QueryResult(probs=None, mask=None, shard_scores=None,
                      shard_ids=ids[0], merged_score=None, merged_shard=None,
                      merged_local=None, merged_valid=0, selection_time=0,
                      doc_select_time=0, batch_size=1)
    for si in range(syn.world.num_sources):
        assert int(dev[0, si]) == server._estimate_message_size(res, si, "")


def test_resolve_doc_ids_and_unported_impl_raises():
    syn, jeng, teng = _pair("medrag", nq=4)
    embs = dict(syn.query_embs)
    t = teng.search(embs, strategy="all")
    j = jeng.search(embs, strategy="all")
    assert teng.resolve_doc_ids(t, 0) == jeng.resolve_doc_ids(j, 0)
    with pytest.raises(ValueError, match="ROADMAP"):
        FederatedSearchEngine(teng.shard_set, teng.router, teng.bank,
                              impl="hostrefine")
