"""The low-rank coarse index and the two-stage search against the JAX package.

The build runs the same numpy calls on the same matrix in both packages
(``eigh`` on the f64 moment matrix, the f32 projection), and both bf16 casts
round to nearest even, so ``basis``, ``mu`` and ``docs_lr`` are bit-equal:
no tolerance, and no sign convention to fix. The search is compared on the
same numpy-seeded operands through ``ragroute_tpu.ops.lowrank_topk`` (its
coarse scan through the exact path, as the JAX package's CPU tests run it)
and the port's ``lowrank_topk``: indices equal, scores within
``rtol=1e-5, atol=1e-5 * max|term|`` (f32 sums in another order; the terms
are the scores themselves and, for l2, the ``|q|^2`` the distance is
cancelled from), and an index may differ only where the two scores at that
position are that close.
"""

import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from ragroute_tpu.index import lowrank as jlr
from ragroute_tpu.ops.lowrank_topk import lowrank_topk as j_lowrank_topk
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.index.ivf import ivf_fingerprint
from ragroute_tpu_torch.index.lowrank import (build_lowrank, load_lowrank,
                                              lowrank_from_reference,
                                              save_lowrank, select_rank)
from ragroute_tpu_torch.index.shard import _pack_int4, _quantize_sym
from ragroute_tpu_torch.index.synthetic import save_world
from ragroute_tpu_torch.ops.lowrank_topk import lowrank_topk
from ragroute_tpu_torch.ops.topk import exact_topk
from test_torch_engine import _assert_same, _pair

K = 16
N, NPAD, D = 1500, 1536, 256


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _planted(n, d, lat=64, seed=0, n_blobs=6, spread=0.35):
    """Rank-``lat`` docs and queries near the doc clusters (the synthetic
    worlds' generative shape)."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((lat, d)).astype(np.float32) / np.sqrt(lat)
    centers = 2.0 * rng.standard_normal((n_blobs, lat)).astype(np.float32)
    z = centers[rng.integers(0, n_blobs, n)] + spread * rng.standard_normal(
        (n, lat)).astype(np.float32)
    qz = centers[rng.integers(0, n_blobs, 24)]
    qz = qz + 0.2 * rng.standard_normal(qz.shape).astype(np.float32)
    return (z @ proj).astype(np.float32), (qz @ proj).astype(np.float32)


def _bits(x) -> np.ndarray:
    """bf16 array (jax or torch) as its uint16 bit pattern."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _padded(emb, mode):
    docs = np.pad(emb, ((0, NPAD - N), (0, 0)))
    base = (-np.einsum("nd,nd->n", emb, emb) if mode == "l2"
            else np.zeros(N, np.float32))
    bias = np.pad(base.astype(np.float32), (0, NPAD - N),
                  constant_values=-np.inf)
    return docs, bias


def _assert_same_topk(ts, ti, js, ji, q=None):
    """``q``: the queries of an l2 search (``|q|^2`` is a term of it)."""
    ts, ti, js, ji = (np.asarray(a) for a in (ts, ti, js, ji))
    term = float(np.abs(js[np.isfinite(js)]).max())
    if q is not None:
        term = max(term, float((q * q).sum(axis=1).max()))
    tol = 1e-5 * term
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=tol)
    for r, p in zip(*np.nonzero(ti != ji)):
        assert abs(ts[r, p] - js[r, p]) <= tol and ti[r, p] in ji[r], (r, p)


# -- build ----------------------------------------------------------------------

def test_select_rank_equals_the_jax_rule():
    w = np.concatenate([np.full(100, 9.0), np.full(412, 100 * 1.0 / 412)])
    for energy, rank in ((0.85, None), (0.999, None), (0.85, 77),
                         (0.5, None), (0.85, 9999)):
        assert select_rank(w, energy, rank) == jlr.select_rank(w, energy,
                                                               rank)
    assert select_rank(w, 0.85) == 128 and select_rank(w, 0.999) is None
    assert select_rank(np.zeros(8), 0.9) is None


@pytest.mark.parametrize("rank", [None, 48, 20])
def test_build_is_bit_equal_to_the_jax_build(rank):
    """Bit-equal in the first ``rank`` columns; the port stores zero columns
    up to the next multiple of 16 (the width the card's scan takes)."""
    emb, _ = _planted(N, D, seed=2)
    a = jlr.build_lowrank(emb, n_pad=NPAD, rank=rank)
    b = build_lowrank(emb, n_pad=NPAD, rank=rank)
    r = b.rank
    assert r == a.rank == (rank or 128) and b.energy == a.energy
    assert b.docs_lr.dtype == torch.bfloat16
    assert b.docs_lr.shape == (NPAD, r + -r % 16)
    assert b.basis.shape == (D, r + -r % 16)
    np.testing.assert_array_equal(b.basis[:, :r].numpy(), np.asarray(a.basis))
    np.testing.assert_array_equal(b.mu.numpy(), np.asarray(a.mu))
    np.testing.assert_array_equal(_bits(b.docs_lr[:, :r].contiguous()),
                                  _bits(a.docs_lr))
    assert (b.docs_lr[N:] == 0).all()
    assert (b.docs_lr[:, r:] == 0).all() and (b.basis[:, r:] == 0).all()
    basis = b.basis[:, :r].numpy()
    np.testing.assert_allclose(basis.T @ basis, np.eye(r), atol=1e-5)


def test_build_refuses_a_flat_spectrum_as_the_jax_build_does():
    emb = np.random.default_rng(3).standard_normal((1000, 128)).astype(
        np.float32)
    assert build_lowrank(emb, n_pad=1024) is None
    assert jlr.build_lowrank(emb, n_pad=1024) is None
    lr = build_lowrank(emb, n_pad=1024, rank=32)
    assert lr is not None and lr.rank == 32 and lr.energy < 0.5


# -- search -----------------------------------------------------------------------

@pytest.mark.parametrize("mode,dtype", [("dot", "float32"), ("l2", "float32"),
                                        ("cos", "float32"), ("dot", "int8")])
def test_lowrank_topk_matches_jax(mode, dtype):
    emb, q = _planted(N, D, seed=4)
    if mode == "cos":
        emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    docs, bias = _padded(emb, mode)
    jl = jlr.build_lowrank(emb, n_pad=NPAD)
    tl = build_lowrank(emb, n_pad=NPAD)
    scale = None
    if dtype == "int8":
        docs, scale = _quantize_sym(docs, 127)
    jargs = dict(mode=mode, valid_docs=N, bias=jnp.asarray(bias),
                 scale=None if scale is None else jnp.asarray(scale),
                 k_refine=4 * K)
    targs = dict(mode=mode, valid_docs=N, bias=torch.from_numpy(bias),
                 scale=None if scale is None else torch.from_numpy(scale),
                 k_refine=4 * K)
    js, ji = j_lowrank_topk(jnp.asarray(q), jl, jnp.asarray(docs), K, **jargs)
    ts, ti = lowrank_topk(torch.from_numpy(q), tl, torch.from_numpy(docs), K,
                          **targs)
    _assert_same_topk(ts, ti, js, ji, q if mode == "l2" else None)
    if dtype == "float32" and mode != "cos":
        # planted rank 64 < 128: the projection loses only the coarse
        # slab's bf16 rounding, so the two-stage search finds the exact
        # path's docs (the JAX package's gate for this case: >= 0.99)
        _, i_ref = exact_topk(torch.from_numpy(q), torch.from_numpy(docs), K,
                              mode=mode, valid_docs=N,
                              bias=torch.from_numpy(bias))
        hits = sum(len(set(a.tolist()) & set(b.tolist()))
                   for a, b in zip(ti, i_ref))
        assert hits >= 0.99 * i_ref.numel()


def test_a_rank_off_the_16_grid_searches_as_the_jax_package(tmp_path):
    """``--rank 20``: built, carried across and read from the JAX package's
    file, the coarse index is zero-padded to 32 columns and the search
    returns what the JAX package returns at rank 20."""
    emb, q = _planted(N, D, seed=12)
    docs, bias = _padded(emb, "dot")
    jl = jlr.build_lowrank(emb, n_pad=NPAD, rank=20)
    path = str(tmp_path / "jlr.npz")
    jlr.save_lowrank(jl, path)
    js, ji = j_lowrank_topk(jnp.asarray(q), jl, jnp.asarray(docs), K,
                            valid_docs=N, bias=jnp.asarray(bias))
    built = build_lowrank(emb, n_pad=NPAD, rank=20)
    for tl in (built, load_lowrank(path)):
        assert tl.rank == 20 and tl.docs_lr.shape == (NPAD, 32)
        assert tl.docs_lr.is_contiguous() and tl.basis.shape == (D, 32)
        ts, ti = lowrank_topk(torch.from_numpy(q), tl, torch.from_numpy(docs),
                              K, valid_docs=N, bias=torch.from_numpy(bias))
        _assert_same_topk(ts, ti, js, ji)
    # the port's own file holds the 20 columns only: the JAX package's format
    save_lowrank(built, path)
    jback = jlr.load_lowrank(path)
    assert jback.rank == 20
    np.testing.assert_array_equal(_bits(jback.docs_lr), _bits(jl.docs_lr))


def test_centre_and_deep_candidates_match_jax():
    """A centred dot shard restores ``q . mu``; ``k_refine=128`` is the
    depth the serving default (4 x 32) gives the coarse scan."""
    emb, q = _planted(N, D, seed=6)
    mu = emb.mean(axis=0)
    docs, bias = _padded(emb - mu, "dot")
    jl = jlr.build_lowrank(emb - mu, n_pad=NPAD)
    tl = lowrank_from_reference({
        "basis": np.array(jl.basis), "docs_lr": _bits(jl.docs_lr).copy(),
        "mu": np.array(jl.mu), "energy": jl.energy})
    js, ji = j_lowrank_topk(jnp.asarray(q), jl, jnp.asarray(docs), 32,
                            mode="dot", valid_docs=N, bias=jnp.asarray(bias),
                            center=jnp.asarray(mu), k_refine=128)
    ts, ti = lowrank_topk(torch.from_numpy(q), tl, torch.from_numpy(docs), 32,
                          mode="dot", valid_docs=N,
                          bias=torch.from_numpy(bias),
                          center=torch.from_numpy(mu), k_refine=128)
    _assert_same_topk(ts, ti, js, ji)


@pytest.mark.parametrize("mode", ["dot", "l2"])
def test_int4_coarse_authoritative_branch_matches_jax(mode):
    """An int4 store returns the coarse slab's own order and scores (plus
    the restored centring constant), never a rescore from 4-bit codes."""
    emb, q = _planted(N, D, seed=8)
    mu = emb.mean(axis=0)
    docs, bias = _padded(emb - mu, mode)
    jl = jlr.build_lowrank(emb - mu, n_pad=NPAD)
    tl = build_lowrank(emb - mu, n_pad=NPAD)
    codes, scale = _quantize_sym(docs, 7, mse_opt=True)
    packed = _pack_int4(codes)
    js, ji = j_lowrank_topk(
        jnp.asarray(q), jl, jnp.asarray(packed), K, mode=mode, valid_docs=N,
        bias=jnp.asarray(bias), scale=jnp.asarray(scale),
        center=jnp.asarray(mu), packed4=True)
    ts, ti = lowrank_topk(
        torch.from_numpy(q), tl, torch.from_numpy(packed), K, mode=mode,
        valid_docs=N, bias=torch.from_numpy(bias),
        scale=torch.from_numpy(scale), center=torch.from_numpy(mu),
        packed4=True)
    _assert_same_topk(ts, ti, js, ji, q - mu if mode == "l2" else None)


def test_duplicate_ties_lowest_index_first_and_short_shards():
    emb, q = _planted(N, D, seed=9)
    emb[700:710] = emb[5]
    docs, bias = _padded(emb, "l2")
    tl = build_lowrank(emb, n_pad=NPAD)
    t = torch.from_numpy
    _, ti = lowrank_topk(t(emb[5:6]), tl, t(docs), K, mode="l2",
                         valid_docs=N, bias=t(bias))
    assert ti[0, :11].tolist() == [5] + list(range(700, 710))
    # fewer valid docs than k': the unfilled candidates stay out
    few = bias.copy()
    few[40:] = -np.inf
    ts, ti = lowrank_topk(t(q), tl, t(docs), K, valid_docs=N, bias=t(few),
                          k_refine=64)
    assert int(ti.max()) < 40 and torch.isfinite(ts).all()
    ts, ti = lowrank_topk(t(q), tl, t(docs), K, mode="l2", valid_docs=N,
                          bias=t(np.where(np.arange(NPAD) < 8, 0.0, -np.inf)
                                 .astype(np.float32)), k_refine=64)
    assert torch.isposinf(ts[:, 8:]).all() and torch.isfinite(ts[:, :8]).all()
    assert not torch.isnan(ts).any()


# -- persistence -------------------------------------------------------------------

def test_npz_round_trip_and_cross_package_read(tmp_path):
    emb, _ = _planted(N, D, seed=7)
    fp = ivf_fingerprint(emb)
    lr = build_lowrank(emb, n_pad=NPAD)
    path = str(tmp_path / "lr.npz")
    save_lowrank(lr, path, fingerprint=fp)
    back = load_lowrank(path, expect_fingerprint=fp)
    assert back.rank == lr.rank and back.energy == lr.energy
    for f in ("basis", "docs_lr", "mu"):
        assert torch.equal(getattr(back, f), getattr(lr, f)), f
    assert load_lowrank(path, expect_fingerprint="other") is None
    jback = jlr.load_lowrank(path, expect_fingerprint=fp)
    np.testing.assert_array_equal(_bits(jback.docs_lr), _bits(lr.docs_lr))
    # and the other way: the JAX package's file, read by the port
    jpath = str(tmp_path / "jlr.npz")
    jlr.save_lowrank(jlr.build_lowrank(emb, n_pad=NPAD), jpath,
                     fingerprint=fp)
    tback = load_lowrank(jpath, expect_fingerprint=fp)
    assert torch.equal(tback.docs_lr, lr.docs_lr)
    assert torch.equal(tback.basis, lr.basis)
    assert tback.device.type == "cpu" and tback.nbytes == lr.nbytes


def test_shardset_load_caches_the_coarse_index(tmp_path):
    syn = make_synthetic_world("medrag", docs_per_source=512, num_queries=4,
                               seed=15)
    root = str(tmp_path / "root")
    save_world(syn, root)
    ss1 = ShardSet.load(root, syn.world, dtype=torch.bfloat16, lowrank=-1)
    caches = [os.path.join(root, "medrag", s.name, "lr_auto0.99.npz")
              for s in syn.world.sources]
    assert all(os.path.exists(c) for c in caches) and ss1.lowrank_built
    mtimes = [os.path.getmtime(c) for c in caches]
    ss2 = ShardSet.load(root, syn.world, dtype=torch.bfloat16, lowrank=-1)
    assert [os.path.getmtime(c) for c in caches] == mtimes      # reused
    assert torch.equal(ss1.shards[0].lr.docs_lr, ss2.shards[0].lr.docs_lr)
    assert ss1.shards[0].lr.docs_lr.shape[0] == ss1.shards[0].docs.shape[0]
    assert ss1.aux_bytes == sum(s.lr.nbytes for s in ss1.shards) > 0
    ShardSet.load(root, syn.world, dtype=torch.bfloat16, lowrank=64)
    assert os.path.exists(os.path.join(root, "medrag", "pubmed",
                                       "lr_64.npz"))


# -- the engine ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype,strategy", [("float32", "ragroute"),
                                            ("int8", "all"),
                                            ("int4", "ragroute")])
def test_engine_matches_jax(tmp_path, dtype, strategy):
    syn, jeng, teng = _pair("medrag", dtype=dtype, impl="lowrank", nq=16,
                            tmp_path=tmp_path, lowrank=-1)
    assert all(s.lr is not None and s.lr.rank == 128
               for s in teng.shard_set.shards)
    embs = dict(syn.query_embs)
    _assert_same(teng.search(embs, strategy=strategy),
                 jeng.search(embs, strategy=strategy), syn.world)


def test_engine_requires_built_shards_and_falls_back_on_refused_ones():
    from ragroute_tpu_torch.engine import FederatedSearchEngine

    syn = make_synthetic_world("medrag", docs_per_source=600, num_queries=8,
                               seed=3)
    plain = ShardSet.build(syn.world, syn.embeddings, dtype=torch.float32)
    with pytest.raises(ValueError, match="lowrank="):
        FederatedSearchEngine(plain, None, None, impl="lowrank")
    # one source with a flat spectrum: its build is refused, the engine
    # scans it exactly, and the result equals the exact engine's
    emb = dict(syn.embeddings)
    first = syn.world.sources[0].name
    emb[first] = np.random.default_rng(0).standard_normal(
        emb[first].shape).astype(np.float32)
    ss = ShardSet.build(syn.world, emb, dtype=torch.float32, lowrank=-1)
    assert ss.shards[0].lr is None and ss.shards[1].lr is not None
    embs = dict(syn.query_embs)
    a = FederatedSearchEngine(ss, None, None, impl="lowrank").search(
        embs, strategy="all")
    b = FederatedSearchEngine(ss, None, None, impl="exact").search(
        embs, strategy="all")
    np.testing.assert_array_equal(a.merged_shard, b.merged_shard)
    np.testing.assert_array_equal(a.merged_local, b.merged_local)
