"""The balanced-IVF build and cluster-probed search against the JAX package.

k-means cannot be bit-equal across packages (summation order decides
borderline assignments), so the *build* is held on its properties and the
*search* on a layout carried across: the JAX package builds and saves it,
the port loads the ``.npz`` (the files are interchangeable), and the same
numpy-seeded queries go through ``ragroute_tpu.ops.ivf_topk.ivf_topk`` (its
Pallas kernels in interpret mode on the CPU) and the port's ``ivf_topk`` (on
CPU tensors: the kernels' plain versions).

Tolerances: integer-valued f32 / bf16 worlds make every gain exact, so
indices and scores are equal. int8 / int4 slabs and real-valued worlds sum
f32 products in another order: scores within ``rtol=1e-5`` and
``atol = 1e-5 * max|score|``, and an index may differ only where the two
scores at that position are within that tolerance (a near-tie).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ragroute_tpu.index import ivf as jivf
from ragroute_tpu.ops.ivf_topk import ivf_topk as j_ivf_topk
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.index.ivf import (build_ivf, default_n_clusters,
                                          ivf_fingerprint, ivf_from_reference,
                                          load_ivf, save_ivf, slab_capacity)
from ragroute_tpu_torch.index.shard import _pack_int4, _quantize_sym
from ragroute_tpu_torch.index.synthetic import save_world
from ragroute_tpu_torch.ops.ivf_topk import dispatch, ivf_topk
from ragroute_tpu_torch.ops.topk import exact_topk, shard_topk, unpack_int4
from test_torch_engine import _assert_same, _pair

K = 16
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8,
       "int4": "int4"}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int8": torch.int8, "int4": "int4"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _clustered(n, d, n_blobs, seed=0, spread=0.25, integer=False):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_blobs, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, n_blobs, n)] + spread * rng.standard_normal(
        (n, d)).astype(np.float32)
    if integer:
        x = np.clip(np.round(x), -4, 4)
    return x.astype(np.float32)


def _carried(emb, mode, dtype, tmp_path, n_clusters=16, seed=0):
    """The JAX package's layout and the same layout loaded by the port."""
    jl = jivf.build_ivf(emb, mode, dtype=JDT[dtype], n_clusters=n_clusters,
                        seed=seed)
    path = str(tmp_path / f"ivf_{dtype}_{mode}.npz")
    jivf.save_ivf(jl, path)
    return jl, load_ivf(path)


def _assert_same_topk(ts, ti, js, ji, exact):
    ts, ti, js, ji = (np.asarray(a) for a in (ts, ti, js, ji))
    if exact:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
        return
    finite = np.isfinite(js)
    tol = 1e-5 * float(np.abs(js[finite]).max())
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=tol)
    for r, p in zip(*np.nonzero(ti != ji)):
        # a swap of two near-tied neighbours
        assert abs(ts[r, p] - js[r, p]) <= tol and ti[r, p] in ji[r], (r, p)


# -- search on a carried-across layout ---------------------------------------

@pytest.mark.parametrize("mode,dtype,nprobe", [
    ("dot", "float32", 4), ("dot", "bfloat16", 16), ("dot", "int8", 6),
    ("dot", "int4", 16), ("cos", "float32", 5), ("l2", "float32", 4),
    ("l2", "int8", 16),
])
def test_ivf_topk_matches_jax_on_one_layout(tmp_path, mode, dtype, nprobe):
    exact = dtype in ("float32", "bfloat16") and mode != "cos"
    emb = _clustered(1500, 32, 8, seed=4, integer=exact)
    q = _clustered(16, 32, 8, seed=5, integer=exact)
    if mode == "cos":
        emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    if dtype == "int4":
        emb = emb - emb.mean(axis=0)
    jl, tl = _carried(emb, mode, dtype, tmp_path)
    js, ji = j_ivf_topk(jnp.asarray(q), jl, K, mode=mode, nprobe=nprobe)
    ts, ti = ivf_topk(torch.from_numpy(q), tl, K, mode=mode, nprobe=nprobe)
    assert ti.dtype == torch.int64 and ts.dtype == torch.float32
    _assert_same_topk(ts, ti, js, ji, exact)
    assert int(ti.max()) < 1500 and int(ti.min()) >= 0


def test_ivf_topk_deep_probe_and_centre_match_jax(tmp_path):
    """More than 64 probes take the sorted ``[B, C]`` probe (ties to the
    lower cluster), and a centred shard shifts l2 queries / restores the
    dot constant."""
    emb = _clustered(2000, 32, 8, seed=6, integer=True)
    q = _clustered(12, 32, 8, seed=7, integer=True)
    mu = np.round(emb.mean(axis=0)).astype(np.float32)
    for mode in ("dot", "l2"):
        jl, tl = _carried(emb - mu, mode, "float32", tmp_path, n_clusters=96)
        assert tl.n_clusters == 96 and tl.capacity % 8 == 0
        js, ji = j_ivf_topk(jnp.asarray(q), jl, K, mode=mode, nprobe=80,
                            center=jnp.asarray(mu))
        ts, ti = ivf_topk(torch.from_numpy(q), tl, K, mode=mode, nprobe=80,
                          center=torch.from_numpy(mu))
        _assert_same_topk(ts, ti, js, ji, exact=True)


@pytest.mark.parametrize("mode", ["dot", "cos", "l2"])
def test_full_probe_equals_the_exact_path(mode):
    """``nprobe == C``: every query scores every document, so the port's
    own build + search reproduce the port's exact path."""
    emb = _clustered(1500, 24, 6, seed=4, integer=mode != "cos")
    q = _clustered(32, 24, 6, seed=5, integer=mode != "cos")
    if mode == "cos":
        emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    ivf = build_ivf(emb, mode, dtype=torch.float32, n_clusters=16, seed=4)
    s_ref, i_ref = exact_topk(torch.from_numpy(q), torch.from_numpy(emb), K,
                              mode=mode)
    s_ivf, i_ivf = ivf_topk(torch.from_numpy(q), ivf, K, mode=mode,
                            nprobe=16)
    if mode == "cos":       # real-valued: same sets, scores in f32 tolerance
        assert all(set(a.tolist()) == set(b.tolist())
                   for a, b in zip(i_ivf, i_ref))
        np.testing.assert_allclose(s_ivf.numpy(), s_ref.numpy(), rtol=1e-5,
                                   atol=1e-6)
    else:
        # equal gains order by slot position in the IVF path and by doc id
        # in the exact path: the same scores, the same docs per tie group
        np.testing.assert_array_equal(s_ivf.numpy(), s_ref.numpy())
        for r in range(32):
            kth = s_ref[r, -1]
            inner = s_ref[r] != kth
            assert set(i_ivf[r][inner].tolist()) == \
                set(i_ref[r][inner].tolist())


def test_int4_full_probe_matches_flat_int4_scan():
    """The int4 slab holds the flat shard's own codes, so full-probe IVF
    reproduces the flat packed-int4 scan. The grouped GEMM takes the
    queries in bf16 and the flat CPU scan in f32, so scores agree within
    bf16's 2^-8 (``rtol = atol = 1e-2``, the JAX package's own gate for
    this pair)."""
    emb = _clustered(2000, 32, 8, seed=8)
    emb = emb - emb.mean(axis=0)
    q = torch.from_numpy(_clustered(32, 32, 8, seed=9))
    ivf = build_ivf(emb, "dot", dtype="int4", n_clusters=16, seed=8)
    assert ivf.packed4 and ivf.docs.dtype == torch.int8
    assert ivf.docs.shape == (16, 16, ivf.capacity)
    codes, s_row = _quantize_sym(emb, 7, mse_opt=True)
    s_flat, i_flat = shard_topk(
        q, torch.from_numpy(_pack_int4(codes)), K, mode="dot",
        valid_docs=2000, scale=torch.from_numpy(s_row), packed4=True)
    s_ivf, i_ivf = ivf_topk(q, ivf, K, mode="dot", nprobe=16)
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(i_ivf, i_flat))
    assert hits >= 0.99 * i_flat.numel()
    np.testing.assert_allclose(s_ivf.numpy(), s_flat.numpy(), rtol=1e-2,
                               atol=1e-2)


def test_dispatch_layout_is_cluster_aligned():
    """Every pair lands once, in a block of its own cluster; padding rows
    name query 0; the real block count is the sum of per-cluster blocks."""
    rng = np.random.default_rng(0)
    bsz, p, c = 37, 5, 12
    probe = torch.from_numpy(np.stack(
        [rng.choice(c, p, replace=False) for _ in range(bsz)]))
    rows, blk_cluster, n_real, row_of = dispatch(probe, c)
    assert rows.dtype == blk_cluster.dtype == n_real.dtype == torch.int32
    assert rows.shape[0] == 64 * blk_cluster.shape[0]
    assert blk_cluster.shape[0] == (bsz * p) // 64 + min(bsz * p, c)
    counts = np.bincount(probe.reshape(-1).numpy(), minlength=c)
    assert int(n_real) == int(np.ceil(counts / 64).sum())
    flat = row_of.reshape(-1).numpy()
    assert len(set(flat.tolist())) == bsz * p           # unique rows
    assert (flat < int(n_real) * 64).all()
    for b in range(bsz):
        for j in range(p):
            r = int(row_of[b, j])
            assert int(rows[r]) == b
            assert int(blk_cluster[r // 64]) == int(probe[b, j])


# -- the build, on its properties ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_build_is_a_partition_with_inf_pads(dtype):
    n, d, c = 3000, 32, 64
    emb = _clustered(n, d, 12)
    ivf = build_ivf(emb, "l2", dtype=TDT[dtype], n_clusters=c, seed=1)
    s = ivf.capacity
    assert s == slab_capacity(n, c) and s % 8 == 0 and c * s >= n
    assert ivf.docs.shape == (c, d // 2 if dtype == "int4" else d, s)
    assert ivf.n_clusters == c and ivf.packed4 == (dtype == "int4")
    bias, perm = ivf.bias.numpy(), ivf.perm.numpy()
    valid = bias > -np.inf
    assert sorted(perm[valid].tolist()) == list(range(n))   # each doc once
    assert np.isneginf(bias[~valid]).all() and (perm[~valid] == 0).all()
    # filled slots are a prefix of every cluster's slab
    assert (np.diff(valid.astype(np.int8), axis=1) <= 0).all()
    np.testing.assert_allclose(bias[valid], -(emb * emb).sum(1)[perm[valid]],
                               rtol=1e-6)
    np.testing.assert_array_equal(
        ivf.cbias.numpy(), -(ivf.centroids.numpy() ** 2).sum(1))
    cl, sl = np.nonzero(valid)
    docs = ivf.docs
    if dtype == "int4":
        docs = unpack_int4(docs, dim=1)
    cols = docs[torch.from_numpy(cl), :, torch.from_numpy(sl)].to(
        torch.float32).numpy()
    if ivf.scale is not None:
        cols = cols * ivf.scale.numpy()[cl, sl][:, None]
    tol = {"float32": 1e-6, "bfloat16": 2e-2, "int8": 2e-2, "int4": 0.6}
    np.testing.assert_allclose(cols, emb[perm[valid]], atol=tol[dtype] * 4,
                               rtol=tol[dtype])
    if dtype in ("float32", "bfloat16"):
        assert (docs.to(torch.float32).numpy().transpose(0, 2, 1)[~valid]
                == 0).all()


def test_capacity_rule_and_default_sizing_equal_the_jax_package():
    for n in (100, 1000, 5000, 734_003, 1 << 20):
        assert default_n_clusters(n) == jivf.default_n_clusters(n)
    # S = 256 at the medrag pubmed shard (lane-aligned), 232 -> 232 (+10%
    # would be fine, +60% not): the rule of the JAX build
    assert slab_capacity(734_003, 4096) == 256
    assert slab_capacity(3000, 64) == 64
    assert slab_capacity(160 * 10, 10) == 200
    emb = _clustered(700, 16, 4)
    for c in (1, 8, 50):
        a = jivf.build_ivf(emb, "dot", dtype=jnp.float32, n_clusters=c)
        assert slab_capacity(700, c) == a.capacity


def test_int4_codes_equal_the_flat_shard_and_the_precomputed_path():
    """A doc's slab codes are bit-equal to its flat-shard codes, whether
    the build quantizes the slot rows or is handed the flat codes."""
    emb = _clustered(1500, 32, 8, seed=11)
    emb = emb - emb.mean(axis=0)
    codes, s_row = _quantize_sym(emb, 7, mse_opt=True)
    packed = _pack_int4(codes)
    a = build_ivf(emb, "dot", dtype="int4", n_clusters=16, seed=3)
    b = build_ivf(emb, "dot", dtype="int4", n_clusters=16, seed=3,
                  packed_rows=packed, row_scales=s_row)
    for f in ("docs", "perm", "scale", "bias"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    valid = a.bias.numpy() > -np.inf
    cl, sl = np.nonzero(valid)
    cols = a.docs[torch.from_numpy(cl), :, torch.from_numpy(sl)].numpy()
    np.testing.assert_array_equal(cols, packed[a.perm.numpy()[valid]])
    np.testing.assert_array_equal(a.scale.numpy()[valid],
                                  s_row[a.perm.numpy()[valid]])
    with pytest.raises(ValueError, match="do not match"):
        build_ivf(emb, "dot", dtype="int4", packed_rows=packed[:-1],
                  row_scales=s_row)
    with pytest.raises(ValueError, match="int4"):
        build_ivf(emb, "dot", dtype="int5")


def test_build_is_seeded():
    emb = _clustered(1200, 16, 6, seed=2)
    a = build_ivf(emb, "dot", dtype=torch.float32, n_clusters=16, seed=5)
    b = build_ivf(emb, "dot", dtype=torch.float32, n_clusters=16, seed=5)
    c = build_ivf(emb, "dot", dtype=torch.float32, n_clusters=16, seed=6)
    assert torch.equal(a.perm, b.perm) and torch.equal(a.docs, b.docs)
    assert not torch.equal(a.centroids, c.centroids)
    one = build_ivf(emb, "dot", dtype=torch.float32, n_clusters=1)
    np.testing.assert_allclose(one.centroids.numpy()[0], emb.mean(0),
                               rtol=1e-5, atol=1e-6)


# -- persistence ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_npz_round_trip_and_cross_package_read(tmp_path, dtype):
    emb = _clustered(1200, 24, 6, seed=13)
    q = _clustered(8, 24, 6, seed=14)
    ivf = build_ivf(emb, "dot", dtype=TDT[dtype], n_clusters=16, seed=13)
    path = str(tmp_path / "ivf.npz")
    save_ivf(ivf, path, fingerprint=ivf_fingerprint(emb))
    back = load_ivf(path, expect_fingerprint=ivf_fingerprint(emb))
    assert back.packed4 == ivf.packed4 and back.capacity == ivf.capacity
    for f in ("centroids", "cbias", "docs", "bias", "scale", "perm"):
        a, b = getattr(ivf, f), getattr(back, f)
        assert (a is None and b is None) or (
            a.dtype == b.dtype and torch.equal(a, b)), f
    assert load_ivf(path, expect_fingerprint="other") is None
    assert ivf_fingerprint(emb) == jivf.ivf_fingerprint(emb)
    # the JAX package reads the port's file and finds the same neighbours
    jback = jivf.load_ivf(path, expect_fingerprint=ivf_fingerprint(emb))
    assert jback.packed4 == ivf.packed4
    np.testing.assert_array_equal(np.asarray(jback.perm), ivf.perm.numpy())
    _, ji = j_ivf_topk(jnp.asarray(q), jback, 8, mode="dot", nprobe=16)
    _, ti = ivf_topk(torch.from_numpy(q), back, 8, mode="dot", nprobe=16)
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(np.asarray(ji), ti.numpy()))
    assert hits >= 0.99 * ti.numel()


def test_from_reference_takes_the_jax_fields_as_numpy():
    emb = _clustered(800, 16, 4, seed=1)
    jl = jivf.build_ivf(emb, "l2", dtype=jnp.bfloat16, n_clusters=8)
    tl = ivf_from_reference({
        "centroids": np.asarray(jl.centroids), "cbias": np.asarray(jl.cbias),
        "docs": np.array(jl.docs).view(np.uint16),
        "dtype_name": "bfloat16", "bias": np.asarray(jl.bias),
        "scale": None, "perm": np.asarray(jl.perm)})
    assert tl.docs.dtype == torch.bfloat16 and tl.scale is None
    np.testing.assert_array_equal(
        tl.docs.to(torch.float32).numpy(),
        np.asarray(jl.docs.astype(jnp.float32)))
    assert tl.device.type == "cpu" and tl.nbytes > 0


def test_shardset_load_caches_the_layout(tmp_path):
    syn = make_synthetic_world("medrag", docs_per_source=512, num_queries=4,
                               seed=15)
    root = str(tmp_path / "root")
    save_world(syn, root)
    ss1 = ShardSet.load(root, syn.world, dtype=torch.float32,
                        ivf_clusters=16)
    caches = [os.path.join(root, "medrag", s.name, "ivf_16_float32_s0.npz")
              for s in syn.world.sources]
    assert all(os.path.exists(c) for c in caches)
    mtimes = [os.path.getmtime(c) for c in caches]
    ss2 = ShardSet.load(root, syn.world, dtype=torch.float32,
                        ivf_clusters=16)
    assert [os.path.getmtime(c) for c in caches] == mtimes      # reused
    assert torch.equal(ss1.shards[0].ivf.perm, ss2.shards[0].ivf.perm)
    assert ss1.aux_bytes == sum(s.ivf.nbytes for s in ss1.shards) > 0
    ShardSet.load(root, syn.world, dtype=torch.float32, ivf_clusters=16,
                  ivf_seed=1)
    assert os.path.exists(os.path.join(root, "medrag", "pubmed",
                                       "ivf_16_float32_s1.npz"))
    # regenerated same-shape embeddings invalidate the cache
    emb_path = os.path.join(root, "medrag", "pubmed", "embeddings.npy")
    stale = np.load(emb_path)
    np.save(emb_path, np.random.default_rng(99).standard_normal(
        stale.shape).astype(np.float32))
    ShardSet.load(root, syn.world, dtype=torch.float32, ivf_clusters=16)
    assert os.path.getmtime(caches[0]) > mtimes[0]


# -- the engine -----------------------------------------------------------------

@pytest.mark.parametrize("impl,dtype,engine_kw,strategy", [
    ("ivf", "float32", {"nprobe": 4}, "ragroute"),
    ("ivf", "float32", {}, "all"),
    ("ivf", "int8", {"nprobe": 16}, "ragroute"),
    ("ivf", "int4", {"nprobe": 16}, "all"),
    ("hybrid", "float32", {}, "ragroute"),
])
def test_engine_matches_jax(tmp_path, impl, dtype, engine_kw, strategy):
    syn, jeng, teng = _pair("medrag", dtype=dtype, impl=impl, nq=16,
                            tmp_path=tmp_path, engine_kw=engine_kw,
                            ivf_clusters=16)
    embs = dict(syn.query_embs)
    _assert_same(teng.search(embs, strategy=strategy),
                 jeng.search(embs, strategy=strategy), syn.world)


def test_engine_hybrid_picks_ivf_by_batch_and_shard_size(tmp_path,
                                                         monkeypatch):
    """Small shards: hybrid is the exact path. With the thresholds opened
    it takes the IVF branch, which at full probe finds the same docs."""
    import ragroute_tpu_torch.engine.engine as eng
    from ragroute_tpu_torch.engine import FederatedSearchEngine

    syn, _, teng = _pair("medrag", impl="hybrid", nq=8, tmp_path=tmp_path,
                         ivf_clusters=16)
    embs = dict(syn.query_embs)
    exact = FederatedSearchEngine(teng.shard_set, teng.router, teng.bank,
                                  impl="exact").search(embs, strategy="all")
    small = teng.search(embs, strategy="all")
    np.testing.assert_array_equal(small.merged_local, exact.merged_local)
    np.testing.assert_array_equal(small.merged_score, exact.merged_score)
    monkeypatch.setattr(eng, "IVF_HYBRID_MIN_DOCS", 1)
    monkeypatch.setattr(eng, "IVF_HYBRID_MAX_BATCH", 1024)
    full = FederatedSearchEngine(teng.shard_set, teng.router, teng.bank,
                                 impl="hybrid", nprobe=16)
    out = full.search(embs, strategy="all")
    for b in range(8):
        assert set(zip(out.merged_shard[b], out.merged_local[b])) == \
            set(zip(exact.merged_shard[b], exact.merged_local[b]))


def test_engine_ivf_requires_the_layout():
    from ragroute_tpu_torch.engine import FederatedSearchEngine

    syn = make_synthetic_world("medrag", docs_per_source=256, num_queries=4,
                               seed=12)
    shard_set = ShardSet.build(syn.world, syn.embeddings,
                               dtype=torch.float32)
    with pytest.raises(ValueError, match="ivf_clusters"):
        FederatedSearchEngine(shard_set, None, None, impl="ivf")
