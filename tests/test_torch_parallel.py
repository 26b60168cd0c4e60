"""The port's mesh-sharded search against the JAX package's (CPU).

The JAX side runs on the eight virtual CPU devices ``conftest.py`` forces;
the port's on ``make_mesh(dp, idx, devices=[torch.device("cpu")] * 8)``
with its kernels' plain versions. Same inputs from a seed; winners equal in
the same order (ties to the lower global index, FAISS's order) where the
data ties exactly; on synthetic worlds the merged lists and the routed
per-shard lists equal but where two scores lie within the f32
summation-order tolerance (``rtol=1e-5``, ``atol = 1e-5 x max|score|``, as
``tests/test_torch_engine.py`` states it); the port's mesh equals the
port's single-device engine winner for winner. IVF is compared on one
layout (the JAX build's, carried over through the ``.npz`` files both
packages read), as in ``tests/test_torch_ivf.py``.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from ragroute_tpu.index import ShardSet as JShardSet
from ragroute_tpu.index.ivf import build_ivf as jbuild_ivf
from ragroute_tpu.parallel import ShardedSearch as JSharded
from ragroute_tpu.parallel import make_mesh as jmake_mesh
from ragroute_tpu.parallel import sharded_ivf_topk as jsharded_ivf
from ragroute_tpu.parallel import sharded_shard_topk as jsharded_topk
from ragroute_tpu.router import RouterBank as JBank
from ragroute_tpu.router import init_router_params
from ragroute_tpu_torch.engine import FederatedSearchEngine
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.index.ivf import build_ivf, load_ivf
from ragroute_tpu_torch.ops.ivf_topk import ivf_topk
from ragroute_tpu_torch.ops.topk import exact_topk
from ragroute_tpu_torch.parallel import (ShardedSearch, make_mesh,
                                         parse_mesh_spec, sharded_ivf_topk,
                                         sharded_shard_topk)
from ragroute_tpu_torch.parallel.sharded import MeshRows
from ragroute_tpu_torch.router import (CorpusRouter, RouterBank,
                                       params_from_jax)
from test_torch_engine import _assert_same_merge, carry_layouts

CPU8 = [torch.device("cpu")] * 8
MESHES = [(2, 4), (1, 8)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def jmeshes():
    return {(dp, idx): jmake_mesh(dp=dp, idx=idx)
            for dp, idx in MESHES + [(4, 2)]}


def tmesh(dp, idx):
    return make_mesh(dp, idx, devices=CPU8[:dp * idx])


def test_mesh_construction():
    assert len(jax.devices()) == 8
    for dp, idx in ((2, None), (1, 8), (4, 2)):
        m = make_mesh(dp, idx, devices=CPU8)
        assert m.shape == dict(jmake_mesh(dp=dp, idx=idx).shape)
        assert m.axis_names == ("dp", "idx")
    for bad in ((3, None), (2, 3)):
        with pytest.raises(ValueError):
            make_mesh(*bad, devices=CPU8)
        with pytest.raises(ValueError):
            jmake_mesh(dp=bad[0], idx=bad[1])
    # one device named more than once: cells share it, slices are views
    m = make_mesh(1, 4, devices=CPU8[:4])
    full = torch.arange(16.0).reshape(8, 2)
    rows = MeshRows(m, full)
    assert rows.parts[0][1].data_ptr() == full[2:4].data_ptr()
    assert parse_mesh_spec("2x4") == (2, 4)
    with pytest.raises(ValueError, match="DPxIDX"):
        parse_mesh_spec("8")
    if not torch.cuda.is_available():
        assert make_mesh(1).devices == ((torch.device("cpu"),),)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("mode", ["dot", "l2", "cos"])
def test_sharded_topk_matches_jax(rng, jmeshes, mesh_shape, mode):
    """Integer data: exact ties everywhere, so the order of equal gains
    (the lower global index first) is held, not only the sets."""
    from ragroute_tpu.ops.topk import doc_bias

    b, n, d, k = 8, 4096, 32, 16
    q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    docs = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    if mode == "cos":
        docs /= np.maximum(np.linalg.norm(docs, axis=1, keepdims=True), 1)
    jb = doc_bias(jnp.asarray(docs), mode)
    jb = jnp.zeros((n,), jnp.float32) if jb is None else jb
    js, ji = jsharded_topk(jmeshes[mesh_shape], jnp.asarray(q),
                           jnp.asarray(docs), jb, k, mode=mode, impl="exact")
    ts, ti = sharded_shard_topk(tmesh(*mesh_shape), torch.from_numpy(q),
                                torch.from_numpy(docs),
                                torch.from_numpy(np.array(jb)), k,
                                mode=mode)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    s1, i1 = exact_topk(torch.from_numpy(q), torch.from_numpy(docs), k,
                        mode=mode)
    np.testing.assert_array_equal(ti.numpy(), i1.numpy())


def test_sharded_topk_padding_unselectable(rng):
    b, n, d, k, valid = 4, 2048, 16, 8, 1500
    q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    docs = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    docs[valid:] = 50.0
    bias = torch.zeros(n)
    bias[valid:] = float("-inf")
    _, i = sharded_shard_topk(tmesh(1, 8), torch.from_numpy(q),
                              torch.from_numpy(docs), bias, k)
    assert i.numpy().max() < valid
    # a row count that is no multiple of idx pads with unselectable rows
    _, i = sharded_shard_topk(tmesh(1, 8), torch.from_numpy(q),
                              MeshRows(tmesh(1, 8), torch.from_numpy(
                                  docs[:1500])),
                              MeshRows(tmesh(1, 8), torch.zeros(1500),
                                       pad=float("-inf")), k)
    assert i.numpy().max() < valid


def _params(syn, key=1):
    params = init_router_params(jax.random.key(key),
                                syn.world.router_input_dim)
    router = CorpusRouter(syn.world.router_input_dim)
    router.load_state_dict(params_from_jax(params))
    return params, router.eval()


def _dt(name, pkg):
    if name == "int4":
        return "int4"
    return getattr(jnp if pkg == "jax" else torch, name)


def _three(world_name, dtype="float32", *, docs=1024, nq=16, seed=5,
           key=1, mesh_shape=(2, 4), jmeshes=None, impl="exact",
           tmp_path=None, **build_kw):
    """The JAX mesh engine, the port's mesh engine and the port's
    single-device engine over one world (approximate layouts: the JAX
    build's, carried over)."""
    syn = make_synthetic_world(world_name, docs_per_source=docs,
                               num_queries=nq, seed=seed,
                               with_payloads=False)
    params, router = _params(syn, key)

    def jset():
        return JShardSet.build(syn.world, syn.embeddings,
                               dtype=_dt(dtype, "jax"), **build_kw)

    def tset(device="cpu"):
        ts = ShardSet.build(syn.world, syn.embeddings,
                            dtype=_dt(dtype, "torch"), device=device)
        if build_kw:
            carry_layouts(jset(), ts, tmp_path)
        return ts

    jeng = JSharded(jset(), params, JBank.create(syn.world, syn.centroids),
                    jmeshes[mesh_shape], impl=impl)
    bank = RouterBank.create(syn.world, syn.centroids)
    teng = ShardedSearch(tset("host"), router, bank, tmesh(*mesh_shape),
                         impl=impl)
    single = FederatedSearchEngine(tset(), router, bank, impl=impl)
    return syn, jeng, teng, single


def _same_as_single(t, e):
    """The port's mesh against its single-device engine: masks equal, the
    merged lists equal but for near-ties (two f32 summation orders)."""
    for f in ("mask", "merged_valid"):
        np.testing.assert_array_equal(getattr(t, f), getattr(e, f), f)
    _assert_same_merge(t, e, np.ones(len(t.mask), bool))


def _same_as_jax(t, j, world):
    """The port's mesh step against the JAX mesh step: probabilities within
    1e-5, masks equal (rows within 1e-5 of the threshold left out), merged
    lists equal but for near-ties, and each routed (query, shard) candidate
    list equal position by position but where two scores are within the
    f32 tolerance (the JAX engine scores unrouted shards as well, the
    port's skips them: those lists are not compared)."""
    np.testing.assert_allclose(t.probs, j.probs, atol=1e-5, rtol=0)
    rows = ~(np.abs(j.probs - world.router_threshold) < 1e-5).any(axis=1)
    assert rows.sum() > 0
    np.testing.assert_array_equal(t.mask[rows], j.mask[rows])
    np.testing.assert_array_equal(t.merged_valid[rows], j.merged_valid[rows])
    _assert_same_merge(t, j, rows)
    finite = np.abs(j.shard_scores[np.isfinite(j.shard_scores)])
    tol = 1e-5 * float(finite.max(initial=1.0))
    routed = t.mask & rows[:, None]
    ts, js = t.shard_scores[routed], j.shard_scores[routed]
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=tol)
    ti, ji = t.shard_ids[routed], j.shard_ids[routed]
    for r, p in zip(*np.nonzero(ti != ji)):
        near = np.abs(js[r] - js[r, p]) <= tol
        assert near.sum() > 1 and ti[r, p] in ji[r][near], (r, p)


@pytest.mark.parametrize("world_name,dtype,strategy,mesh_shape", [
    ("medrag", "float32", "all", (2, 4)),
    ("medrag", "float32", "ragroute", (1, 8)),
    ("feb4rag", "float32", "all", (2, 4)),
    ("wikipedia", "float32", "ragroute", (2, 4)),
    ("medrag", "int8", "all", (2, 4)),
    ("medrag", "int4", "ragroute", (1, 8)),
])
def test_full_step_matches_jax_and_single_device(jmeshes, world_name, dtype,
                                                 strategy, mesh_shape):
    """Route, score (K1 per cell), gather, merge: the JAX mesh engine's
    winners, and the port's single-device engine's."""
    syn, jeng, teng, single = _three(world_name, dtype, nq=16,
                                     mesh_shape=mesh_shape, jmeshes=jmeshes,
                                     docs=600 if world_name == "feb4rag"
                                     else 1024)
    embs = dict(syn.query_embs)
    t = teng.search(embs, strategy=strategy)
    j = jeng.search(embs, strategy=strategy)
    _same_as_jax(t, j, syn.world)
    _same_as_single(t, single.search(embs, strategy=strategy))
    if strategy == "ragroute":
        np.testing.assert_array_equal(
            t.mask, t.probs > syn.world.router_threshold)


def test_compaction_per_cell_matches_uncompacted(jmeshes):
    """A 4x2 mesh over a 64-query ragroute batch: rows where at most half
    route to a shard score a half batch; the winners do not move."""
    syn, jeng, teng, single = _three("medrag", nq=64, seed=9, key=3,
                                     mesh_shape=(4, 2), jmeshes=jmeshes)
    embs = dict(syn.query_embs)
    t = teng.search(embs, strategy="ragroute")
    counts = t.mask.reshape(4, 16, -1).sum(axis=1)
    assert ((counts > 0) & (counts <= 8)).any()
    _same_as_jax(t, jeng.search(embs, strategy="ragroute"), syn.world)
    full = FederatedSearchEngine(single.shard_set, single.router,
                                 single.bank, compaction=False)
    _same_as_single(t, full.search(embs, strategy="ragroute"))


@pytest.mark.parametrize("impl,strategy", [("lowrank", "all"),
                                           ("lowrank", "ragroute"),
                                           ("ivf", "all"),
                                           ("hybrid", "ragroute")])
def test_approximate_modes_match_jax(jmeshes, tmp_path, impl, strategy):
    kw = ({"lowrank": -1} if impl == "lowrank"
          else {"ivf_clusters": 16})
    syn, jeng, teng, single = _three("medrag", nq=16, seed=15, impl=impl,
                                     jmeshes=jmeshes, tmp_path=tmp_path,
                                     **kw)
    embs = dict(syn.query_embs)
    t = teng.search(embs, strategy=strategy)
    _same_as_jax(t, jeng.search(embs, strategy=strategy), syn.world)
    _same_as_single(t, single.search(embs, strategy=strategy))


def _carry_ivf(jl, tmp_path, name):
    from ragroute_tpu.index.ivf import save_ivf

    path = str(tmp_path / f"{name}.npz")
    save_ivf(jl, path)
    return load_ivf(path)


@pytest.mark.parametrize("mode,dtype,nprobe,vs_jax", [
    ("dot", "float32", 4, True), ("l2", "float32", 16, False),
    ("dot", "int8", 16, False), ("l2", "int4", 4, True)])
def test_sharded_ivf_matches_jax_and_single_device(rng, jmeshes, tmp_path,
                                                   mode, dtype, nprobe,
                                                   vs_jax):
    """Cluster axis sharded over idx: each pair scored by its cluster's
    owner (K3 on the local slabs, K2 per pair), one final top-k. Equal to
    the port's single-device IVF bit for bit (which
    ``tests/test_torch_ivf.py`` holds to the JAX package's), and to the
    JAX mesh path (two cases: its CPU lowering takes seconds a case)."""
    b, n, d, k = 8, 2000, 32, 8
    docs = (rng.standard_normal((n, d))
            * rng.uniform(0.1, 10.0, (n, 1))).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    jl = jbuild_ivf(docs, mode, dtype=_dt(dtype, "jax"), n_clusters=16,
                    seed=3)
    tl = _carry_ivf(jl, tmp_path, f"{mode}_{dtype}")
    qt = torch.from_numpy(q)
    ts, ti = sharded_ivf_topk(tmesh(2, 4), qt, tl, k, mode=mode,
                              nprobe=nprobe)
    s1, i1 = ivf_topk(qt, tl, k, mode=mode, nprobe=nprobe)
    np.testing.assert_array_equal(ti.numpy(), i1.numpy())
    np.testing.assert_array_equal(ts.numpy(), s1.numpy())
    if not vs_jax:
        return
    js, ji = jsharded_ivf(jmeshes[(2, 4)], jnp.asarray(q), jl, k,
                          mode=mode, nprobe=nprobe)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    for row in range(b):
        assert set(ti[row].tolist()) == set(np.asarray(ji)[row].tolist())


def test_sharded_ivf_full_probe_equals_exact(rng):
    b, n, d, k = 4, 2000, 24, 8
    docs = rng.standard_normal((n, d)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    ivf = build_ivf(docs, "dot", dtype=torch.float32, n_clusters=32, seed=4)
    s, i = sharded_ivf_topk(tmesh(1, 8), q, ivf, k, mode="dot", nprobe=32)
    s_ref, i_ref = exact_topk(q, torch.from_numpy(docs), k)
    np.testing.assert_allclose(s.numpy(), s_ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), i_ref.numpy())


def test_ivf_built_on_the_mesh_equals_the_single_device_build(rng, jmeshes):
    """Lloyd sums per cell, added across cells: on well-separated data the
    layout equals the single-device build's at the same seed; the JAX
    mesh build agrees on the centroids, and the layout searches right."""
    centers = rng.standard_normal((16, 32)).astype(np.float32) * 50
    docs = (centers[rng.integers(0, 16, 4000)]
            + rng.standard_normal((4000, 32))).astype(np.float32)
    a = build_ivf(docs, "dot", dtype=torch.float32, n_clusters=16, seed=3)
    b = build_ivf(docs, "dot", dtype=torch.float32, n_clusters=16, seed=3,
                  mesh=tmesh(2, 4))
    np.testing.assert_allclose(a.centroids.numpy(), b.centroids.numpy(),
                               rtol=1e-5, atol=1e-5)
    for f in ("perm", "bias", "docs"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy())
    j = jbuild_ivf(docs, "dot", dtype=jnp.float32, n_clusters=16, seed=3,
                   mesh=jmeshes[(2, 4)])
    np.testing.assert_allclose(np.asarray(j.centroids), b.centroids.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(j.perm), b.perm.numpy())
    q = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    _, i_sh = sharded_ivf_topk(tmesh(2, 4), q, b, 8, mode="dot", nprobe=16)
    _, i_ref = exact_topk(q, torch.from_numpy(docs), 8)
    for row in range(8):
        assert set(i_sh[row].tolist()) == set(i_ref[row].tolist())


def test_host_staged_build_is_retired_and_refuses_mutable():
    """``ShardSet.build(device="host")`` stages CPU tensors; the mesh
    engine places each cell's slice and the set then holds the sharded
    copies (the index bytes add up alike). Mutable sets are refused."""
    syn = make_synthetic_world("medrag", docs_per_source=1024, num_queries=8,
                               seed=11, with_payloads=False)
    _, router = _params(syn)
    bank = RouterBank.create(syn.world, syn.centroids)
    host = ShardSet.build(syn.world, syn.embeddings, dtype=torch.float32,
                          device="host")
    nbytes = host.index_bytes
    eng = ShardedSearch(host, router, bank, tmesh(2, 4))
    for i, s in enumerate(host.shards):
        assert s.docs is eng.arrays[i]["docs"]
    assert host.index_bytes == nbytes
    dev = ShardSet.build(syn.world, syn.embeddings, dtype=torch.float32)
    embs = dict(syn.query_embs)
    _same_as_single(eng.search(embs, strategy="all"),
                    FederatedSearchEngine(dev, router, bank).search(
                        embs, strategy="all"))
    live = ShardSet.build(syn.world, syn.embeddings, mutable=True,
                          reserve_docs=64)
    with pytest.raises(ValueError, match="mutable ShardSets"):
        ShardedSearch(live, router, bank, tmesh(2, 4))
    with pytest.raises(ValueError, match="mesh staging"):
        ShardSet.build(syn.world, syn.embeddings, device="host",
                       mutable=True)
    with pytest.raises(ValueError, match="not divisible by mesh dp"):
        eng.search({e: v[:3] for e, v in embs.items()}, strategy="all")
