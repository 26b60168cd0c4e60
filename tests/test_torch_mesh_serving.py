"""The port served over a mesh (CPU): ``/query`` bodies, the system boot,
the native front end, and the hostrefine tier over a mesh.

A mesh of the port is ``[torch.device("cpu")] * 8``; the JAX package's runs
on the eight virtual CPU devices ``conftest.py`` forces. Bodies are compared
with the random query id and the timings blanked (``torch_serving.
normalize``): the port's mesh server against its single-device server byte
for byte, and against the JAX mesh server. The hostrefine tier over a mesh
equals the single-device tier; a world with no coarse slab, where the JAX
package's mesh engine raises (R2: it concatenates an empty list), is served.
"""

import json

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from ragroute_tpu.engine.native_frontend import \
    NativeFederationServer as JNative
from ragroute_tpu.parallel import MeshStreamedEngine as JMeshStreamed
from ragroute_tpu.parallel import ShardedSearch as JSharded
from ragroute_tpu.parallel import make_mesh as jmake_mesh
from ragroute_tpu.router import RouterBank as JBank
from ragroute_tpu_torch.engine.native_frontend import NativeFederationServer
from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.index.streamed import StreamedShardSet
from ragroute_tpu_torch.main import parse_args
from ragroute_tpu_torch.parallel import (MeshStreamedEngine, ShardedSearch,
                                         make_mesh)
from ragroute_tpu_torch.system import ServingSystem
from torch_serving import (_params, normalize, port_engine, query_path,
                           request, same_answers, servers, serving, world)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def syn():
    return world(docs=600, nq=8, seed=1)


def _mesh_engines(syn, strategy_key=3):
    """The JAX mesh engine, the port's mesh engine and the port's
    single-device engine (exact, f32, one router)."""
    from ragroute_tpu.index import ShardSet as JShardSet

    jss = JShardSet.build(syn.world, syn.embeddings, doc_ids=syn.doc_ids,
                          dtype=jnp.float32, device="host")
    jeng = JSharded(jss, _params(syn, strategy_key),
                    JBank.create(syn.world, syn.centroids),
                    jmake_mesh(dp=2, idx=4), impl="exact")
    single = port_engine(syn, ShardSet.build(
        syn.world, syn.embeddings, doc_ids=syn.doc_ids, dtype=torch.float32),
        strategy_key)
    mesh_set = ShardSet.build(syn.world, syn.embeddings, doc_ids=syn.doc_ids,
                              dtype=torch.float32, device="host")
    teng = ShardedSearch(mesh_set, single.router, single.bank,
                         make_mesh(2, 4, devices=CPU8), impl="exact")
    return jeng, teng, single


def _paths(syn):
    paths = [query_path(q["question"], q["options"], q["qid"])
             for q in syn.questions]
    # an unknown qid (hash embedding) and a malformed request
    paths.append(query_path("what is a fox", {"A": "x"}, "unknown-qid"))
    paths.append("/query?q=x")
    return paths


@pytest.mark.parametrize("strategy,front", [("all", "aiohttp"),
                                            ("ragroute", "native"),
                                            ("none", "aiohttp")])
def test_mesh_bodies_equal_single_device_and_jax(syn, strategy, front):
    """Served ``/query`` over a 2x4 mesh: the port's bodies equal its
    single-device server's byte for byte and the JAX mesh server's; under
    ``none`` every query routes to no shard and answers 200 with no docs."""
    jeng, teng, single = _mesh_engines(syn)
    js, ts = servers(syn, jeng, teng, strategy=strategy)
    _, ss = servers(syn, jeng, single, strategy=strategy)
    paths = _paths(syn)
    native = front == "native"
    with serving(js, JNative if native else None) as port:
        jout = [request(port, "GET", p) for p in paths]
    with serving(ts, NativeFederationServer if native else None) as port:
        tout = [request(port, "GET", p) for p in paths]
    with serving(ss, NativeFederationServer if native else None) as port:
        sout = [request(port, "GET", p) for p in paths]
    same_answers(jout, tout, paths)
    for (st, _, tb), (ss_, _, sb) in zip(tout, sout):
        assert st == ss_
        if st == 200:
            assert normalize(tb) == normalize(sb)
    ndocs = [len(json.loads(b)["metadata"]["top_docs"])
             for st, _, b in tout if st == 200]
    if strategy == "none":
        assert ndocs == [0] * len(ndocs)
    else:
        assert max(ndocs) == syn.world.k


def _system_args(**kw):
    argv = ["--dataset", "medrag", "--simulate", "--disable-llm", "--device",
            "cpu", "--dtype", "float32", "--port", "0", "--routing", "all"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", *([str(v)] if v is not True
                                              else [])]
    return parse_args(argv)


def test_system_boots_a_mesh_and_keeps_the_device_count_errors(monkeypatch):
    """``--mesh 2x4 --device cpu`` with the CPU named eight times: the
    sharded engine behind HTTP, the buckets rounded up to multiples of
    dp; too few devices fails with JAX's error, naming the device list."""
    monkeypatch.setenv("RAGROUTE_LOCAL_DEVICES", "8")
    system = ServingSystem(_system_args(mesh="2x4"))
    system.buckets = [3, 8]
    server = system.build()
    assert isinstance(server.engine, ShardedSearch)
    assert server.engine.mesh.shape == {"dp": 2, "idx": 4}
    assert server.batcher.buckets == (4, 8)
    with serving(server) as port:
        st, _, body = request(port, "GET", query_path("test", {"A": "x"},
                                                      "q0"))
        health = json.loads(request(port, "GET", "/healthz")[2])
    assert st == 200
    assert len(json.loads(body)["metadata"]["data_sources"]) == 4
    assert health["index_bytes"] == server.engine.shard_set.index_bytes > 0
    monkeypatch.setenv("RAGROUTE_LOCAL_DEVICES", "2")
    with pytest.raises(ValueError, match="needs 8 devices, have 2.*"
                       "RAGROUTE_LOCAL_DEVICES=8"):
        ServingSystem(_system_args(mesh="2x4")).build()
    with pytest.raises(ValueError, match="DPxIDX"):
        ServingSystem(_system_args(mesh="8")).build()


def _hostrefine_sets(syn, budget):
    kw = dict(dtype="int8", tier="hostrefine", hbm_budget_bytes=budget,
              cluster_coarse=False)
    return (StreamedShardSet.build(syn.world, syn.embeddings, **kw),
            StreamedShardSet.build(syn.world, syn.embeddings, **kw))


@pytest.fixture(scope="module")
def mixed():
    """Mixed residency: two exact resident sources, two coarse + host."""
    sizes = {"pubmed": 1024, "statpearls": 512, "textbooks": 1024,
             "wikipedia": 512}
    return make_synthetic_world("medrag", docs_per_source_map=sizes,
                                num_queries=16, seed=7)


@pytest.mark.parametrize("strategy", ["ragroute", "all"])
def test_hostrefine_mesh_equals_the_single_device_tier(mixed, strategy):
    """``--impl hostrefine --mesh``: coarse slabs and resident rows
    row-sharded, candidates gathered, the host rescore unchanged; every
    field equals the single-device tier's, both copy modes."""
    syn = mixed
    single = port_engine(syn, ShardSet.build(syn.world, syn.embeddings))
    a, b = _hostrefine_sets(syn, 2 * 512 * (768 + 8) + 1024)
    assert any(s.coarse_docs is not None for s in a.sources)
    assert any(s.res_docs is not None for s in a.sources)
    ref = StreamedSearchEngine(a, single.router, single.bank)
    eng = MeshStreamedEngine(b, single.router, single.bank,
                             make_mesh(2, 4, devices=CPU8))
    assert eng.supports_pipelined_dispatch
    embs = dict(syn.query_embs)
    for fetch in (False, True):
        x = ref.search(embs, strategy=strategy, fetch_candidates=fetch)
        y = eng.search(embs, strategy=strategy, fetch_candidates=fetch)
        for f in ("mask", "merged_shard", "merged_local", "merged_valid",
                  "shard_ids", "msg_base"):
            got, want = getattr(y, f), getattr(x, f)
            assert (got is None) == (want is None), f
            if want is not None:
                np.testing.assert_array_equal(got, want, f)
        np.testing.assert_allclose(y.merged_score, x.merged_score,
                                   rtol=1e-5, atol=1e-5, equal_nan=True)
    with pytest.raises(ValueError, match="tier='hostrefine'"):
        MeshStreamedEngine(StreamedShardSet.build(
            syn.world, syn.embeddings, dtype="int8", tier="stream"),
            single.router, single.bank, make_mesh(2, 4, devices=CPU8))


def test_world_without_coarse_slab_is_served_where_jax_raises(syn):
    """R2 of the JAX package: its mesh hostrefine engine concatenates an
    empty list when no source has a coarse slab (every source fits the
    budget) and raises; the port takes the per-source path and answers as
    the single-device tier does."""
    from ragroute_tpu.index.streamed import StreamedShardSet as JStreamed

    single = port_engine(syn, ShardSet.build(syn.world, syn.embeddings))
    a, b = _hostrefine_sets(syn, 1 << 30)
    assert all(s.coarse_docs is None for s in a.sources)
    ref = StreamedSearchEngine(a, single.router, single.bank)
    eng = MeshStreamedEngine(b, single.router, single.bank,
                             make_mesh(1, 8, devices=CPU8))
    embs = dict(syn.query_embs)
    x = ref.search(embs, strategy="all", fetch_candidates=False)
    y = eng.search(embs, strategy="all", fetch_candidates=False)
    np.testing.assert_array_equal(y.merged_local, x.merged_local)
    np.testing.assert_array_equal(y.merged_shard, x.merged_shard)
    jss = JStreamed.build(syn.world, syn.embeddings, dtype=jnp.int8,
                          tier="hostrefine", hbm_budget_bytes=1 << 30,
                          cluster_coarse=False)
    jeng = JMeshStreamed(jss, _params(syn, 0),
                         JBank.create(syn.world, syn.centroids),
                         jmake_mesh(dp=1, idx=8))
    with pytest.raises(ValueError, match="at least one array"):
        jeng.search(embs, strategy="all", fetch_candidates=False)


def test_system_serves_hostrefine_over_a_mesh(monkeypatch):
    monkeypatch.setenv("RAGROUTE_LOCAL_DEVICES", "4")
    server = ServingSystem(_system_args(mesh="1x4", impl="hostrefine",
                                        dtype="int8")).build()
    assert isinstance(server.engine, MeshStreamedEngine)
    with serving(server) as port:
        st, _, body = request(port, "GET", query_path("test", {"A": "x"},
                                                      "q0"))
    assert st == 200 and json.loads(body)["metadata"]["top_docs"]
