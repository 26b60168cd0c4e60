"""The port's HTTP server against the JAX ``FederationServer`` (CPU).

Both servers serve the same world with the same router parameters, query
table and doc store; the same requests go to each over localhost. The
responses must have the same JSON structure and bytes, apart from the
per-request random ``query_id`` and the timing fields; the merged docs
come back in the same order.
"""

import asyncio
import json

import pytest
import torch
from threadpoolctl import threadpool_limits

import aiohttp
from ragroute_tpu.engine.batcher import QueryBatcher as JBatcher
from ragroute_tpu.engine.embedding import PrecomputedEmbeddings
from ragroute_tpu.engine.server import FederationServer as JServer
from ragroute_tpu.index.store import MemoryDocStore
from ragroute_tpu_torch.engine.batcher import QueryBatcher
from ragroute_tpu_torch.engine.embedding import \
    PrecomputedEmbeddings as TPrecomputedEmbeddings
from ragroute_tpu_torch.engine.server import FederationServer
from ragroute_tpu_torch.index.store import MemoryDocStore as TMemoryDocStore
from test_torch_engine import _pair

TIMING = ("embedding_time", "selection_time", "doc_select_time", "e2e_time")


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _servers(world_name, strategy="ragroute", **pair_kw):
    """Both servers over one engine pair (``test_torch_engine._pair``:
    ``impl``, ``tmp_path`` and layout arguments pass through)."""
    pair_kw.setdefault("impl", "exact")
    syn, jeng, teng = _pair(world_name, docs=600, nq=8, seed=1, **pair_kw)
    common = dict(strategy=strategy, disable_llm=True, port=0, warmup=False)
    jserver = JServer(
        jeng, embedding_provider=PrecomputedEmbeddings.from_synthetic(syn),
        doc_store=MemoryDocStore.from_synthetic(syn),
        batcher=JBatcher(jeng, strategy=strategy, window_ms=5.0,
                         buckets=(8,)), **common)
    tserver = FederationServer(
        teng, embedding_provider=TPrecomputedEmbeddings.from_synthetic(syn),
        doc_store=TMemoryDocStore.from_synthetic(syn),
        batcher=QueryBatcher(teng, strategy=strategy, window_ms=5.0,
                             buckets=(8,)), **common)
    return syn, jserver, tserver


def _normalize(body: dict) -> str:
    """Blank the random query id and the timing fields; keep key order."""
    def norm(r):
        if "metadata" not in r:
            return r
        r = dict(r, query_id="")
        md = dict(r["metadata"])
        for f in TIMING:
            assert isinstance(md[f], float)
            md[f] = 0.0
        md["data_sources_stats"] = {
            name: dict(st, duration=0.0)
            for name, st in md["data_sources_stats"].items()}
        r["metadata"] = md
        return r
    if "results" in body:
        body = {"results": [norm(r) for r in body["results"]]}
    return json.dumps(norm(body))


async def _run(server, requests):
    await server.start()
    out = []
    try:
        async with aiohttp.ClientSession() as s:
            base = f"http://127.0.0.1:{server.bound_port}"
            for method, path, kw in requests:
                async with s.request(method, base + path, **kw) as r:
                    text = await r.text()
                    out.append((r.status, r.headers.get("Content-Type"),
                                text))
    finally:
        await server.stop()
    return out


def _requests(syn):
    reqs = []
    for q in syn.questions[:6]:
        reqs.append(("GET", "/query", {"params": {
            "q": q["question"], "choices": json.dumps(q["options"]),
            "qid": q["qid"]}}))
    q = syn.questions[6]
    reqs.append(("POST", "/query", {"data": {
        "q": q["question"], "choices": json.dumps(q["options"]),
        "qid": q["qid"]}}))
    reqs.append(("GET", "/query", {"params": {
        "q": "an unknown query", "choices": '{"A": "x"}', "qid": "nope"}}))
    reqs.append(("POST", "/query/batch", {"json": {"queries": [
        {"q": syn.questions[i]["question"],
         "choices": syn.questions[i]["options"],
         "qid": syn.questions[i]["qid"]} for i in range(3)]
        + [{"q": ""}, {"q": "x", "choices": "[bad"}]}}))
    for params in ({}, {"q": "x"}, {"q": "x", "choices": "[bad"}):
        reqs.append(("GET", "/query", {"params": params}))
    reqs.append(("GET", "/healthz", {}))
    return reqs


def _assert_same_responses(syn, jserver, tserver):
    reqs = _requests(syn)
    jout = asyncio.run(_run(jserver, reqs))
    tout = asyncio.run(_run(tserver, reqs))
    n_docs = 0
    for (js, jct, jt), (ts, tct, tt), req in zip(jout, tout, reqs):
        assert (ts, tct) == (js, jct), req
        if js != 200:
            assert tt == jt, req
            continue
        jb, tb = json.loads(jt), json.loads(tt)
        assert _normalize(tb) == _normalize(jb), req
        n_docs += len(jb.get("metadata", {}).get("top_docs", []))
    assert n_docs >= 6 * syn.world.k // 2    # the queries did retrieve


@pytest.mark.parametrize("world_name", ["medrag", "wikipedia"])
def test_server_responses_match_jax_server(world_name):
    _assert_same_responses(*_servers(world_name))


@pytest.mark.parametrize("impl,build_kw,engine_kw", [
    ("ivf", {"ivf_clusters": 16}, {"nprobe": 8}),
    ("lowrank", {"lowrank": -1}, {}),
])
def test_approximate_mode_server_matches_jax_server(tmp_path, impl, build_kw,
                                                    engine_kw):
    """``--impl ivf`` / ``--impl lowrank`` over HTTP: the same bytes from
    both servers (apart from ids and timings) on layouts carried across."""
    _assert_same_responses(*_servers(
        "medrag", impl=impl, tmp_path=tmp_path, engine_kw=engine_kw,
        **build_kw))


def test_hostrefine_server_matches_jax_server():
    """``--impl hostrefine`` over HTTP: both servers run their pipelined
    batcher worker over a shard set built by the JAX package and carried
    across, and answer with the same bytes (apart from ids and timings):
    the refined docs in the same order, ``selection_time`` 0 and the
    message sizes from the coarse-ordered ids."""
    import jax.numpy as jnp

    from ragroute_tpu.engine.streamed import StreamedSearchEngine as JEngine
    from ragroute_tpu.index.streamed import StreamedShardSet as JSet
    from ragroute_tpu.router import RouterBank as JBank
    from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine
    from ragroute_tpu_torch.index import make_synthetic_world
    from ragroute_tpu_torch.index.streamed import streamed_from_reference
    from ragroute_tpu_torch.router import RouterBank
    from test_torch_streamed import _carry, _router

    syn = make_synthetic_world("medrag", docs_per_source=700, num_queries=8,
                               seed=1)
    params, router = _router(syn.world, key=3)
    jss = JSet.build(syn.world, syn.embeddings, doc_ids=syn.doc_ids,
                     dtype=jnp.int8, tier="hostrefine", hbm_budget_bytes=0)
    jeng = JEngine(jss, params, JBank.create(syn.world, syn.centroids))
    tss = streamed_from_reference(_carry(jss, "int8"))
    tss.doc_ids = {name: list(ids) for name, ids in syn.doc_ids.items()}
    teng = StreamedSearchEngine(
        tss, router, RouterBank.create(syn.world, syn.centroids))
    assert teng.supports_pipelined_dispatch and all(teng._has_coarse)
    common = dict(strategy="ragroute", disable_llm=True, port=0, warmup=False)
    jserver = JServer(
        jeng, embedding_provider=PrecomputedEmbeddings.from_synthetic(syn),
        doc_store=MemoryDocStore.from_synthetic(syn),
        batcher=JBatcher(jeng, strategy="ragroute", window_ms=5.0,
                         buckets=(8,)), **common)
    tserver = FederationServer(
        teng, embedding_provider=TPrecomputedEmbeddings.from_synthetic(syn),
        doc_store=TMemoryDocStore.from_synthetic(syn),
        batcher=QueryBatcher(teng, strategy="ragroute", window_ms=5.0,
                             buckets=(8,)), **common)
    _assert_same_responses(syn, jserver, tserver)


def test_stats_and_unported_stream():
    syn, _, tserver = _servers("medrag", strategy="all")

    async def run():
        await tserver.start()
        try:
            async with aiohttp.ClientSession() as s:
                base = f"http://127.0.0.1:{tserver.bound_port}"
                q = syn.questions[0]
                params = {"q": q["question"], "qid": q["qid"],
                          "choices": json.dumps(q["options"])}
                async with s.get(base + "/query", params=params) as r:
                    body = await r.json()
                    assert len(body["metadata"]["top_docs"]) == syn.world.k
                async with s.get(base + "/query",
                                 params=dict(params, stream="1")) as r:
                    # SSE: the final event with the whole body, then [DONE]
                    assert r.status == 200
                    assert r.content_type == "text/event-stream"
                    events = (await r.text()).split("\n\n")
                    assert events[-2:] == ["data: [DONE]", ""]
                    final = json.loads(events[-3][len("data: "):])
                    assert len(final["metadata"]["top_docs"]) == syn.world.k
                async with s.get(base + "/stats") as r:
                    return await r.json()
        finally:
            await tserver.stop()

    stats = asyncio.run(run())
    assert stats["num_queries"] == 2
    assert stats["batch_size"]["max"] == 1.0
    assert stats["device_memory"] is None       # CPU engine
