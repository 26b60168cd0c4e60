"""Helpers of the tests that serve one world from the JAX package and from
the port side by side (``test_torch_native_frontend.py``,
``test_torch_live_updates.py``, ``test_torch_snapshot.py``,
``test_torch_sse_profile.py``): both engines over the same world with the
same router parameters, both servers on ephemeral ports, a blocking HTTP
client, and the normalisation that blanks what legitimately differs (the
random query id and the timings).
"""

import asyncio
import contextlib
import http.client
import json
import threading
from typing import Optional
from urllib.parse import quote

import jax
import jax.numpy as jnp
import torch

from ragroute_tpu.engine import FederatedSearchEngine as JEngine
from ragroute_tpu.engine.batcher import QueryBatcher as JBatcher
from ragroute_tpu.engine.embedding import PrecomputedEmbeddings as JEmb
from ragroute_tpu.engine.llm import LLMClient as JLLM
from ragroute_tpu.engine.server import FederationServer as JServer
from ragroute_tpu.index import ShardSet as JShardSet
from ragroute_tpu.index.store import MemoryDocStore as JStore
from ragroute_tpu.router import RouterBank as JBank
from ragroute_tpu.router import init_router_params
from ragroute_tpu_torch.engine import FederatedSearchEngine
from ragroute_tpu_torch.engine.batcher import QueryBatcher
from ragroute_tpu_torch.engine.embedding import PrecomputedEmbeddings
from ragroute_tpu_torch.engine.llm import LLMClient
from ragroute_tpu_torch.engine.server import FederationServer
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.index.store import MemoryDocStore
from ragroute_tpu_torch.router import (CorpusRouter, RouterBank,
                                       params_from_jax)

TIMING = ("embedding_time", "selection_time", "doc_select_time", "e2e_time",
          "generate_time")
DTYPES = ("float32", "bfloat16", "int8", "int4")


def dtypes(name: str):
    """The JAX and the port's storage dtype for one name."""
    if name == "int4":
        return "int4", "int4"
    return getattr(jnp, name), getattr(torch, name)


def world(docs: int = 600, nq: int = 8, seed: int = 1):
    return make_synthetic_world("medrag", docs_per_source=docs,
                                num_queries=nq, seed=seed)


def shard_sets(syn, embeddings=None, doc_ids=None, dtype="float32",
               **build_kw):
    """The JAX and the port's shard sets of one world."""
    embeddings = syn.embeddings if embeddings is None else embeddings
    doc_ids = syn.doc_ids if doc_ids is None else doc_ids
    jd, td = dtypes(dtype)
    jss = JShardSet.build(syn.world, embeddings, doc_ids=doc_ids, dtype=jd,
                          **build_kw)
    tss = ShardSet.build(syn.world, embeddings, doc_ids=doc_ids, dtype=td,
                         **build_kw)
    return jss, tss


def _params(syn, key: int):
    return init_router_params(jax.random.key(key),
                              syn.world.router_input_dim)


def port_engine(syn, tss, key: int = 0):
    """The port's exact engine with the router parameters of
    :func:`engines`."""
    router = CorpusRouter(syn.world.router_input_dim)
    router.load_state_dict(params_from_jax(_params(syn, key)))
    return FederatedSearchEngine(
        tss, router.eval(), RouterBank.create(syn.world, syn.centroids),
        impl="exact")


def engines(syn, jss, tss, key: int = 0):
    """Both exact engines with the same router parameters."""
    jeng = JEngine(jss, _params(syn, key),
                   JBank.create(syn.world, syn.centroids), impl="exact")
    return jeng, port_engine(syn, tss, key)


def servers(syn, jeng, teng, *, strategy="all", disable_llm=True,
            llm=None, data_root=None, reuse_port=False):
    """The JAX and the port's ``FederationServer`` over the two engines
    (ephemeral ports, no warm-up, one bucket of 8). ``llm``: a pair of
    LLM clients, else the echo backend on both."""
    jllm, tllm = llm or (JLLM("echo"), LLMClient("echo"))
    common = dict(strategy=strategy, disable_llm=disable_llm, port=0,
                  warmup=False, data_root=data_root, reuse_port=reuse_port)
    js = JServer(jeng, embedding_provider=JEmb.from_synthetic(syn),
                 doc_store=JStore.from_synthetic(syn), llm=jllm,
                 batcher=JBatcher(jeng, strategy=strategy, window_ms=5.0,
                                  buckets=(8,)), **common)
    ts = FederationServer(
        teng, embedding_provider=PrecomputedEmbeddings.from_synthetic(syn),
        doc_store=MemoryDocStore.from_synthetic(syn), llm=tllm,
        batcher=QueryBatcher(teng, strategy=strategy, window_ms=5.0,
                             buckets=(8,)), **common)
    return js, ts


@contextlib.contextmanager
def serving(server, native: Optional[type] = None, before_stop=None):
    """Run an aiohttp ``server`` on an event loop in a thread, or, with
    ``native`` (a ``NativeFederationServer`` class), through the native
    front end in its loop thread; yields the bound port. ``before_stop``:
    a coroutine function run on the loop that served the generation (a
    generation service's ``stop``) before the server stops."""
    if native is not None:
        ns = native(server)
        ns.start(thread=True)
        try:
            yield ns.bound_port
        finally:
            if before_stop is not None:
                asyncio.run_coroutine_threadsafe(
                    before_stop(), ns._fin_loop).result(60)
            ns.stop()
        return
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(60)
        yield server.bound_port
    finally:
        if before_stop is not None:
            asyncio.run_coroutine_threadsafe(before_stop(), loop).result(60)
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
        assert not thread.is_alive()


def request(port, method, path, body=None, headers=None, timeout=120):
    """One request on a fresh connection: ``(status, content type,
    body bytes)``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body)
            headers = {"Content-Type": "application/json", **(headers or {})}
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def query_path(q, choices, qid, extra=""):
    return (f"/query?q={quote(q)}&choices={quote(json.dumps(choices))}"
            f"&qid={qid}{extra}")


def normalize(body) -> str:
    """A ``/query`` or ``/query/batch`` body with the random query id and
    the timing fields blanked, key order kept."""
    def norm(r):
        if not isinstance(r, dict) or "metadata" not in r:
            return r
        r = dict(r, query_id="")
        md = dict(r["metadata"])
        for f in TIMING:
            md[f] = 0.0
        md["data_sources_stats"] = {
            name: dict(st, duration=0.0)
            for name, st in md["data_sources_stats"].items()}
        r["metadata"] = md
        return r
    if isinstance(body, (bytes, str)):
        body = json.loads(body)
    if isinstance(body, dict) and "results" in body:
        body = {"results": [norm(r) for r in body["results"]]}
    return json.dumps(norm(body))


def sse_events(body: bytes) -> list:
    """The ``data:`` payloads of an SSE body, in order."""
    return [e[len("data: "):] for e in body.decode().split("\n\n")
            if e.startswith("data: ")]


def same_answers(jout, tout, what):
    """The JAX and the port's answers to one list of requests agree:
    status, content type and body, the body normalised where it is a
    ``/query`` answer."""
    assert len(jout) == len(tout)
    for (js, jct, jb), (ts, tct, tb), w in zip(jout, tout, what):
        assert (ts, tct) == (js, jct), (w, ts, tb[:200], js, jb[:200])
        if js == 200 and jct.startswith("application/json"):
            assert normalize(tb) == normalize(jb), w
        elif jct.startswith("text/event-stream"):
            je, te = sse_events(jb), sse_events(tb)
            assert len(te) == len(je), w
            for a, b in zip(te, je):
                if a == "[DONE]" or b == "[DONE]":
                    assert a == b, w
                else:
                    assert normalize(a) == normalize(b), w
        else:
            assert tb == jb, w
