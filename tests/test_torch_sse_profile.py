"""SSE, ``/admin/profile`` and the SO_REUSEPORT workers of the port (CPU).

``/query?stream=1`` on both of the port's front ends answers with the JAX
package's events and bytes (apart from ids and timings): generation by the
echo backend (one whole-answer delta), the ``--disable-llm`` case (the
final event and ``[DONE]``) and a failure after the headers (an in-band
error event). The port's demo continuous service streams several deltas
whose join is a prefix of the answer. ``/admin/profile`` answers the JAX
package's 400s, 409 while a capture runs and 200 with a trace written, on
both front ends. Two port servers share one port through ``reuse_port``;
``Workers`` refuses ``--mutable`` and resolves ``--port 0`` to one port
that every worker serves.
"""

import json
import os
import threading
import time

import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu.engine.native_frontend import \
    NativeFederationServer as JNative
from ragroute_tpu_torch.engine.llm import LLMClient
from ragroute_tpu_torch.engine.native_frontend import NativeFederationServer
from ragroute_tpu_torch.main import parse_args
from ragroute_tpu_torch.system import Workers, free_port, run_workers
from torch_serving import (engines, normalize, query_path, request,
                           same_answers, servers, serving, shard_sets,
                           sse_events, world)

FRONTS = {"aiohttp": (None, None), "native": (JNative, NativeFederationServer)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def syn_engines():
    syn = world(docs=600, nq=8, seed=1)
    return syn, engines(syn, *shard_sets(syn))


class _Flaky:
    """A provider that fails on demand (after the query was accepted)."""

    def __init__(self, base):
        self.base, self.fail = base, False

    def _check(self):
        if self.fail:
            raise RuntimeError("encoder exploded")

    def row_of(self, qid):
        self._check()
        return self.base.row_of(qid)

    def embed(self, query, qid):
        self._check()
        return self.base.embed(query, qid)


@pytest.mark.parametrize("front", list(FRONTS))
@pytest.mark.parametrize("llm_on", [False, True])
def test_sse_matches_jax(syn_engines, front, llm_on):
    syn, (jeng, teng) = syn_engines
    js, ts = servers(syn, jeng, teng, disable_llm=not llm_on)
    jcls, tcls = FRONTS[front]
    reqs = [("GET", query_path(q["question"], q["options"], q["qid"],
                               extra="&stream=1"), None)
            for q in syn.questions[:3]]
    reqs.append(("GET", query_path(syn.questions[0]["question"],
                                   syn.questions[0]["options"],
                                   syn.questions[0]["qid"]), None))
    out = []
    for server, cls in ((js, jcls), (ts, tcls)):
        server.provider = flaky = _Flaky(server.provider)
        with serving(server, cls) as port:
            got = [request(port, m, p, body=b) for m, p, b in reqs]
            flaky.fail = True       # a failure once the query is in
            got.append(request(port, *reqs[0][:2]))
        out.append(got)
    same_answers(out[0], out[1], reqs + [reqs[0]])
    tout = out[1]
    for st, ct, body in tout[:3]:
        events = sse_events(body)
        assert st == 200 and ct == "text/event-stream"
        assert events[-1] == "[DONE]"
        final = json.loads(events[-2])
        assert len(final["metadata"]["top_docs"]) == syn.world.k
        deltas = [json.loads(e)["delta"] for e in events[:-2]]
        assert (len(deltas) == 1) == llm_on
        assert final["answer"].startswith("".join(deltas))
    plain = json.loads(tout[3][2])
    assert normalize(json.loads(sse_events(tout[0][2])[-2])) == \
        normalize(plain)
    status, ct, body = tout[4]
    if front == "aiohttp":  # the headers were out: the error is in band
        assert status == 200
        events = sse_events(body)
        assert events[-1] == "[DONE]"
        assert "encoder exploded" in json.loads(events[-2])["error"]
    else:                   # the native loop fails it before answering
        assert status == 500 and b"encoder exploded" in body


@pytest.mark.parametrize("front", list(FRONTS))
def test_sse_streams_deltas_from_the_continuous_service(syn_engines, front):
    from ragroute_tpu_torch.llm.continuous import demo_continuous_service

    syn, (jeng, teng) = syn_engines
    svc = demo_continuous_service(max_new_tokens=12, slots=2, chunk_steps=3)
    _, ts = servers(syn, jeng, teng, disable_llm=False,
                    llm=(None, LLMClient("jax", service=svc)))
    q = syn.questions[0]
    with serving(ts, FRONTS[front][1], before_stop=svc.stop) as port:
        st, ct, body = request(port, "GET", query_path(
            q["question"], q["options"], q["qid"], extra="&stream=1"))
        plain = json.loads(request(port, "GET", query_path(
            q["question"], q["options"], q["qid"]))[2])
    events = sse_events(body)
    assert st == 200 and ct == "text/event-stream"
    assert events[-1] == "[DONE]"
    final = json.loads(events[-2])
    deltas = [json.loads(e)["delta"] for e in events[:-2]]
    assert len(deltas) >= 2
    assert final["answer"].startswith("".join(deltas))
    assert final["answer"] == plain["answer"]
    assert len(final["metadata"]["top_docs"]) == syn.world.k


def _profile(port, body, out, i):
    out[i] = request(port, "POST", "/admin/profile", body=body)


@pytest.mark.parametrize("front", list(FRONTS))
def test_profile_route(syn_engines, tmp_path, front):
    syn, (jeng, teng) = syn_engines
    js, ts = servers(syn, jeng, teng)
    jcls, tcls = FRONTS[front]
    bad = [{"seconds": "x"}, {"seconds": 0}, {"seconds": 61}, b"{bad"]
    with serving(js, jcls) as port:
        jout = [request(port, "POST", "/admin/profile", body=b) for b in bad]
    with serving(ts, tcls) as port:
        tout = [request(port, "POST", "/admin/profile", body=b) for b in bad]
        assert all(s == 400 for s, _, _ in tout)
        res = [None, None]
        first = threading.Thread(target=_profile, args=(
            port, {"seconds": 1.5, "dir": str(tmp_path / "trace")}, res, 0))
        first.start()
        deadline = time.time() + 30
        while not ts._profiling and time.time() < deadline:
            time.sleep(0.01)
        _profile(port, {"seconds": 1.0}, res, 1)
        q = syn.questions[0]
        served = request(port, "GET", query_path(q["question"], q["options"],
                                                 q["qid"]))
        first.join(60)
        assert not first.is_alive()
    same_answers(jout, tout, bad)
    assert served[0] == 200
    assert res[1][0] == 409 and b"already running" in res[1][2]
    assert res[0][0] == 200
    assert json.loads(res[0][2]) == {"trace_dir": str(tmp_path / "trace"),
                                     "seconds": 1.5}
    with open(tmp_path / "trace" / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert not ts._profiling


def test_two_servers_share_one_port_with_reuse_port(syn_engines):
    syn, (jeng, teng) = syn_engines
    port = free_port()
    a = servers(syn, jeng, teng, reuse_port=True)[1]
    b = servers(syn, jeng, teng, reuse_port=True)[1]
    a.port = b.port = port
    with serving(a) as pa, serving(b) as pb:
        assert pa == pb == port
        st, _, body = request(port, "GET", "/stats")
        assert st == 200 and json.loads(body)["worker_pid"] == os.getpid()
        q = syn.questions[0]
        assert request(port, "GET", query_path(
            q["question"], q["options"], q["qid"]))[0] == 200


def test_workers_refuse_mutable():
    args = parse_args(["--dataset", "medrag", "--device", "cpu",
                       "--mutable", "--workers", "2"])
    with pytest.raises(ValueError, match="--mutable is a single-process"):
        run_workers(args, 2)


def test_workers_share_one_resolved_port():
    """``--workers 2 --port 0``: one free port, bound by both spawned
    workers; fresh connections reach both."""
    args = parse_args(["--dataset", "medrag", "--simulate", "--disable-llm",
                       "--device", "cpu", "--dtype", "float32", "--port",
                       "0", "--workers", "2", "--buckets", "8"])
    workers = Workers(args, 2)
    try:
        port = workers.start()
        assert port not in (0, 8000)
        pids = set()
        deadline = time.time() + 240
        while len(pids) < 2 and time.time() < deadline:
            try:
                st, _, body = request(port, "GET", "/stats", timeout=10)
            except OSError:
                time.sleep(0.5)
                continue
            if st == 200:
                pids.add(json.loads(body)["worker_pid"])
        assert pids == {p.pid for p in workers.procs}
    finally:
        workers.stop()
    assert not any(p.is_alive() for p in workers.procs)
