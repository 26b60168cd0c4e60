"""The port's native (C++) front end against the JAX package's (CPU).

Both ``NativeFederationServer``s serve one world with the same router
parameters, query table and doc store, each over its own build of
``native/frontend.cpp``; the same requests get the same status, content
type and bytes (apart from the random query id and the timings):
``/query`` by GET and by POST form, ``/query/batch`` with error slots, the
validation 400s, unknown paths, SSE framing, ``/healthz``, and ``/stats``
with the same keys. Keep-alive, ``Connection: close`` and pipelined
requests behave alike; concurrent clients form batches; the double-
buffered loop answers as the serial one. The port's library lives at its
own path, and a failed build raises.
"""

import json
import os
import socket
import threading
import time

import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu.engine.native_frontend import \
    NativeFederationServer as JNative
from ragroute_tpu_torch.engine import native_frontend as nf
from ragroute_tpu_torch.engine.native_frontend import NativeFederationServer
from torch_serving import (engines, normalize, query_path, request,
                           same_answers, servers, serving, shard_sets, world)


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def pair():
    syn = world(docs=600, nq=8, seed=1)
    jss, tss = shard_sets(syn)
    return (syn, *servers(syn, *engines(syn, jss, tss), strategy="ragroute"))


def _requests(syn):
    reqs = []
    for q in syn.questions[:4]:
        reqs.append(("GET", query_path(q["question"], q["options"],
                                       q["qid"]), None, {}))
    q = syn.questions[4]
    form = (f"q={q['question'].replace(' ', '+')}"
            f"&choices={json.dumps(q['options'])}&qid={q['qid']}")
    reqs.append(("POST", "/query", form,
                 {"Content-Type": "application/x-www-form-urlencoded"}))
    reqs.append(("GET", query_path("an unknown query", {"A": "x"}, "nope"),
                 None, {}))
    reqs.append(("GET", query_path(q["question"], q["options"], q["qid"],
                                   extra="&stream=1"), None, {}))
    reqs.append(("POST", "/query/batch", {"queries": [
        {"q": syn.questions[i]["question"],
         "choices": syn.questions[i]["options"],
         "qid": syn.questions[i]["qid"]} for i in range(3)]
        + [{"q": ""}, {"q": "x", "choices": "[bad"}, "not an object",
           {"q": "x"}]}, {}))
    reqs.append(("POST", "/query/batch", b"{bad", {}))
    reqs.append(("POST", "/query/batch", {"queries": []}, {}))
    for path in ("/query", "/query?q=hello", "/query?q=hello&choices=nope",
                 "/query?choices=%7B%7D", "/nope", "/healthz"):
        reqs.append(("GET", path, None, {}))
    return reqs


def _run(port, reqs):
    return [request(port, m, p, body=b, headers=h) for m, p, b, h in reqs]


def test_same_bytes_as_the_jax_native_front_end(pair):
    syn, js, ts = pair
    reqs = _requests(syn)
    with serving(js, JNative) as port:
        jout = _run(port, reqs)
        jstats = json.loads(request(port, "GET", "/stats")[2])
    with serving(ts, NativeFederationServer) as port:
        tout = _run(port, reqs)
        tstats = json.loads(request(port, "GET", "/stats")[2])
    same_answers(jout, tout, reqs)
    assert [s for s, _, _ in tout] == [200] * 8 + [400] * 6 + [501, 200]
    assert tout[6][1] == "text/event-stream"
    assert set(tstats) == set(jstats)
    assert tstats["frontend"]["kind"] == "native"
    assert set(tstats["frontend"]) == set(jstats["frontend"])
    assert tstats["frontend"]["requests"] == jstats["frontend"]["requests"]


def _keepalive(port, syn):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    out = []
    for i in range(3):
        q = syn.questions[i]
        conn.request("GET", query_path(q["question"], q["options"],
                                       q["qid"]))
        r = conn.getresponse()
        out.append((r.status, r.getheader("Connection"), r.read()))
    conn.close()
    close = request(port, "GET", query_path(
        syn.questions[0]["question"], syn.questions[0]["options"],
        syn.questions[0]["qid"]), headers={"Connection": "close"})
    return out, close


def _pipelined(port, syn):
    raw = b""
    for q in syn.questions[:2]:
        raw += (f"GET {query_path(q['question'], q['options'], q['qid'])}"
                f" HTTP/1.1\r\nHost: x\r\n\r\n").encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    s.sendall(raw)
    buf = b""
    deadline = time.time() + 60
    while buf.count(b"HTTP/1.1 200") < 2 and time.time() < deadline:
        s.settimeout(max(0.1, deadline - time.time()))
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    # the second body may still be in flight
    head = buf.find(b"\r\n\r\n")
    hdr = buf[:head].decode()
    clen = int([ln.split(":")[1] for ln in hdr.split("\r\n")
                if ln.lower().startswith("content-length")][0])
    first = buf[head + 4:head + 4 + clen]
    rest = buf[head + 4 + clen:]
    head2 = rest.find(b"\r\n\r\n")
    clen2 = int([ln.split(":")[1] for ln in rest[:head2].decode()
                 .split("\r\n")
                 if ln.lower().startswith("content-length")][0])
    while len(rest) < head2 + 4 + clen2 and time.time() < deadline:
        rest += s.recv(65536)
    s.close()
    return [first, rest[head2 + 4:head2 + 4 + clen2]]


def test_keepalive_close_and_pipelining_match_jax(pair):
    syn, js, ts = pair
    with serving(js, JNative) as port:
        jka, jclose = _keepalive(port, syn)
        jpipe = _pipelined(port, syn)
    with serving(ts, NativeFederationServer) as port:
        tka, tclose = _keepalive(port, syn)
        tpipe = _pipelined(port, syn)
    for (st, conn, body), (js_, jconn, jbody) in zip(tka, jka):
        assert (st, conn) == (js_, jconn) == (200, "keep-alive")
        assert normalize(body) == normalize(jbody)
    assert len({json.loads(b)["query_id"] for _, _, b in tka}) == 3
    assert tclose[0] == jclose[0] == 200
    assert normalize(tclose[2]) == normalize(jclose[2])
    assert [normalize(b) for b in tpipe] == [normalize(b) for b in jpipe]
    assert [json.loads(b)["query"] for b in tpipe] == \
        [q["question"] for q in syn.questions[:2]]


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_concurrent_clients_form_batches(pair, monkeypatch, pipeline):
    """Concurrent keep-alive clients all get answers, device batches carry
    more than one query, and the double-buffered loop answers as the
    serial one."""
    syn, _, ts = pair
    monkeypatch.setenv("RAGROUTE_NATIVE_PIPELINE", pipeline)
    ok, errs = [], []

    def client(port, tid):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            for i in range(4):
                q = syn.questions[(tid + i) % len(syn.questions)]
                conn.request("GET", query_path(q["question"], q["options"],
                                               q["qid"]))
                r = conn.getresponse()
                data = r.read()
                (ok if r.status == 200 else errs).append((q["qid"], data))
        finally:
            conn.close()

    before = ts.metrics.snapshot()["num_queries"]
    with serving(ts, NativeFederationServer) as port:
        threads = [threading.Thread(target=client, args=(port, t))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        single = {q["qid"]: _unbatched(request(port, "GET", query_path(
            q["question"], q["options"], q["qid"]))[2])
            for q in syn.questions}
    assert not errs and len(ok) == 32
    snap = ts.metrics.snapshot()
    assert snap["num_queries"] - before == 32 + len(syn.questions)
    assert snap["batch_size"]["max"] > 1
    for qid, body in ok:
        assert _unbatched(body) == single[qid]


def _unbatched(body) -> str:
    """A normalised ``/query`` body without the batch size it rode in."""
    r = json.loads(body)
    r["metadata"]["batch_size"] = 0
    return normalize(r)


def test_library_at_its_own_path_and_build_failure_raises(tmp_path,
                                                          monkeypatch):
    path = nf.library_path(nf._SRC)
    assert os.path.dirname(path) == os.path.join(
        nf._REPO_ROOT, "ragroute_tpu_torch", "csrc", "build")
    nf.NativeFrontend("127.0.0.1", 0).close()
    assert os.path.exists(path)
    assert not path.startswith(os.path.join(nf._REPO_ROOT, "native"))
    bad = tmp_path / "frontend.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nf, "_SRC", str(bad))
    monkeypatch.setattr(nf, "_lib", None)
    with pytest.raises(RuntimeError, match="native front end build failed"):
        nf.NativeFrontend("127.0.0.1", 0)
    assert not os.path.exists(nf.library_path(str(bad)))


def test_loadgen_drives_a_closed_loop_burst(pair):
    """``ragroute_tpu_torch.loadgen``: every request answered once, the
    counts and percentiles reported."""
    import asyncio

    from ragroute_tpu_torch.loadgen import closed_loop

    syn, _, ts = pair
    before = ts.metrics.snapshot()["num_queries"]
    with serving(ts, NativeFederationServer) as port:
        res = asyncio.run(closed_loop(port, syn.questions, 24, 4))
    assert res["n"] == 24 and res["n_bad"] == 0 and res["conns"] == 4
    assert 0 < res["p50_ms"] <= res["p99_ms"] and res["requests_per_s"] > 0
    assert ts.metrics.snapshot()["num_queries"] - before == 24
