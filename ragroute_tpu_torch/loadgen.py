"""Closed-loop HTTP load for a running server: ``/query`` requests from a
process of their own.

``conns`` client tasks each hold one connection and send their share of
``n`` GET ``/query`` requests one after another, so at most ``conns`` are in
flight and a request's latency is the server's answer time, not a wait for
a free client connection. Prints one JSON object: the count, the wall time,
requests a second, p50 / p99 latency in ms, and the first non-200 statuses.

    python -m ragroute_tpu_torch.loadgen --port 8321 --n 1024 --conns 64 \\
        --questions questions.json

``--questions`` is a JSON list of ``{"qid", "question"}`` objects, used in
turn. With ``--seconds S`` the clients instead send requests until ``S``
seconds have passed (after ``--warmup-seconds`` that are not measured),
GET ``/query`` or, with ``--bulk N``, POST ``/query/batch`` of N queries,
and the JSON object holds queries a second, the queries answered and
failed and the request latency's p50 / p95 / p99 in ms. Imports no torch
(it starts in well under a second).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import List, Sequence

CHOICES = json.dumps({"A": "a", "B": "b"})


async def closed_loop(port: int, questions: Sequence[dict], n: int,
                      conns: int, host: str = "127.0.0.1") -> dict:
    import aiohttp

    lat: List[float] = []
    bad: List[int] = []
    nxt = iter(range(n))
    url = f"http://{host}:{port}/query"
    timeout = aiohttp.ClientTimeout(total=600)

    async def client(session):
        for i in nxt:
            q = questions[i % len(questions)]
            params = {"q": q["question"], "choices": CHOICES,
                      "qid": q["qid"]}
            t0 = time.perf_counter()
            async with session.get(url, params=params,
                                   timeout=timeout) as r:
                await r.read()
                status = r.status
            lat.append(time.perf_counter() - t0)
            if status != 200:
                bad.append(status)

    connector = aiohttp.TCPConnector(limit=conns)
    async with aiohttp.ClientSession(connector=connector) as session:
        t0 = time.perf_counter()
        await asyncio.gather(*[client(session) for _ in range(conns)])
        wall = time.perf_counter() - t0
    lat.sort()

    def pct(p: float) -> float:
        return lat[min(len(lat) - 1, int(round(p / 100 * (len(lat) - 1))))
                   ] * 1e3

    return {"n": n, "conns": conns, "wall_s": wall,
            "requests_per_s": n / wall, "p50_ms": pct(50), "p99_ms": pct(99),
            "n_bad": len(bad), "bad": bad[:5]}


async def timed_loop(port: int, questions: Sequence[dict], seconds: float,
                     conns: int, *, bulk: int = 0, warmup_s: float = 0.0,
                     host: str = "127.0.0.1") -> dict:
    """``conns`` clients send requests back to back until ``seconds`` have
    passed (``warmup_s`` before that unmeasured): GET ``/query``, or with
    ``bulk`` POST ``/query/batch`` of ``bulk`` queries (latency a request,
    counts a query)."""
    import aiohttp

    base = f"http://{host}:{port}"
    timeout = aiohttp.ClientTimeout(total=600)
    per_request = max(bulk, 1)

    async def client(session, stop_at, lat, counts):
        while time.perf_counter() < stop_at:
            start = counts["sent"]
            counts["sent"] += per_request
            qs = [questions[(start + j) % len(questions)]
                  for j in range(per_request)]
            t0 = time.perf_counter()
            try:
                if bulk:
                    body = {"queries": [{"q": q["question"], "qid": q["qid"],
                                         "choices": CHOICES} for q in qs]}
                    async with session.post(f"{base}/query/batch", json=body,
                                            timeout=timeout) as r:
                        data = await r.json() if r.status == 200 else None
                    ok = (sum(1 for x in data["results"] if "error" not in x)
                          if data is not None else 0)
                else:
                    params = {"q": qs[0]["question"], "choices": CHOICES,
                              "qid": qs[0]["qid"]}
                    async with session.get(f"{base}/query", params=params,
                                           timeout=timeout) as r:
                        await r.read()
                        ok = int(r.status == 200)
            except aiohttp.ClientError:
                ok = 0
            counts["ok"] += ok
            counts["err"] += per_request - ok
            if ok:
                lat.append(time.perf_counter() - t0)

    connector = aiohttp.TCPConnector(limit=conns)
    async with aiohttp.ClientSession(connector=connector) as session:
        for window in (warmup_s, seconds):
            lat: List[float] = []
            counts = {"sent": 0, "ok": 0, "err": 0}
            t0 = time.perf_counter()
            await asyncio.gather(*[client(session, t0 + window, lat, counts)
                                   for _ in range(conns)])
            wall = time.perf_counter() - t0
    lat.sort()

    def pct(p: float):
        if not lat:
            return None
        return lat[min(len(lat) - 1, int(round(p / 100 * (len(lat) - 1))))
                   ] * 1e3

    return {"qps": counts["ok"] / wall, "ok": counts["ok"],
            "errors": counts["err"], "conns": conns, "bulk": bulk,
            "wall_s": wall, "latency_ms": {"p50": pct(50), "p95": pct(95),
                                           "p99": pct(99)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--conns", type=int, default=64)
    p.add_argument("--questions", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--warmup-seconds", type=float, default=0.0)
    p.add_argument("--bulk", type=int, default=0)
    args = p.parse_args(argv)
    with open(args.questions) as f:
        questions = json.load(f)
    if args.seconds:
        res = asyncio.run(timed_loop(
            args.port, questions, args.seconds, args.conns, bulk=args.bulk,
            warmup_s=args.warmup_seconds, host=args.host))
        print(json.dumps(res))
        return 0 if res["errors"] == 0 else 1
    res = asyncio.run(closed_loop(args.port, questions, args.n, args.conns,
                                  args.host))
    print(json.dumps(res))
    return 0 if res["n_bad"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
