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
turn. Imports no torch (it starts in well under a second).
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--conns", type=int, default=64)
    p.add_argument("--questions", required=True)
    args = p.parse_args(argv)
    with open(args.questions) as f:
        questions = json.load(f)
    res = asyncio.run(closed_loop(args.port, questions, args.n, args.conns,
                                  args.host))
    print(json.dumps(res))
    return 0 if res["n_bad"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
