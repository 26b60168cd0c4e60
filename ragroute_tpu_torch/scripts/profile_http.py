"""Per-component host profile of the HTTP serving path under load.

Counterpart of ``scripts/profile_http.py``: builds the federation server
in-process over a synthetic medrag world on ``--device`` (default the
card), drives it with :mod:`ragroute_tpu_torch.loadgen` in a process of its
own for ``--seconds`` (after a 3 s warm-up), and reports:

* the load (queries a second, answered and failed, latency p50 / p95 /
  p99),
* the server's per-stage timing aggregates (``/stats``: embedding /
  batch_wait / doc_select / assemble / e2e), batch sizes and device step
  times, and
* with ``--cprofile``, a cProfile of the server's serving thread during
  the load window (top functions by cumulative time), where the host CPU
  goes.

    python -m ragroute_tpu_torch.scripts.profile_http \\
        [--seconds 15] [--concurrency 256] [--cprofile] \\
        [--frontend native] [--device cuda]
"""

import argparse
import asyncio
import cProfile
import faulthandler
import io
import json
import os
import pstats
import signal
import subprocess
import sys
import tempfile
import threading

from ragroute_tpu_torch import loadgen


def build_server(args):
    """``(synthetic world, FederationServer on port 0)``."""
    import torch

    from ragroute_tpu_torch.engine.batcher import QueryBatcher
    from ragroute_tpu_torch.engine.embedding import PrecomputedEmbeddings
    from ragroute_tpu_torch.engine.engine import FederatedSearchEngine
    from ragroute_tpu_torch.engine.server import FederationServer
    from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
    from ragroute_tpu_torch.index.store import MemoryDocStore
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank
    from ragroute_tpu_torch.utils.precision import resolve_device

    dev = resolve_device(args.device)
    syn = make_synthetic_world(
        "medrag", docs_per_source=args.docs_per_source,
        num_queries=256, seed=7)
    shard_set = ShardSet.build(syn.world, syn.embeddings,
                               doc_ids=syn.doc_ids, dtype=torch.bfloat16,
                               device=dev)
    router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev)
    bank = RouterBank.create(syn.world, syn.centroids, device=dev)
    engine = FederatedSearchEngine(shard_set, router, bank)
    server = FederationServer(
        engine, strategy="ragroute",
        embedding_provider=PrecomputedEmbeddings.from_synthetic(syn),
        doc_store=MemoryDocStore.from_synthetic(syn),
        disable_llm=True, port=0,
        batcher=QueryBatcher(engine, strategy="ragroute"))
    return syn, server


def load_command(syn, port, args):
    fd, path = tempfile.mkstemp(prefix="profile_questions_", suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump([{"qid": q["qid"], "question": f"load {q['qid']}"}
                   for q in syn.questions], f)
    return path, [
        sys.executable, loadgen.__file__,
        "--port", str(port), "--questions", path,
        "--conns", str(args.concurrency),
        "--seconds", str(args.seconds),
        "--warmup-seconds", "3",
        "--bulk", str(args.bulk),
    ]


async def run(args):
    syn, server = build_server(args)
    await server.start()
    path, load_cmd = load_command(syn, server.bound_port, args)
    print(f"driving load: {' '.join(load_cmd[1:])}", file=sys.stderr)

    prof = cProfile.Profile() if args.cprofile else None
    try:
        if prof:
            prof.enable()
        proc = await asyncio.create_subprocess_exec(
            *load_cmd, stdout=subprocess.PIPE)
        out, _ = await proc.communicate()
        if prof:
            prof.disable()
    finally:
        await server.stop()
        os.unlink(path)
    return emit_report(out, server, prof)


def run_native(args):
    """Profile the C++ front end's Python serving loop (--frontend native).

    The IO plane (parse / write) runs on the C++ epoll thread and is
    invisible to cProfile by design; what this measures is everything
    Python still pays per query: embed, device step and copy, response
    assembly, the ctypes handoff. serve_forever runs in THIS thread under
    the profiler (cProfile instruments only its own thread); a watcher
    thread stops the loop when the load generator exits."""
    from ragroute_tpu_torch.engine.native_frontend import (
        NativeFederationServer)

    syn, server = build_server(args)
    native = NativeFederationServer(server)
    native.start(thread=False)
    path, load_cmd = load_command(syn, native.bound_port, args)
    print(f"driving load: {' '.join(load_cmd[1:])}", file=sys.stderr)
    proc = subprocess.Popen(load_cmd, stdout=subprocess.PIPE)

    def _watch():
        proc.wait()
        # wake the blocked fe.next; serve_forever's finally closes the
        # handle on ITS thread
        native._running = False
        if native.fe is not None:
            native.fe.shutdown()

    threading.Thread(target=_watch, daemon=True).start()
    prof = cProfile.Profile() if args.cprofile else None
    try:
        if prof:
            prof.enable()
        native.serve_forever()
        if prof:
            prof.disable()
    finally:
        os.unlink(path)
    return emit_report(proc.stdout.read(), server, prof)


def emit_report(out: bytes, server, prof) -> dict:
    load = json.loads(out.decode().strip().splitlines()[-1])
    stats = server.metrics.snapshot()
    report = {
        "load": {k: load[k] for k in ("qps", "ok", "errors", "latency_ms")},
        "stages_ms": {
            s: {k: round(v * 1e3, 3) for k, v in st.items() if k != "count"}
            for s, st in stats["stages_s"].items() if st.get("count")
        },
        "batch_size": stats["batch_size"],
        "device_step_ms": stats["device_step_ms"],
    }
    print(json.dumps(report, indent=1))
    if prof:
        s = io.StringIO()
        pstats.Stats(prof, stream=s).sort_stats("cumulative").print_stats(40)
        print("\n===== cProfile (server process, load window) =====")
        print(s.getvalue())
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--concurrency", type=int, default=256)
    ap.add_argument("--docs-per-source", type=int, default=4096)
    ap.add_argument("--bulk", type=int, default=0,
                    help="queries per request via POST /query/batch "
                         "(0 = single-query GET mode)")
    ap.add_argument("--cprofile", action="store_true")
    ap.add_argument("--frontend", choices=["aiohttp", "native"],
                    default="aiohttp",
                    help="'native' profiles the Python serving loop "
                         "behind the C++ IO plane")
    ap.add_argument("--device", type=str, default="cuda",
                    help="serving device: cuda (or cuda:N); cpu for tests")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps stacks
    if args.frontend == "native":
        return run_native(args)
    return asyncio.run(run(args))


if __name__ == "__main__":
    main()
