"""How often ``POST /admin/profile`` holds the card's kernels, under load.

Builds ``--frontend native --mutable`` (``--front aiohttp``: the default
aiohttp server over an immutable index) over a synthetic medrag world at the
reference benchmark's size on ``--device`` (default the card), drives it
with :mod:`ragroute_tpu_torch.loadgen` in a process of its own, takes
``--captures`` captures of 2 s one after another, and prints for each the
trace's events by category and whether K1's kernel is among them, then one
JSON line: the captures without K1.

``--thread loop`` (the front end's design) starts and stops each capture on
the serving loop's thread, the one that launches the engine's steps;
``--thread helper`` swaps in the earlier design for comparison, a capture
started and stopped on a helper thread of its own. ``--front aiohttp``
takes the captures as the installed package's aiohttp server takes them
(the thread option does not apply); run the file with an earlier tree first
on ``PYTHONPATH`` to read that tree's design in the same call.

    python -m ragroute_tpu_torch.scripts.profile_captures \\
        [--front native|aiohttp] [--thread loop|helper] [--captures 8] \\
        [--device cuda]
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

MEDRAG_DOCS = {"pubmed": 734_003, "statpearls": 104_857,
               "textbooks": 83_886, "wikipedia": 125_829}


def helper_thread_profile(self, rid: int, body: bytes) -> None:
    """The earlier ``NativeFederationServer._profile``: the capture starts
    and stops on a helper thread, which answers."""
    from ragroute_tpu_torch.engine.native_frontend import TEXT
    from ragroute_tpu_torch.engine.server import (ProfileCapture, _dumps,
                                                  profile_body)

    seconds, logdir, err = profile_body(json.loads(body) if body else {})
    if err is not None or self.server._profiling:
        return self._respond(rid, 400 if err else 409, err or "busy",
                             ctype=TEXT)
    self.server._profiling = True
    fe = self.fe

    def capture():
        try:
            cap = ProfileCapture(self.engine.device, logdir)
            cap.start()
            try:
                time.sleep(seconds)
            finally:
                cap.stop()
            cap.export()
        finally:
            self.server._profiling = False
        fe.respond(rid, 200, _dumps({"trace_dir": logdir,
                                     "seconds": seconds}))

    threading.Thread(target=capture, daemon=True).start()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--front", choices=("native", "aiohttp"),
                   default="native")
    p.add_argument("--thread", choices=("loop", "helper"), default="loop")
    p.add_argument("--captures", type=int, default=8)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--docs-per-source", type=int, default=None,
                   help="default: the reference benchmark's medrag sizes")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ragroute_tpu_torch.engine import native_frontend
    from ragroute_tpu_torch.index.synthetic import (make_synthetic_world,
                                                    save_world)
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.system import ServingSystem

    sizes = ({k: args.docs_per_source for k in MEDRAG_DOCS}
             if args.docs_per_source else MEDRAG_DOCS)
    root = tempfile.mkdtemp(prefix="ragroute_captures_")
    syn = make_synthetic_world("medrag", docs_per_source_map=sizes,
                               num_queries=512, seed=0)
    save_world(syn, root)
    if args.thread == "helper":
        native_frontend.NativeFederationServer._profile = \
            helper_thread_profile
    flags = (["--frontend", "native", "--mutable", "--reserve-docs", "4096"]
             if args.front == "native" else [])
    system = ServingSystem(parse_args([
        "--dataset", "medrag", "--routing", "ragroute", "--disable-llm",
        "--port", "0", "--data-root", root, "--device", args.device,
        *flags]))
    system.build()
    if args.front == "native":
        loop = threading.Thread(target=system.run_native, daemon=True)
        loop.start()
        while system.native is None or system.native.fe is None:
            if not loop.is_alive():
                raise RuntimeError("the native loop ended while starting")
            time.sleep(0.05)
        port = system.native.bound_port
    else:
        import asyncio

        aloop = asyncio.new_event_loop()
        loop = threading.Thread(target=aloop.run_forever, daemon=True)
        loop.start()
        asyncio.run_coroutine_threadsafe(system.start(), aloop).result(900)
        port = system.server.bound_port
    label = args.thread if args.front == "native" else "aiohttp"
    qpath = os.path.join(root, "questions.json")
    with open(qpath, "w") as f:
        json.dump([{"qid": q["qid"], "question": q["question"]}
                   for q in syn.questions], f)
    # a load that outlasts every capture; ended once they are taken
    load = subprocess.Popen(
        [sys.executable, "-m", "ragroute_tpu_torch.loadgen", "--port",
         str(port), "--seconds", str(args.captures * (args.seconds + 8) + 30),
         "--conns", "64", "--questions", qpath],
        stdout=subprocess.DEVNULL)
    time.sleep(3.0)
    missing = 0
    try:
        for i in range(args.captures):
            pdir = os.path.join(root, f"trace{i}")
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/admin/profile", method="POST",
                data=json.dumps({"seconds": args.seconds,
                                 "dir": pdir}).encode())
            with urllib.request.urlopen(req, timeout=600) as r:
                if r.status != 200:
                    raise RuntimeError(f"/admin/profile answered {r.status}")
            with open(os.path.join(pdir, "trace.json")) as f:
                trace = json.load(f)["traceEvents"]
            cats = collections.Counter(e.get("cat") for e in trace)
            k1 = any("topk_kernel" in e.get("name", "") for e in trace
                     if e.get("cat") == "kernel")
            if load.poll() is not None:
                raise RuntimeError("the load ended before the captures")
            missing += not k1
            print(f"[{label}] capture {i}: {len(trace)} events, K1 "
                  f"{k1}, by category {dict(cats)}", flush=True)
    finally:
        load.kill()
        load.wait()
        if args.front == "native":
            native = system.native
            native._running = False
            native.fe.shutdown()
            loop.join(60)
            native.stop()
        else:
            asyncio.run_coroutine_threadsafe(system.stop(), aloop).result(300)
            aloop.call_soon_threadsafe(aloop.stop)
            loop.join(60)
    print(json.dumps({"front": args.front, "thread": label,
                      "captures": args.captures, "without_k1": missing}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
