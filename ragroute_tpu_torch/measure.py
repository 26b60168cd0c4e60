"""Measurements of the port on one CUDA card, for PERF.md.

    python -m ragroute_tpu_torch.measure [--parent DIR]

Needs a card (fails without one). It makes the synthetic medrag world at
the benchmark's size (1,048,575 docs x 768, bf16 on the card) with the
balanced-IVF layouts and the low-rank coarse indexes beside the flat
shards, builds one engine per search mode over that one shard set, and
prints:

1. the engine step time (host clock around ``engine.search`` with
   ``staged=False`` and no candidate copy, a step that ends in its device to
   host copy; median of 10 after 2 warm-ups) for ``impl`` auto / ivf /
   lowrank / hybrid at B = 8, 128 and 512, routing ``ragroute`` and ``all``;
2. for auto, ivf and lowrank at B = 512 (routing ``all``), a
   ``torch.profiler`` window over 10 back-to-back steps: device time by
   kernel name, the device's busy share of the wall time, and the launches
   of the three hand-written kernels per step;
3. with ``--parent DIR`` (an unpacked earlier tree of this repository), the
   fused top-k kernel at the serving shape from that tree and from this one
   in turns (parent, this, this, parent), each in a process of its own.

Every line names the card and its power limit. The last line is one JSON
object with everything printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

MEDRAG_DOCS = {"pubmed": 734_003, "statpearls": 104_857,
               "textbooks": 83_886, "wikipedia": 125_829}
IMPLS = ("auto", "ivf", "lowrank", "hybrid")
BATCHES = (8, 128, 512)
KERNEL_TIMER = """
import torch
from ragroute_tpu_torch.ops import kernel_checks as kc
case = kc.path_case(torch.device("cuda"))
kc.run_kernel(case)
print(kc.cuda_time_ms(lambda: kc.run_kernel(case)))
"""


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _counts():
    from ragroute_tpu_torch.ops.fused_topk import fused_topk
    from ragroute_tpu_torch.ops.grouped_gains import grouped_gains
    from ragroute_tpu_torch.ops.stream_topk import stream_topk

    return {"fused_topk": fused_topk, "stream_topk": stream_topk,
            "grouped_gains": grouped_gains}


def step_times(engines, syn, reps: int = 10):
    """Median host-clock ms of one engine step per (impl, strategy, B)."""
    out = {}
    for impl, eng in engines.items():
        for strategy in ("ragroute", "all"):
            for bsz in BATCHES:
                q = {enc: e[:bsz] for enc, e in syn.query_embs.items()}
                times = []
                for i in range(reps + 2):
                    t0 = time.perf_counter()
                    eng.search(q, strategy=strategy, staged=False,
                               fetch_candidates=False)
                    if i >= 2:
                        times.append(1e3 * (time.perf_counter() - t0))
                out[f"{impl}/{strategy}/B{bsz}"] = float(np.median(times))
    return out


def profile_steps(eng, syn, bsz: int, steps: int = 10, top: int = 12):
    """Device time by kernel over ``steps`` back-to-back steps."""
    from torch.profiler import ProfilerActivity, profile

    q = {enc: e[:bsz] for enc, e in syn.query_embs.items()}
    for _ in range(2):
        eng.search(q, strategy="all", staged=False, fetch_candidates=False)
    counters = _counts()
    for w in counters.values():
        w.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.search(q, strategy="all", staged=False,
                       fetch_candidates=False)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "launches_per_step": {n: w.launches / steps
                                  for n, w in counters.items()},
            "kernels": [{"name": n[:90], "ms": ms, "calls": c}
                        for n, ms, c in rows[:top]]}


def parent_vs_change(parent: str, card: str):
    """The fused kernel at the serving shape from two trees, in turns."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for label, tree in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", KERNEL_TIMER], cwd=tree,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} kernel timer failed:\n{proc.stderr}")
        ms = float(proc.stdout.strip().splitlines()[-1])
        print(f"[k1] {label}: fused_topk B=512 N=734003 d=768 bf16 k=32 "
              f"{ms:.3f} ms ({card})", flush=True)
        out.append({"tree": label, "ms": ms})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure: needs a CUDA card", file=sys.stderr)
        return 2
    from ragroute_tpu_torch.engine import FederatedSearchEngine
    from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    card = _card()
    dev = torch.device("cuda")
    result = {"card": card}
    print(f"[card] {card}; torch {torch.__version__}", flush=True)
    if args.parent:
        result["k1_parent_vs_change"] = parent_vs_change(args.parent, card)

    t0 = time.perf_counter()
    syn = make_synthetic_world("medrag", docs_per_source_map=MEDRAG_DOCS,
                               num_queries=512, seed=0, with_payloads=False)
    ss = ShardSet.build(syn.world, syn.embeddings, dtype=torch.bfloat16,
                        device=dev, ivf_clusters=-1, lowrank=-1)
    print(f"[world] {sum(MEDRAG_DOCS.values())} docs with IVF and low-rank layouts "
          f"on the card in {time.perf_counter() - t0:.1f} s: "
          f"{ss.index_bytes / 1e9:.3f} GB flat + {ss.aux_bytes / 1e9:.3f} GB "
          f"extra", flush=True)
    router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev)
    bank = RouterBank.create(syn.world, syn.centroids, device=dev)
    engines = {impl: FederatedSearchEngine(ss, router, bank, impl=impl)
               for impl in IMPLS}

    result["step_ms"] = step_times(engines, syn)
    for key, ms in result["step_ms"].items():
        print(f"[step] {key}: {ms:.3f} ms ({card})", flush=True)

    result["profile"] = {}
    for impl in ("auto", "ivf", "lowrank"):
        torch.cuda.reset_peak_memory_stats()
        p = profile_steps(engines[impl], syn, 512)
        p["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        result["profile"][impl] = p
        print(f"[profile] impl={impl} B=512 routing=all, 10 steps: wall "
              f"{p['wall_ms']:.3f} ms, device {p['device_ms']:.3f} ms, busy "
              f"share {p['busy_share']:.3f}, launches per step "
              f"{p['launches_per_step']}, peak memory "
              f"{p['peak_memory_gb']:.3f} GB ({card})", flush=True)
        for k in p["kernels"]:
            print(f"[profile]   {k['ms']:9.3f} ms {k['calls']:5d} calls  "
                  f"{k['name']}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
