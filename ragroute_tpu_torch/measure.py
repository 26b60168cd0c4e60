"""Measurements of the port on one CUDA card, for PERF.md.

    python -m ragroute_tpu_torch.measure [--parent DIR]
    python -m ragroute_tpu_torch.measure --tiers
    python -m ragroute_tpu_torch.measure --kernels [--parent DIR]
    python -m ragroute_tpu_torch.measure --turns DIR
    python -m ragroute_tpu_torch.measure --encoders

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

The int8 and int4 shapes of K1 and K4's path shape in turns (``--kernels
--parent DIR``): K1 over one stream slab (346,112 x 768 int8, k = 32), the
734,003 x 768 shard in int8 and in int4 with per-doc and per-group scales
(k = 32) and hostrefine's flat coarse slab (2,936,320 x 128 int8, k' =
128), K4 at the probed scan's serving shape (512 queries x 512 probes of
4,096 slabs of 128 x 1,584), K3 at its path shape over bf16, int8 and
int4 slabs (512 queries x 512 probes of 4,096 slabs of 768 x 256), K1
over the 734,003 x 768 shard in f32 (k = 32) at B = 512 and at the small
batches 1, 8, 32 and 64, and K2's collect at [512, 131,072] and at the
shapes ``--impl hybrid`` hands it, [8 and 16, 131,072] (k = 32); CUDA
events (median of 5, 50 for K2) and the profiler's device time, each
tree's own plan.

``--kernels`` times the streaming top-k (K2) and decode attention (K6) at
the main path's shapes instead: K2 over [512, 131,072] (k = 32, the ivf
collect) and [512, 4,096] (k' = 128, the probed collect) beside
``torch.topk``, K6 at the three shapes of ``decoder_checks.attn_path_cases``
beside SDPA for the bf16 cache; CUDA events (median of 50, which include
the wrapper's host work) and the profiler's device time (50 calls). With
``--parent DIR`` it runs the same timer, and the fused top-k timer of item
3, from that tree and from this one in turns (parent, this, this, parent),
each in a process of its own. Then, from
this tree only (earlier trees refuse these depths), the deep lists that
``--refine-mult 8`` asks for (k' = 256 at medrag's k = 32) beside the
default depth k' = 128: K1 over the low-rank coarse slab (734,003 x 128
bf16) and over hostrefine's flat coarse slab (2,936,320 x 128 int8, as
``chip_smoke.py`` serves it), K2 at the probed collect beside
``torch.topk``, K4 with 256 ranks a tile at the reduced world's probed scan
under an open cap (64 queries x 64 clusters of 568 slots); each with its
bound (``kernel_checks``: a deep launch's gains cross device memory twice,
which its bound counts).

``--kernels`` also runs, from this tree, K5's kernels over M (1 to 8,192)
at the gate/up shape (the first kernel against the decode kernel below
``M_SWITCH`` and the prefill kernel from it) and K1's deep fold against
the deep launch over k (65 to 256) and the docs' width (128, 512, 768) for
bf16 over 734,003 docs and at k' = 128 over 83,886 to 262,144, and for int8
(hostrefine's flat coarse slab, the 768-wide shard) and int4 (per-doc
scales, widths 128 and 768; ``kernel="deep"`` names the deep launch, which
the plan no longer takes there), K1's small-batch f32 scan against the f32
scan at B = 64, 65, 96 and 128 (the reading behind
``fused_topk.f32_scan_pays``; the first design beside both at B = 8 and 64)
over N (104,857 and 734,003), K3's wgmma kernel against its
first design at the small sources' slabs (1,024 clusters, S 104 and 160)
and at B = 8, the readings behind ``int4_matmul.M_SWITCH`` and the fold's
range; with ``--parent DIR`` K5 at the two prefill shapes, K5 at
Qwen3-8B's five decode shapes and K1's deep lists (the low-rank coarse
scan at k' = 128 and 256, hostrefine's at k' = 256, the low-rank world's
three small shards at k' = 128 and 256 and two shards at d = 768) join the
turns, each tree its own plan (one timer alone in turns:
``served_in_turns(parent, card, timers=(DECODE_DEEP_TIMER,))`` from
``python -c``, its rows' device ms in what it returns). ``--kernels``
also runs ``FOLD_SWEEP_TIMER``: the fold's buffer and sample sweep, the
readings behind ``deep_topk.fold_cap`` and ``FOLD_SAMPLE_PER_K``.

``--turns DIR`` times, from DIR (an unpacked earlier tree) and this tree in
turns, the exact engine step (B = 512 and 2,048, routing ``ragroute`` and
``all``), one lockstep generation batch of Qwen3-8B (random int4
weights, int8 KV, 16 prompts of 2,048 tokens: the prefill, then 32 greedy
decode steps), the host tiers' steps at B = 512 (routing ``ragroute``
and ``all``: ``stream`` and ``hostrefine`` over the clustered coarse slab,
over the world ``chip_smoke.py`` serves, half of ``--tiers``' under half
its budget), the low-rank engine step at B = 512, one Qwen3-8B decode
step (host clock, device time, K5's share and launches), and the ivf step
over the topical world and the exact step over the world in f32 (B = 512,
routing ``all``; host clock, device time a step, K3's and K1's share), and
the exact step over the world in f32 at B = 1, 8 and 32 (routing
``ragroute`` and ``all``; host clock), each in a process of its own.

``--tiers`` measures the host-RAM capacity tiers instead: the synthetic
medrag world at eight times that size (8,388,600 docs x 768, 64 topics per
source, int8, rows made block by block from the seed) under a device budget
of 3.0 GB, which keeps the three small sources resident and sends pubmed to
the host tier. For ``stream``, ``hostrefine`` with the flat coarse slab and
``hostrefine`` with the clustered one (the flat build's slab, clustered) it
prints the build seconds, the device and host bytes, the engine step time
at B = 512 and B = 2,048 (routing ``ragroute`` and ``all``; median of 5
after a warm-up), ``last_phases`` of the last step, for hostrefine the
queries per second of eight batches dispatched and completed in turn
against the same batches with batch t + 1 dispatched before batch t
completes, a ``torch.profiler`` window over 5 steps at B = 512 (device time
by kernel, the host->device copies among them, and the busy share), the
kernels' launches per step, and the peak device and host memory.

:func:`prefill_breakdown` times and profiles one prefill of the lockstep
service's batch (16 prompts of 2,048 tokens). :func:`decode_step_breakdown`
times one decode step of the served decoder
(``chip_smoke.py`` runs it on Qwen3-8B with random int4 weights at B = 16
over a 2,080-position int8 KV cache): the step's host-clock time, its bound
(the weights read once plus the valid K/V, over 3.35 TB/s) and a
``torch.profiler`` window of five steps (device time by kernel, busy share,
K5 launches a step).

``--encoders`` measures the query encoders instead (the port's counterpart of
``scripts/bench_embed.py``): every distinct model of the registry at its
published width (``encoders/published.py``: BERT-base, BERT-large, XLM-R
large, MPNet base, the T5 encoder with its ``2_Dense`` and GPT-J; seeded
random weights, bf16 on the card) over seeded token ids of ``ENC_SEQ`` = 128
positions, a forward with its pooling and normalization: at B = 1, 8 and 32,
B serial size-1 forwards against one forward of B rows, by CUDA events
(median of 5), the profiler's device time and kernels a forward, each beside
its bound (``encoders/checks.py::forward_bound``: the larger of the weight
bytes over 3.35 TB/s and the operations over 989 TFLOP/s).

Every line names the card and its power limit. The last line is one JSON
object with everything printed.
"""

from __future__ import annotations

import argparse
import json
import gc
import os
import resource
import subprocess
import sys
import time
from typing import Optional

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


# K2, K5 at prefill and K6 at the main path's shapes; uses only functions
# that every tree since the decode-attention kernel's port has
TURNS_TIMER = """
import json, torch
from ragroute_tpu_torch.ops import decoder_checks as dc, kernel_checks as kc
from ragroute_tpu_torch.ops.decode_attention import decode_attention
from ragroute_tpu_torch.ops.int4_matmul import int4_matmul
from ragroute_tpu_torch.ops.stream_topk import stream_topk
dev, rows = torch.device("cuda"), []
for name, m, k, pad, seed in (("k2 ivf collect [512, 131072] k=32", 131072,
                               32, 0.2, 2),
                              ("k2 probed collect [512, 4096] k=128", 4096,
                               128, 0.1, 8)):
    gains = kc.stream_path_case(dev, m=m, pad_share=pad, seed=seed)
    f = lambda: stream_topk(gains, k)
    rows.append({"name": name, "ms": kc.cuda_time_ms(f, reps=50),
                 "device_ms": dc.device_ms(f, stream_topk, reps=50),
                 "library_ms": kc.cuda_time_ms(
                     lambda: torch.topk(gains, k, dim=1), reps=50)})
    del gains
for case in dc.int4_path_cases(dev):
    if case.x.shape[0] < 1024:
        continue
    f = lambda: dc.run_int4(case)
    rows.append({"name": "k5 " + case.name, "ms": kc.cuda_time_ms(f, reps=10),
                 "device_ms": dc.device_ms(f, int4_matmul, reps=10),
                 "library_ms": None})
    del case
    torch.cuda.empty_cache()
for case in dc.attn_path_cases(dev):
    f = lambda: dc.run_attn(case)
    rows.append({"name": "k6 " + case.name,
                 "ms": kc.cuda_time_ms(f, reps=50),
                 "device_ms": dc.device_ms(f, decode_attention, reps=50),
                 "library_ms": None if case.ks is not None else
                 kc.cuda_time_ms(lambda: dc.sdpa_note(case), reps=50)})
    del case
    torch.cuda.empty_cache()
print(json.dumps(rows))
"""


# K1 at its int8 and int4 path shapes and K4 at its path shape, each tree's
# own plan; uses only functions that every tree since the deep lists has
QUANT_TIMER = """
import json, torch
from ragroute_tpu_torch.ops import decoder_checks as dc, kernel_checks as kc
from ragroute_tpu_torch.ops.fused_topk import fused_topk
from ragroute_tpu_torch.ops.grouped_topk import grouped_pair_topk
dev, rows = torch.device("cuda"), []
def row(name, f, wrapper, reps=5):
    f()
    rows.append({"name": name, "ms": kc.cuda_time_ms(f, reps=reps),
                 "device_ms": dc.device_ms(f, wrapper, warmup=1, reps=reps),
                 "library_ms": None})
    torch.cuda.empty_cache()
n_flat = 2_936_320
for name, make in (
        ("k1 stream slab 346112 x 768 int8 k=32",
         lambda: kc.int8_path_case(dev, n=346_112, d=768, k=32, seed=6)),
        ("k1 734003 x 768 int8 k=32",
         lambda: kc.int8_path_case(dev, n=734_003, d=768, k=32, seed=8)),
        ("k1 734003 x 768 int4 per-doc k=32",
         lambda: kc.int4_path_case(dev, grouped=False)),
        ("k1 734003 x 768 int4 per-group k=32",
         lambda: kc.int4_path_case(dev, grouped=True)),
        ("k1 flat coarse 2936320 x 128 int8 k'=128",
         lambda: kc.int8_path_case(dev, n=n_flat, d=128, k=128,
                                   pad_tail=n_flat - 2_936_012, seed=7))):
    case = make()
    row(name, lambda: kc.run_kernel(case), fused_topk, reps=3 if "coarse"
        in name else 5)
    del case
case = kc.pair_path_case(dev)
row("k4 B=512 P=512 C=4096 r=128 S=1584 kappa 8",
    lambda: kc.run_pair_kernel(case), grouped_pair_topk, reps=10)
print(json.dumps(rows))
"""


# K5 at Qwen3-8B's five decode shapes and K1's deep lists at the low-rank
# (k' = 128 and 256) and hostrefine (k' = 256) coarse scans, over the
# low-rank world's three small coarse shards (k' = 128 and 256) and at d =
# 768 over 125,829 and 262,144 docs (k' = 128), each tree's own plan; uses
# only functions that every tree since the deep lists has
DECODE_DEEP_TIMER = """
import json, torch
from ragroute_tpu_torch.ops import decoder_checks as dc, kernel_checks as kc
from ragroute_tpu_torch.ops.fused_topk import fused_topk
from ragroute_tpu_torch.ops.int4_matmul import int4_matmul
dev, rows = torch.device("cuda"), []
def row(name, f, wrapper, reps):
    f()
    rows.append({"name": name, "ms": kc.cuda_time_ms(f, reps=reps),
                 "device_ms": dc.device_ms(f, wrapper, warmup=1, reps=reps),
                 "library_ms": None})
    torch.cuda.empty_cache()
for case in dc.int4_path_cases(dev):
    if case.name.startswith("qwen3-8b decode"):
        row("k5 " + case.name, lambda: dc.run_int4(case), int4_matmul, 20)
    del case
n_flat = 2_936_320
for label, case, ks in (
        ("k1 low-rank coarse 734003 x 128 bf16",
         kc.path_case(dev, d=128, k=128, seed=4), (128, 256)),
        ("k1 flat coarse 2936320 x 128 int8", kc.int8_path_case(
            dev, n=n_flat, d=128, k=256, pad_tail=n_flat - 2_936_012,
            seed=7), (256,))):
    for k in ks:
        case.k = k
        row(f"{label} k'={k}", lambda: kc.run_kernel(case), fused_topk, 3)
    del case
for n, d, ks in ((83_886, 128, (128, 256)), (104_857, 128, (128, 256)),
                 (125_829, 128, (128, 256)), (125_829, 768, (128,)),
                 (262_144, 768, (128,))):
    case = kc.path_case(dev, n=n, d=d, k=128, seed=0)
    for k in ks:
        case.k = k
        row(f"k1 small shard {n} x {d} bf16 k'={k}",
            lambda: kc.run_kernel(case), fused_topk, 5)
    del case
print(json.dumps(rows))
"""


# K3 at its path shape over bf16, int8 and int4 slabs (int8 / int4: random
# codes, a scale a slot, put in place of the bf16 case's slabs) and K1 over
# the 734,003 x 768 f32 shard at k = 32, each tree's own plan; uses only
# functions that every tree since the approximate modes has
GROUPED_F32_TIMER = """
import dataclasses, json, torch
from ragroute_tpu_torch.ops import decoder_checks as dc, kernel_checks as kc
from ragroute_tpu_torch.ops.fused_topk import fused_topk
from ragroute_tpu_torch.ops.grouped_gains import grouped_gains
dev, rows = torch.device("cuda"), []
def row(name, f, wrapper, reps):
    f()
    rows.append({"name": name, "ms": kc.cuda_time_ms(f, reps=reps),
                 "device_ms": dc.device_ms(f, wrapper, warmup=1, reps=reps),
                 "library_ms": None})
    torch.cuda.empty_cache()
base = kc.grouped_path_case(dev)
c, d, s = base.docs.shape
g = torch.Generator(device=dev).manual_seed(5)
scale = 0.005 + 0.005 * torch.rand((c, s), generator=g, device=dev)
for slab in ("bf16", "int8", "int4"):
    case = base
    if slab != "bf16":
        codes = torch.randint(-128, 128, (c, d // 2 if slab == "int4" else d,
                                          s), generator=g, device=dev,
                              dtype=torch.int16).to(torch.int8)
        case = dataclasses.replace(base, docs=codes, scale=scale,
                                   packed4=slab == "int4")
    row(f"k3 B=512 P=512 C=4096 d=768 S=256 {slab}",
        lambda: kc.run_grouped_kernel(case), grouped_gains, 10)
    del case
del base
torch.cuda.empty_cache()
f32 = kc.path_case(dev, dtype=torch.float32)
row("k1 734003 x 768 f32 k=32", lambda: kc.run_kernel(f32), fused_topk, 3)
print(json.dumps(rows))
"""


# K1 over the 734,003 x 768 f32 shard at the small batches (B = 1, 8, 32
# and 64, k = 32) and K2 at the ivf collect [512, 131,072] and at the
# shapes --impl hybrid hands it ([8 and 16, 131,072]), k = 32, each tree's
# own plan; uses only functions that every tree since the decode-attention
# kernel's port has
SMALL_F32_COLLECT_TIMER = """
import json, torch
from ragroute_tpu_torch.ops import decoder_checks as dc, kernel_checks as kc
from ragroute_tpu_torch.ops.fused_topk import fused_topk
from ragroute_tpu_torch.ops.stream_topk import stream_topk
dev, rows = torch.device("cuda"), []
def row(name, f, wrapper, reps, library=None):
    f()
    rows.append({"name": name, "ms": kc.cuda_time_ms(f, reps=reps),
                 "device_ms": dc.device_ms(f, wrapper, warmup=1, reps=reps),
                 "library_ms": None if library is None
                 else kc.cuda_time_ms(library, reps=reps)})
    torch.cuda.empty_cache()
f32 = kc.path_case(dev, dtype=torch.float32)
base = f32.queries
for bsz in (1, 8, 32, 64):
    f32.queries = base[:bsz].contiguous()
    row(f"k1 B={bsz} 734003 x 768 f32 k=32", lambda: kc.run_kernel(f32),
        fused_topk, 5)
del f32, base
torch.cuda.empty_cache()
for bsz in (512, 8, 16):
    gains = kc.stream_path_case(dev, bsz=bsz, m=131072, pad_share=0.2,
                                seed=2)
    row(f"k2 ivf collect [{bsz}, 131072] k=32",
        lambda: stream_topk(gains, 32), stream_topk, 50,
        library=lambda: torch.topk(gains, 32, dim=1))
    del gains
print(json.dumps(rows))
"""


# this tree only: K1's small-batch f32 scan against the f32 scan at the
# batches around their crossover (B = 64, 65, 96, 128; the reading behind
# fused_topk.f32_scan_pays) and the first design beside both at B = 8 and
# 64, over pubmed's 734,003 and statpearls' 104,857 f32 rows
SMALL_SWITCH_TIMER = """
import json, torch
from ragroute_tpu_torch.ops import decoder_checks as dc, kernel_checks as kc
from ragroute_tpu_torch.ops.fused_topk import fused_topk
dev, rows = torch.device("cuda"), []
for n in (734_003, 104_857):
    for bsz in (8, 64, 65, 96, 128):
        case = kc.path_case(dev, bsz=bsz, n=n, dtype=torch.float32, seed=1)
        kernels = ("f32_small", "f32") + (("shallow",) if bsz in (8, 64)
                                          else ())
        for kernel in kernels:
            f = lambda: kc.run_kernel(case, kernel)
            rows.append({"name": f"k1 B={bsz} N={n} d=768 f32 k=32",
                         "kernel": kernel, "ms": kc.cuda_time_ms(f, reps=5),
                         "device_ms": dc.device_ms(f, fused_topk, warmup=1,
                                                   reps=5)})
        del case
        torch.cuda.empty_cache()
print(json.dumps(rows))
"""


# this tree only: K5's kernels over M at the gate/up shape (the first
# kernel against the decode kernel below M_SWITCH and the prefill kernel
# from it), and K1's deep fold against the deep launch over k (past 64),
# the docs' width and the shard's size, for bf16, int8 and int4 docs (the
# readings behind the plan's choices)
SWITCH_TIMER = """
import json, torch
from ragroute_tpu_torch.ops import decoder_checks as dc, kernel_checks as kc
from ragroute_tpu_torch.ops.fused_topk import fused_topk
from ragroute_tpu_torch.ops.int4_matmul import int4_matmul
dev, rows = torch.device("cuda"), []
for m in (1, 16, 40, 63, 64, 128, 256, 512, 2048, 8192):
    gen = torch.Generator(device=dev).manual_seed(m)
    case = dc._rand_case(f"k5 gate/up M={m}", dev, m, 4096, 12288, 128,
                         torch.bfloat16, gen, exact=False)
    for kernel in ("mma", "decode" if m < 64 else "wgmma"):
        f = lambda: dc.run_int4(case, kernel)
        rows.append({"name": case.name, "kernel": kernel,
                     "ms": kc.cuda_time_ms(f, reps=10),
                     "device_ms": dc.device_ms(f, int4_matmul, reps=10)})
    del case
    torch.cuda.empty_cache()
def scan_against_deep(label, case, ks):
    for k in ks:
        case.k = k
        for kernel in ("fold", "deep") if k > 64 else ("wgmma", "deep"):
            f = lambda: kc.run_kernel(case, kernel)
            rows.append({"name": f"k1 B=512 {label} k={k}",
                         "kernel": kernel, "ms": kc.cuda_time_ms(f, reps=5),
                         "device_ms": dc.device_ms(f, fused_topk, warmup=1,
                                                   reps=3)})
        torch.cuda.empty_cache()
for d in (128, 512, 768):
    scan_against_deep(f"N=734003 d={d} bf16",
                      kc.path_case(dev, d=d, seed=4 if d == 128 else 0),
                      (65, 128, 160, 256))
# the low-rank world's small shards and one between them and pubmed's (the
# deep fold's first design lost to the deep launch there)
for n in (83_886, 104_857, 125_829, 262_144):
    for d in (128, 768):
        scan_against_deep(f"N={n} d={d} bf16", kc.path_case(dev, n=n, d=d,
                                                            seed=0), (128,))
# K3's wgmma kernel against the first design at the small sources' shapes
# (C = 1,024 clusters, S 104 to 160, 128 probes) and at B = 8 over pubmed's
from ragroute_tpu_torch.ops.grouped_gains import grouped_gains
for bsz, c, s, p in ((512, 1024, 104, 128), (512, 1024, 160, 128),
                     (8, 4096, 256, 512), (512, 4096, 256, 512)):
    case = kc.grouped_path_case(dev, bsz=bsz, c=c, s=s, nprobe=p)
    for kernel in ("wgmma", "first"):
        f = lambda: kc.run_grouped_kernel(case, kernel)
        rows.append({"name": f"k3 B={bsz} P={p} C={c} d=768 S={s} bf16",
                     "kernel": kernel, "ms": kc.cuda_time_ms(f, reps=5),
                     "device_ms": dc.device_ms(f, grouped_gains, warmup=1,
                                               reps=5)})
    del case
    torch.cuda.empty_cache()
n_flat = 2_936_320
for label, make, ks in (
        (f"N={n_flat} d=128 int8 (flat coarse)", lambda: kc.int8_path_case(
            dev, n=n_flat, d=128, k=32, pad_tail=n_flat - 2_936_012, seed=7),
         (65, 128, 256)),
        ("N=734003 d=768 int8", lambda: kc.int8_path_case(
            dev, n=734_003, d=768, k=32, seed=8), (128, 256)),
        ("N=734003 d=128 int4 per-doc", lambda: kc.int4_path_case(
            dev, grouped=False, d=128), (128, 256)),
        ("N=734003 d=768 int4 per-doc", lambda: kc.int4_path_case(
            dev, grouped=False), (128, 256))):
    scan_against_deep(label, make(), ks)
print(json.dumps(rows))
"""


# K1's deep fold at d = 128 beside the deep launch: at the low-rank
# world's small shards over its candidate slots a (row, split)
# (deep_topk.fold_cap, 4 or 8 a list's entry), the sample's docs an entry
# (deep_topk.FOLD_SAMPLE_PER_K) and the most splits the plan may take
# (fused_topk.MAX_SPLITS: the card's 33 a row block at B = 512, 16 or 8,
# longer splits); over shards whose splits run 42 to 116 tiles, at both
# buffers (the tile length where the wider one stops paying,
# deep_topk.FOLD_SHORT_TILES): the readings behind those constants, this
# tree only
FOLD_SWEEP_TIMER = """
import json, torch
from ragroute_tpu_torch.ops import decoder_checks as dc, deep_topk as dt
from ragroute_tpu_torch.ops import fused_topk as ft, kernel_checks as kc
dev, rows = torch.device("cuda"), []
cap0, per0, max0 = dt.fold_cap, dt.FOLD_SAMPLE_PER_K, ft.MAX_SPLITS
def cap_of(x):
    return lambda k, tiles=None: max(k + dt.FOLD_SLACK, -(-x * k // 32) * 32)
def row(name, kernel, f):
    rows.append({"name": name, "kernel": kernel,
                 "ms": kc.cuda_time_ms(f, reps=5),
                 "device_ms": dc.device_ms(f, ft.fused_topk, warmup=1,
                                           reps=5)})
small = (83_886, 104_857, 125_829)
for n in small + (262_144, 400_000, 550_000, 734_003):
    case = kc.path_case(dev, n=n, d=128, k=128, seed=0)
    for k in (128, 256) if n in small or n == 734_003 else (128,):
        case.k = k
        name = f"k1 B=512 N={n} d=128 bf16 k={k}"
        row(name, "deep", lambda: kc.run_kernel(case, "deep"))
        per = ft._plan(512, n, 128, k, 1, ft._sm_count(dev),
                       "fold").tiles_per_split
        for x in (4, 8):
            for s in (6, 8, 12) if n in small and k == 128 else (8,):
                dt.fold_cap, dt.FOLD_SAMPLE_PER_K = cap_of(x), s
                row(name, f"fold cap {x}k sample {s}k ({per} tiles a split)",
                    lambda: kc.run_kernel(case, "fold"))
        dt.fold_cap, dt.FOLD_SAMPLE_PER_K = cap0, per0
        for most in (16, 8) if n in small else ():
            ft.MAX_SPLITS = most
            plan = ft._plan(512, n, 128, k, 1, ft._sm_count(dev), "fold")
            row(name, f"fold at most {most} splits ({plan.splits} of "
                f"{plan.tiles_per_split} tiles, cap {plan.cap})",
                lambda: kc.run_kernel(case, "fold"))
            ft.MAX_SPLITS = max0
    del case
    torch.cuda.empty_cache()
print(json.dumps(rows))
"""


# the deep lists of --refine-mult 8 beside the default depth, this tree only
DEEP_TIMER = """
import json, torch
from ragroute_tpu_torch.ops import decoder_checks as dc, kernel_checks as kc
from ragroute_tpu_torch.ops.fused_topk import fused_topk
from ragroute_tpu_torch.ops.grouped_topk import grouped_pair_topk
from ragroute_tpu_torch.ops.stream_topk import stream_topk
dev, rows = torch.device("cuda"), []
def row(name, f, wrapper, bound, reps, library=None):
    r = {"name": name, "ms": kc.cuda_time_ms(f, reps=reps),
         "device_ms": dc.device_ms(f, wrapper, reps=reps),
         "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
         "design_floor_ms": bound.get("design_floor_ms"),
         "library_ms": None if library is None
         else kc.cuda_time_ms(library, reps=reps)}
    rows.append(r)
    torch.cuda.empty_cache()
n_flat = 2_936_320
for label, case in (
        ("k1 low-rank coarse 734003 x 128 bf16", kc.path_case(dev, d=128,
                                                            k=128, seed=4)),
        ("k1 flat coarse 2936320 x 128 int8", kc.int8_path_case(
            dev, n=n_flat, d=128, k=128, pad_tail=n_flat - 2_936_012,
            seed=7))):
    for k in (128, 256):
        case.k = k
        row(f"{label} k'={k}", lambda: kc.run_kernel(case), fused_topk,
            kc.k1_bound(case), reps=5)
    del case
gains = kc.stream_path_case(dev, m=4096, pad_share=0.1, seed=8)
for k in (128, 256):
    row(f"k2 probed collect [512, 4096] k'={k}",
        lambda: stream_topk(gains, k), stream_topk, kc.k2_bound(gains, k),
        reps=50, library=lambda: torch.topk(gains, k, dim=1))
del gains
case = kc.pair_path_case(dev, bsz=64, c=64, s=568, nprobe=64, kappa=256,
                         seed=6)
row("k4 reduced world nprobe == C = 64, S = 568, kappa 256 (ranks 256)",
    lambda: kc.run_pair_kernel(case), grouped_pair_topk, kc.k4_bound(case),
    reps=20)
print(json.dumps(rows))
"""


# the exact engine step over the 1,048,575-doc world in f32 at the
# batcher's small buckets (B = 1, 8 and 32, routing ragroute and all; host
# clock around engine.search, median of 20 after 2 warm-ups); uses only
# functions that every tree since the approximate modes has
F32_STEP_TIMER = """
import json, time, numpy as np, torch
from ragroute_tpu_torch.engine import FederatedSearchEngine
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.router import CorpusRouter, RouterBank
dev, rows = torch.device("cuda"), []
syn = make_synthetic_world("medrag", docs_per_source_map={
    "pubmed": 734_003, "statpearls": 104_857, "textbooks": 83_886,
    "wikipedia": 125_829}, num_queries=64, seed=0, with_payloads=False)
ss = ShardSet.build(syn.world, syn.embeddings, dtype=torch.float32,
                    device=dev)
eng = FederatedSearchEngine(
    ss, CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev),
    RouterBank.create(syn.world, syn.centroids, device=dev), impl="auto")
for strategy in ("ragroute", "all"):
    for bsz in (1, 8, 32):
        q = {enc: e[:bsz] for enc, e in syn.query_embs.items()}
        times = []
        for i in range(22):
            t0 = time.perf_counter()
            eng.search(q, strategy=strategy, staged=False,
                       fetch_candidates=False)
            times.append(1e3 * (time.perf_counter() - t0))
        rows.append({"name": f"f32 exact step {strategy} B={bsz}",
                     "ms": float(np.median(times[2:]))})
print(json.dumps(rows))
"""


# --turns: the exact engine step over the 1,048,575-doc world (bf16, impl
# auto, B = 512 and 2,048, routing ragroute and all; host clock around
# engine.search, median of 10 after 2 warm-ups) and one lockstep batch of
# Qwen3-8B with random int4 weights and an int8 KV cache (B = 16 prompts of
# 2,048 tokens, prefill then 32 greedy decode steps; CUDA-synchronised host
# clock, median of 3 after a warm-up); both use only functions that every
# tree since on-card generation has
STEP_TIMER = """
import json, time, numpy as np, torch
from ragroute_tpu_torch.engine import FederatedSearchEngine
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.router import CorpusRouter, RouterBank
dev, rows = torch.device("cuda"), []
syn = make_synthetic_world("medrag", docs_per_source_map={
    "pubmed": 734_003, "statpearls": 104_857, "textbooks": 83_886,
    "wikipedia": 125_829}, num_queries=2048, seed=0, with_payloads=False)
ss = ShardSet.build(syn.world, syn.embeddings, dtype=torch.bfloat16,
                    device=dev)
eng = FederatedSearchEngine(
    ss, CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev),
    RouterBank.create(syn.world, syn.centroids, device=dev), impl="auto")
for strategy in ("ragroute", "all"):
    for bsz in (512, 2048):
        q = {enc: e[:bsz] for enc, e in syn.query_embs.items()}
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            eng.search(q, strategy=strategy, staged=False,
                       fetch_candidates=False)
            times.append(1e3 * (time.perf_counter() - t0))
        rows.append({"name": f"exact step {strategy} B={bsz}",
                     "ms": float(np.median(times[2:]))})
print(json.dumps(rows))
"""

# --turns: the host tiers' steps over the world chip_smoke.py serves (the
# synthetic medrag world at four times the benchmark's size, int8, 64 topics
# a source, under 1.5 GB: pubmed goes to the host tier): stream, then
# hostrefine over the clustered coarse slab; host clock around
# engine.search at B = 512, median of 5 after a warm-up; uses only functions
# that every tree since the host tiers has
TIER_TIMER = """
import json, time, numpy as np, torch
from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine
from ragroute_tpu_torch.index.streamed import StreamedShardSet
from ragroute_tpu_torch.index.synthetic import make_streamed_world
from ragroute_tpu_torch.ops.grouped_topk import cluster_coarse_slab
from ragroute_tpu_torch.router import CorpusRouter, RouterBank
dev, rows = torch.device("cuda"), []
docs = {"pubmed": 2_936_012, "statpearls": 419_428, "textbooks": 335_544,
        "wikipedia": 503_316}
syn = make_streamed_world("medrag", docs_per_source_map=docs,
                          num_queries=512, seed=0, subclusters=64)
router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev)
bank = RouterBank.create(syn.world, syn.centroids, device=dev)
for tier in ("stream", "hostrefine"):
    sset = StreamedShardSet.build(syn.world, syn.row_sources,
                                  dtype=torch.int8, tier=tier,
                                  hbm_budget_bytes=int(1.5e9), device=dev)
    label = tier
    if tier == "hostrefine":
        label = "hostrefine probed"
        for st in sset.sources:
            if st.coarse_docs is None:
                continue
            n = st.n_docs
            st.coarse_cl = cluster_coarse_slab(
                st.coarse_docs[:n].cpu().numpy(),
                st.coarse_scale[:n].cpu().numpy(),
                st.coarse_bias[:n].cpu().numpy(), 0, device=dev)
            st.coarse_docs = st.coarse_scale = st.coarse_bias = None
    eng = StreamedSearchEngine(sset, router, bank)
    for strategy in ("ragroute", "all"):
        times = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.search(syn.query_embs, strategy=strategy,
                       fetch_candidates=False)
            times.append(1e3 * (time.perf_counter() - t0))
        rows.append({"name": f"{label} step {strategy} B=512",
                     "ms": float(np.median(times[1:]))})
    del eng, sset
    torch.cuda.empty_cache()
print(json.dumps(rows))
"""

# --turns: the low-rank engine step over the 1,048,575-doc world (bf16,
# rank-128 coarse scan at k' = 128, B = 512, routing ragroute and all; host
# clock around engine.search, median of 10 after 2 warm-ups) and one decode
# step of Qwen3-8B with random int4 weights at B = 16 over a 2,080-position
# int8 cache (measure.decode_step_breakdown: host clock and profiler); both
# use only functions that every tree since on-card generation has
LOWRANK_DECODE_TIMER = """
import json, time, numpy as np, torch
from ragroute_tpu_torch.engine import FederatedSearchEngine
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.llm.shapes import QWEN3_8B, quantized_from_masters
from ragroute_tpu_torch.measure import decode_step_breakdown
from ragroute_tpu_torch.router import CorpusRouter, RouterBank
dev, rows = torch.device("cuda"), []
syn = make_synthetic_world("medrag", docs_per_source_map={
    "pubmed": 734_003, "statpearls": 104_857, "textbooks": 83_886,
    "wikipedia": 125_829}, num_queries=512, seed=0, with_payloads=False)
ss = ShardSet.build(syn.world, syn.embeddings, dtype=torch.bfloat16,
                    device=dev, lowrank=-1)
eng = FederatedSearchEngine(
    ss, CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev),
    RouterBank.create(syn.world, syn.centroids, device=dev), impl="lowrank")
for strategy in ("ragroute", "all"):
    times = []
    for i in range(12):
        t0 = time.perf_counter()
        eng.search(syn.query_embs, strategy=strategy, staged=False,
                   fetch_candidates=False)
        times.append(1e3 * (time.perf_counter() - t0))
    rows.append({"name": f"lowrank step {strategy} B=512",
                 "ms": float(np.median(times[2:]))})
del eng, ss, syn
torch.cuda.empty_cache()
params = quantized_from_masters(QWEN3_8B, 4, dev)
step = decode_step_breakdown(params, QWEN3_8B, dev)
rows.append({"name": "qwen3-8b decode step B=16 S=2080 int4, int8 KV",
             "ms": step["step_ms"], "device_ms": step["profile_device_ms"],
             "busy_share": step["busy_share"],
             "k5_ms": sum(k["ms_per_step"] for k in step["kernels"]
                          if "int4_mm" in k["name"]
                          or "reduce_splits" in k["name"]),
             "k5_launches": step["k5_launches_per_step"]})
print(json.dumps(rows))
"""

# the low-rank engine step over the 1,048,575-doc world (bf16, rank-128
# coarse scans at k' = 128, B = 512): host clock around engine.search under
# ragroute and all (median of 10 after 2 warm-ups), then 10 steps under all
# in torch.profiler: device ms, K1's (its kernels by name: the scan and its
# fold, the split merge, the deep launch's gains and selection) and K1's
# over the three small shards (K1's less pubmed's: each step's largest scan
# launch and the split merges, which only pubmed's fold ran before the
# fold took every shard); uses only functions that every tree since the
# deep fold has
LOWRANK_STEP_TIMER = """
import json, time, numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from ragroute_tpu_torch.engine import FederatedSearchEngine
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.router import CorpusRouter, RouterBank
dev, rows = torch.device("cuda"), []
syn = make_synthetic_world("medrag", docs_per_source_map={
    "pubmed": 734_003, "statpearls": 104_857, "textbooks": 83_886,
    "wikipedia": 125_829}, num_queries=512, seed=0, with_payloads=False)
ss = ShardSet.build(syn.world, syn.embeddings, dtype=torch.bfloat16,
                    device=dev, lowrank=-1)
eng = FederatedSearchEngine(
    ss, CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev),
    RouterBank.create(syn.world, syn.centroids, device=dev), impl="lowrank")
def step(strategy):
    eng.search(syn.query_embs, strategy=strategy, staged=False,
               fetch_candidates=False)
for strategy in ("ragroute", "all"):
    times = []
    for i in range(12):
        t0 = time.perf_counter()
        step(strategy)
        times.append(1e3 * (time.perf_counter() - t0))
    rows.append({"name": f"lowrank step {strategy} B=512",
                 "ms": float(np.median(times[2:]))})
K1 = ("wgmma_topk_kernel", "merge_splits_kernel", "chunk_gains_kernel",
      "select_sort_kernel", "deep::merge_kernel", "emit_kernel")
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(10):
        step("all")
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
ev = [e for e in prof.events()
      if e.device_type == torch.autograd.DeviceType.CUDA]
dur = lambda e: e.time_range.elapsed_us() / 1e3
k1 = [e for e in ev if any(n in e.name for n in K1)]
scans = sorted((e for e in k1 if "wgmma_topk_kernel" in e.name),
               key=lambda e: e.time_range.start)
per = len(scans) // 10
largest = sum(max(dur(e) for e in scans[i * per:(i + 1) * per])
              for i in range(10))
k1_ms = sum(dur(e) for e in k1)
merges = sum(dur(e) for e in k1 if "merge_splits_kernel" in e.name)
rows.append({"name": "lowrank 10 steps all B=512 (profiled)", "ms": wall,
             "device_ms": sum(dur(e) for e in ev), "k1_ms": k1_ms,
             "k1_small_ms": k1_ms - largest - merges})
print(json.dumps(rows))
"""

# --turns: the ivf step over the topical world (1,048,575 docs x 768, 64
# topics a source, bf16 with the balanced-IVF layouts, B = 512, routing all;
# host clock around engine.search, median of 10 after 2 warm-ups) with the
# device time of 10 steps and K3's share of it (profile_steps), then the
# exact step over the same world in f32 (B = 512, routing all); both use
# only functions that every tree since the approximate modes has
IVF_F32_TIMER = """
import gc, json, time, numpy as np, torch
from ragroute_tpu_torch.engine import FederatedSearchEngine
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.measure import profile_steps
from ragroute_tpu_torch.router import CorpusRouter, RouterBank
dev, rows = torch.device("cuda"), []
syn = make_synthetic_world("medrag", docs_per_source_map={
    "pubmed": 734_003, "statpearls": 104_857, "textbooks": 83_886,
    "wikipedia": 125_829}, num_queries=512, seed=0, with_payloads=False,
    subclusters=64)
router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev)
bank = RouterBank.create(syn.world, syn.centroids, device=dev)
for label, dtype, impl, build in (("ivf", torch.bfloat16, "ivf",
                                   {"ivf_clusters": -1}),
                                  ("f32 exact", torch.float32, "auto", {})):
    ss = ShardSet.build(syn.world, syn.embeddings, dtype=dtype, device=dev,
                        **build)
    eng = FederatedSearchEngine(ss, router, bank, impl=impl)
    times = []
    for i in range(12):
        t0 = time.perf_counter()
        eng.search(syn.query_embs, strategy="all", staged=False,
                   fetch_candidates=False)
        times.append(1e3 * (time.perf_counter() - t0))
    prof = profile_steps(eng, syn, 512, top=40)
    k3 = sum(k["ms"] for k in prof["kernels"] if "grouped_" in k["name"])
    k1 = sum(k["ms"] for k in prof["kernels"] if "topk_kernel" in k["name"])
    rows.append({"name": f"{label} step all B=512",
                 "ms": float(np.median(times[2:])),
                 "device_ms": prof["device_ms"] / 10,
                 "busy_share": prof["busy_share"], "k3_ms": k3 / 10,
                 "k1_ms": k1 / 10})
    del eng, ss
    gc.collect()
    torch.cuda.empty_cache()
print(json.dumps(rows))
"""

LOCKSTEP_TIMER = """
import json, time, numpy as np, torch
from ragroute_tpu_torch.llm.model import decode_step, init_cache, prefill
from ragroute_tpu_torch.llm.shapes import QWEN3_8B, quantized_from_masters
dev, cfg = torch.device("cuda"), QWEN3_8B
params = quantized_from_masters(cfg, 4, dev)
b, p, new = 16, 2048, 32
gen = torch.Generator(device=dev).manual_seed(0)
ids = torch.randint(0, cfg.vocab_size, (b, p), generator=gen, device=dev,
                    dtype=torch.int32)
mask = torch.ones_like(ids)
lengths = torch.full((b,), p, dtype=torch.int32, device=dev)
def batch():
    cache = init_cache(cfg, b, p + new, "int8", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, ids, mask, cache)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = logits.argmax(-1)
    for t in range(new):
        logits, cache = decode_step(params, cfg, cache, tok, lengths, p, t)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0)
with torch.no_grad():
    batch()
    runs = [batch() for _ in range(3)]
pre = float(np.median([r[0] for r in runs]))
tot = float(np.median([r[1] for r in runs]))
print(json.dumps([{"name": "lockstep prefill B=16 P=2048", "ms": pre},
                  {"name": "lockstep batch B=16 P=2048 +32", "ms": tot,
                   "tokens_per_s": b * new / (tot / 1e3)}]))
"""


def served_in_turns(parent: str, card: str, timers=None):
    """The exact engine step, a lockstep generation batch, the host tiers'
    steps, the low-rank step and a decode step (``timers``, default all)
    from ``parent`` and this tree in turns (parent, this, this, parent),
    each in a process of its own."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for label, tree in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        for timer in timers or (STEP_TIMER, LOCKSTEP_TIMER, TIER_TIMER,
                                LOWRANK_DECODE_TIMER, IVF_F32_TIMER,
                                F32_STEP_TIMER):
            proc = subprocess.run([sys.executable, "-c", timer], cwd=tree,
                                  capture_output=True, text=True,
                                  timeout=1200)
            if proc.returncode != 0:
                raise RuntimeError(f"{label} timer failed:\n{proc.stderr}")
            for row in json.loads(proc.stdout.strip().splitlines()[-1]):
                extra = ("" if "tokens_per_s" not in row else
                         f", {row['tokens_per_s']:.1f} tokens/s")
                if "k5_ms" in row:
                    extra += (f", device {row['device_ms']:.3f} ms (K5 "
                              f"{row['k5_ms']:.3f} in "
                              f"{row['k5_launches']:.0f} launches), busy "
                              f"share {row['busy_share']:.3f}")
                elif "k1_small_ms" in row:
                    extra += (f", device {row['device_ms']:.3f} ms (K1 "
                              f"{row['k1_ms']:.3f}, of which the small "
                              f"shards' {row['k1_small_ms']:.3f})")
                elif "k3_ms" in row:
                    extra += (f", device {row['device_ms']:.3f} ms a step "
                              f"(K3 {row['k3_ms']:.3f}, K1 "
                              f"{row['k1_ms']:.3f}), busy share "
                              f"{row['busy_share']:.3f}")
                elif "device_ms" in row:
                    extra += f", device {row['device_ms']:.4f} ms"
                print(f"[turns] {label}: {row['name']}: {row['ms']:.3f} ms"
                      f"{extra} ({card})", flush=True)
                out.append(dict(row, tree=label))
    return out


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _counts():
    from ragroute_tpu_torch.ops.fused_topk import fused_topk
    from ragroute_tpu_torch.ops.grouped_gains import grouped_gains
    from ragroute_tpu_torch.ops.grouped_topk import grouped_pair_topk
    from ragroute_tpu_torch.ops.stream_topk import stream_topk

    return {"fused_topk": fused_topk, "stream_topk": stream_topk,
            "grouped_gains": grouped_gains,
            "grouped_pair_topk": grouped_pair_topk}


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
    """Device time by kernel (and copy) over ``steps`` back-to-back
    steps."""
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
    # K1's scan launches (one a scored shard a step, in launch order): the
    # largest of each step's is the largest shard's, the rest the smaller
    # shards' (the deep launch's kernels, where a plan takes it, are in
    # ``kernels`` by name)
    k1 = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "wgmma_topk_kernel" in e.name),
                key=lambda e: e.time_range.start)
    per = len(k1) // steps if steps else 0
    durs = [e.time_range.elapsed_us() / 1e3 for e in k1]
    small = sum(sum(sorted(durs[i * per:(i + 1) * per])[:-1])
                for i in range(steps)) if per > 1 else 0.0
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "k1_scan_ms": sum(durs), "k1_scan_small_shards_ms": small,
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


TURN_TIMERS = (QUANT_TIMER, TURNS_TIMER, DECODE_DEEP_TIMER,
               GROUPED_F32_TIMER, SMALL_F32_COLLECT_TIMER)
SWITCH_TIMERS = (SMALL_SWITCH_TIMER, SWITCH_TIMER, FOLD_SWEEP_TIMER)


def kernels_in_turns(parent: Optional[str], card: str):
    """K2 and K6, K1 at its int8, int4 and f32 shapes and K4 timed from this
    tree, or from ``parent`` and this tree in turns (parent, this, this,
    parent), K1 at the serving shape too; then the crossover readings and
    the deep lists from this tree."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    if parent:
        out += [dict(r, name="k1 B=512 N=734003 d=768 bf16 k=32")
                for r in parent_vs_change(parent, card)]
    turns = ((("parent", parent), ("change", here), ("change", here),
              ("parent", parent)) if parent else (("change", here),))
    for label, tree in turns:
        for timer in TURN_TIMERS:
            proc = subprocess.run([sys.executable, "-c", timer], cwd=tree,
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{label} kernel timer failed:\n"
                                   f"{proc.stderr}")
            for row in json.loads(proc.stdout.strip().splitlines()[-1]):
                lib = ("" if row["library_ms"] is None
                       else f", library {row['library_ms']:.4f} ms")
                print(f"[kernels] {label}: {row['name']}: {row['ms']:.4f} ms "
                      f"(device {row['device_ms']:.4f}){lib} ({card})",
                      flush=True)
                out.append(dict(row, tree=label))
    for timer in SWITCH_TIMERS:
        proc = subprocess.run([sys.executable, "-c", timer], cwd=here,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"switch timer failed:\n{proc.stderr}")
        for row in json.loads(proc.stdout.strip().splitlines()[-1]):
            print(f"[switch] {row['name']} {row['kernel']}: {row['ms']:.4f} "
                  f"ms (device {row['device_ms']:.4f}) ({card})", flush=True)
            out.append(dict(row, tree="change"))
    proc = subprocess.run([sys.executable, "-c", DEEP_TIMER], cwd=here,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"deep list timer failed:\n{proc.stderr}")
    for row in json.loads(proc.stdout.strip().splitlines()[-1]):
        lib = ("" if row["library_ms"] is None
               else f", library {row['library_ms']:.4f} ms")
        floor = ("" if row["design_floor_ms"] is None
                 else f", with the gains' round trip "
                      f"{row['design_floor_ms']:.4f} ms")
        print(f"[deep] {row['name']}: {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}){floor}{lib} ({card})", flush=True)
        out.append(dict(row, tree="change"))
    return out


# the host tiers' world (also served by chip_smoke.py): the synthetic medrag
# world at eight times the benchmark's size, under a device budget that the
# three small sources fit and pubmed does not
TIER_DOCS = {"pubmed": 5_872_024, "statpearls": 838_856,
             "textbooks": 671_088, "wikipedia": 1_006_632}
TIER_BUDGET_GB = 3.0
TIER_BUDGET_BYTES = int(TIER_BUDGET_GB * 1e9)
TIER_BATCHES = (512, 2048)


def tier_step_times(eng, syn, reps: int = 5):
    """Median host-clock ms of one engine step per (strategy, B), and the
    phases of the last one."""
    out = {}
    for strategy in ("ragroute", "all"):
        for bsz in TIER_BATCHES:
            q = {enc: e[:bsz] for enc, e in syn.query_embs.items()}
            times = []
            for i in range(reps + 1):
                t0 = time.perf_counter()
                eng.search(q, strategy=strategy, fetch_candidates=False)
                if i >= 1:
                    times.append(1e3 * (time.perf_counter() - t0))
            out[f"{strategy}/B{bsz}"] = {
                "ms": float(np.median(times)),
                "last_phases": dict(eng.last_phases)}
    return out


def pipelined_rate(eng, syn, bsz: int, batches: int = 8):
    """Queries per second of ``batches`` hostrefine batches: dispatched
    and completed in turn, and with batch t + 1 dispatched before batch t
    completes (its device step runs under batch t's host rescore)."""
    qs = [{enc: np.roll(e, 7 * i, axis=0)[:bsz]
           for enc, e in syn.query_embs.items()} for i in range(batches)]
    kw = dict(strategy="ragroute", fetch_candidates=False)
    eng.search(qs[0], **kw)
    t0 = time.perf_counter()
    for q in qs:
        eng.complete_hostrefine(eng.dispatch_hostrefine(q, **kw))
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    handle = eng.dispatch_hostrefine(qs[0], **kw)
    for q in qs[1:]:
        nxt = eng.dispatch_hostrefine(q, **kw)
        eng.complete_hostrefine(handle)
        handle = nxt
    eng.complete_hostrefine(handle)
    pipe_s = time.perf_counter() - t0
    n = bsz * batches
    return {"sequential_qps": n / seq_s, "pipelined_qps": n / pipe_s}


def measure_tiers(card: str, device="cuda"):
    """The three host-tier engines over the 8.4 M-doc world."""
    from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine
    from ragroute_tpu_torch.index.streamed import StreamedShardSet
    from ragroute_tpu_torch.index.synthetic import make_streamed_world
    from ragroute_tpu_torch.ops.grouped_topk import cluster_coarse_slab
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    dev = torch.device(device)
    syn = make_streamed_world("medrag", docs_per_source_map=TIER_DOCS,
                              num_queries=max(TIER_BATCHES), seed=0,
                              subclusters=64)
    router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev)
    bank = RouterBank.create(syn.world, syn.centroids, device=dev)
    result = {}

    def build(tier):
        t0 = time.perf_counter()
        sset = StreamedShardSet.build(
            syn.world, syn.row_sources, dtype=torch.int8, tier=tier,
            hbm_budget_bytes=TIER_BUDGET_BYTES, device=dev)
        return sset, time.perf_counter() - t0

    def run(label, sset, build_s):
        torch.cuda.reset_peak_memory_stats()
        eng = StreamedSearchEngine(sset, router, bank)
        r = {"build_s": build_s, "device_gb": sset.index_bytes / 1e9,
             "host_gb": sset.host_bytes / 1e9}
        print(f"[tier:{label}] {sum(TIER_DOCS.values())} docs built in "
              f"{build_s:.1f} s: {r['device_gb']:.3f} GB on the card, "
              f"{r['host_gb']:.3f} GB of host rows ({card})", flush=True)
        r["step"] = tier_step_times(eng, syn)
        for key, v in r["step"].items():
            print(f"[tier:{label}] step {key}: {v['ms']:.3f} ms, last_phases "
                  f"{v['last_phases']} ({card})", flush=True)
        if eng.supports_pipelined_dispatch:
            r["rate"] = {f"B{b}": pipelined_rate(eng, syn, b)
                         for b in TIER_BATCHES}
            for key, v in r["rate"].items():
                print(f"[tier:{label}] {key} ragroute, 8 batches: sequential "
                      f"{v['sequential_qps']:.1f} q/s, pipelined "
                      f"{v['pipelined_qps']:.1f} q/s ({card})", flush=True)
        p = profile_steps(eng, syn, 512, steps=5)
        p["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        p["host_peak_rss_gb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        r["profile"] = p
        print(f"[tier:{label}] profile B=512 routing=all, 5 steps: wall "
              f"{p['wall_ms']:.3f} ms, device {p['device_ms']:.3f} ms, busy "
              f"share {p['busy_share']:.3f}, launches per step "
              f"{p['launches_per_step']}, peak device memory "
              f"{p['peak_memory_gb']:.3f} GB, peak host RSS "
              f"{p['host_peak_rss_gb']:.2f} GiB ({card})", flush=True)
        for k in p["kernels"]:
            print(f"[tier:{label}]   {k['ms']:9.3f} ms {k['calls']:5d} calls  "
                  f"{k['name']}", flush=True)
        result[label] = r

    sset, secs = build("stream")
    run("stream", sset, secs)
    del sset
    gc.collect()
    torch.cuda.empty_cache()
    sset, secs = build("hostrefine")
    run("hostrefine", sset, secs)
    # the probed scan over the same coarse slab, clustered
    t0 = time.perf_counter()
    for st in sset.sources:
        if st.coarse_docs is None:
            continue
        n = st.n_docs
        st.coarse_cl = cluster_coarse_slab(
            st.coarse_docs[:n].cpu().numpy(),
            st.coarse_scale[:n].cpu().numpy(),
            st.coarse_bias[:n].cpu().numpy(), 0, device=dev)
        st.coarse_docs = st.coarse_scale = st.coarse_bias = None
        print(f"[tier:hostrefine_probed] {st.name}: C="
              f"{st.coarse_cl.n_clusters} S={st.coarse_cl.capacity}",
              flush=True)
    run("hostrefine_probed", sset, time.perf_counter() - t0)
    return result


# ---- on-card generation: one decode step of the served decoder ---------------

LLM_BATCH, LLM_PROMPT, LLM_NEW = 16, 2048, 32


def decoder_bytes(params) -> int:
    """Bytes of every weight a decode step reads: each matrix (codes and
    scales), the norms and the head; the embedding table counts only as
    the head when it is tied (a lookup reads B columns). A tensor-parallel
    decoder's: every cell's (the replicated norms once a cell)."""
    from ragroute_tpu_torch.llm.sharding import TPDecoder

    if isinstance(params, TPDecoder):
        return sum(decoder_bytes(c) for row in params.cells for c in row)
    total = 0
    for module in [params, *params.layers]:
        for name, w in module.items():
            if name == "embed" and "lm_head" in dict(params.items()):
                continue
            for t in ((w.q, w.scale) if hasattr(w, "q") else (w,)):
                total += t.numel() * t.element_size()
    return total


def decode_step_breakdown(params, cfg, device, *, bsz: int = LLM_BATCH,
                          prompt: int = LLM_PROMPT, new: int = LLM_NEW,
                          cache_dtype="int8", steps: int = 5,
                          top: int = 12) -> dict:
    """Decode steps of ``llm.model.decode_step`` at batch ``bsz`` over a
    cache of ``prompt + new`` positions whose prompt slots are all valid:
    the median host-clock ms of a step that ends in a synchronise, its
    bound (the weights read once plus the valid K/V of every layer, over
    the card's memory rate), and a ``torch.profiler`` window over
    ``steps`` steps (device time by kernel, busy share, K5 launches a
    step)."""
    from torch.profiler import ProfilerActivity, profile

    from ragroute_tpu_torch.llm.model import decode_step
    from ragroute_tpu_torch.ops.int4_matmul import int4_matmul
    from ragroute_tpu_torch.ops.kernel_checks import HBM_BYTES_PER_S

    cache = params.init_cache(cfg, bsz, prompt + new, cache_dtype)
    lengths = torch.full((bsz,), prompt, dtype=torch.int32, device=device)
    tok = torch.arange(bsz, dtype=torch.int32, device=device)
    times, t = [], 0
    with torch.no_grad():
        for i in range(2 + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode_step(params, cfg, cache, tok, lengths,
                                        prompt, t)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(1e3 * (time.perf_counter() - t0))
            t += 1
        int4_matmul.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = decode_step(params, cfg, cache, tok, lengths,
                                            prompt, t)
                t += 1
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    # K5's kernels on the device (the profiler's count, which may miss a
    # few at the window's edges): at most one a call when every call is one
    # launch, and no separate sum of split partials
    k5_kernels = sum(c for n, _, c in rows
                     if "int4_mm" in n or "reduce_splits" in n)
    k5_split_sums = sum(c for n, _, c in rows if "reduce_splits" in n)
    # the valid K/V a step reads (codes and, for an int8 cache, scales),
    # at the mean valid length of the timed steps
    s_valid = prompt + 2 + (steps + 1) / 2
    code_bytes = torch.tensor(
        [], dtype=torch.int8 if cache_dtype == "int8" else cache_dtype
    ).element_size()
    per_pos = 2 * cfg.num_layers * bsz * cfg.num_kv_heads * (
        cfg.head_dim * code_bytes + (4 if "ks" in cache else 0))
    wbytes = decoder_bytes(params)
    kv_bytes = per_pos * s_valid
    return {"step_ms": float(np.median(times)),
            "bound_ms": 1e3 * (wbytes + kv_bytes) / HBM_BYTES_PER_S,
            "weight_bytes": wbytes, "kv_bytes": kv_bytes,
            "profile_wall_ms": wall_ms / steps,
            "profile_device_ms": device_ms / steps,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "k5_launches_per_step": int4_matmul.launches / steps,
            "k5_kernels_per_step": k5_kernels / steps,
            "k5_split_sums_per_step": k5_split_sums / steps,
            "kernels": [{"name": n[:90], "ms_per_step": ms / steps,
                         "calls_per_step": c / steps}
                        for n, ms, c in rows[:top]]}


def prefill_breakdown(params, cfg, device, *, bsz: int = LLM_BATCH,
                      prompt: int = LLM_PROMPT, cache_dtype="int8",
                      top: int = 12) -> dict:
    """One ``llm.model.prefill`` of ``bsz`` prompts of ``prompt`` tokens,
    the lockstep service's batch: its host-clock ms after a warm-up (a
    synchronise at each end) and a ``torch.profiler`` window over one more
    (device time by kernel, busy share, K5 launches)."""
    from torch.profiler import ProfilerActivity, profile

    from ragroute_tpu_torch.llm.model import init_cache, prefill
    from ragroute_tpu_torch.ops.int4_matmul import int4_matmul

    gen = torch.Generator(device=device).manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (bsz, prompt), generator=gen,
                        device=device, dtype=torch.int32)
    mask = torch.ones_like(ids)
    with torch.no_grad():
        times = []
        for _ in range(2):
            cache = init_cache(cfg, bsz, prompt, cache_dtype, device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, cfg, ids, mask, cache)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        cache = init_cache(cfg, bsz, prompt, cache_dtype, device=device)
        int4_matmul.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill(params, cfg, ids, mask, cache)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"prefill_ms": times[-1], "profile_wall_ms": wall_ms,
            "profile_device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "k5_launches": int4_matmul.launches,
            "kernels": [{"name": n[:90], "ms": ms, "calls": c}
                        for n, ms, c in rows[:top]]}


def print_decode_breakdown(out: dict, card: str, label: str = "qwen3-8b"
                           ) -> None:
    print(f"[decode:{label}] B={LLM_BATCH} S={LLM_PROMPT + LLM_NEW} int4 "
          f"weights, int8 KV: step {out['step_ms']:.3f} ms (median of 5, "
          f"host clock), bound {out['bound_ms']:.3f} ms ("
          f"{out['weight_bytes'] / 1e9:.3f} GB weights + "
          f"{out['kv_bytes'] / 1e9:.3f} GB K/V at 3.35 TB/s); profiler: "
          f"wall {out['profile_wall_ms']:.3f} ms, device "
          f"{out['profile_device_ms']:.3f} ms a step, busy share "
          f"{out['busy_share']:.3f}, K5 calls a step "
          f"{out['k5_launches_per_step']:.1f} and K5 kernels on the device "
          f"{out['k5_kernels_per_step']:.1f} (split sums "
          f"{out['k5_split_sums_per_step']:.1f}) ({card})", flush=True)
    for k in out["kernels"]:
        print(f"[decode:{label}]   {k['ms_per_step']:8.3f} ms "
              f"{k['calls_per_step']:7.1f} calls a step  {k['name']}",
              flush=True)


ENC_SEQ = 128
ENC_BUCKETS = (1, 8, 32)


def measure_encoders(card: str, device="cuda") -> list:
    """Serial size-1 forwards against one bucketed forward for every
    published-width encoder (see the module's docstring)."""
    from ragroute_tpu_torch.encoders import checks as EC
    from ragroute_tpu_torch.encoders import published as P
    from ragroute_tpu_torch.encoders.bert import pool

    dev = torch.device(device)
    out = []
    for key, specs in P.distinct_models().items():
        pub = P.MODELS[key]
        model = P.random_model(key, dev, torch.bfloat16)
        dense = P.random_dense(key, dev)
        spec = specs[0]
        gen = torch.Generator(device=dev).manual_seed(0)
        ids = torch.randint(3, pub.cfg.vocab_size, (max(ENC_BUCKETS), ENC_SEQ),
                            generator=gen, device=dev)
        mask = torch.ones_like(ids)

        def forward(b, model=model, ids=ids, mask=mask, dense=dense,
                    spec=spec):
            with torch.inference_mode():
                outs = model(ids[:b], mask[:b])
                emb = pool(outs, mask[:b], "mean" if pub.family == "t5"
                           else spec.pooling)
                if dense is not None:
                    emb = emb @ dense[0] + dense[1]
                return emb.cpu()

        for b in ENC_BUCKETS:
            one = EC.event_ms(lambda: forward(b))
            serial = EC.event_ms(lambda: [forward(1) for _ in range(b)])
            dv = EC.device_ms(lambda: forward(b))
            bd = EC.forward_bound(key, model, b, ENC_SEQ)
            row = {"model": key, "source": pub.source, "batch": b,
                   "seq": ENC_SEQ, "ms": one, "serial_ms": serial,
                   **dv, **bd}
            out.append(row)
            print(f"[encoders] {key} B={b} x L={ENC_SEQ}: one forward "
                  f"{one:.3f} ms by events, {dv['device_ms']:.3f} ms device "
                  f"in {dv['kernels']:.0f} kernels; {b} serial size-1 "
                  f"forwards {serial:.3f} ms ({serial / one:.2f}x); bound "
                  f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                  f"({bd['bytes'] / 1e9:.3f} GB, {bd['flops'] / 1e12:.3f} "
                  f"TFLOP) ({card})", flush=True)
        del model, dense, ids, mask
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--tiers", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--turns", default=None, metavar="DIR")
    ap.add_argument("--encoders", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure: needs a CUDA card", file=sys.stderr)
        return 2
    if args.encoders:
        card = _card()
        print(f"[card] {card}; torch {torch.__version__}", flush=True)
        print(json.dumps({"card": card, "encoders": measure_encoders(card)}))
        return 0
    if args.turns:
        card = _card()
        print(f"[card] {card}; torch {torch.__version__}", flush=True)
        print(json.dumps({"card": card, "turns": served_in_turns(
            args.turns, card)}))
        return 0
    if args.kernels:
        card = _card()
        print(f"[card] {card}; torch {torch.__version__}", flush=True)
        print(json.dumps({"card": card, "kernels": kernels_in_turns(
            args.parent, card)}))
        return 0
    if args.tiers:
        card = _card()
        print(f"[card] {card}; torch {torch.__version__}", flush=True)
        print(json.dumps({"card": card, "tiers": measure_tiers(card)}))
        return 0
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
        print(f"[profile]   K1's scan {p['k1_scan_ms']:.3f} ms, of which the "
              f"smaller shards' {p['k1_scan_small_shards_ms']:.3f} ms",
              flush=True)
        for k in p["kernels"]:
            print(f"[profile]   {k['ms']:9.3f} ms {k['calls']:5d} calls  "
                  f"{k['name']}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
