#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ragroute_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. Environment: the card's name and power limit, torch and CUDA versions;
   builds the three hand-written kernels (``csrc/fused_topk.cu``,
   ``csrc/stream_topk.cu``, ``csrc/grouped_gains.cu``; one nvcc each, all
   started together, sm_90a) and prints the build times and nvcc's
   ``-Xptxas -v`` report.
2. Every kernel against its plain PyTorch version on the card: exact
   integer cases (indices and scores equal), then the serving paths'
   shapes within a stated tolerance, with CUDA-event times of the kernel,
   of the plain version and, where one PyTorch call computes the same
   function, of that call:

   * fused top-k: B=512 over one 734,003 x 768 centred bf16 dot shard,
     k=32 (1e-3 x max|score|, winner-set recall >= 0.999); the same shard
     int4-packed with per-doc and with per-group scales; the low-rank
     coarse scan (734,003 x 128 bf16, k=128);
   * streaming top-k: [512, 131,072] stored gains, k=32 (equal);
   * grouped gains: 512 queries x 512 probes over 4,096 bf16 slabs of
     768 x 256 (1e-3 x max|gain|).
3. The main paths at real size: the synthetic medrag world of 1,048,575
   docs x 768 is written to a temporary data root and served by the port's
   ``ServingSystem`` exactly as ``python -m ragroute_tpu_torch.main
   --dataset medrag --routing ragroute --disable-llm --port 0`` builds it:
   first the exact path, then ``--impl lowrank``, then ``--impl ivf``
   (bf16 each), the last over a world of the same size made with 64
   topics per source (cluster probing's serving regime; the world the
   other two serve is isotropic inside a source). In every run
   sequential and concurrent GET /query requests
   must all answer 200, with 32 docs for every query the router sends
   somewhere (and none for a query it sends nowhere, as in the reference),
   the batcher must form a batch larger than one, and the path's kernels
   must have launched between the warm-up and the last answer; then
   ``engine.search`` on 64 queries is held against ``exact_oracle`` (exact
   and low-rank: recall >= 0.99; ivf at its default nprobe C/8: recall
   >= 0.9). The hybrid engine on the ivf run's layouts must probe only
   the large shard and only at a small batch.
4. A reduced topical world (4 x 32,768 docs) on the card: ivf with
   ``nprobe == C`` gives the exact path's winner sets (f32); bf16 ivf at
   the default nprobe reaches recall >= 0.9; int4 flat >= 0.90, int4 with
   the low-rank coarse scan >= 0.95, int4 ivf at full probe >= 0.98 of
   the flat int4 scan's winners (the gates of the JAX package's tests);
   a low-rank index of rank 20, off the kernel's 16-column grid, is served
   through the kernel (recall reported).

``python3 chip_smoke.py kernels`` stops after phase 2: a short first run
after a kernel change.

The second-to-last line is one JSON object with every kernel's launches on
the main paths, its error against the plain version, its times and its
bound; the last line is ``{"ok": true, "device": {...}}``. Without CUDA the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import gc
import json
import logging
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ragroute_tpu_torch.ops import _build
from ragroute_tpu_torch.ops import kernel_checks as kc
from ragroute_tpu_torch.ops.fused_topk import fused_topk
from ragroute_tpu_torch.ops.grouped_gains import grouped_gains
from ragroute_tpu_torch.ops.stream_topk import stream_topk
from ragroute_tpu_torch.utils.precision import resolve_device

# name -> (wrapper that counts launches, source, TPU kernel it replaces)
KERNELS = {
    "fused_topk": (fused_topk, "ragroute_tpu_torch/csrc/fused_topk.cu",
                   "ragroute_tpu/ops/pallas_topk.py:521"),
    "stream_topk": (stream_topk, "ragroute_tpu_torch/csrc/stream_topk.cu",
                    "ragroute_tpu/ops/pallas_topk.py:458"),
    "grouped_gains": (grouped_gains,
                      "ragroute_tpu_torch/csrc/grouped_gains.cu",
                      "ragroute_tpu/ops/ivf_topk.py:101"),
}
# the kernels each served path must launch
PATH_KERNELS = {"exact": ("fused_topk",),
                "ivf": ("stream_topk", "grouped_gains"),
                "lowrank": ("fused_topk",)}

# the medrag world at the benchmark's size (bench.py, BENCH_r05.json)
MEDRAG_DOCS = {"pubmed": 734_003, "statpearls": 104_857,
               "textbooks": 83_886, "wikipedia": 125_829}
NUM_QUERIES = 512
BURST = 128          # concurrent GET /query after 16 sequential ones
N_CHECK = 64         # queries of engine.search held against exact_oracle
IVF_TOPICS = 64      # topics per source of the world --impl ivf serves
REDUCED_DOCS = 32_768    # docs per source of phase 4's world


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: k[0].launches for name, k in KERNELS.items()}


def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    for tool in ("nvcc", "g++", "ninja"):
        log(f"{tool}: {shutil.which(tool)}")
    try:
        import aiohttp
        log(f"aiohttp {aiohttp.__version__}")
    except ImportError:
        log("aiohttp: absent")
    t0 = time.perf_counter()
    infos = _build.build_all(list(KERNELS))
    log(f"[build] {len(infos)} kernels built together in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, info in infos.items():
        log(f"[build] {name}: nvcc {info.seconds:.2f} s -> {info.path}")
        for line in info.ptxas.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                log(f"[ptxas] {name}: {line.strip()}")
    return smi


# ---- phase 2: kernels against their plain versions ---------------------------

def _check_fused_path(case, label: str, reps: int = 10) -> dict:
    kernel, plain = kc.run_pair(case)
    res = kc.compare_tolerant(kernel, plain)
    log(f"[kernel] fused_topk {label}: recall {res['recall']:.6f} "
        f"max_abs_err {res['max_abs_err']:.3e} tol {res['tol']:.3e} "
        f"non-tie mismatches {res['non_tie_mismatches']}")
    if not res["ok"] or res["recall"] < 0.999:
        raise AssertionError(f"fused_topk disagrees with its plain version "
                             f"on {label}: {res}")
    del kernel, plain
    ms = kc.cuda_time_ms(lambda: kc.run_kernel(case), reps=reps)
    plain_ms = kc.cuda_time_ms(lambda: kc.run_plain(case), warmup=1,
                               reps=max(3, reps // 2))
    bound = kc.k1_bound(case)
    log(f"[kernel] fused_topk {label}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']})")
    torch.cuda.empty_cache()
    return {"max_abs_err": res["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None}


def phase_fused(dev) -> dict:
    names = []
    for case in kc.exact_cases(dev):
        (ks, ki), (ps, pi) = kc.run_pair(case)
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
            raise AssertionError(f"kernel != plain on exact case {case.name}")
        names.append(case.name)
    log(f"[kernel] fused_topk {len(names)} exact cases (f32 / bf16 / int8 / "
        f"int4 per-doc and per-group, k 10..160): indices and scores equal")
    res = _check_fused_path(kc.path_case(dev),
                            "path shape B=512 N=734003 d=768 bf16 dot k=32")
    modes = {}
    modes["int4_per_doc"] = _check_fused_path(
        kc.int4_path_case(dev, grouped=False),
        "B=512 N=734003 d=768 int4 per-doc scale k=32", reps=5)
    modes["int4_per_group"] = _check_fused_path(
        kc.int4_path_case(dev, grouped=True),
        "B=512 N=734003 d=768 int4 per-group scale (6 groups) k=32", reps=5)
    coarse = kc.path_case(dev, d=128, k=128, seed=4)
    modes["coarse_k128"] = _check_fused_path(
        coarse, "low-rank coarse scan B=512 N=734003 r=128 bf16 k=128",
        reps=5)
    res["modes"] = modes
    return res


def phase_stream(dev) -> dict:
    n = 0
    for name, gains, k in kc.stream_exact_cases(dev):
        kg, ki = stream_topk(gains, k)
        pg, pi = kc.stream_topk_reference(gains, k)
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi) and torch.equal(kg, pg)):
            raise AssertionError(f"stream_topk != plain on exact case {name}")
        n += 1
    log(f"[kernel] stream_topk {n} exact cases (ties across groups, splits "
        f"and k; -inf entries and rows; k 1..160): positions and gains equal")
    gains = kc.stream_path_case(dev)
    k = 32
    kg, ki = stream_topk(gains, k)
    pg, pi = kc.stream_topk_reference(gains, k)
    torch.cuda.synchronize()
    err = float((kg - pg).abs().max())
    if not torch.equal(ki, pi) or err != 0.0:
        raise AssertionError(f"stream_topk disagrees with its plain version "
                             f"on the path shape (max err {err})")
    del kg, ki, pg, pi
    ms = kc.cuda_time_ms(lambda: stream_topk(gains, k))
    plain_ms = kc.cuda_time_ms(lambda: kc.stream_topk_reference(gains, k),
                               warmup=1, reps=5)
    # torch.topk computes the same lists but promises no order among ties
    library_ms = kc.cuda_time_ms(lambda: torch.topk(gains, k, dim=1))
    bound = kc.k2_bound(gains, k)
    log(f"[kernel] stream_topk path shape B=512 M=131072 k=32 (20% -inf): "
        f"equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.topk "
        f"{library_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']})")
    del gains
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": library_ms}


def phase_grouped(dev) -> dict:
    n = 0
    for case in kc.grouped_exact_cases(dev):
        out = kc.run_grouped_kernel(case)
        real = case.real_rows
        plain = kc.run_grouped_plain(case, real // kc.GROUP_ROWS)
        torch.cuda.synchronize()
        if not torch.equal(out[:real], plain):
            raise AssertionError(
                f"grouped_gains != plain on exact case {case.name}")
        n += 1
    log(f"[kernel] grouped_gains {n} exact cases (f32 / bf16 / int8 / int4 "
        f"slabs, S=72, row table, real-block count): gains equal")
    case = kc.grouped_path_case(dev)
    real = case.real_rows
    blocks = real // kc.GROUP_ROWS
    out = kc.run_grouped_kernel(case)
    plain = kc.run_grouped_plain(case, blocks)
    torch.cuda.synchronize()
    res = kc.compare_grouped(out[:real], plain)
    log(f"[kernel] grouped_gains path shape B=512 P=512 C=4096 d=768 S=256 "
        f"bf16: {blocks} real blocks of {case.blk_cluster.shape[0]}, "
        f"max_abs_err {res['max_abs_err']:.3e} tol {res['tol']:.3e} "
        f"-inf places equal {res['same_inf']}")
    if not res["ok"]:
        raise AssertionError(f"grouped_gains disagrees with its plain "
                             f"version on the path shape: {res}")
    del out, plain
    torch.cuda.empty_cache()
    ms = kc.cuda_time_ms(lambda: kc.run_grouped_kernel(case))
    plain_ms = kc.cuda_time_ms(lambda: kc.run_grouped_plain(case, blocks),
                               warmup=1, reps=3)
    bound = kc.k3_bound(case)
    # no single PyTorch call computes this; for a note, torch.bmm over the
    # gathered bf16 slabs of 512 blocks at a time (bf16 output, no epilogue)
    cl = case.blk_cluster[:blocks].long()
    qb = case.q[case.rows[:real].long()].reshape(blocks, kc.GROUP_ROWS, -1)

    def bmm_note():
        for g0 in range(0, blocks, 512):
            torch.bmm(qb[g0:g0 + 512], case.docs[cl[g0:g0 + 512]])

    bmm_ms = kc.cuda_time_ms(bmm_note, warmup=1, reps=3)
    log(f"[kernel] grouped_gains path shape: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']}; {bound['bytes'] / 1e6:.1f} MB, "
        f"{bound['flops'] / 1e12:.4f} TFLOP); note: torch.bmm over gathered "
        f"bf16 slabs {bmm_ms:.3f} ms")
    del case, qb, cl
    torch.cuda.empty_cache()
    return {"max_abs_err": res["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None,
            "bmm_note_ms": bmm_ms}


def phase_kernels(dev) -> dict:
    return {"fused_topk": phase_fused(dev), "stream_topk": phase_stream(dev),
            "grouped_gains": phase_grouped(dev)}


# ---- phase 3: the served paths at real size -----------------------------------

async def _get_query(session, port: int, qid: str, question: str):
    import aiohttp

    params = {"q": question, "choices": json.dumps({"A": "a", "B": "b"}),
              "qid": qid}
    async with session.get(f"http://127.0.0.1:{port}/query",
                           params=params,
                           timeout=aiohttp.ClientTimeout(total=600)) as r:
        return r.status, (await r.json() if r.status == 200
                          else await r.text())


async def _drive(system, syn, k: int, label: str) -> dict:
    """Sequential then concurrent GET /query through the running server."""
    import aiohttp

    await system.start()   # builds the engine and warms every bucket
    server = system.server
    try:
        reset_counts()               # count the main path's launches only
        port = server.bound_port
        qs = syn.questions
        async with aiohttp.ClientSession() as s:
            t0 = time.perf_counter()
            answers = [await _get_query(s, port, qs[i]["qid"],
                                        qs[i]["question"])
                       for i in range(16)]
            seq_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            answers += await asyncio.gather(*[
                _get_query(s, port, qs[i % len(qs)]["qid"],
                           qs[i % len(qs)]["question"])
                for i in range(BURST)])
            burst_s = time.perf_counter() - t0
            async with s.get(f"http://127.0.0.1:{port}/stats") as r:
                stats = await r.json()
        launches = read_counts()
    finally:
        await system.stop()
    # a query the router sends to no source gets no docs (the reference's
    # semantics); every routed query must get exactly k
    full = unrouted = 0
    bad = []
    for st, b in answers:
        if st != 200:
            bad.append((st, b))
            continue
        n_docs = len(b["metadata"]["top_docs"])
        if b["metadata"]["data_sources"] and n_docs == k:
            full += 1
        elif not b["metadata"]["data_sources"] and n_docs == 0:
            unrouted += 1
        else:
            bad.append((st, n_docs))
    log(f"[serve:{label}] {len(answers)} GET /query answered 200: {full} "
        f"routed with {k} docs, {unrouted} routed to no source with 0 docs; "
        f"16 sequential in {seq_s:.3f} s, {BURST} concurrent in "
        f"{burst_s:.3f} s")
    if not full:
        raise AssertionError("no /query answer carried docs")
    log(f"[serve:{label}] /stats batch_size {stats['batch_size']} "
        f"device_step_ms {stats['device_step_ms']} device_memory "
        f"{stats['device_memory']}")
    if bad:
        raise AssertionError(f"bad /query answers: {bad[:5]}")
    if stats["batch_size"]["max"] <= 1:
        raise AssertionError("the batcher never formed a batch larger than 1")
    return launches


def _hybrid_check(engine, syn) -> None:
    """The hybrid engine on the ivf run's layouts: a batch of 8 probes the
    one shard above ``IVF_HYBRID_MIN_DOCS`` and scans the others exactly;
    a batch of 64 scans everything exactly."""
    from ragroute_tpu_torch.engine import FederatedSearchEngine

    hybrid = FederatedSearchEngine(engine.shard_set, engine.router,
                                   engine.bank, impl="hybrid")
    seen = {}
    for bsz in (8, 64):
        reset_counts()
        q = {enc: e[:bsz] for enc, e in syn.query_embs.items()}
        out = hybrid.search(q, strategy="all")
        seen[bsz] = read_counts()
        if not (out.merged_valid == syn.world.k).all():
            raise AssertionError(f"hybrid B={bsz}: short result lists")
    log(f"[hybrid] launches at B=8 {seen[8]}, at B=64 {seen[64]}")
    if not (seen[8]["grouped_gains"] == 1 and seen[8]["stream_topk"] == 1
            and seen[8]["fused_topk"] >= 3
            and seen[64]["grouped_gains"] == 0
            and seen[64]["fused_topk"] >= 4):
        raise AssertionError(f"hybrid chose the wrong scorers: {seen}")


def serve_path(root: str, dev, syn, label: str, flags, recall_gate: float
               ) -> dict:
    """Build one ServingSystem from the CLI's flags, drive it over HTTP and
    hold ``engine.search`` against the exact f32 oracle."""
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.oracle import engine_recall, exact_oracle
    from ragroute_tpu_torch.system import ServingSystem

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system = ServingSystem(parse_args([
        "--dataset", "medrag", "--routing", "ragroute", "--disable-llm",
        "--port", "0", "--data-root", root, "--device", str(dev), *flags]))
    system.build()
    engine = system.server.engine
    ss = engine.shard_set
    log(f"[world:{label}] loaded onto {dev} in "
        f"{time.perf_counter() - t0:.1f} s: {ss.index_bytes / 1e9:.3f} GB "
        f"flat index ({ss.shards[0].docs.dtype}) + {ss.aux_bytes / 1e9:.3f} "
        f"GB extra layouts")
    for s in ss.shards:
        if s.ivf is not None:
            log(f"[world:{label}] {s.name}: C={s.ivf.n_clusters} "
                f"S={s.ivf.capacity}")
        if s.lr is not None:
            log(f"[world:{label}] {s.name}: rank {s.lr.rank} energy "
                f"{s.lr.energy:.4f}")
    launches = asyncio.run(_drive(system, syn, syn.world.k, label))
    log(f"[serve:{label}] kernel launches on the served path: {launches}")
    for name in PATH_KERNELS[label]:
        if launches[name] <= 0:
            raise AssertionError(
                f"the {label} path never launched the {name} kernel")

    q = {enc: e[:N_CHECK] for enc, e in syn.query_embs.items()}
    out = engine.search(q, strategy="ragroute")
    oracle = exact_oracle(syn.world, syn.embeddings, q, syn.world.k,
                          mask=out.mask)
    recall = engine_recall(syn.world, out, oracle)
    routed = out.mask.sum(axis=0).tolist()
    log(f"[oracle:{label}] engine.search on {N_CHECK} queries: routed per "
        f"source {routed}, recall@{syn.world.k} vs exact_oracle "
        f"{recall:.6f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    valid = out.merged_shard >= 0
    n_docs = np.array([s.n_docs for s in ss.shards])
    if (out.merged_local[valid] < 0).any() or (
            out.merged_local[valid] >= n_docs[out.merged_shard[valid]]).any():
        raise AssertionError(f"{label}: doc ids out of range")
    if recall < recall_gate:
        raise AssertionError(
            f"{label}: recall {recall} < {recall_gate} vs exact_oracle")
    if label == "ivf":
        _hybrid_check(engine, syn)
    del system, engine, ss, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "recall": recall}


def phase_main_paths(dev) -> dict:
    """Serve the synthetic medrag world through the port's ServingSystem:
    exact, then low-rank, then cluster-probed over the topical world."""
    from ragroute_tpu_torch.index.synthetic import (make_synthetic_world,
                                                    save_world)

    n_docs = sum(MEDRAG_DOCS.values())
    out = {}
    for topics, runs in ((1, (("exact", []),
                              ("lowrank", ["--impl", "lowrank"]))),
                         (IVF_TOPICS, (("ivf", ["--impl", "ivf"]),))):
        root = tempfile.mkdtemp(prefix="ragroute_smoke_")
        try:
            t0 = time.perf_counter()
            syn = make_synthetic_world(
                "medrag", docs_per_source_map=MEDRAG_DOCS,
                num_queries=NUM_QUERIES, seed=0, subclusters=topics)
            save_world(syn, root)
            log(f"[world] medrag {n_docs} docs x 768, {topics} topic(s) per "
                f"source, {NUM_QUERIES} queries made and saved in "
                f"{time.perf_counter() - t0:.1f} s")
            for label, flags in runs:
                out[label] = serve_path(
                    root, dev, syn, label, flags,
                    recall_gate=0.9 if label == "ivf" else 0.99)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        del syn
        gc.collect()
    return out


# ---- phase 4: a reduced topical world -------------------------------------------

def _winner_sets(out):
    return [{(int(s), int(l)) for s, l in zip(out.merged_shard[r],
                                              out.merged_local[r]) if s >= 0}
            for r in range(out.merged_shard.shape[0])]


def phase_reduced(dev) -> None:
    from ragroute_tpu_torch.engine import FederatedSearchEngine
    from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
    from ragroute_tpu_torch.oracle import engine_recall, exact_oracle
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    syn = make_synthetic_world("medrag", docs_per_source=REDUCED_DOCS,
                               num_queries=N_CHECK, seed=5,
                               with_payloads=False, subclusters=64)
    q = dict(syn.query_embs)
    oracle = exact_oracle(syn.world, syn.embeddings, q, syn.world.k)
    router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev)
    bank = RouterBank.create(syn.world, syn.centroids, device=dev)

    def engine(dtype, impl="auto", **kw):
        build = {key: kw.pop(key) for key in ("ivf_clusters", "lowrank")
                 if key in kw}
        ss = ShardSet.build(syn.world, syn.embeddings, dtype=dtype,
                            device=dev, **build)
        return FederatedSearchEngine(ss, router, bank, impl=impl, **kw)

    def search(eng):
        return eng.search(q, strategy="all")

    # full probe equals the exact path (f32; a swap is allowed only between
    # scores that agree to 1e-5 relative: the two kernels sum in different
    # orders)
    eng = engine(torch.float32, "ivf", ivf_clusters=128, nprobe=128)
    full = search(eng)
    exact = search(FederatedSearchEngine(eng.shard_set, router, bank))
    swaps = 0
    for r, (a, b) in enumerate(zip(_winner_sets(full), _winner_sets(exact))):
        if a != b:
            kth = float(exact.merged_score[r, -1])
            both = np.concatenate([full.merged_score[r],
                                   exact.merged_score[r]])
            if len(a ^ b) > 2 or not np.isclose(both.min(), kth, rtol=1e-5):
                raise AssertionError(
                    f"ivf with nprobe == C differs from the exact path on "
                    f"query {r}: {sorted(a ^ b)}")
            swaps += 1
    log(f"[reduced] f32 ivf nprobe == C == 128 over 4 x {REDUCED_DOCS} "
        f"docs: winner sets equal the exact path's on {N_CHECK - swaps} of "
        f"{N_CHECK} queries, {swaps} differ by one near-tie at the k "
        f"boundary")

    def gate(label, out, floor, ref=None):
        r = engine_recall(syn.world, out, ref or oracle)
        log(f"[reduced] {label}: recall@{syn.world.k} {r:.6f} "
            f"({'reported' if floor is None else f'gate {floor}'})")
        if floor is not None and r < floor:
            raise AssertionError(f"{label}: recall {r} < {floor}")

    gate("bf16 ivf, default nprobe C/8, topical world",
         search(engine(torch.bfloat16, "ivf", ivf_clusters=-1)), 0.9)
    reset_counts()
    gate("int4 flat scan (per-group scales)", search(engine("int4")), 0.90)
    if fused_topk.launches < 4:
        raise AssertionError("the int4 flat scan did not run the kernel")
    gate("int4 + low-rank coarse scan",
         search(engine("int4", "lowrank", lowrank=-1)), 0.95)
    reset_counts()
    gate("bf16 low-rank coarse scan at rank 20 (stored as 32 columns)",
         search(engine(torch.bfloat16, "lowrank", lowrank=20)), None)
    if fused_topk.launches < 4:
        raise AssertionError("the rank-20 coarse scan did not run the kernel")
    eng = engine("int4", "ivf", ivf_clusters=128, nprobe=128)
    flat4 = search(FederatedSearchEngine(eng.shard_set, router, bank))
    gate("int4 ivf nprobe == C against the flat int4 scan (per-doc scales)",
         search(eng), 0.98, ref=_winner_sets(flat4))
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    only = sys.argv[1] if len(sys.argv) > 1 else "all"
    logging.basicConfig(level=logging.WARNING, stream=sys.stdout)
    for name in ("ivf", "lowrank", "shard"):
        logging.getLogger(name).setLevel(logging.INFO)
    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    smi = phase_environment()
    kres = phase_kernels(dev)
    log(f"[time] kernels checked at {time.perf_counter() - t_start:.0f} s")
    if only == "kernels":      # a short first run after a kernel change
        return 0
    phase_reduced(dev)
    log(f"[time] reduced world done at {time.perf_counter() - t_start:.0f} s")
    paths = phase_main_paths(dev)
    log(f"[time] served paths done at {time.perf_counter() - t_start:.0f} s")
    log(smi)
    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        by_path = {p: r["launches"][name] for p, r in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path[p] for p, ks in PATH_KERNELS.items()
                            if name in ks),
            "launches_by_path": by_path, **kres[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
