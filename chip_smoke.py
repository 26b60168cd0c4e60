#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ragroute_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. Environment: the card's name and power limit, torch and CUDA versions,
   the host's cores and RAM and its page-locked host->device copy rate;
   builds the six hand-written kernels (``csrc/fused_topk.cu``,
   ``csrc/stream_topk.cu``, ``csrc/grouped_gains.cu``,
   ``csrc/grouped_pair_topk.cu``, ``csrc/int4_matmul.cu``,
   ``csrc/decode_attention.cu``; one nvcc each, all started together,
   sm_90a) and prints the build times and nvcc's ``-Xptxas -v`` report.
2. Every kernel against its plain PyTorch version on the card: exact
   integer cases (indices and scores equal), then the serving paths'
   shapes within a stated tolerance, with CUDA-event times of the kernel,
   of the plain version and, where one PyTorch call computes the same
   function, of that call:

   * fused top-k: exact cases of the shallow launch (k 10 to 160), of
     the wgmma scan over bf16 docs and over int8 and int4 docs (no,
     per-doc and per-group scales), of the deep launch (k 161 to 1,100,
     chunks and row slices; through the plan and named) and of the scan's
     deep fold (k 65 to 1,024, bf16 / int8 / int4, buffers cut many
     times); B=512 over one 734,003 x 768 centred bf16 dot
     shard, k=32 (1e-3 x max|score|, winner-set recall >= 0.999); the same
     shard int4-packed with per-doc and with per-group scales, in int8 and
     in f32 (the f32 scan: its exact cases at k 1 to 64 through the plan
     and by name first; cuBLAS's SGEMM of the product as a note); the
     low-rank coarse scan (734,003 x 128 bf16) at k'=128 and
     k'=256 (--refine-mult 8), through the deep fold with the deep launch's
     time beside it; the host tiers'
     launches: one int8 slab of the stream tier (346,112 x 768, per-doc
     scale, k=32) and hostrefine's flat coarse scan (734,208 x 128 int8,
     per-doc scale, -inf bias on the padding rows) at k'=128 and 256
     (the deep fold, with the deep launch's time beside it); over live
     shards (a capacity on the 512-row grid scanned whole, -inf bias holes
     anywhere in it, 40 live rows under k) exact cases of every launch, the
     wgmma scan, the f32 scan, the first design, the deep fold and the deep
     launch, each by name and through the plan, and the live pubmed
     shard's shape (738,304 rows, a free tail and scattered holes); each
     int8 / int4 row with the first design's time at the same shape beside
     it, the deep rows with the profiler's device time and a bound that
     counts the gains' round trip through device memory;
   * streaming top-k: exact cases over both of its paths (the radix select
     a block, the warp-streaming path, runs merged across splits) and the
     deep launch (k 161 to M, one run and runs merged, rows in slices),
     then [512, 131,072] stored gains, k=32, and the probed coarse scan's
     collect, [512, 4,096] with -inf entries, k'=128 and 256, random and as
     sorted runs of 8 with ties (equal; CUDA-event and profiler device
     times);
   * grouped gains: exact cases (f32 / bf16 / int8 / int4 slabs, S 8 to
     328, d 64 to 192, the row table, a real-block count under the grid's)
     through the plan and through the wgmma kernel, the f32 kernel and the
     first design by name, then 512 queries x 512 probes over 4,096 slabs
     of 768 x 256 in bf16, int8 and int4 (1e-3 x max|gain|), each with the
     profiler's device time, its bound's share and the first design's times
     beside it;
   * grouped pair top-k: exact cases (ranks 1 to 64 and the deep launch's
     200 and 256) through the plan and again through the wgmma kernel and
     the first design where each takes them, then 256 ranks a tile at the
     reduced world's probed scan
     under an open cap (64 queries x 64 clusters of 568 slots, kappa 256),
     then 512 queries x 512 probes over 4,096 int8 coarse slabs of 128 x
     1,584, kappa 8 (gains 1e-4 relative, slots equal where the gains are
     clearly ordered, up to a millionth of near-ties at a tile's rank cut;
     every slot that differs from the plain version's must carry,
     recomputed, the gain written for it), with the first design's time
     at the same shape beside the wgmma kernel's;
   * int4 matmul (the decoder's K5): exact integer cases (outputs equal;
     the decode kernel at M = 1, 16, 40 and 63 with splits summed in the
     launch), then Qwen3-8B's projections and untied head at decode
     (B=16, the decode kernel), its gate and down at prefill (16 x 512
     rows, the prefill kernel) and Qwen3-0.6B's tied head, bf16
     activations (1e-4 x max|y|), with the device time from the profiler
     beside the CUDA-event time, the first kernel's times at the same
     shape beside them and dequant-to-bf16 + ``torch.matmul`` as a note;
   * decode attention (K6, wired to no engine): small f32 / bf16 / int8
     cases (1e-5, a row with one valid key and a row with none, S under a
     tile, G 1 to 8, Dh 20 to 256, many splits), then the
     Qwen3-8B decode shape (B=16, S=2,080, 36 layers) with a bf16 and an
     int8 cache and the JAX package's measured shape, each against the
     plain version and the engines' ``_attend``, with SDPA (GQA) as the
     library time for the bf16 cache.
3. The main paths at real size: the synthetic medrag world of 1,048,575
   docs x 768 is written to a temporary data root and served by the port's
   ``ServingSystem`` exactly as ``python -m ragroute_tpu_torch.main
   --dataset medrag --routing ragroute --disable-llm --port 0`` builds it:
   first the exact path, then the exact path at ``--dtype float32`` (3.22
   GB on the card; recall >= 0.999: f32 docs are the oracle's own
   arithmetic), then ``--impl lowrank`` and on its engine the depth
   ``--refine-mult 8`` sets (k' = 256 through ``engine.search`` on 512 and
   64 queries: the fused kernel's deep fold; recall at least the default
   depth's), then ``--impl ivf``
   (bf16 each but the f32 run), the last over a world of the same size made with 64
   topics per source (cluster probing's serving regime; the world the
   other two serve is isotropic inside a source). In every run
   sequential and concurrent GET /query requests
   must all answer 200, with 32 docs for every query the router sends
   somewhere (and none for a query it sends nowhere, as in the reference),
   the batcher must form a batch larger than one, and the path's kernels
   must have launched between the warm-up and the last answer (the exact
   path through K1's wgmma scan, the f32 one through its f32 scan, ivf
   through K3's wgmma kernel); then
   ``engine.search`` on 64 queries is held against ``exact_oracle`` (exact
   and low-rank: recall >= 0.99; ivf at its default nprobe C/8: recall
   >= 0.9). The hybrid engine on the ivf run's layouts must probe only
   the large shard and only at a small batch.
   Then the rest of the serving surface over the same world: the exact
   path's run times a burst of 1,024 GET /query over 64 connections from a
   client process of its own through aiohttp; ``--workers 2`` (two
   SO_REUSEPORT processes on one resolved port, each with its own copy of
   the index on the card) takes the same burst, every answer 200 and both
   workers' ``/stats`` counting queries; then the live index as ``--frontend
   native --mutable --reserve-docs 4096`` builds it, its native loop in a
   thread: the same burst (batches larger than one, K1's wgmma scan
   launched), three 2 s ``/admin/profile`` captures during a burst, each
   trace naming K1's kernel, ``/docs/delete`` of 1,024 build-time docs
   that the bursts served (round after round of winners), ``/docs/add`` of
   1,024 rows into pubmed (64 twins of the check queries among them) and
   256 into each small source (into the freed slots first),
   ``/docs/delete`` of half of them, ``engine.search`` on 64 queries
   against ``exact_oracle`` over the live rows (recall >= 0.99, no deleted
   doc or free slot served, every added doc the oracle ranks served) and
   the same queries over HTTP (no
   deleted doc's payload shown, though its slot now holds another), K1's
   four shard scans of a B=512 step over the live shards against the same
   rows scanned as immutable shards, ``/admin/snapshot``, and a fresh
   immutable aiohttp system loaded from it gives the live winner sets
   (near-ties of the other centre's bf16 rounding excepted).
4. A reduced topical world (4 x 32,768 docs) on the card: ivf with
   ``nprobe == C`` gives the exact path's winner sets (f32, through K3's
   f32 kernel); bf16 ivf at
   the default nprobe reaches recall >= 0.9; int4 flat >= 0.90, int4 with
   the low-rank coarse scan >= 0.95, int4 ivf at full probe >= 0.98 of
   the flat int4 scan's winners (the gates of the JAX package's tests);
   a low-rank index of rank 20, off the kernel's 16-column grid, is served
   through the kernel (recall reported). Then live rewrites on a world of
   that size: int8 rows (per-doc scales) and packed int4 rows (per-group
   scales) added (twins of the check queries among them) and deleted
   through the Python API, held against ``exact_oracle`` over the live rows
   at the JAX package's gates (0.95 int8, 0.90 int4).

5. The host-RAM capacity tiers. On a reduced topical int8 world (4 x
   32,768 docs): ``tier="stream"`` with three slabs a source returns the flat
   int8 engine's merged ids, built from arrays and loaded from a saved
   world's ``embeddings.npy`` alike; hostrefine's flat coarse scan reaches recall
   >= 0.95 of the flat engine; the probed coarse scan at ``nprobe == C``,
   ``kappa >= k' = 256`` (256 ranks a tile: the deep launches of the
   grouped pair top-k and of the collect) truly misses nothing of the flat
   coarse scan. Then at
   size: the synthetic medrag world at the earlier size
   (1,048,575 docs x 768, 64 topics per source, int8; an eighth of what
   ``measure.py --tiers`` serves), its rows made block by block from the
   seed and never held whole, under ``--hbm-budget-gb 0.375``, which keeps
   the three small sources resident and exact and sends pubmed (734,003
   docs) to the host tier. Served over HTTP three times
   as ``python -m ragroute_tpu_torch.main --impl stream | hostrefine``
   builds it (``--impl hostrefine`` with the flat coarse slab and with the
   clustered one, reached through
   ``RAGROUTE_HOSTREFINE_CLUSTER_MIN_DOCS``; each hostrefine engine then
   also at the depth ``--refine-mult 8`` sets, through ``engine.search``,
   whose recall must reach the default depth's and whose K1 must take its
   deep fold and K2 its deep launch): every
   ``/query`` answers
   200, the path's kernels launch (the grouped pair top-k only on the
   probed path, through its wgmma kernel; the stream tier's slabs through
   K1's wgmma scan), ``last_phases`` is printed, and ``engine.search`` on 64
   queries is held against the exact f32 oracle over the generated rows
   (stream >= 0.95, the int8 gate, and >= 0.995 of the exact winners of its
   own stored bytes, beside the recall of a plain f32 scan of those bytes
   against the oracle, which is the quantisation's loss; hostrefine flat
   >= 0.95, probed >= 0.9). At the default depth a burst of
   1,024 concurrent requests goes through the batcher's pipelined worker
   (two batches in flight) and again through its sequential worker, with
   both wall times.
6. Generation on the card, over a small medrag world (4 x 8,192 docs):
   ``ServingSystem`` built as ``--llm-backend jax`` without a checkpoint
   builds it (the demo decoder) answers 4 concurrent ``/query`` with
   generation on; then Qwen3-8B at full width with random weights (bf16
   masters drawn on the card, quantized to int4 there, the masters freed)
   and an int8 KV cache, handed to the system with the byte tokenizer (the
   card's machine has no ``transformers`` and no weights), serves 16
   concurrent ``/query`` through ``--llm-serving batch`` and again through
   ``--llm-serving continuous --llm-prefix-cache --llm-spec-window 4``
   (``--llm-max-new 32``): every answer 200, K5 launched, tokens a second
   printed; 4 concurrent ``stream=1`` requests through aiohttp on the
   lockstep Qwen3-8B system, and 4 through the native front end on the
   demo decoder, each ending in ``[DONE]`` with its deltas a prefix of the
   answer. One decode step at B=16 over a 2,080-position cache is timed
   (every K5 call in it one kernel on the device, by the profiler)
   and profiled against its bound, and so is one prefill of the lockstep
   batch (16 prompts of 2,048 tokens). The 36-layer bf16 prefill logits through
   K5 stay within 0.05 x max|logit| of the plain version's, and two layers
   of Qwen3-8B at f32 give the plain path's greedy tokens for 16 steps
   (near-ties of the plain path's top two logits counted).

7. The live query encoders (``--embedder zoo``): (a) every registry encoder
   at its published width (BERT-base, BERT-large, XLM-R large, MPNet base,
   the T5 encoder with its 2_Dense, GPT-J for SGPT-5.8B; each model built
   once with seeded bf16 weights on the card, SGPT last, each freed before
   the next) over a fixed batch of query texts (the port's WordPiece and BPE
   tokenizers over vocabularies made in code; its SentencePiece unigram
   tokenizer for XLM-R and T5, over a ``tokenizer.json`` of the model's
   vocabulary size the run writes) at buckets 1, 8 and 32: ``[B, dim]``, finite, unit norm where the
   spec normalizes, cosine >= 0.99 against an f32 forward of the same
   weights, >= 0.999 between a text alone and inside the bucket of 32, with
   each forward's CUDA-event and device time beside its bound; (b) inside
   phase 3, over its medrag world (``encoders`` alone: a world made there),
   a MedCPT checkpoint at BERT-base width written into a temporary hub cache
   as ``model.safetensors``, served by ``--embedder zoo`` through aiohttp
   and ``--frontend native``: the encoder on the card, a burst of 1,024 text
   GET /query over 64 connections with qids the table lacks, the aiohttp
   EmbeddingBatcher's mean batch > 1, K1 launched, recall@32 >= 0.99 of 256
   served answers against the exact oracle over ``embed_many``'s
   embeddings; the same weights as ``pytorch_model.bin`` load to the same
   embeddings; (c) the feb4rag world at 262,144 docs (f32 rows) served
   through ``FederationServer`` with its eight encoders (SGPT-5.8B among
   them): 256 text queries at once, recall@10 >= 0.99 under feb4rag's merge,
   requests/s and encoding's share (the same queries over bf16 rows as a
   note).

8. The offline path: a synthetic medrag world of 4 x 32,768 docs x 768
   (64 topics a source) with MIRAGE's 7,663 questions (30,652 router
   examples at width 1,540) written by ``scripts.make_synthetic_data``;
   ``scripts.train_router`` on the card for 50 epochs (a third of the
   reference's 150) at batch 256 (seconds an epoch, steps a second;
   parameters and optimiser state on the card, best validation accuracy
   over the base rate by 0.1,
   AUC > 0.85, threshold in (0, 1)); the world served with the new
   ``router.npz`` as ``python -m ragroute_tpu_torch.main --routing
   ragroute --disable-llm`` builds it, 256 ``/query`` at once, each
   answer's ``data_sources`` equal to a CPU forward of the same router
   (pairs within 1e-4 of the threshold skipped and counted), recall@32
   >= 0.99 against the exact oracle under each answer's routing;
   ``OfflinePipeline.from_data_root`` on the card gives the served
   ``data_sources`` and ``top_docs`` for 64 of those qids;
   ``scripts.eval_recall`` at f32 (recall 1.0) and bf16 (>= 0.99) with
   ``all / ragroute / random``, and with ``--impl ivf`` (printed; K2 and K3
   launched); the world and its router written in the reference's layout
   (FAISS ``IxFI`` files, metadatas, chunk files, ``best_model.pth``, a
   ``preprocessed_data.pkl`` by the port's sklearn-layout writer) and
   imported by ``scripts.import_real_data``, served with the routes of the
   ``.pth`` and scaler loaded directly; ``--encode-from-jsonl`` over 4 x
   2,048 docs through a MedCPT-Article-Encoder checkpoint at BERT-base
   width (seeded weights in a temporary hub cache; 64 rows at cosine >=
   0.99 against an f32 forward of the same weights; docs a second).

9. Meshes, the cluster and the dtype policy: (a) inside phase 3, over its
   medrag world (1,048,575 x 768 bf16), ``ShardedSearch`` over a 2x2 mesh
   of ``cuda:0`` named four times (each cell's row slice a view of the
   card's shard; K1 per cell, then the gather and merge) at B=512, k=32,
   routing ``ragroute`` and ``all``: the single-card engine's winner sets
   (near-ties within 1e-3 x max|score| allowed), K1 launched twice a scored
   (dp row, shard) by its counter and by the profiler, the step's
   host-clock time beside the single card's, and under ``all`` recall@32
   >= 0.99 against the exact oracle on 64 queries; the world under
   ``--dtype policy`` (int8 everywhere: each shard held to the exact
   winners of its stored rows at 0.99, its recall against the f32 rows
   printed beside the int8 gate); (b) over a world of 4 x 16,384 docs
   written for it, three 2 s aiohttp ``/admin/profile`` captures during a
   timed burst, each holding K1's kernel, and ``--mesh 1x1`` through
   aiohttp and the native front end: 64 answers equal the single-card
   server's (query id, timings and batch size blanked);
   (c) phase 4's reduced world (4 x 32,768) over a 1x4 mesh: IVF (K3 + K2),
   low-rank, int8 and int4 through ``ShardedSearch`` and ``--impl
   hostrefine`` through ``MeshStreamedEngine``, each against its
   single-card engine; (d) a two-process cluster on the one card
   (``--num-processes 2 --mesh 2x2``, two local devices a process, gloo;
   over (b)'s world):
   64 ``/query`` at once through the leader answer as the single-process
   server does, the follower logs its steps, SIGTERM on the leader ends
   both; (e) the feb4rag world at 262,144 docs under ``--dtype policy``:
   each shard in its pick (int4 + low-rank ``trec-covid``, bfloat16 for nine
   sources, int8 for three), served, its scan's kernel by the counters
   (``trec-covid`` the low-rank coarse scan), each shard without a coarse
   layout held to the exact winners of its stored rows (0.99) and
   ``trec-covid`` to the f32 rows at its dtype's gate (0.95), every
   shard's recall against the f32 rows printed beside its dtype's gate
   (§2 of PERF.md: at k = 10 bf16 rounding alone takes some sources below
   0.99), the picks and the index bytes printed.

``python3 chip_smoke.py kernels`` stops after phase 2: a short first run
after a kernel change. ``python3 chip_smoke.py tiers`` runs phases 1 and 5
only; ``python3 chip_smoke.py llm`` phases 1, K5 / K6 of 2, and 6;
``python3 chip_smoke.py surface`` phases 1, K1's live cases of 2, the live
rewrites of 4 and of 3 the exact path and the rest of the serving surface;
``python3 chip_smoke.py encoders`` phases 1 and 7; ``python3
chip_smoke.py offline`` phases 1 and 8; ``python3 chip_smoke.py mesh``
phases 1 and 9 (with a medrag world of its own).

The second-to-last line is one JSON object with every kernel's launches on
the main paths (and, for the three top-k kernels, the deep launches among
them; for K1 also its deep fold's), its error against the plain version,
its times and its bound; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import copy
import dataclasses
import gc
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.parse

import numpy as np
import torch

# the prompt builder asks transformers (where installed) for the served
# model's tokenizer; this run uses none and must not reach for the network
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

from ragroute_tpu_torch.measure import TIER_BUDGET_GB, TIER_DOCS
from ragroute_tpu_torch.ops import _build
from ragroute_tpu_torch.ops import decoder_checks as dc
from ragroute_tpu_torch.ops import deep_topk
from ragroute_tpu_torch.ops import kernel_checks as kc
from ragroute_tpu_torch.ops.decode_attention import decode_attention
from ragroute_tpu_torch.ops.fused_topk import fused_topk
from ragroute_tpu_torch.ops.grouped_gains import grouped_gains
from ragroute_tpu_torch.ops.grouped_topk import grouped_pair_topk
from ragroute_tpu_torch.ops.int4_matmul import M_SWITCH, int4_matmul
from ragroute_tpu_torch.ops.stream_topk import stream_topk
from ragroute_tpu_torch.utils.precision import resolve_device

# name -> (wrapper that counts launches, source, TPU kernel it replaces)
KERNELS = {
    "fused_topk": (fused_topk, "ragroute_tpu_torch/csrc/fused_topk.cu",
                   "ragroute_tpu/ops/pallas_topk.py:627"),
    "stream_topk": (stream_topk, "ragroute_tpu_torch/csrc/stream_topk.cu",
                    "ragroute_tpu/ops/pallas_topk.py:488"),
    "grouped_gains": (grouped_gains,
                      "ragroute_tpu_torch/csrc/grouped_gains.cu",
                      "ragroute_tpu/ops/ivf_topk.py:129"),
    "grouped_pair_topk": (grouped_pair_topk,
                          "ragroute_tpu_torch/csrc/grouped_pair_topk.cu",
                          "ragroute_tpu/ops/grouped_topk.py:191"),
    "int4_matmul": (int4_matmul, "ragroute_tpu_torch/csrc/int4_matmul.cu",
                    "ragroute_tpu/ops/int4_matmul.py:170"),
    "decode_attention": (decode_attention,
                         "ragroute_tpu_torch/csrc/decode_attention.cu",
                         "ragroute_tpu/ops/decode_attention.py:201"),
}
# the kernels each served path must launch
PATH_KERNELS = {"exact": ("fused_topk",),
                "exact_f32": ("fused_topk",),
                "ivf": ("stream_topk", "grouped_gains"),
                "lowrank": ("fused_topk",),
                "lowrank_deep": ("fused_topk",),
                "stream": ("fused_topk",),
                "hostrefine": ("fused_topk",),
                "hostrefine_deep": ("fused_topk",),
                "hostrefine_probed": ("fused_topk", "stream_topk",
                                      "grouped_pair_topk"),
                "hostrefine_probed_deep": ("fused_topk", "stream_topk",
                                           "grouped_pair_topk"),
                # the live index through the native front end
                "live": ("fused_topk",),
                # on-card generation, Qwen3-8B int4 (decode attention is
                # wired to no engine, as in the JAX package)
                "llm_batch": ("int4_matmul",),
                "llm_continuous": ("int4_matmul",),
                # --embedder zoo: the medrag world through both front ends
                # and the feb4rag zoo (query encoders on the card)
                "zoo_aiohttp": ("fused_topk",),
                "zoo_native": ("fused_topk",),
                "zoo_feb4rag": ("fused_topk",),
                # the offline path: serving with the trained router, the
                # offline pipeline, eval_recall (exact at f32 and bf16, and
                # ivf), the imported world served
                "offline_served": ("fused_topk",),
                "offline_pipeline": ("fused_topk",),
                "offline_eval_float32": ("fused_topk",),
                "offline_eval_bfloat16": ("fused_topk",),
                "offline_ivf": ("stream_topk", "grouped_gains"),
                "offline_imported": ("fused_topk",),
                # phase 9: the 2x2 virtual mesh over the medrag world (both
                # routings), --mesh 1x1 over HTTP, the reduced world's
                # layouts over a 1x4 mesh, --dtype policy
                "mesh_ragroute": ("fused_topk",),
                "mesh_all": ("fused_topk",),
                "mesh_aiohttp": ("fused_topk",),
                "mesh_native": ("fused_topk",),
                "mesh_ivf": ("stream_topk", "grouped_gains"),
                "mesh_lowrank": ("fused_topk",),
                "mesh_int8": ("fused_topk",),
                "mesh_int4": ("fused_topk",),
                "mesh_hostrefine": ("fused_topk",),
                "policy_medrag": ("fused_topk",),
                "policy_feb4rag": ("fused_topk",)}

# the kernels each served path must launch through their wgmma designs:
# K1's scan (bf16, int8 and int4 docs), K3's grouped GEMM and K4's pair scan
WGMMA_PATHS = {"exact": ("fused_topk",), "stream": ("fused_topk",),
               "live": ("fused_topk",),
               "ivf": ("grouped_gains",),
               "hostrefine_probed": ("grouped_pair_topk",)}
# the kernels each served path must launch through their f32 designs: K1's
# f32 scan on the exact path over f32 docs
F32_PATHS = {"exact_f32": ("fused_topk",)}

# the paths served at --refine-mult 8 (k' = 256 at medrag's k = 32), the
# kernels that must take the launch that serves that depth there, named by
# its counter (K1's deep fold, K2's deep launch), and the default-depth run
# whose recall on the same queries each must reach
REFINE_MULT = 8
DEEP_PATHS = {"lowrank_deep": ((("fused_topk", "fold"),), "lowrank"),
              "hostrefine_deep": ((("fused_topk", "fold"),), "hostrefine"),
              "hostrefine_probed_deep": ((("stream_topk", "deep"),),
                                         "hostrefine_probed")}

# the medrag world at the benchmark's size (bench.py, BENCH_r05.json)
MEDRAG_DOCS = {"pubmed": 734_003, "statpearls": 104_857,
               "textbooks": 83_886, "wikipedia": 125_829}
NUM_QUERIES = 512
# recall@32 of engine.search against exact_oracle on the served paths (the
# rest: 0.99); f32 docs are the oracle's own arithmetic, so only a swap at a
# rounding-level near-tie may differ
RECALL_GATES = {"ivf": 0.9, "exact_f32": 0.999}
BURST = 128          # concurrent GET /query after 16 sequential ones
N_CHECK = 64         # queries of engine.search held against exact_oracle
IVF_TOPICS = 64      # topics per source of the world --impl ivf serves
REDUCED_DOCS = 32_768    # docs per source of phase 4's world
# rows of one uploaded slab of the stream tier over that world (256 MB at
# 776 B an int8 row, on the 512-row grid)
TIER_SLAB_ROWS = 346_112
TIER_BURST = 1024        # concurrent requests of the pipelined burst
# the host tiers' world of this run: an eighth of each source of the world
# ``measure.py --tiers`` serves, under an eighth of its budget, which again
# keeps the three small sources resident and sends pubmed (0.57 GB of int8
# rows against the 0.13 GB the budget leaves it) to the host tier, in slabs
# of TIER_SLAB_ROWS (the depth cut that keeps the whole run, the offline
# phase included, in its time)
SMOKE_TIER_DOCS = {name: n // 8 for name, n in TIER_DOCS.items()}
SMOKE_TIER_BUDGET_GB = TIER_BUDGET_GB / 8
# RAGROUTE_HOSTREFINE_CLUSTER_MIN_DOCS of the probed paths: pubmed's host
# rows cluster, the small sources stay resident
PROBED_CLUSTER_MIN = 500_000
# recall@32 against the exact f32 oracle; the stream tier (int8 rows, the
# int8 gate) is also held to 0.995 of the exact winners of its stored bytes
TIER_GATES = {"stream": 0.95, "hostrefine": 0.95, "hostrefine_probed": 0.9,
              "hostrefine_deep": 0.95, "hostrefine_probed_deep": 0.9}
STREAM_STORED_GATE = 0.995
# the whole serving surface (phase 3's last runs and phase 4's live rewrites)
SURFACE_BURST = 1024     # GET /query of each front end's timed burst
PROFILE_CAPTURES = 3     # 2 s /admin/profile captures during a burst
PROFILE_LOAD_S = 16.0    # seconds of load around them
SURFACE_CONNS = 64       # over this many client connections
SURFACE_WIDE = (4096, 512)   # and a wider burst: requests, connections
RESERVE_DOCS = 4096      # --reserve-docs of the live index
LIVE_ADDS = {"pubmed": 1024, "statpearls": 256, "textbooks": 256,
             "wikipedia": 256}
LIVE_BUILD_DELETES = 1024    # build-time winners deleted from the live index
LIVE_QUANT_GATES = {"int8": 0.95, "int4": 0.90}   # the JAX package's tests'
SSE_REQUESTS = 4
BURSTS = {}              # front end -> its timed burst (phase 3)


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
        for extra in ("deep_launches", "wgmma_launches", "fold_launches",
                      "f32_launches"):
            if hasattr(wrapper, extra):
                setattr(wrapper, extra, 0)


def read_counts() -> dict:
    """Launches of every kernel; under ``deep``, those of the deep launch
    (gains through device memory) of the three top-k kernels; under
    ``wgmma``, those of K1's scan (lists up to 64), K3's wgmma kernel and
    K4's wgmma kernel; under ``fold``, those of K1's scan with the deep fold
    (lists past 64); under ``f32``, those of K1's f32 scan and K3's f32
    kernel."""
    out = {name: k[0].launches for name, k in KERNELS.items()}
    for extra in ("deep", "wgmma", "fold", "f32"):
        out[extra] = {name: getattr(k[0], f"{extra}_launches")
                      for name, k in KERNELS.items()
                      if hasattr(k[0], f"{extra}_launches")}
    return out


def check_wgmma(label: str, launches: dict) -> None:
    """The path's kernels that must have run their wgmma (or f32) design
    did."""
    for counter, paths in (("wgmma", WGMMA_PATHS), ("f32", F32_PATHS)):
        for name in paths.get(label, ()):
            if launches[counter][name] <= 0:
                raise AssertionError(f"the {label} path never launched the "
                                     f"{counter} design of {name}")


def check_deep(label: str, launches: dict, recall: float, out: dict) -> None:
    """A --refine-mult 8 run: its kernels took the launch that serves that
    depth (K1's deep fold, K2's deep launch), and its recall is at least the
    default-depth run's on the same queries."""
    kernels, default = DEEP_PATHS[label]
    for name, counter in kernels:
        if launches[counter][name] <= 0:
            raise AssertionError(f"the {label} path never took the {counter} "
                                 f"launch of {name}")
    base = out[default]["recall"]
    log(f"[serve:{label}] recall {recall:.6f} at k' = {REFINE_MULT} k "
        f"against {base:.6f} at the default depth; deep launches "
        f"{launches['deep']}, fold launches {launches['fold']}")
    if recall < base:
        raise AssertionError(f"{label}: recall {recall} below the default "
                             f"depth's {base}")


def h2d_rate_gbs(nbytes: int = 256 << 20) -> float:
    """GB/s of a page-locked host->device copy of one slab-sized buffer,
    from registered pages as the stream tier's host rows are."""
    from ragroute_tpu_torch.index.streamed import _host_alloc

    host, _ = _host_alloc((nbytes,), torch.int8, 0, True)
    dev = torch.empty(nbytes, dtype=torch.int8, device="cuda")
    ms = kc.cuda_time_ms(lambda: dev.copy_(host, non_blocking=True),
                         warmup=2, reps=5)
    return nbytes / ms / 1e6


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
    with open("/proc/meminfo") as f:
        mem_kb = int(f.readline().split()[1])
    log(f"[host] {os.cpu_count()} cores, {mem_kb / 2 ** 20:.1f} GiB RAM")
    log(f"[host] page-locked host->device copy: {h2d_rate_gbs():.2f} GB/s "
        f"(256 MB slabs, median of 5)")
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


# ---- phase 2: kernels against their plain versions --------------------------

def _check_fused_path(case, label: str, reps: int = 10,
                      q_chunk=None, device: bool = False,
                      old: str = None) -> dict:
    """Kernel against plain version at a path shape, with CUDA-event times,
    the bound, and with ``old`` (the launch the wrapper's plan took before
    the wgmma scan took the shape, named to ``kernel_checks.run_kernel``)
    that launch's time as ``old_ms``."""
    kernel, plain = kc.run_pair(case, q_chunk)
    res = kc.compare_tolerant(kernel, plain)
    plan = kc.fused_plan_of(case)
    log(f"[kernel] fused_topk {label} ({plan}): recall {res['recall']:.6f} "
        f"max_abs_err {res['max_abs_err']:.3e} tol {res['tol']:.3e} "
        f"non-tie mismatches {res['non_tie_mismatches']}")
    if not res["ok"] or res["recall"] < 0.999:
        raise AssertionError(f"fused_topk disagrees with its plain version "
                             f"on {label}: {res}")
    del kernel, plain
    ms = kc.cuda_time_ms(lambda: kc.run_kernel(case), reps=reps)
    plain_ms = kc.cuda_time_ms(lambda: kc.run_plain(case, q_chunk), warmup=1,
                               reps=max(3, reps // 2))
    bound = kc.k1_bound(case)
    row = {"kernel": plan, "max_abs_err": res["max_abs_err"], "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"], "library_ms": None}
    note = floor = ""
    if device:   # every launch of the call (the deep launch makes many)
        row["device_ms"] = dc.device_ms(lambda: kc.run_kernel(case),
                                        fused_topk, warmup=1, reps=3)
        note = f" (device {row['device_ms']:.3f})"
    if old:
        row["old_ms"] = kc.cuda_time_ms(lambda: kc.run_kernel(case, old),
                                        reps=reps)
        row["old_kernel"] = old
        note += f" (the {old} launch before: {row['old_ms']:.3f})"
    if "workspace_bytes" in bound:   # the deep launch's gains' round trip
        row["workspace_bytes"] = bound["workspace_bytes"]
        row["design_floor_ms"] = bound["design_floor_ms"]
        floor = (f"; with the gains' round trip "
                 f"({bound['workspace_bytes'] / 1e9:.3f} GB) "
                 f"{bound['design_floor_ms']:.3f} ms")
    log(f"[kernel] fused_topk {label}: kernel {ms:.3f} ms{note}, plain "
        f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']}){floor}")
    torch.cuda.empty_cache()
    return row


def phase_fused_live(dev) -> dict:
    """K1 over live shards: the exact cases of every launch with -inf
    holes through the capacity, then the live pubmed shard's path shape."""
    live = []
    for case, route in kc.mutable_exact_cases(dev):
        ps, pi = kc.run_plain(case)
        for kernel in (None, route):
            ks, ki = kc.run_kernel(case, kernel)
            torch.cuda.synchronize()
            if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
                raise AssertionError(f"fused_topk ({kernel or 'plan'}) != "
                                     f"plain on live exact case {case.name}")
        live.append(f"{case.name}:{route}")
    log(f"[kernel] fused_topk {len(live)} exact cases over live shards "
        f"(1,536 and 20,480 rows scanned whole, -inf holes scattered, in a "
        f"run, on one copy of a duplicate and in a free tail; 40 live rows "
        f"under k), through the plan and through the wgmma scan (bf16, "
        f"int8, int4 per-doc / per-group), the f32 scan, the first design, "
        f"the deep fold and the deep launch: indices and scores equal")
    # the live index's pubmed shard: its capacity scanned whole, the
    # reserve free and deleted rows as -inf holes
    cap = -(-(MEDRAG_DOCS["pubmed"] + RESERVE_DOCS) // 512) * 512
    live_case = kc.path_case(dev, n=cap)
    live_case.bias = kc.live_bias(cap, holes=0.002,
                                  free_tail=cap - MEDRAG_DOCS["pubmed"],
                                  device=dev)
    return {"live_k32": _check_fused_path(
        live_case, f"live shard B=512 N={cap} d=768 bf16 dot k=32, -inf "
        f"holes and a free tail", old="shallow")}


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
    deep = []
    for case in kc.deep_exact_cases(dev):
        ps, pi = kc.run_plain(case)
        # the plan's launch (the deep fold where it takes the case), then
        # the deep launch itself
        for kernel in (None, "deep"):
            ks, ki = kc.run_kernel(case, kernel)
            torch.cuda.synchronize()
            if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
                raise AssertionError(f"kernel ({kernel or 'plan'}) != plain "
                                     f"on exact case {case.name}")
        deep.append(case.name)
    log(f"[kernel] fused_topk {len(deep)} deep exact cases (k 161..1100 over "
        f"20,000 docs; f32 / bf16 / int8 / int4 per-group; k past the valid "
        f"rows, a -inf tail, chunks and row slices), through the plan and "
        f"the deep launch: indices and scores equal")
    fold = []
    for case in kc.fold_exact_cases(dev):
        ps, pi = kc.run_plain(case)
        ks, ki = kc.run_kernel(case, "fold")
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
            raise AssertionError(f"the deep fold != plain on exact case "
                                 f"{case.name}")
        fold.append(case.name)
    log(f"[kernel] fused_topk {len(fold)} exact cases of the deep fold (k "
        f"{', '.join(map(str, kc.FOLD_KS))}; bf16, int8 and int4 docs; B=150 "
        f"over two query blocks, 845 and 20,000 docs, ties by the thousand so "
        f"that buffers are cut many times, one split under a small cap, "
        f"lists past the valid rows, -inf tail, valid_docs < N): indices and "
        f"scores equal")
    wg = []
    for case in kc.wgmma_exact_cases(dev):
        (ks, ki), (ps, pi) = kc.run_kernel(case, "wgmma"), kc.run_plain(case)
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
            raise AssertionError(f"the wgmma scan != plain on exact case "
                                 f"{case.name}")
        wg.append(case.name)
    log(f"[kernel] fused_topk {len(wg)} exact cases of the wgmma scan (bf16, "
        f"k {', '.join(map(str, kc.WGMMA_KS))}; B=150 over two query blocks, "
        f"845 docs off the tile, d 64 / 80 / 192, -inf tail, valid_docs < N, "
        f"splits of several tiles): indices and scores equal")
    f32 = []
    for case in kc.f32_exact_cases(dev):
        ps, pi = kc.run_plain(case)
        for kernel in (None, "f32"):
            ks, ki = kc.run_kernel(case, kernel)
            torch.cuda.synchronize()
            if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
                raise AssertionError(f"the f32 scan ({kernel or 'plan'}) != "
                                     f"plain on exact case {case.name}")
        if kc.fused_plan_of(case) != "f32":
            raise AssertionError(f"fused_topk plans {case.name} to "
                                 f"{kc.fused_plan_of(case)}")
        f32.append(case.name)
    log(f"[kernel] fused_topk {len(f32)} exact cases of the f32 scan (k "
        f"{', '.join(map(str, kc.F32_KS))}; B=200 over two query tiles, 845 "
        f"docs off the tile, d 64 / 80 / 96, dot / l2 / cos, -inf tail, "
        f"valid_docs < N, per-doc scales, 20,000 docs in splits), through the "
        f"plan and by name: indices and scores equal")
    qn = []
    for case in kc.quant_exact_cases(dev):
        (ks, ki), (ps, pi) = kc.run_kernel(case, "wgmma"), kc.run_plain(case)
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
            raise AssertionError(f"the wgmma scan != plain on exact case "
                                 f"{case.name}")
        qn.append(case.name)
    log(f"[kernel] fused_topk {len(qn)} exact cases of the wgmma scan over "
        f"int8 and int4 docs (no, per-doc and per-group scales; k "
        f"{', '.join(map(str, kc.WGMMA_KS))}; d 64 / 80 / 96 / 192, packed "
        f"rows of 32 to 96 bytes, -inf tail, valid_docs < N, 20,000 docs in "
        f"splits): indices and scores equal")
    res = _check_fused_path(kc.path_case(dev),
                            "path shape B=512 N=734003 d=768 bf16 dot k=32",
                            old="shallow")
    modes = phase_fused_live(dev)
    modes["int4_per_doc"] = _check_fused_path(
        kc.int4_path_case(dev, grouped=False),
        "B=512 N=734003 d=768 int4 per-doc scale k=32", reps=5, device=True,
        old="shallow")
    modes["int4_per_group"] = _check_fused_path(
        kc.int4_path_case(dev, grouped=True),
        "B=512 N=734003 d=768 int4 per-group scale (6 groups) k=32", reps=5,
        device=True, old="shallow")
    # the same shard in int8 (--dtype int8 in HBM) and in f32 (the f32
    # scan: f32 stays off the tensor cores), each with the first design's
    # time beside it
    hbm = kc.int8_path_case(dev, n=734_003, d=768, k=32, seed=8)
    modes["int8_hbm_k32"] = _check_fused_path(
        hbm, "B=512 N=734003 d=768 int8 per-doc scale k=32", reps=5,
        device=True, old="shallow")
    del hbm
    f32 = kc.path_case(dev, dtype=torch.float32)
    modes["f32_k32"] = _check_fused_path(
        f32, "B=512 N=734003 d=768 f32 dot k=32", reps=3, device=True,
        old="shallow")
    # a note: cuBLAS's SGEMM of the product alone (no top-k), full f32; the
    # port never calls it
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    modes["f32_k32"]["sgemm_note_ms"] = kc.cuda_time_ms(
        lambda: torch.matmul(f32.queries, f32.docs.T), warmup=1, reps=3)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"[kernel] fused_topk f32 path shape: note: torch.matmul [512 x 768] "
        f"@ [768 x 734003] f32 without TF32 (cuBLAS SGEMM, the product "
        f"alone) {modes['f32_k32']['sgemm_note_ms']:.3f} ms")
    # the f32 run's batches of 64 query rows or fewer: the plan keeps PR 1's
    # partial_topk_kernel there (fused_topk.f32_scan_pays)
    small = dataclasses.replace(f32, queries=f32.queries[:64].contiguous())
    modes["f32_b64_k32"] = _check_fused_path(
        small, "B=64 N=734003 d=768 f32 dot k=32 (partial_topk_kernel)",
        reps=5, device=True)
    del f32, small
    torch.cuda.empty_cache()
    # the low-rank coarse scan's lists past 64 take the deep fold; the deep
    # launch (the gains' round trip) took them before
    coarse = kc.path_case(dev, d=128, k=128, seed=4)
    modes["coarse_k128"] = _check_fused_path(
        coarse, "low-rank coarse scan B=512 N=734003 r=128 bf16 k=128",
        reps=5, device=True, old="deep")
    # --refine-mult 8: k' = 256
    coarse.k = 256
    modes["coarse_k256"] = _check_fused_path(
        coarse, "low-rank coarse scan B=512 N=734003 r=128 bf16 k'=256",
        reps=5, device=True, old="deep")
    del coarse
    # the host tiers' launches: one uploaded slab of the stream tier, and
    # hostrefine's flat coarse scan over the padded rank-128 slab of the
    # large source (the plain version 64 query rows at a time)
    slab = kc.int8_path_case(dev, n=TIER_SLAB_ROWS, d=768, k=32, seed=6)
    modes["int8_slab_k32"] = _check_fused_path(
        slab, f"stream slab B=512 N={TIER_SLAB_ROWS} d=768 int8 per-doc "
        f"scale k=32", reps=5, device=True, old="shallow")
    del slab
    n_pad = -(-SMOKE_TIER_DOCS["pubmed"] // 512) * 512
    flat = kc.int8_path_case(dev, n=n_pad, d=128, k=128,
                             pad_tail=n_pad - SMOKE_TIER_DOCS["pubmed"],
                             seed=7)
    modes["int8_coarse_k128"] = _check_fused_path(
        flat, f"hostrefine flat coarse scan B=512 N={n_pad} r=128 int8 "
        f"per-doc scale, -inf bias on {n_pad - SMOKE_TIER_DOCS['pubmed']} "
        f"padding "
        f"rows, k'=128", reps=3, q_chunk=64, device=True, old="deep")
    flat.k = 256
    modes["int8_coarse_k256"] = _check_fused_path(
        flat, f"hostrefine flat coarse scan B=512 N={n_pad} r=128 int8 "
        f"per-doc scale, -inf padding tail, k'=256", reps=3,
        q_chunk=64, device=True, old="deep")
    del flat
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
        f"and k; -inf entries and rows; M < 2k and M % 4 != 0; sorted runs; "
        f"both paths, runs merged across splits; k 1..160; deep lists k 161 "
        f"to M over one run and over runs merged): positions and gains "
        f"equal")
    # the deep launch in slices of 4 rows
    gains = torch.cat([next(iter(kc.stream_exact_cases(dev)))[1]] * 5, dim=1)
    one_row = deep_topk.stream_plan(1, gains.shape[1], 1100)
    kg, ki = stream_topk(gains, 1100,
                         workspace_cap=4 * one_row.workspace_bytes)
    pg, pi = kc.stream_topk_reference(gains, 1100)
    if not (torch.equal(ki, pi) and torch.equal(kg, pg)):
        raise AssertionError("stream_topk != plain on the sliced deep case")
    del gains, kg, ki, pg, pi
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
    row = _time_stream(gains, k, "path shape B=512 M=131072 k=32 (20% -inf)")
    del gains
    torch.cuda.empty_cache()
    row["max_abs_err"] = err
    modes = {}
    for k in (128, 256):     # default depth, then --refine-mult 8 (deep)
        for label, gains in (
                (f"probed_collect_k{k}", kc.stream_path_case(
                    dev, m=512 * 8, pad_share=0.1, seed=8)),
                (f"probed_collect_runs_k{k}", kc.stream_runs_case(dev))):
            modes[label] = _check_stream_collect(gains, label, k)
    return {**row, "modes": modes}


def _time_stream(gains, k: int, label: str) -> dict:
    """CUDA-event times of the kernel, its plain version and ``torch.topk``
    (the same lists, no order promised among ties), the kernel's device time
    from the profiler, and its bound."""
    ms = kc.cuda_time_ms(lambda: stream_topk(gains, k), reps=20)
    dev_ms = dc.device_ms(lambda: stream_topk(gains, k), stream_topk)
    plain_ms = kc.cuda_time_ms(lambda: kc.stream_topk_reference(gains, k),
                               warmup=1, reps=5)
    library_ms = kc.cuda_time_ms(lambda: torch.topk(gains, k, dim=1),
                                 reps=20)
    bound = kc.k2_bound(gains, k)
    log(f"[kernel] stream_topk {label}: equal; kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f}, {bound['bound_ms'] / dev_ms:.3f} of its bound), plain "
        f"{plain_ms:.4f} ms, torch.topk {library_ms:.4f} ms, bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bound_share": bound["bound_ms"] / dev_ms,
            "library_ms": library_ms}


def _check_stream_collect(gains, label: str, k: int) -> dict:
    """The collect of the probed coarse scan: 512 probes of kw = 8 kept
    gains a query, a tenth of them unfilled (``-inf``), at k' = 128 or 256;
    random, or sorted runs with ties as K4 leaves them."""
    kg, ki = stream_topk(gains, k)
    pg, pi = kc.stream_topk_reference(gains, k)
    torch.cuda.synchronize()
    err = float((kg - pg).abs().max())
    if not (torch.equal(ki, pi) and torch.equal(kg, pg)):
        raise AssertionError(f"stream_topk disagrees with its plain version "
                             f"on {label} (max err {err})")
    row = _time_stream(gains, k, f"{label} B=512 M=4096 k={k} (10% -inf)")
    return {**row, "max_abs_err": err}


def _check_grouped_path(case, label: str) -> dict:
    """K3 at a path shape: the plan's kernel against the plain version
    (1e-3 x max|gain|), CUDA-event and profiler device times, the bound,
    and the first design's times at the same shape (``old_ms``)."""
    real = case.real_rows
    blocks = real // kc.GROUP_ROWS
    plan = kc.grouped_plan_of(case)
    out = kc.run_grouped_kernel(case)
    plain = kc.run_grouped_plain(case, blocks)
    torch.cuda.synchronize()
    res = kc.compare_grouped(out[:real], plain)
    log(f"[kernel] grouped_gains {label} ({plan}): {blocks} real blocks of "
        f"{case.blk_cluster.shape[0]}, max_abs_err {res['max_abs_err']:.3e} "
        f"tol {res['tol']:.3e} -inf places equal {res['same_inf']}")
    if not res["ok"]:
        raise AssertionError(f"grouped_gains disagrees with its plain "
                             f"version on {label}: {res}")
    del out, plain
    torch.cuda.empty_cache()
    ms = kc.cuda_time_ms(lambda: kc.run_grouped_kernel(case))
    dev_ms = dc.device_ms(lambda: kc.run_grouped_kernel(case), grouped_gains,
                          warmup=1, reps=10)
    old_ms = kc.cuda_time_ms(lambda: kc.run_grouped_kernel(case, "first"))
    old_dev = dc.device_ms(lambda: kc.run_grouped_kernel(case, "first"),
                           grouped_gains, warmup=1, reps=10)
    plain_ms = kc.cuda_time_ms(lambda: kc.run_grouped_plain(case, blocks),
                               warmup=1, reps=3)
    bound = kc.k3_bound(case)
    log(f"[kernel] grouped_gains {label}: kernel {ms:.3f} ms (device "
        f"{dev_ms:.3f}, {bound['bound_ms'] / dev_ms:.2f} of the bound), the "
        f"first design {old_ms:.3f} ms (device {old_dev:.3f}), plain "
        f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']}; {bound['bytes'] / 1e6:.1f} MB, "
        f"{bound['flops'] / 1e12:.4f} TFLOP)")
    return {"kernel": plan, "max_abs_err": res["max_abs_err"], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bound_share": bound["bound_ms"] / dev_ms, "library_ms": None,
            "old_ms": old_ms, "old_device_ms": old_dev,
            "old_kernel": "first"}


def phase_grouped(dev) -> dict:
    n = 0
    for case in kc.grouped_exact_cases(dev):
        real = case.real_rows
        plain = kc.run_grouped_plain(case, real // kc.GROUP_ROWS)
        # the plan's kernel, then each kernel that takes the slab type by
        # name
        for kernel in (None, "wgmma", "f32", "first"):
            if kernel is not None and not kc.grouped_takes(case, kernel):
                continue
            out = kc.run_grouped_kernel(case, kernel)
            torch.cuda.synchronize()
            if not torch.equal(out[:real], plain):
                raise AssertionError(f"grouped_gains ({kernel or 'plan'}) != "
                                     f"plain on exact case {case.name}")
            n += 1
        if kc.grouped_plan_of(case) != (
                "f32" if case.docs.dtype == torch.float32 else "wgmma"):
            raise AssertionError(f"grouped_gains plans {case.name} to "
                                 f"{kc.grouped_plan_of(case)}")
    log(f"[kernel] grouped_gains {n} exact launches (f32 / bf16 / int8 / "
        f"int4 slabs, S {', '.join(map(str, kc.GROUPED_S))}, row table, "
        f"real-block count; through the plan, the wgmma or f32 kernel and the "
        f"first design by name): gains equal")
    case = kc.grouped_path_case(dev)
    res = _check_grouped_path(
        case, "path shape B=512 P=512 C=4096 d=768 S=256 bf16")
    # no single PyTorch call computes this; for a note, torch.bmm over the
    # gathered bf16 slabs of 512 blocks at a time (bf16 output, no epilogue)
    blocks = case.real_rows // kc.GROUP_ROWS
    cl = case.blk_cluster[:blocks].long()
    qb = case.q[case.rows[:case.real_rows].long()].reshape(
        blocks, kc.GROUP_ROWS, -1)

    def bmm_note():
        for g0 in range(0, blocks, 512):
            torch.bmm(qb[g0:g0 + 512], case.docs[cl[g0:g0 + 512]])

    res["bmm_note_ms"] = kc.cuda_time_ms(bmm_note, warmup=1, reps=3)
    log(f"[kernel] grouped_gains path shape: note: torch.bmm over gathered "
        f"bf16 slabs {res['bmm_note_ms']:.3f} ms")
    del case, qb, cl
    torch.cuda.empty_cache()
    modes = {}
    for slab in ("int8", "int4"):
        case = kc.grouped_path_case(dev, slab=slab)
        modes[slab] = _check_grouped_path(
            case, f"path shape B=512 P=512 C=4096 d=768 S=256 {slab}, a "
            f"scale a slot")
        del case
        torch.cuda.empty_cache()
    res["modes"] = modes
    return res


def phase_pair(dev) -> dict:
    n = 0
    for case in kc.pair_exact_cases(dev):
        out = kc.run_pair_kernel(case)
        real = case.real_rows
        plain = kc.run_pair_plain(case, real // kc.PAIR_ROWS)
        torch.cuda.synchronize()
        res = kc.compare_pair((out[0][:real], out[1][:real]), plain)
        if not res["ok"] or res["max_abs_err"] != 0.0:
            raise AssertionError(
                f"grouped_pair_topk != plain on exact case {case.name}: {res}")
        n += 1
    log(f"[kernel] grouped_pair_topk {n} exact cases (S 72 / 1024 / 1096 / "
        f"2056, an empty cluster, a block of padding rows, equal gains "
        f"across the tile boundary, negative biases, ranks 1..64 and deep "
        f"ranks 200 / 256, row table, real-block count, chunks of blocks): "
        f"gains equal, slots equal where finite")
    for kernel in ("wgmma", "shallow"):   # each launch where it takes them
        n = 0
        for case in kc.pair_exact_cases(dev):
            if not kc.pair_takes(case, kernel):
                continue
            out = kc.run_pair_kernel(case, kernel)
            real = case.real_rows
            plain = kc.run_pair_plain(case, real // kc.PAIR_ROWS)
            torch.cuda.synchronize()
            res = kc.compare_pair((out[0][:real], out[1][:real]), plain)
            if not res["ok"] or res["max_abs_err"] != 0.0:
                raise AssertionError(f"the {kernel} launch != plain on exact "
                                     f"case {case.name}: {res}")
            n += 1
        log(f"[kernel] grouped_pair_topk {n} exact cases through the "
            f"{kernel} launch: gains equal, slots equal where finite")
    deep = _check_pair_path(kc.pair_path_case(
        dev, bsz=64, c=64, s=568, nprobe=64, kappa=256, seed=6), reps=5)
    case = kc.pair_path_case(dev)
    real = case.real_rows
    blocks = real // kc.PAIR_ROWS
    out = kc.run_pair_kernel(case)
    plain = kc.run_pair_plain(case, blocks)
    torch.cuda.synchronize()
    res = kc.compare_pair((out[0][:real], out[1][:real]), plain, rel=1e-4,
                          case=case)
    c, r, s = case.cc.docs.shape
    log(f"[kernel] grouped_pair_topk path shape B=512 P=512 C={c} r={r} "
        f"S={s} int8 kappa={case.kappa}: {blocks} real blocks of "
        f"{case.blk_cluster.shape[0]}, max_abs_err {res['max_abs_err']:.3e} "
        f"(gate 1e-4 relative: {res['close']}), -inf places equal "
        f"{res['same_inf']}, {res['slots_differ']} of "
        f"{res['slots_compared']} clearly ordered slots differ (gate: a "
        f"millionth); {res['slots_swapped']} finite entries carry another "
        f"slot than the plain version's, {res['swapped_wrong_gain']} of them "
        f"a slot whose recomputed gain is not the one written (gate: 0)")
    if not res["ok"]:
        raise AssertionError(f"grouped_pair_topk disagrees with its plain "
                             f"version on the path shape: {res}")
    del out, plain
    torch.cuda.empty_cache()
    plan = kc.pair_plan_of(case)
    ms = kc.cuda_time_ms(lambda: kc.run_pair_kernel(case))
    dev_ms = dc.device_ms(lambda: kc.run_pair_kernel(case), grouped_pair_topk,
                          warmup=1, reps=5)
    # the first design, which took this shape before the wgmma kernel
    old_ms = kc.cuda_time_ms(lambda: kc.run_pair_kernel(case, "shallow"))
    plain_ms = kc.cuda_time_ms(lambda: kc.run_pair_plain(case, blocks),
                               warmup=1, reps=2)
    bound = kc.k4_bound(case)
    # no single PyTorch call computes this; for a note, torch.bmm over the
    # gathered slabs as bf16 (64 blocks at a time) and torch.topk of kw per
    # row over the whole slab: no scale, no bias, no tiles, no rank cap
    cl = case.blk_cluster[:blocks].long()
    qb = case.q[case.rows[:real].long()].reshape(blocks, kc.PAIR_ROWS, -1)
    kw = kc.tiling(s, case.kappa)[3]

    def bmm_topk_note():
        for g0 in range(0, blocks, 64):
            gains = torch.bmm(qb[g0:g0 + 64],
                              case.cc.docs[cl[g0:g0 + 64]].to(torch.bfloat16))
            torch.topk(gains, kw, dim=2)

    note_ms = kc.cuda_time_ms(bmm_topk_note, warmup=1, reps=2)
    log(f"[kernel] grouped_pair_topk path shape ({plan}): kernel {ms:.3f} ms "
        f"(device {dev_ms:.3f}; the shallow launch before: {old_ms:.3f}), "
        f"plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']}; {bound['bytes'] / 1e6:.1f} MB, "
        f"{bound['flops'] / 1e12:.4f} TFLOP over the {case.n_pairs} real "
        f"pairs, {bound['padded_flops'] / 1e12:.4f} over the blocks' rows); "
        f"note: torch.bmm + torch.topk over gathered bf16 slabs "
        f"{note_ms:.3f} ms")
    del case, qb, cl
    torch.cuda.empty_cache()
    return {"kernel": plan, "max_abs_err": res["max_abs_err"], "ms": ms,
            "device_ms": dev_ms, "old_ms": old_ms, "old_kernel": "shallow",
            "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None,
            "bmm_topk_note_ms": note_ms, "modes": {"ranks256": deep}}


def _check_pair_path(case, reps: int) -> dict:
    """Deep ranks at the reduced world's probed scan under an open cap
    (nprobe == C == 64 clusters of 568 slots, one 640-slot tile, kappa =
    k' = 256 ranks): held as the path shape, with CUDA-event and device
    times and the bound with the gains' round trip."""
    real = case.real_rows
    out = kc.run_pair_kernel(case)
    plain = kc.run_pair_plain(case, real // kc.PAIR_ROWS)
    torch.cuda.synchronize()
    res = kc.compare_pair((out[0][:real], out[1][:real]), plain, rel=1e-4,
                          case=case)
    c, r, s = case.cc.docs.shape
    label = (f"deep ranks B=64 P=64 C={c} r={r} S={s} int8 kappa="
             f"{case.kappa} (ranks {kc.tiling(s, case.kappa)[2]})")
    if not res["ok"]:
        raise AssertionError(f"grouped_pair_topk disagrees with its plain "
                             f"version on {label}: {res}")
    del out, plain
    ms = kc.cuda_time_ms(lambda: kc.run_pair_kernel(case), reps=reps)
    dev_ms = dc.device_ms(lambda: kc.run_pair_kernel(case),
                          grouped_pair_topk, warmup=1, reps=reps)
    plain_ms = kc.cuda_time_ms(
        lambda: kc.run_pair_plain(case, real // kc.PAIR_ROWS), warmup=1,
        reps=2)
    bound = kc.k4_bound(case)
    log(f"[kernel] grouped_pair_topk {label}: max_abs_err "
        f"{res['max_abs_err']:.3e}, {res['slots_differ']} of "
        f"{res['slots_compared']} clearly ordered slots differ, "
        f"{res['swapped_wrong_gain']} swapped slots with a wrong gain; "
        f"kernel {ms:.3f} ms (device {dev_ms:.3f}), plain {plain_ms:.3f} ms, "
        f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); with "
        f"the gains' round trip ({bound['workspace_bytes'] / 1e6:.1f} MB) "
        f"{bound['design_floor_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return {"max_abs_err": res["max_abs_err"], "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None,
            "workspace_bytes": bound["workspace_bytes"],
            "design_floor_ms": bound["design_floor_ms"]}


def phase_decoder_kernels(dev) -> dict:
    return {"int4_matmul": phase_int4(dev),
            "decode_attention": phase_decode_attention(dev)}


def phase_kernels(dev) -> dict:
    return {"fused_topk": phase_fused(dev), "stream_topk": phase_stream(dev),
            "grouped_gains": phase_grouped(dev),
            "grouped_pair_topk": phase_pair(dev),
            **phase_decoder_kernels(dev)}


# ---- the decoder's kernels: K5 (int4 matmul) and K6 (decode attention) -----

def phase_int4(dev) -> dict:
    n = 0
    for case in dc.int4_exact_cases(dev):
        got, want = dc.run_int4(case), dc.run_int4_plain(case)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"int4_matmul != plain on exact case {case.name}: max err "
                f"{float((got - want).abs().max())}")
        n += 1
    log(f"[kernel] int4_matmul {n} exact cases (bf16 and f32 activations; "
        f"OUT 260 / 300 / 40 off the 16-byte grid; groups 6 / 12 / 24; M 1 "
        f"to 100; a split contraction; the prefill kernel at M {M_SWITCH} "
        f"and {M_SWITCH + 37}, OUT 208, groups over 1, 2 and 4 stages): "
        f"outputs equal")
    modes = {}
    for case in dc.int4_path_cases(dev):
        got, want = dc.run_int4(case), dc.run_int4_plain(case)
        res = dc.matmul_close(got, want)
        del got, want
        if not res["ok"]:
            raise AssertionError(f"int4_matmul disagrees with its plain "
                                 f"version on {case.name}: {res}")
        prefill = case.x.shape[0] >= M_SWITCH
        reps = 5 if prefill else 20
        ms = kc.cuda_time_ms(lambda: dc.run_int4(case), reps=reps)
        # the first kernel, which the plan took at these shapes before the
        # prefill and the decode kernels took them
        old_ms = kc.cuda_time_ms(lambda: dc.run_int4(case, "mma"), reps=reps)
        old_dev_ms = dc.device_ms(lambda: dc.run_int4(case, "mma"),
                                  int4_matmul)
        dev_ms = dc.device_ms(lambda: dc.run_int4(case), int4_matmul)
        plain_ms = kc.cuda_time_ms(lambda: dc.run_int4_plain(case), warmup=1,
                                   reps=3)
        note_ms = kc.cuda_time_ms(lambda: dc.dequant_matmul_note(case),
                                  warmup=1, reps=5)
        bound = dc.k5_bound(case)
        m, i = case.x.shape
        o = case.w.shape[1]
        log(f"[kernel] int4_matmul {case.name} [{m} x {i}] @ [{i} x {o}]: "
            f"max_abs_err {res['max_abs_err']:.3e} (tol {res['tol']:.3e}); "
            f"kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
            f"{plain_ms:.3f} ms, bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
            f"{bound['bytes'] / 1e6:.1f} MB, {bound['flops'] / 1e12:.4f} "
            f"TFLOP); note: dequant to bf16 + torch.matmul {note_ms:.3f} ms"
            f"; the first kernel, before: {old_ms:.4f} ms (device "
            f"{old_dev_ms:.4f})")
        modes[case.name] = {"max_abs_err": res["max_abs_err"], "ms": ms,
                            "device_ms": dev_ms, "plain_ms": plain_ms,
                            "bound_ms": bound["bound_ms"],
                            "bound_by": bound["bound_by"],
                            "library_ms": None,
                            "dequant_matmul_note_ms": note_ms}
        modes[case.name].update(old_ms=old_ms, old_device_ms=old_dev_ms,
                                old_kernel="mma")
        del case
        torch.cuda.empty_cache()
    head = modes.pop("qwen3-8b decode head")
    return {**head, "shape": "qwen3-8b decode head [16 x 4096] @ "
                             "[4096 x 151936]", "modes": modes}


def phase_decode_attention(dev) -> dict:
    n = 0
    for case in dc.attn_small_cases(dev):
        got = dc.run_attn(case)
        for label, want in (("plain", dc.run_attn_plain(case)),
                            ("_attend", dc.run_attend(case))):
            res = dc.attn_close(got, want)
            if not res["ok"]:
                raise AssertionError(f"decode_attention != {label} on "
                                     f"{case.name}: {res}")
        n += 1
    log(f"[kernel] decode_attention {n} small cases (f32, bf16 and int8 "
        f"caches, G 1 to 8, Dh 20 to 256, S 5 to 3,000, a row with one valid "
        f"key and a row with none, layer selection): within 1e-5 of the "
        f"plain version and of _attend")
    out = None
    modes = {}
    for case in dc.attn_path_cases(dev):
        got, want = dc.run_attn(case), dc.run_attn_plain(case)
        res = dc.attn_close(got, want)
        res_att = dc.attn_close(got, dc.run_attend(case))
        if not (res["ok"] and res_att["ok"]):
            raise AssertionError(f"decode_attention disagrees on "
                                 f"{case.name}: {res} {res_att}")
        ms = kc.cuda_time_ms(lambda: dc.run_attn(case), reps=20)
        dev_ms = dc.device_ms(lambda: dc.run_attn(case), decode_attention)
        plain_ms = kc.cuda_time_ms(lambda: dc.run_attn_plain(case), reps=10)
        attend_ms = kc.cuda_time_ms(lambda: dc.run_attend(case), reps=10)
        library_ms = (None if case.ks is not None else
                      kc.cuda_time_ms(lambda: dc.sdpa_note(case), reps=10))
        bound = dc.k6_bound(case)
        lib = ("none (int8 scales)" if library_ms is None
               else f"{library_ms:.4f} ms")
        log(f"[kernel] decode_attention {case.name}: max_abs_err "
            f"{res['max_abs_err']:.3e} vs plain, {res_att['max_abs_err']:.3e}"
            f" vs _attend (tol {res['tol']:.1e}); kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f}, {bound['bound_ms'] / dev_ms:.3f} of its bound), "
            f"plain "
            f"{plain_ms:.4f} ms, _attend {attend_ms:.4f} ms, SDPA (GQA) "
            f"{lib}, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
            f"{bound['bytes'] / 1e6:.1f} MB)")
        row = {"max_abs_err": res["max_abs_err"], "ms": ms,
               "device_ms": dev_ms, "plain_ms": plain_ms,
               "bound_ms": bound["bound_ms"],
               "bound_by": bound["bound_by"],
               "bound_share": bound["bound_ms"] / dev_ms,
               "library_ms": library_ms, "attend_ms": attend_ms}
        if out is None:
            out = dict(row, shape=case.name)
        else:
            modes[case.name] = row
        del case, got, want
        torch.cuda.empty_cache()
    out["modes"] = modes
    return out

# ---- phase 3: the served paths at real size ---------------------------------

async def _get_query(session, port: int, qid: str, question: str):
    import aiohttp

    params = {"q": question, "choices": json.dumps({"A": "a", "B": "b"}),
              "qid": qid}
    async with session.get(f"http://127.0.0.1:{port}/query",
                           params=params,
                           timeout=aiohttp.ClientTimeout(total=600)) as r:
        return r.status, (await r.json() if r.status == 200
                          else await r.text())


async def _drive(system, syn, k: int, label: str, stop: bool = True) -> dict:
    """Sequential then concurrent GET /query through the running server
    (left running with ``stop=False``)."""
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
            timed = None
            if label == "exact":    # the front ends' comparison
                timed = await asyncio.get_running_loop().run_in_executor(
                    None, surface_bursts, port, syn)
            async with s.get(f"http://127.0.0.1:{port}/stats") as r:
                stats = await r.json()
        launches = read_counts()
    except BaseException:
        stop = True
        raise
    finally:
        if stop:
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
    if timed is not None:
        report_bursts(f"serve:{label}", "aiohttp", timed)
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


class OracleMemo:
    """``exact_oracle`` over one world's first ``N_CHECK`` queries, computed
    once a routing mask: the paths served over a world route alike, and
    one computation over the 1,048,575 f32 rows takes seconds a query."""

    def __init__(self, syn):
        self.syn = syn
        self.q = {e: v[:N_CHECK] for e, v in syn.query_embs.items()}
        self._done = {}

    def __call__(self, mask):
        from ragroute_tpu_torch.oracle import exact_oracle

        key = None if mask is None else np.asarray(mask).tobytes()
        if key not in self._done:
            t0 = time.perf_counter()
            self._done[key] = exact_oracle(self.syn.world, self.syn.embeddings,
                                           self.q, self.syn.world.k,
                                           mask=mask)
            log(f"[oracle] exact_oracle of {N_CHECK} queries over "
                f"{sum(len(v) for v in self.syn.embeddings.values())} rows "
                f"in {time.perf_counter() - t0:.1f} s (kept for the paths "
                f"that route alike)")
        return self._done[key]


def deep_rerun(engine, syn, label: str, oracle) -> dict:
    """A ``--refine-mult 8`` path on the engine its default-depth run built
    (k' = 8 k set on the engine, which is what the flag sets; the world is
    not built a second time): the full batch and the check queries through
    ``engine.search``, their launches, and the check queries' recall against
    ``oracle`` (one winner set a check query, or a function of the mask
    giving them)."""
    from ragroute_tpu_torch.oracle import engine_recall

    k = syn.world.k
    engine.k_refine = REFINE_MULT * k
    reset_counts()
    engine.search({e: v[:NUM_QUERIES] for e, v in syn.query_embs.items()},
                  strategy="ragroute", fetch_candidates=False)
    q = {e: v[:N_CHECK] for e, v in syn.query_embs.items()}
    out = engine.search(q, strategy="ragroute", fetch_candidates=False)
    launches = read_counts()
    want = oracle(out.mask) if callable(oracle) else oracle
    recall = engine_recall(syn.world, out, want)
    log(f"[serve:{label}] k' = {engine.k_refine} on the default-depth run's "
        f"engine: {NUM_QUERIES} + {N_CHECK} queries through engine.search, "
        f"launches {launches}, recall@{k} {recall:.6f}")
    for name in PATH_KERNELS[label]:
        if launches[name] <= 0:
            raise AssertionError(
                f"the {label} path never launched the {name} kernel")
    return {"launches": launches, "recall": recall}


def serve_path(root: str, dev, syn, label: str, flags, recall_gate: float,
               deep: str = None, oracles: OracleMemo = None) -> dict:
    """Build one ServingSystem from the CLI's flags, drive it over HTTP and
    hold ``engine.search`` against the exact f32 oracle. ``deep``: then run
    that ``--refine-mult 8`` label on the same engine (:func:`deep_rerun`);
    returns ``{label: result}`` for both. ``oracles``: the world's
    :class:`OracleMemo`."""
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.oracle import engine_recall
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
    check_wgmma(label, launches)

    oracles = oracles or OracleMemo(syn)
    out = engine.search(oracles.q, strategy="ragroute")
    recall = engine_recall(syn.world, out, oracles(out.mask))
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
    res = {label: {"launches": launches, "recall": recall}}
    if deep:
        res[deep] = deep_rerun(engine, syn, deep, oracles)
    del system, engine, ss, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_main_paths(dev, surface_only: bool = False,
                     zoo: bool = True, smi: str = "") -> dict:
    """Serve the synthetic medrag world through the port's ServingSystem:
    exact, then low-rank, then ``--embedder zoo`` (with ``zoo``: phase 7
    (b)), then the rest of the serving surface, then cluster-probed over the
    topical world (``surface_only``: the exact path and the rest of the
    surface)."""
    from ragroute_tpu_torch.index.synthetic import (make_synthetic_world,
                                                    save_world)

    n_docs = sum(MEDRAG_DOCS.values())
    out = {}
    worlds = ((1, (("exact", []),
                   ("exact_f32", ["--dtype", "float32"]),
                   ("lowrank", ["--impl", "lowrank"]))),
              (IVF_TOPICS, (("ivf", ["--impl", "ivf"]),)))
    if surface_only:
        worlds = ((1, (("exact", []),)),)
    for topics, runs in worlds:
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
            oracles = OracleMemo(syn)
            for label, flags in runs:
                deep = "lowrank_deep" if label == "lowrank" else None
                out.update(serve_path(
                    root, dev, syn, label, flags,
                    recall_gate=RECALL_GATES.get(label, 0.99), deep=deep,
                    oracles=oracles))
                if deep:
                    check_deep(deep, out[deep]["launches"],
                               out[deep]["recall"], out)
            if topics == 1 and zoo:     # --embedder zoo over this world
                out.update(phase_zoo_medrag(root, dev, syn))
            if topics == 1 and not surface_only:    # phase 9's mesh part
                out.update(phase_mesh_medrag(root, dev, syn, smi, oracles))
            if topics == 1:     # the same world, served by the rest of
                #                 the surface (it ends by overwriting it)
                out.update(phase_surface(root, dev, syn))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        del syn
        gc.collect()
    return out


# ---- phase 3, last runs: the whole serving surface --------------------------

def start_load(port: int, syn, n: int = SURFACE_BURST,
               conns: int = SURFACE_CONNS, questions=None,
               seconds: float = None):
    """A closed-loop burst of ``n`` GET /query over ``conns`` connections
    from a process of its own (``python -m ragroute_tpu_torch.loadgen``,
    no torch import), so that its work does not load the server's
    process; returns ``(process, questions file)``. ``questions``: the
    ``{"qid", "question"}`` list to send (default the world's).
    ``seconds``: send for that long instead of ``n`` requests."""
    fd, path = tempfile.mkstemp(prefix="ragroute_questions_", suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(questions or [{"qid": q["qid"], "question": q["question"]}
                                for q in syn.questions], f)
    size = ["--seconds", str(seconds)] if seconds else ["--n", str(n)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "ragroute_tpu_torch.loadgen", "--port",
         str(port), *size, "--conns", str(conns), "--questions", path],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, path


def finish_load(load) -> dict:
    """The burst's result; every answer must be 200."""
    proc, path = load
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.unlink(path)
    lines = out.strip().splitlines()
    if not lines:
        raise AssertionError(f"the load generator printed nothing: "
                             f"{err[-2000:]}")
    res = json.loads(lines[-1])
    if "errors" in res:             # a timed load
        if res["errors"] or not res["ok"]:
            raise AssertionError(f"{res['errors']} answers were not 200 and "
                                 f"{res['ok']} were")
    elif res["n_bad"]:
        raise AssertionError(f"{res['n_bad']} of {res['n']} answers were not "
                             f"200: {res['bad']}")
    return res


def surface_burst(port: int, syn, n: int = SURFACE_BURST,
                  conns: int = SURFACE_CONNS, questions=None) -> dict:
    return finish_load(start_load(port, syn, n, conns, questions))


def surface_bursts(port: int, syn) -> list:
    """The timed burst, then the wider one."""
    return [surface_burst(port, syn),
            surface_burst(port, syn, *SURFACE_WIDE)]


def report_bursts(tag: str, front: str, bursts: list) -> None:
    for res in bursts:
        log(f"[{tag}] {front}: {res['n']} GET /query closed-loop over "
            f"{res['conns']} connections, all 200, in {res['wall_s']:.3f} "
            f"s: {res['requests_per_s']:.1f} requests/s, p50 "
            f"{res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms "
            f"({os.cpu_count()} host cores)")
        BURSTS[f"{front} x {res['conns']}"] = res


def _http(port: int, method: str, path: str, body=None, timeout=600):
    """One request on a fresh connection: ``(status, body bytes)``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        headers = {}
        if body is not None and not isinstance(body, (bytes, str)):
            body = json.dumps(body)
            headers["Content-Type"] = "application/json"
        conn.request(method, path, body=body, headers=headers)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _stats_by_worker(port: int, want: int, tries: int = 200) -> dict:
    """``/stats`` of each SO_REUSEPORT worker on ``port``: fresh
    connections until ``want`` distinct workers answered."""
    seen = {}
    for _ in range(tries):
        status, body = _http(port, "GET", "/stats", timeout=60)
        if status == 200:
            st = json.loads(body)
            seen[st["worker_pid"]] = st
            if len(seen) >= want:
                break
    return seen


def phase_workers(root: str, dev, syn) -> dict:
    """``--workers 2`` (aiohttp, immutable, bf16) on one card: both workers
    bind the one resolved port and both answer the timed burst."""
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.system import Workers

    t0 = time.perf_counter()
    workers = Workers(parse_args([
        "--dataset", "medrag", "--routing", "ragroute", "--disable-llm",
        "--port", "0", "--workers", "2", "--data-root", root,
        "--device", str(dev)]), 2)
    try:
        port = workers.start()
        deadline = time.time() + 300
        ready = {}
        while len(ready) < 2 and time.time() < deadline:
            if not all(p.is_alive() for p in workers.procs):
                raise AssertionError("a worker died while starting")
            try:
                ready = _stats_by_worker(port, 2, tries=20)
            except OSError:
                time.sleep(1.0)
        if len(ready) < 2:
            raise AssertionError(f"only {len(ready)} of 2 workers answered")
        log(f"[workers] 2 SO_REUSEPORT workers on port {port} (pids "
            f"{sorted(ready)}) loaded the world and warmed in "
            f"{time.perf_counter() - t0:.1f} s")
        report_bursts("workers", "aiohttp, 2 workers",
                      surface_bursts(port, syn))
        seen = _stats_by_worker(port, 2)
        counts = {pid: st["num_queries"] for pid, st in seen.items()}
        log(f"[workers] /stats num_queries by worker {counts}")
        if len(seen) < 2 or min(counts.values()) <= 0:
            raise AssertionError(f"not both workers served: {counts}")
    finally:
        workers.stop()
    if any(p.is_alive() for p in workers.procs):
        raise AssertionError("a worker outlived stop()")
    return {}


def _start_native(system):
    """``system.run_native()`` (the native loop, as ``main`` runs it) in a
    thread; returns the thread once the front end listens."""
    import threading

    thread = threading.Thread(target=system.run_native, daemon=True)
    thread.start()
    deadline = time.time() + 300
    while (system.native is None or system.native.fe is None) \
            and time.time() < deadline:
        if not thread.is_alive():
            raise AssertionError("the native loop ended while starting")
        time.sleep(0.05)
    if system.native is None or system.native.fe is None:
        raise AssertionError("the native front end did not start")
    return thread


def _stop_native(system, thread) -> None:
    native = system.native
    native._running = False
    if native.fe is not None:
        native.fe.shutdown()
    thread.join(60)
    native.stop()
    if thread.is_alive():
        raise AssertionError("the native loop did not stop")


def _twins(syn, name: str, n: int) -> np.ndarray:
    """Rows that beat every doc of source ``name`` for the first ``n``
    check queries: each query's direction at twice the source's largest
    row norm (a dot score above any of the source's, by Cauchy-Schwarz)."""
    src = next(s for s in syn.world.sources if s.name == name)
    q = syn.query_embs[src.encoder][:n].astype(np.float32)
    top = float(np.sqrt((syn.embeddings[name] ** 2).sum(axis=1).max()))
    return q / np.linalg.norm(q, axis=1, keepdims=True) * (2.0 * top)


def _live_rows(syn, rows: dict, name: str):
    """A source's live rows in ascending slot order, and their slots."""
    slots = sorted(rows[name])
    base = syn.embeddings[name]
    out = np.empty((len(slots), base.shape[1]), np.float32)
    n0 = base.shape[0]
    bs = [i for i, sl in enumerate(slots) if sl < n0 and rows[name][sl] is None]
    out[bs] = base[[slots[i] for i in bs]]
    for i, sl in enumerate(slots):
        if rows[name][sl] is not None:
            out[i] = rows[name][sl]
    return out, slots


def live_oracle(syn, rows: dict, q: dict, k: int, mask) -> list:
    """``exact_oracle`` over the live rows, as (source, slot) sets."""
    from ragroute_tpu_torch.oracle import exact_oracle

    embs, slot_of = {}, {}
    for src in syn.world.sources:
        embs[src.name], slot_of[src.name] = _live_rows(syn, rows, src.name)
    want = exact_oracle(syn.world, embs, q, k, mask=mask)
    names = [s.name for s in syn.world.sources]
    return [{(si, slot_of[names[si]][li]) for si, li in w} for w in want]


def _winners(out, r: int) -> set:
    return {(int(s), int(l)) for s, l in zip(out.merged_shard[r],
                                             out.merged_local[r]) if s >= 0}


def _scored_ids(out, r: int, tables: list) -> dict:
    """One query's winners as ``{(source, doc id): natural score}``."""
    return {(int(s), str(tables[s][int(l)])): float(sc)
            for s, l, sc in zip(out.merged_shard[r], out.merged_local[r],
                                out.merged_score[r]) if s >= 0}


def same_winners(a: list, b: list, tol: float) -> int:
    """Two runs' winners (``_scored_ids`` per query) agree: equal sets, or
    sets that differ only in docs scoring within ``tol`` of their own
    set's k-th score (a near-tie bf16 rounding may swap). Returns the
    count of equal sets."""
    same = 0
    for r, (x, y) in enumerate(zip(a, b)):
        if set(x) == set(y):
            same += 1
            continue
        for mine, other in ((x, y), (y, x)):
            kth = min(mine.values())
            for key in set(mine) - set(other):
                if mine[key] - kth > tol:
                    raise AssertionError(f"query {r}: {key} scores "
                                         f"{mine[key]} against a k-th of "
                                         f"{kth} in one run only")
    return same


def _k1_step_ms(engine, q: dict, immutable: bool) -> float:
    """Device time of K1's launches of one exact step at B=512 with every
    source routed (the profiler's kernels over the four shard scans, the
    queries' casts included): over the live shards as served (the whole
    capacity, -inf holes) or, ``immutable``, over the same rows as an
    immutable shard scans them (the build-time docs, no holes)."""
    from torch.profiler import ProfilerActivity, profile

    from ragroute_tpu_torch.ops.topk import shard_topk

    calls = []
    for src, sh in zip(engine.world.sources, engine.shard_set.shards):
        bias, valid = sh.bias, sh.capacity
        if immutable:
            bias = torch.zeros_like(sh.bias)
            bias[sh.n_docs:] = float("-inf")
            valid = sh.n_docs
        qq = torch.from_numpy(q[src.encoder]).to(engine.device)
        calls.append((qq, sh, bias, valid, src.score_mode))

    def step():
        for qq, sh, bias, valid, mode in calls:
            shard_topk(qq, sh.docs, engine.world.k, mode=mode,
                       valid_docs=valid, bias=bias, scale=sh.scale,
                       center=sh.center, packed4=sh.packed4)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    before = fused_topk.launches
    reps = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    if fused_topk.launches - before != reps * len(calls):
        raise AssertionError("the profiled step did not launch K1 per shard")
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / reps


def phase_live(root: str, dev, syn) -> dict:
    """The live index through the native front end (``--frontend native
    --mutable --reserve-docs 4096``): the timed burst; ``/admin/profile``
    during a burst (its trace must name K1's kernel); ``/docs/add`` of
    rows made from the seed (twins of the check queries among them) and
    ``/docs/delete`` of half of them and of build-time winners;
    ``engine.search`` against ``exact_oracle`` over the live rows; K1's
    step time over the live shards against the immutable scan; then
    ``/admin/snapshot``, and an immutable aiohttp system reloaded from it
    must give the same winners."""
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.oracle import engine_recall
    from ragroute_tpu_torch.system import ServingSystem

    t0 = time.perf_counter()
    argv = ["--dataset", "medrag", "--routing", "ragroute", "--disable-llm",
            "--port", "0", "--data-root", root, "--device", str(dev)]
    system = ServingSystem(parse_args(argv + [
        "--frontend", "native", "--mutable", "--reserve-docs",
        str(RESERVE_DOCS)]))
    system.build()
    engine = system.server.engine
    ss = engine.shard_set
    thread = _start_native(system)
    port = system.native.bound_port
    log(f"[live] mutable world on {dev} behind the native front end on port "
        f"{port} in {time.perf_counter() - t0:.1f} s: capacities "
        f"{[s.capacity for s in ss.shards]}, {ss.total_docs} live docs, "
        f"{ss.index_bytes / 1e9:.3f} GB")
    out = {}
    try:
        reset_counts()
        bursts = surface_bursts(port, syn)
        launches = read_counts()
        report_bursts("live", "native", bursts)
        # the native loop's two host-side knobs, as notes: one step in
        # flight while the last one's answers are assembled, and no wait
        # for a fuller pop (the JAX package's defaults were read on a TPU
        # host at 512 clients)
        native = system.native
        for knobs in ({"pipeline": True}, {"fill_ms": 0},
                      {"pipeline": True, "fill_ms": 0}):
            saved = {k: getattr(native, k) for k in knobs}
            for k, v in knobs.items():
                setattr(native, k, v)
            res = surface_burst(port, syn)
            for k, v in saved.items():
                setattr(native, k, v)
            tag = ", ".join(f"{k}={v}" for k, v in knobs.items())
            log(f"[live] note: native with {tag}: {res['n']} GET /query over "
                f"{res['conns']} connections: {res['requests_per_s']:.1f} "
                f"requests/s, p50 {res['p50_ms']:.3f} ms, p99 "
                f"{res['p99_ms']:.3f} ms")
        stats = json.loads(_http(port, "GET", "/stats")[1])
        log(f"[live] /stats batch_size {stats['batch_size']} frontend "
            f"{stats['frontend']}; launches {launches}")
        if stats["batch_size"]["max"] <= 1:
            raise AssertionError("the native loop never formed a batch > 1")
        for name in PATH_KERNELS["live"]:
            if launches[name] <= 0:
                raise AssertionError(f"the live path never launched {name}")
        check_wgmma("live", launches)
        out["live"] = {"launches": launches}

        # /admin/profile over a burst, PROFILE_CAPTURES times: the engine
        # steps' kernels are in each (captures on a helper thread lost
        # them now and then). The load is timed so that it outlasts the
        # captures: a burst of a fixed count can end before a window opens
        load = start_load(port, syn, seconds=PROFILE_LOAD_S)
        time.sleep(1.0)             # the load is running
        found = []
        try:
            for _ in range(PROFILE_CAPTURES):
                pdir = tempfile.mkdtemp(prefix="ragroute_profile_")
                status, body = _http(port, "POST", "/admin/profile",
                                     {"seconds": 2.0, "dir": pdir})
                if status != 200:
                    raise AssertionError(
                        f"/admin/profile answered {status}: {body}")
                with open(os.path.join(json.loads(body)["trace_dir"],
                                       "trace.json")) as f:
                    trace = json.load(f)["traceEvents"]
                shutil.rmtree(pdir, ignore_errors=True)
                kern = {e["name"] for e in trace if e.get("cat") == "kernel"}
                k1 = sorted(n for n in kern if "topk_kernel" in n)
                found.append(any("wgmma_topk_kernel" in n for n in k1))
                log(f"[live] /admin/profile 2 s during a burst: "
                    f"{len(trace)} trace events, {len(kern)} distinct "
                    f"kernels, K1's: {[n[:60] for n in k1]}")
        finally:
            profile_load = finish_load(load)
        if not all(found):
            raise AssertionError(
                f"{found.count(False)} of {PROFILE_CAPTURES} profile traces "
                f"hold no K1 kernel (the load around them: "
                f"{profile_load['ok']} answers in "
                f"{profile_load['wall_s']:.1f} s)")

        # the live rows by slot (None: the build-time row) and each live
        # slot's payload id, kept here, apart from the server's tables
        names = [s.name for s in syn.world.sources]
        rows = {s.name: {i: None for i in range(s.n_docs)}
                for s in ss.shards}
        pid = {s.name: {i: f"{s.name}_{i}" for i in range(s.n_docs)}
               for s in ss.shards}
        deleted = set()         # payload ids of deleted docs

        def delete(si: int, slots) -> None:
            name = names[si]
            status, reply = _http(port, "POST", "/docs/delete",
                                  {"source": name, "slots": slots})
            if status != 200:
                raise AssertionError(f"/docs/delete {name}: {status} "
                                     f"{reply[:200]}")
            for sl in slots:
                deleted.add(pid[name].pop(sl))
                del rows[name][sl]

        # /docs/delete of build-time winners, round after round: winners
        # of the bursts' own queries and routing, so their payloads were
        # served and cached, and the adds then recycle their slots
        t1 = time.perf_counter()
        rounds = n_victims = 0
        while n_victims < LIVE_BUILD_DELETES:
            wide = engine.search(syn.query_embs, strategy="ragroute")
            new = list(dict.fromkeys(
                w for r in range(wide.merged_shard.shape[0])
                for w in sorted(_winners(wide, r))))
            new = new[:LIVE_BUILD_DELETES - n_victims]
            if not new:
                raise AssertionError("no build-time winners left to delete")
            for si in range(len(names)):
                if any(s == si for s, _ in new):
                    delete(si, [sl for s, sl in new if s == si])
            n_victims += len(new)
            rounds += 1
        log(f"[live] /docs/delete of {n_victims} build-time winners of the "
            f"{wide.merged_shard.shape[0]} queries in {rounds} "
            f"rounds, {(time.perf_counter() - t1) * 1e3:.1f} ms with the "
            f"searches")

        # /docs/add: rows from the seed, twins of the check queries first
        rng = np.random.default_rng(7)
        added = {}
        add_ms = {}
        for src in syn.world.sources:
            m = LIVE_ADDS[src.name]
            emb = rng.standard_normal((m, src.embed_dim)).astype(np.float32)
            emb *= float(syn.embeddings[src.name][:4096].std())
            if src.name == "pubmed":
                emb[:N_CHECK] = _twins(syn, src.name, N_CHECK)
            docs = [{"embedding": e.tolist(), "id": f"live-{src.name}-{i}",
                     "payload": {"id": f"live-{src.name}-{i}",
                                 "title": f"live {i}",
                                 "content": f"added at serve time {i}"}}
                    for i, e in enumerate(emb)]
            body = json.dumps({"source": src.name, "docs": docs})
            t1 = time.perf_counter()
            status, reply = _http(port, "POST", "/docs/add", body)
            add_ms[src.name] = (time.perf_counter() - t1) * 1e3
            if status != 200:
                raise AssertionError(f"/docs/add {src.name}: {status} "
                                     f"{reply[:200]}")
            added[src.name] = json.loads(reply)["slots"]
            for i, (sl, e) in enumerate(zip(added[src.name], emb)):
                rows[src.name][sl] = e
                pid[src.name][sl] = f"live-{src.name}-{i}"
        recycled = sum(sl < s.n_docs for s in ss.shards
                       for sl in added[s.name])
        log(f"[live] /docs/add {LIVE_ADDS} rows (JSON over HTTP, one "
            f"request a source; {recycled} into recycled slots): "
            f"{add_ms['pubmed']:.1f} ms for pubmed's "
            f"{LIVE_ADDS['pubmed']:,} rows")
        t1 = time.perf_counter()
        for si, name in enumerate(names):
            delete(si, added[name][1::2])
        log(f"[live] /docs/delete of half of the added docs in "
            f"{(time.perf_counter() - t1) * 1e3:.1f} ms; {ss.total_docs} "
            f"live docs, free slots {[ss.free_slots(n) for n in names]}")

        q = {enc: e[:N_CHECK] for enc, e in syn.query_embs.items()}
        reset_counts()
        got = engine.search(q, strategy="ragroute")
        launches = read_counts()
        oracle = live_oracle(syn, rows, q, syn.world.k, got.mask)
        recall = engine_recall(syn.world, got, oracle)
        served_slots = set().union(*[_winners(got, r)
                                     for r in range(N_CHECK)])
        free = [w for w in served_slots if w[1] not in pid[names[w[0]]]]
        served = {pid[names[si]][sl] for si, sl in served_slots
                  if sl in pid[names[si]]}
        ranked = {pid[names[si]][sl] for w in oracle for si, sl in w
                  if pid[names[si]][sl].startswith("live-")}
        # the served bodies: an added doc in a recycled slot shows its own
        # payload, never the deleted doc's cached one
        bodies = []
        for r in range(N_CHECK):
            qq = syn.questions[r]
            path = (f"/query?q={urllib.parse.quote(qq['question'])}&qid="
                    f"{qq['qid']}&choices=%7B%22A%22%3A%22a%22%7D")
            status, body = _http(port, "GET", path)
            if status != 200:
                raise AssertionError(f"/query after the updates: {status}")
            bodies.append(json.loads(body)["metadata"]["top_docs"])
        shown = {d["id"] for b in bodies for d in b}
        log(f"[live] engine.search on {N_CHECK} queries over the live rows: "
            f"recall@{syn.world.k} vs exact_oracle {recall:.6f}; added docs "
            f"the oracle ranks {len(ranked)}, of them served "
            f"{len(ranked & served)}; deleted docs served "
            f"{len(served & deleted)}, free slots served {len(free)}; "
            f"GET /query shows {len(shown)} distinct payloads, "
            f"{sum(i.startswith('live-') for i in shown)} added ones, "
            f"{len(shown & deleted)} deleted ones; launches {launches}")
        if recall < 0.99:
            raise AssertionError(f"live recall {recall} < 0.99")
        if served & deleted or free or shown & deleted:
            raise AssertionError(
                f"deleted docs served: {sorted(served & deleted)[:5]} "
                f"{free[:5]} {sorted(shown & deleted)[:5]}")
        if not ranked or ranked - served or not ranked & shown:
            raise AssertionError(f"added docs the oracle ranks not served: "
                                 f"{sorted(ranked - served)[:5]}")
        out["live"]["recall"] = recall

        # K1 over the live shards against the immutable scan, B=512 all
        q512 = {enc: e[:512] for enc, e in syn.query_embs.items()}
        k1 = {"mutable_ms": _k1_step_ms(engine, q512, False),
              "immutable_ms": _k1_step_ms(engine, q512, True)}
        log(f"[live] K1's four shard scans of a B=512 step, every source "
            f"routed (profiler device time, queries' casts included): over "
            f"the live shards {k1['mutable_ms']:.3f} ms, over the same rows "
            f"as immutable shards {k1['immutable_ms']:.3f} ms")
        out["live"]["k1_step"] = k1

        # /admin/snapshot, then a fresh immutable system from it
        t1 = time.perf_counter()
        status, reply = _http(port, "POST", "/admin/snapshot")
        snap_s = time.perf_counter() - t1
        if status != 200:
            raise AssertionError(f"/admin/snapshot: {status} {reply[:200]}")
        log(f"[live] /admin/snapshot of {ss.total_docs} live docs "
            f"(embeddings, ids, payloads) in {snap_s:.2f} s: "
            f"{json.loads(reply)['sources']}")
        out["live"]["snapshot_s"] = snap_s
        out["live"]["add_ms"] = add_ms["pubmed"]
        tables = [ss.doc_ids[n] for n in names]
        live_ids = [_scored_ids(got, r, tables) for r in range(N_CHECK)]
        tol = 1e-3 * float(np.nanmax(np.abs(got.merged_score)))
    finally:
        _stop_native(system, thread)
    del system, engine, ss
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fresh = ServingSystem(parse_args(argv))
    fresh.build()
    eng = fresh.server.engine
    new = eng.search(q, strategy="ragroute")
    tables = [eng.shard_set.doc_ids[n] for n in names]
    # bf16 rows centred on another mean (the snapshot's) may swap a
    # near-tie at the k-th place, within 1e-3 x max|score|
    same = same_winners(live_ids, [_scored_ids(new, r, tables)
                                   for r in range(N_CHECK)], tol)
    log(f"[live] an immutable aiohttp system reloaded from the snapshot in "
        f"{time.perf_counter() - t0:.1f} s ({eng.shard_set.total_docs} docs) "
        f"gives the live winner sets on {same} of {N_CHECK} queries, the "
        f"rest near-ties at the k-th place")
    out["live"]["reload_same"] = same
    del fresh, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_surface(root: str, dev, syn) -> dict:
    """The rest of the serving surface over phase 3's world: two
    SO_REUSEPORT workers, then the live index (which ends by writing its
    snapshot over the world)."""
    out = phase_workers(root, dev, syn)
    out.update(phase_live(root, dev, syn))
    log("[surface] timed bursts: " + ", ".join(
        f"{k} {v['requests_per_s']:.1f} req/s p50 {v['p50_ms']:.3f} ms p99 "
        f"{v['p99_ms']:.3f} ms" for k, v in BURSTS.items()))
    return out


def phase_live_quant(dev) -> None:
    """Live rewrites of int8 rows (per-doc scales) and packed int4 rows
    (per-group scales at d=768) on a reduced world (4 x 32,768 docs):
    adds (twins of the check queries among them) and deletes through the
    Python API, then ``engine.search`` against ``exact_oracle`` over the
    live rows at the JAX package's gates."""
    from ragroute_tpu_torch.engine import FederatedSearchEngine
    from ragroute_tpu_torch.index import ShardSet
    from ragroute_tpu_torch.index.synthetic import make_synthetic_world
    from ragroute_tpu_torch.oracle import engine_recall
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    syn = make_synthetic_world("medrag", docs_per_source=REDUCED_DOCS,
                               num_queries=N_CHECK, seed=5)
    router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev)
    bank = RouterBank.create(syn.world, syn.centroids, device=dev)
    q = syn.query_embs
    names = [s.name for s in syn.world.sources]
    for dtype, gate in LIVE_QUANT_GATES.items():
        ss = ShardSet.build(syn.world, syn.embeddings, doc_ids=syn.doc_ids,
                            dtype="int4" if dtype == "int4" else torch.int8,
                            device=dev, mutable=True, reserve_docs=1024)
        engine = FederatedSearchEngine(ss, router, bank)
        before = engine.search(q, strategy="all")
        victims = list(dict.fromkeys(
            w for r in range(N_CHECK)
            for w in sorted(_winners(before, r))))[:256]
        rng = np.random.default_rng(3)
        rows = {s.name: {i: None for i in range(s.n_docs)}
                for s in ss.shards}
        added = {}
        for src in syn.world.sources:
            emb = rng.standard_normal((512, src.embed_dim)).astype(
                np.float32) * float(syn.embeddings[src.name].std())
            if src.name == "pubmed":
                emb[:N_CHECK] = _twins(syn, src.name, N_CHECK)
            added[src.name] = engine.add_docs(
                src.name, emb, [f"live-{i}" for i in range(512)])
            for sl, e in zip(added[src.name], emb):
                rows[src.name][sl] = e
        deleted = set()
        for si, name in enumerate(names):
            slots = added[name][1::2] + [sl for s, sl in victims if s == si]
            engine.delete_docs(name, slots=slots)
            for sl in slots:
                del rows[name][sl]
                deleted.add((si, sl))
        reset_counts()
        got = engine.search(q, strategy="all")
        launches = read_counts()
        oracle = live_oracle(syn, rows, q, syn.world.k, got.mask)
        recall = engine_recall(syn.world, got, oracle)
        served = set().union(*[_winners(got, r) for r in range(N_CHECK)])
        scales = [tuple(s.scale.shape) for s in ss.shards]
        log(f"[live:{dtype}] 4 x {REDUCED_DOCS} docs, 512 added a source and "
            f"half of them and {len(victims)} build-time winners deleted: "
            f"recall@{syn.world.k} vs exact_oracle over the live rows "
            f"{recall:.6f} (gate {gate}); deleted docs served "
            f"{len(served & deleted)}; scales {scales}; wgmma launches "
            f"{launches['wgmma']['fused_topk']}")
        if recall < gate or served & deleted:
            raise AssertionError(f"live {dtype}: recall {recall}, deleted "
                                 f"served {len(served & deleted)}")
        if dtype == "int4" and any(len(s) != 2 for s in scales):
            raise AssertionError("int4 rows without per-group scales")
        if launches["wgmma"]["fused_topk"] <= 0:
            raise AssertionError(f"live {dtype}: K1's scan never launched")
        del ss, engine, got, before
        gc.collect()
        torch.cuda.empty_cache()


# ---- phase 4: a reduced topical world ---------------------------------------

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
    reset_counts()
    full = search(eng)
    exact = search(FederatedSearchEngine(eng.shard_set, router, bank))
    # the f32 ivf run through K3's f32 kernel (K1 at these 64 queries takes
    # its first design: fused_topk.f32_scan_pays)
    if grouped_gains.f32_launches < 4:
        raise AssertionError(f"the f32 ivf run did not take K3's f32 "
                             f"kernel: {read_counts()}")
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


# ---- phase 5: the host-RAM capacity tiers -----------------------------------

def phase_reduced_tiers(dev) -> None:
    """The tiers on a reduced topical int8 world, against the flat engine
    and the flat coarse scan on the card."""
    from ragroute_tpu_torch.engine import FederatedSearchEngine
    from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine
    from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
    from ragroute_tpu_torch.index.streamed import StreamedShardSet
    from ragroute_tpu_torch.oracle import engine_recall
    from ragroute_tpu_torch.ops.grouped_topk import (cluster_coarse_slab,
                                                     coarse_probe_topk)
    from ragroute_tpu_torch.ops.topk import shard_topk
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    syn = make_synthetic_world("medrag", docs_per_source=REDUCED_DOCS,
                               num_queries=N_CHECK, seed=5,
                               with_payloads=False, subclusters=64)
    q = dict(syn.query_embs)
    router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev)
    bank = RouterBank.create(syn.world, syn.centroids, device=dev)
    flat = FederatedSearchEngine(
        ShardSet.build(syn.world, syn.embeddings, dtype=torch.int8,
                       device=dev), router, bank)
    row_b = 768 + 8
    sset = StreamedShardSet.build(
        syn.world, syn.embeddings, dtype=torch.int8, tier="stream",
        hbm_budget_bytes=4 * 8192 * row_b, slab_bytes=8192 * row_b,
        device=dev)
    slabs = [s.n_slabs for s in sset.sources]
    reset_counts()
    for strategy in ("all", "ragroute"):
        a = flat.search(q, strategy=strategy)
        b = StreamedSearchEngine(sset, router, bank).search(
            q, strategy=strategy)
        ok = a.merged_shard >= 0
        if not (np.array_equal(a.mask, b.mask)
                and np.array_equal(a.merged_shard, b.merged_shard)
                and np.array_equal(np.where(ok, a.merged_local, -1),
                                   np.where(ok, b.merged_local, -1))
                and np.allclose(np.where(ok, a.merged_score, 0.0),
                                np.where(ok, b.merged_score, 0.0),
                                rtol=2e-4, atol=2e-4)):
            raise AssertionError(
                f"stream tier != flat int8 engine (routing {strategy})")
    log(f"[reduced] stream tier, int8, 4 x {REDUCED_DOCS} docs, resident "
        f"prefix 8192 rows + {slabs} slabs of 8192 rows: merged ids and "
        f"order equal the flat int8 engine's, scores within 2e-4 (routing "
        f"all and ragroute); fused_topk launches {fused_topk.launches}")
    if fused_topk.launches < 2 * (4 + sum(slabs)):
        raise AssertionError("the slab scans did not run the kernel")

    # the same tier through StreamedShardSet.load, as ``python -m
    # ragroute_tpu_torch.main --impl stream`` builds it: from the
    # embeddings.npy mmaps of a saved world
    root = tempfile.mkdtemp(prefix="ragroute_smoke_")
    try:
        for src in syn.world.sources:
            ShardSet.save_source(root, syn.world.name, src.name,
                                 syn.embeddings[src.name])
        lset = StreamedShardSet.load(
            root, syn.world, dtype=torch.int8, tier="stream",
            hbm_budget_bytes=4 * 8192 * row_b, slab_bytes=8192 * row_b,
            device=dev)
        c = StreamedSearchEngine(lset, router, bank).search(
            q, strategy="ragroute")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not (np.array_equal(b.merged_shard, c.merged_shard)
            and np.array_equal(b.merged_local, c.merged_local)
            and np.array_equal(b.merged_score, c.merged_score)):
        raise AssertionError("the stream tier loaded from embeddings.npy "
                             "differs from the one built from the arrays")
    log(f"[reduced] stream tier loaded from the saved world's embeddings.npy "
        f"mmaps ({[s.n_slabs for s in lset.sources]} slabs): ids and scores "
        f"equal the built tier's")
    del lset

    hset = StreamedShardSet.build(
        syn.world, syn.embeddings, dtype=torch.int8, tier="hostrefine",
        hbm_budget_bytes=0, device=dev)
    want = _winner_sets(flat.search(q, strategy="all"))
    out = StreamedSearchEngine(hset, router, bank).search(
        q, strategy="all", fetch_candidates=False)
    r = engine_recall(syn.world, out, want)
    log(f"[reduced] hostrefine, flat coarse scan at rank "
        f"{hset.sources[0].rank}, k' = 128: recall@{syn.world.k} {r:.6f} of "
        f"the flat int8 engine (gate 0.95)")
    if r < 0.95:
        raise AssertionError(f"hostrefine flat: recall {r} < 0.95")

    # the probed scan at nprobe == C, kappa >= k' against the flat coarse
    # scan: a true miss is a flat-scan candidate clearly better than the
    # worst kept key (beyond the summation noise of the two layouts)
    st = hset.sources[0]
    n, kp = st.n_docs, 256        # --refine-mult 8: K4's deep ranks
    cc = cluster_coarse_slab(st.coarse_docs[:n].cpu().numpy(),
                             st.coarse_scale[:n].cpu().numpy(),
                             st.coarse_bias[:n].cpu().numpy(), 0,
                             n_clusters=64, device=dev)
    qt = torch.from_numpy(q[syn.world.sources[0].encoder]).to(dev) @ st.basis
    reset_counts()
    keys, gid = coarse_probe_topk(qt, cc, kp, nprobe=cc.n_clusters, kappa=kp)
    rs, ri = shard_topk(qt, st.coarse_docs, kp, mode="dot",
                        bias=st.coarse_bias, scale=st.coarse_scale)
    launches = read_counts()
    keys, gid, rs, ri = (t.cpu().numpy() for t in (keys, gid, rs, ri))
    missed = swaps = 0
    for row in range(qt.shape[0]):
        tol = 1e-3 * max(1.0, abs(float(keys[row][-1])))
        got = set(gid[row][gid[row] >= 0].tolist())
        for j, doc in enumerate(ri[row].tolist()):
            if doc not in got:
                swaps += 1
                missed += rs[row][j] > keys[row][-1] + tol
    log(f"[reduced] coarse_probe_topk at nprobe == C == {cc.n_clusters} "
        f"(S={cc.capacity}), kappa = k' = {kp} against the flat coarse scan "
        f"over {n} rows: {missed} true misses, {swaps} boundary near-ties "
        f"swapped; launches {launches}")
    if missed or launches["grouped_pair_topk"] != 1 \
            or launches["stream_topk"] != 1 or launches["fused_topk"] != 1 \
            or launches["deep"] != {"fused_topk": 1, "stream_topk": 1,
                                    "grouped_pair_topk": 1}:
        raise AssertionError("the full probe disagrees with the flat scan")
    del flat, sset, hset, cc
    gc.collect()
    torch.cuda.empty_cache()


def _running_topk(qd, blocks, k: int):
    """Exact top-k of ``gains(rows)`` over ``(offset, gains_fn)`` blocks: a
    stable running list, ties to the lower doc."""
    from ragroute_tpu_torch.ops.topk import merge_topk, topk_stable

    run_s = torch.full((qd.shape[0], k), float("-inf"), device=qd.device)
    run_i = torch.zeros((qd.shape[0], k), dtype=torch.int64, device=qd.device)
    for offset, gains in blocks:
        s, i = topk_stable(gains, k)
        run_s, run_i = merge_topk(run_s, run_i, s, i + offset, k)
    return run_s.cpu().numpy(), run_i.cpu().numpy()


def _merge_sources(per, mask: np.ndarray, k: int) -> list:
    """The oracle's merge: the top-k of the routed sources' k-lists."""
    out = []
    for row in range(mask.shape[0]):
        cands = []
        for si, (s, i) in enumerate(per):
            if mask[row, si]:
                cands.extend((float(s[row, j]), si, int(i[row, j]))
                             for j in range(k))
        cands.sort(key=lambda t: -t[0])
        out.append({(si, li) for _, si, li in cands[:k]})
    return out


def streamed_oracle(syn, q: dict, k: int, mask: np.ndarray, dev) -> list:
    """``exact_oracle`` over rows that are never held whole: every source's
    generated f32 rows are scored block by block on the card in full f32,
    then the per-source lists merge as the oracle's do. A few blocks are
    generated ahead in threads. Returns the winner set per query."""
    import collections
    import concurrent.futures

    block, ahead = 1 << 18, 4
    per = []
    with concurrent.futures.ThreadPoolExecutor(ahead) as pool:
        for src in syn.world.sources:
            rs = syn.row_sources[src.name]
            qd = torch.from_numpy(q[src.encoder]).to(dev)
            spans = [(a, min(a + block, rs.n_docs))
                     for a in range(0, rs.n_docs, block)]

            def blocks():
                queue = collections.deque()
                for span in spans + [None] * ahead:
                    if span is not None:
                        queue.append((span[0], pool.submit(rs.get, *span)))
                    if len(queue) == ahead or (span is None and queue):
                        a, fut = queue.popleft()
                        rows = torch.from_numpy(fut.result()).to(dev)
                        yield a, qd @ rows.T

            per.append(_running_topk(qd, blocks(), k))
    return _merge_sources(per, mask, k)


def stored_oracle(sset, q: dict, k: int, mask: np.ndarray, dev,
                  round_queries: bool = False) -> list:
    """The exact winners of the STORED bytes of a stream-tier shard set
    (dot sources): every resident and host row dequantized and scored in
    f32 on the card, the centring constant restored per source.
    ``round_queries`` rounds the queries to bf16 first, as the card's scan
    of an int8 shard does."""
    block = 1 << 18
    per = []
    for st in sset.sources:
        assert st.score_mode == "dot"
        qd = torch.from_numpy(q[st.encoder]).to(dev)
        if round_queries:
            qd = qd.to(torch.bfloat16).to(torch.float32)
        parts = [(0, st.res_docs[:st.n_res], st.res_scale[:st.n_res],
                  st.res_bias[:st.n_res])]
        if st.host is not None:
            codes, bias, scale = st.host.tensors
            n_host = st.n_docs - st.host_row0
            parts.append((st.host_row0, codes[:n_host], scale[:n_host],
                          bias[:n_host]))

        def blocks():
            for row0, codes, scale, bias in parts:
                for a in range(0, codes.shape[0], block):
                    rows = codes[a:a + block].to(dev).to(torch.float32)
                    yield row0 + a, ((qd @ rows.T)
                                     * scale[a:a + block].to(dev)[None, :]
                                     + bias[a:a + block].to(dev)[None, :])

        s, i = _running_topk(qd, blocks(), k)
        if st.center is not None:
            s = s + (q[st.encoder] @ st.center)[:, None]
        per.append((s, i))
    return _merge_sources(per, mask, k)


async def _burst(port: int, qs, n: int) -> float:
    """Wall seconds of ``n`` concurrent GET /query (all must answer 200)."""
    import aiohttp

    conn = aiohttp.TCPConnector(limit=0)
    async with aiohttp.ClientSession(connector=conn) as s:
        t0 = time.perf_counter()
        answers = await asyncio.gather(*[
            _get_query(s, port, qs[i % len(qs)]["qid"],
                       qs[i % len(qs)]["question"]) for i in range(n)])
        wall = time.perf_counter() - t0
    bad = [a for a in answers if a[0] != 200]
    if bad:
        raise AssertionError(f"bad /query answers in the burst: {bad[:3]}")
    return wall


async def _drive_tier(system, syn, k: int, label: str,
                      burst: bool = True) -> dict:
    """The served path of a host tier: the sequential and concurrent
    requests of every path, then (hostrefine, with ``burst``) the pipelined
    burst."""
    launches = await _drive(system, syn, k, label, stop=False)
    server = system.server
    try:
        engine = server.engine
        log(f"[serve:{label}] last_phases {engine.last_phases}")
        if burst and engine.supports_pipelined_dispatch:
            port, qs = server.bound_port, syn.questions
            batcher = server.batcher
            await _burst(port, qs, TIER_BURST)          # warm the connections
            piped = await _burst(port, qs, TIER_BURST)
            await batcher.stop()
            engine.supports_pipelined_dispatch = False  # the plain worker
            await batcher.start()
            seq = await _burst(port, qs, TIER_BURST)
            await batcher.stop()
            engine.supports_pipelined_dispatch = True
            await batcher.start()
            log(f"[serve:{label}] burst of {TIER_BURST} concurrent GET "
                f"/query (buckets up to {batcher.buckets[-1]}, so at least "
                f"two batches): pipelined worker {piped:.3f} s, sequential "
                f"worker {seq:.3f} s")
    finally:
        await system.stop()
    return launches


def serve_tier(root: str, dev, syn, label: str, impl: str,
               cluster_min_docs: int, oracle: dict, deep: str = None) -> dict:
    """Build one host tier's ServingSystem from the CLI's flags (the rows
    come from the world's block generator), drive it over HTTP and hold
    ``engine.search`` against the exact f32 oracle. ``deep``: then run that
    ``--refine-mult 8`` label on the same engine (:func:`deep_rerun`; its
    pipelined burst is the default-depth run's). Returns ``{label:
    result}`` for both."""
    flags = ()
    from ragroute_tpu_torch import config as cfg
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.oracle import engine_recall
    from ragroute_tpu_torch.system import ServingSystem

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the value RAGROUTE_HOSTREFINE_CLUSTER_MIN_DOCS sets at start-up
    cfg.HOSTREFINE_CLUSTER_MIN_DOCS = cluster_min_docs
    try:
        system = ServingSystem(parse_args([
            "--dataset", "medrag", "--routing", "ragroute", "--disable-llm",
            "--port", "0", "--data-root", root, "--device", str(dev),
            "--dtype", "int8", "--impl", impl, "--hbm-budget-gb",
            str(SMOKE_TIER_BUDGET_GB), *flags]), row_sources=syn.row_sources)
        system.build()
    finally:
        cfg.HOSTREFINE_CLUSTER_MIN_DOCS = 0
    engine = system.server.engine
    ss = engine.shard_set
    log(f"[world:{label}] built in {time.perf_counter() - t0:.1f} s: "
        f"{ss.index_bytes / 1e9:.3f} GB on the card, {ss.host_bytes / 1e9:.3f}"
        f" GB of host rows")
    for s in ss.sources:
        what = (f"coarse rank {s.rank} clustered C={s.coarse_cl.n_clusters} "
                f"S={s.coarse_cl.capacity}" if s.coarse_cl is not None
                else f"coarse rank {s.rank} flat" if s.rank
                else f"{s.n_slabs} slabs of {s.slab_rows} rows" if s.n_slabs
                else "resident")
        log(f"[world:{label}] {s.name}: {s.n_docs} docs, {s.n_res} resident "
            f"rows, {what}")
    # the shapes phase 2 held the fused kernel to are the ones this path
    # gives it
    big = ss.sources[0]
    if label == "stream" and big.slab_rows != TIER_SLAB_ROWS:
        raise AssertionError(f"slabs of {big.slab_rows} rows, the kernel "
                             f"check assumed {TIER_SLAB_ROWS}")
    if label.startswith("hostrefine") and "probed" not in label and tuple(
            big.coarse_docs.shape) != (
            -(-SMOKE_TIER_DOCS["pubmed"] // 512) * 512, 128):
        raise AssertionError(f"coarse slab {tuple(big.coarse_docs.shape)} "
                             f"differs from the kernel check's shape")
    launches = asyncio.run(_drive_tier(system, syn, syn.world.k, label,
                                       burst=not flags))
    log(f"[serve:{label}] kernel launches on the served path: {launches}")
    for name in PATH_KERNELS[label]:
        if launches[name] <= 0:
            raise AssertionError(
                f"the {label} path never launched the {name} kernel")
    if "probed" not in label and launches["grouped_pair_topk"]:
        raise AssertionError(f"the {label} path ran the probed scan")
    check_wgmma(label, launches)

    q = {enc: e[:N_CHECK] for enc, e in syn.query_embs.items()}
    out = engine.search(q, strategy="ragroute", fetch_candidates=False)
    if not oracle:       # once: the three paths route alike
        t0 = time.perf_counter()
        oracle.update(mask=out.mask, winners=streamed_oracle(
            syn, q, syn.world.k, out.mask, dev))
        log(f"[oracle] exact f32 winners of {N_CHECK} queries over the "
            f"generated rows in {time.perf_counter() - t0:.1f} s")
    if not np.array_equal(oracle["mask"], out.mask):
        raise AssertionError(f"{label}: the routing mask changed")
    recall = engine_recall(syn.world, out, oracle["winners"])
    gate = TIER_GATES[label]
    log(f"[oracle:{label}] engine.search on {N_CHECK} queries: routed per "
        f"source {out.mask.sum(axis=0).tolist()}, recall@{syn.world.k} vs the "
        f"exact f32 oracle {recall:.6f} (gate {gate}); last_phases "
        f"{engine.last_phases}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    valid = out.merged_shard >= 0
    n_docs = np.array([s.n_docs for s in ss.sources])
    if (out.merged_local[valid] < 0).any() or (
            out.merged_local[valid] >= n_docs[out.merged_shard[valid]]).any():
        raise AssertionError(f"{label}: doc ids out of range")
    if recall < gate:
        raise AssertionError(
            f"{label}: recall {recall} < {gate} vs the exact f32 oracle")
    if label == "stream":
        # where the loss against the f32 oracle comes from: the exact
        # winners of the stored int8 rows, a plain f32 scan of the
        # dequantized bytes, with f32 queries and with queries rounded to
        # bf16 as the card's scan rounds them, each held against the f32
        # oracle; the tier must return the winners of its own bytes
        t0 = time.perf_counter()
        kk = syn.world.k
        stored_w = stored_oracle(ss, q, kk, out.mask, dev)
        rounded_w = stored_oracle(ss, q, kk, out.mask, dev,
                                  round_queries=True)

        def share(got, want):
            return float(np.mean([len(g & w) / len(w) if w else 1.0
                                  for g, w in zip(got, want)]))

        stored = engine_recall(syn.world, out, stored_w)
        rounded = engine_recall(syn.world, out, rounded_w)
        log(f"[oracle:stream] flat f32 scan of the stored int8 rows vs the "
            f"exact f32 oracle: recall@{kk} "
            f"{share(stored_w, oracle['winners']):.6f} with f32 queries, "
            f"{share(rounded_w, oracle['winners']):.6f} with bf16-rounded "
            f"queries (the quantisation's loss, no tier involved)")
        log(f"[oracle:stream] the tier vs the exact winners of its stored "
            f"bytes: recall@{kk} {stored:.6f} with f32 queries (gate "
            f"{STREAM_STORED_GATE}), {rounded:.6f} with bf16-rounded queries "
            f"(gate {STREAM_STORED_GATE}), in {time.perf_counter() - t0:.1f} s")
        if min(stored, rounded) < STREAM_STORED_GATE:
            raise AssertionError(
                f"stream: recall {stored} / {rounded} vs its own bytes")
    res = {label: {"launches": launches, "recall": recall}}
    if deep:
        res[deep] = deep_rerun(engine, syn, deep, oracle["winners"])
    del system, engine, ss, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_tiers(dev) -> dict:
    """Serve the 1.05 M-doc int8 world through the three host-tier paths."""
    from ragroute_tpu_torch.index.synthetic import make_streamed_world

    n_docs = sum(SMOKE_TIER_DOCS.values())
    syn = make_streamed_world("medrag", docs_per_source_map=SMOKE_TIER_DOCS,
                              num_queries=NUM_QUERIES, seed=0,
                              subclusters=IVF_TOPICS)
    root = tempfile.mkdtemp(prefix="ragroute_smoke_")
    out, oracle = {}, {}
    try:
        # what the system reads beside the rows: centroids and the query
        # table (no router checkpoint: seed 0, as on the other paths)
        wroot = os.path.join(root, "medrag")
        os.makedirs(os.path.join(wroot, "queries"))
        with open(os.path.join(wroot, "centroids.json"), "w") as f:
            json.dump({n: v.tolist() for n, v in syn.centroids.items()}, f)
        encoders = list(syn.world.encoders)
        with open(os.path.join(wroot, "queries", "encoders.json"), "w") as f:
            json.dump(encoders, f)
        with open(os.path.join(wroot, "queries", "qids.json"), "w") as f:
            json.dump([qq["qid"] for qq in syn.questions], f)
        for i, enc in enumerate(encoders):
            np.save(os.path.join(wroot, "queries", f"enc_{i}.npy"),
                    syn.query_embs[enc])
        log(f"[world] medrag {n_docs} docs x 768, {IVF_TOPICS} topics per "
            f"source, rows made block by block from the seed; int8, "
            f"--hbm-budget-gb {SMOKE_TIER_BUDGET_GB}")
        for label, impl, cluster_min, deep in (
                ("stream", "stream", 0, None),
                ("hostrefine", "hostrefine", 0, "hostrefine_deep"),
                ("hostrefine_probed", "hostrefine", PROBED_CLUSTER_MIN,
                 "hostrefine_probed_deep")):
            out.update(serve_tier(root, dev, syn, label, impl, cluster_min,
                                  oracle, deep))
            if deep:
                check_deep(deep, out[deep]["launches"],
                           out[deep]["recall"], out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 6: on-card generation (--llm-backend jax) ------------------------

GEN_DOCS = 8_192         # docs per source of the world generation serves over
GEN_REQUESTS = 16        # concurrent GET /query per served Qwen3-8B service
GEN_DEMO_REQUESTS = 4    # GET /query through the demo decoder
GEN_MAX_NEW = 32         # --llm-max-new of every served generation run
PARITY_STEPS = 16        # greedy steps of the two-layer f32 parity check
NEAR_TIE = 1e-5          # plain top-two logits this close (relative) may swap
# the 36-layer bf16 prefill's logits, kernel against plain version: bf16
# activations are rounded after each of the 253 products, so one rounding
# that lands the other way moves every later layer
PREFILL_LOGIT_TOL = 0.05  # of max |logit|


def cpu_copy(params):
    """The decoder's weights copied to the host: on CPU tensors every int4
    product runs K5's plain version (the parity checks' reference path)."""
    return copy.deepcopy(params).cpu()


def check_sse(bodies, k: int, label: str) -> None:
    """SSE answers with generation on: each ends in ``[DONE]``, generated
    (``generate_time`` > 0), its deltas joined are a prefix of the final
    event's answer (one delta at least where the answer is not empty), and
    the final event's ``top_docs`` has k entries where the router sent the
    query somewhere."""
    full = 0
    for body in bodies:
        events = [e[len("data: "):] for e in body.split("\n\n")
                  if e.startswith("data: ")]
        if events[-1] != "[DONE]":
            raise AssertionError(f"{label}: an SSE stream without [DONE]")
        final = json.loads(events[-2])
        deltas = [json.loads(e)["delta"] for e in events[:-2]]
        # random weights behind the byte tokenizer mostly draw ids past
        # its 256 bytes, which decode to nothing: an answer may be empty
        if (not final["answer"].startswith("".join(deltas))
                or (final["answer"] and not deltas)
                or not final["metadata"]["generate_time"] > 0):
            raise AssertionError(f"{label}: deltas {deltas[:3]} against "
                                 f"answer {final.get('answer')!r:.80}, "
                                 f"generate_time "
                                 f"{final['metadata']['generate_time']}")
        n_docs = len(final["metadata"]["top_docs"])
        if n_docs != (k if final["metadata"]["data_sources"] else 0):
            raise AssertionError(f"{label}: {n_docs} top_docs")
        full += n_docs == k
    if not full:
        raise AssertionError(f"{label}: no SSE answer carried docs")
    log(f"[sse:{label}] {len(bodies)} concurrent stream=1 answers: each "
        f"ends in [DONE] after generating, deltas joined a prefix of the "
        f"final answer, {full} with {k} top_docs")


async def _drive_generation(system, syn, n: int, sse: bool = False) -> dict:
    """``n`` concurrent GET /query with generation on. Every answer must be
    200 with a generated answer: the LLM client turns a failed or timed-out
    generation into an answer that starts with "Error generat" and a
    ``generate_time`` of -1 or the time to the failure, so both are held.
    ``sse``: then :data:`SSE_REQUESTS` concurrent ``stream=1`` requests."""
    import aiohttp

    await system.start()
    try:
        port = system.server.bound_port
        qs = syn.questions
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://127.0.0.1:{port}/stats") as r:
                before = (await r.json())["llm"]["generated_tokens"]
            reset_counts()          # count the served generation's launches
            t0 = time.perf_counter()
            answers = await asyncio.gather(*[
                _get_query(s, port, qs[i]["qid"], qs[i]["question"])
                for i in range(n)])
            wall = time.perf_counter() - t0
            launches = read_counts()
            async with s.get(f"http://127.0.0.1:{port}/stats") as r:
                stats = await r.json()
            if sse:
                async def stream(i):
                    params = {"q": qs[i]["question"], "qid": qs[i]["qid"],
                              "choices": json.dumps({"A": "a", "B": "b"}),
                              "stream": "1"}
                    async with s.get(f"http://127.0.0.1:{port}/query",
                                     params=params) as r:
                        return await r.text()
                check_sse(await asyncio.gather(*[
                    stream(i) for i in range(SSE_REQUESTS)]),
                    syn.world.k, "aiohttp")
    finally:
        await system.stop()
    bad = [a for a in answers if a[0] != 200
           or not isinstance(a[1].get("answer"), str)
           or a[1]["answer"].startswith("Error generat")
           or not a[1]["metadata"]["generate_time"] > 0]
    if bad:
        raise AssertionError(f"{len(bad)} of {n} /query answers with "
                             f"generation failed: {bad[:3]}")
    return {"answers": [a[1]["answer"] for a in answers], "wall_s": wall,
            "launches": launches, "llm": stats["llm"],
            "tokens": stats["llm"]["generated_tokens"] - before}


def serve_generation(root: str, dev, syn, label: str, flags, n: int,
                     max_new: int, weights=None, sse: bool = False) -> dict:
    """Build the ServingSystem as ``python -m ragroute_tpu_torch.main
    --dataset medrag --llm-backend jax --llm-max-new <max_new> ...`` does
    (``weights``: a decoder the caller holds on the card, served in place
    of the demo one) and drive ``n`` concurrent requests through it. The
    requests must generate at least half their budget on average (a random
    decoder rarely draws its eos; every served run so far generated all of
    it)."""
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.system import ServingSystem

    system = ServingSystem(parse_args([
        "--dataset", "medrag", "--routing", "ragroute", "--llm-backend",
        "jax", "--port", "0", "--data-root", root, "--device", str(dev),
        "--llm-max-new", str(max_new), *flags]), llm_weights=weights)
    res = asyncio.run(_drive_generation(system, syn, n, sse))
    tok_s = res["tokens"] / res["wall_s"]
    log(f"[llm:{label}] {n} concurrent GET /query with generation answered "
        f"200 in {res['wall_s']:.3f} s: {res['tokens']} tokens generated "
        f"({tok_s:.1f} tokens/s), /stats llm {res['llm']}, "
        f"{sum(1 for a in res['answers'] if a)} non-empty answers; "
        f"launches {res['launches']}")
    if res["tokens"] < n * max_new // 2:
        raise AssertionError(f"{label}: {res['tokens']} tokens for {n} "
                             f"requests of budget {max_new}")
    res["tokens_per_s"] = tok_s
    del system
    gc.collect()
    torch.cuda.empty_cache()
    return res


def native_sse(root: str, dev, syn) -> None:
    """:data:`SSE_REQUESTS` concurrent ``stream=1`` requests through the
    native front end (``--frontend native --llm-backend jax``, the demo
    decoder): the deltas go out as chunked frames from the finisher loop."""
    import threading

    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.system import ServingSystem

    system = ServingSystem(parse_args([
        "--dataset", "medrag", "--routing", "ragroute", "--llm-backend",
        "jax", "--frontend", "native", "--port", "0", "--data-root", root,
        "--device", str(dev), "--llm-max-new", str(GEN_MAX_NEW)]))
    system.build()
    thread = _start_native(system)
    port = system.native.bound_port
    bodies = [None] * SSE_REQUESTS
    try:
        def one(i):
            q = syn.questions[i]
            path = (f"/query?q={urllib.parse.quote(q['question'])}&qid="
                    f"{q['qid']}&choices=%7B%22A%22%3A%22a%22%7D&stream=1")
            status, body = _http(port, "GET", path)
            bodies[i] = body.decode() if status == 200 else f"{status}"

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(SSE_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check_sse(bodies, syn.world.k, "native")
    finally:
        asyncio.run_coroutine_threadsafe(
            system.server.llm.service.stop(),
            system.native._fin_loop).result(60)
        _stop_native(system, thread)
    del system
    gc.collect()
    torch.cuda.empty_cache()


def _greedy_parity(params, cfg, dev, *, bsz: int = 4, p: int = 64) -> dict:
    """The kernel path on the card against the plain path on a host copy of
    the weights, in lockstep over ``PARITY_STEPS`` greedy steps, each fed
    the plain path's token: the argmax must agree except where the plain
    path's top two logits are within ``NEAR_TIE`` of each other (counted)."""
    from ragroute_tpu_torch.llm.model import decode_step, init_cache, prefill

    host = torch.device("cpu")
    plain = cpu_copy(params)
    gen = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (bsz, p), generator=gen,
                        device=dev, dtype=torch.int32)
    mask = torch.ones_like(ids)
    mask[1, :p // 2] = 0                      # one left-padded row
    lengths = mask.sum(dim=1, dtype=torch.int32)
    same = near = 0
    err = 0.0
    with torch.no_grad():
        lk, ck = prefill(params, cfg, ids, mask, init_cache(
            cfg, bsz, p + PARITY_STEPS, torch.float32, dev))
        lp, cp = prefill(plain, cfg, ids.cpu(), mask.cpu(), init_cache(
            cfg, bsz, p + PARITY_STEPS, torch.float32, host))
        for t in range(PARITY_STEPS):
            lk = lk.cpu()
            err = max(err, float((lk - lp).abs().max()))
            tk, tp = torch.argmax(lk, -1), torch.argmax(lp, -1)
            top2 = torch.topk(lp, 2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]) / top2[:, 0].abs().clamp_min(
                1e-30)
            for r in range(bsz):
                if int(tk[r]) == int(tp[r]):
                    same += 1
                elif float(gap[r]) <= NEAR_TIE:
                    near += 1
                else:
                    raise AssertionError(
                        f"parity: step {t} row {r}: kernel token "
                        f"{int(tk[r])} != plain {int(tp[r])} with a top-two "
                        f"gap of {float(gap[r]):.3e}")
            tok = tp.to(torch.int32)
            lk, ck = decode_step(params, cfg, ck, tok.to(dev), lengths, p, t)
            lp, cp = decode_step(plain, cfg, cp, tok, lengths.cpu(), p, t)
    return {"same": same, "near_ties": near, "max_logit_err": err}


def _prefill_logits(params, cfg, dev, *, bsz: int = 4, p: int = 128):
    """Last-position prefill logits through the kernel on the card and
    through the plain version on a host copy, on the same random prompts."""
    from ragroute_tpu_torch.llm.model import init_cache, prefill

    gen = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (bsz, p), generator=gen,
                        device=dev, dtype=torch.int32)
    mask = torch.ones_like(ids)
    out = []
    with torch.no_grad():
        for w, d in ((params, dev), (cpu_copy(params), torch.device("cpu"))):
            cache = init_cache(cfg, bsz, p, torch.bfloat16, d)
            out.append(prefill(w, cfg, ids.to(d), mask.to(d), cache)[0].cpu())
    return out


def phase_generation(dev, smi: str) -> dict:
    """Serve generation over a small medrag world: the demo decoder as the
    CLI builds it, then Qwen3-8B at full width with random int4 weights and
    an int8 KV cache through the lockstep and the continuous services; the
    decode step's time and profile; the kernel path against the plain
    version at full width."""
    from ragroute_tpu_torch.index.synthetic import (make_synthetic_world,
                                                    save_world)
    from ragroute_tpu_torch.llm.service import ByteTokenizer
    from ragroute_tpu_torch.llm.shapes import QWEN3_8B, quantized_from_masters
    from ragroute_tpu_torch.measure import (LLM_BATCH, LLM_PROMPT,
                                            decode_step_breakdown,
                                            prefill_breakdown,
                                            print_decode_breakdown)

    out = {}
    root = tempfile.mkdtemp(prefix="ragroute_smoke_llm_")
    try:
        t0 = time.perf_counter()
        syn = make_synthetic_world("medrag", docs_per_source=GEN_DOCS,
                                   num_queries=64, seed=0)
        save_world(syn, root)
        log(f"[world] medrag {4 * GEN_DOCS} docs x 768 for generation made "
            f"and saved in {time.perf_counter() - t0:.1f} s")
        demo = serve_generation(root, dev, syn, "demo", [],
                                GEN_DEMO_REQUESTS, GEN_MAX_NEW)
        if not any(demo["answers"]):
            raise AssertionError("the demo decoder generated no text")
        native_sse(root, dev, syn)

        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = quantized_from_masters(QWEN3_8B, 4, dev)
        torch.cuda.synchronize()
        log(f"[llm] Qwen3-8B bf16 masters drawn on the card and quantized "
            f"to int4 in {time.perf_counter() - t0:.1f} s (peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; int4 "
            f"decoder {torch.cuda.memory_allocated() / 1e9:.2f} GB)")
        weights = (params, QWEN3_8B, ByteTokenizer())
        common = ["--llm-kv-quant", "int8"]
        for label, flags in (
                ("llm_batch", ["--llm-serving", "batch"]),
                ("llm_continuous", ["--llm-serving", "continuous",
                                    "--llm-prefix-cache",
                                    "--llm-spec-window", "4"])):
            res = serve_generation(root, dev, syn, label, common + flags,
                                   GEN_REQUESTS, GEN_MAX_NEW, weights,
                                   sse=label == "llm_batch")
            if res["launches"]["int4_matmul"] <= 0:
                raise AssertionError(f"{label} never launched int4_matmul")
            out[label] = res
        step = decode_step_breakdown(params, QWEN3_8B, dev)
        print_decode_breakdown(step, smi)
        # every K5 call of a decode step is one kernel on the device: no
        # more K5 kernels than calls (the profiler may miss a few at its
        # window's edges), none of them a separate sum of split partials
        if (step["k5_kernels_per_step"] > step["k5_launches_per_step"]
                or step["k5_split_sums_per_step"] > 0):
            raise AssertionError(
                f"a decode step's {step['k5_launches_per_step']} K5 calls ran "
                f"{step['k5_kernels_per_step']} kernels on the device "
                f"({step['k5_split_sums_per_step']} split sums)")
        out["decode_step"] = step
        pre = prefill_breakdown(params, QWEN3_8B, dev)
        log(f"[prefill:qwen3-8b] B={LLM_BATCH} P={LLM_PROMPT} int4 weights, "
            f"int8 KV: {pre['prefill_ms']:.3f} ms (host clock); profiler: "
            f"wall {pre['profile_wall_ms']:.3f} ms, device "
            f"{pre['profile_device_ms']:.3f} ms, busy share "
            f"{pre['busy_share']:.3f}, K5 launches {pre['k5_launches']} "
            f"({smi})")
        for k in pre["kernels"]:
            log(f"[prefill:qwen3-8b]   {k['ms']:9.3f} ms {k['calls']:5d} "
                f"calls  {k['name']}")
        out["prefill"] = pre

        kern, plain = _prefill_logits(params, QWEN3_8B, dev)
        scale = float(plain.abs().max())
        rel = float((kern - plain).abs().max()) / scale
        agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
        log(f"[llm] Qwen3-8B 36-layer bf16 prefill (B=4, P=128) logits, K5 "
            f"against its plain version: max |diff| {rel:.3e} of max |logit| "
            f"{scale:.3f} (gate {PREFILL_LOGIT_TOL}); argmax equal on "
            f"{agree} of 4 rows")
        if not rel <= PREFILL_LOGIT_TOL:
            raise AssertionError(f"36-layer prefill logits differ by {rel}")
        out["prefill_rel_err"] = rel
        del params, weights, kern, plain
        gc.collect()
        torch.cuda.empty_cache()

        cfg2 = dataclasses.replace(QWEN3_8B, num_layers=2)
        p2 = quantized_from_masters(cfg2, 4, dev, seed=1,
                                    dtype=torch.float32)
        par = _greedy_parity(p2, cfg2, dev)
        log(f"[llm] Qwen3-8B widths, 2 layers, f32, int4 weights: kernel "
            f"against plain path over {PARITY_STEPS} greedy steps x 4 rows: "
            f"{par['same']} tokens equal, {par['near_ties']} near-ties "
            f"(top two within {NEAR_TIE} relative), max |logit diff| "
            f"{par['max_logit_err']:.3e}")
        out["parity"] = par
        del p2
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- phase 7: the live query encoders (--embedder zoo) ----------------------

ZOO_ENCODER = "ncbi/MedCPT-Query-Encoder"
ZOO_CHECK = 256          # served answers a front end held against the oracle
ZOO_RECALL_GATE = 0.99
FEB_DOCS = 262_144       # the feb4rag world's size (ROADMAP's feb4rag cell)
FEB_REQUESTS = 256


def _zoo_questions(syn) -> list:
    """The world's question texts under qids its query table does not
    hold, so that every request is encoded."""
    return [{"qid": f"zoo-{i}", "question": q["question"]}
            for i, q in enumerate(syn.questions)]


def _bodies(port: int, questions: list) -> list:
    """Every question through ``GET /query`` at once; the answers' bodies
    (each must be 200)."""
    import aiohttp

    async def run():
        async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(
                limit=len(questions))) as s:
            return await asyncio.gather(*[
                _get_query(s, port, q["qid"], q["question"])
                for q in questions])

    out = asyncio.run(run())
    bad = [(st, b) for st, b in out if st != 200]
    if bad:
        raise AssertionError(f"{len(bad)} /query answers were not 200: "
                             f"{bad[:3]}")
    return [b for _, b in out]


def _serve_aiohttp(server):
    """Start an aiohttp ``server`` (or ``ServingSystem``) on an event loop
    in a thread; returns ``stop()``."""
    import threading

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(900)

    def stop():
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(300)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()
        if thread.is_alive():
            raise AssertionError("the server's loop did not stop")
    return stop


def _embed_all(provider, texts: list, world) -> dict:
    """``provider.embed_many`` over ``texts`` in chunks of the largest
    encode bucket, stacked ``{encoder: [n, d]}``."""
    rows = []
    for i in range(0, len(texts), 32):
        rows += provider.embed_many(texts[i:i + 32], [""] * len(
            texts[i:i + 32]))
    return {e: np.stack([r[e] for r in rows]) for e in world.encoders}


def serve_zoo(root: str, dev, syn, front: str) -> dict:
    """``--embedder zoo`` over the medrag world through one front end, as
    ``python -m ragroute_tpu_torch.main`` builds it: the encoder read from
    the hub cache by the port's reader must run on the card; the timed
    burst of text queries; then ``ZOO_CHECK`` answers held against the
    exact oracle over the embeddings ``provider.embed_many`` gives for the
    same texts afterwards."""
    from ragroute_tpu_torch.encoders import checks as EC
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.system import ServingSystem

    label = f"zoo_{front}"
    t0 = time.perf_counter()
    argv = ["--dataset", "medrag", "--routing", "ragroute", "--disable-llm",
            "--port", "0", "--data-root", root, "--device", str(dev),
            "--embedder", "zoo"]
    system = ServingSystem(parse_args(
        argv + (["--frontend", "native"] if front == "native" else [])))
    system.build()
    provider = system.server.provider
    backends = provider.zoo.backends
    log(f"[{label}] built in {time.perf_counter() - t0:.1f} s; encoder "
        f"backends {backends}")
    if backends != {ZOO_ENCODER: f"torch:{dev.type}"}:
        raise AssertionError(f"{label}: the encoder is not on the card: "
                             f"{backends}")
    questions = _zoo_questions(syn)
    if front == "native":
        thread = _start_native(system)
        port = system.native.bound_port
        stop = lambda: _stop_native(system, thread)  # noqa: E731
    else:
        stop = _serve_aiohttp(system)
        port = system.server.bound_port
    try:
        reset_counts()
        burst = surface_burst(port, syn, questions=questions)
        answers = _bodies(port, questions[:ZOO_CHECK])
        launches = read_counts()
        stats = json.loads(_http(port, "GET", "/stats")[1])
    finally:
        stop()
    report_bursts(label, f"{front}, --embedder zoo", [burst])
    base = BURSTS.get(f"aiohttp x {SURFACE_CONNS}")
    log(f"[{label}] the same burst through aiohttp with precomputed "
        f"embeddings: "
        + (f"{base['requests_per_s']:.1f} requests/s, p50 "
           f"{base['p50_ms']:.3f} ms, p99 {base['p99_ms']:.3f} ms (this run)"
           if base else "not run in this run"))
    t0 = time.perf_counter()
    q = _embed_all(provider, [a["question"] for a in questions[:ZOO_CHECK]],
                   syn.world)
    lists = EC.oracle_lists(syn.world, syn.embeddings, q, syn.world.k)
    recall = EC.served_recall(syn.world, answers, lists, syn.world.k)
    emb = stats.get("embedding")
    log(f"[{label}] recall@{syn.world.k} of {ZOO_CHECK} served answers "
        f"against the exact oracle over embed_many's embeddings: "
        f"{recall:.6f} (gate {ZOO_RECALL_GATE}; oracle in "
        f"{time.perf_counter() - t0:.1f} s); /stats embedding {emb}, "
        f"batch_size {stats['batch_size']}; launches {launches}")
    if recall < ZOO_RECALL_GATE:
        raise AssertionError(f"{label}: recall {recall} < {ZOO_RECALL_GATE}")
    if front == "aiohttp" and not (emb and emb["mean_batch"] > 1):
        raise AssertionError(f"{label}: the EmbeddingBatcher never batched: "
                             f"{emb}")
    for name in PATH_KERNELS[label]:
        if launches[name] <= 0:
            raise AssertionError(f"the {label} path never launched {name}")
    del system, provider
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "recall": recall, "burst": burst}


def phase_zoo_medrag(root: str, dev, syn) -> dict:
    """Phase 7 (b): a MedCPT-Query-Encoder checkpoint at BERT-base width
    (seeded f32 weights, a 30,522-entry vocabulary made in code with the
    questions' words) written into a hub cache as ``model.safetensors``,
    served through aiohttp and through the native front end; then the same
    weights as ``pytorch_model.bin`` through a second run of the loader,
    which must give the first load's embeddings."""
    from ragroute_tpu_torch.encoders import checks as EC
    from ragroute_tpu_torch.encoders import published as P
    from ragroute_tpu_torch.encoders.registry import ENCODER_SPECS
    from ragroute_tpu_torch.encoders.zoo import load_encoder

    hub = tempfile.mkdtemp(prefix="ragroute_hub_")
    saved = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = hub
    out = {}
    try:
        t0 = time.perf_counter()
        master = P.random_model("bert-base", dev, torch.float32, seed=1)
        vocab = P.wordpiece_vocab(master.cfg.vocab_size, EC.words_of(
            [q["question"] for q in syn.questions] + EC.QUERY_TEXTS))
        P.write_hub_checkpoint(hub, ZOO_ENCODER, master, vocab)
        log(f"[zoo] {ZOO_ENCODER} (BERT-base, {P.n_params(master) / 1e6:.1f}"
            f" M parameters, f32) written as model.safetensors into a hub "
            f"cache in {time.perf_counter() - t0:.1f} s")
        for front in ("aiohttp", "native"):
            out[f"zoo_{front}"] = serve_zoo(root, dev, syn, front)
        spec = ENCODER_SPECS[ZOO_ENCODER]
        first = load_encoder(spec, device=dev).encode(EC.QUERY_TEXTS)
        P.write_hub_checkpoint(hub, ZOO_ENCODER, master, vocab, fmt="bin")
        enc = load_encoder(spec, device=dev)
        second = enc.encode(EC.QUERY_TEXTS)
        diff = float(np.abs(first - second).max())
        log(f"[zoo] the same weights as pytorch_model.bin: backend "
            f"{enc.backend}, max |difference| {diff:.3g} over "
            f"{len(EC.QUERY_TEXTS)} queries")
        if enc.backend != f"torch:{dev.type}" or diff > 1e-5 * float(
                np.abs(first).max()):
            raise AssertionError("the .bin checkpoint loads differently")
        del master, enc
    finally:
        if saved is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = saved
        shutil.rmtree(hub, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_zoo_feb4rag(dev, smi: str) -> dict:
    """Phase 7 (c): the synthetic feb4rag world at 262,144 docs (13
    sources at 768, 1,024 and 4,096; f32 rows) served through
    ``FederationServer``
    with ``EncoderZooEmbeddings`` over the eight encoders of the world at
    their published widths (SGPT-5.8B among them), held on the card, and
    the EmbeddingBatcher: ``FEB_REQUESTS`` text queries at once, recall of
    the served answers, requests/s and the share of the step spent
    encoding."""
    from ragroute_tpu_torch.encoders import EncoderZoo
    from ragroute_tpu_torch.encoders import checks as EC
    from ragroute_tpu_torch.encoders import published as P
    from ragroute_tpu_torch.encoders.registry import ENCODER_SPECS
    from ragroute_tpu_torch.engine import FederatedSearchEngine
    from ragroute_tpu_torch.engine.embedding import EncoderZooEmbeddings
    from ragroute_tpu_torch.engine.server import FederationServer
    from ragroute_tpu_torch.index import ShardSet
    from ragroute_tpu_torch.index.store import MemoryDocStore
    from ragroute_tpu_torch.index.synthetic import make_synthetic_world
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    t0 = time.perf_counter()
    n_src = 13
    syn = make_synthetic_world("feb4rag", docs_per_source=FEB_DOCS // n_src,
                               num_queries=FEB_REQUESTS, seed=0)
    world = syn.world
    # f32 rows (the reference's flat f32 indexes): the encoders' random
    # weights give queries at near-zero cosine to every doc, where bf16
    # rows alone cost recall (the note below measures how much)
    ss = ShardSet.build(world, syn.embeddings, doc_ids=syn.doc_ids,
                        dtype=torch.float32, device=dev)
    router = CorpusRouter.from_seed(world.router_input_dim, 0, dev)
    bank = RouterBank.create(world, syn.centroids, device=dev)
    engine = FederatedSearchEngine(ss, router, bank, impl="auto")
    log(f"[zoo_feb4rag] {ss.total_docs} docs in {world.num_sources} sources "
        f"(widths {sorted({s.embed_dim for s in world.sources})}) on the "
        f"card in {time.perf_counter() - t0:.1f} s: {ss.index_bytes / 1e9:.3f}"
        f" GB")
    t0 = time.perf_counter()
    words = EC.words_of([q["question"] for q in syn.questions]
                        + EC.QUERY_TEXTS)
    models, encs = {}, {}
    for name in world.encoders:
        key = P.SPEC_MODEL[name]
        if key not in models:
            models[key] = (P.random_model(key, dev, torch.bfloat16),
                           P.tokenizer_for(key, words),
                           P.random_dense(key, dev))
        model, tok, dense = models[key]
        encs[name] = P.encoder(ENCODER_SPECS[name], model, tok, dense)
    zoo = EncoderZoo(world, encoders=encs)
    provider = EncoderZooEmbeddings(world, zoo=zoo)
    log(f"[zoo_feb4rag] {len(encs)} encoders over {len(models)} models "
        f"({sorted(models)}) made on the card in "
        f"{time.perf_counter() - t0:.1f} s; backends {zoo.backends}; "
        f"parameters {sum(P.n_params(m[0]) for m in models.values()) / 1e9:.2f}"
        f" G")
    if set(zoo.backends.values()) != {f"torch:{dev.type}"}:
        raise AssertionError(f"feb4rag zoo off the card: {zoo.backends}")
    server = FederationServer(
        engine, strategy="ragroute", embedding_provider=provider,
        doc_store=MemoryDocStore.from_synthetic(syn), disable_llm=True,
        port=0)
    stop = _serve_aiohttp(server)
    questions = _zoo_questions(syn)
    try:
        _bodies(server.bound_port, questions[:8])        # warm the encoders
        reset_counts()
        t0 = time.perf_counter()
        answers = _bodies(server.bound_port, questions[:FEB_REQUESTS])
        wall = time.perf_counter() - t0
        launches = read_counts()
        stats = json.loads(_http(server.bound_port, "GET", "/stats")[1])
    finally:
        stop()
    md = [a["metadata"] for a in answers]
    enc_share = (sum(m["embedding_time"] for m in md)
                 / max(sum(m["e2e_time"] for m in md), 1e-12))
    t0 = time.perf_counter()
    q = _embed_all(provider, [x["question"] for x in questions[:FEB_REQUESTS]],
                   world)
    lists = EC.oracle_lists(world, syn.embeddings, q, world.k)
    recall = EC.served_recall(world, answers, lists, world.k)
    log(f"[zoo_feb4rag] {FEB_REQUESTS} text GET /query at once, all 200, in "
        f"{wall:.3f} s: {FEB_REQUESTS / wall:.1f} requests/s; encoding "
        f"{enc_share:.3f} of the summed request time; /stats embedding "
        f"{stats.get('embedding')}; recall@{world.k} against the exact oracle"
        f" (feb4rag's merge without qrels) {recall:.6f} (gate "
        f"{ZOO_RECALL_GATE}; oracle in {time.perf_counter() - t0:.1f} s); "
        f"launches {launches}; {smi}")
    bf16 = FederatedSearchEngine(
        ShardSet.build(world, syn.embeddings, dtype=torch.bfloat16,
                       device=dev), router, bank, impl="auto")
    log(f"[zoo_feb4rag] note: the same queries over bf16 rows: per-source "
        f"recall@{world.k} {EC.source_recall(bf16.search(q), lists):.6f}, "
        f"over the served f32 rows "
        f"{EC.source_recall(engine.search(q), lists):.6f}")
    if recall < ZOO_RECALL_GATE:
        raise AssertionError(f"feb4rag zoo: recall {recall}")
    for name in PATH_KERNELS["zoo_feb4rag"]:
        if launches[name] <= 0:
            raise AssertionError(f"the feb4rag zoo path never launched {name}")
    del server, provider, zoo, encs, models, engine, bf16, ss, syn
    gc.collect()
    torch.cuda.empty_cache()
    return {"zoo_feb4rag": {"launches": launches, "recall": recall,
                            "requests_per_s": FEB_REQUESTS / wall,
                            "encode_share": enc_share}}


def phase_encoders(dev, smi: str, medrag: bool = False) -> dict:
    """Phase 7: (a) every registry encoder at its published width on the
    card; with ``medrag`` (the ``encoders`` run alone) (b) over a medrag
    world made here (the full run serves it inside phase 3); (c) the
    feb4rag zoo."""
    from ragroute_tpu_torch.encoders import checks as EC

    t0 = time.perf_counter()
    out = {}
    if medrag:
        from ragroute_tpu_torch.index.synthetic import (make_synthetic_world,
                                                        save_world)

        root = tempfile.mkdtemp(prefix="ragroute_smoke_")
        try:
            syn = make_synthetic_world(
                "medrag", docs_per_source_map=MEDRAG_DOCS,
                num_queries=NUM_QUERIES, seed=0)
            save_world(syn, root)
            log(f"[world] medrag {sum(MEDRAG_DOCS.values())} docs x 768 made "
                f"and saved in {time.perf_counter() - t0:.1f} s")
            out.update(phase_zoo_medrag(root, dev, syn))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        del syn
        gc.collect()
    rows = EC.check_published_models(dev, log, card=smi)
    ENCODER_ROWS.extend(rows)
    log(f"[time] encoders at their published widths checked in "
        f"{time.perf_counter() - t0:.0f} s")
    out.update(phase_zoo_feb4rag(dev, smi))
    log(f"[time] encoders phase took {time.perf_counter() - t0:.0f} s")
    return out


# ---- phase 8: the offline path (train, serve, evaluate, import) -------------

# MIRAGE's questions, which the reference's medrag router trains on:
# 1,089 + 1,273 + 4,183 + 500 + 618
OFFLINE_QUESTIONS = 7_663
# the reference trains 150 (train_router.NUM_EPOCHS, the script's default);
# a third of them keeps the whole run in its time on a slow host (the
# synthetic labels separate in the first epoch)
OFFLINE_EPOCHS = 50
OFFLINE_BURST = 256          # /query answers held against the CPU router
OFFLINE_PIPELINE = 64        # qids the offline pipeline runs
NEAR_THRESHOLD = 1e-4        # |p - threshold| under which a pair is skipped
OFFLINE_RECALL_GATES = {"float32": 1.0, "bfloat16": 0.99}
ARTICLE_ENCODER = "ncbi/MedCPT-Article-Encoder"
ENCODE_DOCS = 2_048          # docs per source through --encode-from-jsonl
ENCODE_CHECK = 64            # rows held against the f32 forward
ENCODE_COS_GATE = 0.99


def _offline_questions(wroot: str, n: int) -> list:
    """The first ``n`` questions of the world's benchmark file."""
    with open(os.path.join(wroot, "benchmark", "SYNTHETIC.json")) as f:
        bank = json.load(f)["synthetic"]
    return [{"qid": qid, **q} for qid, q in list(bank.items())[:n]]


def _world_arrays(wroot: str, world) -> tuple:
    """The saved world's rows (mmap) and its query table."""
    emb = {s.name: np.load(os.path.join(wroot, s.name, "embeddings.npy"),
                           mmap_mode="r") for s in world.sources}
    qdir = os.path.join(wroot, "queries")
    with open(os.path.join(qdir, "encoders.json")) as f:
        encoders = json.load(f)
    with open(os.path.join(qdir, "qids.json")) as f:
        qids = json.load(f)
    q = {e: np.load(os.path.join(qdir, f"enc_{i}.npy"))
         for i, e in enumerate(encoders)}
    return emb, q, qids


def _cpu_routes(npz: str, wroot: str, world, q: dict) -> tuple:
    """A CPU forward of the router in ``npz`` over the features of the
    query rows ``q``: ``(probs [B, N], threshold)``."""
    from ragroute_tpu_torch.router import RouterBank, build_features
    from ragroute_tpu_torch.router.torch_import import load_router

    router, thr, scaler = load_router(npz)
    with open(os.path.join(wroot, "centroids.json")) as f:
        cents = {k: np.asarray(v, np.float32) for k, v in json.load(f).items()}
    bank = RouterBank.create(world, cents, scaler)
    with torch.no_grad():
        x = build_features(world, bank, {e: torch.from_numpy(v)
                                         for e, v in q.items()})
        probs = torch.sigmoid(router(x)).numpy()
    return probs, world.router_threshold if thr is None else thr


def _same_routes(label: str, world, served: list, probs: np.ndarray,
                 thr: float) -> int:
    """Each served ``data_sources`` against ``probs > thr``, pairs within
    NEAR_THRESHOLD of the threshold skipped; returns the skipped count."""
    names = [s.name for s in world.sources]
    skipped = 0
    for r, sources in enumerate(served):
        for si, name in enumerate(names):
            if abs(probs[r, si] - thr) <= NEAR_THRESHOLD:
                skipped += 1
                continue
            if (name in sources) != bool(probs[r, si] > thr):
                raise AssertionError(
                    f"{label}: row {r} routes {sources}, the CPU router "
                    f"{probs[r].tolist()} at threshold {thr}")
    return skipped


def _serve_offline(root: str, dev, questions: list) -> tuple:
    """The world under ``root`` served as ``python -m
    ragroute_tpu_torch.main --routing ragroute --disable-llm`` builds it:
    every question through ``GET /query`` at once; ``(answers, launches,
    requests a second)``."""
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.system import ServingSystem

    system = ServingSystem(parse_args([
        "--dataset", "medrag", "--routing", "ragroute", "--disable-llm",
        "--port", "0", "--data-root", root, "--device", str(dev)]))
    system.build()
    stop = _serve_aiohttp(system)
    try:
        reset_counts()
        t0 = time.perf_counter()
        answers = _bodies(system.server.bound_port, questions)
        rate = len(questions) / (time.perf_counter() - t0)
        launches = read_counts()
    finally:
        stop()
    del system
    gc.collect()
    torch.cuda.empty_cache()
    return answers, launches, rate


def _doc_ids(docs: list) -> list:
    return [d.get("id") for d in docs]


def _train_step_profile(res, dev, reps: int = 50) -> dict:
    """One training step at batch 256 with dropout, from the trained
    parameters: device time, wall time and kernels a step by
    ``torch.profiler``, and the step's bound (its f32 products at the
    CUDA cores' 67 TFLOP/s: TF32 is off)."""
    from ragroute_tpu_torch.encoders import checks as EC
    from ragroute_tpu_torch.router import CorpusRouter
    from ragroute_tpu_torch.train import train_router as T

    d = res.params["fc1.weight"].shape[1]
    model = CorpusRouter(d).to(dev)
    model.load_state_dict(res.params)
    opt, sched = T.make_optimizer(model, 95)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(256, d, device=dev, generator=gen)
    y = (torch.rand(256, device=dev, generator=gen) < 0.5).float()
    r = EC.device_ms(lambda: T.train_step(model, opt, sched, x, y, 1.0, gen),
                     reps=reps)
    flops = 3 * 2 * 256 * (d * 256 + 256 * 128 + 128)   # forward + backward
    bound = flops / 67e12 * 1e3
    log(f"[offline:train] one step at batch 256 ({reps} under the "
        f"profiler): device {r['device_ms']:.4f} ms, wall {r['wall_ms']:.4f}"
        f" ms (busy {r['device_ms'] / r['wall_ms']:.3f}), {r['kernels']:.0f}"
        f" kernels a step; bound {bound:.4f} ms (operations)")
    return {"step_device_ms": r["device_ms"], "step_wall_ms": r["wall_ms"],
            "step_kernels": r["kernels"], "step_bound_ms": bound}


def offline_train_serve(root: str, dev) -> dict:
    """Steps 1 to 4: make the world, train its router on the card, serve
    it, and run the offline pipeline over the served qids."""
    from ragroute_tpu_torch.config import get_world
    from ragroute_tpu_torch.encoders import checks as EC
    from ragroute_tpu_torch.pipeline import OfflinePipeline
    from ragroute_tpu_torch.scripts import make_synthetic_data, train_router

    out = {}
    t0 = time.perf_counter()
    wroot = make_synthetic_data.main([
        "--dataset", "medrag", "--docs-per-source", str(REDUCED_DOCS),
        "--num-queries", str(OFFLINE_QUESTIONS), "--subclusters",
        str(IVF_TOPICS), "--data-root", root, "--device", str(dev)])
    log(f"[offline] world: medrag 4 x {REDUCED_DOCS} docs x 768, "
        f"{IVF_TOPICS} topics a source, {OFFLINE_QUESTIONS} questions "
        f"({OFFLINE_QUESTIONS * 4} router examples at width 1,540), made "
        f"and saved in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    res, npz = train_router.main([
        "--dataset", "medrag", "--data-root", root, "--epochs",
        str(OFFLINE_EPOCHS), "--device", str(dev)])
    wall = time.perf_counter() - t0
    labels = np.load(os.path.join(wroot, "relevant.npy")).reshape(-1)
    base = max(labels.mean(), 1 - labels.mean())
    train_s = sum(res.epoch_seconds)
    m = res.metrics
    log(f"[offline:train] {OFFLINE_EPOCHS} epochs, {res.steps} Adam steps at "
        f"batch 256 in {train_s:.3f} s ({wall:.1f} s with features and "
        f"split): {train_s / len(res.epoch_seconds):.4f} s an epoch "
        f"(first {res.epoch_seconds[0]:.4f}, median "
        f"{float(np.median(res.epoch_seconds)):.4f}), "
        f"{res.steps / train_s:.1f} steps/s; parameters and optimiser state "
        f"on {res.devices}; best val acc {m['best_val_acc']:.6f} against a "
        f"base rate {base:.6f}, AUC {m['auc']:.6f}, threshold "
        f"{res.threshold:.6f}")
    if res.devices != [str(torch.empty(0, device=dev).device)]:
        raise AssertionError(f"training state not on the card: {res.devices}")
    if not (m["best_val_acc"] > base + 0.1 and m["auc"] > 0.85
            and 0.0 < res.threshold < 1.0):
        raise AssertionError(f"the trained router is not good enough: {m}, "
                             f"threshold {res.threshold}, base {base}")
    prof = _train_step_profile(res, dev)
    out["offline_train"] = {"s_per_epoch": train_s / len(res.epoch_seconds),
                            "steps_per_s": res.steps / train_s,
                            "metrics": m, **prof}

    world = get_world("medrag")
    emb, q, qids = _world_arrays(wroot, world)
    questions = _offline_questions(wroot, OFFLINE_BURST)
    if [qq["qid"] for qq in questions] != qids[:OFFLINE_BURST]:
        raise AssertionError("the benchmark's qids are not the table's")
    t0 = time.perf_counter()
    answers, launches, rate = _serve_offline(root, dev, questions)
    serve_s = time.perf_counter() - t0
    qb = {e: v[:OFFLINE_BURST] for e, v in q.items()}
    probs, thr = _cpu_routes(npz, wroot, world, qb)
    served = [a["metadata"]["data_sources"] for a in answers]
    skipped = _same_routes("offline_served", world, served, probs, thr)
    lists = EC.oracle_lists(world, emb, qb, world.k)
    recall = EC.served_recall(world, answers, lists, world.k)
    per_source = [sum(s.name in d for d in served) for s in world.sources]
    log(f"[offline:serve] {OFFLINE_BURST} /query at once with the trained "
        f"router: all 200, {rate:.1f} requests/s (build, burst and stop in "
        f"{serve_s:.1f} s), routes per source {per_source}, "
        f"equal to the CPU forward of router.npz ({skipped} pairs within "
        f"{NEAR_THRESHOLD} of the threshold {thr:.6f} skipped); recall@"
        f"{world.k} against the exact oracle under each answer's routing "
        f"{recall:.6f} (gate 0.99); launches {launches}")
    if recall < 0.99:
        raise AssertionError(f"offline_served: recall {recall} < 0.99")
    out["offline_served"] = {"launches": launches, "recall": recall,
                             "skipped": skipped, "requests_per_s": rate}

    t0 = time.perf_counter()
    pipe = OfflinePipeline.from_data_root(root, "medrag", device=dev)
    if pipe.engine.device.type != dev.type:
        raise AssertionError(f"the offline pipeline is on "
                             f"{pipe.engine.device}, not {dev}")
    reset_counts()
    same = near = 0
    for qq, a, p in zip(questions[:OFFLINE_PIPELINE], answers, probs):
        r = pipe.run(qq["question"], qq["options"], qid=qq["qid"])
        if (np.abs(p - thr) <= NEAR_THRESHOLD).any():
            near += 1
            continue
        md = a["metadata"]
        if (r["data_sources"] != md["data_sources"]
                or _doc_ids(r["top_docs"]) != _doc_ids(md["top_docs"])):
            raise AssertionError(
                f"offline pipeline on {qq['qid']}: {r['data_sources']} "
                f"{_doc_ids(r['top_docs'])[:4]} against the served "
                f"{md['data_sources']} {_doc_ids(md['top_docs'])[:4]}")
        same += 1
    launches = read_counts()
    log(f"[offline:pipeline] OfflinePipeline.from_data_root on {dev}: "
        f"{same} of {OFFLINE_PIPELINE} qids give the served data_sources "
        f"and top_docs ({near} with a pair near the threshold left out) in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    out["offline_pipeline"] = {"launches": launches}
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def offline_eval(root: str, dev) -> dict:
    """Step 5: ``scripts.eval_recall`` on the card at f32 and bf16, then
    with ``--impl ivf``."""
    from ragroute_tpu_torch.scripts import eval_recall

    out = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        reset_counts()
        rep = eval_recall.main(["--dataset", "medrag", "--data-root", root,
                                "--dtype", dtype, "--device", str(dev)])
        launches = read_counts()
        gate = OFFLINE_RECALL_GATES[dtype]
        log(f"[offline:eval] eval_recall --dtype {dtype}: {rep['recall']} "
            f"(gate {gate}) in {time.perf_counter() - t0:.1f} s; launches "
            f"{launches}")
        if min(rep["recall"].values()) < gate:
            raise AssertionError(f"eval_recall {dtype}: {rep['recall']}")
        out[f"offline_eval_{dtype}"] = {"launches": launches,
                                        "recall": rep["recall"]}
    t0 = time.perf_counter()
    reset_counts()
    rep = eval_recall.main(["--dataset", "medrag", "--data-root", root,
                            "--impl", "ivf", "--device", str(dev)])
    launches = read_counts()
    log(f"[offline:eval] eval_recall --impl ivf: {rep['recall']}, layout "
        f"{rep['ivf']['pubmed']} on pubmed, in {time.perf_counter() - t0:.1f}"
        f" s; launches {launches}")
    for name in PATH_KERNELS["offline_ivf"]:
        if launches[name] <= 0:
            raise AssertionError(f"eval_recall --impl ivf never launched "
                                 f"{name}")
    out["offline_ivf"] = {"launches": launches, "recall": rep["recall"]}
    return out


def offline_import(root: str, dev) -> dict:
    """Step 6: the world and its router in the reference's layout (FAISS
    files, metadatas, chunks, ``best_model.pth``, ``preprocessed_data.pkl``
    by the port's writer), imported by ``scripts.import_real_data``, served;
    its routes equal those of the ``.pth`` and scaler loaded directly."""
    from ragroute_tpu_torch.config import get_world
    from ragroute_tpu_torch.engine.engine import FederatedSearchEngine
    from ragroute_tpu_torch.index.reference_layout import (
        write_medrag_corpus, write_reference_router)
    from ragroute_tpu_torch.router.torch_import import load_router
    from ragroute_tpu_torch.scripts import import_real_data
    from ragroute_tpu_torch.system import load_world_artifacts

    world = get_world("medrag")
    wroot = os.path.join(root, "medrag")
    emb, q, _ = _world_arrays(wroot, world)
    payloads = {}
    for s in world.sources:
        with open(os.path.join(wroot, "payloads", f"{s.name}.jsonl")) as f:
            payloads[s.name] = [json.loads(line) for line in f]
    t0 = time.perf_counter()
    ref = os.path.join(root, "reference")
    write_medrag_corpus(os.path.join(ref, "corpus"), emb, payloads,
                        chunk_rows=4096, seed=3)
    router, _, scaler = load_router(os.path.join(wroot, "router.npz"))
    pth, pkl = write_reference_router(
        os.path.join(ref, "routing"), router.state_dict(), scaler[0],
        scaler[1], items=(np.zeros((4, 1540), np.float32), None,
                          np.zeros(4, np.float32), None))
    log(f"[offline:import] reference-layout tree (FAISS IxFI files, "
        f"metadatas, chunk files, best_model.pth, preprocessed_data.pkl) "
        f"written in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    iroot = os.path.join(root, "imported")
    import_real_data.main(["--dataset", "medrag", "--corpus-root",
                           os.path.join(ref, "corpus"), "--router-ckpt", pth,
                           "--scaler", pkl, "--data-root", iroot,
                           "--device", str(dev)])
    iw = os.path.join(iroot, "medrag")
    for s in world.sources:
        if not np.array_equal(np.load(os.path.join(iw, s.name,
                                                   "embeddings.npy")),
                              emb[s.name]):
            raise AssertionError(f"import: {s.name}'s rows differ")
        with open(os.path.join(iw, "payloads", f"{s.name}.jsonl")) as f:
            if [json.loads(line) for line in f] != payloads[s.name]:
                raise AssertionError(f"import: {s.name}'s payloads are not "
                                     f"in row order")
    shutil.copytree(os.path.join(wroot, "queries"),
                    os.path.join(iw, "queries"))
    log(f"[offline:import] imported in {time.perf_counter() - t0:.1f} s: "
        f"rows and payloads in row order equal the world's")
    questions = _offline_questions(wroot, OFFLINE_BURST)
    answers, launches, _ = _serve_offline(iroot, dev, questions)
    served = [a["metadata"]["data_sources"] for a in answers]

    # the same world with the .pth and its scaler in place of router.npz
    os.rename(os.path.join(iw, "router.npz"), os.path.join(root, "imp.npz"))
    shutil.copy(pth, os.path.join(iw, "router.pth"))
    shutil.copy(pkl, os.path.join(iw, "preprocessed_data.pkl"))
    (shard_set, prouter, bank, _, _, _, thr) = load_world_artifacts(
        iroot, world, device=dev)
    engine = FederatedSearchEngine(shard_set, prouter, bank, threshold=thr)
    direct = engine.search({e: v[:OFFLINE_BURST] for e, v in q.items()},
                           strategy="ragroute", fetch_candidates=False)
    probs, t = direct.probs, world.router_threshold
    skipped = _same_routes("offline_imported", world, served, probs, t)
    log(f"[offline:import] the imported world served {OFFLINE_BURST} /query "
        f"(all 200) with the routes of the .pth and preprocessed_data.pkl "
        f"loaded directly on the card ({skipped} pairs within "
        f"{NEAR_THRESHOLD} of the threshold skipped); launches {launches}")
    del shard_set, prouter, engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"offline_imported": {"launches": launches, "skipped": skipped}}


def offline_encode(root: str, dev) -> dict:
    """Step 7: ``import_real_data --encode-from-jsonl`` over 4 x
    ENCODE_DOCS medrag docs through a MedCPT-Article-Encoder checkpoint at
    BERT-base width (seeded f32 weights in a temporary hub cache, served in
    bf16); sampled rows against an f32 forward of the same weights."""
    from ragroute_tpu_torch.config import get_world
    from ragroute_tpu_torch import config as cfg
    from ragroute_tpu_torch.encoders import checks as EC
    from ragroute_tpu_torch.encoders import published as P
    from ragroute_tpu_torch.encoders.registry import ENCODER_SPECS
    from ragroute_tpu_torch.encoders.zoo import load_encoder
    from ragroute_tpu_torch.scripts import import_real_data

    world = get_world("medrag")
    wroot = os.path.join(root, "medrag")
    jsonl = os.path.join(root, "jsonl")
    os.makedirs(jsonl)
    texts = {}
    for s in world.sources:
        with open(os.path.join(wroot, "payloads", f"{s.name}.jsonl")) as f:
            lines = [next(f) for _ in range(ENCODE_DOCS)]
        with open(os.path.join(jsonl, f"{s.name}.jsonl"), "w") as f:
            f.writelines(lines)
        texts[s.name] = [import_real_data._doc_text("medrag", json.loads(x))
                         for x in lines]
    hub = tempfile.mkdtemp(prefix="ragroute_hub_")
    saved = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = hub
    try:
        master = P.random_model("bert-base", dev, torch.float32, seed=2)
        vocab = P.wordpiece_vocab(master.cfg.vocab_size, EC.words_of(
            [t for ts in texts.values() for t in ts[:256]]))
        P.write_hub_checkpoint(hub, ARTICLE_ENCODER, master, vocab)
        del master
        eroot = os.path.join(root, "encoded")
        timings = import_real_data.main([
            "--dataset", "medrag", "--encode-from-jsonl", jsonl,
            "--data-root", eroot, "--device", str(dev)])
        backends = {v["backend"] for v in timings.values()}
        docs = sum(v["docs"] for v in timings.values())
        secs = sum(v["seconds"] for v in timings.values())
        if backends != {f"torch:{dev.type}"}:
            raise AssertionError(f"encode-from-jsonl not on the card: "
                                 f"{backends}")
        old = cfg.ENCODER_COMPUTE_DTYPE
        cfg.ENCODER_COMPUTE_DTYPE = "float32"
        try:
            f32 = load_encoder(ENCODER_SPECS[ARTICLE_ENCODER], device=dev)
        finally:
            cfg.ENCODER_COMPUTE_DTYPE = old
        rng = np.random.default_rng(0)
        cos = []
        for s in world.sources:
            rows = np.sort(rng.choice(ENCODE_DOCS, ENCODE_CHECK // 4,
                                      replace=False))
            got = np.load(os.path.join(eroot, "medrag", s.name,
                                       "embeddings.npy"))[rows]
            want = f32.encode_corpus([texts[s.name][r] for r in rows])
            cos.append(EC.cosine_rows(got, want))
        cos = np.concatenate(cos)
        per_source = {k: round(v["docs"] / v["seconds"], 1)
                      for k, v in timings.items()}
        log(f"[offline:encode] {docs} docs through {ARTICLE_ENCODER} "
            f"(BERT-base, bf16 on the card) in {secs:.3f} s: "
            f"{docs / secs:.1f} docs/s (per source {per_source}); "
            f"{len(cos)} sampled rows against the f32 forward: cosine min "
            f"{cos.min():.6f} (gate {ENCODE_COS_GATE})")
        if cos.min() < ENCODE_COS_GATE:
            raise AssertionError(f"encode-from-jsonl: cosine {cos.min()}")
        del f32
    finally:
        if saved is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = saved
        shutil.rmtree(hub, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"offline_encode": {"docs_per_s": docs / secs,
                               "cos_min": float(cos.min())}}


def phase_offline(dev) -> dict:
    """Phase 8: the offline path on the card."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ragroute_offline_")
    try:
        out = offline_train_serve(root, dev)
        out.update(offline_eval(root, dev))
        out.update(offline_import(root, dev))
        out.update(offline_encode(root, dev))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for label, res in out.items():
        for name in PATH_KERNELS.get(label, ()):
            if res["launches"][name] <= 0:
                raise AssertionError(f"the {label} path never launched "
                                     f"{name}")
    log(f"[time] offline phase took {time.perf_counter() - t0:.0f} s")
    return out


ENCODER_ROWS = []        # (a)'s forwards: times and bounds


# ---- phase 9: meshes, the cluster, the dtype policy -------------------------

MESH_SHAPE = (2, 2)      # the virtual mesh over the full medrag world
MESH_REDUCED = (1, 4)    # the layouts' virtual mesh over phase 4's world
MESH_STEPS = 3           # host-clock steps timed, each engine, each routing
CLUSTER_QUESTIONS = 64   # /query through the cluster's leader at once
CLUSTER_DOCS = 16_384    # docs a source of its world (8,192 rows a cell:
#                          past 4,096, so each cell launches K1)
# the storage dtypes' recall gates (§2 of PERF.md: the JAX tests' gates)
DTYPE_GATES = {"float32": 0.999, "bfloat16": 0.99, "int8": 0.95,
               "int4": 0.90, "int4+lowrank": 0.95}
STORED_GATE = 0.99       # against the exact winners of a shard's own bytes
K1_KERNELS = ("wgmma_topk_kernel", "partial_topk_kernel", "f32_topk_kernel")


def _k1_kernel_count(prof) -> int:
    """K1's scan kernels in a profile (one a launch)."""
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(n in e.key for n in K1_KERNELS))


def _shallow_set(ss):
    """A second view of a shard set (its own list of the same shards): a
    mesh engine retires the entries of the list it is given, and the
    single-card engine keeps serving the original."""
    return dataclasses.replace(ss, shards=list(ss.shards))


def _timed_steps(engine, q: dict, strategy: str) -> list:
    times = []
    for _ in range(MESH_STEPS):
        t0 = time.perf_counter()
        engine.search(q, strategy=strategy)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _norm_body(b: dict) -> str:
    """A /query body with the random query id, the timings and the batch
    size blanked (the batch a query shares depends on when the concurrent
    requests arrive)."""
    b = dict(b, query_id="")
    md = dict(b["metadata"])
    for f in ("embedding_time", "selection_time", "doc_select_time",
              "e2e_time", "generate_time", "batch_size"):
        if f in md:
            md[f] = 0.0
    md["data_sources_stats"] = {n: dict(st, duration=0.0) for n, st in
                                md.get("data_sources_stats", {}).items()}
    b["metadata"] = md
    return json.dumps(b, sort_keys=True)


def _same_bodies(label: str, got: list, want: list) -> None:
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if _norm_body(a) != _norm_body(b)]
    if bad or len(got) != len(want):
        raise AssertionError(f"{label}: {len(bad)} of {len(want)} answers "
                             f"differ from the single-card server's, first "
                             f"{bad[:3]}")


def _aiohttp_captures(port: int, syn, label: str) -> list:
    """PROFILE_CAPTURES 2 s ``/admin/profile`` captures of the aiohttp
    front end during a timed burst; whether each trace holds K1's scan."""
    load = start_load(port, syn, seconds=PROFILE_LOAD_S)
    time.sleep(1.0)
    found = []
    try:
        for _ in range(PROFILE_CAPTURES):
            pdir = tempfile.mkdtemp(prefix="ragroute_profile_")
            status, body = _http(port, "POST", "/admin/profile",
                                 {"seconds": 2.0, "dir": pdir})
            if status != 200:
                raise AssertionError(f"/admin/profile answered {status}")
            with open(os.path.join(pdir, "trace.json")) as f:
                trace = json.load(f)["traceEvents"]
            shutil.rmtree(pdir, ignore_errors=True)
            kern = {e["name"] for e in trace if e.get("cat") == "kernel"}
            k1 = sorted(n for n in kern if any(m in n for m in K1_KERNELS))
            found.append(bool(k1))
            log(f"[{label}] aiohttp /admin/profile 2 s during a burst: "
                f"{len(trace)} trace events, {len(kern)} distinct kernels, "
                f"K1's: {[n[:60] for n in k1]}")
    finally:
        res = finish_load(load)
    log(f"[{label}] aiohttp captures holding K1: {sum(found)} of "
        f"{len(found)} (the load around them: {res['ok']} answers in "
        f"{res['wall_s']:.1f} s)")
    if not all(found):
        raise AssertionError(f"{found.count(False)} of {PROFILE_CAPTURES} "
                             f"aiohttp profile traces hold no K1 kernel")
    return found


def _serve_flags(root: str, dev, flags) -> "object":
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.system import ServingSystem

    return ServingSystem(parse_args([
        "--dataset", "medrag", "--routing", "ragroute", "--disable-llm",
        "--port", "0", "--data-root", root, "--device", str(dev), *flags]))


def _source_recall(world, embeddings, q: dict, out, dev) -> list:
    """Per source, the recall@k of its candidate list (``out.shard_ids``,
    strategy "all") against the exact f32 top-k of that source alone."""
    k = world.k
    rec = []
    for si, src in enumerate(world.sources):
        d = torch.from_numpy(np.ascontiguousarray(
            embeddings[src.name], np.float32)).to(dev)
        qq = torch.from_numpy(np.asarray(q[src.encoder], np.float32)).to(dev)
        if src.score_mode == "cos":
            d = d / d.norm(dim=1, keepdim=True).clamp(min=1e-12)
            qq = qq / qq.norm(dim=1, keepdim=True).clamp(min=1e-12)
        if src.score_mode == "l2":
            s = 2 * qq @ d.T - (d * d).sum(1)[None, :]
        else:
            s = qq @ d.T
        want = torch.topk(s, k, dim=1).indices.cpu().numpy()
        del d, s
        got = out.shard_ids[:, si]
        rec.append(float(np.mean([len(set(g.tolist()) & set(w.tolist())) / k
                                  for g, w in zip(got, want)])))
    return rec


def _policy_check(label: str, engine, syn, dev, n: int) -> dict:
    """``--dtype policy``: each shard's pick, its scan's kernel by the
    counters (the low-rank shards' coarse scan, the bf16 / int8 / int4 wgmma
    scans), its recall. A shard without a coarse layout is held to the
    exact winners of its own stored rows (the plain path over the same
    bytes, f32 arithmetic) at ``STORED_GATE``, and its recall against the
    f32 rows is printed beside its dtype's gate (§2 of PERF.md): at k = 10
    bf16 storage alone moves that recall below 0.99 on some sources of the
    synthetic feb4rag world, where the scan still finds its bytes' winners.
    A low-rank shard (coarse-authoritative int4) is held to the f32 rows at
    its dtype's gate."""
    from ragroute_tpu_torch.config import store_dtype_policy
    from ragroute_tpu_torch.ops.lowrank_topk import lowrank_topk
    from ragroute_tpu_torch.ops.topk import shard_topk

    world, ss = syn.world, engine.shard_set
    k = world.k
    q = {e: v[:n] for e, v in syn.query_embs.items()}
    out = engine.search(q, strategy="all", fetch_candidates=True)
    rec = _source_recall(world, syn.embeddings, q, out, dev)
    rows = []
    for si, (src, sh) in enumerate(zip(world.sources, ss.shards)):
        dt, lr = store_dtype_policy(src.embed_dim, src.score_mode)
        stored = "int4" if sh.packed4 else str(sh.docs.dtype).split(".")[-1]
        if stored != dt or (sh.lr is not None) != lr:
            raise AssertionError(f"{label}: {src.name} stored {stored} "
                                 f"(low-rank {sh.lr is not None}), picked "
                                 f"{dt} (low-rank {lr})")
        qq = torch.from_numpy(q[src.encoder]).to(dev)
        args = dict(mode=src.score_mode, valid_docs=sh.n_docs, bias=sh.bias,
                    scale=sh.scale, center=sh.center, packed4=sh.packed4)
        reset_counts()
        if sh.lr is not None:
            lowrank_topk(qq, sh.lr, sh.docs, k, **args)
        else:
            shard_topk(qq, sh.docs, k, **args)
        c = read_counts()
        scan = ("low-rank coarse scan" if sh.lr is not None
                else f"{dt} scan")
        if c["fused_topk"] < 1 or (c["wgmma"]["fused_topk"]
                                   + c["fold"]["fused_topk"]) < 1:
            raise AssertionError(f"{label}: {src.name}'s {scan} did not "
                                 f"launch K1's wgmma scan: {c}")
        gate = DTYPE_GATES[dt + ("+lowrank" if lr else "")]
        own = None
        if sh.lr is None:
            ref = shard_topk(qq, sh.docs, k, impl="chunked", **args)[1]
            own = float(np.mean([
                len(set(a.tolist()) & set(b.tolist())) / k
                for a, b in zip(out.shard_ids[:, si], ref.cpu().numpy())]))
        bytes_ = sh.docs.numel() * sh.docs.element_size()
        log(f"[{label}] {src.name}: {src.embed_dim}-d {src.score_mode}, pick "
            f"{dt}{' + low-rank' if lr else ''}, {bytes_ / 1e6:.1f} MB, "
            f"{scan} (K1 wgmma scans {c['wgmma']['fused_topk']}, folds "
            f"{c['fold']['fused_topk']}); recall@{k} against the f32 rows "
            f"{rec[si]:.6f} (the dtype's gate {gate}), against its stored "
            f"rows {'-' if own is None else f'{own:.6f}'} (gate "
            f"{STORED_GATE})")
        if (own is None and rec[si] < gate) or (own is not None
                                                and own < STORED_GATE):
            raise AssertionError(f"{label}: {src.name} recall {rec[si]} "
                                 f"(stored rows: {own})")
        rows.append({"source": src.name, "pick": dt, "lowrank": lr,
                     "recall": rec[si], "recall_stored": own})
    log(f"[{label}] index bytes {ss.index_bytes / 1e9:.4f} GB over "
        f"{len(ss.shards)} mixed shards (+ {ss.aux_bytes / 1e9:.4f} GB "
        f"low-rank layouts)")
    return {"rows": rows, "index_bytes": ss.index_bytes}


def phase_mesh_medrag(root: str, dev, syn, smi: str,
                      oracles: OracleMemo = None) -> dict:
    """Phase 9 (a) and (e) over phase 3's medrag world (1,048,575 docs,
    bf16): :class:`ShardedSearch` over a 2x2 mesh of ``cuda:0`` named four
    times against the single-card engine (both as ``ServingSystem`` builds
    them); the world under ``--dtype policy``."""
    from torch.profiler import ProfilerActivity, profile

    from ragroute_tpu_torch.oracle import engine_recall
    from ragroute_tpu_torch.parallel import ShardedSearch, make_mesh

    out = {}
    t0 = time.perf_counter()
    single_sys = _serve_flags(root, dev, [])
    single_sys.build()
    single = single_sys.server.engine
    log(f"[mesh] single-card engine built in {time.perf_counter() - t0:.1f} "
        f"s")
    try:
        # (a) the 2x2 virtual mesh: cells are views of the card's shards
        dp, idx = MESH_SHAPE
        mesh = ShardedSearch(_shallow_set(single.shard_set), single.router,
                             single.bank,
                             make_mesh(dp, idx, devices=[dev] * (dp * idx)))
        q = {e: v[:NUM_QUERIES] for e, v in syn.query_embs.items()}
        tables = [single.shard_set.doc_ids.get(s.name) or
                  list(range(s.n_docs)) for s in single.shard_set.shards]
        for strategy in ("ragroute", "all"):
            for eng in (single, mesh):
                eng.search(q, strategy=strategy)          # warm
            torch.cuda.synchronize()
            # a warm-up step under the profiler, then two recorded ones
            # (the first kernels of a capture are where CUPTI has lost an
            # event: 9 of 10 once)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=torch.profiler.schedule(
                             wait=0, warmup=1, active=2, repeat=1),
                         acc_events=True) as prof:
                mesh.search(q, strategy=strategy)
                torch.cuda.synchronize()
                prof.step()
                reset_counts()
                for _ in range(2):
                    got = mesh.search(q, strategy=strategy)
                    torch.cuda.synchronize()
                    prof.step()
            launches = read_counts()
            traced = _k1_kernel_count(prof)
            want = single.search(q, strategy=strategy)
            counts = got.mask.reshape(dp, -1, got.mask.shape[1]).sum(axis=1)
            expect = 2 * int((counts > 0).sum()) * idx
            same = same_winners(
                [_scored_ids(got, r, tables) for r in range(NUM_QUERIES)],
                [_scored_ids(want, r, tables) for r in range(NUM_QUERIES)],
                tol=1e-3 * float(np.nanmax(np.abs(want.merged_score))))
            if not (got.mask == want.mask).all():
                raise AssertionError(f"mesh {strategy}: masks differ")
            if launches["fused_topk"] != expect or traced != expect:
                raise AssertionError(
                    f"mesh {strategy}: K1 launched {launches['fused_topk']} "
                    f"times in two steps (profiler {traced}), {idx} per "
                    f"scored (row, shard) gives {expect}")
            tm = _timed_steps(mesh, q, strategy)
            ts = _timed_steps(single, q, strategy)
            recall = None
            if strategy == "all":       # every shard scored: one oracle
                oracles = oracles or OracleMemo(syn)
                oc = mesh.search(oracles.q, strategy=strategy)
                recall = engine_recall(syn.world, oc, oracles(oc.mask))
            log(f"[mesh] {dp}x{idx} over cuda:0 x {dp * idx}, B={NUM_QUERIES} "
                f"k={syn.world.k} {strategy}: winner sets equal the "
                f"single-card engine's on {same} of {NUM_QUERIES} (the rest "
                f"near-ties); K1 launches in two steps {launches['fused_topk']}"
                f" by the counter, {traced} by the profiler ({idx} per scored "
                f"row and shard: {counts.tolist()} routed); step host-clock "
                f"{np.median(tm):.2f} ms against the single card's "
                f"{np.median(ts):.2f} ms (median of {MESH_STEPS}); recall@"
                f"{syn.world.k} vs exact_oracle on {N_CHECK} queries "
                f"{'-' if recall is None else f'{recall:.6f}'} ({smi})")
            if recall is not None and recall < DTYPE_GATES["bfloat16"]:
                raise AssertionError(f"mesh {strategy}: recall {recall}")
            out[f"mesh_{strategy}"] = {"launches": launches,
                                       "recall": recall}
        del mesh
        log(f"[time] the 2x2 mesh checks done {time.perf_counter() - t0:.0f}"
            f" s after the single-card engine's build")
    finally:
        del single_sys, single
        gc.collect()
        torch.cuda.empty_cache()
    # (e) the medrag world under --dtype policy (int8 everywhere, exact)
    sysm = _serve_flags(root, dev, ["--dtype", "policy"])
    sysm.build()
    reset_counts()
    res = _policy_check("policy:medrag", sysm.server.engine, syn, dev,
                        N_CHECK)
    out["policy_medrag"] = {"launches": read_counts(), **res}
    log(f"[time] the medrag world's part of phase 9 took "
        f"{time.perf_counter() - t0:.0f} s")
    del sysm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_mesh_reduced(dev) -> dict:
    """Phase 9 (c): phase 4's reduced world (4 x 32,768) over a 1x4 mesh of
    ``cuda:0``: IVF (K3 + K2), low-rank, int8 and int4 through
    :class:`ShardedSearch`, and ``--impl hostrefine --mesh`` through
    :class:`MeshStreamedEngine`, each against its single-card engine."""
    from ragroute_tpu_torch.engine import FederatedSearchEngine
    from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine
    from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
    from ragroute_tpu_torch.index.streamed import StreamedShardSet
    from ragroute_tpu_torch.parallel import (MeshStreamedEngine,
                                             ShardedSearch, make_mesh)
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    syn = make_synthetic_world("medrag", docs_per_source=REDUCED_DOCS,
                               num_queries=N_CHECK, seed=5,
                               with_payloads=False, subclusters=64)
    q = dict(syn.query_embs)
    router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev)
    bank = RouterBank.create(syn.world, syn.centroids, device=dev)
    dp, idx = MESH_REDUCED
    devices = [dev] * (dp * idx)
    tables = [list(range(REDUCED_DOCS))] * syn.world.num_sources
    out = {}
    cases = (("mesh_ivf", torch.bfloat16, "ivf", {"ivf_clusters": -1},
              ("grouped_gains", "stream_topk")),
             ("mesh_lowrank", torch.bfloat16, "lowrank", {"lowrank": -1},
              ("fused_topk",)),
             ("mesh_int8", torch.int8, "auto", {}, ("fused_topk",)),
             ("mesh_int4", "int4", "auto", {}, ("fused_topk",)))
    for label, dtype, impl, build, kernels in cases:
        ss = ShardSet.build(syn.world, syn.embeddings, dtype=dtype,
                            device=dev, **build)
        single = FederatedSearchEngine(ss, router, bank, impl=impl)
        want = single.search(q, strategy="all")
        mesh = ShardedSearch(_shallow_set(ss), router, bank,
                             make_mesh(dp, idx, devices=devices), impl=impl)
        mesh.search(q, strategy="all")
        reset_counts()
        got = mesh.search(q, strategy="all")
        launches = read_counts()
        same = same_winners(
            [_scored_ids(got, r, tables) for r in range(N_CHECK)],
            [_scored_ids(want, r, tables) for r in range(N_CHECK)],
            tol=1e-3 * float(np.nanmax(np.abs(want.merged_score))))
        for name in kernels:
            if launches[name] <= 0:
                raise AssertionError(f"{label}: {name} never launched")
        log(f"[mesh:reduced] {label} over {dp}x{idx} (4 x {REDUCED_DOCS}): "
            f"winner sets equal the single-card engine's on {same} of "
            f"{N_CHECK} (the rest near-ties); launches {launches}")
        out[label] = {"launches": launches}
        del ss, single, mesh
        gc.collect()
        torch.cuda.empty_cache()
    # --impl hostrefine --mesh: a budget that keeps pubmed on the host
    budget = 3 * REDUCED_DOCS * (768 + 8) + 4096
    kw = dict(dtype="int8", tier="hostrefine", hbm_budget_bytes=budget,
              cluster_coarse=False, device=dev)
    a = StreamedShardSet.build(syn.world, syn.embeddings, **kw)
    b = StreamedShardSet.build(syn.world, syn.embeddings, **kw)
    if not any(s.coarse_docs is not None for s in a.sources):
        raise AssertionError("the hostrefine world has no coarse slab")
    single = StreamedSearchEngine(a, router, bank)
    mesh = MeshStreamedEngine(b, router, bank,
                              make_mesh(dp, idx, devices=devices))
    for fetch in (False, True):
        want = single.search(q, strategy="all", fetch_candidates=fetch)
        reset_counts()
        got = mesh.search(q, strategy="all", fetch_candidates=fetch)
        launches = read_counts()
        if not (np.array_equal(got.merged_shard, want.merged_shard)
                and np.array_equal(got.merged_local, want.merged_local)):
            raise AssertionError(f"hostrefine --mesh (fetch {fetch}) "
                                 f"differs from the single-card tier")
        if launches["fused_topk"] < idx:
            raise AssertionError(f"hostrefine --mesh: K1 {launches}")
    log(f"[mesh:reduced] mesh_hostrefine over {dp}x{idx}: winners equal the "
        f"single-card tier's in both copy modes; launches {launches}")
    out["mesh_hostrefine"] = {"launches": launches}
    return out


def _mesh_1x1_http(root: str, dev, questions: list, want: list) -> dict:
    """``--mesh 1x1`` through aiohttp and the native front end: the
    single-card server's answers (``want``) to the same questions."""
    out = {}
    for front in ("aiohttp", "native"):
        sysm = _serve_flags(root, dev, ["--mesh", "1x1", "--frontend",
                                        front])
        sysm.build()
        if type(sysm.server.engine).__name__ != "ShardedSearch":
            raise AssertionError("--mesh 1x1 did not build ShardedSearch")
        if front == "native":
            thread = _start_native(sysm)
            port = sysm.native.bound_port
        else:
            stop = _serve_aiohttp(sysm)
            port = sysm.server.bound_port
        try:
            reset_counts()
            got = _bodies(port, questions)
            launches = read_counts()
        finally:
            if front == "native":
                _stop_native(sysm, thread)
            else:
                stop()
        _same_bodies(f"--mesh 1x1 {front}", got, want)
        log(f"[mesh] --mesh 1x1 through {front}: {len(got)} answers equal "
            f"the single-card server's; launches {launches}")
        out[f"mesh_{front}"] = {"launches": launches}
        del sysm
    return out


def phase_cluster(dev) -> dict:
    """Phase 9 (b) and (d) over a world of 4 x 16,384 docs written for
    them: the single-card server's answers and three aiohttp
    ``/admin/profile`` captures under load; ``--mesh 1x1`` through both
    front ends (:func:`_mesh_1x1_http`); then a two-process cluster on the
    one card (``--num-processes 2 --mesh 2x2``, each process naming
    ``cuda:0`` twice, gloo between them): a burst through the leader
    answers as the single-process server does; the follower logs its
    steps; SIGTERM on the leader ends both."""
    import signal

    from ragroute_tpu_torch.index import make_synthetic_world
    from ragroute_tpu_torch.index.synthetic import save_world
    from ragroute_tpu_torch.system import free_port

    root = tempfile.mkdtemp(prefix="ragroute_cluster_")
    procs = []
    out = {}
    try:
        syn = make_synthetic_world("medrag", docs_per_source=CLUSTER_DOCS,
                                   num_queries=CLUSTER_QUESTIONS, seed=6)
        save_world(syn, root)
        questions = [{"qid": q["qid"], "question": q["question"]}
                     for q in syn.questions]
        single = _serve_flags(root, dev, [])
        single.build()
        stop = _serve_aiohttp(single)
        try:
            want = _bodies(single.server.bound_port, questions)
            _aiohttp_captures(single.server.bound_port, syn, "mesh")
        finally:
            stop()
        del single
        out.update(_mesh_1x1_http(root, dev, questions, want))
        gc.collect()
        torch.cuda.empty_cache()
        http, coord = free_port(), free_port()
        env = dict(os.environ, RAGROUTE_LOCAL_DEVICES="2")
        t0 = time.perf_counter()
        for pid in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ragroute_tpu_torch.main",
                 "--dataset", "medrag", "--routing", "ragroute",
                 "--disable-llm", "--data-root", root, "--device", str(dev),
                 "--mesh", "2x2", "--num-processes", "2", "--process-id",
                 str(pid), "--coordinator", f"127.0.0.1:{coord}", "--port",
                 str(http)],
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.time() + 300
        while time.time() < deadline:
            if any(p.poll() is not None for p in procs):
                raise AssertionError("a cluster process ended early")
            try:
                if _http(http, "GET", "/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        up = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = _bodies(http, questions)
        burst = time.perf_counter() - t0
        procs[0].send_signal(signal.SIGTERM)
        logs = [p.communicate(timeout=120)[0] for p in procs]
        rcs = [p.returncode for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    steps = [line for line in logs[1].splitlines() if "process 1: step" in line]
    log(f"[cluster] 2 processes x cuda:0 x 2, --mesh 2x2: up in {up:.1f} s; "
        f"{len(got)} GET /query at once through the leader in {burst:.3f} s; "
        f"the follower logged {len(steps)} steps (last: "
        f"{steps[-1].strip() if steps else None}); exit codes {rcs}")
    if rcs != [0, 0] or not steps:
        raise AssertionError(f"cluster: exit codes {rcs}; leader log "
                             f"{logs[0][-2000:]}\nfollower log "
                             f"{logs[1][-2000:]}")
    _same_bodies("the cluster's leader", got, want)
    return out


def phase_policy_feb4rag(dev) -> dict:
    """Phase 9 (e): phase 7's feb4rag world (262,144 docs, 13 sources)
    under ``--dtype policy``: the system's picks (``ServingSystem``'s own
    policy step), each shard built in its pick, the picks and the index
    bytes, each shard's recall at its gate and the scan K1 runs for it;
    served over HTTP. The world stays in memory (``FederationServer`` over
    it, as phase 7 serves it): writing its 262,144 rows and payloads to a
    data root would take longer than the rest of the phase."""
    from ragroute_tpu_torch.engine import FederatedSearchEngine
    from ragroute_tpu_torch.engine.embedding import PrecomputedEmbeddings
    from ragroute_tpu_torch.engine.server import FederationServer
    from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
    from ragroute_tpu_torch.index.store import MemoryDocStore
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank
    from ragroute_tpu_torch.system import ServingSystem

    t0 = time.perf_counter()
    syn = make_synthetic_world("feb4rag", docs_per_source=FEB_DOCS // 13,
                               num_queries=N_CHECK, seed=0)
    world = syn.world
    system = ServingSystem(parse_args([
        "--dataset", "feb4rag", "--routing", "all", "--disable-llm",
        "--port", "0", "--device", str(dev), "--dtype", "policy"]))
    dtype, lowrank = system._storage()
    ss = ShardSet.build(world, syn.embeddings, doc_ids=syn.doc_ids,
                        dtype=dtype, lowrank=lowrank, device=dev)
    engine = FederatedSearchEngine(
        ss, CorpusRouter.from_seed(world.router_input_dim, 0, dev),
        RouterBank.create(world, syn.centroids, device=dev),
        impl=system.impl)
    log(f"[policy:feb4rag] {ss.total_docs} docs built under --dtype policy "
        f"in {time.perf_counter() - t0:.1f} s (impl {system.impl})")
    server = FederationServer(
        engine, strategy="all",
        embedding_provider=PrecomputedEmbeddings.from_synthetic(syn),
        doc_store=MemoryDocStore.from_synthetic(syn), disable_llm=True,
        port=0)
    stop = _serve_aiohttp(server)
    try:
        reset_counts()
        bodies = _bodies(server.bound_port, [
            {"qid": q["qid"], "question": q["question"]}
            for q in syn.questions[:16]])
        served = read_counts()
    finally:
        stop()
    if not all(len(b["metadata"]["top_docs"]) for b in bodies):
        raise AssertionError("policy:feb4rag: an answer without docs")
    res = _policy_check("policy:feb4rag", engine, syn, dev, N_CHECK)
    del server, engine, ss
    gc.collect()
    torch.cuda.empty_cache()
    return {"policy_feb4rag": {"launches": served, **res}}


def phase_mesh(dev, smi: str, medrag: bool = False) -> dict:
    """Phase 9 alone (``python3 chip_smoke.py mesh``) or its parts after
    phase 3 (``medrag``: the medrag world made here)."""
    from ragroute_tpu_torch.index.synthetic import (make_synthetic_world,
                                                    save_world)

    t_start = time.perf_counter()
    out = {}
    if medrag:
        root = tempfile.mkdtemp(prefix="ragroute_smoke_")
        try:
            syn = make_synthetic_world(
                "medrag", docs_per_source_map=MEDRAG_DOCS,
                num_queries=NUM_QUERIES, seed=0)
            save_world(syn, root)
            out.update(phase_mesh_medrag(root, dev, syn, smi))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        del syn
        gc.collect()
    t0 = time.perf_counter()
    out.update(phase_mesh_reduced(dev))
    log(f"[time] mesh layouts over the reduced world took "
        f"{time.perf_counter() - t0:.0f} s")
    t0 = time.perf_counter()
    out.update(phase_cluster(dev))
    log(f"[time] --mesh 1x1 over HTTP, the aiohttp captures and the cluster "
        f"took {time.perf_counter() - t0:.0f} s")
    t0 = time.perf_counter()
    out.update(phase_policy_feb4rag(dev))
    log(f"[time] the feb4rag policy took {time.perf_counter() - t0:.0f} s")
    log(f"[time] phase 9 (without the medrag world's part: "
        f"{not medrag}) took {time.perf_counter() - t_start:.0f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    only = sys.argv[1] if len(sys.argv) > 1 else "all"
    logging.basicConfig(level=logging.WARNING, stream=sys.stdout)
    for name in ("ivf", "lowrank", "shard", "streamed"):
        logging.getLogger(name).setLevel(logging.INFO)
    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    smi = phase_environment()
    if only == "tiers":        # the host tiers alone
        phase_reduced_tiers(dev)
        phase_tiers(dev)
        log(f"[time] host tiers done at {time.perf_counter() - t_start:.0f} s")
        return 0
    if only == "surface":      # the live index, workers and SSE paths
        phase_fused_live(dev)
        phase_live_quant(dev)
        paths = phase_main_paths(dev, surface_only=True, zoo=False)
        log(f"[time] serving surface done at "
            f"{time.perf_counter() - t_start:.0f} s")
        report(smi, {}, paths)
        return 0
    if only == "encoders":     # the live query encoders (phase 7)
        paths = phase_encoders(dev, smi, medrag=True)
        log(f"[time] encoders done at {time.perf_counter() - t_start:.0f} s")
        report(smi, {}, paths)
        return 0
    if only == "offline":      # the offline path (phase 8)
        paths = phase_offline(dev)
        log(f"[time] offline path done at {time.perf_counter() - t_start:.0f}"
            f" s")
        report(smi, {}, paths)
        return 0
    if only == "mesh":         # meshes, the cluster, the policy (phase 9)
        paths = phase_mesh(dev, smi, medrag=True)
        log(f"[time] mesh phase done at {time.perf_counter() - t_start:.0f} s")
        report(smi, {}, paths)
        return 0
    if only == "llm":          # the decoder's kernels and generation
        kres = phase_decoder_kernels(dev)
        log(f"[time] decoder kernels checked at "
            f"{time.perf_counter() - t_start:.0f} s")
        paths = phase_generation(dev, smi)
        log(f"[time] generation done at {time.perf_counter() - t_start:.0f} s")
        report(smi, kres, paths)
        return 0
    kres = phase_kernels(dev)
    log(f"[time] kernels checked at {time.perf_counter() - t_start:.0f} s")
    if only == "kernels":      # a short first run after a kernel change
        return 0
    phase_reduced(dev)
    phase_live_quant(dev)
    phase_reduced_tiers(dev)
    log(f"[time] reduced worlds done at {time.perf_counter() - t_start:.0f} s")
    paths = phase_main_paths(dev, smi=smi)
    log(f"[time] served paths done at {time.perf_counter() - t_start:.0f} s")
    paths.update(phase_tiers(dev))
    log(f"[time] host tiers done at {time.perf_counter() - t_start:.0f} s")
    paths.update(phase_generation(dev, smi))
    log(f"[time] generation done at {time.perf_counter() - t_start:.0f} s")
    paths.update(phase_encoders(dev, smi))
    log(f"[time] encoders done at {time.perf_counter() - t_start:.0f} s")
    paths.update(phase_offline(dev))
    log(f"[time] offline path done at {time.perf_counter() - t_start:.0f} s")
    paths.update(phase_mesh(dev, smi))
    log(f"[time] mesh phase done at {time.perf_counter() - t_start:.0f} s")
    report(smi, kres, paths)
    return 0


def report(smi: str, kres: dict, paths: dict) -> None:
    """The card's line, the kernels' line and the contract's last line."""
    log(smi)
    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        if name not in kres:
            continue
        by_path = {p: r["launches"][name] for p, r in paths.items()
                   if p in PATH_KERNELS}
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path[p] for p, ks in PATH_KERNELS.items()
                            if name in ks and p in by_path),
            "launches_by_path": by_path, **kres[name]}
        for extra in ("deep", "wgmma", "fold", "f32"):
            if hasattr(KERNELS[name][0], f"{extra}_launches"):
                row[f"{extra}_launches_by_path"] = {
                    p: r["launches"][extra][name] for p, r in paths.items()
                    if p in PATH_KERNELS}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
