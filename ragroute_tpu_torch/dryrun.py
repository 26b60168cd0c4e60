"""Whole-stack checks: one forward step, and the dry run over a mesh.

Counterpart of the JAX package's ``__graft_entry__.py``:

* :func:`entry` returns ``(fn, example_args)``: route plus score over the
  medrag world at ``_build_world``'s shapes, one forward step on the card;
* :func:`dryrun_multichip` runs the framework's training and serving over a
  ``(dp, idx)`` mesh of one device named ``n`` times (``cuda:0`` unless the
  caller names another; the CPU only when named): routers trained by the
  dp-sharded step on five worlds, each world served by ``ShardedSearch``,
  the hostrefine tier, the low-rank mode and sharded IVF over the mesh, one
  real ``/query`` over HTTP, and tensor-parallel generation through
  ``generate`` and the continuous service with a shared prefix.

Run it::

    python -m ragroute_tpu_torch.dryrun [N] [--device cpu]

(N defaults to 8: a 2x4 mesh.) The JAX package's compile cache has no
counterpart here: the kernels' builds are cached by ``ops/_build.py``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import urllib.parse
import urllib.request

import numpy as np
import torch

from ragroute_tpu_torch.utils.precision import resolve_device

# the dry run's decoder: the JAX package's tiny config, with the byte
# tokenizer's vocabulary (its ids reach 258: the JAX decoder clamps ids past
# a vocabulary of 64, torch's lookup refuses them)
LLM_VOCAB = 260
SYSTEM_HEAD = "mesh dryrun system head"


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _build_world(docs_per_source=2048, num_queries=64, seed=0,
                 world_name="medrag", dtype=None, device="cpu"):
    from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    syn = make_synthetic_world(
        world_name, docs_per_source=docs_per_source,
        num_queries=num_queries, seed=seed, with_payloads=False)
    shard_set = ShardSet.build(syn.world, syn.embeddings,
                               dtype=dtype or torch.bfloat16, device=device)
    router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, device)
    bank = RouterBank.create(syn.world, syn.centroids, device=device)
    return syn, shard_set, router, bank


def entry(device=None):
    """``(fn, example_args)``: ``fn(*example_args)`` is one forward step of
    the flagship model (router MLP gating, the four shards' exact top-k,
    the segmented merge) on ``device`` (default the card); it returns
    ``(probs, mask) + _score_fn``'s outputs, the mask ``[B, N]``."""
    from ragroute_tpu_torch.engine.engine import _route_fn, _score_fn

    dev = resolve_device(device or "cuda")
    syn, shard_set, router, bank = _build_world(device=dev)
    world = shard_set.world
    arrays = shard_set.arrays()
    n_docs = tuple(s.n_docs for s in shard_set.shards)
    packed = tuple(s.packed4 for s in shard_set.shards)

    @torch.no_grad()
    def forward(router, bank, arrays, query_embs, generator):
        probs, mask = _route_fn(world, "ragroute", router, bank, query_embs,
                                generator)
        return (probs, mask) + _score_fn(world, world.k, "auto", n_docs,
                                         arrays, query_embs, mask, True,
                                         packed)

    embs = {enc: torch.from_numpy(np.asarray(syn.query_embs[enc],
                                             np.float32)).to(dev)
            for enc in world.encoders}
    example_args = (router, bank, arrays, embs,
                    torch.Generator(device=dev).manual_seed(1))
    return forward, example_args


def _train_router_dp(mesh, world, bank, syn_w, router, steps=24):
    """A few dp-sharded router training steps (the batch split over every
    cell, the gradients summed on the primary): the trained router and the
    first and last losses. The serving probes run on trained routers, so an
    over-pruning mask cannot hide behind a random gate's zeros."""
    from ragroute_tpu_torch.index.synthetic import contribution_labels
    from ragroute_tpu_torch.router import build_features
    from ragroute_tpu_torch.train.train_router import dp_train_step

    dev = mesh.primary
    labels = contribution_labels(syn_w)                       # [Q, N]
    with torch.no_grad():
        feats = build_features(world, bank, {
            e: torch.from_numpy(syn_w.query_embs[e]).to(dev)
            for e in world.encoders})
    x = feats.reshape(-1, world.router_input_dim).to(torch.float32)
    y = torch.from_numpy(labels.reshape(-1).astype(np.float32)).to(dev)
    # class-balanced BCE: a sparse-relevance world (1 to 3 of 10+ sources)
    # would otherwise sit below the threshold for many steps
    pos = float((y == 1).sum())
    pw = float((y == 0).sum()) / max(pos, 1.0)
    opt = torch.optim.Adam(router.parameters(), lr=5e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    loss0 = loss = None
    for _ in range(steps):
        loss = dp_train_step(router, opt, sched, x, y, mesh, pw, gen)
        if loss0 is None:
            loss0 = float(loss)
    return router.eval(), loss0, float(loss)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Train and serve over a mesh of ``device`` (default the card) named
    ``n_devices`` times, at tiny shapes, and check each step as the JAX
    package's dry run does. Returns its results and prints its line."""
    from ragroute_tpu_torch.engine.batcher import QueryBatcher
    from ragroute_tpu_torch.engine.embedding import PrecomputedEmbeddings
    from ragroute_tpu_torch.engine.server import FederationServer
    from ragroute_tpu_torch.index import ShardSet
    from ragroute_tpu_torch.index.ivf import build_ivf
    from ragroute_tpu_torch.index.streamed import StreamedShardSet
    from ragroute_tpu_torch.llm.continuous import (ContinuousGenerationService,
                                                   shared_prefix_ids)
    from ragroute_tpu_torch.llm.model import (DecoderConfig, generate,
                                              init_decoder_params)
    from ragroute_tpu_torch.llm.service import ByteTokenizer
    from ragroute_tpu_torch.llm.sharding import shard_decoder_params
    from ragroute_tpu_torch.parallel import (MeshStreamedEngine,
                                             ShardedSearch, make_mesh,
                                             sharded_ivf_topk)

    dev = resolve_device(device or "cuda")
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(dp=dp, idx=n_devices // dp, devices=[dev] * n_devices)

    # --- serving step: docs sharded over idx, batch over dp ---------------
    # every world shape the framework serves: medrag (768-d dot, bf16, int8
    # and int4), feb4rag (768 / 1024 / 4096-d, cos and dot), wikipedia
    # (l2); each router dp-trained first, the probes checking fan-out and
    # non-empty merges
    results, losses = {}, {}
    for tag, world_name, dtype in (
            ("medrag/bf16", "medrag", torch.bfloat16),
            ("medrag/int8", "medrag", torch.int8),
            ("medrag/int4", "medrag", "int4"),
            ("feb4rag/bf16", "feb4rag", torch.bfloat16),
            ("wikipedia/bf16", "wikipedia", torch.bfloat16)):
        syn_w, shards_w, router_w, bank_w = _build_world(
            docs_per_source=1024, num_queries=32, world_name=world_name,
            dtype=dtype, device=dev)
        router_t, l0, l1 = _train_router_dp(mesh, shards_w.world, bank_w,
                                            syn_w, router_w)
        _check(l1 < l0, f"{tag}: dp-sharded training did not reduce loss "
                        f"({l0:.4f} -> {l1:.4f})")
        losses[tag] = (round(l0, 4), round(l1, 4))
        sharded = ShardedSearch(shards_w, router_t, bank_w, mesh,
                                impl="auto")
        out_w = sharded.search(syn_w.query_embs, strategy="ragroute")
        routed_q = out_w.mask.any(axis=1)
        _check(routed_q.mean() >= 0.5,
               f"{tag}: trained router routed only {routed_q.sum()}/"
               f"{len(routed_q)} probe queries: degenerate fan-out")
        _check(bool((out_w.merged_valid[routed_q] > 0).all()),
               f"{tag}: routed queries with EMPTY merges: "
               f"{out_w.merged_valid[routed_q].tolist()}")
        results[tag] = {
            "routed_frac": round(float(out_w.mask.mean()), 3),
            "merged_valid_head": out_w.merged_valid[:4].tolist(),
        }
        if tag == "medrag/bf16":
            syn, bank, router = syn_w, bank_w, router_t
            sharded_medrag = sharded
    world = syn.world

    # --- the capacity tier over the mesh: hostrefine's coarse slabs
    # row-sharded over idx, candidates gathered, exact rescore on the host
    sset_hr = StreamedShardSet.build(
        world, syn.embeddings, dtype="int8", tier="hostrefine",
        hbm_budget_bytes=0, cluster_coarse=False, device=dev)
    out_hr = MeshStreamedEngine(sset_hr, router, bank, mesh).search(
        syn.query_embs, strategy="ragroute")
    routed_hr = out_hr.mask.any(axis=1)
    _check(bool((out_hr.merged_valid[routed_hr] > 0).all()),
           f"mesh hostrefine: routed queries with empty merges: "
           f"{out_hr.merged_valid[routed_hr].tolist()}")
    results["medrag/hostrefine-mesh"] = {
        "routed_frac": round(float(out_hr.mask.mean()), 3),
        "merged_valid_head": out_hr.merged_valid[:4].tolist(),
    }
    del sset_hr

    # --- two-stage low-rank mode: the coarse slab row-sharded over idx ---
    shards_lr = ShardSet.build(world, syn.embeddings, dtype=torch.bfloat16,
                               lowrank=-1, device=dev)
    out_lr = ShardedSearch(shards_lr, router, bank, mesh,
                           impl="lowrank").search(syn.query_embs,
                                                  strategy="ragroute")
    results["medrag/lowrank"] = out_lr.merged_valid[:4].tolist()
    del shards_lr

    # --- IVF: the layout built over the mesh (Lloyd sums a cell, added
    # across cells), then served with the cluster axis sharded over idx
    src0 = world.sources[0]
    ivf = build_ivf(syn.embeddings[src0.name], "dot", dtype=torch.bfloat16,
                    n_clusters=16, mesh=mesh, device=dev)
    _, i_ivf = sharded_ivf_topk(
        mesh, torch.from_numpy(syn.query_embs[src0.encoder]).to(dev), ivf,
        world.k, mode="dot", nprobe=4)
    results["medrag/ivf"] = i_ivf[0, :4].tolist()

    # --- the training step's strict gate: a clear loss drop on the
    # flagship world (a step printing about ln 2 would not catch a mesh
    # step that computes garbage gradients)
    loss0, loss_end = losses["medrag/bf16"]
    _check(loss_end < loss0 - 0.02,
           f"dp-sharded training did not learn: loss {loss0:.4f} -> "
           f"{loss_end:.4f}")

    # --- the federation served over the mesh: one real HTTP query through
    # FederationServer -> QueryBatcher -> ShardedSearch
    async def serve_one_query():
        server = FederationServer(
            sharded_medrag, strategy="ragroute",
            embedding_provider=PrecomputedEmbeddings.from_synthetic(syn),
            disable_llm=True, port=0, warmup=False,
            batcher=QueryBatcher(sharded_medrag, strategy="ragroute",
                                 window_ms=2.0, buckets=(dp,)))
        await server.start()
        try:
            q = syn.questions[0]
            url = (f"http://127.0.0.1:{server.bound_port}/query?"
                   f"q={urllib.parse.quote(q['question'])}"
                   f"&choices={urllib.parse.quote(json.dumps(q['options']))}"
                   f"&qid={q['qid']}")
            loop = asyncio.get_running_loop()
            body = await loop.run_in_executor(
                None, lambda: json.load(urllib.request.urlopen(url,
                                                               timeout=120)))
            md = body["metadata"]
            return {"sources": md["data_sources"],
                    "n_top_docs": len(md["top_docs"])}
        finally:
            await server.stop()

    served = asyncio.run(serve_one_query())

    # --- tensor-parallel generation: weights over idx, batch over dp
    n_idx = mesh.shape["idx"]
    llm_cfg = DecoderConfig(vocab_size=LLM_VOCAB, hidden_size=32,
                            num_layers=2, num_heads=8,
                            num_kv_heads=max(4, n_idx), head_dim=8,
                            intermediate_size=8 * n_idx)
    plain = init_decoder_params(3, llm_cfg, device=dev)
    llm_params = shard_decoder_params(plain, llm_cfg, mesh)
    prompt = torch.ones((2 * dp, 8), dtype=torch.int32, device=dev)
    with torch.no_grad():
        toks, _ = generate(llm_params, llm_cfg, prompt, prompt, 4, eos_id=-1,
                           pad_id=0)
        want, _ = generate(plain, llm_cfg, prompt, prompt, 4, eos_id=-1,
                           pad_id=0)
    _check(torch.equal(toks, want),
           f"TP generate {toks.tolist()} != one device {want.tolist()}")
    llm_row = toks[0].tolist()

    # --- continuous serving over the same TP weights with the shared-prefix
    # KV: slot admission, chunked decode and the prefix segment
    tok = ByteTokenizer()

    async def serve_continuous():
        svc = ContinuousGenerationService(
            llm_params, llm_cfg, tok, slots=2, cache_len=160,
            max_new_tokens=6, prompt_buckets=(64,), chunk_steps=3,
            cache_dtype=torch.float32, eos_id=tok.eos_id, pad_id=tok.pad_id,
            prefix_ids=shared_prefix_ids(tok, SYSTEM_HEAD))
        try:
            return await svc.chat([
                {"role": "system", "content": SYSTEM_HEAD},
                {"role": "user", "content": "hello mesh"}])
        finally:
            await svc.stop()

    cont_answer = asyncio.run(serve_continuous())

    out = {"mesh": dict(mesh.shape), "worlds": results, "losses": losses,
           "served_query": served, "llm_tp_tokens": llm_row,
           "llm_tp_continuous_prefix_chars": len(cont_answer)}
    print(f"dryrun_multichip ok: mesh={out['mesh']}, worlds={results} (all "
          f"routers dp-trained first; fan-out + non-empty merges asserted), "
          f"train losses={losses} (medrag drop asserted), "
          f"served_query={served}, llm_tp_tokens={llm_row}, "
          f"llm_tp_continuous_prefix_chars={len(cont_answer)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="cells of the mesh (default 8: 2x4)")
    ap.add_argument("--device", default="cuda",
                    help="the device the mesh names n times (default the "
                         "card; 'cpu' for a debug run)")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print(f"entry ok: mask {tuple(out[1].shape)}")
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
