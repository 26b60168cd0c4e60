"""``--dtype policy`` per shard (CPU), against the JAX package.

The picks (``config.store_dtype_policy``) are the JAX package's: medrag and
wikipedia (768-d dot / l2) int8; feb4rag int4 + low-rank for ``trec-covid``
(4,096-d cos), bfloat16 for the nine 1,024-d and 768-d cos sources, int8
for ``scidocs``, ``fiqa`` and ``scifact``. The port builds each shard in
its own pick and serves ``--impl auto`` as low-rank on the shard with a
coarse layout and exact elsewhere; each shard's candidate list is held to
the JAX engine over a shard set built in that shard's pick (the low-rank
layout carried over through the ``.npz`` file both packages read), with
scores within f32 summation-order tolerance. R3: the JAX system asks for
the whole world as int4 + low-rank; the port does not copy that.
"""

import argparse

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from ragroute_tpu import config as jcfg
from ragroute_tpu.engine import FederatedSearchEngine as JEngine
from ragroute_tpu.index import ShardSet as JShardSet
from ragroute_tpu.router import RouterBank as JBank
from ragroute_tpu_torch import config as cfg
from ragroute_tpu_torch.engine import FederatedSearchEngine
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.index.lowrank import load_lowrank
from ragroute_tpu_torch.main import parse_args
from ragroute_tpu_torch.router import RouterBank
from ragroute_tpu_torch.system import ServingSystem
from torch_serving import _params, port_engine

FEB_INT8 = {"scidocs", "fiqa", "scifact"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


@pytest.mark.parametrize("name", ["medrag", "feb4rag", "wikipedia"])
def test_picks_are_the_jax_packages(name):
    world = cfg.get_world(name)
    picks = {s.name: cfg.store_dtype_policy(s.embed_dim, s.score_mode)
             for s in world.sources}
    assert picks == {s.name: jcfg.store_dtype_policy(s.embed_dim,
                                                     s.score_mode)
                     for s in world.sources}
    if name == "feb4rag":
        assert picks.pop("trec-covid") == ("int4", True)
        assert {n for n, p in picks.items() if p == ("int8", False)} \
            == FEB_INT8
        assert sum(p == ("bfloat16", False) for p in picks.values()) == 9
    else:
        assert set(picks.values()) == {("int8", False)}


@pytest.fixture(scope="module")
def feb():
    return make_synthetic_world("feb4rag", docs_per_source=512, num_queries=8,
                                seed=4, with_payloads=False)


def test_feb4rag_shards_are_held_to_jax_in_their_own_pick(feb, tmp_path):
    """One port world in mixed dtypes; per pick, the JAX engine over a set
    built in that pick (the low-rank layout of ``trec-covid`` built by the
    JAX package alone and carried over): every shard's (scores, ids)
    agree."""
    import dataclasses

    from ragroute_tpu.index.lowrank import save_lowrank

    syn = feb
    names = [s.name for s in syn.world.sources]
    picks = {s.name: cfg.store_dtype_policy(s.embed_dim, s.score_mode)
             for s in syn.world.sources}
    tdt = {"int4": "int4", "bfloat16": torch.bfloat16, "int8": torch.int8}
    tss = ShardSet.build(syn.world, syn.embeddings,
                         dtype={n: tdt[d] for n, (d, _) in picks.items()})
    single = port_engine(syn, tss, 1)
    embs = dict(syn.query_embs)
    jdt = {"int4": "int4", "bfloat16": jnp.bfloat16, "int8": jnp.int8}
    groups = {}
    for n, p in picks.items():
        groups.setdefault(p, []).append(n)
    jouts = {}
    for (dt, lr), members in groups.items():
        jss = JShardSet.build(syn.world, syn.embeddings, dtype=jdt[dt])
        if lr:
            for n in members:
                si = names.index(n)
                sub = dataclasses.replace(
                    syn.world, sources=(syn.world.sources[si],))
                jlr = JShardSet.build(sub, {n: syn.embeddings[n]},
                                      dtype=jdt[dt], lowrank=-1).shards[0].lr
                jss.shards[si] = jss.shards[si].replace(lr=jlr)
                path = str(tmp_path / f"{si}_lr.npz")
                save_lowrank(jlr, path)
                tss.shards[si].lr = load_lowrank(path)
            jss.lowrank_built = tss.lowrank_built = True
        jeng = JEngine(jss, _params(syn, 1),
                       JBank.create(syn.world, syn.centroids),
                       impl="lowrank" if lr else "exact")
        jouts[(dt, lr)] = jeng.search(embs, strategy="all")
    teng = FederatedSearchEngine(tss, single.router, single.bank,
                                 impl="lowrank")
    t = teng.search(embs, strategy="all")
    for (dt, lr), members in groups.items():
        j = jouts[(dt, lr)]
        for n in members:
            si = names.index(n)
            shard = tss.shards[si]
            assert shard.packed4 == (dt == "int4")
            if dt != "int4":
                assert shard.docs.dtype == tdt[dt]
            assert (shard.lr is not None) == lr
            js, ts = j.shard_scores[:, si], t.shard_scores[:, si]
            tol = 1e-5 * float(np.abs(js).max())
            np.testing.assert_allclose(ts, js, rtol=1e-5, atol=tol)
            ji, ti = j.shard_ids[:, si], t.shard_ids[:, si]
            for r, p in zip(*np.nonzero(ti != ji)):
                near = np.abs(js[r] - js[r, p]) <= tol
                assert near.sum() > 1 and ti[r, p] in ji[r][near], (n, r, p)


def _policy_args(dataset, **kw):
    argv = ["--dataset", dataset, "--simulate", "--disable-llm", "--device",
            "cpu", "--dtype", "policy", "--port", "0", "--buckets", "8"]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    return parse_args(argv)


class _Captured(Exception):
    pass


def test_system_serves_each_shard_in_its_pick_not_r3(caplog, monkeypatch):
    """The port's system builds each feb4rag shard in its pick, logs one
    line a source, serves ``--impl auto`` as low-rank, and ``/healthz``'s
    bytes add up the mixed shards. R3 is recorded, not copied: the JAX
    system asks its shard set for int4 + low-rank across the world, so
    its bfloat16-pick shards would be int4."""
    import logging

    import ragroute_tpu.system as jsystem

    caplog.set_level(logging.INFO, logger="system")
    system = ServingSystem(_policy_args("feb4rag"))
    server = system.build()
    ss = server.engine.shard_set
    assert system.impl == "lowrank" and server.engine.impl == "lowrank"
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("dtype policy:")]
    assert len(lines) == 13
    assert "dtype policy: trec-covid -> int4 + low-rank" in lines
    kinds = []
    for src, s in zip(system.world.sources, ss.shards):
        dt, lr = cfg.store_dtype_policy(src.embed_dim, src.score_mode)
        kinds.append(dt)
        assert s.packed4 == (dt == "int4")
        assert (s.lr is not None) == lr
        if dt == "int8":
            assert s.docs.dtype == torch.int8 and s.scale is not None
        elif dt == "bfloat16":
            assert s.docs.dtype == torch.bfloat16 and s.scale is None
    assert kinds.count("bfloat16") == 9 and kinds.count("int8") == 3
    want = sum(s.docs.numel() * s.docs.element_size() + s.bias.numel() * 4
               for s in ss.shards)
    assert ss.index_bytes == want
    # R3: what the JAX system asks its ShardSet for under the policy
    asked = {}

    def capture(*a, **kw):
        asked.update(kw)
        raise _Captured

    monkeypatch.setattr(jsystem.ShardSet, "build", capture)
    jsys = jsystem.ServingSystem(argparse.Namespace(
        dataset="feb4rag", routing="all", disable_llm=True, simulate=True,
        model="llama3.1-8B-instruct", data_root=None, port=0,
        dtype="policy", impl="auto", buckets=(8,)))
    with pytest.raises(_Captured):
        jsys.build()
    assert asked["dtype"] == "int4" and asked["lowrank"] == -1
    assert jsys.impl == "lowrank"
    # medrag: every pick int8, served exact
    m = ServingSystem(_policy_args("medrag"))
    mss = m.build().engine.shard_set
    assert m.impl == "auto"
    assert all(s.docs.dtype == torch.int8 for s in mss.shards)


def test_lowrank_mapping_builds_only_the_named_sources():
    syn = make_synthetic_world("medrag", docs_per_source=512, num_queries=4,
                               seed=2, with_payloads=False)
    ss = ShardSet.build(syn.world, syn.embeddings, dtype={
        "pubmed": "int8", "statpearls": torch.bfloat16,
        "textbooks": torch.float32, "wikipedia": "int4"},
        lowrank={"statpearls": -1})
    assert [s.lr is not None for s in ss.shards] == [False, True, False,
                                                     False]
    assert ss.lowrank_built
    assert [s.docs.dtype for s in ss.shards[:3]] == [
        torch.int8, torch.bfloat16, torch.float32]
    assert ss.shards[3].packed4
    router = port_engine(syn, ss, 0)
    out = FederatedSearchEngine(ss, router.router, RouterBank.create(
        syn.world, syn.centroids), impl="lowrank").search(
            dict(syn.query_embs), strategy="all")
    assert (out.merged_valid == syn.world.k).all()
    with pytest.raises(KeyError, match="no storage dtype"):
        ShardSet.build(syn.world, syn.embeddings, dtype={"pubmed": "int8"})
