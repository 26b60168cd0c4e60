"""The port's snapshot of a live index against the JAX package's (CPU).

After the same adds and deletes, ``ShardSet.snapshot`` of the JAX package
and of the port write byte-identical ``embeddings.npy`` and
``doc_ids.json``; ``POST /admin/snapshot`` on both servers (aiohttp and
native front ends) answers the same bytes and writes the same payload
jsonl too; and the port, reloaded from its snapshot, serves the winners
the live index served.
"""

import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu.engine.native_frontend import \
    NativeFederationServer as JNative
from ragroute_tpu_torch.engine.native_frontend import NativeFederationServer
from ragroute_tpu_torch.index import ShardSet
from torch_serving import (engines, port_engine, request, same_answers,
                           servers, serving, shard_sets, world)


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _churn(syn, ss, seed=0):
    """Delete three build-time docs a source and add five new ones (three
    into the freed slots, two into the reserve)."""
    rng = np.random.default_rng(seed)
    for src in syn.world.sources:
        ids = syn.doc_ids[src.name]
        ss.delete_docs(src.name, doc_ids=[ids[5], ids[6], ids[7]])
        fresh = rng.standard_normal((5, src.embed_dim)).astype(np.float32)
        ss.add_docs(src.name, fresh,
                    doc_ids=[f"fresh-{src.name}-{i}" for i in range(5)])


def _files(root, syn, payloads=False):
    out = {}
    for src in syn.world.sources:
        d = ShardSet.source_dir(root, syn.world.name, src.name)
        names = ["embeddings.npy", "doc_ids.json"]
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[(src.name, n)] = f.read()
        if payloads:
            with open(os.path.join(root, syn.world.name, "payloads",
                                   f"{src.name}.jsonl"), "rb") as f:
                out[(src.name, "payloads")] = f.read()
    return out


def _winner_ids(syn, ss, out):
    return [[(int(s), str(ss.doc_ids[syn.world.sources[s].name][int(l)]))
             for s, l in zip(out.merged_shard[q], out.merged_local[q])
             if s >= 0] for q in range(out.merged_shard.shape[0])]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_snapshot_files_byte_identical_to_jax(tmp_path, dtype):
    syn = world(docs=400, nq=8, seed=11)
    jss, tss = shard_sets(syn, dtype=dtype, mutable=True, reserve_docs=32)
    _churn(syn, jss)
    _churn(syn, tss)
    jrep = jss.snapshot(str(tmp_path / "jax"))
    trep = tss.snapshot(str(tmp_path / "port"))
    assert trep == jrep
    assert all(r["live_docs"] == 402 for r in trep.values())
    assert _files(str(tmp_path / "port"), syn) == \
        _files(str(tmp_path / "jax"), syn)


@pytest.mark.parametrize("front", ["aiohttp", "native"])
def test_snapshot_route_and_reload(tmp_path, front):
    syn = world(docs=400, nq=8, seed=11)
    jss, tss = shard_sets(syn, mutable=True, reserve_docs=32)
    _churn(syn, jss)
    _churn(syn, tss)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jeng, teng = engines(syn, jss, tss)
    js, _ = servers(syn, jeng, teng, data_root=jroot)
    _, ts = servers(syn, jeng, teng, data_root=troot)
    name = syn.world.sources[0].name
    reqs = [("POST", "/docs/add", {"source": name, "docs": [
                {"embedding": [0.5] * syn.world.sources[0].embed_dim,
                 "id": "served", "payload": {"id": "s", "title": "t",
                                             "content": "served"}}]}),
            ("POST", "/docs/delete", {"source": name, "slots": [9]}),
            ("POST", "/admin/snapshot", None)]
    native = front == "native"
    with serving(js, JNative if native else None) as port:
        jout = [request(port, m, p, body=b) for m, p, b in reqs]
    with serving(ts, NativeFederationServer if native else None) as port:
        tout = [request(port, m, p, body=b) for m, p, b in reqs]
    # the bodies name each server's own data root
    jout[2] = (jout[2][0], jout[2][1], jout[2][2].replace(
        jroot.encode(), b"ROOT"))
    tout[2] = (tout[2][0], tout[2][1], tout[2][2].replace(
        troot.encode(), b"ROOT"))
    same_answers(jout, tout, reqs)
    assert [s for s, _, _ in tout] == [200, 200, 200]
    files = _files(troot, syn, payloads=True)
    assert files == _files(jroot, syn, payloads=True)
    assert b'"served"' in files[(name, "payloads")]

    reloaded = ShardSet.load(troot, syn.world, dtype=torch.float32)
    assert reloaded.total_docs == tss.total_docs
    got = port_engine(syn, reloaded).search(syn.query_embs, strategy="all")
    want = teng.search(syn.query_embs, strategy="all")
    assert _winner_ids(syn, reloaded, got) == _winner_ids(syn, tss, want)
