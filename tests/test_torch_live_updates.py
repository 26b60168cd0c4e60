"""The port's live index against the JAX package's (CPU).

The same add / delete sequence on a JAX ``ShardSet`` and on the port's,
built mutable over one world, leaves the same free lists, live counts and
``doc_ids`` tables (the late id-table cases of ``test_live_updates.py``
included), the same device bytes (rows, bias, scales) and, through
``engine.search``, the same winners, in f32, bf16, int8 and int4; the
refusals are the JAX package's. Over HTTP, ``/docs/add`` and
``/docs/delete`` (and their guards' 400s) answer with the same bytes on
both front ends, and the queries after them return the same docs.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from ragroute_tpu.engine.native_frontend import \
    NativeFederationServer as JNative
from ragroute_tpu.index import ShardSet as JShardSet
from ragroute_tpu_torch.engine.native_frontend import NativeFederationServer
from ragroute_tpu_torch.index import ShardSet
from test_torch_engine import _assert_same_merge
from test_torch_shard import _bits
from torch_serving import (DTYPES, engines, query_path, request,
                           same_answers, servers, serving, shard_sets,
                           world)

HOLDOUT = 40


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _split(syn):
    """The world split into served rows and held-out rows a source."""
    base = {n: e[:-HOLDOUT] for n, e in syn.embeddings.items()}
    held = {n: e[-HOLDOUT:] for n, e in syn.embeddings.items()}
    base_ids = {n: list(i[:-HOLDOUT]) for n, i in syn.doc_ids.items()}
    held_ids = {n: list(i[-HOLDOUT:]) for n, i in syn.doc_ids.items()}
    return base, held, base_ids, held_ids


def _updates(ss, syn, held, held_ids):
    """One add / delete sequence (ids and slots, recycled slots): returns
    what each call returned."""
    got = []
    for si, src in enumerate(syn.world.sources):
        name = src.name
        got.append(ss.add_docs(name, held[name][:20], held_ids[name][:20]))
        table = ss.doc_ids[name]
        victims = [table[s] for s in (0, 7, 11)] + held_ids[name][2:5]
        got.append(ss.delete_docs(name, doc_ids=victims))
        got.append(ss.delete_docs(name, slots=[20 + si, 30]))
        got.append(ss.add_docs(name, held[name][20:], held_ids[name][20:]))
        got.append((ss.live_docs(name), ss.free_slots(name),
                    ss.live_slots(name)))
    return got


def _assert_same_state(jss, tss):
    assert tss._free == jss._free
    assert tss._live == jss._live
    assert tss.doc_ids == jss.doc_ids
    assert tss.total_docs == jss.total_docs
    for js, ts in zip(jss.shards, tss.shards):
        assert ts.scan_docs == js.scan_docs == js.capacity
        for field in ("docs", "bias", "scale", "center"):
            a, b = getattr(js, field), getattr(ts, field)
            assert (a is None) == (b is None), field
            if a is not None:
                np.testing.assert_array_equal(_bits(b), _bits(a),
                                              err_msg=field)


@pytest.mark.parametrize("dtype", DTYPES)
def test_same_state_and_winners_after_the_same_updates(dtype):
    syn = world(nq=16, seed=3)
    base, held, base_ids, held_ids = _split(syn)
    jss, tss = shard_sets(syn, base, base_ids, dtype=dtype, mutable=True,
                          reserve_docs=64)
    assert [s.capacity for s in tss.shards] == [1024] * 4
    jeng, teng = engines(syn, jss, tss)
    assert teng._n_docs == tuple(s.capacity for s in tss.shards)
    j0 = jeng.search(syn.query_embs, strategy="all")
    t0 = teng.search(syn.query_embs, strategy="all")
    _assert_same_merge(t0, j0, np.ones(16, bool))

    assert _updates(tss, syn, held, held_ids) == \
        _updates(jss, syn, held, held_ids)
    _assert_same_state(jss, tss)
    for strategy in ("all", "ragroute"):
        j = jeng.search(syn.query_embs, strategy=strategy)
        t = teng.search(syn.query_embs, strategy=strategy)
        np.testing.assert_array_equal(t.mask, j.mask)
        np.testing.assert_array_equal(t.merged_valid, j.merged_valid)
        _assert_same_merge(t, j, np.ones(16, bool))
    # no winner is a free slot, and the added docs win somewhere
    free = {(si, s) for si, src in enumerate(syn.world.sources)
            for s in tss._free[src.name]}
    won = {(int(s), int(l)) for s, l in zip(t.merged_shard.ravel(),
                                            t.merged_local.ravel()) if s >= 0}
    assert not won & free
    assert any(l >= 600 - HOLDOUT for _, l in won)


def test_submit_after_an_update_reads_the_new_rows():
    """A step launched before an update answers from the old rows, one
    launched after it from the new ones (the update is ordered behind the
    launched step)."""
    syn = world(nq=8, seed=3)
    base, _, base_ids, _ = _split(syn)
    _, teng = engines(syn, *shard_sets(syn, base, base_ids,
                                       dtype="bfloat16", mutable=True,
                                       reserve_docs=8))
    name = syn.world.sources[0].name
    first = teng.search(syn.query_embs, strategy="all")
    winners = sorted({int(l) for s, l in zip(first.merged_shard[0],
                                             first.merged_local[0])
                      if s == 0})
    before = teng.search_submit(syn.query_embs, strategy="all")
    teng.delete_docs(name, slots=winners)
    after = teng.search_submit(syn.query_embs, strategy="all").wait()
    old = before.wait()
    got_old = {int(l) for s, l in zip(old.merged_shard[0],
                                      old.merged_local[0]) if s == 0}
    got_new = {int(l) for s, l in zip(after.merged_shard[0],
                                      after.merged_local[0]) if s == 0}
    assert got_old == set(winners) and not got_new & set(winners)


@pytest.mark.parametrize("case", ["pre_table_delete", "late_ids",
                                  "idless_reserve"])
def test_late_id_tables_match_jax(case):
    """The id-table cases of ``test_live_updates.py``: a table made by a
    late add with ids keeps dead slots ``None`` and earlier id-less docs
    named by their slots, on both packages alike."""
    syn = world(nq=2, seed=3)
    base, held, _, _ = _split(syn)
    name = syn.world.sources[0].name
    out = []
    for cls, dt in ((JShardSet, jnp.float32), (ShardSet, torch.float32)):
        ss = cls.build(syn.world, base, dtype=dt, mutable=True,
                       reserve_docs=0 if case == "pre_table_delete" else 8)
        got = []
        if case == "pre_table_delete":
            ss.delete_docs(name, slots=[3, 5])
            got.append(ss.add_docs(name, held[name][:1], doc_ids=["fresh"]))
        else:
            got.append(ss.add_docs(name, held[name][:2]))
            ss.delete_docs(name, slots=[3])
            got.append(ss.add_docs(name, held[name][2:3],
                                   doc_ids=["late-id"]))
            if case == "idless_reserve":
                got.append(ss.delete_docs(name, doc_ids=["late-id"]))
                got.append(ss.add_docs(name, held[name][3:5]))
        with pytest.raises(KeyError):   # a dead slot's index is no id
            ss.delete_docs(name, doc_ids=[3 if case == "pre_table_delete"
                                          else "absent"])
        out.append((got, ss.doc_ids[name], ss._free[name]))
    assert out[1] == out[0]


@pytest.mark.parametrize("call,kw,exc", [
    ("build", {"ivf_clusters": 4}, ValueError),
    ("build", {"lowrank": -1}, ValueError),
    ("add_immutable", {}, ValueError),
    ("add_too_many", {}, ValueError),
    ("add_bad_shape", {}, ValueError),
    ("delete_duplicate", {}, ValueError),
    ("delete_free", {}, ValueError),
    ("delete_both", {}, ValueError),
    ("delete_unknown_id", {}, KeyError),
    ("unknown_source", {}, KeyError),
])
def test_refusals_match_jax(call, kw, exc):
    syn = world(docs=64, nq=2, seed=3)
    name = syn.world.sources[0].name
    msgs = []
    for cls, dt in ((JShardSet, jnp.float32), (ShardSet, torch.float32)):
        with pytest.raises(exc) as e:
            if call == "build":
                cls.build(syn.world, syn.embeddings, dtype=dt, mutable=True,
                          **kw)
            ss = cls.build(syn.world, syn.embeddings, doc_ids=syn.doc_ids,
                           dtype=dt, mutable=call != "add_immutable",
                           reserve_docs=0)
            row = syn.embeddings[name][:1]
            if call in ("add_immutable", "add_too_many"):
                ss.add_docs(name, np.repeat(row, 600, axis=0))
            elif call == "add_bad_shape":
                ss.add_docs(name, row[:, :5])
            elif call == "delete_duplicate":
                ss.delete_docs(name, slots=[1, 1])
            elif call == "delete_free":
                ss.delete_docs(name, slots=[511])
            elif call == "delete_both":
                ss.delete_docs(name, slots=[1], doc_ids=["x"])
            elif call == "delete_unknown_id":
                ss.delete_docs(name, doc_ids=["no such id"])
            else:
                ss.add_docs("nope", row)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def _docs_requests(syn, held, held_ids):
    """``/docs/*`` traffic with every guard, then queries."""
    name = syn.world.sources[0].name
    small = syn.world.sources[1].name
    docs = [{"embedding": held[name][i].tolist(), "id": held_ids[name][i],
             "payload": {"id": f"live{i}", "title": f"live {i}",
                         "content": f"added doc {i}"}}
            for i in range(12)]
    # a twin of query 0's embedding: the best doc for that query
    enc = syn.world.sources[0].encoder
    docs.append({"embedding": (2.0 * syn.query_embs[enc][0]).tolist(),
                 "id": "q0-twin", "payload": {"id": "twin", "title": "twin",
                                              "content": "added doc twin"}})
    reqs = [
        ("POST", "/docs/add", {"source": name, "docs": docs}),
        ("POST", "/docs/add", {"source": small, "docs": [
            {"embedding": held[small][0].tolist()}]}),
        ("POST", "/docs/add", {"source": "nope", "docs": docs[:1]}),
        ("POST", "/docs/add", {"source": name, "docs": []}),
        ("POST", "/docs/add", {"source": name, "docs": [{"id": 1}]}),
        ("POST", "/docs/add", {"source": name, "docs": [
            {"embedding": [1.0, 2.0]}, {"embedding": [1.0]}]}),
        ("POST", "/docs/add", {"source": name, "docs": [
            {"embedding": [1.0, 2.0]}]}),
        ("POST", "/docs/add", b"{not json"),
        ("POST", "/docs/add", ["a list"]),
        ("POST", "/docs/delete", {"source": name,
                                  "ids": [held_ids[name][0]]}),
        ("POST", "/docs/delete", {"source": name, "slots": [2, 5]}),
        ("POST", "/docs/delete", {"source": name, "slots": [9, 9]}),
        ("POST", "/docs/delete", {"source": name, "ids": ["no such id"]}),
        ("POST", "/docs/delete", {"source": name}),
        ("POST", "/docs/delete", {"source": "nope", "slots": [1]}),
        ("POST", "/admin/snapshot", None),
    ]
    for q in syn.questions[:4]:
        reqs.append(("GET", query_path(q["question"], q["options"],
                                       q["qid"]), None))
    return reqs


def _run(port, reqs):
    return [request(port, m, p, body=b) for m, p, b in reqs]


@pytest.mark.parametrize("front", ["aiohttp", "native"])
def test_docs_routes_match_jax_server(front):
    syn = world(nq=8, seed=1)
    base, held, base_ids, held_ids = _split(syn)
    jss, tss = shard_sets(syn, base, base_ids, mutable=True,
                          reserve_docs=16)
    js, ts = servers(syn, *engines(syn, jss, tss))
    reqs = _docs_requests(syn, held, held_ids)
    native = front == "native"
    with serving(js, JNative if native else None) as port:
        jout = _run(port, reqs)
    with serving(ts, NativeFederationServer if native else None) as port:
        tout = _run(port, reqs)
    same_answers(jout, tout, reqs)
    assert [s for s, _, _ in tout[:2]] == [200, 200]
    assert all(s == 400 for s, _, _ in tout[2:9])
    assert [s for s, _, _ in tout[9:11]] == [200, 200]
    assert all(s == 400 for s, _, _ in tout[11:16])
    assert all(s == 200 for s, _, _ in tout[16:])
    # an added doc's payload is served
    assert b"added doc" in b"".join(b for _, _, b in tout[16:])
    _assert_same_state(jss, tss)


def test_immutable_server_refuses_updates():
    syn = world(docs=600, nq=2)
    js, ts = servers(syn, *engines(syn, *shard_sets(syn)))
    reqs = [("POST", "/docs/add", {"source": "pubmed", "docs": []}),
            ("POST", "/docs/delete", {"source": "pubmed", "slots": [1]}),
            ("POST", "/admin/snapshot", None)]
    with serving(js) as port:
        jout = _run(port, reqs)
    with serving(ts) as port:
        tout = _run(port, reqs)
    same_answers(jout, tout, reqs)
    assert all(s == 400 and b"immutable" in b for s, _, b in tout)
