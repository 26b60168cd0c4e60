"""``--embedder zoo`` served by the port, against the JAX package's server
(CPU, ephemeral ports).

* Concurrent ``/query`` share encoder forwards through the
  ``EmbeddingBatcher`` (the port's counterpart of
  ``tests/test_server.py::test_served_zoo_embedding_batches``), and
  ``/stats`` carries the ``embedding`` block.
* With a hash-backend zoo on both sides (no checkpoint in any cache) the
  ``/query`` bodies equal the JAX server's byte for byte (query id and
  timings blanked); with a tiny real BERT checkpoint at f32 on both sides the
  served ``top_docs`` are the same. The native front end drops the batcher
  and still encodes through ``embed_many``.
* ``check_args`` accepts ``--embedder zoo``; ``load_world_artifacts``
  returns the zoo provider, and refuses an unknown embedder with the JAX
  package's words.
* A checkpoint that is present but corrupt raises, and so does one that
  would have to run on a card this machine lacks: neither falls to hash.
"""

import asyncio
import json
import os
import shutil

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import ragroute_tpu.config as jconf
import ragroute_tpu_torch.config as tconf
from ragroute_tpu.encoders.zoo import EncoderZoo as JZoo
from ragroute_tpu.engine.batcher import QueryBatcher as JBatcher
from ragroute_tpu.engine.embedding import EncoderZooEmbeddings as JZooEmb
from ragroute_tpu.engine.server import FederationServer as JServer
from ragroute_tpu.index.store import MemoryDocStore as JStore
from ragroute_tpu_torch.encoders import EncoderZoo
from ragroute_tpu_torch.engine.batcher import QueryBatcher
from ragroute_tpu_torch.engine.embedding import EncoderZooEmbeddings
from ragroute_tpu_torch.engine.native_frontend import NativeFederationServer
from ragroute_tpu_torch.engine.server import FederationServer
from ragroute_tpu_torch.index.store import MemoryDocStore
from torch_serving import (engines, normalize, query_path, request, serving,
                           shard_sets, world)

MEDCPT = "ncbi/MedCPT-Query-Encoder"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(autouse=True)
def _empty_caches(tmp_path, monkeypatch):
    """No hub cache of this machine is read: each test names its own."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "no_hub"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_home"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))


@pytest.fixture(scope="module")
def pair_world():
    syn = world(docs=600, nq=8, seed=1)
    jss, tss = shard_sets(syn)
    return syn, engines(syn, jss, tss)


def _servers(syn, jeng, teng, jprov, tprov, strategy="ragroute"):
    common = dict(strategy=strategy, disable_llm=True, port=0, warmup=False)
    js = JServer(jeng, embedding_provider=jprov,
                 doc_store=JStore.from_synthetic(syn),
                 batcher=JBatcher(jeng, strategy=strategy, window_ms=5.0,
                                  buckets=(8,)), **common)
    ts = FederationServer(teng, embedding_provider=tprov,
                          doc_store=MemoryDocStore.from_synthetic(syn),
                          batcher=QueryBatcher(teng, strategy=strategy,
                                               window_ms=5.0, buckets=(8,)),
                          **common)
    return js, ts


async def _burst(port, reqs):
    loop = asyncio.get_running_loop()
    return await asyncio.gather(*[
        loop.run_in_executor(None, request, port, "GET", path)
        for path in reqs])


def _paths(syn, n=6):
    return [query_path(q["question"], q["options"], f"zoo-{i}")
            for i, q in enumerate(syn.questions[:n])]


def test_served_zoo_embedding_batches_and_stats(pair_world):
    """Concurrent queries share encoder forwards; a query served alone gets
    the docs it got in the batch; ``/stats`` counts the forwards."""
    syn, (jeng, teng) = pair_world
    provider = EncoderZooEmbeddings(syn.world)
    assert set(provider.zoo.backends.values()) == {"hash"}
    _, ts = _servers(syn, jeng, teng, JZooEmb(syn.world, JZoo(
        syn.world, prefer="hash")), provider)
    assert ts.embed_batcher is not None
    paths = _paths(syn)
    with serving(ts) as port:
        res = asyncio.run(_burst(port, paths))
        assert all(st == 200 for st, _, _ in res)
        eb = ts.embed_batcher
        assert 1 <= eb.batches < eb.batched_queries == len(paths)
        st, _, alone = request(port, "GET", paths[0])
        assert st == 200
        ids = [d["id"] for d in json.loads(alone)["metadata"]["top_docs"]]
        assert ids == [d["id"] for d in
                       json.loads(res[0][2])["metadata"]["top_docs"]]
        st, _, body = request(port, "GET", "/stats")
        stats = json.loads(body)
    emb = stats["embedding"]
    assert emb["batched_queries"] == len(paths) + 1
    assert emb["batches"] == eb.batches
    assert emb["mean_batch"] == round(emb["batched_queries"]
                                      / emb["batches"], 2)


def test_hash_zoo_bodies_equal_the_jax_servers(pair_world):
    syn, (jeng, teng) = pair_world
    js, ts = _servers(syn, jeng, teng, JZooEmb(syn.world, JZoo(
        syn.world, prefer="hash")), EncoderZooEmbeddings(syn.world))
    paths = _paths(syn) + [query_path("an unknown query", {"A": "x"}, "q")]
    out = {}
    for name, server in (("jax", js), ("port", ts)):
        with serving(server) as port:
            out[name] = [request(port, "GET", p) for p in paths]
            st, _, body = request(port, "GET", "/stats")
            out[name + "_stats"] = json.loads(body)["embedding"]
    for (jst, jct, jb), (tst, tct, tb) in zip(out["jax"], out["port"]):
        assert (tst, tct) == (jst, jct) == (200, "application/json; "
                                            "charset=utf-8")
        assert normalize(tb) == normalize(jb)
    assert out["jax_stats"].keys() == out["port_stats"].keys()
    assert out["port_stats"]["batched_queries"] == len(paths)


def _tiny_medcpt(cache):
    """A MedCPT-Query-Encoder stand-in at the world's width (768) with one
    layer, laid out as a hub-cache snapshot; returns the snapshot."""
    from transformers import BertConfig, BertModel, BertTokenizer

    torch.manual_seed(9)
    model = BertModel(BertConfig(
        vocab_size=60, hidden_size=768, num_hidden_layers=1,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2)).eval()
    repo = os.path.join(cache, "models--" + MEDCPT.replace("/", "--"))
    snap = os.path.join(repo, "snapshots", "r1")
    model.save_pretrained(snap)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write("r1")
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "?", "[", "]",
              "'", ","] + [chr(ord("a") + i) for i in range(26)]
             + [str(i) for i in range(10)]
             + ["##" + chr(ord("a") + i) for i in range(14)])
    with open(os.path.join(snap, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab))
    BertTokenizer(os.path.join(snap, "vocab.txt")).save_pretrained(snap)
    return snap


@pytest.mark.parametrize("front", ["aiohttp", "native"])
def test_real_bert_zoo_serves_the_jax_servers_docs(pair_world, tmp_path,
                                                    monkeypatch, front):
    """A tiny real BERT at f32 on both sides (the JAX package's
    ``_load_jax_bert`` from the snapshot, the port's own reader from the hub
    cache): the same ``top_docs`` for every query. Through the native front
    end the batcher is dropped and ``embed_many`` batches the encodes."""
    from ragroute_tpu.encoders.registry import ENCODER_SPECS as JSPECS
    from ragroute_tpu.encoders.zoo import _load_jax_bert

    syn, (jeng, teng) = pair_world
    snap = _tiny_medcpt(str(tmp_path / "hub"))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.setattr(jconf, "ENCODER_COMPUTE_DTYPE", "float32")
    monkeypatch.setattr(tconf, "ENCODER_COMPUTE_DTYPE", "float32")
    jzoo = JZoo(syn.world, prefer="hash")
    jspec = JSPECS[MEDCPT]
    jzoo.encoders[MEDCPT] = _load_jax_bert(
        type(jspec)(**{**jspec.__dict__, "hf_name": snap}))
    tprov = EncoderZooEmbeddings(syn.world, device="cpu")
    assert tprov.zoo.backends == {MEDCPT: "torch:cpu"}
    js, ts = _servers(syn, jeng, teng, JZooEmb(syn.world, jzoo), tprov)
    paths = _paths(syn, 8)

    def top_docs(body):
        return [d["id"] for d in json.loads(body)["metadata"]["top_docs"]]

    with serving(js) as port:
        want = [request(port, "GET", p) for p in paths]
    native = NativeFederationServer if front == "native" else None
    with serving(ts, native) as port:
        if native is not None:
            assert ts.embed_batcher is None
        got = asyncio.run(_burst(port, paths))
    for (jst, _, jb), (tst, _, tb) in zip(want, got):
        assert jst == tst == 200
        assert top_docs(tb) == top_docs(jb)
    if native is None:
        assert ts.embed_batcher.batched_queries == len(paths)


def test_check_ported_and_load_world_artifacts_take_zoo(tmp_path):
    from ragroute_tpu.engine.embedding import HashEmbeddings as JHash
    from ragroute_tpu.system import load_world_artifacts as jload
    from ragroute_tpu_torch.engine.embedding import (HashEmbeddings,
                                                     PrecomputedEmbeddings)
    from ragroute_tpu_torch.index.synthetic import (make_synthetic_world,
                                                    save_world)
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.system import check_args, load_world_artifacts

    check_args(parse_args(["--dataset", "medrag", "--embedder", "zoo"]))
    syn = make_synthetic_world("medrag", docs_per_source=256, num_queries=4,
                               seed=0)
    root = str(tmp_path / "data")
    save_world(syn, root)

    def provider_for(embedder):
        return load_world_artifacts(root, syn.world, embedder=embedder,
                                    dtype=torch.float32)[3]

    assert isinstance(provider_for("auto"), PrecomputedEmbeddings)
    assert isinstance(provider_for("hash"), HashEmbeddings)
    zoo = provider_for("zoo")
    assert isinstance(zoo, EncoderZooEmbeddings)
    assert zoo.blocking and set(zoo.zoo.backends.values()) == {"hash"}
    embs = zoo.embed("What is the treatment for hypertension?", "q0")
    for s in syn.world.sources:
        assert embs[s.encoder].shape == (s.embed_dim,)
    assert isinstance(jload(root, syn.world, embedder="hash")[3], JHash)
    errors = []
    for load in (jload, load_world_artifacts):
        with pytest.raises(ValueError) as e:
            load(root, syn.world, embedder="bogus")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _corrupt(snap):
    with open(os.path.join(snap, "model.safetensors"), "r+b") as f:
        f.seek(8)
        f.write(b"{not json")


@pytest.mark.parametrize("fault", ["corrupt_file", "wrong_shapes", "no_card"])
def test_present_checkpoint_never_falls_back_to_hash(tmp_path, monkeypatch,
                                                     fault):
    snap = _tiny_medcpt(str(tmp_path / "hub"))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    syn_world = tconf.get_world("medrag")
    device = "cpu"
    if fault == "corrupt_file":
        _corrupt(snap)
        err = ValueError
    elif fault == "wrong_shapes":
        with open(os.path.join(snap, "config.json")) as f:
            conf = json.load(f)
        conf["intermediate_size"] = 96
        with open(os.path.join(snap, "config.json"), "w") as f:
            json.dump(conf, f)
        err = RuntimeError
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the load succeeds there")
        device, err = None, RuntimeError
    with pytest.raises(err):
        EncoderZoo(syn_world, device=device)
    shutil.rmtree(str(tmp_path / "hub"))
    # with no checkpoint at all the same call serves hash embeddings
    zoo = EncoderZoo(syn_world, device=device)
    assert zoo.backends == {MEDCPT: "hash"}


def test_zoo_over_given_encoders_runs_them_on_their_device():
    """``EncoderZoo(world, encoders=...)`` serves models the caller already
    holds (the chip smoke's feb4rag zoo); ``encode_queries`` runs each
    once for the batch."""
    from ragroute_tpu_torch.encoders import published as P

    world = tconf.get_world("feb4rag")
    calls = []

    class Counting:
        backend = "torch:cpu"

        def __init__(self, dim):
            self.dim = dim

        def encode(self, texts):
            calls.append(len(texts))
            return np.ones((len(texts), self.dim), np.float32)

    dims = {s.encoder: s.embed_dim for s in world.sources}
    zoo = EncoderZoo(world, encoders={e: Counting(d) for e, d in dims.items()})
    out = zoo.encode_queries(["a", "b", "c"])
    assert calls == [3] * len(world.encoders)
    assert {e: v.shape for e, v in out.items()} == {
        e: (3, d) for e, d in dims.items()}
    # every registry spec of the world has a published model to stand in
    assert set(world.encoders) <= set(P.SPEC_MODEL)
