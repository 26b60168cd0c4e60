"""The port's own copies of the JAX package's host-side modules do not drift.

``ragroute_tpu_torch`` imports nothing of ``ragroute_tpu``; what it needs of
that package's numpy / stdlib modules it keeps as its own copy at the
mirrored path. Each copy is held to its original here: the same public
names, the same value of every ``config`` constant and ``WORLDS`` entry, and
the same output on the same seeded input.
"""

import dataclasses
import importlib
import json
import types

import numpy as np
import pytest

COPIES = ["config", "oracle", "benchmark", "engine.rerank", "engine.prompts",
          "engine.llm", "engine.metrics", "engine.embedding", "index.store",
          "index.native_store", "index.synthetic", "utils.template"]

# names of the original that the port leaves out on purpose, with the
# ROADMAP item that brings them
LEFT_OUT = {
    "index.synthetic": {"GEN_BLOCK", "StreamedSyntheticWorld",
                        "make_streamed_world"},     # queue 1, item 11
}


def _pair(name):
    return (importlib.import_module(f"ragroute_tpu.{name}"),
            importlib.import_module(f"ragroute_tpu_torch.{name}"))


def _public(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("name", COPIES)
def test_copy_has_the_original_public_names(name):
    ref, ours = _pair(name)
    assert _public(ref) - LEFT_OUT.get(name, set()) == _public(ours)
    assert ours.__name__.startswith("ragroute_tpu_torch.")
    for n in _public(ours):
        v = getattr(ours, n)
        if isinstance(v, (type, types.FunctionType)):
            assert v.__module__.split(".")[0] != "ragroute_tpu", n


def _plain(v):
    """A value as plain data, so two packages' dataclasses compare."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def test_every_config_constant_and_world_is_equal():
    ref, ours = _pair("config")
    checked = 0
    for n in sorted(_public(ref)):
        a, b = getattr(ref, n), getattr(ours, n)
        if isinstance(a, (type, types.FunctionType)):
            continue
        if n in ("DATA_ROOT", "DEFAULT_DATA_ROOT"):
            continue                # each package's own default directory
        assert _plain(a) == _plain(b), n
        checked += 1
    assert checked > 40
    assert list(ref.WORLDS) == list(ours.WORLDS)
    for name in ref.WORLDS:
        a, b = ref.get_world(name), ours.get_world(name)
        assert _plain(a) == _plain(b)
        assert a.router_input_dim == b.router_input_dim
        assert a.encoders == b.encoders and a.num_sources == b.num_sources
    for shard in [(768, "dot"), (4096, "cos"), (768, "l2"), (768, "cos")]:
        for cap in (False, True):
            assert (ref.store_dtype_policy(*shard, capacity=cap)
                    == ours.store_dtype_policy(*shard, capacity=cap))


@pytest.mark.parametrize("world_name,subclusters", [("medrag", 1),
                                                    ("wikipedia", 4)])
def test_synthetic_world_is_bit_equal(world_name, subclusters):
    ref, ours = _pair("index.synthetic")
    kw = dict(docs_per_source=96, num_queries=12, seed=7,
              subclusters=subclusters)
    a = ref.make_synthetic_world(world_name, **kw)
    b = ours.make_synthetic_world(world_name, **kw)
    for f in ("embeddings", "centroids", "query_embs"):
        for key, arr in getattr(a, f).items():
            np.testing.assert_array_equal(getattr(b, f)[key], arr, err_msg=f)
    np.testing.assert_array_equal(a.relevant, b.relevant)
    assert a.questions == b.questions and a.doc_ids == b.doc_ids
    assert a.doc_payloads == b.doc_payloads


def test_saved_world_has_the_same_files_and_bytes(tmp_path):
    import filecmp
    import os

    ref, ours = _pair("index.synthetic")
    kw = dict(docs_per_source=64, num_queries=6, seed=2)
    ref.save_world(ref.make_synthetic_world("medrag", **kw),
                   str(tmp_path / "a"))
    ours.save_world(ours.make_synthetic_world("medrag", **kw),
                    str(tmp_path / "b"))
    listing = {}
    for side in ("a", "b"):
        root = str(tmp_path / side)
        listing[side] = sorted(
            os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files)
    assert listing["a"] == listing["b"] and len(listing["a"]) > 10
    for rel in listing["a"]:
        assert filecmp.cmp(str(tmp_path / "a" / rel),
                           str(tmp_path / "b" / rel), shallow=False), rel


def test_exact_oracle_and_recall_are_equal():
    ref, ours = _pair("oracle")
    syn = importlib.import_module(
        "ragroute_tpu_torch.index.synthetic").make_synthetic_world(
        "wikipedia", docs_per_source=128, num_queries=10, seed=3,
        with_payloads=False)
    rworld = importlib.import_module("ragroute_tpu.config").get_world(
        "wikipedia")
    mask = np.random.default_rng(0).random((10, syn.world.num_sources)) < 0.5
    a = ref.exact_oracle(rworld, syn.embeddings, syn.query_embs, 10,
                         mask=mask)
    b = ours.exact_oracle(syn.world, syn.embeddings, syn.query_embs, 10,
                          mask=mask)

    assert a == b and all(len(w) == 10 for w in b)

    class Out:                  # an engine output that misses one doc a row
        merged_shard = np.array([[si for si, _ in sorted(w)][:9] + [-1]
                                 for w in b])
        merged_local = np.array([[li for _, li in sorted(w)][:9] + [0]
                                 for w in b])
    assert (ref.engine_recall(rworld, Out, a)
            == ours.engine_recall(syn.world, Out, b) == 0.9)


def test_small_host_modules_behave_the_same(tmp_path):
    world = importlib.import_module("ragroute_tpu_torch.config").get_world(
        "medrag")
    rworld = importlib.import_module("ragroute_tpu.config").get_world(
        "medrag")
    ref, ours = _pair("utils.template")
    tmpl = "Q: {{ question }} [{{options[1]}}] {{ missing }} {{options[9]}}"
    ctx = {"question": "x?", "options": ["a", "b"]}
    assert ours.render(tmpl, ctx) == ref.render(tmpl, ctx) == \
        "Q: x? [b] {{ missing }} "

    ref, ours = _pair("engine.embedding")
    a = ref.HashEmbeddings(rworld).embed("what is a test?", "qid")
    b = ours.HashEmbeddings(world).embed("what is a test?", "qid")
    assert a.keys() == b.keys()
    for enc in a:
        np.testing.assert_array_equal(a[enc], b[enc])

    ref, ours = _pair("engine.prompts")
    docs = [{"title": "t", "content": "c " * 5},
            {"title": "u", "content": "d"}]
    args = ("medrag", "why?", docs, {"A": "x", "B": "y"}, "echo")
    model = next(iter(importlib.import_module(
        "ragroute_tpu_torch.config").LLM_MODELS))
    args = args[:4] + (model,)
    assert ref.generate_llm_message(*args) == ours.generate_llm_message(*args)

    ref, ours = _pair("engine.metrics")
    ma, mb = ref.ServerMetrics(), ours.ServerMetrics()
    for m in (ma, mb):
        m.set_device_step_ms({8: 1.5})
        for v in (1.0, 3.0, 2.0):
            m.observe_query(embedding=v, selection=2 * v, doc_select=v,
                            generate=-1.0, e2e=4 * v, batch_size=int(v))
        m.observe_error()
    assert json.dumps(ma.snapshot(), sort_keys=True) == \
        json.dumps(mb.snapshot(), sort_keys=True)

    ref, ours = _pair("index.store")
    path = tmp_path / "payloads"
    path.mkdir()
    with open(path / "pubmed.jsonl", "w") as f:
        for i in range(5):
            f.write(json.dumps({"id": f"d{i}", "title": f"t{i}",
                                "content": "x" * i}) + "\n")
    sa, sb = ref.JsonlDirDocStore(str(path)), ours.JsonlDirDocStore(str(path))
    assert [sa.get("pubmed", i) for i in (0, 4, 2, 9)] == \
        [sb.get("pubmed", i) for i in (0, 4, 2, 9)]

    ref, ours = _pair("engine.rerank")
    qrels = tmp_path / "qrels.txt"
    qrels.write_text("q1\t0\tdocA\t2\nq1\t0\tdocB\t0\nq2\t0\tdocC\t1\n")
    assert ref.load_qrels(str(qrels)) == ours.load_qrels(str(qrels))
