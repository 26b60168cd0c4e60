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
          "index.native_store", "index.synthetic", "utils.template",
          "encoders.registry", "eval_metrics", "index.faiss_import"]

# names of the original that the port leaves out on purpose, with the
# ROADMAP item that brings them
LEFT_OUT = {}


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


# ---- the generation slice's own copies of host-side functions ---------------

def _llm_pair(name):
    """(original, the port's copy) of one host-side function or value of
    the generation slice; ``shapes.*`` are ``scripts/bench_llm.py``'s."""
    mod, attr = name.rsplit(".", 1)
    ref_mod = ("scripts.bench_llm" if mod == "llm.shapes"
               else f"ragroute_tpu.{mod}")
    return (getattr(importlib.import_module(ref_mod), attr),
            getattr(importlib.import_module(f"ragroute_tpu_torch.{mod}"),
                    attr))


def _same_int4(ref, ours):
    import torch

    rng = np.random.default_rng(4)
    w = rng.normal(size=(96, 40)).astype(np.float32)
    if ref.__name__ == "pack_int4_rows":
        codes = rng.integers(-8, 8, (96, 40)).astype(np.int8)
        np.testing.assert_array_equal(
            ref(codes), ours(torch.from_numpy(codes)).numpy())
        return
    p, s = _llm_pair("ops.int4_matmul.quantize_int4")[0](w, group=24)
    if ref.__name__ == "quantize_int4":
        tp, ts = ours(torch.from_numpy(w), group=24)
        np.testing.assert_array_equal(p, tp.numpy())
        np.testing.assert_array_equal(s, ts.numpy())
    else:
        np.testing.assert_array_equal(
            ref(p, s, 24),
            ours(torch.from_numpy(p), torch.from_numpy(s), 24).numpy())


def _same_service_helper(ref, ours):
    name = ref.__name__
    rtok = importlib.import_module("ragroute_tpu.llm.service").ByteTokenizer()
    otok = importlib.import_module(
        "ragroute_tpu_torch.llm.service").ByteTokenizer()
    msgs = [{"role": "system", "content": "sys ✓"},
            {"role": "user", "content": "x" * 40 + " end?"}]
    if name == "_render_prompt":
        class NoTemplate:
            chat_template = None
        for tok in (rtok, NoTemplate()):
            assert ours(tok, msgs) == ref(tok, msgs)
    elif name == "resolve_special_id":
        class Hf:
            eos_token_id, pad_token_id = 7, None
        for args in ((Hf(), None, "eos_token_id", "eos_id"),
                     (Hf(), 3, "eos_token_id", "eos_id"),
                     (Hf(), None, "pad_token_id", "pad_id"),
                     (rtok, None, "pad_token_id", "pad_id")):
            assert ours(*args) == ref(*args)
    elif name == "validate_sampling":
        assert ours(3, 0.5) == ref(3, 0.5)
        for bad in ((-1, 1.0), (0, 0.0), (0, 1.01)):
            for fn in (ref, ours):
                with pytest.raises(ValueError):
                    fn(*bad)
    elif name == "pick_bucket":
        for n in (1, 4, 5, 16, 99):
            assert ours((4, 16), n) == ref((4, 16), n)
    elif name == "encode_prompt":
        for cap in (8, 4096):
            assert ours(otok, msgs, cap) == ref(rtok, msgs, cap)
    elif name == "clamp_budget":
        for v in (None, 0, 5, 99):
            assert ours(v, 8) == ref(v, 8)
    elif name in ("shared_prefix_from_messages",):
        other = [{"role": "user", "content": "y"}]
        assert ours(otok, msgs, other) == ref(rtok, msgs, other)
    elif name == "shared_prefix_ids":
        for system in (None, "You are a doctor."):
            assert ours(otok, system) == ref(rtok, system)
    else:
        raise AssertionError(name)


def _same_value(ref, ours):
    if dataclasses.is_dataclass(ref):
        assert _plain(ref) == _plain(ours)
    elif isinstance(ref, dict):
        assert list(ref) == list(ours)
        for k in ref:
            assert _plain(ref[k]) == _plain(ours[k]), k
    else:                               # ByteTokenizer
        r, o = ref(), ours()
        for a in ("pad_id", "bos_id", "eos_id", "vocab_size", "is_fallback"):
            assert getattr(r, a) == getattr(o, a)
        for text in ("hello", "ünïcödé ✓", ""):
            assert r.encode(text) == o.encode(text)
            assert r.decode(r.encode(text) + [300, 256]) == o.decode(
                o.encode(text) + [300, 256])
        msgs = [{"role": "user", "content": "q"}]
        assert r.apply_chat_template(msgs) == o.apply_chat_template(msgs)


def _same_model_helper(ref, ours):
    name = ref.__name__
    if name == "_int4_group":
        for n in (48, 128, 4096, 12288, 100, 6):
            assert ours(n) == ref(n) and ours(n, 16) == ref(n, 16)
    elif name == "_inv_freq":
        rcls = importlib.import_module("ragroute_tpu.llm.model").DecoderConfig
        ocls = importlib.import_module(
            "ragroute_tpu_torch.llm.model").DecoderConfig
        for scaling in (None, (8.0, 1.0, 4.0, 8192)):
            kw = dict(vocab_size=8, hidden_size=256, num_layers=1,
                      num_heads=2, num_kv_heads=1, head_dim=128,
                      intermediate_size=8, rope_theta=5e5,
                      rope_scaling=scaling)
            np.testing.assert_array_equal(ours(ocls(**kw)), ref(rcls(**kw)))
    else:
        raise AssertionError(name)


LLM_COPIES = {
    "ops.int4_matmul.pack_int4_rows": _same_int4,
    "ops.int4_matmul.quantize_int4": _same_int4,
    "ops.int4_matmul.dequant_int4": _same_int4,
    "llm.service.ByteTokenizer": _same_value,
    "llm.service.DEMO_CFG": _same_value,
    "llm.service._render_prompt": _same_service_helper,
    "llm.service.resolve_special_id": _same_service_helper,
    "llm.service.validate_sampling": _same_service_helper,
    "llm.service.pick_bucket": _same_service_helper,
    "llm.service.encode_prompt": _same_service_helper,
    "llm.service.clamp_budget": _same_service_helper,
    "llm.continuous.shared_prefix_from_messages": _same_service_helper,
    "llm.continuous.shared_prefix_ids": _same_service_helper,
    "llm.model._int4_group": _same_model_helper,
    "llm.model._inv_freq": _same_model_helper,
    "llm.shapes.QWEN3_06B": _same_value,
    "llm.shapes.QWEN3_8B": _same_value,
}


def _same_host_helper(ref, ours):
    name = ref.__name__
    if name == "_parse_qs_first":
        for qs in ("q=a+b&choices=%7B%22A%22%3A%22x%22%7D&qid=1",
                   "q=first&q=second&&x", "a%20b=c%2Bd&stream=1",
                   "q=%ZZbad&choices=&qid=", ""):
            for seed in ({}, {"q": "form"}):
                assert ours(qs, dict(seed)) == ref(qs, dict(seed))
    elif name == "_unquote_cached":
        for v in ("a%20b+c", "%E2%9C%93", "x" * 3000 + "%41", "%zz"):
            assert ours(v) == ref(v)
    elif name == "_id_key":
        for v in ("id", 3, {"b": 1, "a": [2]}, ["x", {"y": 1}]):
            assert ours(v) == ref(v)
    else:
        raise AssertionError(name)


HOST_COPIES = ("engine.native_frontend._parse_qs_first",
               "engine.native_frontend._unquote_cached",
               "index.shard._id_key")


@pytest.mark.parametrize("name", HOST_COPIES)
def test_serving_slice_copy_behaves_as_the_original(name):
    """The pure helpers of the native front end and the live index that the
    port keeps as its own copies."""
    ref, ours = _llm_pair(name)
    assert ours.__module__.startswith("ragroute_tpu_torch")
    _same_host_helper(ref, ours)


@pytest.mark.parametrize("name", sorted(LLM_COPIES))
def test_generation_slice_copy_behaves_as_the_original(name):
    ref, ours = _llm_pair(name)
    assert getattr(ours, "__module__", "ragroute_tpu_torch").startswith(
        "ragroute_tpu_torch") or not callable(ours)
    LLM_COPIES[name](ref, ours)


def test_encoder_registry_and_instruction_table_are_equal():
    """The registry's specs are equal field by field, and the instruction
    table is the original's file byte for byte."""
    import os

    ref, ours = _pair("encoders.registry")
    assert _plain(ref.ENCODER_SPECS) == _plain(ours.ENCODER_SPECS)
    spec = ours.ENCODER_SPECS["UAE-Large-V1"]
    assert spec.format_query("q") == ref.ENCODER_SPECS[
        "UAE-Large-V1"].format_query("q")
    blobs = []
    for pkg in ("ragroute_tpu", "ragroute_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.encoders")
        path = os.path.join(os.path.dirname(mod.__file__),
                            "instructor_instructions.json")
        with open(path, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]


def _encoder_tokenizer(with_eos):
    from tests.test_encoders import _make_local_tokenizer

    return _make_local_tokenizer(with_eos=with_eos)


def _same_encoder_helper(ref, ours):
    name = ref.__name__
    rng = np.random.default_rng(5)
    if name in ("weighted_mean_pool", "masked_mean_pool"):
        hid = rng.standard_normal((3, 7, 4)).astype(np.float32)
        mask = (rng.random((3, 7)) > 0.3).astype(np.int64)
        mask[2] = 0
        np.testing.assert_array_equal(ours(hid, mask), ref(hid, mask))
    elif name == "instructor_instructions":
        assert ours() == ref()
    elif name == "instructor_instruction":
        for args in (("hkunlp/instructor-large", "trec-covid", "query"),
                     ("instructor-xl", "scifact", "corpus"),
                     ("instructor-base", "nq", "query")):
            assert ours(*args) == ref(*args)
    elif name == "specb_bracket_ids":
        tok = _encoder_tokenizer(False)
        assert ours(tok) == ref(tok)
    elif name == "specb_tokenize":
        tok = _encoder_tokenizer(False)
        texts = ["what is diabetes", "the [quick] {brown} fox", "x" * 40]
        for kw in ({}, {"is_query": False}, {"pad_to": 16},
                   {"max_length": 6}):
            a, b = ours(tok, texts, **kw), ref(tok, texts, **kw)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    elif name == "instructor_tokenize":
        tok = _encoder_tokenizer(True)
        for ins in ("represent the question for retrieving documents ",
                    ""):
            for kw in ({}, {"pad_to": 24}, {"max_length": 8}):
                a = ours(tok, ins, ["what is diabetes", " fox "], **kw)
                b = ref(tok, ins, ["what is diabetes", " fox "], **kw)
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k])
    else:
        raise AssertionError(name)


ENCODER_HELPERS = ("specb_bracket_ids", "specb_tokenize",
                   "weighted_mean_pool", "instructor_tokenize",
                   "masked_mean_pool", "instructor_instruction",
                   "instructor_instructions")


@pytest.mark.parametrize("name", ENCODER_HELPERS)
def test_encoder_helper_copy_behaves_as_the_original(name):
    """The numpy helpers of ``encoders/custom.py``, which the port keeps in
    a module that also holds its torch encoder classes."""
    ref = getattr(importlib.import_module("ragroute_tpu.encoders.custom"),
                  name)
    ours = getattr(importlib.import_module(
        "ragroute_tpu_torch.encoders.custom"), name)
    assert ours.__module__ == "ragroute_tpu_torch.encoders.custom"
    _same_encoder_helper(ref, ours)
