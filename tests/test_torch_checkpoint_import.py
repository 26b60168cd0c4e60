"""The reference's router artifacts in the port, against the JAX package's
import path (CPU).

* A reference ``CorpusRoutingNN`` state dict (``.pth``) gives the port the
  JAX ``load_torch_router``'s logits (atol 1e-6); a missing key raises
  naming it.
* sklearn-written scalers, bare and as the 5-tuple
  ``preprocessed_data.pkl``, load to the JAX loader's ``(mean, scale)``
  (equal) in a subprocess where ``sys.modules["sklearn"] = None``; a pickle
  naming any other global is refused by name; the port's scaler writer
  gives bytes that real sklearn unpickles into a ``StandardScaler``.
* ``load_world_artifacts`` on a ``router.pth`` world routes as the JAX
  package's (probabilities within atol 1e-5, masks equal away from the
  threshold) and raises ``FileNotFoundError`` without a scaler.
* ``python -m ragroute_tpu_torch.scripts.import_real_data --device cpu``
  against ``scripts/import_real_data.py`` on one reference-layout tree:
  the same files and arrays; ``--encode-from-jsonl`` with a small BERT
  checkpoint: embeddings within cosine 0.9999 of the JAX package's.
"""

import json
import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from ragroute_tpu.router import router_forward
from ragroute_tpu.router import torch_import as jimport
from ragroute_tpu_torch.index.reference_layout import (write_medrag_corpus,
                                                       write_reference_router)
from ragroute_tpu_torch.index.synthetic import make_synthetic_world, save_world
from ragroute_tpu_torch.router import torch_import as timport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


@pytest.fixture()
def reference_pth(tmp_path):
    from tests.test_router import make_torch_router

    model = make_torch_router(1540, seed=4).eval()
    path = str(tmp_path / "best_model.pth")
    torch.save(model.state_dict(), path)
    return model, path


def _sklearn_scaler(d, seed=0):
    from sklearn.preprocessing import StandardScaler

    rng = np.random.default_rng(seed)
    return StandardScaler().fit(rng.standard_normal((60, d)) * 2 + 0.5)


def test_reference_pth_gives_the_jax_import_logits(reference_pth):
    model, path = reference_pth
    router = timport.load_torch_router(path)
    jparams = jimport.load_torch_router(path)
    x = np.random.default_rng(1).standard_normal((16, 1540)).astype(
        np.float32)
    with torch.no_grad():
        ours = router(torch.from_numpy(x)).numpy()
        ref = model(torch.from_numpy(x)).numpy()[:, 0]
    np.testing.assert_allclose(ours, np.asarray(
        router_forward(jparams, jnp.asarray(x))), atol=1e-6)
    np.testing.assert_array_equal(ours, ref)
    state = torch.load(path, weights_only=True)
    del state["ln2.bias"]
    with pytest.raises(KeyError, match="ln2.bias"):
        timport.router_from_state_dict(state)


_LOAD_WITHOUT_SKLEARN = """
import json, sys
sys.modules["sklearn"] = None
from ragroute_tpu_torch.router.torch_import import load_sklearn_scaler
out = {}
for p in sys.argv[1:]:
    mean, scale = load_sklearn_scaler(p)
    out[p] = [mean.tolist(), scale.tolist(), str(mean.dtype)]
assert "sklearn.preprocessing" not in sys.modules
print(json.dumps(out))
"""


def test_sklearn_scalers_load_without_sklearn(tmp_path):
    scaler = _sklearn_scaler(24)
    paths = {"bare": str(tmp_path / "scaler.pkl"),
             "tuple": str(tmp_path / "preprocessed_data.pkl"),
             "bare_p2": str(tmp_path / "scaler_p2.pkl")}
    with open(paths["bare"], "wb") as f:
        pickle.dump(scaler, f)
    with open(paths["tuple"], "wb") as f:
        pickle.dump((np.zeros((3, 24)), np.ones(3), [1, 2], scaler,
                     np.arange(4)), f, protocol=4)
    with open(paths["bare_p2"], "wb") as f:
        pickle.dump(scaler, f, protocol=2)
    out = subprocess.run([sys.executable, "-c", _LOAD_WITHOUT_SKLEARN,
                          *paths.values()], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for path in paths.values():
        mean, scale = jimport.load_sklearn_scaler(path)
        assert got[path][2] == "float32"
        np.testing.assert_array_equal(np.asarray(got[path][0], np.float32),
                                      mean)
        np.testing.assert_array_equal(np.asarray(got[path][1], np.float32),
                                      scale)


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("payload,name", [
    (_Evil(), os.system.__module__ + ".system"),
    ((1, 2, 3, None, __import__("collections").OrderedDict()),
     "collections.OrderedDict"),
    (__import__("datetime").date(2024, 1, 1), "datetime.date"),
])
def test_a_pickle_naming_another_global_is_refused(tmp_path, payload, name):
    path = str(tmp_path / "scaler.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(pickle.UnpicklingError, match=name.replace(".", r"\.")):
        timport.load_sklearn_scaler(path)


def test_the_scaler_writer_gives_bytes_real_sklearn_loads(tmp_path):
    from sklearn.preprocessing import StandardScaler

    rng = np.random.default_rng(3)
    mean = rng.standard_normal(10)
    scale = rng.random(10) + 0.5
    x = rng.standard_normal((5, 10))
    items = (np.zeros((2, 10)), [1.5], None, np.arange(3))
    blob = timport.dump_preprocessed_data(items, mean, scale)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # another sklearn version named
        tup = pickle.loads(blob)
    s = tup[3]
    assert type(s) is StandardScaler
    np.testing.assert_allclose(s.transform(x), (x - mean) / scale,
                               rtol=1e-12)
    assert s.n_features_in_ == 10
    assert tup[1] == [1.5] and tup[2] is None
    np.testing.assert_array_equal(tup[0], items[0])
    np.testing.assert_array_equal(tup[4], np.arange(3))
    path = str(tmp_path / "preprocessed_data.pkl")
    with open(path, "wb") as f:
        f.write(blob)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jimport.load_sklearn_scaler(path)
    for got, w in zip(timport.load_sklearn_scaler(path), want):
        np.testing.assert_array_equal(got, w)


def _features(world, bank, syn, rows=40):
    q = {e: torch.from_numpy(v[:rows]) for e, v in syn.query_embs.items()}
    from ragroute_tpu_torch.router import build_features

    return build_features(world, bank, q)


def test_router_pth_world_routes_like_the_jax_package(tmp_path,
                                                      reference_pth):
    import shutil

    from ragroute_tpu.config import get_world as jworld
    from ragroute_tpu.router import build_features as jfeatures
    from ragroute_tpu.system import load_world_artifacts as jload
    from ragroute_tpu_torch.config import get_world
    from ragroute_tpu_torch.system import load_world_artifacts

    _, pth = reference_pth
    root = str(tmp_path / "data")
    syn = make_synthetic_world("medrag", docs_per_source=200, num_queries=40,
                               seed=2)
    save_world(syn, root)
    wroot = os.path.join(root, "medrag")
    shutil.copy(pth, os.path.join(wroot, "router.pth"))
    for load in (load_world_artifacts, jload):
        with pytest.raises(FileNotFoundError, match="scaler"):
            load(root, (get_world if load is load_world_artifacts
                        else jworld)("medrag"))
    scaler = _sklearn_scaler(1540, seed=5)
    for name in ("preprocessed_data.pkl", "scaler.pkl"):
        with open(os.path.join(wroot, name), "wb") as f:
            pickle.dump(scaler if name == "scaler.pkl"
                        else (None, None, None, scaler, None), f)
        out = load_world_artifacts(root, get_world("medrag"))
        jout = jload(root, jworld("medrag"))
        router, bank, thr = out[1], out[2], out[6]
        assert thr is None and jout[6] is None
        np.testing.assert_array_equal(bank.scaler_mean.numpy(),
                                      np.asarray(jout[2].scaler_mean))
        x = _features(syn.world, bank, syn)
        jx = jfeatures(jworld("medrag"), jout[2], {
            e: jnp.asarray(v[:40]) for e, v in syn.query_embs.items()})
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5)
        with torch.no_grad():
            probs = torch.sigmoid(router(x)).numpy()
        jprobs = np.asarray(1 / (1 + jnp.exp(-router_forward(jout[1], jx))))
        np.testing.assert_allclose(probs, jprobs, atol=1e-5)
        t = syn.world.router_threshold
        clear = np.abs(jprobs - t) > 1e-5
        np.testing.assert_array_equal((probs > t)[clear], (jprobs > t)[clear])
        os.remove(os.path.join(wroot, name))


# ---- the import script ------------------------------------------------------

def _reference_tree(tmp_path, reference_pth):
    """A medrag world in the reference's layout, its router and scaler, and
    FeB4RAG-style qrels; returns (syn, argv tail)."""
    syn = make_synthetic_world("medrag", docs_per_source=300, num_queries=4,
                               seed=6)
    corpus = str(tmp_path / "corpus")
    write_medrag_corpus(corpus, syn.embeddings, syn.doc_payloads,
                        chunk_rows=128, seed=1)
    model, _ = reference_pth
    rng = np.random.default_rng(7)
    pth, pkl = write_reference_router(
        str(tmp_path / "routing"), model.state_dict(),
        rng.standard_normal(1540), rng.random(1540) + 0.5)
    qrels = tmp_path / "qrels.txt"
    qrels.write_text("syn0\t0\tpubmed_3\t2\nsyn1\t0\ttextbooks_9\t1\n")
    return syn, ["--corpus-root", corpus, "--router-ckpt", pth,
                 "--scaler", pkl, "--qrels", str(qrels)]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_import_real_data_writes_what_the_jax_script_writes(tmp_path,
                                                            reference_pth):
    import scripts.import_real_data as jscript
    from ragroute_tpu_torch.scripts import import_real_data as tscript

    syn, tail = _reference_tree(tmp_path, reference_pth)
    roots = {side: str(tmp_path / side) for side in ("jax", "port")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # sklearn reads the written one
        jscript.main(["--dataset", "medrag", "--data-root", roots["jax"],
                      *tail])
    tscript.main(["--dataset", "medrag", "--data-root", roots["port"],
                  "--device", "cpu", *tail])
    files = _files(roots["jax"])
    assert files == _files(roots["port"]) and len(files) == 15
    for rel in files:
        a, b = (os.path.join(roots[s], rel) for s in ("jax", "port"))
        if rel.endswith(".npz"):
            da, db = np.load(a), np.load(b)
            assert sorted(da.files) == sorted(db.files)
            for key in da.files:
                np.testing.assert_array_equal(da[key], db[key], err_msg=key)
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
    # payloads in embedding-row order, whatever the chunk files' order
    for src in syn.world.sources:
        with open(os.path.join(roots["port"], "medrag", "payloads",
                               f"{src.name}.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        assert rows == syn.doc_payloads[src.name]
        np.testing.assert_array_equal(
            np.load(os.path.join(roots["port"], "medrag", src.name,
                                 "embeddings.npy")), syn.embeddings[src.name])


def _small_bert(root):
    """A BERT checkpoint at the medrag width (768) with one layer and a
    vocabulary of characters, saved as transformers saves it."""
    from transformers import BertConfig, BertModel, BertTokenizer

    torch.manual_seed(11)
    model = BertModel(BertConfig(
        vocab_size=64, hidden_size=768, num_hidden_layers=1,
        num_attention_heads=12, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2)).eval()
    path = os.path.join(root, "small_bert")
    model.save_pretrained(path)
    chars = [chr(ord("a") + i) for i in range(26)]
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars
             + ["##" + c for c in chars])
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    BertTokenizer(os.path.join(path, "vocab.txt")).save_pretrained(path)
    return path


def test_encode_from_jsonl_matches_the_jax_script(tmp_path, monkeypatch):
    import scripts.import_real_data as jscript
    import ragroute_tpu.config as jconf
    import ragroute_tpu.encoders.registry as jreg
    import ragroute_tpu_torch.config as tconf
    import ragroute_tpu_torch.encoders.registry as treg
    from ragroute_tpu_torch.scripts import import_real_data as tscript

    ckpt = _small_bert(str(tmp_path))
    for reg in (jreg, treg):
        monkeypatch.setitem(reg.ENCODER_SPECS, "small-article",
                            reg.EncoderSpec("small-article", "bert", ckpt,
                                            768, "cls", False,
                                            max_length=48))
    for conf in (jconf, tconf):
        monkeypatch.setattr(conf, "ENCODER_COMPUTE_DTYPE", "float32")
    syn = make_synthetic_world("medrag", docs_per_source=24, num_queries=2,
                               seed=8)
    save_world(syn, str(tmp_path / "world"))
    jsonl = str(tmp_path / "world" / "medrag" / "payloads")
    roots = {side: str(tmp_path / side) for side in ("jax", "port")}
    common = ["--dataset", "medrag", "--encode-from-jsonl", jsonl,
              "--doc-encoder", "small-article", "--encode-batch-size", "8",
              "--limit", "20"]
    jscript.main(common + ["--data-root", roots["jax"]])
    tscript.main(common + ["--data-root", roots["port"], "--device", "cpu"])
    assert _files(roots["jax"]) == _files(roots["port"])
    for src in syn.world.sources:
        parts = ("medrag", src.name, "embeddings.npy")
        a = np.load(os.path.join(roots["jax"], *parts))
        b = np.load(os.path.join(roots["port"], *parts))
        assert a.shape == b.shape == (20, 768)
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                * np.linalg.norm(b, axis=1))
        assert cos.min() >= 0.9999, cos.min()
        for rel in (("medrag", src.name, "doc_ids.json"),
                    ("medrag", "payloads", f"{src.name}.jsonl")):
            with open(os.path.join(roots["jax"], *rel)) as fa, open(
                    os.path.join(roots["port"], *rel)) as fb:
                assert fa.read() == fb.read()
