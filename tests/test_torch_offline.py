"""The port's offline path against the JAX package's (CPU).

* ``OfflinePipeline.run`` (``from_data_root`` on one saved world and one
  ``router.npz``) gives the JAX pipeline's ``data_sources``, ``top_docs``,
  ``messages`` and ``docs_tokens`` (equal) and its router probabilities
  (atol 1e-5) for medrag, feb4rag (the qrels rerank) and wikipedia (the
  options prompt), a query table's qids and an unknown one (the hash
  fallback) alike.
* ``python -m ragroute_tpu_torch.scripts.eval_recall --device cpu`` prints
  the JAX script's JSON line: the same keys and settings, recalls within
  0.01, equal at f32; ``make_synthetic_data`` writes the JAX script's
  files byte for byte.
* The own copies ``eval_metrics`` and ``index.faiss_import`` give the
  originals' results; the reference-layout writer's FAISS files read the
  same in both packages.
"""

import json
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax

from ragroute_tpu.router import init_router_params
from ragroute_tpu.router.torch_import import save_router_npz as jsave_npz
from ragroute_tpu_torch.index.synthetic import make_synthetic_world, save_world


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _world(root, name, docs=256, queries=12, seed=0):
    """A saved synthetic world with a router.npz drawn by the JAX package
    (seed 3), so both packages route with the same weights."""
    syn = make_synthetic_world(name, docs_per_source=docs,
                               num_queries=queries, seed=seed)
    save_world(syn, root)
    params = init_router_params(jax.random.key(3),
                                syn.world.router_input_dim)
    jsave_npz(os.path.join(root, name, "router.npz"), params,
              threshold=0.5)
    return syn


@pytest.mark.parametrize("dataset", ["medrag", "feb4rag", "wikipedia"])
def test_offline_pipeline_matches_jax(tmp_path, dataset):
    from ragroute_tpu.pipeline import OfflinePipeline as JPipeline
    from ragroute_tpu_torch.pipeline import OfflinePipeline

    root = str(tmp_path)
    syn = _world(root, dataset, docs=128 if dataset == "feb4rag" else 256)
    ours = OfflinePipeline.from_data_root(root, dataset, device="cpu")
    ref = JPipeline.from_data_root(root, dataset)
    assert ours.engine.device.type == "cpu"
    routed = 0
    for q in syn.questions[:6] + [{"qid": "not-a-qid",
                                   "question": "anything at all?",
                                   "options": syn.questions[0]["options"]}]:
        a = ours.run(q["question"], q["options"], qid=q["qid"])
        b = ref.run(q["question"], q["options"], qid=q["qid"])
        for key in ("question", "data_sources", "top_docs", "messages",
                    "docs_tokens"):
            assert a[key] == b[key], (q["qid"], key)
        np.testing.assert_allclose(a["probs"], b["probs"], atol=1e-5)
        routed += bool(a["data_sources"])
        if a["data_sources"] and dataset != "feb4rag":
            assert len(a["top_docs"]) == syn.world.k
    assert routed >= 3


def test_from_synthetic_serves_on_the_device_it_is_given():
    from ragroute_tpu_torch.pipeline import OfflinePipeline

    pipe = OfflinePipeline.from_synthetic("medrag", strategy="all",
                                          docs_per_source=300,
                                          num_queries=4, device="cpu")
    out = pipe.run("What causes diabetes?", {"A": "x", "B": "y"}, qid="syn0")
    assert sorted(out["data_sources"]) == [
        "pubmed", "statpearls", "textbooks", "wikipedia"]
    assert len(out["top_docs"]) == 32 and out["top_docs"][0]["title"]
    s = [v for v in out["merged_scores"] if not np.isnan(v)]
    assert all(s[i] >= s[i + 1] - 1e-4 for i in range(len(s) - 1))
    assert "Document [0]" in out["messages"][1]["content"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_recall_prints_the_jax_scripts_line(tmp_path, capsys, dtype):
    import scripts.eval_recall as jscript
    from ragroute_tpu_torch.scripts import eval_recall as tscript

    root = str(tmp_path)
    _world(root, "medrag", docs=512, queries=48)
    argv = ["--dataset", "medrag", "--data-root", root, "--dtype", dtype,
            "--num-queries", "40"]
    jscript.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tscript.main(argv + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == got
    assert {k: v for k, v in got.items() if k != "recall"} == \
        {k: v for k, v in want.items() if k != "recall"}
    assert list(got["recall"]) == list(want["recall"]) == [
        "all", "ragroute", "random"]
    for strategy, r in want["recall"].items():
        if dtype == "float32":
            assert got["recall"][strategy] == r == 1.0
        else:
            assert abs(got["recall"][strategy] - r) <= 0.01


def test_eval_recall_reports_the_ivf_layout(tmp_path, capsys):
    from ragroute_tpu_torch.scripts import eval_recall as tscript

    root = str(tmp_path)
    _world(root, "medrag", docs=512, queries=16)
    got = tscript.main(["--dataset", "medrag", "--data-root", root,
                        "--impl", "ivf", "--ivf-clusters", "8",
                        "--nprobe", "8", "--strategies", "all",
                        "--device", "cpu"])
    assert got["ivf"]["pubmed"]["C"] == 8
    assert got["ivf"]["pubmed"]["nprobe"] == 8
    assert got["recall"]["all"] >= 0.99       # every cluster probed


def test_make_synthetic_data_scripts_write_the_same_files(tmp_path):
    import filecmp

    import scripts.make_synthetic_data as jscript
    from ragroute_tpu_torch.scripts import make_synthetic_data as tscript

    argv = ["--dataset", "wikipedia", "--docs-per-source", "64",
            "--num-queries", "6", "--seed", "4", "--subclusters", "3"]
    jscript.main(argv + ["--data-root", str(tmp_path / "a")])
    tscript.main(argv + ["--data-root", str(tmp_path / "b"),
                         "--device", "cpu"])
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


def test_eval_metrics_copy_gives_the_originals_results():
    from ragroute_tpu import eval_metrics as ref
    from ragroute_tpu_torch import eval_metrics as ours

    rng = np.random.default_rng(9)
    docs = [f"d{i}" for i in range(40)]
    qrels, results = {}, {}
    for q in range(12):
        rel = rng.choice(docs, 6, replace=False)
        qrels[f"q{q}"] = {d: int(rng.integers(0, 3)) for d in rel}
        results[f"q{q}"] = {d: float(rng.random()) for d in
                            rng.choice(docs, 25, replace=False)}
    qrels["empty"] = {"d1": 0}
    for ks in ((1, 10, 100), (3, 5)):
        assert ours.evaluate_retrieval(qrels, results, ks) == \
            ref.evaluate_retrieval(qrels, results, ks)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_faiss_files_read_the_same_in_both_packages(tmp_path, metric):
    from ragroute_tpu.index.faiss_import import read_flat_index as jread
    from ragroute_tpu_torch.index.faiss_import import read_flat_index
    from ragroute_tpu_torch.index.reference_layout import write_flat_index
    from tests.test_faiss_import import write_flat

    vecs = np.random.default_rng(2).standard_normal((33, 12)).astype(
        np.float32)
    ours_path, ref_path = str(tmp_path / "a.index"), str(tmp_path / "b.index")
    write_flat_index(ours_path, vecs, metric)
    write_flat(ref_path, vecs, b"IxFI" if metric == "ip" else b"IxF2",
               0 if metric == "ip" else 1)
    with open(ours_path, "rb") as fa, open(ref_path, "rb") as fb:
        assert fa.read() == fb.read()
    for path in (ours_path, ref_path):
        got, got_metric = read_flat_index(path)
        want, want_metric = jread(path)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, vecs)
        assert got_metric == want_metric == metric
    bad = str(tmp_path / "ivf.index")
    with open(bad, "wb") as f:
        f.write(b"IwIF" + b"\0" * 64)
    with pytest.raises(ValueError, match="not a FAISS flat index"):
        read_flat_index(bad)
