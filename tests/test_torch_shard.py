"""The port's shard store and synthetic worlds against the JAX package.

Shard arrays must be bit-equal to ``ragroute_tpu`` ``ShardSet.build``:
f32 and bf16 docs, int8 codes and scales, packed int4 bytes and (per-group
or per-doc) scales, bias (with its -inf padding tail) and centre. The
synthetic world and the files ``save_world`` writes must be byte-equal.
"""

import filecmp
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from ragroute_tpu.index import ShardSet as JShardSet
from ragroute_tpu.index import make_synthetic_world as jmake
from ragroute_tpu.index.synthetic import save_world as jsave
from ragroute_tpu_torch.index import ShardSet, make_synthetic_world, save_world


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _bits(x) -> np.ndarray:
    """Raw bytes of a device array / tensor, for bit-equality."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint8)
    a = np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("world_name,dtype", [
    ("medrag", "float32"), ("medrag", "bfloat16"), ("medrag", "int8"),
    ("wikipedia", "bfloat16"), ("wikipedia", "int8"),
    ("medrag", "int4"), ("feb4rag", "bfloat16"),
])
def test_shard_arrays_bit_equal_to_jax(world_name, dtype):
    syn = make_synthetic_world(world_name, docs_per_source=40,
                               num_queries=2, seed=3, with_payloads=False)
    jdtype = "int4" if dtype == "int4" else getattr(jnp, dtype)
    tdtype = "int4" if dtype == "int4" else getattr(torch, dtype)
    jset = JShardSet.build(syn.world, syn.embeddings, dtype=jdtype)
    tset = ShardSet.build(syn.world, syn.embeddings, dtype=tdtype)
    assert tset.index_bytes == jset.index_bytes
    assert tset.total_docs == jset.total_docs
    for js, ts in zip(jset.shards, tset.shards):
        assert (ts.n_docs, ts.name, ts.score_mode, ts.packed4) == \
            (js.n_docs, js.name, js.score_mode, js.packed4)
        assert tuple(ts.docs.shape) == tuple(js.docs.shape)
        for field in ("docs", "bias", "scale", "center"):
            a, b = getattr(js, field), getattr(ts, field)
            assert (a is None) == (b is None), field
            if a is not None:
                np.testing.assert_array_equal(_bits(b), _bits(a),
                                              err_msg=field)
        assert np.isneginf(ts.bias[ts.n_docs:].numpy()).all()


def test_numpy_quantizers_bit_equal_to_jax_package():
    """The port's copies of the int8/int4 quantizers and the int4 packer
    give the reference's codes and scales bit for bit (per-doc, per-doc
    MSE-optimal for dims the int4 group does not divide, per-group)."""
    from ragroute_tpu.index.shard import (_pack_int4, _quantize_sym,
                                          _quantize_sym_grouped)
    from ragroute_tpu_torch.index import shard as tshard

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((64, 96)).astype(np.float32)
    for levels, mse in ((127, False), (7, True)):
        jc, js = _quantize_sym(emb, levels, mse_opt=mse)
        tc, ts = tshard._quantize_sym(emb, levels, mse_opt=mse)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ts.view(np.uint32), js.view(np.uint32))
    emb2 = rng.standard_normal((32, 256)).astype(np.float32)
    jc, js = _quantize_sym_grouped(emb2, 7, 128)
    tc, ts = tshard._quantize_sym_grouped(emb2, 7, 128)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts.view(np.uint32), js.view(np.uint32))
    np.testing.assert_array_equal(tshard._pack_int4(tc), _pack_int4(jc))


def test_synthetic_world_and_saved_files_byte_equal(tmp_path):
    kw = dict(docs_per_source_map={"pubmed": 90, "statpearls": 40,
                                   "textbooks": 50, "wikipedia": 33},
              num_queries=6, seed=5)
    jsyn = jmake("medrag", **kw)
    tsyn = make_synthetic_world("medrag", **kw)
    for name in jsyn.embeddings:
        np.testing.assert_array_equal(tsyn.embeddings[name],
                                      jsyn.embeddings[name])
    assert tsyn.doc_payloads == jsyn.doc_payloads
    assert tsyn.questions == jsyn.questions
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    jsave(jsyn, str(jroot))
    save_world(tsyn, str(troot))
    files = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    tfiles = sorted(os.path.relpath(os.path.join(d, f), troot)
                    for d, _, fs in os.walk(troot) for f in fs)
    assert files == tfiles and len(files) > 10
    for f in files:
        assert filecmp.cmp(jroot / f, troot / f, shallow=False), f


def test_load_round_trip_matches_build(tmp_path):
    syn = make_synthetic_world("wikipedia", docs_per_source=40,
                               num_queries=2, seed=2)
    save_world(syn, str(tmp_path))
    loaded = ShardSet.load(str(tmp_path), syn.world, dtype=torch.float32)
    built = ShardSet.build(syn.world, syn.embeddings, doc_ids=syn.doc_ids,
                           dtype=torch.float32)
    assert loaded.doc_ids == built.doc_ids
    for a, b in zip(loaded.shards, built.shards):
        assert torch.equal(a.docs, b.docs) and torch.equal(a.bias, b.bias)
