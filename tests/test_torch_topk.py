"""Parity of the port's top-k ops with the JAX package (CPU).

Inputs are made with numpy from a seed and go through the JAX function and
its PyTorch counterpart. The JAX side reaches the fused kernel the way its
own tests do: ``pallas_topk`` in interpret mode at tiny shapes. The port's
wrapper takes its plain version for CPU tensors.

Tolerances: f32 scores ``rtol=atol=1e-5`` (XLA:CPU and torch sum in other
orders), indices equal; integer-valued tie cases equal everywhere.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from ragroute_tpu.ops import topk as jtopk
from ragroute_tpu.ops.pallas_topk import pallas_topk
from ragroute_tpu_torch.ops import topk as ttopk
from ragroute_tpu_torch.ops.fused_topk import fused_topk

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _np(x):
    return np.asarray(x)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _tie_data(seed, bsz=12, n=300, d=32):
    """Small integers: exact sums, many ties; duplicate rows straddle the
    chunk/tile boundaries used below."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(-4, 5, (n, d)).astype(np.float32)
    docs[[63, 64, 127, 128, 255, 256]] = docs[5]
    docs[[30, 31, 200, 201, 202]] = docs[7]
    q = rng.integers(-4, 5, (bsz, d)).astype(np.float32)
    return q, docs


@pytest.mark.parametrize("mode", ["dot", "l2"])
@pytest.mark.parametrize("k", [10, 32])
def test_exact_and_chunked_ties_equal_jax(mode, k):
    q, docs = _tie_data(k)
    js, ji = jtopk.exact_topk(jnp.asarray(q), jnp.asarray(docs), k, mode=mode)
    for impl in ("exact", "chunked"):
        s, i = ttopk.shard_topk(_t(q), _t(docs), k, mode=mode, impl=impl,
                                chunk=64)
        np.testing.assert_array_equal(i.numpy(), _np(ji), err_msg=impl)
        np.testing.assert_array_equal(s.numpy(), _np(js), err_msg=impl)


@pytest.mark.parametrize("mode", ["dot", "cos", "l2"])
def test_exact_topk_matches_jax_f32(mode):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((9, 48)).astype(np.float32)
    docs = rng.standard_normal((700, 48)).astype(np.float32)
    bias = rng.standard_normal(700).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 700).astype(np.float32)
    for kw in ({}, {"valid_docs": 650}, {"bias": bias, "scale": scale}):
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        js, ji = jtopk.exact_topk(jnp.asarray(q), jnp.asarray(docs), 16,
                                  mode=mode, **jkw)
        s, i = ttopk.exact_topk(_t(q), _t(docs), 16, mode=mode, **tkw)
        np.testing.assert_array_equal(i.numpy(), _np(ji))
        np.testing.assert_allclose(s.numpy(), _np(js), **TOL)


@pytest.mark.parametrize("mode", ["dot", "cos", "l2"])
def test_chunked_topk_matches_jax_with_ragged_last_chunk(mode):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((7, 32)).astype(np.float32)
    docs = rng.standard_normal((1000, 32)).astype(np.float32)
    js, ji = jtopk.chunked_topk(jnp.asarray(q), jnp.asarray(docs), 12,
                                mode=mode, valid_docs=990, chunk=256)
    s, i = ttopk.chunked_topk(_t(q), _t(docs), 12, mode=mode,
                              valid_docs=990, chunk=256)
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    np.testing.assert_allclose(s.numpy(), _np(js), **TOL)


def test_merge_topk_ties_prefer_first_list_then_lower_position():
    ga = np.array([[3.0, 2.0, 2.0, 1.0]], np.float32)
    gb = np.array([[2.0, 2.0, 1.0, 0.0]], np.float32)
    ia = np.array([[10, 11, 12, 13]], np.int32)
    ib = np.array([[20, 21, 22, 23]], np.int32)
    jg, ji = jtopk.merge_topk(*(jnp.asarray(a) for a in (ga, ia, gb, ib)), 5)
    tg, ti = ttopk.merge_topk(_t(ga), _t(ia).long(), _t(gb), _t(ib).long(),
                              5)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_array_equal(tg.numpy(), _np(jg))


def test_unpack_int4_matches_jax():
    rng = np.random.default_rng(3)
    packed = rng.integers(-128, 128, (20, 16)).astype(np.int8)
    np.testing.assert_array_equal(
        ttopk.unpack_int4(_t(packed)).numpy(),
        _np(jtopk.unpack_int4(jnp.asarray(packed))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["dot", "cos", "l2"])
def test_fused_wrapper_matches_pallas_interpret_on_ties(dtype, mode):
    """The wrapper's plain path against the TPU kernel in interpret mode,
    integer data (exact in any order): everything equal, including tie
    order across the kernel's doc tiles."""
    q, docs = _tie_data(11, bsz=8, n=600, d=64)
    if mode == "cos":
        q = np.zeros_like(q)
        q[:, :16] = np.where(np.arange(16) % 3 == 0, -1.0, 1.0)  # |q| = 4
    scale = None
    if dtype == "int8":
        scale = (2.0 ** np.random.default_rng(4).integers(-2, 2, 600)
                 ).astype(np.float32)
    jdocs = jnp.asarray(docs).astype(getattr(jnp, dtype))
    tdocs = _t(docs).to(getattr(torch, dtype))
    js, ji = pallas_topk(jnp.asarray(q), jdocs, 10, mode=mode,
                         valid_docs=590,
                         scale=None if scale is None else jnp.asarray(scale))
    before = fused_topk.launches
    s, i = fused_topk(_t(q), tdocs, 10, mode=mode, valid_docs=590,
                      scale=None if scale is None else _t(scale))
    assert fused_topk.launches == before    # CPU tensors: plain version
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    np.testing.assert_array_equal(s.numpy(), _np(js))


@pytest.mark.parametrize("bsz,mode,k", [(1, "dot", 10), (1, "l2", 32),
                                         (1, "cos", 32), (8, "dot", 32)])
def test_fused_wrapper_f32_small_batches_match_pallas_interpret_on_ties(
        bsz, mode, k):
    """f32 docs at the small batches the small-batch f32 scan takes on the
    card (the batcher's buckets 1 and 8), integer data with duplicate rows
    across the 256-doc tiles: the wrapper's plain path equals the TPU
    kernel in interpret mode, tie order included."""
    q, docs = _tie_data(17, bsz=bsz, n=600, d=64)
    docs[[510, 511, 512, 513]] = docs[9]
    if mode == "cos":
        q = np.zeros_like(q)
        q[:, :16] = np.where(np.arange(16) % 3 == 0, -1.0, 1.0)  # |q| = 4
    js, ji = pallas_topk(jnp.asarray(q), jnp.asarray(docs), k, mode=mode,
                         valid_docs=590)
    s, i = fused_topk(_t(q), _t(docs), k, mode=mode, valid_docs=590)
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    np.testing.assert_array_equal(s.numpy(), _np(js))


def test_fused_wrapper_matches_pallas_interpret_f32_random():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((5, 64)).astype(np.float32)
    docs = rng.standard_normal((520, 64)).astype(np.float32)
    bias = -rng.uniform(0, 1, 520).astype(np.float32)
    js, ji = pallas_topk(jnp.asarray(q), jnp.asarray(docs), 32, mode="l2",
                         bias=jnp.asarray(bias))
    s, i = fused_topk(_t(q), _t(docs), 32, mode="l2", bias=_t(bias))
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    np.testing.assert_allclose(s.numpy(), _np(js), **TOL)


@pytest.mark.parametrize("scales,k", [("doc", 10), ("group", 32),
                                      ("doc", 128), ("group", 160)])
def test_fused_wrapper_int4_and_deep_k_match_pallas_interpret(scales, k):
    """Packed-int4 shards (per-doc ``[N]`` and per-group ``[N, G]`` scales)
    and lists deeper than 64 against the TPU kernel in interpret mode.
    Integer queries, 4-bit codes and power-of-two scales are exact in bf16
    and in any summation order: indices and scores equal, ties included."""
    rng = np.random.default_rng(k)
    n, d, groups = 700, 64, 2
    q = rng.integers(-4, 5, (6, d)).astype(np.float32)
    packed = rng.integers(-128, 128, (n, d // 2)).astype(np.int8)
    packed[300:330] = packed[7]             # ties across the doc tiles
    shape = (n, groups) if scales == "group" else (n,)
    scale = (2.0 ** rng.integers(-2, 2, shape)).astype(np.float32)
    scale[300:330] = scale[7]
    bias = rng.integers(-3, 4, n).astype(np.float32)
    bias[300:330] = bias[7]
    js, ji = pallas_topk(jnp.asarray(q), jnp.asarray(packed), k, mode="l2",
                         valid_docs=n - 9, bias=jnp.asarray(bias),
                         scale=jnp.asarray(scale), packed4=True)
    s, i = fused_topk(_t(q), _t(packed), k, mode="l2", valid_docs=n - 9,
                      bias=_t(bias), scale=_t(scale), packed4=True)
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    np.testing.assert_array_equal(s.numpy(), _np(js))
    assert int(i.max()) < n - 9


@pytest.mark.parametrize("mode", ["dot", "l2"])
@pytest.mark.parametrize("impl", ["exact", "chunked"])
def test_shard_topk_center_restores_scores_like_jax(mode, impl):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    raw = rng.standard_normal((800, 32)).astype(np.float32) + 3.0
    mu = raw.mean(axis=0).astype(np.float32)
    docs = raw - mu
    bias = (-(docs * docs).sum(1)).astype(np.float32) if mode == "l2" \
        else np.zeros(800, np.float32)
    js, ji = jtopk.shard_topk(jnp.asarray(q), jnp.asarray(docs), 8,
                              mode=mode, bias=jnp.asarray(bias),
                              center=jnp.asarray(mu), impl=impl, chunk=256)
    s, i = ttopk.shard_topk(_t(q), _t(docs), 8, mode=mode, bias=_t(bias),
                            center=_t(mu), impl=impl, chunk=256)
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    np.testing.assert_allclose(s.numpy(), _np(js), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("grouped", [False, True])
def test_shard_topk_packed4_dequant_matches_jax(grouped):
    rng = np.random.default_rng(7)
    d = 256
    q = rng.standard_normal((4, d)).astype(np.float32)
    packed = rng.integers(-128, 128, (600, d // 2)).astype(np.int8)
    scale = (rng.uniform(0.01, 0.1, (600, 2)) if grouped
             else rng.uniform(0.01, 0.1, 600)).astype(np.float32)
    for impl in ("exact", "chunked"):
        js, ji = jtopk.shard_topk(jnp.asarray(q), jnp.asarray(packed), 10,
                                  scale=jnp.asarray(scale), impl=impl,
                                  chunk=128, packed4=True)
        s, i = ttopk.shard_topk(_t(q), _t(packed), 10, scale=_t(scale),
                                impl=impl, chunk=128, packed4=True)
        np.testing.assert_array_equal(i.numpy(), _np(ji), err_msg=impl)
        np.testing.assert_allclose(s.numpy(), _np(js), rtol=1e-5, atol=1e-4)


def test_auto_impl_picks_exact_small_and_chunked_on_cpu():
    rng = np.random.default_rng(8)
    q = _t(rng.standard_normal((3, 16)).astype(np.float32))
    big = _t(rng.standard_normal((5000, 16)).astype(np.float32))
    before = fused_topk.launches
    s, i = ttopk.shard_topk(q, big, 5)
    se, ie = ttopk.shard_topk(q, big, 5, impl="exact")
    assert fused_topk.launches == before
    assert torch.equal(i, ie)
    torch.testing.assert_close(s, se, rtol=1e-5, atol=1e-5)
