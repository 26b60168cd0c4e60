"""The grouped GEMM of cluster-aligned pair blocks against the JAX package.

The same numpy-seeded operands go through
``ragroute_tpu.ops.ivf_topk._grouped_gains`` (Pallas in interpret mode on
the CPU) and the port's ``grouped_gains`` (on CPU tensors: its plain version
``grouped_gains_reference``), for f32, bf16, int8 and packed-int4 slabs and
a slab width ``S`` that is a multiple of 8 but not of 128.

Integer-valued operands make every product and partial sum exact in f32, so
those cases must be equal bit for bit; random operands are f32 sums taken
in another order and agree within ``rtol=1e-5, atol=1e-5 * max|gain|``.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from ragroute_tpu.ops.ivf_topk import _grouped_gains
from ragroute_tpu_torch.index.shard import _pack_int4
from ragroute_tpu_torch.ops.grouped_gains import (GROUP_ROWS, grouped_gains,
                                                  grouped_gains_reference)

C, D, S, G = 5, 32, 24, 7
EP = G * GROUP_ROWS
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _operands(kind: str, *, integer: bool, seed: int = 0):
    """numpy operands: q [EP, D], slab [C, D or D/2, S], bias, scale,
    blk_cluster; ``kind`` in float32 | bfloat16 | int8 | int4."""
    rng = np.random.default_rng(seed)
    if integer:
        q = rng.integers(-4, 5, (EP, D)).astype(np.float32)
    else:
        q = rng.standard_normal((EP, D)).astype(np.float32)
    levels = {"int8": 127, "int4": 7}.get(kind)
    if levels:
        codes = rng.integers(-levels, levels + 1, (C, D, S)).astype(np.int8)
        scale = (2.0 ** rng.integers(-3, 2, (C, S))).astype(np.float32)
        if kind == "int4":
            # pack along d: byte row j = dim j (low) and dim j + D/2 (high)
            rows = codes.transpose(0, 2, 1).reshape(C * S, D)
            docs = _pack_int4(rows).reshape(C, S, D // 2).transpose(0, 2, 1)
            docs = np.ascontiguousarray(docs)
        else:
            docs = codes
    else:
        docs = (rng.integers(-4, 5, (C, D, S)) if integer
                else rng.standard_normal((C, D, S))).astype(np.float32)
        scale = None
    bias = rng.integers(-2, 3, (C, S)).astype(np.float32)
    bias[rng.random((C, S)) < 0.2] = -np.inf        # empty slots
    blk = rng.integers(0, C, G).astype(np.int32)
    return q, docs, bias, scale, blk


def _run_both(kind, q, docs, bias, scale, blk):
    packed4 = kind == "int4"
    qdt = "float32" if kind == "float32" else "bfloat16"
    jdocs = jnp.asarray(docs, JNP[kind]) if kind in JNP else jnp.asarray(docs)
    want = np.asarray(_grouped_gains(
        jnp.asarray(q, JNP[qdt]), jdocs, jnp.asarray(bias),
        None if scale is None else jnp.asarray(scale), jnp.asarray(blk),
        packed4=packed4))
    tdocs = torch.from_numpy(docs)
    if kind in JNP:
        tdocs = tdocs.to(getattr(torch, kind))
    got = grouped_gains(
        torch.from_numpy(q).to(getattr(torch, qdt)), tdocs,
        torch.from_numpy(bias),
        None if scale is None else torch.from_numpy(scale),
        torch.from_numpy(blk), packed4)
    assert got.shape == (EP, S) and got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "int4"])
def test_grouped_gains_integer_operands_equal_pallas(kind):
    got, want = _run_both(kind, *_operands(kind, integer=True))
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got).any() and np.isfinite(got).any()
    assert not np.isnan(got).any()


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "int4"])
def test_grouped_gains_random_operands_close_to_pallas(kind):
    got, want = _run_both(kind, *_operands(kind, integer=False, seed=3))
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(
        got[finite], want[finite], rtol=1e-5,
        atol=1e-5 * float(np.abs(want[finite]).max()))


def test_row_table_gathers_the_query_rows():
    """``rows`` names the query of every pair row: the result equals the
    call on the gathered ``[Ep, d]`` copy."""
    q, docs, bias, scale, blk = _operands("int8", integer=True)
    rng = np.random.default_rng(9)
    queries = torch.from_numpy(q[:11]).to(torch.bfloat16)
    rows = torch.from_numpy(rng.integers(0, 11, EP).astype(np.int32))
    args = (torch.from_numpy(docs), torch.from_numpy(bias),
            torch.from_numpy(scale), torch.from_numpy(blk))
    via_rows = grouped_gains(queries, *args, rows=rows)
    gathered = grouped_gains(queries[rows.long()], *args)
    assert torch.equal(via_rows, gathered)
    assert torch.equal(via_rows, grouped_gains_reference(
        queries, *args, rows=rows))
    assert grouped_gains.launches == 0      # no kernel ran on the CPU


def test_shape_checks():
    q, docs, bias, scale, blk = _operands("float32", integer=True)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="pair rows"):
        grouped_gains(t(q[:-1]), t(docs), t(bias), None, t(blk))
    with pytest.raises(ValueError, match="slab depth"):
        grouped_gains(t(q), t(docs), t(bias), None, t(blk), True)
