"""The probed coarse scan (``ops/grouped_topk.py``) against the JAX package.

Inputs come from a seed through numpy; the JAX side runs as its own tests
run it off the TPU (the Pallas kernel in interpret mode). On the CPU the
port's ``grouped_pair_topk`` is the plain version.

Tolerances. Both sides multiply the same bf16 rows with the same int8 codes
(exact in bf16) and sum in f32, in different orders, then scale and add the
bias in f32: gains agree within ``1e-4`` relative (``+ 1e-4`` absolute for
gains near zero). Slots are compared where the gain is finite and the row's
neighbouring gains are further apart than that tolerance: two offers closer
than the summation noise may come out in either order.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from ragroute_tpu.ops import grouped_topk as jgt
from ragroute_tpu_torch.ops.grouped_topk import (
    PAIR_ROWS, cluster_coarse_slab, clustered_from_reference,
    coarse_probe_topk, grouped_pair_topk, grouped_pair_topk_reference,
    layout_slab, probe_dispatch, tiling)
from ragroute_tpu_torch.ops.topk import shard_topk

REL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _slab(n=3000, r=32, b=16, seed=0, clusters=8, l2_bias=False):
    """Cluster-structured int8 coarse rows and queries near the same
    centres (the shape of ``tests/test_grouped_topk.py``)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, r)).astype(np.float32) * 3
    which = rng.integers(0, clusters, n)
    rows = centers[which] + rng.standard_normal((n, r)).astype(np.float32)
    scales = (np.abs(rows).max(axis=1) / 127.0).astype(np.float32)
    scales = np.where(scales == 0, 1.0, scales)
    codes = np.clip(np.round(rows / scales[:, None]), -127, 127
                    ).astype(np.int8)
    bias = (rng.standard_normal(n).astype(np.float32)
            if l2_bias else np.zeros(n, np.float32))
    qwhich = rng.integers(0, clusters, b)
    qt = (centers[qwhich]
          + 0.5 * rng.standard_normal((b, r))).astype(np.float32)
    return codes, scales, bias, qt


def _fields(jcc):
    return {f: np.asarray(getattr(jcc, f))
            for f in ("centroids", "cbias", "docs", "bias", "scale", "perm")}


def _flat(codes, scales, bias, qt, kp):
    """The flat coarse scan over the same stored values (port, exact)."""
    n = codes.shape[0]
    pad = -(-n // 512) * 512 - n
    t = torch.from_numpy
    s, i = shard_topk(
        t(qt), t(np.pad(codes, ((0, pad), (0, 0)))), kp, mode="dot",
        bias=t(np.pad(bias, (0, pad), constant_values=-np.inf)),
        scale=t(np.pad(scales, (0, pad), constant_values=1e-12)))
    return s.numpy(), i.numpy()


def test_tiling_is_the_jax_rule():
    for s, kappa, want in ((72, 8, (128, 1, 8, 8)), (1024, 8, (1024, 1, 8, 8)),
                           (1584, 8, (1024, 2, 4, 8)),
                           (4704, 8, (1024, 5, 2, 10)),
                           (2048, 1, (1024, 2, 1, 2)), (200, 3, (256, 1, 3, 3))):
        assert tiling(s, kappa) == want


@pytest.mark.parametrize("s,kappa", [(384, 2), (384, 1), (1096, 4),
                                     (1096, 2), (1096, 1)])
def test_pair_topk_reference_matches_the_pallas_kernel(s, kappa):
    """One tile (S=384) and two (S=1096: 1024 + 72), ``ranks`` 1 and 2."""
    rng = np.random.default_rng(s + kappa)
    c, r, g = 3, 32, 2
    docs = rng.integers(-127, 128, (c, r, s)).astype(np.int8)
    scale = (0.01 + 0.01 * rng.random((c, s))).astype(np.float32)
    bias = rng.standard_normal((c, s)).astype(np.float32)
    bias[rng.random((c, s)) < 0.15] = -np.inf
    bias[2, :] = -np.inf                       # an empty cluster
    perm = np.arange(c * s, dtype=np.int32).reshape(c, s)
    cent = np.zeros((c, r), np.float32)
    qd = rng.standard_normal((g * PAIR_ROWS, r)).astype(np.float32)
    blk = np.array([1, 2], np.int32)
    jcc = jgt.ClusteredCoarse(
        centroids=jnp.asarray(cent), cbias=jnp.zeros(c), docs=jnp.asarray(docs),
        bias=jnp.asarray(bias), scale=jnp.asarray(scale),
        perm=jnp.asarray(perm), n_clusters=c, capacity=s)
    jg, ji = jgt._grouped_pair_topk(
        jnp.asarray(qd).astype(jnp.bfloat16), jcc, jnp.asarray(blk), kappa)
    jg, ji = np.asarray(jg), np.asarray(ji)
    tcc = clustered_from_reference(_fields(jcc))
    q = torch.from_numpy(qd).to(torch.bfloat16)
    tg, ti = grouped_pair_topk(q, tcc, torch.from_numpy(blk), kappa)
    kw = tiling(s, kappa)[3]
    assert tg.shape == ti.shape == jg.shape == (g * PAIR_ROWS, kw)
    tg, ti = tg.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.isneginf(tg), np.isneginf(jg))
    fin = np.isfinite(jg)
    np.testing.assert_allclose(tg[fin], jg[fin], rtol=REL, atol=REL)
    assert np.isneginf(tg[PAIR_ROWS:]).all()   # the empty cluster's block
    # slots: equal where finite and not tied across the summation noise
    tol = REL * (1.0 + np.abs(jg))
    gap = np.full(jg.shape, np.inf)
    with np.errstate(invalid="ignore"):
        d = np.abs(np.diff(np.where(fin, jg, np.inf), axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    clear = fin & (np.nan_to_num(gap, nan=np.inf) > 2 * tol)
    assert clear[:PAIR_ROWS].mean() > 0.9
    np.testing.assert_array_equal(ti[clear], ji[clear])
    # the row table gives the same function as the gathered rows
    rows = torch.from_numpy(rng.integers(0, 7, g * PAIR_ROWS).astype(np.int32))
    a = grouped_pair_topk(q[:7].contiguous(), tcc, torch.from_numpy(blk),
                          kappa, rows=rows)
    b = grouped_pair_topk_reference(q[:7][rows.long()], tcc,
                                    torch.from_numpy(blk), kappa)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_pair_topk_reference_ties_and_rank_cap():
    """Exact integer case: duplicate gains across the tile boundary keep
    the lower slot first, a tile offers at most ``ranks`` winners, and
    ``-inf`` never enters."""
    c, r, s = 1, 16, 1032
    docs = np.zeros((c, r, s), np.int8)
    docs[0, 0, :] = 1
    docs[0, 0, [5, 1023, 1024, 1030]] = 9      # four equal best gains
    docs[0, 0, [7, 8, 9]] = 5                  # a third-ranked tie in tile 0
    bias = np.zeros((c, s), np.float32)
    bias[0, 1031] = -np.inf
    cc = clustered_from_reference({
        "centroids": np.zeros((c, r), np.float32), "cbias": np.zeros(c),
        "docs": docs, "bias": bias, "scale": np.ones((c, s), np.float32),
        "perm": np.arange(s, dtype=np.int32)[None]})
    q = torch.zeros((PAIR_ROWS, r), dtype=torch.bfloat16)
    q[:, 0] = 1.0
    blk = torch.zeros(1, dtype=torch.int32)
    g, i = grouped_pair_topk(q, cc, blk, 6)   # two tiles, ranks 3, kw 6
    assert g.shape == (PAIR_ROWS, 6)
    assert g[0].tolist() == [9.0, 9.0, 9.0, 9.0, 5.0, 1.0]
    assert i[0].tolist() == [5, 1023, 1024, 1030, 7, 1025]
    g, i = grouped_pair_topk(q, cc, blk, 2)   # ranks 1: one winner a tile
    assert g[0].tolist() == [9.0, 9.0] and i[0].tolist() == [5, 1024]
    q[3] = 0.0                                 # an all-padding row: all ties
    q[3, 1] = 1.0
    g, i = grouped_pair_topk(q, cc, blk, 4)
    assert g[3].tolist() == [0.0] * 4 and i[3].tolist() == [0, 1, 1024, 1025]


def test_cluster_slab_layout_equals_jax_on_the_same_assignment():
    codes, scales, bias, _ = _slab(l2_bias=True)
    jcc = jgt.cluster_coarse_slab(codes, scales, bias, 100, n_clusters=8,
                                  kmeans_iters=3)
    perm = np.asarray(jcc.perm)
    assign = np.empty(codes.shape[0], np.int32)
    cl, sl = np.nonzero(perm >= 0)
    assign[perm[cl, sl] - 100] = cl
    tcc = layout_slab(codes, scales, bias, 100, assign,
                      np.asarray(jcc.centroids), jcc.n_clusters, jcc.capacity)
    for f, a in _fields(jcc).items():
        np.testing.assert_array_equal(getattr(tcc, f).numpy(), a, err_msg=f)
    assert tcc.nbytes == sum(a.nbytes for a in _fields(jcc).values())


def test_cluster_slab_invariants_of_the_ports_own_build():
    codes, scales, bias, _ = _slab(n=2000, l2_bias=True, seed=2)
    cc = cluster_coarse_slab(codes, scales, bias, 50, n_clusters=8,
                             kmeans_iters=3)
    perm = cc.perm.numpy()
    real = perm >= 0
    assert sorted(perm[real].tolist()) == list(range(50, 2050))
    assert cc.docs.shape == (8, 32, cc.capacity) and cc.capacity % 8 == 0
    assert np.isneginf(cc.bias.numpy()[~real]).all()
    assert (cc.scale.numpy()[~real] == np.float32(1e-12)).all()
    assert (cc.docs.numpy().transpose(0, 2, 1)[~real] == 0).all()
    rows = perm[real] - 50
    np.testing.assert_array_equal(cc.docs.numpy().transpose(0, 2, 1)[real],
                                  codes[rows])
    np.testing.assert_array_equal(cc.bias.numpy()[real], bias[rows])
    np.testing.assert_array_equal(cc.scale.numpy()[real], scales[rows])
    one = cluster_coarse_slab(codes[:40], scales[:40], bias[:40], 0,
                              n_clusters=1)
    assert one.n_clusters == 1 and (one.perm.numpy()[0, :40]
                                    == np.arange(40)).all()


def test_probe_dispatch_is_block_diagonal():
    rng = np.random.default_rng(4)
    bsz, c, p = 300, 5, 3
    probe = torch.from_numpy(np.stack(
        [rng.choice(c, p, replace=False) for _ in range(bsz)]))
    pair_q, blk, n_real, pos = probe_dispatch(probe, c)
    assert blk.shape[0] == (bsz * p) // PAIR_ROWS + min(bsz * p, c)
    assert len(set(pos.reshape(-1).tolist())) == bsz * p      # no collision
    counts = np.bincount(probe.reshape(-1).numpy(), minlength=c)
    assert int(n_real) == int((-(-counts // PAIR_ROWS)).sum())
    for b in range(bsz):
        for j in range(p):
            row = int(pos[b, j])
            assert int(pair_q[row]) == b
            assert int(blk[row // PAIR_ROWS]) == int(probe[b, j])


@pytest.mark.parametrize("l2_bias", [False, True])
def test_coarse_probe_topk_matches_jax_and_the_flat_scan(l2_bias):
    """On a carried-across layout the port returns the JAX function's
    candidates (a doc in one list only scores within ``1e-3 * max(1,
    |k'-th key|)`` of the k'-th key: a boundary near-tie), and the full
    probe with ``kappa >= kp`` truly misses nothing of the flat scan."""
    codes, scales, bias, qt = _slab(l2_bias=l2_bias)
    kp = 40
    jcc = jgt.cluster_coarse_slab(codes, scales, bias, 0, n_clusters=8,
                                  kmeans_iters=4)
    jk, jg = jgt.coarse_probe_topk(jnp.asarray(qt), jcc, kp,
                                   nprobe=jcc.n_clusters, kappa=kp)
    jk, jg = np.asarray(jk), np.asarray(jg)
    tcc = clustered_from_reference(_fields(jcc))
    tk, tgid = coarse_probe_topk(torch.from_numpy(qt), tcc, kp,
                                 nprobe=tcc.n_clusters, kappa=kp)
    tk, tgid = tk.numpy(), tgid.numpy()
    np.testing.assert_allclose(tk, jk, rtol=REL, atol=REL)
    rs, ri = _flat(codes, scales, bias, qt, kp)
    for q in range(qt.shape[0]):
        tol = 1e-3 * max(1.0, abs(float(jk[q][-1])))
        got = {int(x) for x in tgid[q] if x >= 0}
        for other in ({int(x) for x in jg[q] if x >= 0},
                      {int(x) for x in ri[q]}):
            for m in other - got:
                key = (rs[q][list(ri[q]).index(m)] if m in ri[q]
                       else jk[q][list(jg[q]).index(m)])
                assert key <= tk[q][-1] + tol, (q, m)
        assert (np.diff(tk[q]) <= 0).all()                 # best first
        np.testing.assert_allclose(tk[q], rs[q], rtol=2e-2, atol=2e-2)


def test_partial_probe_recall_and_row0_on_the_ports_own_build():
    codes, scales, bias, qt = _slab(n=6000, clusters=16, b=24, seed=3)
    kp = 32
    cc = cluster_coarse_slab(codes, scales, bias, 1000, n_clusters=16,
                             kmeans_iters=6)
    _, gid = coarse_probe_topk(torch.from_numpy(qt), cc, kp, nprobe=4,
                               kappa=kp)
    gid = gid.numpy()
    assert gid[gid >= 0].min() >= 1000 and gid.max() < 7000
    _, ri = _flat(codes, scales, bias, qt, kp)
    hits = sum(len({int(x) + 1000 for x in ri[q]}
                   & {int(x) for x in gid[q] if x >= 0})
               for q in range(qt.shape[0]))
    assert hits / ri.size >= 0.9, f"nprobe=4/16 recall {hits / ri.size:.3f}"
    # fewer reachable candidates than kp: the tail is (-inf, -1)
    keys, gid = coarse_probe_topk(torch.from_numpy(qt), cc, 64, nprobe=1,
                                  kappa=2)
    assert torch.isneginf(keys[:, 2:]).all() and (gid[:, 2:] == -1).all()
    assert (gid[:, :2] >= 1000).all()
