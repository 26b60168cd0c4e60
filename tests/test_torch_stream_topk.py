"""The streaming top-k over stored gains against the JAX package (CPU).

The same numpy-seeded gain matrices go through
``ragroute_tpu.ops.pallas_topk.pallas_stream_topk`` (Pallas in interpret
mode, as ``tests/test_topk.py`` runs it) and the port's
``stream_topk`` (on a CPU tensor: its plain version
``stream_topk_reference``). Nothing is summed, so gains and positions must
be equal, ties to the lower position; only the position of an unfilled
(``-inf``) slot is left open by the TPU kernel and is 0 in the port.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from ragroute_tpu.ops.pallas_topk import pallas_stream_topk
from ragroute_tpu_torch.ops.stream_topk import (MAX_SHALLOW_K, stream_topk,
                                                stream_topk_reference)

NEG_INF = float("-inf")


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _both(gains: np.ndarray, k: int):
    jg, jp = pallas_stream_topk(jnp.asarray(gains), k)
    tg, tp = stream_topk(torch.from_numpy(gains), k)
    assert tg.dtype == torch.float32 and tp.dtype == torch.int32
    return np.asarray(jg), np.asarray(jp), tg.numpy(), tp.numpy()


@pytest.mark.parametrize("b,m,k", [(24, 3000, 16), (5, 4096, 32),
                                   (3, 1000, 128)])
def test_stream_topk_matches_pallas(b, m, k):
    rng = np.random.default_rng(b * m + k)
    gains = rng.standard_normal((b, m)).astype(np.float32)
    gains[1] = NEG_INF                      # a fully invalid row
    gains[2, 100:] = NEG_INF                # fewer valid entries than k=128
    jg, jp, tg, tp = _both(gains, k)
    np.testing.assert_array_equal(tg, jg)
    valid = jg > NEG_INF
    np.testing.assert_array_equal(tp[valid], jp[valid])
    assert (tp[~valid] == 0).all()


@pytest.mark.parametrize("m,k", [(2048, 8), (1536, 32), (640, 160)])
def test_stream_topk_tie_positions(m, k):
    """Integer gains: many duplicates across every tile boundary; the
    lowest position wins and tie groups come position-ascending."""
    rng = np.random.default_rng(m + k)
    gains = rng.integers(-3, 3, size=(8, m)).astype(np.float32)
    jg, jp, tg, tp = _both(gains, k)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tp, jp)


def test_stream_topk_all_equal_row_returns_first_k():
    gains = np.zeros((2, 700), np.float32)
    gains[1, 300:] = NEG_INF
    _, _, tg, tp = _both(gains, 16)
    np.testing.assert_array_equal(tp, np.tile(np.arange(16), (2, 1)))
    assert (tg == 0).all()


def test_wrapper_is_the_plain_version_on_cpu_and_checks_its_arguments():
    g = torch.randn(4, 300)
    a = stream_topk(g, 10)
    b = stream_topk_reference(g, 10)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert stream_topk.launches == 0        # no kernel ran on the CPU
    assert MAX_SHALLOW_K == 160
    with pytest.raises(ValueError):
        stream_topk(g, 301)                 # k > M
    with pytest.raises(ValueError):
        stream_topk(g[0], 4)                # not [B, M]


def _sorted_runs(b, runs, kw, seed, pad_share=0.1):
    """Rows made as the probed coarse scan makes them: ``runs`` runs of
    ``kw`` gains, each run sorted descending with its unfilled slots
    (``-inf``) at its tail; gains on a 1/8 grid, so values tie within and
    across runs and across the k boundary."""
    rng = np.random.default_rng(seed)
    g = np.round(rng.standard_normal((b, runs, kw)) * 8) / 8
    g[rng.random((b, runs, kw)) < pad_share] = NEG_INF
    g = -np.sort(-g, axis=-1)
    return g.reshape(b, runs * kw).astype(np.float32)


@pytest.mark.parametrize("k", [8, 64, 128])
def test_stream_topk_sorted_runs_match_pallas(k):
    gains = _sorted_runs(6, 64, 8, seed=k)
    gains[3] = NEG_INF                      # a fully invalid row
    jg, jp, tg, tp = _both(gains, k)
    np.testing.assert_array_equal(tg, jg)
    valid = jg > NEG_INF
    np.testing.assert_array_equal(tp[valid], jp[valid])
    assert (tp[~valid] == 0).all()
    # ties straddle the k boundary: the last winner's gain continues past it
    rest = -np.sort(-gains, axis=1)[:, k]
    assert (rest[valid[:, -1]] == tg[valid[:, -1], -1]).any()


@pytest.mark.parametrize("bsz,m,k", [
    (512, 4096, 128), (512, 131_072, 32), (512, 131_072, 128), (8, 4096, 128),
    (9, 70_001, 32), (1, 1, 1), (37, 5000, 160), (3, 8193, 10),
    (2048, 8192, 64), (64, 2 ** 20, 160), (4, 65_537, 64)])
def test_plan_splits_cover_the_row(bsz, m, k):
    """The path and split plan is a function of (B, M, k, SMs): every
    position lies in exactly one run, no run is empty, a select run fits the
    select kernel, and a block's shared memory stays within the card's."""
    from ragroute_tpu_torch.ops import stream_topk as st

    p = st.plan(bsz, m, k, 132)
    assert p == st.plan(bsz, m, k, 132)                 # pure
    assert p.splits >= 1 and (p.splits - 1) * p.chunk < m <= p.splits * p.chunk
    starts = np.arange(p.splits) * p.chunk
    ends = np.minimum(starts + p.chunk, m)
    assert (ends > starts).all() and ends[-1] == m
    assert (starts[1:] == ends[:-1]).all()              # each position once
    assert st.smem_bytes(p, k) <= st.SMEM_LIMIT
    if k > st.SHALLOW_K or m <= st.SELECT_CHUNK:
        assert p.path == st.SELECT and p.chunk <= st.SELECT_CHUNK
    else:
        assert p.path == st.COLLECT and p.chunk % st.COLLECT_ROUND == 0
        assert p.chunk >= st.MIN_CHUNK or p.splits == 1
        # persistent blocks: at most the card's resident ones, no idle one
        assert 1 <= p.grid <= 132 * st.COLLECT_BLOCKS_PER_SM
        assert (p.grid - 1) * st.COLLECT_WARPS < bsz * p.splits


def test_plan_picks_the_select_path_for_the_probed_collect():
    """The probed collect (k' = 128 over 512 runs of 8) is one select run a
    row, one launch; the ivf collect takes the collect."""
    from ragroute_tpu_torch.ops import stream_topk as st

    assert st.plan(512, 4096, 128, 132) == st.Plan(st.SELECT, 1, 4096)
    assert st.plan(512, 131_072, 32, 132).path == st.COLLECT
