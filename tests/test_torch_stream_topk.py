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

import jax.numpy as jnp

from ragroute_tpu.ops.pallas_topk import pallas_stream_topk
from ragroute_tpu_torch.ops.stream_topk import (MAX_K, stream_topk,
                                                stream_topk_reference)

NEG_INF = float("-inf")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


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
    assert MAX_K == 160
    with pytest.raises(ValueError):
        stream_topk(g, 301)                 # k > M
    with pytest.raises(ValueError):
        stream_topk(g[0], 4)                # not [B, M]
