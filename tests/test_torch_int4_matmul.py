"""The port's int4 matmul (K5) against the JAX package's, on the CPU.

The CUDA kernel runs only on a card (``tests/test_torch_kernel.py`` holds it
against the plain version there); here the wrapper takes its plain version,
which must agree with the JAX package's Pallas kernel (interpret mode off the
TPU) at f32 within 1e-5 relative. The host copies ``pack_int4_rows``,
``quantize_int4`` and ``dequant_int4`` are bit-equal to numpy's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu.ops import int4_matmul as jx
from ragroute_tpu_torch.ops import int4_matmul as tx


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


@pytest.mark.parametrize("in_dim,out,group", [(48, 20, 8), (256, 96, 128),
                                              (128, 260, 64), (40, 7, 20),
                                              (48, 33, 24), (96, 16, 6)])
def test_quantize_and_pack_are_bit_equal(in_dim, out, group):
    rng = np.random.default_rng(in_dim + out)
    w = rng.normal(size=(in_dim, out)).astype(np.float32) * 3.0
    w[0, 0] = 0.0
    p, s = jx.quantize_int4(w, group=group)
    tp, ts = tx.quantize_int4(torch.from_numpy(w), group=group)
    np.testing.assert_array_equal(p, tp.numpy())
    np.testing.assert_array_equal(s, ts.numpy())
    codes = rng.integers(-8, 8, (in_dim, out)).astype(np.int8)
    np.testing.assert_array_equal(
        jx.pack_int4_rows(codes),
        tx.pack_int4_rows(torch.from_numpy(codes)).numpy())
    np.testing.assert_array_equal(jx.dequant_int4(p, s, group),
                                  tx.dequant_int4(tp, ts, group).numpy())


@pytest.mark.parametrize("m,in_dim,out,group", [
    (1, 128, 260, 64), (5, 256, 128, 128), (16, 48, 40, 24),
    (3, 48, 96, 12), (37, 512, 64, 64), (2, 1024, 136, 128)])
def test_plain_version_matches_jax_kernel(m, in_dim, out, group):
    rng = np.random.default_rng(m * 7 + in_dim)
    x = rng.normal(size=(m, in_dim)).astype(np.float32)
    packed = rng.integers(-128, 128, (in_dim // 2, out)).astype(np.int8)
    scales = (rng.random((in_dim // group, out)) * 0.05 + 1e-3).astype(
        np.float32)
    want = np.asarray(jx.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                     jnp.asarray(scales), group=group))
    before = tx.int4_matmul.launches
    got = tx.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                         torch.from_numpy(scales), group=group)
    assert tx.int4_matmul.launches == before    # a CPU tensor: no kernel
    assert got.dtype == torch.float32 and got.shape == (m, out)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # and the dequantized product, the function both compute
    deq = x @ jx.dequant_int4(packed, scales, group)
    np.testing.assert_allclose(got.numpy(), deq, rtol=1e-4,
                               atol=1e-4 * np.abs(deq).max())


@pytest.mark.parametrize("m", [tx.M_SWITCH - 1, tx.M_SWITCH, 300])
def test_plain_version_matches_jax_kernel_at_prefill_rows(m):
    """Either side of the prefill kernel's switch (on the card the wrapper
    takes the first kernel below ``M_SWITCH`` and the wgmma kernel from
    it; here both are the plain version): the function is the JAX
    package's at a prefill-like M, groups of whole 64-row stages."""
    rng = np.random.default_rng(m)
    in_dim, out, group = 256, 48, 64
    x = rng.normal(size=(m, in_dim)).astype(np.float32)
    packed = rng.integers(-128, 128, (in_dim // 2, out)).astype(np.int8)
    scales = (rng.random((in_dim // group, out)) * 0.05 + 1e-3).astype(
        np.float32)
    want = np.asarray(jx.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                     jnp.asarray(scales), group=group))
    got = tx.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                         torch.from_numpy(scales), group=group).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_exact_integer_cases_are_exact():
    """Small integer activations and power-of-two scales: every partial sum
    is exact, so the plain version equals the dequantized product."""
    rng = np.random.default_rng(3)
    x = rng.integers(-2, 3, (7, 96)).astype(np.float32)
    packed = rng.integers(-128, 128, (48, 50)).astype(np.int8)
    scales = (2.0 ** rng.integers(-2, 2, (96 // 12, 50))).astype(np.float32)
    got = tx.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                         torch.from_numpy(scales), group=12).numpy()
    np.testing.assert_array_equal(got, x @ jx.dequant_int4(packed, scales,
                                                           12))


@pytest.mark.parametrize("xs,ws,ss,group,match", [
    ((2, 64), (31, 8), (4, 8), 16, "IN/2"),
    ((2, 64), (32, 8), (4, 8), 12, "does not divide"),
    ((2, 64), (32, 8), (4, 9), 16, "scales"),
])
def test_shapes_the_function_does_not_take_raise(xs, ws, ss, group, match):
    with pytest.raises(ValueError, match=match):
        tx.int4_matmul(torch.zeros(xs), torch.zeros(ws, dtype=torch.int8),
                       torch.zeros(ss), group=group)
