"""The port's int8 products (generative_models_tpu_torch/ops/int8.py, the
plain versions of Kernels I and J on the CPU) against the JAX package's
ops/int8.py: the weight quantization bitwise (all-zero columns included);
under w8a8 the activation quantization, the int32 sums and y against both
JAX routes (the Pallas kernel in interpret mode and lax.dot); w8a16 against
both; and the float64 plain int8 product exact where f32 would not be."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops import int8 as jint8
from generative_models_tpu_torch.ops.int8 import (
    dequant_gemm, int8_gemm, int8_gemm_plain, int8_matmul, quantize_int8, quantize_rows,
)

torch.set_num_threads(1)

# the ragged shapes of tests/test_int8.py, and made's widest serving product
SHAPES = [(10, 72, 136), (6, 130, 70), (64, 1024, 784)]


def _xw(M, K, N, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, K).astype(np.float32),
            (rng.randn(K, N) * 3.0).astype(np.float32))


def test_quantize_int8_bitwise_with_zero_columns():
    _, w = _xw(1, 96, 160, 0)
    w[:, 7] = 0.0
    w[:, 100] = 0.0
    q, scale = quantize_int8(torch.from_numpy(w))
    jq, jscale = jint8.quantize_int8(jnp.asarray(w))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32 and scale.shape == (160,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert not q[:, 7].any() and float(scale[7]) == np.float32(1e-12)


@pytest.mark.parametrize('M,K,N', SHAPES)
def test_w8a8_matches_both_jax_routes(M, K, N):
    """xq and the int32 sums bitwise; y at 1e-6 (the same integer sums and
    the same two multiplies, so in fact equal)."""
    x, w = _xw(M, K, N, M + K)
    jq, jscale = jint8.quantize_int8(jnp.asarray(w))
    q, scale = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(jscale))
    xq, sx = quantize_rows(torch.from_numpy(x))
    # the reference's own activation quantization (int8.py:138-139)
    jx = jnp.asarray(x)
    jsx = jnp.maximum(jnp.max(jnp.abs(jx), axis=1, keepdims=True), 1e-12) / 127.0
    jxq = jnp.clip(jnp.round(jx / jsx), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    acc = int8_gemm(xq, q)
    assert acc.dtype == torch.int32
    pallas_acc = jint8._pallas_gemm(jxq, jq, interpret=True)
    dot_acc = jax.lax.dot(jxq, jq, preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(pallas_acc))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(dot_acc))
    y = int8_matmul(torch.from_numpy(x), q, scale, act_quant=True).numpy()
    for use_pallas in (True, False):
        ref = jint8.int8_matmul(jx, jq, jscale, act_quant=True, use_pallas=use_pallas,
                                interpret=True if use_pallas else None)
        np.testing.assert_allclose(y, np.asarray(ref), rtol=1e-6, atol=1e-6)


def _assert_sums_close(got, ref, bound):
    """|got - ref| <= 1e-5 * bound elementwise, bound the sum of the
    products' magnitudes: f32 sums in another order differ by a few ulps
    of that sum, which cancellation can leave far above an ulp of the
    result."""
    err = np.abs(np.asarray(got) - np.asarray(ref))
    assert (err <= 1e-5 * bound).all(), float((err / bound).max())


@pytest.mark.parametrize('M,K,N', SHAPES)
def test_w8a16_matches_both_jax_routes(M, K, N):
    """f32 x on the CPU on both sides (the JAX kernel keeps x f32 off the
    TPU), the same products, sums in another order: within 1e-5 of the sum
    of |products|."""
    x, w = _xw(M, K, N, 2 * M + K)
    jq, jscale = jint8.quantize_int8(jnp.asarray(w))
    q, scale = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(jscale))
    y = int8_matmul(torch.from_numpy(x).reshape(M, 1, K), q, scale, act_quant=False)
    assert y.shape == (M, 1, N)
    mag = np.abs(x).astype(np.float64) @ np.abs(np.asarray(jq, np.float64))
    acc = dequant_gemm(torch.from_numpy(x), q).numpy()
    _assert_sums_close(
        acc, jint8._pallas_gemm(jnp.asarray(x), jq, dequant_w=True, interpret=True), mag)
    for use_pallas in (True, False):
        ref = jint8.int8_matmul(jnp.asarray(x), jq, jscale, act_quant=False,
                                use_pallas=use_pallas, interpret=True if use_pallas else None)
        _assert_sums_close(y.numpy()[:, 0], ref, mag * np.asarray(jscale))


def test_plain_int8_product_is_exact_past_f32():
    """K=2048 with every |x| = |q| = 127: sums up to 2048 * 127^2 = 33.0 M,
    past f32's 2^24, exact in float64 and equal to numpy's int64 product."""
    rng = np.random.RandomState(3)
    x = (rng.choice([-127, 127], (8, 2048))).astype(np.int8)
    q = (rng.choice([-127, 127], (2048, 40))).astype(np.int8)
    x[0] = 127
    q[:, 0] = 127
    got = int8_gemm_plain(torch.from_numpy(x), torch.from_numpy(q))
    ref = x.astype(np.int64) @ q.astype(np.int64)
    assert got.dtype == torch.int32 and int(ref[0, 0]) == 2048 * 127 * 127 > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cpu_tensors_take_the_plain_versions():
    x, w = _xw(4, 64, 48, 9)
    q, scale = quantize_int8(torch.from_numpy(w))
    before = (int8_gemm.launches, dequant_gemm.launches)
    int8_matmul(torch.from_numpy(x), q, scale, act_quant=True)
    int8_matmul(torch.from_numpy(x), q, scale, act_quant=False)
    assert (int8_gemm.launches, dequant_gemm.launches) == before
