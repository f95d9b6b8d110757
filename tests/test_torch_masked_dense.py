"""The port's masked dense layer (generative_models_tpu_torch/ops/
masked_dense.py) against the JAX package's on the CPU: the plain versions of
Kernels G and H and the MaskedDense autograd Function against the Pallas
masked_dense in interpret mode, forward (1e-5) and gradients (1e-4), from
the same numpy-seeded inputs; the weight gradient exactly 0 off the mask;
the transposed layouts (B read as (N, K), A read as (K, M)); and the skipped dX of
a layer whose input needs no gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops.masked_dense import masked_dense as jax_masked_dense
from generative_models_tpu.ops.masked_dense import prefer_pallas
from generative_models_tpu_torch.ops import masked_dense as tmd

torch.set_num_threads(1)

# (B, K, N): tests/test_masked_dense.py's shapes; K=1300 spans three of the
# reference's 512-deep K tiles; then the ragged edges of Kernel G's tiling
# (64-row strips, 32-deep K tiles, 128-column strips): M past 64 and not a
# multiple of 16, K under one tile pair, N not a multiple of 64 (nor 16)
SHAPES = [(8, 20, 12), (16, 1300, 256), (72, 40, 130), (200, 784, 130)]


def _data(B, K, N, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, K).astype(np.float32)
    w = (rng.randn(K, N) * K ** -0.5).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    m = (rng.rand(K, N) > 0.5).astype(np.float32)
    return x, w, b, m


def _torch(x, w, b, m):
    return (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            torch.from_numpy(m).to(torch.uint8))


@pytest.mark.parametrize('B,K,N', SHAPES)
def test_forward_matches_the_pallas_layer(B, K, N):
    x, w, b, m = _data(B, K, N)
    ref = np.asarray(jax_masked_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      jnp.asarray(m), True))
    tx, tw, tb, tm = _torch(x, w, b, m)
    before = tmd.masked_matmul.launches
    plain = tmd.masked_matmul_plain(tx, tw, tm) + tb
    with torch.no_grad():
        layer = tmd.masked_dense(tx, tw, tb, tm, use_kernel=True)
        fold = tmd.masked_dense(tx, tw, tb, tm, use_kernel=False)
    assert tmd.masked_matmul.launches == before  # CPU tensors launch nothing
    for got in (plain, layer, fold):
        assert got.dtype == torch.float32 and got.shape == (B, N)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('B,K,N', SHAPES)
def test_gradients_match_jax_grad(B, K, N):
    """dx, dw, db of sum(layer(x) * r) through the port's MaskedDense
    against jax.grad through the reference's custom VJP (Pallas kernels in
    interpret mode)."""
    x, w, b, m = _data(B, K, N, seed=1)
    r = np.random.RandomState(2).randn(B, N).astype(np.float32)
    grads = jax.grad(
        lambda x, w, b: jnp.sum(jax_masked_dense(x, w, b, jnp.asarray(m), True) * r),
        argnums=(0, 1, 2),
    )(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb, tm = _torch(x, w, b, m)
    for t in (tx, tw, tb):
        t.requires_grad_()
    (tmd.masked_dense(tx, tw, tb, tm, use_kernel=True) * torch.from_numpy(r)).sum().backward()
    for name, got, ref in zip(('dx', 'dw', 'db'), (tx.grad, tw.grad, tb.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    # the weight gradient is exactly 0 where the mask is 0
    assert not tw.grad.numpy()[m == 0].any()
    assert tw.grad.numpy()[m == 1].any()


@pytest.mark.parametrize('B,K,N', SHAPES)
def test_layout_flags_match_the_untransposed_product(B, K, N):
    """G with trans_b reads B and its mask as (N, K); H reads A as stored
    (K, M): the same products as the plain versions on the untransposed
    operands."""
    x, w, _, m = _data(B, K, N, seed=3)
    tx, tw, _, tm = _torch(x, w, np.zeros(1, np.float32), m)
    # f32 sums in another order (a strided operand): torch's f32 tolerance
    got = tmd.masked_matmul(tx, tw.t().contiguous(), tm.t().contiguous(), trans_b=True)
    torch.testing.assert_close(got, tmd.masked_matmul_plain(tx, tw, tm))
    g = torch.from_numpy(np.random.RandomState(4).randn(B, N).astype(np.float32))
    # dW = m * (x^T g): H on x as stored, (B, K), read as (K, B)
    out_mask = tm  # (K, N), the output's shape
    got = tmd.mask_out_matmul(tx, g, out_mask)
    ref = tmd.mask_out_matmul_plain(tx.t().contiguous(), g, out_mask)
    torch.testing.assert_close(got, ref)
    np.testing.assert_allclose(ref.numpy(), m * (x.T @ g.numpy()), rtol=1e-5, atol=1e-5)


def test_input_that_needs_no_grad_skips_dx_and_keeps_dw_and_db(monkeypatch):
    x, w, b, m = _data(8, 40, 24, seed=5)
    r = torch.from_numpy(np.random.RandomState(6).randn(8, 24).astype(np.float32))
    orig = tmd.masked_matmul
    calls = []
    monkeypatch.setattr(tmd, 'masked_matmul', lambda *a, **k: calls.append(k) or orig(*a, **k))
    out = {}
    for needs_dx in (True, False):
        tx, tw, tb, tm = _torch(x, w, b, m)
        tx.requires_grad_(needs_dx)
        tw.requires_grad_()
        tb.requires_grad_()
        calls.clear()
        (tmd.masked_dense(tx, tw, tb, tm, use_kernel=True) * r).sum().backward()
        # the forward, then dX (trans_b) only when x needs it
        assert calls == ([{}, {'trans_b': True}] if needs_dx else [{}])
        assert (tx.grad is not None) == needs_dx
        out[needs_dx] = (tw.grad, tb.grad)
    for a, b_ in zip(out[True], out[False]):
        assert torch.equal(a, b_)


@pytest.mark.parametrize('K,N,big', [(784, 1024, False), (1024, 1024, False),
                                     (1448, 1448, False), (1449, 1449, True),
                                     (2048, 2048, True), (2048, 784, False)])
def test_gate_keeps_the_reference_threshold(K, N, big):
    assert tmd.prefer_kernel(K, N) == prefer_pallas(K, N) == big


def test_wrappers_refuse_tensors_off_the_cpu_without_a_kernel():
    x, w = torch.zeros((4, 8), device='meta'), torch.zeros((8, 16), device='meta')
    m = torch.zeros((8, 16), dtype=torch.uint8, device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        tmd.masked_matmul(x, w, m)
    with pytest.raises(ValueError, match='CUDA tensor'):
        tmd.mask_out_matmul(x.t(), w, m)
