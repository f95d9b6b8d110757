"""The port's VQ codebook search and VQ layer (generative_models_tpu_torch/
ops/quantize.py) against the JAX package's on the CPU: the plain version of
Kernel F bit-equal to the Pallas kernel in interpret mode and to its XLA
path, ties to the lowest index, and vq_quantize's outputs and gradients
within 1e-6 of the JAX function's, from the same numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops import quantize as jq
from generative_models_tpu_torch.ops import quantize as tq

torch.set_num_threads(1)


def _f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize('N,K,D', [(3136, 64, 64), (160, 2048, 32), (50, 24, 16)])
def test_plain_search_is_bit_equal_to_jax(N, K, D):
    rng = np.random.RandomState(N + K)
    z, e = _f32(rng, N, D), _f32(rng, K, D)
    pallas = np.asarray(jq.vq_one_hot(jnp.asarray(z), jnp.asarray(e), use_pallas=True,
                                      interpret=True))
    xla = np.asarray(jq.vq_one_hot(jnp.asarray(z), jnp.asarray(e), use_pallas=False))
    before = tq.vq_one_hot.launches
    oh, idx = tq.vq_one_hot(torch.from_numpy(z), torch.from_numpy(e))
    assert tq.vq_one_hot.launches == before  # CPU tensors launch nothing
    assert oh.dtype == torch.float32 and oh.shape == (N, K)
    np.testing.assert_array_equal(oh.numpy(), pallas)
    np.testing.assert_array_equal(oh.numpy(), xla)
    np.testing.assert_array_equal(idx.numpy(), pallas.argmax(-1))


def test_duplicated_codes_resolve_to_the_lowest_index():
    rng = np.random.RandomState(0)
    e = _f32(rng, 8, 16)
    e = np.concatenate([e, e, e])  # codes k, k + 8, k + 16 are equal
    z = _f32(rng, 200, 16)
    oh, idx = tq.vq_one_hot(torch.from_numpy(z), torch.from_numpy(e))
    assert int(idx.max()) < 8
    ref = np.asarray(jq.vq_one_hot(jnp.asarray(z), jnp.asarray(e), use_pallas=True,
                                   interpret=True))
    np.testing.assert_array_equal(oh.numpy(), ref)


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    return _f32(rng, 2, 7, 7, 8), _f32(rng, 16, 8), _f32(rng, 2, 7, 7, 8)


def test_vq_quantize_matches_jax():
    z, cb, _ = _inputs()
    ref = jq.vq_quantize(jnp.asarray(z), jnp.asarray(cb), 0.25, use_pallas=True)
    got = tq.vq_quantize(torch.from_numpy(z), torch.from_numpy(cb), 0.25)
    for name, g, r in zip(('loss', 'z_q', 'perplexity', 'idxs', 'one_hot'), got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6, err_msg=name)
    assert got[3].shape == (2, 7, 7)


def test_vq_quantize_gradients_match_jax():
    """d/dz and d/dcodebook of the embedding loss plus a weighted sum of the
    straight-through z_q."""
    z, cb, w = _inputs(2)

    def jf(z, cb):
        loss, z_q, _, _, _ = jq.vq_quantize(z, cb, 0.25, use_pallas=True)
        return loss + jnp.sum(z_q * w)

    gz, gcb = jax.grad(jf, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(cb))
    tz, tcb = (torch.from_numpy(a).requires_grad_() for a in (z, cb))
    loss, z_q, _, _, _ = tq.vq_quantize(tz, tcb, 0.25)
    (loss + (z_q * torch.from_numpy(w)).sum()).backward()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(gz), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tcb.grad.numpy(), np.asarray(gcb), rtol=1e-6, atol=1e-6)
    assert np.abs(tcb.grad.numpy()).sum() > 0


def test_wrapper_refuses_tensors_off_the_cpu_without_a_kernel():
    z, e = torch.zeros((4, 8), device='meta'), torch.zeros((16, 8), device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        tq.vq_one_hot(z, e)
