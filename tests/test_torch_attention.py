"""The port's causal attention (generative_models_tpu_torch/ops/attention.py)
against the JAX package on the CPU: the flash forward in interpret mode, the
dense XLA path at the long-T plan's length, the saved row logsumexp, and the
KV-cached decode step. Same numpy-seeded inputs through both, f32."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops import attention as jat
from generative_models_tpu_torch.ops import attention as tat

torch.set_num_threads(1)


def _qkv(B=2, H=2, T=20, D=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(3)]


def _port(q, k, v):
    o, lse = tat.causal_attention(*map(torch.from_numpy, (q, k, v)))
    assert o.dtype == lse.dtype == torch.float32
    return o.numpy(), lse.numpy()


def test_causal_forward_matches_jax_flash_kernel():
    q, k, v = _qkv(T=200)  # several blocks of the JAX kernel's static plan
    ref = jat.causal_attention(*map(jnp.asarray, (q, k, v)), True)  # interpret
    o, _ = _port(q, k, v)
    np.testing.assert_allclose(o, np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_causal_forward_matches_jax_at_streamed_length():
    # T=1664 = 13 blocks of 128: past _MAX_STATIC_BLOCKS, the JAX package's
    # streamed plan; the port has one kernel for every T
    q, k, v = _qkv(B=1, H=2, T=1664, D=8, seed=1)
    assert jat._plan(1664)[0] == 'streamed'
    ref = jat.xla_causal_attention(*map(jnp.asarray, (q, k, v)))
    o, _ = _port(q, k, v)
    np.testing.assert_allclose(o, np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_lse_is_the_dense_row_logsumexp():
    q, k, v = _qkv(T=37, seed=2)
    _, lse = _port(q, k, v)
    s = np.einsum('bhqd,bhkd->bhqk', q, k).astype(np.float64) / np.sqrt(q.shape[-1])
    s = np.where(np.tril(np.ones((37, 37), bool)), s, -np.inf)
    ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('t', [0, 5, 11])
def test_decode_step_attention_matches_jax(t):
    q, k, v = _qkv(T=12, seed=3)
    B, H, T, D = q.shape
    to_rows = lambda u: u.transpose(2, 0, 1, 3).reshape(T, B, H * D)
    cache = np.stack([to_rows(k), to_rows(v)], 2)  # (T, B, 2, HD)
    q1 = q[:, :, t].reshape(B, H * D)
    ref = jat.decode_step_attention(jnp.asarray(q1), jnp.asarray(cache), t, H)
    got = tat.decode_step_attention(torch.from_numpy(q1), torch.from_numpy(cache), t, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # and it is row t of the full causal attention
    full, _ = _port(q, k, v)
    np.testing.assert_allclose(
        got.numpy(), full[:, :, t].reshape(B, H * D), rtol=1e-5, atol=1e-6
    )


def test_decode_cache_dtype_is_f32_on_the_cpu():
    assert tat.decode_cache_dtype(torch.device('cpu')) == torch.float32


def test_kernel_wrapper_refuses_tensors_off_the_cpu():
    q = torch.zeros((1, 1, 8, 8), device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        tat.causal_attention_fwd(q, q, q)


def _kernel_c_arithmetic(q, k, v, pair):
    """Kernel C's arithmetic in torch: 64-key tiles, the online softmax in
    log2 units (the row max over a tile, one rescale of acc and l a tile,
    P = exp2(S * scale * log2(e) - m), l += P in f32), and P into P v as a
    bf16 pair hi = bf16(P), lo = bf16(P - hi), both products summed in f32
    (pair=True), or rounded to bf16 once (pair=False, the TPU kernel's
    rounding). q, k, v hold bf16 values in f32 -> (o, lse in natural
    units)."""
    bf = torch.bfloat16
    T, D = q.shape[-2:]
    sl2 = math.log2(math.e) / math.sqrt(D)
    rows = torch.arange(T)[:, None]
    m = torch.full(q.shape[:-1] + (1,), tat.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, T, 64):
        kt, vt = k[..., k0:k0 + 64, :], v[..., k0:k0 + 64, :]
        s = q @ kt.transpose(-1, -2)
        s = s.masked_fill(torch.arange(k0, k0 + kt.shape[-2])[None, :] > rows, tat.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * sl2 - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(bf).float()
        pv = hi @ vt + (p - hi).to(bf).float() @ vt if pair else hi @ vt
        acc, m = acc * alpha + pv, m_new
    return acc / l, (m * math.log(2) + torch.log(l))[..., 0]


@pytest.mark.parametrize('pair', [True, False])
def test_p_as_a_bf16_pair_holds_the_plain_forward(pair):
    """Why Kernel C splits P: at pixel_transformer's T=784 and D=32, with
    bf16-valued inputs, the hi/lo pair keeps o and lse within the chip
    check's atol 2e-5 + rtol 2e-4 of the plain forward (P in f32), and
    rounding P to bf16 once does not."""
    bf = torch.bfloat16
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(2, 4, 784, 32).astype(np.float32)).to(bf).float()
               for _ in range(3))
    o_ref, lse_ref = tat.causal_attention_plain(q, k, v, dtype=bf)
    o, lse = _kernel_c_arithmetic(q, k, v, pair)
    outside = lambda g, r: int(((g - r).abs() > 2e-5 + 2e-4 * r.abs()).sum())
    assert outside(lse, lse_ref) == 0
    if pair:
        assert outside(o, o_ref) == 0
    else:
        assert outside(o, o_ref) > 1000
