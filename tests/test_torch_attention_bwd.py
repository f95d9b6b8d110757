"""The port's flash-attention backward (generative_models_tpu_torch/ops/
attention.py: the CausalAttention autograd Function, Kernels E and D's
plain versions) against the JAX package on the CPU: jax.grad of its flash
kernel in interpret mode at T=200 (several blocks of the static plan) and
of the dense XLA path at T=1664 (the streamed plan's length). Same
numpy-seeded inputs and cotangent through both, f32. About 15 s here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops import attention as jat
from generative_models_tpu_torch.ops import attention as tat

torch.set_num_threads(1)

# the JAX package's flash-vs-dense gradient tolerance (tests/test_attention.py)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _inputs(B, H, T, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(4)]  # q, k, v, g


def _port_grads(q, k, v, g):
    qt, kt, vt = (torch.from_numpy(u).requires_grad_() for u in (q, k, v))
    o, _ = tat.causal_attention(qt, kt, vt)
    (o * torch.from_numpy(g)).sum().backward()
    return [u.grad.numpy() for u in (qt, kt, vt)]


def _jax_grads(fn, q, k, v, g):
    f = lambda q, k, v: jnp.sum(fn(q, k, v) * g)
    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def test_grads_match_jax_flash_kernel():
    q, k, v, g = _inputs(2, 2, 200, 8, seed=0)
    ref = _jax_grads(lambda q, k, v: jat.causal_attention(q, k, v, True), q, k, v, g)
    for name, got, r in zip('qkv', _port_grads(q, k, v, g), ref):
        np.testing.assert_allclose(got, np.asarray(r), err_msg=f'd{name}', **GRAD_TOL)


def test_grads_match_jax_at_streamed_length():
    q, k, v, g = _inputs(1, 2, 1664, 8, seed=1)
    assert jat._plan(1664)[0] == 'streamed'
    ref = _jax_grads(jat.xla_causal_attention, q, k, v, g)
    for name, got, r in zip('qkv', _port_grads(q, k, v, g), ref):
        np.testing.assert_allclose(got, np.asarray(r), err_msg=f'd{name}', **GRAD_TOL)


def test_plain_backward_is_autograd_of_plain_forward():
    q, k, v, g = (torch.from_numpy(u) for u in _inputs(2, 3, 37, 8, seed=2))
    qr, kr, vr = (u.clone().requires_grad_() for u in (q, k, v))
    o, lse = tat.causal_attention_plain(qr, kr, vr)
    (o * g).sum().backward()
    got = tat.causal_attention_bwd_plain(q, k, v, o.detach(), lse.detach(), g)
    for name, a, b in zip('qkv', got, (qr.grad, kr.grad, vr.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5, err_msg=f'd{name}')


def test_cpu_backward_goes_through_the_plain_backward(monkeypatch):
    """On CPU tensors the Function's backward is Kernels E and D's plain
    versions, which together are causal_attention_bwd_plain, not autograd
    of the dense forward."""
    calls = []
    for name in ('flash_bwd_dq_plain', 'flash_bwd_dkv_plain'):
        plain = getattr(tat, name)

        def counted(*a, _name=name, _plain=plain, **kw):
            calls.append(_name)
            return _plain(*a, **kw)

        monkeypatch.setattr(tat, name, counted)
    q, k, v, g = _inputs(1, 2, 20, 8, seed=3)
    got = _port_grads(q, k, v, g)
    assert calls == ['flash_bwd_dq_plain', 'flash_bwd_dkv_plain']
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    o, lse = tat.causal_attention_fwd(qt, kt, vt)
    ref = tat.causal_attention_bwd_plain(qt, kt, vt, o, lse, gt)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a.numpy(), b)
    _, delta = tat.flash_bwd_dq(qt, kt, vt, o, lse, gt)
    np.testing.assert_allclose(delta.numpy(), (g * o.numpy()).sum(-1), rtol=1e-5, atol=1e-5)


def test_function_keeps_input_dtypes_and_lse_has_no_grad():
    q, k, v, _ = _inputs(1, 1, 9, 8, seed=4)
    qt, kt, vt = (torch.from_numpy(u).double().requires_grad_() for u in (q, k, v))
    o, lse = tat.causal_attention(qt, kt, vt)
    assert o.dtype == lse.dtype == torch.float32 and not lse.requires_grad
    o.sum().backward()
    assert qt.grad.dtype == kt.grad.dtype == vt.grad.dtype == torch.float64


def test_backward_wrappers_copy_a_view_off_16_bytes():
    """Kernels D and E read rows 16 bytes at a time: their wrappers hand
    them a copy of an operand whose data starts off a 16-byte boundary (a
    view at an odd offset) and the operand itself otherwise."""
    u = torch.arange(65, dtype=torch.float32).to(torch.bfloat16)[1:].view(1, 1, 8, 8)
    assert u.is_contiguous() and u.data_ptr() % 16 == 2
    a = tat._aligned16(u)
    assert a.data_ptr() % 16 == 0 and torch.equal(a, u)
    w = torch.zeros((1, 1, 8, 8), dtype=torch.bfloat16)
    assert w.data_ptr() % 16 == 0 and tat._aligned16(w) is w


@pytest.mark.parametrize('fn', ['flash_bwd_dq', 'flash_bwd_dkv'])
def test_backward_kernel_wrappers_refuse_tensors_off_the_cpu(fn):
    u = torch.zeros((1, 1, 8, 8), device='meta')
    row = torch.zeros((1, 1, 8), device='meta')
    args = (u, u, u, u, row, u) if fn == 'flash_bwd_dq' else (u, u, u, u, row, row)
    with pytest.raises(ValueError, match='CUDA tensor'):
        getattr(tat, fn)(*args)


def _pair_or_once_bwd(q, k, v, o, lse, do, pair):
    """The plain backward (through _bwd_scores) with P and dS rounded to
    bf16 before the dQ/dK/dV products: once (pair=False, the TPU kernel's
    rounding) or carried as hi = bf16(x), lo = bf16(x - hi) with both
    products summed in f32 (pair=True, Kernels D and E)."""
    bf = torch.bfloat16
    scale = 1.0 / np.sqrt(q.shape[-1])
    delta = (do.to(bf).float() * o).sum(-1)
    p, ds, qf, kf, dof = tat._bwd_scores(q, k, v, lse, do, delta, bf)

    def times(x, y):
        hi = x.to(bf).float()
        return hi @ y + (x - hi).to(bf).float() @ y if pair else hi @ y

    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    return times(ds, kf) * scale, times(dst, qf) * scale, times(pt, dof)


@pytest.mark.parametrize('pair', [True, False])
def test_p_and_ds_as_bf16_pairs_hold_the_plain_backward(pair):
    """Why Kernels D and E split P and dS: at pixel_transformer's T=784 and
    D=32, with bf16-valued inputs, the hi/lo pair keeps every gradient
    within the chip check's atol 1e-4 + rtol 1e-3 of the plain backward
    (P and dS in f32), and rounding P and dS to bf16 once does not."""
    bf = torch.bfloat16
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 4, 784, 32).astype(np.float32)).to(bf).float()
                   for _ in range(4))
    o, lse = tat.causal_attention_plain(q, k, v, dtype=bf)
    ref = tat.causal_attention_bwd_plain(q, k, v, o, lse, do, dtype=bf)
    got = _pair_or_once_bwd(q, k, v, o, lse, do, pair)
    outside = [int(((g - r).abs() > GRAD_TOL['atol'] + GRAD_TOL['rtol'] * r.abs()).sum())
               for g, r in zip(got, ref)]
    if pair:
        assert outside == [0, 0, 0]
    else:
        assert min(outside) > 1000, outside
