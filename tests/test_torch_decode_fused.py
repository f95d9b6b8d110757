"""The port's decode-step kernels (generative_models_tpu_torch/ops/
decode_fused.py) against the JAX package's Pallas kernels in interpret mode,
on the CPU: the same numpy-seeded inputs through both, f32 throughout, at the
tolerance tests/test_decode_fused.py uses (rtol 1e-4, atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops import decode_fused as jdf
from generative_models_tpu_torch.ops import decode_fused as tdf

torch.set_num_threads(1)

B, C = 3, 32


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _tail_params(rng):
    return dict(
        wproj=_f32(rng, C, C, scale=C ** -0.5), bproj=_f32(rng, C, scale=0.1),
        ln2_scale=1 + _f32(rng, C, scale=0.1), ln2_bias=_f32(rng, C, scale=0.1),
        wfc1=_f32(rng, C, 4 * C, scale=C ** -0.5), bfc1=_f32(rng, 4 * C, scale=0.1),
        wfc2=_f32(rng, 4 * C, C, scale=(4 * C) ** -0.5), bfc2=_f32(rng, C, scale=0.1),
    )


@pytest.mark.parametrize('N', [96, 1])
def test_ln_matmul_matches_jax(N):
    rng = np.random.RandomState(N)
    args = (
        _f32(rng, B, C), 1 + _f32(rng, C, scale=0.1), _f32(rng, C, scale=0.1),
        _f32(rng, C, N, scale=C ** -0.5), _f32(rng, N, scale=0.1),
    )
    ref = np.asarray(jdf.ln_matmul(*map(jnp.asarray, args), interpret=True))
    before = tdf.ln_matmul.launches
    got = tdf.ln_matmul(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == (B, N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    assert tdf.ln_matmul.launches == before  # CPU tensors launch nothing


def test_block_tail_matches_jax():
    rng = np.random.RandomState(0)
    x, y = _f32(rng, B, C), _f32(rng, B, C)
    lp = _tail_params(rng)
    ref = jdf.block_tail(
        jnp.asarray(x), jnp.asarray(y),
        {k: jnp.asarray(v) for k, v in lp.items()}, interpret=True,
    )
    got = tdf.block_tail(
        torch.from_numpy(x), torch.from_numpy(y),
        {k: torch.from_numpy(v) for k, v in lp.items()},
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_plain_versions_round_operands_to_dtype():
    """With dtype=bf16 the plain versions multiply bf16-rounded operands in
    f32: the same result as feeding pre-rounded f32 inputs at dtype=f32."""
    rng = np.random.RandomState(1)
    x, y = torch.from_numpy(_f32(rng, B, C)), torch.from_numpy(_f32(rng, B, C))
    lp = {k: torch.from_numpy(v) for k, v in _tail_params(rng).items()}
    rnd = lambda t: t.to(torch.bfloat16).float()
    w = {k: rnd(v) if k.startswith('w') else v for k, v in lp.items()}
    # block_tail rounds y; its inner activations are rounded in both runs
    np.testing.assert_array_equal(
        tdf.block_tail_plain(x, y, lp, dtype=torch.bfloat16).numpy(),
        tdf.block_tail_plain(x, rnd(y), w, dtype=torch.bfloat16).numpy(),
    )
    s, b = torch.ones(C), torch.zeros(C)
    wq, bq = lp['wfc1'], lp['bfc1']
    h = tdf._ln(x, s, b)
    np.testing.assert_array_equal(
        tdf.ln_matmul_plain(x, s, b, wq, bq, dtype=torch.bfloat16).numpy(),
        (rnd(h) @ rnd(wq) + bq).numpy(),
    )


def test_wrappers_refuse_tensors_off_the_cpu_without_a_kernel():
    """Only CPU tensors take the plain path: any other device goes to the
    kernel's checks, which refuse what is not a CUDA tensor."""
    x = torch.zeros((B, C), device='meta')
    v = torch.zeros((C,), device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        tdf.ln_matmul(x, v, v, torch.zeros((C, 4), device='meta'), torch.zeros(4, device='meta'))
    lp = {k: torch.zeros(v.shape, device='meta') for k, v in _tail_params(np.random.RandomState(0)).items()}
    with pytest.raises(ValueError, match='CUDA tensor'):
        tdf.block_tail(x, x, lp)
