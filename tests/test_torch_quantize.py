"""The port's VQ codebook search and VQ layer (generative_models_tpu_torch/
ops/quantize.py) against the JAX package's on the CPU: the plain version of
Kernel F bit-equal to the Pallas kernel in interpret mode and to its XLA
path, ties to the lowest index, a NaN score taken first as jnp.argmin
takes it, and vq_quantize's outputs and gradients within 1e-6 of the JAX
function's, from the same numpy-seeded inputs; and an emulation of the
kernel's 3xTF32 product that holds the plain version's assignments but for
ties, where one tf32 product does not."""

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


def _nan_case(case):
    """(z, e, the index every row must get or None) of a NaN case: a NaN
    element in code 5 (every row takes code 5, the first NaN score), NaNs
    in codes 9 and 4 (every row takes 4), a row of z all NaN and an element
    of another row NaN (both rows take index 0, the others their nearest),
    and codes duplicated with a NaN code among the copies."""
    rng = np.random.RandomState(7)
    z, e = _f32(rng, 120, 16), _f32(rng, 24, 16)
    if case == 'nan_code':
        e[5, 3] = np.nan
        return z, e, 5
    if case == 'two_nan_codes':
        e[9, 0] = e[4, 15] = np.nan
        return z, e, 4
    if case == 'nan_rows':
        z[7] = np.nan
        z[30, 2] = np.nan
        return z, e, None
    e = np.concatenate([e[:8], e[:8], e[:8]])  # codes k, k + 8, k + 16 are equal
    e[11, 1] = e[19, 1] = np.nan  # the copies of code 3 are NaN: 11 first
    return z, e, 11


@pytest.mark.parametrize('case', ['nan_code', 'two_nan_codes', 'nan_rows', 'duplicates'])
def test_plain_search_takes_the_first_nan_as_jax(case):
    """torch.argmin and jnp.argmin both take the first NaN over any number
    (argmin([1, nan, 0]) is 1): a NaN code is taken by every row, the
    lowest NaN code among several, and a row with a NaN gets index 0. The
    plain version equals the Pallas kernel in interpret mode and the XLA
    path exactly; Kernel F holds the same rule on the card (chip_smoke.py
    vq_cases)."""
    z, e, every = _nan_case(case)
    pallas = np.asarray(jq.vq_one_hot(jnp.asarray(z), jnp.asarray(e), use_pallas=True,
                                      interpret=True))
    xla = np.asarray(jq.vq_one_hot(jnp.asarray(z), jnp.asarray(e), use_pallas=False))
    oh, idx = tq.vq_one_hot(torch.from_numpy(z), torch.from_numpy(e))
    np.testing.assert_array_equal(oh.numpy(), pallas)
    np.testing.assert_array_equal(oh.numpy(), xla)
    np.testing.assert_array_equal(idx.numpy(), pallas.argmax(-1))
    if every is not None:
        assert (idx == every).all()
    else:
        assert idx[7] == 0 and idx[30] == 0 and (idx[:7] > 0).any()
    # the tie rule counts a NaN row apart from the plain version as missed
    moved = idx.clone()
    moved[7] = 1 if case == 'nan_rows' else moved[7]
    assert tq.vq_ties_missed(moved, idx, torch.from_numpy(z),
                             torch.from_numpy(e)) == (case == 'nan_rows')
    # and an index outside the codebook as missed, not as an error
    moved[0] = e.shape[0]
    assert tq.vq_ties_missed(moved, idx, torch.from_numpy(z),
                             torch.from_numpy(e)) == 1 + (case == 'nan_rows')


def _tf32(x):
    """x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero:
    cvt.rna.tf32.f32 on finite inputs, by bit operations."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _emulate_kernel_f(z, e, parts):
    """Kernel F's indices with its product emulated: parts=3, each operand
    split as hi = tf32(x), lo = tf32(x - hi), lo.hi, hi.lo and hi.hi each
    summed over the k8 steps into an f32 accumulator of its own, and the
    dot the small products' sum added to hi.hi's; parts=1, hi.hi alone (one
    tf32 product). Each k8 step's eight products are summed as a block, as
    one mma.sync m16n8k8 sums them."""
    zh, eh = _tf32(z), _tf32(e)
    zl, el = _tf32(z - zh), _tf32(e - eh)
    acc_hh = torch.zeros((z.shape[0], e.shape[0]))
    acc_lh, acc_hl = torch.zeros_like(acc_hh), torch.zeros_like(acc_hh)
    for k in range(0, z.shape[1], 8):
        s = slice(k, k + 8)
        if parts == 3:
            acc_lh = acc_lh + zl[:, s] @ eh[:, s].t()
            acc_hl = acc_hl + zh[:, s] @ el[:, s].t()
        acc_hh = acc_hh + zh[:, s] @ eh[:, s].t()
    dot = acc_hh + (acc_lh + acc_hl)
    return torch.argmin(-2.0 * dot + (e * e).sum(-1)[None, :], dim=1)


VQ_PATH_SHAPES = [(3136, 64, 64), (392, 64, 64), (12544, 1024, 64)]


def _emulated_misses(N, K, D, seed, parts):
    """Rows at which the emulated kernel (parts tf32 products) misses the
    plain version beyond a tie (vq_ties_missed), randn inputs from seed."""
    rng = np.random.RandomState(seed)
    z, e = (torch.from_numpy(_f32(rng, n, D)) for n in (N, K))
    return tq.vq_ties_missed(_emulate_kernel_f(z, e, parts), tq.vq_one_hot(z, e)[1], z, e)


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('N,K,D', VQ_PATH_SHAPES)
def test_kernel_f_as_three_tf32_products_holds_the_plain_search(N, K, D, seed):
    """Kernel F's 3xTF32 product, emulated, at vqvae's training and evaluate
    batches and at a 1024-code book (randn inputs, two seeds): its indices
    differ from the plain version's only at ties under vq_ties_missed's rule
    (within 1e-5 of the row's largest |score|)."""
    assert _emulated_misses(N, K, D, seed, 3) == 0


@pytest.mark.parametrize('seed', [0, 1])
def test_one_tf32_product_misses_the_plain_search(seed):
    """Why Kernel F multiplies in three tf32 products: one (hi.hi alone), on
    the inputs of the test above, misses the tie rule at some of the three
    shapes at each seed, so the rule catches the lower precision. Here: 2, 0
    and 6 rows at seed 0, 0, 1 and 6 at seed 1, in the order of
    VQ_PATH_SHAPES; the 1024-code book misses at both."""
    misses = [_emulated_misses(N, K, D, seed, 1) for N, K, D in VQ_PATH_SHAPES]
    assert sum(misses) > 0 and misses[-1] > 0, misses


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
