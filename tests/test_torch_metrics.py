"""The port's eval metrics (generative_models_tpu_torch/utils/metrics.py)
against the JAX package's (generative_models_tpu/utils/metrics.py) on the
CPU, in f32, on features made from a seed with numpy.

Tolerances: the FIDs and the matrix roots rtol 1e-3 (eigh in f32, two
LAPACK builds), a set's FID against itself 1e-3 of its covariances'
traces; cdist, the covariance and the cross-entropy rtol 1e-5;
precision, recall and f1 exactly (counts of strict comparisons on random
normal features, far from ties). A near-symmetric matrix shows why the port
symmetrises before eigh (without it the root is 1e-3 away), and sets that
do not overlap give precision = recall = f1 = 0 in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.utils import metrics as J
from generative_models_tpu_torch.utils import metrics as M

torch.set_num_threads(1)


def _feats(n, d, seed, shift=0.0, scale=1.0):
    rng = np.random.RandomState(seed)
    return (shift + scale * rng.randn(n, d)).astype(np.float32)


def _both(fn_t, fn_j, *arrays):
    got = fn_t(*[torch.from_numpy(a) for a in arrays])
    ref = fn_j(*[jnp.asarray(a) for a in arrays])
    return got, ref


@pytest.mark.parametrize('n,d', [(64, 16), (128, 64), (32, 64)])
def test_fid_both_forms_match_jax(n, d):
    """(32, 64): fewer samples than features, a rank-deficient covariance
    whose negative rounding eigenvalues both clip to 0."""
    x, y = _feats(n, d, 0), _feats(n, d, 1, shift=0.3, scale=1.2)
    for mean_of_sq in (True, False):
        got, ref = _both(lambda a, b: M.frechet_distance(a, b, mean_of_sq),
                         lambda a, b: J.frechet_distance(a, b, mean_of_sq), x, y)
        assert float(got) == pytest.approx(float(ref), rel=1e-3), mean_of_sq
    got, ref = _both(M.compute_fid, J.compute_fid, x, y)
    assert float(got) == pytest.approx(float(ref), rel=1e-3)
    # a set against itself: 0 up to the roots' f32 rounding, 1e-3 of the traces
    got, ref = _both(M.compute_fid, J.compute_fid, x, x)
    scale = 2 * float(np.trace(np.cov(x.T)))
    assert abs(float(got)) < 1e-3 * scale and abs(float(got) - float(ref)) < 1e-3 * scale


def test_cov_cdist_and_cross_entropy_match_jax():
    x, y = _feats(48, 10, 2), _feats(40, 10, 3)
    got, ref = _both(M._cov, J._cov, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    got, ref = _both(M.cdist, J.cdist, x, y)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    logits = _feats(16, 10, 4, scale=3.0)
    labels = np.random.RandomState(5).randint(0, 10, 16).astype(np.int32)
    got = M.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = J.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert float(got) == pytest.approx(float(ref), rel=1e-5)


def test_psd_sqrtm_symmetrises_a_near_symmetric_input_as_jax_does():
    """jnp.linalg.eigh reads (a + a^T) / 2; torch.linalg.eigh reads the
    lower triangle. On a PSD matrix plus an antisymmetric 1e-3 part the
    port's root matches JAX's and the unsymmetrised one does not."""
    rng = np.random.RandomState(6)
    b = rng.randn(12, 12)
    s = (b @ b.T / 12 + np.eye(12)).astype(np.float32)
    e = rng.randn(12, 12)
    a = (s + 1e-3 * (e - e.T)).astype(np.float32)
    got, ref = _both(M._psd_sqrtm, J._psd_sqrtm, a)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-5)
    w, v = torch.linalg.eigh(torch.from_numpy(a))
    lower = (v * torch.sqrt(torch.clamp(w, min=0.0))) @ v.T
    assert float(torch.max(torch.abs(lower - got))) > 1e-4


@pytest.mark.parametrize('seed,n,d,k', [(7, 64, 16, 3), (8, 100, 8, 3), (9, 64, 32, 5)])
def test_precision_recall_f1_match_jax_exactly(seed, n, d, k):
    real = _feats(n, d, seed)
    gen = _feats(n + 7, d, seed + 100, shift=0.2, scale=1.1)
    got = M.precision_recall_f1(torch.from_numpy(real), torch.from_numpy(gen), k=k)
    ref = J.precision_recall_f1(jnp.asarray(real), jnp.asarray(gen), k=k)
    for key in ('precision', 'recall', 'f1'):
        assert float(got[key]) == float(ref[key]), key
    assert 0 < float(got['precision']) < 1 and 0 < float(got['recall']) < 1


def test_f1_is_zero_where_precision_and_recall_are():
    real = _feats(32, 8, 10)
    gen = real + 100.0
    got = M.precision_recall_f1(torch.from_numpy(real), torch.from_numpy(gen))
    ref = J.precision_recall_f1(jnp.asarray(real), jnp.asarray(gen))
    for key in ('precision', 'recall', 'f1'):
        assert float(got[key]) == float(ref[key]) == 0.0, key
