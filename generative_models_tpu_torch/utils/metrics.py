"""Eval metrics, on the device of their inputs. Counterpart of
generative_models_tpu/utils/metrics.py: FID through the symmetric-PSD form

  trace(sqrtm(A @ B)) = trace(sqrtm(B^1/2 A B^1/2)),

so every matrix root is an eigh, and the k-NN manifold precision / recall /
F1 (arXiv:1904.06991), in f32 throughout, as the JAX package.

Where torch and jnp differ, this module writes the JAX package's form out:
jnp.linalg.eigh symmetrises its input, (a + a^T) / 2, and torch.linalg.eigh
reads only the lower triangle, so _psd_sqrtm symmetrises first (B^1/2 A
B^1/2 is not exactly symmetric in floating point); cdist is
sqrt(max(|a|^2 + |b|^2 - 2 a.b, 0)), not torch.cdist, whose rounding
differs and moves the strict d < radius comparisons. The products run with
TF32 off (ops/common.resolve_device turns it off on the card).
"""

import torch
import torch.nn.functional as F


def _psd_sqrtm(a):
    """Symmetric PSD matrix square root through eigh of (a + a^T) / 2."""
    w, v = torch.linalg.eigh((a + a.T) / 2)
    return (v * torch.sqrt(torch.clamp(w, min=0.0))) @ v.T


def _cov(x):
    xm = x - x.mean(0, keepdim=True)
    return (xm.T @ xm) / (x.shape[0] - 1)


def frechet_distance(x, y, mean_of_sq=False):
    """Frechet distance between Gaussians fit to two feature sets (N, D).
    mean_of_sq=True takes the mean of the squared mean difference (the
    reference's FID), False its sum (the standard formula)."""
    x, y = x.float(), y.float()
    pmu, tmu = x.mean(0), y.mean(0)
    pcov, tcov = _cov(x), _cov(y)
    sqrt_p = _psd_sqrtm(pcov)
    covmean_tr = torch.trace(_psd_sqrtm(sqrt_p @ tcov @ sqrt_p))
    diff = pmu - tmu
    mean_term = torch.mean(diff ** 2) if mean_of_sq else torch.sum(diff ** 2)
    return mean_term + torch.trace(pcov) + torch.trace(tcov) - 2.0 * covmean_tr


def compute_fid(x, y):
    """The reference's FID: the mean of squares for the mean term."""
    return frechet_distance(x, y, mean_of_sq=True)


def cdist(a, b):
    """Pairwise euclidean distances (N, D) x (M, D) -> (N, M)."""
    a2 = torch.sum(a ** 2, -1)[:, None]
    b2 = torch.sum(b ** 2, -1)[None, :]
    return torch.sqrt(torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0))


def cross_entropy(logits, labels):
    """Mean softmax cross-entropy with integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def precision_recall_f1(real, gen, k=3):
    """k-NN manifold precision / recall / F1: a set's radii are each
    point's distance to its (k+1)-th nearest point in the set, itself
    included; precision is the share of gen within some real point's
    radius (strictly), recall the share of real within some gen point's.
    f1 is 0 where precision + recall is 0."""

    def manifold_estimate(set_a, set_b):
        radii = torch.topk(cdist(set_a, set_a), k + 1, dim=-1, largest=False).values[..., -1:]
        return torch.mean(torch.any(cdist(set_a, set_b) < radii, dim=0).float())

    precision = manifold_estimate(real, gen)
    recall = manifold_estimate(gen, real)
    denom = precision + recall
    f1 = torch.where(denom > 0, 2 * (precision * recall) / torch.clamp(denom, min=1e-12),
                     torch.zeros_like(denom))
    return {'precision': precision, 'recall': recall, 'f1': f1}
