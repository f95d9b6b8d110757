"""VQ codebook search (Kernel F) and the VQ layer built on it.

Counterpart of generative_models_tpu/ops/quantize.py:

  vq_one_hot   -- Kernel F (ops/csrc/quantize.cu): the nearest code of each
                  z row by argmin of -2 z.e + |e|^2 over the whole codebook
                  in torch.argmin's order (a NaN score first, then the
                  lowest; the first index on ties and among NaNs), as a
                  one-hot (N, K) f32 and the int64 index. The codebook
                  streams through shared memory in K-tiles and D in
                  chunks, so every N, K and D runs through the kernel: the
                  port keeps no counterpart of the JAX package's XLA gate
                  (quantize.py:80-86), which came from the TPU's VMEM
                  budget.
  vq_quantize  -- the straight-through VQ layer on an NHWC latent grid:
                  codebook and commitment losses, z_q, perplexity, indices.

The wrapper launches the kernel for CUDA tensors (and refuses what it does
not take) and runs vq_one_hot_plain for CPU tensors. The plain version is
f32; the kernel multiplies on the tensor cores as three tf32 products a
multiply-add (3xTF32), which keeps the f32 product's assignments but for
ties within rounding (vq_ties_missed): bf16 operands, or one tf32 product,
would flip assignments against the reference. Infinite inputs are outside
the kernel's contract (its split turns an inf into a NaN). The search has
no gradient; z_q = one_hot @ codebook carries the codebook's, as in the JAX
package.
"""

import torch
import torch.nn.functional as F

from generative_models_tpu_torch.ops.common import c_function, check_cuda, launch


def vq_scores(z, e):
    """-2 z @ e^T + |e|^2, (N, K) f32: |z - e|^2 less the row's |z|^2."""
    return -2.0 * (z @ e.t()) + (e * e).sum(-1)[None, :]


def vq_one_hot_plain(z, e):
    """z (N, D), e (K, D) f32 -> (one-hot (N, K) f32, index (N,) int64):
    torch.argmin of vq_scores, which takes the first index on ties and the
    first NaN over any number, as jnp.argmin does."""
    idx = torch.argmin(vq_scores(z, e), dim=1)
    return F.one_hot(idx, e.shape[0]).float(), idx


# a differing index is a tie when the plain scores of the two codes differ
# by less than this share of the row's largest |score|: a sum in another
# order may break such a tie either way
VQ_TIE_REL = 1e-5


def vq_ties_missed(idx, ref_idx, z, e, rel=VQ_TIE_REL):
    """Rows whose index differs from ref_idx (the plain version's) by more
    than a tie under vq_scores(z, e). A row with a NaN score among the two
    codes', or an index outside the codebook, counts as missed unless the
    indices are equal."""
    rows = (idx != ref_idx).nonzero().flatten()
    if not len(rows):
        return 0
    sc = vq_scores(z[rows], e)
    got, K = idx[rows], e.shape[0]
    outside = (got < 0) | (got >= K)
    a = sc.gather(1, got.clamp(0, K - 1)[:, None]).squeeze(1)
    b = sc.gather(1, ref_idx[rows, None]).squeeze(1)
    return int((outside | ~((a - b).abs() < rel * sc.abs().amax(1))).sum())


def vq_one_hot(z, e):
    """Kernel F. z (N, D), e (K, D) f32, contiguous on the card (at any
    offset: rows that are not 16-byte aligned take the kernel's 4-byte
    copies) -> (one-hot (N, K) f32, index (N,) int64), both written by the
    kernel. CPU tensors take vq_one_hot_plain."""
    z, e = z.detach(), e.detach()
    if z.device.type == 'cpu':
        return vq_one_hot_plain(z, e)
    N, D = z.shape
    K = e.shape[0]
    check_cuda('vq_one_hot z', z, torch.float32, (N, D))
    check_cuda('vq_one_hot e', e, torch.float32, (K, D))
    if not (K and D):
        raise ValueError(f'vq_one_hot: empty codebook ({K}, {D})')
    one_hot = torch.empty((N, K), dtype=torch.float32, device=z.device)
    idx = torch.empty((N,), dtype=torch.int64, device=z.device)
    if N:
        fn = c_function('quantize', 'gmt_vq_one_hot', 4, 3)
        launch('quantize', fn, z.data_ptr(), e.data_ptr(), one_hot.data_ptr(),
               idx.data_ptr(), N, K, D)
        vq_one_hot.launches += 1
    return one_hot, idx


vq_one_hot.launches = 0


def vq_quantize(z, codebook, beta):
    """The VQ layer on an NHWC latent grid z (B, h, w, D), rows flattened in
    (b, h, w) order. Returns (embed_loss, z_q straight-through, perplexity,
    idxs (B, h, w), one-hot (B*h*w, K)), with the reference's loss
    mean((sg[z_q] - z)^2) + beta * mean((z_q - sg[z])^2)."""
    B, h, w, D = z.shape
    one_hot, idx = vq_one_hot(z.reshape(-1, D), codebook)
    z_q = (one_hot @ codebook).reshape(z.shape)
    loss = ((z_q.detach() - z) ** 2).mean() + beta * ((z_q - z.detach()) ** 2).mean()
    z_q_st = z + (z_q - z).detach()  # forward z_q, gradient to z
    e_mean = one_hot.mean(0)
    perplexity = torch.exp(-(e_mean * torch.log(e_mean + 1e-10)).sum())
    return loss, z_q_st, perplexity, idx.reshape(B, h, w), one_hot
