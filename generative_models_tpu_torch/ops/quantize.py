"""VQ codebook search (Kernel F) and the VQ layer built on it.

Counterpart of generative_models_tpu/ops/quantize.py:

  vq_one_hot   -- Kernel F (ops/csrc/quantize.cu): the nearest code of each
                  z row by argmin of -2 z.e + |e|^2 over the whole codebook,
                  first index on ties, as a one-hot (N, K) f32 and the
                  int64 index. The codebook streams through shared memory
                  in K-tiles, so every N, K and D runs through the kernel:
                  the port keeps no counterpart of the JAX package's XLA
                  gate (quantize.py:80-86), which came from the TPU's VMEM
                  budget.
  vq_quantize  -- the straight-through VQ layer on an NHWC latent grid:
                  codebook and commitment losses, z_q, perplexity, indices.

The wrapper launches the kernel for CUDA tensors (and refuses what it does
not take) and runs vq_one_hot_plain for CPU tensors. Both are f32
throughout: bf16 operands would flip assignments against the reference.
The search has no gradient; z_q = one_hot @ codebook carries the
codebook's, as in the JAX package.
"""

import torch
import torch.nn.functional as F

from generative_models_tpu_torch.ops.common import c_function, check_cuda, launch


def vq_scores(z, e):
    """-2 z @ e^T + |e|^2, (N, K) f32: |z - e|^2 less the row's |z|^2."""
    return -2.0 * (z @ e.t()) + (e * e).sum(-1)[None, :]


def vq_one_hot_plain(z, e):
    """z (N, D), e (K, D) f32 -> (one-hot (N, K) f32, index (N,) int64):
    torch.argmin of vq_scores, which takes the first index on ties as
    jnp.argmin does."""
    idx = torch.argmin(vq_scores(z, e), dim=1)
    return F.one_hot(idx, e.shape[0]).float(), idx


def vq_one_hot(z, e):
    """Kernel F. z (N, D), e (K, D) f32, contiguous on the card -> (one-hot
    (N, K) f32, index (N,) int64). CPU tensors take vq_one_hot_plain."""
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
    idx = torch.empty((N,), dtype=torch.int32, device=z.device)
    if N:
        fn = c_function('quantize', 'gmt_vq_one_hot', 4, 3)
        launch('quantize', fn, z.data_ptr(), e.data_ptr(), one_hot.data_ptr(),
               idx.data_ptr(), N, K, D)
        vq_one_hot.launches += 1
    return one_hot, idx.long()


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
