"""Fused transformer decode-step kernels (Kernels A and B).

Counterpart of generative_models_tpu/ops/decode_fused.py. The KV-cached
sampling loop runs one decode step per token, and each step is a chain of
small (B, C) dense ops whose cost is their count, not their size. Two
kernels collapse the dense chains of a Block step:

  ln_matmul   -- pre-LN + matmul (+bias): the LN1 + fused QKV entry of a
                 Block step and the final ln_f + head, one launch each;
  block_tail  -- attention out-proj + residual + pre-LN MLP (fc1, tanh
                 GELU, fc2) + residual: one launch instead of ~8 ops.

The CUDA sources are ops/csrc/decode_fused.cu. Each wrapper launches its
kernel for CUDA tensors (and refuses what the kernel does not take), and
runs the plain PyTorch version for CPU tensors. The plain versions take the
matmul operand dtype, so on the card they repeat the kernel's arithmetic
(bf16 operands, f32 accumulation) and isolate the kernel in a comparison.

Weights use the JAX package's (in, out) layout, which the kernels read
coalesced along the output columns.
"""

import torch
import torch.nn.functional as F

from generative_models_tpu_torch.ops.common import c_function, check_cuda, launch

LN_EPS = 1e-6  # flax LayerNorm's eps (torch's default is 1e-5)


def _ln(x, scale, bias, eps=LN_EPS):
    m = x.mean(-1, keepdim=True)
    v = (x - m).square().mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * scale + bias


def _mm(a, w, dtype):
    """a @ w with both operands rounded to dtype and the product in f32."""
    return a.to(dtype).float() @ w.to(dtype).float()


def ln_matmul_plain(x, scale, bias, w, b, dtype=torch.float32):
    """LN(x) @ w + b. x: (B, C); w: (C, N) -> (B, N) f32."""
    return _mm(_ln(x, scale, bias), w, dtype) + b


def block_tail_plain(x, y, lp, dtype=torch.float32):
    """x + proj(y), then + MLP(LN2(.)): the post-attention half of a Block
    step. x, y: (B, C); lp: dict with wproj, bproj, ln2_scale, ln2_bias,
    wfc1, bfc1, wfc2, bfc2 (weights (in, out)). Returns (B, C) f32."""
    h1 = x + (_mm(y, lp['wproj'], dtype) + lp['bproj'])
    g = _ln(h1, lp['ln2_scale'], lp['ln2_bias'])
    g = F.gelu(_mm(g, lp['wfc1'], dtype) + lp['bfc1'], approximate='tanh')
    return h1 + (_mm(g, lp['wfc2'], dtype) + lp['bfc2'])


def ln_matmul(x, scale, bias, w, b):
    """LN(x) @ w + b in one kernel. x: (B, C) f32; scale, bias: (C,) f32;
    w: (C, N) bf16 on the card; b: (N,) f32 -> (B, N) f32."""
    if x.device.type == 'cpu':
        return ln_matmul_plain(x, scale, bias, w, b)
    B, C = x.shape
    N = w.shape[1]
    check_cuda('ln_matmul x', x, torch.float32, (B, C))
    check_cuda('ln_matmul scale', scale, torch.float32, (C,))
    check_cuda('ln_matmul bias', bias, torch.float32, (C,))
    check_cuda('ln_matmul w', w, torch.bfloat16, (C, N))
    check_cuda('ln_matmul b', b, torch.float32, (N,))
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if B and N:
        fn = c_function('decode_fused', 'gmt_ln_matmul', 6, 3)
        launch('decode_fused', fn, x.data_ptr(), scale.data_ptr(),
               bias.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
               B, C, N)
        ln_matmul.launches += 1
    return out


ln_matmul.launches = 0

_BT_VECS = ('bproj', 'ln2_scale', 'ln2_bias', 'bfc1', 'bfc2')


def block_tail(x, y, lp):
    """The whole post-attention half of a Block step in one kernel. x, y:
    (B, C) f32; lp as block_tail_plain, weights bf16 on the card. Returns
    (B, C) f32."""
    if x.device.type == 'cpu':
        return block_tail_plain(x, y, lp)
    B, C = x.shape
    check_cuda('block_tail x', x, torch.float32, (B, C))
    check_cuda('block_tail y', y, torch.float32, (B, C))
    for name, shape in (('wproj', (C, C)), ('wfc1', (C, 4 * C)), ('wfc2', (4 * C, C))):
        check_cuda(f'block_tail {name}', lp[name], torch.bfloat16, shape)
    for name in _BT_VECS:
        n = 4 * C if name == 'bfc1' else C
        check_cuda(f'block_tail {name}', lp[name], torch.float32, (n,))
    out = torch.empty((B, C), dtype=torch.float32, device=x.device)
    if B:
        fn = c_function('decode_fused', 'gmt_block_tail', 11, 2)
        launch('decode_fused', fn, x.data_ptr(), y.data_ptr(),
               lp['wproj'].data_ptr(), lp['bproj'].data_ptr(),
               lp['ln2_scale'].data_ptr(), lp['ln2_bias'].data_ptr(),
               lp['wfc1'].data_ptr(), lp['bfc1'].data_ptr(),
               lp['wfc2'].data_ptr(), lp['bfc2'].data_ptr(), out.data_ptr(),
               B, C)
        block_tail.launches += 1
    return out


block_tail.launches = 0
