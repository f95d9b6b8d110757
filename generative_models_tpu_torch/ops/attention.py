"""Causal attention ops.

Counterpart of generative_models_tpu/ops/attention.py, forward half:

  causal_attention_fwd   -- Kernel C (ops/csrc/attention.cu), the causal
                            flash-attention forward: one block per (bh, query
                            tile), online softmax, o and the row logsumexp
                            (which the training slice's backward will need).
                            One kernel for every T: the TPU's static/streamed
                            split (_plan) came from its VMEM budget.
  causal_attention       -- the scoring path's entry: casts q/k/v to the
                            operand dtype and calls the wrapper above.
  decode_step_attention  -- single-token attention against the packed
                            T-major KV cache; plain torch, as the JAX package
                            left it to XLA.

Operands are bf16 on the card and f32 on the CPU; every product accumulates
in f32, and o and lse are f32.
"""

import math

import torch

from generative_models_tpu_torch.ops.common import (
    c_function, check_cuda, launch, matmul_dtype,
)

NEG_INF = -1e30


def causal_attention_plain(q, k, v, dtype=torch.float32):
    """Dense reference: (B, H, T, D) -> (o (B, H, T, D) f32, lse (B, H, T)
    f32), with q/k/v rounded to dtype and every product in f32."""
    T, D = q.shape[-2:]
    qf, kf, vf = (u.to(dtype).float() for u in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    return torch.exp(s - lse[..., None]) @ vf, lse


def causal_attention_fwd(q, k, v):
    """Kernel C. q, k, v: (B, H, T, D), bf16 and contiguous on the card ->
    (o (B, H, T, D) f32, lse (B, H, T) f32). D must be a multiple of 8 up to
    128. CPU tensors take causal_attention_plain in f32."""
    if q.device.type == 'cpu':
        return causal_attention_plain(q, k, v)
    B, H, T, D = q.shape
    for name, u in (('q', q), ('k', k), ('v', v)):
        check_cuda(f'causal_attention_fwd {name}', u, torch.bfloat16, (B, H, T, D))
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f'causal_attention_fwd: D={D} must be a multiple of 8 in [8, 128]')
    if B * H > 65535:
        raise ValueError(f'causal_attention_fwd: B*H={B * H} exceeds the grid limit 65535')
    o = torch.empty((B, H, T, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if B * H and T:
        fn = c_function('attention', 'gmt_flash_fwd', 5, 3, 1)
        launch('attention', fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               o.data_ptr(), lse.data_ptr(), B * H, T, D, 1.0 / math.sqrt(D))
        causal_attention_fwd.launches += 1
    return o, lse


causal_attention_fwd.launches = 0


def causal_attention(q, k, v):
    """Causal multi-head attention: (B, H, T, D) -> (o f32, lse f32).
    softmax(QK^T / sqrt(D), tril-masked) @ V through Kernel C on the card
    (bf16 operands), the plain version in f32 on the CPU."""
    dt = matmul_dtype(q.device)
    return causal_attention_fwd(
        *(u.to(dt).contiguous() for u in (q, k, v))
    )


def decode_step_attention(q1, kv_cache, t, n_head):
    """Single-token attention against a packed T-major KV cache.

    q1: (B, H*D) the current token's query; kv_cache: (T, B, 2, H*D) with K
    at [:, :, 0] and V at [:, :, 1]; t: current index. Attends to positions
    0..t inclusive; returns (B, H*D) f32. Operands are rounded to the cache
    dtype and products accumulate in f32, as in the JAX package.
    """
    T, B, _, HD = kv_cache.shape
    D = HD // n_head
    dt = kv_cache.dtype
    kc = kv_cache[:, :, 0].reshape(T, B, n_head, D).float()
    vc = kv_cache[:, :, 1].reshape(T, B, n_head, D).float()
    qh = q1.reshape(B, n_head, D).to(dt).float()
    s = torch.einsum('tbhd,bhd->bht', kc, qh) / math.sqrt(D)
    s[..., t + 1:] = NEG_INF
    p = torch.softmax(s, dim=-1)
    y = torch.einsum('bht,tbhd->bhd', p.to(dt).float(), vc)
    return y.reshape(B, HD).contiguous()


def decode_cache_dtype(device):
    """KV-cache dtype for sampling: bf16 on the card (halves the cache
    traffic that each decode step re-reads), f32 on the CPU so the tests
    compare the decode chain against the full forward exactly."""
    return matmul_dtype(device)
