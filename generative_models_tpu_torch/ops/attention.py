"""Causal attention ops.

Counterpart of generative_models_tpu/ops/attention.py:

  causal_attention_fwd   -- Kernel C (ops/csrc/attention.cu), the causal
                            flash-attention forward: one block per (bh, query
                            tile), online softmax, o and the row logsumexp.
                            One kernel for every T: the TPU's static/streamed
                            split (_plan) came from its VMEM budget.
  flash_bwd_dq           -- Kernel E (ops/csrc/attention_bwd.cu): dQ, and
                            delta = rowsum(dO * o), one block per (bh, query
                            tile).
  flash_bwd_dkv          -- Kernel D (same file): dK and dV, one block per
                            (bh, key tile), from E's delta.
  causal_attention_bwd   -- the backward: E then D (their plain versions
                            on the CPU).
  causal_attention       -- the model's entry: a torch.autograd.Function
                            (CausalAttention) whose forward is Kernel C and
                            whose backward is causal_attention_bwd, as
                            jax.custom_vjp wraps the TPU kernels
                            (_ca_fwd/_ca_bwd).
  decode_step_attention  -- single-token attention against the packed
                            T-major KV cache; plain torch, as the JAX package
                            left it to XLA.

Operands (q, k, v, dO) are bf16 on the card and f32 on the CPU; every
product accumulates in f32, and o, lse and the gradients are f32.
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


def _bwd_scores(q, k, v, lse, do, delta, dtype):
    """The plain backward's shared recompute: (P, dS) (B, H, T, T) f32 and
    the rounded q, k, dO."""
    T, D = q.shape[-2:]
    qf, kf, vf, dof = (u.to(dtype).float() for u in (q, k, v, do))
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    p = torch.exp(s.masked_fill(~mask, NEG_INF) - lse[..., None])
    ds = p * ((dof @ vf.transpose(-1, -2)) - delta[..., None])
    return p, ds, qf, kf, dof


def flash_bwd_dq_plain(q, k, v, o, lse, do, dtype=torch.float32):
    """Kernel E's plain version: (dq (B, H, T, D) f32, delta (B, H, T) f32),
    delta = rowsum(dO * o) with dO rounded to dtype."""
    D = q.shape[-1]
    delta = (do.to(dtype).float() * o).sum(-1)
    _, ds, _, kf, _ = _bwd_scores(q, k, v, lse, do, delta, dtype)
    return (ds @ kf) * (1.0 / math.sqrt(D)), delta


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, dtype=torch.float32):
    """Kernel D's plain version: (dk, dv), each (B, H, T, D) f32."""
    D = q.shape[-1]
    p, ds, qf, _, dof = _bwd_scores(q, k, v, lse, do, delta, dtype)
    return (ds.transpose(-1, -2) @ qf) * (1.0 / math.sqrt(D)), p.transpose(-1, -2) @ dof


def causal_attention_bwd_plain(q, k, v, o, lse, do, dtype=torch.float32):
    """Dense recompute of the flash backward: P = exp(S - lse),
    dV = P^T dO, dP = dO V^T, dS = P * (dP - delta), dQ = dS K * scale,
    dK = dS^T Q * scale, with q/k/v/dO rounded to dtype and every product
    in f32 (P and dS are not rounded, as in Kernels D and E)."""
    dq, delta = flash_bwd_dq_plain(q, k, v, o, lse, do, dtype)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, dtype)
    return dq, dk, dv


def _check_bwd(name, q, k, v, do, lse):
    B, H, T, D = q.shape
    for arg, u in (('q', q), ('k', k), ('v', v), ('do', do)):
        check_cuda(f'{name} {arg}', u, torch.bfloat16, (B, H, T, D))
    check_cuda(f'{name} lse', lse, torch.float32, (B, H, T))
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f'{name}: D={D} must be a multiple of 8 in [8, 128]')
    if B * H > 65535:
        raise ValueError(f'{name}: B*H={B * H} exceeds the grid limit 65535')


def flash_bwd_dq(q, k, v, o, lse, do):
    """Kernel E. q, k, v, do: (B, H, T, D) bf16, o f32, lse (B, H, T) f32,
    contiguous on the card -> (dq (B, H, T, D) f32, delta (B, H, T) f32).
    CPU tensors take flash_bwd_dq_plain in f32."""
    if q.device.type == 'cpu':
        return flash_bwd_dq_plain(q, k, v, o, lse, do)
    _check_bwd('flash_bwd_dq', q, k, v, do, lse)
    check_cuda('flash_bwd_dq o', o, torch.float32, q.shape)
    B, H, T, D = q.shape
    dq = torch.empty((B, H, T, D), dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if B * H and T:
        fn = c_function('attention_bwd', 'gmt_flash_bwd_dq', 8, 3, 1)
        launch('attention_bwd', fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dq.data_ptr(), B * H, T, D, 1.0 / math.sqrt(D))
        flash_bwd_dq.launches += 1
    return dq, delta


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta):
    """Kernel D. q, k, v, do: (B, H, T, D) bf16, lse and delta (B, H, T) f32
    (delta from Kernel E), contiguous on the card -> (dk, dv), each
    (B, H, T, D) f32. CPU tensors take flash_bwd_dkv_plain in f32."""
    if q.device.type == 'cpu':
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    _check_bwd('flash_bwd_dkv', q, k, v, do, lse)
    check_cuda('flash_bwd_dkv delta', delta, torch.float32, lse.shape)
    B, H, T, D = q.shape
    dk = torch.empty((B, H, T, D), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, H, T, D), dtype=torch.float32, device=q.device)
    if B * H and T:
        fn = c_function('attention_bwd', 'gmt_flash_bwd_dkv', 8, 3, 1)
        launch('attention_bwd', fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
               dv.data_ptr(), B * H, T, D, 1.0 / math.sqrt(D))
        flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def causal_attention_bwd(q, k, v, o, lse, do):
    """Flash backward: q, k, v, do in the operand dtype, o and lse f32 from
    the forward -> (dq, dk, dv) f32. Kernel E (dq, delta) then Kernel D
    (dk, dv) on the card; on the CPU their wrappers take the plain versions,
    which together are causal_attention_bwd_plain."""
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv


class CausalAttention(torch.autograd.Function):
    """Causal attention with the flash backward, the counterpart of the JAX
    package's custom_vjp. Takes q/k/v in any float dtype and casts them to
    the operand dtype inside, so the gradients (f32 from the kernels) come
    back in the inputs' dtype without passing through a bf16 cast. Saves
    (q, k, v, o, lse); lse is returned but carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        dt = matmul_dtype(q.device)
        qc, kc, vc = (u.to(dt).contiguous() for u in (q, k, v))
        o, lse = causal_attention_fwd(qc, kc, vc)
        ctx.save_for_backward(qc, kc, vc, o, lse)
        ctx.in_dtypes = (q.dtype, k.dtype, v.dtype)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qc, kc, vc, o, lse = ctx.saved_tensors
        grads = causal_attention_bwd(qc, kc, vc, o, lse, do.to(qc.dtype).contiguous())
        return tuple(g.to(dt) for g, dt in zip(grads, ctx.in_dtypes))


def causal_attention(q, k, v):
    """Causal multi-head attention: (B, H, T, D) -> (o f32, lse f32).
    softmax(QK^T / sqrt(D), tril-masked) @ V through Kernel C on the card
    (bf16 operands), the plain version in f32 on the CPU; differentiable
    through CausalAttention's flash backward."""
    return CausalAttention.apply(q, k, v)


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
