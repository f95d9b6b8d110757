"""Causal attention ops.

Counterpart of generative_models_tpu/ops/attention.py:

  causal_attention_fwd   -- Kernel C (ops/csrc/attention.cu), the causal
                            flash-attention forward: o and the row logsumexp,
                            one block per (bh, query tile), on the tensor
                            cores (mma.sync) with the online softmax in log2
                            units and P carried into P v as a bf16 hi/lo
                            pair, built like E from ops/csrc/flash_tiles.cuh
                            (0.097 ms at (64,4,784,32) on an H100, 1.1x SDPA's
                            forward: PERF.md section 6). One kernel for every
                            T: the TPU's static/streamed split (_plan) came
                            from its VMEM budget.
  flash_bwd_dq           -- Kernel E (ops/csrc/attention_bwd.cu): dQ, and
                            delta = rowsum(dO * o), one block per (bh, query
                            tile), on the tensor cores (mma.sync) with P and
                            dS carried as bf16 hi/lo pairs.
  flash_bwd_dkv          -- Kernel D (same file): dK and dV, one block per
                            (bh, key tile), from E's delta, the same way.
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
  ring_chunk_fwd         -- Kernel K (ops/csrc/ring_attention.cu), one ring
                            hop of the causal online softmax: folds each ring
                            position's visiting K/V chunk into its carried
                            (acc, m, l); Kernel C's hop form on the tensor
                            cores. parallel/ring_attention.py runs the hops.
  ring_chunk_bwd_dq      -- Kernel L (same file), one hop's dQ onto the
                            local carried dQ; Kernel E's hop form.
  ring_chunk_bwd_dkv     -- Kernel M (same file), one hop's dK/dV onto the
                            visiting chunk's travelling accumulators; Kernel
                            D's hop form.

Operands (q, k, v, dO) are bf16 on the card and f32 on the CPU; every
product accumulates in f32, and o, lse and the gradients are f32.
"""

import math

import torch

from generative_models_tpu_torch.ops.common import (
    c_function, check_cuda, launch, matmul_dtype, round_up,
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
    (o (B, H, T, D) f32, lse (B, H, T) f32, lse in natural units). D must
    be a multiple of 8 up to 128. CPU tensors take causal_attention_plain
    in f32."""
    if q.device.type == 'cpu':
        return causal_attention_plain(q, k, v)
    B, H, T, D = q.shape
    for name, u in (('q', q), ('k', k), ('v', v)):
        check_cuda(f'causal_attention_fwd {name}', u, torch.bfloat16, (B, H, T, D))
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f'causal_attention_fwd: D={D} must be a multiple of 8 in [8, 128]')
    if B * H > 65535:
        raise ValueError(f'causal_attention_fwd: B*H={B * H} exceeds the grid limit 65535')
    q, k, v = map(_aligned16, (q, k, v))
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
    in f32. P and dS are not rounded: Kernels D and E carry each as a bf16
    pair hi + lo (about 2^-16 relative), which holds them to this."""
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


def _aligned16(u):
    """u, or a copy of it where its data does not start on 16 bytes (a view
    at an odd offset): Kernels C, D and E read rows 16 bytes at a time."""
    return u if u.data_ptr() % 16 == 0 else u.clone()


def flash_bwd_dq(q, k, v, o, lse, do):
    """Kernel E. q, k, v, do: (B, H, T, D) bf16, o f32, lse (B, H, T) f32,
    contiguous on the card -> (dq (B, H, T, D) f32, delta (B, H, T) f32).
    CPU tensors take flash_bwd_dq_plain in f32."""
    if q.device.type == 'cpu':
        return flash_bwd_dq_plain(q, k, v, o, lse, do)
    _check_bwd('flash_bwd_dq', q, k, v, do, lse)
    check_cuda('flash_bwd_dq o', o, torch.float32, q.shape)
    B, H, T, D = q.shape
    q, k, v, o, do = map(_aligned16, (q, k, v, o, do))
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
    q, k, v, do = map(_aligned16, (q, k, v, do))
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


def decode_step_attention(q1, kv_cache, t, n_head, pos=None):
    """Single-token attention against a packed T-major KV cache.

    q1: (B, H*D) the current token's query; kv_cache: (T, B, 2, H*D) with K
    at [:, :, 0] and V at [:, :, 1]; t: current index. Attends to positions
    0..t inclusive; returns (B, H*D) f32. Operands are rounded to the cache
    dtype and products accumulate in f32, as in the JAX package. The rows
    past t are masked through pos > t (pos: torch.arange of at least T on
    the cache's device, made here when None), a shape that does not depend
    on t, so torch.export keeps the step in its loop.
    """
    T, B, _, HD = kv_cache.shape
    D = HD // n_head
    dt = kv_cache.dtype
    kc = kv_cache[:, :, 0].reshape(T, B, n_head, D).float()
    vc = kv_cache[:, :, 1].reshape(T, B, n_head, D).float()
    qh = q1.reshape(B, n_head, D).to(dt).float()
    s = torch.einsum('tbhd,bhd->bht', kc, qh) / math.sqrt(D)
    if pos is None:
        pos = torch.arange(T, device=kv_cache.device)
    s = s.masked_fill(pos[:T] > t, NEG_INF)
    p = torch.softmax(s, dim=-1)
    y = torch.einsum('bht,tbhd->bhd', p.to(dt).float(), vc)
    return y.reshape(B, HD).contiguous()


def decode_cache_dtype(device):
    """KV-cache dtype for sampling: bf16 on the card (halves the cache
    traffic that each decode step re-reads), f32 on the CPU so the tests
    compare the decode chain against the full forward exactly."""
    return matmul_dtype(device)


# ------------------------- ring-attention hop kernels -------------------------
# One ring hop (parallel/ring_attention.py runs the hops) of the causal flash
# forward and backward, for every ring position of a launch together. The
# causal mask comes from global positions: ring position p's query chunk
# starts at p * t_valid, and the chunk c it visits at hop `hop`, c = (p - hop)
# mod n_ring, at c * t_valid. Keys at or past t_valid (the chunk's padding)
# are masked. Layouts: q, k, v, dO (P, BH, Tp, D); acc, dq, dk, dv the same in
# f32; m, l, lse, delta (P, BH, Tp) f32. With P == n_ring every ring position
# lies on this device, and position p reads chunk (p - hop) mod n_ring where
# it lies (the rotation is an index); with P < n_ring (a process group) slot j
# of k and v holds the chunk that position pos0 + j visits at this hop.


def _pick_blk(T):
    """(block size, padded T), as the JAX package's _pick_blk: the largest
    multiple of 8 in [40, 144] that divides T, else 128 with T padded to a
    multiple of 128."""
    if T % 8 == 0:
        best = 0
        for d in range(40, 145, 8):
            if T % d == 0:
                best = d
        if best:
            return best, T
    return 128, round_up(T, 128)


def _pick_chunk_blk(T):
    """(block size, padded T) for a ring chunk of local length T: a chunk
    of at most 128 is one block rounded up to 8, a longer one takes
    _pick_blk. The padded length is the ring's chunk length in memory."""
    if T <= 128:
        b = round_up(T, 8)
        return b, b
    return _pick_blk(T)


def _live_kv_bound(q0, k0, blk, n_kv):
    """Number of leading KV blocks with any causally live pair for the
    query block starting at global q0 against the chunk starting at k0."""
    return min(max((q0 + blk - 1 - k0) // blk + 1, 0), n_kv)


def _ring_scores(q, k, q_start, k_start, t_valid, dtype):
    """(S (BH, Tp, Tp) f32 with dead pairs at NEG_INF, rounded q, rounded k)
    of one ring position against the chunk it visits."""
    Tp, D = q.shape[-2:]
    qf, kf = (u.to(dtype).float() for u in (q, k))
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    r = torch.arange(Tp, device=q.device)
    live = (q_start + r[:, None] >= k_start + r[None, :]) & (r[None, :] < t_valid)
    return s.masked_fill(~live, NEG_INF), qf, kf


def ring_chunk_fwd_plain(q, k, v, acc, m, l, q_start, k_start, t_valid, dtype=torch.float32):
    """Kernel K's plain version, one ring position: q, k, v (BH, Tp, D)
    rounded to dtype; the carry acc (BH, Tp, D), m, l (BH, Tp) f32, or None
    for the first hop (acc = 0, m = NEG_INF, l = 0). Returns the carry with
    the visiting chunk folded in by the online softmax, all f32 (P is not
    rounded), block by block in the TPU kernel's order: KV blocks of
    _pick_chunk_blk(t_valid), each query block stopping at its live bound,
    so a query block with no live pair keeps its carry. (A row of a live
    block with no live key yet and m = NEG_INF would weigh the dead keys by
    exp(0); the ring's first hop is the diagonal, where every row has a
    live key in the first block.)"""
    BH, Tp, D = q.shape
    if acc is None:
        acc = torch.zeros((BH, Tp, D), dtype=torch.float32, device=q.device)
        m = torch.full((BH, Tp), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((BH, Tp), dtype=torch.float32, device=q.device)
    s, _, _ = _ring_scores(q, k, q_start, k_start, t_valid, dtype)
    vf = v.to(dtype).float()
    blk = _pick_chunk_blk(t_valid)[0]
    n_kv = -(-t_valid // blk)
    bounds = [_live_kv_bound(q_start + i * blk, k_start, blk, n_kv) for i in range(-(-Tp // blk))]
    bound = torch.tensor(bounds, device=q.device)[torch.arange(Tp, device=q.device) // blk]
    for j in range(n_kv):
        sj = s[..., j * blk:(j + 1) * blk]
        m_new = torch.maximum(m, sj.max(-1).values)
        p = torch.exp(sj - m_new[..., None])
        alpha = torch.exp(m - m_new)
        live = bound > j  # rows whose query block reaches KV block j
        l = torch.where(live, alpha * l + p.sum(-1), l)
        acc = torch.where(live[:, None], acc * alpha[..., None] + p @ vf[:, j * blk:(j + 1) * blk],
                          acc)
        m = torch.where(live, m_new, m)
    return acc, m, l


def _ring_bwd_scores(q, k, v, do, lse, delta, q_start, k_start, t_valid, dtype):
    """(P, dS (BH, Tp, Tp) f32, rounded q, k, dO) of one ring position's
    backward against the chunk it visits."""
    s, qf, kf = _ring_scores(q, k, q_start, k_start, t_valid, dtype)
    dof, vf = do.to(dtype).float(), v.to(dtype).float()
    p = torch.exp(s - lse[..., None])
    ds = p * ((dof @ vf.transpose(-1, -2)) - delta[..., None])
    return p, ds, qf, kf, dof


def ring_chunk_bwd_dq_plain(q, k, v, do, lse, delta, dq, q_start, k_start, t_valid,
                            dtype=torch.float32):
    """Kernel L's plain version, one ring position: dq + dS K * scale (dq
    None for the first hop: dS K * scale), f32."""
    _, ds, _, kf, _ = _ring_bwd_scores(q, k, v, do, lse, delta, q_start, k_start, t_valid, dtype)
    out = (ds @ kf) * (1.0 / math.sqrt(q.shape[-1]))
    return out if dq is None else dq + out


def ring_chunk_bwd_dkv_plain(q, k, v, do, lse, delta, dk, dv, q_start, k_start, t_valid,
                             dtype=torch.float32):
    """Kernel M's plain version, one ring position: (dk + dS^T Q * scale,
    dv + P^T dO) onto the visiting chunk's accumulators (None for the
    first hop: zeros), f32."""
    p, ds, qf, _, dof = _ring_bwd_scores(q, k, v, do, lse, delta, q_start, k_start, t_valid,
                                         dtype)
    gk = (ds.transpose(-1, -2) @ qf) * (1.0 / math.sqrt(q.shape[-1]))
    gv = p.transpose(-1, -2) @ dof
    return (gk, gv) if dk is None else (dk + gk, dv + gv)


def ring_chunk_bwd_plain(q, k, v, do, lse, delta, dq, dk, dv, q_start, k_start, t_valid,
                         dtype=torch.float32):
    """One ring position's hop backward, the JAX package's _ring_chunk_bwd:
    (dq, dk, dv), Kernels L and M's plain versions together."""
    dq = ring_chunk_bwd_dq_plain(q, k, v, do, lse, delta, dq, q_start, k_start, t_valid, dtype)
    dk, dv = ring_chunk_bwd_dkv_plain(q, k, v, do, lse, delta, dk, dv, q_start, k_start,
                                      t_valid, dtype)
    return dq, dk, dv


def _hop_items(P, hop, t_valid, pos0, n_ring):
    """(slot j, q_start, k_start) of each of the P ring positions of a
    launch at this hop: position pos0 + j visits chunk (pos0 + j - hop) mod
    n_ring. The visiting chunk lies in slot (chunk) of k and v when P ==
    n_ring, else in slot j."""
    for j in range(P):
        c = (pos0 + j - hop) % n_ring
        yield j, (c if P == n_ring else j), (pos0 + j) * t_valid, c * t_valid


def ring_hop_fwd_plain(q, k, v, carry, hop, t_valid, pos0=0, n_ring=None, dtype=torch.float32):
    """Kernel K's plain version for every ring position of a launch
    (ring_chunk_fwd's layout), one position at a time. Returns new
    tensors."""
    P = q.shape[0]
    outs = [[], [], []]
    for j, kv, qs, ks in _hop_items(P, hop, t_valid, pos0, n_ring or P):
        c = (None,) * 3 if carry is None else tuple(u[j] for u in carry)
        for o, u in zip(outs, ring_chunk_fwd_plain(q[j], k[kv], v[kv], *c, qs, ks, t_valid, dtype)):
            o.append(u)
    return tuple(torch.stack(o) for o in outs)


def ring_hop_bwd_dq_plain(q, k, v, do, lse, delta, dq, hop, t_valid, pos0=0, n_ring=None,
                          dtype=torch.float32):
    """Kernel L's plain version for every ring position of a launch."""
    return torch.stack([
        ring_chunk_bwd_dq_plain(q[j], k[kv], v[kv], do[j], lse[j], delta[j],
                                None if dq is None else dq[j], qs, ks, t_valid, dtype)
        for j, kv, qs, ks in _hop_items(q.shape[0], hop, t_valid, pos0, n_ring or q.shape[0])
    ])


def ring_hop_bwd_dkv_plain(q, k, v, do, lse, delta, dkv, hop, t_valid, pos0=0, n_ring=None,
                           dtype=torch.float32):
    """Kernel M's plain version for every ring position of a launch: (dk,
    dv) with k's slots, each slot's accumulators from the position that
    visits it."""
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    for j, kv, qs, ks in _hop_items(q.shape[0], hop, t_valid, pos0, n_ring or q.shape[0]):
        acc = (None, None) if dkv is None else (dkv[0][kv], dkv[1][kv])
        dk[kv], dv[kv] = ring_chunk_bwd_dkv_plain(q[j], k[kv], v[kv], do[j], lse[j], delta[j],
                                                  *acc, qs, ks, t_valid, dtype)
    return dk, dv


def _check_ring(name, q, k, v, t_valid, pos0, n_ring, do=None, **f32):
    """Refuse what Kernels K, L and M do not take: a D that is not a
    multiple of 8 in [8, 128] (checked first, from q's shape alone), q, k, v
    (and do) bf16 of q's shape, the named f32 tensors of q's shape or, for
    the rows m, l, lse and delta, (P, BH, Tp); None stands for an absent
    carry."""
    P, BH, Tp, D = q.shape
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f'{name}: D={D} must be a multiple of 8 in [8, 128]')
    for arg, u in (('q', q), ('k', k), ('v', v), ('do', do)):
        if u is not None:
            check_cuda(f'{name} {arg}', u, torch.bfloat16, (P, BH, Tp, D))
    for arg, u in f32.items():
        if u is not None:
            rows = arg in ('m', 'l', 'lse', 'delta')
            check_cuda(f'{name} {arg}', u, torch.float32, (P, BH, Tp) if rows else (P, BH, Tp, D))
    if BH > 65535 or P > 65535:
        raise ValueError(f'{name}: BH={BH} and P={P} must not exceed the grid limit 65535')
    if not 0 < t_valid <= Tp or not 0 <= pos0 <= n_ring - P:
        raise ValueError(f'{name}: t_valid={t_valid}, Tp={Tp}, pos0={pos0}, P={P}, '
                         f'n_ring={n_ring} out of range')


def _aligned8(u):
    """u (None stays None), or a copy of it where its data does not start on
    8 bytes (an f32 view at an odd offset): Kernels K, L and M read and
    write their f32 carries 8 bytes at a time. The caller copies the result
    back into u."""
    return u if u is None or u.data_ptr() % 8 == 0 else u.clone()


def _ptr(u):
    return None if u is None else u.data_ptr()


def ring_chunk_fwd(q, k, v, carry, hop, t_valid, pos0=0, n_ring=None):
    """Kernel K: one ring hop of the causal online softmax for the P ring
    positions pos0 .. pos0 + P - 1 of a ring of n_ring (default P), in one
    launch. q, k, v: (P, BH, Tp, D), bf16 and contiguous on the card (see
    the layout note above); carry: None at the first hop (the kernel seeds
    acc = 0, m = NEG_INF, l = 0 itself) or (acc (P, BH, Tp, D), m, l (P, BH,
    Tp)) f32. Returns the carry with this hop folded in: on the card the
    carry's own tensors, updated in place. CPU tensors take
    ring_hop_fwd_plain in f32."""
    n_ring = n_ring or q.shape[0]
    if q.device.type == 'cpu':
        return ring_hop_fwd_plain(q, k, v, carry, hop, t_valid, pos0, n_ring)
    acc_in, m_in, l_in = (None,) * 3 if carry is None else carry
    _check_ring('ring_chunk_fwd', q, k, v, t_valid, pos0, n_ring, acc=acc_in, m=m_in, l=l_in)
    P, BH, Tp, D = q.shape
    q, k, v = map(_aligned16, (q, k, v))
    if carry is None:
        acc = torch.empty((P, BH, Tp, D), dtype=torch.float32, device=q.device)
        m = torch.empty((P, BH, Tp), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    else:
        acc, m, l = _aligned8(acc_in), m_in, l_in
    fn = c_function('ring_attention', 'gmt_ring_fwd', 9, 8, 1)
    acc_ptr = None if carry is None else acc.data_ptr()
    launch('ring_attention', fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), acc_ptr,
           _ptr(m_in), _ptr(l_in), acc.data_ptr(), m.data_ptr(), l.data_ptr(), P, BH, Tp, D,
           t_valid, pos0, n_ring, hop, 1.0 / math.sqrt(D))
    ring_chunk_fwd.launches += 1
    if acc_in is not None and acc is not acc_in:
        acc = acc_in.copy_(acc)
    return acc, m, l


ring_chunk_fwd.launches = 0


def ring_chunk_bwd_dq(q, k, v, do, lse, delta, dq, hop, t_valid, pos0=0, n_ring=None):
    """Kernel L: one ring hop's dQ for the P ring positions of a launch
    (ring_chunk_fwd's layout). do: (P, BH, Tp, D) bf16, zero on padded
    rows; lse (from the forward) and delta = rowsum(dO * o) (P, BH, Tp) f32;
    dq: None at the first hop or the carried (P, BH, Tp, D) f32, updated in
    place on the card. Returns dq + dS K * scale; on the card rows at or
    past t_valid keep dq (0 at the first hop), which is what a zero dO
    gives them. CPU tensors take ring_hop_bwd_dq_plain in f32."""
    n_ring = n_ring or q.shape[0]
    if q.device.type == 'cpu':
        return ring_hop_bwd_dq_plain(q, k, v, do, lse, delta, dq, hop, t_valid, pos0, n_ring)
    _check_ring('ring_chunk_bwd_dq', q, k, v, t_valid, pos0, n_ring, do=do, lse=lse,
                delta=delta, dq=dq)
    P, BH, Tp, D = q.shape
    q, k, v, do = map(_aligned16, (q, k, v, do))
    acc = _aligned8(dq)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device) if dq is None else acc
    fn = c_function('ring_attention', 'gmt_ring_bwd_dq', 8, 8, 1)
    launch('ring_attention', fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), _ptr(acc), out.data_ptr(), P, BH, Tp, D, t_valid,
           pos0, n_ring, hop, 1.0 / math.sqrt(D))
    ring_chunk_bwd_dq.launches += 1
    return out if acc is dq else dq.copy_(out)


ring_chunk_bwd_dq.launches = 0


def ring_chunk_bwd_dkv(q, k, v, do, lse, delta, dkv, hop, t_valid, pos0=0, n_ring=None):
    """Kernel M: one ring hop's dK and dV for the P ring positions of a
    launch, onto the accumulators of the chunks they visit. do must be zero
    on padded rows (at or past t_valid), which the kernel skips. dkv: None at
    the first hop or (dk, dv), k's shape in f32, slot by slot as k (so on
    one device chunk c's accumulators stay in slot c for every hop), updated
    in place on the card. Returns (dk + dS^T Q * scale, dv + P^T dO). CPU
    tensors take ring_hop_bwd_dkv_plain in f32."""
    n_ring = n_ring or q.shape[0]
    if q.device.type == 'cpu':
        return ring_hop_bwd_dkv_plain(q, k, v, do, lse, delta, dkv, hop, t_valid, pos0, n_ring)
    dk_in, dv_in = (None, None) if dkv is None else dkv
    _check_ring('ring_chunk_bwd_dkv', q, k, v, t_valid, pos0, n_ring, do=do, lse=lse,
                delta=delta, dk=dk_in, dv=dv_in)
    P, BH, Tp, D = q.shape
    q, k, v, do = map(_aligned16, (q, k, v, do))
    if dkv is None:
        dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.empty_like(dk)
    else:
        dk, dv = _aligned8(dk_in), _aligned8(dv_in)
    dk_ptr, dv_ptr = (None, None) if dkv is None else (dk.data_ptr(), dv.data_ptr())
    fn = c_function('ring_attention', 'gmt_ring_bwd_dkv', 10, 8, 1)
    launch('ring_attention', fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dk_ptr, dv_ptr,
           dk.data_ptr(), dv.data_ptr(), P, BH, Tp, D, t_valid, pos0, n_ring, hop,
           1.0 / math.sqrt(D))
    ring_chunk_bwd_dkv.launches += 1
    if dkv is not None:  # a copy made for alignment goes back into its tensor
        dk = dk if dk is dk_in else dk_in.copy_(dk)
        dv = dv if dv is dv_in else dv_in.copy_(dv)
    return dk, dv


ring_chunk_bwd_dkv.launches = 0
