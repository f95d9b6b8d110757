"""Ring attention: causal attention with the sequence split into n chunks
around a ring, each ring position folding every visiting K/V chunk into its
queries' online softmax. Counterpart of
generative_models_tpu/parallel/ring_attention.py (_ring_fwd, _ring_bwd and
the custom_vjp around them, :46-146), reached from pixel_transformer by
--mesh=seq:N.

Each hop is one launch of a hop kernel for every ring position of this
process (ops/attention.py): Kernel K (ring_chunk_fwd) in the forward,
Kernels L (ring_chunk_bwd_dq) and M (ring_chunk_bwd_dkv) in the backward,
their plain versions on the CPU. Hop 0 is the diagonal chunk, in the init
variant; hop i folds in the chunk of ring position (p - i) mod n. The
backward takes delta = rowsum(dO * o) once, in plain torch, as the JAX
package does outside its kernel; dK and dV travel with their chunk and are
home after n hops.

Two forms of the rotation share that hop loop:
  * one card (no process group): all n ring positions lie on this device,
    chunk c in slot c, and the rotation is an index: at hop i position p
    reads chunk (p - i) mod n where it lies, and Kernel M adds into chunk
    c's dK/dV in place. Each chunk is visited by exactly one position a hop,
    so nothing races, and every sum runs in the ring's order. No K/V copy
    moves through device memory at a hop. This is what the model runs
    (parallel/mesh.py's one-card rule).
  * a process group of n ranks (group=): each rank holds its shard, its
    ring position its rank in the group, and K/V (then K/V/dK/dV) go to
    rank + 1 through dist.batch_isend_irecv, the counterpart of lax.ppermute
    with perm [(j, j + 1 mod n)]. The forward's last rotation, whose chunk
    nobody reads, is not made.
"""

import torch
import torch.nn.functional as F

from generative_models_tpu_torch.ops.attention import (
    _pick_chunk_blk, ring_chunk_bwd_dkv, ring_chunk_bwd_dq, ring_chunk_fwd,
)
from generative_models_tpu_torch.ops.common import matmul_dtype


def _chunks(x, P, Tlp, dt):
    """(B, H, P * Tl, D) -> (P, BH, Tlp, D) in dt, chunk p in slot p, each
    zero-padded along the sequence (padded query rows are sliced off;
    padded dO rows are zero, which makes their dK/dV terms exactly 0)."""
    B, H, T, D = x.shape
    Tl = T // P
    y = x.to(dt).reshape(B * H, P, Tl, D).transpose(0, 1)
    return F.pad(y, (0, 0, 0, Tlp - Tl)).contiguous()


def _unchunk(x, B, H, Tl):
    """(P, BH, Tlp, D) -> (B, H, P * Tl, D), the padding sliced off."""
    P, _, _, D = x.shape
    return x[:, :, :Tl].transpose(0, 1).reshape(B, H, P * Tl, D)


def _ring(group, P):
    """(n, pos0): the ring's size and this process's first ring position."""
    if group is None:
        return P, 0
    import torch.distributed as dist

    return dist.get_world_size(group), dist.get_rank(group)


def _rotate(group, *xs):
    """Send each of xs to the next rank of the ring and receive the previous
    rank's in its place: lax.ppermute with perm [(j, (j + 1) mod n)]."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    outs = [torch.empty_like(x) for x in xs]
    ops = []
    for x, o in zip(xs, outs):
        ops += [dist.P2POp(dist.isend, x, nxt, group), dist.P2POp(dist.irecv, o, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def ring_forward(q, k, v, t_valid, group=None):
    """The forward ring pass. q, k, v: (P, BH, Tp, D) chunks in the operand
    dtype (all n of the ring without group, this rank's one with it) ->
    (o (P, BH, Tp, D) f32, lse (P, BH, Tp) f32) over the padded rows."""
    n, pos0 = _ring(group, q.shape[0])
    carry = ring_chunk_fwd(q, k, v, None, 0, t_valid, pos0, n)
    kk, vv = k, v
    for hop in range(1, n):
        if group is not None:
            kk, vv = _rotate(group, kk, vv)
        carry = ring_chunk_fwd(q, kk, vv, carry, hop, t_valid, pos0, n)
    acc, m, l = carry
    l = l.clamp_min(1e-30)
    return acc / l[..., None], m + torch.log(l)


def ring_backward(q, k, v, o, lse, do, t_valid, group=None):
    """The backward ring pass: q, k, v, do (P, BH, Tp, D) in the operand
    dtype (do zero on padded rows), o and lse from ring_forward -> (dq, dk,
    dv), each (P, BH, Tp, D) f32, dk and dv home in their chunk's slot."""
    n, pos0 = _ring(group, q.shape[0])
    delta = (do.float() * o).sum(-1)
    dq = ring_chunk_bwd_dq(q, k, v, do, lse, delta, None, 0, t_valid, pos0, n)
    dkv = ring_chunk_bwd_dkv(q, k, v, do, lse, delta, None, 0, t_valid, pos0, n)
    kk, vv = k, v
    for hop in range(1, n):
        if group is not None:
            kk, vv, *dkv = _rotate(group, kk, vv, *dkv)
        dq = ring_chunk_bwd_dq(q, kk, vv, do, lse, delta, dq, hop, t_valid, pos0, n)
        dkv = ring_chunk_bwd_dkv(q, kk, vv, do, lse, delta, dkv, hop, t_valid, pos0, n)
    if group is not None and n > 1:
        dkv = _rotate(group, *dkv)  # after n rotations the accumulators are home
    return (dq, *dkv)


class RingAttention(torch.autograd.Function):
    """The ring's forward and backward passes as one Function, as the JAX
    package's custom_vjp pairs _ring_fwd and _ring_bwd. Takes q/k/v in any
    float dtype, casts them to the operand dtype inside and returns o in
    f32; the gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, P, group):
        B, H, T, _ = q.shape
        Tl = T // P
        Tlp = _pick_chunk_blk(Tl)[1]
        dt = matmul_dtype(q.device)
        qc, kc, vc = (_chunks(u, P, Tlp, dt) for u in (q, k, v))
        o, lse = ring_forward(qc, kc, vc, Tl, group)
        ctx.save_for_backward(qc, kc, vc, o, lse)
        ctx.shape, ctx.group = (B, H, Tl, Tlp), group
        ctx.in_dtypes = (q.dtype, k.dtype, v.dtype)
        return _unchunk(o, B, H, Tl)

    @staticmethod
    def backward(ctx, do):
        qc, kc, vc, o, lse = ctx.saved_tensors
        B, H, Tl, Tlp = ctx.shape
        doc = _chunks(do, qc.shape[0], Tlp, qc.dtype)
        grads = ring_backward(qc, kc, vc, o, lse, doc, Tl, ctx.group)
        return (*(_unchunk(g, B, H, Tl).to(dt) for g, dt in zip(grads, ctx.in_dtypes)),
                None, None)


def ring_causal_attention(q, k, v, n=None, group=None):
    """Causal attention (B, H, T, D) -> o (B, H, T, D) f32 through a ring.

    Without group: q, k, v hold the whole sequence, which n must divide, and
    the n ring positions run on this device (one launch a hop for all of
    them). With group, a torch.distributed group of n ranks: q, k, v are
    this rank's shard of the sequence, and the rank in the group is its ring
    position. Matches ops/attention.py's causal_attention (the same
    function, summed in the ring's order); differentiable through
    RingAttention."""
    if group is None:
        if not n or q.shape[2] % n:
            raise ValueError(f'ring_causal_attention: n={n} must divide T={q.shape[2]}')
        return RingAttention.apply(q, k, v, n, None)
    return RingAttention.apply(q, k, v, 1, group)
