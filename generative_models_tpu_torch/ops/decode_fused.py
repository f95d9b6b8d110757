"""Fused transformer decode-step kernels (Kernels A and B).

Counterpart of generative_models_tpu/ops/decode_fused.py. The KV-cached
sampling loop runs one decode step per token, and each step is a chain of
small (B, C) dense ops whose cost is their count, not their size. Two
kernels collapse the dense chains of a Block step:

  ln_matmul   -- pre-LN + matmul (+bias): the LN1 + fused QKV entry of a
                 Block step and the final ln_f + head, one launch each;
  block_tail  -- attention out-proj + residual + pre-LN MLP (fc1, tanh
                 GELU, fc2) + residual: one launch instead of ~8 ops.

The CUDA sources are ops/csrc/decode_fused.cu. ln_matmul multiplies on the
tensor cores, a block a 16-row strip and 64-column slice, or takes a row a
warp on the CUDA cores where N < 8, as plan_ln_matmul lays it out.
block_tail runs one thread-block cluster a 16-row strip, the weights spread
over the cluster's blocks as plan_block_tail lays them out. Each wrapper
launches its kernel for CUDA tensors (and refuses what the kernel does not
take), and runs the plain PyTorch version for CPU tensors. The plain
versions take the matmul operand dtype, so on the card they repeat the
kernel's arithmetic (bf16 operands, f32 accumulation) and isolate the
kernel in a comparison.

Weights use the JAX package's (in, out) layout, which the kernels read
coalesced along the output columns.
"""

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from generative_models_tpu_torch.ops.common import c_function, check_cuda, launch, round_up

LN_EPS = 1e-6  # flax LayerNorm's eps (torch's default is 1e-5)

# Kernel B's layout (ops/csrc/decode_fused.cu, the BT_* constants): rows a
# cluster, the rows and columns of a weight tile and its row stride, ring
# slots at most, the widest C and cluster, and a block's shared memory on
# an H100; the widest C that takes BT_CLUSTER blocks (wider takes
# BT_MAX_CLUSTER)
BT_ROWS, BT_KC, BT_NC, BT_WLD = 16, 64, 64, 72
BT_SLOT = BT_KC * BT_WLD * 2
BT_MAX_SLOTS, BT_MAX_C, BT_MAX_CLUSTER = 24, 512, 16
BT_BARRIERS = 2 * BT_MAX_SLOTS * 8  # the ring slots' full and empty mbarriers
SMEM_MAX = 232448
BT_CLUSTER, BT_NARROW_C = 8, 128
# Kernel A's layout (the LM_* constants): rows and output columns a block on
# the tensor cores, rows of w a stage, stages in flight, rows a block on the
# dot route (a row a warp), and the widest N it takes
LM_ROWS, LM_COLS, LM_KC, LM_STAGES = 16, 64, 64, 4
LM_DOT_WARPS, LM_DOT_MAX_N = 4, 7


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


class BlockTailPlan(NamedTuple):
    """Kernel B's layout for one C: `cluster` blocks a 16-row strip; block
    r owns h1's (and the output's) columns [r*P, (r+1)*P) and the hidden
    columns [r*F, (r+1)*F) (fewer or none at the end); its weight tiles
    stream through `slots` ring slots; `smem` bytes of shared memory a
    block."""
    cluster: int
    P: int
    F: int
    slots: int
    smem: int


def _cdiv(a, b):
    return -(-a // b)


def block_tail_tiles(C, P, F):
    """Weight tiles (BT_KC x BT_NC) block 0, the busiest, streams: proj's
    C x P slice, fc1's C x F slice, fc2's F x C slice."""
    nk = _cdiv(C, BT_KC)
    return nk * _cdiv(P, BT_NC) + nk * _cdiv(F, BT_NC) + _cdiv(F, BT_KC) * _cdiv(C, BT_NC)


def block_tail_smem(C, cluster, P, F, slots):
    """Shared memory of one block (the layout in decode_fused.cu): the ring
    slots' mbarriers; the bf16 rows of y, then LN2(h1); the bf16 hidden
    slice; h1's rows (f32, every block's columns); fc2's partial sums of
    this block's columns from every block; the f32 vectors (bproj's, bfc1's
    and bfc2's slices, LN2's scale and bias); the weight ring."""
    cp = round_up(C, 16)
    return (BT_BARRIERS + BT_ROWS * (cp + 8) * 2 + BT_ROWS * (F + 8) * 2 + BT_ROWS * cp * 4
            + cluster * BT_ROWS * P * 4 + (2 * P + F + 2 * cp) * 4 + slots * BT_SLOT)


@functools.cache
def plan_block_tail(C, cluster=None):
    """BlockTailPlan for width C (1 <= C <= 512) over `cluster` blocks (8
    up to C = 128, else 16: at C=256 a block's 8-way slices are 20 tiles and
    it takes 1.6x the 16-way's 12, PERF.md), slices of whole 16-column
    groups, and as many ring slots as fit (at most BT_MAX_SLOTS, and no more
    than block 0's tiles). Raises ValueError where fewer than 2 fit."""
    if cluster is None:
        cluster = BT_CLUSTER if C <= BT_NARROW_C else BT_MAX_CLUSTER
    if not 1 <= C <= BT_MAX_C or not 1 <= cluster <= BT_MAX_CLUSTER:
        raise ValueError(f'block_tail: C={C}, cluster={cluster} outside 1..{BT_MAX_C}, '
                         f'1..{BT_MAX_CLUSTER}')
    P, F = round_up(_cdiv(C, cluster), 16), round_up(_cdiv(4 * C, cluster), 16)
    room = (SMEM_MAX - block_tail_smem(C, cluster, P, F, 0)) // BT_SLOT
    slots = max(2, min(block_tail_tiles(C, P, F), BT_MAX_SLOTS, room))
    if slots > room:
        raise ValueError(f'block_tail: 2 ring slots for C={C} over {cluster} blocks do not '
                         f'fit {SMEM_MAX} bytes')
    return BlockTailPlan(cluster, P, F, slots, block_tail_smem(C, cluster, P, F, slots))


class LnMatmulPlan(NamedTuple):
    """Kernel A's launch for (B, C, N): `route` 'mma' (N >= 8: tensor cores,
    a block a `rows`-row strip and `cols`-column slice) or 'dot' (N < 8: a
    warp a row, `rows` rows a block, every column); `grid` (x, y) blocks of
    `threads`; `vec` 16-byte loads (else plain); x held in registers at
    `vpl` values a lane a row (0: read by loops, C > 256); `stages` weight
    stages resident; `smem` bytes of shared memory a block."""
    route: str
    grid: tuple
    threads: int
    rows: int
    cols: int
    vec: bool
    vpl: int
    stages: int
    smem: int


def ln_matmul_smem(C, stages):
    """Shared memory of a tensor-core block: its weight stages (LM_KC rows
    at a stride of LM_COLS + 8) and the strip's bf16 rows at a stride of C
    rounded up to 16, + 8."""
    return stages * LM_KC * (LM_COLS + 8) * 2 + LM_ROWS * (round_up(C, 16) + 8) * 2


@functools.cache
def plan_ln_matmul(B, C, N, aligned=True):
    """LnMatmulPlan of ops/csrc/decode_fused.cu's gmt_ln_matmul, which
    reckons the same: `aligned` says whether x and w start on 16 bytes.
    Raises ValueError for an empty shape, a C past what a block holds (6096)
    or more than 65535 strips."""
    if B <= 0 or C <= 0 or N <= 0:
        raise ValueError(f'ln_matmul: B={B}, C={C}, N={N} must be positive')
    vpl = 4 if C <= 128 else 8 if C <= 256 else 0
    if N <= LM_DOT_MAX_N:
        return LnMatmulPlan('dot', (_cdiv(B, LM_DOT_WARPS), 1), 32 * LM_DOT_WARPS,
                            LM_DOT_WARPS, N, False, vpl, 0, 0)
    stages = min(_cdiv(C, LM_KC), LM_STAGES)
    smem = ln_matmul_smem(C, stages)
    if smem > SMEM_MAX or _cdiv(B, LM_ROWS) > 65535:
        raise ValueError(f'ln_matmul: C={C} (at most 6096) or B={B} too large for a block '
                         f'({smem} of {SMEM_MAX} bytes)')
    vec = aligned and N % 8 == 0 and C % 4 == 0
    return LnMatmulPlan('mma', (_cdiv(N, LM_COLS), _cdiv(B, LM_ROWS)), 4 * LM_COLS, LM_ROWS,
                        LM_COLS, vec, vpl, stages, smem)


def ln_matmul(x, scale, bias, w, b):
    """LN(x) @ w + b in one kernel, laid out by plan_ln_matmul. x: (B, C)
    f32, C <= 6096; scale, bias: (C,) f32; w: (C, N) bf16 on the card;
    b: (N,) f32 -> (B, N) f32."""
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
        plan_ln_matmul(B, C, N)  # refuses what the kernel does not take
        fn = c_function('decode_fused', 'gmt_ln_matmul', 6, 3)
        launch('decode_fused', fn, x.data_ptr(), scale.data_ptr(),
               bias.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
               B, C, N)
        ln_matmul.launches += 1
    return out


ln_matmul.launches = 0

_BT_VECS = ('bproj', 'ln2_scale', 'ln2_bias', 'bfc1', 'bfc2')


def block_tail(x, y, lp):
    """The whole post-attention half of a Block step in one kernel, laid
    out by plan_block_tail. x, y: (B, C) f32, C <= 512; lp as
    block_tail_plain, weights bf16 on the card. Returns (B, C) f32."""
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
        plan = plan_block_tail(C)
        fn = c_function('decode_fused', 'gmt_block_tail', 11, 6)
        launch('decode_fused', fn, x.data_ptr(), y.data_ptr(),
               lp['wproj'].data_ptr(), lp['bproj'].data_ptr(),
               lp['ln2_scale'].data_ptr(), lp['ln2_bias'].data_ptr(),
               lp['wfc1'].data_ptr(), lp['bfc1'].data_ptr(),
               lp['wfc2'].data_ptr(), lp['bfc2'].data_ptr(), out.data_ptr(),
               B, C, plan.cluster, plan.P, plan.F, plan.slots)
        block_tail.launches += 1
    return out


block_tail.launches = 0
