"""Sweep compile-time knobs of Kernels C, H, I, A, B, K, L, M and F on the card.

    python -m generative_models_tpu_torch.ops.knob_sweep [--out FILE] [--only SRC,...]

Each variant is a copy of ops/csrc/ with knob lines rewritten: Kernel C's
register cap at D=32 (FwdPlan's MINB, blocks an SM) and K/V tile depth
(SROWS) in attention.cu; Kernel H's register cap on its 16-byte route
(HM_MINB), its dW tile (HM_BM, HM_BN), a warp's patch of it (HM_WM, HM_WN)
and its staged depth of K (HM_KC) in masked_dense.cu; Kernel I's cp.async
stages (I8_STAGES) in int8.cu; in decode_fused.cu Kernel A's rows and
columns a block (LM_TILE: LM_ROWS, LM_COLS) and Kernel B's weight-tile depth
(BT_KC), and, at the call, B's cluster size at C=256 (cluster_c256:
plan_block_tail's 16 or 8); in ring_attention.cu the streamed-tile depth
at D=32 of Kernels K, L and M (K_SROWS, L_SROWS, M_SROWS) and their
register caps at D=32 (K_MINB_D32, L_MINB_D32, M_MINB_D32, blocks an SM),
the three kernels' knobs moved together in each variant; in quantize.cu
Kernel F's 16-row strips a block (VQ_WM), its warps along the codes and
codes a warp (VQ_WARP: VQ_WN, VQ_CW), its register cap (VQ_MINB, blocks
an SM) and the depth of its copy ring (VQ_STAGES); and a control, F's dot
as its hi.hi product alone (VQ_DOT: one tf32 product, not 3xTF32).
Every variant is built by nvcc (all at once, ptxas's registers and spills
kept), launched at the main paths' shapes (pixel_transformer's
(64,4,784,32) and long T (1,4,2048,32) for C; made's dW at
hidden_size=2048, (2048,64) x (64,2048) and (784,64) x (64,2048), for H;
made's three w8a8 products at hidden_size=1024 and pixel_transformer's fc2
for I; the decode step's four products at B=64 for A and the step at C=128
and C=256 for B; the seq:4 ring's first and carry hops for L; vqvae's training and evaluate
batches and a 1024-code book for F), compared
bitwise with the shipped kernel through its wrapper, held against the plain
version within chip_smoke.py's tolerances (F's indices by its tie rule; the
run fails if any case misses, or if a control, a variant that sets a
knob of CONTROLS, misses at none of its shapes), and timed as device time from
torch.profiler's CUDA trace, for H, I, A, B, K, L, M and F also with L2
flushed before each launch. Prints one JSON
line a variant and writes them all to --out. Needs a card.
"""

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from generative_models_tpu_torch.ops.common import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

SWEEP_DIR = BUILD_DIR.parent / 'knob_sweep'

# knob -> (source, regex of its line, the line with {} for each value)
KNOBS = {
    'MINB_D32': ('attention', r'static constexpr int MINB = DP == 32 \? \d+ : 1;',
                 'static constexpr int MINB = DP == 32 ? {} : 1;'),
    'SROWS': ('attention', r'static constexpr int SROWS = [^;]+;',
              'static constexpr int SROWS = {};'),
    'HM_TILE': ('masked_dense', r'constexpr int HM_BM = \d+, HM_BN = \d+;',
                'constexpr int HM_BM = {}, HM_BN = {};'),
    'HM_WARP': ('masked_dense', r'constexpr int HM_WM = \d+, HM_WN = \d+;',
                'constexpr int HM_WM = {}, HM_WN = {};'),
    'HM_KC': ('masked_dense', r'constexpr int HM_KC = \d+;', 'constexpr int HM_KC = {};'),
    'HM_MINB': ('masked_dense', r'constexpr int HM_MINB = \d+,', 'constexpr int HM_MINB = {},'),
    'I8_STAGES': ('int8', r'constexpr int I8_STAGES = \d+;', 'constexpr int I8_STAGES = {};'),
    'BT_KC': ('decode_fused', r'constexpr int BT_KC = \d+, BT_NC = 64;',
              'constexpr int BT_KC = {}, BT_NC = 64;'),
    'LM_TILE': ('decode_fused', r'constexpr int LM_ROWS = \d+, LM_COLS = \d+;',
                'constexpr int LM_ROWS = {}, LM_COLS = {};'),
    'K_SROWS': ('ring_attention', r'K_SROWS_D32 = \d+,', 'K_SROWS_D32 = {},'),
    'K_MINB_D32': ('ring_attention', r'K_MINB_D32 = \d+;', 'K_MINB_D32 = {};'),
    'L_SROWS': ('ring_attention', r'L_SROWS_D32 = \d+,', 'L_SROWS_D32 = {},'),
    'L_MINB_D32': ('ring_attention', r'L_MINB_D32 = \d+;', 'L_MINB_D32 = {};'),
    'M_SROWS': ('ring_attention', r'M_SROWS_D32 = \d+,', 'M_SROWS_D32 = {},'),
    'M_MINB_D32': ('ring_attention', r'M_MINB_D32 = \d+;', 'M_MINB_D32 = {};'),
    'VQ_WM': ('quantize', r'constexpr int VQ_WM = \d+;', 'constexpr int VQ_WM = {};'),
    'VQ_WARP': ('quantize', r'constexpr int VQ_WN = \d+, VQ_CW = \d+;',
                'constexpr int VQ_WN = {}, VQ_CW = {};'),
    'VQ_MINB': ('quantize', r'constexpr int VQ_MINB = \d+;', 'constexpr int VQ_MINB = {};'),
    'VQ_STAGES': ('quantize', r'constexpr int VQ_STAGES = \d+;', 'constexpr int VQ_STAGES = {};'),
    'VQ_DOT': ('quantize', r'const float dot = [^;]+;', 'const float dot = {};'),
}
CALL_KNOBS = ('cluster_c256',)  # set at the call, not in the source
# knobs that make a control: a lower precision the plain-version check must
# catch, so a variant that sets one must miss at some shape
CONTROLS = ('VQ_DOT',)

# C: 64-key tiles (as shipped) or 32, by register cap; H: the shipped 64 x
# 128 tile (32 x 32 a warp, 64 deep) by register cap, then tiles that read
# the f32 operands fewer times (each a tile is read once for every tile
# column of dW, each b tile once for every tile row)
_C = dict(SROWS='DP > 64 ? 32 : 64', MINB_D32=4)
_C32 = 'DP == 32 ? 32 : DP > 64 ? 32 : 64'  # 32-key tiles at D=32 only
_H = dict(HM_TILE=(64, 128), HM_WARP=(32, 32), HM_KC=64, HM_MINB=2)
# K, L and M: 64-row streamed tiles and 4, 6 and 4 blocks an SM at D=32
# (as shipped), by register cap, then 32-row tiles;
# the three are separate kernels in one library, so each variant moves all
# three
_R = dict(K_SROWS=64, K_MINB_D32=5, L_SROWS=64, L_MINB_D32=6, M_SROWS=64, M_MINB_D32=4)
_R32 = dict(K_SROWS=32, L_SROWS=32, M_SROWS=32)
# F: one 16-row strip a block, 4 warps of 16 codes, 2 blocks an SM, a
# ring of 2 (as shipped); then 2 and 4 strips a block, other warp splits of
# a K-tile, the register cap and the ring's depth; last the control, one
# tf32 product (hi.hi) where F sums three
_F = dict(VQ_WM=1, VQ_WARP=(4, 16), VQ_MINB=2, VQ_STAGES=2)
VARIANTS = (
    [('attention', dict(_C, **kw)) for kw in (
        {}, dict(MINB_D32=3), dict(MINB_D32=5), dict(SROWS=_C32),
        dict(SROWS=_C32, MINB_D32=5), dict(SROWS=_C32, MINB_D32=6))]
    + [('masked_dense', dict(_H, **kw)) for kw in (
        {}, dict(HM_MINB=3), dict(HM_MINB=4), dict(HM_TILE=(128, 64)),
        dict(HM_TILE=(128, 128), HM_WARP=(32, 64), HM_KC=32),
        dict(HM_TILE=(128, 128), HM_WARP=(64, 32), HM_KC=32),
        dict(HM_TILE=(64, 256), HM_WARP=(32, 64), HM_KC=32))]
    + [('int8', dict(I8_STAGES=k)) for k in (4, 2, 3, 6)]
    + [('decode_fused', kw) for kw in (
        dict(BT_KC=64, LM_TILE=(16, 64)), dict(BT_KC=64, cluster_c256=8), dict(BT_KC=32),
        dict(BT_KC=32, cluster_c256=8), dict(LM_TILE=(16, 32)), dict(LM_TILE=(16, 128)),
        dict(LM_TILE=(32, 64)), dict(LM_TILE=(32, 128)))]
    + [('ring_attention', dict(_R, **kw)) for kw in (
        {}, dict(K_MINB_D32=4, L_MINB_D32=5, M_MINB_D32=3),
        dict(K_MINB_D32=5, L_MINB_D32=8, M_MINB_D32=5),
        dict(K_MINB_D32=6, L_MINB_D32=4, M_MINB_D32=6), _R32,
        dict(_R32, K_MINB_D32=6, L_MINB_D32=8, M_MINB_D32=6))]
    + [('quantize', dict(_F, **kw)) for kw in (
        {}, dict(VQ_WM=2), dict(VQ_WM=4, VQ_MINB=1), dict(VQ_WARP=(2, 32)),
        dict(VQ_WARP=(8, 8)), dict(VQ_WARP=(2, 16)), dict(VQ_MINB=4), dict(VQ_MINB=3),
        dict(VQ_STAGES=3), dict(VQ_STAGES=4), dict(VQ_DOT='acc_hh[j][q]'))]
)


def patched_source(src, knobs):
    """ops/csrc/<src>.cu with each knob's line rewritten to its value;
    raises unless every knob is src's and its line occurs exactly once."""
    text = (CSRC / f'{src}.cu').read_text()
    for knob, value in knobs.items():
        if knob in CALL_KNOBS:
            continue
        owner, pattern, line = KNOBS[knob]
        value = value if isinstance(value, tuple) else (value,)
        text, n = re.subn(pattern, line.format(*value), text)
        if n != 1 or owner != src:
            raise RuntimeError(f'{src}.cu: knob {knob} of {owner}.cu found {n} times')
    return text


def build(variants_):
    """nvcc every variant in parallel; returns [(lib path, ptxas text)]."""
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    jobs = []
    for i, (src, knobs) in enumerate(variants_):
        d = SWEEP_DIR / f'{src}-{i}'
        d.mkdir(parents=True)
        for p in CSRC.glob('*.cuh'):
            shutil.copy(p, d / p.name)
        (d / f'{src}.cu').write_text(patched_source(src, knobs))
        lib = d / f'lib{src}.so'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(lib), str(d / f'{src}.cu')]
        jobs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    out = []
    for lib, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {lib}:\n{log}')
        out.append((lib, log))
    return out


def ptxas(log, kernels):
    """{registers, spill_stores} of each instantiation of the kernels named
    (a tuple of substrings of their entry names) in log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in kernels) else None
            if name:
                out[name] = {}
        m = re.search(r'(\d+) bytes spill stores', line)
        if m and name:
            out[name]['spill_stores'] = int(m.group(1))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            out[name]['registers'] = int(m.group(1))
    return out


def device_ms(fn, kernel, iters, flush=None):
    """Mean device ms of the kernel named kernel over iters calls of fn (each
    after a write of flush, where given), from torch.profiler's CUDA trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events() if kernel in e.name]
        if us:
            return sum(us) / 1e3 / len(us)
    raise AssertionError(f'the profiler saw no {kernel} events')


def outside(got, ref, atol, rtol):
    """Elements of got outside atol + rtol * |ref| (or not finite)."""
    return int((~((got - ref).abs() <= atol + rtol * ref.abs())).sum())


def run_attention(lib, rng, dev):
    from generative_models_tpu_torch.ops.attention import (
        causal_attention_fwd, causal_attention_plain,
    )

    fn = lib.gmt_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    out = {}
    for shape in ((64, 4, 784, 32), (1, 4, 2048, 32)):
        B, H, T, D = shape
        q, k, v = (torch.tensor(rng.randn(*shape), dtype=torch.float32, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        o = torch.empty(shape, dtype=torch.float32, device=dev)
        lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)

        def call():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    B * H, T, D, 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f'flash_fwd launch failed ({rc})')

        call()
        ro, rl = causal_attention_fwd(q, k, v)
        po, pl = causal_attention_plain(q, k, v, dtype=torch.bfloat16)
        out[str(shape)] = dict(
            bitwise_as_shipped=bool(torch.equal(o, ro) and torch.equal(lse, rl)),
            outside_tol=outside(ro, po, 2e-5, 2e-4) + outside(rl, pl, 2e-5, 2e-4),
            ms=device_ms(call, 'flash_fwd_kernel', 20))
        del po, pl
    return out


def run_masked_dense(lib, rng, dev):
    from generative_models_tpu_torch.ops.masked_dense import (
        mask_out_matmul, mask_out_matmul_plain,
    )

    fn = lib.gmt_mask_out_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    flush = torch.empty(64 << 20, device=dev)  # 256 MB of f32, past the 50 MB L2
    out = {}
    for M, K, N in ((2048, 64, 2048), (784, 64, 2048)):
        a = torch.tensor(rng.randn(K, M), dtype=torch.float32, device=dev)
        b = torch.tensor(rng.randn(K, N), dtype=torch.float32, device=dev)
        m = torch.tensor(rng.rand(M, N) < 0.5, device=dev).to(torch.uint8)
        dw = torch.empty((M, N), dtype=torch.float32, device=dev)

        def call():
            rc = fn(a.data_ptr(), b.data_ptr(), m.data_ptr(), dw.data_ptr(), M, K, N,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f'mask_out_matmul launch failed ({rc})')

        call()
        ref = mask_out_matmul(a, b, m)
        out[f'({M},{K})x({K},{N})'] = dict(
            bitwise_as_shipped=bool(torch.equal(dw, ref)),
            outside_tol=outside(ref, mask_out_matmul_plain(a.t(), b, m), 1e-3, 1e-3)
            + int(ref[m == 0].count_nonzero()),
            ms=device_ms(call, 'mask_out_matmul_kernel', 200),
            ms_l2_cold=device_ms(call, 'mask_out_matmul_kernel', 50, flush))
    return out


def run_int8(lib, rng, dev, knobs):
    from generative_models_tpu_torch.ops.common import plan_split_k
    from generative_models_tpu_torch.ops.int8 import (
        INT8_GEMM_BN, INT8_GEMM_KT, int8_gemm, int8_gemm_plain,
    )

    fn = lib.gmt_int8_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    flush = torch.empty(64 << 20, device=dev)
    out = {}
    for M, K, N in ((64, 784, 1024), (64, 1024, 1024), (64, 1024, 784), (64, 512, 128)):
        x = torch.tensor(rng.randint(-127, 128, (M, K)), dtype=torch.int8, device=dev)
        q = torch.tensor(rng.randint(-127, 128, (K, N)), dtype=torch.int8, device=dev)
        o = torch.empty((M, N), dtype=torch.int32, device=dev)
        splits, kper = plan_split_k(M, K, N, INT8_GEMM_BN, kt=INT8_GEMM_KT)

        def call():
            rc = fn(x.data_ptr(), q.data_ptr(), o.data_ptr(), M, K, N, splits, kper,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f'int8_gemm launch failed ({rc})')

        call()
        out[f'({M},{K})x({K},{N})'] = dict(
            bitwise_as_shipped=bool(torch.equal(o, int8_gemm(x, q))),
            outside_tol=int((o != int8_gemm_plain(x, q)).sum()),
            ms=device_ms(call, 'int8_gemm_kernel', 200),
            ms_l2_cold=device_ms(call, 'int8_gemm_kernel', 50, flush))
    return out


def run_decode_fused(lib, rng, dev, knobs):
    from generative_models_tpu_torch.ops.decode_fused import (
        block_tail, block_tail_plain, ln_matmul, ln_matmul_plain, plan_block_tail,
    )

    flush = torch.empty(64 << 20, device=dev)
    bf, B = torch.bfloat16, 64
    f32 = lambda *s, scale=1.0: torch.tensor(rng.randn(*s) * scale, dtype=torch.float32,
                                             device=dev)
    out = {}
    fa = lib.gmt_ln_matmul
    fa.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for C, N in ((128, 384), (128, 1), (256, 768), (256, 64)):
        x, s, b = f32(B, C), 1 + f32(C, scale=0.1), f32(C, scale=0.1)
        w, bias = f32(C, N, scale=C ** -0.5).to(bf), f32(N, scale=0.1)
        o = torch.empty((B, N), dtype=torch.float32, device=dev)

        def call_a():
            rc = fa(x.data_ptr(), s.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    o.data_ptr(), B, C, N, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f'ln_matmul launch failed ({rc})')

        call_a()
        out[f'A ({B},{C})->{N}'] = dict(
            bitwise_as_shipped=bool(torch.equal(o, ln_matmul(x, s, b, w, bias))),
            outside_tol=outside(o, ln_matmul_plain(x, s, b, w, bias, dtype=bf), 1e-2, 1e-2),
            ms=device_ms(call_a, 'ln_matmul', 200),
            ms_l2_cold=device_ms(call_a, 'ln_matmul', 50, flush))
    fn = lib.gmt_block_tail
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for C in (128, 256):
        lp = dict(
            wproj=f32(C, C, scale=C ** -0.5).to(bf), bproj=f32(C, scale=0.1),
            ln2_scale=1 + f32(C, scale=0.1), ln2_bias=f32(C, scale=0.1),
            wfc1=f32(C, 4 * C, scale=C ** -0.5).to(bf), bfc1=f32(4 * C, scale=0.1),
            wfc2=f32(4 * C, C, scale=(4 * C) ** -0.5).to(bf), bfc2=f32(C, scale=0.1),
        )
        x, y = f32(B, C), f32(B, C)
        o = torch.empty_like(x)
        plan = plan_block_tail(C, knobs.get('cluster_c256') if C == 256 else None)
        names = ('wproj', 'bproj', 'ln2_scale', 'ln2_bias', 'wfc1', 'bfc1', 'wfc2', 'bfc2')

        def call():
            rc = fn(x.data_ptr(), y.data_ptr(), *(lp[k].data_ptr() for k in names), o.data_ptr(),
                    B, C, plan.cluster, plan.P, plan.F, plan.slots,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f'block_tail launch failed ({rc})')

        call()
        out[f'C={C}'] = dict(
            plan=plan._asdict(), bitwise_as_shipped=bool(torch.equal(o, block_tail(x, y, lp))),
            outside_tol=outside(o, block_tail_plain(x, y, lp, dtype=bf), 1e-2, 1e-2),
            ms=device_ms(call, 'block_tail_kernel', 200),
            ms_l2_cold=device_ms(call, 'block_tail_kernel', 50, flush))
    return out


def run_ring_attention(lib, rng, dev, knobs):
    """K, L and M at the seq:4 ring's carry hop (in place, as the ring runs
    them) and first hop, against the shipped wrappers (bitwise) and the
    plain versions (K at atol 2e-5 + rtol 2e-4, L and M at 1e-4 + 1e-3)."""
    from generative_models_tpu_torch.ops import attention as att
    from generative_models_tpu_torch.parallel.ring_attention import _chunks, ring_forward

    flush = torch.empty(64 << 20, device=dev)
    bf, n, (B, H, T, D) = torch.bfloat16, 4, (64, 4, 784, 32)
    Tl = T // n
    Tp = att._pick_chunk_blk(Tl)[1]
    q, k, v, do = (_chunks(torch.tensor(rng.randn(B, H, T, D), dtype=torch.float32, device=dev),
                           n, Tp, bf) for _ in range(4))
    o, lse = ring_forward(q, k, v, Tl)
    delta = (do.float() * o).sum(-1)
    bwd = (q, k, v, do, lse, delta)
    carries = dict(fwd=att.ring_chunk_fwd(q, k, v, None, 0, Tl),
                   dq=(att.ring_chunk_bwd_dq(*bwd, None, 0, Tl),),
                   dkv=att.ring_chunk_bwd_dkv(*bwd, None, 0, Tl))
    clone = lambda xs: tuple(u.clone() for u in xs)
    # (name, entry, kernel in the trace, inputs, tolerance, shipped, plain):
    # shipped(carry, hop) and plain(carry, hop) return tuples
    specs = (
        ('fwd', 'gmt_ring_fwd', 'ring_fwd_kernel', (q, k, v), (2e-5, 2e-4),
         lambda c, hop: att.ring_chunk_fwd(q, k, v, c, hop, Tl),
         lambda c, hop: att.ring_hop_fwd_plain(q, k, v, c, hop, Tl, dtype=bf)),
        ('dq', 'gmt_ring_bwd_dq', 'ring_bwd_dq_kernel', bwd, (1e-4, 1e-3),
         lambda c, hop: (att.ring_chunk_bwd_dq(*bwd, c if c is None else c[0], hop, Tl),),
         lambda c, hop: (att.ring_hop_bwd_dq_plain(*bwd, c if c is None else c[0], hop, Tl,
                                                   dtype=bf),)),
        ('dkv', 'gmt_ring_bwd_dkv', 'ring_bwd_dkv_kernel', bwd, (1e-4, 1e-3),
         lambda c, hop: att.ring_chunk_bwd_dkv(*bwd, c, hop, Tl),
         lambda c, hop: att.ring_hop_bwd_dkv_plain(*bwd, c, hop, Tl, dtype=bf)),
    )
    out = {}
    for name, entry, trace, ins, (atol, rtol), shipped, plain in specs:
        fn = getattr(lib, entry)
        carry = carries[name]
        fn.argtypes = ([ctypes.c_void_p] * (len(ins) + 2 * len(carry)) + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_void_p])
        for hop in (1, 0):
            res = clone(carry)  # updated in place at the carry hop
            c_in = (None,) * len(carry) if hop == 0 else res

            def call():
                rc = fn(*(u.data_ptr() for u in ins), *(None if u is None else u.data_ptr() for u in c_in),
                        *(u.data_ptr() for u in res), n, B * H, Tp, D, Tl, 0, n, hop,
                        1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f'{entry} launch failed ({rc})')

            call()
            got = clone(res)
            c_ref = None if hop == 0 else carry
            ref = tuple(shipped(None if hop == 0 else clone(carry), hop))
            ref_plain = tuple(plain(c_ref, hop))
            out[f'{trace} seq:4 hop {hop}'] = dict(
                bitwise_as_shipped=all(torch.equal(a, b) for a, b in zip(got, ref)),
                outside_tol=sum(outside(a, b, atol, rtol) for a, b in zip(got, ref_plain)),
                ms=device_ms(call, trace, 50),
                ms_l2_cold=device_ms(call, trace, 20, flush))
    return out


def run_quantize(lib, rng, dev, knobs):
    """F at vqvae's training and evaluate batches and at a 1024-code book,
    against the shipped wrapper (bitwise: one-hot and index) and the plain
    version (indices equal but for ties, vq_ties_missed)."""
    from generative_models_tpu_torch.ops.quantize import vq_one_hot, vq_one_hot_plain, vq_ties_missed

    fn = lib.gmt_vq_one_hot
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    flush = torch.empty(64 << 20, device=dev)
    out = {}
    for N, K, D in ((3136, 64, 64), (392, 64, 64), (12544, 1024, 64)):
        z = torch.tensor(rng.randn(N, D), dtype=torch.float32, device=dev)
        e = torch.tensor(rng.randn(K, D), dtype=torch.float32, device=dev)
        oh = torch.empty((N, K), dtype=torch.float32, device=dev)
        idx = torch.empty((N,), dtype=torch.int64, device=dev)

        def call():
            rc = fn(z.data_ptr(), e.data_ptr(), oh.data_ptr(), idx.data_ptr(), N, K, D,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f'vq_one_hot launch failed ({rc})')

        call()
        ref_oh, ref_idx = vq_one_hot(z, e)
        out[f'z ({N},{D}) x e ({K},{D})'] = dict(
            bitwise_as_shipped=bool(torch.equal(oh, ref_oh) and torch.equal(idx, ref_idx)),
            outside_tol=vq_ties_missed(idx, vq_one_hot_plain(z, e)[1], z, e),
            ms=device_ms(call, 'vq_one_hot_kernel', 100),
            ms_l2_cold=device_ms(call, 'vq_one_hot_kernel', 50, flush))
    return out


# per source: the kernels' names in the trace and ptxas's report, and the runner
RUNS = {
    'attention': (('flash_fwd_kernel',),
                  lambda lib, rng, dev, knobs: run_attention(lib, rng, dev)),
    'masked_dense': (('mask_out_matmul_kernel',),
                     lambda lib, rng, dev, knobs: run_masked_dense(lib, rng, dev)),
    'int8': (('int8_gemm_kernel',), run_int8),
    'decode_fused': (('ln_matmul', 'block_tail_kernel'), run_decode_fused),
    'ring_attention': (('ring_fwd_kernel', 'ring_bwd_dq_kernel', 'ring_bwd_dkv_kernel'),
                       run_ring_attention),
    'quantize': (('vq_one_hot_kernel',), run_quantize),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=str(SWEEP_DIR / 'knob_sweep.json'))
    ap.add_argument('--only', default='', help='comma-separated sources to sweep (default all)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('knob_sweep: torch.cuda.is_available() is False; this needs a GPU', file=sys.stderr)
        return 1
    from generative_models_tpu_torch.ops.common import resolve_device

    dev = resolve_device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    only = set(filter(None, args.only.split(',')))
    vs = [v for v in VARIANTS if not only or v[0] in only]
    built = build(vs)
    rows = []
    for (src, knobs), (lib_path, log) in zip(vs, built):
        lib = ctypes.CDLL(str(lib_path))
        rng = np.random.RandomState(0)
        kernels, run = RUNS[src]
        row = dict(source=src, knobs=knobs, control=bool(set(knobs) & set(CONTROLS)),
                   ptxas=ptxas(log, kernels), shapes=run(lib, rng, dev, knobs), device=smi)
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1) + '\n')
    bad = [s for r in rows if not r['control'] for s in r['shapes'].values() if s['outside_tol']]
    caught = [r for r in rows if r['control'] and any(s['outside_tol'] for s in r['shapes'].values())]
    n_controls = sum(r['control'] for r in rows)
    if bad or len(caught) < n_controls:
        print(f'knob_sweep: {len(bad)} cases miss the plain version; '
              f'{n_controls - len(caught)} controls miss it nowhere', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
