"""Kernels of this tree against the same kernels of another tree, timed in
turns in one process on the card.

    python -m generative_models_tpu_torch.ops.ab_time OTHER_REPO [--only K,...] [--rounds N] [--out FILE]

OTHER_REPO is another checkout of this repository (say, a parent commit
unpacked with git archive). The sources of the kernels asked for (--only,
by wrapper name; default all) are built by nvcc from both trees into
build/ab_time/, and each kernel is launched through each tree's C entry on
the same inputs: G (masked_matmul: x @ (w * m) at made's forward products
at hidden_size=2048), J (dequant_gemm: bf16(x) @ q at the w8a16 serving
products), B (block_tail: the decode step's second half at C=128 and
C=256, B=64), K (ring_chunk_fwd) and M (ring_chunk_bwd_dkv) at the seq:4
ring's first hop and a carry hop (BH=256, T=784, D=32). The outputs are
checked bitwise equal between the trees and the launches timed as device
time from torch.profiler's CUDA trace, in the order this, other, other,
this, each round. Prints one JSON line a shape: both trees' medians and
their ratio. Two trees on two cards (or two calls) are not comparable:
this puts both in one process. Needs a card.
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from generative_models_tpu_torch.ops.common import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc, plan_split_k
from generative_models_tpu_torch.ops.knob_sweep import device_ms

OUT_DIR = BUILD_DIR.parent / 'ab_time'
G_SHAPES = ((64, 2048, 2048), (64, 784, 2048), (64, 2048, 784))
J_SHAPES = ((64, 128, 128), (64, 128, 512), (64, 512, 128), (64, 64, 256), (64, 256, 256),
            (64, 256, 1024), (64, 1024, 256), (64, 256, 64), (64, 784, 1024), (64, 1024, 1024),
            (64, 1024, 784))
# wrapper name -> (source, kernel name in the trace)
KERNELS = {
    'masked_matmul': ('masked_dense', 'masked_matmul_kernel'),
    'dequant_gemm': ('int8', 'dequant_gemm_kernel'),
    'block_tail': ('decode_fused', 'block_tail_kernel'),
    'ring_chunk_fwd': ('ring_attention', 'ring_fwd_kernel'),
    'ring_chunk_bwd_dkv': ('ring_attention', 'ring_bwd_dkv_kernel'),
}


def build(csrc, tag, srcs):
    """{source: ctypes library} of csrc's sources srcs."""
    jobs = {}
    for src in srcs:
        d = OUT_DIR / tag
        d.mkdir(parents=True, exist_ok=True)
        lib = d / f'lib{src}.so'
        jobs[src] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, '-o', str(lib), str(csrc / f'{src}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {tag} {src}.cu:\n{log}')
        libs[src] = ctypes.CDLL(str(lib))
    return libs


def _launcher(fn, tensors, *args):
    """fn(*args, stream) with the arguments fixed now (tensors: the ones
    whose pointers args holds, kept alive with the call); raises on an
    error."""
    def call():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f'{fn.__name__}: launch failed ({rc})')
    call.tensors = tensors
    return call


def _entry(libs, tag, src, name, n_ptr, n_int, n_float=0):
    fn = getattr(libs[tag][src], name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float] * n_float
                   + [ctypes.c_void_p])
    return fn


def _ring_calls(libs, dev, rng, only):
    """K and M at the seq:4 ring's carry hop and first hop: (kernel, shape,
    {tree: call}, {tree: outputs})."""
    from generative_models_tpu_torch.ops import attention as att
    from generative_models_tpu_torch.parallel.ring_attention import _chunks, ring_forward

    bf, n, (B, H, T, D) = torch.bfloat16, 4, (64, 4, 784, 32)
    Tl = T // n
    Tp = att._pick_chunk_blk(Tl)[1]
    q, k, v, do = (_chunks(torch.tensor(rng.randn(B, H, T, D), dtype=torch.float32, device=dev),
                           n, Tp, bf) for _ in range(4))
    o, lse = ring_forward(q, k, v, Tl)
    delta = (do.float() * o).sum(-1)
    carry = att.ring_chunk_fwd(q, k, v, None, 0, Tl)
    dkv = att.ring_chunk_bwd_dkv(q, k, v, do, lse, delta, None, 0, Tl)
    scale, ints = 1.0 / math.sqrt(D), (n, B * H, Tp, D, Tl, 0, n)
    ptr = lambda u: None if u is None else u.data_ptr()
    out = []
    for hop in (1, 0):
        shape = f'seq:4 hop {hop}'
        c_in = (None,) * 3 if hop == 0 else carry
        d_in = (None,) * 2 if hop == 0 else dkv
        if 'ring_chunk_fwd' in only:
            fns, outs = {}, {}
            for tag in libs:
                fn = _entry(libs, tag, 'ring_attention', 'gmt_ring_fwd', 9, 8, 1)
                res = outs[tag] = tuple(torch.empty_like(u) for u in carry)
                fns[tag] = _launcher(fn, (q, k, v, *c_in, *res), q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), *map(ptr, c_in), *map(ptr, res), *ints, hop,
                                     scale)
            out.append(('ring_chunk_fwd', shape, fns, outs))
        if 'ring_chunk_bwd_dkv' in only:
            fns, outs = {}, {}
            for tag in libs:
                fn = _entry(libs, tag, 'ring_attention', 'gmt_ring_bwd_dkv', 10, 8, 1)
                res = outs[tag] = tuple(torch.empty_like(u) for u in dkv)
                fns[tag] = _launcher(fn, (q, k, v, do, lse, delta, *d_in, *res), q.data_ptr(),
                                     k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                     delta.data_ptr(), *map(ptr, d_in), *map(ptr, res), *ints,
                                     hop, scale)
            out.append(('ring_chunk_bwd_dkv', shape, fns, outs))
    return out


def calls(libs, dev, rng, only):
    """(kernel, shape, {tree: call}, {tree: outputs}) for every shape of the
    kernels in only, both trees."""
    out = []
    for M, K, N in G_SHAPES if 'masked_matmul' in only else ():
        x = torch.tensor(rng.randn(M, K), dtype=torch.float32, device=dev)
        w = torch.tensor(rng.randn(K, N) * K ** -0.5, dtype=torch.float32, device=dev)
        m = torch.tensor(rng.rand(K, N) < 0.5, device=dev).to(torch.uint8)
        splits, kper = plan_split_k(M, K, N, 64)
        fns, outs = {}, {}
        for tag in libs:
            fn = _entry(libs, tag, 'masked_dense', 'gmt_masked_matmul', 4, 6)
            o = outs[tag] = torch.empty((M, N), dtype=torch.float32, device=dev)
            fns[tag] = _launcher(fn, (x, w, m, o), x.data_ptr(), w.data_ptr(), m.data_ptr(),
                                 o.data_ptr(), M, K, N, 0, splits, kper)
        out.append(('masked_matmul', (M, K, N), fns, outs))
    for M, K, N in J_SHAPES if 'dequant_gemm' in only else ():
        x = torch.tensor(rng.randn(M, K), dtype=torch.float32, device=dev)
        q = torch.tensor(rng.randint(-127, 128, (K, N)), dtype=torch.int8, device=dev)
        splits, kper = plan_split_k(M, K, N, 32)
        fns, outs = {}, {}
        for tag in libs:
            fn = _entry(libs, tag, 'int8', 'gmt_dequant_gemm', 3, 5)
            o = outs[tag] = torch.empty((M, N), dtype=torch.float32, device=dev)
            fns[tag] = _launcher(fn, (x, q, o), x.data_ptr(), q.data_ptr(), o.data_ptr(), M, K, N,
                                 splits, kper)
        out.append(('dequant_gemm', (M, K, N), fns, outs))
    for C in (128, 256) if 'block_tail' in only else ():
        from generative_models_tpu_torch.ops.decode_fused import plan_block_tail

        f32 = lambda *s, scale=1.0: torch.tensor(rng.randn(*s) * scale, dtype=torch.float32,
                                                 device=dev)
        bf, B = torch.bfloat16, 64
        ws = (f32(C, C, scale=C ** -0.5).to(bf), f32(C, scale=0.1), 1 + f32(C, scale=0.1),
              f32(C, scale=0.1), f32(C, 4 * C, scale=C ** -0.5).to(bf), f32(4 * C, scale=0.1),
              f32(4 * C, C, scale=(4 * C) ** -0.5).to(bf), f32(C, scale=0.1))
        x, y = f32(B, C), f32(B, C)
        plan = plan_block_tail(C)
        fns, outs = {}, {}
        for tag in libs:
            fn = _entry(libs, tag, 'decode_fused', 'gmt_block_tail', 11, 6)
            o = outs[tag] = torch.empty_like(x)
            fns[tag] = _launcher(fn, (x, y, *ws, o), x.data_ptr(), y.data_ptr(),
                                 *(u.data_ptr() for u in ws), o.data_ptr(), B, C, plan.cluster,
                                 plan.P, plan.F, plan.slots)
        out.append(('block_tail', (B, C), fns, outs))
    return out + _ring_calls(libs, dev, rng, only)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('other', help='root of another checkout of this repository')
    ap.add_argument('--only', default='', help='comma-separated wrapper names (default all: '
                    + ', '.join(KERNELS) + ')')
    ap.add_argument('--rounds', type=int, default=3)
    ap.add_argument('--out', default='')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('ab_time: torch.cuda.is_available() is False; this needs a GPU', file=sys.stderr)
        return 1
    from generative_models_tpu_torch.ops.common import resolve_device

    dev = resolve_device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    only = [k for k in args.only.split(',') if k] or list(KERNELS)
    unknown = set(only) - set(KERNELS)
    if unknown:
        ap.error(f'unknown kernels {sorted(unknown)}')
    srcs = sorted({KERNELS[k][0] for k in only})
    other = Path(args.other) / 'generative_models_tpu_torch' / 'ops' / 'csrc'
    libs = {'this': build(CSRC, 'this', srcs), 'other': build(other, 'other', srcs)}
    rows = []
    for kernel, shape, fns, outs in calls(libs, dev, np.random.RandomState(0), only):
        trace = KERNELS[kernel][1]
        iters = 20 if kernel.startswith('ring') else 200
        for fn in fns.values():
            fn()
        ms = {tag: [] for tag in fns}
        for _ in range(args.rounds):
            for tag in ('this', 'other', 'other', 'this'):
                ms[tag].append(device_ms(fns[tag], trace, iters))
        torch.cuda.synchronize()
        med = {tag: float(np.median(v)) for tag, v in ms.items()}
        a, b = (u if isinstance(u, tuple) else (u,) for u in outs.values())
        rows.append(dict(kernel=kernel, shape=shape,
                         bitwise=all(torch.equal(x, y) for x, y in zip(a, b)),
                         max_abs_diff=max(float((x - y).abs().max()) for x, y in zip(a, b)),
                         ms_this=med['this'], ms_other=med['other'],
                         ratio=med['this'] / med['other'], runs=ms, device=smi))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1) + '\n')
    return 0 if all(r['bitwise'] for r in rows) else 1


if __name__ == '__main__':
    sys.exit(main())
