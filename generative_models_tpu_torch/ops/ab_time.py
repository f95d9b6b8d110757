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
C=256, B=64), C (causal_attention_fwd), E (flash_bwd_dq) and D
(flash_bwd_dkv) at pixel_transformer's (64,4,784,32) and vqvae's
(64,8,49,32), K (ring_chunk_fwd), L (ring_chunk_bwd_dq) and M
(ring_chunk_bwd_dkv) at the seq:4 ring's carry hop and first hop (BH=256,
T=784, D=32), and F (vq_one_hot) at vqvae's training and evaluate batches
and a 1024-code book. The outputs are checked bitwise equal between the
trees, but for those of kernels whose arithmetic a tree may change, which
are each held against the plain version: K and M within chip_smoke.py's
tolerances (TOL), F's indices, read from its one-hot, by its tie rule
(TIE_RULE: ops/quantize.py vq_ties_missed); this tree's must hold, the
other's count is reported. The launches are timed as
device time from torch.profiler's CUDA trace, in the order this, other,
other, this, each round. Prints one JSON line a shape: both trees' medians
and their ratio. Two trees on two cards (or two calls) are not comparable:
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
    'causal_attention_fwd': ('attention', 'flash_fwd_kernel'),
    'flash_bwd_dq': ('attention_bwd', 'flash_bwd_dq_kernel'),
    'flash_bwd_dkv': ('attention_bwd', 'flash_bwd_dkv_kernel'),
    'ring_chunk_fwd': ('ring_attention', 'ring_fwd_kernel'),
    'ring_chunk_bwd_dq': ('ring_attention', 'ring_bwd_dq_kernel'),
    'ring_chunk_bwd_dkv': ('ring_attention', 'ring_bwd_dkv_kernel'),
    'vq_one_hot': ('quantize', 'vq_one_hot_kernel'),
}
# kernels held against their plain versions rather than bitwise to the
# other tree: (atol, rtol) of the ring's K and M, redesigned after their
# first designs (chip_smoke.py's tolerances); and F, whose indices are held
# by its tie rule
TOL = {'ring_chunk_fwd': (2e-5, 2e-4), 'ring_chunk_bwd_dkv': (1e-4, 1e-3)}
TIE_RULE = ('vq_one_hot',)
ATT_SHAPES = ((64, 4, 784, 32), (64, 8, 49, 32))
VQ_SHAPES = ((3136, 64, 64), (392, 64, 64), (12544, 1024, 64))


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
    """K, L and M at the seq:4 ring's carry hop and first hop, as calls()
    gives them."""
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
    dq0 = att.ring_chunk_bwd_dq(q, k, v, do, lse, delta, None, 0, Tl)
    dkv = att.ring_chunk_bwd_dkv(q, k, v, do, lse, delta, None, 0, Tl)
    scale, ints = 1.0 / math.sqrt(D), (n, B * H, Tp, D, Tl, 0, n)
    ptr = lambda u: None if u is None else u.data_ptr()
    bwd_in = (q, k, v, do, lse, delta)
    out = []
    for hop in (1, 0):
        shape = f'seq:4 hop {hop}'
        c_fwd = None if hop == 0 else carry
        c_dkv = None if hop == 0 else dkv
        # (wrapper, entry, pointers, carry in, its outputs' templates, plain)
        specs = (('ring_chunk_fwd', 'gmt_ring_fwd', (q, k, v), c_fwd or (None,) * 3, carry,
                  lambda: att.ring_hop_fwd_plain(q, k, v, c_fwd, hop, Tl, dtype=bf)),
                 ('ring_chunk_bwd_dq', 'gmt_ring_bwd_dq', bwd_in, (None if hop == 0 else dq0,),
                  (dq0,), None),
                 ('ring_chunk_bwd_dkv', 'gmt_ring_bwd_dkv', bwd_in, c_dkv or (None,) * 2, dkv,
                  lambda: att.ring_hop_bwd_dkv_plain(*bwd_in, c_dkv, hop, Tl, dtype=bf)))
        for kernel, entry, ins, c_in, like, plain in specs:
            if kernel not in only:
                continue
            fns, outs = {}, {}
            for tag in libs:
                fn = _entry(libs, tag, 'ring_attention', entry, len(ins) + 2 * len(like), 8, 1)
                res = tuple(torch.empty_like(u) for u in like)
                outs[tag] = res
                fns[tag] = _launcher(fn, (*ins, *c_in, *res), *map(ptr, ins), *map(ptr, c_in),
                                     *map(ptr, res), *ints, hop, scale)
            out.append((kernel, shape, fns, outs, None if plain is None else tuple(plain())))
    return out


def _attention_calls(libs, dev, rng, only):
    """C, E and D at pixel_transformer's and vqvae's attention shapes."""
    from generative_models_tpu_torch.ops import attention as att

    out = []
    for B, H, T, D in ATT_SHAPES:
        if not {'causal_attention_fwd', 'flash_bwd_dq', 'flash_bwd_dkv'} & set(only):
            break
        q, k, v, do = (torch.tensor(rng.randn(B, H, T, D), dtype=torch.float32, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = att.causal_attention_fwd(q, k, v)
        _, delta = att.flash_bwd_dq(q, k, v, o, lse, do)
        ints, scale = (B * H, T, D), 1.0 / math.sqrt(D)
        rows = torch.empty_like(lse)
        specs = (('causal_attention_fwd', 'attention', 'gmt_flash_fwd', (q, k, v), (o, lse)),
                 ('flash_bwd_dq', 'attention_bwd', 'gmt_flash_bwd_dq', (q, k, v, o, do, lse),
                  (rows, o)),
                 ('flash_bwd_dkv', 'attention_bwd', 'gmt_flash_bwd_dkv',
                  (q, k, v, do, lse, delta), (o, o)))
        for kernel, src, entry, ins, like in specs:
            if kernel not in only:
                continue
            fns, outs = {}, {}
            for tag in libs:
                fn = _entry(libs, tag, src, entry, len(ins) + len(like), 3, 1)
                res = outs[tag] = tuple(torch.empty_like(u) for u in like)
                fns[tag] = _launcher(fn, (*ins, *res), *(u.data_ptr() for u in (*ins, *res)),
                                     *ints, scale)
            out.append((kernel, (B, H, T, D), fns, outs, None))
    return out


def _vq_calls(libs, dev, rng, only):
    """F at VQ_SHAPES, as calls() gives them; the index buffer is int64 for
    both trees (a tree that writes an int32 index fills its first half),
    so the trees are compared by their one-hots, and the plain version's
    part is (its index, z, e)."""
    from generative_models_tpu_torch.ops.quantize import vq_one_hot_plain

    out = []
    for N, K, D in VQ_SHAPES if 'vq_one_hot' in only else ():
        z = torch.tensor(rng.randn(N, D), dtype=torch.float32, device=dev)
        e = torch.tensor(rng.randn(K, D), dtype=torch.float32, device=dev)
        fns, outs = {}, {}
        for tag in libs:
            fn = _entry(libs, tag, 'quantize', 'gmt_vq_one_hot', 4, 3)
            oh = torch.empty((N, K), dtype=torch.float32, device=dev)
            idx = torch.empty((N,), dtype=torch.int64, device=dev)
            outs[tag] = (oh,)
            fns[tag] = _launcher(fn, (z, e, oh, idx), z.data_ptr(), e.data_ptr(), oh.data_ptr(),
                                 idx.data_ptr(), N, K, D)
        out.append(('vq_one_hot', (N, K, D), fns, outs, (vq_one_hot_plain(z, e)[1], z, e)))
    return out


def calls(libs, dev, rng, only):
    """(kernel, shape, {tree: call}, {tree: outputs}, the plain version's
    outputs for the kernels of TOL and TIE_RULE, else None) for every shape of the
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
        out.append(('masked_matmul', (M, K, N), fns, outs, None))
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
        out.append(('dequant_gemm', (M, K, N), fns, outs, None))
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
        out.append(('block_tail', (B, C), fns, outs, None))
    return (out + _attention_calls(libs, dev, rng, only) + _ring_calls(libs, dev, rng, only)
            + _vq_calls(libs, dev, rng, only))


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
    for kernel, shape, fns, outs, plain in calls(libs, dev, np.random.RandomState(0), only):
        trace = KERNELS[kernel][1]
        iters = 200 if kernel in ('masked_matmul', 'dequant_gemm', 'block_tail', 'vq_one_hot') else 20
        for fn in fns.values():
            fn()
        ms = {tag: [] for tag in fns}
        for _ in range(args.rounds):
            for tag in ('this', 'other', 'other', 'this'):
                ms[tag].append(device_ms(fns[tag], trace, iters))
        torch.cuda.synchronize()
        med = {tag: float(np.median(v)) for tag, v in ms.items()}
        a, b = (u if isinstance(u, tuple) else (u,) for u in outs.values())
        row = dict(kernel=kernel, shape=shape,
                   bitwise=all(torch.equal(x, y) for x, y in zip(a, b)),
                   max_abs_diff=max(float((x - y).abs().max()) for x, y in zip(a, b)))
        if kernel in TIE_RULE:
            from generative_models_tpu_torch.ops.quantize import VQ_TIE_REL, vq_ties_missed

            ridx, z, e = plain
            miss = {tag: vq_ties_missed(res[0].argmax(1), ridx, z, e) for tag, res in outs.items()}
            row.update(tie_rel=VQ_TIE_REL, outside_tol_vs_plain=miss)
        elif kernel in TOL:
            atol, rtol = TOL[kernel]
            miss = {tag: sum(int((~((x - y).abs() <= atol + rtol * y.abs())).sum())
                             for x, y in zip(res, plain)) for tag, res in outs.items()}
            row.update(atol=atol, rtol=rtol, outside_tol_vs_plain=miss)
        held = kernel in TOL or kernel in TIE_RULE
        row['ok'] = row['outside_tol_vs_plain']['this'] == 0 if held else row['bitwise']
        rows.append(dict(**row, ms_this=med['this'], ms_other=med['other'],
                         ratio=med['this'] / med['other'], runs=ms, device=smi))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1) + '\n')
    return 0 if all(r['ok'] for r in rows) else 1


if __name__ == '__main__':
    sys.exit(main())
