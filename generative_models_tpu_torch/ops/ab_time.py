"""Kernels G and J of this tree against the same kernels of another tree,
timed in turns in one process on the card.

    python -m generative_models_tpu_torch.ops.ab_time OTHER_REPO [--rounds N] [--out FILE]

OTHER_REPO is another checkout of this repository (say, a parent commit
unpacked with git archive). ops/csrc/masked_dense.cu and ops/csrc/int8.cu
of both trees are built by nvcc into build/ab_time/, and G (x @ (w * m) at
made's forward products at hidden_size=2048) and J (bf16(x) @ q at the
w8a16 serving products) are launched through each tree's C entry on the
same inputs, checked bitwise equal between the trees, and timed as device
time from torch.profiler's CUDA trace, in the order this, other, other,
this, each round. Prints one JSON line a shape: both trees' medians and
their ratio. Two trees on two cards (or two calls) are not comparable:
this puts both in one process. Needs a card.
"""

import argparse
import ctypes
import json
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


def build(csrc, tag):
    """{source: ctypes library} of csrc's masked_dense.cu and int8.cu."""
    jobs = {}
    for src in ('masked_dense', 'int8'):
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


def calls(libs, dev, rng):
    """(kernel, shape, {tree: call}, outputs) for every shape, both trees."""
    out = []
    for M, K, N in G_SHAPES:
        x = torch.tensor(rng.randn(M, K), dtype=torch.float32, device=dev)
        w = torch.tensor(rng.randn(K, N) * K ** -0.5, dtype=torch.float32, device=dev)
        m = torch.tensor(rng.rand(K, N) < 0.5, device=dev).to(torch.uint8)
        splits, kper = plan_split_k(M, K, N, 64)
        fns, outs = {}, {}
        for tag, ls in libs.items():
            fn = ls['masked_dense'].gmt_masked_matmul
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            o = outs[tag] = torch.empty((M, N), dtype=torch.float32, device=dev)
            fns[tag] = _launcher(fn, (x, w, m, o), x.data_ptr(), w.data_ptr(), m.data_ptr(),
                                 o.data_ptr(), M, K, N, 0, splits, kper)
        out.append(('masked_matmul', (M, K, N), fns, outs))
    for M, K, N in J_SHAPES:
        x = torch.tensor(rng.randn(M, K), dtype=torch.float32, device=dev)
        q = torch.tensor(rng.randint(-127, 128, (K, N)), dtype=torch.int8, device=dev)
        splits, kper = plan_split_k(M, K, N, 32)
        fns, outs = {}, {}
        for tag, ls in libs.items():
            fn = ls['int8'].gmt_dequant_gemm
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            o = outs[tag] = torch.empty((M, N), dtype=torch.float32, device=dev)
            fns[tag] = _launcher(fn, (x, q, o), x.data_ptr(), q.data_ptr(), o.data_ptr(), M, K, N,
                                 splits, kper)
        out.append(('dequant_gemm', (M, K, N), fns, outs))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('other', help='root of another checkout of this repository')
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
    other = Path(args.other) / 'generative_models_tpu_torch' / 'ops' / 'csrc'
    libs = {'this': build(CSRC, 'this'), 'other': build(other, 'other')}
    rows = []
    for kernel, shape, fns, outs in calls(libs, dev, np.random.RandomState(0)):
        for fn in fns.values():
            fn()
        ms = {tag: [] for tag in fns}
        for _ in range(args.rounds):
            for tag in ('this', 'other', 'other', 'this'):
                ms[tag].append(device_ms(fns[tag], f'{kernel}_kernel', 200))
        torch.cuda.synchronize()
        med = {tag: float(np.median(v)) for tag, v in ms.items()}
        a, b = outs.values()
        rows.append(dict(kernel=kernel, shape=shape, bitwise=bool(torch.equal(a, b)),
                         max_abs_diff=float((a - b).abs().max()),
                         ms_this=med['this'], ms_other=med['other'],
                         ratio=med['this'] / med['other'], runs=ms, device=smi))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1) + '\n')
    return 0 if all(r['bitwise'] for r in rows) else 1


if __name__ == '__main__':
    sys.exit(main())
