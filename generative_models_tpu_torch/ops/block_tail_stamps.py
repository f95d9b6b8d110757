"""Where a launch of Kernel B spends its time, on the card.

    python -m generative_models_tpu_torch.ops.block_tail_stamps [--out FILE]

Builds a copy of ops/csrc/decode_fused.cu with %globaltimer stamps at
fixed source lines (ANCHORS: each found exactly once, or the build stops),
taken by thread 0 (a consumer warp's lane 0) of each block, into
build/block_tail_stamps/. Launches it at the decode step's two serving
widths, C=128 over 8 blocks and C=256 over 16 (B=64, plan_block_tail's
plans), three launches back to back as a decode loop makes them, 30 times,
and prints for each width the median nanoseconds from the block's first
instruction to each stamp, for the first cluster's block 0 and the latest
block of that cluster, as one JSON line; with --out, also to a file. The
stamps add about 40 ns each. Needs a card.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from generative_models_tpu_torch.ops.common import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

OUT_DIR = BUILD_DIR.parent / 'block_tail_stamps'
MAX_STAMPS = 64
# (a line of decode_fused.cu's Kernel B, its stamp, the stamp before or
# after the line); 'tile' fires once a weight tile
ANCHORS = (
    ('  const int rank = (int)cooperative_groups::this_cluster().block_rank();', 'entry',
     'after'),
    ("  bt_consumers_sync();  // y, x's slice and the vectors are in", 'inputs in', 'after'),
    ('  bt_mbar_wait(&full[slot], (t / slots) & 1);', 'tile', 'after'),
    ('      bt_layernorm<VEC, VPL>(h1, Cp, C, ls_s, lb_s, ys, ldy);', 'proj, barrier 1',
     'before'),
    ('      bt_layernorm<VEC, VPL>(h1, Cp, C, ls_s, lb_s, ys, ldy);', 'LN2', 'after'),
    ("    bt_consumers_sync();  // g (fc1's operand) complete; then hid (fc2's)", 'stage done',
     'after'),
    ("  // this block's columns: the ranks' partials summed in rank order,", 'barrier 2',
     'before'),
    ('    out[(size_t)m * C + p0 + c] = h1[r * Cp + p0 + c] + (sum + b2_s[c]);', 'reduced',
     'after'),
)
STAMP = ('{{ unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
         'if (threadIdx.x == 0 && bt_k < {max}) {{ '
         'const int b_ = blockIdx.y * gridDim.x + blockIdx.x; '
         'bt_stamps[b_ * {max} + bt_k] = t_; bt_labels[b_ * {max} + bt_k++] = {label}; }} }}\n')


def stamped_source():
    """decode_fused.cu with the stamps in; raises unless every anchor line
    occurs exactly once."""
    text = (CSRC / 'decode_fused.cu').read_text()
    lines = text.split('\n')
    for i, (line, name, where) in enumerate(ANCHORS):
        at = [k for k, l in enumerate(lines) if l == line]
        if len(at) != 1:
            raise RuntimeError(f'decode_fused.cu: anchor {name!r} found {len(at)} times')
        stamp = STAMP.format(max=MAX_STAMPS, label=i).rstrip('\n')
        if name == 'entry':
            stamp = '  if (threadIdx.x == 0) bt_k = 0;\n' + stamp
        lines.insert(at[0] + (where == 'after'), stamp)
    head = '// ---------------------------------------------------------------- Kernel B'
    text = '\n'.join(lines)
    if text.count(head) != 1:
        raise RuntimeError('decode_fused.cu: Kernel B heading not found once')
    grid = 4096 * MAX_STAMPS
    return text.replace(head, f'__device__ unsigned long long bt_stamps[{grid}];\n'
                              f'__device__ int bt_labels[{grid}];\n'
                              'static __shared__ int bt_k;\n'
                              'extern "C" int bt_read(void* t, void* l, size_t n) {\n'
                              '  cudaMemcpyFromSymbol(l, bt_labels, n * sizeof(int));\n'
                              '  return cudaMemcpyFromSymbol(t, bt_stamps, n * 8);\n}\n' + head)


def build():
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for p in CSRC.glob('*.cuh'):
        (OUT_DIR / p.name).write_text(p.read_text())
    (OUT_DIR / 'decode_fused.cu').write_text(stamped_source())
    lib = OUT_DIR / 'libdecode_fused_stamped.so'
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(lib), str(OUT_DIR / 'decode_fused.cu')],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f'nvcc failed:\n{r.stdout}{r.stderr}')
    return ctypes.CDLL(str(lib))


def stamps(lib, C, dev, reps=30):
    """{'block0': [[stamp, ns], ...], 'latest': [...]} for the first cluster
    at width C, medians over reps."""
    from generative_models_tpu_torch.ops.decode_fused import plan_block_tail

    rng = np.random.RandomState(0)
    f32 = lambda *s, scale=1.0: torch.tensor(rng.randn(*s) * scale, dtype=torch.float32,
                                             device=dev)
    bf, B = torch.bfloat16, 64
    ws = [f32(C, C, scale=C ** -0.5).to(bf), f32(C, scale=0.1), 1 + f32(C, scale=0.1),
          f32(C, scale=0.1), f32(C, 4 * C, scale=C ** -0.5).to(bf), f32(4 * C, scale=0.1),
          f32(4 * C, C, scale=(4 * C) ** -0.5).to(bf), f32(C, scale=0.1)]
    x, y = f32(B, C), f32(B, C)
    out = torch.empty_like(x)
    plan = plan_block_tail(C)
    fn = lib.gmt_block_tail
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.bt_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    n = plan.cluster * MAX_STAMPS
    runs, labels = [], None
    for _ in range(reps):
        for _ in range(3):
            rc = fn(x.data_ptr(), y.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(), B, C,
                    plan.cluster, plan.P, plan.F, plan.slots,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f'block_tail launch failed ({rc})')
        torch.cuda.synchronize()
        t = (ctypes.c_ulonglong * n)()
        lab = (ctypes.c_int * n)()
        lib.bt_read(t, lab, n)
        a = np.array(t, dtype=np.int64).reshape(plan.cluster, MAX_STAMPS)
        labels = np.array(lab).reshape(plan.cluster, MAX_STAMPS)
        runs.append(a - a[:, :1])
    med = np.median(np.stack(runs), axis=0)
    latest = int(np.argmax(med.max(axis=1)))
    # a slot not written in this launch still holds 0: negative past the entry
    row = lambda b: [[ANCHORS[int(k)][1], int(v)] for k, v in zip(labels[b], med[b]) if v >= 0]
    return dict(C=C, plan=plan._asdict(), block0=row(0), latest_block=latest,
                latest=row(latest))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default='')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('block_tail_stamps: torch.cuda.is_available() is False; this needs a GPU',
              file=sys.stderr)
        return 1
    from generative_models_tpu_torch.ops.common import resolve_device

    dev = resolve_device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lib = build()
    rows = [dict(stamps(lib, C, dev), device=smi) for C in (128, 256)]
    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
