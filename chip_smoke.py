#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (generative_models_tpu_torch) on one
NVIDIA GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each timed ([time] lines, and phase_sec in the summary); any
failure exits non-zero before the result lines:
  1. device  -- require CUDA (no fallback); print nvidia-smi's name and
                power limit.
  2. build   -- compile ops/csrc/*.cu (one nvcc per source, in parallel)
                and print the build seconds and ptxas's registers and
                spills of every entry function (Kernels C, E, D and L's by
                D bucket, H's and I's by their VEC flag and A's and B's by
                VEC flag and LN width also in the kernels line; fails where
                C, E or D spill at D=32 or H, I, A, B or L spills).
  3. kernels -- hold each kernel against its plain PyTorch version on the
                card at the main paths' shapes (pixel_transformer's,
                vqvae's and made's at hidden_size=2048), with seeded inputs
                and a stated tolerance; A (the decode step's LN + product)
                at its four path shapes and eleven ragged ones (B 1-70, N 7
                and 96, C 100-4096, x at an odd offset), launched twice and
                bitwise equal; Kernel F's indices must be
                identical but for ties within rounding, Kernel H exactly 0
                off its mask, and Kernel I (int8 x int8 -> int32) bitwise
                equal; I and J (the dequantizing product) at every product
                of the quantized serving paths and at four ragged shapes, I
                also at K=100000; G at six ragged ones (both layouts), H at
                five (K 1 to 200, an x at an odd offset); B (the decode
                step's second half) at both path widths, three ragged row
                counts and three ragged widths (both load routes); B, G, H,
                I and J launched twice and bitwise equal; C (the flash
                forward) and E and D (the
                backward) at the three attention shapes and nine edge
                cases of their tiling, each launched twice and bitwise
                equal;
                the ring's hop Kernels K, L and M on rings of 2, 4 and 8 at
                their first hop and at a carry hop (L launched twice and
                bitwise equal, then untimed at D 8-128, t_valid 75 and one
                rank's launch of a ring of 4), and the whole ring at 4 and 8
                against Kernels C, E and D on the full sequence.
                Time kernel, plain version and, where one PyTorch call
                computes the same function, that call, as device time
                (torch.profiler's CUDA trace) and as eager back-to-back time
                (CUDA events, host issue included).
  4. slice   -- pixel_transformer's serving path through its entry points:
                load_server at its default width, requests at serve_bs=64
                (warm, n=25, n=64 seed=7 twice, an HTTP /sample and
                /healthz), then a batch scored through the full forward.
                Every launch count is reset just before each path and read
                just after, and must equal what the path implies. Then the
                sampled tokens are teacher-forced through the kernel decode
                chain (must redraw the same tokens), the plain decode chain
                and the full forward, and a CPU f32 forward checks the card.
  5. train   -- pixel_transformer's training path: main.main at the
                default width, bs=64, on the synthetic set cut to 640/128
                images (10 steps, 2 eval batches), one epoch with a save
                each epoch. Exact launch counts of every kernel; the
                artifacts; finite metrics; eval/nlogp falling.
  6. grads   -- one batch's gradients on the card, from the trained
                model.pt, for every parameter: finite, non-zero, and within
                a bf16 tolerance of the same batch's gradients from a CPU
                f32 copy.
  7. seq_train -- phase 5 under --mesh=seq:4: attention through a ring of 4
                on the card, K 112, L and M 80 launches and no other kernel
                (sampling takes the per-op chain).
  8. seq_grads -- phase 6 for the seq_train model, the card's ring against
                an unsharded CPU f32 copy.
  9. vq_serve -- vqvae's serving path at its default width (warm, n=25,
                seed=7 twice) with exact launch counts; the seed=7 codes
                redrawn through the kernel decode chain, against the full
                prior forward and a CPU f32 prior and decoder.
  10. vq_train -- vqvae's training path through main.main, as phase 5:
                exact launch counts, artifacts, finite metrics, the test
                recon_loss falling, the perplexity in [1, vqK].
  11. vq_grads -- phase 6 for vqvae, every AE and prior parameter, and the
                count of codes the card and the CPU copy assign apart.
  12. made_serve -- made's serving path at hidden_size=2048, the width at
                which it takes the kernel route (warm, n=25, seed=7 twice):
                Kernel G 784 * 4 launches a pass and nothing else; the
                kernel route's causality, bitwise, on a random canvas; its
                logits against a CPU f32 copy.
  13. made_default -- one made pass at the default hidden_size=1024: the
                premasked route, no kernel launched.
  14. made_train -- made's training path through main.main at 2048, as
                phase 5: G 6358 and H 40 launches, artifacts, finite
                metrics, eval/nlogp falling.
  15. made_grads -- phase 6 for made, against a CPU copy on the
                fold-the-mask route; dW exactly 0 off the mask on both.
  16. quant_serve -- --quantize serving of each model at its default width
                (pixel_transformer, vqvae, made at hidden_size=1024), w8a8
                and w8a16, through load_server (warm, seed=7 twice):
                Kernel I (w8a8) or J (w8a16) once a quantized Linear or
                masked layer a step, nothing else; the /healthz fields; the
                request redrawn through the quantized chain; the card's
                int8 table bitwise equal to a CPU copy's; teacher-forced
                quantized logits against a CPU f32 copy of the unquantized
                chain (relative error < 0.05), against the card's
                unquantized chain (reported), that chain against the CPU f32
                one (reported), and against a CPU copy of the same quantized
                chain; made's causality under w8a16, bitwise, and under
                w8a8 the logits that move (one absmax scale a row sees
                every unit).
  17. profile -- device time by kernel over one request and one train step
                of each model, one pixel_transformer scoring forward, one
                seq:4 train step, one quantized request of vqvae and of made
                in each mode, and 32 decode steps of a quantized
                pixel_transformer request in each mode.
Then the kernels line, the nvidia-smi line and, last, the device line.

Imports nothing of JAX or of the JAX package.
"""

import itertools
import json
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
TRAIN_DIR = Path(__file__).resolve().parent / 'build' / 'chip_smoke_train'
VQ_TRAIN_DIR = Path(__file__).resolve().parent / 'build' / 'chip_smoke_vqvae'
MADE_TRAIN_DIR = Path(__file__).resolve().parent / 'build' / 'chip_smoke_made'
MADE_FLAGS = ['--model=made', '--hidden_size=2048']  # the kernel route's width
QUANT_MODES = ('w8a8', 'w8a16')
QUANT_KERNEL = {'w8a8': 'int8_gemm', 'w8a16': 'dequant_gemm'}
RING_KERNELS = ('ring_chunk_fwd', 'ring_chunk_bwd_dq', 'ring_chunk_bwd_dkv')
NO_RING = dict.fromkeys(RING_KERNELS, 0)  # the ring's kernels run only under --mesh=seq:N
SEQ_TRAIN_DIR = Path(__file__).resolve().parent / 'build' / 'chip_smoke_seq'
SEQ = 4  # the seq_train phase's ring: --mesh=seq:4
PT_DECODE_WINDOW = range(392, 424)  # the profiled steps of a quantized pixel_transformer request


def log(*a):
    print(*a, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, iters, warmup=3):
    """Mean ms per call over iters back-to-back calls from Python, CUDA
    events: what a caller issuing one call at a time pays (for a kernel
    shorter than its wrapper, the host's issue time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _on_device(event):
    """A kernel or copy on the card's timeline; not a user annotation (such
    as Optimizer.step), whose span covers kernels already counted."""
    from torch.autograd import DeviceType

    return event.device_type == DeviceType.CUDA and not getattr(event, 'is_user_annotation', False)


def _device_events(fn, iters, flush=None, tries=3):
    """The card's events over iters calls of fn (each after a write of
    flush, where given) under torch.profiler's CUDA trace. A trace with no
    device event at all is taken again, up to tries times: the trace now
    and then comes back empty (it also loses a window's first events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if _on_device(e)]
        if events:
            return events
        log(f'[profile] the trace has no device event; taking it again ({attempt + 1} of {tries})')
    raise AssertionError('the profiler saw no device events')


def device_ms(fn, iters):
    """Mean device ms per call: the summed duration of the kernels (and
    copies) that iters calls ran, from torch.profiler's CUDA trace, so the
    host's issue time between launches is not counted."""
    return sum(e.time_range.elapsed_us() for e in _device_events(fn, iters)) / 1e3 / iters


def l2_cold_ms(fn, kernel_name, flush, iters=50):
    """Mean device ms of the kernel named kernel_name when each call follows
    a write of flush (larger than the 50 MB L2), so its operands come from
    HBM: the events of that kernel alone, from torch.profiler's trace."""
    us = [e.time_range.elapsed_us() for e in _device_events(fn, iters, flush)
          if kernel_name in e.name]
    if not us:
        raise AssertionError(f'the profiler saw no {kernel_name} events')
    return sum(us) / 1e3 / len(us)


def timings(kernel, plain, library=None, iters=200):
    """ms / plain_ms / library_ms (device time) and their eager twins."""
    out = dict(
        ms=device_ms(kernel, iters), eager_ms=eager_ms(kernel, iters),
        plain_ms=device_ms(plain, iters), plain_eager_ms=eager_ms(plain, iters),
        library_ms=None, library_eager_ms=None,
    )
    if library is not None:
        out.update(library_ms=device_ms(library, iters),
                   library_eager_ms=eager_ms(library, iters))
    return out


def bound(nbytes, flops, peak=H100_BF16_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak of their type (bf16 unless given)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _twice_bitwise(name, fn):
    """fn() twice on the same inputs; raises unless the two (a tensor or a
    tuple of tensors) are bitwise equal. Returns the first."""
    a, b = fn(), fn()
    pairs = zip(a, b) if isinstance(a, tuple) else ((a, b),)
    if not all(torch.equal(x, y) for x, y in pairs):
        raise AssertionError(f'{name}: two launches on the same inputs differ')
    return a


def compare(name, got, ref, atol, rtol):
    """Max abs error; raises if any |got - ref| > atol + rtol * |ref|."""
    err = (got - ref).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: non-finite output')
    bad = err > atol + rtol * ref.abs()
    max_err = float(err.max())
    if bad.any():
        raise AssertionError(
            f'{name}: {int(bad.sum())} elements outside atol={atol} rtol={rtol}; '
            f'max abs err {max_err:.3g}'
        )
    return max_err


def ptxas_report(text):
    """{entry function: {registers, spill_stores, spill_loads}} from
    `nvcc -Xptxas -v` output, in the order ptxas compiled them."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            out[name]['registers'] = int(m.group(1))
    return out


def phase_build():
    """Builds every kernel source; logs ptxas's registers and spills of
    each entry function. Returns the reports of the kernels redesigned for
    the tensor cores, Kernels C, E, D and L by D bucket, H and I by their
    VEC flag and A and B by VEC flag and LN width (A's dot route as 'dot'),
    as {'causal_attention_fwd': {'DP=32': {...}, ...}, 'flash_bwd_dq': ...,
    'flash_bwd_dkv': ..., 'mask_out_matmul': {'VEC=1': {...}, 'VEC=0':
    {...}}, 'int8_gemm': ..., 'block_tail': {'VEC=1,VPL=4': {...}, ...},
    'ln_matmul': {'VEC=1,VPL=4': {...}, 'dot,VPL=4': {...}, ...},
    'ring_chunk_bwd_dq': {'DP=32': {...}, ...}}, and raises if C, E or D
    spill at D=32 (every path's width) or H, I, A, B or L spill at all."""
    from generative_models_tpu_torch.ops.common import BUILD_DIR, KERNEL_SOURCES, build_kernels

    t0 = time.time()
    build_kernels()
    log(f'[build] {len(KERNEL_SOURCES)} sources in {time.time() - t0:.1f}s -> {BUILD_DIR}')
    # (library, mangled kernel name with its template arguments, wrapper,
    # key): the D bucket (C, E, D), the VEC flag (H, I), VEC and the LN
    # width (B)
    watched = (('attention', r'flash_fwd_kernelILi(\d+)E', 'causal_attention_fwd', 'DP={}'),
               ('attention_bwd', r'flash_bwd_dq_kernelILi(\d+)E', 'flash_bwd_dq', 'DP={}'),
               ('attention_bwd', r'flash_bwd_dkv_kernelILi(\d+)E', 'flash_bwd_dkv', 'DP={}'),
               ('masked_dense', r'mask_out_matmul_kernelILb(\d+)E', 'mask_out_matmul', 'VEC={}'),
               ('int8', r'int8_gemm_kernelILb(\d+)E', 'int8_gemm', 'VEC={}'),
               ('decode_fused', r'block_tail_kernelILb(\d+)ELi(\d+)E', 'block_tail',
                'VEC={},VPL={}'),
               ('decode_fused', r'ln_matmul_kernelILb(\d+)ELi(\d+)E', 'ln_matmul',
                'VEC={},VPL={}'),
               ('decode_fused', r'ln_matmul_dot_kernelILi(\d+)E', 'ln_matmul', 'dot,VPL={}'),
               ('ring_attention', r'ring_bwd_dq_kernelILi(\d+)E', 'ring_chunk_bwd_dq', 'DP={}'))
    every_bucket = ('ring_chunk_bwd_dq',)  # held at every D bucket, not at D=32 alone
    reps = {name: {} for _, _, name, _ in watched}
    for p in sorted(BUILD_DIR.glob('*.log')):
        for fn, rep in ptxas_report(p.read_text()).items():
            log(f'[build] {p.stem}: {fn}: {json.dumps(rep)}')
            for lib, mangled, name, key in watched:
                m = re.match(rf'_Z\d+{mangled}', fn)
                if m and p.stem.startswith(f'lib{lib}-'):
                    reps[name][key.format(*m.groups())] = rep
    for name, rep in reps.items():
        log(f'[build] {name} ptxas {json.dumps(rep)}')
        if not rep:
            raise AssertionError(f'{name}: no ptxas report')
        held = ([('DP=32', rep['DP=32'])] if 'DP=32' in rep and name not in every_bucket
                else rep.items())
        for key, r in held:
            if r.get('spill_stores', 0):
                raise AssertionError(f'{name} spills at {key}: {r}')
    return reps


def phase_kernels(dev):
    """Each kernel vs its plain version at the main paths' shapes:
    pixel_transformer's (C=128, T=784 and 2048) first, then vqvae's (the
    prior at C=256, 8 heads, T=49; the codebook search at its batches)."""
    import torch.nn.functional as F

    from generative_models_tpu_torch.ops.attention import (
        causal_attention_fwd, flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq,
        flash_bwd_dq_plain,
    )
    from generative_models_tpu_torch.ops.decode_fused import (
        block_tail, block_tail_plain, ln_matmul, ln_matmul_plain, plan_block_tail,
        plan_ln_matmul,
    )

    rng = np.random.RandomState(0)
    f32 = lambda *s, scale=1.0: torch.tensor(rng.randn(*s) * scale, dtype=torch.float32, device=dev)
    bf = torch.bfloat16
    cases = {'ln_matmul': [], 'block_tail': [], 'causal_attention_fwd': [],
             'flash_bwd_dq': [], 'flash_bwd_dkv': [], 'vq_one_hot': []}

    # Kernels A and B vs plain at the same operand rounding (bf16, f32
    # accumulation). Tolerance atol 1e-2 + rtol 1e-2: the f32 sums differ
    # only in order (~1e-6), but a normalised input that lands within an
    # f32 ulp of a bf16 rounding boundary rounds the other way in one of the
    # two, moving its products by up to 2^-8 relative. A launches twice on
    # the same inputs and the two must be bitwise equal (no atomics, no split
    # K); ms_l2_cold: with L2 flushed before each launch. Then untimed:
    # ragged rows (B = 1, 25, 70: a part-filled 16-row strip), ragged N (7:
    # the dot route at N > 1; 96: a part-filled 64-column slice), ragged C
    # (100: plain loads; 1024 and 4096: LN by loops, the weight streamed
    # through the stage ring), and x at an odd offset (plain loads).
    tol_dense = dict(atol=1e-2, rtol=1e-2)
    flush = torch.empty(64 << 20, device=dev)  # 256 MB of f32
    B = 64
    for C, N, path in ((128, 384, 'pixel_transformer'), (128, 1, 'pixel_transformer'),
                       (256, 768, 'vqvae'), (256, 64, 'vqvae')):
        x, s, b = f32(B, C), 1 + f32(C, scale=0.1), f32(C, scale=0.1)
        w, bias = f32(C, N, scale=C ** -0.5).to(bf), f32(N, scale=0.1)
        got = _twice_bitwise(f'ln_matmul C={C} N={N}', lambda: ln_matmul(x, s, b, w, bias))
        ref = ln_matmul_plain(x, s, b, w, bias, dtype=bf)
        err = compare(f'ln_matmul C={C} N={N}', got, ref, **tol_dense)
        nbytes = B * C * 4 + 2 * C * 4 + C * N * 2 + N * 4 + B * N * 4
        bms, by = bound(nbytes, 2 * B * C * N)
        cases['ln_matmul'].append(dict(
            shape=f'x ({B},{C}) -> ({B},{N})', path=path, max_abs_err=err, **tol_dense,
            bound_ms=bms, bound_by=by, bitwise_twice=True,
            plan=plan_ln_matmul(B, C, N)._asdict(),
            ms_l2_cold=l2_cold_ms(lambda: ln_matmul(x, s, b, w, bias), 'ln_matmul', flush),
            **timings(
                lambda: ln_matmul(x, s, b, w, bias),
                lambda: ln_matmul_plain(x, s, b, w, bias, dtype=bf),
            ),
        ))
    for rows, C, N, odd in ((1, 128, 384, False), (25, 128, 384, False), (70, 256, 768, False),
                            (64, 128, 7, False), (64, 128, 96, False), (64, 100, 96, False),
                            (25, 1024, 384, False), (70, 1024, 1, False), (5, 4096, 96, False),
                            (64, 128, 384, True), (25, 100, 1, True)):
        s, b = 1 + f32(C, scale=0.1), f32(C, scale=0.1)
        w, bias = f32(C, N, scale=C ** -0.5).to(bf), f32(N, scale=0.1)
        # 4 bytes past a 16-byte boundary: the plain-load route
        x = f32(rows * C + 1)[1:].view(rows, C) if odd else f32(rows, C)
        shape = f'ragged x ({rows},{C}) -> ({rows},{N}){", at an odd offset" if odd else ""}'
        got = _twice_bitwise(f'ln_matmul {shape}', lambda: ln_matmul(x, s, b, w, bias))
        err = compare(f'ln_matmul {shape}', got, ln_matmul_plain(x, s, b, w, bias, dtype=bf),
                      **tol_dense)
        plan = plan_ln_matmul(rows, C, N, aligned=not odd)._asdict()
        cases['ln_matmul'].append(dict(shape=shape, path='ragged', max_abs_err=err, **tol_dense,
                                       bitwise_twice=True, plan=plan))
    # Kernel B launched twice on the same inputs must be bitwise equal (its
    # cluster's partial sums meet in rank order); ms_l2_cold: with L2
    # flushed before each launch. Then untimed: ragged rows (B = 1, 25, 70:
    # a part-filled 16-row strip) and ragged C, C=144 on the 16-byte route
    # (P=32 slices over 8 blocks, the last rank's 16 wide, ranks 5-7 empty)
    # and on the plain-load route (x, y at an odd offset), and C=100 (not a
    # multiple of 16: plain loads)

    def block_tail_params(C):
        return dict(
            wproj=f32(C, C, scale=C ** -0.5).to(bf), bproj=f32(C, scale=0.1),
            ln2_scale=1 + f32(C, scale=0.1), ln2_bias=f32(C, scale=0.1),
            wfc1=f32(C, 4 * C, scale=C ** -0.5).to(bf), bfc1=f32(4 * C, scale=0.1),
            wfc2=f32(4 * C, C, scale=(4 * C) ** -0.5).to(bf), bfc2=f32(C, scale=0.1),
        )

    for C, path in ((128, 'pixel_transformer'), (256, 'vqvae')):
        lp = block_tail_params(C)
        x, y = f32(B, C), f32(B, C)
        got = _twice_bitwise(f'block_tail C={C}', lambda: block_tail(x, y, lp))
        err = compare(f'block_tail C={C}', got, block_tail_plain(x, y, lp, dtype=bf), **tol_dense)
        nbytes = 3 * B * C * 4 + 9 * C * C * 2 + 8 * C * 4
        bms, by = bound(nbytes, 2 * B * 9 * C * C)
        cases['block_tail'].append(dict(
            shape=f'x, y ({B},{C})', path=path, max_abs_err=err, **tol_dense,
            bound_ms=bms, bound_by=by, bitwise_twice=True,
            plan=plan_block_tail(C)._asdict(),
            ms_l2_cold=l2_cold_ms(lambda: block_tail(x, y, lp), 'block_tail_kernel', flush),
            **timings(
                lambda: block_tail(x, y, lp),
                lambda: block_tail_plain(x, y, lp, dtype=bf),
            ),
        ))
    del flush
    for rows, C, odd in ((1, 128, False), (25, 128, False), (70, 256, False), (64, 144, False),
                         (64, 144, True), (25, 100, False)):
        lp = block_tail_params(C)
        if odd:  # 4 bytes past a 16-byte boundary: the plain-load route
            x, y = (f32(rows * C + 1)[1:].view(rows, C) for _ in range(2))
        else:
            x, y = f32(rows, C), f32(rows, C)
        shape = f'ragged x, y ({rows},{C}){", at an odd offset" if odd else ""}'
        got = _twice_bitwise(f'block_tail {shape}', lambda: block_tail(x, y, lp))
        err = compare(f'block_tail {shape}', got, block_tail_plain(x, y, lp, dtype=bf),
                      **tol_dense)
        cases['block_tail'].append(dict(shape=shape, path='ragged', max_abs_err=err, **tol_dense,
                                        bitwise_twice=True, plan=plan_block_tail(C)._asdict()))

    cases['causal_attention_fwd'] = flash_fwd_cases(f32, dev)

    # Kernels E (dQ, delta) and D (dK, dV) vs the dense plain backward on the
    # same bf16 operands, P and dS in f32 in the plain version (the kernels
    # carry each as a bf16 hi/lo pair): rtol 1e-3 / atol 1e-4, the JAX
    # package's flash-vs-dense gradient tolerance (sums of up to T terms in
    # another order). Each launches twice on the same inputs, and the two
    # must be bitwise equal (no atomics, fixed sum order). library_ms: the
    # backward alone of scaled_dot_product_attention (dq, dk and dv in one
    # call); ms_l2_cold at the path shape: each kernel with L2 flushed
    # before it. Then untimed edge cases of the tiling (64-row blocks,
    # 16-row chunks, D padded to 16, 32, 64 or 128) at a small B*H.
    tol_bwd = dict(atol=1e-4, rtol=1e-3)
    bwd_shapes = (((64, 4, 784, 32), (209, 209), 'pixel_transformer'),
                  ((1, 4, 2048, 32), (389, 418), 'long T'),
                  ((64, 8, 49, 32), (209, 209), 'vqvae'))
    flush = torch.empty(64 << 20, device=dev)  # 256 MB of f32
    for (Bq, Hq, T, D), lines, path in bwd_shapes:
        q, k, v, do = (f32(Bq, Hq, T, D).to(bf) for _ in range(4))
        o, lse = causal_attention_fwd(q, k, v)
        shape = f'(B={Bq},H={Hq},T={T},D={D})'
        dq, delta = _twice_bitwise(f'flash_bwd_dq {shape}',
                                   lambda: flash_bwd_dq(q, k, v, o, lse, do))
        dk, dv = _twice_bitwise(f'flash_bwd_dkv {shape}',
                                lambda: flash_bwd_dkv(q, k, v, do, lse, delta))
        rdq, rdelta = flash_bwd_dq_plain(q, k, v, o, lse, do, dtype=bf)
        err_dq = max(compare(f'bwd dq {shape}', dq, rdq, **tol_bwd),
                     compare(f'bwd delta {shape}', delta, rdelta, **tol_bwd))
        del rdq
        rdk, rdv = flash_bwd_dkv_plain(q, k, v, do, lse, rdelta, dtype=bf)
        err_dkv = max(compare(f'bwd dk {shape}', dk, rdk, **tol_bwd),
                      compare(f'bwd dv {shape}', dv, rdv, **tol_bwd))
        del rdk, rdv
        torch.cuda.empty_cache()
        qg, kg, vg = (u.detach().clone().requires_grad_() for u in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        sdpa_bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)
        BH, pairs = Bq * Hq, Bq * Hq * T * (T + 1) // 2
        n = BH * T * D
        iters = 10 if T > 64 else 100
        cold = {}
        if path == 'pixel_transformer':
            cold = dict(
                dq=l2_cold_ms(lambda: flash_bwd_dq(q, k, v, o, lse, do), 'flash_bwd_dq_kernel',
                              flush),
                dkv=l2_cold_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta),
                               'flash_bwd_dkv_kernel', flush))
        # E reads q, k, v, dO (bf16), o, lse and writes dq, delta; three
        # D-long products a live pair (S, dP, dQ)
        bms, by = bound(4 * n * 2 + n * 4 + BH * T * 4 + n * 4 + BH * T * 4, 3 * 2 * D * pairs)
        cases['flash_bwd_dq'].append(dict(
            shape=shape, path=path, replaces_line=lines[0], max_abs_err=err_dq, **tol_bwd,
            bound_ms=bms, bound_by=by, library_covers='dq, dk and dv', bitwise_twice=True,
            **({'ms_l2_cold': cold['dq']} if cold else {}), **timings(
                lambda: flash_bwd_dq(q, k, v, o, lse, do),
                lambda: flash_bwd_dq_plain(q, k, v, o, lse, do, dtype=bf),
                sdpa_bwd, iters=iters,
            ),
        ))
        # D reads q, k, v, dO (bf16), lse, delta and writes dk, dv; four
        # D-long products a live pair (S, dP, dK, dV)
        bms, by = bound(4 * n * 2 + 2 * BH * T * 4 + 2 * n * 4, 4 * 2 * D * pairs)
        cases['flash_bwd_dkv'].append(dict(
            shape=shape, path=path, replaces_line=lines[1], max_abs_err=err_dkv, **tol_bwd,
            bound_ms=bms, bound_by=by, library_covers='dq, dk and dv', bitwise_twice=True,
            **({'ms_l2_cold': cold['dkv']} if cold else {}), **timings(
                lambda: flash_bwd_dkv(q, k, v, do, lse, delta),
                lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta, dtype=bf),
                sdpa_bwd, iters=iters,
            ),
        ))
        del out, sdpa_bwd, qg, kg, vg
        torch.cuda.empty_cache()
    del flush
    edge_shapes = ([(2, 3, T, 32) for T in (1, 63, 65, 130)]
                   + [(2, 3, 200, D) for D in (8, 16, 24, 64, 128)])
    for Bq, Hq, T, D in edge_shapes:
        q, k, v, do = (f32(Bq, Hq, T, D).to(bf) for _ in range(4))
        o, lse = causal_attention_fwd(q, k, v)
        shape = f'(B={Bq},H={Hq},T={T},D={D})'
        dq, delta = _twice_bitwise(f'flash_bwd_dq {shape}',
                                   lambda: flash_bwd_dq(q, k, v, o, lse, do))
        dk, dv = _twice_bitwise(f'flash_bwd_dkv {shape}',
                                lambda: flash_bwd_dkv(q, k, v, do, lse, delta))
        rdq, rdelta = flash_bwd_dq_plain(q, k, v, o, lse, do, dtype=bf)
        rdk, rdv = flash_bwd_dkv_plain(q, k, v, do, lse, rdelta, dtype=bf)
        err_dq = max(compare(f'bwd dq {shape}', dq, rdq, **tol_bwd),
                     compare(f'bwd delta {shape}', delta, rdelta, **tol_bwd))
        err_dkv = max(compare(f'bwd dk {shape}', dk, rdk, **tol_bwd),
                      compare(f'bwd dv {shape}', dv, rdv, **tol_bwd))
        for name, err in (('flash_bwd_dq', err_dq), ('flash_bwd_dkv', err_dkv)):
            cases[name].append(dict(shape=shape, path='edge', max_abs_err=err, **tol_bwd,
                                    bitwise_twice=True))

    cases['vq_one_hot'] = vq_cases(f32)
    cases['masked_matmul'], cases['mask_out_matmul'] = made_cases(f32, dev)
    cases['int8_gemm'], cases['dequant_gemm'] = int8_cases(rng, dev)
    ring = ring_cases(f32)
    cases.update(ring.pop('cases'))
    torch.cuda.synchronize()
    for name, cs in cases.items():
        for c in cs:
            log(f'[kernels] {name} {json.dumps(c)}')
    return cases, ring


def flash_fwd_cases(f32, dev):
    """Kernel C vs the dense plain version on the same bf16 operands, both
    in f32: atol 2e-5 + rtol 2e-4, the JAX package's flash-vs-dense
    tolerance (sums in another order, exp/log implementations differ; C
    carries P into P v as a bf16 hi/lo pair, the plain version keeps it in
    f32). At the three attention shapes of the main paths, timed, and at
    untimed edge cases of the tiling (64-row blocks, 16-key chunks, D
    padded to 16, 32, 64 or 128) at a small B*H. Every case launches C
    twice on the same inputs, and the two must be bitwise equal (no
    atomics, fixed sum order). library_ms: scaled_dot_product_attention's
    forward; ms_l2_cold at the path shape: C with L2 flushed before it."""
    import torch.nn.functional as F

    from generative_models_tpu_torch.ops.attention import (
        causal_attention_fwd, causal_attention_plain,
    )

    tol = dict(atol=2e-5, rtol=2e-4)
    bf, out = torch.bfloat16, []
    flush = torch.empty(64 << 20, device=dev)  # 256 MB of f32
    shapes = ([((64, 4, 784, 32), 148, 'pixel_transformer'), ((1, 4, 2048, 32), 312, 'long T'),
               ((64, 8, 49, 32), 148, 'vqvae')]
              + [((2, 3, T, 32), None, 'edge') for T in (1, 63, 65, 130)]
              + [((2, 3, 200, D), None, 'edge') for D in (8, 16, 24, 64, 128)])
    for (Bq, Hq, T, D), replaces, path in shapes:
        q, k, v = (f32(Bq, Hq, T, D).to(bf) for _ in range(3))
        shape = f'(B={Bq},H={Hq},T={T},D={D})'
        o, lse = _twice_bitwise(f'causal_attention_fwd {shape}',
                                lambda: causal_attention_fwd(q, k, v))
        o_ref, lse_ref = causal_attention_plain(q, k, v, dtype=bf)
        err = max(compare(f'attention o {shape}', o, o_ref, **tol),
                  compare(f'attention lse {shape}', lse, lse_ref, **tol))
        del o_ref, lse_ref
        case = dict(shape=shape, path=path, max_abs_err=err, **tol, bitwise_twice=True)
        if path != 'edge':
            BH = Bq * Hq
            nbytes = 3 * BH * T * D * 2 + BH * T * D * 4 + BH * T * 4
            flops = 4 * D * BH * T * (T + 1) // 2  # QK^T and PV over live pairs
            bms, by = bound(nbytes, flops)
            kern = lambda: causal_attention_fwd(q, k, v)
            if path == 'pixel_transformer':
                case['ms_l2_cold'] = l2_cold_ms(kern, 'flash_fwd_kernel', flush)
            case.update(replaces_line=replaces, bound_ms=bms, bound_by=by, **timings(
                kern, lambda: causal_attention_plain(q, k, v, dtype=bf),
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                iters=10 if T > 64 else 100,
            ))
        out.append(case)
        torch.cuda.empty_cache()
    del flush
    return out


def _live_pairs(n, Tl, hop):
    """(query, key) pairs with a live causal pair at one hop of a ring of n,
    over the real rows of every position: the diagonal's triangle, a past
    chunk's square, a future chunk's nothing."""
    pairs = 0
    for p in range(n):
        c = (p - hop) % n
        pairs += Tl * (Tl + 1) // 2 if c == p else (Tl * Tl if c < p else 0)
    return pairs


def _live_positions(n, hop):
    """Ring positions with any live pair at one hop of a ring of n: those
    whose visiting chunk is the diagonal or a past one. A hop's bound
    counts the bytes of these positions' real rows only."""
    return sum((p - hop) % n <= p for p in range(n))


def ring_cases(f32, shape=(64, 4, 784, 32)):
    """Kernels K, L and M vs their plain versions at pixel_transformer's
    shapes (B=64, H=4, T=784, D=32: BH=256) on rings of 4 (the seq_train
    phase's), 2 and 8, at the first hop (the init variant) and at hop 1
    (the carry from hop 0). Inputs: one seeded (64,4,784,32) q, k, v and dO
    in bf16, cut into the ring's chunks as the ring cuts them (dO zero on
    padded rows); L and M get lse and delta from the full forward ring.
    Tolerances are Kernel C's for K (atol 2e-5 + rtol 2e-4) and E/D's for
    L and M (atol 1e-4 + rtol 1e-3): the same bf16 operands on both sides,
    f32 sums in another order. No single PyTorch call computes a hop's
    carry: library_ms is null. Then the whole ring at n = 4 and 8 through
    ring_causal_attention (its autograd Function) against Kernels C, E and
    D on the full sequence, o and the three gradients, and its forward and
    backward timed beside scaled_dot_product_attention's."""
    import torch.nn.functional as F

    from generative_models_tpu_torch.ops import attention as att
    from generative_models_tpu_torch.parallel.ring_attention import (
        _chunks, ring_causal_attention, ring_forward,
    )

    B, H, T, D = shape
    BH, bf = B * H, torch.bfloat16
    q, k, v, do = (f32(B, H, T, D).to(bf) for _ in range(4))
    tol_k, tol_lm = dict(atol=2e-5, rtol=2e-4), dict(atol=1e-4, rtol=1e-3)
    flush = torch.empty(64 << 20, device=q.device)  # 256 MB of f32
    out = {'ring_chunk_fwd': [], 'ring_chunk_bwd_dq': [], 'ring_chunk_bwd_dkv': []}
    clone = lambda xs: None if xs is None else tuple(x.clone() for x in xs)
    for n in (4, 2, 8):
        Tl = T // n
        Tp = att._pick_chunk_blk(Tl)[1]
        qc, kc, vc, doc = (_chunks(u, n, Tp, bf) for u in (q, k, v, do))
        o, lse = ring_forward(qc, kc, vc, Tl)
        delta = (doc.float() * o).sum(-1)
        carry = att.ring_chunk_fwd(qc, kc, vc, None, 0, Tl)  # hop 0's carry for hop 1
        dq0 = att.ring_chunk_bwd_dq(qc, kc, vc, doc, lse, delta, None, 0, Tl)
        dkv0 = att.ring_chunk_bwd_dkv(qc, kc, vc, doc, lse, delta, None, 0, Tl)
        for hop, init in ((1, False), (0, True)):
            shape = f'ring of {n}: (n={n},BH={BH},Tp={Tp},D={D}), t_valid {Tl}, hop {hop}'
            variant = 'init' if init else 'carry'
            pairs = BH * _live_pairs(n, Tl, hop)
            # bytes over the live positions' real rows only: rows is one f32
            # a row (m, l, lse or delta), full one element a row and channel
            live_rows = BH * _live_positions(n, hop) * Tl
            rows, full = live_rows * 4, live_rows * D
            common = dict(shape=shape, path='seq_train' if n == 4 else f'seq:{n}', variant=variant,
                          live_pairs=pairs, library_covers=None)
            c_in = None if init else carry
            dq_in = None if init else dq0
            dkv_in = None if init else dkv0
            # K: q and the visited k, v read, the carry read (not at init)
            # and written
            got = att.ring_chunk_fwd(qc, kc, vc, clone(c_in), hop, Tl)
            ref = att.ring_hop_fwd_plain(qc, kc, vc, c_in, hop, Tl, dtype=bf)
            err = max(compare(f'ring_chunk_fwd {x} {shape}', g, r, **tol_k)
                      for x, g, r in zip(('acc', 'm', 'l'), got, ref))
            bms, by = bound(3 * full * 2 + (1 if init else 2) * (full * 4 + 2 * rows),
                            4 * D * pairs)
            scratch = clone(carry)
            out['ring_chunk_fwd'].append(dict(
                **common, max_abs_err=err, **tol_k, bound_ms=bms, bound_by=by, **timings(
                    lambda: att.ring_chunk_fwd(qc, kc, vc, None if init else scratch, hop, Tl),
                    lambda: att.ring_hop_fwd_plain(qc, kc, vc, c_in, hop, Tl, dtype=bf),
                    iters=10)))
            # L: q, k, v, dO, lse, delta read, dq read (not at init) and
            # written; launched twice on the same inputs, bitwise equal (no
            # atomics); timed in place, as the ring runs it, and at the
            # seq_train ring also with L2 flushed before each launch
            got = _twice_bitwise(f'ring_chunk_bwd_dq {shape}', lambda: att.ring_chunk_bwd_dq(
                qc, kc, vc, doc, lse, delta, None if init else dq0.clone(), hop, Tl))
            ref = att.ring_hop_bwd_dq_plain(qc, kc, vc, doc, lse, delta, dq_in, hop, Tl, dtype=bf)
            err = compare(f'ring_chunk_bwd_dq {shape}', got, ref, **tol_lm)
            bms, by = bound(4 * full * 2 + 2 * rows + (1 if init else 2) * full * 4,
                            3 * 2 * D * pairs)
            dq_s = dq0.clone()
            l_call = lambda: att.ring_chunk_bwd_dq(qc, kc, vc, doc, lse, delta,
                                                   None if init else dq_s, hop, Tl)
            cold = {'ms_l2_cold': l2_cold_ms(l_call, 'ring_bwd_dq_kernel', flush)} if n == 4 else {}
            out['ring_chunk_bwd_dq'].append(dict(
                **common, max_abs_err=err, **tol_lm, bound_ms=bms, bound_by=by,
                bitwise_twice=True, **cold, **timings(
                    l_call,
                    lambda: att.ring_hop_bwd_dq_plain(qc, kc, vc, doc, lse, delta, dq_in, hop,
                                                      Tl, dtype=bf),
                    iters=10)))
            # M: q, k, v, dO, lse, delta read, the visited chunk's dk and dv
            # read (not at init) and written
            got = att.ring_chunk_bwd_dkv(qc, kc, vc, doc, lse, delta, clone(dkv_in), hop, Tl)
            ref = att.ring_hop_bwd_dkv_plain(qc, kc, vc, doc, lse, delta, dkv_in, hop, Tl,
                                             dtype=bf)
            err = max(compare(f'ring_chunk_bwd_dkv {x} {shape}', g, r, **tol_lm)
                      for x, g, r in zip(('dk', 'dv'), got, ref))
            bms, by = bound(4 * full * 2 + 2 * rows + (1 if init else 2) * 2 * full * 4,
                            4 * 2 * D * pairs)
            dkv_s = clone(dkv0)
            out['ring_chunk_bwd_dkv'].append(dict(
                **common, max_abs_err=err, **tol_lm, bound_ms=bms, bound_by=by, **timings(
                    lambda: att.ring_chunk_bwd_dkv(qc, kc, vc, doc, lse, delta,
                                                   None if init else dkv_s, hop, Tl),
                    lambda: att.ring_hop_bwd_dkv_plain(qc, kc, vc, doc, lse, delta, dkv_in,
                                                       hop, Tl, dtype=bf),
                    iters=10)))
            del got, ref
        del qc, kc, vc, doc, o, lse, delta, carry, dq0, dkv0
        torch.cuda.empty_cache()
    del flush
    out['ring_chunk_bwd_dq'] += ring_dq_edge_cases(f32, tol_lm)

    # the whole ring against Kernels C, E and D on the full sequence; f32
    # inputs holding bf16 values, so the ring's gradients come back in f32
    oc, lsec = att.causal_attention_fwd(q, k, v)
    refs = (oc, *att.causal_attention_bwd(q, k, v, oc, lsec, do))
    whole = {}
    for n in (4, 8):
        qg, kg, vg = (u.float().requires_grad_() for u in (q, k, v))
        o = ring_causal_attention(qg, kg, vg, n)
        grads = torch.autograd.grad(o, (qg, kg, vg), do.float(), retain_graph=True)
        errs = {x: compare(f'ring of {n} vs C/E/D {x}', g, r, **(tol_k if x == 'o' else tol_lm))
                for x, g, r in zip(('o', 'dq', 'dk', 'dv'), (o.detach(), *grads), refs)}
        with torch.no_grad():
            fwd = lambda: ring_causal_attention(qg, kg, vg, n)
            whole[f'ring_{n}'] = dict(
                max_abs_err=errs, fwd_ms=device_ms(fwd, 10), fwd_eager_ms=eager_ms(fwd, 10))
        bwd = lambda: torch.autograd.grad(o, (qg, kg, vg), do.float(), retain_graph=True)
        whole[f'ring_{n}'].update(bwd_ms=device_ms(bwd, 10), bwd_eager_ms=eager_ms(bwd, 10))
        del o, grads, qg, kg, vg
        torch.cuda.empty_cache()
    qs, ks, vs = (u.detach().clone().requires_grad_() for u in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    whole['sdpa'] = dict(
        fwd_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 10),
        bwd_ms=device_ms(lambda: torch.autograd.grad(so, (qs, ks, vs), do, retain_graph=True), 10))
    whole['c_e_d'] = dict(
        fwd_ms=device_ms(lambda: att.causal_attention_fwd(q, k, v), 10),
        bwd_ms=device_ms(lambda: att.causal_attention_bwd(q, k, v, oc, lsec, do), 10))
    whole.update(shape=f'(B={B},H={H},T={T},D={D})', tol_o=tol_k, tol_grads=tol_lm)
    log(f'[kernels] whole ring {json.dumps(whole)}')
    del so, qs, ks, vs, oc, lsec, refs
    torch.cuda.empty_cache()
    return dict(cases=out, whole=whole)


def ring_dq_edge_cases(f32, tol):
    """Kernel L, untimed, at the edges of its tiling, each launched twice
    (bitwise equal) and held against ring_hop_bwd_dq_plain on the same
    arguments: D = 8, 16, 64 and 128 (every D bucket, 32 being the path's)
    on a ring of 4 at T=784 (t_valid 196); t_valid 75 on a ring of 2 (T=150,
    chunks of 80 rows); and one rank's launch of a ring of 4 (P=1, pos0=2,
    the visiting chunk in slot 0) at every hop, on a dq at an odd offset at
    the carry hops (the wrapper's copy back)."""
    from generative_models_tpu_torch.ops import attention as att
    from generative_models_tpu_torch.parallel.ring_attention import _chunks, ring_forward

    bf = torch.bfloat16
    out = []

    def fresh(dq, odd):
        """a copy of dq (None stays None), 4 bytes past a 16-byte boundary
        where odd"""
        if dq is None or not odd:
            return None if dq is None else dq.clone()
        buf = torch.empty(dq.numel() + 1, device=dq.device)
        buf[1:] = dq.flatten()
        return buf[1:].view(dq.shape)

    def check(label, qc, kc, vc, doc, lse, delta, dq_in, hop, Tl, pos0=0, n_ring=None,
              odd=False):
        got = _twice_bitwise(f'ring_chunk_bwd_dq {label}', lambda: att.ring_chunk_bwd_dq(
            qc, kc, vc, doc, lse, delta, fresh(dq_in, odd), hop, Tl, pos0, n_ring))
        ref = att.ring_hop_bwd_dq_plain(qc, kc, vc, doc, lse, delta, dq_in, hop, Tl, pos0,
                                        n_ring, dtype=bf)
        out.append(dict(shape=label, path='edge', bitwise_twice=True, **tol,
                        max_abs_err=compare(f'ring_chunk_bwd_dq {label}', got, ref, **tol)))

    for n, (B, H, T, D) in ((4, (2, 3, 784, 8)), (4, (2, 3, 784, 16)), (4, (2, 3, 784, 64)),
                            (4, (2, 3, 784, 128)), (2, (2, 3, 150, 32))):
        Tl = T // n
        Tp = att._pick_chunk_blk(Tl)[1]
        qc, kc, vc, doc = (_chunks(f32(B, H, T, D), n, Tp, bf) for _ in range(4))
        o, lse = ring_forward(qc, kc, vc, Tl)
        delta = (doc.float() * o).sum(-1)
        dq0 = att.ring_chunk_bwd_dq(qc, kc, vc, doc, lse, delta, None, 0, Tl)
        for hop in (0, 1):
            check(f'ring of {n}: (n={n},BH={B * H},Tp={Tp},D={D}), t_valid {Tl}, hop {hop}',
                  qc, kc, vc, doc, lse, delta, None if hop == 0 else dq0, hop, Tl)
    n, (B, H, T, D) = 4, (2, 3, 200, 32)
    Tl = T // n
    Tp = att._pick_chunk_blk(Tl)[1]
    qc, kc, vc, doc = (_chunks(f32(B, H, T, D), n, Tp, bf) for _ in range(4))
    o, lse = ring_forward(qc, kc, vc, Tl)
    delta = (doc.float() * o).sum(-1)
    for hop in range(n):
        c = (2 - hop) % n  # the chunk visiting position 2
        dq_in = None if hop == 0 else f32(1, B * H, Tp, D)
        check(f'one rank of a ring of {n}: P=1, pos0=2, (BH={B * H},Tp={Tp},D={D}), '
              f't_valid {Tl}, hop {hop}', qc[2:3], kc[c:c + 1], vc[c:c + 1], doc[2:3], lse[2:3],
              delta[2:3], dq_in, hop, Tl, 2, n, odd=hop > 0)
    return out


def vq_cases(f32):
    """Kernel F vs its plain version (f32 on both sides) at vqvae's
    training batch, at evaluate's 8 images, and at a codebook of 16
    K-tiles. The indices must be identical; where one differs, the plain
    scores' gap between the best and the second-best code at that row must
    be under 1e-5 of the row's largest |score| (a tie within rounding,
    which a sum in another order may break either way)."""
    from generative_models_tpu_torch.ops.quantize import vq_one_hot, vq_one_hot_plain, vq_scores

    out = []
    for N, K, D, path in ((3136, 64, 64, 'vqvae train'), (392, 64, 64, 'vqvae evaluate'),
                          (12544, 1024, 64, 'K-tiles')):
        z, e = f32(N, D), f32(K, D)
        oh, idx = vq_one_hot(z, e)
        roh, ridx = vq_one_hot_plain(z, e)
        if not torch.equal(oh, torch.nn.functional.one_hot(idx, K).float()):
            raise AssertionError(f'vq_one_hot ({N},{K},{D}): one-hot disagrees with its index')
        rows = (idx != ridx).nonzero().flatten()
        gaps = []
        if len(rows):
            sc = vq_scores(z[rows], e)
            top2 = sc.topk(2, dim=1, largest=False).values
            gap = top2[:, 1] - top2[:, 0]
            scale = sc.abs().max(dim=1).values
            gaps = [dict(row=int(r), gap=float(g), rel_gap=float(g / m))
                    for r, g, m in zip(rows, gap, scale)]
            log(f'[kernels] vq_one_hot ({N},{K},{D}): {len(rows)} rows differ: {gaps[:20]}')
            if (gap >= 1e-5 * scale).any():
                raise AssertionError(f'vq_one_hot ({N},{K},{D}): indices differ beyond a tie')
        # bytes: z and the codebook read once, the one-hot and the int32
        # index written once; operations: the f32 z.e products (FMA on the
        # CUDA cores, so against the f32 peak)
        bms, by = bound(4 * (N * D + K * D + N * K + N), 2 * N * K * D, peak=H100_F32_FLOPS)
        out.append(dict(
            shape=f'z ({N},{D}) x e ({K},{D})', path=path, rows_differ=len(rows),
            max_abs_err=float((oh - roh).abs().max()), atol=0.0, rtol=0.0,
            tie_rel_gap=1e-5, bound_ms=bms, bound_by=by,
            **timings(lambda: vq_one_hot(z, e), lambda: vq_one_hot_plain(z, e),
                      iters=100 if N * K < 2 ** 24 else 20),
        ))
        del z, e, oh, roh
        torch.cuda.empty_cache()
    return out


def made_cases(f32, dev):
    """Kernels G and H vs their plain versions at made's shapes at
    hidden_size=2048 and bs=64, with made's own masks
    (create_made_masks(784, (2048,) * 3, 42)): G at the four forward
    products, the widest first, and at the dX product of a hidden layer
    with w and its mask read as (N, K); H at the weight gradients of a
    hidden layer and of the input layer, x read as (K, M). Tolerance atol
    1e-3 + rtol 1e-3: the same bf16-rounded operands on both sides, f32
    sums of up to 2048 products in another order (~1e-6 relative). H must
    be exactly 0 wherever its mask is 0. G's two launches on the same inputs
    must be bitwise equal (its K splits are summed in a fixed order). Then G
    untimed at ragged shapes in both layouts, with random {0, 1} masks: M
    past 64 and not a multiple of 64, K shorter than one split's share, N
    not a multiple of 16 (plain loads instead of 16-byte cp.async).
    library_ms: torch.matmul on bf16
    operands with the weight already masked (for H, the unmasked x^T g), the
    product the premasked route pays for instead. ms_l2_cold: the kernel's
    device time with L2 flushed before each launch, as in a made request,
    whose four layers' weights and masks do not fit in L2 together, against
    ms, where the one layer's operands stay in L2 across the iterations.
    H launches twice on the same inputs and must be bitwise equal too, and
    is checked untimed at ragged shapes and odd K. library_f32_out_ms for
    H: torch.mm with an f32 result, where this PyTorch offers it
    (torch.matmul on bf16 writes a bf16 dW, half of H's bytes)."""
    from generative_models_tpu_torch.models.made import create_made_masks
    from generative_models_tpu_torch.ops.masked_dense import (
        mask_out_matmul, mask_out_matmul_plain, masked_matmul, masked_matmul_plain,
    )

    masks = [torch.tensor(m, device=dev).to(torch.uint8)
             for m in create_made_masks(784, (2048,) * 3, 42)]
    tol = dict(atol=1e-3, rtol=1e-3)
    bf, B = torch.bfloat16, 64
    library_covers = 'torch.matmul, bf16 operands, the weight already masked'
    g_cases, h_cases = [], []
    flush = torch.empty(64 << 20, device=dev)  # 256 MB of f32
    for layer, trans_b in ((1, False), (0, False), (2, False), (3, False), (1, True)):
        m = masks[layer]
        K, N = m.shape
        w = f32(K, N, scale=K ** -0.5)
        wmb = (w * m).to(bf)
        if trans_b:  # dX = g @ (w * m)^T: g (B, N), output (B, K)
            x = f32(B, N)
            kern = lambda: masked_matmul(x, w, m, trans_b=True)
            plain = lambda: masked_matmul_plain(x, w.t(), m.t())
            xb = x.to(bf)
            lib = lambda: torch.matmul(xb, wmb.t())
            dims, shape = (B, N, K), f'dX g ({B},{N}) x (w*m)^T, w ({K},{N}) read as (N, K)'
        else:
            x = f32(B, K)
            kern = lambda: masked_matmul(x, w, m)
            plain = lambda: masked_matmul_plain(x, w, m)
            xb = x.to(bf)
            lib = lambda: torch.matmul(xb, wmb)
            dims, shape = (B, K, N), f'x ({B},{K}) x w ({K},{N})'
        err = compare(f'masked_matmul {shape}', _twice_bitwise(f'masked_matmul {shape}', kern),
                      plain(), **tol)
        M_, K_, N_ = dims
        # f32 x and w read once, the uint8 mask once, the f32 output written
        bms, by = bound(4 * M_ * K_ + 5 * K_ * N_ + 4 * M_ * N_, 2 * M_ * K_ * N_)
        g_cases.append(dict(shape=shape, path='made', layer=layer, max_abs_err=err, **tol,
                            bound_ms=bms, bound_by=by, library_covers=library_covers,
                            ms_l2_cold=l2_cold_ms(kern, 'masked_matmul_kernel', flush),
                            **timings(kern, plain, lib)))
    rng = np.random.RandomState(1)
    for (M, K, N), trans_b in itertools.product(((10, 72, 136), (80, 40, 136), (200, 784, 130)),
                                                (False, True)):
        x, m = f32(M, K), torch.tensor(rng.rand(K, N) < 0.5, device=dev).to(torch.uint8)
        w = f32(K, N, scale=K ** -0.5)
        wl, ml = (w.t().contiguous(), m.t().contiguous()) if trans_b else (w, m)
        shape = f'ragged x ({M},{K}) x w ({K},{N}){" read as (N, K)" if trans_b else ""}'
        got = _twice_bitwise(f'masked_matmul {shape}',
                             lambda: masked_matmul(x, wl, ml, trans_b=trans_b))
        err = compare(f'masked_matmul {shape}', got, masked_matmul_plain(x, w, m), **tol)
        g_cases.append(dict(shape=shape, path='ragged', max_abs_err=err, **tol))
    for layer in (1, 0):
        m = masks[layer]
        K, N = m.shape
        x, g = f32(B, K), f32(B, N)
        shape = f'dW x^T ({K},{B}) x g ({B},{N}), x read as (K, M)'
        kern = lambda: mask_out_matmul(x, g, m)
        got = _twice_bitwise(f'mask_out_matmul {shape}', kern)
        err = compare(f'mask_out_matmul {shape}', got, mask_out_matmul_plain(x.t(), g, m), **tol)
        if got[m == 0].any():
            raise AssertionError(f'mask_out_matmul {shape}: non-zero off the mask')
        xb, gb = x.to(bf), g.to(bf)
        bms, by = bound(4 * B * K + 4 * B * N + 5 * K * N, 2 * K * B * N)
        h_cases.append(dict(
            shape=shape, path='made', layer=layer, max_abs_err=err, **tol,
            exact_zero_off_mask=True, bitwise_twice=True, bound_ms=bms, bound_by=by,
            library_covers='torch.matmul, bf16 operands, unmasked, a bf16 result',
            ms_l2_cold=l2_cold_ms(kern, 'mask_out_matmul_kernel', flush),
            library_f32_out_ms=_f32_out_mm_ms(xb, gb),
            **timings(kern, lambda: mask_out_matmul_plain(x.t(), g, m),
                      lambda: torch.matmul(xb.t(), gb)),
        ))
    # H untimed where the tile is ragged (M not a multiple of 64, N of 128),
    # at K = 1, 10, 37 and 200 (one and four 64-deep chunks), with random
    # {0, 1} masks; M not a multiple of 4 or N of 16, and x a view at an odd
    # offset (4 bytes past a 16-byte boundary), take the plain-load route
    for M, K, N, odd in ((200, 37, 130, False), (784, 10, 784, False), (64, 1, 2048, False),
                         (300, 200, 272, False), (784, 64, 2048, True)):
        m = torch.tensor(rng.rand(M, N) < 0.5, device=dev).to(torch.uint8)
        x = f32(K * M + 1)[1:].view(K, M) if odd else f32(K, M)
        g = f32(K, N)
        shape = f'ragged dW x^T ({M},{K}) x g ({K},{N}){", x at an odd offset" if odd else ""}'
        got = _twice_bitwise(f'mask_out_matmul {shape}', lambda: mask_out_matmul(x, g, m))
        err = compare(f'mask_out_matmul {shape}', got, mask_out_matmul_plain(x.t(), g, m), **tol)
        if got[m == 0].any():
            raise AssertionError(f'mask_out_matmul {shape}: non-zero off the mask')
        h_cases.append(dict(shape=shape, path='ragged', max_abs_err=err, **tol,
                            exact_zero_off_mask=True, bitwise_twice=True))
    del flush
    torch.cuda.empty_cache()
    return g_cases, h_cases


def _f32_out_mm_ms(xb, gb):
    """Device ms of torch.mm(xb^T, gb, out_dtype=torch.float32): bf16
    operands and the f32 result that H writes, the library's own product
    with H's output bytes, where this PyTorch's mm takes out_dtype (it is
    timed, never used by the port); else None."""
    try:
        torch.mm(xb.t(), gb, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        log(f'[kernels] torch.mm(..., out_dtype=torch.float32) is not available here: {e}')
        return None
    return device_ms(lambda: torch.mm(xb.t(), gb, out_dtype=torch.float32), 200)


def int8_cases(rng, dev):
    """Kernels I and J vs their plain versions at every product of the
    quantized serving paths at serve_bs=64 (pixel_transformer's, the vqvae
    prior's, made's at hidden_size=1024) and at four ragged shapes, the
    ragged ones untimed, and I alone at K=100000 (a deep split, sums of
    1.6e9 near int32's limit). I must be bitwise equal (integer sums; the
    plain version in float64 is exact); J within atol 1e-3 + rtol 1e-3 (the
    same bf16 x and int8 q on both sides, f32 sums of up to 1024 products
    in another order); both launched twice on the same inputs bitwise equal
    (their K splits are summed in a fixed order). ms_l2_cold for I at made's
    three products: with L2 flushed before each launch, as in a made
    request, whose layers' weights pass through L2 in turn. Bound: I reads
    int8 x and q and writes int32, J reads
    f32 x (it rounds x to bf16 itself) and int8 q and writes f32; their
    operations at the int8 and the bf16 peak. library_ms: torch._int_mm for
    I (it takes M > 16 and K, N multiples of 8: the path shapes only), and
    for J torch.matmul on bf16 x and a bf16 weight widened ahead of time,
    the weight traffic w8a16 avoids."""
    from generative_models_tpu_torch.ops.int8 import (
        dequant_gemm, dequant_gemm_plain, int8_gemm, int8_gemm_plain,
    )

    shapes = (((64, 128, 128), 'pixel_transformer query/key/value/proj'),
              ((64, 128, 512), 'pixel_transformer fc1'), ((64, 512, 128), 'pixel_transformer fc2'),
              ((64, 64, 256), 'vqvae prior embed'),
              ((64, 256, 256), 'vqvae prior query/key/value/proj'),
              ((64, 256, 1024), 'vqvae prior fc1'), ((64, 1024, 256), 'vqvae prior fc2'),
              ((64, 256, 64), 'vqvae prior head'), ((64, 784, 1024), 'made layer 0'),
              ((64, 1024, 1024), 'made layers 1, 2'), ((64, 1024, 784), 'made layer 3'),
              ((10, 72, 136), 'ragged'), ((6, 130, 70), 'ragged'), ((80, 130, 70), 'ragged'),
              ((72, 40, 130), 'ragged'))
    i8 = lambda *s: torch.tensor(rng.randint(-127, 128, s), dtype=torch.int8, device=dev)
    tol_j = dict(atol=1e-3, rtol=1e-3)
    i_cases, j_cases = [], []
    flush = torch.empty(64 << 20, device=dev)  # 256 MB of f32
    for (M, K, N), path in shapes:
        x8, q = i8(M, K), i8(K, N)
        xf = torch.tensor(rng.randn(M, K), dtype=torch.float32, device=dev)
        shape = f'x ({M},{K}) x q ({K},{N})'
        if not torch.equal(_twice_bitwise(f'int8_gemm {shape}', lambda: int8_gemm(x8, q)),
                           int8_gemm_plain(x8, q)):
            raise AssertionError(f'int8_gemm {shape}: not bitwise equal to its plain version')
        got = _twice_bitwise(f'dequant_gemm {shape}', lambda: dequant_gemm(xf, q))
        err = compare(f'dequant_gemm {shape}', got, dequant_gemm_plain(xf, q), **tol_j)
        ci = dict(shape=shape, path=path, max_abs_err=0.0, atol=0.0, rtol=0.0, bitwise=True,
                  bitwise_twice=True)
        cj = dict(shape=shape, path=path, max_abs_err=err, **tol_j, bitwise_twice=True)
        if path != 'ragged':
            xb, wb = xf.to(torch.bfloat16), q.to(torch.bfloat16)
            bms, by = bound(M * K + K * N + 4 * M * N, 2 * M * K * N, peak=H100_INT8_OPS)
            if path.startswith('made'):
                ci['ms_l2_cold'] = l2_cold_ms(lambda: int8_gemm(x8, q), 'int8_gemm_kernel', flush)
            ci.update(bound_ms=bms, bound_by=by, library_covers='torch._int_mm', **timings(
                lambda: int8_gemm(x8, q), lambda: int8_gemm_plain(x8, q),
                lambda: torch._int_mm(x8, q), iters=50))
            bms, by = bound(4 * M * K + K * N + 4 * M * N, 2 * M * K * N)
            cj.update(bound_ms=bms, bound_by=by,
                      library_covers='torch.matmul, bf16 x and a bf16 weight widened ahead',
                      **timings(lambda: dequant_gemm(xf, q), lambda: dequant_gemm_plain(xf, q),
                                lambda: torch.matmul(xb, wb), iters=50))
        i_cases.append(ci)
        j_cases.append(cj)
    del flush
    M, K, N = 3, 100000, 16  # a deep K: 8 splits of 196 stages
    x8 = torch.full((M, K), -127, dtype=torch.int8, device=dev)
    x8[1] = i8(K)
    q = torch.full((K, N), 127, dtype=torch.int8, device=dev)
    q[:, 1:] = i8(K, N - 1)
    shape = f'x ({M},{K}) x q ({K},{N})'
    got = _twice_bitwise(f'int8_gemm {shape}', lambda: int8_gemm(x8, q))
    if not torch.equal(got, int8_gemm_plain(x8, q)):
        raise AssertionError(f'int8_gemm {shape}: not bitwise equal to its plain version')
    i_cases.append(dict(shape=shape, path='deep K', max_abs_err=0.0, atol=0.0, rtol=0.0,
                        bitwise=True, bitwise_twice=True, extreme=int(got.abs().max())))
    return i_cases, j_cases


def _counters():
    """Every kernel wrapper; each counts its own launches."""
    from generative_models_tpu_torch.ops.attention import (
        causal_attention_fwd, flash_bwd_dkv, flash_bwd_dq, ring_chunk_bwd_dkv, ring_chunk_bwd_dq,
        ring_chunk_fwd,
    )
    from generative_models_tpu_torch.ops.decode_fused import block_tail, ln_matmul
    from generative_models_tpu_torch.ops.int8 import dequant_gemm, int8_gemm
    from generative_models_tpu_torch.ops.masked_dense import mask_out_matmul, masked_matmul
    from generative_models_tpu_torch.ops.quantize import vq_one_hot

    return (ln_matmul, block_tail, causal_attention_fwd, flash_bwd_dq, flash_bwd_dkv,
            vq_one_hot, masked_matmul, mask_out_matmul, int8_gemm, dequant_gemm,
            ring_chunk_fwd, ring_chunk_bwd_dq, ring_chunk_bwd_dkv)


def _reset(counters):
    for fn in counters:
        fn.launches = 0


def _read(counters):
    return {fn.__name__: fn.launches for fn in counters}


def _get(url):
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, r.read()


def phase_slice():
    """The main path through its entry points, with exact launch counts."""
    from generative_models_tpu_torch.serve import _http_serve, load_server

    counters = _counters()
    _reset(counters)
    t0 = time.time()
    server, G = load_server(['--model=pixel_transformer', '--serve_bs=64'])
    model = server.model
    warm = server.warm()
    log(f'[slice] load_server + warm {time.time() - t0:.2f}s (warm {warm:.2f}s)')
    r25 = server.sample(25)
    a = server.sample(64, seed=7)
    b = server.sample(64, seed=7)
    httpd = _http_serve(server, 0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        st, png = _get(f'http://127.0.0.1:{port}/sample?n=16&seed=3')
        st2, health = _get(f'http://127.0.0.1:{port}/healthz')
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    x = torch.as_tensor(a, device=model.device).reshape(64, model.block_size, 1)
    t1 = time.time()
    nlogp = model.eval_loss(x)['nlogp']
    torch.cuda.synchronize()
    score_sec = time.time() - t1
    launches = _read(counters)
    log(f'[slice] launches {launches}')

    T, L, passes = model.block_size, int(G.n_layer), 5  # warm + 4 requests
    expected = {
        'ln_matmul': (L + 1) * T * passes,
        'block_tail': L * T * passes,
        'causal_attention_fwd': L,  # one scoring forward
        'flash_bwd_dq': 0, 'flash_bwd_dkv': 0,  # serving runs no backward
        'vq_one_hot': 0, 'masked_matmul': 0, 'mask_out_matmul': 0,
        'int8_gemm': 0, 'dequant_gemm': 0, **NO_RING,
    }
    if launches != expected:
        raise AssertionError(f'launch counts {launches} != expected {expected}')
    if th.is_alive():
        raise AssertionError('HTTP server thread did not stop')
    if st != 200 or png[:8] != b'\x89PNG\r\n\x1a\n' or st2 != 200:
        raise AssertionError(f'HTTP: /sample {st}, /healthz {st2}')
    stats = json.loads(health)
    if stats['requests'] != 4:
        raise AssertionError(f'/healthz requests {stats["requests"]} != 4')
    for name, s, n in (('n=25', r25, 25), ('seed=7', a, 64)):
        if s.shape != (n, 28, 28, 1) or not np.isin(s, (0.0, 1.0)).all():
            raise AssertionError(f'{name}: shape {s.shape} or values outside {{0, 1}}')
    if not np.array_equal(a, b):
        raise AssertionError('seed=7 twice gave different batches')
    if not np.isfinite(nlogp):
        raise AssertionError(f'nlogp {nlogp}')
    log(f'[slice] nlogp of the seed=7 batch {nlogp:.6f} (scoring {score_sec * 1e3:.1f} ms)')
    log(f'[slice] request latencies (s): {[round(v, 4) for v in server.latencies]}')
    log(f'[slice] /healthz {json.dumps(stats)}')

    checks = teacher_force(model, x, nlogp)
    return dict(
        launches=launches, passes=passes, latencies=list(server.latencies),
        warm_sec=warm, score_ms=score_sec * 1e3, checks=checks,
        server=server, x=x,
    )


def teacher_force(model, x, nlogp):
    """Hold the sampled batch against the other ways of computing its
    logits."""
    from generative_models_tpu_torch.models.pixel_transformer import (
        TransformerNet, teacher_forced_logits,
    )
    from generative_models_tpu_torch.utils.dists import Bernoulli

    net, T = model.net, model.block_size
    segments = 4  # the card's default, as the requests ran
    out = {}
    # the kernel decode chain at the request's segments and uniforms redraws
    # the request's tokens exactly: same ops on the same inputs
    u = torch.rand((T, 64, 1), generator=torch.Generator(model.device).manual_seed(7),
                   device=model.device)
    lk = teacher_forced_logits(net, x, segments)
    redrawn = Bernoulli(logits=lk).sample(uniforms=u.permute(1, 0, 2))
    flips = int((redrawn != x).sum())
    if flips:
        raise AssertionError(f'kernel decode redraws {flips} tokens differently')
    # bf16 tolerance: the logits pass ~10 bf16 roundings of O(1) values
    # (2^-8 relative each) in sequence; the two sides round at different
    # points (per-op chain vs kernels, dense attention vs decode cache)
    tol = dict(atol=5e-2, rtol=5e-2)
    net.use_fused_decode = False
    try:
        lp = teacher_forced_logits(net, x, segments)
    finally:
        net.use_fused_decode = True
    out['plain_decode_vs_kernel_decode'] = compare('plain vs kernel decode', lp, lk, **tol)
    with torch.no_grad():
        lf = net(x).logits
    out['full_forward_vs_kernel_decode'] = compare('full forward vs kernel decode', lf, lk, **tol)
    nlogp_decode = float(-Bernoulli(logits=lk).log_prob(x).mean())
    out['nlogp_forward_minus_decode'] = abs(nlogp - nlogp_decode)
    if out['nlogp_forward_minus_decode'] > 1e-3:
        raise AssertionError(f'nlogp forward {nlogp} vs decode {nlogp_decode}')
    # the card against the CPU's exact f32 forward, on four samples
    cpu = TransformerNet(1, T, net.n_embed, net.n_head, len(net.blocks))
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    with torch.no_grad():
        lc = cpu(x[:4].cpu()).logits
    out['card_vs_cpu_f32_forward'] = compare('card vs CPU forward', lf[:4].cpu(), lc, **tol)
    out.update(tol)
    log(f'[slice] teacher-forced checks {json.dumps(out)}')
    return out


def phase_train(seq=1):
    """The training path through main.main, with exact launch counts;
    seq > 1 runs it under --mesh=seq:<seq> (the seq_train phase), attention
    through the ring: Kernel K once a hop of every forward, L and M once a
    hop of every backward, and sampling on the per-op chain (no A or B)."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.main import main as train_main

    label, logdir = ('train', TRAIN_DIR) if seq == 1 else ('seq_train', SEQ_TRAIN_DIR)
    train_n, test_n, bs, L, T = 640, 128, 64, 2, 784
    mnist.TRAIN_N, mnist.TEST_N = train_n, test_n  # 10 steps, 2 eval batches
    shutil.rmtree(logdir, ignore_errors=True)
    counters = _counters()
    _reset(counters)
    t0 = time.time()
    history = train_main([
        '--model=pixel_transformer', f'--bs={bs}', '--epochs=1', '--save_n=1',
        '--data_source=synthetic', f'--logdir={logdir}',
    ] + ([f'--mesh=seq:{seq}'] if seq > 1 else []))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _read(counters)
    log(f'[{label}] main.main {wall:.2f}s; launches {launches}')

    steps, eval_batches, evals = train_n // bs, test_n // bs, 2  # epochs 0 and 1
    expected = dict.fromkeys(launches, 0)
    if seq == 1:
        expected.update({
            'ln_matmul': (L + 1) * T * evals,  # evaluate samples 25 each epoch
            'block_tail': L * T * evals,
            'causal_attention_fwd': L * (eval_batches * evals + steps),
            'flash_bwd_dq': L * steps,
            'flash_bwd_dkv': L * steps,
        })
    else:
        expected.update({
            'ring_chunk_fwd': L * seq * (steps + eval_batches * evals),
            'ring_chunk_bwd_dq': L * seq * steps,
            'ring_chunk_bwd_dkv': L * seq * steps,
        })
    if launches != expected:
        raise AssertionError(f'{label} launch counts {launches} != expected {expected}')
    for name in ('model.pt', 'hps.yaml', 'sampling_process_0.gif', 'sampling_process_1.gif'):
        if not (logdir / name).is_file():
            raise AssertionError(f'{label}: {name} was not written')
    if (logdir / 'sampling_process_0.gif').read_bytes()[:6] != b'GIF89a':
        raise AssertionError(f'{label}: sampling_process_0.gif is not a GIF')
    for i, h in enumerate(history):
        bad = {k: v for k, v in h.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f'{label}: non-finite metrics at epoch {i}: {bad}')
    keys = {'eval/nlogp', 'eval/bits_per_dim', 'train/nlogp', 'dt/train', 'dt/eval', 'num_vars'}
    if not keys <= set(history[1]):
        raise AssertionError(f'{label}: epoch 1 logged {sorted(history[1])}, '
                             f'missing {keys - set(history[1])}')
    nlogp = [h['eval/nlogp'] for h in history]
    if not nlogp[1] < nlogp[0]:
        raise AssertionError(f'{label}: eval/nlogp did not fall: {nlogp}')
    log(f'[{label}] eval/nlogp {nlogp}, train/nlogp {history[1]["train/nlogp"]}, '
        f'dt/train {history[1]["dt/train"]:.3f}s for {steps} steps, dt/eval {history[1]["dt/eval"]:.3f}s')
    return dict(launches=launches, wall_sec=wall, steps=steps, history=history)


def _cpu_copy(model, G, **over):
    """The same model on the CPU (f32 throughout) with the card's weights;
    over sets flags of the copy."""
    Gc = type(G)(G)
    Gc.device = 'cpu'
    Gc.update(over)
    cpu = type(model)(Gc)
    cpu.net.load_state_dict({k: v.cpu() for k, v in model.net.state_dict().items()})
    return cpu


def grad_check(label, model, cpu):
    """Every parameter's gradient on the card (already in p.grad) against
    the CPU copy's: finite, non-zero, and within a bf16 tolerance."""
    ref = dict(cpu.net.named_parameters())
    total = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in ref.values())))
    # bf16 operands round each product's inputs by up to 2^-8 relative, and
    # a gradient passes ~10 such products: its relative error sits near
    # 1e-2, so 5e-2 of its own norm, plus 1e-4 of the whole gradient's norm
    # for key.bias, whose exact gradient is 0 (softmax is shift-invariant)
    rel, floor = 5e-2, 1e-4
    out = {}
    for name, p in model.net.named_parameters():
        g = p.grad
        if g is None or not torch.isfinite(g).all() or not g.any():
            raise AssertionError(f'{label}: {name} has no finite non-zero gradient on the card')
        gr = ref[name].grad.double()
        err = float(torch.linalg.vector_norm(g.cpu().double() - gr))
        ref_norm = float(torch.linalg.vector_norm(gr))
        if err > rel * ref_norm + floor * total:
            raise AssertionError(f'{label}: {name} |card - cpu| {err:.3g} vs |cpu| {ref_norm:.3g}')
        out[name] = err / max(ref_norm, 1e-30)
    worst = max(out, key=out.get)
    log(f'[{label}] {len(out)} parameters finite and non-zero; relative error vs CPU f32 '
        f'max {out[worst]:.3g} ({worst}), median {sorted(out.values())[len(out) // 2]:.3g}; '
        f'tolerance {rel} of the norm + {floor} of |all grads| = {total:.4g}')
    return dict(rel_err=out, rtol_norm=rel, atol_of_total=floor)


def phase_grads(seq=1):
    """One batch's gradients on the card against a CPU f32 copy; seq > 1
    (the seq_grads phase) from the seq_train phase's model.pt, whose
    hps.yaml keeps --mesh=seq:<seq>: the card's gradients through the ring
    against an unsharded CPU copy (the normal path, dense attention)."""
    from generative_models_tpu_torch.main import load_model_and_data

    logdir = TRAIN_DIR if seq == 1 else SEQ_TRAIN_DIR
    model, dataset, G = load_model_and_data([
        f'--weights_from={logdir / "model.pt"}', '--data_source=synthetic',
    ])
    if model.net.ring != seq:
        raise AssertionError(f'grads: the reloaded model runs a ring of {model.net.ring}, not {seq}')
    x = dataset.first_test_batch(0)[0][:8]
    model.backward(x)
    cpu = _cpu_copy(model, G, mesh='')
    cpu.backward(x.cpu())
    return model, dataset, grad_check('grads' if seq == 1 else 'seq_grads', model, cpu)


def phase_vq_serve():
    """vqvae's serving path through load_server, with exact launch counts:
    per pass the prior's T=49 decode steps, Kernels A and B only."""
    from generative_models_tpu_torch.serve import load_server

    counters = _counters()
    _reset(counters)
    t0 = time.time()
    server, G = load_server(['--model=vqvae', '--serve_bs=64'])
    warm = server.warm()
    log(f'[vq_serve] load_server + warm {time.time() - t0:.2f}s (warm {warm:.2f}s)')
    r25 = server.sample(25)
    a = server.sample(64, seed=7)
    b = server.sample(64, seed=7)
    torch.cuda.synchronize()
    launches = _read(counters)
    log(f'[vq_serve] launches {launches}')
    T, L, passes = server.model.n_codes, int(G.n_layer), 4  # warm + 3 requests
    expected = {
        'ln_matmul': (L + 1) * T * passes, 'block_tail': L * T * passes,
        'causal_attention_fwd': 0, 'flash_bwd_dq': 0, 'flash_bwd_dkv': 0, 'vq_one_hot': 0,
        'masked_matmul': 0, 'mask_out_matmul': 0, 'int8_gemm': 0, 'dequant_gemm': 0, **NO_RING,
    }
    if launches != expected:
        raise AssertionError(f'vqvae serve launch counts {launches} != expected {expected}')
    for name, s, n in (('n=25', r25, 25), ('seed=7', a, 64)):
        if s.shape != (n, 28, 28, 1) or not np.isin(s, (0.0, 1.0)).all():
            raise AssertionError(f'vqvae {name}: shape {s.shape} or values outside {{0, 1}}')
    if not np.array_equal(a, b):
        raise AssertionError('vqvae seed=7 twice gave different batches')
    log(f'[vq_serve] request latencies (s): {[round(v, 4) for v in server.latencies]}')
    checks = vq_teacher_force(server.model, a)
    return dict(launches=launches, passes=passes, latencies=list(server.latencies),
                warm_sec=warm, checks=checks, server=server)


def vq_teacher_force(model, batch):
    """Redraw the seed=7 request's codes and hold them against the other
    ways of computing the prior's logits."""
    from generative_models_tpu_torch.models.pixel_transformer import (
        teacher_forced_logits, transformer_sample_scan,
    )
    from generative_models_tpu_torch.utils.dists import Categorical

    prior, T, K, n = model.net.prior, model.n_codes, int(model.G.vqK), 64
    u = torch.rand((T, n, K), generator=torch.Generator(model.device).manual_seed(7),
                   device=model.device)
    with torch.no_grad():
        tokens = transformer_sample_scan(
            prior, n, lambda logits, ut: Categorical(logits).sample(uniforms=ut), u)
        codes = tokens.permute(1, 0, 2).contiguous()  # (n, T, K)
        imgs = (torch.sigmoid(model.net.ae.decode_codes(codes)) > 0.5).float()
    # the request is this draw, decoded: the same images
    if not np.array_equal(imgs.cpu().numpy(), batch):
        raise AssertionError('vqvae: the seed=7 codes do not decode to the request')
    out = {}
    lk = teacher_forced_logits(prior, codes)
    redrawn = Categorical(lk).sample(uniforms=u.permute(1, 0, 2))
    flips = int((redrawn != codes).any(-1).sum())
    if flips:
        raise AssertionError(f'vqvae: kernel decode redraws {flips} codes differently')
    # bf16 tolerance, as for pixel_transformer's teacher-forced checks
    tol = dict(atol=5e-2, rtol=5e-2)
    with torch.no_grad():
        lf = prior(codes).logits
    out['full_forward_vs_kernel_decode'] = compare('vqvae full forward vs kernel decode',
                                                   lf, lk, **tol)
    cpu = _cpu_copy(model, model.G)
    with torch.no_grad():
        lc = cpu.net.prior(codes[:4].cpu()).logits
        dc = cpu.net.ae.decode_codes(codes[:4].cpu())
        dk = model.net.ae.decode_codes(codes[:4])
    out['card_vs_cpu_f32_prior'] = compare('vqvae card vs CPU prior', lf[:4].cpu(), lc, **tol)
    # the decoder in f32 on both sides (TF32 off): sums in another order
    out['card_vs_cpu_f32_decoder'] = compare('vqvae card vs CPU decoder', dk.cpu(), dc,
                                             atol=1e-4, rtol=1e-4)
    out.update(tol)
    log(f'[vq_serve] teacher-forced checks {json.dumps(out)}')
    return out


def phase_vq_train():
    """vqvae's training path through main.main, with exact launch counts."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.main import main as train_main

    train_n, test_n, bs, L, T = 640, 128, 64, 2, 49
    mnist.TRAIN_N, mnist.TEST_N = train_n, test_n  # 10 steps, 2 eval batches
    shutil.rmtree(VQ_TRAIN_DIR, ignore_errors=True)
    counters = _counters()
    _reset(counters)
    t0 = time.time()
    history = train_main([
        '--model=vqvae', f'--bs={bs}', '--epochs=1', '--save_n=1',
        '--data_source=synthetic', f'--logdir={VQ_TRAIN_DIR}',
    ])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _read(counters)
    log(f'[vq_train] main.main {wall:.2f}s; launches {launches}')

    steps, eval_batches, evals = train_n // bs, test_n // bs, 2  # epochs 0 and 1
    expected = {
        # a train step, an eval batch and evaluate's 8-image reconstruction
        # each quantize once
        'vq_one_hot': steps + eval_batches * evals + evals,
        'causal_attention_fwd': L * (steps + eval_batches * evals),
        'flash_bwd_dq': L * steps,
        'flash_bwd_dkv': L * steps,
        'ln_matmul': (L + 1) * T * evals,  # evaluate samples 25 each epoch
        'block_tail': L * T * evals,
        'masked_matmul': 0, 'mask_out_matmul': 0, 'int8_gemm': 0, 'dequant_gemm': 0, **NO_RING,
    }
    if launches != expected:
        raise AssertionError(f'vqvae train launch counts {launches} != expected {expected}')
    for name in ('model.pt', 'hps.yaml'):
        if not (VQ_TRAIN_DIR / name).is_file():
            raise AssertionError(f'vqvae train: {name} was not written')
    for i, h in enumerate(history):
        bad = {k: v for k, v in h.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f'vqvae train: non-finite metrics at epoch {i}: {bad}')
    keys = {f'vqvae/{split}/{k}' for split in ('train', 'test')
            for k in ('vq_vae_loss', 'recon_loss', 'embed_loss', 'perplexity', 'prior_loss')}
    if not keys <= set(history[1]):
        raise AssertionError(f'vqvae train: epoch 1 is missing {keys - set(history[1])}')
    recon = [h['vqvae/test/recon_loss'] for h in history]
    if not recon[1] < recon[0]:
        raise AssertionError(f'vqvae train: test recon_loss did not fall: {recon}')
    perp = [h[k] for h in history for k in h if k.endswith('/perplexity')]
    if not all(1.0 <= p <= 64.0 for p in perp):
        raise AssertionError(f'vqvae train: perplexity outside [1, 64]: {perp}')
    log(f'[vq_train] test recon_loss {recon}, perplexity {perp}, prior_loss '
        f'{[h["vqvae/test/prior_loss"] for h in history]}, dt/train '
        f'{history[1]["dt/train"]:.3f}s for {steps} steps, dt/eval {history[1]["dt/eval"]:.3f}s')
    return dict(launches=launches, wall_sec=wall, steps=steps, history=history)


def phase_vq_grads():
    """One batch's gradients on the card, every AE and prior parameter,
    against a CPU f32 copy; and how many codes the two assign
    differently."""
    from generative_models_tpu_torch.main import load_model_and_data

    model, dataset, G = load_model_and_data([
        f'--weights_from={VQ_TRAIN_DIR / "model.pt"}', '--data_source=synthetic',
    ])
    x = dataset.first_test_batch(0)[0]
    model.backward(x)
    cpu = _cpu_copy(model, G)
    cpu.backward(x.cpu())
    with torch.no_grad():
        idx, idx_cpu = model.net.ae(x)[3], cpu.net.ae(x.cpu())[3]
    codes_differ = int((idx.cpu() != idx_cpu).sum())
    log(f'[vq_grads] codes that differ between the card and the CPU copy: '
        f'{codes_differ} of {idx.numel()}')
    out = grad_check('vq_grads', model, cpu)
    out['codes_differ'] = codes_differ
    return model, dataset, out


def phase_made_serve():
    """made's serving path at hidden_size=2048 through load_server, with
    exact launch counts: per pass 784 steps of one full forward, Kernel G
    once a layer, and nothing else."""
    from generative_models_tpu_torch.serve import load_server

    counters = _counters()
    _reset(counters)
    t0 = time.time()
    server, G = load_server(MADE_FLAGS + ['--serve_bs=64'])
    if not server.model.net.use_kernel:
        raise AssertionError('made at hidden_size=2048 did not take the kernel route')
    warm = server.warm()
    log(f'[made_serve] load_server + warm {time.time() - t0:.2f}s (warm {warm:.2f}s)')
    r25 = server.sample(25)
    a = server.sample(64, seed=7)
    b = server.sample(64, seed=7)
    torch.cuda.synchronize()
    launches = _read(counters)
    log(f'[made_serve] launches {launches}')
    nin, layers, passes = server.model.nin, server.model.net.n_layers, 4  # warm + 3 requests
    expected = dict.fromkeys(launches, 0)
    expected['masked_matmul'] = nin * layers * passes
    if launches != expected:
        raise AssertionError(f'made serve launch counts {launches} != expected {expected}')
    for name, s, n in (('n=25', r25, 25), ('seed=7', a, 64)):
        if s.shape != (n, 28, 28, 1) or not np.isin(s, (0.0, 1.0)).all():
            raise AssertionError(f'made {name}: shape {s.shape} or values outside {{0, 1}}')
    if not np.array_equal(a, b):
        raise AssertionError('made seed=7 twice gave different batches')
    log(f'[made_serve] request latencies (s): {[round(v, 4) for v in server.latencies]}')
    checks = made_checks(server.model, a)
    return dict(launches=launches, passes=passes, per_pass=launches['masked_matmul'] // passes,
                latencies=list(server.latencies), warm_sec=warm, checks=checks, server=server)


def made_checks(model, batch):
    """Causality of the kernel route on the card, bitwise: changing inputs
    j >= i leaves logit i unchanged (the masks inside Kernel G, and its
    fixed summation order). Then the card's logits against a CPU f32 copy on
    the fold-the-mask route (the same function) on the seed=7 batch."""
    x = torch.as_tensor(batch, device=model.device).reshape(-1, model.nin)
    canvas = (torch.rand(x.shape, generator=torch.Generator(model.device).manual_seed(3),
                         device=model.device) < 0.5).float()
    out = {'causal_bitwise_at': [0, 1, 2, 100, 400, 600, 782, 783]}
    with torch.no_grad():
        ref = model.net(canvas)
        for i in out['causal_bitwise_at']:
            changed = canvas.clone()
            changed[:, i:] = 1 - changed[:, i:]
            logits = model.net(changed)
            if not torch.equal(logits[:, :i + 1], ref[:, :i + 1]):
                raise AssertionError(f'made: logits up to {i} moved when inputs >= {i} changed')
            # (near the end a flip may reach no later logit through a live unit)
            if i <= 600 and torch.equal(logits[:, i + 1:], ref[:, i + 1:]):
                raise AssertionError(f'made: logits past {i} did not move')
        cpu = _cpu_copy(model, model.G, premasked=0)
        lk = model.net(x[:8])
        lc = cpu.net(x[:8].cpu())
    # bf16 operands at four layers (2^-8 relative each), f32 sums
    tol = dict(atol=5e-2, rtol=5e-2)
    out['card_vs_cpu_f32_logits'] = compare('made card vs CPU logits', lk.cpu(), lc, **tol)
    out.update(tol)
    log(f'[made_serve] checks {json.dumps(out)}')
    return out


def phase_made_default():
    """One made serving pass at the default width, hidden_size=1024: the
    gate keeps the reference's premasked route there, so neither Kernel G
    nor H launches."""
    from generative_models_tpu_torch.serve import load_server

    counters = _counters()
    _reset(counters)
    server, _ = load_server(['--model=made', '--serve_bs=64'])
    if server.model.net.use_kernel or not server.model.net.premasked:
        raise AssertionError('made at hidden_size=1024 left the premasked route')
    s = server.sample(64, seed=7)
    torch.cuda.synchronize()
    launches = _read(counters)
    if any(launches.values()):
        raise AssertionError(f'made at hidden_size=1024 launched kernels: {launches}')
    if s.shape != (64, 28, 28, 1) or not np.isin(s, (0.0, 1.0)).all():
        raise AssertionError(f'made hidden_size=1024: shape {s.shape} or values outside {{0, 1}}')
    log(f'[made_default] hidden_size=1024: launches {launches}, request {server.latencies[-1]:.4f}s')
    return dict(launches=launches, request_sec=server.latencies[-1])


def phase_made_train():
    """made's training path through main.main at hidden_size=2048, with
    exact launch counts."""
    import generative_models_tpu_torch.data.mnist as mnist
    from generative_models_tpu_torch.main import main as train_main

    train_n, test_n, bs, layers, nin = 640, 128, 64, 4, 784
    mnist.TRAIN_N, mnist.TEST_N = train_n, test_n  # 10 steps, 2 eval batches
    shutil.rmtree(MADE_TRAIN_DIR, ignore_errors=True)
    counters = _counters()
    _reset(counters)
    t0 = time.time()
    history = train_main(MADE_FLAGS + [
        f'--bs={bs}', '--epochs=1', '--save_n=1', '--data_source=synthetic',
        f'--logdir={MADE_TRAIN_DIR}',
    ])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _read(counters)
    log(f'[made_train] main.main {wall:.2f}s; launches {launches}')

    steps, eval_batches, evals = train_n // bs, test_n // bs, 2  # epochs 0 and 1
    expected = dict.fromkeys(launches, 0)
    # a train step: G for each layer's forward and for the dX of every layer
    # but the first (its input is the data); H for each layer's dW. An eval
    # batch: the forward. evaluate: 25 samples, 784 forwards, each epoch.
    expected['masked_matmul'] = (steps * (2 * layers - 1) + eval_batches * evals * layers
                                 + evals * nin * layers)
    expected['mask_out_matmul'] = steps * layers
    if launches != expected:
        raise AssertionError(f'made train launch counts {launches} != expected {expected}')
    for name in ('model.pt', 'hps.yaml', 'sampling_process_0.gif', 'sampling_process_1.gif'):
        if not (MADE_TRAIN_DIR / name).is_file():
            raise AssertionError(f'made train: {name} was not written')
    if (MADE_TRAIN_DIR / 'sampling_process_1.gif').read_bytes()[:6] != b'GIF89a':
        raise AssertionError('made train: sampling_process_1.gif is not a GIF')
    for i, h in enumerate(history):
        bad = {k: v for k, v in h.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f'made train: non-finite metrics at epoch {i}: {bad}')
    keys = {'eval/nlogp', 'eval/bits_per_dim', 'train/nlogp', 'dt/train', 'dt/eval', 'num_vars'}
    if not keys <= set(history[1]):
        raise AssertionError(f'made train: epoch 1 is missing {keys - set(history[1])}')
    nlogp = [h['eval/nlogp'] for h in history]
    if not nlogp[1] < nlogp[0]:
        raise AssertionError(f'made train: eval/nlogp did not fall: {nlogp}')
    log(f'[made_train] eval/nlogp {nlogp}, train/nlogp {history[1]["train/nlogp"]}, '
        f'dt/train {history[1]["dt/train"]:.3f}s for {steps} steps, '
        f'dt/eval {history[1]["dt/eval"]:.3f}s')
    return dict(launches=launches, wall_sec=wall, steps=steps, history=history)


def phase_made_grads():
    """One batch's gradients on the card (the kernel route: Kernels G and
    H) from the trained model.pt, against a CPU f32 copy on the
    fold-the-mask route (autograd through x @ (w * m)): finite, non-zero,
    within the bf16 tolerance, and dW exactly 0 off the mask on both."""
    from generative_models_tpu_torch.main import load_model_and_data

    model, dataset, G = load_model_and_data([
        f'--weights_from={MADE_TRAIN_DIR / "model.pt"}', '--data_source=synthetic',
    ])
    if not model.net.use_kernel:
        raise AssertionError('made grads: the reloaded model left the kernel route')
    x = dataset.first_test_batch(0)[0]
    model.backward(x)
    cpu = _cpu_copy(model, G, premasked=0)
    cpu.backward(x.cpu())
    for net, where in ((model.net, 'card'), (cpu.net, 'CPU copy')):
        for w, _, m in net.layers():
            if w.grad[m == 0].any():
                raise AssertionError(f'made grads: dW off the mask on the {where}')
    return model, dataset, grad_check('made_grads', model, cpu)


def _healthz(server):
    """GET /healthz from the server's HTTP front, started and stopped here."""
    from generative_models_tpu_torch.serve import _http_serve

    httpd = _http_serve(server, 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        st, body = _get(f'http://127.0.0.1:{httpd.server_address[1]}/healthz')
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    if st != 200 or th.is_alive():
        raise AssertionError(f'/healthz {st}, server thread alive {th.is_alive()}')
    return json.loads(body)


def phase_quant_serve():
    """--quantize serving of each model at its default width in both modes;
    returns {'<model>_<mode>': result}. The unquantized chains each mode is
    held against do not depend on the mode: they are computed once a model,
    on the first mode's request, and shared."""
    out = {}
    for name in ('pixel_transformer', 'vqvae', 'made'):
        ref = {}
        for mode in QUANT_MODES:
            out[f'{name}_{mode}'] = quant_serve_one(name, mode, ref)
    return out


def quant_serve_one(name, mode, ref):
    """One model in one mode through load_server (warm and seed=7 twice),
    with exact launch counts: the mode's kernel once a quantized weight a
    step (a decode step, or a made forward), every other kernel 0 times: no
    Kernel A or B in the decode steps, no G in made's forwards. ref: the
    model's unquantized chains, shared between its modes (quant_checks)."""
    from generative_models_tpu_torch.serve import load_server

    label = f'quant_serve {name} {mode}'
    counters = _counters()
    _reset(counters)
    t0 = time.time()
    server, G = load_server([f'--model={name}', '--serve_bs=64', f'--quantize={mode}'])
    warm = server.warm()
    a = server.sample(64, seed=7)
    b = server.sample(64, seed=7)
    torch.cuda.synchronize()
    launches = _read(counters)
    log(f'[{label}] load_server + warm {time.time() - t0:.2f}s (warm {warm:.2f}s); '
        f'launches {launches}')
    steps = {'pixel_transformer': 784, 'vqvae': 49, 'made': 784}[name]
    n_q = {'pixel_transformer': 12, 'vqvae': 14, 'made': 4}[name]
    passes = 3  # warm + 2 requests
    if server.quant_kernels != n_q or server.quant_mode != mode:
        raise AssertionError(f'{label}: {server.quant_kernels} quantized weights in mode '
                             f'{server.quant_mode}, expected {n_q} in {mode}')
    expected = dict.fromkeys(launches, 0)
    expected[QUANT_KERNEL[mode]] = n_q * steps * passes
    if launches != expected:
        raise AssertionError(f'{label} launch counts {launches} != expected {expected}')
    stats = _healthz(server)
    if (stats['quantize'], stats['quantized_kernels'], stats['requests']) != (mode, n_q, 2):
        raise AssertionError(f'{label}: /healthz {stats}')
    if a.shape != (64, 28, 28, 1) or not np.isin(a, (0.0, 1.0)).all():
        raise AssertionError(f'{label} seed=7: shape {a.shape} or values outside {{0, 1}}')
    if not np.array_equal(a, b):
        raise AssertionError(f'{label}: seed=7 twice gave different batches')
    log(f'[{label}] request latencies (s): {[round(v, 4) for v in server.latencies]}')
    checks = quant_checks(name, mode, server, G, a, ref)
    return dict(launches=launches, passes=passes, per_pass=n_q * steps,
                latencies=list(server.latencies), warm_sec=warm, checks=checks, server=server)


def quant_checks(name, mode, server, G, batch, ref):
    """The seed=7 request redrawn through the quantized chain from its
    uniforms (the same tokens); the card's table bitwise equal to a CPU
    copy's (the weights copied, quantized there again); then teacher-forced
    logits, quantized on the card, on the model's first mode's request
    (ref['x']: the unquantized chains on it, ref['lu'] on the card and
    ref['lf'] on a CPU f32 copy, are computed at the first mode and reused
    at the second):
      * against the unquantized chain on a CPU f32 copy, on 8 samples: the
        relative error (Frobenius) < 0.05, the JAX package's bound for its
        quantized forward against the exact f32 one (tests/test_int8.py);
      * against the unquantized chain on the card (bf16 operands, so its
        own rounding adds in), on all 64: reported, not bounded; and that
        chain itself against the CPU f32 one (reported: the card's own
        bf16 rounding, once a model);
      * against the same quantized chain on the CPU copy, on 8 samples, at
        the bf16 tolerance of the other teacher-forced checks: the card
        rounds the KV cache (and under w8a16 the activations) to bf16. Under
        w8a8 that rounding can also move an activation across a
        quantization level, which moves its products by sx * scale * |q| and
        every logit downstream: those logits are counted, and at most 0.5 %
        of them may lie outside the tolerance (none under w8a16).
    made: causality under w8a16 bitwise, and under w8a8 the count of logits
    <= i that move when inputs >= i change."""
    from generative_models_tpu_torch.models.pixel_transformer import (
        teacher_forced_logits, transformer_sample_scan,
    )
    from generative_models_tpu_torch.ops.int8 import build_quant_table
    from generative_models_tpu_torch.utils.dists import Bernoulli, Categorical

    model, quant = server.model, server.quant
    dev, gen = model.device, torch.Generator(model.device).manual_seed(7)
    cpu = _cpu_copy(model, G)
    cquant, _ = build_quant_table(cpu, mode)
    if (quant.dense.keys(), quant.masked.keys()) != (cquant.dense.keys(), cquant.masked.keys()):
        raise AssertionError(f'{name} {mode}: the card and the CPU quantize other layers')
    pairs = [(k, quant.dense[k], cquant.dense[k]) for k in quant.dense] + [
        (f'{k} layer {i}', a, b) for k in quant.masked
        for i, (a, b) in enumerate(zip(quant.masked[k], cquant.masked[k]))]
    for key, (q, sc), (cq, csc) in pairs:
        if not (torch.equal(q.cpu(), cq) and torch.equal(sc.cpu(), csc)):
            raise AssertionError(f'{name} {mode}: {key} quantized apart on the card and the CPU')
    tol = dict(atol=5e-2, rtol=5e-2)
    out = {}
    with torch.no_grad():
        if name == 'pixel_transformer':
            T = model.block_size
            x = torch.as_tensor(batch, device=dev).reshape(64, T, 1)
            u = torch.rand((T, 64, 1), generator=gen, device=dev)
            lq = teacher_forced_logits(model.net, x, 4, quant)
            redrawn = Bernoulli(logits=lq).sample(uniforms=u.permute(1, 0, 2))
            flips = int((redrawn != x).sum())
            if not ref:
                ref.update(x=x, lu=teacher_forced_logits(model.net, x, 4),
                           lf=teacher_forced_logits(cpu.net, x[:8].cpu()))
            else:
                lq = teacher_forced_logits(model.net, ref['x'], 4, quant)
            lc = teacher_forced_logits(cpu.net, ref['x'][:8].cpu(), 1, cquant)
        elif name == 'vqvae':
            prior, pq, T, K = model.net.prior, quant.sub('prior'), model.n_codes, int(G.vqK)
            u = torch.rand((T, 64, K), generator=gen, device=dev)
            tokens = transformer_sample_scan(
                prior, 64, lambda logits, ut: Categorical(logits).sample(uniforms=ut), u, quant=pq)
            x = tokens.permute(1, 0, 2).contiguous()
            imgs = (torch.sigmoid(model.net.ae.decode_codes(x)) > 0.5).float()
            if not np.array_equal(imgs.cpu().numpy(), batch):
                raise AssertionError(f'vqvae {mode}: the seed=7 codes do not decode to the request')
            lq = teacher_forced_logits(prior, x, 1, pq)
            flips = int((Categorical(lq).sample(uniforms=u.permute(1, 0, 2)) != x).any(-1).sum())
            if not ref:
                ref.update(x=x, lu=teacher_forced_logits(prior, x),
                           lf=teacher_forced_logits(cpu.net.prior, x[:8].cpu()))
            else:
                lq = teacher_forced_logits(prior, ref['x'], 1, pq)
            lc = teacher_forced_logits(cpu.net.prior, ref['x'][:8].cpu(), 1, cquant.sub('prior'))
        else:
            x = torch.as_tensor(batch, device=dev).reshape(64, model.nin)
            if not ref:
                ref.update(x=x, lu=model.net(x), lf=cpu.net(x[:8].cpu()))
            lq = model.net(ref['x'], quant=quant)
            lc = cpu.net(ref['x'][:8].cpu(), quant=cquant)
            flips = 0  # each forward is one step of sampling: nothing to redraw
            out['causality'] = made_quant_causality(model, quant, mode)
    if flips:
        raise AssertionError(f'{name} {mode}: the quantized chain redraws {flips} tokens differently')
    lu, lf = ref['lu'], ref['lf']
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    out['rel_err_vs_cpu_f32_unquantized'] = rel(lq[:8].cpu(), lf)
    out['rel_err_vs_card_unquantized'] = rel(lq, lu)
    out['rel_err_cpu_quantized_vs_cpu_f32'] = rel(lc, lf)
    out['rel_err_card_unquantized_vs_cpu_f32'] = rel(lu[:8].cpu(), lf)
    if not out['rel_err_vs_cpu_f32_unquantized'] < 0.05:
        raise AssertionError(f'{name} {mode}: relative error {out["rel_err_vs_cpu_f32_unquantized"]:.4g}'
                             ' vs the unquantized f32 chain')
    got = lq[:8].cpu()
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name} {mode}: non-finite quantized logits')
    err = (got - lc).abs()
    outside = int((err > tol['atol'] + tol['rtol'] * lc.abs()).sum())
    out.update(card_vs_cpu_quantized=float(err.max()), outside_tolerance=outside,
               compared=err.numel(), max_share_outside=0.005 if mode == 'w8a8' else 0.0, **tol)
    if outside > out['max_share_outside'] * err.numel():
        raise AssertionError(f'{name} {mode} card vs CPU quantized: {outside} of {err.numel()} '
                             f'logits outside atol {tol["atol"]} + rtol {tol["rtol"]}; '
                             f'max abs err {out["card_vs_cpu_quantized"]:.3g}')
    log(f'[quant_serve {name} {mode}] checks {json.dumps(out)}')
    return out


def made_quant_causality(model, quant, mode):
    """made's quantized forward on a random canvas with the inputs >= i
    flipped: under w8a16 logits <= i bitwise unchanged (the folded int8
    weights are exactly 0 off the masks, and Kernel J sums in a fixed
    order); under w8a8 the number of them that move (the row's absmax
    scale sees every unit)."""
    canvas = (torch.rand((64, model.nin), generator=torch.Generator(model.device).manual_seed(3),
                         device=model.device) < 0.5).float()
    ref = model.net(canvas, quant=quant)
    moved = {}
    for i in (0, 1, 2, 100, 400, 600, 782, 783):
        changed = canvas.clone()
        changed[:, i:] = 1 - changed[:, i:]
        logits = model.net(changed, quant=quant)
        moved[i] = int((logits[:, :i + 1] != ref[:, :i + 1]).sum())
        if mode == 'w8a16' and moved[i]:
            raise AssertionError(f'made w8a16: logits up to {i} moved when inputs >= {i} changed')
    return dict(logits_moved_at_or_before_i=moved, bitwise=mode == 'w8a16')


def _profile(label, fn, top_n):
    """Wall and device time of one call of fn under torch.profiler, and the
    kernels that took the most device time; traced_sec is the whole cost,
    the trace's processing included."""
    from torch.profiler import ProfilerActivity, profile

    t_trace = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}
    for e in prof.events():
        if _on_device(e):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    launches = sum(n for n, _ in by_name.values())
    traced = time.time() - t_trace
    log(f'[profile] {label}: wall {wall * 1e3:.1f} ms, device kernels '
        f'{busy_ms:.1f} ms ({launches} launches), busy share {busy_ms / (wall * 1e3):.3f}; '
        f'traced in {traced:.1f}s')
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]:
        log(f'[profile]   {us / 1e3:9.2f} ms  {n:6d}x  {name[:110]}')
    return dict(wall_ms=wall * 1e3, device_ms=busy_ms, launches=launches, traced_sec=traced)


def _decode_window(server, steps):
    """A call running the quantized decode steps `steps` of a request at
    serve_bs=64 (server.model.net with server.quant, on a fresh KV cache),
    as sampling runs them, without the rest of the request."""
    net, quant = server.model.net, server.quant
    caches = net.init_cache(64)
    prev = torch.zeros((64, net.in_size), device=net.pos_emb.device)

    @torch.no_grad()
    def run():
        for t in steps:
            net.decode_step(prev, caches, t, None, quant)
    return run


def phase_profile(server, x, model, dataset, vq_server, vq_model, vq_dataset,
                  made_server, made_model, made_dataset, quant, seq_model, seq_dataset):
    """Device time by kernel over one seeded request, one (warm) scoring
    forward and one (warm) train step at bs=64, for pixel_transformer, for
    vqvae and for made at hidden_size=2048; one (warm) pixel_transformer
    train step under --mesh=seq:4; one seeded quantized request of vqvae and
    made in each mode; and a window of PT_DECODE_WINDOW decode steps of a
    quantized pixel_transformer request in each mode (a whole request's
    trace, 100k-200k launches, took 60-100 s to process)."""
    bx = dataset.epoch_batches(torch.Generator().manual_seed(0))[0]
    model.train_step(bx[0])
    seq_bx = seq_dataset.epoch_batches(torch.Generator().manual_seed(0))[0]
    seq_model.train_step(seq_bx[0])
    vq_bx = vq_dataset.epoch_batches(torch.Generator().manual_seed(0))[0]
    vq_model.train_step(vq_bx[0])
    made_bx = made_dataset.epoch_batches(torch.Generator().manual_seed(0))[0]
    made_model.train_step(made_bx[0])
    torch.cuda.synchronize()
    return dict(
        request=_profile('one request', lambda: server.sample(64, seed=11), 15),
        scoring=_profile('one scoring forward', lambda: server.model.eval_loss(x), 10),
        train_step=_profile('one train step', lambda: model.train_step(bx[1]), 15),
        seq_train_step=_profile(f'one seq:{SEQ} train step',
                                lambda: seq_model.train_step(seq_bx[1]), 15),
        vqvae_request=_profile('one vqvae request', lambda: vq_server.sample(64, seed=11), 15),
        vqvae_train_step=_profile('one vqvae train step',
                                  lambda: vq_model.train_step(vq_bx[1]), 15),
        made_request=_profile('one made request', lambda: made_server.sample(64, seed=11), 10),
        made_train_step=_profile('one made train step',
                                 lambda: made_model.train_step(made_bx[1]), 15),
        **{f'{key}_request': _profile(f'one {key} request',
                                      lambda srv=q['server']: srv.sample(64, seed=11), 12)
           for key, q in quant.items() if not key.startswith('pixel_transformer')},
        **{f'{key}_decode_window': dict(
            steps=[PT_DECODE_WINDOW.start, PT_DECODE_WINDOW.stop],
            **_profile(f'{len(PT_DECODE_WINDOW)} decode steps of a {key} request',
                       _decode_window(q['server'], PT_DECODE_WINDOW), 12))
           for key, q in quant.items() if key.startswith('pixel_transformer')},
    )


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this needs a GPU',
              file=sys.stderr)
        return 1
    import generative_models_tpu_torch  # noqa: F401  (fails outside the repo)
    from generative_models_tpu_torch.ops.common import resolve_device

    dev = resolve_device('cuda')
    smi = nvidia_smi()
    log(f'[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; '
        f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    t_start = time.time()
    phase_sec = {}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        torch.cuda.synchronize()
        phase_sec[name] = time.time() - t0
        log(f'[time] {name} {phase_sec[name]:.1f}s')
        return out

    ptxas = timed('build', phase_build)
    cases, ring = timed('kernels', phase_kernels, dev)
    sl = timed('slice', phase_slice)
    tr = timed('train', phase_train)
    model, dataset, grads = timed('grads', phase_grads)
    st = timed('seq_train', phase_train, SEQ)
    seq_model, seq_dataset, seq_grads = timed('seq_grads', phase_grads, SEQ)
    vs = timed('vq_serve', phase_vq_serve)
    vt = timed('vq_train', phase_vq_train)
    vq_model, vq_dataset, vq_grads = timed('vq_grads', phase_vq_grads)
    ms = timed('made_serve', phase_made_serve)
    md = timed('made_default', phase_made_default)
    mt = timed('made_train', phase_made_train)
    made_model, made_dataset, made_grads = timed('made_grads', phase_made_grads)
    qs = timed('quant_serve', phase_quant_serve)
    prof = timed('profile', phase_profile, sl['server'], sl['x'], model, dataset,
                 vs['server'], vq_model, vq_dataset, ms['server'], made_model, made_dataset, qs,
                 seq_model, seq_dataset)
    phase_sec['total'] = time.time() - t_start
    log(f'[time] phases {json.dumps(phase_sec)}')

    # (source, TPU kernel replaced) of each kernel; its launches are those
    # of pixel_transformer's serving path (sampling passes, one scoring
    # forward), training path and training path under --mesh=seq:4, and of
    # vqvae's and made's
    srcs = {
        'ln_matmul': ('decode_fused.cu', 'generative_models_tpu/ops/decode_fused.py:46'),
        'block_tail': ('decode_fused.cu', 'generative_models_tpu/ops/decode_fused.py:71'),
        'causal_attention_fwd': ('attention.cu', 'generative_models_tpu/ops/attention.py:148'),
        'flash_bwd_dq': ('attention_bwd.cu', 'generative_models_tpu/ops/attention.py:209'),
        'flash_bwd_dkv': ('attention_bwd.cu', 'generative_models_tpu/ops/attention.py:209'),
        'vq_one_hot': ('quantize.cu', 'generative_models_tpu/ops/quantize.py:23'),
        'masked_matmul': ('masked_dense.cu', 'generative_models_tpu/ops/masked_dense.py:24'),
        'mask_out_matmul': ('masked_dense.cu', 'generative_models_tpu/ops/masked_dense.py:35'),
        'int8_gemm': ('int8.cu', 'generative_models_tpu/ops/int8.py:49'),
        'dequant_gemm': ('int8.cu', 'generative_models_tpu/ops/int8.py:60'),
        'ring_chunk_fwd': ('ring_attention.cu', 'generative_models_tpu/ops/attention.py:565'),
        'ring_chunk_bwd_dq': ('ring_attention.cu', 'generative_models_tpu/ops/attention.py:675'),
        'ring_chunk_bwd_dkv': ('ring_attention.cu', 'generative_models_tpu/ops/attention.py:675'),
    }
    kernels = []
    for name, cs in cases.items():
        src, replaces = srcs[name]
        main_case = cs[0]
        by_path = {'serve': sl['launches'][name], 'train': tr['launches'][name],
                   'seq_train': st['launches'][name], 'vqvae_serve': vs['launches'][name], 'vqvae_train': vt['launches'][name],
                   'made_serve': ms['launches'][name], 'made_train': mt['launches'][name],
                   **{f'{key}_serve': q['launches'][name] for key, q in qs.items()}}
        if sum(by_path.values()) == 0:
            raise AssertionError(f'{name} was not launched on a main path')
        kernels.append(dict(
            name=name, route='cuda',
            source=f'generative_models_tpu_torch/ops/csrc/{src}',
            replaces=replaces, launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(c['max_abs_err'] for c in cs),
            atol=main_case['atol'], rtol=main_case['rtol'],
            ms=main_case['ms'], kernel_ms=main_case['ms'],
            eager_ms=main_case['eager_ms'],
            plain_ms=main_case['plain_ms'], bound_ms=main_case['bound_ms'],
            bound_by=main_case['bound_by'], library_ms=main_case['library_ms'],
            **{key: main_case[key] for key in ('ms_l2_cold', 'library_f32_out_ms')
               if key in main_case},
            **({'ptxas': ptxas[name]} if name in ptxas else {}), cases=cs,
        ))
    lat = sorted(sl['latencies'])
    log(json.dumps(dict(
        slice=dict(
            serve_bs=64, warm_sec=sl['warm_sec'], request_sec=lat,
            request_p50_sec=lat[len(lat) // 2], score_ms=sl['score_ms'],
            profile=prof, checks=sl['checks'], power=smi,
        ),
        train=dict(
            wall_sec=tr['wall_sec'], steps=tr['steps'], history=tr['history'],
            grads_max_rel_err=max(grads['rel_err'].values()), power=smi,
        ),
        seq_train=dict(
            mesh=f'seq:{SEQ}', wall_sec=st['wall_sec'], steps=st['steps'], history=st['history'],
            grads_max_rel_err=max(seq_grads['rel_err'].values()), ring=ring['whole'], power=smi,
        ),
        vqvae_serve=dict(
            serve_bs=64, warm_sec=vs['warm_sec'], request_sec=sorted(vs['latencies']),
            checks=vs['checks'], power=smi,
        ),
        vqvae_train=dict(
            wall_sec=vt['wall_sec'], steps=vt['steps'], history=vt['history'],
            grads_max_rel_err=max(vq_grads['rel_err'].values()),
            codes_differ=vq_grads['codes_differ'], power=smi,
        ),
        made_serve=dict(
            hidden_size=2048, serve_bs=64, warm_sec=ms['warm_sec'],
            request_sec=sorted(ms['latencies']), launches_per_pass=ms['per_pass'],
            checks=ms['checks'], default_width=md, power=smi,
        ),
        made_train=dict(
            hidden_size=2048, wall_sec=mt['wall_sec'], steps=mt['steps'], history=mt['history'],
            grads_max_rel_err=max(made_grads['rel_err'].values()), power=smi,
        ),
        quant_serve={key: dict(
            serve_bs=64, warm_sec=q['warm_sec'], request_sec=sorted(q['latencies']),
            launches_per_pass=q['per_pass'], checks=q['checks'], power=smi,
        ) for key, q in qs.items()},
        phase_sec=phase_sec,
    )))
    log(json.dumps({'kernels': kernels}))
    log(nvidia_smi())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
