#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (generative_models_tpu_torch) on one
NVIDIA GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result lines:
  1. device  -- require CUDA (no fallback); print nvidia-smi's name and
                power limit.
  2. build   -- compile ops/csrc/*.cu (one nvcc per source, in parallel)
                and print the build seconds and ptxas's resource lines.
  3. kernels -- hold each kernel against its plain PyTorch version on the
                card at the main path's shapes, with seeded inputs and a
                stated tolerance; time kernel, plain version and, where one
                PyTorch call computes the same function, that call, as
                device time (torch.profiler's CUDA trace) and as eager
                back-to-back time (CUDA events, host issue included).
  4. slice   -- the main path through its entry points: load_server builds
                pixel_transformer at its default width and serves requests
                at serve_bs=64 (warm, n=25, n=64 seed=7 twice, an HTTP
                /sample and /healthz), then scores a batch through the full
                forward. Every launch count is reset just before and read
                just after, and must equal what the path implies. Then the
                sampled tokens are teacher-forced through the kernel decode
                chain (must redraw the same tokens), the plain decode chain
                and the full forward, and a CPU f32 forward checks the card.
  5. profile -- device time by kernel over one request.
Then the kernels line, the nvidia-smi line and, last, the device line.

Imports nothing of JAX or of the JAX package.
"""

import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet


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


def device_ms(fn, iters):
    """Mean device ms per call: the summed duration of the kernels (and
    copies) that iters calls ran, from torch.profiler's CUDA trace, so the
    host's issue time between launches is not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not us:
        raise AssertionError('the profiler saw no device events')
    return sum(us) / 1e3 / iters


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


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the bf16 peak."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


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


def phase_build():
    from generative_models_tpu_torch.ops.common import BUILD_DIR, KERNEL_SOURCES, build_kernels

    t0 = time.time()
    build_kernels()
    log(f'[build] {len(KERNEL_SOURCES)} sources in {time.time() - t0:.1f}s -> {BUILD_DIR}')
    for p in sorted(BUILD_DIR.glob('*.log')):
        for line in p.read_text().splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
                log(f'[build] {p.stem}: {line.strip()}')


def phase_kernels(dev):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch.nn.functional as F

    from generative_models_tpu_torch.ops.attention import (
        causal_attention_fwd, causal_attention_plain,
    )
    from generative_models_tpu_torch.ops.decode_fused import (
        block_tail, block_tail_plain, ln_matmul, ln_matmul_plain,
    )

    rng = np.random.RandomState(0)
    f32 = lambda *s, scale=1.0: torch.tensor(rng.randn(*s) * scale, dtype=torch.float32, device=dev)
    bf = torch.bfloat16
    cases = {'ln_matmul': [], 'block_tail': [], 'causal_attention_fwd': []}

    # Kernels A and B vs plain at the same operand rounding (bf16, f32
    # accumulation). Tolerance atol 1e-2 + rtol 1e-2: the f32 sums differ
    # only in order (~1e-6), but a normalised input that lands within an
    # f32 ulp of a bf16 rounding boundary rounds the other way in one of the
    # two, moving its products by up to 2^-8 relative.
    tol_dense = dict(atol=1e-2, rtol=1e-2)
    B, C = 64, 128
    for N in (3 * C, 1):
        x, s, b = f32(B, C), 1 + f32(C, scale=0.1), f32(C, scale=0.1)
        w, bias = f32(C, N, scale=C ** -0.5).to(bf), f32(N, scale=0.1)
        got = ln_matmul(x, s, b, w, bias)
        ref = ln_matmul_plain(x, s, b, w, bias, dtype=bf)
        err = compare(f'ln_matmul N={N}', got, ref, **tol_dense)
        nbytes = B * C * 4 + 2 * C * 4 + C * N * 2 + N * 4 + B * N * 4
        bms, by = bound(nbytes, 2 * B * C * N)
        cases['ln_matmul'].append(dict(
            shape=f'x ({B},{C}) -> ({B},{N})', max_abs_err=err, **tol_dense,
            bound_ms=bms, bound_by=by, **timings(
                lambda: ln_matmul(x, s, b, w, bias),
                lambda: ln_matmul_plain(x, s, b, w, bias, dtype=bf),
            ),
        ))
    lp = dict(
        wproj=f32(C, C, scale=C ** -0.5).to(bf), bproj=f32(C, scale=0.1),
        ln2_scale=1 + f32(C, scale=0.1), ln2_bias=f32(C, scale=0.1),
        wfc1=f32(C, 4 * C, scale=C ** -0.5).to(bf), bfc1=f32(4 * C, scale=0.1),
        wfc2=f32(4 * C, C, scale=(4 * C) ** -0.5).to(bf), bfc2=f32(C, scale=0.1),
    )
    x, y = f32(B, C), f32(B, C)
    got, ref = block_tail(x, y, lp), block_tail_plain(x, y, lp, dtype=bf)
    err = compare('block_tail', got, ref, **tol_dense)
    nbytes = 3 * B * C * 4 + 9 * C * C * 2 + 8 * C * 4
    bms, by = bound(nbytes, 2 * B * 9 * C * C)
    cases['block_tail'].append(dict(
        shape=f'x, y ({B},{C})', max_abs_err=err, **tol_dense,
        bound_ms=bms, bound_by=by, **timings(
            lambda: block_tail(x, y, lp),
            lambda: block_tail_plain(x, y, lp, dtype=bf),
        ),
    ))

    # Kernel C vs the dense plain version on the same bf16 operands, both in
    # f32: rtol 2e-4 / atol 2e-5, the JAX package's flash-vs-dense
    # tolerance (sums in another order, exp/log implementations differ).
    tol_attn = dict(atol=2e-5, rtol=2e-4)
    for (Bq, Hq, T, D), replaces in (((64, 4, 784, 32), 148), ((1, 4, 2048, 32), 312)):
        q, k, v = (f32(Bq, Hq, T, D).to(bf) for _ in range(3))
        o, lse = causal_attention_fwd(q, k, v)
        o_ref, lse_ref = causal_attention_plain(q, k, v, dtype=bf)
        err = max(
            compare(f'attention o T={T}', o, o_ref, **tol_attn),
            compare(f'attention lse T={T}', lse, lse_ref, **tol_attn),
        )
        del o_ref, lse_ref
        BH = Bq * Hq
        nbytes = 3 * BH * T * D * 2 + BH * T * D * 4 + BH * T * 4
        flops = 4 * D * BH * T * (T + 1) // 2  # QK^T and PV over live pairs
        bms, by = bound(nbytes, flops)
        cases['causal_attention_fwd'].append(dict(
            shape=f'(B={Bq},H={Hq},T={T},D={D})', replaces_line=replaces,
            max_abs_err=err, **tol_attn, bound_ms=bms, bound_by=by,
            **timings(
                lambda: causal_attention_fwd(q, k, v),
                lambda: causal_attention_plain(q, k, v, dtype=bf),
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                iters=10,
            ),
        ))
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for name, cs in cases.items():
        for c in cs:
            log(f'[kernels] {name} {json.dumps(c)}')
    return cases


def _get(url):
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, r.read()


def phase_slice():
    """The main path through its entry points, with exact launch counts."""
    from generative_models_tpu_torch.ops.attention import causal_attention_fwd
    from generative_models_tpu_torch.ops.decode_fused import block_tail, ln_matmul
    from generative_models_tpu_torch.serve import _http_serve, load_server

    counters = (ln_matmul, block_tail, causal_attention_fwd)
    for fn in counters:
        fn.launches = 0
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
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f'[slice] launches {launches}')

    T, L, passes = model.block_size, int(G.n_layer), 5  # warm + 4 requests
    expected = {
        'ln_matmul': (L + 1) * T * passes,
        'block_tail': L * T * passes,
        'causal_attention_fwd': L,  # one scoring forward
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


def _profile(label, fn, top_n):
    """Wall and device time of one call of fn under torch.profiler, and the
    kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    launches = sum(n for n, _ in by_name.values())
    log(f'[profile] {label}: wall {wall * 1e3:.1f} ms, device kernels '
        f'{busy_ms:.1f} ms ({launches} launches), busy share {busy_ms / (wall * 1e3):.3f}')
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]:
        log(f'[profile]   {us / 1e3:9.2f} ms  {n:6d}x  {name[:110]}')
    return dict(wall_ms=wall * 1e3, device_ms=busy_ms, launches=launches)


def phase_profile(server, x):
    """Device time by kernel over one seeded request and one (warm) scoring
    forward."""
    return dict(
        request=_profile('one request', lambda: server.sample(64, seed=11), 15),
        scoring=_profile('one scoring forward', lambda: server.model.eval_loss(x), 10),
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
    phase_build()
    cases = phase_kernels(dev)
    sl = phase_slice()
    prof = phase_profile(sl['server'], sl['x'])

    # (source, TPU kernel replaced, passes the launch count spans: sampling
    # passes for the decode kernels, one scoring forward for attention)
    srcs = {
        'ln_matmul': ('decode_fused.cu', 'generative_models_tpu/ops/decode_fused.py:46', sl['passes']),
        'block_tail': ('decode_fused.cu', 'generative_models_tpu/ops/decode_fused.py:71', sl['passes']),
        'causal_attention_fwd': ('attention.cu', 'generative_models_tpu/ops/attention.py:148', 1),
    }
    kernels = []
    for name, cs in cases.items():
        src, replaces, passes = srcs[name]
        main_case = cs[0]
        launches = sl['launches'][name]
        if launches == 0:
            raise AssertionError(f'{name} was not launched on the main path')
        kernels.append(dict(
            name=name, route='cuda',
            source=f'generative_models_tpu_torch/ops/csrc/{src}',
            replaces=replaces, launches=launches,
            launches_per_pass=launches // passes,
            max_abs_err=max(c['max_abs_err'] for c in cs),
            atol=main_case['atol'], rtol=main_case['rtol'],
            ms=main_case['ms'], kernel_ms=main_case['ms'],
            eager_ms=main_case['eager_ms'],
            plain_ms=main_case['plain_ms'], bound_ms=main_case['bound_ms'],
            bound_by=main_case['bound_by'], library_ms=main_case['library_ms'],
            cases=cs,
        ))
    lat = sorted(sl['latencies'])
    log(json.dumps(dict(
        slice=dict(
            serve_bs=64, warm_sec=sl['warm_sec'], request_sec=lat,
            request_p50_sec=lat[len(lat) // 2], score_ms=sl['score_ms'],
            profile=prof, checks=sl['checks'], power=smi,
        )
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
