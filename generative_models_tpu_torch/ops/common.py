"""Device resolution, tile rounding, and building and loading the CUDA kernels.

Counterpart of generative_models_tpu/ops/common.py (on_tpu + round_up). The
device rule: an entry point asks for 'cuda' unless the caller passes
--device=cpu; asking for CUDA on a machine without it raises, there is no
silent CPU fallback. Kernel wrappers take the CPU path only for tensors that
lie on the CPU.

Kernels are CUDA C++ sources under ops/csrc/, each compiled by nvcc for
sm_90a into its own shared library with a plain C interface and loaded with
ctypes. The build runs at first use into <repo>/build/torch_kernels/, one
nvcc per source, all started together, and each library's file name carries
a hash of its source, the shared headers and the flags, so an edited source
is rebuilt and an unchanged one is reused.

The kernels on the serving paths (A, B, G, I and J) are torch.library ops
in the gmt namespace (register_op), so torch.export sees each as one node
and an exported program launches them as the live one does.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
NVCC_FLAGS = [
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
]
KERNEL_SOURCES = ('decode_fused', 'attention', 'attention_bwd', 'quantize', 'masked_dense',
                  'int8', 'ring_attention')

# every kernel wrapper, as (module under ops/, function): each counts its own
# launches in its .launches attribute, on the host, where it launches
KERNEL_COUNTERS = (
    ('decode_fused', 'ln_matmul'), ('decode_fused', 'block_tail'),
    ('attention', 'causal_attention_fwd'), ('attention', 'flash_bwd_dq'),
    ('attention', 'flash_bwd_dkv'), ('quantize', 'vq_one_hot'),
    ('masked_dense', 'masked_matmul'), ('masked_dense', 'mask_out_matmul'),
    ('int8', 'int8_gemm'), ('int8', 'dequant_gemm'), ('attention', 'ring_chunk_fwd'),
    ('attention', 'ring_chunk_bwd_dq'), ('attention', 'ring_chunk_bwd_dkv'),
)

_LIBS = {}
_LIBS_LOCK = threading.Lock()
OPS = torch.library.Library('gmt', 'DEF')  # the namespace of register_op's ops


@functools.cache
def kernel_counters():
    """The kernel wrappers of KERNEL_COUNTERS, in its order."""
    import importlib

    return tuple(getattr(importlib.import_module(f'{__package__}.{mod}'), fn)
                 for mod, fn in KERNEL_COUNTERS)


def resolve_device(name=''):
    """'' or 'cuda[:i]' -> the CUDA device (raises without one); 'cpu' ->
    the CPU. Anything else raises."""
    name = str(name or 'cuda')
    if name.split(':')[0] not in ('cuda', 'cpu'):
        raise ValueError(f'--device={name}: the port runs on cuda or cpu')
    dev = torch.device(name)
    if dev.type == 'cpu':
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f'--device={name} asks for CUDA, but '
            'torch.cuda.is_available() is False; pass --device=cpu to run '
            'on the CPU'
        )
    # the plain PyTorch versions of the kernels run on the card too (the
    # per-op decode chain, the dense layers of the full forward, the
    # comparisons in chip_smoke.py); they round operands to bf16 and then
    # multiply in f32, which TF32 would silently truncate again
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


@contextlib.contextmanager
def deterministic_convs():
    """A context in which cuDNN takes deterministic algorithms only, its
    other flags (TF32 off on the card) untouched: its transposed convs may
    otherwise not be, and a seeded request would not give the same batch
    twice."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def matmul_dtype(device):
    """Matmul operand dtype: bf16 on the card (f32 accumulation), exact f32
    on the CPU so the tests hold the algorithm against the JAX package."""
    return torch.bfloat16 if torch.device(device).type == 'cuda' else torch.float32


def round_up(x, m):
    return ((x + m - 1) // m) * m


# the tiling of ops/csrc/stream_gemm.cuh (Kernels G and J, and I's s8
# sibling): 64 rows a block, 32-deep K tiles (64-deep for I), at most 8 K
# splits (one cluster); H100_SMS is the card the split aims to fill when no
# device is given
SPLIT_K_BM, SPLIT_K_KT, SPLIT_K_MAX = 64, 32, 8
H100_SMS = 132


def plan_split_k(M, K, N, bn, sms=H100_SMS, kt=SPLIT_K_KT):
    """(splits, kper) for stream_gemm.cuh: K's kt-deep tiles cut into
    `splits` runs of `kper` tiles, one block each, so that the (M/64) x
    (N/bn) output strips times the splits reach about two blocks on each
    of `sms` SMs (a block's tile chain is latency-bound: a second block
    hides it). At most SPLIT_K_MAX splits and no more than there are tiles;
    every tile in exactly one split and no split empty (the kernel refuses
    anything else). K=0 is one split of one (empty) tile."""
    k_tiles = max(1, -(-K // kt))
    strips = -(-M // SPLIT_K_BM) * -(-N // bn)
    splits = max(1, min(SPLIT_K_MAX, k_tiles, -(-2 * sms // strips)))
    kper = -(-k_tiles // splits)
    return -(-k_tiles // kper), kper


@functools.cache
def sm_count(index):
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _nvcc():
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(nvcc):
        raise RuntimeError('nvcc not found (PATH or /usr/local/cuda/bin)')
    return nvcc


def _lib_path(name):
    h = hashlib.sha256()
    for p in [CSRC / f'{name}.cu', *sorted(CSRC.glob('*.cuh'))]:
        h.update(p.name.encode() + p.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def build_kernels(names=KERNEL_SOURCES):
    """Compile every named csrc/<name>.cu that is not built yet, one nvcc
    process per source, all started together; each library's ptxas report
    goes beside it as a .log. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f'--- nvcc {name}.cu (rc {proc.returncode}) ---\n{log}')
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        out.with_suffix('.log').write_text(log)
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))


def load_kernel(name):
    """ctypes handle of csrc/<name>.cu's library, building it if needed."""
    with _LIBS_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                t0 = time.time()
                build_kernels([name])
                print(f'built {path.name} in {time.time() - t0:.1f}s', flush=True)
            lib = _LIBS[name] = ctypes.CDLL(str(path))
            lib.gmt_error_string.argtypes = [ctypes.c_int]
            lib.gmt_error_string.restype = ctypes.c_char_p
        return lib


@functools.cache
def c_function(lib_name, fn_name, n_ptr, n_int=0, n_float=0):
    """The library's C function with its argtypes set: n_ptr pointers, then
    n_int ints, then n_float floats, then the stream. Returns cudaError_t.
    Cached, so a launch pays for the lookup once."""
    lib = load_kernel(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
        + [ctypes.c_float] * n_float + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def launch(lib_name, fn, *args):
    """Call a kernel's C entry on the current stream of the current device;
    raise if it returns a CUDA error (a refused launch never runs, and a
    later synchronize would not report it)."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        msg = load_kernel(lib_name).gmt_error_string(rc).decode()
        raise RuntimeError(f'{lib_name} kernel launch failed: {msg} ({rc})')


def register_op(name, schema, cuda, cpu, fake):
    """Define the op gmt::<name><schema> with its CUDA implementation (the
    kernel's launch), its CPU one (the plain version) and its fake one (the
    output's shape and dtype, which torch.export traces). The lightest
    registration export takes: the dispatcher calls the Python function
    directly, with no custom_op wrapper around it. Returns the op."""
    OPS.define(name + schema)
    OPS.impl(name, cuda, 'CUDA')
    OPS.impl(name, cpu, 'CPU')
    torch.library.register_fake(f'gmt::{name}', fake, lib=OPS)
    return getattr(torch.ops.gmt, name)


def check_cuda(name, t, dtype, shape=None):
    """Refuse a tensor a kernel does not take: it must lie on the current
    CUDA device, have the dtype and shape given, and be contiguous."""
    if t.device.type != 'cuda':
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f'{name}: tensor on {t.device}, current device is '
            f'cuda:{torch.cuda.current_device()}'
        )
    if t.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype}, got {t.dtype}')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')


def dense(x, layer, reduce=None):
    """nn.Linear applied under the operand policy: operands rounded to
    matmul_dtype(x.device), product and sum in f32. A plain matmul outside
    any kernel, as the JAX package left these to XLA. reduce, where given,
    acts on the product before the bias (a row-parallel Linear's
    tp_reduce)."""
    dt = matmul_dtype(x.device)
    y = torch.matmul(x.to(dt).float(), layer.weight.to(dt).float().t())
    if reduce is not None:
        y = reduce(y)
    return y if layer.bias is None else y + layer.bias
