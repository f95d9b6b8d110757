"""Int8 quantized products for serving (Kernels I and J).

Counterpart of generative_models_tpu/ops/int8.py:

  quantize_int8    -- a (K, N) weight -> (q int8 (K, N), scale f32 (N,)),
                      per-output-column symmetric absmax: w ~= q * scale.
  quantize_rows    -- the w8a8 activation quantization: one absmax scale a
                      row, xq int8 and sx f32 (M, 1).
  int8_gemm        -- Kernel I (ops/csrc/int8.cu, on the int8 tensor cores,
                      K split as plan_split_k says with 64-deep tiles): xq
                      (M, K) int8 @ q (K, N) int8 -> int32, exact.
  dequant_gemm     -- Kernel J (same file, on the tensor cores, K split as
                      plan_split_k says): bf16(x) (M, K) @ q (K, N) int8
                      -> f32, the weight widened on chip.
  int8_matmul      -- y = x @ dequant(q): w8a8 (quantize_rows, I, then
                      acc * sx * scale) or w8a16 (J, then y * scale).
  QuantTable       -- the quantized weights of one model and its mode, the
                      explicit quant= argument of the serving paths:
                      quantize_dense_modules (every large nn.Linear) and
                      quantize_masked_mlp (MADE's layers, mask folded in),
                      built by build_quant_table.

Each kernel wrapper launches its kernel for CUDA tensors (and refuses what
the kernel does not take) and runs the plain version for CPU tensors. The
plain versions: int8_gemm_plain in float64, exact on the card too (f32 is
exact only while K * 127^2 < 2^24, and torch.matmul has no int32 on CUDA);
dequant_gemm_plain takes its operand dtype from matmul_dtype, as the
kernel: bf16 x on the card, f32 on the CPU (where the JAX package's
interpret-mode kernel keeps x f32 too). The rescale stays outside both
kernels, as the JAX package leaves it to XLA.
"""

import torch

from generative_models_tpu_torch.ops.common import (
    c_function, check_cuda, dense, launch, matmul_dtype, plan_split_k, sm_count,
)

DEQUANT_GEMM_BN = 32  # Kernel J's output columns a block (DQ_BN in the source)
INT8_GEMM_BN = 32  # Kernel I's output columns a block (I8_BN in the source)
INT8_GEMM_KT = 64  # Kernel I's K bytes a stage (SG8_KT in stream_gemm.cuh)
INT8_GEMM_MAX_K = 133144  # past it K * 127^2 may overflow int32 (I8_MAX_K)

_ONE27 = {}  # device -> a 0-dim 127.0 on it


def _div127(t):
    """t / 127 as an IEEE division, as the JAX package's. On CUDA torch
    takes a Python-scalar divisor as a multiply by its reciprocal, which
    can differ in the last bit and so move a scale, and then a q, off the
    CPU's; a divisor that is a tensor on the device is divided."""
    c = _ONE27.get(t.device)
    if c is None:
        c = _ONE27[t.device] = torch.tensor(127.0, device=t.device)
    return t / c


def quantize_int8(w):
    """(K, N) float weights -> (q int8 (K, N), scale f32 (N,)) per output
    column: scale = max|w| / 127, then at least 1e-12 (all-zero columns);
    q = clip(round(w / scale), -127, 127), round half to even. q is
    contiguous (K, N), the layout Kernels I and J read, whatever w's
    strides (a Linear's weight arrives transposed)."""
    w = w.detach().float()
    scale = torch.clamp_min(_div127(w.abs().amax(0)), 1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q.contiguous(), scale


def quantize_rows(x2d):
    """(M, K) f32 activations -> (xq int8 (M, K), sx f32 (M, 1)): sx =
    max(max|x|, 1e-12) / 127 (the clamp before the division, the other
    order from the weight's), xq = clip(round(x / sx), -127, 127)."""
    sx = _div127(torch.clamp_min(x2d.abs().amax(1, keepdim=True), 1e-12))
    xq = torch.clamp(torch.round(x2d / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_gemm_plain(x, q):
    """x (M, K) int8 @ q (K, N) int8 -> (M, N) int32, exact: the products
    and sums in float64 (exact while K * 127^2 < 2^53)."""
    return (x.double() @ q.double()).to(torch.int32)


def dequant_gemm_plain(x, q):
    """x (M, K) f32 @ q (K, N) int8 -> (M, N) f32, x rounded to
    matmul_dtype(x.device) and q widened; f32 products and sums."""
    return x.to(matmul_dtype(x.device)).float() @ q.float()


def int8_gemm(x, q):
    """Kernel I. x (M, K) int8, q (K, N) int8, contiguous on the card,
    K <= INT8_GEMM_MAX_K -> (M, N) int32. CPU tensors take
    int8_gemm_plain."""
    if x.device.type == 'cpu':
        return int8_gemm_plain(x, q)
    M, K = x.shape
    N = q.shape[1]
    check_cuda('int8_gemm x', x, torch.int8, (M, K))
    check_cuda('int8_gemm q', q, torch.int8, (K, N))
    if K > INT8_GEMM_MAX_K:
        raise ValueError(f'int8_gemm: K={K} > {INT8_GEMM_MAX_K} may overflow int32 sums')
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    if M and N:
        splits, kper = plan_split_k(M, K, N, INT8_GEMM_BN, sm_count(x.device.index),
                                    kt=INT8_GEMM_KT)
        fn = c_function('int8', 'gmt_int8_gemm', 3, 5)
        launch('int8', fn, x.data_ptr(), q.data_ptr(), out.data_ptr(), M, K, N, splits, kper)
        int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def dequant_gemm(x, q):
    """Kernel J. x (M, K) f32, q (K, N) int8, contiguous on the card ->
    bf16(x) @ q (M, N) f32. CPU tensors take dequant_gemm_plain."""
    if x.device.type == 'cpu':
        return dequant_gemm_plain(x, q)
    M, K = x.shape
    N = q.shape[1]
    check_cuda('dequant_gemm x', x, torch.float32, (M, K))
    check_cuda('dequant_gemm q', q, torch.int8, (K, N))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M and N:
        splits, kper = plan_split_k(M, K, N, DEQUANT_GEMM_BN, sm_count(x.device.index))
        fn = c_function('int8', 'gmt_dequant_gemm', 3, 5)
        launch('int8', fn, x.data_ptr(), q.data_ptr(), out.data_ptr(), M, K, N, splits, kper)
        dequant_gemm.launches += 1
    return out


dequant_gemm.launches = 0


def int8_matmul(x, q, scale, act_quant=True):
    """y = x @ dequant(q) with q int8 (K, N), scale f32 (N,). act_quant
    (w8a8): x quantized a row at a time, Kernel I, then acc * sx * scale;
    otherwise (w8a16) Kernel J, then y * scale. x (..., K) -> (..., N)
    f32."""
    batch_shape = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).float().contiguous()
    if act_quant:
        xq, sx = quantize_rows(x2d)
        y = int8_gemm(xq, q).float() * sx * scale
    else:
        y = dequant_gemm(x2d, q) * scale
    return y.reshape(*batch_shape, q.shape[-1])


# ---------------------------------------------------------------------- #
# serving-side weight quantization
# ---------------------------------------------------------------------- #
def quantize_dense_modules(net, min_dim=64, min_size=16384):
    """{qualified name: (q, scale)} of every nn.Linear in net whose (in,
    out) weight has both dims >= min_dim and >= min_size elements, as
    quantize_dense_tree keys flax's Dense modules by path."""
    table = {}
    for name, mod in net.named_modules():
        if not isinstance(mod, torch.nn.Linear):
            continue
        N, K = mod.weight.shape
        if min(K, N) < min_dim or K * N < min_size:
            continue
        table[name] = quantize_int8(mod.weight.t())
    return table


def quantize_masked_mlp(model, min_size=16384):
    """{'': ((q, scale) per layer)} when model.net is MADE's MaskedMLP,
    each layer's w * mask quantized (the mask a constant at serving time, so
    it folds into the int8 weight); all or nothing: {} if any layer is
    under min_size, or for any other net."""
    from generative_models_tpu_torch.models.made import MaskedMLP

    net = getattr(model, 'net', None)
    if not isinstance(net, MaskedMLP):
        return {}
    layers = []
    for w, _, m in net.layers():
        if w.numel() < min_size:
            return {}
        layers.append(quantize_int8(w * m))
    return {'': tuple(layers)}


class QuantTable:
    """The quantized weights a serving pass applies, and its mode:
    dense {qualified name: (q, scale)} of nn.Linear layers, masked
    {qualified name: ((q, scale) per layer)} of MaskedMLPs, names relative
    to the module the table is handed to (sub moves the root down)."""

    def __init__(self, mode, dense=None, masked=None):
        if mode not in ('w8a8', 'w8a16'):
            raise ValueError(f'unknown quant mode {mode}')
        self.mode = mode
        self.act_quant = mode == 'w8a8'
        self.dense = dict(dense or {})
        self.masked = dict(masked or {})

    def __len__(self):
        return len(self.dense) + sum(len(v) for v in self.masked.values())

    def sub(self, prefix):
        """The entries under module prefix, keyed from that module."""
        cut = lambda d: {k[len(prefix) + 1:]: v for k, v in d.items()
                         if k.startswith(prefix + '.')}
        return QuantTable(self.mode, cut(self.dense), cut(self.masked))

    def linear(self, x, name, layer):
        """layer(x) for the nn.Linear at name: int8_matmul + bias when the
        table holds it, else the plain dense product."""
        if name not in self.dense:
            return dense(x, layer)
        y = int8_matmul(x, *self.dense[name], act_quant=self.act_quant)
        return y if layer.bias is None else y + layer.bias


def build_quant_table(model, mode='w8a8'):
    """(QuantTable over model.net, number of quantized weights), both
    surfaces: every large nn.Linear and MADE's folded masked layers."""
    table = QuantTable(mode, quantize_dense_modules(model.net), quantize_masked_mlp(model))
    return table, len(table)
