"""Masked dense layer (Kernels G and H).

Counterpart of generative_models_tpu/ops/masked_dense.py:

  masked_matmul    -- Kernel G (ops/csrc/masked_dense.cu on the tensor cores,
                      K split as plan_split_k says): x @ (w * m), the mask
                      applied to each w tile inside the K loop. With
                      trans_b, w and m are read as (N, K): dX = g @ (w * m)^T
                      without a transposed copy of either.
  mask_out_matmul  -- Kernel H (same file, on the tensor cores: 64 x 128
                      output tiles, mma.sync on ldmatrix.trans fragments):
                      m * (a^T @ b), the mask applied once to the f32 sum,
                      a read as stored (K, M): dW = m * (x^T g) without a
                      transposed copy of x (0.012 ms at made's 2048x2048
                      layer on an H100 with L2 flushed, 1.8x its byte
                      bound: PERF.md section 6).
  masked_dense     -- the layer y = x @ (w * m) + b. With use_kernel it is
                      the MaskedDense autograd Function (forward G, backward
                      G on the transposed operands for dX and H for dW), as
                      the JAX package's custom_vjp; without, the plain
                      fold-the-mask product, as the JAX package's XLA path.
  prefer_kernel    -- the reference's shape gate, unchanged.

Each wrapper launches its kernel for CUDA tensors (and refuses what it does
not take) and runs the plain version for CPU tensors. masked_matmul, on
made's serving path, is the torch.library op gmt::masked_matmul
(ops/common.py register_op), whose CUDA implementation counts the launches;
mask_out_matmul, on the training path only, is a plain function. The plain versions
take their operand dtype from matmul_dtype, as _pallas_masked_matmul does:
bf16 on the card (f32 products and sums), f32 on the CPU. The kernels read
f32 x, w, a and b and round them to bf16 themselves, and a uint8 {0, 1}
mask. Outputs are f32; the bias stays outside the kernels.
"""

import torch

from generative_models_tpu_torch.ops.common import (
    c_function, check_cuda, launch, matmul_dtype, plan_split_k, register_op, sm_count,
)

MASKED_MATMUL_BN = 64  # Kernel G's output columns a block (MM_BN in the source)


def masked_matmul_plain(x, w, m):
    """x (M, K) @ (w (K, N) * m (K, N)) -> (M, N) f32, operands rounded to
    matmul_dtype(x.device)."""
    dt = matmul_dtype(x.device)
    return x.to(dt).float() @ (w.to(dt).float() * m)


def mask_out_matmul_plain(a, b, m):
    """m (M, N) * (a (M, K) @ b (K, N)) -> (M, N) f32, operands rounded to
    matmul_dtype(a.device)."""
    dt = matmul_dtype(a.device)
    return m * (a.to(dt).float() @ b.to(dt).float())


def _masked_matmul_cuda(x, w, m, trans_b=False):
    """gmt::masked_matmul on the card: Kernel G, K split as plan_split_k
    says."""
    M, K = x.shape
    N = w.shape[0] if trans_b else w.shape[1]
    wshape = (N, K) if trans_b else (K, N)
    check_cuda('masked_matmul x', x, torch.float32, (M, K))
    check_cuda('masked_matmul w', w, torch.float32, wshape)
    check_cuda('masked_matmul mask', m, torch.uint8, wshape)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M and N:
        splits, kper = plan_split_k(M, K, N, MASKED_MATMUL_BN, sm_count(x.device.index))
        fn = c_function('masked_dense', 'gmt_masked_matmul', 4, 6)
        launch('masked_dense', fn, x.data_ptr(), w.data_ptr(), m.data_ptr(),
               out.data_ptr(), M, K, N, int(trans_b), splits, kper)
        masked_matmul.launches += 1
    return out


def _masked_matmul_cpu(x, w, m, trans_b=False):
    return masked_matmul_plain(x, w.t(), m.t()) if trans_b else masked_matmul_plain(x, w, m)


_masked_matmul_op = register_op(
    'masked_matmul', '(Tensor x, Tensor w, Tensor m, bool trans_b=False) -> Tensor',
    _masked_matmul_cuda, _masked_matmul_cpu,
    lambda x, w, m, trans_b=False: x.new_empty(
        (x.shape[0], w.shape[0] if trans_b else w.shape[1]), dtype=torch.float32))


def masked_matmul(x, w, m, trans_b=False):
    """Kernel G, the op gmt::masked_matmul. x (M, K) f32; w (K, N) f32 and
    m (K, N) uint8, or both (N, K) with trans_b; contiguous on the card ->
    x @ (w * m) (M, N) f32. CPU tensors take masked_matmul_plain."""
    args = (x.detach(), w.detach(), m.detach(), trans_b)
    if x.device.type not in ('cpu', 'cuda'):  # the kernel's checks refuse it
        return _masked_matmul_cuda(*args)
    return _masked_matmul_op(*args)


masked_matmul.launches = 0


def mask_out_matmul(a, b, m):
    """Kernel H. a (K, M) f32, read as stored; b (K, N) f32; m (M, N) uint8;
    contiguous on the card -> m * (a^T @ b) (M, N) f32, exactly 0 where m is
    0. CPU tensors take mask_out_matmul_plain."""
    a, b, m = a.detach(), b.detach(), m.detach()
    if a.device.type == 'cpu':
        return mask_out_matmul_plain(a.t(), b, m)
    K, M = a.shape
    N = b.shape[1]
    check_cuda('mask_out_matmul a', a, torch.float32, (K, M))
    check_cuda('mask_out_matmul b', b, torch.float32, (K, N))
    check_cuda('mask_out_matmul mask', m, torch.uint8, (M, N))
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M and N:
        fn = c_function('masked_dense', 'gmt_mask_out_matmul', 4, 3)
        launch('masked_dense', fn, a.data_ptr(), b.data_ptr(), m.data_ptr(),
               out.data_ptr(), M, K, N)
        mask_out_matmul.launches += 1
    return out


mask_out_matmul.launches = 0


def prefer_kernel(K, N):
    """The JAX package's shape gate (prefer_pallas): the kernel route once a
    (K, N) f32 masked weight passes 8 MiB. The threshold came from TPU
    timings and is kept as it is, so the port takes the reference's
    routes."""
    return K * N * 4 > 8 * 1024 * 1024


class MaskedDense(torch.autograd.Function):
    """y = x @ (w * m) + b through Kernel G, with the reference's VJP:
    dX by G on the transposed operands, dW by H, db = g.sum(0). dX is
    skipped when x needs no gradient (layer 0, whose input is the data).
    x (B, K), w (K, N), b (N,) f32; m (K, N) {0, 1}."""

    @staticmethod
    def forward(ctx, x, w, b, m):
        x = x.contiguous()
        ctx.save_for_backward(x, w, m)
        return masked_matmul(x, w, m) + b

    @staticmethod
    def backward(ctx, g):
        x, w, m = ctx.saved_tensors
        g = g.contiguous()
        dx = masked_matmul(g, w, m, trans_b=True) if ctx.needs_input_grad[0] else None
        dw = mask_out_matmul(x, g, m) if ctx.needs_input_grad[1] else None
        db = g.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None


def masked_dense(x, w, b, m, use_kernel=True):
    """x (..., K) @ (w * m) + b -> (..., N) f32. use_kernel: MaskedDense
    (Kernels G and H on the card), or without autograd its forward, Kernel
    G; otherwise the fold-the-mask product under
    the operand policy, which autograd differentiates."""
    x2d = x.reshape(-1, x.shape[-1])
    if use_kernel and torch.is_grad_enabled():
        y = MaskedDense.apply(x2d, w, b, m)
    elif use_kernel:  # MaskedDense's forward alone, which torch.export traces
        y = masked_matmul(x2d.contiguous(), w, m) + b
    else:
        y = masked_matmul_plain(x2d, w, m) + b
    return y.reshape(*x.shape[:-1], w.shape[-1])
