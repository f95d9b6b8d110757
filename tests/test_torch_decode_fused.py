"""The port's decode-step kernels (generative_models_tpu_torch/ops/
decode_fused.py) against the JAX package's Pallas kernels in interpret mode,
on the CPU: the same numpy-seeded inputs through both, f32 throughout, at the
tolerance tests/test_decode_fused.py uses (rtol 1e-4, atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops import decode_fused as jdf
from generative_models_tpu_torch.ops import decode_fused as tdf

torch.set_num_threads(1)

B, C = 3, 32


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _tail_params(rng):
    return dict(
        wproj=_f32(rng, C, C, scale=C ** -0.5), bproj=_f32(rng, C, scale=0.1),
        ln2_scale=1 + _f32(rng, C, scale=0.1), ln2_bias=_f32(rng, C, scale=0.1),
        wfc1=_f32(rng, C, 4 * C, scale=C ** -0.5), bfc1=_f32(rng, 4 * C, scale=0.1),
        wfc2=_f32(rng, 4 * C, C, scale=(4 * C) ** -0.5), bfc2=_f32(rng, C, scale=0.1),
    )


@pytest.mark.parametrize('N', [96, 1])
def test_ln_matmul_matches_jax(N):
    rng = np.random.RandomState(N)
    args = (
        _f32(rng, B, C), 1 + _f32(rng, C, scale=0.1), _f32(rng, C, scale=0.1),
        _f32(rng, C, N, scale=C ** -0.5), _f32(rng, N, scale=0.1),
    )
    ref = np.asarray(jdf.ln_matmul(*map(jnp.asarray, args), interpret=True))
    before = tdf.ln_matmul.launches
    got = tdf.ln_matmul(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == (B, N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    assert tdf.ln_matmul.launches == before  # CPU tensors launch nothing


def test_block_tail_matches_jax():
    rng = np.random.RandomState(0)
    x, y = _f32(rng, B, C), _f32(rng, B, C)
    lp = _tail_params(rng)
    ref = jdf.block_tail(
        jnp.asarray(x), jnp.asarray(y),
        {k: jnp.asarray(v) for k, v in lp.items()}, interpret=True,
    )
    got = tdf.block_tail(
        torch.from_numpy(x), torch.from_numpy(y),
        {k: torch.from_numpy(v) for k, v in lp.items()},
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_plain_versions_round_operands_to_dtype():
    """With dtype=bf16 the plain versions multiply bf16-rounded operands in
    f32: the same result as feeding pre-rounded f32 inputs at dtype=f32."""
    rng = np.random.RandomState(1)
    x, y = torch.from_numpy(_f32(rng, B, C)), torch.from_numpy(_f32(rng, B, C))
    lp = {k: torch.from_numpy(v) for k, v in _tail_params(rng).items()}
    rnd = lambda t: t.to(torch.bfloat16).float()
    w = {k: rnd(v) if k.startswith('w') else v for k, v in lp.items()}
    # block_tail rounds y; its inner activations are rounded in both runs
    np.testing.assert_array_equal(
        tdf.block_tail_plain(x, y, lp, dtype=torch.bfloat16).numpy(),
        tdf.block_tail_plain(x, rnd(y), w, dtype=torch.bfloat16).numpy(),
    )
    s, b = torch.ones(C), torch.zeros(C)
    wq, bq = lp['wfc1'], lp['bfc1']
    h = tdf._ln(x, s, b)
    np.testing.assert_array_equal(
        tdf.ln_matmul_plain(x, s, b, wq, bq, dtype=torch.bfloat16).numpy(),
        (rnd(h) @ rnd(wq) + bq).numpy(),
    )


def test_wrappers_refuse_tensors_off_the_cpu_without_a_kernel():
    """Only CPU tensors take the plain path: any other device goes to the
    kernel's checks, which refuse what is not a CUDA tensor."""
    x = torch.zeros((B, C), device='meta')
    v = torch.zeros((C,), device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        tdf.ln_matmul(x, v, v, torch.zeros((C, 4), device='meta'), torch.zeros(4, device='meta'))
    lp = {k: torch.zeros(v.shape, device='meta') for k, v in _tail_params(np.random.RandomState(0)).items()}
    with pytest.raises(ValueError, match='CUDA tensor'):
        tdf.block_tail(x, x, lp)


# Kernel B's layout (plan_block_tail, the launch of ops/csrc/decode_fused.cu
# block_tail_kernel) at the two serving widths: pixel_transformer's C=128
# over 8 blocks, the vqvae prior's C=256 over 16, every weight tile resident
def test_block_tail_plan_pinned():
    assert tdf.plan_block_tail(128) == tdf.BlockTailPlan(8, 16, 64, 6, 80128)
    assert tdf.plan_block_tail(256) == tdf.BlockTailPlan(16, 16, 64, 12, 156928)
    for C in (128, 256):
        p = tdf.plan_block_tail(C)
        assert p.slots == tdf.block_tail_tiles(C, p.P, p.F)


@pytest.mark.parametrize('cluster', [None, 8, 16])
def test_block_tail_plan_owns_every_column_once(cluster):
    """At every C from 1 to 512: proj's (and the output's) C columns and
    fc1's 4C hidden columns (fc2's K) each belong to exactly one block of
    the cluster, in whole 16-column groups from block 0 on; the shared
    memory stays within a block's 232448 bytes, with 2 to 24 ring slots.
    Blocks past the last owned group own nothing and still take part."""
    for C in range(1, tdf.BT_MAX_C + 1):
        p = tdf.plan_block_tail(C, cluster)
        assert p.P % 16 == 0 and p.F % 16 == 0
        for width, per in ((C, p.P), (4 * C, p.F)):
            owned = [c for r in range(p.cluster) for c in range(r * per, min((r + 1) * per, width))]
            assert owned == list(range(width))
        assert p.smem <= tdf.SMEM_MAX and 2 <= p.slots <= tdf.BT_MAX_SLOTS
        assert p.smem == tdf.block_tail_smem(C, p.cluster, p.P, p.F, p.slots)
    with pytest.raises(ValueError):
        tdf.plan_block_tail(tdf.BT_MAX_C + 16)


@pytest.mark.parametrize('C', [48, 100, 128, 144])
def test_block_tail_plan_computes_the_block(C):
    """The plan's decomposition, emulated in f32 on the CPU: h1's column
    slices, LN2 over the gathered rows, each block's hidden slice through
    fc1 and its K slice of fc2, the blocks' partial sums added in rank
    order; equal to block_tail_plain within f32 reordering."""
    rng = np.random.RandomState(C)
    x, y = (torch.from_numpy(_f32(rng, 5, C)) for _ in range(2))
    lp = {k: torch.from_numpy(v) for k, v in dict(
        wproj=_f32(rng, C, C, scale=C ** -0.5), bproj=_f32(rng, C, scale=0.1),
        ln2_scale=1 + _f32(rng, C, scale=0.1), ln2_bias=_f32(rng, C, scale=0.1),
        wfc1=_f32(rng, C, 4 * C, scale=C ** -0.5), bfc1=_f32(rng, 4 * C, scale=0.1),
        wfc2=_f32(rng, 4 * C, C, scale=(4 * C) ** -0.5), bfc2=_f32(rng, C, scale=0.1),
    ).items()}
    p = tdf.plan_block_tail(C)
    h1 = torch.empty_like(x)
    for r in range(p.cluster):
        cols = slice(r * p.P, min((r + 1) * p.P, C))
        h1[:, cols] = x[:, cols] + (y @ lp['wproj'][:, cols] + lp['bproj'][cols])
    g = tdf._ln(h1, lp['ln2_scale'], lp['ln2_bias'])
    total = None
    for r in range(p.cluster):
        hc = slice(r * p.F, min((r + 1) * p.F, 4 * C))
        hid = torch.nn.functional.gelu(g @ lp['wfc1'][:, hc] + lp['bfc1'][hc], approximate='tanh')
        part = hid @ lp['wfc2'][hc, :]
        total = part if total is None else total + part
    got = h1 + (total + lp['bfc2'])
    np.testing.assert_allclose(got.numpy(), tdf.block_tail_plain(x, y, lp).numpy(),
                               rtol=1e-5, atol=1e-5)


# Kernel A's layout (plan_ln_matmul, the launch of ops/csrc/decode_fused.cu
# gmt_ln_matmul) at the four path shapes: pixel_transformer's LN1 + qkv and
# ln_f + head (the dot route), the vqvae prior's LN1 + qkv and head
def test_ln_matmul_plan_pinned():
    P = tdf.LnMatmulPlan
    assert tdf.plan_ln_matmul(64, 128, 384) == P('mma', (6, 4), 256, 16, 64, True, 4, 2, 22784)
    assert tdf.plan_ln_matmul(64, 128, 1) == P('dot', (16, 1), 128, 4, 1, False, 4, 0, 0)
    assert tdf.plan_ln_matmul(64, 256, 768) == P('mma', (12, 4), 256, 16, 64, True, 8, 4, 45312)
    assert tdf.plan_ln_matmul(64, 256, 64) == P('mma', (1, 4), 256, 16, 64, True, 8, 4, 45312)


def _plan_tiles(plan, B, N):
    """(rows, columns) of each block of an ln_matmul plan."""
    gx, gy = plan.grid
    if plan.route == 'dot':
        return [(range(i * plan.rows, min((i + 1) * plan.rows, B)), range(N)) for i in range(gx)]
    return [(range(y * plan.rows, min((y + 1) * plan.rows, B)),
             range(x * plan.cols, min((x + 1) * plan.cols, N)))
            for y in range(gy) for x in range(gx)]


@pytest.mark.parametrize('C', [48, 100, 128, 256, 4096])
def test_ln_matmul_plan_owns_every_output_once(C):
    """Every output of (B, N) belongs to exactly one block, the shared
    memory fits a block's 232448 bytes, N < 8 takes the dot route (a warp a
    row) and the tensor cores otherwise, and 16-byte loads are taken only
    where N % 8 == 0, C % 4 == 0 and the pointers are aligned."""
    B = 70
    for N in (1, 7, 8, 64, 96, 384):
        plan = tdf.plan_ln_matmul(B, C, N)
        owned = sorted((r, c) for rows, cols in _plan_tiles(plan, B, N) for r in rows for c in cols)
        assert owned == [(r, c) for r in range(B) for c in range(N)]
        assert plan.route == ('dot' if N < 8 else 'mma')
        assert plan.vec == (N % 8 == 0 and C % 4 == 0)
        assert not tdf.plan_ln_matmul(B, C, N, aligned=False).vec
        assert plan.smem <= tdf.SMEM_MAX
        if plan.route == 'mma':
            assert plan.smem == tdf.ln_matmul_smem(C, plan.stages)
            assert plan.stages == min(-(-C // tdf.LM_KC), tdf.LM_STAGES)
    assert tdf.plan_ln_matmul(B, 6096, 64).smem <= tdf.SMEM_MAX
    with pytest.raises(ValueError):
        tdf.plan_ln_matmul(B, 6097, 64)


def _emulate_ln_matmul(x, scale, bias, w, b):
    """Kernel A's arithmetic block by block from its plan, in f32 on the
    CPU: each block's rows normalised and rounded to bf16 (zero from C to a
    multiple of 16), its slice of w rounded to bf16, and the product summed
    over 16-deep k steps in order into two sums, of the even and the odd
    steps, added at the end (the dot route: one sum over C)."""
    B, C = x.shape
    N = w.shape[1]
    plan = tdf.plan_ln_matmul(B, C, N)
    rnd = lambda t: t.to(torch.bfloat16).float()
    out = torch.full((B, N), float('nan'))
    for rows, cols in _plan_tiles(plan, B, N):
        r, c = slice(rows.start, rows.stop), slice(cols.start, cols.stop)
        h = rnd(tdf._ln(x[r], scale, bias))
        wc = rnd(w[:, c])
        if plan.route == 'dot':
            acc = h @ wc
        else:
            acc = [torch.zeros((len(rows), len(cols))) for _ in range(2)]
            for i, k in enumerate(range(0, C, 16)):
                acc[i % 2] = acc[i % 2] + h[:, k:k + 16] @ wc[k:k + 16]
            acc = acc[0] + acc[1]
        out[r, c] = acc + b[c]
    return out


@pytest.mark.parametrize('B,C,N', [(64, 128, 384), (64, 128, 1), (64, 256, 768), (64, 256, 64),
                                   (25, 100, 96), (70, 48, 7), (1, 1024, 8)])
def test_ln_matmul_plan_computes_the_product(B, C, N):
    """The emulated kernel (bf16 rows, 16-deep k steps, the plan's blocks)
    holds ln_matmul_plain(dtype=bf16) within chip_smoke.py's atol 1e-2 +
    rtol 1e-2, and leaves no output unwritten."""
    rng = np.random.RandomState(B + C + N)
    x = torch.from_numpy(_f32(rng, B, C))
    s, b = 1 + torch.from_numpy(_f32(rng, C, scale=0.1)), torch.from_numpy(_f32(rng, C, scale=0.1))
    w = torch.from_numpy(_f32(rng, C, N, scale=C ** -0.5))
    bias = torch.from_numpy(_f32(rng, N, scale=0.1))
    got = _emulate_ln_matmul(x, s, b, w, bias)
    ref = tdf.ln_matmul_plain(x, s, b, w, bias, dtype=torch.bfloat16)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-2, rtol=1e-2)
