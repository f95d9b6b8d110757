"""The K split of Kernels G, J and I (generative_models_tpu_torch/ops/common.py
plan_split_k, the grid of ops/csrc/stream_gemm.cuh): at every product of
made's kernel route at hidden_size=2048 (G), of the w8a16 serving paths (J)
and of the w8a8 ones (I, 64-deep tiles), and at the ragged shapes the chip
run checks, every K tile lies in exactly one split, no split is empty, and
there are at most 8 splits (one cluster) and no more than tiles. The splits
of a strip meet in the cluster's shared memory, so there is no scratch
buffer to size. The grids of the path shapes are pinned."""

import pytest

from generative_models_tpu_torch.ops.common import (
    H100_SMS, SPLIT_K_BM, SPLIT_K_KT, SPLIT_K_MAX, plan_split_k,
)
from generative_models_tpu_torch.ops.int8 import DEQUANT_GEMM_BN, INT8_GEMM_BN, INT8_GEMM_KT
from generative_models_tpu_torch.ops.masked_dense import MASKED_MATMUL_BN

G, J = MASKED_MATMUL_BN, DEQUANT_GEMM_BN

# (M, K, N, bn) -> (splits, kper): made at 2048 (a forward at bs=64 or 25
# samples, dX read as (N, K)), then the w8a16 serving products
PATH_PLANS = {
    (64, 2048, 2048, G): (8, 8), (64, 784, 2048, G): (7, 4), (64, 2048, 784, G): (8, 8),
    (25, 2048, 2048, G): (8, 8), (25, 784, 2048, G): (7, 4), (25, 2048, 784, G): (8, 8),
    (64, 128, 128, J): (4, 1), (64, 128, 512, J): (4, 1), (64, 512, 128, J): (8, 2),
    (64, 64, 256, J): (2, 1), (64, 256, 256, J): (8, 1), (64, 256, 1024, J): (8, 1),
    (64, 1024, 256, J): (8, 4), (64, 256, 64, J): (8, 1), (64, 784, 1024, J): (7, 4),
    (64, 1024, 1024, J): (8, 4), (64, 1024, 784, J): (8, 4),
}
# (M, K, N) -> (splits, kper) of Kernel I: the w8a8 serving products
# (pixel_transformer, the vqvae prior, made at hidden_size=1024), 32
# columns a block, 64-deep K tiles
I_PLANS = {
    (64, 128, 128): (2, 1), (64, 128, 512): (2, 1), (64, 512, 128): (8, 1),
    (64, 64, 256): (1, 1), (64, 256, 256): (4, 1), (64, 256, 1024): (4, 1),
    (64, 1024, 256): (8, 2), (64, 256, 64): (4, 1), (64, 784, 1024): (7, 2),
    (64, 1024, 1024): (8, 2), (64, 1024, 784): (8, 2),
}
RAGGED = [(10, 72, 136), (6, 130, 70), (80, 40, 136), (200, 784, 130), (72, 40, 130),
          (80, 130, 70), (64, 0, 128), (1, 1, 1), (4096, 32, 8), (3, 100000, 16)]


def _cdiv(a, b):
    return -(-a // b)


def _check(M, K, N, bn, kt=SPLIT_K_KT):
    splits, kper = plan_split_k(M, K, N, bn, kt=kt)
    k_tiles = max(1, _cdiv(K, kt))
    assert 1 <= splits <= min(SPLIT_K_MAX, k_tiles) and kper >= 1
    runs = [range(s * kper, min((s + 1) * kper, k_tiles)) for s in range(splits)]
    assert all(len(r) for r in runs)  # no empty split
    assert [t for r in runs for t in r] == list(range(k_tiles))  # each tile once, in order
    strips = _cdiv(M, SPLIT_K_BM) * _cdiv(N, bn)
    # splits for two blocks an SM, up to a cluster and the tiles there are
    want = min(SPLIT_K_MAX, k_tiles, _cdiv(2 * H100_SMS, strips))
    assert splits == _cdiv(k_tiles, _cdiv(k_tiles, want))
    return splits, kper


@pytest.mark.parametrize('M,K,N,bn', sorted(PATH_PLANS))
def test_path_shapes_split_k_as_pinned(M, K, N, bn):
    assert _check(M, K, N, bn) == PATH_PLANS[M, K, N, bn]


@pytest.mark.parametrize('bn', [G, J])
@pytest.mark.parametrize('M,K,N', RAGGED)
def test_ragged_shapes_cover_every_k_tile_once(M, K, N, bn):
    _check(M, K, N, bn)


@pytest.mark.parametrize('M,K,N', sorted(I_PLANS))
def test_int8_path_shapes_split_k_as_pinned(M, K, N):
    assert (INT8_GEMM_BN, INT8_GEMM_KT) == (32, 64)
    assert _check(M, K, N, INT8_GEMM_BN, INT8_GEMM_KT) == I_PLANS[M, K, N]


@pytest.mark.parametrize('M,K,N', RAGGED)
def test_int8_ragged_shapes_cover_every_k_tile_once(M, K, N):
    _check(M, K, N, INT8_GEMM_BN, INT8_GEMM_KT)


def test_a_smaller_card_takes_no_more_splits():
    for M, K, N, bn in PATH_PLANS:
        assert plan_split_k(M, K, N, bn, sms=66)[0] <= plan_split_k(M, K, N, bn)[0]
