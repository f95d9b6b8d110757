"""The port's data pipeline (generative_models_tpu_torch/data/mnist.py)
against the JAX package's on the CPU: the checked-in idx fixture and the
synthetic set and the digits fallback bit for bit, the
transforms, first_test_batch's indices, and drop-last epochs. About 7 s
here."""

import gzip
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import generative_models_tpu.data.mnist as jm
import generative_models_tpu_torch.data.mnist as tm
from generative_models_tpu.utils.config import global_defaults as jax_defaults
from generative_models_tpu_torch.utils.config import global_defaults

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / 'fixtures' / 'mnist_idx'


@pytest.fixture()
def small_splits(monkeypatch):
    # multiples of 8: the JAX Dataset shards its batch axis over 8 CPU devices
    for m in (jm, tm):
        monkeypatch.setattr(m, 'TRAIN_N', 96)
        monkeypatch.setattr(m, 'TEST_N', 32)


def _both(source, data_dir=FIXTURE, binarize=1, pad32=0, bs=16):
    Gs = []
    for G in (jax_defaults(), global_defaults()):
        G.update(data_source=source, data_dir=Path(data_dir), binarize=binarize,
                 pad32=pad32, bs=bs)
        Gs.append(G)
    return jm.load_mnist(Gs[0]), tm.load_mnist(Gs[1], torch.device('cpu'))


def _splits(ds):
    return [np.asarray(a) for a in (ds.train_x, ds.train_y, ds.test_x, ds.test_y)]


@pytest.mark.parametrize('binarize,pad32', [(1, 0), (0, 1), (1, 1)])
def test_idx_fixture_is_bit_equal(binarize, pad32):
    jd, td = _both('mnist', binarize=binarize, pad32=pad32)
    for a, b in zip(_splits(jd), _splits(td)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert td.train_x.shape == (64, 32 if pad32 else 28, 32 if pad32 else 28, 1)


def test_synthetic_is_bit_equal(small_splits):
    jd, td = _both('synthetic')
    for a, b in zip(_splits(jd), _splits(td)):
        np.testing.assert_array_equal(a, b)


def test_digits_within_float_rounding(small_splits):
    """The port reads jax.image.resize's upsampled values from
    data/digits.npz, so every pixel is the JAX package's, binarised or
    not."""
    pytest.importorskip('sklearn')
    jx, jy, jt, jty = jm._load_digits_upsampled()
    tx, ty, tt, tty = tm._load_digits_upsampled()
    for a, b in ((tx, jx), (ty, jy), (tt, jt), (tty, jty)):
        np.testing.assert_array_equal(a, b)
    for binarize in (0, 1):
        jd, td = _both('digits', binarize=binarize)
        for a, b in zip(_splits(jd), _splits(td)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('layout', ['flat', 'MNIST/raw', 'mnist'])
def test_idx_layouts_raw_and_gz(tmp_path, layout):
    d = tmp_path / 'data'
    sub = d if layout == 'flat' else d / layout
    sub.mkdir(parents=True)
    for i, p in enumerate(sorted(FIXTURE.glob('*.gz'))):
        if i % 2:  # half of the files unpacked to raw idx
            (sub / p.stem).write_bytes(gzip.decompress(p.read_bytes()))
        else:
            shutil.copy(p, sub / p.name)
    ref = tm._load_mnist_idx(FIXTURE)
    got = tm._load_mnist_idx(d)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert tm._load_mnist_idx(tmp_path / 'nothing') is None


def test_idx_parse_refuses_a_bad_header():
    with pytest.raises(ValueError, match='idx header'):
        tm.idx_parse(b'\x01\x00\x08\x01\x00\x00\x00\x01\x05')


def test_first_test_batch_indices_equal():
    jd, td = _both('mnist', bs=8)
    for epoch in (0, 1, 5):
        jx, jy = jd.first_test_batch(epoch)
        tx, ty = td.first_test_batch(epoch)
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())


def test_epoch_batches_drop_last(small_splits):
    # unbinarised, so every image keeps its own noise; 96 // 20 = 4 steps,
    # 32 // 20 = 1
    _, td = _both('synthetic', binarize=0, bs=20)
    g = lambda seed: torch.Generator().manual_seed(seed)
    bx, by = td.epoch_batches(g(0))
    assert bx.shape == (4, 20, 28, 28, 1) and by.shape == (4, 20)
    assert td.steps_per_epoch == 4 and td.test_steps == 1
    tx, ty = td.epoch_batches(g(0), train=False)
    assert tx.shape == (1, 20, 28, 28, 1) and ty.shape == (1, 20)
    # 80 distinct rows of the split with their labels; the same order from
    # the same seed
    full = td.train_x.reshape(96, -1)
    idx = [int((full == r).all(1).nonzero()[0, 0]) for r in bx.reshape(80, -1)]
    assert len(set(idx)) == 80
    assert torch.equal(td.train_y[idx], by.reshape(80))
    assert torch.equal(td.epoch_batches(g(0))[0], bx)
    assert not torch.equal(td.epoch_batches(g(1))[0], bx)
