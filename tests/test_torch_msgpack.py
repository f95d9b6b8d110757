"""The port's msgpack subset (generative_models_tpu_torch/utils/msgpack.py)
against flax.serialization and the msgpack package: the shipped arbiters'
params decode leaf for leaf and bitwise as flax's msgpack_restore decodes
them, and encode back to the same bytes; a tree of every type the module
takes encodes to flax's msgpack_serialize bytes and is restored by flax to
the same tree; every length form the msgpack package writes decodes; bad
input raises. Exact comparisons throughout."""

import pickle
from pathlib import Path

import jax
import msgpack as msgpack_pkg
import numpy as np
import pytest
from flax import serialization

from generative_models_tpu_torch.utils import msgpack

WEIGHTS = Path(__file__).resolve().parent.parent / 'weights'


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_same_tree(got, ref):
    got, ref = _leaves(got), _leaves(ref)
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, a), (_, b) in zip(got, ref):
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), k
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
        else:
            assert type(a) is type(b) and a == b, k


@pytest.mark.parametrize('name', ['autoencoder', 'classifier'])
def test_the_shipped_params_decode_as_flax_decodes_them(name):
    with open(WEIGHTS / f'{name}.pt', 'rb') as f:
        payload = pickle.load(f)
    tree = msgpack.decode(payload['params'])
    _assert_same_tree(tree, serialization.msgpack_restore(payload['params']))
    leaves = [v for _, v in _leaves(tree)]
    assert len(leaves) == (16 if name == 'autoencoder' else 8)
    assert all(v.dtype == np.float32 and v.flags.writeable for v in leaves)
    assert msgpack.encode(tree) == payload['params']


def _mixed_tree():
    rng = np.random.RandomState(0)
    return {
        'params': {'Conv_0': {'kernel': rng.randn(3, 3, 1, 4).astype(np.float32),
                              'bias': np.zeros(4, np.float32)},
                   'ints': np.arange(5, dtype=np.int32),
                   'empty': np.zeros((0, 3), np.float32), 'f64': rng.randn(2).astype(np.float64),
                   'u8': np.arange(200, dtype=np.uint8)},
        'step': 7, 'neg': -3, 'big': 2 ** 40, 'bigneg': -(2 ** 40), 'u16': 60000, 'i16': -30000,
        'lr': 3e-4, 'none': None, 'flags': [True, False], 'name': 'x' * 40, 'long': 'é' * 300,
        'raw': b'\x00\x01' * 200, 'many': {f'k{i}': i for i in range(20)},
    }


def test_the_encoder_writes_flax_bytes_and_flax_restores_them():
    tree = _mixed_tree()
    enc = msgpack.encode(tree)
    assert enc == serialization.msgpack_serialize(tree)
    restored = serialization.msgpack_restore(enc)
    _assert_same_tree(restored, tree)
    _assert_same_tree(msgpack.decode(enc), tree)


@pytest.mark.parametrize('value', [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
    -32768, -32769, -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63), 1.25, None, True, False,
])
def test_scalars_of_every_width_decode(value):
    packed = msgpack_pkg.packb(value)
    assert msgpack.decode(packed) == value and msgpack.encode(value) == packed
    if isinstance(value, float):  # float 32 too, which the encoder never writes
        assert msgpack.decode(msgpack_pkg.packb(value, use_single_float=True)) == value


@pytest.mark.parametrize('n', [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_containers_and_strings_of_every_length_form_decode(n):
    values = {
        'str': 'a' * n, 'bin': b'b' * n, 'array': list(range(n)),
        'map': {f'{i:06d}': i for i in range(n)},
    }
    for kind, v in values.items():
        packed = msgpack_pkg.packb(v, use_bin_type=True)
        assert msgpack.decode(packed) == v, kind
        assert msgpack.encode(v) == packed, kind


@pytest.mark.parametrize('array,form', [
    (np.arange(2, dtype=np.uint16), 0xD8), (np.arange(3, dtype=np.uint8), 0xC7),
    (np.arange(300, dtype=np.uint8), 0xC8), (np.arange(70000, dtype=np.uint8), 0xC9),
])
def test_ext_ndarrays_of_every_length_form_decode(array, form):
    """fixext 16 (a 16-byte payload: two uint16), ext 8, 16 and 32; an
    ndarray's payload is never 1, 2, 4 or 8 bytes long."""
    ext = serialization.msgpack_serialize(array)
    assert ext[0] == form
    got = msgpack.decode(ext)
    assert got.dtype == array.dtype and np.array_equal(got, array)
    assert msgpack.encode(array) == ext


@pytest.mark.parametrize('n', [1, 2, 4, 8, 16, 3, 300])
def test_every_ext_form_reads_its_type_code(n):
    """fixext 1-16 and ext 8 / 16: the reader finds the type code (here 5;
    flax writes only 1 for params) behind each form's header."""
    with pytest.raises(ValueError, match='ext type 5'):
        msgpack.decode(msgpack_pkg.packb(msgpack_pkg.ExtType(5, b'x' * n)))


def test_bad_input_raises():
    good = msgpack.encode({'a': np.ones(3, np.float32)})
    with pytest.raises(ValueError, match='truncated'):
        msgpack.decode(good[:-1])
    with pytest.raises(ValueError, match='after the value'):
        msgpack.decode(good + b'\x00')
    with pytest.raises(ValueError, match='unknown type byte'):
        msgpack.decode(b'\xc1')
    with pytest.raises(TypeError, match='cannot encode'):
        msgpack.encode({'a': object()})
    with pytest.raises(TypeError, match='cannot encode'):
        msgpack.encode({'a': np.float32(1.0)})  # flax's ext type 3, not written for params
