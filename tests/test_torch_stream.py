"""Host streaming (generative_models_tpu_torch/data/stream.py) on the CPU:
the cases of the JAX package's tests/test_stream.py that do not concern
sharding (order, drop_last, the producer thread joined on an early close,
a producer error raised in the consumer, the transform, the test split's
surface, a memmap split, chunked blocks in the same order with a partial
tail), then the invariant the port keeps: a streamed epoch yields the
on-device Dataset's batches from the same generator, and --stream_data=1,
at --stream_chunk 1 and 16, trains the on-device run bitwise through the
CLI. Then --profile=1 writes a Chrome trace under logdir/profile/, also
when the epoch loop raises."""

import contextlib
import io
import json
import threading

import numpy as np
import pytest
import torch

import generative_models_tpu_torch.data.mnist as tm
from generative_models_tpu_torch.data.mnist import Dataset
from generative_models_tpu_torch.data.stream import StreamingDataset
from generative_models_tpu_torch.main import main

torch.set_num_threads(1)


def _toy(n=96, nt=32, bs=8, **kw):
    r = np.random.RandomState(0)
    # image value i at sample i, so content identifies samples
    train_x = np.broadcast_to(np.arange(n, dtype=np.float32)[:, None, None, None],
                              (n, 4, 4, 1)).copy()
    train_y = np.arange(n, dtype=np.int32) % 10
    test_x = r.rand(nt, 4, 4, 1).astype(np.float32)
    test_y = r.randint(0, 10, nt).astype(np.int32)
    return StreamingDataset(train_x, train_y, test_x, test_y, bs=bs, device='cpu', **kw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _epoch_ids(ds, seed, chunk=1):
    ids, labels = [], []
    with ds.stream_epoch(_gen(seed), chunk=chunk) as it:
        for x, y in it:
            ids.append(x.reshape(-1, 16)[:, 0].long().numpy())
            labels.append(y.reshape(-1).numpy())
    return np.concatenate(ids), np.concatenate(labels)


def test_epoch_covers_the_split_once_in_the_on_device_order():
    ds = _toy()
    assert ds.steps_per_epoch == 12
    ids, labels = _epoch_ids(ds, 3)
    assert sorted(ids.tolist()) == list(range(96)) and ids.tolist() != list(range(96))
    np.testing.assert_array_equal(labels, ids % 10)
    np.testing.assert_array_equal(_epoch_ids(ds, 3)[0], ids)
    assert _epoch_ids(ds, 4)[0].tolist() != ids.tolist()
    # the on-device Dataset's batches from the same generator
    dev = Dataset(ds.train_x, ds.train_y, ds.test_x.numpy(), ds.test_y.numpy(), 8, 'cpu')
    bx, by = dev.epoch_batches(_gen(3), train=True)
    np.testing.assert_array_equal(bx.reshape(-1, 16)[:, 0].long().numpy(), ids)


def test_drop_last_semantics():
    ds = _toy(n=100)  # 12 * 8 + 4
    assert ds.steps_per_epoch == 12
    ids, _ = _epoch_ids(ds, 0)
    assert len(ids) == 96 and len(set(ids.tolist())) == 96


def test_early_close_joins_the_producer_thread():
    ds = _toy(prefetch=1)
    before = threading.active_count()
    it = ds.stream_epoch(_gen(0))
    next(it)  # the producer is live, and blocked on the bounded queue
    it.close()
    assert not it._thread.is_alive()
    assert threading.active_count() <= before
    with pytest.raises(StopIteration):
        next(it)
    with ds.stream_epoch(_gen(0)) as it2:
        next(it2)
    assert not it2._thread.is_alive()


def test_a_producer_error_is_raised_in_the_consumer():
    armed = {'on': False}  # __init__ runs the transform on the test split

    def bad(b):
        if armed['on']:
            raise RuntimeError('disk on fire')
        return b

    ds = _toy(n=32, transform=bad)
    armed['on'] = True
    with pytest.raises(RuntimeError, match='disk on fire'):
        with ds.stream_epoch(_gen(0)) as it:
            list(it)
    assert not it._thread.is_alive()


def test_the_transform_applies_to_train_and_test():
    ds = StreamingDataset(np.ones((16, 4, 4, 1), np.uint8), np.zeros(16, np.int32),
                          np.ones((8, 4, 4, 1), np.uint8), np.zeros(8, np.int32), bs=8,
                          device='cpu', transform=lambda b: b.astype(np.float32) * 0.5)
    with ds.stream_epoch(_gen(0)) as it:
        x, _ = next(it)
    assert x.dtype == torch.float32 and float(x[0, 0, 0, 0]) == 0.5
    assert float(ds.test_x[0, 0, 0, 0]) == 0.5


def test_the_test_split_has_the_datasets_surface():
    ds = _toy(n=64, nt=32)
    dev = Dataset(ds.train_x, ds.train_y, ds.test_x.numpy(), ds.test_y.numpy(), 8, 'cpu')
    bx, by = ds.epoch_batches(_gen(0), train=False)
    assert bx.shape == (4, 8, 4, 4, 1) and by.shape == (4, 8)
    ref = dev.epoch_batches(_gen(0), train=False)
    assert torch.equal(bx, ref[0]) and torch.equal(by, ref[1])
    tx, ty = ds.first_test_batch(epoch=1)
    assert torch.equal(tx, dev.first_test_batch(1)[0]) and ty.shape == (8,)
    with pytest.raises(ValueError, match='stream_epoch'):
        ds.epoch_batches(_gen(0), train=True)


def test_a_memmap_split_streams(tmp_path):
    path = tmp_path / 'big.npy'
    mm = np.lib.format.open_memmap(str(path), mode='w+', dtype=np.float32, shape=(64, 4, 4, 1))
    mm[:] = np.arange(64, dtype=np.float32)[:, None, None, None]
    mm.flush()
    del mm
    ro = np.lib.format.open_memmap(str(path), mode='r')
    ds = StreamingDataset(ro, np.arange(64, dtype=np.int32) % 10,
                          np.zeros((8, 4, 4, 1), np.float32), np.zeros(8, np.int32), bs=8,
                          device='cpu')
    ids, _ = _epoch_ids(ds, 0)
    assert sorted(ids.tolist()) == list(range(64))


def test_chunked_blocks_keep_the_order_with_a_partial_tail():
    ds = _toy()  # 12 steps
    singles = []
    with ds.stream_epoch(_gen(7)) as it:
        singles = [(x, y) for x, y in it]
    with ds.stream_epoch(_gen(7), chunk=5) as it:  # 5 + 5 + 2
        chunks = [(x, y) for x, y in it]
    assert [c[0].shape[0] for c in chunks] == [5, 5, 2]
    assert torch.equal(torch.cat([c[0] for c in chunks]), torch.stack([s[0] for s in singles]))
    assert torch.equal(torch.cat([c[1] for c in chunks]), torch.stack([s[1] for s in singles]))


TINY = ['--model=vae', '--device=cpu', '--hidden_size=16', '--bs=8', '--epochs=2',
        '--save_n=1', '--data_source=synthetic', '--eval_heavy=0']


def _train(tmp_path, name, *flags):
    with contextlib.redirect_stdout(io.StringIO()):
        history = main(TINY + [f'--logdir={tmp_path / name}', *flags])
    return history, torch.load(tmp_path / name / 'model.pt', weights_only=True)


@pytest.mark.parametrize('chunk', [1, 16])
def test_stream_data_trains_the_on_device_run(tmp_path, monkeypatch, chunk):
    """vae draws its posterior noise from the model's generator every step,
    so the two runs agree only if they see the same batches in the same
    order. 72 images at bs=8: 9 steps an epoch, so chunk 16 stages one
    partial block."""
    monkeypatch.setattr(tm, 'TRAIN_N', 72)
    monkeypatch.setattr(tm, 'TEST_N', 16)
    ref_hist, ref = _train(tmp_path, 'dev')
    hist, got = _train(tmp_path, 'stream', '--stream_data=1', f'--stream_chunk={chunk}',
                       '--prefetch_depth=3')
    for k, v in ref['net'].items():
        assert torch.equal(got['net'][k], v), k
    for a, b in zip(ref['opt']['state'].values(), got['opt']['state'].values()):
        assert torch.equal(a['exp_avg'], b['exp_avg']) and torch.equal(a['exp_avg_sq'],
                                                                       b['exp_avg_sq'])
    drop = lambda h: {k: v for k, v in h.items() if not k.startswith('dt/')}
    assert [drop(h) for h in hist] == [drop(h) for h in ref_hist]


def test_profile_writes_a_chrome_trace_also_when_the_loop_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tm, 'TRAIN_N', 16)
    monkeypatch.setattr(tm, 'TEST_N', 16)
    _train(tmp_path, 'prof', '--profile=1', '--epochs=1')
    traces = list((tmp_path / 'prof' / 'profile').glob('*.json'))
    assert len(traces) == 1
    names = {e.get('name') for e in json.loads(traces[0].read_text())['traceEvents']}
    assert any('conv' in str(n) for n in names)
    with pytest.raises(FloatingPointError):
        _train(tmp_path, 'nan', '--profile=1', '--epochs=1', '--lr=1e30')
    assert len(list((tmp_path / 'nan' / 'profile').glob('*.json'))) == 1
