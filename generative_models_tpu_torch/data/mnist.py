"""MNIST data pipeline. Counterpart of generative_models_tpu/data/mnist.py:
the whole dataset lives on the device as one tensor, the transforms
(binarize / [-1, 1] / pad32) are applied once, and an epoch is a shuffled
index into it, reshaped to (steps, bs, ...).

Data sources, resolved in order by 'auto':
  1. 'mnist'     -- real MNIST idx files under --data_dir (raw or .gz; the
     directory itself, its MNIST/raw or its mnist). Nothing is downloaded.
  2. 'digits'    -- sklearn's 1797 8x8 digits, upsampled to 24x24 and placed
     at random offsets in a 28x28 canvas, up to TRAIN_N/TEST_N, read from
     digits.npz (no scikit-learn needed).
  3. 'synthetic' -- procedural rectangles per class, pure numpy.
The arrays are the JAX package's, bit for bit.

Difference: an epoch's order comes from torch.randperm with an explicit
torch.Generator, not jax.random.permutation, so the batches differ from the
JAX package's at the same seed; first_test_batch keeps its numpy indices.

Under a process group with a data axis (parallel/mesh.py) every rank draws
the same epoch order and takes its rows of each global batch of --bs, as
the JAX package's batch_sharding splits axis 0 over data (local_rows); a
--bs that the axis does not divide raises.
"""

import gzip
from pathlib import Path

import numpy as np
import torch

TRAIN_N = 60000
TEST_N = 10000

_IDX_CANDIDATES = {
    'train_images': ['train-images-idx3-ubyte', 'train-images.idx3-ubyte'],
    'train_labels': ['train-labels-idx1-ubyte', 'train-labels.idx1-ubyte'],
    'test_images': ['t10k-images-idx3-ubyte', 't10k-images.idx3-ubyte'],
    'test_labels': ['t10k-labels-idx1-ubyte', 't10k-labels.idx1-ubyte'],
}
_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16, 0x0C: np.int32,
               0x0D: np.float32, 0x0E: np.float64}


def idx_parse(buf):
    """IDX bytes (the MNIST container: two zero bytes, a dtype code, the
    rank, big-endian u32 dims, big-endian data) -> numpy array."""
    if len(buf) < 4 or buf[0] or buf[1] or buf[2] not in _IDX_DTYPES:
        raise ValueError('malformed idx header')
    ndim = buf[3]
    shape = tuple(int(d) for d in np.frombuffer(buf, '>u4', ndim, offset=4))
    dtype = np.dtype(_IDX_DTYPES[buf[2]])
    arr = np.frombuffer(buf, dtype.newbyteorder('>'), int(np.prod(shape)), offset=4 + 4 * ndim)
    return arr.reshape(shape).astype(dtype)


def _read_idx(path):
    opener = gzip.open if str(path).endswith('.gz') else open
    with opener(path, 'rb') as f:
        return idx_parse(f.read())


def _find_idx_file(data_dir, names):
    for d in (data_dir, data_dir / 'MNIST' / 'raw', data_dir / 'mnist'):
        for name in names:
            for suffix in ('', '.gz'):
                p = Path(d) / (name + suffix)
                if p.exists():
                    return p
    return None


def _load_mnist_idx(data_dir):
    data_dir = Path(data_dir)
    files = {}
    for key, names in _IDX_CANDIDATES.items():
        p = _find_idx_file(data_dir, names)
        if p is None:
            return None
        files[key] = p
    train_x = _read_idx(files['train_images']).astype(np.float32) / 255.0
    train_y = _read_idx(files['train_labels']).astype(np.int32)
    test_x = _read_idx(files['test_images']).astype(np.float32) / 255.0
    test_y = _read_idx(files['test_labels']).astype(np.int32)
    return train_x[..., None], train_y, test_x[..., None], test_y


DIGITS = Path(__file__).resolve().with_name('digits.npz')


def load_digits():
    """sklearn's 1797 8x8 hand-written digits (the UCI ML hand-written
    digits set that scikit-learn bundles) upsampled to (1797, 24, 24) f32 as
    the JAX package's loader upsamples them (jax.image.resize, bilinear),
    and their labels, from digits.npz beside this module: the port needs
    neither scikit-learn nor JAX for them."""
    with np.load(DIGITS) as f:
        return f['up'], f['target'].astype(np.int32)


def _load_digits_upsampled(train_n=None, test_n=None):
    """The upsampled digits -> 28x28, replicated with deterministic
    placement up to train_n / test_n (TRAIN_N / TEST_N)."""
    up_all, labels = load_digits()
    test_mask = np.arange(len(up_all)) % 7 == 0  # every 7th example to test

    def expand(split_up, split_labels, n, seed):
        rng = np.random.RandomState(seed)
        idx = rng.randint(0, len(split_up), size=n)
        up = split_up[idx]
        out = np.zeros((n, 28, 28, 1), np.float32)
        offs = rng.randint(0, 5, size=(n, 2))
        for dy in range(5):
            for dx in range(5):
                m = (offs[:, 0] == dy) & (offs[:, 1] == dx)
                out[m, dy:dy + 24, dx:dx + 24, 0] = up[m]
        return np.clip(out, 0.0, 1.0), split_labels[idx].astype(np.int32)

    train_x, train_y = expand(up_all[~test_mask], labels[~test_mask], train_n or TRAIN_N, seed=0)
    test_x, test_y = expand(up_all[test_mask], labels[test_mask], test_n or TEST_N, seed=1)
    return train_x, train_y, test_x, test_y


def _load_synthetic():
    """Last-resort procedural data: noisy rectangles per class."""

    def make(n, seed):
        r = np.random.RandomState(seed)
        y = r.randint(0, 10, size=n).astype(np.int32)
        x = np.zeros((n, 28, 28, 1), np.float32)
        for i in range(n):
            cy, cx = 6 + y[i] % 5 * 3, 6 + y[i] // 5 * 8
            h, w = 6 + y[i] % 3 * 2, 4 + y[i] % 4
            x[i, cy:cy + h, cx:cx + w, 0] = 1.0
        x += 0.05 * r.randn(n, 28, 28, 1).astype(np.float32)
        return np.clip(x, 0, 1), y

    train_x, train_y = make(TRAIN_N, 0)
    test_x, test_y = make(TEST_N, 1)
    return train_x, train_y, test_x, test_y


def apply_transforms(x, binarize, pad32):
    """binarize -> {0,1} (> 0.5); else scale to [-1,1]; optional pad to
    32x32 with the background value. numpy in, float32 numpy out."""
    x = np.asarray(x, np.float32)
    x = (x > 0.5).astype(np.float32) if binarize else 2.0 * x - 1.0
    if pad32:
        pad_val = 0.0 if binarize else -1.0
        x = np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)), constant_values=pad_val)
    return x


def local_rows(bs):
    """This rank's rows of a global batch of bs: all of them without a
    process group, else its share of the data axis (parallel/mesh.py)."""
    from generative_models_tpu_torch.parallel.mesh import data_slice, get_mesh

    return slice(None) if get_mesh().dm is None else data_slice(bs)


class Dataset:
    """The whole dataset on one device, NHWC float32, with drop-last epochs
    by shuffled index."""

    def __init__(self, train_x, train_y, test_x, test_y, bs, device):
        self.bs = bs
        as_t = lambda a: torch.as_tensor(np.asarray(a)).to(device)
        self.train_x, self.train_y = as_t(train_x), as_t(train_y)
        self.test_x, self.test_y = as_t(test_x), as_t(test_y)
        self.steps_per_epoch = self.train_x.shape[0] // bs  # drop_last semantics
        self.test_steps = self.test_x.shape[0] // bs

    def epoch_batches(self, generator, train=True):
        """(steps, bs, H, W, C) images and (steps, bs) labels, shuffled by
        torch.randperm(generator) (a CPU generator), on the device; this
        rank's rows of each batch under a data axis (local_rows)."""
        x, y = (self.train_x, self.train_y) if train else (self.test_x, self.test_y)
        steps = self.steps_per_epoch if train else self.test_steps
        n = steps * self.bs
        perm = torch.randperm(x.shape[0], generator=generator)[:n].reshape(steps, self.bs)
        perm = perm[:, local_rows(self.bs)].reshape(-1).to(x.device)
        rows = perm.shape[0] // steps
        return x[perm].reshape(steps, rows, *x.shape[1:]), y[perm].reshape(steps, rows)

    def first_test_batch(self, epoch=0):
        """One test batch for model.evaluate: the JAX package's indices,
        np.random.RandomState(epoch).permutation(n_test)[:bs]."""
        idx = np.random.RandomState(epoch).permutation(self.test_x.shape[0])[:self.bs]
        idx = torch.as_tensor(idx).to(self.test_x.device)
        return self.test_x[idx], self.test_y[idx]


def load_mnist(G, device):
    """Load per --data_source / --data_dir, apply the transforms, move to
    device. Returns a Dataset, or with --stream_data=1 a StreamingDataset
    (data/stream.py: the training split stays on the host, each batch
    transformed as it is staged, --prefetch_depth batches ahead)."""
    source = G.get('data_source', 'auto')
    loaded = None
    chosen = source
    if source in ('auto', 'mnist'):
        loaded = _load_mnist_idx(G.get('data_dir', Path('./data/')))
        chosen = 'mnist' if loaded is not None else source
    if loaded is None and source in ('auto', 'digits'):
        loaded = _load_digits_upsampled()
        chosen = 'digits'
    if loaded is None:
        loaded = _load_synthetic()
        chosen = 'synthetic'
    if chosen != 'mnist':
        print(f'[data] MNIST idx files not found; using fallback source: {chosen}')
    train_x, train_y, test_x, test_y = loaded
    if int(G.get('stream_data', 0)):
        from generative_models_tpu_torch.data.stream import StreamingDataset

        return StreamingDataset(
            train_x, train_y, test_x, test_y, G.bs, device,
            prefetch=int(G.get('prefetch_depth', 2)),
            transform=lambda b: apply_transforms(b, G.binarize, G.pad32))
    return Dataset(apply_transforms(train_x, G.binarize, G.pad32), train_y,
                   apply_transforms(test_x, G.binarize, G.pad32), test_y, G.bs, device)
