"""Metrics logging and visualisation sink. Counterpart of
generative_models_tpu/utils/logger.py, with the same conventions: buffered
per-epoch scalar lists flushed by dump_logger (mean -> TensorBoard when it
imports + stdout + hps.yaml), tiled sample grids (grid_image for a batch
of images, combine_imgs for a batch of images or videos; write_grid,
write_image) and sampling-process GIFs.

Differences: the GIF encoder is the port's own numpy one (gif_encode_gray;
no imageio, PIL or native library), and TensorBoard gets a filmstrip of the
sampling process instead of the embedded GIF.
"""

import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch


def make_logger():
    return defaultdict(list)


def make_writer(logdir):
    """A TensorBoard SummaryWriter, or None where tensorboard is missing."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print('[logger] tensorboard unavailable; scalar logs go to stdout only')
        return None
    return SummaryWriter(str(logdir))


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def count_vars(params):
    """Number of scalars in an iterable of tensors."""
    return sum(int(p.numel()) for p in params)


def dump_logger(logger, writer, i, G):
    """Flush buffered metrics: mean each list -> TB scalar + stdout, record
    full_cmd + commit_hash in G, dump hps.yaml. Returns {key: mean}."""
    from generative_models_tpu_torch.utils.config import dump_hps

    print('=' * 30)
    print(i)
    means = {}
    for key, val in logger.items():
        vals = val if isinstance(val, list) else [val]
        means[key] = float(np.mean([np.mean(to_numpy(v)) for v in vals]))
        if writer is not None:
            writer.add_scalar(key, means[key], i)
        print(key, means[key])
    G.full_cmd = 'python ' + ' '.join(sys.argv)
    try:
        G.commit_hash = subprocess.check_output(
            ['git', 'rev-parse', 'HEAD'], cwd=Path(__file__).parent,
            stderr=subprocess.DEVNULL,
        ).decode('ascii').strip()
    except (OSError, subprocess.CalledProcessError):
        G.commit_hash = 'unknown'
    from generative_models_tpu_torch.parallel.mesh import get_mesh

    if get_mesh().is_main:  # rank 0 writes under a process group
        dump_hps(G)
    print(G.full_cmd)
    print('=' * 30)
    if writer is not None:
        writer.flush()
    return means


def _to_hwc_uint8(x, expand=True):
    """(H, W, C) float in [0,1] or uint8 -> uint8 HWC; expand=True repeats
    single channels to 3, expand=False keeps C=1."""
    x = to_numpy(x)
    if x.dtype != np.uint8:
        x = (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)
    if expand and x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return x


def grid_image(x, n1=5, n2=5):
    """(n1*n2, H, W, C) -> (n1*H, n2*W, C) tiled image."""
    x = to_numpy(x)
    n, h, w, c = x.shape
    if n != n1 * n2:
        raise ValueError(f'grid_image: {n} images do not fill {n1}x{n2}')
    return x.reshape(n1, n2, h, w, c).transpose(0, 2, 1, 3, 4).reshape(n1 * h, n2 * w, c)


def combine_imgs(arr, row=5, col=5):
    """A batch of images (B, H, W, C) -> one (row * H, col * W, C) canvas,
    or of videos (B, T, H, W, C) -> (T, row * H, col * W, C); B = row *
    col."""
    arr = to_numpy(arr)
    if arr.ndim == 4:
        return grid_image(arr, row, col)
    if arr.ndim == 5:
        bs, t, h, w, _ = arr.shape
        if bs != row * col:
            raise ValueError(f'combine_imgs: {bs} videos do not fill {row}x{col}')
        x = arr.reshape(row, col, t, h, w, -1).transpose(2, 0, 3, 1, 4, 5)
        return x.reshape(t, row * h, col * w, -1)
    raise NotImplementedError(arr.shape)


def write_image(writer, tag, img, epoch):
    """One (H, W, C) image in [0, 1] to TensorBoard."""
    if writer is not None:
        writer.add_image(tag, _to_hwc_uint8(img), epoch, dataformats='HWC')


def write_grid(writer, tag, x, epoch):
    """5x5 grid of 25 (28|32, 28|32, 1) samples to TensorBoard."""
    if tuple(x.shape) not in ((25, 28, 28, 1), (25, 32, 32, 1)):
        raise ValueError(f'write_grid: expected 25 28x28 or 32x32 images, got {tuple(x.shape)}')
    if writer is not None:
        writer.add_image(tag, _to_hwc_uint8(grid_image(x)), epoch, dataformats='HWC')


def _lzw_literal_bytes(frames):
    """(t, n) uint8 pixels -> (t, m) bytes: each frame's LZW code stream
    with every pixel a 9-bit literal, a clear code (256) before every 254
    literals and the end code (257) last, packed LSB-first."""
    t, n = frames.shape
    runs = -(-n // 254)
    L = n + runs + 1
    stream = np.zeros((t, -(-L // 8) * 8), np.uint64)
    i = np.arange(n)
    stream[:, np.arange(runs) * 255] = 256
    stream[:, i + i // 254 + 1] = frames
    stream[:, L - 1] = 257
    # 8 codes of 9 bits = 9 bytes: codes 0-6 and bit 0 of code 7 fill a
    # little-endian u64, the rest of code 7 the ninth byte
    g = stream.reshape(t, -1, 8)
    lo = g[..., 7] & np.uint64(1)
    lo <<= np.uint64(63)
    for j in range(7):
        lo |= g[..., j] << np.uint64(9 * j)
    out = np.empty((t, g.shape[1], 9), np.uint8)
    out[..., :8] = lo.astype('<u8').view(np.uint8).reshape(t, -1, 8)
    out[..., 8] = (g[..., 7] >> np.uint64(1)).astype(np.uint8)
    return out.reshape(t, -1)[:, :-(-9 * L // 8)]


def gif_encode_gray(frames, fps, loop=0):
    """(T, H, W) uint8 grayscale frames -> animated GIF89a bytes.

    The same container as the JAX package's native encoder (256-gray global
    palette, NETSCAPE2.0 loop, one full-canvas frame with a "do not dispose"
    graphic control each), but its image data is uncompressed LZW: every
    pixel is its own 9-bit literal code, with a clear code every 254
    literals, so a decoder's dictionary stays under 512 entries and the code
    width never grows. The code stream is then a fixed function of the
    pixels, packed with numpy (~1.13 bytes a pixel) instead of a Python LZW
    loop, which would take seconds for 784 frames of 140x140.
    """
    frames = np.ascontiguousarray(frames, np.uint8)
    t, h, w = frames.shape
    if not (t and 0 < h <= 0xFFFF and 0 < w <= 0xFFFF):
        raise ValueError(f'gif_encode_gray: bad frame stack {frames.shape}')
    delay = max(1, int(round(100.0 / max(fps, 1e-6))))
    u16 = lambda v: [v & 0xFF, v >> 8]
    head = bytes([0x21, 0xF9, 4, 0x04, *u16(delay), 0, 0,  # graphic control
                  0x2C, 0, 0, 0, 0, *u16(w), *u16(h), 0,  # image descriptor
                  8])  # LZW minimum code size
    chunk = max(1, (1 << 22) // (h * w))  # frames a pass: bounds the u64 stream
    body = []
    for f0 in range(0, t, chunk):
        data = _lzw_literal_bytes(frames[f0:f0 + chunk].reshape(-1, h * w))
        # data sub-blocks of <= 255 bytes, each after its length byte, then
        # the terminator (the last column, left 0)
        nb = data.shape[1]
        k = -(-nb // 255)
        blocks = np.zeros((data.shape[0], nb + k + 1), np.uint8)
        blocks[:, np.arange(k) * 256] = np.minimum(255, nb - 255 * np.arange(k))
        j = np.arange(nb)
        blocks[:, j + j // 255 + 1] = data
        body += [head + row.tobytes() for row in blocks]
    palette = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    screen = bytes([*u16(w), *u16(h), 0xF7, 0, 0])  # 256-entry global table
    netscape = bytes([0x21, 0xFF, 0x0B]) + b'NETSCAPE2.0' + bytes([3, 1, *u16(loop), 0])
    return b'GIF89a' + screen + palette + netscape + b''.join(body) + b'\x3b'


def _tile_u8(x):
    """(25, H, W, 1) float [0, 1] -> (5H, 5W) uint8, rounded to nearest as
    the JAX package's native tile_grid_u8; uint8 frames are tiled as they
    are."""
    img = grid_image(x)[..., 0]
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_gridvid(writer, tag, x, epoch, logdir=None):
    """(T, 25, H, W, 1) sampling-process video (float in [0, 1] or uint8)
    -> <logdir>/<tag>_<epoch>.gif (5x5 grid a frame), and a filmstrip of 8
    evenly spaced frames to TensorBoard."""
    x = to_numpy(x)
    T = x.shape[0]
    frames = np.stack([_tile_u8(x[t]) for t in range(T)])
    fps = max(1, min(T // 3, 60))
    from generative_models_tpu_torch.parallel.mesh import get_mesh

    if logdir is not None and get_mesh().is_main:  # rank 0 writes under a group
        gif_dir = Path(logdir)
        gif_dir.mkdir(parents=True, exist_ok=True)
        safe_tag = tag.replace('/', '_')
        (gif_dir / f'{safe_tag}_{epoch}.gif').write_bytes(gif_encode_gray(frames, fps))
    if writer is not None:
        idxs = np.linspace(0, T - 1, num=min(8, T)).astype(int)
        strip = np.concatenate([frames[i] for i in idxs], axis=1)[..., None]
        writer.add_image(tag, np.repeat(strip, 3, axis=-1), epoch, dataformats='HWC')
