"""Image helpers of generative_models_tpu/utils/logger.py that the serving
path needs (serve.tile_grid). Pure numpy; the TensorBoard sink comes with
the training slice."""

import numpy as np
import torch


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
