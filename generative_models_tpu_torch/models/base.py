"""GM base class, inference half. Counterpart of
generative_models_tpu/models/base.py (GM/Autoreg, :113-457).

Every model owns a torch module (self.net) on self.device, initialised from
G.seed with flax's initializer families, and the host API of the JAX
package: loss / eval_loss, sample / sample_images, the serving fn, and
save / load_weights. The optimizer, train step and epoch loop come with the
training slice.

Checkpoints are the port's own: model.pt is a torch state dict, beside an
hps.yaml that both packages read. A JAX checkpoint's params are carried over
with convert.params_from_jax.
"""

import math
from pathlib import Path

import torch
from torch import nn

from generative_models_tpu_torch.ops.common import resolve_device
from generative_models_tpu_torch.utils.config import AttrDict, dump_hps

# std of a unit normal truncated to [-2, 2]: flax's variance_scaling divides
# by it so the truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def flax_init_(module, generator):
    """flax's default initializers: lecun-normal (truncated normal, fan_in)
    Linear weights, zero biases, LayerNorm scale 1 and bias 0. Parameters
    of other modules (pos_emb) keep their constructor values."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(
                    m.weight, std=std, a=-2 * std, b=2 * std, generator=generator
                )
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)


class GM:
    """GenerativeModel base."""

    DG = AttrDict()  # model-specific config defaults

    def __init__(self, G):
        self.G = G
        self.device = resolve_device(G.get('device', ''))
        seed = int(G.get('seed', 0))
        self.net = self.build()
        # init on the CPU from one generator: the same seed gives the same
        # weights whatever the device
        flax_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(self.device).eval()
        self._gen = torch.Generator(self.device).manual_seed(seed)

    def build(self):
        """Return the torch module."""
        raise NotImplementedError

    def loss(self, x, y=None):
        """(batch) -> (loss, metrics dict)."""
        raise NotImplementedError

    def _as_input(self, x):
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def eval_loss(self, x, y=None):
        """Scoring: the full forward's metrics on one batch, as floats."""
        _, metrics = self.loss(self._as_input(x), y)
        return {k: float(v) for k, v in metrics.items()}

    def save(self, path, tag=''):
        """model[_tag].pt (torch state dict) + hps.yaml into directory path."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        suffix = f'_{tag}' if tag else ''
        torch.save(self.net.state_dict(), path / f'model{suffix}.pt')
        dump_hps(self.G, path)

    def load_weights(self, path):
        path = Path(path)
        with open(path, 'rb') as f:
            if f.read(2) != b'PK':  # torch.save writes a zip archive
                raise NotImplementedError(
                    f'{path} is not a torch state dict (a JAX msgpack checkpoint?); '
                    'reading JAX checkpoints is not ported yet: carry params '
                    'over with generative_models_tpu_torch.convert.params_from_jax'
                )
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.net.load_state_dict(state)


class Autoreg(GM):
    """Autoregressive models: sample_fn(n, generator, uniforms, with_frames)
    returns samples in [0, 1], plus the sampling-process frames when
    asked."""

    def sample_fn(self, n, generator=None, uniforms=None, with_frames=True):
        raise NotImplementedError

    @torch.no_grad()
    def sample(self, n):
        """(samples (n, H, W, 1), frames (T, n, H, W, 1)) from the model's
        own generator stream."""
        return self.sample_fn(n, generator=self._gen)

    @torch.no_grad()
    def sample_images(self, n, y=None):
        if y is not None:
            raise TypeError(f'{type(self).__name__}.sample takes no labels')
        return self.sample_fn(n, generator=self._gen, with_frames=False)

    def pure_serving_fn(self, n):
        """(seed) -> (n, H, W, 1) float32 numpy samples in [0, 1]. The seed
        becomes torch.Generator(device).manual_seed(seed), so the same seed
        gives the same batch."""

        @torch.no_grad()
        def fn(seed):
            gen = torch.Generator(self.device).manual_seed(int(seed))
            return self.sample_fn(n, generator=gen, with_frames=False).cpu().numpy()

        return fn
