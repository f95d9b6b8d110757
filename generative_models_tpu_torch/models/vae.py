"""VAE. Counterpart of generative_models_tpu/models/vae.py: a conv encoder
to a Normal posterior (softplus scale + 1e-4), a deconv decoder, and the
ELBO as a Bernoulli (binarized data) or unit Normal reconstruction NLL plus
beta * KL(posterior || N(0, 1)). ConvEncoder and ConvDecoder are also the
arbiters' networks (models/arbiters/).

No kernel of ops/ lies on this path: the convs and deconvs are stock
PyTorch ops in f32 (TF32 off on the card, ops/common.resolve_device), as
the JAX package leaves them to XLA.

Layouts: the public tensors are NHWC, as the JAX package's; the convs run
NCHW inside ConvEncoder and ConvDecoder. The encoder's last map is permuted
back to NHWC before it is flattened, so the features come in the JAX
package's (h, w, c) order: at 28x28 the map is 1x1 and the order cannot
show, at --pad32=1 it is 2x2 (32 -> 15 -> 7 -> 5 -> 2). The decoder's
weights are flax's unflipped ConvTranspose kernels flipped in both spatial
axes (convert.conv_tree_from_jax); at these kernel sizes (k >= stride) a
flax VALID ConvTranspose and torch's ConvTranspose2d give the same size.

Random draws: the posterior's noise (train_step(x, eps=...), (B, z)) and the
prior's (sample_fn(n, z=...)) can be passed in; otherwise they come from
the model's generator, and the eval loss from a generator seeded afresh
each call, as the JAX package folds one fixed tag into its key.
"""

import torch
import torch.nn.functional as F
from torch import nn

from generative_models_tpu_torch import convert
from generative_models_tpu_torch.models.base import GM, deterministic_convs
from generative_models_tpu_torch.utils import (
    combine_imgs, dists, register, write_grid, write_image,
)
from generative_models_tpu_torch.utils.config import AttrDict
from generative_models_tpu_torch.utils.dists import normal_kl

EVAL_SEED_TAG = 0x7FFFFFFF  # the eval loss's generator seed, beside G.seed
ENC_LAYERS = ((2, True), (2, True), (1, True), (2, False))  # (stride, relu after)


def encoded_hw(size):
    """The encoder's output height (= width) for a size x size input."""
    for stride, _ in ENC_LAYERS:
        size = (size - 3) // stride + 1
    return size


class ConvEncoder(nn.Module):
    """28 -> 13 -> 6 -> 4 -> 1 VALID 3x3 convs (strides 2, 2, 1, 2), ReLUs
    between: NHWC (B, H, W, 1) -> (B, h * w * out_size) in (h, w, c)
    order."""

    def __init__(self, out_size, hidden, in_channels=1):
        super().__init__()
        H = hidden
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels, H, 3, stride=2), nn.Conv2d(H, H, 3, stride=2),
            nn.Conv2d(H, H, 3, stride=1), nn.Conv2d(H, out_size, 3, stride=2),
        ])

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv, (_, relu) in zip(self.convs, ENC_LAYERS):
            x = conv(x)
            x = F.relu(x) if relu else x
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class ConvDecoder(nn.Module):
    """1 -> 5 -> 12 -> 26 -> 28 VALID deconvs (5x5, 4x4 stride 2, 4x4
    stride 2, 3x3), ReLUs between: (B, in_size) -> NHWC (B, 28, 28,
    out_channels)."""

    def __init__(self, in_size, hidden, out_channels=1):
        super().__init__()
        H = hidden
        self.deconvs = nn.ModuleList([
            nn.ConvTranspose2d(in_size, H, 5), nn.ConvTranspose2d(H, H, 4, stride=2),
            nn.ConvTranspose2d(H, H, 4, stride=2), nn.ConvTranspose2d(H, out_channels, 3),
        ])

    def forward(self, z):
        x = z[:, :, None, None]
        for deconv in self.deconvs[:-1]:
            x = F.relu(deconv(x))
        return self.deconvs[-1](x).permute(0, 2, 3, 1)


class VAENet(nn.Module):
    """encoder -> (mu, softplus(log_std) + 1e-4), decoder(z) -> logits."""

    def __init__(self, z_size, hidden, size=28):
        super().__init__()
        self.encoder = ConvEncoder(out_size=2 * z_size, hidden=hidden)
        # the JAX package's decoder takes whatever width mu has: z_size a
        # pixel of the encoder's last map
        self.decoder = ConvDecoder(in_size=z_size * encoded_hw(size) ** 2, hidden=hidden)

    def encode(self, x):
        h = self.encoder(x)
        mu, log_std = torch.chunk(h, 2, dim=-1)
        return mu, F.softplus(log_std) + 1e-4

    def decode(self, z):
        return self.decoder(z)

    def forward(self, x):
        return self.decode(self.encode(x)[0])


@register
class VAE(GM):
    params_from_jax = staticmethod(convert.vae_params_from_jax)  # a JAX model.pt
    DG = AttrDict()
    DG.z_size = 128
    DG.beta = 1.0

    def build(self):
        G = self.G
        return VAENet(int(G.z_size), int(G.hidden_size), 32 if G.get('pad32', 0) else 28)

    def _losses(self, x, eps):
        mu, std = self.net.encode(x)
        z = dists.Normal(mu, std).rsample(noise=eps)
        decoded = self.net.decode(z)
        if self.G.binarize:
            recon_loss = -dists.Bernoulli(logits=decoded).log_prob(x).mean((1, 2, 3))
        else:
            recon_loss = -dists.Normal(decoded, 1.0).log_prob(x).mean((1, 2, 3))
        kl_loss = normal_kl(mu, std).mean(-1)
        loss = (recon_loss + float(self.G.beta) * kl_loss).mean()
        return loss, {'vae_loss': loss, 'recon_loss': recon_loss.mean(),
                      'kl_loss': kl_loss.mean()}

    def _eps(self, x, eps, generator):
        if eps is not None:
            return torch.as_tensor(eps, dtype=torch.float32).to(self.device)
        shape = (x.shape[0], self.net.decoder.deconvs[0].in_channels)
        return dists.batch_draw(torch.randn, shape, generator, self.device)

    def loss(self, x, y=None, eps=None):
        """The eval loss: the posterior's noise from a fixed seed (or eps)."""
        gen = torch.Generator(self.device).manual_seed(int(self.G.get('seed', 0)) + EVAL_SEED_TAG)
        return self._losses(x, self._eps(x, eps, gen))

    def train_loss(self, x, y=None, eps=None):
        return self._losses(x, self._eps(x, eps, self._gen))

    SERVE_DETERMINISTIC_CONVS = True

    def draw_spec(self, n):
        return [('z', (n, int(self.G.z_size)), 'normal')]

    def sample_from_draws(self, n, draws, y=None, quant=None):
        return self.sample_fn(n, z=draws[0])

    def sample_fn(self, n, generator=None, z=None, quant=None):
        """n samples (n, H, W, 1) in {0, 1}: sigmoid(decode(z)) > 0.5, z
        from N(0, 1) (or given), the deconvs on cuDNN's deterministic
        algorithms; one CUDA graph a batch size (graphed_pass)."""
        if z is None:
            z = torch.randn((n, int(self.G.z_size)), generator=generator, device=self.device)

        def decode(z):
            with deterministic_convs():
                return (torch.sigmoid(self.net.decode(z)) > 0.5).float()

        return self.graphed_pass(('vae', n), decode,
                                 torch.as_tensor(z, dtype=torch.float32).to(self.device))

    @torch.no_grad()
    def evaluate(self, writer, x, y, epoch):
        """25 samples, and 8 test images over their reconstructions (from
        the posterior mean) over the error map."""
        self.net.eval()
        write_grid(writer, 'samples', self.sample(25), epoch)
        truth = self._as_input(x[:8])
        recon = (torch.sigmoid(self.net.decode(self.net.encode(truth)[0])) > 0.5).float()
        error = (recon - truth + 1.0) / 2.0
        stack = torch.cat([truth, recon, error], 0)
        write_image(writer, 'reconstruction', combine_imgs(stack, 3, 8), epoch)
