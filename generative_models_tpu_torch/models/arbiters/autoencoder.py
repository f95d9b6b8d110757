"""Arbiter autoencoder. Counterpart of
generative_models_tpu/models/arbiters/autoencoder.py: a plain AE whose
z_size-wide encoder is eval_heavy's feature extractor (feature_fn: encode
only), decoded through a sigmoid (binarized data) or a tanh ([-1, 1] data),
trained on the reconstruction NLL plus beta * KL(N(z, 1) || N(0, 1))."""

import torch
from torch import nn

from generative_models_tpu_torch.models.base import Arbiter
from generative_models_tpu_torch.models.vae import ConvDecoder, ConvEncoder, encoded_hw
from generative_models_tpu_torch.utils import combine_imgs, dists, register, write_image
from generative_models_tpu_torch.utils.config import AttrDict
from generative_models_tpu_torch.utils.dists import normal_kl


class AENet(nn.Module):
    def __init__(self, z_size, hidden, binarize, size=28):
        super().__init__()
        self.binarize = binarize
        self.encoder = ConvEncoder(out_size=z_size, hidden=hidden)
        self.decoder = ConvDecoder(in_size=z_size * encoded_hw(size) ** 2, hidden=hidden)

    def forward(self, x):
        return self.encode(x)

    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        x = self.decoder(z)
        return torch.sigmoid(x) if self.binarize else torch.tanh(x)


@register
class Autoencoder(Arbiter):
    DG = AttrDict()
    DG.eval_heavy = False
    DG.z_size = 64
    DG.beta = 1e-6
    DG.binarize = 0

    def build(self):
        G = self.G
        return AENet(int(G.z_size), int(G.hidden_size), bool(G.binarize),
                     32 if G.get('pad32', 0) else 28)

    def feature_fn(self, x):
        return self.net(x)

    def loss(self, x, y=None):
        z = self.net.encode(x)
        decoded = self.net.decode(z)
        if self.G.binarize:
            recon_loss = -dists.Bernoulli(probs=decoded).log_prob(x).mean((1, 2, 3))
        else:
            recon_loss = -dists.Normal(decoded, 1.0).log_prob(x).mean((1, 2, 3))
        kl_loss = normal_kl(z, torch.ones_like(z)).mean(-1)
        loss = (recon_loss + float(self.G.beta) * kl_loss).mean()
        return loss, {'full_loss': loss, 'recon_loss': recon_loss.mean(),
                      'kl_loss': kl_loss.mean(), 'z_mean': z.mean(),
                      'z_std': z.std(unbiased=False)}

    @torch.no_grad()
    def evaluate(self, writer, x, y, epoch):
        """8 test images over their reconstructions over the error map."""
        self.net.eval()
        truth = self._as_input(x[:8])
        recon = self.net.decode(self.net.encode(truth))
        if self.G.binarize:
            recon = (recon > 0.5).float()
        error = (recon - truth + 1.0) / 2.0
        stack = torch.cat([truth, recon, error], 0)
        write_image(writer, 'reconstruction', combine_imgs(stack, 3, 8), epoch)
