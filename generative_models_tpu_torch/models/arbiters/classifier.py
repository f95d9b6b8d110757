"""Arbiter MNIST classifier. Counterpart of
generative_models_tpu/models/arbiters/classifier.py: the VAE's conv
encoder with out_size=10, trained on cross-entropy; eval_heavy scores
class-conditional samples with its logits (feature_fn)."""

import numpy as np
import torch

from generative_models_tpu_torch.models.base import Arbiter
from generative_models_tpu_torch.models.vae import ConvEncoder
from generative_models_tpu_torch.utils import register, to_numpy, write_image
from generative_models_tpu_torch.utils.config import AttrDict
from generative_models_tpu_torch.utils.metrics import cross_entropy


@register
class Classifier(Arbiter):
    DG = AttrDict()
    DG.eval_heavy = False
    DG.epochs = 6  # starts to overfit after about this many
    DG.binarize = 0
    DG.save_n = 1

    def build(self):
        return ConvEncoder(out_size=10, hidden=int(self.G.hidden_size))

    def feature_fn(self, x):
        return self.net(x)

    def loss(self, x, y=None):
        loss = cross_entropy(self.net(x), torch.as_tensor(y).to(self.device))
        return loss, {'cross_entropy_loss': loss}

    @torch.no_grad()
    def evaluate(self, writer, x, y, epoch):
        """The first 10 test images in a strip, green where predicted right
        and red where wrong."""
        N = 10
        self.net.eval()
        preds = torch.argmax(self.net(self._as_input(x[:N])), dim=1)
        correct = to_numpy(preds == torch.as_tensor(y[:N]).to(self.device))
        imgs = np.clip(np.repeat(to_numpy(x[:N]), 3, axis=-1), 0.0, 1.0)  # (N, H, W, 3)
        imgs[correct, :, :, 0] = 0
        imgs[correct, :, :, 2] = 0
        imgs[~correct, :, :, 1] = 0
        imgs[~correct, :, :, 2] = 0
        strip = imgs.transpose(1, 0, 2, 3).reshape(imgs.shape[1], imgs.shape[0] * imgs.shape[2], 3)
        write_image(writer, 'classifier/pred', strip, epoch)
