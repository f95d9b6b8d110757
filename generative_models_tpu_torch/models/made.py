"""MADE: masked autoencoder for distribution estimation. Counterpart of
generative_models_tpu/models/made.py: a 3-hidden-layer ReLU MLP over the 784
flattened binarised pixels with autoregressive connectivity masks, a
Bernoulli NLL loss, and raster-order sampling with one full forward a pixel.

Three routes, chosen as the JAX package chooses them (MADE.build):
  * the kernel route, on the card when the widest layer passes the shape
    gate (ops/masked_dense.py prefer_kernel; --hidden_size >= 1449): every
    layer is masked_dense through Kernels G and H, the masks applied inside
    the kernels, the init NOT masked. It overrides --premasked;
  * the premasked route (--premasked=1, the default otherwise): the masks
    live in the weights (masked init, masked gradients in transform_grads,
    masked params and Adam moments on load), and each layer is a plain
    matmul;
  * the fold route (--premasked=0): x @ (w * m) + b, a plain matmul.
The plain matmuls stay torch.matmul under the operand policy (bf16
operands, f32 sums on the card), as the JAX package left them to XLA.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from generative_models_tpu_torch.models.base import Autoreg, _lecun_normal_
from generative_models_tpu_torch.ops.common import matmul_dtype
from generative_models_tpu_torch.ops.masked_dense import masked_dense, prefer_kernel
from generative_models_tpu_torch.utils import dists, register
from generative_models_tpu_torch.utils.config import AttrDict


def create_made_masks(nin, hidden_sizes, seed=42):
    """Autoregressive connectivity masks, the JAX package's construction:
    natural input order, random hidden ranks in [min(prev_rank), nin-1); a
    hidden mask connects rank-nondecreasing units, the output mask uses a
    strict inequality. (in, out)-shaped float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    m = {-1: np.arange(nin)}
    L = len(hidden_sizes)
    for l in range(L):
        m[l] = rng.randint(m[l - 1].min(), nin - 1, size=hidden_sizes[l])
    masks = [(m[l - 1][:, None] <= m[l][None, :]) for l in range(L)]
    masks.append(m[L - 1][:, None] < m[-1][None, :])
    return [mask.astype(np.float32) for mask in masks]


class MaskedMLP(nn.Module):
    """ReLU MLP of masked layers: parameters w{i} (in, out) and b{i} (out,),
    named and laid out as flax's, and the masks as uint8 buffers m{i} (not
    saved: they follow from the seed). use_kernel routes every layer through
    Kernels G and H; premasked keeps the masks in the weights."""

    def __init__(self, nin, hidden_sizes, nout, masks, use_kernel=False, premasked=False):
        super().__init__()
        self.use_kernel = use_kernel
        self.premasked = premasked
        sizes = (nin, *hidden_sizes, nout)
        self.n_layers = len(sizes) - 1
        for i in range(self.n_layers):
            self.register_parameter(f'w{i}', nn.Parameter(torch.empty(sizes[i], sizes[i + 1])))
            self.register_parameter(f'b{i}', nn.Parameter(torch.zeros(sizes[i + 1])))
            m = torch.as_tensor(np.asarray(masks[i]) != 0, dtype=torch.uint8)
            self.register_buffer(f'm{i}', m, persistent=False)

    def layers(self):
        """[(w, b, mask)] of every layer, input first."""
        return [(getattr(self, f'w{i}'), getattr(self, f'b{i}'), getattr(self, f'm{i}'))
                for i in range(self.n_layers)]

    def flax_init(self, generator):
        """lecun-normal weights (fan_in = in) and zero biases, the weights
        masked on the premasked route only (the JAX package's
        _masked_init); the other routes keep the masked-out draws."""
        for w, b, m in self.layers():
            _lecun_normal_(w, w.shape[0], generator)
            if self.premasked:
                w.mul_(m)
            b.zero_()

    def forward(self, x):
        dt = matmul_dtype(x.device)
        for i, (w, b, m) in enumerate(self.layers()):
            if self.premasked:
                x = x.to(dt).float() @ w.to(dt).float() + b
            else:
                x = masked_dense(x, w, b, m, self.use_kernel)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x


@register
class MADE(Autoreg):
    DG = AttrDict()
    DG.hidden_size = 1024
    DG.premasked = 1  # masks live in the weights; 0 = the fold-the-mask
    # route (the kernel route at the gate's widths overrides either)

    def __init__(self, G):
        self.nin = self.nout = (32 * 32) if G.get('pad32', 0) else 784
        self.hidden_sizes = (int(G.hidden_size),) * 3
        self.masks = create_made_masks(self.nin, self.hidden_sizes,
                                       seed=int(G.get('seed', 0)) + 42)
        super().__init__(G)

    def use_kernel_route(self):
        """The reference's gate, on_tpu() read as a CUDA model: the kernel
        route when the widest layer passes prefer_kernel."""
        sizes = (self.nin, *self.hidden_sizes, self.nout)
        big_k, big_n = max(zip(sizes[:-1], sizes[1:]), key=lambda kn: kn[0] * kn[1])
        return self.device.type == 'cuda' and prefer_kernel(big_k, big_n)

    def build(self):
        use_kernel = self.use_kernel_route()
        premasked = bool(int(self.G.get('premasked', 1))) and not use_kernel
        return MaskedMLP(self.nin, self.hidden_sizes, self.nout, self.masks,
                         use_kernel=use_kernel, premasked=premasked)

    # --- the premasked invariant: masked-out weights stay exactly 0 ---
    def transform_grads(self):
        if not self.net.premasked:
            return
        for w, _, m in self.net.layers():
            if w.grad is not None:
                w.grad.mul_(m)

    @torch.no_grad()
    def load_weights(self, path):
        """Checkpoints of the other routes carry unused values in the
        masked-out weights and live Adam moments (and a --grad_accum
        window's mean) there; on the premasked route zero all of them, so
        the premasked forward stays exact."""
        super().load_weights(path)
        if not self.net.premasked:
            return
        params = [p for group in self.opt.param_groups for p in group['params']]
        for w, _, m in self.net.layers():
            w.mul_(m)
            for key in ('exp_avg', 'exp_avg_sq'):
                if key in self.opt.state.get(w, {}):
                    self.opt.state[w][key].mul_(m)
            if self._acc is not None:
                self._acc[next(j for j, p in enumerate(params) if p is w)].mul_(m)

    def loss(self, x, y=None):
        x = x.reshape(-1, self.nin)
        logits = self.net(x)
        loss = -dists.Bernoulli(logits=logits).log_prob(x).mean()
        return loss, {'nlogp': loss}

    def sample_fn(self, n, generator=None, uniforms=None, with_frames=True):
        """Raster-order sampling: nin steps of one full forward each, pixel i
        set to u_i < sigmoid(logit_i). uniforms (nin, n), the draws of step
        i in row i, replace the generator's. Returns the samples (n, H, W,
        1) and, with with_frames, the (nin, n, H, W, 1) canvas after each
        step."""
        side = math.isqrt(self.nin)
        if uniforms is None:
            uniforms = torch.rand((self.nin, n), generator=generator, device=self.device)
        samples = torch.zeros((n, self.nin), device=self.device)
        for i in range(self.nin):
            logits = self.net(samples)
            samples[:, i] = dists.Bernoulli(logits=logits[:, i]).sample(uniforms=uniforms[i])
        out = samples.reshape(n, side, side, 1)
        if not with_frames:
            return out
        # frame i is the final canvas with the pixels after i still 0: each
        # pixel is written once, at its own step
        tri = torch.ones((self.nin, self.nin), device=self.device).tril()
        frames = tri[:, None, :] * samples[None]
        return out, frames.reshape(self.nin, n, side, side, 1)
