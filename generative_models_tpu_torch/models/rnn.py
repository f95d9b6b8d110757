"""Pixel-RNN: an LSTM over the pixels in raster order. Counterpart of
generative_models_tpu/models/rnn.py.

The cell is written out once (LSTMPixelNet.cell: fused gates in the order
i, f, g, o; wi with a bias, wh without) and serves training, scoring and
sampling. The full forward takes the input projection over all T positions
in one product, then runs the cell a position at a time in a Python loop
(the JAX package's nn.scan); sampling and the teacher-forced chain run
LSTMPixelNet.step, the same cell with wi applied to the one input
(its lax.scan). Every product runs under the operand policy (bf16 operands,
f32 sums on the card), as the JAX package leaves them to XLA.

Quantized serving (serve.py --quantize): at the default hidden_size=256
the QuantTable holds wh alone (256 x 1024; wi's 3 x 1024 and fc's 256 x 1
are under the thresholds), so each step runs one int8_matmul, Kernel I
(w8a8) or J (w8a16), where the JAX package's interceptor replaces wh's
Dense call. The full forward takes quant= as well.

The location channels (--append_loc): training reads location_grid, a copy
of jnp.linspace's values (i * (1 / (side - 1)) in f32), and sampling feeds
(i // side) / (side - 1), an f32 division, as the JAX package's sampler
computes it; the two differ in the last bit at some positions, and each is
copied as it is. wavenet imports both helpers from here.
"""

import functools

import numpy as np
import torch
from torch import nn

from generative_models_tpu_torch import convert
from generative_models_tpu_torch.models.base import RasterAutoreg
from generative_models_tpu_torch.ops.common import matmul_dtype
from generative_models_tpu_torch.utils import dists, register
from generative_models_tpu_torch.utils.config import AttrDict
from generative_models_tpu_torch.utils.loop import exporting, fori_loop


def location_grid(side=28, device='cpu'):
    """(side, side, 2): (row, col) * (1 / (side - 1)) in f32, bitwise the
    JAX package's location_grid (jnp.linspace(0, 1, side) on a meshgrid).
    Made once a side and device (not to be written), so a train step reads
    it and copies nothing from the host, and a CUDA graph can capture it;
    under torch.export made anew (a traced tensor is not kept)."""
    if exporting():
        return _location_grid.__wrapped__(side, torch.device(device))
    return _location_grid(side, torch.device(device))


@functools.cache
def _location_grid(side, device):
    r = np.arange(side, dtype=np.float32) * (np.float32(1) / np.float32(side - 1))
    rows, cols = np.meshgrid(r, r, indexing='ij')
    return torch.from_numpy(np.stack([rows, cols], -1)).to(device)


def sampling_locations(side=28, device='cpu'):
    """(side * side, 2): pixel i's ((i // side) / (side - 1), (i % side) /
    (side - 1)) as f32 divisions, the values the JAX package's rnn sampler
    feeds after drawing pixel i."""
    i = np.arange(side * side)
    loc = np.stack([i // side, i % side], -1).astype(np.float32) / np.float32(side - 1)
    return torch.from_numpy(loc).to(device)


def append_location(x):
    """(B, H, W, C) -> (B, H, W, C + 2) with the normalised coordinates."""
    b, h, w, _ = x.shape
    grid = location_grid(h, x.device).expand(b, h, w, 2)
    return torch.cat([x, grid.to(x.dtype)], -1)


def linear_fn(layer, quant=None, name=''):
    """x -> layer(x): through quant.linear when a QuantTable is given (an
    int8_matmul where it holds name), otherwise under the operand policy
    with the weight rounded once, here, for every call of the function."""
    if quant is not None:
        return lambda x: quant.linear(x, name, layer)
    dt = matmul_dtype(layer.weight.device)
    w = layer.weight.to(dt).float().t()
    b = layer.bias
    return lambda x: x.to(dt).float() @ w if b is None else x.to(dt).float() @ w + b


class LSTMPixelNet(nn.Module):
    """wi (in -> 4H, bias), wh (H -> 4H, no bias), fc (H -> 1), named as
    flax's Dense modules."""

    def __init__(self, hidden, in_channels):
        super().__init__()
        self.hidden = hidden
        self.wi = nn.Linear(in_channels, 4 * hidden)
        self.wh = nn.Linear(hidden, 4 * hidden, bias=False)
        self.fc = nn.Linear(hidden, 1)

    def products(self, quant=None):
        """(wi, wh, fc) as functions of their input, for one pass."""
        return tuple(linear_fn(getattr(self, n), quant, n) for n in ('wi', 'wh', 'fc'))

    @staticmethod
    def cell(h, c, gx, wh):
        """One LSTM step from the input's projection gx = wi(x_t)."""
        i, f, g, o = (gx + wh(h)).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def forward(self, x_seq, quant=None):
        """Teacher-forced sequence (B, T, C), already shifted -> (B, T)
        logits."""
        wi, wh, fc = self.products(quant)
        B = x_seq.shape[0]
        h = c = x_seq.new_zeros(B, self.hidden)
        hs = []
        # unbind, not gx[:, t]: its backward stacks the T gradients once,
        # where T indexing backwards would each write a zero (B, T, 4H)
        for gx_t in wi(x_seq).unbind(1):
            h, c = self.cell(h, c, gx_t, wh)
            hs.append(h)
        return fc(torch.stack(hs, 1))[..., 0]

    def step(self, h, c, x_t, products):
        """One decode step: (h, c, the logit (B,)) after input x_t (B, C)."""
        wi, wh, fc = products
        h, c = self.cell(h, c, wi(x_t), wh)
        return h, c, fc(h)[..., 0]


@register
class RNN(RasterAutoreg):
    params_from_jax = staticmethod(convert.rnn_params_from_jax)  # a JAX model.pt
    DG = AttrDict()
    DG.append_loc = 1  # the reference's default (hidden_size stays 256)

    def __init__(self, G):
        self.in_channels = 3 if G.append_loc else 1
        super().__init__(G)

    def build(self):
        return LSTMPixelNet(int(self.G.hidden_size), self.in_channels)

    def shifted_inputs(self, x):
        """(B, H, W, 1) images -> the (B, T, C) sequence the net reads: the
        location appended, right-shifted behind a zero start token."""
        bs = x.shape[0]
        seq = (append_location(x) if self.G.append_loc else x).reshape(
            bs, self.canvas_size, self.in_channels)
        return torch.cat([seq.new_zeros(bs, 1, self.in_channels), seq[:, :-1]], 1)

    def logits(self, x, quant=None):
        """The full forward's logits (B, T) of images x (B, H, W, 1);
        quant: a QuantTable over self.net."""
        return self.net(self.shifted_inputs(x), quant)

    def loss(self, x, y=None):
        logits = self.logits(x).reshape(x.shape)
        loss = -dists.Bernoulli(logits=logits).log_prob(x).mean()
        return loss, {'nlogp': loss}

    @torch.no_grad()
    def decode_chain(self, n, next_pixel, state=(), quant=None):
        """The LSTM chain: step t reads pixel t - 1 with its location."""
        net, products = self.net, self.net.products(quant)
        locs = sampling_locations(self.side, self.device) if self.G.append_loc else None

        def step(t, carry):
            h, c, x, state = carry
            h, c, logit = net.step(h, c, x, products)
            pix, state = next_pixel(t, logit, state)
            x = pix[:, None] if locs is None else torch.cat([pix[:, None], locs[t].expand(n, 2)], 1)
            return h, c, x, state

        zeros = lambda width: torch.zeros((n, width), device=self.device)
        carry = (zeros(net.hidden), zeros(net.hidden), zeros(self.in_channels), state)
        return fori_loop(0, self.canvas_size, step, carry)[3]
