"""Wavenet over the raster sequence of pixels. Counterpart of
generative_models_tpu/models/wavenet.py: a causal 'A' conv (kernel 2) into
nine gated residual blocks with dilations 2^0..2^8 (or, with
--use_resblock=0, nine plain dilated convs), a 1x1 output Dense, Bernoulli
over the pixels.

A kernel-2 dilated causal conv is two shifted products, each tap a (C, F)
matrix (CausalConv1x2.k0 and k1, the JAX package's (2, C, F) kernel split):
the 'A' layer is y_t = K0 x_{t-2} + K1 x_{t-1}, a 'B' layer y_t = K0
x_{t-d} + K1 x_t. There is no right-shift: the A layer keeps the net
causal. Sampling decodes incrementally: WavenetNet.decode_step carries
s_{t-2} for the A layer and a d-slot ring for each dilated layer (slot t
mod d), one position a step, as the JAX package's.

dtype is WavenetNet's compute dtype, as the JAX package's field: bf16 on the
card, as the JAX package runs on its accelerator, f32 on the CPU. Operands
and activations (the rings too) are in dtype, each product sums in f32 and
is rounded back to dtype with the bias (the convs) or rounded and then
biased in dtype (res1x1, flax's Dense(dtype=...)); the parameters stay f32,
and so does out_dense.

Quantized serving (serve.py --quantize): the nine res1x1 (320 x 320 at the
default width) are the QuantTable's entries, blocks.{i}.res1x1 (flax's
block{i}/res1x1); each goes through int8_matmul, Kernel I (w8a8) or J
(w8a16), in every decode step and in the full forward, and returns f32, so
the residual stream is f32 from the first block on, as under the JAX
package's interceptor. --use_resblock=0 has nothing large enough to
quantize, and serving exits.
"""

import torch
import torch.nn.functional as F
from torch import nn

from generative_models_tpu_torch import convert
from generative_models_tpu_torch.models.base import RasterAutoreg, _lecun_normal_
from generative_models_tpu_torch.models.rnn import append_location, location_grid
from generative_models_tpu_torch.utils import dists, register
from generative_models_tpu_torch.utils.config import AttrDict
from generative_models_tpu_torch.utils.graphs import stage
from generative_models_tpu_torch.utils.loop import fori_loop, write


def _mm(x, k):
    """x (..., C) @ k (C, F) with both in the compute dtype: exact products,
    f32 sums and output."""
    return x.float() @ k.float()


class CausalConv1x2(nn.Module):
    """Kernel-2 dilated causal conv, one set of params for the full and the
    single-step paths; a_type: the reference's 'A' layer."""

    def __init__(self, in_c, features, dilation=1, a_type=False, dtype=torch.float32):
        super().__init__()
        self.dilation, self.a_type, self.dtype = dilation, a_type, dtype
        self.k0 = nn.Parameter(torch.empty(in_c, features))
        self.k1 = nn.Parameter(torch.empty(in_c, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def flax_init(self, generator):
        """lecun-normal over the (2, C, F) kernel (fan_in 2C), zero bias."""
        for k in (self.k0, self.k1):
            _lecun_normal_(k, 2 * k.shape[0], generator)
        self.bias.zero_()

    def forward(self, x, x_prev=None):
        """Full: x (B, T, C), x_prev None. Step: x (B, C) the current input
        (x_{t-1} for A, x_t for B), x_prev (B, C) (x_{t-2} for A, x_{t-d}
        for B)."""
        dt = self.dtype
        k0, k1 = self.k0.to(dt), self.k1.to(dt)
        if x_prev is None:
            xc, T = x.to(dt), x.shape[1]
            shift = 2 if self.a_type else self.dilation
            x_prev = F.pad(xc, (0, 0, shift, 0))[:, :T]
            x = F.pad(xc, (0, 0, 1, 0))[:, :T] if self.a_type else xc
        return (_mm(x_prev.to(dt), k0) + _mm(x.to(dt), k1) + self.bias).to(dt)


class GatedResidualBlock(nn.Module):
    """tanh/sigmoid-gated dilated conv and a 1x1 residual Dense."""

    def __init__(self, channels, dilation, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dilated = CausalConv1x2(channels, 2 * channels, dilation, dtype=dtype)
        self.res1x1 = nn.Linear(channels, channels)

    def _res1x1(self, g, quant, name):
        if quant is not None and name in quant.dense:
            return quant.linear(g, name, self.res1x1)
        dt = self.dtype
        y = (_mm(g.to(dt), self.res1x1.weight.to(dt).t())).to(dt)
        return y + self.res1x1.bias.to(dt)

    def forward(self, x, x_prev=None, quant=None, name=''):
        """Full (x_prev None) or step, as CausalConv1x2; quant: a QuantTable
        keyed from the net, name: this block's key in it."""
        o1, o2 = self.dilated(x, x_prev).chunk(2, -1)
        return x + self._res1x1(torch.tanh(o1) * torch.sigmoid(o2), quant, f'{name}.res1x1')


class WavenetNet(nn.Module):
    def __init__(self, res_channels, use_resblock=True, layer_size=9, in_channels=3,
                 dtype=torch.float32):
        super().__init__()
        self.res_channels, self.use_resblock, self.dtype = res_channels, use_resblock, dtype
        C = res_channels
        self.causal = CausalConv1x2(in_channels, C, a_type=True, dtype=dtype)
        self.blocks = nn.ModuleList(
            GatedResidualBlock(C, 2**i, dtype) if use_resblock
            else CausalConv1x2(C, C, 2**i, dtype=dtype)
            for i in range(layer_size))
        self.out_dense = nn.Linear(C, 1)  # the logits stay f32

    def _layer(self, i, h, x_prev, quant):
        block = self.blocks[i]
        if self.use_resblock:
            return block(h, x_prev, quant, f'blocks.{i}')
        return block(h, x_prev)

    def _out(self, h):
        return F.linear(h.float(), self.out_dense.weight, self.out_dense.bias)[..., 0]

    def forward(self, x, quant=None):
        """(B, T, in_channels) -> (B, T) logits; quant: a QuantTable keyed
        from this net."""
        h = self.causal(x)
        for i in range(len(self.blocks)):
            h = self._layer(i, h, None, quant)
        return self._out(h)

    # ------------------------- incremental decode ------------------------- #
    def init_buffers(self, n, in_channels=3):
        """s_{t-2} for the A layer, and a d-slot ring a dilated layer in the
        compute dtype (zeros: the full path's left pad)."""
        dev = self.out_dense.weight.device
        a_buf = torch.zeros((n, in_channels), device=dev)
        rings = [torch.zeros((n, 2**i, self.res_channels), dtype=self.dtype, device=dev)
                 for i in range(len(self.blocks))]
        return a_buf, rings

    def decode_step(self, buffers, s_prev, t, quant=None):
        """Consume s_{t-1} (the input at position t-1) and return the logit
        for position t (B,) and the buffers, whose rings are updated in
        place when eager and are new tensors under torch.export
        (utils/loop.py write)."""
        a_buf, rings = buffers
        h = self.causal(s_prev, a_buf)  # K0 s_{t-2} + K1 s_{t-1}
        written = []
        for i, ring in enumerate(rings):
            slot = t % ring.shape[1]
            nxt = self._layer(i, h, ring.select(1, slot), quant)  # reads x_{t-d}
            written.append(write(ring, (slice(None), slot), h))  # then stores x_t there
            h = nxt
        return self._out(h), (s_prev, written)


@register
class Wavenet(RasterAutoreg):
    params_from_jax = staticmethod(convert.wavenet_params_from_jax)  # a JAX model.pt
    DG = AttrDict()
    DG.use_resblock = 1
    DG.hidden_size = 320

    def build(self, dtype=None):
        """dtype: the compute dtype, bf16 on the card and f32 on the CPU
        unless given."""
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == 'cuda' else torch.float32
        return WavenetNet(int(self.G.hidden_size), bool(int(self.G.use_resblock)), dtype=dtype)

    def inputs(self, x):
        """(B, H, W, 1) images -> the (B, T, 3) sequence with locations."""
        return append_location(x).reshape(x.shape[0], self.canvas_size, 3)

    def logits(self, x, quant=None):
        """The full forward's logits (B, T) of images x (B, H, W, 1);
        quant: a QuantTable over self.net."""
        return self.net(self.inputs(x), quant)

    def loss(self, x, y=None):
        logits = self.logits(x).reshape(x.shape)
        loss = -dists.Bernoulli(logits=logits).log_prob(x).mean()
        return loss, {'nlogp': loss}

    @torch.no_grad()
    def decode_chain(self, n, next_pixel, state=(), quant=None, graphs=None):
        """The incremental decode: step t reads pixel t - 1 with its
        location (location_grid's values). Graphed: a row of steps a graph,
        t a host int baked in (its ring slots are views, as eager)."""
        locs = location_grid(self.side, self.device).reshape(self.canvas_size, 2)

        def step(t, carry):
            buffers, s, state = carry
            logit, buffers = self.net.decode_step(buffers, s, t, quant)
            pix, state = next_pixel(t, logit, state)
            return buffers, torch.cat([pix[:, None], locs[t].expand(n, 2)], 1), state

        buffers, s = stage(graphs, 'first', lambda: (
            self.net.init_buffers(n), torch.zeros((n, 3), device=self.device)))
        graphed = () if graphs is None else (self.side, graphs)
        return fori_loop(0, self.canvas_size, step, (buffers, s, state), *graphed)[2]
