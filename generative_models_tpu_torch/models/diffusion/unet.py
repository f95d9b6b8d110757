"""MNIST-sized UNet. Counterpart of
generative_models_tpu/models/diffusion/unet.py: constant channel width, a
sinusoidal logSNR embedding (max_period=256) through a 2-layer MLP, an
additive one-hot class embedding (zeroed for label -1) and, for a distilled
student, a guidance-weight embedding (max_period=4); down / turn / up with
every down activation kept as a skip; GroupNorm / SiLU ResBlocks whose
output conv starts at zero.

The public tensors are NHWC, as the JAX package's; the convs run NCHW. The
compute dtype is the JAX package's flax dtype: with bfloat16 every Conv and
Linear casts its input, weight and bias to bf16 (the parameters stay f32),
GroupNorm takes its statistics and affine in f32 and returns bf16, whatever
its input's dtype (a quantized Linear's f32 output, added to a bf16 map,
goes back to bf16 at the next GroupNorm, as in flax), and the output is
cast back to the input's dtype. Module
names follow flax's (Downsample_i -> down.i, ResBlock_i -> blocks.i,
Upsample_i -> ups.i; convert.diffusion_params_from_jax).

Quantized serving (serve.py --quantize): forward takes a QuantTable
(ops/int8.py) over the net as quant=; every Linear it holds (the embedding
MLPs' and each ResBlock's emb projection that pass the size thresholds:
at the default width 128, time_embed's two, guide_embed's second,
cond_w_embed's two and the twelve (256 -> 128) projections) runs through
Kernel I (w8a8) or J (w8a16), in f32, plus its f32 bias: the f32 result
promotes what it is added to, as the JAX package's interceptor returns
f32 from a bf16 net.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from generative_models_tpu_torch.models.vqvae import same_pad
from generative_models_tpu_torch.parallel.mesh import (
    MODEL_AXIS, get_mesh, model_slice, tp_copy, tp_reduce,
)
from generative_models_tpu_torch.utils.dists import batch_draw

MAX_TIMESTEPS = 256
N_CLASSES = 10


def timestep_embedding(timesteps, dim, max_period):
    """Sinusoidal embedding, cos first, a zero column for an odd dim."""
    half = dim // 2
    arange = torch.arange(half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(-math.log(max_period) * arange / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Linear(nn.Linear):
    """flax Dense(dtype=...): input, weight and bias in dtype (SimpleUnet
    sets the net's; None: the input's)."""

    dtype = None

    def forward(self, x):
        dt = self.dtype or x.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _linear(layer, x, quant, name):
    """layer(x), or the QuantTable's int8 product (f32) where it holds
    name."""
    if quant is None or name not in quant.dense:
        return layer(x)
    return quant.linear(x, name, layer)


class Conv(nn.Conv2d):
    """flax Conv(padding='SAME', dtype=...) on NCHW: input, weight and bias
    in dtype (as Linear's); SAME pads (k - 1) / 2 a side at stride 1, and an
    odd total after the image at stride 2."""

    dtype = None

    def forward(self, x, bias=None):
        """bias: the bias to add in place of self.bias (None: self.bias)."""
        x = x.to(self.dtype or x.dtype)
        (k, _), (s, _) = self.kernel_size, self.stride
        top, bottom = same_pad(x.shape[2], k, s)
        left, right = same_pad(x.shape[3], k, s)
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        b = self.bias if bias is None else bias
        return F.conv2d(x, self.weight.to(x.dtype), b.to(x.dtype), self.stride, pad)


class ZeroConv(Conv):
    """A Conv whose weight and bias start at zero (flax_init_ draws none)."""

    def flax_init(self, generator):
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


class GroupNorm(nn.Module):
    """flax GroupNorm(num_groups=min(32, C), epsilon=1e-6, dtype=...) on
    NCHW: the statistics in f32 with the fast variance max(0, E[x^2] -
    E[x]^2), then (x - mean) * rsqrt(var + eps) * scale + bias in f32,
    returned in dtype (as Linear's)."""

    dtype = None

    def __init__(self, channels, eps=1e-6):
        super().__init__()
        self.groups, self.eps, self.channels = min(32, channels), eps, channels
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        B, C = x.shape[:2]
        G = self.groups * C // self.channels  # this rank's groups on a channel shard
        xg = x.float().reshape(B, G, C // G, -1)
        mean = xg.mean((2, 3), keepdim=True)
        mean2 = xg.square().mean((2, 3), keepdim=True)
        var = torch.clamp_min(mean2 - mean.square(), 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G, 1)
        y = (xg - mean) * mul + self.bias.reshape(G, C // G, 1)
        return y.reshape(x.shape).to(self.dtype or x.dtype)


class EmbedMLP(nn.Module):
    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.dense0 = Linear(in_dim, out_dim)
        self.dense1 = Linear(out_dim, out_dim)

    def forward(self, x, quant=None, name=''):
        h = F.silu(_linear(self.dense0, x, quant, f'{name}.dense0'))
        return _linear(self.dense1, h, quant, f'{name}.dense1')


class ResBlock(nn.Module):
    """GN/SiLU/conv + the embedding's projection + GN/SiLU/dropout/zero-init
    conv, plus the input (through a 1x1 conv where the width changes)."""

    def __init__(self, in_channels, out_channels, emb_dim, dropout=0.0):
        super().__init__()
        self.norm0 = GroupNorm(in_channels)
        self.conv0 = Conv(in_channels, out_channels, 3)
        self.dense = Linear(emb_dim, out_channels)
        self.norm1 = GroupNorm(out_channels)
        self.dropout = dropout
        self.conv1 = ZeroConv(out_channels, out_channels, 3)
        self.skip = Conv(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x, emb, quant=None, name='', mask=None):
        """mask: dropout's (keep / keep_prob), the output channels' shape;
        F.dropout's own draw without it. Under the model axis conv0 and the
        emb Dense are column-parallel (their input through tp_copy), norm1
        and the dropout act on this rank's channels and conv1 is
        row-parallel, its partial sums reduced (rank 0's holding the
        bias)."""
        h = self.conv0(tp_copy(F.silu(self.norm0(x))))
        h = h + _linear(self.dense, tp_copy(F.silu(emb)), quant, f'{name}.dense')[:, :, None, None]
        h = F.silu(self.norm1(h))
        h = h * mask if mask is not None else F.dropout(h, self.dropout, self.training)
        if get_mesh().group(MODEL_AXIS) is None:
            h = self.conv1(h)
        else:
            # the bias in rank 0's partial sum alone, its gradient summed
            # back to every rank: at model:1 the no-group conv, bitwise
            first = float(get_mesh().rank(MODEL_AXIS) == 0)
            h = tp_reduce(self.conv1(h, bias=tp_copy(self.conv1.bias) * first))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Upsample(nn.Module):
    """Nearest x2, then a SAME 3x3 conv."""

    def __init__(self, channels):
        super().__init__()
        self.conv = Conv(channels, channels, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode='nearest'))


class SimpleUnet(nn.Module):
    """(z (B, H, W, 1), logsnr (B,), guide (B,) int labels or None, cond_w
    (B,) or None) -> (B, H, W, out_channels). cond_w needs a net built with
    cond_w=True (a distilled student's guidance-weight embedding). remat
    recomputes each ResBlock in the backward (torch.utils.checkpoint) under
    grad. quant: a QuantTable over this net (serving)."""

    def __init__(self, channels, dropout=0.0, out_channels=1, dtype=torch.float32,
                 remat=False, cond_w=False):
        super().__init__()
        C, emb_dim = channels, 2 * channels
        self.dtype, self.remat = dtype, remat
        self.time_embed = EmbedMLP(64, emb_dim)
        self.guide_embed = EmbedMLP(N_CLASSES, emb_dim)
        self.cond_w_embed = EmbedMLP(64, emb_dim) if cond_w else None
        self.down = nn.ModuleList([Conv(1, C, 3)] + [Conv(C, C, 3, stride=2) for _ in range(2)])
        # down 0-3, turn 4, up 5-11 (each up block takes [h, skip])
        self.blocks = nn.ModuleList(
            [ResBlock(C, C, emb_dim, dropout) for _ in range(5)]
            + [ResBlock(2 * C, C, emb_dim, dropout) for _ in range(7)]
        )
        self.ups = nn.ModuleList([Upsample(C) for _ in range(2)])
        self.norm_out = GroupNorm(C)
        self.conv_out = Conv(C, out_channels, 3)
        for m in self.modules():  # flax's dtype= on every layer
            if isinstance(m, (Linear, Conv, GroupNorm)):
                m.dtype = dtype

    drop_gen = None  # () -> the generator of dropout's masks (the model's training draws)

    def _drop_mask(self, block, h):
        """Block's dropout mask for input h, drawn from drop_gen at the
        global batch and the full width (dists.batch_draw), this rank's rows
        and channels kept: the one-process mask's slice."""
        B, _, H, W = h.shape
        C = block.conv1.weight.shape[0]
        u = batch_draw(torch.rand, (B, C, H, W), self.drop_gen(), h.device)[:, model_slice(C)]
        keep = 1.0 - block.dropout
        return (u < keep).to(self.dtype or h.dtype) / keep

    def _block(self, i, h, emb, quant=None):
        block = self.blocks[i]
        mask = None
        if self.training and block.dropout > 0 and self.drop_gen is not None:
            mask = self._drop_mask(block, h)  # drawn once, outside any recompute
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, h, emb, None, '', mask, use_reentrant=False)
        return block(h, emb, quant, f'blocks.{i}', mask)

    def forward(self, x, logsnr, guide=None, cond_w=None, quant=None):
        dt, in_dtype = self.dtype, x.dtype
        emb = self.time_embed(timestep_embedding(logsnr, 64, MAX_TIMESTEPS).to(dt), quant,
                              'time_embed')
        if guide is not None:
            mask = guide == -1
            safe = torch.where(mask, 0, guide)
            # an out-of-range label one-hots to zeros, as jax.nn.one_hot
            classes = torch.arange(N_CLASSES, device=guide.device)
            g = (safe[:, None] == classes).to(dt)
            emb = emb + torch.where(mask[:, None], 0.0, self.guide_embed(g, quant, 'guide_embed'))
        if cond_w is not None:
            if self.cond_w_embed is None:
                raise ValueError('cond_w given to a UNet built without cond_w_embed')
            emb = emb + self.cond_w_embed(timestep_embedding(cond_w, 64, 4).to(dt), quant,
                                          'cond_w_embed')

        h = self.down[0](x.permute(0, 3, 1, 2).to(dt))
        cache = [h]
        for stage in range(2):
            for j in range(2):
                h = self._block(2 * stage + j, h, emb, quant)
                cache.append(h)
            h = self.down[stage + 1](h)
            cache.append(h)
        h = self._block(4, h, emb, quant)  # turn
        for i, skip in enumerate(cache[::-1]):
            h = self._block(5 + i, torch.cat([h, skip], dim=1), emb, quant)
            if i in (0, 3):
                h = self.ups[0 if i == 0 else 1](h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return h.permute(0, 2, 3, 1).to(in_dtype)
