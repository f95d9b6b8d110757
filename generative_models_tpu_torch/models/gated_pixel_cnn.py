"""GatedPixelCNN: vertical and horizontal stacks that close PixelCNN's blind
spot. Counterpart of generative_models_tpu/models/gated_pixel_cnn.py. The
vertical stack sees the rows above, the horizontal stack the pixels left of
the centre on its row, linked by a 1x1 conv of the down-shifted vertical
features; tanh * sigmoid gates both.

The vertical and horizontal stacks stay two tensors (vx, hx). The stack
masks zero whole kernel rows or columns, so each conv runs on its causal
support: the v conv on rows [:p+1] padded by p above, the h conv on columns
[:p+1] ('B') or [:p] ('A', with a negative pad on the right), p = k // 2.
link and out1x1 are 1x1 convs without a bias. Layouts, dtypes, --bf16 and
the decode's f32 are as in models/pixel_cnn.py, whose PixelCNN and
MaskConv2d this reuses.

Sampling is a hybrid wavefront: the h stack is raster-causal, so each step
computes one position a layer against cached canvases; the v stack's mask
spans its whole centre row, so its activations are only row-causal and are
computed a row at a time, for row r - 1, as the cursor enters row r (the
JAX package's lax.cond on c == 0; utils/loop.py when here: a Python if,
or torch.cond in an exported program).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from generative_models_tpu_torch import convert
from generative_models_tpu_torch.models.pixel_cnn import (
    LN_EPS, MaskConv2d, PixelCNN, layer_norm, nhwc_conv, window_product,
)
from generative_models_tpu_torch.utils import register
from generative_models_tpu_torch.utils.config import AttrDict
from generative_models_tpu_torch.utils.loop import when, write


def vstack_mask(k):
    """(k, k): rows 0..k // 2 kept."""
    m = np.zeros((k, k), np.float32)
    m[: k // 2 + 1, :] = 1.0
    return m


def hstack_mask(k, mask_type):
    """(1, k): columns 0..k // 2 kept, the centre dropped for 'A'."""
    m = np.zeros((1, k), np.float32)
    m[0, : k // 2 if mask_type == 'A' else k // 2 + 1] = 1.0
    return m


def down_shift(x):
    """NHWC rows shifted down by one, a zero row on top."""
    return F.pad(x[:, :-1], (0, 0, 0, 0, 1, 0))


def gate(x):
    a, b = x.chunk(2, -1)
    return torch.tanh(a) * torch.sigmoid(b)


def conv1x1(x, conv, dtype=None):
    """A 1x1 conv without a bias on NHWC x (or (n, C) vectors) in dtype
    (flax's nn.Conv(dtype=...)): a product over the channels."""
    w = conv.weight[:, :, 0, 0]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    return x @ w.t()


class GatedConv2d(nn.Module):
    """v_conv (k x k) and h_conv (1 x k) kernels to 2F channels, link (2F
    -> 2F) and out1x1 (F -> F)."""

    def __init__(self, mask_type, features, kernel_size=7, in_features=None, dtype=None):
        super().__init__()
        in_c = features if in_features is None else in_features
        self.mask_type, self.k, self.dtype = mask_type, kernel_size, dtype
        self.v_conv = nn.Conv2d(in_c, 2 * features, kernel_size, bias=False)
        self.h_conv = nn.Conv2d(in_c, 2 * features, (1, kernel_size), bias=False)
        self.link = nn.Conv2d(2 * features, 2 * features, 1, bias=False)
        self.out1x1 = nn.Conv2d(features, features, 1, bias=False)
        self.register_buffer('hmask', torch.from_numpy(hstack_mask(kernel_size, mask_type)),
                             persistent=False)

    def forward(self, vx, hx):
        p, dt = self.k // 2, self.dtype
        end = p + 1 if self.mask_type == 'B' else p
        wv, wh = self.v_conv.weight[:, :, : p + 1], self.h_conv.weight[:, :, :, :end]
        if dt is not None:
            vx, hx, wv, wh = vx.to(dt), hx.to(dt), wv.to(dt), wh.to(dt)
        vx_out = nhwc_conv(vx, wv, (p, p, p, 0))
        hx_new = nhwc_conv(hx, wh, (p, end - p - 1, 0, 0))
        hx_new = hx_new + conv1x1(down_shift(vx_out), self.link, dt)
        return gate(vx_out), hx + conv1x1(gate(hx_new), self.out1x1, dt)

    # ---------------------------- decode pieces ---------------------------- #
    def v_row(self, strip):
        """The raw v-conv outputs of one row: strip (n, p + 1, Wp, C), the
        rows of the relu'd v canvas that end at the output row -> (n, Wp -
        2p, 2F)."""
        p = self.k // 2
        return nhwc_conv(strip, self.v_conv.weight[:, :, : p + 1], (0, 0, 0, 0))[:, 0]

    def h_step(self, hw, vo_prev):
        """One h-stack position: hw (n, 1, p + 1, C) the relu'd window that
        ends at the centre column, vo_prev (n, 2F) the raw v output of the
        row above -> the raw h update (n, 2F)."""
        p = self.k // 2
        w = (self.h_conv.weight * self.hmask)[:, :, :, : p + 1]
        return window_product(hw, w) + conv1x1(vo_prev, self.link)

    def h_out(self, hx, raw):
        """Gate, out1x1 and the residual at one position: (n, F)."""
        return hx + conv1x1(gate(raw), self.out1x1)


class StackLayerNorm(nn.Module):
    def __init__(self, features, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.ln_v = nn.LayerNorm(features, eps=LN_EPS)
        self.ln_h = nn.LayerNorm(features, eps=LN_EPS)

    def forward(self, vx, hx):
        return layer_norm(self.ln_v, vx, self.dtype), layer_norm(self.ln_h, hx, self.dtype)


class GatedPixelCNNNet(nn.Module):
    def __init__(self, n_filters, n_layers, kernel_size, dtype=None):
        super().__init__()
        self.n_filters, self.n_layers, self.kernel_size, self.dtype = (
            n_filters, n_layers, kernel_size, dtype)
        n_gated = n_layers - 2
        self.conv_in = MaskConv2d('A', 1, n_filters, kernel_size, dtype=dtype)
        self.gated = nn.ModuleList(
            GatedConv2d('B', n_filters, kernel_size, in_features=n_filters, dtype=dtype)
            for _ in range(n_gated))
        self.stack_lns = nn.ModuleList(StackLayerNorm(n_filters, dtype) for _ in range(n_gated))
        self.conv_out = MaskConv2d('B', n_filters, 1, kernel_size, dtype=dtype)

    def forward(self, x):
        vx = hx = self.conv_in(x)
        for gated, lns in zip(self.gated, self.stack_lns):
            vx, hx = lns(*gated(F.relu(vx), F.relu(hx)))
        return self.conv_out(hx)

    # ---------------------- incremental hybrid decode ----------------------
    # Canvases, all padded by p = k // 2 on each spatial edge (f32):
    #   c0   : the input pixels (1 channel)
    #   s0   : the A conv's outputs, a pixel at a time (both stacks' root)
    #   v[i] : the v-stack input of gated layer i + 1, a row at a time
    #   vo[i]: gated layer i's raw v-conv outputs (2F), a row at a time; the
    #          h chain reads them at the row above the cursor (the link)
    #   h[i] : the h-stack input of gated layer i + 1, a pixel at a time
    #   hfin : the last h stack (conv_out's input), a pixel at a time

    def init_canvases(self, n, side):
        dev = self.conv_in.weight.device
        hw, Fn, n_gated = side + self.kernel_size // 2 * 2, self.n_filters, self.n_layers - 2
        z = lambda c: torch.zeros((n, hw, hw, c), device=dev)
        return dict(c0=z(1), s0=z(Fn), v=[z(Fn) for _ in range(n_gated - 1)],
                    vo=[z(2 * Fn) for _ in range(n_gated)],
                    h=[z(Fn) for _ in range(n_gated - 1)], hfin=z(Fn))

    def _row_update(self, cv, r):
        """cv with the v-stack activations of row r - 1 (r >= 1), every
        layer in order, written into vo[i] and v[i]."""
        p = self.kernel_size // 2
        above = torch.sym_max(r - 1, 0)  # r - 1, known >= 0 under export
        row_out, side = above + p, cv['c0'].shape[2] - 2 * p
        cols = (slice(None), row_out, slice(p, p + side))
        src = cv['s0'].narrow(1, above, p + 1)  # the p + 1 rows that end at the output row
        vo, v = list(cv['vo']), list(cv['v'])
        for i, (gated, lns) in enumerate(zip(self.gated, self.stack_lns)):
            vo_row = gated.v_row(F.relu(src))  # (n, side, 2F)
            vo[i] = write(vo[i], cols, vo_row)
            if i + 1 < len(self.gated):
                v[i] = write(v[i], cols, layer_norm(lns.ln_v, gate(vo_row)))
                src = v[i].narrow(1, above, p + 1)
        return dict(cv, vo=vo, v=v)

    def decode_step(self, cv, r, c):
        """The logit (n,) of position (r, c): the row update on entering a
        new row, then the per-pixel h chain; the canvases are written in
        place."""
        return self.step(cv, r, c)[0]

    def step(self, cv, r, c):
        """(The logit (n,) of position (r, c), the canvases written as
        PixelCNNNet.step writes them.) The row update is utils/loop.py
        when: an if when eager, torch.cond under export."""
        k = self.kernel_size
        p = k // 2
        n_vo = len(cv['vo'])

        def row_update(*bufs):
            out = self._row_update(dict(cv, vo=list(bufs[:n_vo]), v=list(bufs[n_vo:])), r)
            return (*out['vo'], *out['v'])

        bufs = when((c == 0) & (r > 0), row_update, (*cv['vo'], *cv['v']))
        cv = dict(cv, vo=list(bufs[:n_vo]), v=list(bufs[n_vo:]))
        pos = (slice(None), r + p, c + p)
        h = self.conv_in.window(cv['c0'].narrow(1, r, k).narrow(2, c, k))  # strictly-before pixels
        cv['s0'] = write(cv['s0'], pos, h)
        hs = list(cv['h'])
        for i, (gated, lns) in enumerate(zip(self.gated, self.stack_lns)):
            if i:
                hs[i - 1] = write(hs[i - 1], pos, h)
            canvas = cv['s0'] if i == 0 else hs[i - 1]
            hw = canvas.narrow(1, r + p, 1).narrow(2, c, p + 1)  # the row's window up to the centre
            raw = gated.h_step(F.relu(hw), cv['vo'][i].select(1, r + p - 1).select(1, c + p))
            h = layer_norm(lns.ln_h, gated.h_out(F.relu(h), raw))
        cv['h'] = hs
        cv['hfin'] = write(cv['hfin'], pos, h)
        return self.conv_out.window(cv['hfin'].narrow(1, r, k).narrow(2, c, k))[:, 0], cv

    def write_input(self, cv, r, c, pixel):
        """cv with pixel (n,) at (r, c) of the input canvas."""
        p = self.kernel_size // 2
        return dict(cv, c0=write(cv['c0'], (slice(None), r + p, c + p, 0), pixel))

    @staticmethod
    def input_canvas(cv):
        return cv['c0']


@register
class GatedPixelCNN(PixelCNN):
    params_from_jax = staticmethod(convert.gated_pixel_cnn_params_from_jax)  # a JAX model.pt
    DG = AttrDict()
    DG.n_filters = 96
    DG.n_layers = 5
    DG.kernel_size = 7
    DG.use_resblock = 0
    DG.lr = 1e-4
    DG.bf16 = 0  # bf16 stacks in training and scoring (params and loss f32)

    def build(self):
        G = self.G
        dtype = torch.bfloat16 if int(G.get('bf16', 0)) else None
        return GatedPixelCNNNet(int(G.n_filters), int(G.n_layers), int(G.kernel_size), dtype)
