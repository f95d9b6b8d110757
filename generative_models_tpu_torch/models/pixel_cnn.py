"""PixelCNN: masked 2-D convs ('A' mask on the input layer, 'B' after it),
LayerNorm over the channels, ReLUs, two 1x1 'B' convs on top, Bernoulli
over the pixels. Counterpart of generative_models_tpu/models/pixel_cnn.py.

Layouts: the public tensors are NHWC, as the JAX package's, and LayerNorm
acts on their last axis; each conv views its input as NCHW (a permute, no
copy) and its weight is a torch OIHW Conv2d weight (convert.py carries
flax's HWIO kernels over). The masks are constant buffers multiplied into
the weight at apply time. The mask zeroes every kernel row below the
centre, so the full forward crops the kernel to rows [:p+1] (p = k // 2)
and pads the input by p above and p on each side (F.pad, then F.conv2d),
bit-identical to the masked conv on p fewer rows, as the JAX package does.
No kernel of ops/ lies on this path: the convs are stock PyTorch ops in f32
(TF32 off on the card, ops/common.resolve_device), as the JAX package leaves
them to XLA.

--bf16 runs the stacks in bf16 for training and scoring (convs and
LayerNorms in bf16, LayerNorm's statistics in f32, the last 1x1 conv and the
loss in f32). Sampling always runs the net in f32 on the same weights, as
the JAX package's _decode_net.

Sampling decodes incrementally (a wavefront, as the JAX package's lax.scan):
each step computes the one position (r, c) of every layer from k x k windows
of canvases padded by k // 2, which hold each spatial conv's input and are
filled in raster order; a position's window holds only positions before it,
so what it reads is final. The window route is the product of the window's
(h, w, c) values with the masked kernel in the same order ('nhwc,hwcf->nf').
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from generative_models_tpu_torch import convert
from generative_models_tpu_torch.models.base import RasterAutoreg
from generative_models_tpu_torch.utils import dists, register
from generative_models_tpu_torch.utils.config import AttrDict
from generative_models_tpu_torch.utils.graphs import stage
from generative_models_tpu_torch.utils.loop import fori_loop, write

LN_EPS = 1e-6  # flax LayerNorm's epsilon


def pixelcnn_mask(k, mask_type):
    """(k, k) raster-causal mask: rows above the centre 1, the centre row 1
    left of the centre, and the centre itself for type B only."""
    m = np.zeros((k, k), np.float32)
    m[: k // 2, :] = 1.0
    m[k // 2, : k // 2] = 1.0
    if mask_type == 'B':
        m[k // 2, k // 2] = 1.0
    return m


def nhwc_conv(x, w, pad):
    """NHWC x through F.conv2d with OIHW w after F.pad(pad) (pad in F.pad's
    order: left, right, top, bottom; negative pads crop)."""
    return F.conv2d(F.pad(x.permute(0, 3, 1, 2), pad), w).permute(0, 2, 3, 1)


def window_product(x, w):
    """One output position: x (n, kh, kw, C) window, w (F, C, kh, kw) ->
    (n, F), the sum over (h, w, c) in that order."""
    return x.reshape(x.shape[0], -1) @ w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])


def f32_or_wider(x):
    """x in f32, or in its own dtype where that is wider (a float64 copy of
    the net, which checks hold the card's f32 gradients against)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def layer_norm(ln, x, dtype=None):
    """flax's LayerNorm (dtype=dtype): statistics and normalisation in f32
    (f32_or_wider), the output in dtype (that dtype when None)."""
    y = F.layer_norm(f32_or_wider(x), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y if dtype is None else y.to(dtype)


class MaskConv2d(nn.Conv2d):
    """A masked conv, 'A' or 'B'. dtype: the compute dtype of the full
    forward (bf16 stacks under --bf16), None for f32; an f32 conv fed bf16
    computes in f32. The window route (decode) is f32 throughout."""

    def __init__(self, mask_type, in_c, features, kernel_size, use_bias=True, dtype=None):
        super().__init__(in_c, features, kernel_size, bias=use_bias)
        self.k, self.dtype = kernel_size, dtype
        self.register_buffer('mask', torch.from_numpy(pixelcnn_mask(kernel_size, mask_type)),
                             persistent=False)

    def forward(self, x):
        """Full NHWC image (B, H, W, C) -> (B, H, W, features), SAME size."""
        w, b = self.weight * self.mask, self.bias
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        else:
            x = x.to(w.dtype)
        p = self.k // 2
        y = nhwc_conv(x, w[:, :, : p + 1], (p, p, p, 0))
        return y if b is None else y + b

    def window(self, x):
        """x (n, k, k, C): the patch centred on one output position ->
        (n, features), in f32."""
        y = window_product(x.float(), self.weight * self.mask)
        return y if self.bias is None else y + self.bias

    def point(self, x):
        """A 1x1 conv at one position: x (n, C) -> (n, features), f32."""
        return self.window(x[:, None, None, :])


class PixelResBlock(nn.Module):
    """relu, 1x1 'B' conv to C/2, relu, 7x7 'B' conv, relu, 1x1 'B' conv
    back to C, plus the input."""

    def __init__(self, channels, dtype=None):
        super().__init__()
        h = channels // 2
        self.conv_a = MaskConv2d('B', channels, h, 1, dtype=dtype)
        self.conv_mid = MaskConv2d('B', h, h, 7, dtype=dtype)
        self.conv_b = MaskConv2d('B', h, channels, 1, dtype=dtype)

    def forward(self, x):
        h = self.conv_a(F.relu(x))
        h = self.conv_mid(F.relu(h))
        return x + self.conv_b(F.relu(h))

    def step_pre(self, x):
        """(n, C) -> the (n, C/2) vector the 7x7 conv's canvas holds."""
        return F.relu(self.conv_a.point(x))

    def step_post(self, x, w):
        """x (n, C) the block's input, w (n, 7, 7, C/2) the mid conv's
        window -> (n, C)."""
        return x + self.conv_b.point(F.relu(self.conv_mid.window(w)))


class PixelCNNNet(nn.Module):
    def __init__(self, n_filters, n_layers, kernel_size, use_resblock, dtype=None):
        super().__init__()
        Fn, self.n_layers, self.kernel_size = n_filters, n_layers, kernel_size
        self.n_filters, self.use_resblock, self.dtype = n_filters, use_resblock, dtype
        self.conv_in = MaskConv2d('A', 1, Fn, kernel_size, dtype=dtype)
        self.lns = nn.ModuleList(nn.LayerNorm(Fn, eps=LN_EPS) for _ in range(n_layers))
        self.blocks = nn.ModuleList(
            PixelResBlock(Fn, dtype) if use_resblock
            else MaskConv2d('B', Fn, Fn, kernel_size, dtype=dtype)
            for _ in range(n_layers))
        self.conv_out1 = MaskConv2d('B', Fn, Fn, 1, dtype=dtype)
        self.conv_out2 = MaskConv2d('B', Fn, 1, 1)  # f32

    def forward(self, x):
        """(B, H, W, 1) -> logits (B, H, W, 1)."""
        x = self.conv_in(x)
        for ln, block in zip(self.lns, self.blocks):
            x = block(F.relu(layer_norm(ln, x, self.dtype)))
        x = self.conv_out1(F.relu(x))
        return self.conv_out2(F.relu(x))

    # ---------------------- incremental wavefront decode ---------------------- #
    # One canvas per spatial (k > 1) conv, holding that conv's input plane,
    # zero-padded by k // 2 on each spatial edge; 1x1 convs and LayerNorm
    # act on one position and need none. The decode is f32.

    def _mid_kernel_size(self):
        # the resblocks' spatial conv is their 7x7 conv_mid, whatever
        # kernel_size says: the layer canvases are padded for it
        return 7 if self.use_resblock else self.kernel_size

    def init_canvases(self, n, side):
        """(c0: the input pixels, padded by kernel_size // 2; one canvas a
        layer of the spatial conv's input)."""
        dev = self.conv_in.weight.device
        p, pm = self.kernel_size // 2, self._mid_kernel_size() // 2
        mid_c = self.n_filters // 2 if self.use_resblock else self.n_filters
        c0 = torch.zeros((n, side + 2 * p, side + 2 * p, 1), device=dev)
        layers = [torch.zeros((n, side + 2 * pm, side + 2 * pm, mid_c), device=dev)
                  for _ in range(self.n_layers)]
        return c0, layers

    def decode_step(self, canvases, r, c):
        """The logit (n,) of position (r, c), writing this position's
        activations into the canvases (in place)."""
        return self.step(canvases, r, c)[0]

    def step(self, canvases, r, c):
        """(The logit (n,) of position (r, c), the canvases with this
        position's activations written: in place when eager, as new
        tensors under torch.export, utils/loop.py write.) Windows are
        narrowed views, as r and c are symbolic under export."""
        k, km = self.kernel_size, self._mid_kernel_size()
        pm = km // 2
        c0, layers = canvases
        # the window centred on (r + p, c + p) in padded coordinates starts at (r, c)
        x = self.conv_in.window(c0.narrow(1, r, k).narrow(2, c, k))
        written = []
        for ln, block, canvas in zip(self.lns, self.blocks, layers):
            x = F.relu(layer_norm(ln, x))
            v = block.step_pre(x) if self.use_resblock else x
            canvas = write(canvas, (slice(None), r + pm, c + pm), v)
            w = canvas.narrow(1, r, km).narrow(2, c, km)
            x = block.step_post(x, w) if self.use_resblock else block.window(w)
            written.append(canvas)
        x = self.conv_out1.point(F.relu(x))
        return self.conv_out2.point(F.relu(x))[:, 0], (c0, written)

    def write_input(self, canvases, r, c, pixel):
        """The canvases with pixel (n,) at (r, c) of the input canvas."""
        p = self.kernel_size // 2
        c0, layers = canvases
        return write(c0, (slice(None), r + p, c + p, 0), pixel), layers

    @staticmethod
    def input_canvas(canvases):
        return canvases[0]


@register
class PixelCNN(RasterAutoreg):
    params_from_jax = staticmethod(convert.pixel_cnn_params_from_jax)  # a JAX model.pt
    DG = AttrDict()
    DG.n_filters = 128
    DG.n_layers = 5
    DG.kernel_size = 7
    DG.use_resblock = 0
    DG.lr = 1e-4
    DG.bf16 = 0  # bf16 stacks in training and scoring (params and loss f32)

    def build(self):
        G = self.G
        return PixelCNNNet(int(G.n_filters), int(G.n_layers), int(G.kernel_size),
                           bool(int(G.use_resblock)),
                           dtype=torch.bfloat16 if int(G.get('bf16', 0)) else None)

    def logits(self, x):
        """The full forward's logits (B, H, W, 1), in f32 whatever the
        net's compute dtype (f32_or_wider)."""
        return f32_or_wider(self.net(x))

    def loss(self, x, y=None):
        logits = self.logits(x)  # an f32 loss
        loss = -dists.Bernoulli(logits=logits).log_prob(x).mean()
        return loss, {'nlogp': loss}

    def decode_chain(self, n, next_pixel, state=(), quant=None, graphs=None):
        """The wavefront decode, one net.step a step: pixel t is written
        into the input canvas. quant is unused: no layer is an nn.Linear,
        so --quantize has nothing to quantize and exits. Its callers turn
        autograd off: a no_grad region here would put grad-mode nodes
        around the gated row update's torch.cond in an exported program,
        which torch.export's pass over them refuses. Graphed: a row of steps
        a graph, r and c host ints baked in (the windows are views, and the
        gated row update a Python if, as eager)."""
        net, side = self.net, self.side

        def step(t, carry):
            canvases, state = carry
            r, c = t // side, t % side
            logit, canvases = net.step(canvases, r, c)
            pix, state = next_pixel(t, logit, state)
            return net.write_input(canvases, r, c, pix), state

        canvases = stage(graphs, 'first', lambda: net.init_canvases(n, side))
        graphed = () if graphs is None else (side, graphs)
        return fori_loop(0, self.canvas_size, step, (canvases, state), *graphed)[1]
