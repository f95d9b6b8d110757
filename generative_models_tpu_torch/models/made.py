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
Quantized serving (serve.py --quantize) passes forward a QuantTable
(ops/int8.py) whose layers fold each mask into an int8 weight: every layer
is then int8_matmul (Kernel I or J) + b, with no masked-dense kernel at any
width, as the JAX package's interceptor replaces MaskedMLP.__call__.
The plain matmuls stay torch.matmul under the operand policy (bf16
operands, f32 sums on the card), as the JAX package left them to XLA.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from generative_models_tpu_torch import convert
from generative_models_tpu_torch.models.base import Autoreg, _lecun_normal_
from generative_models_tpu_torch.ops.common import matmul_dtype
from generative_models_tpu_torch.ops.int8 import int8_matmul
from generative_models_tpu_torch.ops.masked_dense import masked_dense, prefer_kernel
from generative_models_tpu_torch.parallel import mesh as pmesh
from generative_models_tpu_torch.utils import dists, register
from generative_models_tpu_torch.utils.config import AttrDict
from generative_models_tpu_torch.utils.graphs import stage
from generative_models_tpu_torch.utils.loop import fori_loop, take, write

SAMPLE_UNROLL = 8  # sampling steps (full forwards) a CUDA graph of the graphed pass


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

    def forward(self, x, quant=None):
        """quant: a QuantTable keyed from this net, whose masked[''] holds
        each layer's folded (q, scale)."""
        if quant is not None:
            return self._quant_forward(x, quant)
        dt = matmul_dtype(x.device)
        for i, (w, b, m) in enumerate(self.layers()):
            if self.premasked:
                x = x.to(dt).float() @ w.to(dt).float() + b
            else:
                x = masked_dense(x, w, b, m, self.use_kernel)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x

    def _quant_forward(self, x, quant):
        layers = quant.masked['']
        for i, ((q, scale), (_, b, _)) in enumerate(zip(layers, self.layers())):
            x = int8_matmul(x, q, scale, act_quant=quant.act_quant) + b
            if i < len(layers) - 1:
                x = F.relu(x)
        return x


@register
class MADE(Autoreg):
    params_from_jax = staticmethod(convert.made_params_from_jax)  # a JAX model.pt
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
    @staticmethod
    def _masked_(t, m):
        """t *= m in place, t a weight, its gradient or moment (under
        --fsdp=1 a DTensor shard, m then laid out as it)."""
        if hasattr(t, 'to_local'):
            m = pmesh.layout_like(m, t).to_local()
        pmesh.local(t).mul_(m)

    def transform_grads(self):
        if not self.net.premasked:
            return
        for w, _, m in self.net.layers():
            if w.grad is not None:
                self._masked_(w.grad, m)

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
            self._masked_(w, m)
            for key in ('exp_avg', 'exp_avg_sq'):
                if key in self.opt.state.get(w, {}):
                    self._masked_(self.opt.state[w][key], m)
            if self._acc is not None:
                self._masked_(self._acc[next(j for j, p in enumerate(params) if p is w)], m)

    def loss(self, x, y=None):
        x = x.reshape(-1, self.nin)
        logits = self.net(x)
        loss = -dists.Bernoulli(logits=logits).log_prob(x).mean()
        return loss, {'nlogp': loss}

    def uniform_shape(self, n):
        return (self.nin, n)

    def sample_fn(self, n, generator=None, uniforms=None, with_frames=True, quant=None):
        """Raster-order sampling: nin steps, one body of utils/loop.py
        fori_loop each of one full forward each, pixel i
        set to u_i < sigmoid(logit_i). uniforms (nin, n), the draws of step
        i in row i, replace the generator's; quant: a QuantTable over
        self.net. Returns the samples (n, H, W, 1) and, with with_frames,
        the (nin, n, H, W, 1) canvas after each step. Graphed
        (pass_graphs): SAMPLE_UNROLL steps a CUDA graph, i a device
        counter."""
        side = math.isqrt(self.nin)
        if uniforms is None:
            uniforms = torch.rand((self.nin, n), generator=generator, device=self.device)
        graphs = self.pass_graphs(('made', n), refs=(quant,))
        if graphs is not None:
            (uniforms,) = graphs.start(uniforms)

        def step(i, samples):
            logits = self.net(samples, quant=quant)
            pixel = dists.Bernoulli(logits=take(logits, i, 1)).sample(uniforms=take(uniforms, i))
            return write(samples, (slice(None), i), pixel)

        samples = stage(graphs, 'first', lambda: torch.zeros((n, self.nin), device=self.device))
        graphed = () if graphs is None else (SAMPLE_UNROLL, graphs, graphs.t)
        samples = fori_loop(0, self.nin, step, samples, *graphed)
        if graphs is not None:
            samples = samples.clone()  # not the pass's fixed tensor
        out = samples.reshape(n, side, side, 1)
        if not with_frames:
            return out
        # frame i is the final canvas with the pixels after i still 0: each
        # pixel is written once, at its own step
        tri = torch.ones((self.nin, self.nin), device=self.device).tril()
        frames = tri[:, None, :] * samples[None]
        return out, frames.reshape(self.nin, n, side, side, 1)
