"""VQ-VAE with a jointly trained transformer prior. Counterpart of
generative_models_tpu/models/vqvae.py: a conv encoder to a 7x7 grid of
vqD-wide latents, the nearest-code search (Kernel F, ops/quantize.py) with
straight-through gradients, a deconv decoder, and a 49-token categorical
TransformerNet prior trained in the same step, with its own Adam, on the
detached codes.

On the card the search is Kernel F, the prior's full forward and backward
Kernels C, E and D, and prior sampling the decode chain of Kernels A and B.
The convs and deconvs are stock PyTorch ops in f32 with TF32 off (as the
JAX package left them to XLA), so the encoder's output, and the codes, stay
close to an f32 CPU forward.

Layouts: the model's public tensors are NHWC, as the JAX package's. The
convs run NCHW inside the encoder and decoder, and the latent is permuted
back to NHWC before it is flattened, so the code rows, idxs and the
prior's 49-token raster order are the JAX package's (b, h, w) order.
"""

import torch
import torch.nn.functional as F
from torch import nn

from generative_models_tpu_torch import convert
from generative_models_tpu_torch.models.base import GM
from generative_models_tpu_torch.models.pixel_transformer import (
    DecodeGraphs, TransformerNet, transformer_rules, transformer_sample_scan,
)
from generative_models_tpu_torch.parallel.mesh import MODEL_AXIS, get_mesh
from generative_models_tpu_torch.ops.quantize import vq_quantize
from generative_models_tpu_torch.utils import (
    dists, grid_image, register, write_grid, write_image,
)
from generative_models_tpu_torch.utils.config import AttrDict

SAMPLE_UNROLL = 7  # the prior's decode steps a CUDA graph of the graphed pass


def same_pad(size, k, s):
    """flax padding='SAME' of one axis as (before, after): an odd total goes
    after, so a stride-2 3x3 conv on an even size pads 0 before and 1
    after (nn.Conv2d(padding=1) would pad 1 and 1)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class VQEncoder(nn.Module):
    """28 -> 14 -> 7 -> 7 -> 7 SAME 3x3 convs, each followed by a ReLU."""

    def __init__(self, hidden, vqD):
        super().__init__()
        H = hidden
        self.convs = nn.ModuleList([
            nn.Conv2d(1, H, 3, stride=2), nn.Conv2d(H, H, 3, stride=2),
            nn.Conv2d(H, H, 3, stride=1), nn.Conv2d(H, vqD, 3, stride=1),
        ])

    def forward(self, x):
        """(B, 1, H, W) -> (B, vqD, h, w)."""
        for conv in self.convs:
            (k, _), (s, _) = conv.kernel_size, conv.stride
            top, bottom = same_pad(x.shape[2], k, s)
            left, right = same_pad(x.shape[3], k, s)
            x = F.relu(conv(F.pad(x, (left, right, top, bottom))))
        return x


class VQDecoder(nn.Module):
    """7 -> 24 -> 26 -> 28 VALID deconvs with ReLUs, then a 1x1 to one
    channel of logits. The weights are flax's unflipped ConvTranspose
    kernels flipped in both spatial axes (convert.vqvae_params_from_jax)."""

    def __init__(self, hidden, vqD):
        super().__init__()
        H = hidden
        self.deconvs = nn.ModuleList([
            nn.ConvTranspose2d(vqD, H, 6, stride=3), nn.ConvTranspose2d(H, H, 3),
            nn.ConvTranspose2d(H, H, 3), nn.ConvTranspose2d(H, 1, 1),
        ])

    def forward(self, z):
        """(B, vqD, h, w) -> (B, 1, H, W) logits."""
        for deconv in self.deconvs[:-1]:
            z = F.relu(deconv(z))
        return self.deconvs[-1](z)


class VQAENet(nn.Module):
    """Encoder + codebook (vqK, vqD) + decoder: the AE optimizer's params."""

    def __init__(self, hidden, vqD, vqK, beta):
        super().__init__()
        self.beta = beta
        self.encoder = VQEncoder(hidden, vqD)
        self.decoder = VQDecoder(hidden, vqD)
        self.codebook = nn.Parameter(torch.empty(vqK, vqD))

    def flax_init(self, generator):
        """The codebook's uniform(-1/K, 1/K); the convs take flax_init_'s."""
        K = self.codebook.shape[0]
        self.codebook.uniform_(-1.0 / K, 1.0 / K, generator=generator)

    def _decode(self, z_q):
        """NHWC latent -> NHWC logits."""
        return self.decoder(z_q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x):
        """x (B, H, W, 1) -> (embed_loss, decoded logits (B, H, W, 1),
        perplexity, idxs (B, h, w), one-hot codes (B*h*w, K))."""
        z_e = self.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        embed_loss, z_q, perplexity, idxs, one_hot = vq_quantize(z_e, self.codebook, self.beta)
        return embed_loss, self._decode(z_q), perplexity, idxs, one_hot

    def decode_codes(self, one_hots):
        """(B, T=h*w, K) one-hot codes -> decoded logits (B, H, W, 1)."""
        B, T, _ = one_hots.shape
        hw = round(T ** 0.5)
        return self._decode((one_hots @ self.codebook).reshape(B, hw, hw, -1))


@register
class VQVAE(GM):
    DG = AttrDict()
    DG.vqD = 64
    DG.vqK = 64
    DG.beta = 0.25
    DG.n_layer = 2
    DG.n_head = 8
    DG.n_embed = 256
    DG.prior_lr = 1e-3
    DG.fused_decode = 1  # prior sampling through Kernels A and B

    def __init__(self, G):
        self.grid_hw = 8 if G.get('pad32', 0) else 7
        self.n_codes = self.grid_hw * self.grid_hw
        super().__init__(G)
        # the reference's Adam(prior_lr, betas=(0.5, 0.999)): no trainer
        # knobs, and a step on every micro-step, as the JAX package wraps
        # only the AE's optimizer in MultiSteps
        self.prior_opt = self.adam(self.net.prior.parameters(), float(G.prior_lr), (0.5, 0.999))

    def build(self):
        G = self.G
        # the prior takes pixel_transformer's TP rules; above model:1 its
        # decode is the module-by-module step, without Kernels A and B
        tp = get_mesh().size(MODEL_AXIS)
        if int(G.n_head) % tp:
            raise ValueError(f'--n_head={G.n_head} does not split over model:{tp}')
        return nn.ModuleDict(dict(
            ae=VQAENet(int(G.hidden_size), int(G.vqD), int(G.vqK), float(G.beta)),
            prior=TransformerNet(
                in_size=int(G.vqK), block_size=self.n_codes, n_embed=int(G.n_embed),
                n_head=int(G.n_head), n_layer=int(G.n_layer), head='cat',
                use_fused_decode=bool(G.get('fused_decode', 1)) and tp == 1,
                module_step=tp > 1,
            ),
        ))

    def param_sharding_rules(self):
        return transformer_rules()

    def fsdp_modules(self):
        return [self.net.ae, self.net.prior]

    def trained_params(self):
        return self.net.ae.parameters()

    def optimizers(self):
        return {'opt': self.opt, 'prior_opt': self.prior_opt}

    params_from_jax = staticmethod(convert.vqvae_params_from_jax)  # a JAX model.pt

    def jax_optimizers(self, opt_state):
        return [(self.opt, opt_state['ae'], convert.vqvae_ae_params_from_jax),
                (self.prior_opt, opt_state['prior'], convert.vqvae_prior_params_from_jax)]

    def _losses(self, x):
        """(AE loss, prior loss on the detached codes, metrics)."""
        embed_loss, decoded, perplexity, _, one_hot = self.net.ae(x)
        recon_loss = -dists.Bernoulli(logits=decoded).log_prob(x).mean()
        codes = one_hot.detach().reshape(x.shape[0], self.n_codes, -1)
        prior_loss = -self.net.prior(codes).log_prob(codes).mean()
        loss = recon_loss + embed_loss
        return loss, prior_loss, {
            'vq_vae_loss': loss, 'recon_loss': recon_loss, 'embed_loss': embed_loss,
            'perplexity': perplexity, 'prior_loss': prior_loss,
        }

    def loss(self, x, y=None):
        loss, _, metrics = self._losses(x)
        return loss, metrics

    def train_loss(self, x, y=None):
        """The joint step's objective: the AE and the prior share no
        parameter and the codes are detached, so one backward of the sum
        leaves each half exactly its own loss's gradients."""
        loss, prior_loss, metrics = self._losses(x)
        return loss + prior_loss, metrics

    def update(self):
        """The AE's step (Adam with the trainer knobs), then the prior's,
        both from the pre-update weights' gradients, as the JAX joint
        step."""
        super().update()
        self.prior_opt.step()

    def draw_spec(self, n):
        return [('uniforms', (self.n_codes, n, int(self.G.vqK)), 'uniform')]

    def sample_from_draws(self, n, draws, y=None, quant=None):
        return self.sample_fn(n, uniforms=draws[0], quant=quant)

    def sample_fn(self, n, generator=None, uniforms=None, quant=None):
        """n samples (n, H, W, 1) in {0, 1}: a Gumbel-max categorical code
        at each of the prior's T decode steps, from uniforms (T, n, K) or
        the generator's draws, then decode_codes and sigmoid > 0.5. quant: a
        QuantTable over self.net; the prior's decode steps take its entries
        under 'prior', keyed from the prior's own root, so every quantized
        Linear of the prior applies (the JAX package's table keeps the
        'prior' prefix that the prior's modules do not see, and so
        quantizes none of them; ROADMAP.md queue 3). Graphed
        (graphed_sampling): the prior's decode through a DecodeGraphs of
        its own (SAMPLE_UNROLL steps a CUDA graph), then decode_codes as
        one more graph."""
        T, K = self.n_codes, int(self.G.vqK)
        if uniforms is None:
            uniforms = torch.rand((T, n, K), generator=generator, device=self.device)
        sample_token = lambda logits, u: dists.Categorical(logits).sample(uniforms=u)
        prior_quant = quant.sub('prior') if quant is not None else None
        decode = lambda tokens: (torch.sigmoid(
            self.net.ae.decode_codes(tokens.permute(1, 0, 2))) > 0.5).float()
        bufs = self.pass_graphs(('prior', n), refs=(quant,), make=lambda refs: DecodeGraphs(
            self.net.prior, n, prior_quant, SAMPLE_UNROLL, refs))
        if bufs is None:
            return decode(transformer_sample_scan(self.net.prior, n, sample_token, uniforms,
                                                  quant=prior_quant))
        transformer_sample_scan(self.net.prior, n, sample_token, uniforms, quant=bufs.quant,
                                bufs=bufs)
        return bufs('decode', lambda: decode(bufs.tokens)).clone()

    @torch.no_grad()
    def evaluate(self, writer, x, y, epoch):
        """8 test images over their reconstructions, and 25 samples."""
        self.net.eval()
        x8 = self._as_input(x[:8])
        recon = (torch.sigmoid(self.net.ae(x8)[1]) > 0.5).float()
        write_image(writer, 'reconstruction', grid_image(torch.cat([x8, recon]), 2, 8), epoch)
        write_grid(writer, 'samples', self.sample(25), epoch)
