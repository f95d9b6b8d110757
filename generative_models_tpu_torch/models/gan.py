"""DCGAN-style GAN. Counterpart of generative_models_tpu/models/gan.py: a
deconv generator with BatchNorm and a tanh output, a conv discriminator
with BatchNorm and leaky ReLUs giving logits, and twin Adam optimizers
(lr=5e-5, betas (0.5, 0.999); --disc_lr for the discriminator's) taking,
in one train step, a BCE step of the discriminator (real -> 1 -
label_smooth, fake -> 0) and then a non-saturating step of the generator
against the updated discriminator.

No kernel of ops/ lies on this path: stock convs and deconvs in f32.

BatchNorm is written out (BatchNorm below) so that the step moves the
running statistics exactly as the JAX package threads its batch_stats by
hand: flax's momentum 0.9 (ra = 0.9 ra + 0.1 batch), the biased batch
variance max(0, E[x^2] - E[x]^2), and a train-mode pass updates them only
when asked. In a step the generator's statistics move once, from the pass
that makes the fake batch (the JAX step discards that pass's update and
takes the same batch statistics again in its generator-loss pass: the same
weights and noise); the discriminator's move twice, real then fake; the
discriminator pass inside the generator loss updates nothing.

--spectral_norm=1 wraps each discriminator conv in flax's SpectralNorm,
written out (SpectralNorm below; torch.nn.utils.spectral_norm differs in
its eval mode, init and eps): one power-iteration step on every call, from
the stored u, whose result u and sigma are stored only by a pass that
updates its statistics. A step's real and fake passes store theirs; the
pass inside the generator loss iterates once more from the fake pass's u,
against the updated weights, and stores nothing, as the JAX step discards
that pass's batch_stats.

Random draws: a step's noise (train_step(x, noise=...)) and a sample's
(sample_fn(n, noise=...)) can be passed in; otherwise they come from the
model's generator. The evaluate grid's fixed_noise is drawn from
torch.Generator().manual_seed(seed + 7), where the JAX package draws from
jax.random.key(seed + 7): the same seed gives other fixed noise.
"""

import torch
import torch.nn.functional as F
from torch import nn

from generative_models_tpu_torch import convert
from generative_models_tpu_torch.models.base import GM, deterministic_convs, global_metrics
from generative_models_tpu_torch.parallel.mesh import DATA_AXIS, batch_sum, get_mesh
from generative_models_tpu_torch.utils import dists, register, write_grid
from generative_models_tpu_torch.utils.config import AttrDict


def _dcgan_init_(module, generator, scale=0.02):
    """The reference's weights_init: kernels N(0, scale), biases 0."""
    module.weight.normal_(0.0, scale, generator=generator)
    nn.init.zeros_(module.bias)


class DCGANConv(nn.Conv2d):
    def flax_init(self, generator):
        _dcgan_init_(self, generator)


class DCGANDeconv(nn.ConvTranspose2d):
    def flax_init(self, generator):
        _dcgan_init_(self, generator)


class BatchNorm(nn.Module):
    """flax BatchNorm(momentum=0.9, epsilon=1e-5) over the channels of an
    NCHW map: in train mode the batch's mean and biased variance (flax's
    fast variance), folded into the running mean and var when update_stats;
    in eval mode the running ones. y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias. The scale starts at N(1, 0.02), the reference's
    init. Under a data axis the batch is the global one (batch_sum)."""

    def __init__(self, channels, momentum=0.9, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('mean', torch.zeros(channels))
        self.register_buffer('var', torch.ones(channels))

    def flax_init(self, generator):
        self.weight.copy_(1.0 + 0.02 * torch.randn(self.weight.shape, generator=generator))
        nn.init.zeros_(self.bias)

    def forward(self, x, train, update_stats=False):
        if train:
            mean, mean2 = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
            if get_mesh().dm is not None:
                # the global batch's statistics, as GSPMD computes flax's
                # under a data axis: the mean of the ranks' equal-sized means
                d = get_mesh().size(DATA_AXIS)
                mean, mean2 = batch_sum(torch.stack([mean, mean2])).div(d).unbind(0)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if update_stats:
                m = self.momentum
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def _l2_normalize(x, eps):
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNorm(nn.Module):
    """flax SpectralNorm(n_steps=1, epsilon=1e-12) of one conv's kernel.
    The kernel is read as flax's (kh * kw * in, out) matrix W; u (1, out)
    starts as a unit normal draw and sigma at 1. Each call: v = l2n(u W^T),
    u' = l2n(v W), both without gradient, sigma = v W u'^T (with its
    gradient), and the kernel divided by sigma (by 1 where sigma is 0);
    u' and sigma are stored when update_stats."""

    def __init__(self, out_channels, eps=1e-12):
        super().__init__()
        self.eps = eps
        self.register_buffer('u', torch.zeros(1, out_channels))
        self.register_buffer('sigma', torch.ones(()))

    def flax_init(self, generator):
        self.u.copy_(torch.randn(self.u.shape, generator=generator))

    def forward(self, weight, update_stats):
        """weight (out, in, kh, kw) -> weight / sigma."""
        w = weight.permute(2, 3, 1, 0).reshape(-1, weight.shape[0])
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.t(), self.eps)
            u = _l2_normalize(v @ w, self.eps)
        sigma = (v @ w @ u.t())[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class Generator(nn.Module):
    """noise (B, noise_size) -> NHWC (B, 28, 28, 1) in [-1, 1]: 1 -> 5 ->
    12 -> 26 VALID deconvs, each with BatchNorm and a ReLU, then a 3x3
    deconv to 28 and a tanh."""

    def __init__(self, noise_size, hidden):
        super().__init__()
        H = hidden
        self.deconvs = nn.ModuleList([
            DCGANDeconv(noise_size, H, 5), DCGANDeconv(H, H, 4, stride=2),
            DCGANDeconv(H, H, 4, stride=2), DCGANDeconv(H, 1, 3),
        ])
        self.bns = nn.ModuleList([BatchNorm(H) for _ in range(3)])

    def forward(self, z, train=True, update_stats=False):
        x = z[:, :, None, None]
        for deconv, bn in zip(self.deconvs, self.bns):
            x = F.relu(bn(deconv(x), train, update_stats))
        return torch.tanh(self.deconvs[-1](x)).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """NHWC (B, 28, 28, 1) -> (B,) logits: 28 -> 13 -> 6 -> 4 -> 1 VALID 3x3
    convs (strides 2, 2, 1, 2), leaky ReLUs (slope 0.01) between, BatchNorm
    after the second and third; spectral: each conv's kernel through its
    SpectralNorm (sns)."""

    def __init__(self, hidden, spectral=False):
        super().__init__()
        H = hidden
        self.convs = nn.ModuleList([
            DCGANConv(1, H, 3, stride=2), DCGANConv(H, H, 3, stride=2),
            DCGANConv(H, H, 3, stride=1), DCGANConv(H, 1, 3, stride=2),
        ])
        self.bns = nn.ModuleList([BatchNorm(H) for _ in range(2)])
        # registered last, so that the other modules draw their init as
        # without spectral norm
        self.sns = nn.ModuleList(
            [SpectralNorm(c.out_channels) for c in self.convs]) if spectral else None

    def _conv(self, i, x, update_stats):
        conv = self.convs[i]
        if self.sns is None:
            return conv(x)
        return F.conv2d(x, self.sns[i](conv.weight, update_stats), conv.bias, conv.stride)

    def forward(self, x, train=True, update_stats=False):
        x = F.leaky_relu(self._conv(0, x.permute(0, 3, 1, 2), update_stats), 0.01)
        for i, bn in enumerate(self.bns, 1):
            x = F.leaky_relu(bn(self._conv(i, x, update_stats), train, update_stats), 0.01)
        x = self._conv(3, x, update_stats)
        return x.reshape(x.shape[0])


class _NoGrad:
    """requires_grad off on module's parameters inside the block."""

    def __init__(self, module):
        self.params = list(module.parameters())

    def __enter__(self):
        for p in self.params:
            p.requires_grad_(False)

    def __exit__(self, *exc):
        for p in self.params:
            p.requires_grad_(True)


def bce_with_logits(logits, target):
    """BCELoss(sigmoid(logits), target), in log space."""
    return torch.mean(-(target * F.logsigmoid(logits) + (1 - target) * F.logsigmoid(-logits)))


@register
class GAN(GM):
    DG = AttrDict()
    DG.noise_size = 128
    DG.lr = 5e-5
    DG.binarize = 0  # trains on [-1, 1] data
    DG.disc_lr = 0.0  # the discriminator's lr (0 = --lr)
    DG.spectral_norm = 0  # 1: flax SpectralNorm around every discriminator conv
    DG.label_smooth = 0.0  # one-sided: the discriminator's real target is 1 - label_smooth
    SAMPLE_RANGE = (-1.0, 1.0)  # the generator ends in tanh

    def __init__(self, G):
        super().__init__(G)
        betas = (0.5, 0.999)
        lr = float(G.lr)
        self.opt = self.adam(self.net.gen.parameters(), lr, betas)
        self.disc_opt = self.adam(self.net.disc.parameters(),
                                  float(G.get('disc_lr', 0.0)) or lr, betas)
        gen = torch.Generator().manual_seed(int(G.get('seed', 0)) + 7)
        self.fixed_noise = torch.randn((25, int(G.noise_size)), generator=gen).to(self.device)

    def build(self):
        H = int(self.G.hidden_size)
        return nn.ModuleDict(dict(gen=Generator(int(self.G.noise_size), H),
                                  disc=Discriminator(H, bool(int(self.G.spectral_norm)))))

    def optimizers(self):
        return {'opt': self.opt, 'disc_opt': self.disc_opt}

    def fsdp_modules(self):
        return [self.net.gen, self.net.disc]

    def net_state_from_jax(self, tree):
        return convert.gan_params_from_jax(tree['params'], tree['extra'])

    def jax_optimizers(self, opt_state):
        return [(self.opt, opt_state['gen'], lambda t: convert.gan_params_from_jax({'gen': t})),
                (self.disc_opt, opt_state['disc'],
                 lambda t: convert.gan_params_from_jax({'disc': t}))]

    def accum(self):
        return 1  # the twin step takes no trainer knob, as the JAX package's

    def _schedule(self):
        pass  # both Adams at their fixed lr

    def device_step(self, x, y=None, noise=None):
        """The twin step's device work: the discriminator's update, then
        the generator's against it; the BatchNorms' statistics and
        --spectral_norm's power iterations move in place. noise (B,
        noise_size; train_step's keyword) replaces the generator's draw.
        Returns the four losses (device scalars)."""
        x = self._as_input(x)
        if noise is None:
            noise = dists.batch_draw(torch.randn, (x.shape[0], int(self.G.noise_size)),
                                     self._gen, self.device)
        gen, disc = self.net.gen, self.net.disc
        fake = gen(torch.as_tensor(noise).to(self.device, x.dtype), True, True)

        real_target = 1.0 - float(self.G.get('label_smooth', 0.0))
        loss_real = bce_with_logits(disc(x, True, True), real_target)
        loss_fake = bce_with_logits(disc(fake.detach(), True, True), 0.0)
        d_loss = loss_real + loss_fake
        self._grads(d_loss, disc)  # fake is detached: the generator gets none
        self.disc_opt.step()

        # against the updated discriminator, whose statistics stay; its
        # weights out of the graph: the generator's gradients alone
        with _NoGrad(disc):
            g_loss = bce_with_logits(disc(fake, True, False), 1.0)
            self._grads(g_loss, gen)
        self.opt.step()
        return global_metrics({'disc/loss': d_loss.detach(), 'disc/loss_fake': loss_fake.detach(),
                               'disc/loss_real': loss_real.detach(),
                               'gen/loss': g_loss.detach()})

    def _grads(self, loss, net):
        """net's gradients of loss in p.grad, averaged over the data axis
        (FSDP2 reduces its roots' in their backward)."""
        net.zero_grad(set_to_none=True)
        loss.backward()
        self.sync_grads(net.parameters())

    SERVE_DETERMINISTIC_CONVS = True

    def draw_spec(self, n):
        return [('noise', (n, int(self.G.noise_size)), 'normal')]

    def sample_from_draws(self, n, draws, y=None, quant=None):
        return self.sample_fn(n, noise=draws[0])

    def serving_modules(self):
        return [self.net.gen]

    def sample_fn(self, n, generator=None, noise=None, quant=None):
        """n samples (n, 28, 28, 1) in [-1, 1]: the generator in eval mode
        (running statistics) on N(0, 1) noise (or noise given), its deconvs
        on cuDNN's deterministic algorithms; one CUDA graph a batch size
        (graphed_pass)."""
        if noise is None:
            noise = torch.randn((n, int(self.G.noise_size)), generator=generator,
                                device=self.device)

        def generate(noise):
            with deterministic_convs():
                return self.net.gen(noise, False)

        return self.graphed_pass(('gan', n), generate,
                                 torch.as_tensor(noise, dtype=torch.float32).to(self.device))

    @torch.no_grad()
    def evaluate(self, writer, x, y, epoch):
        """25 samples and the 25 of fixed_noise, each a grid in [0, 1]."""
        write_grid(writer, 'samples', (self.sample(25) + 1.0) / 2.0, epoch)
        write_grid(writer, 'fixed_noise', (self.net.gen(self.fixed_noise, False) + 1.0) / 2.0,
                   epoch)
