"""GM base class. Counterpart of generative_models_tpu/models/base.py
(GM/Autoreg, :113-457).

Every model owns a torch module (self.net) on self.device, initialised from
G.seed with flax's initializer families, and the host API of the JAX
package: loss / eval_loss / eval_epoch, train_step / train_epoch with the
trainer knobs, sample / sample_images / evaluate, the serving fn, and
save / load_weights.

The optimizer is torch.optim.Adam on G.lr (optax.adam's b1, b2, eps and
bias correction), wrapped as make_optimizer wraps optax.adam:
  * --grad_clip: optax.clip_by_global_norm, g * max_norm / |g| only when
    |g| >= max_norm (not clip_grad_norm_'s max_norm / (|g| + 1e-6));
  * --grad_accum=k: optax.MultiSteps, a running mean over k micro-steps;
    clip and Adam act on the mean every k-th step;
  * --lr_scheduler=cosine / --warmup_steps / --lr_decay_steps: the optax
    schedules, evaluated at the count of optimizer updates made so far.
self.step counts train_step calls (micro-steps), as TrainState.step does.

A model may own a second optimizer beside self.opt (the VQ-VAE prior's
Adam): optimizers() names every one whose state a checkpoint keeps, and
trained_params() the parameters self.opt steps.

Checkpoints are the port's own: model.pt holds the full train state (net,
every optimizer's state, step counters) as a torch pickle of tensors,
beside an hps.yaml that both packages read; load_weights also reads a
params-only state dict. A JAX checkpoint's params are carried over with
convert.params_from_jax, convert.vqvae_params_from_jax or
convert.made_params_from_jax.
"""

import math
from pathlib import Path

import torch
from torch import nn

from generative_models_tpu_torch.ops.common import resolve_device
from generative_models_tpu_torch.utils.config import AttrDict, dump_hps
from generative_models_tpu_torch.utils.logger import write_grid, write_gridvid

# std of a unit normal truncated to [-2, 2]: flax's variance_scaling divides
# by it so the truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def flax_init_(module, generator):
    """flax's default initializers: lecun-normal (truncated normal, fan_in)
    Linear, Conv and ConvTranspose weights, zero biases, LayerNorm scale 1
    and bias 0. A module with a flax_init(generator) method draws its own
    parameters (the VQ codebook); those of other modules (pos_emb) keep
    their constructor values."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, 'flax_init'):
                m.flax_init(generator)
                continue
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # flax's fan_in of a (kh, kw, in, out) kernel, whichever way
                # round torch stores it (ConvTranspose2d's dim 1 is out)
                kh, kw = m.kernel_size
                _lecun_normal_(m.weight, kh * kw * m.in_channels, generator)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
            else:
                continue
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class GM:
    """GenerativeModel base."""

    DG = AttrDict()  # model-specific config defaults

    def __init__(self, G):
        self.G = G
        self.device = resolve_device(G.get('device', ''))
        seed = int(G.get('seed', 0))
        self.net = self.build()
        # init on the CPU from one generator: the same seed gives the same
        # weights whatever the device
        flax_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(self.device).eval()
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self.opt = torch.optim.Adam(
            self.trained_params(), lr=self.lr_at(0), betas=(0.9, 0.999), eps=1e-8
        )
        self.step = 0  # train_step calls, micro-steps included
        self.updates = 0  # optimizer updates: the schedule's count
        self.mini_step = 0  # position inside the --grad_accum window
        self._acc = None  # the window's running mean of the gradients

    def build(self):
        """Return the torch module."""
        raise NotImplementedError

    def trained_params(self):
        """The parameters self.opt (Adam with the trainer knobs) steps."""
        return self.net.parameters()

    def optimizers(self):
        """{name: optimizer} of every optimizer whose state save() keeps."""
        return {'opt': self.opt}

    def loss(self, x, y=None):
        """(batch) -> (loss, metrics dict)."""
        raise NotImplementedError

    def train_loss(self, x, y=None):
        """(batch) -> (the objective a train step differentiates, metrics)."""
        return self.loss(x, y)

    def evaluate(self, writer, x, y, epoch):
        raise NotImplementedError(
            'you need to implement the evaluate method. make some samples or something.'
        )

    def has_loss(self):
        """Whether the harness runs the test-set loss sweep."""
        return type(self).loss is not GM.loss

    @property
    def params(self):
        return list(self.net.parameters())

    def _as_input(self, x):
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    # ------------------------------------------------------------------ #
    # optimizer
    # ------------------------------------------------------------------ #
    def lr_at(self, count):
        """The learning rate of optimizer update number count (0-based):
        G.lr, or optax.linear_schedule(0, lr, warmup) with --warmup_steps,
        or optax.warmup_cosine_decay_schedule(0, lr, warmup, warmup + decay,
        0) with --lr_scheduler=cosine. Warmup starts at lr 0, as optax's."""
        G = self.G
        base = float(G.lr)
        sched = str(G.get('lr_scheduler', 'none') or 'none')
        warm = int(G.get('warmup_steps', 0) or 0)
        if sched not in ('none', 'cosine'):
            raise ValueError(f'unknown --lr_scheduler={sched}')
        if sched == 'cosine':
            decay = int(G.get('lr_decay_steps', 0) or 0)
            if decay <= 0:
                raise ValueError('--lr_scheduler=cosine needs --lr_decay_steps')
            if count < warm:
                return base * count / warm
            c = min(count - warm, decay)
            return base * 0.5 * (1.0 + math.cos(math.pi * c / decay))
        if warm == 0:
            return base
        return base * min(count, warm) / warm

    def _clip_(self, grads):
        """optax.clip_by_global_norm in place, on the device (no sync)."""
        clip = float(self.G.get('grad_clip', 0) or 0)
        if clip <= 0:
            return
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        torch._foreach_mul_(grads, scale)

    def transform_grads(self):
        """Hook between the backward and the optimizer, acting on p.grad in
        place (default: nothing). MADE masks its weight gradients here on
        its premasked route."""

    def apply_grads(self):
        """One optimizer micro-step on the gradients in p.grad: transform
        them (transform_grads), fold them into the --grad_accum window's
        running mean and, at the window's last micro-step (every step
        without accumulation), clip the mean and take one Adam step at the
        scheduled lr."""
        self.transform_grads()
        params = [p for group in self.opt.param_groups for p in group['params']]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        k = int(self.G.get('grad_accum', 1) or 1)
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in params]
            # optax.MultiSteps' running mean: acc += (g - acc) / (n + 1)
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < k:
                return
            self.mini_step = 0
            grads = self._acc
        self._clip_(grads)
        for p, g in zip(params, grads):
            p.grad = g
        for group in self.opt.param_groups:
            group['lr'] = self.lr_at(self.updates)
        self.opt.step()
        self.updates += 1
        if k > 1:
            for a in self._acc:
                a.zero_()

    # ------------------------------------------------------------------ #
    # steps and epochs
    # ------------------------------------------------------------------ #
    def backward(self, x, y=None):
        """Forward and backward of one batch in train mode: leaves the
        batch's gradients in p.grad and returns its metrics (device
        scalars, not synced)."""
        self.net.train()
        self.net.zero_grad(set_to_none=True)
        loss, metrics = self.train_loss(self._as_input(x), y)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self, x, y=None):
        metrics = self.backward(x, y)
        self.apply_grads()
        self.step += 1
        return metrics

    def train_epoch(self, bx, by=None):
        """(steps, bs, ...) batches -> the mean of each metric over the
        steps, as floats (one sync at the end)."""
        ms = [self.train_step(bx[i], None if by is None else by[i]) for i in range(len(bx))]
        return {k: float(torch.stack([m[k] for m in ms]).mean()) for k in ms[0]}

    @torch.no_grad()
    def eval_loss(self, x, y=None):
        """Scoring: the full forward's metrics on one batch, as floats."""
        self.net.eval()
        _, metrics = self.loss(self._as_input(x), y)
        return {k: float(v) for k, v in metrics.items()}

    @torch.no_grad()
    def eval_epoch(self, bx, by=None):
        """(steps, bs, ...) batches -> the mean of each metric, as floats."""
        self.net.eval()
        ms = [self.loss(self._as_input(bx[i]), None if by is None else by[i])[1]
              for i in range(len(bx))]
        return {k: float(torch.stack([m[k] for m in ms]).mean()) for k in ms[0]}

    # ------------------------------------------------------------------ #
    # checkpoints: the full train state, as the JAX package's
    # ------------------------------------------------------------------ #
    def save(self, path, tag=''):
        """model[_tag].pt (net, every optimizer's state, step counters) +
        hps.yaml into directory path."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        suffix = f'_{tag}' if tag else ''
        state = dict(
            net=self.net.state_dict(), step=self.step, updates=self.updates,
            mini_step=self.mini_step, acc=self._acc,
            **{name: o.state_dict() for name, o in self.optimizers().items()},
        )
        torch.save(state, path / f'model{suffix}.pt')
        dump_hps(self.G, path)

    def load_weights(self, path):
        """Restore a model.pt written by save (the full train state), or a
        params-only torch state dict."""
        path = Path(path)
        with open(path, 'rb') as f:
            if f.read(2) != b'PK':  # torch.save writes a zip archive
                raise NotImplementedError(
                    f'{path} is not a torch checkpoint (a JAX msgpack checkpoint?); '
                    'reading JAX checkpoints is not ported yet: carry params '
                    'over with generative_models_tpu_torch.convert.params_from_jax'
                )
        state = torch.load(path, map_location=self.device, weights_only=True)
        if 'net' not in state:  # params only
            self.net.load_state_dict(state)
            return
        self.net.load_state_dict(state['net'])
        for name, o in self.optimizers().items():
            o.load_state_dict(state[name])
        self.step, self.updates = int(state['step']), int(state['updates'])
        self.mini_step, self._acc = int(state['mini_step']), state['acc']


    # ------------------------------------------------------------------ #
    # sampling and serving
    # ------------------------------------------------------------------ #
    def sample_fn(self, n, generator=None, uniforms=None):
        """n samples from the generator's draws, or from the random numbers
        given (uniforms), so a test can hand both packages the same draws."""
        raise NotImplementedError

    def _draw(self, n, generator):
        """n samples (n, H, W, 1) in [0, 1] and nothing else."""
        return self.sample_fn(n, generator=generator)

    @torch.no_grad()
    def sample(self, n):
        """sample_fn's output from the model's own generator stream."""
        self.net.eval()
        return self.sample_fn(n, generator=self._gen)

    @torch.no_grad()
    def sample_images(self, n, y=None):
        if y is not None:
            raise TypeError(f'{type(self).__name__}.sample takes no labels')
        self.net.eval()
        return self._draw(n, self._gen)

    def pure_serving_fn(self, n):
        """(seed) -> (n, H, W, 1) float32 numpy samples in [0, 1]. The seed
        becomes torch.Generator(device).manual_seed(seed), so the same seed
        gives the same batch."""

        @torch.no_grad()
        def fn(seed):
            gen = torch.Generator(self.device).manual_seed(int(seed))
            self.net.eval()
            return self._draw(n, gen).cpu().numpy()

        return fn


class Autoreg(GM):
    """Autoregressive models: sample_fn(n, generator, uniforms, with_frames)
    returns samples in [0, 1], plus the sampling-process frames when
    asked."""

    is_autoreg = True  # enables eval/bits_per_dim logging in the harness

    def evaluate(self, writer, x, y, epoch):
        """25 samples -> 5x5 grid + the sampling-process GIF."""
        samples, frames = self.sample(25)
        write_grid(writer, 'samples', samples, epoch)
        write_gridvid(writer, 'sampling_process', frames, epoch, logdir=self.G.logdir)

    def _draw(self, n, generator):
        return self.sample_fn(n, generator=generator, with_frames=False)
