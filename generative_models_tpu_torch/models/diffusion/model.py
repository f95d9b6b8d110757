"""The diffusion model. Counterpart of
generative_models_tpu/models/diffusion/model.py: SimpleUnet +
GaussianDiffusion, classifier-free label dropout in training, --ema (a
moving average of the parameters that sampling reads), a progressive-
distillation teacher (the student starts from the frozen teacher's
weights; a student reloaded by --weights_from builds no teacher and drops
its cond_w_embed, as the JAX package's strict=False restore does),
guided sampling and serving with labels, and a seeded evaluate
that writes the 25-sample grid and the z / x_hat / eps_hat chain GIFs.

No kernel of ops/ lies on this path: the UNet's convs, GroupNorm and
Linears are stock PyTorch ops (the JAX package leaves them to XLA), in bf16
under --bf16=1 as flax's dtype computes them (unet.py). Serving under
--quantize runs the UNet's large Linears through Kernels I and J, from a
table over the net that sampling reads (quant_net).

Random draws: training takes, in order, the label-drop uniforms, eps, u
(or i) and w from the model's generator unless train_step is handed them
(draws=dict(drop=, eps=, u=, w=)); the eval loss draws from a generator
seeded afresh each call, as the JAX package folds one fixed tag into its
key; serving from torch.Generator(device).manual_seed(seed), the noise
first, then w, then the noisy sampler's step normals (draw_spec).
"""

import copy
from pathlib import Path

import torch

from generative_models_tpu_torch import convert
from generative_models_tpu_torch.models.base import GM, JaxTrainState, read_checkpoint
from generative_models_tpu_torch.models.diffusion.gaussian_diffusion import GaussianDiffusion
from generative_models_tpu_torch.models.diffusion.unet import SimpleUnet
from generative_models_tpu_torch.parallel.mesh import MODEL_AXIS, get_mesh, local
from generative_models_tpu_torch.utils import register, write_grid, write_gridvid
from generative_models_tpu_torch.utils.dists import batch_draw
from generative_models_tpu_torch.utils.config import AttrDict

EVAL_SEED_TAG = 0x7FFFFFFF  # the eval loss's generator seed, beside G.seed


@register
class DiffusionModel(GM):
    params_from_jax = staticmethod(convert.diffusion_params_from_jax)  # a JAX model.pt
    DG = AttrDict()
    SAMPLE_RANGE = (-1.0, 1.0)  # sampling clips x_hat to [-1, 1]
    DG.binarize = 0
    DG.timesteps = 250
    DG.hidden_size = 128
    DG.dropout = 0.0
    DG.sampler = 'ddim'  # ddim | noisy (ancestral) | dpm2m (DPM-Solver++(2M)) | teacher_test
    DG.sample_steps = 0  # the chain's length; 0 = --timesteps
    DG.mean_type = 'v'
    DG.eval_heavy = 1
    DG.class_cond = 1
    DG.sample_cond_w = -1.0
    DG.cf_drop_prob = 0.1
    DG.teacher_path = Path('.')
    DG.teacher_mode = 'step1'
    DG.lr_scheduler = 'none'
    DG.bf16 = 1  # bf16 compute, f32 parameters
    DG.ema = 0.0  # > 0: sample from a moving average of the parameters
    DG.fused_cfg = 0  # guided sampling: 1 = one doubled-batch call a step, 0 = two
    DG.eval_sampler = ''  # sample_images' sampler ('' = --sampler)
    DG.eval_sample_steps = 0  # sample_images' chain length (0 = --sample_steps)

    def __init__(self, G):
        self.size = 32 if G.get('pad32', 0) else 28
        self.has_teacher = Path(G.teacher_path) != Path('.') and G.weights_from == Path('.')
        kw = dict(mean_type=G.mean_type, num_steps=int(G.timesteps),
                  has_teacher=self.has_teacher, teacher_mode=G.teacher_mode,
                  sample_cond_w=float(G.sample_cond_w), fused_cfg=bool(G.get('fused_cfg', 0)))
        self.diffusion = GaussianDiffusion(
            sampler=G.sampler, sample_steps=int(G.get('sample_steps', 0)), **kw)
        ev_sampler = G.get('eval_sampler', '') or G.sampler
        ev_steps = int(G.get('eval_sample_steps', 0)) or int(G.get('sample_steps', 0))
        self._eval_diffusion = None
        if (ev_sampler, ev_steps) != (G.sampler, int(G.get('sample_steps', 0))):
            self._eval_diffusion = GaussianDiffusion(sampler=ev_sampler, sample_steps=ev_steps, **kw)
        self.ema_decay = float(G.get('ema', 0))
        self.ema_net = self.teacher_net = None
        super().__init__(G)

    def post_build(self):
        """The EMA copy and the teacher, made from the net laid out over the
        model axis and before FSDP (which shards the EMA beside the net)."""
        self.net.drop_gen = lambda: self._gen  # dropout's masks: the training draws
        if self.ema_decay:
            self.ema_net = self._frozen_copy()
        if self.has_teacher:
            self._load_teacher(self.G.teacher_path)

    def fsdp_modules(self):
        return [self.net] + ([self.ema_net] if self.ema_net is not None else [])

    def param_sharding_rules(self):
        """TP over the ResBlocks' channels (the JAX package's rules, torch
        names): conv0 and the emb Dense column-parallel, norm1 on its
        channel shard, conv1 row-parallel."""
        return [
            (r'blocks\.\d+\.conv0\.weight$', (MODEL_AXIS, None, None, None)),
            (r'blocks\.\d+\.conv0\.bias$', (MODEL_AXIS,)),
            (r'blocks\.\d+\.dense\.weight$', (MODEL_AXIS, None)),
            (r'blocks\.\d+\.dense\.bias$', (MODEL_AXIS,)),
            (r'blocks\.\d+\.norm1\.(weight|bias)$', (MODEL_AXIS,)),
            (r'blocks\.\d+\.conv1\.weight$', (None, MODEL_AXIS, None, None)),
        ]

    def build(self):
        G = self.G
        # the model axis splits the ResBlocks' channels and norm1's groups:
        # a width whose groups do not split evenly is refused
        tp, C = get_mesh().size(MODEL_AXIS), int(G.hidden_size)
        if C % tp or min(32, C) % tp:
            raise ValueError(f'--hidden_size={C}: its {min(32, C)} GroupNorm groups do not '
                             f'split over model:{tp}')
        return SimpleUnet(
            channels=int(G.hidden_size), dropout=float(G.dropout),
            out_channels=2 if G.mean_type == 'both' else 1,
            dtype=torch.bfloat16 if int(G.get('bf16', 1)) else torch.float32,
            remat=bool(G.get('remat', 0)), cond_w=self.has_teacher,
        )

    def _frozen_copy(self):
        net = copy.deepcopy(self.net).eval()
        net.requires_grad_(False)
        return net

    def _load_teacher(self, path):
        """The student starts from the teacher's weights, merged strict=False
        over its own init (a step1 student's cond_w_embed, which the teacher
        lacks, keeps its init); a frozen copy is the teacher, and the EMA
        restarts from it. path: a port model.pt, or its directory."""
        print('Loading teacher model')
        path = Path(path)
        if path.is_dir():
            path = path / 'model.pt'
        state = read_checkpoint(path)
        if isinstance(state, JaxTrainState):
            teacher = convert.diffusion_params_from_jax(state['params'])
        else:
            teacher = state.get('net', state)
        merged = self.net_state()
        for k, v in teacher.items():
            if k in merged and merged[k].shape == v.shape:
                merged[k] = v
        self.load_net_state(self.net, merged)
        self.teacher_net = self._frozen_copy()
        if self.ema_net is not None:
            self.load_net_state(self.ema_net, merged)

    def extra_state(self):
        extra = {}
        if self.ema_net is not None:
            extra['ema'] = self.net_state(self.ema_net)
        if self.teacher_net is not None:
            extra['teacher'] = self.net_state(self.teacher_net)
        return extra

    def load_extra_state(self, extra):
        if self.ema_net is not None:
            # a checkpoint without an EMA starts it from the restored weights
            self.load_net_state(self.ema_net, extra.get('ema') or self.net_state())
        if self.teacher_net is not None and 'teacher' in extra:
            self.load_net_state(self.teacher_net, extra['teacher'])

    def fit_checkpoint(self, state):
        """A distilled student's model.pt read into a net without
        cond_w_embed (its reload by --weights_from, which builds no
        teacher): as the JAX package's strict=False restore (merge_pytree)
        keeps only the entries its model has, the student's cond_w_embed is
        not read, from the net, Adam's moments, the --grad_accum window or
        the EMA, and the student samples as a guided model."""
        names = list(state['net'])
        keep = [j for j, k in enumerate(names) if not k.startswith('cond_w_embed.')]
        if len(keep) == len(names) or self.net.cond_w_embed is not None:
            return state
        # the UNet holds no buffers: its state dict's order is its
        # parameters', by which Adam's saved state is indexed
        saved = {int(j): st for j, st in state['opt']['state'].items()}
        fitted = dict(state, net={names[j]: state['net'][names[j]] for j in keep},
                      opt=dict(state['opt'], state={i: saved[j] for i, j in enumerate(keep)
                                                    if j in saved}))
        if state['acc'] is not None:
            fitted['acc'] = [state['acc'][j] for j in keep]
        ema = state.get('extra', {}).get('ema')
        if ema:
            fitted['extra'] = dict(state['extra'], ema={
                k: v for k, v in ema.items() if not k.startswith('cond_w_embed.')})
        return fitted

    def load_jax_extra(self, extra):
        """The JAX TrainState's extra['ema'] and extra['teacher'] (params
        trees) into the EMA copy and the teacher."""
        self.load_extra_state({k: convert.diffusion_params_from_jax(v) for k, v in extra.items()
                               if k in ('ema', 'teacher')})

    # ---------------------------------------------------------------- #
    def _make_net(self, net, guide, quant=None):
        """The closure net(z, logsnr, cond_w=None, uncond=False,
        uncond_second_half=False) of the diffusion core, over the UNet net
        with labels guide (-1: unconditional); quant: a QuantTable over
        net."""

        def fn(z, logsnr, cond_w=None, uncond=False, uncond_second_half=False):
            B, dev = z.shape[0], z.device
            logsnr = torch.as_tensor(logsnr, dtype=torch.float32, device=dev).expand(B)
            if uncond_second_half:
                # fused CF guidance: rows [B/2:] are the unconditional branch
                g = torch.cat([guide, -torch.ones_like(guide)])
                if cond_w is not None:
                    cw = torch.as_tensor(cond_w, dtype=torch.float32, device=dev)
                    cond_w = torch.cat([cw, cw]) if cw.dim() else cw
            else:
                g = -torch.ones_like(guide) if uncond else guide
            if cond_w is not None:
                cond_w = torch.as_tensor(cond_w, dtype=torch.float32, device=dev).expand(B)
            return net(z, logsnr, guide=g, cond_w=cond_w, quant=quant)

        return fn

    def _labels(self, y, n):
        if y is None:
            return -torch.ones((n,), dtype=torch.int32, device=self.device)
        return torch.as_tensor(y, dtype=torch.int32).to(self.device)

    def _losses(self, x, y, generator, draws, train):
        draws = draws or {}
        y = self._labels(y, x.shape[0])
        drop = draws.get('drop')
        if drop is None:
            drop = batch_draw(torch.rand, y.shape, generator, self.device)
        if train:  # classifier-free label dropout
            y = torch.where(drop < float(self.G.cf_drop_prob), -1, y)
        teacher = None if self.teacher_net is None else self._make_net(self.teacher_net, y)
        losses = self.diffusion.training_losses(
            net=self._make_net(self.net, y), x=x, generator=generator, teacher_net=teacher,
            **{k: draws.get(k) for k in ('eps', 'u', 'w')},
        )
        loss = losses['loss'].mean()
        return loss, {'loss': loss}

    def loss(self, x, y=None, draws=None):
        """The eval loss: no label drop, draws from a fixed seed."""
        seed = int(self.G.get('seed', 0)) + EVAL_SEED_TAG
        gen = torch.Generator(self.device).manual_seed(seed)
        return self._losses(x, y, gen, draws, train=False)

    def train_loss(self, x, y=None, draws=None):
        return self._losses(x, y, self._gen, draws, train=True)

    def device_step(self, x, y=None, draws=None):
        """A step's device work, then the EMA update; draws (dict of drop,
        eps, u, w; train_step's keyword) replace the generator's."""
        metrics = super().device_step(x, y, draws=draws)
        if self.ema_net is not None:
            # ema = d * ema + (1 - d) * params, after every step
            d = self.ema_decay
            ema = [local(p) for p in self.ema_net.parameters()]
            with torch.no_grad():
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [local(p) for p in self.net.parameters()], alpha=1 - d)
        return metrics

    # ---------------------------------------------------------------- #
    def _sample_net(self):
        """Sampling reads the EMA copy when --ema is on."""
        return (self.ema_net if self.ema_net is not None else self.net).eval()

    def quant_net(self):
        """The net whose Linears serve.py --quantize quantizes: the one
        sampling reads (the EMA copy under --ema). The JAX package
        quantizes TrainState.params even then, and its sampler reads the
        EMA (ROADMAP.md queue 3)."""
        return self._sample_net()

    @torch.no_grad()
    def sample_chain(self, noise, y, generator=None, cond_w=None, return_history=True,
                     w=None, step_noise=None, diffusion=None, quant=None):
        """The chain from noise (n, H, W, 1) under labels y (n,): see
        GaussianDiffusion.sample. quant: a QuantTable over the sampling
        net (quant_net)."""
        teacher = None
        if self.teacher_net is not None:
            teacher = self._make_net(self.teacher_net.eval(), y)
        return (diffusion or self.diffusion).sample(
            net=self._make_net(self._sample_net(), y, quant), init_x=noise, generator=generator,
            cond_w=cond_w, teacher_net=teacher, return_history=return_history, w=w,
            step_noise=step_noise,
        )

    def sample_fn(self, n, y=None, generator=None, noise=None, w=None, step_noise=None,
                  diffusion=None, quant=None):
        """n samples (n, H, W, 1) in [-1, 1] under labels y (None: -1,
        unconditional): noise from generator (unless given), then the
        guided chain. cond_w=0.5 is only the flag that turns guidance on:
        each sample's weight is 4 w, w uniform (the JAX package's quirk).
        quant: a QuantTable over quant_net()."""
        if noise is None:
            noise = torch.randn((n, self.size, self.size, 1), generator=generator,
                                device=self.device)
        return self.sample_chain(noise, self._labels(y, n), generator, cond_w=0.5,
                                 return_history=False, w=w, step_noise=step_noise,
                                 diffusion=diffusion, quant=quant)

    @torch.no_grad()
    def sample(self, n, y=None):
        return self.sample_fn(n, y, generator=self._sample_gen)

    @torch.no_grad()
    def sample_images(self, n, y=None):
        """n samples under labels y, through the --eval_sampler /
        --eval_sample_steps chain where those are set."""
        return self.sample_fn(n, y, generator=self._sample_gen, diffusion=self._eval_diffusion)

    def draw_spec(self, n):
        """The noise, then w, then (the noisy sampler) the (S, n, H, W, 1)
        normals of its steps, drawn up front."""
        img = (n, self.size, self.size, 1)
        spec = [('noise', img, 'normal'), ('w', (n,), 'uniform')]
        if self.diffusion.sampler == 'noisy':
            spec.append(('step_noise', (self.diffusion.sample_steps, *img), 'normal'))
        return spec

    def sample_from_draws(self, n, draws, y=None, quant=None):
        noise, w, *step_noise = draws
        return self.sample_fn(n, y, noise=noise, w=w, step_noise=(step_noise or [None])[0],
                              quant=quant)

    def serving_modules(self):
        return [self._sample_net()] + ([self.teacher_net] if self.teacher_net is not None else [])

    @torch.no_grad()
    def evaluate(self, writer, x, y, epoch):
        """Seeded 25-sample grid and the z / x_hat / eps_hat chain GIFs,
        unguided (no cond_w, as the JAX package), labels 0-9 in turn."""

        def proc(v):
            v = torch.clamp((v + 1) * 127.5, 0, 255).to(torch.uint8)
            if self.G.get('pad32', 0):
                v = v[..., 2:-2, 2:-2, :]
            return v.cpu().numpy()

        gen = torch.Generator(self.device).manual_seed(0)
        noise = torch.randn((25, self.size, self.size, 1), generator=gen, device=self.device)
        labels = torch.arange(25, dtype=torch.int32, device=self.device) % 10
        zs, xs, eps = map(proc, self.sample_chain(noise, labels, gen))
        write_grid(writer, 'samples', zs[-1], epoch)
        ld = self.G.logdir
        write_gridvid(writer, 'sampling_process', zs, epoch, logdir=ld)
        write_gridvid(writer, 'diffusion_model/eps', eps, epoch, logdir=ld)
        write_gridvid(writer, 'diffusion_model/x', xs, epoch, logdir=ld)
