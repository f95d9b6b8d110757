"""Continuous-time logSNR Gaussian diffusion. Counterpart of
generative_models_tpu/models/diffusion/gaussian_diffusion.py: q(z_t|x) and
q(z_s|z_t,x) in logSNR form, x <-> eps <-> v conversions with
clip-then-recompute, the 'snr_trunc' max(x_mse, eps_mse) loss (the 'snr'
eps loss for a step1 student), epsilon-space classifier-free guidance as
two net calls or one doubled batch, DDIM, the ancestral ('noisy') sampler,
DPM-Solver++(2M), and the 1- and 2-step progressive-distillation teacher
targets.

The sampling chain is utils/loop.py fori_loop over its steps (a Python
loop, or one while_loop in an exported program; the JAX package's
lax.scan), the first and last steps' branches through pick; with
return_history=False it keeps only the current state, and given a
PassGraphs (utils/graphs.py) runs as CUDA graphs on the card: its tables
and first carry one graph, then each step a graph replayed S times with
the step k a device counter (take reads the tables' row k, pick is
torch.where), bitwise the Python loop.
Every random draw comes from an explicit torch.Generator or is passed in,
so a test can hand the JAX package's draws to the port: the training eps,
u (or i for step2) and w, the per-sample guidance weights w and the noisy
sampler's per-step normals. Uniform draws are passed as drawn, in [0, 1):
w becomes the weight 4 * w here, as in the JAX package.
"""

import math
from functools import partial

import torch
import torch.nn.functional as F

from generative_models_tpu_torch.models.diffusion.schedules import get_logsnr_schedule
from generative_models_tpu_torch.utils.dists import batch_draw
from generative_models_tpu_torch.utils.graphs import stage
from generative_models_tpu_torch.utils.loop import fori_loop, pick, take

SAMPLE_UNROLL = 1  # chain steps a CUDA graph of the graphed chain (~1450 launches a guided step)


def _f32(x, like):
    if isinstance(x, (int, float)):  # a fill, which a CUDA graph captures (no host copy)
        return torch.full((), x, dtype=torch.float32, device=like.device)
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def bc(x, shape, like):
    """broadcast_from_left: x (a scalar or leading dims of shape) as a
    float32 tensor of shape, on like's device."""
    x = _f32(x, like)
    return x.reshape(x.shape + (1,) * (len(shape) - x.dim())).expand(shape)


def mean_flat(x):
    return x.mean(dim=tuple(range(1, x.dim())))


def log1mexp(x, expm1_guard=1e-7):
    """Numerically stable log(1 - exp(x)) for x < 0, with a guarded
    backward near x = 0."""
    small = x < math.log(0.5)
    # branch 1 (x < log 0.5): log1p(-exp(x)); a safe input for the other
    x_small = torch.where(small, x, math.log(0.5) - 1.0)
    y_small = torch.log1p(-torch.exp(x_small))
    # branch 2 (x >= log 0.5): log(-expm1(x)), its gradient's magnitude guarded
    x_big = torch.where(small, math.log(0.5) + 1e-3, x)
    expxm1 = torch.expm1(x_big)
    fw = torch.log(-expxm1)
    bw = torch.log(-expxm1 + expm1_guard)
    y_big = fw.detach() + (bw - bw.detach())
    return torch.where(small, y_small, y_big)


def diffusion_forward(x, logsnr):
    """q(z_t | x)."""
    return {
        'mean': x * torch.sqrt(torch.sigmoid(logsnr)),
        'std': torch.sqrt(torch.sigmoid(-logsnr)),
        'var': torch.sigmoid(-logsnr),
        'logvar': F.logsigmoid(-logsnr),
    }


def diffusion_reverse(x, z_t, logsnr_s, logsnr_t, x_logvar):
    """q(z_s | z_t, x), s < t."""
    alpha_st = torch.sqrt((1.0 + torch.exp(-logsnr_t)) / (1.0 + torch.exp(-logsnr_s)))
    alpha_s = torch.sqrt(torch.sigmoid(logsnr_s))
    r = torch.exp(logsnr_t - logsnr_s)  # SNR(t) / SNR(s)
    one_minus_r = -torch.expm1(logsnr_t - logsnr_s)
    log_one_minus_r = log1mexp(logsnr_t - logsnr_s)
    mean = r * alpha_st * z_t + one_minus_r * alpha_s * x
    if x_logvar == 'small':
        var = one_minus_r * torch.sigmoid(-logsnr_s)
        logvar = log_one_minus_r + F.logsigmoid(-logsnr_s)
    elif x_logvar == 'large':
        var = one_minus_r * torch.sigmoid(-logsnr_t)
        logvar = log_one_minus_r + F.logsigmoid(-logsnr_t)
    elif x_logvar.startswith('medium:'):
        frac = float(x_logvar.split(':')[1])
        assert 0 <= frac <= 1
        min_logvar = log_one_minus_r + F.logsigmoid(-logsnr_s)
        max_logvar = log_one_minus_r + F.logsigmoid(-logsnr_t)
        logvar = frac * max_logvar + (1 - frac) * min_logvar
        var = torch.exp(logvar)
    else:
        raise NotImplementedError(x_logvar)
    return {'mean': mean, 'std': torch.sqrt(var), 'var': var, 'logvar': logvar}


def predict_x_from_eps(z, eps, logsnr):
    logsnr = bc(logsnr, z.shape, z)
    return torch.sqrt(1.0 + torch.exp(-logsnr)) * (z - eps * torch.rsqrt(1.0 + torch.exp(logsnr)))


def predict_eps_from_x(z, x, logsnr):
    logsnr = bc(logsnr, z.shape, z)
    return torch.sqrt(1.0 + torch.exp(logsnr)) * (z - x * torch.rsqrt(1.0 + torch.exp(-logsnr)))


def predict_v_from_x_and_eps(x, eps, logsnr):
    logsnr = bc(logsnr, x.shape, x)
    return torch.sqrt(torch.sigmoid(logsnr)) * eps - torch.sqrt(torch.sigmoid(-logsnr)) * x


def predict_x_from_v(z, v, logsnr):
    logsnr = bc(logsnr, z.shape, z)
    return torch.sqrt(torch.sigmoid(logsnr)) * z - torch.sqrt(torch.sigmoid(-logsnr)) * v


class GaussianDiffusion:
    """Stateless diffusion math over a net(z, logsnr, cond_w=None,
    uncond=False, uncond_second_half=False) closure from the model layer."""

    def __init__(self, *, mean_type, num_steps, has_teacher=False, teacher_mode=None,
                 sampler='ddim', sample_cond_w=None, fused_cfg=False, sample_steps=None):
        self.fused_cfg = fused_cfg
        self.mean_type = mean_type
        self.num_steps = num_steps
        # the chain walks sample_steps points of the same schedule (0 or
        # None: num_steps)
        self.sample_steps = int(sample_steps or num_steps)
        self.has_teacher = has_teacher
        self.logsnr_schedule_fn = get_logsnr_schedule('cosine', logsnr_min=-20.0, logsnr_max=20.0)
        self.sampler = sampler
        self.sample_cond_w = sample_cond_w
        self.loss_weight_type = 'snr_trunc'
        if has_teacher:
            assert teacher_mode in ['step1', 'step2']
            self.teacher_mode = teacher_mode
            if teacher_mode == 'step1':
                self.loss_weight_type = 'snr'

    def _run_model(self, *, net, z, logsnr):
        """The net's output under mean_type -> clipped x_hat, recomputed
        eps and v."""
        model_output = net(z, logsnr)
        if self.mean_type == 'eps':
            model_x = predict_x_from_eps(z=z, eps=model_output, logsnr=logsnr)
        elif self.mean_type == 'x':
            model_x = model_output
        elif self.mean_type == 'v':
            model_x = predict_x_from_v(z=z, v=model_output, logsnr=logsnr)
        elif self.mean_type == 'both':
            _model_x, _model_eps = torch.chunk(model_output, 2, dim=-1)
            model_x_eps = predict_x_from_eps(z=z, eps=_model_eps, logsnr=logsnr)
            wx = bc(torch.sigmoid(-_f32(logsnr, z)), z.shape, z)
            model_x = wx * _model_x + (1.0 - wx) * model_x_eps
        else:
            raise NotImplementedError(self.mean_type)
        model_x = torch.clamp(model_x, -1.0, 1.0)
        model_eps = predict_eps_from_x(z=z, x=model_x, logsnr=logsnr)
        model_v = predict_v_from_x_and_eps(x=model_x, eps=model_eps, logsnr=logsnr)
        return {'model_x': model_x, 'model_eps': model_eps, 'model_v': model_v}

    def training_losses(self, *, net, x, generator=None, eps=None, u=None, w=None,
                        teacher_net=None):
        """{'loss': (B,)}. eps (normal, x's shape), u (uniform (B,), or the
        step index i in [0, num_steps) for step2) and w (uniform (B,), a
        teacher's guidance weight 4 w) are drawn from generator, in that
        order, unless given, at the global batch (dists.batch_draw)."""
        B, dev = x.shape[0], x.device
        if eps is None:
            eps = batch_draw(torch.randn, x.shape, generator, dev)
        bcx = lambda v: bc(v, x.shape, x)
        if self.has_teacher and self.teacher_mode == 'step2':
            steps = partial(torch.randint, 0, self.num_steps)
            i = u if u is not None else batch_draw(steps, (B,), generator, dev)
            u = (i + 1).float() / self.num_steps
        else:
            i = None
            if u is None:
                u = batch_draw(torch.rand, (B,), generator, dev)
        logsnr = self.logsnr_schedule_fn(u)

        z_dist = diffusion_forward(x, bcx(logsnr))
        z_t = z_dist['mean'] + z_dist['std'] * eps

        if self.has_teacher:
            assert teacher_net is not None
            if w is None:
                w = batch_draw(torch.rand, (B,), generator, dev)
            cond_w = 4.0 * w
            net = partial(net, cond_w=cond_w)
            t_net = partial(teacher_net, cond_w=None if self.teacher_mode == 'step1' else cond_w)
            u_s = u - 1.0 / self.num_steps
            logsnr_s = self.logsnr_schedule_fn(u_s)
            with torch.no_grad():
                if self.teacher_mode == 'step1':
                    _, x_target, _ = self.ddim_step(
                        net=t_net, z_t=z_t, logsnr_t=logsnr, logsnr_s=logsnr_s, cond_w=cond_w)
                else:  # step2: two teacher DDIM half-steps + the implied x
                    u_mid = u - 0.5 / self.num_steps
                    logsnr_mid = self.logsnr_schedule_fn(u_mid)
                    z_mid, _, _ = self.ddim_step(
                        net=t_net, z_t=z_t, logsnr_t=logsnr, logsnr_s=logsnr_mid)
                    z_teacher, x_pred_teacher, _ = self.ddim_step(
                        net=t_net, z_t=z_mid, logsnr_t=logsnr_mid, logsnr_s=logsnr_s)
                    alpha_s = bcx(torch.sqrt(torch.sigmoid(logsnr_s)))
                    alpha_t = bcx(torch.sqrt(torch.sigmoid(logsnr)))
                    stdv_frac = bcx(torch.exp(0.5 * (F.softplus(logsnr) - F.softplus(logsnr_s))))
                    x_target = (z_teacher - stdv_frac * z_t) / (alpha_s - stdv_frac * alpha_t)
                    first = (i == 0).reshape((B,) + (1,) * (x.dim() - 1))
                    x_target = torch.where(first, x_pred_teacher, x_target)
                eps_target = predict_eps_from_x(z=z_t, x=x_target, logsnr=logsnr)
        else:
            x_target = x
            eps_target = eps

        model_output = self._run_model(net=net, z=z_t, logsnr=logsnr)
        x_mse = mean_flat(torch.square(model_output['model_x'] - x_target))
        eps_mse = mean_flat(torch.square(model_output['model_eps'] - eps_target))
        if self.loss_weight_type == 'snr_trunc':  # x_mse * max(SNR, 1)
            loss = torch.maximum(x_mse, eps_mse)
        else:  # 'snr'
            loss = eps_mse
        return {'loss': loss}

    def _run_model_guided(self, *, net, z_t, logsnr_t, cond_w):
        """Classifier-free guidance: the conditional and unconditional
        predictions, as one doubled-batch call (fused_cfg) or two, combined
        in epsilon space, then clip-recompute."""
        B = z_t.shape[0]
        ls = _f32(logsnr_t, z_t).expand(B)
        if self.fused_cfg:
            out = self._run_model(net=partial(net, uncond_second_half=True),
                                  z=torch.cat([z_t, z_t]), logsnr=torch.cat([ls, ls]))
            eps_cond, eps_uncond = out['model_eps'][:B], out['model_eps'][B:]
        else:
            eps_cond = self._run_model(net=net, z=z_t, logsnr=ls)['model_eps']
            eps_uncond = self._run_model(net=partial(net, uncond=True), z=z_t,
                                         logsnr=ls)['model_eps']
        cond_w = bc(cond_w, z_t.shape, z_t)
        eps_pred_t = (1 + cond_w) * eps_cond - cond_w * eps_uncond
        x_pred_t = predict_x_from_eps(z=z_t, eps=eps_pred_t, logsnr=ls)
        x_pred_t = torch.clamp(x_pred_t, -1.0, 1.0)
        eps_pred_t = predict_eps_from_x(z=z_t, x=x_pred_t, logsnr=ls)
        return x_pred_t, eps_pred_t

    def _predict(self, *, net, z_t, logsnr_t, cond_w=None):
        """Clipped x_hat and recomputed eps_hat at (z_t, logsnr_t), guided
        when cond_w is set."""
        if cond_w is not None:
            return self._run_model_guided(net=net, z_t=z_t, logsnr_t=logsnr_t, cond_w=cond_w)
        out = self._run_model(net=net, z=z_t, logsnr=logsnr_t)
        return out['model_x'], out['model_eps']

    def ddim_step(self, *, net, logsnr_t, logsnr_s, z_t, cond_w=None):
        x_pred_t, eps_pred_t = self._predict(net=net, z_t=z_t, logsnr_t=logsnr_t, cond_w=cond_w)
        logsnr_s = _f32(logsnr_s, z_t)
        stdv_s = bc(torch.sqrt(torch.sigmoid(-logsnr_s)), z_t.shape, z_t)
        alpha_s = bc(torch.sqrt(torch.sigmoid(logsnr_s)), z_t.shape, z_t)
        return alpha_s * x_pred_t + stdv_s * eps_pred_t, x_pred_t, eps_pred_t

    def reverse_dpm_step(self, *, net, logsnr_t, logsnr_s, z_t, noise, cond_w=None):
        """One ancestral step; noise is the step's standard normal draw."""
        x_pred_t, eps_pred_t = self._predict(net=net, z_t=z_t, logsnr_t=logsnr_t, cond_w=cond_w)
        z_s_dist = diffusion_reverse(
            z_t=z_t, logsnr_t=bc(logsnr_t, z_t.shape, z_t), logsnr_s=bc(logsnr_s, z_t.shape, z_t),
            x=x_pred_t, x_logvar='large',
        )
        return z_s_dist['mean'] + z_s_dist['std'] * noise, x_pred_t, eps_pred_t

    def sample(self, *, net, init_x, generator=None, cond_w=None, teacher_net=None,
               return_history=True, w=None, step_noise=None, graphs=None):
        """The reverse chain over t = S-1..0, S = sample_steps. Returns the
        stacked (z, x_hat, eps_hat) histories, each (S, *init_x.shape), or
        with return_history=False the final batch alone.

        cond_w's value is ignored: it is a flag that turns guidance on, with
        per-sample weights 4 w, w uniform (drawn unless given), unless
        sample_cond_w (not -1) fixes the weight, as in the JAX package.
        step_noise (S, *init_x.shape) replaces the noisy sampler's per-step
        normals, which are otherwise drawn from generator after w.

        graphs: a PassGraphs whose fixed buffers init_x, w, step_noise
        and the net's labels are (the graphed chain; not with
        return_history): the tables, 4 w and the first carry in one graph,
        then SAMPLE_UNROLL steps a graph, k a device counter; the noisy
        sampler's draws from generator then come from inside the graphs,
        which register it (PassGraphs' generators)."""
        dev, shape = init_x.device, init_x.shape
        if graphs is not None and return_history:
            raise ValueError('the graphed chain keeps no history')
        if cond_w is not None and w is None:
            w = torch.rand((shape[0],), generator=generator, device=dev)
        S, guided = self.sample_steps, cond_w is not None

        def first():
            """The logSNR tables, 4 w and the first carry (dpm2m's x_prev and
            h_prev stand in, unread: views, or copies in the graphed form's
            fixed carry)."""
            steps = torch.arange(S - 1, -1, -1, dtype=torch.float32, device=dev)
            ts, ss = self.logsnr_schedule_fn((steps + 1.0) / S), self.logsnr_schedule_fn(steps / S)
            carry = (init_x, init_x, ts[0]) if self.sampler == 'dpm2m' else (init_x,)
            if graphs is not None:
                carry = tuple(x.clone() for x in carry)
            return ts, ss, 4.0 * w if guided else None, carry

        logsnr_ts, logsnr_ss, net_cond_w, carry = stage(graphs, 'first', first)
        if self.has_teacher:
            # a distilled student conditions on w directly, no CF guidance
            net = partial(net, cond_w=net_cond_w)
            cond_w = None
        else:
            cond_w = self.sample_cond_w if self.sample_cond_w != -1.0 else net_cond_w

        stochastic = False
        if self.sampler in ('ddim', 'dpm2m'):
            body_net = net
        elif self.sampler == 'noisy':
            body_net, stochastic = net, True
        elif self.sampler == 'teacher_test':
            assert teacher_net is not None
            body_net = partial(teacher_net, cond_w=None)
            cond_w = net_cond_w
        else:
            raise NotImplementedError(self.sampler)

        hist = ([], [], [])

        def step(k, carry):
            """Step k of the chain (t = S-1-k); carry (z,), or (z, x_prev,
            h_prev) for dpm2m (the first step reads neither)."""
            z = carry[0]
            logsnr_t, logsnr_s = take(logsnr_ts, k), take(logsnr_ss, k)
            if self.sampler == 'dpm2m':
                # DPM-Solver++(2M) in half-logSNR time: D = x + (x - x_prev)
                # / (2 r), r = h_prev / h; the first step (D = x) is DDIM's
                x_pred, eps_pred = self._predict(net=body_net, z_t=z, logsnr_t=logsnr_t,
                                                 cond_w=cond_w)
                h = 0.5 * (logsnr_s - logsnr_t)
                x_prev, h_prev = carry[1:]
                D = pick(k == 0, x_pred, lambda: x_pred + (x_pred - x_prev) / (2.0 * (h_prev / h)))
                sig_ratio = torch.sqrt(torch.sigmoid(-logsnr_s) / torch.sigmoid(-logsnr_t))
                alpha_s = torch.sqrt(torch.sigmoid(logsnr_s))
                z_s = sig_ratio * z - (alpha_s * torch.expm1(-h)) * D
                rest = (x_pred, h)
            elif stochastic:
                noise = (take(step_noise, k) if step_noise is not None
                         else torch.randn(shape, generator=generator, device=dev))
                z_s, x_pred, eps_pred = self.reverse_dpm_step(
                    net=body_net, logsnr_t=logsnr_t, logsnr_s=logsnr_s, z_t=z, noise=noise,
                    cond_w=cond_w)
                rest = ()
            else:
                z_s, x_pred, eps_pred = self.ddim_step(
                    net=body_net, logsnr_t=logsnr_t, logsnr_s=logsnr_s, z_t=z, cond_w=cond_w)
                rest = ()
            # the last step returns x_hat
            z = pick(k == S - 1, x_pred, lambda: z_s)
            if return_history:
                for acc, v in zip(hist, (z, x_pred, eps_pred)):
                    acc.append(v)
            return (z, *rest)

        graphed = () if graphs is None else (SAMPLE_UNROLL, graphs, graphs.t)
        z = fori_loop(0, S, step, carry, *graphed)[0]
        if not return_history:
            return z if graphs is None else z.clone()  # not the fixed carry
        return tuple(torch.stack(acc) for acc in hist)
