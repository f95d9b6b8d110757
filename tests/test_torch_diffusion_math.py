"""The port's diffusion math (generative_models_tpu_torch/models/diffusion/
schedules.py and gaussian_diffusion.py) against the JAX package's on the
CPU: the seven logSNR schedules, log1mexp and its guarded gradient, q(z_t|x)
and q(z_s|z_t,x) with the three variances, the predict_* conversions and
their round trips, _run_model for every mean type, the training losses (no
teacher, step1, step2) and their gradients, and every sampler chain (ddim,
noisy, dpm2m, --sample_steps, guided two-call and fused, teacher_test).

The nets are small closed-form functions of (z, logsnr, cond_w, the guide
branch), written once in each framework, so the comparison holds the math
and not a UNet (tests/test_torch_unet.py holds that). The JAX package's
random draws are taken from its keys with its own splits and handed to the
port. Tolerances: f32 on both sides, atol 1e-5 and rtol 1e-5 (2e-5 over a
chain, whose steps compound rounding), except where stated. A guided chain
is held at atol 1e-2: its first step, at logSNR -20, takes x_hat from the
guided eps through sqrt(1 + e^20) ~ 2.2e4, so a 1-ulp difference in eps
(2.4e-7 at |eps| ~ 2) moves x_hat by ~5e-3 before the clip; one guided
step at a moderate logSNR is held at 1e-5 below.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.models.diffusion import gaussian_diffusion as jgd
from generative_models_tpu.models.diffusion import schedules as jsch
from generative_models_tpu_torch.models.diffusion import gaussian_diffusion as tgd
from generative_models_tpu_torch.models.diffusion import schedules as tsch

TOL = dict(rtol=1e-5, atol=1e-5)
CHAIN_TOL = dict(rtol=2e-5, atol=2e-5)
GUIDED_CHAIN_TOL = dict(rtol=0, atol=1e-2)
SHAPE = (3, 4, 4, 1)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------- #
# the same small nets in both frameworks
# ---------------------------------------------------------------------- #
def _jnet(a=0.5, b=0.1, both=False):
    def net(z, logsnr, cond_w=None, uncond=False, uncond_second_half=False):
        ls = jgd.bc(jnp.broadcast_to(jnp.asarray(logsnr, jnp.float32), (z.shape[0],)), z.shape)
        scale = jnp.full(z.shape, 0.6 if uncond else 1.0, jnp.float32)
        if uncond_second_half:
            B = z.shape[0] // 2
            scale = jnp.concatenate([jnp.ones_like(z[:B]), 0.6 * jnp.ones_like(z[B:])])
        out = a * scale * jnp.tanh(z) + b * jnp.tanh(0.1 * ls)
        if cond_w is not None:
            cw = jnp.broadcast_to(jnp.asarray(cond_w, jnp.float32), (z.shape[0],))
            out = out + 0.05 * jgd.bc(cw, z.shape)
        if both:
            out = jnp.concatenate([out, 0.7 * out + 0.1], axis=-1)
        return out

    return net


def _tnet(a=0.5, b=0.1, both=False):
    def net(z, logsnr, cond_w=None, uncond=False, uncond_second_half=False):
        ls = tgd.bc(torch.as_tensor(logsnr, dtype=torch.float32).expand(z.shape[0]), z.shape, z)
        scale = torch.full(z.shape, 0.6 if uncond else 1.0)
        if uncond_second_half:
            B = z.shape[0] // 2
            scale = torch.cat([torch.ones_like(z[:B]), 0.6 * torch.ones_like(z[B:])])
        out = a * scale * torch.tanh(z) + b * torch.tanh(0.1 * ls)
        if cond_w is not None:
            cw = torch.as_tensor(cond_w, dtype=torch.float32).expand(z.shape[0])
            out = out + 0.05 * tgd.bc(cw, z.shape, z)
        if both:
            out = torch.cat([out, 0.7 * out + 0.1], dim=-1)
        return out

    return net


def _z(seed=0, shape=SHAPE):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------- #
# schedules, log1mexp, q(z_t|x), q(z_s|z_t,x), conversions
# ---------------------------------------------------------------------- #
SCHEDULES = [
    ('uniform', dict(logsnr_min=-20.0, logsnr_max=20.0)),
    ('beta_const', dict(logsnr_min=-12.0, logsnr_max=10.0)),
    ('beta_linear', dict(logsnr_min=-12.0, logsnr_max=10.0)),
    ('beta_interp', dict(betas=np.linspace(1e-4, 0.02, 50))),
    ('cosine', dict(logsnr_min=-20.0, logsnr_max=20.0)),
    ('iddpm_cosine_interp', dict(num_timesteps=40)),
    ('iddpm_cosine_respaced', dict(num_timesteps=40, num_respaced_timesteps=13)),
]


@pytest.mark.parametrize('name,kw', SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_jax(name, kw):
    t = np.concatenate([[0.0, 1.0, 0.5, 1e-3, 0.999],
                        np.random.RandomState(1).rand(32)]).astype(np.float32)
    ref = jsch.get_logsnr_schedule(name, **kw)(jnp.asarray(t))
    got = tsch.get_logsnr_schedule(name, **kw)(torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=2e-6, atol=2e-6)


def test_log1mexp_and_its_guarded_gradient_match_jax():
    """Values on both branches, and the gradient near 0, where the guard
    keeps it finite (jax.grad against torch.autograd)."""
    x = np.array([-30.0, -5.0, -1.0, math.log(0.5) - 1e-4, math.log(0.5), -0.3, -1e-3, -1e-6,
                  -1e-9], np.float32)
    ref = jgd.log1mexp(jnp.asarray(x))
    ref_g = jax.grad(lambda v: jgd.log1mexp(v).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tgd.log1mexp(xt)
    got.sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(ref_g), rtol=1e-5, atol=1e-5)
    assert np.isfinite(_np(xt.grad)).all()
    assert abs(float(xt.grad[-1])) < 1.1e7  # the guard: |d/dx| <= 1 / expm1_guard


@pytest.mark.parametrize('x_logvar', ['small', 'large', 'medium:0.3'])
def test_diffusion_forward_and_reverse_match_jax(x_logvar):
    rng = np.random.RandomState(2)
    x, z = rng.randn(*SHAPE).astype(np.float32), rng.randn(*SHAPE).astype(np.float32)
    ls_t = rng.uniform(-8, 2, SHAPE).astype(np.float32)
    ls_s = ls_t + rng.uniform(0.01, 4, SHAPE).astype(np.float32)  # s < t: higher logSNR
    ref = jgd.diffusion_reverse(jnp.asarray(x), jnp.asarray(z), jnp.asarray(ls_s),
                                jnp.asarray(ls_t), x_logvar)
    got = tgd.diffusion_reverse(_t(x), _t(z), _t(ls_s), _t(ls_t), x_logvar)
    assert set(got) == set(ref) == {'mean', 'std', 'var', 'logvar'}
    for k in ref:
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), **TOL, err_msg=k)
    ref = jgd.diffusion_forward(jnp.asarray(x), jnp.asarray(ls_t))
    got = tgd.diffusion_forward(_t(x), _t(ls_t))
    for k in ref:
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), **TOL, err_msg=k)


def test_predict_conversions_match_jax_and_round_trip():
    rng = np.random.RandomState(3)
    x, eps = np.clip(rng.randn(*SHAPE), -1, 1).astype(np.float32), rng.randn(*SHAPE).astype(np.float32)
    ls = rng.uniform(-6, 6, SHAPE[0]).astype(np.float32)
    a = np.sqrt(1 / (1 + np.exp(-ls)))[:, None, None, None]
    s = np.sqrt(1 / (1 + np.exp(ls)))[:, None, None, None]
    z = (a * x + s * eps).astype(np.float32)
    J, T = (jnp.asarray(v) for v in (x, eps, z, ls)), [_t(v) for v in (x, eps, z, ls)]
    jx, jeps, jz, jls = J
    tx, teps, tz, tls = T
    v_ref = jgd.predict_v_from_x_and_eps(jx, jeps, jls)
    v = tgd.predict_v_from_x_and_eps(tx, teps, tls)
    pairs = [
        (tgd.predict_x_from_eps(tz, teps, tls), jgd.predict_x_from_eps(jz, jeps, jls), x),
        (tgd.predict_eps_from_x(tz, tx, tls), jgd.predict_eps_from_x(jz, jx, jls), eps),
        (v, v_ref, None),
        (tgd.predict_x_from_v(tz, v, tls), jgd.predict_x_from_v(jz, v_ref, jls), x),
    ]
    for got, ref, exact in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
        if exact is not None:  # the round trip back to what z was made of
            np.testing.assert_allclose(_np(got), exact, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize('mean_type', ['eps', 'x', 'v', 'both'])
def test_run_model_matches_jax(mean_type):
    z = _z(4)
    ls = np.array([-7.0, 0.3, 9.0], np.float32)
    kw = dict(mean_type=mean_type, num_steps=4)
    ref = jgd.GaussianDiffusion(**kw)._run_model(net=_jnet(both=mean_type == 'both'),
                                                 z=jnp.asarray(z), logsnr=jnp.asarray(ls))
    got = tgd.GaussianDiffusion(**kw)._run_model(net=_tnet(both=mean_type == 'both'),
                                                 z=_t(z), logsnr=_t(ls))
    for k in ('model_x', 'model_eps', 'model_v'):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), **TOL, err_msg=k)


# ---------------------------------------------------------------------- #
# training losses and their gradients
# ---------------------------------------------------------------------- #
def jax_loss_draws(rng, shape, num_steps, step2=False):
    """The draws GaussianDiffusion.training_losses takes from rng, with its
    splits (eps, u or i, w), as the port's arguments."""
    rng_eps, rng_u, rng_w = jax.random.split(rng, 3)
    eps = jax.random.normal(rng_eps, shape, jnp.float32)
    if step2:
        u = jax.random.randint(rng_u, (shape[0],), 0, num_steps)
    else:
        u = jax.random.uniform(rng_u, (shape[0],), jnp.float32)
    w = jax.random.uniform(rng_w, (shape[0],), jnp.float32)
    return {k: _t(v) for k, v in (('eps', eps), ('u', u), ('w', w))}


LOSS_CASES = [('eps', None), ('x', None), ('v', None), ('both', None), ('v', 'step1'),
              ('v', 'step2'), ('x', 'step2')]


@pytest.mark.parametrize('mean_type,teacher_mode', LOSS_CASES,
                         ids=[f'{m}-{t or "plain"}' for m, t in LOSS_CASES])
def test_training_losses_and_gradients_match_jax(mean_type, teacher_mode):
    """The per-example losses and the gradient of their mean with respect to
    the net's two parameters, from the same draws; with a teacher the
    step1 ('snr') and step2 targets."""
    x = np.clip(_z(5, (6, 4, 4, 1)), -1, 1)
    N = 4
    both = mean_type == 'both'
    kw = dict(mean_type=mean_type, num_steps=N, has_teacher=teacher_mode is not None,
              teacher_mode=teacher_mode)
    rng = jax.random.key(11)
    jd = jgd.GaussianDiffusion(**kw)

    def jloss(params):
        teacher = _jnet(0.8, -0.2, both) if teacher_mode else None
        return jd.training_losses(net=_jnet(*params, both=both), x=jnp.asarray(x), rng=rng,
                                  teacher_net=teacher)['loss']

    ref = jloss((0.5, 0.1))
    ref_g = jax.grad(lambda p: jloss(p).mean())((0.5, 0.1))
    a, b = (torch.tensor(v, requires_grad=True) for v in (0.5, 0.1))
    draws = jax_loss_draws(rng, x.shape, N, step2=teacher_mode == 'step2')
    got = tgd.GaussianDiffusion(**kw).training_losses(
        net=_tnet(a, b, both), x=_t(x), teacher_net=_tnet(0.8, -0.2, both) if teacher_mode else None,
        **draws)['loss']
    got.mean().backward()
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    np.testing.assert_allclose([float(a.grad), float(b.grad)], [float(g) for g in ref_g],
                               rtol=1e-4, atol=1e-5)


def test_training_losses_draw_from_the_generator():
    """Without draws the port takes eps, u and w from its generator: the
    same seed gives the same loss, another seed another."""
    d = tgd.GaussianDiffusion(mean_type='v', num_steps=4)
    x = _t(np.clip(_z(6), -1, 1))
    loss = lambda s: d.training_losses(net=_tnet(), x=x,
                                       generator=torch.Generator().manual_seed(s))['loss']
    assert torch.equal(loss(1), loss(1))
    assert not torch.equal(loss(1), loss(2))


# ---------------------------------------------------------------------- #
# sampler chains
# ---------------------------------------------------------------------- #
CHAINS = [
    dict(sampler='ddim'),
    dict(sampler='noisy'),
    dict(sampler='dpm2m'),
    dict(sampler='ddim', sample_steps=3),
    dict(sampler='dpm2m', sample_steps=5),
    dict(sampler='ddim', guided=True),
    dict(sampler='ddim', guided=True, fused_cfg=True),
    dict(sampler='noisy', guided=True),
    dict(sampler='ddim', sample_cond_w=1.5, guided=True),
    dict(sampler='teacher_test', guided=True),
    dict(sampler='ddim', teacher='step1', guided=True),
]


def _chain_id(c):
    return '-'.join(f'{k}={v}' if v is not True else k for k, v in c.items())


@pytest.mark.parametrize('case', CHAINS, ids=[_chain_id(c) for c in CHAINS])
def test_sample_chains_match_jax(case):
    """The whole (z, x_hat, eps_hat) history of each sampler from the same
    noise, guidance weights and per-step normals (the JAX package's
    splits), and the final batch alone with return_history=False."""
    case = dict(case)
    guided, teacher = case.pop('guided', False), case.pop('teacher', None)
    kw = dict(mean_type='v', num_steps=6, has_teacher=teacher is not None, teacher_mode=teacher,
              sample_cond_w=case.pop('sample_cond_w', -1.0), **case)
    z0 = np.clip(_z(7), -2.5, 2.5)
    rng = jax.random.key(5)
    cond_w = 0.5 if guided else None
    teacher_j = _jnet(0.8, -0.2) if case['sampler'] == 'teacher_test' or teacher else None
    teacher_t = _tnet(0.8, -0.2) if teacher_j is not None else None
    ref = jgd.GaussianDiffusion(**kw).sample(net=_jnet(), init_x=jnp.asarray(z0), rng=rng,
                                             cond_w=cond_w, teacher_net=teacher_j)
    rng_w, rng_chain = jax.random.split(rng)
    S = int(case.get('sample_steps') or 6)
    w = np.asarray(jax.random.uniform(rng_w, (z0.shape[0],)))
    noise = np.stack([np.asarray(jax.random.normal(k, z0.shape, jnp.float32))
                      for k in jax.random.split(rng_chain, S)])
    d = tgd.GaussianDiffusion(**kw)
    args = dict(net=_tnet(), init_x=_t(z0), cond_w=cond_w, teacher_net=teacher_t, w=_t(w),
                step_noise=_t(noise))
    got = d.sample(**args)
    assert len(got) == 3 and got[0].shape == (S,) + z0.shape
    guidance = (guided and teacher is None) or kw['sample_cond_w'] != -1.0
    tol = GUIDED_CHAIN_TOL if guidance else CHAIN_TOL
    for name, g, r in zip(('z', 'x_hat', 'eps_hat'), got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), **tol, err_msg=name)
    final = d.sample(**args, return_history=False)
    assert torch.equal(final, got[0][-1])
    assert torch.equal(final, got[1][-1])  # the last step returns x_hat


@pytest.mark.parametrize('fused_cfg', [False, True], ids=['two_call', 'fused'])
def test_guided_ddim_step_matches_jax(fused_cfg):
    """One guided DDIM step, a weight a sample, at moderate logSNRs."""
    z0, w = np.clip(_z(10), -2.5, 2.5), np.array([0.3, 1.7, 3.2], np.float32)
    kw = dict(mean_type='v', num_steps=6, fused_cfg=fused_cfg)
    for lt, ls in [(-3.0, -2.0), (5.0, 9.0)]:
        ref = jgd.GaussianDiffusion(**kw).ddim_step(
            net=_jnet(), z_t=jnp.asarray(z0), logsnr_t=jnp.float32(lt), logsnr_s=jnp.float32(ls),
            cond_w=jnp.asarray(w))
        got = tgd.GaussianDiffusion(**kw).ddim_step(
            net=_tnet(), z_t=_t(z0), logsnr_t=torch.tensor(lt), logsnr_s=torch.tensor(ls),
            cond_w=_t(w))
        for name, g, r in zip(('z_s', 'x_hat', 'eps_hat'), got, ref):
            np.testing.assert_allclose(_np(g), np.asarray(r), **TOL, err_msg=f'{lt} {name}')


def test_fused_guidance_equals_two_calls():
    """One doubled-batch call a step gives the two-call chain's numbers."""
    z0, w = _t(np.clip(_z(8), -2.5, 2.5)), torch.rand(3, generator=torch.Generator().manual_seed(0))
    out = [tgd.GaussianDiffusion(mean_type='v', num_steps=5, fused_cfg=f).sample(
        net=_tnet(), init_x=z0, cond_w=0.5, w=w, return_history=False) for f in (False, True)]
    np.testing.assert_allclose(_np(out[0]), _np(out[1]), rtol=1e-6, atol=1e-6)


def test_dpm2m_first_step_is_ddim():
    z0 = _t(np.clip(_z(9), -2.5, 2.5))
    zs = [tgd.GaussianDiffusion(mean_type='v', num_steps=4, sampler=s).sample(
        net=_tnet(), init_x=z0)[0][0] for s in ('ddim', 'dpm2m')]
    np.testing.assert_allclose(_np(zs[0]), _np(zs[1]), rtol=1e-6, atol=1e-6)
