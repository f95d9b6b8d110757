"""logSNR schedules. Counterpart of
generative_models_tpu/models/diffusion/schedules.py.

Every schedule maps t in [0, 1] (a float32 tensor) to logSNR, t = 0 giving
logsnr_max and t = 1 logsnr_min. Their constants are computed in float64
numpy, as in the JAX file, and enter the float32 math as Python floats; the
interpolated schedules hold their tables in float32 and interpolate as
jnp.interp does.
"""

import functools

import numpy as np
import torch


def _np_softplus(x):
    return np.logaddexp(x, 0)


def logsnr_uniform(t, *, logsnr_min, logsnr_max):
    return logsnr_min * t + logsnr_max * (1.0 - t)


def logsnr_beta_const(t, *, logsnr_min, logsnr_max):
    b = _np_softplus(-logsnr_max)
    a = _np_softplus(-logsnr_min) - b
    return -torch.log(torch.expm1(float(a) * t + float(b)))


def logsnr_beta_linear(t, *, logsnr_min, logsnr_max):
    b = _np_softplus(-logsnr_max)
    a = _np_softplus(-logsnr_min) - b
    return -torch.log(torch.expm1(float(a) * t**2 + float(b)))


def interp(x, xp, fp):
    """jnp.interp(x, xp, fp) for sorted 1-D xp: linear between the two
    nearest points, fp[0] left of xp[0] and fp[-1] right of xp[-1]."""
    xp = torch.as_tensor(xp, dtype=torch.float32, device=x.device)
    fp = torch.as_tensor(fp, dtype=torch.float32, device=x.device)
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + ((x - xp[i - 1]) / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def logsnr_beta_interpolated(t, *, betas):
    betas = np.asarray(betas, dtype=np.float64)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    logsnr = np.log(alphas_cumprod) - np.log1p(-alphas_cumprod)
    return interp(t, np.linspace(0, 1, len(betas)), logsnr)


def logsnr_cosine(t, *, logsnr_min, logsnr_max):
    b = np.arctan(np.exp(-0.5 * logsnr_max))
    a = np.arctan(np.exp(-0.5 * logsnr_min)) - b
    return -2.0 * torch.log(torch.tan(float(a) * t + float(b)))


def _iddpm_betas(num_timesteps):
    steps = np.arange(num_timesteps + 1, dtype=np.float64) / num_timesteps
    alpha_bar = np.cos((steps + 0.008) / 1.008 * np.pi / 2) ** 2
    return np.minimum(1 - alpha_bar[1:] / alpha_bar[:-1], 0.999)


def logsnr_iddpm_cosine_interpolated(t, *, num_timesteps):
    return logsnr_beta_interpolated(t, betas=_iddpm_betas(num_timesteps))


def logsnr_iddpm_cosine_respaced(t, *, num_timesteps, num_respaced_timesteps):
    betas = _iddpm_betas(num_timesteps)
    respaced_inds = np.round(
        np.linspace(0, 1, num_respaced_timesteps) * (num_timesteps - 1)
    ).astype(int)
    alpha_bar = np.cumprod(1.0 - betas)[respaced_inds]
    logsnr = np.log(alpha_bar) - np.log1p(-alpha_bar)
    return interp(t, np.linspace(0, 1, len(logsnr)), logsnr)


_SCHEDULES = {
    'uniform': logsnr_uniform,
    'beta_const': logsnr_beta_const,
    'beta_linear': logsnr_beta_linear,
    'beta_interp': logsnr_beta_interpolated,
    'cosine': logsnr_cosine,
    'iddpm_cosine_interp': logsnr_iddpm_cosine_interpolated,
    'iddpm_cosine_respaced': logsnr_iddpm_cosine_respaced,
}


def get_logsnr_schedule(name, **kwargs):
    return functools.partial(_SCHEDULES[name], **kwargs)
