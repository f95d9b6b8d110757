"""Trace a loss curve that falls outside the parity contract to its cause, on
the CPU:

    JAX_PLATFORMS=cpu python tests/parity_trace.py gated_pixel_cnn diffusion

For each model: the JAX package's curve on the reference's batches (its
own init and draws: tests/parity_common.py run_ours), the port's with its
own init and draws (generative_models_tpu_torch/data/parity.py run_curve,
what chip_smoke.py's parity phase runs on the card), and the port's from
the JAX package's initial weights (carried over by convert): with the JAX
package's training draws too where the model draws any (diffusion: its
label drop, eps, t and w, split from fold_in(rng, step) as its train step
splits them), so that curve must be the JAX one; and, for a model that
draws, the port's from the JAX init with its own draws and from its own
init with the JAX draws. Prints each curve's converged-window excess over
the reference (data/parity.py excess) and its largest distance from the
JAX curve. Not a test: the JAX package compiles each conv model once for
its whole curve, which takes minutes on the CPU."""

import json
import sys
import time

import jax
import numpy as np
import torch

import parity_common as jpc
from generative_models_tpu_torch import convert
from generative_models_tpu_torch.data import parity as tparity

CONVERT = {'gated_pixel_cnn': convert.gated_pixel_cnn_params_from_jax,
           'pixel_cnn': convert.pixel_cnn_params_from_jax,
           'diffusion': convert.diffusion_params_from_jax,
           'made': convert.made_params_from_jax,
           'vae': convert.vae_params_from_jax}


def _jax_draws(jm, state, x, y):
    """The draws of the JAX diffusion train step at state."""
    from test_torch_diffusion_model import jax_model_draws

    rng = jax.random.fold_in(state.rng, state.step)
    return jax_model_draws(rng, y.shape, x.shape, int(jm.G.timesteps))


def _port_curve(name, params=None, draws_of=None):
    """The port's curve on the CPU; params: a JAX init's state dict; draws_of:
    a JAX model whose train steps give each step's draws."""
    info = tparity.reference_curves()[name]
    key = tparity.KEY_OVERRIDE.get(name, info['key'])
    bx, by = tparity.parity_batches(4096, info['bs'], info['steps'], info['binarize'])
    model = tparity.build(name, info['bs'], 'cpu', params)
    curve = []
    for i in range(info['steps']):
        x, y = torch.from_numpy(bx[i]), torch.from_numpy(by[i])
        kw = {}
        if draws_of is not None:
            kw['draws'] = _jax_draws(draws_of, draws_of.state, bx[i], by[i])
            draws_of.train_step(jax.numpy.asarray(bx[i]), jax.numpy.asarray(by[i]))
        curve.append(float(model.train_step(x, y, **kw)[key]))
    return curve


def trace(name):
    torch.manual_seed(0)
    info = tparity.reference_curves()[name]
    ref = tparity.ref_curve(info, name, info['steps'])
    t0 = time.time()
    jax_curve, _ = jpc.run_ours(name, cap=False)
    jm = jpc.build(name, info['bs'])
    init = CONVERT[name](jax.tree_util.tree_map(np.asarray, jm.state.params))
    draws = name == 'diffusion'
    curves = {'jax': jax_curve, 'port': _port_curve(name),
              'port_jax_init' + ('_jax_draws' if draws else ''):
                  _port_curve(name, init, jpc.build(name, info['bs']) if draws else None)}
    if draws:
        curves['port_jax_init'] = _port_curve(name, init)
        curves['port_jax_draws'] = _port_curve(name, None, jpc.build(name, info['bs']))
    out = {}
    for key, c in curves.items():
        try:
            tparity.check_parity(name, c, ref)
            ok = True
        except AssertionError:
            ok = False
        out[key] = dict(excess=tparity.excess(name, c, ref), within_contract=ok,
                        max_abs_vs_jax=float(np.max(np.abs(np.array(c) - np.array(jax_curve)))))
    print(json.dumps({name: dict(tol=tparity.TOL.get(name), sec=time.time() - t0, **out)}),
          flush=True)


if __name__ == '__main__':
    for name in sys.argv[1:]:
        trace(name)
