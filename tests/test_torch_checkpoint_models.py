"""A JAX package's model.pt read into the port, as in
tests/test_torch_checkpoint.py (its helpers, tolerances and ZERO_GRAD), for
the other models: vae, rnn, wavenet, pixel_cnn and gated_pixel_cnn;
diffusion with --ema and a teacher that is itself a JAX model.pt (gan is
in test_torch_checkpoint.py, which keeps each file near a minute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_checkpoint import (
    UNET_ZERO_GRAD, _batch, _check_against, _jax_model, _next_state, _np, _port,
    step_after_jax,
)

torch.set_num_threads(1)

CASES = {
    'vae': ['--model=vae', '--hidden_size=16'],
    'rnn': ['--model=rnn', '--hidden_size=16'],
    'wavenet': ['--model=wavenet', '--hidden_size=8'],
    'pixel_cnn': ['--model=pixel_cnn', '--n_filters=8', '--n_layers=2', '--kernel_size=3'],
    'gated_pixel_cnn': ['--model=gated_pixel_cnn', '--n_filters=8', '--n_layers=3',
                        '--kernel_size=3'],
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_jax_checkpoint_steps_as_the_jax_package(name, tmp_path):
    step_after_jax(CASES[name], name, tmp_path)


def test_diffusion_jax_checkpoint_with_ema_and_a_jax_teacher(tmp_path):
    """A student of a JAX teacher (--teacher_path to a JAX model.pt, read
    by the port too) with --ema, every weight perturbed so that no
    gradient sits behind a zero-init conv: after one JAX step the port
    reads the student's model.pt (net, Adam, extra['ema'],
    extra['teacher']) and takes the next step on the JAX step's draws."""
    from test_torch_diffusion_model import _perturb, jax_model_draws

    base = ['--model=diffusion_model', '--hidden_size=32', '--timesteps=4', '--bf16=0',
            '--eval_heavy=0']
    jt = _jax_model(base, tmp_path / 'jt')
    jt.state = jt.state.replace(params=_perturb(jt.state.params, seed=1))
    jt.save(tmp_path / 'jt')
    flags = base + [f'--teacher_path={tmp_path / "jt" / "model.pt"}', '--ema=0.9']
    js = _jax_model(flags, tmp_path / 'js')
    js.state = js.state.replace(params=_perturb(js.state.params, seed=2))
    x = _batch(False, seed=1)
    y = np.array([0, 3, 7, 9], np.int32)
    js.train_step(jnp.asarray(x), jnp.asarray(y))
    js.save(tmp_path / 'js')

    model = _port(flags)
    assert model.has_teacher
    teacher = model.params_from_jax(_np(jt.state.params))
    for k, v in teacher.items():
        assert torch.equal(model.teacher_net.state_dict()[k], v), k
    model.load_weights(tmp_path / 'js' / 'model.pt')
    draws = jax_model_draws(jax.random.fold_in(js.state.rng, js.state.step), y.shape, x.shape, 4)
    js.train_step(jnp.asarray(x), jnp.asarray(y))
    model.train_step(x, torch.from_numpy(y), draws=draws)
    ref = _next_state(js, tmp_path)
    _check_against(model, ref, flags, UNET_ZERO_GRAD)
    for key, net in (('ema', model.ema_net), ('teacher', model.teacher_net)):
        want = model.params_from_jax(ref['extra'][key])
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f'{key} {k}')
