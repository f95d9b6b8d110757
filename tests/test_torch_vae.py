"""The port's VAE (generative_models_tpu_torch/models/vae.py) against the
JAX package's on the CPU at hidden_size=8, z_size=4: the same weights
(JAX params, perturbed, carried over by convert.vae_params_from_jax) and
the JAX package's posterior noise, drawn from its key as its loss draws
it. The loss and its metrics (binarized and [-1, 1] data), every
parameter's gradient and one Adam step against optax; the eval loss's
fixed draw; sample_fn from the same prior draw; the training CLI's
artifacts and keys; serving 64 samples in {0, 1} through SampleServer.

Tolerances (f32 on both sides): losses rtol 1e-5; each gradient within
1e-5 of its own norm plus 1e-7 of the whole gradient's; the Adam step
atol 1e-6 (it moves a parameter by up to lr = 3e-4); samples exactly
(sigmoid > 0.5 of logits that agree to 1e-6, away from 0)."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import generative_models_tpu_torch.data.mnist as tm
from generative_models_tpu.models.vae import VAENet as JaxVAENet
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.convert import vae_params_from_jax
from generative_models_tpu_torch.main import main
from generative_models_tpu_torch.serve import SampleServer
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

FLAGS = ['--model=vae', '--hidden_size=8', '--z_size=4']


def _jax_model(*flags):
    G, Model = jax_parse_args(FLAGS + list(flags), discover_models=jax_models)
    return Model(G)


def _port(params, *flags):
    G, Model = parse_args(FLAGS + ['--device=cpu'] + list(flags))
    model = Model(G)
    model.net.load_state_dict(vae_params_from_jax(jax.device_get(params)))
    return model


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.randn(*p.shape).astype(np.float32)),
        params)


def _batch(binarize, B=8, seed=0):
    x = np.random.RandomState(seed).rand(B, 28, 28, 1).astype(np.float32)
    return (x > 0.5).astype(np.float32) if binarize else 2 * x - 1


def _eps(jm, params, x, rng):
    """The JAX loss's posterior noise: dists.Normal(mu, std).rsample(rng)
    draws jax.random.normal(rng, mu.shape)."""
    mu, _ = jm.net.apply({'params': params}, jnp.asarray(x), method=JaxVAENet.encode)
    return torch.from_numpy(np.array(jax.random.normal(rng, mu.shape)))


@pytest.mark.parametrize('binarize', [1, 0])
def test_loss_gradients_and_adam_step_match_jax(binarize):
    jm = _jax_model(f'--binarize={binarize}', '--beta=0.5')
    params = _perturb(jm.state.params)
    model = _port(params, f'--binarize={binarize}', '--beta=0.5')
    x = _batch(binarize)
    rng = jax.random.key(3)
    eps = _eps(jm, params, x, rng)
    (ref_loss, ref_metrics), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, jnp.asarray(x), None, rng, True)
    metrics = model.backward(x, eps=eps)
    assert set(metrics) == set(ref_metrics) == {'vae_loss', 'recon_loss', 'kl_loss'}
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(ref_metrics[k]), rel=1e-5), k
    ref = vae_params_from_jax(jax.device_get(grads))
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref.values())))
    for name, p in model.net.named_parameters():
        err = float(torch.linalg.vector_norm(p.grad.double() - ref[name].double()))
        norm = float(torch.linalg.vector_norm(ref[name].double()))
        assert norm > 0 and err <= 1e-5 * norm + 1e-7 * total, (name, err, norm)

    opt = jm.make_optimizer()
    updates, _ = opt.update(grads, opt.init(params), params)
    stepped = vae_params_from_jax(jax.device_get(optax.apply_updates(params, updates)))
    for name, p in model.net.named_parameters():
        p.grad = ref[name].float().clone()
    model.apply_grads()
    for name, p in model.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), stepped[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_eval_loss_draws_the_same_noise_each_call():
    jm = _jax_model()
    model = _port(_perturb(jm.state.params))
    x = torch.from_numpy(_batch(1))
    a, b = model.eval_loss(x), model.eval_loss(x)
    assert a == b and set(a) == {'vae_loss', 'recon_loss', 'kl_loss'}
    with torch.no_grad():
        other = model.loss(x, eps=torch.zeros(8, 4))[1]
    assert float(other['vae_loss']) != a['vae_loss']


def test_sample_fn_matches_jax_from_the_same_draw():
    jm = _jax_model()
    params = _perturb(jm.state.params, scale=0.3)
    model = _port(params)
    rng = jax.random.key(5)
    state = jm.state.replace(params=params)
    ref = np.asarray(jm.sample_fn(state, 16, rng))
    z = torch.from_numpy(np.array(jax.random.normal(rng, (16, 4))))
    with torch.no_grad():
        got = model.sample_fn(16, z=z).numpy()
    assert got.shape == (16, 28, 28, 1) and set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_array_equal(got, ref)


def test_vae_trains_through_the_cli_and_serves(tmp_path, monkeypatch):
    """The port's default model: one epoch, model.pt and hps.yaml, the vae/
    keys, the grid and reconstruction strip in the event file; then 64
    samples in {0, 1} through SampleServer, seed=3 twice equal."""
    monkeypatch.setattr(tm, 'TRAIN_N', 32)
    monkeypatch.setattr(tm, 'TEST_N', 16)
    with contextlib.redirect_stdout(io.StringIO()):
        history = main(['--device=cpu', '--hidden_size=8', '--z_size=4', '--bs=8', '--epochs=1',
                        '--save_n=1', '--data_source=synthetic', f'--logdir={tmp_path}'])
    assert {k for k in history[1] if k.startswith('vae/')} == {
        f'vae/{s}/{k}' for s in ('train', 'test') for k in ('vae_loss', 'recon_loss', 'kl_loss')}
    assert all(np.isfinite(v) for h in history for v in h.values())
    for name in ('model.pt', 'hps.yaml'):
        assert (tmp_path / name).is_file(), name
    assert list(tmp_path.glob('events.out.tfevents.*'))
    G, Model = parse_args([f'--weights_from={tmp_path / "model.pt"}', '--device=cpu'])
    model = Model(G)
    model.load_weights(G.weights_from)
    server = SampleServer(model, serve_bs=64)
    a, b = server.sample(64, seed=3), server.sample(64, seed=3)
    assert a.shape == (64, 28, 28, 1) and set(np.unique(a)) <= {0.0, 1.0}
    np.testing.assert_array_equal(a, b)
    assert server.sample(5).shape == (5, 28, 28, 1)
