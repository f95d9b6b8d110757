"""The port's GAN (generative_models_tpu_torch/models/gan.py) against the
JAX package's on the CPU at hidden_size=8, noise_size=16, bs=8: the same
weights and batch statistics (the JAX init, carried over by
convert.gan_params_from_jax) and the JAX step's noise, drawn as its
train_step_fn draws it.

One twin step: the four losses; both nets' params, both Adams' moments
and both nets' batch_stats after the step. The batch statistics show the
JAX package's threading, by hand: the generator's running mean and var
moved once (a second move, or torch's unbiased running variance, misses
the tolerance tenfold), the discriminator's twice, real then fake. Then sample_fn in eval mode from the same noise, the
served batch mapped from [-1, 1] to [0, 1], the training CLI (model.pt with
both optimizers and the batch statistics, the two grids), also with
--spectral_norm=1. --spectral_norm=1 (flax SpectralNorm written out): one
twin step as above, with each SpectralNorm's u and sigma after it
(rtol 1e-5, atol 1e-6); and from the same u, one discriminator pass in
train mode: its logits (rtol 1e-5), the u and sigma it stores, and every
gradient of the real-batch loss (within 1e-5 of its norm plus 1e-7 of the
whole), sigma's own gradient path included.

Tolerances (f32 on both sides): losses rtol 1e-5; params atol 1e-6 (one
Adam step moves each by up to lr = 5e-5); the moments within 1e-5 of each
tensor's norm; batch_stats rtol 1e-5, atol 1e-6; samples atol 1e-5. The
biases of the convs that feed a BatchNorm (BN_FED) have an exact gradient
of 0: on each side theirs is within 1e-5 of the whole gradient's norm, and
their steps (Adam's sign of the rounding) within 2 lr of each other."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import generative_models_tpu_torch.data.mnist as tm
from generative_models_tpu.models.gan import bce_with_logits as bce_with_logits_jax
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.convert import gan_params_from_jax
from generative_models_tpu_torch.main import main
from generative_models_tpu_torch.serve import SampleServer
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

FLAGS = ['--model=gan', '--hidden_size=8', '--noise_size=16']
# the biases of the convs that feed a train-mode BatchNorm: the batch mean
# takes them out again, so their exact gradient is 0 and Adam's first step
# moves each element by up to lr on the sign of rounding noise, on each side
# its own way
BN_FED = {'gen.deconvs.0.bias', 'gen.deconvs.1.bias', 'gen.deconvs.2.bias',
          'disc.convs.1.bias', 'disc.convs.2.bias'}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_model(*flags):
    G, Model = jax_parse_args(FLAGS + list(flags), discover_models=jax_models)
    return Model(G)


def _port(state, *flags):
    G, Model = parse_args(FLAGS + ['--device=cpu'] + list(flags))
    model = Model(G)
    model.net.load_state_dict(gan_params_from_jax(_np(state.params), _np(state.extra)))
    return model


def _batch(B=8, seed=0):
    x = np.random.RandomState(seed).rand(B, 28, 28, 1).astype(np.float32)
    return 2 * x - 1


def _adam_moments(opt, params):
    """{name: (exp_avg, exp_avg_sq)} of a torch Adam over named params."""
    return {name: (opt.state[p]['exp_avg'], opt.state[p]['exp_avg_sq']) for name, p in params}


@pytest.mark.parametrize('flags', [(), ('--disc_lr=1e-4', '--label_smooth=0.1'),
                                   ('--spectral_norm=1',)])
def test_one_twin_step_matches_jax(flags):
    jm = _jax_model(*flags)
    state = jm.state
    model = _port(state, *flags)
    x = _batch()
    noise = np.array(jax.random.normal(jax.random.fold_in(state.rng, state.step), (8, 16)))
    new, ref_metrics = jax.jit(jm.train_step_fn)(state, jnp.asarray(x))
    metrics = model.train_step(x, noise=torch.from_numpy(noise))
    assert set(metrics) == set(ref_metrics)
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(ref_metrics[k]), rel=1e-5), k

    ref_sd = gan_params_from_jax(_np(new.params), _np(new.extra))
    got_sd = model.net.state_dict()
    assert set(got_sd) == set(ref_sd)
    for name, ref in ref_sd.items():
        if name in BN_FED:
            continue
        tol = (dict(rtol=1e-5, atol=1e-6) if name.endswith(('.mean', '.var', '.u', '.sigma'))
               else dict(rtol=0, atol=1e-6))
        np.testing.assert_allclose(got_sd[name].numpy(), ref.numpy(), err_msg=name, **tol)

    for net, opt in (('gen', model.opt), ('disc', model.disc_opt)):
        adam = _np(new.opt_state[net])[0]  # optax adam: (ScaleByAdamState, EmptyState)
        assert int(adam.count) == 1 and opt.state_dict()['state'][0]['step'] == 1
        mu = gan_params_from_jax({net: adam.mu, 'gen' if net == 'disc' else 'disc': {}})
        nu = gan_params_from_jax({net: adam.nu, 'gen' if net == 'disc' else 'disc': {}})
        # a first Adam step's mu is (1 - b1) g = g / 2
        whole = 2 * float(torch.sqrt(sum((m.double() ** 2).sum() for m in mu.values())))
        params = [(f'{net}.{n}', p) for n, p in model.net[net].named_parameters()]
        for name, (m, v) in _adam_moments(opt, params).items():
            if name in BN_FED:
                # the exact gradient is 0: each side's is rounding, and its
                # step at most lr
                for g in (2 * m, 2 * mu[name]):
                    assert float(torch.linalg.vector_norm(g.double())) <= 1e-5 * whole, name
                lr = float(opt.param_groups[0]['lr'])
                assert float((got_sd[name] - ref_sd[name]).abs().max()) <= 2 * lr * (1 + 1e-6)
                continue
            for got, ref in ((m, mu[name]), (v, nu[name])):
                err = float(torch.linalg.vector_norm(got.double() - ref.double()))
                assert err <= 1e-5 * float(torch.linalg.vector_norm(ref.double())) + 1e-12, name


def test_batch_stats_move_once_for_the_generator_twice_for_the_discriminator():
    """The JAX step's statistics by hand, on both nets' first BatchNorm (its
    input's batch mean and biased variance, flax's momentum 0.9): the
    generator's moved once, from the fake batch; the discriminator's twice,
    real then fake. The alternatives miss by more than ten times the
    tolerance: torch's unbiased running variance, a second generator move,
    one discriminator move. The generator's first deconv is scaled up 50x in
    both packages, so that its output's variance (~1e-2 at the init) is
    large enough for the unbiased factor n / (n - 1), n = 200, to show."""
    jm = _jax_model()
    params = jax.tree_util.tree_map(lambda a: a, jm.state.params)
    params['gen']['ConvTranspose_0']['kernel'] = params['gen']['ConvTranspose_0']['kernel'] * 50
    state = jm.state.replace(params=params)
    model = _port(state)
    x = _batch(seed=1)
    noise = torch.from_numpy(np.array(
        jax.random.normal(jax.random.fold_in(state.rng, state.step), (8, 16))))
    new, _ = jax.jit(jm.train_step_fn)(state, jnp.asarray(x))
    ref = gan_params_from_jax(_np(new.params), _np(new.extra))

    gen, disc = model.net.gen, model.net.disc
    with torch.no_grad():
        h = gen.deconvs[0](noise[:, :, None, None])
        fake = gen(noise, True).permute(0, 3, 1, 2)
        first = lambda img: disc.convs[1](torch.nn.functional.leaky_relu(disc.convs[0](img), 0.01))
        d_real, d_fake = first(torch.from_numpy(x).permute(0, 3, 1, 2)), first(fake)
    stats = lambda a: (a.mean((0, 2, 3)), a.var((0, 2, 3), unbiased=False))
    close = lambda got, want: np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                                         atol=1e-6)
    far = lambda got, want: float((got - want).abs().max()) > 10 * (1e-6 + 1e-5 * float(
        want.abs().max()))

    m, v = stats(h)
    n = h.shape[0] * h.shape[2] * h.shape[3]
    close(ref['gen.bns.0.mean'], 0.1 * m)
    close(ref['gen.bns.0.var'], 0.9 + 0.1 * v)
    assert far(0.9 + 0.1 * v * n / (n - 1), ref['gen.bns.0.var'])  # torch's unbiased
    assert far(0.9 * (0.9 + 0.1 * v) + 0.1 * v, ref['gen.bns.0.var'])  # moved twice
    (mr, vr), (mf, vf) = stats(d_real), stats(d_fake)
    close(ref['disc.bns.0.mean'], 0.9 * 0.1 * mr + 0.1 * mf)
    close(ref['disc.bns.0.var'], 0.9 * (0.9 + 0.1 * vr) + 0.1 * vf)
    assert far(0.1 * mr, ref['disc.bns.0.mean'])  # moved once
    model.train_step(x, noise=noise)
    for key in ('gen.bns.0.mean', 'gen.bns.0.var', 'disc.bns.0.mean', 'disc.bns.0.var'):
        close(model.net.state_dict()[key], ref[key])


def test_sample_fn_and_the_served_range_match_jax():
    jm = _jax_model()
    state = jm.state
    model = _port(state)
    rng = jax.random.key(9)
    ref = np.asarray(jm.sample_fn(state, 16, rng))
    noise = torch.from_numpy(np.array(jax.random.normal(rng, (16, 16))))
    with torch.no_grad():
        got = model.sample_fn(16, noise=noise).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got.min() < 0 and model.SAMPLE_RANGE == (-1.0, 1.0)
    server = SampleServer(model, serve_bs=16)
    served = server.sample(16, seed=4)
    with torch.no_grad():
        native = model.sample_fn(16, generator=torch.Generator().manual_seed(4)).numpy()
    np.testing.assert_allclose(served, (native + 1) / 2, rtol=0, atol=1e-7)
    assert 0 <= served.min() and served.max() <= 1
    # eval_heavy's samples stay in the native range, as the test set's
    assert float(model.sample_images(64).min()) < 0


def test_gan_trains_through_the_cli_and_spectral_norm_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(tm, 'TRAIN_N', 32)
    monkeypatch.setattr(tm, 'TEST_N', 16)
    with contextlib.redirect_stdout(io.StringIO()):
        history = main(FLAGS + ['--device=cpu', '--bs=8', '--epochs=1', '--save_n=1',
                                '--data_source=synthetic', f'--logdir={tmp_path}'])
    assert {k for k in history[1] if k.startswith('gan/')} == {
        'gan/train/disc/loss', 'gan/train/disc/loss_fake', 'gan/train/disc/loss_real',
        'gan/train/gen/loss'}
    assert all(np.isfinite(v) for h in history for v in h.values())
    state = torch.load(tmp_path / 'model.pt', weights_only=True)
    assert {'opt', 'disc_opt'} <= set(state) and state['step'] == 4
    assert not torch.equal(state['net']['gen.bns.0.var'], torch.ones(8))
    G, Model = parse_args([f'--weights_from={tmp_path / "model.pt"}', '--device=cpu'])
    model = Model(G)
    model.load_weights(G.weights_from)
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, state['net'][k]), k
    # --spectral_norm=1 trains through the CLI too, and its u and sigma
    # round-trip through model.pt
    with contextlib.redirect_stdout(io.StringIO()):
        main(FLAGS + ['--device=cpu', '--bs=8', '--epochs=1', '--save_n=1', '--spectral_norm=1',
                      '--data_source=synthetic', f'--logdir={tmp_path / "sn"}'])
    state = torch.load(tmp_path / 'sn' / 'model.pt', weights_only=True)
    assert not torch.equal(state['net']['disc.sns.1.sigma'], torch.ones(()))
    G, Model = parse_args([f'--weights_from={tmp_path / "sn" / "model.pt"}', '--device=cpu'])
    model = Model(G)
    model.load_weights(G.weights_from)
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, state['net'][k]), k


def test_spectral_norm_pass_and_gradients_match_jax():
    """One discriminator pass in train mode from the JAX init's u: logits,
    the u and sigma it stores, and every gradient of the real-batch BCE."""
    jm = _jax_model('--spectral_norm=1')
    state = jm.state
    model = _port(state, '--spectral_norm=1')
    x = _batch(seed=3)

    def loss_fn(p):
        logits, mut = jm._disc_apply(p, state.extra['disc'], jnp.asarray(x), True)
        return bce_with_logits_jax(logits, jnp.ones(8)), (logits, mut['batch_stats'])

    (ref_loss, (ref_logits, ref_stats)), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params['disc'])
    disc = model.net.disc
    logits = disc(torch.from_numpy(x), True, True)
    loss = torch.mean(-torch.nn.functional.logsigmoid(logits))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), rtol=1e-5,
                               atol=1e-6)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    ref = gan_params_from_jax({'disc': _np(ref_grads)}, {'disc': _np(ref_stats)})
    sd = model.net.state_dict()
    for i in range(4):
        for leaf in ('u', 'sigma'):
            key = f'disc.sns.{i}.{leaf}'
            np.testing.assert_allclose(sd[key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
    total = float(torch.sqrt(sum((ref[f'disc.{n}'].double() ** 2).sum()
                                 for n, _ in disc.named_parameters())))
    for name, p in disc.named_parameters():
        want = ref[f'disc.{name}'].double()
        err = float(torch.linalg.vector_norm(p.grad.double() - want))
        assert err <= 1e-5 * float(torch.linalg.vector_norm(want)) + 1e-7 * total, name
