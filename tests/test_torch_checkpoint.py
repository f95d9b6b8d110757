"""A JAX package's model.pt read into the port (models/base.py
read_checkpoint, GM.load_jax_state) on the CPU: the JAX model takes a step
and saves its TrainState; the port reads that file and both take the next
step on the same batch and draws. The port's params, batch statistics,
spectral-norm state and every Adam moment are then held against the JAX
package's next TrainState, read through the same converters
(convert.*_from_jax), and the step counters against its step and Adam
counts, each restored step counter on the CPU.

Cases here: made with plain Adam, --grad_clip and --grad_accum=2 (saved in
the middle of the accumulation window); pixel_transformer and vqvae (two
Adams); gan with and without --spectral_norm=1 (two Adams, batch_stats and
SpectralNorm's u and sigma); then a tree that does not fit the model, and one that is no
TrainState, are refused, and chip_smoke.py's writer of a TrainState is
held to the JAX package's bytes. test_torch_checkpoint_models.py holds the
other models with these helpers.

Tolerances (f32 on both sides): params rtol 1e-4, atol 1e-5, and for the
parameters whose exact gradient is 0 2 lr a step, as Adam moves them on
rounding: attention's key bias, the conv biases in front of a train-mode
BatchNorm and, in the diffusion UNet at hidden_size=32 (GroupNorm's 32
groups are one channel each), every per-channel constant in front of a
GroupNorm (each ResBlock's conv0 bias and embedding projection, the three
embedding MLPs, the last block's output biases); each moment within 1e-4
of its norm plus 1e-8, those of the zero-gradient parameters within 1e-5
of the whole moment's norm."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.models.base import jax_adam_state, read_checkpoint
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

CASES = {
    'made': ['--model=made', '--hidden_size=16'],
    'made_clip': ['--model=made', '--hidden_size=16', '--grad_clip=0.01'],
    'made_accum': ['--model=made', '--hidden_size=16', '--grad_accum=2'],
    'pixel_transformer': ['--model=pixel_transformer', '--n_layer=1', '--n_embed=16',
                          '--n_head=2'],
    'vqvae': ['--model=vqvae', '--hidden_size=16', '--vqD=8', '--vqK=16', '--n_layer=1',
              '--n_embed=32', '--n_head=2'],
}
# parameters whose exact gradient is 0: the step moves them by rounding
ZERO_GRAD = re.compile(r'.*(attn\.key\.bias|gen\.deconvs\.[012]\.bias|disc\.convs\.[12]\.bias)$')
UNET_ZERO_GRAD = re.compile(
    r'(blocks\.\d+\.(conv0\.bias|dense\..*)|\w+_embed\..*|blocks\.11\.(conv1|skip)\.bias)$')


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_model(flags, logdir):
    G, Model = jax_parse_args(flags + [f'--logdir={logdir}'], discover_models=jax_models)
    return Model(G)


def _port(flags):
    G, Model = parse_args(flags + ['--device=cpu'])
    return Model(G)


def _batch(binarize=True, B=4, seed=0):
    x = np.random.RandomState(seed).rand(B, 28, 28, 1).astype(np.float32)
    return (x > 0.5).astype(np.float32) if binarize else 2 * x - 1


def _next_state(jm, tmp_path):
    """The JAX model's TrainState as the port reads it from a model.pt."""
    jm.save(tmp_path / 'next')
    return read_checkpoint(tmp_path / 'next' / 'model.pt')


def _check_against(model, ref, flags, zero_grad=ZERO_GRAD):
    """The port's net and every optimizer against the JAX TrainState ref."""
    lrs = [float(g['lr']) for o in model.optimizers().values() for g in o.param_groups]
    steps = int(ref['step'])
    want = model.net_state_from_jax(ref)
    for name, v in model.net.state_dict().items():
        tol = (dict(rtol=0, atol=2 * max(lrs) * steps * (1 + 1e-6)) if zero_grad.match(name)
               else dict(rtol=1e-4, atol=1e-5))
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), err_msg=f'{flags} {name}', **tol)
    names = {id(p): n for n, p in model.net.named_parameters()}
    for opt, opt_state, conv in model.jax_optimizers(ref['opt_state']):
        adam = jax_adam_state(opt_state)
        mu, nu = conv(adam['mu']), conv(adam['nu'])
        whole = {k: float(torch.sqrt(sum((m.double() ** 2).sum() for m in mom.values())))
                 for k, mom in (('exp_avg', mu), ('exp_avg_sq', nu))}
        for p in (p for g in opt.param_groups for p in g['params']):
            st, name = opt.state[p], names[id(p)]
            assert st['step'].device.type == 'cpu' and float(st['step']) == float(adam['count'])
            for key, r in (('exp_avg', mu[name]), ('exp_avg_sq', nu[name])):
                err = float(torch.linalg.vector_norm(st[key].double() - r.double()))
                bound = (1e-5 * whole[key] if zero_grad.match(name)
                         else 1e-4 * float(torch.linalg.vector_norm(r.double())) + 1e-8)
                assert err <= bound, (flags, name, key, err)


def _draws(jm, name, x):
    """The keyword draws of the JAX package's next train step: vae's
    posterior noise from fold_in(rng, step), as its train_step_fn draws
    it."""
    if name != 'vae':
        return {}
    rng = jax.random.fold_in(jm.state.rng, jm.state.step)
    return {'eps': torch.from_numpy(np.array(jax.random.normal(rng, (x.shape[0],
                                                                     int(jm.G.z_size)))))}


def step_after_jax(flags, name, tmp_path):
    """The JAX model steps and saves; the port reads its model.pt; both
    take the next step; the port is held against the JAX TrainState."""
    jm = _jax_model(flags, tmp_path / 'jax')
    binarize = int(jm.G.binarize)
    jm.train_step(jnp.asarray(_batch(binarize, seed=1)), None)
    jm.save(tmp_path / 'jax')
    model = _port(flags)
    model.load_weights(tmp_path / 'jax' / 'model.pt')
    accum = name == 'made_accum'
    assert (model.step, model.updates, model.mini_step) == (1, 0 if accum else 1, int(accum))

    x = _batch(binarize, seed=2)
    draws = _draws(jm, name, x)
    jm.train_step(jnp.asarray(x), None)
    model.train_step(x, **draws)
    ref = _next_state(jm, tmp_path)
    assert (model.step, model.updates, model.mini_step) == (2, 1 if accum else 2, 0)
    _check_against(model, ref, flags)


@pytest.mark.parametrize('name', sorted(CASES))
def test_jax_checkpoint_steps_as_the_jax_package(name, tmp_path):
    step_after_jax(CASES[name], name, tmp_path)


@pytest.mark.parametrize('spectral', [0, 1], ids=['bn', 'spectral_norm'])
def test_gan_jax_checkpoint_steps_as_the_jax_package(spectral, tmp_path):
    """Both Adams, the batch_stats and, with --spectral_norm=1,
    SpectralNorm_i's u and sigma carried over; the next twin step on the
    JAX step's noise."""
    flags = ['--model=gan', '--hidden_size=8', '--noise_size=16', f'--spectral_norm={spectral}']
    jm = _jax_model(flags, tmp_path / 'jax')
    jm.train_step(jnp.asarray(_batch(False, B=8, seed=1)), None)
    jm.save(tmp_path / 'jax')
    model = _port(flags)
    model.load_weights(tmp_path / 'jax' / 'model.pt')
    assert (model.net.disc.sns is not None) == bool(spectral)
    x = _batch(False, B=8, seed=2)
    noise = np.array(jax.random.normal(jax.random.fold_in(jm.state.rng, jm.state.step), (8, 16)))
    jm.train_step(jnp.asarray(x), None)
    model.train_step(x, noise=torch.from_numpy(noise))
    _check_against(model, _next_state(jm, tmp_path), flags)


def test_a_tree_that_does_not_fit_is_refused(tmp_path):
    """A made TrainState read into a pixel_transformer, or a tree with
    params alone, is refused with a ValueError that says why."""
    jm = _jax_model(CASES['made'], tmp_path / 'jax')
    jm.save(tmp_path / 'jax')
    with pytest.raises(ValueError, match='does not fit PixelTransformer'):
        _port(CASES['pixel_transformer']).load_weights(tmp_path / 'jax' / 'model.pt')
    (tmp_path / 'bad.pt').write_bytes(b'\x81\xa6params\x80')
    with pytest.raises(ValueError, match='not a JAX TrainState'):
        _port(CASES['made']).load_weights(tmp_path / 'bad.pt')
    (tmp_path / 'text.pt').write_bytes(b'hello')
    with pytest.raises(ValueError, match='neither a torch checkpoint nor a JAX'):
        _port(CASES['made']).load_weights(tmp_path / 'text.pt')


@pytest.mark.parametrize('name', ['made', 'pixel_transformer'])
def test_chip_smokes_flax_train_state_is_the_jax_packages_bytes(name, tmp_path):
    """chip_smoke.py's jax_ckpt phase writes a TrainState on the card
    without JAX (flax_train_state_bytes, the port's msgpack writer and its
    own transpose back to flax's layout): from the weights, moments and
    counters the port read from a JAX package's model.pt, and the JAX
    key's raw data, it writes that model.pt again byte for byte."""
    import chip_smoke

    jm = _jax_model(CASES[name], tmp_path / 'jax')
    jm.train_step(jnp.asarray(_batch(seed=1)), None)
    jm.train_step(jnp.asarray(_batch(seed=2)), None)
    jm.save(tmp_path / 'jax')
    model = _port(CASES[name])
    model.load_weights(tmp_path / 'jax' / 'model.pt')
    to_flax = {'made': chip_smoke.made_params_to_flax,
               'pixel_transformer': chip_smoke.pixel_transformer_params_to_flax}[name]
    rng = tuple(int(v) for v in np.asarray(jax.random.key_data(jm.state.rng)))
    blob = chip_smoke.flax_train_state_bytes(model, to_flax, rng)
    assert blob == (tmp_path / 'jax' / 'model.pt').read_bytes()
