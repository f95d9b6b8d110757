"""The port's MADE (generative_models_tpu_torch/models/made.py) against the
JAX package's on the CPU at hidden_size=64: the masks bit-equal; the
autoregressive Jacobian on every route; weights from a JAX init carried
over by convert.made_params_from_jax, then the loss on all three routes
(premasked, fold-the-mask, and the kernel route against the Pallas
MaskedMLP in interpret mode), every gradient, and Adam steps (plain, with
--grad_accum=2, with --grad_clip=0.1); sampling from the JAX sampler's own
uniforms; the checkpoint round trip with the premasked zeroing; and the
training and serving CLIs."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import generative_models_tpu_torch.data.mnist as tm
from generative_models_tpu.models.made import MaskedMLP as JaxMaskedMLP
from generative_models_tpu.models.made import create_made_masks as jax_masks
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch import serve
from generative_models_tpu_torch.convert import made_params_from_jax
from generative_models_tpu_torch.main import main
from generative_models_tpu_torch.models.made import MADE, MaskedMLP, create_made_masks
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

FLAGS = ['--model=made', '--hidden_size=64']
NIN, H = 784, 64


def _jax_model(tmp_path_factory, *flags):
    G, Model = jax_parse_args(
        FLAGS + list(flags) + [f'--logdir={tmp_path_factory.mktemp("jax")}'],
        discover_models=jax_models,
    )
    return Model(G)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(params=None, *flags, kernel=False, monkeypatch=None):
    """The port's MADE on the CPU; kernel=True builds the kernel route
    (MaskedDense, the plain versions of Kernels G and H on the CPU), which
    the gate gives only on the card."""
    if kernel:
        monkeypatch.setattr(MADE, 'use_kernel_route', lambda self: True)
    G, Model = parse_args(FLAGS + ['--device=cpu', *flags])
    model = Model(G)
    assert model.net.use_kernel == kernel
    if params is not None:
        model.net.load_state_dict(made_params_from_jax(params))
    return model


def _batch(B=4, seed=0):
    return (np.random.RandomState(seed).rand(B, 28, 28, 1) > 0.6).astype(np.float32)


@pytest.mark.parametrize('seed', [42, 3 + 42])
def test_masks_are_bit_equal_to_jax(seed):
    got = create_made_masks(NIN, (H,) * 3, seed)
    ref = jax_masks(NIN, (H,) * 3, seed)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(r))


def test_model_masks_follow_the_seed_as_the_jax_model(tmp_path_factory):
    jmodel = _jax_model(tmp_path_factory, '--seed=3')
    model = _port(None, '--seed=3')
    for i, r in enumerate(jmodel.masks):
        np.testing.assert_array_equal(getattr(model.net, f'm{i}').numpy(), np.asarray(r))


@pytest.mark.parametrize('route', ['premasked', 'fold', 'kernel'])
def test_mask_causality_jacobian(route):
    """Output i depends only on inputs j < i (tests/test_made.py's check)."""
    nin = 12
    masks = create_made_masks(nin, (24, 24), seed=3)
    net = MaskedMLP(nin, (24, 24), nin, masks, use_kernel=route == 'kernel',
                    premasked=route == 'premasked')
    with torch.no_grad():
        net.flax_init(torch.Generator().manual_seed(0))
    jac = torch.autograd.functional.jacobian(lambda x: net(x[None])[0], torch.full((nin,), 0.5))
    for i in range(nin):
        assert not jac[i, i:].any(), f'output {i} sees the future'
    assert jac.any()


@pytest.mark.parametrize('route', ['premasked', 'fold', 'kernel'])
def test_loss_matches_jax_on_every_route(tmp_path_factory, monkeypatch, route):
    """JAX premasked vs the port's premasked; JAX --premasked=0 (the XLA
    fold) vs the port's fold; the Pallas MaskedMLP (interpret mode) vs the
    port's kernel route."""
    jmodel = _jax_model(tmp_path_factory, *([] if route == 'premasked' else ['--premasked=0']))
    if route == 'kernel':
        jmodel.net = JaxMaskedMLP(hidden_sizes=jmodel.hidden_sizes, nout=NIN,
                                  masks=jmodel.masks, use_pallas=True)
    params = _np(jmodel.state.params)
    if route == 'premasked':  # the JAX init is masked on this route only
        assert not params['w1'][np.asarray(jmodel.masks[1]) == 0].any()
    else:
        assert params['w1'][np.asarray(jmodel.masks[1]) == 0].any()
    model = _port(params, *([] if route == 'premasked' else ['--premasked=0']),
                  kernel=route == 'kernel', monkeypatch=monkeypatch)
    assert model.net.premasked == (route == 'premasked')
    x = _batch(seed=1)
    ref_loss, ref = jmodel.loss(jmodel.state.params, jnp.asarray(x), None, None, False)
    got = model.eval_loss(x)
    assert set(got) == set(ref) == {'nlogp'}
    np.testing.assert_allclose(got['nlogp'], float(ref['nlogp']), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got['nlogp'], float(ref_loss), rtol=1e-5, atol=1e-5)


def _jax_grads(jmodel, x):
    g = jax.grad(lambda p: jmodel.loss(p, jnp.asarray(x), None, None, True)[0])(
        jmodel.state.params)
    return _np(jmodel.transform_grads(g))


CASES = {  # name: (port route, JAX flags, trainer flags)
    'premasked': ('premasked', [], []),
    'premasked_accum': ('premasked', [], ['--grad_accum=2']),
    'premasked_clip': ('premasked', [], ['--grad_clip=0.1']),
    'kernel': ('kernel', ['--premasked=0'], []),
}


@pytest.mark.parametrize('case', list(CASES))
def test_gradients_and_adam_steps_match_jax(tmp_path_factory, monkeypatch, case):
    """The gradients of the first batch (after transform_grads), then every
    parameter after each of two train steps. The kernel route is held
    against JAX --premasked=0: the same function through XLA. With
    --grad_accum=2 and --grad_clip=0.1 the premasked route shows that
    transform_grads acts before the window's mean and before the clip."""
    route, jflags, tflags = CASES[case]
    jmodel = _jax_model(tmp_path_factory, *jflags, *tflags)
    model = _port(_np(jmodel.state.params), *jflags, *tflags, kernel=route == 'kernel',
                  monkeypatch=monkeypatch)
    x0 = _batch(B=4, seed=10)
    ref = _jax_grads(jmodel, x0)
    model.backward(x0)
    model.transform_grads()
    for name, p in model.net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=1e-4, atol=1e-5,
                                   err_msg=f'{case} grad {name}')
        if name.startswith('w'):
            m = getattr(model.net, f'm{name[1:]}').numpy()
            assert not p.grad.numpy()[m == 0].any(), f'{case} {name} grad off the mask'
    for step in range(2):
        x = _batch(B=4, seed=10 + step)
        ref_metrics = jmodel.train_step(jnp.asarray(x))
        metrics = model.train_step(x)
        np.testing.assert_allclose(float(metrics['nlogp']), float(ref_metrics['nlogp']),
                                   rtol=1e-5, atol=1e-5, err_msg=f'{case} step {step}')
        ref = _np(jmodel.state.params)
        for name, v in model.net.state_dict().items():
            if name in ref:
                np.testing.assert_allclose(v.numpy(), ref[name], rtol=1e-4, atol=1e-5,
                                           err_msg=f'{case} step {step} {name}')
    assert model.updates == (1 if '--grad_accum=2' in tflags else 2)
    if route == 'premasked':  # the masked-out weights stay exactly 0
        for i in range(4):
            m = getattr(model.net, f'm{i}').numpy()
            assert not getattr(model.net, f'w{i}').detach().numpy()[m == 0].any()


def _first_divergence(got, ref):
    """(row, pixel) of the first raster-order pixel where each differing row
    of two (n, 784) sample arrays parts."""
    rows = np.nonzero((got != ref).any(1))[0]
    return [(int(r), int(np.argmax(got[r] != ref[r]))) for r in rows]


def test_sampling_matches_jax_from_the_same_uniforms(tmp_path_factory):
    """JAX's sample_fn draws pixel i as uniform(keys[i], (n,)) < p with
    keys = split(rng, 784): the same uniforms handed to the port give the
    same samples and frames. Where a pixel differs, its uniform lies within
    1e-5 of its probability (a tie that f32 rounding may break either
    way)."""
    n, seed = 3, 5
    jmodel = _jax_model(tmp_path_factory)
    rng = jax.random.key(seed)
    ref, ref_frames = jmodel.sample_fn(jmodel.state, n, rng, True)
    keys = jax.random.split(rng, NIN)
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))
    model = _port(_np(jmodel.state.params))
    with torch.no_grad():
        got, frames = model.sample_fn(n, uniforms=torch.from_numpy(u))
        only = model.sample_fn(n, uniforms=torch.from_numpy(u), with_frames=False)
    assert got.shape == (n, 28, 28, 1) and frames.shape == (NIN, n, 28, 28, 1)
    np.testing.assert_array_equal(only.numpy(), got.numpy())
    np.testing.assert_array_equal(frames[-1].numpy(), got.numpy())
    g, r = got.numpy().reshape(n, NIN), np.asarray(ref).reshape(n, NIN)
    for row, i in _first_divergence(g, r):
        canvas = torch.from_numpy(g[row:row + 1].copy())
        canvas[0, i:] = 0
        with torch.no_grad():
            p = float(torch.sigmoid(model.net(canvas)[0, i]))
        assert abs(u[i, row] - p) < 1e-5, (row, i, u[i, row], p)
    if not _first_divergence(g, r):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(frames.numpy(), np.asarray(ref_frames))
    assert 0 < g.mean() < 1


def test_checkpoint_round_trip_and_premasked_zeroing(tmp_path):
    """A premasked checkpoint reloads to the same train state; a fold-route
    checkpoint (live masked-out weights, Adam moments and --grad_accum mean)
    loaded on the premasked route has all three zeroed off the mask."""
    model = _port(None, '--grad_accum=2')
    for s in range(3):
        model.train_step(_batch(B=2, seed=s))
    model.save(tmp_path / 'pre')
    again = _port(None, '--grad_accum=2')
    again.load_weights(tmp_path / 'pre' / 'model.pt')
    assert (again.step, again.updates, again.mini_step) == (3, 1, 1)
    x = _batch(B=2, seed=9)
    model.train_step(x)
    again.train_step(x)
    for k, v in model.net.state_dict().items():
        assert torch.equal(again.net.state_dict()[k], v), k

    # the fold route's gradients are 0 off the mask, so its Adam moments and
    # window mean are too: fill them, as a checkpoint of another route (or
    # of the JAX package's kernel route) may carry live values there
    fold = _port(None, '--premasked=0', '--grad_accum=2')
    for s in range(3):
        fold.train_step(_batch(B=2, seed=s))
    with torch.no_grad():
        for st in fold.opt.state.values():
            st['exp_avg'].fill_(0.5)
            st['exp_avg_sq'].fill_(0.25)
        for a in fold._acc:
            a.fill_(1.0)
    fold.save(tmp_path / 'fold')
    pre = _port(None, '--grad_accum=2')
    pre.load_weights(tmp_path / 'fold' / 'model.pt')
    params = list(pre.net.parameters())
    for i in range(4):
        w, m = getattr(pre.net, f'w{i}'), getattr(pre.net, f'm{i}')
        fw = getattr(fold.net, f'w{i}')
        off = m == 0
        assert fw[off].any() and not w[off].any()
        assert torch.equal(w[~off], fw[~off])
        acc = pre._acc[next(j for j, p in enumerate(params) if p is w)]
        for t, on in ((pre.opt.state[w]['exp_avg'], 0.5), (pre.opt.state[w]['exp_avg_sq'], 0.25),
                      (acc, 1.0)):
            assert not t[off].any() and bool((t[~off] == on).all())


def test_gate_and_routes_on_the_cpu():
    """On the CPU the gate never takes the kernel route; --premasked picks
    between the other two, and the init is masked on the premasked route
    only."""
    # at 2048 the widest layer passes the gate, but the model lies on the CPU
    for flags, premasked in ((['--hidden_size=16'], True),
                             (['--hidden_size=16', '--premasked=0'], False),
                             (['--hidden_size=2048'], True)):
        G, Model = parse_args(['--model=made', '--device=cpu', *flags])
        model = Model(G)
        assert not model.net.use_kernel and model.net.premasked == premasked
        w, m = model.net.w1, model.net.m1
        assert bool(w[m == 0].any()) != premasked


def test_pad32_gives_1024_inputs():
    G, Model = parse_args(FLAGS + ['--device=cpu', '--pad32=1', '--hidden_size=16'])
    model = Model(G)
    assert model.nin == 1024 and model.net.w0.shape == (1024, 16)
    loss, _ = model.loss(torch.from_numpy(
        (np.random.RandomState(0).rand(2, 32, 32, 1) > 0.5).astype(np.float32)))
    assert torch.isfinite(loss)


@pytest.fixture(scope='module')
def cli_run(tmp_path_factory):
    logdir = tmp_path_factory.mktemp('cli')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, 'TRAIN_N', 32)  # 4 steps of 8
        mp.setattr(tm, 'TEST_N', 16)  # 2 eval batches
        with contextlib.redirect_stdout(io.StringIO()):
            history = main(['--model=made', '--device=cpu', '--hidden_size=16', '--bs=8',
                            '--epochs=1', '--save_n=1', '--data_source=synthetic',
                            f'--logdir={logdir}'])
        yield logdir, history


def test_cli_trains_and_serves(cli_run, tmp_path):
    logdir, history = cli_run
    for name in ('model.pt', 'hps.yaml', 'sampling_process_0.gif', 'sampling_process_1.gif'):
        assert (logdir / name).is_file(), name
    assert set(history[0]) == {'eval/nlogp', 'eval/bits_per_dim', 'dt/eval', 'num_vars'}
    assert set(history[1]) == set(history[0]) | {'train/nlogp', 'dt/train'}
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert history[1]['eval/nlogp'] < history[0]['eval/nlogp']
    out = tmp_path / 's.png'
    with contextlib.redirect_stdout(io.StringIO()):
        serve.main([f'--weights_from={logdir / "model.pt"}', '--device=cpu', '--n=2',
                    '--serve_bs=2', f'--out={out}'])
    assert out.read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
    server, G = serve.load_server([f'--weights_from={logdir / "model.pt"}', '--device=cpu',
                                   '--serve_bs=2'])
    assert G.model == 'made' and G.hidden_size == 16
    a, b = server.sample(2, seed=4), server.sample(2, seed=4)
    assert a.shape == (2, 28, 28, 1) and np.isin(a, (0.0, 1.0)).all()
    np.testing.assert_array_equal(a, b)
