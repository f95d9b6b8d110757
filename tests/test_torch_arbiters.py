"""The port's arbiters (generative_models_tpu_torch/models/arbiters/) against
the JAX package's on the CPU.

The shipped weights/autoencoder.pt and weights/classifier.pt (hidden 256,
z 64) load in the port with no jax, flax or msgpack import, and their
features and logits of 64 seeded images in [-1, 1] match the JAX
package's load_arbiter(...).apply, at 28x28 and at 32x32 (--pad32=1, where
the encoder's last map is 2x2 and an NCHW flatten would permute the
features): rtol 1e-4, atol 1e-4 of the largest |value|. A model.jit.pt
saved by either package at hidden 16 loads in the other with the same
features. The arbiters' losses, metrics and gradients match JAX's at
hidden 8 (losses rtol 1e-5; each gradient within 1e-4 of its norm plus
1e-6 of the whole's), and one Adam step on the JAX gradients matches
optax's (atol 1e-6). Both train, save and evaluate through the port's CLI.
"""

import contextlib
import io
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import generative_models_tpu_torch.data.mnist as tm
from generative_models_tpu.models.arbiters import load_arbiter as jax_load_arbiter
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.convert import arbiter_params_from_jax
from generative_models_tpu_torch.main import main
from generative_models_tpu_torch.models.arbiters import load_arbiter
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CLASS = {'autoencoder': 'Autoencoder', 'classifier': 'Classifier'}


def _images(n, size, seed=0):
    rng = np.random.RandomState(seed)
    return np.clip(rng.randn(n, size, size, 1), -1, 1).astype(np.float32)


def _close(got, ref, rtol=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max()))


@pytest.fixture(scope='module')
def jax_arbiters(tmp_path_factory):
    """model.jit.pt files of a JAX Autoencoder and Classifier at hidden 16,
    written by the JAX package's Arbiter.save."""
    root = tmp_path_factory.mktemp('jax_arbiters')
    paths = {}
    for name in CLASS:
        G, Model = jax_parse_args([f'--model={name}', '--hidden_size=16',
                                   f'--logdir={root / name}'], discover_models=jax_models)
        Model(G).save(root / name)
        paths[name] = root / name / 'model.jit.pt'
    return paths


@pytest.mark.parametrize('size', [28, 32])
@pytest.mark.parametrize('name', ['autoencoder', 'classifier'])
def test_the_shipped_arbiters_match_jax(name, size):
    path = REPO / 'weights' / f'{name}.pt'
    x = _images(64, size)
    ref = np.asarray(jax_load_arbiter(path).apply(jnp.asarray(x)))
    handle = load_arbiter(path, 'cpu')
    assert handle.device == torch.device('cpu')
    got = handle.apply(x).numpy()
    feats = {('autoencoder', 28): 64, ('autoencoder', 32): 256,
             ('classifier', 28): 10, ('classifier', 32): 40}[name, size]
    assert got.shape == (64, feats)
    _close(got, ref)


def test_loading_needs_no_jax_flax_or_msgpack():
    """A fresh interpreter loads both shipped arbiters (the payload's G says
    device 'tpu'; the caller's device wins) and imports none of them."""
    code = (
        'import sys, numpy as np\n'
        'from generative_models_tpu_torch.models.arbiters import load_arbiter\n'
        'x = np.zeros((2, 28, 28, 1), np.float32)\n'
        'for n, d in (("autoencoder", 64), ("classifier", 10)):\n'
        '    h = load_arbiter("weights/" + n + ".pt", "cpu")\n'
        '    assert tuple(h.apply(x).shape) == (2, d) and h.model.G.device == "cpu"\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "msgpack")]\n'
        'assert not bad, bad\n'
    )
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True, timeout=300)


@pytest.mark.parametrize('name', ['autoencoder', 'classifier'])
def test_arbiter_files_load_in_both_packages(tmp_path, jax_arbiters, name):
    """JAX's file in the port; the port's (from the JAX weights, saved by
    the port's Arbiter.save) in JAX's load_arbiter, from its directory."""
    x = _images(16, 28, seed=1)
    ref = np.asarray(jax_load_arbiter(jax_arbiters[name]).apply(jnp.asarray(x)))
    port = load_arbiter(jax_arbiters[name], 'cpu')
    _close(port.apply(x).numpy(), ref)
    port.model.save(tmp_path)
    with open(tmp_path / 'model.jit.pt', 'rb') as f:
        payload = pickle.load(f)
    assert payload['class_name'] == CLASS[name] and type(payload['G']) is dict
    assert isinstance(payload['G']['logdir'], str) and payload['G']['hidden_size'] == 16
    back = np.asarray(jax_load_arbiter(tmp_path).apply(jnp.asarray(x)))
    _close(back, ref, rtol=1e-6)


def _jax_model(name, *flags):
    G, Model = jax_parse_args([f'--model={name}', '--hidden_size=8'] + list(flags),
                              discover_models=jax_models)
    return Model(G)


def _port_model(name, params, *flags):
    G, Model = parse_args([f'--model={name}', '--hidden_size=8', '--device=cpu'] + list(flags))
    model = Model(G)
    model.net.load_state_dict(arbiter_params_from_jax(jax.device_get(params), CLASS[name]))
    return model


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.randn(*p.shape).astype(np.float32)),
        params)


@pytest.mark.parametrize('name,flags', [('autoencoder', ()), ('autoencoder', ('--binarize=1',)),
                                        ('classifier', ())])
def test_losses_gradients_and_adam_step_match_jax(name, flags):
    jm = _jax_model(name, *flags)
    params = _perturb(jm.state.params)
    model = _port_model(name, params, *flags)
    x = _images(8, 28, seed=2)
    if '--binarize=1' in flags:
        x = (x > 0).astype(np.float32)
    y = np.array([0, 3, 7, 9, 1, 5, 2, 8], np.int32)
    (ref_loss, ref_metrics), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(y), None, True)
    metrics = model.backward(x, torch.from_numpy(y))
    assert set(metrics) == set(ref_metrics)
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(ref_metrics[k]), rel=1e-5, abs=1e-7), k
    ref = arbiter_params_from_jax(jax.device_get(grads), CLASS[name])
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref.values())))
    for pname, p in model.net.named_parameters():
        err = float(torch.linalg.vector_norm(p.grad.double() - ref[pname].double()))
        norm = float(torch.linalg.vector_norm(ref[pname].double()))
        assert norm > 0 and err <= 1e-4 * norm + 1e-6 * total, (pname, err, norm)

    opt = jm.make_optimizer()
    updates, _ = opt.update(grads, opt.init(params), params)
    stepped = arbiter_params_from_jax(jax.device_get(optax.apply_updates(params, updates)),
                                      CLASS[name])
    for pname, p in model.net.named_parameters():
        p.grad = ref[pname].float().clone()
    model.apply_grads()
    for pname, p in model.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), stepped[pname].numpy(), rtol=0,
                                   atol=1e-6, err_msg=pname)


@pytest.mark.parametrize('name', ['autoencoder', 'classifier'])
def test_arbiters_train_save_and_evaluate_through_the_cli(tmp_path, monkeypatch, name):
    monkeypatch.setattr(tm, 'TRAIN_N', 32)
    monkeypatch.setattr(tm, 'TEST_N', 16)
    with contextlib.redirect_stdout(io.StringIO()):
        history = main([f'--model={name}', '--device=cpu', '--hidden_size=8', '--bs=8',
                        '--epochs=1', '--save_n=1', '--data_source=synthetic',
                        f'--logdir={tmp_path}'])
    keys = {'autoencoder': {'full_loss', 'recon_loss', 'kl_loss', 'z_mean', 'z_std'},
            'classifier': {'cross_entropy_loss'}}[name]
    assert {k.split('/')[-1] for k in history[1] if k.startswith(f'{name}/train/')} == keys
    assert {k.split('/')[-1] for k in history[1] if k.startswith(f'{name}/test/')} == keys
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert (tmp_path / 'model.jit.pt').is_file() and not (tmp_path / 'model.pt').exists()
    assert list(tmp_path.glob('events.out.tfevents.*'))
    handle = load_arbiter(tmp_path, 'cpu')
    assert tuple(handle.apply(_images(2, 28)).shape) == (2, {'autoencoder': 64,
                                                             'classifier': 10}[name])
