"""The port's eval_heavy (generative_models_tpu_torch/main.py) against the
JAX package's (generative_models_tpu/main.py) on the CPU: both read the same
arbiters (a JAX Autoencoder and Classifier at hidden 16, written by the JAX
package's Arbiter.save; the port reads them through its msgpack decoder),
the same synthetic test set (64 images, bs=16: four rounds, then the test
set runs out), and their models' sample_images are replaced by one list of
seeded batches, handed out in the same order. The same eval/* keys come
out with the same values, once on a tiny diffusion model with
--class_cond=1 (the classifier loss and cond_* metrics; the labels each
draw was asked for match too) and once on made without.

Tolerances: the FIDs rtol 1e-3 (f32 eigh); precision, recall and f1
exactly; the classifier loss rtol 1e-5. Then diffusion's default CLI
(--eval_heavy=1, --class_cond=1) runs through the port's main.main, and gan
(samples in [-1, 1]) hands its native range to the autoencoder."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import generative_models_tpu.data.mnist as jm_data
import generative_models_tpu.main as jax_main
import generative_models_tpu_torch.data.mnist as tm
import generative_models_tpu_torch.main as port_main
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils import make_logger as jax_make_logger
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.models.arbiters import ArbiterHandle
from generative_models_tpu_torch.utils import make_logger

torch.set_num_threads(1)

BS, TEST_N = 16, 64
FID_KEYS = ('fid', 'ignite_fid', 'cond_fid')


@pytest.fixture(scope='module')
def jax_arbiters(tmp_path_factory):
    """model.jit.pt files of a JAX Autoencoder and Classifier at hidden 16."""
    root = tmp_path_factory.mktemp('jax_arbiters')
    paths = {}
    for name in ('autoencoder', 'classifier'):
        G, Model = jax_parse_args([f'--model={name}', '--hidden_size=16',
                                   f'--logdir={root / name}'], discover_models=jax_models)
        Model(G).save(root / name)
        paths[name] = root / name / 'model.jit.pt'
    return paths


@pytest.fixture()
def small_test_set(monkeypatch):
    for mod in (jm_data, tm):
        monkeypatch.setattr(mod, 'TRAIN_N', 32)
        monkeypatch.setattr(mod, 'TEST_N', TEST_N)


class Draws:
    """sample_images(n, y=None) handing out seeded batches in order,
    recording the labels each draw was asked for."""

    def __init__(self, batches, wrap):
        self.batches, self.wrap, self.labels = list(batches), wrap, []

    def __call__(self, n, y=None):
        self.labels.append(None if y is None else np.asarray(
            y.cpu() if isinstance(y, torch.Tensor) else y).astype(np.int32).tolist())
        out = self.batches.pop(0)
        assert out.shape[0] == n
        return self.wrap(out)


def _batches(k, binary, seed=0):
    rng = np.random.RandomState(seed)
    if binary:
        return [(rng.rand(BS, 28, 28, 1) > 0.5).astype(np.float32) for _ in range(k)]
    return [np.clip(0.7 * rng.randn(BS, 28, 28, 1), -1, 1).astype(np.float32) for _ in range(k)]


@pytest.mark.parametrize('model,flags', [
    ('diffusion_model', ['--hidden_size=16', '--timesteps=2', '--bf16=0', '--class_cond=1']),
    ('made', ['--hidden_size=32']),
])
def test_eval_heavy_matches_jax(jax_arbiters, small_test_set, tmp_path, model, flags):
    cond = '--class_cond=1' in flags
    common = [f'--model={model}', f'--bs={BS}', '--data_source=synthetic', '--eval_heavy=1',
              f'--autoencoder={jax_arbiters["autoencoder"]}',
              f'--classifier={jax_arbiters["classifier"]}'] + flags
    rounds = TEST_N // BS
    batches = _batches(rounds * (2 if cond else 1), binary=model == 'made')

    with contextlib.redirect_stdout(io.StringIO()):
        jm, jdata, jae, jcls, jG = jax_main.load_model_and_data(
            common + [f'--logdir={tmp_path / "jax"}'])
    jdraws = Draws(batches, jnp.asarray)
    jm.sample_images = jdraws
    ref = jax_make_logger()
    jax_main.eval_heavy(ref, jm, jdata, jae, jcls, jG)

    with contextlib.redirect_stdout(io.StringIO()):
        pm, pdata, pae, pcls, pG = port_main.load_model_and_data(
            common + ['--device=cpu', f'--logdir={tmp_path / "port"}'])
    assert isinstance(pae, ArbiterHandle) and (pcls is not None) == cond
    pdraws = Draws(batches, torch.from_numpy)
    pm.sample_images = pdraws
    got = make_logger()
    port_main.eval_heavy(got, pm, pdata, pae, pcls, pG)

    assert np.array_equal(np.asarray(jdata.test_x), pdata.test_x.numpy())
    assert len(jdraws.labels) == len(pdraws.labels) == len(batches)
    assert jdraws.labels == pdraws.labels
    keys = {'fid', 'ignite_fid', 'precision', 'recall', 'f1'}
    if cond:
        keys |= {'classifier_loss', 'cond_fid', 'cond_precision', 'cond_recall', 'cond_f1'}
        assert pdraws.labels[1] == [-1] * BS and pdraws.labels[0] != [-1] * BS
    assert set(got) == set(ref) == {f'eval/{k}' for k in keys}
    for key in keys:
        g, r = got[f'eval/{key}'], ref[f'eval/{key}']
        assert len(g) == len(r) == 1 and isinstance(g[0], float), key
        if key in FID_KEYS:
            assert g[0] == pytest.approx(r[0], rel=1e-3), key
        elif key == 'classifier_loss':
            assert g[0] == pytest.approx(r[0], rel=1e-5), key
        else:
            assert g[0] == r[0], key
    assert 0 < got['eval/precision'][0] + got['eval/recall'][0]


def test_diffusion_default_cli_runs_eval_heavy(jax_arbiters, small_test_set, tmp_path,
                                               monkeypatch):
    """--eval_heavy=1 and --class_cond=1 are diffusion's defaults: main.main
    loads both arbiters and logs every eval/* key, finite, and
    dt/eval_heavy at the save."""
    monkeypatch.setattr(port_main, 'TOTAL_HEAVY_SAMPLES', 32)  # two rounds
    with contextlib.redirect_stdout(io.StringIO()):
        history = port_main.main([
            '--model=diffusion_model', '--device=cpu', '--hidden_size=16', '--timesteps=2',
            f'--bs={BS}', '--epochs=0', '--data_source=synthetic', f'--logdir={tmp_path}',
            f'--autoencoder={jax_arbiters["autoencoder"]}',
            f'--classifier={jax_arbiters["classifier"]}',
        ])
    keys = {f'eval/{k}' for k in ('fid', 'ignite_fid', 'precision', 'recall', 'f1',
                                  'classifier_loss', 'cond_fid', 'cond_precision',
                                  'cond_recall', 'cond_f1')}
    assert keys | {'dt/eval_heavy'} <= set(history[0])
    assert all(np.isfinite(history[0][k]) for k in keys)
    assert history[0]['eval/fid'] >= 0 and history[0]['eval/ignite_fid'] >= 0


def test_gan_hands_the_autoencoder_its_native_range(jax_arbiters, small_test_set, tmp_path):
    """gan's samples reach the arbiter in [-1, 1], the test set's range
    (binarize=0), not the serving range."""
    with contextlib.redirect_stdout(io.StringIO()):
        model, dataset, ae, cls, G = port_main.load_model_and_data([
            '--model=gan', '--device=cpu', '--hidden_size=8', f'--bs={BS}', '--eval_heavy=1',
            '--data_source=synthetic', f'--logdir={tmp_path}',
            f'--autoencoder={jax_arbiters["autoencoder"]}'])
    seen = []
    apply = ae.apply
    ae.apply = lambda x: (seen.append(x), apply(x))[1]
    logger = make_logger()
    port_main.eval_heavy(logger, model, dataset, ae, cls, G)
    assert cls is None and len(seen) == 2 * TEST_N // BS
    samples = torch.cat(seen[1::2])
    assert float(samples.min()) < 0 and float(dataset.test_x.min()) == -1.0
    assert all(np.isfinite(v[0]) for v in logger.values())
