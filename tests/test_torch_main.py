"""The port's training CLI (generative_models_tpu_torch/main.py) on the CPU
at a tiny size (n_layer=1, n_embed=16, bs=8, one epoch on 64 synthetic
images): the artifacts and logger keys of the JAX package's CLI,
--keep_best, --weights_from of the full train state and of a params-only
state dict, --nan_guard, the flags still refused, and the sampling-process GIF
against the JAX package's. About 30 s here."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

import generative_models_tpu_torch.data.mnist as tm
from generative_models_tpu.utils.logger import write_gridvid as jax_write_gridvid
from generative_models_tpu_torch.main import load_model_and_data, main
from generative_models_tpu_torch.utils.config import parse_args
from generative_models_tpu_torch.utils.logger import write_gridvid

torch.set_num_threads(1)

TINY = ['--model=pixel_transformer', '--device=cpu', '--n_layer=1', '--n_embed=16',
        '--n_head=2', '--bs=8', '--data_source=synthetic']


@pytest.fixture(scope='module')
def small_data():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, 'TRAIN_N', 64)  # 8 steps of 8
        mp.setattr(tm, 'TEST_N', 16)  # 2 eval batches
        yield


@pytest.fixture(scope='module')
def run(tmp_path_factory, small_data):
    logdir = tmp_path_factory.mktemp('cli')
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        history = main(TINY + ['--epochs=1', '--save_n=1', '--keep_best=nlogp',
                               f'--logdir={logdir}'])
    return logdir, history, out.getvalue()


def test_cli_writes_the_jax_artifacts_and_keys(run):
    logdir, history, stdout = run
    for name in ('model.pt', 'hps.yaml', 'sampling_process_0.gif', 'sampling_process_1.gif'):
        assert (logdir / name).is_file(), name
    assert len(history) == 2  # epoch 0 (eval only) and epoch 1
    assert set(history[0]) == {'eval/nlogp', 'eval/bits_per_dim', 'dt/eval', 'num_vars'}
    assert set(history[1]) == set(history[0]) | {'train/nlogp', 'dt/train'}
    for key in history[1]:
        assert f'\n{key} ' in stdout, key
    assert history[1]['eval/bits_per_dim'] == pytest.approx(history[1]['eval/nlogp'] / np.log(2))
    assert history[1]['eval/nlogp'] < history[0]['eval/nlogp']
    assert all(np.isfinite(v) for h in history for v in h.values())
    hps = (logdir / 'hps.yaml').read_text()
    assert 'model: pixel_transformer' in hps and 'full_cmd:' in hps


def test_keep_best_writes_model_best_and_best_json(run):
    logdir, history, _ = run
    best = json.loads((logdir / 'best.json').read_text())
    assert best == {'metric': 'eval/nlogp', 'value': history[1]['eval/nlogp'], 'epoch': 1}
    assert (logdir / 'model_best.pt').is_file()


def test_weights_from_restores_the_full_train_state(run, small_data):
    logdir, _, _ = run
    model, dataset, _, _, G = load_model_and_data([f'--weights_from={logdir / "model.pt"}',
                                             '--device=cpu'])
    saved = torch.load(logdir / 'model.pt', weights_only=True)
    assert (model.step, model.updates) == (8, 8) == (saved['step'], saved['updates'])
    assert G.n_embed == 16 and dataset.steps_per_epoch == 8  # hps.yaml reloaded
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, saved['net'][k]), k
    assert model.opt.state_dict()['state'][0]['exp_avg'].abs().sum() > 0
    # a params-only state dict (the model.pt that this package wrote before
    # it could train) still loads, for serving too
    from generative_models_tpu_torch.serve import load_server

    torch.save(saved['net'], logdir / 'params_only.pt')
    server, _ = load_server([f'--weights_from={logdir / "params_only.pt"}', '--device=cpu'])
    for k, v in server.model.net.state_dict().items():
        assert torch.equal(v, saved['net'][k]), k
    assert server.model.step == 0


def test_nan_guard_raises_on_a_nan(tmp_path, small_data, monkeypatch):
    monkeypatch.setattr(tm, 'TRAIN_N', 16)  # step 2 sees the blown-up weights
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(FloatingPointError, match='non-finite train metrics'):
            main(TINY + ['--epochs=1', '--lr=1e30', f'--logdir={tmp_path}'])


@pytest.mark.parametrize('flag', ['--ckpt=orbax', '--fsdp=1', '--export=a.bin',
                                  '--from_export=a.bin'])
def test_unported_training_flags_raise(flag):
    """The flags still refused by name; --export and --from_export (serving
    flags, parsed with the server's defaults) are ported and parse, and so
    does --fsdp=1, which a model refuses without a process group, naming
    torchrun."""
    from generative_models_tpu_torch.serve import serve_defaults

    if flag.startswith(('--export', '--from_export', '--fsdp')):
        G, Model = parse_args(TINY + [flag], DG=serve_defaults())
        key, val = flag[2:].split('=')
        assert str(G[key]) == val if key == 'fsdp' else str(G[key]) == 'a.bin'
        if key == 'fsdp':
            with pytest.raises(RuntimeError, match='torchrun'):
                Model(G)
        return
    with pytest.raises(NotImplementedError, match='not ported yet'):
        parse_args(TINY + [flag], DG=serve_defaults())


def test_jit_epoch_is_accepted():
    G, _ = parse_args(TINY + ['--jit_epoch=0'])
    assert G.jit_epoch == 0


def _gif_frames(path):
    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert('L')))
    return np.stack(frames)


def test_sampling_process_gif_decodes_to_the_jax_frames(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.rand(6, 25, 28, 28, 1).astype(np.float32)
    x[:, :, :4] = (x[:, :, :4] > 0.5)  # binary rows, as the sampler draws
    jax_write_gridvid(None, 'sampling_process', x, 3, logdir=tmp_path / 'jax')
    write_gridvid(None, 'sampling_process', x, 3, logdir=tmp_path / 'port')
    ref = _gif_frames(tmp_path / 'jax' / 'sampling_process_3.gif')
    got = _gif_frames(tmp_path / 'port' / 'sampling_process_3.gif')
    assert got.shape == ref.shape == (6, 140, 140)
    np.testing.assert_array_equal(got, ref)


# tests/test_smoke.py's sizes for the models whose samplers decode a pixel
# a step (784 steps)
AR_FLAGS = {
    'rnn': ['--hidden_size=16'],
    'wavenet': ['--hidden_size=8'],
    'pixel_cnn': ['--n_filters=8', '--n_layers=2', '--kernel_size=3'],
    'gated_pixel_cnn': ['--n_filters=8', '--n_layers=3', '--kernel_size=3'],
}
# each model's own defaults (its DG), which hps.yaml must carry back
AR_DG = {
    'rnn': {'append_loc': 1, 'hidden_size': 256},
    'wavenet': {'use_resblock': 1, 'hidden_size': 320},
    'pixel_cnn': {'use_resblock': 0, 'n_filters': 128, 'bf16': 0, 'lr': 1e-4},
    'gated_pixel_cnn': {'use_resblock': 0, 'n_filters': 96, 'bf16': 0, 'lr': 1e-4},
}


@pytest.mark.parametrize('name', sorted(AR_FLAGS))
def test_raster_models_train_save_reload_and_draw_the_gif(name, tmp_path, small_data):
    """One epoch of rnn, wavenet, pixel_cnn or gated_pixel_cnn through the
    CLI: the logger keys and artifacts of the autoregressive models, a
    falling eval/nlogp, hps.yaml reloaded with the model's own defaults,
    and the sampling GIF: one 5x5 grid a decode step, its last frame the
    grid of a complete sample (binary)."""
    G0, _ = parse_args([f'--model={name}', '--device=cpu'])
    assert {k: G0[k] for k in AR_DG[name]} == AR_DG[name]
    with contextlib.redirect_stdout(io.StringIO()):
        history = main([f'--model={name}', '--device=cpu', '--bs=8', '--epochs=1', '--save_n=1',
                        '--data_source=synthetic', f'--logdir={tmp_path}'] + AR_FLAGS[name])
    assert set(history[1]) == {'eval/nlogp', 'eval/bits_per_dim', 'dt/eval', 'num_vars',
                               'train/nlogp', 'dt/train'}
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert history[1]['eval/nlogp'] < history[0]['eval/nlogp']
    for f in ('model.pt', 'hps.yaml', 'sampling_process_0.gif', 'sampling_process_1.gif'):
        assert (tmp_path / f).is_file(), f
    model, _, _, _, G = load_model_and_data([f'--weights_from={tmp_path / "model.pt"}',
                                             '--device=cpu'])
    assert G.model == name and type(model).__name__ == type(parse_args(
        [f'--model={name}', '--device=cpu'])[1](G0)).__name__
    for flag in AR_FLAGS[name]:
        key, val = flag[2:].split('=')
        assert G[key] == int(val), key
    assert {k: G[k] for k in AR_DG[name] if k not in dict(f[2:].split('=') for f in AR_FLAGS[name])
            } == {k: v for k, v in AR_DG[name].items()
                  if k not in dict(f[2:].split('=') for f in AR_FLAGS[name])}
    assert (model.step, model.updates) == (8, 8)
    frames = _gif_frames(tmp_path / 'sampling_process_1.gif')
    assert frames.shape == (784, 140, 140)
    assert set(np.unique(frames[-1])) <= {0, 255} and frames[0].sum() <= frames[-1].sum()
