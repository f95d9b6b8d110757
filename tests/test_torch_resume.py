"""--resume=1 (generative_models_tpu_torch/main.py) on the CPU: a run cut
after one epoch and started again with the same command trains exactly the
uninterrupted run, as the JAX package's tests/test_checkpoint.py asks of
its own: RESUMED <logdir> at step N and RESUMING at epoch E printed, the
parameters, every Adam state and the logged metrics of the epochs after
the cut bitwise equal, best.json kept. vae draws its posterior noise from
the model's generator each step (kept in model.pt) and samples in
evaluate from another stream; under --grad_accum=2 the step still counts
micro-steps. A first run with --resume=1 starts fresh, and a model.pt
written before the generator's state was kept still loads."""

import contextlib
import io
import json

import pytest
import torch

import generative_models_tpu_torch.data.mnist as tm
from generative_models_tpu_torch.main import main
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

CASES = {
    'vae': ['--model=vae', '--hidden_size=16', '--keep_best=vae/test/vae_loss'],
    'made_accum': ['--model=made', '--hidden_size=16', '--grad_accum=2', '--keep_best=nlogp'],
}


def _run(logdir, flags, *more):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        history = main(['--device=cpu', '--bs=16', '--save_n=1', '--data_source=synthetic',
                        '--eval_heavy=0', f'--logdir={logdir}', *flags, *more])
    return history, out.getvalue()


def _state(logdir):
    return torch.load(logdir / 'model.pt', weights_only=True)


@pytest.mark.parametrize('name', sorted(CASES))
def test_a_resumed_run_is_the_uninterrupted_run(name, tmp_path, monkeypatch):
    monkeypatch.setattr(tm, 'TRAIN_N', 64)  # 4 steps an epoch at bs=16
    monkeypatch.setattr(tm, 'TEST_N', 32)
    flags = CASES[name]
    ref_hist, _ = _run(tmp_path / 'ref', flags, '--epochs=3')
    first, out1 = _run(tmp_path / 'cut', flags, '--epochs=1', '--resume=1')
    assert 'RESUMED' not in out1  # nothing to resume yet: a fresh start
    hist, out2 = _run(tmp_path / 'cut', flags, '--epochs=3', '--resume=1')
    assert f'RESUMED {tmp_path / "cut"} at step 4' in out2
    assert 'RESUMING at epoch 1' in out2  # 4 micro-steps / 4 steps an epoch

    ref, got = _state(tmp_path / 'ref'), _state(tmp_path / 'cut')
    assert (got['step'], got['updates'], got['mini_step']) == (
        ref['step'], ref['updates'], ref['mini_step']) == (12, 6 if 'accum' in name else 12, 0)
    for k, v in ref['net'].items():
        assert torch.equal(got['net'][k], v), k
    for a, b in zip(ref['opt']['state'].values(), got['opt']['state'].values()):
        for key in ('step', 'exp_avg', 'exp_avg_sq'):
            assert torch.equal(a[key], b[key]), key
    assert torch.equal(ref['gen_state'], got['gen_state'])
    drop = lambda h: {k: v for k, v in h.items() if not k.startswith('dt/')}
    # the uninterrupted run's epochs 1-3 against the resumed run's; a log
    # line holds the train metrics of the epoch before, which the resumed
    # process did not train
    evals = lambda h: {k: v for k, v in drop(h).items() if 'train' not in k}
    assert evals(hist[0]) == evals(ref_hist[1])
    assert [drop(h) for h in hist[1:]] == [drop(h) for h in ref_hist[2:]]
    assert json.loads((tmp_path / 'cut' / 'best.json').read_text()) == json.loads(
        (tmp_path / 'ref' / 'best.json').read_text())


def test_weights_from_wins_and_an_older_checkpoint_loads(tmp_path, monkeypatch):
    monkeypatch.setattr(tm, 'TRAIN_N', 32)
    monkeypatch.setattr(tm, 'TEST_N', 16)
    flags = CASES['vae']
    _run(tmp_path / 'a', flags, '--epochs=1')
    state = _state(tmp_path / 'a')
    del state['gen_state']  # a model.pt of an earlier port
    torch.save(state, tmp_path / 'a' / 'model.pt')
    G, Model = parse_args([f'--weights_from={tmp_path / "a" / "model.pt"}', '--device=cpu'])
    model = Model(G)
    model.load_weights(G.weights_from)
    assert model.step == 2
    # --weights_from is read, not logdir/model.pt
    _, out = _run(tmp_path / 'b', flags, '--epochs=1', '--resume=1',
                  f'--weights_from={tmp_path / "a" / "model.pt"}')
    assert 'RESUMED' not in out and 'RESUMING at epoch 1' in out
