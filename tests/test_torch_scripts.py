"""The port's orchestration layer (generative_models_tpu_torch/scripts/) on
the CPU: each JAX shell script, run from a copy with a fake python that
records its argv, against its module's commands(); one stage of the
distillation chain run in process against the same stage run by
`python -m generative_models_tpu_torch.main`, model.pt bitwise; a tiny end
to end (arbiters, the ten-stage chain, its eval, collect and latency) on a
16-image idx set with every chain sampled in 2 steps; collect_distill's
refusal of an empty chain; a distilled student reloaded by --weights_from.
About 70 s on one core."""

import gzip
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from generative_models_tpu_torch.main import load_model_and_data
from generative_models_tpu_torch.models.base import read_checkpoint
from generative_models_tpu_torch.scripts import (
    CHAIN_STAGES, collect_distill, distill_latency, eval_distill_chain, eval_no_progressive,
    progressive_distillation, run_all, train_arbiters,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SHIPPED = [ROOT / 'weights' / 'autoencoder.pt', ROOT / 'weights' / 'classifier.pt']
ENV_KEYS = ('LOGROOT', 'EPOCHS', 'EPOCHS_TEACHER', 'EPOCHS_STUDENT', 'WEIGHTS_DIR')
FAKE_PYTHON = f"""#!{sys.executable}
import json, os, sys
from pathlib import Path
argv = sys.argv[1:]
with open(os.environ['FAKE_PYTHON_LOG'], 'a') as f:
    f.write(json.dumps(argv) + '\\n')
for a in argv:
    if a.startswith('--logdir='):
        d = Path(a.split('=', 1)[1])
        d.mkdir(parents=True, exist_ok=True)
        for name in ('model.pt', 'hps.yaml', 'model.jit.pt'):
            (d / name).touch()
"""


def sha256(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def run_jax_script(tmp_path, script, args=(), env=None):
    """script (run_all.sh or scripts/<name>.sh) run from a copy of the repo's
    scripts under tmp_path, a fake python first on PATH: the argv of each
    python call, in order."""
    copy = tmp_path / 'copy'
    if not copy.exists():
        (copy / 'scripts').mkdir(parents=True)
        shutil.copy(ROOT / 'run_all.sh', copy / 'run_all.sh')
        for sh in (ROOT / 'scripts').glob('*.sh'):
            shutil.copy(sh, copy / 'scripts' / sh.name)
        (tmp_path / 'bin').mkdir()
        fake = tmp_path / 'bin' / 'python'
        fake.write_text(FAKE_PYTHON)
        fake.chmod(0o755)
    log = tmp_path / 'argv.jsonl'
    log.unlink(missing_ok=True)
    full = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    full.update(env or {}, FAKE_PYTHON_LOG=str(log),
                PATH=f'{tmp_path / "bin"}{os.pathsep}{os.environ["PATH"]}')
    subprocess.run(['bash', str(copy / script), *args], cwd=copy, env=full, check=True,
                   capture_output=True)
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert all(c[:2] == ['-m', 'generative_models_tpu.main'] for c in calls), calls
    return [c[2:] for c in calls]


@pytest.mark.parametrize('case', ['run_all_default', 'run_all_3', 'train_arbiters',
                                  'progressive_default', 'progressive_env',
                                  'eval_distill_chain', 'eval_no_progressive'])
def test_commands_are_the_jax_scripts(tmp_path, case):
    """(a) Each module's commands() for an environment and arguments equals
    the argv its JAX script gives the JAX main for the same ones."""
    root = tmp_path / 'chain'
    if case.startswith('run_all'):
        args = ['3'] if case == 'run_all_3' else []
        got = run_jax_script(tmp_path, 'run_all.sh', args)
        want = run_all.commands(args, {})
        assert len(want) == 12
    elif case == 'train_arbiters':
        env = {'EPOCHS': '2', 'LOGROOT': str(tmp_path / 'arb')}
        args = ['--bs=16', '--data_source=synthetic']
        got = run_jax_script(tmp_path, 'scripts/train_arbiters.sh', args, env)
        want = train_arbiters.commands(args, env)
        # the JAX script installs into its own repo's weights/: here the copy's
        assert (tmp_path / 'copy' / 'weights' / 'autoencoder.pt').is_file()
    elif case.startswith('progressive'):
        env = {} if case == 'progressive_default' else {
            'LOGROOT': str(root), 'EPOCHS_TEACHER': '3', 'EPOCHS_STUDENT': '2'}
        got = run_jax_script(tmp_path, 'scripts/progressive_distillation.sh', env=env)
        want = progressive_distillation.commands([], env)
        assert [Path(c[-1].split('=', 1)[1]).name for c in want] == list(CHAIN_STAGES)
    elif case == 'eval_distill_chain':
        for stage in ('teacher', 'step2_64', 'step2_1'):  # the stages that have a model.pt
            (root / stage).mkdir(parents=True)
            (root / stage / 'model.pt').touch()
        (root / 'step1').mkdir()  # no model.pt: skipped
        env = {'LOGROOT': str(root)}
        got = run_jax_script(tmp_path, 'scripts/eval_distill_chain.sh', env=env)
        want = eval_distill_chain.commands([], env)
        assert len(want) == 3
    else:
        args = [str(root / 'teacher')]
        got = run_jax_script(tmp_path, 'scripts/eval_no_progressive.sh', args)
        want = eval_no_progressive.commands(args, {})
        with pytest.raises(SystemExit):
            eval_no_progressive.commands([], {})
    assert got == want


def run_jax_collect(tmp_path, args, cwd):
    """The JAX system's scripts/collect_distill.py (no jax: tensorboard and
    yaml), run from a copy under tmp_path with cwd, where its default
    LOGROOT and OUT.json are relative: the finished process."""
    copy = tmp_path / 'jax_collect' / 'collect_distill.py'
    copy.parent.mkdir(exist_ok=True)
    shutil.copy(ROOT / 'scripts' / 'collect_distill.py', copy)
    return subprocess.run([sys.executable, str(copy), *map(str, args)], cwd=cwd,
                          capture_output=True, text=True)


def _idx(arr):
    arr = np.ascontiguousarray(arr, np.uint8)
    return (struct.pack('>BBBB', 0, 0, 8, arr.ndim)
            + b''.join(struct.pack('>I', d) for d in arr.shape) + arr.tobytes())


def _write_idx_set(d, n_train=16, n_test=16):
    """A seeded MNIST idx set of n_train and n_test images (gzipped), which
    a subprocess reads as the test process does."""
    rng = np.random.RandomState(0)
    d.mkdir(parents=True)
    for split, n in (('train', n_train), ('t10k', n_test)):
        (d / f'{split}-images-idx3-ubyte.gz').write_bytes(
            gzip.compress(_idx(rng.randint(0, 256, (n, 28, 28)))))
        (d / f'{split}-labels-idx1-ubyte.gz').write_bytes(gzip.compress(_idx(np.arange(n) % 10)))
    return d


def _state_equal(a, b):
    """Whether two model.pt dicts are bitwise equal (tensors, counters,
    optimizer state, generator state)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.fixture(scope='module')
def e2e(tmp_path_factory):
    """The tiny end to end, in this process: train_arbiters, then the
    chain (EPOCHS_*=1, --save_n=1, hidden 8, bs 8, 2 sampling steps), then
    step2_1 again as a CLI subprocess into a logdir of its own (before the
    eval chain rewrites its teacher's model.pt), then eval_distill_chain
    with the new arbiters, collect_distill and distill_latency."""
    tmp = tmp_path_factory.mktemp('scripts_e2e')
    shipped = [sha256(p) for p in SHIPPED]
    data = _write_idx_set(tmp / 'data')
    flags = [f'--data_dir={data}', '--data_source=mnist', '--device=cpu', '--bs=8',
             '--save_n=1']
    arb_env = {'LOGROOT': str(tmp / 'arb'), 'EPOCHS': '1'}
    _, arbiters = train_arbiters.main(flags + ['--hidden_size=16'], arb_env)
    env = {'LOGROOT': str(tmp / 'chain'), 'EPOCHS_TEACHER': '1', 'EPOCHS_STUDENT': '1'}
    chain_flags = flags + ['--hidden_size=8', '--eval_heavy=0', '--sample_steps=2']
    histories = progressive_distillation.main(chain_flags, env)

    stage = progressive_distillation.commands(chain_flags, env)[-1]
    sub = [a if not a.startswith('--logdir=') else f'--logdir={tmp / "cli_step2_1"}'
           for a in stage]
    sub_env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS=str(torch.get_num_threads()))
    subprocess.run([sys.executable, '-m', 'generative_models_tpu_torch.main', *sub], cwd=tmp,
                   env=sub_env, check=True, capture_output=True)
    in_process = read_checkpoint(tmp / 'chain' / 'step2_1' / 'model.pt')
    cli = read_checkpoint(tmp / 'cli_step2_1' / 'model.pt')

    evals = eval_distill_chain.main(flags + arbiters + ['--sample_steps=2'], env)
    collected = collect_distill.main([], env)
    jax_out = tmp / 'jax_collect' / 'DISTILL.json'
    run_jax_collect(tmp, [env['LOGROOT'], jax_out], tmp).check_returncode()
    jax_collected = json.loads(jax_out.read_text())
    latency = distill_latency.main(['--reps=1', '--sample_steps=2', '--device=cpu'], env)
    return dict(tmp=tmp, env=env, arbiters=arbiters, histories=histories, evals=evals,
                collected=collected, jax_collected=jax_collected, latency=latency,
                in_process=in_process, cli=cli,
                shipped=shipped)


def test_stage_in_process_equals_the_cli(e2e):
    """(b) step2_1, the chain's last stage, run in this process after nine
    others equals the same command as a fresh `python -m
    generative_models_tpu_torch.main` process, model.pt bitwise."""
    a, b = e2e['in_process'], e2e['cli']
    assert a['step'] == b['step'] == 2
    assert _state_equal(a, b)


def test_tiny_chain_end_to_end(e2e):
    """(c) arbiters, the chain, its eval, collect and latency on the CPU;
    collect's record equals the JAX system's collect_distill.py's on the
    same chain; the shipped weights/*.pt keep their bytes."""
    tmp, chain = e2e['tmp'], e2e['tmp'] / 'chain'
    weights = tmp / 'arb' / 'weights'
    assert e2e['arbiters'] == [f'--autoencoder={weights / "autoencoder.pt"}',
                               f'--classifier={weights / "classifier.pt"}']
    for name in ('autoencoder', 'classifier'):
        assert sha256(weights / f'{name}.pt') == sha256(tmp / 'arb' / name / 'model.jit.pt')
    assert len(e2e['histories']) == len(e2e['evals']) == len(CHAIN_STAGES) == 10
    for h in e2e['histories']:  # epochs 0 and 1
        assert len(h) == 2 and np.isfinite(h[1]['diffusion_model/train/loss'])
    keys = ('fid', 'ignite_fid', 'precision', 'recall', 'f1', 'classifier_loss', 'cond_fid',
            'cond_precision', 'cond_recall', 'cond_f1')
    for h in e2e['evals']:
        assert all(np.isfinite(h[0][f'eval/{k}']) for k in keys), h[0]
    steps = [256, 256, 128, 64, 32, 16, 8, 4, 2, 1]
    stages = e2e['collected']['stages']
    assert list(stages) == list(CHAIN_STAGES)
    assert [s['timesteps'] for s in stages.values()] == steps
    for s in stages.values():
        assert set(collect_distill.KEYS) <= set(s) and s['epochs'] == 0  # the eval's hps.yaml
    record = json.loads((chain / 'DISTILL.json').read_text())
    assert record['stages'] == json.loads(json.dumps(stages))
    assert e2e['jax_collected'] == {'logroot': str(chain), 'stages': record['stages']}
    lat = record['sample_latency']
    assert [lat[s]['timesteps'] for s in CHAIN_STAGES] == steps
    assert all(lat[s]['sample64_sec'] > 0 for s in CHAIN_STAGES)
    assert record['sample_latency_device'] == 'cpu'
    assert [sha256(p) for p in SHIPPED] == e2e['shipped']


def test_reloaded_student_drops_cond_w_embed(e2e):
    """A step1 student reloaded by --weights_from builds no teacher: its
    cond_w_embed is not read (the JAX package's strict=False restore), every
    other weight, Adam moment and the EMA are, by name."""
    path = e2e['tmp'] / 'student' / 'model.pt'
    path.parent.mkdir()
    # the chain's step1 checkpoint was rewritten by the eval chain: train one
    # from the teacher's again, with an EMA
    teacher = e2e['tmp'] / 'chain' / 'teacher' / 'model.pt'
    model, dataset, *_ = load_model_and_data([
        '--model=diffusion_model', '--device=cpu', '--hidden_size=8', '--eval_heavy=0',
        '--ema=0.9', '--bs=8', '--data_source=synthetic', f'--teacher_path={teacher}',
        '--teacher_mode=step1', f'--logdir={path.parent}'])
    assert model.net.cond_w_embed is not None
    bx, by = dataset.epoch_batches(torch.Generator().manual_seed(0))
    model.train_step(bx[0], by[0])
    model.save(path.parent)
    saved = read_checkpoint(path)
    names = list(saved['net'])
    reloaded, *_ = load_model_and_data([f'--weights_from={path}', '--device=cpu',
                                        '--eval_heavy=0', '--data_source=synthetic'])
    assert reloaded.net.cond_w_embed is None and reloaded.teacher_net is None
    sd = reloaded.net.state_dict()
    assert set(names) - set(sd) == {k for k in names if k.startswith('cond_w_embed.')} != set()
    assert all(torch.equal(v, saved['net'][k]) for k, v in sd.items())
    ema = reloaded.ema_net.state_dict()
    assert all(torch.equal(v, saved['extra']['ema'][k]) for k, v in ema.items())
    moments = reloaded.opt.state_dict()['state']
    for i, n in enumerate(reloaded._opt_names(reloaded.opt)):
        j = names.index(n)
        assert torch.equal(moments[i]['exp_avg'], saved['opt']['state'][j]['exp_avg']), n
    assert reloaded.step == 1


@pytest.mark.parametrize('how', ['argument', 'environment'])
def test_collect_refuses_an_empty_chain(tmp_path, how):
    """(d) collect_distill writes nothing for a LOGROOT with no stage, and
    refuses it as the JAX system's collect_distill.py does (which reads no
    LOGROOT from the environment: its default, logs/distillation under
    its cwd, names the same directory)."""
    root = tmp_path / 'logs' / 'distillation'
    (root / 'teacher').mkdir(parents=True)  # a stage directory with no hps.yaml
    with pytest.raises(SystemExit, match='no chain stages found under'):
        if how == 'argument':
            collect_distill.main([str(root)], {})
        else:
            collect_distill.main([], {'LOGROOT': str(root)})
    jax = run_jax_collect(tmp_path, [root] if how == 'argument' else [], tmp_path)
    assert jax.returncode == 1 and 'no chain stages found under' in jax.stderr, jax.stderr
    assert not (root / 'DISTILL.json').exists()
    assert not list(tmp_path.rglob('*.json'))
