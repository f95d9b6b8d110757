"""Rules of the PyTorch port (generative_models_tpu_torch/ and chip_smoke.py):
it imports nothing of JAX, flax or the JAX package, and asking for CUDA on a
machine without it raises instead of running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / 'generative_models_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'generative_models_tpu')


def _forbidden(name):
    # generative_models_tpu_torch shares a prefix with the JAX package
    return any(name == f or name.startswith(f + '.') for f in FORBIDDEN)


def _port_modules():
    for p in sorted(PORT.rglob('*.py')):
        parts = p.relative_to(REPO).with_suffix('').parts
        yield '.'.join(parts[:-1] if parts[-1] == '__init__' else parts)


def test_importing_the_port_loads_no_jax():
    mods = list(_port_modules()) + ['chip_smoke']
    code = (
        'import sys; sys.path.insert(0, %r)\n'
        'import importlib\n'
        'for m in %r: importlib.import_module(m)\n'
        'print("\\n".join(sorted(sys.modules)))\n'
    ) % (str(REPO), mods)
    out = subprocess.run(
        [sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout.split()
    for m in ('serve', 'main', 'data.mnist', 'utils.logger'):
        assert f'generative_models_tpu_torch.{m}' in out
    assert [m for m in out if _forbidden(m)] == []


def test_no_source_file_imports_jax():
    files = sorted(PORT.rglob('*.py')) + [REPO / 'chip_smoke.py']
    assert len(files) > 10
    bad = []
    for p in files:
        for node in ast.walk(ast.parse(p.read_text(), str(p))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            bad += [f'{p.relative_to(REPO)}: {n}' for n in names if _forbidden(n)]
    assert bad == []


def test_serve_without_cuda_raises_instead_of_using_the_cpu(monkeypatch, tmp_path):
    from generative_models_tpu_torch import serve

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    out = tmp_path / 's.png'
    with pytest.raises(RuntimeError, match='--device=cpu'):
        serve.main(['--model=pixel_transformer', '--n=1', f'--out={out}'])
    assert not out.exists()


def test_train_without_cuda_raises_instead_of_using_the_cpu(monkeypatch, tmp_path):
    from generative_models_tpu_torch import main

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    logdir = tmp_path / 'logs'
    with pytest.raises(RuntimeError, match='--device=cpu'):
        main.main(['--model=pixel_transformer', '--data_source=synthetic',
                   f'--logdir={logdir}'])
    assert not logdir.exists()


@pytest.mark.parametrize('entry', ['serve', 'main'])
def test_made_without_cuda_raises_instead_of_using_the_cpu(monkeypatch, tmp_path, entry):
    """made at the kernel route's width: the gate reads the model's device,
    and without CUDA there is no device to read but the CPU, which is
    refused."""
    from generative_models_tpu_torch import main, serve

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    flags = ['--model=made', '--hidden_size=2048']
    with pytest.raises(RuntimeError, match='--device=cpu'):
        if entry == 'serve':
            serve.main(flags + ['--n=1', f'--out={tmp_path / "s.png"}'])
        else:
            main.main(flags + ['--data_source=synthetic', f'--logdir={tmp_path / "logs"}'])
    assert list(tmp_path.iterdir()) == []


def test_device_rule():
    from generative_models_tpu_torch.ops.common import resolve_device

    assert resolve_device('cpu') == torch.device('cpu')
    with pytest.raises(ValueError):
        resolve_device('tpu')


def test_unported_models_and_flags_raise():
    from generative_models_tpu_torch.serve import serve_defaults
    from generative_models_tpu_torch.utils.config import parse_args

    with pytest.raises(NotImplementedError, match='not ported yet'):
        parse_args(['--model=diffusion_model', '--device=cpu'])
    with pytest.raises(KeyError):
        parse_args(['--model=no_such_model', '--device=cpu'])
    for flag in ('--mesh=data:2', '--fsdp=1', '--quantize=int8',
                 '--export=a.bin', '--from_export=a.bin'):
        with pytest.raises(NotImplementedError, match='not ported yet'):
            parse_args(['--model=pixel_transformer', '--device=cpu', flag],
                       DG=serve_defaults())
    G, Model = parse_args(['--model=pixel_transformer', '--device=cpu',
                           '--moe_experts=2', '--n_embed=16'])
    with pytest.raises(NotImplementedError, match='moe_experts'):
        Model(G)
