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


def test_kernel_sources_call_no_library_gemm():
    """Every kernel is written by hand: no source under ops/csrc/ includes
    or calls cuBLAS, cuDNN or a CUTLASS device-level GEMM. Kernels G and J
    multiply on the tensor cores, through mma.cuh's mma.sync."""
    csrc = PORT / 'ops' / 'csrc'
    files = sorted(csrc.glob('*.cu')) + sorted(csrc.glob('*.cuh'))
    assert len(files) >= 9
    banned = ('cublas', 'cudnn', 'cutlass/gemm/device', 'gemm::device', 'gemmuniversal',
              'collectivebuilder', 'cutlass/gemm/kernel', 'gemm::kernel')
    bad = [f'{p.name}: {b}' for p in files for b in banned if b in p.read_text().lower()]
    assert bad == []
    assert 'mma.sync.aligned.m16n8k16' in (csrc / 'mma.cuh').read_text()
    assert 'gmt_mma_bf16' in (csrc / 'stream_gemm.cuh').read_text()
    for name, kernel in (('masked_dense.cu', 'masked_matmul_kernel'),
                         ('int8.cu', 'dequant_gemm_kernel')):
        src = (csrc / name).read_text()
        assert '#include "stream_gemm.cuh"' in src and 'sg_gemm<' in src and kernel in src


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


@pytest.mark.parametrize('model', ['pixel_transformer', 'made'])
def test_quantize_without_cuda_raises_instead_of_using_the_cpu(monkeypatch, tmp_path, model):
    """--quantize serves on the card like every entry point: without CUDA
    it raises unless --device=cpu, before any weight is quantized."""
    from generative_models_tpu_torch import serve

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device=cpu'):
        serve.main([f'--model={model}', '--quantize=int8', '--n=1', f'--out={tmp_path / "q.png"}'])
    assert list(tmp_path.iterdir()) == []
    server, _ = serve.load_server([f'--model={model}', '--quantize=w8a16', '--device=cpu',
                                   '--serve_bs=1'])
    assert server.quant_mode == 'w8a16' and server.model.device.type == 'cpu'


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
    for flag in ('--mesh=data:2', '--fsdp=1', '--export=a.bin', '--from_export=a.bin'):
        with pytest.raises(NotImplementedError, match='not ported yet'):
            parse_args(['--model=pixel_transformer', '--device=cpu', flag],
                       DG=serve_defaults())
    G, Model = parse_args(['--model=pixel_transformer', '--device=cpu',
                           '--moe_experts=2', '--n_embed=16'])
    with pytest.raises(NotImplementedError, match='moe_experts'):
        Model(G)


def test_mesh_rules():
    """--mesh: seq:N on pixel_transformer (its ring attention) and axes of
    size 1 pass; any axis but seq above size 1 raises as not ported when the
    flags are parsed, and seq:N above 1 when a model without ring attention
    is built; --quantize with a seq axis above 1 is refused, as the JAX
    package's serve.py refuses a non-data sharded mesh."""
    from generative_models_tpu_torch.serve import load_server
    from generative_models_tpu_torch.utils.config import parse_args

    for mesh in ('seq:4', 'seq:1', 'data:1,seq:8', 'model:1', 'seq:5'):
        G, Model = parse_args(['--model=pixel_transformer', '--device=cpu', f'--mesh={mesh}',
                               '--n_embed=16', '--n_layer=1'])
        assert G.mesh == mesh and Model.supports_ring
        Model(G)
    for mesh in ('model:2', 'seq:4,data:2'):
        with pytest.raises(NotImplementedError, match='not ported yet'):
            parse_args(['--model=pixel_transformer', '--device=cpu', f'--mesh={mesh}'])
    for model, mesh in (('made', 'seq:4'), ('vqvae', 'seq:7'), ('made', 'seq:1')):
        G, Model = parse_args([f'--model={model}', '--device=cpu', f'--mesh={mesh}'])
        assert not Model.supports_ring
        if mesh == 'seq:1':
            Model(G)
            continue
        with pytest.raises(NotImplementedError, match='not ported yet'):
            Model(G)
    with pytest.raises(SystemExit, match='--quantize does not compose'):
        load_server(['--model=pixel_transformer', '--device=cpu', '--mesh=seq:4',
                     '--quantize=int8', '--serve_bs=1'])
    server, _ = load_server(['--model=pixel_transformer', '--device=cpu', '--mesh=seq:1',
                             '--quantize=w8a16', '--serve_bs=1'])
    assert server.quant_mode == 'w8a16' and not server.model.net.use_ring
