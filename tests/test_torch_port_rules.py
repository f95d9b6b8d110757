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


def test_flash_backward_multiplies_on_the_tensor_cores():
    """Kernels E and D (attention_bwd.cu) compute every product with
    mma.sync on bf16 fragments through flash_tiles.cuh's warp routines
    (S and dP by ft_scores, dQ, dV and dK by ft_accum with P and dS split
    into hi/lo pairs); no f32 tile is staged for an FMA product loop."""
    csrc = PORT / 'ops' / 'csrc'
    src = (csrc / 'attention_bwd.cu').read_text()
    tiles = (csrc / 'flash_tiles.cuh').read_text()
    assert '#include "flash_tiles.cuh"' in src and '#include "mma.cuh"' in tiles
    assert src.count('ft_scores<') == 4 and src.count('ft_accum<') == 3
    assert src.count('ft_split(') == 3 and 'gmt_mma_bf16' not in src
    assert tiles.count('gmt_mma_bf16(') == 6 and 'gmt_ldmatrix_x4_trans' in tiles
    assert '__shared__ __align__(16) float' not in src


def test_flash_forward_multiplies_on_the_tensor_cores():
    """Kernel C (attention.cu) is built from flash_tiles.cuh's warp routines:
    S by ft_scores, P split into a bf16 hi/lo pair by ft_split and P v by
    ft_accum, every product an mma.sync; no f32 K/V tile is staged in shared
    memory for an FMA product loop, as the first design did."""
    csrc = PORT / 'ops' / 'csrc'
    src = (csrc / 'attention.cu').read_text()
    assert '#include "flash_tiles.cuh"' in src
    assert src.count('ft_scores<') == 1 and src.count('ft_accum<') == 1
    assert src.count('ft_split(') == 1 and 'ft_exp2(' in src and 'ft_a_frags<' in src
    assert 'gmt_mma_bf16' not in src and 'expf(' not in src
    assert '__shared__ __align__(16) float' not in src and 'float ks[' not in src


def test_mask_out_matmul_multiplies_on_the_tensor_cores():
    """Kernel H (masked_dense.cu) multiplies with mma.cuh's gmt_mma_bf16 on
    ldmatrix.trans fragments; the first design's f32 FMA body (md_gemm and
    its md_* helpers) is gone."""
    src = (PORT / 'ops' / 'csrc' / 'masked_dense.cu').read_text()
    h = src[src.index('-- Kernel H'):src.index('// G: out (M, N) = x (M, K) @ (w * mask)')]
    assert 'mask_out_matmul_kernel(' in h and h.count('gmt_mma_bf16(') == 2
    assert h.count('gmt_ldmatrix_x4_trans(') == 2 and 'gmt_cp_async16(' in h
    assert 'fmaf(' not in h and 'md_gemm' not in src and 'md_' not in src


def test_int8_gemm_multiplies_on_the_int8_tensor_cores():
    """Kernel I (int8.cu) is the s8 sibling of stream_gemm.cuh's skeleton:
    every product an mma.sync m16n8k32 s8 through mma.cuh's gmt_mma_s8, K
    split in a cluster; the first design's __dp4a loop and its byte-by-byte
    loaders (i8_load_x, i8_load_q) are gone."""
    csrc = PORT / 'ops' / 'csrc'
    src = (csrc / 'int8.cu').read_text()
    skeleton = (csrc / 'stream_gemm.cuh').read_text()
    assert 'mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32' in (csrc / 'mma.cuh').read_text()
    assert 'sg_gemm_s8<' in src and 'int8_gemm_kernel' in src
    assert skeleton.count('gmt_mma_s8(') == 2 and '__byte_perm' in skeleton
    assert 'cluster.map_shared_rank' in skeleton
    assert '__dp4a(' not in src and 'i8_load_' not in src and 'QG_' not in src


def test_block_tail_multiplies_on_the_tensor_cores_over_a_cluster():
    """Kernel B (decode_fused.cu block_tail_kernel) multiplies with
    mma.cuh's gmt_mma_bf16 on ldmatrix fragments, over a thread-block
    cluster whose blocks meet through distributed shared memory; neither it
    nor Kernel A, which multiplies on the tensor cores before it, calls the
    first design's f32 FMA loop (rows_matmul)."""
    src = (PORT / 'ops' / 'csrc' / 'decode_fused.cu').read_text()
    b = src[src.index('-- Kernel B'):]
    assert b.count('gmt_mma_bf16(') == 1 and 'gmt_ldmatrix_x4_trans(' in b
    assert 'cudaLaunchAttributeClusterDimension' in b and 'barrier.cluster.arrive' in b
    assert 'st.shared::cluster' in b and 'mapa.shared::cluster' in b
    assert 'rows_matmul' not in src and src[:src.index('-- Kernel B')].count('gmt_mma_bf16(') == 1


def test_ln_matmul_multiplies_on_the_tensor_cores():
    """Kernel A's route for N >= 8 (decode_fused.cu ln_matmul_kernel)
    multiplies with mma.cuh's gmt_mma_bf16 on ldmatrix fragments (A from
    the bf16 rows, B from the (in, out) weight stages by ldmatrix.trans)
    that 16-byte cp.async copies fill; it has no f32 FMA product loop, and
    the first design's rows_matmul and its LN into f32 shared memory
    (common.cuh's gmt_layernorm_rows_bf16) are gone. Only the N < 8 route
    (ln_matmul_dot_kernel, a warp a row) sums on the CUDA cores."""
    csrc = PORT / 'ops' / 'csrc'
    src = (csrc / 'decode_fused.cu').read_text()
    a = src[src.index('-- Kernel A'):src.index('-- Kernel B')]
    mma = a[a.index('ln_matmul_kernel('):a.index('ln_matmul_dot_kernel(')]
    assert mma.count('gmt_mma_bf16(') == 1 and 'gmt_ldmatrix_x4(' in mma
    assert 'gmt_ldmatrix_x4_trans(' in mma and 'fmaf(' not in mma
    assert 'gmt_cp_async16(' in a and 'lm_load_stage<VEC>(' in mma
    assert 'rows_matmul' not in src and 'gmt_layernorm_rows_bf16' not in src
    assert 'gmt_layernorm_rows_bf16' not in (csrc / 'common.cuh').read_text()


def test_ring_dq_hop_multiplies_on_the_tensor_cores():
    """Kernel L (ring_attention.cu ring_bwd_dq_kernel) is Kernel E's hop
    form on flash_tiles.cuh: S and dP by ft_scores, dS split into a bf16
    hi/lo pair by ft_split and dq += dS k by ft_accum, K/V tiles by
    ft_load_tile; no f32 K/V tile is staged for an FMA product loop, as the
    first design (and Kernels K and M still) do."""
    src = (PORT / 'ops' / 'csrc' / 'ring_attention.cu').read_text()
    assert '#include "flash_tiles.cuh"' in src
    l_src = src[src.index('-- Kernel L'):src.index('-- Kernel M')]
    assert l_src.count('ft_scores<') == 2 and l_src.count('ft_split(') == 1
    assert l_src.count('ft_accum<') == 1 and 'ft_exp2(' in l_src and 'ft_a_frags<' in l_src
    assert 'ft_load_tile<' in l_src and 'ring_bwd_dq_kernel(' in l_src
    assert 'gmt_mma_bf16' not in l_src and 'expf(' not in l_src and 'fmaf(ds' not in l_src
    assert '__shared__ __align__(16) float' not in l_src and 'load_kv_tile<' not in l_src


@pytest.mark.parametrize('src', ['attention', 'masked_dense', 'int8', 'decode_fused',
                                 'ring_attention'])
def test_knob_sweep_rewrites_one_line_a_knob(src):
    """ops/knob_sweep.py (run on the card) finds each of its knobs' lines
    exactly once in the source, and its first variant of each source is the
    source as shipped, so the sweep times the shipped kernel beside the
    others; every other variant differs from it in the source or in a knob
    set at the call (Kernel B's cluster size)."""
    from generative_models_tpu_torch.ops import knob_sweep

    variants = [knobs for s, knobs in knob_sweep.VARIANTS if s == src]
    assert len(variants) > 3
    shipped = (PORT / 'ops' / 'csrc' / f'{src}.cu').read_text()
    assert knob_sweep.patched_source(src, variants[0]) == shipped
    assert not set(variants[0]) & set(knob_sweep.CALL_KNOBS)
    assert all(knob_sweep.patched_source(src, k) != shipped
               or set(k) & set(knob_sweep.CALL_KNOBS) for k in variants[1:])


def test_every_kernel_entry_a_wrapper_calls_is_in_its_source():
    """Each c_function(library, 'gmt_...') of the port names an extern "C"
    entry that ops/csrc/<library>.cu defines: a lost host entry fails here
    on the CPU, not at the first launch on the card."""
    calls = set()
    for p in sorted(PORT.rglob('*.py')):
        for node in ast.walk(ast.parse(p.read_text(), str(p))):
            if (isinstance(node, ast.Call) and getattr(node.func, 'id', '') == 'c_function'
                    and all(isinstance(a, ast.Constant) for a in node.args[:2])):
                calls.add((node.args[0].value, node.args[1].value))
    assert len(calls) >= 12
    csrc = PORT / 'ops' / 'csrc'
    missing = [(lib, fn) for lib, fn in sorted(calls)
               if f'extern "C" int {fn}(' not in (csrc / f'{lib}.cu').read_text()]
    assert missing == []


def test_block_tail_stamps_find_their_lines():
    """ops/block_tail_stamps.py (run on the card) puts each of its stamps
    at a line of Kernel B that occurs exactly once, so the timeline it
    prints follows the shipped source."""
    from generative_models_tpu_torch.ops import block_tail_stamps as bts

    text = bts.stamped_source()
    assert text.count('%%globaltimer') == len(bts.ANCHORS)
    shipped = (PORT / 'ops' / 'csrc' / 'decode_fused.cu').read_text()
    kept = iter(text.split('\n'))
    assert all(line in kept for line in shipped.split('\n'))  # every line, in order


def test_ptxas_report_reads_registers_and_spills():
    """chip_smoke.py's build phase reads each entry function's registers
    and spills from nvcc -Xptxas -v (and fails where C, E or D spill at
    D=32 or H spills)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    log = (
        "ptxas info    : Compiling entry function '_Z19flash_bwd_dq_kernelILi32EEvPKf' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z19flash_bwd_dq_kernelILi32EEvPKf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 80 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z3fooILi128EEv' for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size\n"
    )
    assert chip_smoke.ptxas_report(log) == {
        '_Z19flash_bwd_dq_kernelILi32EEvPKf': dict(registers=80, spill_stores=0, spill_loads=0),
        '_Z3fooILi128EEv': dict(registers=255, spill_stores=8, spill_loads=12),
    }


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
