"""Rules of the PyTorch port (generative_models_tpu_torch/ and chip_smoke.py):
it imports nothing of JAX, flax, msgpack or the JAX package, and asking for
CUDA on a machine without it raises instead of running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / 'generative_models_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'generative_models_tpu')


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


def _tile_routine(name):
    """The body of flash_tiles.cuh's tile routine `name`, up to the next
    template or the end of the file."""
    tiles = (PORT / 'ops' / 'csrc' / 'flash_tiles.cuh').read_text()
    body = tiles[tiles.index(f'void {name}('):]
    return body[:body.index('template <')] if 'template <' in body else body


def test_flash_backward_multiplies_on_the_tensor_cores():
    """Kernels E and D (attention_bwd.cu) compute every product with
    mma.sync on bf16 fragments through flash_tiles.cuh's warp routines: S
    and dP by ft_scores, dQ, dV and dK by ft_accum with P and dS split into
    hi/lo pairs, in the tile routines ft_dq_tile (E) and ft_dkv_tile (D,
    over ft_dkv_chunk) that the ring's L and M share; no f32 tile is staged
    for an FMA product loop."""
    csrc = PORT / 'ops' / 'csrc'
    src = (csrc / 'attention_bwd.cu').read_text()
    tiles = (csrc / 'flash_tiles.cuh').read_text()
    assert '#include "flash_tiles.cuh"' in src and '#include "mma.cuh"' in tiles
    assert src.count('ft_dq_tile<') == 2 and src.count('ft_dkv_tile<') == 2
    dq, dkv = _tile_routine('ft_dq_tile'), _tile_routine('ft_dkv_chunk')
    assert _tile_routine('ft_dkv_tile').count('ft_dkv_chunk<') == 2
    assert dq.count('ft_scores<') + dkv.count('ft_scores<') == 4
    assert dq.count('ft_accum<') + dkv.count('ft_accum<') == 3
    assert dq.count('ft_split(') + dkv.count('ft_split(') == 3
    assert 'gmt_mma_bf16' not in src and 'ft_scores<' not in src
    # two products a 16-deep step in ft_scores, two a B fragment and part
    # in ft_accum (its DP <= 64 form and its DP = 128 form)
    assert _tile_routine('ft_scores').count('gmt_mma_bf16(') == 2
    assert _tile_routine('ft_accum').count('gmt_mma_bf16(') == 4
    assert tiles.count('gmt_mma_bf16(') == 6 and 'gmt_ldmatrix_x4_trans' in tiles
    assert '__shared__ __align__(16) float' not in src


def test_flash_forward_multiplies_on_the_tensor_cores():
    """Kernel C (attention.cu) is built from flash_tiles.cuh's warp routines:
    its tile routine ft_fwd_tile (shared with the ring's K) takes S by
    ft_scores, splits P into a bf16 hi/lo pair by ft_split and adds P v by
    ft_accum, every product an mma.sync; no f32 K/V tile is staged in shared
    memory for an FMA product loop, as the first design did."""
    csrc = PORT / 'ops' / 'csrc'
    src = (csrc / 'attention.cu').read_text()
    fwd = _tile_routine('ft_fwd_tile')
    assert '#include "flash_tiles.cuh"' in src and src.count('ft_fwd_tile<') == 2
    assert fwd.count('ft_scores<') == 1 and fwd.count('ft_accum<') == 1
    assert fwd.count('ft_split(') == 1 and 'ft_exp2(' in fwd and 'ft_a_frags<' in src
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


def test_vq_search_multiplies_on_the_tensor_cores():
    """Kernel F (quantize.cu vq_one_hot_kernel) multiplies on the tensor
    cores: three tf32 mma.sync products a k8 step (3xTF32, mma.cuh's
    gmt_mma_tf32 on gmt_tf32_split's hi/lo parts of both operands), the z
    strip and the codebook's K-tiles by cp.async (16-byte, or 4-byte where
    rows are not aligned) into a ring of buffers; no fmaf product loop over D, as
    the first design had, and no atomics; the index written as int64 and
    the one-hot in 16-byte stores. gmt_vq_one_hot is the one entry the
    wrapper calls, and the wrapper adds no cast after it."""
    csrc = PORT / 'ops' / 'csrc'
    mma = (csrc / 'mma.cuh').read_text()
    src = (csrc / 'quantize.cu').read_text()
    assert 'mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32' in mma
    assert 'cvt.rna.tf32.f32' in mma and '#include "mma.cuh"' in src
    assert src.count('gmt_mma_tf32(') == 3 and src.count('gmt_tf32_split(') == 6
    assert 'gmt_cp_async16_ca(' in src and 'gmt_cp_async4(' in src
    assert 'gmt_cp_async_wait<VQ_STAGES - 2>()' in src
    assert 'fmaf(' not in src and 'atomic' not in src.replace('(no atomics)', '')
    assert 'float4' in src
    assert 'extern "C" int gmt_vq_one_hot(const float* z, const float* e, float* one_hot, ' \
           'long long* idx,' in src
    wrapper = (PORT / 'ops' / 'quantize.py').read_text()
    calls = [(n.args[0].value, n.args[1].value) for n in ast.walk(ast.parse(wrapper))
             if isinstance(n, ast.Call) and getattr(n.func, 'id', '') == 'c_function']
    assert calls == [('quantize', 'gmt_vq_one_hot')]
    assert 'dtype=torch.int64' in wrapper and '.long()' not in wrapper


def _ring_section(kernel):
    """ring_attention.cu's section of Kernel K, L or M."""
    src = (PORT / 'ops' / 'csrc' / 'ring_attention.cu').read_text()
    marks = ['-- Kernel K', '-- Kernel L', '-- Kernel M', 'static int launch_ring_fwd(']
    i = 'KLM'.index(kernel)
    return src[src.index(marks[i]):src.index(marks[i + 1])]


def test_ring_dq_hop_multiplies_on_the_tensor_cores():
    """Kernel L (ring_attention.cu ring_bwd_dq_kernel) is Kernel E's hop
    form on flash_tiles.cuh: its tile routine is E's ft_dq_tile (S and dP
    by ft_scores, dS split into a bf16 hi/lo pair by ft_split and dq += dS
    k by ft_accum), K/V tiles by ft_load_tile; no f32 K/V tile is staged
    for an FMA product loop, as the first design did."""
    src = (PORT / 'ops' / 'csrc' / 'ring_attention.cu').read_text()
    assert '#include "flash_tiles.cuh"' in src
    l_src = _ring_section('L')
    assert l_src.count('ft_dq_tile<') == 2 and 'ft_a_frags<' in l_src
    assert 'ft_load_tile<' in l_src and 'ring_bwd_dq_kernel(' in l_src
    assert 'gmt_mma_bf16' not in l_src and 'expf(' not in l_src and 'fmaf(ds' not in l_src
    assert '__shared__ __align__(16) float' not in l_src and 'load_kv_tile<' not in l_src


@pytest.mark.parametrize('kernel, routine, entry', [('K', 'ft_fwd_tile', 'ring_fwd_kernel('),
                                                    ('M', 'ft_dkv_tile', 'ring_bwd_dkv_kernel(')])
def test_ring_fwd_and_dkv_hops_multiply_on_the_tensor_cores(kernel, routine, entry):
    """Kernels K and M (ring_attention.cu) are Kernels C's and D's hop
    forms: each runs its flat kernel's tile routine from flash_tiles.cuh
    (ft_fwd_tile, in its hop form for K, and ft_dkv_tile) on tiles that
    ft_load_tile streams by cp.async, with no atomics, no f32 tile staged
    in shared memory and no FMA product loop on the CUDA cores, as their
    first designs had."""
    sec = _ring_section(kernel)
    assert entry in sec and sec.count(f'{routine}<') == 2
    # K's hop form carries P in three bf16 parts (its acc is unnormalised)
    assert kernel == 'M' or 'ft_split3(' in _tile_routine(routine)
    assert 'ft_load_tile<' in sec and 'ft_a_frags<' in sec and 'gmt_cp_async_commit()' in sec
    src = (PORT / 'ops' / 'csrc' / 'ring_attention.cu').read_text()
    assert 'atomicAdd' not in src and 'gmt_mma_bf16' not in src and 'expf(' not in src
    assert '__shared__ __align__(16) float' not in src and 'load_kv_tile' not in src
    assert 'RING_DISPATCH_D' not in src and src.count('return cudaErrorInvalidValue;') == 3


@pytest.mark.parametrize('fn', ['ring_chunk_fwd', 'ring_chunk_bwd_dq', 'ring_chunk_bwd_dkv'])
@pytest.mark.parametrize('D', [4, 12, 136])
def test_check_ring_refuses_a_head_width_the_hop_kernels_do_not_take(fn, D):
    """The hop kernels take D a multiple of 8 in [8, 128]; _check_ring
    (which the wrappers call on the card, never on the CPU) refuses any
    other D with a message before it looks at where the tensors lie, and
    the C entries refuse it too (cudaErrorInvalidValue)."""
    from generative_models_tpu_torch.ops import attention as att

    u = torch.zeros((2, 1, 8, D), device='meta')
    with pytest.raises(ValueError, match=f'D={D} must be a multiple of 8'):
        att._check_ring(fn, u, u, u, 8, 0, 2)
    ok = torch.zeros((2, 1, 8, 32), device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        att._check_ring(fn, ok, ok, ok, 8, 0, 2)


@pytest.mark.parametrize('src', ['attention', 'masked_dense', 'int8', 'decode_fused',
                                 'ring_attention', 'quantize'])
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


@pytest.mark.parametrize('model', ['pixel_transformer', 'made', 'rnn', 'wavenet'])
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
    from generative_models_tpu.utils.registry import discover_models as jax_models
    from generative_models_tpu_torch.serve import serve_defaults
    from generative_models_tpu_torch.utils.config import parse_args
    from generative_models_tpu_torch.utils.registry import discover_models

    # every model the JAX package registers is in the port's registry and
    # builds on the CPU at its defaults
    ported = discover_models()
    assert set(jax_models()) <= set(ported)
    for name in sorted(jax_models()):
        G, Model = parse_args([f'--model={name}', '--device=cpu'])
        assert Model is ported[name] and Model(G).net is not None, name
    # diffusion's default --eval_heavy=1 is ported, and so is the global
    # default model (vae)
    assert parse_args(['--model=diffusion_model', '--device=cpu'])[0].eval_heavy == 1
    assert parse_args(['--device=cpu'])[1].__name__ == 'VAE'
    with pytest.raises(KeyError):
        parse_args(['--model=no_such_model', '--device=cpu'])
    for flag in ('--mesh=data:2', '--fsdp=1', '--export=a.bin', '--from_export=a.bin'):
        argv = ['--model=pixel_transformer', '--device=cpu', flag]
        if flag.startswith(('--export', '--from_export')):  # ported: they parse
            G, _ = parse_args(argv, DG=serve_defaults())
            assert str(G[flag[2:].split('=')[0]]) == 'a.bin'
            continue
        # ported: they parse, and span the ranks of a process group, so a
        # model built without one refuses them, naming torchrun
        G, Model = parse_args(argv, DG=serve_defaults())
        with pytest.raises(RuntimeError, match='torchrun'):
            Model(G)
    for flag in ('--mesh=pipe:2', '--mesh=data:1,expert:2'):
        # ported: they parse, and a model built without a group refuses
        # them, naming torchrun
        G, Model = parse_args(['--model=pixel_transformer', '--device=cpu', flag])
        with pytest.raises(RuntimeError, match='torchrun'):
            Model(G)
    G, Model = parse_args(['--model=pixel_transformer', '--device=cpu',
                           '--moe_experts=2', '--n_embed=16'])
    assert all(hasattr(b, 'moe') for b in Model(G).net.blocks)


def test_diffusion_is_ported_and_imports_no_jax():
    """diffusion_model is in the registry; its modules are among those the
    import rules above scan."""
    from generative_models_tpu_torch.serve import load_server
    from generative_models_tpu_torch.utils.registry import discover_models

    assert 'diffusion_model' in discover_models()
    mods = set(_port_modules())
    for m in ('schedules', 'gaussian_diffusion', 'unet', 'model'):
        assert f'generative_models_tpu_torch.models.diffusion.{m}' in mods
    # --quantize is ported: at the default width the table holds the
    # embedding MLPs' Linears that pass the thresholds (time_embed's two,
    # guide_embed's second) and the twelve ResBlock emb projections
    server, _ = load_server(['--model=diffusion_model', '--device=cpu', '--eval_heavy=0',
                             '--quantize=int8', '--serve_bs=1'])
    assert server.quant_kernels == 15 and server.quant.mode == 'w8a8'
    assert sorted(server.quant.dense)[:3] == ['blocks.0.dense', 'blocks.1.dense',
                                              'blocks.10.dense']


def test_vae_gan_and_the_arbiters_are_ported_and_import_no_jax(monkeypatch, tmp_path):
    """vae, gan, autoencoder and classifier are in the registry; their
    modules and the msgpack decoder are among those the
    import rules above scan; without CUDA their entry points raise, and so
    does loading an arbiter for the card."""
    from generative_models_tpu_torch import main, serve
    from generative_models_tpu_torch.models.arbiters import load_arbiter
    from generative_models_tpu_torch.utils.registry import discover_models

    names = ('vae', 'gan', 'autoencoder', 'classifier')
    assert set(names) <= set(discover_models())
    mods = set(_port_modules())
    for m in ('models.vae', 'models.gan', 'models.arbiters', 'models.arbiters.autoencoder',
              'models.arbiters.classifier', 'utils.metrics', 'utils.msgpack'):
        assert f'generative_models_tpu_torch.{m}' in mods, m
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for name in ('vae', 'gan'):
        with pytest.raises(RuntimeError, match='--device=cpu'):
            main.main([f'--model={name}', '--hidden_size=8', '--epochs=0',
                       f'--logdir={tmp_path}'])
        with pytest.raises(RuntimeError, match='--device=cpu'):
            serve.main([f'--model={name}', '--hidden_size=8', '--n=1',
                        f'--out={tmp_path / "s.png"}'])
    with pytest.raises(RuntimeError, match='--device=cpu'):
        load_arbiter(REPO / 'weights' / 'classifier.pt', 'cuda')
    assert list(tmp_path.iterdir()) == []


def test_diffusion_without_cuda_raises_instead_of_using_the_cpu(monkeypatch, tmp_path):
    from generative_models_tpu_torch import main, serve

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    flags = ['--model=diffusion_model', '--eval_heavy=0', '--hidden_size=32']
    with pytest.raises(RuntimeError, match='--device=cpu'):
        main.main(flags + ['--epochs=0', f'--logdir={tmp_path}'])
    with pytest.raises(RuntimeError, match='--device=cpu'):
        serve.main(flags + ['--n=1', f'--out={tmp_path / "d.png"}'])
    assert list(tmp_path.iterdir()) == []


def test_mesh_rules():
    """--mesh: seq:N on pixel_transformer (its ring attention) and axes of
    size 1 pass; data, model, pipe and expert above 1 parse and a model
    built without a process group refuses them, naming torchrun; pipe:1
    builds the pipeline in one process, and refuses ring attention and MoE
    as the JAX package does; seq:N above 1 on a model without ring
    attention replicates; --quantize with a seq axis above 1 is refused,
    as the JAX package's serve.py refuses a non-data sharded mesh."""
    from generative_models_tpu_torch.parallel.mesh import ring_size
    from generative_models_tpu_torch.serve import load_server
    from generative_models_tpu_torch.utils.config import parse_args

    for mesh in ('seq:4', 'seq:1', 'data:1,seq:8', 'model:1', 'seq:5'):
        G, Model = parse_args(['--model=pixel_transformer', '--device=cpu', f'--mesh={mesh}',
                               '--n_embed=16', '--n_layer=1'])
        assert G.mesh == mesh
        assert Model(G).net.ring == ring_size(mesh, 784)  # seq:5 does not divide 784
    for mesh in ('model:2', 'seq:4,data:2'):  # over ranks: a model refuses them without a group
        G, Model = parse_args(['--model=pixel_transformer', '--device=cpu', f'--mesh={mesh}'])
        with pytest.raises(RuntimeError, match='torchrun --nproc_per_node='):
            Model(G)
    for mesh in ('pipe:2', 'expert:4,data:1'):  # over ranks: refused without a group
        G, Model = parse_args(['--model=pixel_transformer', '--device=cpu', f'--mesh={mesh}'])
        with pytest.raises(RuntimeError, match='torchrun --nproc_per_node='):
            Model(G)
    # pipe:1 builds the pipeline machinery in one process (n_layer % 1 ==
    # 0); with ring attention it is refused, as the JAX package cannot
    # build it; MoE inside the GPipe stack is refused, as the JAX
    # package's assert
    G, Model = parse_args(['--model=pixel_transformer', '--device=cpu', '--mesh=pipe:1',
                           '--n_embed=16', '--n_layer=2'])
    assert Model(G).net.pipe == 1
    G, Model = parse_args(['--model=pixel_transformer', '--device=cpu', '--mesh=pipe:1,seq:4'])
    with pytest.raises(NotImplementedError, match='ring attention'):
        Model(G)
    G, Model = parse_args(['--model=pixel_transformer', '--device=cpu', '--mesh=pipe:1',
                           '--moe_experts=2'])
    with pytest.raises(ValueError, match='MoE blocks inside the GPipe stack'):
        Model(G)
    # a model without ring attention replicates over seq, as the JAX
    # package's GSPMD does: one process runs the whole batch
    for model, mesh in (('made', 'seq:4'), ('vqvae', 'seq:7'), ('made', 'seq:1')):
        G, Model = parse_args([f'--model={model}', '--device=cpu', f'--mesh={mesh}'])
        m = Model(G)
        assert m.mesh.size('seq') == int(mesh[4:]) and m.mesh.dm is None and not m.seq_split()
    with pytest.raises(SystemExit, match='--quantize does not compose'):
        load_server(['--model=pixel_transformer', '--device=cpu', '--mesh=seq:4',
                     '--quantize=int8', '--serve_bs=1'])
    server, _ = load_server(['--model=pixel_transformer', '--device=cpu', '--mesh=seq:1',
                             '--quantize=w8a16', '--serve_bs=1'])
    assert server.quant_mode == 'w8a16' and not server.model.net.use_ring


def test_moe_and_the_mesh_import_no_jax_and_their_flags_round_trip_hps(tmp_path):
    """models/moe.py and parallel/ import nothing of JAX or the JAX
    package, and hps.yaml carries mesh, fsdp and moe_* both ways between
    the packages."""
    from generative_models_tpu.utils import discover_models as jax_models
    from generative_models_tpu.utils.config import dump_hps as jax_dump_hps
    from generative_models_tpu.utils.config import parse_args as jax_parse_args
    from generative_models_tpu_torch.utils.config import dump_hps, parse_args

    files = [PORT / 'models' / 'moe.py', *sorted((PORT / 'parallel').glob('*.py'))]
    for p in files:
        for node in ast.walk(ast.parse(p.read_text(), str(p))):
            if isinstance(node, ast.Import):
                assert not any(_forbidden(a.name) for a in node.names), p
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                assert not _forbidden(node.module), p
    flags = ['--model=pixel_transformer', '--mesh=data:2,model:2', '--fsdp=1',
             '--moe_experts=4', '--moe_cap=1.5', '--moe_aux=0.02']
    keys = ('mesh', 'fsdp', 'moe_experts', 'moe_cap', 'moe_aux')
    G, _ = parse_args(flags + ['--device=cpu', f'--logdir={tmp_path / "port"}'])
    dump_hps(G, tmp_path / 'port')
    jG, _ = jax_parse_args([f'--weights_from={tmp_path / "port" / "model.pt"}'],
                           discover_models=jax_models)
    assert tuple(jG[k] for k in keys) == ('data:2,model:2', 1, 4, 1.5, 0.02)
    jG, _ = jax_parse_args(flags + [f'--logdir={tmp_path / "jax"}'], discover_models=jax_models)
    jax_dump_hps(jG, tmp_path / 'jax')
    pG, _ = parse_args([f'--weights_from={tmp_path / "jax" / "model.pt"}', '--device=cpu'])
    assert tuple(pG[k] for k in keys) == ('data:2,model:2', 1, 4, 1.5, 0.02)
