"""The port's deployment artifacts (serve.py --export / --from_export) on
the CPU, at small sizes: the five serving kernels as torch.library ops
(opcheck); each of the ten models' artifact against its live server,
bitwise at two seeds; the exported sampling loops kept as while_loop nodes
(not unrolled); the quantized rnn; the conditional and unconditional
diffusion and its samplers; a pixel_transformer artifact fed the JAX
serving fn's draws against the JAX package's live batch and its jax.export
artifact, and made's the same within its sampling test's tie rule; the
CLI, its refusals, and an artifact of another device type refused."""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from generative_models_tpu_torch import serve as tserve
from generative_models_tpu_torch.ops import decode_fused, int8, masked_dense

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = {
    'pixel_transformer': ['--n_layer=1', '--n_head=2', '--n_embed=16'],
    'made': ['--hidden_size=16'],
    'rnn': ['--hidden_size=16'],
    'wavenet': ['--hidden_size=8'],
    'pixel_cnn': ['--n_filters=8', '--n_layers=2', '--kernel_size=3'],
    'gated_pixel_cnn': ['--n_filters=8', '--n_layers=3', '--kernel_size=3'],
    'vqvae': ['--hidden_size=16', '--vqD=8', '--vqK=16', '--n_layer=1', '--n_embed=32',
              '--n_head=2'],
    'vae': ['--hidden_size=16'],
    'gan': ['--hidden_size=16'],
    'diffusion_model': ['--hidden_size=16', '--timesteps=4', '--eval_heavy=0', '--bf16=0'],
}
LOOPED = set(SMALL) - {'vae', 'gan'}
_CACHE = {}


def _server(name, *flags, serve_bs=2):
    srv, _ = tserve.load_server([f'--model={name}', '--device=cpu', f'--serve_bs={serve_bs}',
                                 *SMALL[name], *flags])
    return srv


def _exported(tmp_path_factory, name, *flags, serve_bs=2):
    """(live server, its artifact's path, the ExportedProgram), exported
    once a configuration."""
    key = (name, flags, serve_bs)
    if key not in _CACHE:
        srv = _server(name, *flags, serve_bs=serve_bs)
        path = tmp_path_factory.mktemp('art') / f'{name}.pt2'
        nbytes = srv.export_serving(path)
        assert nbytes == path.stat().st_size > 0
        _CACHE[key] = srv, path, torch.export.load(path)
    return _CACHE[key]


def _graphs(ep):
    return [m for m in ep.graph_module.modules() if isinstance(m, torch.fx.GraphModule)]


def _count(ep, pred):
    return sum(pred(n) for g in _graphs(ep) for n in g.graph.nodes)


def _is_while(node):
    return node.target is torch.ops.higher_order.while_loop


def _ops_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    q = lambda *s: torch.randint(-127, 128, s, generator=g, dtype=torch.int8)
    C = 16
    lp = [r(C, C), r(C), r(C), r(C), r(C, 4 * C), r(4 * C), r(4 * C, C), r(C)]
    return {
        'ln_matmul': (torch.ops.gmt.ln_matmul, (r(3, C), r(C), r(C), r(C, 24), r(24))),
        'block_tail': (torch.ops.gmt.block_tail, (r(3, C), r(3, C), *lp)),
        'masked_matmul': (torch.ops.gmt.masked_matmul,
                          (r(3, C), r(C, 8), (r(C, 8) > 0).to(torch.uint8), False)),
        'int8_gemm': (torch.ops.gmt.int8_gemm, (q(3, C), q(C, 8))),
        'dequant_gemm': (torch.ops.gmt.dequant_gemm, (r(3, C), q(C, 8))),
    }


@pytest.mark.parametrize('op', ['ln_matmul', 'block_tail', 'masked_matmul', 'int8_gemm',
                                'dequant_gemm'])
def test_serving_kernels_are_library_ops(op):
    """torch.library.opcheck of each gmt:: op (its schema, its fake
    implementation against the CPU one, its registration); the op on CPU
    tensors is the wrapper's plain version, bitwise."""
    fn, args = _ops_cases()[op]
    torch.library.opcheck(fn, args)
    wrapper = {'ln_matmul': decode_fused.ln_matmul, 'masked_matmul': masked_dense.masked_matmul,
               'int8_gemm': int8.int8_gemm, 'dequant_gemm': int8.dequant_gemm}.get(op)
    if op == 'block_tail':
        lp = dict(zip(decode_fused._BT_ARGS, args[2:]))
        ref = decode_fused.block_tail_plain(args[0], args[1], lp)
        assert torch.equal(decode_fused.block_tail(args[0], args[1], lp), ref)
    else:
        assert torch.equal(wrapper(*args), fn(*args))


@pytest.mark.parametrize('name', list(SMALL))
def test_artifact_serves_the_live_batch(name, tmp_path_factory):
    """The artifact, served by ExportedServer with no model code, gives
    bitwise the live server's batch at two seeds, and another at a third;
    a looped model's program keeps its sampling loop as while_loop nodes,
    with fewer nodes than its T steps (not unrolled)."""
    serve_bs = 4 if name == 'diffusion_model' else 2  # the labels test's artifact
    srv, path, ep = _exported(tmp_path_factory, name, serve_bs=serve_bs)
    ex = tserve.ExportedServer(path, 'cpu')
    assert ex.serve_bs == serve_bs and ex.class_cond == srv.class_cond
    assert ex.meta['model'] == name and ex.meta['device'] == 'cpu'
    for seed in (3, 11):
        live = srv.sample(2, seed=seed)
        assert live.shape == (2, 28, 28, 1) and 0 <= live.min() and live.max() <= 1
        np.testing.assert_array_equal(ex.sample(2, seed=seed), live)
    assert not np.array_equal(ex.sample(2, seed=4), ex.sample(2, seed=3))
    loops = _count(ep, _is_while)
    if name in LOOPED:
        assert loops >= 1
        steps = {'vqvae': 49, 'diffusion_model': 4}.get(name, 784)
        if name != 'diffusion_model':
            assert _count(ep, lambda n: True) < 20 * steps
        else:  # one guided step's convolutions, not four
            convs = _count(ep, lambda n: n.target is torch.ops.aten.conv2d.default)
            body = sum(n.target is torch.ops.aten.conv2d.default
                       for n in _graphs(ep)[-1].graph.nodes)
            assert convs == body > 0
    else:
        assert loops == 0


@pytest.mark.parametrize('name', ['rnn', 'pixel_transformer'])
def test_exported_graph_does_not_grow_with_the_steps(name, tmp_path_factory):
    """28 x 28 (784 steps) and --pad32 (1024 steps) export to graphs of one
    size: the loop is one while_loop node whatever T."""
    _, _, ep28 = _exported(tmp_path_factory, name)
    _, _, ep32 = _exported(tmp_path_factory, name, '--pad32=1')
    assert _count(ep28, lambda n: True) == _count(ep32, lambda n: True)


def test_quantized_rnn_artifact(tmp_path_factory):
    """tests/test_int8.py's export case on the port: a --quantize=w8a16 rnn
    artifact (wh through gmt::dequant_gemm, baked into the artifact) serves
    the live quantized server's batch bitwise, and not the unquantized
    server's."""
    srv, path, ep = _exported(tmp_path_factory, 'rnn', '--hidden_size=64',
                              '--quantize=w8a16')
    assert srv.quant_kernels == 1
    ex = tserve.ExportedServer(path, 'cpu')
    assert ex.stats()['quantize'] == 'w8a16' and ex.stats()['quantized_kernels'] == 1
    assert _count(ep, lambda n: n.target is torch.ops.gmt.dequant_gemm.default) == 1
    np.testing.assert_array_equal(ex.sample(2, seed=5), srv.sample(2, seed=5))
    # quantization moves a logit by ~1e-3: the first seed whose batch it
    # flips a pixel of, which the artifact flips too
    plain = _server('rnn', '--hidden_size=64')
    seed = next(s for s in range(64)
                if not np.array_equal(srv.sample(2, seed=s), plain.sample(2, seed=s)))
    np.testing.assert_array_equal(ex.sample(2, seed=seed), srv.sample(2, seed=seed))
    assert not np.array_equal(ex.sample(2, seed=seed), plain.sample(2, seed=seed))


def test_conditional_diffusion_artifact_takes_labels(tmp_path_factory):
    """tests/test_serve.py's conditional export: the artifact takes the
    labels, serves a padded sample(2, y=[3]) in [0, 1] with a mid-gray
    mean (SAMPLE_RANGE mapped inside the program), bitwise the live
    server's."""
    srv, path, ep = _exported(tmp_path_factory, 'diffusion_model', serve_bs=4)
    ex = tserve.ExportedServer(path, 'cpu')
    assert ex.class_cond and ex.serve_bs == 4
    inputs = [s for s in ep.graph_signature.input_specs if s.kind.name == 'USER_INPUT']
    assert len(inputs) == 3  # noise, w and the labels
    out = ex.sample(2, y=[3], seed=1)
    assert out.shape == (2, 28, 28, 1) and out.min() >= 0 and out.max() <= 1
    assert 0.2 < out.mean() < 0.8
    np.testing.assert_array_equal(out, srv.sample(2, y=[3], seed=1))


@pytest.mark.parametrize('flags', [['--class_cond=0'], ['--sampler=dpm2m'],
                                   ['--sampler=noisy']], ids=['uncond', 'dpm2m', 'noisy'])
def test_diffusion_artifacts(flags, tmp_path_factory):
    """An unconditional artifact has no label input; ddim (above), dpm2m
    and noisy (its step normals drawn up front, a draw of its own) each
    export and serve the live batch bitwise. One doubled-batch call a step
    (--fused_cfg=1) keeps the traces short."""
    srv, path, ep = _exported(tmp_path_factory, 'diffusion_model', '--fused_cfg=1', *flags)
    ex = tserve.ExportedServer(path, 'cpu')
    names = [d['name'] for d in ex.meta['draws']]
    assert names == ['noise', 'w'] + (['step_noise'] if '--sampler=noisy' in flags else [])
    n_inputs = sum(s.kind.name == 'USER_INPUT' for s in ep.graph_signature.input_specs)
    assert n_inputs == len(names) + ex.class_cond
    if flags == ['--class_cond=0']:
        assert not ex.class_cond
        with pytest.raises(ValueError, match='unconditional'):
            ex.sample(2, y=[1])
    np.testing.assert_array_equal(ex.sample(2, seed=2), srv.sample(2, seed=2))


@contextlib.contextmanager
def _one_device():
    """The JAX package's default mesh over one of conftest's devices."""
    from generative_models_tpu.parallel import make_mesh, set_mesh

    set_mesh(make_mesh('', jax.devices()[:1]))
    try:
        yield
    finally:
        set_mesh(make_mesh('', jax.devices()))


def _jax_server(name, serve_bs, **over):
    from generative_models_tpu import serve as jserve
    from generative_models_tpu.utils import discover_models
    from generative_models_tpu.utils.config import global_defaults

    Model = discover_models()[name]
    G = global_defaults()
    G.model = name
    G.update(Model.DG)
    G.update(bs=8, **over)
    return jserve.SampleServer(Model(G), serve_bs=serve_bs)


def _uniforms(seed, T, shape):
    """The uniforms the JAX serving fn draws at seed: one key a step."""
    keys = jax.random.split(jax.random.wrap_key_data(
        jax.random.key_data(jax.random.key(seed))), T)
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))


def _port_program(name, flags, params, serve_bs, tmp_path):
    """A port artifact of name with the JAX params, loaded back."""
    from generative_models_tpu_torch.convert import made_params_from_jax, params_from_jax

    srv = _server(name, *flags, serve_bs=serve_bs)
    convert = made_params_from_jax if name == 'made' else params_from_jax
    srv.model.net.load_state_dict(convert(jax.tree_util.tree_map(np.asarray, params)))
    path = tmp_path / f'{name}.pt2'
    srv.export_serving(path)
    return srv, torch.export.load(path).module()


def test_pixel_transformer_artifact_matches_jax_bitwise(tmp_path):
    """A pixel_transformer artifact fed the uniforms the JAX serving fn
    draws at a seed gives bitwise the JAX package's live batch and the
    batch of its own jax.export artifact at that key."""
    from generative_models_tpu import serve as jserve

    serve_bs, n, seed = 3, 2, 5
    with _one_device():
        jsrv = _jax_server('pixel_transformer', serve_bs, n_layer=1, n_head=2, n_embed=16)
        ref = jsrv.sample(n, seed=seed)
        jsrv.export_serving(tmp_path / 'jax.stablehlo')
        jex = jserve.ExportedServer(tmp_path / 'jax.stablehlo')
        jref = np.asarray(jex.exp.call(jax.random.key_data(jax.random.key(seed))))
    u = _uniforms(seed, 784, (serve_bs, 1))
    _, program = _port_program('pixel_transformer', [], jsrv.model.state.params, serve_bs,
                               tmp_path)
    with torch.no_grad():
        got = program(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got[:n], np.asarray(ref))
    np.testing.assert_array_equal(got, jref)


def test_made_artifact_matches_jax(tmp_path):
    """made's artifact fed the JAX serving fn's uniforms: the JAX batch,
    but where a pixel differs its uniform lies within 1e-5 of the port's
    probability (tests/test_torch_made.py's tie rule)."""
    serve_bs, seed = 3, 7
    with _one_device():
        jsrv = _jax_server('made', serve_bs, hidden_size=64)
        ref = np.asarray(jsrv.model.pure_serving_fn(serve_bs)(
            jax.random.key_data(jax.random.key(seed)))).reshape(serve_bs, 784)
    u = _uniforms(seed, 784, (serve_bs,))
    srv, program = _port_program('made', ['--hidden_size=64'], jsrv.model.state.params,
                                 serve_bs, tmp_path)
    with torch.no_grad():
        got = program(torch.from_numpy(u)).numpy().reshape(serve_bs, 784)
    for row in range(serve_bs):
        diff = np.flatnonzero(got[row] != ref[row])
        if len(diff):
            i = diff[0]
            canvas = torch.from_numpy(got[row:row + 1].copy())
            canvas[0, i:] = 0
            with torch.no_grad():
                p = float(torch.sigmoid(srv.model.net(canvas)[0, i]))
            assert abs(u[i, row] - p) < 1e-5, (row, i, u[i, row], p)
    assert 0 < got.mean() < 1


def test_cli_exports_and_serves_without_the_models(tmp_path):
    """--export writes the artifact and exits; --from_export --n=4 in a
    fresh process writes a PNG with no module of the port's models/
    imported."""
    art, png = tmp_path / 'made.pt2', tmp_path / 'made.png'
    tserve.main(['--model=made', '--device=cpu', '--hidden_size=16', '--serve_bs=4',
                 f'--export={art}'])
    assert art.stat().st_size > 0
    code = (
        'import sys\n'
        'from generative_models_tpu_torch.serve import main\n'
        f'main(["--from_export={art}", "--device=cpu", "--n=4", "--out={png}"])\n'
        'bad = [m for m in sys.modules if m.startswith("generative_models_tpu_torch.models")'
        ' or m == "jax" or m.startswith("generative_models_tpu.")]\n'
        'assert not bad, bad\n'
    )
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert png.read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
    stats = json.loads(out.stdout.strip().splitlines()[-2])
    assert stats['model'] == f'exported:{art}' and stats['requests'] == 1


def test_cli_refusals():
    """The JAX package's two refusals, with its messages."""
    with pytest.raises(SystemExit, match='cannot be combined'):
        tserve.load_server(['--from_export=/nonexistent.pt2', '--export=/tmp/x.pt2'])
    with pytest.raises(SystemExit, match='already baked'):
        tserve.load_server(['--from_export=/nonexistent.pt2', '--quantize=int8'])


def test_artifact_of_another_device_is_refused(tmp_path_factory, tmp_path):
    """A serving.json that records cuda is refused on the CPU, as
    jax.export refuses an artifact lowered for another platform."""
    _, path, _ = _exported(tmp_path_factory, 'vae')
    extra = {'serving.json': ''}
    ep = torch.export.load(path, extra_files=extra)
    meta = dict(json.loads(extra['serving.json']), device='cuda')
    other = tmp_path / 'cuda.pt2'
    torch.export.save(ep, other, extra_files={'serving.json': json.dumps(meta)})
    with pytest.raises(ValueError, match='exported on cuda'):
        tserve.ExportedServer(other, 'cpu')
