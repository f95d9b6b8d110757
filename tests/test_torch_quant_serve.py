"""Quantized serving (--quantize) of the port against the JAX package's, on
the CPU, where Kernels I and J run as their plain versions: the
quantization tables key for key and bitwise; the counts at the default
widths; pixel_transformer's quantized decode step, made's quantized
forward (with its causality) and the vqvae prior's quantized decode step
against the JAX modules under the JAX interceptor; quantized sampling from
the same uniforms; and the server's and the CLI's handling of the flag.

Two findings in the reference shape these tests. (1) The JAX vqvae's table
is keyed from the model's root ('prior', ...), but its prior runs as
self.prior.apply and its modules see paths without 'prior': its interceptor
quantizes none of them. The port applies all of them, and is held against a
JAX interceptor built from the table with the prefix stripped. (2) Under
w8a8 each activation row has one absmax scale, which depends on every unit
of the row, so MADE's logit i moves when a pixel after i does; the port
copies the mode as it is, and its causality is bitwise only under w8a16."""

import contextlib
import io
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu import serve as jserve
from generative_models_tpu.models.base import intercept_ctx
from generative_models_tpu.models.pixel_transformer import TransformerNet as JaxNet
from generative_models_tpu.ops import int8 as jint8
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch import serve
from generative_models_tpu_torch.convert import (
    made_params_from_jax, params_from_jax, quant_table_from_jax, vqvae_params_from_jax,
)
from generative_models_tpu_torch.models.pixel_transformer import TransformerNet
from generative_models_tpu_torch.ops import int8 as tint8
from generative_models_tpu_torch.ops.int8 import (
    QuantTable, build_quant_table, quantize_dense_modules, quantize_masked_mlp,
)
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

MODES = ['w8a8', 'w8a16']
MADE_FLAGS = ['--model=made', '--hidden_size=128']
# the narrowest vqvae whose prior has quantized layers: n_embed and vqK 128
VQ_FLAGS = ['--model=vqvae', '--hidden_size=16', '--vqD=8', '--vqK=128', '--n_layer=1',
            '--n_embed=128', '--n_head=2']
# pixel_transformer at its default n_embed=128 (narrower quantizes nothing)
PT = dict(in_size=1, block_size=10, n_embed=128, n_head=4, n_layer=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(tmp_path_factory, flags):
    """The JAX package's model, its state initialised under jax.jit: op by
    op, the vqvae's initialisation alone takes ~18 s on the CPU."""
    G, Model = jax_parse_args(flags + [f'--logdir={tmp_path_factory.mktemp("jax")}'],
                              discover_models=jax_models)
    init_state = Model.init_state
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Model, 'init_state',
                   lambda self, rng: jax.jit(lambda r: init_state(self, r))(rng))
        return Model(G)


def _port_model(flags, sd=None):
    G, Model = parse_args(flags + ['--device=cpu'], DG=serve.serve_defaults())
    model = Model(G)
    if sd is not None:
        model.net.load_state_dict(sd)
    return model


@pytest.fixture(scope='module')
def made_pair(tmp_path_factory):
    jmodel = _jax_model(tmp_path_factory, MADE_FLAGS)
    return jmodel, _port_model(MADE_FLAGS, made_params_from_jax(_np(jmodel.state.params)))


@pytest.fixture(scope='module')
def vq_pair(tmp_path_factory):
    jmodel = _jax_model(tmp_path_factory, VQ_FLAGS)
    return jmodel, _port_model(VQ_FLAGS, vqvae_params_from_jax(_np(jmodel.state.params)))


@pytest.fixture(scope='module')
def pt_pair():
    jnet = JaxNet(**PT, use_pallas=False)
    params = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((1, PT['block_size'], 1)))['params']
    net = TransformerNet(**PT)
    net.load_state_dict(params_from_jax(_np(params)))
    return jnet, params, net.eval()


def _assert_tables_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for name, v in ref.items():
        pairs = [(got[name], v)] if not isinstance(v[0], tuple) else zip(got[name], v)
        for (q, s), (rq, rs) in pairs:
            assert q.dtype == torch.int8 and torch.equal(q, rq), name
            assert q.is_contiguous(), name  # the layout the kernels take on the card
            assert torch.equal(s, rs), name


def test_tables_match_jax_key_for_key(pt_pair, made_pair, vq_pair):
    _, params, net = pt_pair
    pt = quantize_dense_modules(net)
    assert len(pt) == 12 and 'blocks.1.fc2' in pt and 'embed' not in pt
    _assert_tables_equal(pt, quant_table_from_jax(jint8.quantize_dense_tree(params)))
    jmade, made = made_pair
    assert quantize_dense_modules(made.net) == {}
    _assert_tables_equal(quantize_masked_mlp(made),
                         quant_table_from_jax(jint8.quantize_masked_mlp(jmade)))
    jvq, vq = vq_pair
    table = quantize_dense_modules(vq.net)
    assert {'prior.embed', 'prior.head_layer.dense', 'prior.blocks.0.attn.query'} <= set(table)
    _assert_tables_equal(table, quant_table_from_jax(jint8.quantize_dense_tree(jvq.state.params)))


@pytest.mark.parametrize('model,count', [('pixel_transformer', 12), ('made', 4), ('vqvae', 14)])
def test_counts_at_default_widths(model, count):
    m = _port_model([f'--model={model}'])
    table, n = build_quant_table(m, 'w8a8')
    assert n == len(table) == count
    if model == 'vqvae':  # all of them in the prior, keyed from its root
        assert len(table.sub('prior')) == count and table.sub('prior').dense.keys() >= {
            'embed', 'head_layer.dense'}


@pytest.mark.parametrize('mode', MODES)
def test_quantized_decode_step_matches_jax(pt_pair, mode):
    """Teacher-forced decode steps of the port's quantized route against
    JAX's TransformerNet.decode_step under its own interceptor (the Pallas
    kernels in interpret mode): the logits within 1e-4, the LayerNorms'
    rounding (flax's and the port's differ by an ulp). No w8a8 level flips
    at these inputs: one flipped level would move a product by sx * scale *
    |q|, ~1e-3 here, past the tolerance. And the route calls neither Kernel
    A nor B (their wrappers are not called at all)."""
    jnet, params, net = pt_pair
    T, B = PT['block_size'], 3
    table = jint8.quantize_dense_tree(params)
    interceptor = jint8.make_dense_interceptor(table, mode, use_pallas=True)

    @jax.jit
    def jstep(prev, caches, t):
        with intercept_ctx(interceptor):
            return jnet.apply({'params': params}, prev, caches, t, method=JaxNet.decode_step)

    quant = QuantTable(mode, quant_table_from_jax(table))
    x = (np.random.RandomState(1).rand(B, T, 1) > 0.5).astype(np.float32)
    jcaches, caches = jnet.init_cache(B), net.init_cache(B)
    jprev, prev = jnp.zeros((B, 1)), torch.zeros(B, 1)
    calls = []
    orig = tint8.int8_matmul
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tint8, 'int8_matmul', lambda *a, **k: calls.append(1) or orig(*a, **k))
        for name in ('ln_matmul', 'block_tail'):
            mp.setattr(f'generative_models_tpu_torch.models.pixel_transformer.{name}',
                       lambda *a, **k: pytest.fail('a fused decode kernel ran'))
        for t in range(T):
            ref, jcaches = jstep(jprev, jcaches, t)
            got = net.decode_step(prev, caches, t, quant=quant)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
            jprev, prev = jnp.asarray(x[:, t]), torch.from_numpy(x[:, t])
    assert len(calls) == 12 * T
    # and the caches agree: the quantized key and value rows
    for c, jc in zip(caches, jcaches):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)


def _jax_made_forward(jmodel, mode, x, use_pallas):
    interceptor, n = jint8.build_quant_interceptor(jmodel, mode, use_pallas=use_pallas)
    assert n == 4
    with nn.intercept_methods(interceptor):
        return np.asarray(jmodel.net.apply({'params': jmodel.state.params}, jnp.asarray(x)))


@pytest.mark.parametrize('mode', MODES)
def test_made_quantized_forward_and_causality_match_jax(made_pair, mode):
    """made's folded int8 layers against the JAX interceptor (the Pallas
    kernels in interpret mode, and lax.dot): w8a8 equal (the same integer
    sums and the same elementwise steps), w8a16 within 1e-5 of the sum of
    |products| (f32 sums in another order). Causality with pixel 500
    flipped: bitwise under w8a16; under w8a8 logits <= 500 move, on the
    port as on JAX (finding 2)."""
    jmodel, model = made_pair
    quant, n = build_quant_table(model, mode)
    x = (np.random.RandomState(6).rand(4, 784) > 0.5).astype(np.float32)
    x2 = x.copy()
    x2[:, 500] = 1 - x2[:, 500]
    with torch.no_grad():
        got, got2 = (model.net(torch.from_numpy(v), quant=quant).numpy() for v in (x, x2))
    for use_pallas in (True, False):
        ref, ref2 = (_jax_made_forward(jmodel, mode, v, use_pallas) for v in (x, x2))
        tol = dict(rtol=0, atol=0) if mode == 'w8a8' else dict(rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, ref, **tol)
        np.testing.assert_allclose(got2, ref2, **tol)
    moved = int((got[:, :501] != got2[:, :501]).sum())
    if mode == 'w8a16':
        assert moved == 0
    else:
        assert moved > 0 and moved == int((ref[:, :501] != ref2[:, :501]).sum())
    exact = model.net(torch.from_numpy(x)).detach().numpy()
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 0.05


@pytest.mark.parametrize('mode', MODES)
def test_vqvae_prior_is_quantized_and_matches_jax(vq_pair, mode):
    """Finding 1: the JAX table keeps the 'prior' prefix and its
    interceptor calls int8_matmul 0 times in a prior decode step; stripped,
    8 times, as the port's table (keyed from the prior's root) does. The
    port's quantized prior steps against the stripped JAX interceptor,
    within 1e-4 as pixel_transformer's."""
    jmodel, model = vq_pair
    p = jmodel.state.params['prior']
    full = jint8.quantize_dense_tree(jmodel.state.params)
    stripped = {k[1:]: v for k, v in full.items() if k[0] == 'prior'}
    assert len(stripped) == len(full) == 8
    B, T, K = 2, 49, 128
    codes = np.eye(K, dtype=np.float32)[np.random.RandomState(2).randint(0, K, (B, T))]

    def jax_steps(table, steps):
        calls, orig = [], jint8.int8_matmul
        interceptor = jint8.make_dense_interceptor(table, mode, use_pallas=False)
        caches, prev, out = jmodel.prior.init_cache(B), jnp.zeros((B, K)), []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jint8, 'int8_matmul', lambda *a, **k: calls.append(1) or orig(*a, **k))
            for t in range(steps):
                with intercept_ctx(interceptor):
                    logits, caches = jmodel.prior.apply(
                        {'params': p}, prev, caches, t, method=JaxNet.decode_step)
                out.append(np.asarray(logits))
                prev = jnp.asarray(codes[:, t])
        return out, len(calls)

    assert jax_steps(full, 1)[1] == 0
    ref, n_calls = jax_steps(stripped, 6)
    assert n_calls == 8 * 6
    quant, n = build_quant_table(model, mode)
    assert n == 8
    prior, pq = model.net.prior, quant.sub('prior')
    caches, prev = prior.init_cache(B), torch.zeros(B, K)
    with torch.no_grad():
        for t in range(6):
            got = prior.decode_step(prev, caches, t, quant=pq)
            np.testing.assert_allclose(got.numpy(), ref[t], rtol=1e-4, atol=1e-4)
            prev = torch.from_numpy(codes[:, t])


def _first_divergence(a, b):
    """(row, first pixel where a and b differ) of each row that differs."""
    return [(r, int(np.flatnonzero(a[r] != b[r])[0])) for r in range(len(a))
            if not np.array_equal(a[r], b[r])]


@pytest.mark.parametrize('mode', MODES)
def test_quantized_sampling_matches_jax_from_the_same_uniforms(made_pair, mode):
    """The JAX --quantize server's batch at a seed and the port's from that
    seed's uniforms: equal. Where a pixel differs, its uniform lies within
    1e-5 of its probability (a tie that f32 rounding may break either way;
    none occurs here). A request's rows do not depend on the padding: the
    first rows of a larger batch are the smaller batch."""
    jmodel, model = made_pair
    n, seed = 3, 5
    ref = jserve.SampleServer(jmodel, serve_bs=n, quantize=mode).sample(n, seed=seed)
    keys = jax.random.split(jax.random.key(seed), 784)
    u = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)))
    quant, _ = build_quant_table(model, mode)
    with torch.no_grad():
        got = model.sample_fn(n, uniforms=u, with_frames=False, quant=quant)
        two = model.sample_fn(2, uniforms=u[:, :2].contiguous(), with_frames=False, quant=quant)
    assert torch.equal(two, got[:2])
    g, r = got.numpy().reshape(n, 784), np.asarray(ref).reshape(n, 784)
    assert _first_divergence(g, r) == []
    assert 0 < g.mean() < 1


def test_server_refusals_modes_and_stats(made_pair):
    _, model = made_pair
    with pytest.raises(SystemExit, match='choose int8|w8a8|w8a16'):
        serve.SampleServer(model, serve_bs=2, quantize='fp4')
    with pytest.raises(SystemExit, match='large enough to quantize'):
        serve.SampleServer(_port_model(['--model=pixel_transformer', '--n_embed=16',
                                        '--n_head=2', '--n_layer=1']), quantize='w8a8')
    plain = serve.SampleServer(model, serve_bs=2)
    assert (plain.stats()['quantize'], plain.stats()['quantized_kernels']) == (None, 0)
    for flag, mode in (('int8', 'w8a8'), ('w8a8', 'w8a8'), ('w8a16', 'w8a16')):
        srv = serve.SampleServer(model, serve_bs=2, quantize=flag)
        assert (srv.quant_mode, srv.quant_kernels) == (mode, 4)
    out = srv.sample(2, seed=4)
    assert out.shape == (2, 28, 28, 1) and np.isin(out, (0.0, 1.0)).all()
    stats = srv.stats()
    assert (stats['quantize'], stats['quantized_kernels'], stats['requests']) == ('w8a16', 4, 1)
    np.testing.assert_array_equal(srv.sample(2, seed=4), out)


def test_serve_cli_quantized_on_the_cpu(tmp_path):
    out = tmp_path / 'q.png'
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(MADE_FLAGS + ['--device=cpu', '--quantize=int8', '--n=2', '--serve_bs=2',
                                 f'--out={out}'])
    stats = json.loads(next(ln for ln in buf.getvalue().splitlines() if ln.startswith('{')))
    assert (stats['quantize'], stats['quantized_kernels'], stats['model']) == ('w8a8', 4, 'made')
    assert out.read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
