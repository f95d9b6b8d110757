"""The port's Pixel-RNN (generative_models_tpu_torch/models/rnn.py) against
the JAX package's on the CPU at hidden_size=64: the same weights (JAX
params, perturbed, carried over by convert.rnn_params_from_jax) and the
same draws (jax.random.uniform(split(key, T)[t], (n,)) for step t, handed
to the port's sample_fn). The logits and loss; every gradient and one Adam
step against optax; the location grid, bitwise; causality of the shifted
input; sampling and its frames; and --quantize (w8a8 and w8a16): the table,
the quantized decode step against JAX's under its interceptor (the Pallas
kernels in interpret mode), and a quantized request against JAX's
SampleServer.

Tolerances (f32 on both sides): logits and loss within 1e-5; each gradient
within 1e-4 of its own norm plus 1e-6 of the whole gradient's (784 steps of
backpropagation through the cell, summed in another order); the Adam step
atol 1e-6 (it moves a parameter by up to lr = 3e-4); samples exactly (a
pixel whose uniform lies within rounding of its probability could differ;
none does here). The quantized step within 1e-4, as pixel_transformer's
(tests/test_torch_quant_serve.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generative_models_tpu import serve as jserve
from generative_models_tpu.models.base import intercept_ctx
from generative_models_tpu.models.rnn import LSTMPixelNet as JaxLSTM
from generative_models_tpu.models.rnn import location_grid as jax_location_grid
from generative_models_tpu.ops import int8 as jint8
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch import serve
from generative_models_tpu_torch.convert import quant_table_from_jax, rnn_params_from_jax
from generative_models_tpu_torch.models.base import flax_init_
from generative_models_tpu_torch.models.rnn import (
    LSTMPixelNet, location_grid, sampling_locations,
)
from generative_models_tpu_torch.ops import int8 as tint8
from generative_models_tpu_torch.ops.int8 import QuantTable, build_quant_table
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

FLAGS = ['--model=rnn', '--hidden_size=64']
MODES = ['w8a8', 'w8a16']


def _jax_model(tmp_path_factory, *flags):
    G, Model = jax_parse_args(FLAGS + list(flags) + [f'--logdir={tmp_path_factory.mktemp("j")}'],
                              discover_models=jax_models)
    return Model(G)


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.randn(*p.shape).astype(np.float32)),
        params)


def _port(params, *flags):
    G, Model = parse_args(FLAGS + ['--device=cpu'] + list(flags), DG=serve.serve_defaults())
    model = Model(G)
    model.net.load_state_dict(rnn_params_from_jax(jax.device_get(params)))
    return model


@pytest.fixture(scope='module', params=[1, 0], ids=['append_loc', 'no_loc'])
def pair(request, tmp_path_factory):
    jm = _jax_model(tmp_path_factory, f'--append_loc={request.param}')
    params = _perturb(jm.state.params)
    jm.state = jm.state.replace(params=params)
    return jm, _port(params, f'--append_loc={request.param}')


def _uniforms(seed, n, T=784):
    keys = jax.random.split(jax.random.key(seed), T)
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)))


def test_location_grid_and_sampling_locations_are_the_jax_values_bitwise():
    for side in (28, 32):
        np.testing.assert_array_equal(location_grid(side).numpy(), np.asarray(jax_location_grid(side)))
        i = jnp.arange(side * side)
        ref = jnp.stack([(i // side) / (side - 1), (i % side) / (side - 1)], -1).astype(jnp.float32)
        np.testing.assert_array_equal(sampling_locations(side).numpy(), np.asarray(ref))
    # the two forms differ in the last bit at some positions: each is kept
    assert not np.array_equal(sampling_locations(28).numpy().reshape(28, 28, 2),
                              location_grid(28).numpy())


def test_logits_and_loss_match_jax(pair):
    jm, model = pair
    x = (np.random.RandomState(1).rand(4, 28, 28, 1) > 0.5).astype(np.float32)
    ref_loss, _ = jax.jit(jm.loss)(jm.state.params, jnp.asarray(x))
    with torch.no_grad():
        loss, metrics = model.loss(torch.from_numpy(x))
        seq = model.shifted_inputs(torch.from_numpy(x))
        got = model.net(seq).numpy()
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    assert set(metrics) == {'nlogp'}
    ref = np.asarray(jm.net.apply({'params': jm.state.params}, jnp.asarray(seq.numpy())))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_gradients_and_adam_step_match_jax(pair):
    jm, _ = pair
    params = jm.state.params
    model = _port(params, f'--append_loc={jm.G.append_loc}')  # its own: the step moves it
    x = (np.random.RandomState(2).rand(4, 28, 28, 1) > 0.5).astype(np.float32)
    (ref_loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, jnp.asarray(x))
    metrics = model.backward(x)
    assert float(metrics['nlogp']) == pytest.approx(float(ref_loss), rel=1e-5)
    ref = rnn_params_from_jax(jax.device_get(grads))
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref.values())))
    for name, p in model.net.named_parameters():
        err = float(torch.linalg.vector_norm(p.grad.double() - ref[name].double()))
        norm = float(torch.linalg.vector_norm(ref[name].double()))
        assert norm > 0 and err <= 1e-4 * norm + 1e-6 * total, (name, err, norm)
    opt = jm.make_optimizer()
    updates, _ = opt.update(grads, opt.init(params), params)
    stepped = rnn_params_from_jax(jax.device_get(optax.apply_updates(params, updates)))
    for name, p in model.net.named_parameters():
        p.grad = ref[name].float().clone()
    model.apply_grads()
    for name, p in model.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), stepped[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_shifted_input_causality():
    """As tests/test_causality.py's LSTM case: the loss path right-shifts,
    so the logits at t see inputs before t only; a later one moves."""
    net = LSTMPixelNet(16, 1)
    flax_init_(net, torch.Generator().manual_seed(0))
    T, j = 12, 6
    x0 = torch.full((1, T, 1), 0.5)
    shift = lambda x: torch.cat([torch.zeros(1, 1, 1), x[:, :-1]], 1)
    x1 = x0.clone()
    x1[0, j, 0] += 5.0
    with torch.no_grad():
        out0, out1 = net(shift(x0))[0], net(shift(x1))[0]
    np.testing.assert_allclose(out0[: j + 1].numpy(), out1[: j + 1].numpy(), atol=1e-5)
    assert (out0[j + 1:] - out1[j + 1:]).abs().max() > 1e-6


def test_sampling_and_frames_match_jax_from_the_same_uniforms(pair):
    jm, model = pair
    n, seed = 3, 4
    samples, frames = jm._jit_sample(jm.state, n, jax.random.key(seed))
    with torch.no_grad():
        got, got_frames = model.sample_fn(n, uniforms=_uniforms(seed, n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(samples))
    np.testing.assert_array_equal(got_frames.numpy(), np.asarray(frames))
    assert 0 < float(got.mean()) < 1


@pytest.fixture(scope='module')
def loc_pair(tmp_path_factory):
    jm = _jax_model(tmp_path_factory)
    return jm, _port(jm.state.params)


@pytest.mark.parametrize('mode', MODES)
def test_quantized_decode_step_matches_jax(loc_pair, mode):
    """wh (64 x 256) is the one quantized weight, in the JAX table and the
    port's, bitwise; teacher-forced decode steps of the quantized chain
    against LSTMPixelNet.step under JAX's interceptor (its Pallas kernels
    in interpret mode): one int8_matmul a step on each side, the logits
    within 1e-4."""
    jm, model = loc_pair
    params = jm.state.params
    table = jint8.quantize_dense_tree(params)
    quant, n_q = build_quant_table(model, mode)
    assert n_q == 1 and list(quant.dense) == ['wh'] == [k for (k,) in table]
    ref_q = quant_table_from_jax(table)['wh']
    assert torch.equal(quant.dense['wh'][0], ref_q[0]) and torch.equal(quant.dense['wh'][1], ref_q[1])
    interceptor = jint8.make_dense_interceptor(table, mode, use_pallas=True)

    @jax.jit
    def jstep(carry, x_t):
        with intercept_ctx(interceptor):
            return jm.net.apply({'params': params}, carry, x_t, method=JaxLSTM.step)

    B, steps = 3, 6
    xs = np.random.RandomState(3).rand(steps, B, 3).astype(np.float32)
    carry = (jnp.zeros((B, 64)), jnp.zeros((B, 64)))
    h = c = torch.zeros(B, 64)
    calls, orig = [], tint8.int8_matmul
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tint8, 'int8_matmul', lambda *a, **k: calls.append(1) or orig(*a, **k))
        products = model.net.products(QuantTable(mode, quant_table_from_jax(table)))
        for t in range(steps):
            carry, ref = jstep(carry, jnp.asarray(xs[t]))
            h, c, got = model.net.step(h, c, torch.from_numpy(xs[t]), products)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    assert len(calls) == steps
    np.testing.assert_allclose(h.numpy(), np.asarray(carry[0]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('mode', MODES)
def test_quantized_request_matches_the_jax_server(loc_pair, mode):
    """The JAX --quantize server's batch at a seed and the port's quantized
    sampling from that seed's uniforms: equal. The port's server reports
    quant_kernels == 1 and answers a seeded request twice alike."""
    jm, model = loc_pair
    n, seed = 2, 5
    jsrv = jserve.SampleServer(jm, serve_bs=n, quantize=mode)
    assert jsrv.quant_kernels == 1
    ref = np.asarray(jsrv.sample(n, seed=seed))
    srv = serve.SampleServer(model, serve_bs=n, quantize=mode)
    assert (srv.quant_mode, srv.quant_kernels) == (mode, 1)
    with torch.no_grad():
        got = model.sample_fn(n, uniforms=_uniforms(seed, n), with_frames=False, quant=srv.quant)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(srv.sample(n, seed=1), srv.sample(n, seed=1))


@pytest.mark.parametrize('mode', MODES)
def test_quantized_full_forward_is_the_teacher_forced_chain(loc_pair, mode):
    """The full forward under quant= (the scoring form of a quantized
    request) equals the quantized sampling chain fed the same pixels, and
    both lie within 0.05 (relative) of the unquantized logits, the JAX
    package's bound (tests/test_int8.py)."""
    _, model = loc_pair
    quant, _ = build_quant_table(model, mode)
    x = torch.from_numpy((np.random.RandomState(7).rand(2, 28, 28, 1) > 0.5).astype(np.float32))
    with torch.no_grad():
        full = model.net(model.shifted_inputs(x), quant)
        chain = model.teacher_forced_logits(x, quant)
        exact = model.net(model.shifted_inputs(x))
    np.testing.assert_allclose(full.numpy(), chain.numpy(), rtol=1e-5, atol=1e-5)
    assert float(torch.linalg.vector_norm(full - exact) / torch.linalg.vector_norm(exact)) < 0.05


def test_pad32_logits_and_loss_match_jax(tmp_path_factory):
    """--pad32=1: a 32 x 32 canvas of 1024 steps, its location grid from
    side 32, against the JAX package's."""
    jm = _jax_model(tmp_path_factory, '--pad32=1')
    model = _port(jm.state.params, '--pad32=1')
    assert (model.side, model.canvas_size) == (32, 1024)
    x = (np.random.RandomState(8).rand(2, 32, 32, 1) > 0.5).astype(np.float32)
    ref_loss, _ = jax.jit(jm.loss)(jm.state.params, jnp.asarray(x))
    with torch.no_grad():
        loss, _ = model.loss(torch.from_numpy(x))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
