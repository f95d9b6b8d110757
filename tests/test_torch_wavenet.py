"""The port's Wavenet (generative_models_tpu_torch/models/wavenet.py)
against the JAX package's on the CPU, at hidden_size 8 and 128, with and
without resblocks: the same weights (JAX params, perturbed, carried over by
convert.wavenet_params_from_jax, each (2, C, F) kernel as its two taps) and
the same draws (jax.random.uniform(split(key, T)[t], (n,)) for step t).

Held: the full forward and the loss in f32 within 1e-5; the port's bf16 net
against the JAX package's WavenetNet(dtype=bfloat16) built here; the
incremental decode against the full forward (tests/test_wavenet_decode.py's
tolerance, rtol 2e-4 + atol 2e-5); causality (tests/test_causality.py's
case); sampling and its frames, exactly; every gradient within 1e-5 of its
own norm plus 1e-7 of the whole gradient's and one Adam step at atol 1e-6;
and at hidden_size=128 --quantize (w8a8 and w8a16): the nine res1x1 in the
table, the quantized decode step against JAX's under its interceptor (the
Pallas kernels in interpret mode) within 1e-4, a quantized request against
JAX's SampleServer, and --use_resblock=0, which has nothing to quantize,
refused by both.

The bf16 bound: XLA on the CPU and torch round bf16 differently in places
(sigmoid and the rounding of a bf16 product's output differ by one bf16 ulp
at some elements), so the two bf16 nets sit as far apart as each sits from
the f32 net: measured 0.3-1.3 % (relative Frobenius norm of the logits over
784 positions). Bound: 3e-2 between them and of each from f32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generative_models_tpu import serve as jserve
from generative_models_tpu.models.base import intercept_ctx
from generative_models_tpu.models.wavenet import WavenetNet as JaxNet
from generative_models_tpu.ops import int8 as jint8
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch import serve
from generative_models_tpu_torch.convert import quant_table_from_jax, wavenet_params_from_jax
from generative_models_tpu_torch.models.base import flax_init_
from generative_models_tpu_torch.models.wavenet import WavenetNet
from generative_models_tpu_torch.ops import int8 as tint8
from generative_models_tpu_torch.ops.int8 import QuantTable, build_quant_table
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

MODES = ['w8a8', 'w8a16']
BF16_REL = 3e-2
WIDTHS = [(8, 1), (8, 0), (128, 1), (128, 0)]


def _flags(C, res):
    return ['--model=wavenet', f'--hidden_size={C}', f'--use_resblock={res}']


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.randn(*p.shape).astype(np.float32)),
        params)


def _port(flags, params):
    G, Model = parse_args(flags + ['--device=cpu'], DG=serve.serve_defaults())
    model = Model(G)
    model.net.load_state_dict(wavenet_params_from_jax(jax.device_get(params)))
    return model


@pytest.fixture(scope='module', params=WIDTHS, ids=[f'C{c}-res{r}' for c, r in WIDTHS])
def pair(request, tmp_path_factory):
    flags = _flags(*request.param)
    G, Model = jax_parse_args(flags + [f'--logdir={tmp_path_factory.mktemp("j")}'],
                              discover_models=jax_models)
    jm = Model(G)
    jm.state = jm.state.replace(params=_perturb(jm.state.params))
    return jm, _port(flags, jm.state.params), flags


def _batch(B=3, seed=1):
    return (np.random.RandomState(seed).rand(B, 28, 28, 1) > 0.5).astype(np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _uniforms(seed, n, T=784):
    keys = jax.random.split(jax.random.key(seed), T)
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)))


def test_full_forward_and_loss_match_jax(pair):
    jm, model, _ = pair
    x = _batch()
    ref_loss, _ = jax.jit(jm.loss)(jm.state.params, jnp.asarray(x))
    with torch.no_grad():
        loss, _ = model.loss(torch.from_numpy(x))
        seq = model.inputs(torch.from_numpy(x))
        got = model.net(seq).numpy()
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    ref = np.asarray(jax.jit(jm.net.apply)({'params': jm.state.params}, jnp.asarray(seq.numpy())))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_bf16_net_matches_the_jax_bf16_net(pair):
    """The compute dtype the card takes, on the CPU: the port's
    WavenetNet(dtype=bfloat16) against JAX's on the same params (module
    docstring: the bound)."""
    jm, model, _ = pair
    seq = model.inputs(torch.from_numpy(_batch(2, seed=2)))
    jb = JaxNet(res_channels=model.net.res_channels, use_resblock=model.net.use_resblock,
                dtype=jnp.bfloat16)
    ref = np.asarray(jax.jit(jb.apply)({'params': jm.state.params}, jnp.asarray(seq.numpy())))
    f32 = np.asarray(jax.jit(jm.net.apply)({'params': jm.state.params}, jnp.asarray(seq.numpy())))
    net = WavenetNet(model.net.res_channels, model.net.use_resblock, dtype=torch.bfloat16)
    net.load_state_dict(model.net.state_dict())
    with torch.no_grad():
        got = net(seq)
    assert got.dtype == torch.float32  # out_dense stays f32
    got = got.numpy()
    assert _rel(got, ref) < BF16_REL and _rel(got, f32) < BF16_REL and _rel(ref, f32) < BF16_REL


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('use_resblock', [True, False])
def test_decode_step_matches_full_forward(use_resblock, dtype):
    """tests/test_wavenet_decode.py's case on the port: T=40, C=8, four
    layers; in bf16 too (both paths round at the same places)."""
    T, n = 40, 3
    net = WavenetNet(8, use_resblock, layer_size=4, dtype=dtype)
    flax_init_(net, torch.Generator().manual_seed(0))
    s = torch.from_numpy(np.random.RandomState(0).randn(n, T, 3).astype(np.float32))
    with torch.no_grad():
        full = net(s)
        buffers, prev, steps = net.init_buffers(n), torch.zeros(n, 3), []
        for t in range(T):
            logit, buffers = net.decode_step(buffers, prev, t)
            steps.append(logit)
            prev = s[:, t]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), rtol=2e-4, atol=2e-5)


def test_causality():
    """tests/test_causality.py's wavenet case: a pixel perturbed at j moves
    no logit at or before j, and moves a later one."""
    net = WavenetNet(8, True, layer_size=5)
    flax_init_(net, torch.Generator().manual_seed(0))
    T = 64
    x0 = torch.full((1, T, 3), 0.3)
    with torch.no_grad():
        out0 = net(x0)[0]
        for j in (0, 7, 40, T - 1):
            x1 = x0.clone()
            x1[0, j, 0] += 10.0
            out1 = net(x1)[0]
            np.testing.assert_allclose(out0[: j + 1].numpy(), out1[: j + 1].numpy(), atol=1e-4)
            if j < T - 1:
                assert (out0[j + 1:] - out1[j + 1:]).abs().max() > 1e-6


def test_sampling_and_frames_match_jax_from_the_same_uniforms(pair):
    jm, model, _ = pair
    n, seed = 2, 4
    samples, frames = jm._jit_sample(jm.state, n, jax.random.key(seed))
    with torch.no_grad():
        got, got_frames = model.sample_fn(n, uniforms=_uniforms(seed, n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(samples))
    np.testing.assert_array_equal(got_frames.numpy(), np.asarray(frames))
    assert 0 < float(got.mean()) < 1


def test_gradients_and_adam_step_match_jax(pair):
    jm, _, flags = pair
    params = jm.state.params
    model = _port(flags, params)  # its own: the step moves it
    x = _batch(2, seed=3)
    (ref_loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, jnp.asarray(x))
    metrics = model.backward(x)
    assert float(metrics['nlogp']) == pytest.approx(float(ref_loss), rel=1e-5)
    ref = wavenet_params_from_jax(jax.device_get(grads))
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref.values())))
    for name, p in model.net.named_parameters():
        err = float(torch.linalg.vector_norm(p.grad.double() - ref[name].double()))
        norm = float(torch.linalg.vector_norm(ref[name].double()))
        assert norm > 0 and err <= 1e-5 * norm + 1e-7 * total, (name, err, norm)
    opt = jm.make_optimizer()
    updates, _ = opt.update(grads, opt.init(params), params)
    stepped = wavenet_params_from_jax(jax.device_get(optax.apply_updates(params, updates)))
    for name, p in model.net.named_parameters():
        p.grad = ref[name].float().clone()
    model.apply_grads()
    for name, p in model.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), stepped[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


@pytest.fixture(scope='module')
def wide(tmp_path_factory):
    """hidden_size=128 with resblocks: nine res1x1 of 128 x 128 clear the
    quantizer's thresholds."""
    flags = _flags(128, 1)
    G, Model = jax_parse_args(flags + [f'--logdir={tmp_path_factory.mktemp("j")}'],
                              discover_models=jax_models)
    jm = Model(G)
    return jm, _port(flags, jm.state.params)


@pytest.mark.parametrize('mode', MODES)
def test_quantized_decode_step_matches_jax(wide, mode):
    """The nine res1x1 are the table on both sides, bitwise; teacher-forced
    decode steps of the quantized net against JAX's decode_step under its
    interceptor (interpret-mode Pallas): nine int8_matmul a step, the
    logits within 1e-4; the residual stream turns f32 at the first
    quantized block, as the interceptor's result_type does."""
    jm, model = wide
    params = jm.state.params
    table = jint8.quantize_dense_tree(params)
    assert sorted(table) == sorted((f'block{i}', 'res1x1') for i in range(9))
    quant, n_q = build_quant_table(model, mode)
    assert n_q == 9 and sorted(quant.dense) == sorted(f'blocks.{i}.res1x1' for i in range(9))
    for name, (q, s) in quant_table_from_jax(table).items():
        assert torch.equal(quant.dense[name][0], q) and torch.equal(quant.dense[name][1], s)
    interceptor = jint8.make_dense_interceptor(table, mode, use_pallas=True)

    @jax.jit
    def jstep(buffers, s_prev, t):
        with intercept_ctx(interceptor):
            return jm.net.apply({'params': params}, buffers, s_prev, t, method=JaxNet.decode_step)

    B, steps = 2, 5
    s = np.random.RandomState(4).rand(steps, B, 3).astype(np.float32)
    jbuf = jm.net.apply({'params': params}, B, method=JaxNet.init_buffers)
    buf, jprev, prev = model.net.init_buffers(B), jnp.zeros((B, 3)), torch.zeros(B, 3)
    calls, orig = [], tint8.int8_matmul
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tint8, 'int8_matmul', lambda *a, **k: calls.append(1) or orig(*a, **k))
        q = QuantTable(mode, quant_table_from_jax(table))
        for t in range(steps):
            ref, jbuf = jstep(jbuf, jprev, jnp.int32(t))
            got, buf = model.net.decode_step(buf, prev, t, q)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
            jprev, prev = jnp.asarray(s[t]), torch.from_numpy(s[t])
    assert len(calls) == 9 * steps


@pytest.mark.parametrize('mode', MODES)
def test_quantized_request_matches_the_jax_server(wide, mode):
    jm, model = wide
    n, seed = 2, 5
    jsrv = jserve.SampleServer(jm, serve_bs=n, quantize=mode)
    assert jsrv.quant_kernels == 9
    ref = np.asarray(jsrv.sample(n, seed=seed))
    srv = serve.SampleServer(model, serve_bs=n, quantize=mode)
    assert (srv.quant_mode, srv.quant_kernels) == (mode, 9)
    with torch.no_grad():
        got = model.sample_fn(n, uniforms=_uniforms(seed, n), with_frames=False, quant=srv.quant)
        x = torch.from_numpy(ref.copy())
        chain = model.teacher_forced_logits(x, srv.quant)
        full = model.net(model.inputs(x), srv.quant)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the quantized full forward (the scoring form) is the chain's logits
    np.testing.assert_allclose(full.numpy(), chain.numpy(), rtol=1e-5, atol=1e-5)


def test_quantize_without_resblocks_exits_as_jax(tmp_path_factory):
    """--use_resblock=0: the dilated convs' kernels are 3-D and out_dense
    is 128 x 1, so nothing clears the thresholds and both servers exit."""
    flags = _flags(128, 0)
    G, Model = jax_parse_args(flags + [f'--logdir={tmp_path_factory.mktemp("j")}'],
                              discover_models=jax_models)
    with pytest.raises(SystemExit, match='large enough'):
        jserve.SampleServer(Model(G), serve_bs=2, quantize='w8a8')
    with pytest.raises(SystemExit, match='large enough'):
        serve.SampleServer(_port(flags, Model(G).state.params), serve_bs=2, quantize='w8a8')
