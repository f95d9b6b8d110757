"""The port's PixelCNN (generative_models_tpu_torch/models/pixel_cnn.py)
against the JAX package's on the CPU at the JAX tests' small sizes
(n_filters 8 and 16, 2 layers, kernel 3, 5 and 7, with and without
resblocks): the same weights (JAX params, perturbed, carried over by
convert.pixel_cnn_params_from_jax, HWIO -> OIHW) and the same draws
(jax.random.uniform(split(key, T)[t], (n,)) for step t).

Held: the logits and the loss within 1e-5; every gradient within 1e-5 of
its own norm plus 1e-7 of the whole gradient's, and one Adam step at atol
1e-6 (lr 1e-4); the wavefront decode, teacher-forced, against the port's
own full forward within 1e-4 and against the JAX package's decode within
1e-5 (f32 sums of the same window products; the JAX test's 2e-2 covers its
accelerator's bf16 passes); causality at raster positions and with
resblocks (tests/test_causality.py); sampling and its frames, exactly.

--bf16 (bf16 stacks, f32 loss): the first training step's loss against
the JAX package's --bf16 loss and against the port's f32 loss within 5e-3,
tests/test_regression.py's bound for JAX's bf16 against its f32; the logits
of the two bf16 nets within 3e-2 (relative Frobenius norm; XLA on the CPU
and torch round bf16 at other places: measured 1.0 % apart at (16, 4, 5),
each 1.0-1.1 % from f32; the gated net 0.7 %, each 0.8 %); and the sampler
runs the f32 decode on the same weights: its samples are the f32 model's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.convert import pixel_cnn_params_from_jax
from generative_models_tpu_torch.models.base import flax_init_
from generative_models_tpu_torch.models.pixel_cnn import PixelCNNNet
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

CONFIGS = [(8, 2, 3, 0), (8, 2, 5, 1), (16, 2, 7, 0)]  # n_filters, n_layers, kernel, resblock
SIDE = 8  # the decode walks' canvas


def flags_of(model, cfg):
    f, n, k, *res = cfg
    out = [f'--model={model}', f'--n_filters={f}', f'--n_layers={n}', f'--kernel_size={k}']
    return out + ([f'--use_resblock={res[0]}'] if res else [])


def perturb(params, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.randn(*p.shape).astype(np.float32)),
        params)


def make_pair(tmp_path_factory, flags, convert):
    """(the JAX model with perturbed params, the port's with them, a
    function building another port model from the same flags)."""
    G, Model = jax_parse_args(flags + [f'--logdir={tmp_path_factory.mktemp("j")}'],
                              discover_models=jax_models)
    jm = Model(G)
    jm.state = jm.state.replace(params=perturb(jm.state.params))

    def port(*extra):
        G, Model = parse_args(flags + ['--device=cpu'] + list(extra))
        model = Model(G)
        model.net.load_state_dict(convert(jax.device_get(jm.state.params)))
        return model
    return jm, port(), port


def batch(B=3, seed=1, side=28):
    return (np.random.RandomState(seed).rand(B, side, side, 1) > 0.5).astype(np.float32)


def uniforms(seed, n, T=784):
    keys = jax.random.split(jax.random.key(seed), T)
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)))


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check_loss_and_logits(jm, model):
    x = batch()
    ref_loss, _ = jax.jit(jm.loss)(jm.state.params, jnp.asarray(x))
    with torch.no_grad():
        loss, metrics = model.loss(torch.from_numpy(x))
        got = model.net(torch.from_numpy(x)).numpy()
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5) and set(metrics) == {'nlogp'}
    ref = np.asarray(jax.jit(jm.net.apply)({'params': jm.state.params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def check_gradients_and_adam_step(jm, model, convert):
    params = jm.state.params
    x = batch(2, seed=2)
    (ref_loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, jnp.asarray(x))
    metrics = model.backward(x)
    assert float(metrics['nlogp']) == pytest.approx(float(ref_loss), rel=1e-5)
    ref = convert(jax.device_get(grads))
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref.values())))
    for name, p in model.net.named_parameters():
        if p.grad is None:  # off the loss's graph (the gated net's last ln_v): 0 in JAX
            assert not ref[name].any(), name
            continue
        err = float(torch.linalg.vector_norm(p.grad.double() - ref[name].double()))
        norm = float(torch.linalg.vector_norm(ref[name].double()))
        assert norm > 0 and err <= 1e-5 * norm + 1e-7 * total, (name, err, norm)
    opt = jm.make_optimizer()
    updates, _ = opt.update(grads, opt.init(params), params)
    stepped = convert(jax.device_get(optax.apply_updates(params, updates)))
    for name, p in model.net.named_parameters():
        p.grad = ref[name].float().clone()
    model.apply_grads()
    for name, p in model.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), stepped[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def check_decode(jm, net, input_canvas):
    """Teacher-forced cursor walk over a SIDE x SIDE canvas: the port's
    decode step against its own full forward (1e-4) and the JAX model's
    decode step on the same params (1e-5)."""
    jnet, params, p = jm.net, jm.state.params, net.kernel_size // 2
    x = batch(3, seed=5, side=SIDE)
    with torch.no_grad():
        full = net(torch.from_numpy(x))[..., 0].numpy()
    jcv = jnet.apply({'params': params}, 3, SIDE, method=jm._init_canvases)
    jstep = jax.jit(lambda cv, r, c: jnet.apply({'params': params}, cv, r, c,
                                                method=jm._decode_step))
    cv = net.init_canvases(3, SIDE)
    worst_full = worst_jax = 0.0
    with torch.no_grad():
        for i in range(SIDE * SIDE):
            r, c = divmod(i, SIDE)
            ref, jcv = jstep(jcv, jnp.int32(r), jnp.int32(c))
            logit = net.decode_step(cv, r, c).numpy()
            worst_full = max(worst_full, float(np.abs(logit - full[:, r, c]).max()))
            worst_jax = max(worst_jax, float(np.abs(logit - np.asarray(ref)).max()))
            input_canvas(cv)[:, r + p, c + p, 0] = torch.from_numpy(x[:, r, c, 0])
            jcv = jm._set_c0(jcv, jax.lax.dynamic_update_slice(
                jm._get_c0(jcv), jnp.asarray(x[:, r:r + 1, c:c + 1]), (0, r + p, c + p, 0)))
    assert worst_full < 1e-4 and worst_jax < 1e-5, (worst_full, worst_jax)


def raster_causal_check(net, j, side=10):
    """Perturb raster position j: the logits at positions <= j stay."""
    x0 = torch.full((1, side, side, 1), 0.5)
    x1 = x0.clone().reshape(-1)
    x1[j] += 10.0
    with torch.no_grad():
        out0 = net(x0).reshape(-1)
        out1 = net(x1.reshape(x0.shape)).reshape(-1)
    np.testing.assert_allclose(out0[: j + 1].numpy(), out1[: j + 1].numpy(), atol=1e-4)


@pytest.fixture(scope='module', params=CONFIGS, ids=[f'f{c[0]}-l{c[1]}-k{c[2]}-res{c[3]}'
                                                     for c in CONFIGS])
def pair(request, tmp_path_factory):
    return make_pair(tmp_path_factory, flags_of('pixel_cnn', request.param),
                     pixel_cnn_params_from_jax)


def test_logits_and_loss_match_jax(pair):
    check_loss_and_logits(*pair[:2])


def test_gradients_and_adam_step_match_jax(pair):
    jm, _, port = pair
    check_gradients_and_adam_step(jm, port(), pixel_cnn_params_from_jax)


def test_decode_matches_the_full_forward_and_jax(pair):
    jm, model, _ = pair
    check_decode(jm, model.net, PixelCNNNet.input_canvas)


@pytest.mark.parametrize('use_resblock,positions', [(False, [0, 1, 13, 99]),
                                                   (True, [0, 25, 99])])
def test_causality(use_resblock, positions):
    net = PixelCNNNet(8, 2, 5, use_resblock)
    flax_init_(net, torch.Generator().manual_seed(0))
    for j in positions:
        raster_causal_check(net, j)


def test_sampling_and_frames_match_jax_from_the_same_uniforms(pair):
    jm, model, _ = pair
    n, seed = 2, 4
    samples, frames = jm._jit_sample(jm.state, n, jax.random.key(seed))
    with torch.no_grad():
        got, got_frames = model.sample_fn(n, uniforms=uniforms(seed, n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(samples))
    np.testing.assert_array_equal(got_frames.numpy(), np.asarray(frames))
    assert 0 < float(got.mean()) < 1


def bf16_case(tmp_path_factory, model_name, cfg, convert):
    """The --bf16 checks of the module docstring, for pixel_cnn or
    gated_pixel_cnn at cfg."""
    flags = flags_of(model_name, cfg)
    jm32, model32, port = make_pair(tmp_path_factory, flags, convert)
    G, Model = jax_parse_args(flags + ['--bf16=1', f'--logdir={tmp_path_factory.mktemp("j")}'],
                              discover_models=jax_models)
    jmbf = Model(G)
    jmbf.state = jmbf.state.replace(params=jm32.state.params)
    modelbf = port('--bf16=1')
    x = batch(4, seed=6)
    jlog = np.asarray(jax.jit(jmbf.net.apply)({'params': jm32.state.params}, jnp.asarray(x)),
                      np.float32)
    with torch.no_grad():
        got = modelbf.net(torch.from_numpy(x)).float().numpy()
        f32 = model32.net(torch.from_numpy(x)).numpy()
        s_bf = modelbf.sample_fn(2, uniforms=uniforms(3, 2), with_frames=False)
        s_32 = model32.sample_fn(2, uniforms=uniforms(3, 2), with_frames=False)
    assert rel(got, jlog) < 3e-2 and rel(got, f32) < 3e-2, (rel(got, jlog), rel(got, f32))
    assert torch.equal(s_bf, s_32)
    a = float(jmbf.train_step(jnp.asarray(x), None)['nlogp'])
    b = float(modelbf.train_step(x)['nlogp'])
    c = float(model32.train_step(x)['nlogp'])
    assert abs(a - b) < 5e-3 and abs(b - c) < 5e-3, (a, b, c)


def test_bf16_training_matches_jax_bf16(tmp_path_factory):
    bf16_case(tmp_path_factory, 'pixel_cnn', (16, 4, 5, 0), pixel_cnn_params_from_jax)
