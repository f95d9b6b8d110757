"""The port's training step (generative_models_tpu_torch/models/base.py,
models/pixel_transformer.py) against the JAX package on the CPU: weights
from a JAX init carried over by convert.params_from_jax, then the loss and
every parameter's gradient of one batch against
jax.value_and_grad(PixelTransformer.loss) (dense attention on the CPU); the
optimizer (Adam, --grad_clip, --grad_accum, the lr schedules) fed the same
numpy gradients as the JAX package's optax chain; and --remat against no
remat. About 25 s here."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generative_models_tpu.models.base import GM as JaxGM
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.convert import params_from_jax
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

FLAGS = ['--model=pixel_transformer', '--n_layer=2', '--n_embed=16', '--n_head=2']


def _port(*flags):
    G, Model = parse_args(FLAGS + ['--device=cpu', *flags])
    return Model(G)


@pytest.fixture(scope='module')
def jax_model(tmp_path_factory):
    G, Model = jax_parse_args(
        FLAGS + [f'--logdir={tmp_path_factory.mktemp("jax")}'], discover_models=jax_models
    )
    return Model(G)


def _batch(B=3, seed=0):
    return (np.random.RandomState(seed).rand(B, 28, 28, 1) > 0.6).astype(np.float32)


def _params_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_loss_and_every_grad_match_jax(jax_model):
    params = jax_model.state.params
    x = _batch()
    loss_fn = lambda p, x: jax_model.loss(p, x, None, None, True)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jnp.asarray(x))
    model = _port()
    model.net.load_state_dict(params_from_jax(_params_np(params)))
    metrics = model.backward(x)
    np.testing.assert_allclose(float(metrics['nlogp']), float(loss), rtol=1e-6)
    ref = params_from_jax(_params_np(grads))
    got = {k: p.grad for k, p in model.net.named_parameters()}
    assert set(got) == set(ref)
    for name, g in got.items():
        assert g is not None, name
        # f32 sums over 3 x 784 tokens in another order
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=2e-4, atol=1e-6, err_msg=name)


def test_remat_gives_the_same_grads():
    x = _batch(seed=1)
    grads = []
    for remat in (0, 1):
        model = _port(f'--remat={remat}')
        model.backward(x)
        grads.append({k: p.grad.clone() for k, p in model.net.named_parameters()})
    for name, g in grads[0].items():
        np.testing.assert_allclose(grads[1][name].numpy(), g.numpy(), rtol=1e-6, atol=1e-9, err_msg=name)


def _optax_chain(flags):
    """The JAX package's make_optimizer for these flags."""
    G, _ = jax_parse_args(FLAGS + flags, discover_models=jax_models)

    class Knobs:
        pass

    knobs = Knobs()
    knobs.G = G
    knobs.lr_schedule = lambda: JaxGM.lr_schedule(knobs)
    return JaxGM.make_optimizer(knobs)


OPT_CASES = {
    'adam': ([], 3),
    'clip': (['--grad_clip=0.5'], 3),  # step 1's gradients are below the norm
    'accum': (['--grad_accum=2'], 4),
    'warmup': (['--warmup_steps=3'], 4),
    'cosine': (['--lr_scheduler=cosine', '--warmup_steps=2', '--lr_decay_steps=3'], 6),
    'cosine_clip_accum': (['--lr_scheduler=cosine', '--warmup_steps=1', '--lr_decay_steps=2',
                           '--grad_clip=0.5', '--grad_accum=2'], 6),
}


@pytest.mark.parametrize('case', sorted(OPT_CASES))
def test_optimizer_steps_match_optax(jax_model, case):
    """The same numpy gradients, micro-step by micro-step, through optax's
    chain and the port's apply_grads; the params after every micro-step."""
    flags, steps = OPT_CASES[case]
    params = _params_np(jax_model.state.params)
    tx = _optax_chain(flags)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    model = _port(*flags)
    model.net.load_state_dict(params_from_jax(params))
    named = dict(model.net.named_parameters())
    rng = np.random.RandomState(5)
    for step in range(steps):
        scale = 0.001 if step == 1 else 0.1  # global norm ~0.03 or ~3
        g = jax.tree_util.tree_map(
            lambda p: (scale * rng.randn(*p.shape)).astype(np.float32), params
        )
        updates, opt_state = update(g, opt_state, params)
        params = _params_np(optax.apply_updates(params, updates))
        for name, gt in params_from_jax(g).items():
            named[name].grad = gt.clone()
        model.apply_grads()
        for name, ref in params_from_jax(params).items():
            np.testing.assert_allclose(
                named[name].detach().numpy(), ref.numpy(), rtol=1e-6, atol=1e-7,
                err_msg=f'{case} step {step} {name}',
            )


@pytest.mark.parametrize('flags', [
    [], ['--warmup_steps=5'],
    ['--lr_scheduler=cosine', '--lr_decay_steps=7'],
    ['--lr_scheduler=cosine', '--warmup_steps=3', '--lr_decay_steps=6'],
])
def test_lr_schedule_matches_optax(flags):
    G, Model = jax_parse_args(FLAGS + flags, discover_models=jax_models)

    class Knobs:
        pass

    knobs = Knobs()
    knobs.G = G
    sched = JaxGM.lr_schedule(knobs)
    model = _port(*flags)
    for count in range(15):
        ref = sched(count) if callable(sched) else sched
        assert model.lr_at(count) == pytest.approx(float(ref), rel=1e-6, abs=1e-12), count
    if G.warmup_steps:
        assert model.lr_at(0) == 0.0  # the first update after warmup starts uses lr 0


def test_train_step_counts_micro_steps_and_moves_params():
    model = _port('--grad_accum=2')
    w0 = model.net.embed.weight.detach().clone()
    model.train_step(_batch(seed=2))
    assert (model.step, model.updates, model.mini_step) == (1, 0, 1)
    assert torch.equal(model.net.embed.weight, w0)  # mid-window: no update
    model.train_step(_batch(seed=3))
    assert (model.step, model.updates, model.mini_step) == (2, 1, 0)
    assert not torch.equal(model.net.embed.weight, w0)
