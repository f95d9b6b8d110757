"""The port's diffusion model (generative_models_tpu_torch/models/diffusion/
model.py) against the JAX package's on the CPU, at hidden_size=32,
timesteps=4, bf16=0: the same weights (JAX params, perturbed so that no
gradient is zero behind the zero-init convs, carried over by
convert.diffusion_params_from_jax) and the JAX package's draws, split from
its keys as it splits them. The eval and train losses of the four mean
types, every parameter's gradient and one Adam step against optax; the
step1 and step2 distillation losses from a teacher; the EMA's hand math,
sampling from it, and its checkpoint; a restored train state that steps
exactly as an uninterrupted one, with Adam's step counters on the CPU; the
training CLI's artifacts (model.pt, hps.yaml, the grid's TensorBoard event
file and the three chain GIFs), hps.yaml read by both packages, and the
default --eval_heavy=1 parsed as the JAX package's.

Tolerances (f32 on both sides): losses rtol 1e-5; each gradient within
1e-4 of its own norm plus 1e-6 of the whole gradient's; the port's Adam
step on the JAX gradients against optax's, atol 1e-6 (the step moves each
parameter by up to lr = 3e-4).
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import generative_models_tpu_torch.data.mnist as tm
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import dump_hps as jax_dump_hps
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.convert import diffusion_params_from_jax
from generative_models_tpu_torch.main import main
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

FLAGS = ['--model=diffusion_model', '--hidden_size=32', '--timesteps=4', '--bf16=0',
         '--eval_heavy=0']
EVAL_RNG_TAG = 0x7FFFFFFF  # the JAX package's GM.EVAL_RNG_TAG


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_model(tmp_path, *flags):
    G, Model = jax_parse_args(FLAGS + list(flags) + [f'--logdir={tmp_path / "jax"}'],
                              discover_models=jax_models)
    return Model(G)


def _port(*flags, params=None):
    G, Model = parse_args(FLAGS + ['--device=cpu'] + list(flags))
    model = Model(G)
    if params is not None:
        model.net.load_state_dict(diffusion_params_from_jax(_np(params)))
    return model


def _perturb(params, seed=0, scale=0.05):
    """Every parameter moved by scale * N(0, 1): the zero-init convs no
    longer zero the gradients behind them."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.randn(*p.shape).astype(np.float32)),
        params)


def _batch(B=4, seed=0):
    rng = np.random.RandomState(seed)
    x = np.clip(rng.randn(B, 28, 28, 1), -1, 1).astype(np.float32)
    y = np.array([0, 3, 7, 9, 1, 5][:B], np.int32)
    return x, y


def jax_model_draws(rng, y_shape, x_shape, num_steps, step2=False):
    """The draws of the JAX DiffusionModel.loss at rng: its split into
    (drop, loss, net), then GaussianDiffusion.training_losses' split of the
    loss key into (eps, u or i, w)."""
    rng_drop, rng_loss, _ = jax.random.split(rng, 3)
    rng_eps, rng_u, rng_w = jax.random.split(rng_loss, 3)
    u = (jax.random.randint(rng_u, (x_shape[0],), 0, num_steps) if step2
         else jax.random.uniform(rng_u, (x_shape[0],), jnp.float32))
    return dict(drop=_t(jax.random.uniform(rng_drop, y_shape)),
                eps=_t(jax.random.normal(rng_eps, x_shape, jnp.float32)), u=_t(u),
                w=_t(jax.random.uniform(rng_w, (x_shape[0],), jnp.float32)))


def _check_grads(model, ref_grads):
    ref = diffusion_params_from_jax(_np(ref_grads))
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref.values())))
    for name, p in model.net.named_parameters():
        err = float(torch.linalg.vector_norm(p.grad.double() - ref[name].double()))
        norm = float(torch.linalg.vector_norm(ref[name].double()))
        assert norm > 0, name
        assert err <= 1e-4 * norm + 1e-6 * total, (name, err, norm)


@pytest.mark.parametrize('mean_type', ['eps', 'x', 'v', 'both'])
def test_losses_gradients_and_adam_step_match_jax(tmp_path, mean_type):
    """The eval loss (no label drop, the eval key's draws) and the train
    loss (labels dropped where the drop uniforms fall under cf_drop_prob),
    every parameter's gradient of the train loss, and one Adam step: the
    port's optimizer against the JAX package's optax optimizer on the JAX
    gradients."""
    jm = _jax_model(tmp_path, f'--mean_type={mean_type}', '--cf_drop_prob=0.2')
    params = _perturb(jm.state.params)
    model = _port(f'--mean_type={mean_type}', '--cf_drop_prob=0.2', params=params)
    x, y = _batch()
    rng = jax.random.key(3)
    loss_fn = jax.jit(jm.loss, static_argnums=4)
    draws = jax_model_draws(rng, y.shape, x.shape, 4)
    assert (draws['drop'] < 0.2).any() and not (draws['drop'] < 0.2).all()
    ref_eval = float(loss_fn(params, jnp.asarray(x), jnp.asarray(y), rng, False)[0])
    with torch.no_grad():
        got_eval = float(model.loss(_t(x), _t(y), draws=draws)[0])
    assert got_eval == pytest.approx(ref_eval, rel=1e-5)

    (ref_train, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True), static_argnums=4)(
        params, jnp.asarray(x), jnp.asarray(y), rng, True)
    metrics = model.backward(x, _t(y), draws=draws)
    assert float(metrics['loss']) == pytest.approx(float(ref_train), rel=1e-5)
    _check_grads(model, grads)

    # the port's Adam on the JAX gradients: a first step moves an element by
    # lr * g / (|g| + eps), so elements with |g| near eps would carry the
    # two gradients' rounding into it
    opt = jm.make_optimizer()
    updates, _ = opt.update(grads, opt.init(params), params)
    ref = diffusion_params_from_jax(_np(optax.apply_updates(params, updates)))
    jgrads = diffusion_params_from_jax(_np(grads))
    for name, p in model.net.named_parameters():
        p.grad = jgrads[name].clone()
    model.apply_grads()
    for name, p in model.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize('teacher_mode', ['step1', 'step2'])
def test_distillation_losses_match_jax(tmp_path, teacher_mode):
    """A student of a teacher checkpoint: the JAX package's reads its
    msgpack model.pt, the port's a port model.pt of the same (converted)
    weights. Both students start from the teacher's weights with their own
    cond_w_embed init; the port takes the JAX student's, then the eval and
    train losses (step1: the guided teacher's one DDIM step, 'snr' loss;
    step2: two teacher half-steps, the implied x) match, and a train step
    leaves the frozen teacher as it was."""
    jt = _jax_model(tmp_path / 'teacher')
    teacher = _perturb(jt.state.params, seed=1)
    jt.state = jt.state.replace(params=teacher)
    jt.save(tmp_path / 'jt')
    port_teacher = tmp_path / 'pt' / 'model.pt'
    port_teacher.parent.mkdir()
    torch.save(diffusion_params_from_jax(_np(teacher)), port_teacher)
    mode = f'--teacher_mode={teacher_mode}'
    js = _jax_model(tmp_path / 'student', f'--teacher_path={tmp_path / "jt" / "model.pt"}', mode)
    model = _port(f'--teacher_path={port_teacher}', mode)
    assert model.has_teacher and model.net.cond_w_embed is not None
    for name, v in diffusion_params_from_jax(_np(teacher)).items():
        assert torch.equal(model.net.state_dict()[name], v), name
        assert torch.equal(model.teacher_net.state_dict()[name], v), name
    model.net.load_state_dict(diffusion_params_from_jax(_np(js.state.params)))
    model.teacher_net.load_state_dict(diffusion_params_from_jax(_np(js.state.extra['teacher'])))

    x, y = _batch(seed=2)
    loss_fn = jax.jit(js.loss, static_argnums=4)
    for train in (False, True):
        rng = jax.random.fold_in(js.state.rng, EVAL_RNG_TAG if not train else 0)
        draws = jax_model_draws(rng, y.shape, x.shape, 4, step2=teacher_mode == 'step2')
        ref = float(loss_fn(js.state.params, jnp.asarray(x), jnp.asarray(y), rng, train,
                            js.state.extra['teacher'])[0])
        got = (model.backward(x, _t(y), draws=draws) if train
               else model.loss(_t(x), _t(y), draws=draws)[1])['loss']
        assert float(got.detach()) == pytest.approx(ref, rel=1e-5), train
    before = {k: v.clone() for k, v in model.teacher_net.state_dict().items()}
    model.train_step(x, _t(y))
    for k, v in model.teacher_net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert any(not torch.equal(p, before[k]) for k, p in model.net.state_dict().items())


def test_a_jax_msgpack_teacher_is_refused(tmp_path):
    """--teacher_path to a JAX package's model.pt (msgpack) is read: the
    student and the frozen teacher start from its params (the student's
    cond_w_embed, which the teacher lacks, keeps its init), as the port's
    own model.pt of the same weights gives them."""
    jt = _jax_model(tmp_path)
    teacher = _perturb(jt.state.params, seed=1)
    jt.state = jt.state.replace(params=teacher)
    jt.save(tmp_path / 'jt')
    model = _port(f'--teacher_path={tmp_path / "jt" / "model.pt"}')
    assert model.has_teacher and model.net.cond_w_embed is not None
    want = diffusion_params_from_jax(_np(teacher))
    for name, v in want.items():
        assert torch.equal(model.net.state_dict()[name], v), name
        assert torch.equal(model.teacher_net.state_dict()[name], v), name
    fresh = _port(f'--teacher_path={tmp_path / "jt" / "model.pt"}')
    for name, v in model.net.cond_w_embed.state_dict().items():
        assert torch.equal(fresh.net.cond_w_embed.state_dict()[name], v), name


def test_ema_hand_math_sampling_and_checkpoint(tmp_path):
    """ema = d * ema + (1 - d) * params after each step; sampling reads the
    EMA (at d = 1 it stays at the init, so the samples are a fresh
    model's); model.pt carries it."""
    x, y = _batch(seed=4)
    m = _port('--ema=0.5')
    init = {k: v.clone() for k, v in m.net.state_dict().items()}
    m.train_step(x, _t(y))
    new, ema = m.net.state_dict(), m.ema_net.state_dict()
    for k in init:
        np.testing.assert_allclose(ema[k].numpy(), (0.5 * init[k] + 0.5 * new[k]).numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    m.save(tmp_path / 'ema')
    m2 = _port('--ema=0.5')
    m2.load_weights(tmp_path / 'ema' / 'model.pt')
    for k, v in m2.ema_net.state_dict().items():
        assert torch.equal(v, ema[k]), k

    def samples(model):
        gen = torch.Generator().manual_seed(7)
        return model.sample_fn(3, _t([1, 2, -1]), generator=gen)

    frozen, fresh, live = _port('--ema=1.0'), _port('--ema=1.0'), _port()
    for _ in range(2):
        frozen.train_step(x, _t(y))
        live.train_step(x, _t(y))
    assert torch.equal(samples(frozen), samples(fresh))
    assert (samples(live) - samples(fresh)).abs().max() > 1e-4


@pytest.mark.parametrize('flags', [['--ema=0.9'], ['--grad_accum=2']], ids=['ema', 'accum'])
def test_restored_train_state_steps_as_an_uninterrupted_one(tmp_path, flags):
    """save -> load_weights -> train_step gives the parameters, Adam moments
    and EMA of an uninterrupted run exactly (the draws passed in: a
    generator's state is not checkpointed), and every restored Adam step
    counter lies on the CPU, where a fresh Adam keeps it."""
    x, y = _batch(seed=5)
    draws = [dict(drop=torch.rand(4, generator=torch.Generator().manual_seed(s)),
                  eps=torch.randn((4, 28, 28, 1), generator=torch.Generator().manual_seed(s)),
                  u=torch.rand(4, generator=torch.Generator().manual_seed(s + 10)))
             for s in range(3)]
    a = _port(*flags)
    a.train_step(x, _t(y), draws=draws[0])
    a.save(tmp_path)
    b = _port(*flags)
    b.load_weights(tmp_path / 'model.pt')
    for m in (a, b):
        for d in draws[1:]:
            m.train_step(x, _t(y), draws=d)
    assert (a.step, a.updates, a.mini_step) == (b.step, b.updates, b.mini_step)
    for (k, p), q in zip(a.net.named_parameters(), b.net.parameters()):
        assert torch.equal(p, q), k
        sa, sb = a.opt.state[p], b.opt.state[q]
        assert torch.equal(sa['exp_avg'], sb['exp_avg']) and torch.equal(
            sa['exp_avg_sq'], sb['exp_avg_sq']), k
        assert sb['step'].device.type == 'cpu' and torch.equal(sa['step'], sb['step']), k
    if a.ema_net is not None:
        for p, q in zip(a.ema_net.parameters(), b.ema_net.parameters()):
            assert torch.equal(p, q)


@pytest.fixture(scope='module')
def cli_run(tmp_path_factory):
    logdir = tmp_path_factory.mktemp('cli')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, 'TRAIN_N', 16)  # 2 steps of 8
        mp.setattr(tm, 'TEST_N', 8)
        with contextlib.redirect_stdout(io.StringIO()):
            history = main(FLAGS + ['--device=cpu', '--bs=8', '--epochs=1', '--save_n=1',
                                    '--ema=0.9', '--data_source=synthetic',
                                    f'--logdir={logdir}'])
    return logdir, history


def test_cli_writes_the_jax_artifacts(cli_run):
    logdir, history = cli_run
    for name in ('model.pt', 'hps.yaml', 'sampling_process_0.gif', 'diffusion_model_eps_0.gif',
                 'diffusion_model_x_0.gif', 'sampling_process_1.gif'):
        assert (logdir / name).is_file(), name
        if name.endswith('.gif'):
            assert (logdir / name).read_bytes()[:6] == b'GIF89a'
    assert list(logdir.glob('events.out.tfevents.*'))  # the samples grid
    assert set(history[1]) == {'diffusion_model/test/loss', 'diffusion_model/train/loss',
                               'dt/eval', 'dt/train', 'num_vars'}
    assert all(np.isfinite(v) for h in history for v in h.values())
    state = torch.load(logdir / 'model.pt', weights_only=True)
    assert set(state['extra']) == {'ema'} and set(state['extra']['ema']) == set(state['net'])


def test_hps_yaml_round_trips_between_the_packages(cli_run, tmp_path):
    """The port's hps.yaml builds the JAX package's config, and a JAX
    hps.yaml the port's, teacher_path included."""
    logdir, _ = cli_run
    G, Model = jax_parse_args([f'--weights_from={logdir / "model.pt"}'],
                              discover_models=jax_models)
    assert Model.__name__ == 'DiffusionModel'
    assert (G.hidden_size, G.timesteps, G.ema, G.bf16, str(G.teacher_path)) == (32, 4, 0.9, 0, '.')
    jG, _ = jax_parse_args(FLAGS + ['--teacher_mode=step2', '--sample_steps=3',
                                    f'--logdir={tmp_path}'], discover_models=jax_models)
    jax_dump_hps(jG, tmp_path)
    pG, pModel = parse_args([f'--weights_from={tmp_path / "model.pt"}', '--device=cpu'])
    assert pModel.__name__ == 'DiffusionModel'
    loaded = yaml.safe_load((tmp_path / 'hps.yaml').read_text())
    for key in ('hidden_size', 'timesteps', 'teacher_mode', 'sample_steps', 'mean_type',
                'cf_drop_prob', 'class_cond', 'fused_cfg'):
        assert pG[key] == loaded[key], key
    assert str(pG.teacher_path) == '.'
    model = pModel(pG)
    assert not model.has_teacher and model.diffusion.sample_steps == 3


def test_default_eval_heavy_is_refused_by_name():
    """No longer refused: the arbiters are ported, so diffusion's defaults
    (--eval_heavy=1, --class_cond=1) parse as the JAX package's, and
    --eval_heavy=0 still turns it off (tests/test_torch_eval_heavy.py runs
    the default CLI)."""
    G, _ = parse_args(['--model=diffusion_model', '--device=cpu'])
    jG, _ = jax_parse_args(['--model=diffusion_model'], discover_models=jax_models)
    assert G.eval_heavy == jG.eval_heavy == 1 and G.class_cond == jG.class_cond == 1
    G, _ = parse_args(FLAGS + ['--device=cpu'])
    assert G.eval_heavy == 0 and G.class_cond == 1


def test_bf16_gradients_sit_as_far_from_f32_as_the_jax_packages(tmp_path):
    """The bf16 UNet's gradients (--bf16=1, flax's dtype casts) of both
    packages from the same weights, batch and draws, at hidden_size=64
    (GroupNorm's groups of two channels leave no gradient exactly 0),
    against the f32 gradients: the JAX package's own bf16 gradients sit
    2-3 % of the whole from f32, and the port's no farther than 1.5 times
    that, within 5 % of the JAX package's bf16 ones; the f32 gradients of
    the two packages agree within 1e-5 of the whole. So the port's bf16
    distance from f32 on the card (PERF.md) is bf16 arithmetic, not
    a cast that differs from flax's."""
    base = ['--model=diffusion_model', '--hidden_size=64', '--timesteps=4', '--eval_heavy=0']
    x, y = _batch()
    rng = jax.random.key(3)
    grads, params = {}, None
    for bf16 in (0, 1):
        G, Model = jax_parse_args(base + [f'--bf16={bf16}', f'--logdir={tmp_path}'],
                                  discover_models=jax_models)
        jm = Model(G)
        params = _perturb(jm.state.params) if params is None else params
        _, g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True), static_argnums=4)(
            params, jnp.asarray(x), jnp.asarray(y), rng, True)
        grads[f'jax{bf16}'] = diffusion_params_from_jax(_np(g))
        Gp, Port = parse_args(base + [f'--bf16={bf16}', '--device=cpu'])
        model = Port(Gp)
        model.net.load_state_dict(diffusion_params_from_jax(_np(params)))
        model.backward(x, _t(y), draws=jax_model_draws(rng, y.shape, x.shape, 4))
        grads[f'port{bf16}'] = {n: p.grad for n, p in model.net.named_parameters()}

    def whole(a, b):
        num = sum(((grads[a][n].double() - grads[b][n].double()) ** 2).sum() for n in grads[b])
        den = sum((grads[b][n].double() ** 2).sum() for n in grads[b])
        return float(torch.sqrt(num / den))

    assert whole('port0', 'jax0') < 1e-5
    jax_bf16 = whole('jax1', 'jax0')
    assert 5e-3 < jax_bf16 < 5e-2, jax_bf16
    assert whole('port1', 'jax0') <= 1.5 * jax_bf16, (whole('port1', 'jax0'), jax_bf16)
    assert whole('port1', 'jax1') < 5e-2
