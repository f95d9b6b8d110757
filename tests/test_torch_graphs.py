"""--jit_epoch=1 and --decode_unroll in the port (utils/graphs.py, the
graphed forms of models/base.py train_epoch and utils/loop.py fori_loop) on
the CPU, where the same steps run uncaptured (the card's CUDA graphs are
held bitwise by chip_smoke.py's graphs phase):

  * every registry name's train_epoch at a small width, 5 steps, bitwise the
    per-step loop of --jit_epoch=0 (params and buffers, every optimizer's
    state, the host counters, the training draws' generator, the epoch's
    metric floats), with --grad_accum=2 and warmup-cosine on one model,
    diffusion with --ema and gan among them;
  * pixel_transformer's decode with a device t at --decode_unroll 1, 3 and
    8 and --decode_segments 1 and 4, bitwise the per-step loop's tokens,
    the remainder's group reached where unroll does not divide a segment;
  * the model keeps its DecodeGraphs a key among its sampling passes'
    holders, the PASS_GRAPHS_KEPT last used;
  * StepGraphs' launch-counter bookkeeping with the capture stubbed: every
    counter restored after a capture, its increments added once a replay;
  * main.train with --jit_epoch=1 against the JAX package's main.train on
    the same batches from the same weights (convert.py), pixel_transformer
    and diffusion (the JAX package's draws passed in), one epoch of 2
    steps: the epoch's train metric within the loss tolerance of the port's
    multi-step parity against the JAX package (test_torch_mesh.py, the
    JAX tests': rtol 1e-4), pixel_transformer's weights within its params
    tolerance (atol 1e-4 after a few steps), diffusion's update within 5e-2
    of the JAX one's (relative Frobenius; chip_smoke.py MADE_FLAGS_BOUND,
    the card's update against the CPU's).
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu import main as jax_main
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch import main as port_main
from generative_models_tpu_torch.convert import diffusion_params_from_jax, params_from_jax
from generative_models_tpu_torch.models.base import mean_metrics
from generative_models_tpu_torch.ops.common import kernel_counters
from generative_models_tpu_torch.utils import graphs as graphs_mod
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

TINY = {
    'pixel_transformer': ['--n_layer=1', '--n_embed=16', '--n_head=2'],
    'vqvae': ['--hidden_size=16', '--vqD=8', '--vqK=16', '--n_layer=1', '--n_embed=32',
              '--n_head=2'],
    'made': ['--hidden_size=16'],
    'rnn': ['--hidden_size=16'],
    'wavenet': ['--hidden_size=8'],
    'pixel_cnn': ['--n_filters=8', '--n_layers=2', '--kernel_size=3'],
    'gated_pixel_cnn': ['--n_filters=8', '--n_layers=3', '--kernel_size=3'],
    'diffusion_model': ['--eval_heavy=0', '--hidden_size=16', '--timesteps=8'],
    'vae': ['--hidden_size=16'],
    'gan': ['--hidden_size=16'],
    'autoencoder': ['--hidden_size=16'],
    'classifier': ['--hidden_size=16'],
}
CASES = [(name, []) for name in TINY] + [
    ('made', ['--grad_accum=2', '--lr_scheduler=cosine', '--warmup_steps=2',
              '--lr_decay_steps=4', '--grad_clip=1e-3']),
    ('diffusion_model', ['--ema=0.99', '--dropout=0.1']),
    ('gan', ['--spectral_norm=1']),
]
STEPS = 5


def _model(name, flags=()):
    G, Model = parse_args([f'--model={name}', '--device=cpu', '--bs=8', *TINY[name], *flags])
    return Model(G)


def _batches(name, steps=STEPS, bs=8, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.rand(steps, bs, 28, 28, 1) > 0.5).astype(np.float32)
    if name in ('gan', 'diffusion_model'):  # trained on [-1, 1]
        x = x * 2 - 1
    return torch.from_numpy(x), torch.from_numpy(rng.randint(0, 10, (steps, bs)).astype(np.int32))


def _opt_state(model):
    return {f'{name}.{i}.{k}': v for name, o in model.optimizers().items()
            for i, st in enumerate(o.state.values()) for k, v in st.items()}


@pytest.mark.parametrize('name,flags', CASES, ids=[f'{n}{"".join(f)}' for n, f in CASES])
def test_train_epoch_is_bitwise_the_per_step_loop(name, flags):
    bx, by = _batches(name)
    eager, jit = _model(name, flags), _model(name, flags)
    want = mean_metrics([eager.train_step(bx[i], by[i]) for i in range(STEPS)])
    got = jit.train_epoch(bx, by)
    assert got == want
    for (k, a), b in zip(eager.net.state_dict().items(), jit.net.state_dict().values()):
        assert torch.equal(a, b), k
    ea, ja = _opt_state(eager), _opt_state(jit)
    assert ea.keys() == ja.keys() and ea
    for k in ea:
        assert torch.equal(ea[k], ja[k]), k
    for k in ('step', 'updates', 'mini_step'):
        assert getattr(eager, k) == getattr(jit, k), k
    assert jit.step == STEPS
    assert torch.equal(eager._gen.get_state(), jit._gen.get_state())
    if '--grad_accum=2' in flags:
        assert (jit.updates, jit.mini_step) == (2, 1)


def _pt(*flags):
    G, Model = parse_args(['--model=pixel_transformer', '--device=cpu', '--n_layer=1',
                           '--n_embed=16', '--n_head=2', *flags])
    return Model(G)


@pytest.fixture(scope='module')
def pt_decode():
    """A tiny pixel_transformer, 4 draws' uniforms and, for each segments,
    the per-step loop's samples (--decode_unroll=0)."""
    model = _pt()
    u = torch.from_numpy(np.random.RandomState(0).rand(784, 4, 1).astype(np.float32))
    ref = {}
    for seg in (1, 4):
        model.G.decode_segments, model.G.decode_unroll = seg, 0
        ref[seg] = model.sample_fn(4, uniforms=u, with_frames=False)
    return model, u, ref


@pytest.mark.parametrize('segments', [1, 4])
@pytest.mark.parametrize('unroll', [1, 3, 8])
def test_decode_with_a_device_t_is_bitwise_the_per_step_loop(pt_decode, monkeypatch, unroll,
                                                             segments):
    model, u, ref = pt_decode
    keys = []
    call = graphs_mod.StepGraphs.__call__
    monkeypatch.setattr(graphs_mod.StepGraphs, '__call__',
                        lambda self, key, fn: keys.append(key) or call(self, key, fn))
    model.G.decode_segments, model.G.decode_unroll = segments, unroll
    got = model.sample_fn(4, uniforms=u, with_frames=False)
    assert torch.equal(got, ref[segments])
    seg = 784 // segments
    full, rest = divmod(seg, unroll)
    assert len(keys) == segments * (full + bool(rest))
    assert {k[2] for k in keys} == {unroll} | ({rest} if rest else set())
    if (unroll, segments) in ((3, 1), (3, 4), (8, 4)):  # a remainder group in each segment
        assert rest > 0
    # a second pass reuses the buffers and gives the same tokens
    assert torch.equal(model.sample_fn(4, uniforms=u, with_frames=False), ref[segments])


def test_decode_graphs_keep_the_last_used():
    from generative_models_tpu_torch.utils.graphs import PASS_GRAPHS_KEPT

    model = _pt()
    u = {n: torch.zeros((784, n, 1)) for n in range(1, PASS_GRAPHS_KEPT + 2)}
    first = model.decode_graphs(1, u[1], 1, 8, None)
    assert model.decode_graphs(1, u[1], 1, 8, None) is first
    assert model.decode_graphs(1, u[1], 4, 8, None) is not first  # another key
    for n in range(2, PASS_GRAPHS_KEPT + 2):
        bufs = model.decode_graphs(n, u[n], 1, 8, None)
        assert (bufs.unroll, bufs.prev.shape[0]) == (8, n)
    assert len(model._pass_graphs) == PASS_GRAPHS_KEPT
    assert model.decode_graphs(1, u[1], 1, 8, None) is not first  # the oldest went


class _StubGraph:
    """A capture that runs fn once, as torch.cuda.graph's capture runs the
    Python, and whose replay runs nothing."""

    def __init__(self, fn):
        self.out = fn()
        self.replays = 0

    def replay(self):
        self.replays += 1


class _StubGraphs(graphs_mod.StepGraphs):
    def captured(self, fn):
        return _StubGraph(fn)


def test_launch_counters_across_capture_and_replay(monkeypatch):
    counters = kernel_counters()
    fwd, dq = counters[2], counters[3]
    for c in counters:
        monkeypatch.setattr(c, 'launches', 0)

    def step():  # what a step's kernel wrappers count as they launch
        fwd.launches += 2
        dq.launches += 1
        return 'out'

    g = _StubGraphs(capture=True)
    assert g('k', step) == 'out'  # the eager warm-up step counts as it runs
    assert (fwd.launches, dq.launches) == (2, 1)
    assert g('k', step) == 'out'  # capture (its Python counted, then restored), replay
    graph, delta = g.graphs['k']
    assert graph.replays == 1
    assert delta == [(fwd, 2), (dq, 1)]
    assert (fwd.launches, dq.launches) == (4, 2)
    for _ in range(3):  # replays run no Python: the kept increments are added
        g('k', step)
    assert graph.replays == 4
    assert (fwd.launches, dq.launches) == (10, 5)
    assert all(c.launches == 0 for c in counters if c not in (fwd, dq))

    def failing():
        fwd.launches += 7
        raise RuntimeError('capture failed')

    g.eager['bad'] = graphs_mod.WARMUP  # past its warm-up: the next call captures, and raises
    with pytest.raises(RuntimeError, match='capture failed'):
        g('bad', failing)
    assert (fwd.launches, dq.launches) == (10, 5)  # restored: no fallback ran


def test_no_capture_runs_every_call():
    g = graphs_mod.StepGraphs(capture=False)
    calls = []
    for _ in range(3):
        g('k', lambda: calls.append(1))
    assert len(calls) == 3 and not g.graphs


class _Batches:
    """The same (steps, bs, ...) training batches every epoch, and one test
    batch, for either package's main.train."""

    def __init__(self, bx, by, as_array):
        self.bx, self.by, self.as_array = bx, by, as_array
        self.steps_per_epoch = len(bx)

    def epoch_batches(self, key, train=True):
        bx, by = (self.bx, self.by) if train else (self.bx[:1], self.by[:1])
        return self.as_array(bx), self.as_array(by)

    def first_test_batch(self, epoch=0):
        return self.as_array(self.bx[0]), self.as_array(self.by[0])


def _train_both(tmp_path, flags, to_port, port_hook=None, bs=4, data=None,
                perturb=False):
    """main.train of both packages at --jit_epoch=1, one epoch on the same
    batches, the port's net loaded from the JAX init (perturbed
    with perturb, so that no gradient is zero behind a zero-init conv)
    through to_port: (JAX model, port model, the JAX run's printed lines,
    the port's history)."""
    bx, by = data
    jG, jModel = jax_parse_args(flags + ['--epochs=1', '--save_n=1', f'--bs={bs}',
                                         f'--logdir={tmp_path / "jax"}'],
                                discover_models=jax_models)
    jm = jModel(jG)
    if perturb:
        from test_torch_diffusion_model import _perturb

        jm.state = jm.state.replace(params=_perturb(jm.state.params))
    G, Model = parse_args(flags + ['--device=cpu', '--epochs=1', '--save_n=1', f'--bs={bs}',
                                   '--jit_epoch=1', f'--logdir={tmp_path / "port"}'])
    port = Model(G)
    port.net.load_state_dict(to_port(jax.tree_util.tree_map(np.asarray, jm.state.params)))
    port.init_sd = {k: v.clone() for k, v in port.net.state_dict().items()}
    if port_hook is not None:
        port_hook(port, jm)
    jax_out = io.StringIO()
    with contextlib.redirect_stdout(jax_out):
        jax_main.train(jm, _Batches(bx, by, jnp.asarray), None, None, jG)
    with contextlib.redirect_stdout(io.StringIO()):
        ph = port_main.train(port, _Batches(torch.from_numpy(bx), torch.from_numpy(by),
                                            lambda a: a), None, None, G)
    return jm, port, jax_out.getvalue(), ph


def _printed(text, key):
    """The last value of key that the JAX package's dump_logger printed."""
    return [float(line.split()[1]) for line in text.splitlines()
            if line.split()[:1] == [key]][-1]


def _check_weights(jm, port, to_port, lr, steps=2, atol=1e-4):
    """Every parameter within atol of the JAX package's, but a
    transformer's key bias, whose exact gradient is 0 (softmax does not see
    a constant added to a row's scores): each side's steps follow Adam's
    sign of its rounding, so it is held to 2 lr a step (test_torch_mesh.py's
    rule)."""
    ref = to_port(jax.tree_util.tree_map(np.asarray, jm.state.params))
    for name, p in port.net.named_parameters():
        got, want = p.detach().numpy(), ref[name].numpy()
        if name.endswith('attn.key.bias'):
            assert np.abs(got - want).max() <= 2 * lr * steps * (1 + 1e-6), name
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def test_jit_epoch_train_matches_jax_pixel_transformer(tmp_path):
    rng = np.random.RandomState(1)
    data = ((rng.rand(2, 4, 28, 28, 1) > 0.5).astype(np.float32),
            rng.randint(0, 10, (2, 4)).astype(np.int32))
    flags = ['--model=pixel_transformer', '--n_layer=1', '--n_embed=16', '--n_head=2',
             '--data_source=synthetic']
    jm, port, jh, ph = _train_both(tmp_path, flags, params_from_jax, data=data)
    assert port.step == 2 and int(jm.state.step) == 2
    got = ph[1]['train/nlogp']
    want = _printed(jh, 'train/nlogp')
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _check_weights(jm, port, params_from_jax, lr=1e-3)


def test_jit_epoch_train_matches_jax_diffusion(tmp_path):
    from test_torch_diffusion_model import jax_model_draws

    rng = np.random.RandomState(2)
    data = (np.clip(rng.randn(2, 4, 28, 28, 1), -1, 1).astype(np.float32),
            rng.randint(0, 10, (2, 4)).astype(np.int32))
    flags = ['--model=diffusion_model', '--hidden_size=16', '--timesteps=4', '--bf16=0',
             '--eval_heavy=0', '--sample_steps=2', '--data_source=synthetic']

    def draws_from_jax(port, jm):
        # the JAX package's draws of step i: its loss at fold_in(rng, i)
        queue = [jax_model_draws(jax.random.fold_in(jm.state.rng, i), (4,), (4, 28, 28, 1), 4)
                 for i in range(2)]
        train_loss = port.train_loss
        port.train_loss = lambda x, y=None, draws=None: train_loss(x, y, draws=queue.pop(0))

    jm, port, jh, ph = _train_both(tmp_path, flags, diffusion_params_from_jax, draws_from_jax,
                                   data=data, perturb=True)
    assert port.step == 2 and int(jm.state.step) == 2
    got = ph[1]['diffusion_model/train/loss']
    want = _printed(jh, 'diffusion_model/train/loss')
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the update, as a whole: Adam's first steps move an element with a
    # gradient near 0 by up to lr either way, so the weights are held as the
    # card's run against the CPU's is (chip_smoke.py MADE_FLAGS_BOUND)
    ref = diffusion_params_from_jax(jax.tree_util.tree_map(np.asarray, jm.state.params))
    names = [n for n, _ in port.net.named_parameters()]
    d_port = torch.cat([(port.net.state_dict()[n] - port.init_sd[n]).flatten() for n in names])
    d_jax = torch.cat([(ref[n] - port.init_sd[n]).flatten() for n in names])
    assert float((d_port - d_jax).norm() / d_jax.norm()) <= 5e-2
