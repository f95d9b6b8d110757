"""Every sampler as CUDA graphs (models/base.py pass_graphs, utils/graphs.py
PassGraphs, the graphed forms of utils/loop.py fori_loop) on the CPU, where
the card's captures are simulated: SimGraphs runs a stage's function at its
capture (standing for the capture's one replay) and, at each later replay,
the function it captured again, whose closure is that of the capture's pass,
copying what it returns into the capture's outputs. A graph reads the
tensors it was captured with, so a pass that hands its graphs anything but
its fixed buffers reads the capture's pass's values here, as on the card
(chip_smoke.py's graphs phase holds the card's graphs bitwise).

  * every sampler's serving pass (sample_from_draws), three passes of one
    PassGraphs on three draws (the eager warm-up pass, the capture, a
    replay), each bitwise the per-step loop's (graph_sampling = False):
    diffusion's ddim, dpm2m, noisy (drawn step_noise), fused_cfg, a
    distilled student and teacher_test, all guided; made, vqvae, rnn,
    wavenet, pixel_cnn, gated_pixel_cnn, vae, gan; w8a8 and w8a16 requests
    of made and diffusion;
  * the noisy sampler's sample(), whose steps draw from the model's
    sampling generator inside the graphs: bitwise, the generator's state
    after it the per-step loop's;
  * the replayed passes of diffusion (ddim, dpm2m) and rnn against the JAX
    package's jitted samplers on the same draws: diffusion within 2e-2 in
    [0, 1], as tests/test_torch_diffusion_serve.py holds a served batch,
    rnn's samples exactly, as tests/test_torch_rnn.py;
  * a pass after a train step reads the moved weights, and one after a
    checkpoint is reloaded into the same model the reloaded ones;
  * loop.py's device-index helpers (take, pick, write at dim 1), the
    fourth form of fori_loop (a graph a run of steps, host ints baked in),
    PassGraphs' warm-up by pass, kept's bound, and SampleServer.warm
    capturing so that request #1 replays; pixel_transformer's DecodeGraphs
    warmed the same way, and its --decode_unroll=0 server warming one
    eager pass.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.convert import diffusion_params_from_jax, rnn_params_from_jax
from generative_models_tpu_torch.ops.common import kernel_counters
from generative_models_tpu_torch.ops.int8 import build_quant_table
from generative_models_tpu_torch.serve import SampleServer
from generative_models_tpu_torch.utils import graphs as graphs_mod
from generative_models_tpu_torch.utils.config import parse_args
from generative_models_tpu_torch.utils.dists import draw
from generative_models_tpu_torch.utils.loop import fori_loop, pick, take, write

torch.set_num_threads(1)

DIFF = ['--model=diffusion_model', '--eval_heavy=0', '--hidden_size=16', '--bf16=0',
        '--timesteps=3']
TINY = {
    'made': ['--model=made', '--hidden_size=16'],
    'vqvae': ['--model=vqvae', '--hidden_size=16', '--vqD=8', '--vqK=16', '--n_layer=1',
              '--n_embed=32', '--n_head=2'],
    'rnn': ['--model=rnn', '--hidden_size=16'],
    'wavenet': ['--model=wavenet', '--hidden_size=8'],
    'pixel_cnn': ['--model=pixel_cnn', '--n_filters=8', '--n_layers=2', '--kernel_size=3'],
    'gated_pixel_cnn': ['--model=gated_pixel_cnn', '--n_filters=8', '--n_layers=3',
                        '--kernel_size=3'],
    'vae': ['--model=vae', '--hidden_size=16'],
    'gan': ['--model=gan', '--hidden_size=16'],
    'diffusion_ddim': DIFF,
    'diffusion_dpm2m': DIFF + ['--sampler=dpm2m'],
    'diffusion_noisy': DIFF + ['--sampler=noisy'],
    'diffusion_fused_cfg': DIFF + ['--fused_cfg=1'],
    'diffusion_student': DIFF + ['--timesteps=4', '--sample_steps=3'],  # + --teacher_path
    'diffusion_teacher_test': DIFF + ['--sampler=teacher_test'],  # + --teacher_path
    # the narrowest widths whose layers --quantize takes (ops/int8.py thresholds)
    'made_w8a8': ['--model=made', '--hidden_size=128'],
    'made_w8a16': ['--model=made', '--hidden_size=128'],
    'diffusion_w8a8': DIFF[:2] + ['--hidden_size=64', '--bf16=0', '--timesteps=3',
                                  '--sampler=dpm2m'],
    'diffusion_w8a16': DIFF[:2] + ['--hidden_size=64', '--bf16=0', '--timesteps=3'],
}
N = 2  # a pass's batch


def _copy_into(old, new):
    """old's tensors overwritten by new's, through tuples, lists, dicts and
    functions' closures (a stage's outputs: rnn's products are closures
    over the weights it cast)."""
    if isinstance(old, torch.Tensor):
        if old is not new:
            old.copy_(new)
    elif isinstance(old, (tuple, list)):
        for a, b in zip(old, new, strict=True):
            _copy_into(a, b)
    elif isinstance(old, dict):
        for k in old:
            _copy_into(old[k], new[k])
    elif isinstance(old, types.FunctionType) and old.__closure__:
        for a, b in zip(old.__closure__, new.__closure__, strict=True):
            _copy_into(a.cell_contents, b.cell_contents)


class SimGraph:
    """A capture that runs fn (for the capture's one replay, which
    StepGraphs makes next) and whose later replays run that same fn again,
    its outputs copied into the capture's, the counters left as they were
    (a replay runs no Python)."""

    def __init__(self, fn):
        self.fn, self.out, self.replays = fn, fn(), 0

    def replay(self):
        self.replays += 1
        if self.replays == 1:
            return
        counters = kernel_counters()
        before = [c.launches for c in counters]
        _copy_into(self.out, self.fn())
        for c, b in zip(counters, before):
            c.launches = b


class SimGraphs(graphs_mod.StepGraphs):
    def __init__(self, capture=True, generators=(), shared_pool=False):
        super().__init__(False, generators, shared_pool)
        self.capture = True  # on the CPU

    def captured(self, fn):
        return SimGraph(fn)


@pytest.fixture
def sim(monkeypatch):
    monkeypatch.setattr(graphs_mod, 'StepGraphs', SimGraphs)


@pytest.fixture(scope='module')
def teacher(tmp_path_factory):
    """A tiny diffusion model's model.pt, the student's and teacher_test's
    teacher."""
    G, Model = parse_args(DIFF + ['--device=cpu'])
    path = tmp_path_factory.mktemp('teacher')
    Model(G).save(path)
    return path / 'model.pt'


def _model(label, teacher=None, seed=0):
    flags = TINY[label] + (['--teacher_path=' + str(teacher)] if 'student' in label
                           or 'teacher_test' in label else [])
    G, Model = parse_args(flags + ['--device=cpu', '--bs=4', f'--seed={seed}'])
    model = Model(G)
    if label.startswith('diffusion'):
        _live(model)
    return model


def _live(model):
    """The diffusion nets' weights moved off their init, whose zero-init
    output convs make every ResBlock the identity."""
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for net in {id(n): n for n in (model.net, model.teacher_net) if n is not None}.values():
            for p in net.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))


def _draws(model, seed):
    return draw(model.draw_spec(N), torch.Generator().manual_seed(seed), model.device)


def _labels(model):
    return torch.tensor([3, -1], dtype=torch.int32) if model.G.get('class_cond', 0) else None


def _pass(model, draws, graphed, quant=None):
    model.graph_sampling = graphed
    with torch.no_grad():
        return model.sample_from_draws(N, draws, _labels(model), quant)


def _captured(model):
    """{(pass key, graph key): replays} of the model's graphed passes."""
    return {(pk, gk): g.replays for pk, h in model._pass_graphs.items()
            for gk, (g, _) in h.graphs.graphs.items()}


@pytest.mark.parametrize('label', list(TINY))
def test_graphed_pass_is_bitwise_the_per_step_loop(sim, teacher, label):
    model = _model(label, teacher)
    quant = None
    if label.endswith(('w8a8', 'w8a16')):
        quant, n_q = build_quant_table(model, label.rsplit('_', 1)[1])
        assert n_q > 0
    for seed in range(3):  # the warm-up pass, the capture, a replay
        d = _draws(model, seed)
        want = _pass(model, d, False, quant)
        got = _pass(model, d, True, quant)
        assert torch.equal(got, want), f'pass {seed}'
    assert got.shape == (N, 28, 28, 1)
    captured = _captured(model)
    assert len(model._pass_graphs) == 1 and captured
    assert all(n >= 2 for n in captured.values())  # each graph replayed after its capture


def test_noisy_sample_draws_its_steps_from_the_sampling_generator(sim):
    model = _model('diffusion_noisy')
    for _ in range(3):
        state = model._sample_gen.get_state()
        model.graph_sampling = False
        want = model.sample(N)
        after = model._sample_gen.get_state()
        model._sample_gen.set_state(state)
        model.graph_sampling = True
        assert torch.equal(model.sample(N), want)
        assert torch.equal(model._sample_gen.get_state(), after)
    assert all(n >= 2 for n in _captured(model).values())


def _jax_pair(tmp_path, flags, to_port):
    """The JAX model (its params perturbed off their init) and a port model
    with the same weights."""
    G, Model = jax_parse_args(flags + [f'--logdir={tmp_path}'], discover_models=jax_models)
    jm = Model(G)
    rng = np.random.RandomState(0)
    jm.state = jm.state.replace(params=jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(np.float32)),
        jm.state.params))
    G, Model = parse_args(flags + ['--device=cpu'])
    port = Model(G)
    port.net.load_state_dict(to_port(jax.tree_util.tree_map(np.asarray, jm.state.params)))
    return jm, port


@pytest.mark.parametrize('flags', [['--timesteps=4'], ['--timesteps=8', '--sampler=dpm2m',
                                                       '--sample_steps=3']],
                         ids=['ddim', 'dpm2m'])
def test_replayed_diffusion_pass_matches_jax(sim, tmp_path, flags):
    jm, model = _jax_pair(tmp_path, ['--model=diffusion_model', '--hidden_size=16', '--bf16=0',
                                     '--eval_heavy=0'] + flags, diffusion_params_from_jax)
    y = np.array([1, -1], np.int32)
    serving_fn = jm.pure_serving_fn(N)
    for seed in range(3):  # the third pass replays
        ref = np.asarray(serving_fn(jax.random.key_data(jax.random.key(seed)), jnp.asarray(y)))
        rng_noise, rng_chain = jax.random.split(jax.random.key(seed))
        noise = torch.from_numpy(np.array(jax.random.normal(rng_noise, (N, 28, 28, 1))))
        w = torch.from_numpy(np.array(jax.random.uniform(jax.random.split(rng_chain)[0], (N,))))
        with torch.no_grad():
            got = model.sample_fn(N, torch.from_numpy(y), noise=noise, w=w)
        np.testing.assert_allclose(((got + 1) / 2).numpy(), ref, rtol=0, atol=2e-2)
    assert all(n >= 2 for n in _captured(model).values())


def test_replayed_rnn_pass_matches_jax(sim, tmp_path):
    jm, model = _jax_pair(tmp_path, ['--model=rnn', '--hidden_size=16'], rnn_params_from_jax)
    for seed in range(3):
        samples, _ = jm._jit_sample(jm.state, N, jax.random.key(seed))
        keys = jax.random.split(jax.random.key(seed), 784)
        u = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (N,)))(keys)))
        with torch.no_grad():
            got = model.sample_fn(N, uniforms=u, with_frames=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(samples))
    assert all(n >= 2 for n in _captured(model).values())


def _batch(model, seed=5):
    x = (torch.rand((4, 28, 28, 1), generator=torch.Generator().manual_seed(seed)) > 0.5).float()
    if model.SAMPLE_RANGE == (-1.0, 1.0):
        x = x * 2 - 1
    return x, torch.arange(4, dtype=torch.int32)


@pytest.mark.parametrize('label', ['made', 'rnn', 'vqvae', 'diffusion_ddim', 'gan'])
def test_a_pass_after_a_train_step_reads_the_moved_weights(sim, label):
    model = _model(label)
    d = _draws(model, 0)
    before = [_pass(model, d, True) for _ in range(2)][-1]  # warm-up and capture
    model.train_step(*_batch(model))
    got = _pass(model, d, True)
    assert torch.equal(got, _pass(model, d, False))
    assert not torch.equal(got, before)
    assert all(n >= 2 for n in _captured(model).values())


@pytest.mark.parametrize('label', ['made', 'rnn', 'vqvae', 'diffusion_ddim'])
def test_a_pass_after_a_reload_reads_the_reloaded_weights(sim, tmp_path, label):
    trained = _model(label)
    trained.train_step(*_batch(trained))
    trained.save(tmp_path)
    model = _model(label)
    d = _draws(model, 0)
    for _ in range(2):
        _pass(model, d, True)
    model.load_weights(tmp_path / 'model.pt')
    got = _pass(model, d, True)
    assert torch.equal(got, _pass(trained, d, False))
    assert all(n >= 2 for n in _captured(model).values())


def test_device_index_helpers_are_their_host_int_forms():
    x = torch.arange(24.0).reshape(2, 3, 4)
    t = torch.tensor(2)
    assert torch.equal(take(x, t, 1), take(x, 2, 1))
    assert torch.equal(take(x, torch.tensor(1)), x.select(0, 1))
    a, b = torch.zeros(3), torch.ones(3)
    assert torch.equal(pick(torch.tensor(True), a, lambda: b), a)
    assert torch.equal(pick(torch.tensor(False), a, lambda: b), b)
    assert pick(False, a, lambda: b) is b
    buf, ref = torch.zeros(2, 5), torch.zeros(2, 5)
    value = torch.tensor([7.0, 8.0])
    assert write(buf, (slice(None), torch.tensor(3)), value) is buf
    ref[:, 3] = value
    assert torch.equal(buf, ref)
    with pytest.raises(ValueError, match='full slices'):
        write(buf, (0, torch.tensor(1)), value[:1])


def test_fori_loop_with_a_graph_a_run_of_host_steps():
    keys = []
    graphs = graphs_mod.StepGraphs(capture=False)

    def run(key, fn):
        keys.append(key)
        return graphs(key, fn)

    body = lambda t, c: (c[0] * 2 + t, c[1] + 1)  # t a host int in both forms
    want = fori_loop(0, 10, body, (torch.ones(3), torch.zeros(())))
    carry = (torch.ones(3), torch.zeros(()))
    got = fori_loop(0, 10, body, carry, 4, run)
    assert got is carry and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert keys == [(0, 10, 0), (0, 10, 4), (0, 10, 8)]


def test_pass_graphs_warm_up_by_pass_then_capture_every_key(sim):
    holder = graphs_mod.PassGraphs(torch.device('cpu'))
    out = torch.zeros(())
    for p in range(3):
        (x,) = holder.start(torch.tensor(float(p)))
        holder('a', lambda: out.copy_(x + 1))
        holder('b', lambda: out.mul_(2))
        assert float(out) == (p + 1) * 2
        assert len(holder.graphs.graphs) == (0 if p == 0 else 2)  # captured at pass 2
    assert holder.start(torch.zeros(()))[0] is x  # the same fixed buffer every pass


def test_kept_keeps_the_last_used():
    cache = {}
    first = graphs_mod.kept(cache, 0, object, 2)
    graphs_mod.kept(cache, 1, object, 2)
    assert graphs_mod.kept(cache, 0, object, 2) is first  # used again: now the newest
    graphs_mod.kept(cache, 2, object, 2)
    assert list(cache) == [0, 2]


def test_warm_captures_so_that_request_one_replays(sim):
    G, Model = parse_args(TINY['made'] + ['--device=cpu'])
    server = SampleServer(Model(G), serve_bs=N)
    assert server.warm_passes == graphs_mod.WARMUP + 1
    server.warm()
    captured = _captured(server.model)
    assert captured  # every graph of the pass: request #1 captures none
    a = server.sample(N, seed=3)
    replayed = _captured(server.model)
    assert replayed.keys() == captured.keys()
    assert all(replayed[k] > n for k, n in captured.items())
    server.model.graph_sampling = False
    np.testing.assert_array_equal(a, server.sample(N, seed=3))



def test_pixel_transformer_server_warms_as_its_decode_is_graphed(sim):
    """At --decode_unroll=8 the DecodeGraphs (a PassGraphs) warm up by
    pass: captured by warm(), replayed by request #1, bitwise the per-step
    loop's batch; --decode_unroll=0 is the per-step loop, as
    graphed_sampling says, and its server warms one eager pass."""
    G, Model = parse_args(['--model=pixel_transformer', '--n_layer=1', '--n_embed=16',
                           '--n_head=2', '--decode_unroll=8', '--device=cpu'])
    model = Model(G)
    server = SampleServer(model, serve_bs=N)
    assert model.graphed_sampling() and server.warm_passes == graphs_mod.WARMUP + 1
    server.warm()
    captured = _captured(model)
    assert captured
    a = server.sample(N, seed=3)
    replayed = _captured(model)
    assert replayed.keys() == captured.keys()
    assert all(replayed[k] > n for k, n in captured.items())
    model.G.decode_unroll = 0
    assert not model.graphed_sampling() and SampleServer(model, serve_bs=N).warm_passes == 1
    np.testing.assert_array_equal(a, server.sample(N, seed=3))
    assert _captured(model) == replayed  # the per-step request replayed nothing
