"""The port's pipe axis (generative_models_tpu_torch/parallel/pipeline.py
and pixel_transformer's stages) against the JAX package, on the CPU:
pick_n_micro against JAX's, the GPipe schedule against a sequential stack
at S=2 and S=4 in gloo ranks (forward and gradients), pixel_transformer at
pipe:4, data:2,pipe:2 and pipe:2,model:2 against the JAX package's
one-device pipe:1 run from its stacked init (carried over by the
converter), and a JAX pipe:2 model.pt read through --weights_from. Each
multi-rank case runs in gloo subprocesses with a process-group timeout and
a join timeout (test_torch_mesh.py's _spawn). Tolerances: nlogp rtol 1e-4,
params and Adam moments atol 1e-4 after two steps, forward and gradients
of the schedule atol 1e-5."""

import contextlib

import numpy as np
import pytest
import torch

from test_torch_mesh import _bin_batch, _host, _model, _np, _rows, _spawn

torch.set_num_threads(1)

PT4 = ['--model=pixel_transformer', '--n_layer=4', '--n_embed=32', '--n_head=4']
L, W = 8, 16  # the schedule's test stack: L layers of width W


@pytest.mark.parametrize('batch,stages', [(6, 4), (64, 4), (7, 4), (64, 1), (16, 2),
                                          (8, 4), (1, 2), (12, 8)])
def test_pick_n_micro_matches_jax(batch, stages):
    from generative_models_tpu.parallel.pipeline import pick_n_micro as jax_pick
    from generative_models_tpu_torch.parallel.pipeline import pick_n_micro

    assert pick_n_micro(batch, stages) == jax_pick(batch, stages)


# ---------------------------------------------------------------------- #
# the cases each rank runs
# ---------------------------------------------------------------------- #
def _stack():
    rng = np.random.RandomState(0)
    return (torch.from_numpy((rng.randn(L, W, W) * 0.3).astype(np.float32)),
            torch.from_numpy((rng.randn(L, W) * 0.1).astype(np.float32)),
            torch.from_numpy(rng.randn(32, W).astype(np.float32)))


def _layer(h, w, b):
    return torch.nn.functional.gelu(h @ w + b)


def _case_schedule(case, out):
    """The stack as pipe:S stages, this rank's L / S layers: the output,
    and the gradients of sum(out ** 2) with respect to every layer (all
    gathered over the axis) and the input."""
    import torch.distributed as dist

    from generative_models_tpu_torch.parallel.mesh import Mesh, set_mesh
    from generative_models_tpu_torch.parallel.pipeline import (
        pipe_group, pipeline_apply, stage_layers,
    )

    mesh = Mesh(f"pipe:{case['stages']}")
    set_mesh(mesh)
    g = pipe_group()
    Ws, bs, x = _stack()
    mine = stage_layers(L, case['stages'], g.rank())
    w = Ws[mine.start:mine.stop].clone().requires_grad_()
    b = bs[mine.start:mine.stop].clone().requires_grad_()
    x = x.clone().requires_grad_()

    def stage(h):
        for i in range(len(mine)):
            h = _layer(h, w[i], b[i])
        return h

    y = pipeline_apply(stage, x, group=g)
    (y ** 2).sum().backward()
    parts = []
    for t in (w.grad, b.grad):
        gathered = [torch.empty_like(t) for _ in range(g.size())]
        dist.all_gather(gathered, t, group=g)
        parts.append(torch.cat(gathered).numpy())
    return dict(y=y.detach().numpy(), gw=parts[0], gb=parts[1], gx=x.grad.numpy())


def _case_pipe_steps(case, out):
    """Two train steps on this rank's rows from the JAX init: each step's
    metrics, the gathered params and Adam moments (the whole model's), the
    Blocks and optimizer entries this rank holds, the seed-7 samples, and
    model.pt written by rank 0."""
    from generative_models_tpu_torch.utils import dists

    model = _model(case['flags'])
    model.load_weights(out / f"{case['name']}_init.pt")
    data = dict(np.load(out / f"{case['name']}_in.npz"))
    res = {}
    for i in range(case['steps']):
        metrics = model.train_step(torch.from_numpy(_rows(data[f'x{i}'])))
        for k, v in metrics.items():
            res[f'm{i}/{k}'] = np.float64(v)
    for k, v in model.net_state().items():
        res[f'p/{k}'] = v.numpy()
    names = model._full_names(model.opt)
    for j, st in model._full_opt_state(model.opt)['state'].items():
        res[f'mu/{names[j]}'] = st['exp_avg'].numpy()
        res[f'nu/{names[j]}'] = st['exp_avg_sq'].numpy()
    res['held'] = np.array([i for i, _ in model.net.stage_blocks()])
    res['opt_entries'] = np.array(len(model.opt.state))
    with torch.no_grad(), model.unsharded():
        draws = dists.draw(model.draw_spec(2), torch.Generator().manual_seed(7), model.device)
        res['samples'] = model.sample_from_draws(2, draws).numpy()
    model.save(out / case['name'])
    return res


# ---------------------------------------------------------------------- #
# the JAX package's one-device pipe:1 run
# ---------------------------------------------------------------------- #
@contextlib.contextmanager
def _jax_mesh(spec, n=1):
    import jax
    from generative_models_tpu.parallel import get_mesh, make_mesh, set_mesh

    old = get_mesh()
    set_mesh(make_mesh(spec, jax.devices()[:n]))
    try:
        yield
    finally:
        set_mesh(old)


def _jax_pipe(spec, n, xs, tmp, save=None, jitter=0.0):
    """The JAX PixelTransformer (4 layers, 32 wide) under --mesh=spec on n
    devices, its Blocks stacked: _jax_run's."""
    return _jax_run(PT4, spec, n, xs, tmp, save, jitter, pipe=True)


def _jax_run(flags, spec, n, xs, tmp, save=None, jitter=0.0, pipe=False, f64=False):
    """The JAX model of flags under --mesh=spec on n devices: its init
    (moved by jitter times a seeded normal, with a fresh Adam), each
    step's metrics on xs, and its last params and Adam moments; save: a
    directory for its model.pt and hps.yaml; f64: the steps in float64
    (jax.enable_x64, the f32 init cast up, a fresh Adam)."""
    import jax
    import jax.numpy as jnp
    from generative_models_tpu.utils import discover_models as jax_models
    from generative_models_tpu.utils.config import dump_hps as jax_dump_hps
    from generative_models_tpu.utils.config import parse_args as jax_parse_args

    with _jax_mesh(spec, n):
        G, Model = jax_parse_args(flags + ['--bs=8', f'--mesh={spec}', f'--logdir={tmp}'],
                                  discover_models=jax_models)
        jm = Model(G)
        assert jm.net.use_pipe == pipe
        if jitter:
            rng = np.random.RandomState(1)
            params = jax.tree_util.tree_map(
                lambda p: p + jitter * jnp.asarray(rng.randn(*p.shape), jnp.float32),
                jm.state.params)
            jm.state = jm.state.replace(params=params, opt_state=jm.make_optimizer().init(params))
        init = _host(jm.state)
        dtype = jnp.float64 if f64 else jnp.float32
        with jax.enable_x64(f64):
            if f64:
                params = jax.tree_util.tree_map(lambda p: jnp.asarray(p, dtype), init['params'])
                jm.state = jm.state.replace(params=params,
                                            opt_state=jm.make_optimizer().init(params))
            metrics = [{k: float(v) for k, v in jm.train_step(jnp.asarray(x, dtype)).items()}
                       for x in xs]
        if save is not None:
            jm.save(save)
            jax_dump_hps(G, save)
        last = _host(jm.state)
        adam = _adam(jm.state.opt_state)
    return init, metrics, last, adam


def _adam(opt_state):
    """optax's ScaleByAdamState inside opt_state: {'mu', 'nu'} as numpy."""
    for s in (opt_state if isinstance(opt_state, tuple) else (opt_state,)):
        if hasattr(s, 'mu'):
            return {'mu': _np(s.mu), 'nu': _np(s.nu)}
    raise KeyError('no Adam state')


def test_schedule_matches_the_sequential_stack(tmp_path):
    """pipeline_apply at S=1 (no group, in this process: the same ticks,
    _Shift without a peer) and at S=2 and S=4 (gloo ranks), M =
    pick_n_micro(32, S) microbatches: the output on every stage and the
    gradients of every layer and of the input equal the sequential
    stack's at atol 1e-5 (bitwise those of the microbatches one after
    another at S=1)."""
    from generative_models_tpu_torch.parallel.mesh import set_mesh
    from generative_models_tpu_torch.parallel.pipeline import pick_n_micro, pipeline_apply

    Ws, bs, x = _stack()
    Ws, bs, x = (t.clone().requires_grad_() for t in (Ws, bs, x))
    y = x
    for i in range(L):
        y = _layer(y, Ws[i], bs[i])
    (y ** 2).sum().backward()

    def stack(h, w, b):
        for i in range(L):
            h = _layer(h, w[i], b[i])
        return h

    set_mesh(None)
    runs = []
    for sched in (True, False):
        w, b, xi = (t.detach().clone().requires_grad_() for t in (Ws, bs, x))
        if sched:
            yi = pipeline_apply(lambda h: stack(h, w, b), xi)
        else:  # the microbatches one after another
            yi = torch.cat([stack(m, w, b) for m in xi.chunk(pick_n_micro(32, 1))])
        (yi ** 2).sum().backward()
        runs.append([t.detach() for t in (yi, w.grad, b.grad, xi.grad)])
    for got, one, ref in zip(*runs, (y, Ws.grad, bs.grad, x.grad)):
        assert torch.equal(got, one)
        np.testing.assert_allclose(got.numpy(), ref.detach().numpy(), rtol=0, atol=1e-5)
    for S in (2, 4):
        d = tmp_path / f's{S}'
        d.mkdir()
        out = _spawn(S, [dict(kind='schedule', name='sched', stages=S)], d,
                     module='test_torch_pipeline')['sched']
        np.testing.assert_allclose(out['y'], y.detach().numpy(), rtol=0, atol=1e-5)
        for k, ref in (('gw', Ws.grad), ('gb', bs.grad), ('gx', x.grad)):
            np.testing.assert_allclose(out[k], ref.numpy(), rtol=0, atol=1e-5, err_msg=f'S={S} {k}')


def test_pipe_meshes_match_the_jax_one_device_pipe_run(tmp_path):
    """pixel_transformer (4 layers, 32 wide, bs=8, 2 steps) at pipe:4,
    data:2,pipe:2 and pipe:2,model:2 from the JAX package's stacked init:
    each step's nlogp (rtol 1e-4), the gathered params and both Adam
    moments (atol 1e-4; the key bias, whose gradient is exactly 0, within
    2 lr a step) against the JAX one-device pipe:1 run; each rank holds
    its stage's Blocks and their moments alone; the seed-7 samples equal
    the one-process port's; rank 0's model.pt loads whole under pipe:1 and
    with no pipe axis. data:2,pipe:2 with --fsdp=1 and --grad_clip (the
    norm's squares summed over pipe for a stage's entries) against the
    port's one-process run (atol 1e-5).

    The init is moved off its zeros (0.02 of a normal): at flax's init the
    first position's hidden state is exactly zero through every layer
    (zero biases and pos_emb, a zero input), each LayerNorm scales its
    gradient by rsqrt(eps) = 1e3 (pos_emb's reaches 1e21), and Adam's
    first, sign-only step turns f32 rounding of near-zero elements into
    moves of 2 lr: from that init the port's one-process run, pipe or not,
    lies 1.4e-3 of nlogp from the JAX run at step 1."""
    xs = [_bin_batch(8, s) for s in (0, 1)]
    init, metrics, last, adam = _jax_pipe('pipe:1', 1, xs, tmp_path / 'jax', jitter=0.02)
    conv = _model(PT4).params_from_jax
    ref_p, ref_mu, ref_nu = conv(last['params']), conv(adam['mu']), conv(adam['nu'])
    cases = []
    for mesh in ('pipe:4', 'data:2,pipe:2', 'pipe:2,model:2'):
        name = mesh.replace(':', '').replace(',', '_')
        torch.save(conv(init['params']), tmp_path / f'{name}_init.pt')
        np.savez(tmp_path / f'{name}_in.npz', x0=xs[0], x1=xs[1])
        cases.append(dict(kind='pipe_steps', name=name, flags=PT4 + [f'--mesh={mesh}'], steps=2))
    # FSDP2 over data and the global clip norm (a stage's entries summed
    # over pipe) against the port's one-process run from the same init
    clip = ['--fsdp=1', '--grad_clip=0.05']
    torch.save(conv(init['params']), tmp_path / 'clip_init.pt')
    np.savez(tmp_path / 'clip_in.npz', x0=xs[0], x1=xs[1])
    clip_case = dict(kind='pipe_steps', name='clip', steps=2,
                     flags=PT4 + ['--mesh=data:2,pipe:2', '--grad_clip=0.05', '--fsdp=1'])
    out = _spawn(4, cases + [clip_case], tmp_path, module='test_torch_pipeline')
    ref = _model(PT4 + clip[1:])
    ref.load_weights(tmp_path / 'clip_init.pt')
    for i, x in enumerate(xs):
        np.testing.assert_allclose(out['clip'][f'm{i}/nlogp'],
                                   float(ref.train_step(torch.from_numpy(x))['nlogp']), rtol=1e-5)
    for k, v in ref.net.state_dict().items():
        np.testing.assert_allclose(out['clip'][f'p/{k}'], v.numpy(), rtol=0, atol=1e-5, err_msg=k)

    one = _model(PT4)
    one.net.load_state_dict(ref_p)
    with torch.no_grad():
        from generative_models_tpu_torch.utils import dists

        draws = dists.draw(one.draw_spec(2), torch.Generator().manual_seed(7), one.device)
        samples = one.sample_from_draws(2, draws).numpy()
    held = {'pipe4': [0], 'data2_pipe2': [0, 1], 'pipe2_model2': [0, 1]}
    for case in cases:
        name, res = case['name'], out[case['name']]
        for i, m in enumerate(metrics):
            np.testing.assert_allclose(res[f'm{i}/nlogp'], m['nlogp'], rtol=1e-4,
                                       err_msg=f'{name} step {i}')
        for tag, ref in (('p', ref_p), ('mu', ref_mu), ('nu', ref_nu)):
            got = {k[len(tag) + 1:]: v for k, v in res.items() if k.startswith(tag + '/')}
            assert set(got) == set(ref), (name, tag)
            for k, r in ref.items():
                if tag == 'p' and k.endswith('attn.key.bias'):
                    assert np.abs(got[k] - r.numpy()).max() <= 2 * 1e-3 * 2 * (1 + 1e-6), k
                    continue
                np.testing.assert_allclose(got[k], r.numpy(), rtol=0, atol=1e-4,
                                           err_msg=f'{name} {tag} {k}')
        assert res['held'].tolist() == held[name], name
        n_block = len([k for k in ref_p if k.startswith('blocks.0.')])
        assert int(res['opt_entries']) == len(ref_p) - (4 - len(held[name])) * n_block, name
        np.testing.assert_array_equal(res['samples'], samples, err_msg=name)

    # model.pt of a pipe:4 run is the whole model: it loads under pipe:1
    # and with no pipe axis, params and moments
    ckpt = torch.load(tmp_path / 'pipe4' / 'model.pt', weights_only=True)
    for mesh in ('pipe:1', ''):
        m = _model(PT4 + [f'--mesh={mesh}'])
        m.load_weights(tmp_path / 'pipe4' / 'model.pt')
        assert m.net.use_pipe == bool(mesh) and m.step == 2
        for k, v in m.net.state_dict().items():
            assert torch.equal(v, ckpt['net'][k]), (mesh, k)
        st = m.opt.state_dict()['state']
        for i, n in enumerate(m._opt_names(m.opt)):
            np.testing.assert_array_equal(st[i]['exp_avg'].numpy(), out['pipe4'][f'mu/{n}'])


def _f64_witness(flags, spec, tmp):
    """Two steps from flax's own init (no jitter) of the JAX package's
    one-device run and the port's, both in float64 (the port's net cast by
    .double(), its Adam made on the first step): each step's metrics, and
    the params after them as (port, JAX) pairs of the port's names."""
    xs = [_bin_batch(8, s) for s in (0, 1)]
    init, metrics, last, _ = _jax_run(flags, spec, 1, xs, tmp, pipe='pipe' in spec, f64=True)
    port = _model(flags + [f'--mesh={spec}'])
    port.net.load_state_dict(port.params_from_jax(init['params']))
    port.net.double()
    got = [{k: float(v) for k, v in port.train_step(torch.from_numpy(x).double()).items()}
           for x in xs]
    ref = port.params_from_jax(last['params'])
    return got, metrics, {k: (v.numpy(), ref[k].numpy()) for k, v in port.net.state_dict().items()}


def _check_f64_witness(got, metrics, params, lr=1e-3):
    """Each step's metrics at rtol 1e-6 (in float32 the step-1 nlogp lies
    1.4e-3 apart from this init) and every parameter at atol 1e-4, the key
    bias (its gradient exactly 0) within 2 lr a step."""
    for i, m in enumerate(metrics):
        for k, v in m.items():
            np.testing.assert_allclose(got[i][k], v, rtol=1e-6, err_msg=f'step {i} {k}')
    for k, (a, b) in params.items():
        assert a.dtype == np.float64, k
        if k.endswith('attn.key.bias'):
            assert np.abs(a - b).max() <= 2 * lr * len(metrics) * (1 + 1e-6), k
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=k)


def test_pipe1_in_float64_from_flax_init_matches_jax(tmp_path):
    """The witness for the jitter of the test above: from flax's own init,
    where the float32 runs of the two packages part by 1.4e-3 of nlogp at
    step 1, the port's pipe:1 (the GPipe schedule) and the JAX package's
    stacked pipe:1 run, both in float64, agree (_check_f64_witness): the
    float32 gap is rounding, not the port."""
    _check_f64_witness(*_f64_witness(PT4, 'pipe:1', tmp_path / 'jax'))


def test_a_jax_pipe2_checkpoint_loads_through_weights_from(tmp_path):
    """A JAX package's model.pt written at --mesh=pipe:2 (its Blocks and
    their Adam moments stacked on a leading layer axis) reads through
    --weights_from under pipe:1 and with no pipe axis: the params and both
    moments as the converter lays them out, the step count."""
    from generative_models_tpu_torch.utils.config import parse_args

    xs = [_bin_batch(8, 2)]
    _, _, last, adam = _jax_pipe('pipe:2', 2, xs, tmp_path / 'jax', save=tmp_path / 'ckpt')
    conv = _model(PT4).params_from_jax
    ref_p, ref_mu = conv(last['params']), conv(adam['mu'])
    for mesh in ('pipe:1', ''):
        G, Model = parse_args([f'--weights_from={tmp_path / "ckpt" / "model.pt"}',
                               '--device=cpu', f'--mesh={mesh}'])
        m = Model(G)
        m.load_weights(G.weights_from)
        assert m.net.use_pipe == bool(mesh) and m.step == 1 and m.updates == 1
        for k, v in m.net.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), ref_p[k].numpy(), err_msg=k)
        st = m.opt.state_dict()['state']
        for i, n in enumerate(m._opt_names(m.opt)):
            np.testing.assert_array_equal(st[i]['exp_avg'].numpy(), ref_mu[n].numpy(), err_msg=n)
