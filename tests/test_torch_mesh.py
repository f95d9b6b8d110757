"""The port's mesh over ranks (generative_models_tpu_torch/parallel/mesh.py)
against the JAX package's one-device run, on the CPU: the spec rules and the
env-gated init in this process, then every multi-rank case in gloo ranks,
each rank a subprocess with a process-group timeout and a join timeout
(a deadlock fails in under a minute or two instead of hanging the suite),
the cases of a world size grouped into one spawn.

The JAX references run here at one device (its tests show that its meshes
give those numbers); the ranks import nothing of JAX. Each case starts
from the JAX init, carried over as a params-only model.pt that every rank
lays out on its mesh, takes its steps on its rows of the same batches (and
its slice of the JAX draws where the model draws), gathers the full state
and rank 0 writes it. Tolerances are the JAX tests': nlogp / loss rtol
1e-4, params atol 1e-4 after one or two steps, samples atol 1e-5."""

import contextlib
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)

PT = ['--model=pixel_transformer', '--n_layer=2', '--n_embed=32', '--n_head=4']
MADE = ['--model=made', '--hidden_size=32']
DIFF = ['--model=diffusion_model', '--hidden_size=32', '--timesteps=4', '--bf16=0',
        '--eval_heavy=0', '--cf_drop_prob=0.2']
GAN = ['--model=gan', '--hidden_size=8', '--noise_size=16']
VQ = ['--model=vqvae', '--hidden_size=16', '--vqD=8', '--vqK=16', '--n_layer=1',
      '--n_embed=32', '--n_head=2']
BN_FED = {'gen.deconvs.0.bias', 'gen.deconvs.1.bias', 'gen.deconvs.2.bias',
          'disc.convs.1.bias', 'disc.convs.2.bias'}  # exact gradient 0 (test_torch_gan.py)


# ---------------------------------------------------------------------- #
# the ranks
# ---------------------------------------------------------------------- #
def _worker(rank, n, store, spec, out, module=__name__):
    """One gloo rank: joins the group through the FileStore, then runs each
    case of spec (a JSON list) in order, each a _case_<kind> function of
    module (a test file's)."""
    import importlib

    import torch.distributed as dist

    rank, n, out = int(rank), int(n), Path(out)
    cases = vars(importlib.import_module(module))
    dist.init_process_group('gloo', store=dist.FileStore(store, n), rank=rank, world_size=n,
                            timeout=timedelta(seconds=60))
    try:
        for case in json.loads(Path(spec).read_text()):
            res = cases['_case_' + case['kind']](case, out)
            if rank == 0 and res is not None:
                np.savez(out / f"{case['name']}.npz", **res)
    finally:
        dist.destroy_process_group()


def _model(flags):
    from generative_models_tpu_torch.utils.config import parse_args

    G, Model = parse_args(flags + ['--device=cpu'])
    return Model(G)


def _rows(a):
    from generative_models_tpu_torch.parallel.mesh import data_slice

    return None if a is None else a[data_slice(len(a))]


def _case_steps(case, out):
    """The case's steps from its init: train_step on this rank's rows (and
    draws), the metrics of each step, the gathered state, the FSDP shard
    fractions, and optionally samples from given uniforms."""
    from generative_models_tpu_torch.parallel.mesh import local

    model = _model(case['flags'])
    model.load_weights(out / f"{case['name']}_init.pt")
    data = dict(np.load(out / f"{case['name']}_in.npz"))
    res = {}
    for i in range(case['steps']):
        x = torch.from_numpy(_rows(data[f'x{i}']))
        y = torch.from_numpy(_rows(data[f'y{i}'])) if f'y{i}' in data else None
        kw = {}
        if f'noise{i}' in data:
            kw['noise'] = torch.from_numpy(_rows(data[f'noise{i}']))
        draws = {k[:-len(str(i))]: torch.from_numpy(_rows(v))
                 for k, v in data.items() if k.startswith('draw_') and k.endswith(str(i))}
        if draws:
            kw['draws'] = {k[5:]: v for k, v in draws.items()}
        metrics = model.train_step(x, y, **kw)
        for k, v in metrics.items():
            res[f'm{i}/{k}'] = np.float64(v)
        if i == 0:
            for k, v in model.net_state().items():
                res[f'p0/{k}'] = v.numpy()
    for k, v in model.net_state().items():
        res[f'p/{k}'] = v.numpy()
    for name, p in model.net.named_parameters():
        st = next(o.state[p] for o in model.optimizers().values() if p in o.state)
        res[f'frac/{name}'] = np.array([p.numel(), local(p).numel(), local(st['exp_avg']).numel(),
                                        local(st['exp_avg_sq']).numel()])
    if 'uniforms' in data:
        with torch.no_grad():
            res['samples'] = model.sample_fn(data['uniforms'].shape[1],
                                             uniforms=torch.from_numpy(data['uniforms']),
                                             with_frames=False).numpy()
    return res


def _case_grads(case, out):
    """The gradients of one batch on this rank's rows and draws, averaged
    over the ranks as before an optimizer step, gathered full."""
    from generative_models_tpu_torch.parallel.mesh import gather_full

    model = _model(case['flags'])
    model.load_weights(out / f"{case['name']}_init.pt")
    data = dict(np.load(out / f"{case['name']}_in.npz"))
    draws = {k[5:-1]: torch.from_numpy(_rows(v)) for k, v in data.items()
             if k.startswith('draw_') and k.endswith('0')}
    metrics = model.backward(torch.from_numpy(_rows(data['x0'])),
                             torch.from_numpy(_rows(data['y0'])), draws=draws)
    model.sync_grads(model.net.parameters())
    res = {f'm0/{k}': np.float64(v) for k, v in metrics.items()}
    for name, p in model.net.named_parameters():
        res[f'g/{name}'] = gather_full(p.grad, model.layout.get(name)).numpy()
    return res


def _case_main(case, out):
    """main.main on every rank (the logdir's model.pt written by rank 0)."""
    from generative_models_tpu_torch.data import mnist
    from generative_models_tpu_torch.main import main

    mnist.TRAIN_N, mnist.TEST_N = 32, 16
    with contextlib.redirect_stdout(open(os.devnull, 'w')):
        main(case['flags'] + ['--device=cpu'])
    return None


def _spawn(n, cases, tmp_path, timeout=300, module=__name__):
    """Run cases in n gloo ranks, each case a _case_<kind> function of
    module; returns {name: rank 0's arrays}."""
    spec = tmp_path / 'cases.json'
    spec.write_text(json.dumps(cases))
    code = ('import sys; sys.path[:0] = [{!r}, {!r}]; import test_torch_mesh as t; '
            't._worker(*sys.argv[1:])').format(str(REPO), str(REPO / 'tests'))
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-c', code, str(r), str(n), str(tmp_path / 'store'), str(spec),
         str(tmp_path), module], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(n)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * n, '\n'.join(l[-3000:] for l in logs)
    return {c['name']: dict(np.load(tmp_path / f"{c['name']}.npz"))
            for c in cases if c['kind'] != 'main'}


# ---------------------------------------------------------------------- #
# the JAX package's one-device run
# ---------------------------------------------------------------------- #
@contextlib.contextmanager
def _one_device():
    import jax
    from generative_models_tpu.parallel import get_mesh, make_mesh, set_mesh

    old = get_mesh()
    set_mesh(make_mesh('', jax.devices()[:1]))
    try:
        yield
    finally:
        set_mesh(old)


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _host(state):
    """A JAX TrainState's params and extra as numpy (before a step donates
    its buffers)."""
    return {'params': _np(state.params), 'extra': _np(state.extra or {})}


def _port_state(flags, tree):
    """_host's tree as the port's full state dict."""
    return _model(flags).net_state_from_jax(tree)


def _jax_steps(flags, xs, ys=None, tmp=None):
    """(the JAX model, its init state, each step's metrics, its last state)
    of train_step on xs at one device."""
    import jax.numpy as jnp
    from generative_models_tpu.utils import discover_models as jax_models
    from generative_models_tpu.utils.config import parse_args as jax_parse_args

    with _one_device():
        G, Model = jax_parse_args(flags + [f'--logdir={tmp}'], discover_models=jax_models)
        jm = Model(G)
        init = _host(jm.state)
        metrics = [{k: float(v) for k, v in jm.train_step(
            jnp.asarray(x), None if ys is None else jnp.asarray(ys[i])).items()}
            for i, x in enumerate(xs)]
    return jm, init, metrics, _host(jm.state)


def _bin_batch(B, seed):
    return (np.random.RandomState(seed).rand(B, 28, 28, 1) > 0.5).astype(np.float32)


def _prepare(tmp_path, name, flags, init_sd, arrays):
    torch.save(init_sd, tmp_path / f'{name}_init.pt')
    np.savez(tmp_path / f'{name}_in.npz', **arrays)


def _check(name, res, metrics, ref_sd, skip=(), atol=1e-4, lr=1e-3):
    """Each step's metrics (rtol 1e-4) and every parameter (atol) of case
    name. The entries in skip have an exact gradient of 0 (a transformer's
    key bias: softmax does not see a constant added to a row's scores;
    the convs that feed a BatchNorm): each side's steps follow Adam's sign of
    its rounding, so they are held to 2 lr a step."""
    for i, m in enumerate(metrics):
        for k, v in m.items():
            np.testing.assert_allclose(res[f'm{i}/{k}'], v, rtol=1e-4,
                                       err_msg=f'{name} step {i} {k}')
    got = {k[2:]: v for k, v in res.items() if k.startswith('p/')}
    assert set(got) == set(ref_sd), name
    for k, ref in ref_sd.items():
        if k in skip or k.endswith('attn.key.bias'):
            assert np.abs(got[k] - ref.numpy()).max() <= 2 * lr * len(metrics) * (1 + 1e-6), k
            continue
        np.testing.assert_allclose(got[k], ref.numpy(), rtol=0, atol=atol, err_msg=f'{name} {k}')


# ---------------------------------------------------------------------- #
# one process: the spec rules and the env-gated init
# ---------------------------------------------------------------------- #
def test_spec_rules_and_the_one_card_rule():
    from generative_models_tpu.parallel.mesh import parse_mesh_spec as jax_parse
    from generative_models_tpu_torch.parallel import mesh as pm

    for spec in ('data:4', 'data:2,model:2', 'model:2,seq:2', 'data:2,seq:2'):
        assert pm.parse_mesh_spec(spec) == jax_parse(spec, 4)
    m = pm.Mesh('seq:4')  # the one-card ring needs no group
    assert (m.dm, m.size('seq'), m.size('data'), m.is_main) == (None, 4, 1, True)
    for spec in ('data:2', 'model:2', 'data:2,seq:2', 'pipe:2', 'expert:2', 'data:1,pipe:4'):
        with pytest.raises(RuntimeError, match='torchrun --nproc_per_node='):
            pm.Mesh(spec)
    # pipe:1 and expert:1 build without a group; pipe:1 runs the whole
    # pipeline machinery, its Blocks one stage
    m = pm.Mesh('pipe:1,expert:1')
    assert (m.dm, m.size('pipe'), m.size('expert')) == (None, 1, 1)
    pt = _model(PT + ['--mesh=pipe:1'])
    assert pt.net.pipe == 1 and not pt.net.use_fused_decode
    assert [i for i, _ in pt.net.stage_blocks()] == [0, 1] and set(pt.stage_of.values()) == {0}
    with pytest.raises(ValueError, match='unknown axis'):
        pm.Mesh('tensor:2')
    # without a group every collective is the identity
    x = torch.ones(3, requires_grad=True)
    assert pm.tp_copy(x) is x and pm.tp_reduce(x) is x and pm.batch_mean(x) is x
    with pytest.raises(RuntimeError, match='torchrun'):
        _model(MADE + ['--fsdp=1'])


def test_layout_helpers_without_a_group():
    """Without a group the layout helpers act on full tensors: gather_full
    gives the tensor, put_ copies in place and refuses another shape
    (copy_ would broadcast it), and the clip norm's buckets weigh each
    entry once."""
    from generative_models_tpu_torch.parallel import mesh as pm

    pm.set_mesh(None)
    dst = torch.zeros(4, 3)
    assert torch.equal(pm.gather_full(dst), dst)
    pm.put_(dst, torch.ones(4, 3, dtype=torch.float64))
    assert dst.dtype == torch.float32 and bool(dst.eq(1).all())
    with pytest.raises(ValueError, match='does not fit'):
        pm.put_(dst, torch.ones(1, 3))
    grads = [torch.ones(2), torch.full((3,), 2.0), torch.ones(1)]
    buckets = pm.norm_buckets(grads, [(), ('model',), ('expert', 'pipe')])
    weights, axes = buckets
    assert weights.shape == (16, 3) and axes == ()
    assert [weights[:, i].nonzero().flatten().tolist() for i in range(3)] == [[0], [2], [12]]
    assert float(pm.global_sq_norm(grads, buckets)) == 15.0


def test_init_distributed_gates_on_the_env(monkeypatch):
    """No RANK/WORLD_SIZE: nothing joined and the device kept; with them a
    group is joined (gloo on the CPU), the counterpart of
    maybe_initialize_distributed."""
    import torch.distributed as dist
    from generative_models_tpu_torch.parallel import mesh as pm

    for k in ('RANK', 'WORLD_SIZE'):
        monkeypatch.delenv(k, raising=False)
    assert pm.init_distributed(torch.device('cpu')) == torch.device('cpu')
    assert not dist.is_initialized()
    port = 29500 + os.getpid() % 1000
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('WORLD_SIZE', '1')
    monkeypatch.setenv('MASTER_ADDR', 'localhost')
    monkeypatch.setenv('MASTER_PORT', str(port))
    try:
        pm.init_distributed(torch.device('cpu'))
        assert dist.is_initialized() and dist.get_backend() == 'gloo'
        mesh = pm.Mesh('data:1,model:1')
        assert mesh.grouped and mesh.dm is not None and mesh.size('model') == 1
        with pytest.raises(ValueError, match='needs 2 ranks'):
            pm.Mesh('data:2')
    finally:
        dist.destroy_process_group()
        pm.set_mesh(None)


def test_serving_runs_in_one_process(tmp_path, monkeypatch):
    """The server's mesh rules: without a group a checkpoint's axes that
    span ranks (data, model, pipe, expert) and its --fsdp are dropped and
    its seq axis kept, while --mesh on the command line stands; under a
    group (torchrun's env) the checkpoint's mesh is inherited; --export and
    --from_export under a group are refused by name, and so is --quantize
    with any axis but data above 1."""
    from generative_models_tpu_torch.serve import load_server, serving_mesh
    from generative_models_tpu_torch.utils.config import AttrDict

    G = AttrDict(mesh='data:2,model:2,pipe:2,expert:2,seq:4', fsdp=1)
    serving_mesh(G, [])
    assert (G.mesh, G.fsdp) == ('seq:4', 0)
    G = AttrDict(mesh='data:2', fsdp=1)
    serving_mesh(G, ['--mesh=data:2'])
    assert (G.mesh, G.fsdp) == ('data:2', 0)
    for k in ('RANK', 'WORLD_SIZE'):
        monkeypatch.setenv(k, '0' if k == 'RANK' else '4')
    G = AttrDict(mesh='data:2,pipe:2', fsdp=1)
    serving_mesh(G, [])
    assert (G.mesh, G.fsdp) == ('data:2,pipe:2', 1)
    for flag in ('--export=a.pt2', '--from_export=a.pt2'):
        with pytest.raises(SystemExit, match='not under a process group'):
            load_server(['--model=made', '--device=cpu', flag])
    monkeypatch.delenv('RANK')
    monkeypatch.delenv('WORLD_SIZE')
    for mesh in ('model:2', 'pipe:2', 'expert:2,data:1'):
        with pytest.raises(SystemExit, match='--quantize does not compose'):
            load_server(PT + ['--device=cpu', f'--mesh={mesh}', '--quantize=w8a16'])


# ---------------------------------------------------------------------- #
# four ranks
# ---------------------------------------------------------------------- #
def test_four_rank_meshes_match_the_jax_one_device_run(tmp_path):
    """made at data:4 (and with --fsdp=1: every leaf of at least
    FSDP_MIN_SIZE elements and both its Adam moments hold a quarter on each
    rank); pixel_transformer at data:2,model:2, data:2,seq:2 and
    model:2,seq:2 (two steps, then samples from the same uniforms as the
    one-process port's), with --moe_experts=4 at data:2,seq:2, and with
    --fsdp=1 --grad_clip under data:2,model:2; diffusion at data:2,model:2, two steps from the JAX
    draws: each case's metrics and parameters against the JAX package's
    one-device run."""
    import jax
    import jax.numpy as jnp
    import optax

    from generative_models_tpu_torch.parallel.mesh import FSDP_MIN_SIZE

    cases, refs = [], {}
    xs = [_bin_batch(8, s) for s in (0, 1)]

    jm, init, metrics, last = _jax_steps(MADE + ['--bs=8'], xs, tmp=tmp_path / 'jm')
    for name, extra in (('made', []), ('made_fsdp', ['--fsdp=1'])):
        flags = MADE + ['--mesh=data:4'] + extra
        _prepare(tmp_path, name, flags, _port_state(MADE, init), dict(x0=xs[0], x1=xs[1]))
        cases.append(dict(kind='steps', name=name, flags=flags, steps=2))
        refs[name] = (metrics, _port_state(MADE, last))

    u = np.random.RandomState(5).rand(784, 2, 1).astype(np.float32)
    jm, init, metrics, last = _jax_steps(PT, xs, tmp=tmp_path / 'jpt')
    for mesh in ('data:2,model:2', 'data:2,seq:2', 'model:2,seq:2'):
        name = 'pt_' + mesh.replace(':', '').replace(',', '_')
        flags = PT + [f'--mesh={mesh}']
        _prepare(tmp_path, name, flags, _port_state(PT, init),
                 dict(x0=xs[0], x1=xs[1], uniforms=u))
        cases.append(dict(kind='steps', name=name, flags=flags, steps=2))
        refs[name] = (metrics, _port_state(PT, last))

    # MoE with the sequence split: a token's queue position counts its
    # row's tokens on the seq ranks before it, f and p are global means
    moe = PT[:-1] + ['--n_head=2', '--moe_experts=4']
    jm, init, metrics, last = _jax_steps(moe, xs, tmp=tmp_path / 'jmoe')
    flags = moe + ['--mesh=data:2,seq:2']
    _prepare(tmp_path, 'moe_data2_seq2', flags, _port_state(moe, init), dict(x0=xs[0], x1=xs[1]))
    cases.append(dict(kind='steps', name='moe_data2_seq2', flags=flags, steps=2))
    refs['moe_data2_seq2'] = (metrics, _port_state(moe, last))

    clip = ['--grad_clip=0.05']
    jm, init, metrics, last = _jax_steps(PT + clip, xs, tmp=tmp_path / 'jclip')
    flags = PT + clip + ['--mesh=data:2,model:2', '--fsdp=1']
    _prepare(tmp_path, 'pt_clip_fsdp_tp', flags, _port_state(PT, init), dict(x0=xs[0], x1=xs[1]))
    cases.append(dict(kind='steps', name='pt_clip_fsdp_tp', flags=flags, steps=2))
    refs['pt_clip_fsdp_tp'] = (metrics, _port_state(PT, last))

    # diffusion: the JAX loss and optax at explicit keys, the port fed the
    # same draws (each rank its rows): both steps' losses, as the JAX
    # package's own TP test holds them, and the first batch's gradients
    # (Adam makes a parameter whose gradient is rounding-sized move by up
    # to lr either way, so its parameters are held through the gradients,
    # as tests/test_torch_diffusion_model.py holds them)
    from test_torch_diffusion_model import jax_model_draws

    from generative_models_tpu.utils import discover_models as jax_models
    from generative_models_tpu.utils.config import parse_args as jax_parse_args

    rng = np.random.RandomState(0)
    dx = [np.clip(rng.randn(4, 28, 28, 1), -1, 1).astype(np.float32) for _ in range(2)]
    dy = [np.array([0, 3, 7, 9], np.int32), np.array([1, 5, 2, 8], np.int32)]
    with _one_device():
        G, Model = jax_parse_args(DIFF + [f'--logdir={tmp_path / "jd"}'],
                                  discover_models=jax_models)
        jd = Model(G)
        params = jax.tree_util.tree_map(  # moved off the zero-init convs
            lambda p: p + 0.05 * jnp.asarray(np.random.RandomState(1).randn(*p.shape),
                                             jnp.float32), jd.state.params)
        init_sd = _model(DIFF).net_state_from_jax({'params': _np(params)})
        opt = jd.make_optimizer()
        opt_state = opt.init(params)
        arrays, dmetrics, dgrads = {}, [], None
        grad_fn = jax.jit(jax.value_and_grad(jd.loss, has_aux=True), static_argnums=4)
        for i in range(2):
            key = jax.random.key(10 + i)
            for k, v in jax_model_draws(key, dy[i].shape, dx[i].shape, 4).items():
                arrays[f'draw_{k}{i}'] = v.numpy()
            (loss, _), grads = grad_fn(params, jnp.asarray(dx[i]), jnp.asarray(dy[i]), key, True)
            dmetrics.append({'loss': float(loss)})
            dgrads = dgrads or _model(DIFF).net_state_from_jax({'params': _np(grads)})
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
    flags = DIFF + ['--mesh=data:2,model:2']
    arrays.update(x0=dx[0], x1=dx[1], y0=dy[0], y1=dy[1])
    for name in ('diff', 'diff_grads'):
        _prepare(tmp_path, name, flags, init_sd, arrays)
    cases.append(dict(kind='steps', name='diff', flags=flags, steps=2))
    cases.append(dict(kind='grads', name='diff_grads', flags=flags))

    out = _spawn(4, cases, tmp_path)

    for name, (metrics, ref_sd) in refs.items():
        _check(name, out[name], metrics, ref_sd)
    for i, m in enumerate(dmetrics):
        np.testing.assert_allclose(out['diff'][f'm{i}/loss'], m['loss'], rtol=1e-4)
    np.testing.assert_allclose(out['diff_grads']['m0/loss'], dmetrics[0]['loss'], rtol=1e-4)
    total = float(np.sqrt(sum((g.double() ** 2).sum() for g in dgrads.values())))
    for k, ref in dgrads.items():
        err = np.linalg.norm(out['diff_grads'][f'g/{k}'].astype(np.float64) - ref.double().numpy())
        assert err <= 1e-4 * float(torch.linalg.vector_norm(ref.double())) + 1e-6 * total, k

    # FSDP: each large leaf and both its moments split four ways (the
    # small ones too: FSDP2's layout, ROADMAP.md queue 3)
    large = 0
    for k, v in out['made_fsdp'].items():
        if k.startswith('frac/') and v[0] >= FSDP_MIN_SIZE:
            large += 1
            assert list(v[1:]) == [v[0] // 4] * 3, (k, v)
    assert large >= 1
    assert all(v[1] == v[0] for k, v in out['made'].items() if k.startswith('frac/'))

    # sampling under every axis: the one-process port's samples
    one = _model(PT)
    one.net.load_state_dict({k: torch.from_numpy(v) for k, v in
                             ((k[2:], v) for k, v in out['pt_data2_model2'].items()
                              if k.startswith('p/'))})
    with torch.no_grad():
        ref = one.sample_fn(2, uniforms=torch.from_numpy(u), with_frames=False).numpy()
    for name in ('pt_data2_model2', 'pt_data2_seq2', 'pt_model2_seq2'):
        np.testing.assert_allclose(out[name]['samples'], ref, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------- #
# two ranks
# ---------------------------------------------------------------------- #
def test_two_rank_meshes_match_the_jax_one_device_run(tmp_path):
    """pixel_transformer --moe_experts=4 at data:2 (the aux from global f
    and p) and at model:2 (the experts' hidden dim split); gan at data:2
    (its BatchNorm statistics over the global batch, from the JAX step's
    noise); vqvae at model:2 (the prior's TP): metrics and parameters
    against the JAX package's one-device run."""
    import jax

    cases, refs = [], {}
    xs = [_bin_batch(8, s) for s in (0, 1)]
    moe = PT[:-1] + ['--n_head=2', '--moe_experts=4']
    jm, init, metrics, last = _jax_steps(moe, xs, tmp=tmp_path / 'jmoe')
    for mesh in ('data:2', 'model:2'):
        name = 'moe_' + mesh.replace(':', '')
        flags = moe + [f'--mesh={mesh}']
        _prepare(tmp_path, name, flags, _port_state(moe, init), dict(x0=xs[0], x1=xs[1]))
        cases.append(dict(kind='steps', name=name, flags=flags, steps=2))
        refs[name] = (metrics, _port_state(moe, last))

    gx = [2 * np.random.RandomState(s).rand(8, 28, 28, 1).astype(np.float32) - 1 for s in (0, 1)]
    with _one_device():
        from generative_models_tpu.utils import discover_models as jax_models
        from generative_models_tpu.utils.config import parse_args as jax_parse_args

        G, Model = jax_parse_args(GAN + [f'--logdir={tmp_path / "jg"}'],
                                  discover_models=jax_models)
        jg = Model(G)
        ginit = _host(jg.state)
        noise, gmetrics = [], []
        for x in gx:
            noise.append(np.array(jax.random.normal(
                jax.random.fold_in(jg.state.rng, jg.state.step), (8, 16))))
            gmetrics.append({k: float(v) for k, v in jg.train_step(x).items()})
    flags = GAN + ['--mesh=data:2']
    _prepare(tmp_path, 'gan', flags, _port_state(GAN, ginit),
             dict(x0=gx[0], x1=gx[1], noise0=noise[0], noise1=noise[1]))
    cases.append(dict(kind='steps', name='gan', flags=flags, steps=2))
    refs['gan'] = (gmetrics, _port_state(GAN, _host(jg.state)))

    vx = [_bin_batch(4, s) for s in (2, 3)]
    jv, vinit, vmetrics, vlast = _jax_steps(VQ, vx, tmp=tmp_path / 'jv')
    flags = VQ + ['--mesh=model:2']
    _prepare(tmp_path, 'vq', flags, _port_state(VQ, vinit), dict(x0=vx[0], x1=vx[1]))
    cases.append(dict(kind='steps', name='vq', flags=flags, steps=2))
    refs['vq'] = (vmetrics, _port_state(VQ, vlast))

    out = _spawn(2, cases, tmp_path)
    for name in ('moe_data2', 'moe_model2', 'vq'):
        _check(name, out[name], *refs[name])
    _check('gan', out['gan'], *refs['gan'], skip=BN_FED, lr=5e-5)


def test_main_over_two_ranks_and_resume_across_meshes(tmp_path):
    """main.main at data:2: rank 0's model.pt holds full tensors and loads
    bitwise into one process; a one-process checkpoint resumes on the
    data:2 mesh and trains on as a one-process resume does."""
    from generative_models_tpu_torch.data import mnist
    from generative_models_tpu_torch.main import main

    base = MADE + ['--bs=8', '--data_source=synthetic', '--save_n=1', '--epochs=1']
    one_dir, res_one, res_mesh = tmp_path / 'one', tmp_path / 'res_one', tmp_path / 'res_mesh'
    old = mnist.TRAIN_N, mnist.TEST_N
    mnist.TRAIN_N, mnist.TEST_N = 32, 16
    try:
        with contextlib.redirect_stdout(open(os.devnull, 'w')):
            main(base + [f'--logdir={one_dir}', '--device=cpu'])
            for d in (res_one, res_mesh):
                d.mkdir()
                for f in ('model.pt', 'hps.yaml'):
                    (d / f).write_bytes((one_dir / f).read_bytes())
            main(base + ['--epochs=2', '--resume=1', f'--logdir={res_one}', '--device=cpu'])
    finally:
        mnist.TRAIN_N, mnist.TEST_N = old
    cases = [
        dict(kind='main', name='mesh_run', flags=base + ['--mesh=data:2',
                                                          f'--logdir={tmp_path / "mesh"}']),
        dict(kind='main', name='mesh_resume',
             flags=base + ['--epochs=2', '--resume=1', '--mesh=data:2', f'--logdir={res_mesh}']),
    ]
    _spawn(2, cases, tmp_path)

    state = torch.load(tmp_path / 'mesh' / 'model.pt', weights_only=True)
    model = _model(MADE)
    model.load_weights(tmp_path / 'mesh' / 'model.pt')
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, state['net'][k]), k
    assert model.step == state['step'] == 4  # 32 rows, bs 8, one epoch

    a = torch.load(res_one / 'model.pt', weights_only=True)
    b = torch.load(res_mesh / 'model.pt', weights_only=True)
    assert a['step'] == b['step'] == 8
    for k in a['net']:
        np.testing.assert_allclose(b['net'][k].numpy(), a['net'][k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    for i in a['opt']['state']:
        for m in ('exp_avg', 'exp_avg_sq'):
            np.testing.assert_allclose(b['opt']['state'][i][m].numpy(),
                                       a['opt']['state'][i][m].numpy(), rtol=1e-4, atol=1e-7)
