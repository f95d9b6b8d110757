"""The port's expert axis (generative_models_tpu_torch/models/moe.py under
--mesh=...,expert:N) against the JAX package's one-device run, on the CPU:
pixel_transformer --moe_experts=4 at data:2,expert:2 in four gloo ranks
(test_torch_mesh.py's _spawn: a process-group timeout and a join
timeout), two steps from the JAX init, at tests/test_moe.py's tolerances:
nlogp and the aux loss rtol 1e-4, samples atol 1e-5, and params and both
Adam moments atol 1e-4. The init is moved off its zeros, as
tests/test_torch_pipeline.py's (its docstring says why: at flax's init
the first position's hidden state is exactly zero through every layer,
each LayerNorm scales its gradient by rsqrt(eps), pos_emb's first moment
reaches 3e6, and its f32 rounding decides moments near a cancellation).
Beside it, the seq axis on a model without ring attention (made at seq:2
in two ranks) against the no-mesh run."""

import numpy as np
import torch

from test_torch_mesh import PT, _bin_batch, _check, _model, _port_state, _rows, _spawn

torch.set_num_threads(1)

MOE = PT[:-1] + ['--n_head=2', '--moe_experts=4']


def _case_expert_steps(case, out):
    """Two train steps on this rank's rows from the JAX init: the metrics,
    the gathered params and Adam moments, the local shapes of each
    expert-stacked leaf and of its moments, the seed-7 samples."""
    from generative_models_tpu_torch.parallel.mesh import local
    from generative_models_tpu_torch.utils import dists

    model = _model(case['flags'])
    model.load_weights(out / f"{case['name']}_init.pt")
    data = dict(np.load(out / f"{case['name']}_in.npz"))
    res = {}
    for i in range(case['steps']):
        for k, v in model.train_step(torch.from_numpy(_rows(data[f'x{i}']))).items():
            res[f'm{i}/{k}'] = np.float64(v)
    for k, v in model.net_state().items():
        res[f'p/{k}'] = v.numpy()
    names = model._full_names(model.opt)
    for j, st in model._full_opt_state(model.opt)['state'].items():
        res[f'mu/{names[j]}'] = st['exp_avg'].numpy()
        res[f'nu/{names[j]}'] = st['exp_avg_sq'].numpy()
    for name, p in model.net.named_parameters():
        if '.moe.' in name and not name.endswith('router.weight'):
            st = model.opt.state[p]
            res[f'local/{name}'] = np.array([local(t).shape[0] for t in
                                             (p, st['exp_avg'], st['exp_avg_sq'])])
    with torch.no_grad():
        draws = dists.draw(model.draw_spec(2), torch.Generator().manual_seed(7), model.device)
        res['samples'] = model.sample_from_draws(2, draws).numpy()
    return res


def test_data2_expert2_matches_the_jax_one_device_run(tmp_path):
    """--moe_experts=4 at data:2,expert:2: each step's nlogp and moe_aux
    (rtol 1e-4), the params and both Adam moments (atol 1e-4; the key
    bias, whose gradient is exactly 0, within 2 lr a step) against the JAX
    package's one-device run from its init moved by 0.02 of a normal; every rank holds 2 of the 4 experts in wi,
    bi, wo, bo and in their moments; the seed-7 samples equal the
    one-process port's."""
    from test_torch_pipeline import _jax_run

    xs = [_bin_batch(8, s) for s in (0, 1)]
    init, metrics, last, adam = _jax_run(MOE, '', 1, xs, tmp_path / 'jax', jitter=0.02)
    conv = _model(MOE).params_from_jax
    flags = MOE + ['--mesh=data:2,expert:2']
    torch.save(_port_state(MOE, init), tmp_path / 'ep_init.pt')
    np.savez(tmp_path / 'ep_in.npz', x0=xs[0], x1=xs[1])
    res = _spawn(4, [dict(kind='expert_steps', name='ep', flags=flags, steps=2)], tmp_path,
                 module='test_torch_expert')['ep']

    _check('data:2,expert:2', res, metrics, _port_state(MOE, last))
    for tag in ('mu', 'nu'):
        ref = conv(adam[tag])
        got = {k[len(tag) + 1:]: v for k, v in res.items() if k.startswith(tag + '/')}
        assert set(got) == set(ref), tag
        for k, r in ref.items():
            np.testing.assert_allclose(got[k], r.numpy(), rtol=0, atol=1e-4, err_msg=f'{tag} {k}')
    shapes = {k[6:]: v.tolist() for k, v in res.items() if k.startswith('local/')}
    assert len(shapes) == 8 and all(v == [2, 2, 2] for v in shapes.values()), shapes

    one = _model(MOE)
    one.net.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in res.items()
                             if k.startswith('p/')})
    with torch.no_grad():
        from generative_models_tpu_torch.utils import dists

        draws = dists.draw(one.draw_spec(2), torch.Generator().manual_seed(7), one.device)
        np.testing.assert_allclose(res['samples'], one.sample_from_draws(2, draws).numpy(),
                                   rtol=0, atol=1e-5)


def test_moe_in_float64_from_flax_init_matches_jax(tmp_path):
    """The witness for the jitter of the test above: from flax's own init
    the port's --moe_experts=4 run and the JAX package's, both in float64,
    agree after two steps: metrics at rtol 1e-6, params at atol 1e-4
    (tests/test_torch_pipeline.py's _check_f64_witness)."""
    from test_torch_pipeline import _f64_witness, _check_f64_witness

    _check_f64_witness(*_f64_witness(MOE, '', tmp_path / 'jax'))


def test_seq_axis_on_a_model_without_ring_attention_replicates(tmp_path):
    """made (no ring attention) at --mesh=seq:2 in two gloo ranks runs as
    the JAX package runs it, replicated over seq: both ranks train on the
    whole batch, no gradient is averaged over the axis, and two steps give
    the no-mesh run's metrics and parameters."""
    from test_torch_mesh import MADE, _prepare

    flags = MADE + ['--bs=8']
    xs = [_bin_batch(8, s) for s in (3, 4)]
    one = _model(flags)
    init = {k: v.clone() for k, v in one.net.state_dict().items()}
    metrics = [{k: float(v) for k, v in one.train_step(torch.from_numpy(x)).items()} for x in xs]
    _prepare(tmp_path, 'made_seq2', flags, init, dict(x0=xs[0], x1=xs[1]))
    res = _spawn(2, [dict(kind='steps', name='made_seq2', flags=flags + ['--mesh=seq:2'],
                          steps=2)], tmp_path)['made_seq2']
    for i, m in enumerate(metrics):
        for k, v in m.items():
            assert float(res[f'm{i}/{k}']) == v, (i, k)
    for k, v in one.net.state_dict().items():
        np.testing.assert_array_equal(res[f'p/{k}'], v.numpy(), err_msg=k)
