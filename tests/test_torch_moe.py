"""The port's MoE (generative_models_tpu_torch/models/moe.py,
--moe_experts) against the JAX package's on the CPU: the layer fed the JAX
weights (forward, the load-balance aux, capacity drops, the decode step
equal to the forward), then a pixel_transformer with --moe_experts=4 (the
loss, every gradient and one Adam step; sampling from the JAX draws), the
init's scale (flax's fan_in of a stacked leaf counts E), a JAX MoE model.pt
read in, the quantized decode's launch count derived from the table, and
an export artifact bitwise as the live server."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generative_models_tpu.models.moe import MoEMLP as JaxMoE
from generative_models_tpu.parallel import get_mesh, make_mesh, set_mesh
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch import convert
from generative_models_tpu_torch.models.moe import MoEMLP
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

C, E = 16, 4
FLAGS = ['--model=pixel_transformer', '--n_layer=2', '--n_embed=32', '--n_head=2',
         '--moe_experts=4']


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _layer(cf=2.0, seed=0, zero_router=False):
    jm = JaxMoE(n_embed=C, n_experts=E, capacity_factor=cf)
    x = np.random.RandomState(seed).randn(2, 12, C).astype(np.float32)
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))['params'])
    if zero_router:  # uniform probs: argmax ties every token to expert 0
        params['router'] = {'kernel': np.zeros((C, E), np.float32)}
    pm = MoEMLP(C, E, cf)
    sd = {'router.weight': torch.from_numpy(params['router']['kernel'].T.copy())}
    sd.update({k: torch.from_numpy(np.array(params[k])) for k in ('wi', 'bi', 'wo', 'bo')})
    pm.load_state_dict(sd)
    return jm, params, pm, x


def _jax_forward(jm, params, x):
    y, inter = jm.apply({'params': params}, jnp.asarray(x), mutable=['intermediates'])
    return np.asarray(y), float(jax.tree_util.tree_leaves(inter['intermediates'])[0])


def test_layer_forward_and_aux_match_jax():
    jm, params, pm, x = _layer()
    ref, ref_aux = _jax_forward(jm, params, x)
    with torch.no_grad():
        y, aux = pm(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert float(aux) == pytest.approx(ref_aux, rel=1e-5)


def test_capacity_drops_overflow_tokens_as_jax():
    """Every token on expert 0 and cap = 12 / 4 = 3: only each row's first
    three tokens give output, the rest exactly 0, as the JAX layer."""
    jm, params, pm, x = _layer(cf=1.0, seed=1, zero_router=True)
    ref, _ = _jax_forward(jm, params, x)
    with torch.no_grad():
        y, _ = pm(torch.from_numpy(x))
    assert np.abs(y[:, :3].numpy()).sum() > 0
    np.testing.assert_array_equal(y[:, 3:].numpy(), 0.0)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_decode_step_equals_the_forward_and_jax_step():
    jm, params, pm, x = _layer(seed=2)
    with torch.no_grad():
        fwd, _ = pm(torch.from_numpy(x))
        step = pm.step(torch.from_numpy(x.reshape(-1, C))).reshape(fwd.shape)
    ref = np.asarray(jm.apply({'params': params}, jnp.asarray(x.reshape(-1, C)),
                              method=JaxMoE.step)).reshape(fwd.shape)
    np.testing.assert_allclose(step.numpy(), fwd.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(step.numpy(), ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------- #
# pixel_transformer --moe_experts
# ---------------------------------------------------------------------- #
@pytest.fixture(scope='module')
def jax_model(tmp_path_factory):
    old = get_mesh()
    set_mesh(make_mesh('', jax.devices()[:1]))
    try:
        G, Model = jax_parse_args(FLAGS + [f'--logdir={tmp_path_factory.mktemp("jax")}'],
                                  discover_models=jax_models)
        yield Model(G)
    finally:
        set_mesh(old)


def _port(*flags, params=None):
    G, Model = parse_args(FLAGS + ['--device=cpu', *flags])
    model = Model(G)
    if params is not None:
        model.net.load_state_dict(convert.params_from_jax(_np(params)))
    return model


def _batch(B=3, seed=0):
    return (np.random.RandomState(seed).rand(B, 28, 28, 1) > 0.6).astype(np.float32)


def test_loss_grads_and_one_adam_step_match_jax(jax_model):
    params = jax_model.state.params
    x = _batch()
    loss_fn = lambda p, x: jax_model.loss(p, x, None, None, True)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params,
                                                                             jnp.asarray(x))
    model = _port(params=params)
    assert all(hasattr(b, 'moe') and not hasattr(b, 'fc1') for b in model.net.blocks)
    metrics = model.backward(x)
    assert set(metrics) == {'nlogp', 'moe_aux'}
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(aux[k]), rel=1e-5), k
    ref = convert.params_from_jax(_np(grads))
    got = {k: p.grad for k, p in model.net.named_parameters()}
    assert set(got) == set(ref) and 'blocks.1.moe.wi' in got
    # held a tensor at a time: position 0's zero input meets LayerNorm at
    # var 0, so some gradients reach 1e9 beside others near 0 (so in both
    # packages)
    for name, g in got.items():
        err = float(torch.linalg.vector_norm(g.double() - ref[name].double()))
        assert err <= 1e-4 * float(torch.linalg.vector_norm(ref[name].double())) + 1e-6, name
    # the port's Adam fed the JAX gradients against optax's step
    opt = jax_model.make_optimizer()
    updates, _ = opt.update(grads, opt.init(params), params)
    want = convert.params_from_jax(_np(optax.apply_updates(params, updates)))
    for name, p in model.net.named_parameters():
        p.grad = ref[name].clone()
    model.apply_grads()
    for name, p in model.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_sampling_from_the_jax_draws_matches_jax(jax_model):
    """The JAX sampler at a key, and the port's from that key's uniforms
    (step t's from the t-th split key): the same tokens. Both take the
    per-op decode under MoE."""
    model = _port(params=jax_model.state.params)
    assert model.net.module_step and not model.net.use_fused_decode
    n, rng = 2, jax.random.key(7)
    ref = np.asarray(jax.jit(jax_model.sample_fn, static_argnums=(1, 3))(
        jax_model.state, n, rng, False))
    keys = jax.random.split(rng, 784)
    u = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (n, 1)))(keys)))
    got = model.sample_fn(n, uniforms=u, with_frames=False).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert 0 < got.mean() < 1


def test_init_draws_stacked_experts_with_fan_in_e_times_c():
    """flax's lecun_normal on a stacked (E, in, out) leaf counts E into
    fan_in: std 1/sqrt(E * in), as the JAX init draws it."""
    model = _port('--n_embed=128', '--n_head=4', '--moe_experts=8')
    moe = model.net.blocks[0].moe
    jm = JaxMoE(n_embed=128, n_experts=8)
    jp = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 128)))['params'])
    for name, fan_in in (('wi', 8 * 128), ('wo', 8 * 512)):
        got, ref = getattr(moe, name).detach().numpy(), jp[name]
        assert got.shape == ref.shape
        assert np.std(got) == pytest.approx(1 / np.sqrt(fan_in), rel=0.03), name
        assert np.std(ref) == pytest.approx(1 / np.sqrt(fan_in), rel=0.03), name
    assert not moe.bi.detach().any() and not moe.bo.detach().any()


def test_a_jax_moe_checkpoint_reads_in(jax_model, tmp_path):
    """A JAX MoE model.pt: the router transposed, the stacked experts as
    they are, and Adam's moments by the same map."""
    x = _batch(B=2, seed=3)
    jax_model.train_step(jnp.asarray(x), None)
    jax_model.save(tmp_path)
    state = jax_model.state
    model = _port()
    model.load_weights(tmp_path / 'model.pt')
    want = convert.params_from_jax(_np(state.params))
    for k, v in model.net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    mu = convert.params_from_jax(_np(state.opt_state[0].mu))
    names = model._opt_names(model.opt)
    st = model.opt.state_dict()['state']
    for i, n in enumerate(names):
        np.testing.assert_array_equal(st[i]['exp_avg'].numpy(), mu[n].numpy(), err_msg=n)
    assert model.step == 1


def test_quantized_decode_runs_the_table_s_linears_each_step(monkeypatch):
    """At the default width the JAX quant table's thresholds take q, k, v
    and proj (128 x 128) of each layer and leave out the router (128 x 8)
    and the stacked experts: 4 x 2 Linears, each launched once a decode
    step, 784 x 8 = 6272 int8_matmul calls a request."""
    from generative_models_tpu_torch.ops import int8
    from generative_models_tpu_torch.ops.int8 import build_quant_table

    model = _port('--n_embed=128', '--n_head=4', '--moe_experts=8')
    table, n = build_quant_table(model, 'w8a16')
    assert n == 8 and sorted(table.dense) == sorted(
        f'blocks.{i}.attn.{m}' for i in range(2) for m in ('query', 'key', 'value', 'proj'))
    calls = []
    real = int8.int8_matmul
    monkeypatch.setattr(int8, 'int8_matmul', lambda *a, **k: calls.append(1) or real(*a, **k))
    u = torch.rand(784, 1, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.sample_fn(1, uniforms=u, with_frames=False, quant=table)
    assert len(calls) == 784 * n == 6272


def test_an_export_artifact_serves_bitwise_as_the_live_server(tmp_path):
    from generative_models_tpu_torch import serve as tserve

    srv, _ = tserve.load_server(['--model=pixel_transformer', '--device=cpu', '--serve_bs=2',
                                 '--n_layer=1', '--n_head=2', '--n_embed=16',
                                 '--moe_experts=2'])
    path = tmp_path / 'moe.pt2'
    assert srv.export_serving(path) == path.stat().st_size > 0
    ex = tserve.ExportedServer(path, 'cpu')
    for seed in (3, 4):
        np.testing.assert_array_equal(ex.sample(2, seed=seed), srv.sample(2, seed=seed))
