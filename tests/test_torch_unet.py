"""The port's diffusion UNet (generative_models_tpu_torch/models/diffusion/
unet.py) against the JAX package's SimpleUnet on the CPU, at
hidden_size=32: JAX weights carried over by convert.diffusion_params_from_jax,
then the forward with guide -1 rows, with and without the distilled
student's cond_w embedding, with mean_type=both's two output channels,
under --remat, and under bf16; the timestep embedding, GroupNorm alone, the
initialisation (ResBlock Conv_1 at zero, GroupNorm at 1 and 0) and
num_vars against the JAX package's, with and without a teacher.

Tolerances: f32 atol 1e-4 and rtol 1e-4 (measured ~1.3e-6 at |out| ~ 2.6:
the same math, summed in another order). bf16: the relative Frobenius error
against the JAX package's bf16 forward, < 2e-2 (both round every Conv and
Linear input to bf16, 2^-8 relative, about 30 times in sequence, at
different points; the two bf16 forwards also sit near the f32 one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from generative_models_tpu.models.base import intercept_ctx
from generative_models_tpu.models.diffusion import unet as junet
from generative_models_tpu.ops import int8 as jint8
from generative_models_tpu.utils import count_vars as jax_count_vars
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.convert import diffusion_params_from_jax
from generative_models_tpu_torch.models.diffusion import unet as tunet
from generative_models_tpu_torch.ops.int8 import QuantTable, quantize_dense_modules
from generative_models_tpu_torch.utils import count_vars
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

C = 32
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 2e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _inputs(B=4, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(B, 28, 28, 1).astype(np.float32)
    ls = rng.uniform(-15, 15, B).astype(np.float32)
    guide = np.array([0, 3, -1, 9, -1, 7][:B], np.int32)
    cw = rng.uniform(0, 4, B).astype(np.float32)
    return z, ls, guide, cw


def _jax_init(cond_w=False, out_channels=1, seed=0):
    net = junet.SimpleUnet(channels=C, out_channels=out_channels)
    return jax.jit(lambda r: net.init(
        r, jnp.zeros((1, 28, 28, 1)), jnp.zeros((1,)), guide=jnp.zeros((1,), jnp.int32),
        cond_w=jnp.zeros((1,)) if cond_w else None, train=False)['params'])(jax.random.key(seed))


def _port(params, cond_w=False, out_channels=1, dtype=torch.float32, remat=False):
    net = tunet.SimpleUnet(C, out_channels=out_channels, dtype=dtype, remat=remat, cond_w=cond_w)
    net.load_state_dict(diffusion_params_from_jax(_np(params)))
    return net.eval()


def _jax_apply(params, z, ls, guide, cw, out_channels=1, dtype=jnp.float32):
    net = junet.SimpleUnet(channels=C, out_channels=out_channels, dtype=dtype)
    fn = jax.jit(lambda p, z, ls, g, cw: net.apply({'params': p}, z, ls, guide=g, cond_w=cw,
                                                   train=False))
    return np.asarray(fn(params, jnp.asarray(z), jnp.asarray(ls), jnp.asarray(guide),
                         None if cw is None else jnp.asarray(cw)))


def _run(net, z, ls, guide, cw):
    with torch.no_grad():
        return net(torch.from_numpy(z), torch.from_numpy(ls), guide=torch.from_numpy(guide),
                   cond_w=None if cw is None else torch.from_numpy(cw)).numpy()


@pytest.fixture(scope='module')
def params():
    return _jax_init()


def test_converter_covers_every_parameter(params):
    for cond_w, oc in ((False, 1), (True, 2)):
        p = _np(_jax_init(cond_w, oc))
        net = tunet.SimpleUnet(C, out_channels=oc, cond_w=cond_w)
        sd, ref = diffusion_params_from_jax(p), net.state_dict()
        assert set(sd) == set(ref)
        for k, v in sd.items():
            assert tuple(v.shape) == tuple(ref[k].shape), k


@pytest.mark.parametrize('case', ['guide', 'cond_w', 'both', 'no_guide'])
def test_forward_matches_flax(case):
    """guide with -1 rows (their class embedding zeroed, the MLP's bias
    included); a student's cond_w embedding; mean_type=both's two
    channels; no guide at all."""
    cond_w, oc = case == 'cond_w', 2 if case == 'both' else 1
    p = _jax_init(cond_w, oc, seed=1)
    z, ls, guide, cw = _inputs(seed=2)
    cw = cw if cond_w else None
    if case == 'no_guide':
        ref = np.asarray(junet.SimpleUnet(channels=C).apply(
            {'params': p}, jnp.asarray(z), jnp.asarray(ls), train=False))
        with torch.no_grad():
            got = _port(p)(torch.from_numpy(z), torch.from_numpy(ls)).numpy()
    else:
        ref = _jax_apply(p, z, ls, guide, cw, oc)
        got = _run(_port(p, cond_w, oc), z, ls, guide, cw)
    assert got.shape == ref.shape == (4, 28, 28, oc)
    np.testing.assert_allclose(got, ref, **TOL)


def test_unconditional_rows_ignore_the_class_embedding(params):
    """A -1 row's output is its output with no guide at all: the class
    MLP's bias does not leak into it."""
    z, ls, guide, _ = _inputs(seed=3)
    net = _port(params)
    with torch.no_grad():
        a = net(torch.from_numpy(z), torch.from_numpy(ls), guide=torch.full((4,), -1))
        b = net(torch.from_numpy(z), torch.from_numpy(ls))
    assert torch.equal(a, b)


def test_bf16_forward_within_its_bound(params):
    z, ls, guide, _ = _inputs(seed=4)
    ref = _jax_apply(params, z, ls, guide, None, dtype=jnp.bfloat16)
    ref32 = _jax_apply(params, z, ls, guide, None)
    got = _run(_port(params, dtype=torch.bfloat16), z, ls, guide, None)
    assert got.dtype == np.float32
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got, ref) < BF16_REL, rel(got, ref)
    assert rel(got, ref32) < BF16_REL and rel(ref, ref32) < BF16_REL


def test_remat_gives_the_same_gradients(params):
    """--remat (torch.utils.checkpoint a ResBlock) recomputes, it does not
    change the numbers."""
    z, ls, guide, _ = _inputs(seed=5)
    grads = []
    for remat in (False, True):
        net = _port(params, remat=remat).train()
        out = net(torch.from_numpy(z), torch.from_numpy(ls), guide=torch.from_numpy(guide))
        (out ** 2).mean().backward()
        grads.append({k: p.grad.clone() for k, p in net.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_timestep_embedding_matches_jax():
    t = np.random.RandomState(6).uniform(-20, 20, 5).astype(np.float32)
    for dim, period in ((64, 256), (64, 4), (7, 256)):
        ref = junet.timestep_embedding(jnp.asarray(t), dim, period)
        got = tunet.timestep_embedding(torch.from_numpy(t), dim, period)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('channels', [16, 64])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_group_norm_matches_flax(channels, dtype):
    """min(32, C) groups, eps 1e-6, the fast variance in f32, the output in
    the input's dtype, with a scale and bias away from 1 and 0."""
    rng = np.random.RandomState(7)
    x = (3.0 + rng.randn(2, 5, 5, channels)).astype(np.float32)
    scale, bias = rng.randn(channels).astype(np.float32), rng.randn(channels).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref = fnn.GroupNorm(num_groups=min(32, channels), dtype=jdt).apply(
        {'params': {'scale': scale, 'bias': bias}}, jnp.asarray(x, jdt))
    gn = tunet.GroupNorm(channels)
    gn.weight.data, gn.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    with torch.no_grad():
        got = gn(xt).permute(0, 2, 3, 1)
    assert got.dtype == xt.dtype
    tol = 1e-5 if dtype == 'float32' else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize('teacher', [False, True], ids=['plain', 'with_teacher'])
def test_init_and_num_vars_match_jax(tmp_path, teacher):
    """The port's init from its seed: every ResBlock's Conv_1 (conv1)
    exactly zero, GroupNorm scale 1 and bias 0, biases 0; num_vars equal
    to the JAX package's, with the teacher's cond_w_embed counted only for
    a student."""
    flags = ['--model=diffusion_model', f'--hidden_size={C}', '--timesteps=4', '--eval_heavy=0']
    jflags = flags + [f'--logdir={tmp_path}']
    if teacher:  # a student needs a teacher checkpoint: the port's own, and the JAX one's
        G, Model = parse_args(flags + ['--device=cpu', f'--logdir={tmp_path / "t"}'])
        Model(G).save(tmp_path / 't')
        flags = flags + [f'--teacher_path={tmp_path / "t" / "model.pt"}']
    G, Model = parse_args(flags + ['--device=cpu'])
    model = Model(G)
    net = model.net
    assert (net.cond_w_embed is not None) == teacher
    for i, block in enumerate(net.blocks):
        assert not block.conv1.weight.any() and not block.conv1.bias.any(), i
        for norm in (block.norm0, block.norm1):
            assert torch.equal(norm.weight, torch.ones_like(norm.weight))
            assert not norm.bias.any()
        assert block.conv0.weight.std() > 0 and not block.conv0.bias.any()
    jp = _jax_init(cond_w=teacher)
    assert count_vars(model.params) == jax_count_vars(jp)
    if not teacher:
        jG, jModel = jax_parse_args(jflags, discover_models=jax_models)
        assert count_vars(model.params) == jax_count_vars(jModel(jG).state.params)


@pytest.mark.parametrize('mode', ['w8a8', 'w8a16'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_quantized_forward_matches_the_jax_interceptor(mode, dtype):
    """serve.py --quantize's UNet forward against the JAX package's under
    its interceptor (ops/int8.py make_dense_interceptor, the plain XLA
    product), at hidden_size=64: at 32, GroupNorm's one-channel groups
    take out every embedding, and nothing quantized could show. Every
    parameter is drawn afresh, N(0, 0.2): at the init each ResBlock's zero
    conv1 hides the embeddings too. Both sides quantize with the
    thresholds lowered to both dims >= 16 and >= 256 elements, so that the
    same 17 Dense layers quantize as the default thresholds pick at 128
    (time_embed's and cond_w_embed's two, guide_embed's second, the twelve
    emb projections). Relative Frobenius error: f32 < 1e-3, bf16 < 2e-2
    (as the plain bf16 forward); the quantized forward moves off the plain
    one by more than a fifth of that. Under bf16 each ResBlock still
    returns bf16, as flax's GroupNorm and Conv with dtype=bf16 do: the
    quantized products' f32 output goes back to bf16 at the next
    GroupNorm."""
    width = 64
    init = junet.SimpleUnet(channels=width)
    p = jax.jit(lambda r: init.init(
        r, jnp.zeros((1, 28, 28, 1)), jnp.zeros((1,)), guide=jnp.zeros((1,), jnp.int32),
        cond_w=jnp.zeros((1,)), train=False)['params'])(jax.random.key(5))
    rng = np.random.RandomState(7)
    p = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.2 * rng.randn(*a.shape).astype(np.float32)), p)
    z, ls, guide, cw = _inputs(B=2, seed=6)
    table = jint8.quantize_dense_tree(p, min_dim=16, min_size=256)
    jdt, tdt, tol = ((jnp.float32, torch.float32, 1e-3) if dtype == 'f32'
                     else (jnp.bfloat16, torch.bfloat16, BF16_REL))
    net = junet.SimpleUnet(channels=width, dtype=jdt)
    fn = jax.jit(lambda p, z, ls, g, cw: net.apply({'params': p}, z, ls, guide=g, cond_w=cw,
                                                   train=False))
    with intercept_ctx(jint8.make_dense_interceptor(table, mode, use_pallas=False)):
        ref = np.asarray(fn(p, *map(jnp.asarray, (z, ls, guide, cw))))
    port = tunet.SimpleUnet(width, dtype=tdt, cond_w=True)
    port.load_state_dict(diffusion_params_from_jax(_np(p)))
    quant = QuantTable(mode, quantize_dense_modules(port, min_dim=16, min_size=256))
    assert len(quant) == len(table) == 17
    dtypes = set()
    for block in port.blocks:
        block.register_forward_hook(lambda m, a, out: dtypes.add(out.dtype))
    with torch.no_grad():
        args = (torch.from_numpy(z), torch.from_numpy(ls))
        kw = dict(guide=torch.from_numpy(guide), cond_w=torch.from_numpy(cw))
        got = port.eval()(*args, **kw, quant=quant).numpy()
        plain = port(*args, **kw).numpy()
    assert dtypes == {tdt}
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got, ref) < tol, rel(got, ref)
    assert rel(plain, ref) > tol / 5, (rel(plain, ref), rel(got, ref))
