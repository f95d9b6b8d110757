"""The port's TransformerNet (generative_models_tpu_torch/models/
pixel_transformer.py) against the JAX package's, on the CPU: weights from a
JAX init carried over by convert.params_from_jax, then the full forward and
the teacher-forced decode chain compared step by step with the JAX fused
decode (interpret-mode Pallas), and the port's sampling checked to be
bitwise independent of the segment count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.models.pixel_transformer import TransformerNet as JaxNet
from generative_models_tpu_torch.convert import params_from_jax
from generative_models_tpu_torch.models.pixel_transformer import (
    TransformerNet, teacher_forced_logits, transformer_sample_scan,
)
from generative_models_tpu_torch.utils.dists import Bernoulli

torch.set_num_threads(1)

T, C, H, L, B = 16, 32, 4, 2, 3
KW = dict(in_size=1, block_size=T, n_embed=C, n_head=H, n_layer=L, head='bin')


@pytest.fixture(scope='module')
def nets():
    jnet = JaxNet(**KW, use_pallas=False, use_fused_decode=True)
    x0 = jnp.zeros((1, T, 1), jnp.float32)
    params = jnet.init(jax.random.key(0), x0)['params']
    net = TransformerNet(**KW)
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, net.eval()


def _tokens(seed):
    return (np.random.RandomState(seed).rand(B, T, 1) > 0.5).astype(np.float32)


def test_full_forward_logits_match_jax(nets):
    jnet, params, net = nets
    x = _tokens(0)
    ref = np.asarray(jnet.apply({'params': params}, jnp.asarray(x)).logits)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_teacher_forced_decode_matches_jax_fused_stepwise(nets):
    jnet, params, net = nets
    x = _tokens(1)
    got = teacher_forced_logits(net, torch.from_numpy(x)).numpy()  # (B, T, 1)
    cache = jnet.apply({'params': params}, B, method=JaxNet.init_cache)
    prev = jnp.zeros((B, 1))
    for t in range(T):
        ref, cache = jnet.apply(
            {'params': params}, prev, cache, t, method=JaxNet.decode_step
        )
        np.testing.assert_allclose(
            got[:, t], np.asarray(ref), rtol=1e-4, atol=1e-5, err_msg=f'step {t}'
        )
        prev = jnp.asarray(x[:, t])


def test_decode_chains_agree_with_full_forward(nets):
    """Fused (kernel wrappers) and per-op decode chains and the full forward
    compute the same logits."""
    _, _, net = nets
    x = torch.from_numpy(_tokens(2))
    with torch.no_grad():
        full = net(x).logits
    fused = teacher_forced_logits(net, x)
    net.use_fused_decode = False
    try:
        per_op = teacher_forced_logits(net, x)
    finally:
        net.use_fused_decode = True
    np.testing.assert_allclose(fused.numpy(), full.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(per_op.numpy(), fused.numpy())


def test_segmented_sampling_is_bitwise_identical(nets):
    """segments > 1 attends over a truncated cache; the rows it drops carry
    exactly zero weight, so the tokens must not change at all."""
    _, _, net = nets
    u = torch.from_numpy(np.random.RandomState(3).rand(T, B, 1).astype(np.float32))
    tok = lambda logits, ut: Bernoulli(logits=logits).sample(uniforms=ut)
    base = transformer_sample_scan(net, B, tok, u, segments=1)
    for segments in (2, 4, 8):
        seg = transformer_sample_scan(net, B, tok, u, segments=segments)
        np.testing.assert_array_equal(seg.numpy(), base.numpy())
    # teacher forcing the drawn tokens redraws them from the same uniforms
    x = base.permute(1, 0, 2).contiguous()
    lk = teacher_forced_logits(net, x, segments=4)
    redrawn = Bernoulli(logits=lk).sample(uniforms=u.permute(1, 0, 2))
    np.testing.assert_array_equal(redrawn.numpy(), x.numpy())


def test_seeded_init_uses_flax_families():
    from generative_models_tpu_torch.models.base import flax_init_

    def make(seed):
        net = TransformerNet(**dict(KW, n_embed=64))
        flax_init_(net, torch.Generator().manual_seed(seed))
        return net

    net, other = make(0), make(0)
    for (name, p), q in zip(net.state_dict().items(), other.state_dict().values()):
        assert torch.equal(p, q), name  # same seed, same weights
    assert not torch.equal(make(1).blocks[0].fc1.weight, net.blocks[0].fc1.weight)
    w = net.blocks[0].fc1.weight.detach()  # (256, 64): lecun normal, fan_in 64
    assert abs(float(w.std()) - 64 ** -0.5) < 0.01
    assert float(w.abs().max()) <= 2 * 64 ** -0.5 / 0.87962566103423978 + 1e-6
    assert not net.blocks[0].fc1.bias.any()
    assert torch.equal(net.ln_f.weight, torch.ones(64)) and not net.ln_f.bias.any()
    assert not net.pos_emb.any()
