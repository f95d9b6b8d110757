"""The port's distributions and heads (generative_models_tpu_torch/utils/
dists.py, models/heads.py) against the JAX package's on the CPU, from the same
numpy-seeded inputs and, for sampling, the same uniforms."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from generative_models_tpu.models import heads as jheads
from generative_models_tpu.utils import dists as jd
from generative_models_tpu_torch.convert import _linear
from generative_models_tpu_torch.models import heads as theads
from generative_models_tpu_torch.utils import dists as td

torch.set_num_threads(1)


def _close(got, ref, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **kw)


def test_log_probs_and_kl_match_jax():
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(5, 7)).astype(np.float32)
    x = (rng.rand(5, 7) > 0.5).astype(np.float32)
    _close(td.Bernoulli(logits=torch.from_numpy(logits)).log_prob(torch.from_numpy(x)),
           jd.Bernoulli(logits=logits).log_prob(x), rtol=1e-5, atol=1e-6)
    probs = rng.rand(5, 7).astype(np.float32)
    _close(td.Bernoulli(probs=torch.from_numpy(probs)).logits,
           jd.Bernoulli(probs=probs).logits, rtol=1e-5, atol=1e-5)
    loc, scale = rng.randn(5, 7).astype(np.float32), (0.5 + rng.rand(5, 7)).astype(np.float32)
    y = rng.randn(5, 7).astype(np.float32)
    t = torch.from_numpy
    _close(td.Normal(t(loc), t(scale)).log_prob(t(y)),
           jd.Normal(loc, scale).log_prob(y), rtol=1e-5, atol=1e-6)
    _close(td.normal_kl(t(loc), t(scale)), jd.normal_kl(loc, scale), rtol=1e-5, atol=1e-6)
    onehot = np.eye(7, dtype=np.float32)[rng.randint(0, 7, 5)]
    _close(td.Categorical(t(logits)).log_prob(t(onehot)),
           jd.Categorical(logits).log_prob(onehot), rtol=1e-5, atol=1e-6)


def test_sampling_from_given_draws():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(4, 3).astype(np.float32))
    u = torch.from_numpy(rng.rand(4, 3).astype(np.float32))
    # JAX: uniform < sigmoid(logits); same uniforms, same tokens
    ref = np.asarray(u.numpy() < np.asarray(jax.nn.sigmoid(jnp.asarray(logits.numpy()))),
                     np.float32)
    np.testing.assert_array_equal(td.Bernoulli(logits=logits).sample(uniforms=u).numpy(), ref)
    noise = torch.from_numpy(rng.randn(4, 3).astype(np.float32))
    np.testing.assert_array_equal(
        td.Normal(logits, 2.0).sample(noise=noise).numpy(), (logits + 2.0 * noise).numpy()
    )
    idx = td.Categorical(logits).sample_index(uniforms=u)
    gumbel = -np.log(-np.log(u.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.argmax(logits.numpy() + gumbel, -1))
    g = torch.Generator().manual_seed(0)
    onehot = td.Categorical(logits).sample(generator=g)
    assert onehot.shape == (4, 3) and torch.equal(onehot.sum(-1), torch.ones(4))


def test_heads_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 8).astype(np.float32)
    for jcls, tcls in ((jheads.BinaryHead, theads.BinaryHead),
                       (jheads.CategoricalHead, theads.CategoricalHead)):
        jhead = jcls(5)
        params = jhead.init(jax.random.key(0), jnp.asarray(x))['params']
        head = tcls(8, 5)
        head.load_state_dict(
            _linear(jax.tree_util.tree_map(np.asarray, params['Dense_0']), 'dense')
        )
        with torch.no_grad():
            got = head(torch.from_numpy(x)).logits
        _close(got, jhead.apply({'params': params}, jnp.asarray(x)).logits,
               rtol=1e-5, atol=1e-6)
