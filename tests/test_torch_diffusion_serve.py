"""Class-conditional serving of the port's diffusion model
(generative_models_tpu_torch/serve.py, models/diffusion/model.py) on the
CPU: a served batch against the JAX package's pure_serving_fn from the same
weights and draws (the noise and guidance weights split from its key as it
splits them), then the label path of the JAX package's serve.py: one label
broadcast to n, -1 padding past n, the range and length checks, coalesced
requests packing their labels at their offsets, labels over HTTP
(/sample?n=2&y=3 and y=1,2), the stats line's class_cond, and an
unconditional server refusing labels.

The served batch's tolerance is atol 2e-2 in [0, 1] (f32 on both sides):
serving is always guided, and the chain's first step, at logSNR -20, takes
x_hat from the guided eps through sqrt(1 + e^20) ~ 2.2e4, so the UNet's
~1e-6 difference in eps (tests/test_torch_unet.py) moves x_hat by up to
~2e-2 before the clip (tests/test_torch_diffusion_math.py holds one
guided step at a moderate logSNR to 1e-5).
"""

import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.convert import diffusion_params_from_jax
from generative_models_tpu_torch.serve import SampleServer, _http_serve, load_server

torch.set_num_threads(1)

FLAGS = ['--model=diffusion_model', '--hidden_size=32', '--bf16=0', '--eval_heavy=0']
SERVED_ATOL = 2e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize('flags', [['--timesteps=4'], ['--timesteps=4', '--fused_cfg=1'],
                                   ['--timesteps=8', '--sampler=dpm2m', '--sample_steps=3']],
                         ids=['ddim', 'fused', 'dpm2m'])
def test_served_batch_matches_jax(tmp_path, flags):
    G, Model = jax_parse_args(FLAGS + flags + [f'--logdir={tmp_path}'], discover_models=jax_models)
    jm = Model(G)
    # weights moved off their init, where the zero-init output convs make
    # every ResBlock the identity
    rng = np.random.RandomState(0)
    jm.state = jm.state.replace(params=jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(np.float32)),
        jm.state.params))
    n, seed = 4, 3
    y = np.array([1, -1, 7, 7], np.int32)
    ref = np.asarray(jm.pure_serving_fn(n)(jax.random.key_data(jax.random.key(seed)),
                                           jnp.asarray(y)))
    rng_noise, rng_chain = jax.random.split(jax.random.key(seed))
    noise = np.asarray(jax.random.normal(rng_noise, (n, 28, 28, 1)))
    w = np.asarray(jax.random.uniform(jax.random.split(rng_chain)[0], (n,)))

    server, _ = load_server(FLAGS + flags + ['--device=cpu', f'--serve_bs={n}'])
    model = server.model
    model.net.load_state_dict(diffusion_params_from_jax(_np(jm.state.params)))
    with torch.no_grad():
        got = model.sample_fn(n, torch.from_numpy(y), noise=torch.from_numpy(noise.copy()),
                              w=torch.from_numpy(w.copy()))
    got = ((got + 1) / 2).numpy()
    assert got.shape == ref.shape == (n, 28, 28, 1)
    assert ref.min() >= 0 and ref.max() <= 1
    np.testing.assert_allclose(got, ref, rtol=0, atol=SERVED_ATOL)
    # the server's own pass: [0, 1], the same seed and labels the same batch
    a, b = server.sample(n, y=y, seed=seed), server.sample(n, y=y, seed=seed)
    assert a.shape == (n, 28, 28, 1) and a.dtype == np.float32 and np.isfinite(a).all()
    assert a.min() >= 0 and a.max() <= 1
    np.testing.assert_array_equal(a, b)


class _Recorder:
    """Wraps a server's serving fn: records each pass's (seed, labels)."""

    def __init__(self, server):
        self.calls, self._fn = [], server._call
        server._call = self

    def __call__(self, seed, y=None):
        self.calls.append((seed, None if y is None else np.array(y)))
        return self._fn(seed, y) if y is not None else self._fn(seed)


@pytest.fixture(scope='module')
def server():
    """A class-conditional server whose weights are moved off their init:
    the zero-init output convs would make every ResBlock ignore the labels."""
    srv, _ = load_server(FLAGS + ['--timesteps=2', '--device=cpu', '--serve_bs=4'])
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in srv.model.net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return srv


def test_labels_broadcast_pad_and_are_checked(server):
    rec = _Recorder(server)
    try:
        out = server.sample(3, y=[5], seed=1)
        assert out.shape == (3, 28, 28, 1) and 0 <= out.min() and out.max() <= 1
        server.sample(2, y=[1, -1], seed=1)
        server.sample(4, seed=1)
        assert [list(y) for _, y in rec.calls] == [[5, 5, 5, -1], [1, -1, -1, -1], [-1] * 4]
        for bad, match in (([1, 2], 'len'), ([10], r'\[-1, 10\)'), ([-2], r'\[-1, 10\)')):
            with pytest.raises(ValueError, match=match):
                server.sample(3, y=bad)
        with pytest.raises(ValueError, match='out of range'):
            server.sample(5, y=[1])
        assert len(rec.calls) == 3  # refused requests run no pass
    finally:
        server._call = rec._fn
    assert server.stats()['class_cond'] is True
    assert not np.array_equal(server.sample(4, y=[3], seed=2), server.sample(4, y=[4], seed=2))


def test_coalesced_requests_pack_their_labels_at_their_offsets():
    srv, _ = load_server(FLAGS + ['--timesteps=2', '--device=cpu', '--serve_bs=4'])
    rec = _Recorder(srv)
    srv.enable_coalescing(2000)
    outs = {}

    def ask(key, n, y):
        outs[key] = srv.sample(n, y=y)

    threads = [threading.Thread(target=ask, args=('a', 1, [3])),
               threading.Thread(target=ask, args=('b', 2, [4, 6])),
               threading.Thread(target=ask, args=('c', 1, None))]
    for th in threads:
        th.start()
        time.sleep(0.2)  # arrival order a, b, c, within the window
    for th in threads:
        th.join(timeout=120)
    assert len(rec.calls) == 1 and srv.coalesced_batches == 1
    assert list(rec.calls[0][1]) == [3, 4, 6, -1]
    assert [outs[k].shape[0] for k in 'abc'] == [1, 2, 1]
    with pytest.raises(ValueError, match=r'\[-1, 10\)'):
        srv.sample(1, y=[11])  # checked before queueing


def test_labels_over_http(server):
    httpd = _http_serve(server, 0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()

    def get(query):
        try:
            with urllib.request.urlopen(f'http://127.0.0.1:{port}/sample?{query}',
                                        timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    try:
        rec = _Recorder(server)
        try:
            ok = [get('n=2&y=3&seed=4'), get('n=3&y=1,2,-1')]
            bad = [get('n=2&y=1,2,3'), get('n=2&y=10'), get('n=2&y=a')]
        finally:
            server._call = rec._fn
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    for status, body in ok:
        assert status == 200 and body[:8] == b'\x89PNG\r\n\x1a\n'
    assert [list(y) for _, y in rec.calls] == [[3, 3, -1, -1], [1, 2, -1, -1]]
    assert [s for s, _ in bad] == [400, 400, 400]


def test_an_unconditional_server_refuses_labels():
    srv, _ = load_server(FLAGS + ['--timesteps=2', '--device=cpu', '--serve_bs=2',
                                  '--class_cond=0'])
    assert srv.stats()['class_cond'] is False
    out = srv.sample(2, seed=1)
    assert out.shape == (2, 28, 28, 1)
    with pytest.raises(ValueError, match='unconditional'):
        srv.sample(2, y=[1])
    with pytest.raises(TypeError):
        srv.model.pure_serving_fn(2)(1, np.zeros(2, np.int32))  # (seed) alone
    assert isinstance(srv, SampleServer)
