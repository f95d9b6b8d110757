"""The port's serving slice (generative_models_tpu_torch/serve.py) on the
CPU: a JAX PixelTransformer's weights and its serving fn's own uniforms,
carried into the port, give the bitwise-same padded-and-sliced batch as the
JAX SampleServer at the same seed; plus the serving mechanics (pad/slice,
range errors, seeded reproducibility, coalescing, PNG bytes, HTTP) and the
hps.yaml round trip between the two packages."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from generative_models_tpu import serve as jserve
from generative_models_tpu_torch import serve as tserve
from generative_models_tpu_torch.convert import params_from_jax
from generative_models_tpu_torch.models.pixel_transformer import PixelTransformer
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)

SMALL = dict(n_layer=1, n_head=2, n_embed=16)


def _port_model(**over):
    G = tserve.serve_defaults()
    G.update(PixelTransformer.DG)
    G.update(model='pixel_transformer', device='cpu', **SMALL)
    G.update(over)
    return PixelTransformer(G)


@pytest.fixture(scope='module')
def server():
    srv = tserve.SampleServer(_port_model(), serve_bs=4)
    srv.warm()
    return srv


def test_serving_slice_matches_jax_bitwise():
    from generative_models_tpu.models.pixel_transformer import (
        PixelTransformer as JaxPT,
    )
    from generative_models_tpu.parallel import make_mesh, set_mesh
    from generative_models_tpu.utils.config import global_defaults

    serve_bs, n, seed = 3, 2, 5
    G = global_defaults()
    G.model = 'pixel_transformer'
    G.update(JaxPT.DG)
    G.update(bs=8, **SMALL)
    try:
        set_mesh(make_mesh('', jax.devices()[:1]))
        jmodel = JaxPT(G)
        ref = jserve.SampleServer(jmodel, serve_bs=serve_bs).sample(n, seed=seed)
        params = jax.tree_util.tree_map(np.asarray, jmodel.state.params)
    finally:
        set_mesh(make_mesh('', jax.devices()))
    # the uniforms the JAX serving fn draws at this seed: one key per step
    raw = jax.random.key_data(jax.random.key(seed))
    keys = jax.random.split(jax.random.wrap_key_data(raw), 784)
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (serve_bs, 1)))(keys))

    model = _port_model()
    model.net.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        full = model.sample_fn(
            serve_bs, uniforms=torch.from_numpy(u), with_frames=False
        )
    got = full[:n].numpy()
    assert ref.shape == got.shape == (n, 28, 28, 1)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_pads_slices_and_refuses_out_of_range(server):
    out = server.sample(3)
    assert out.shape == (3, 28, 28, 1) and out.dtype == np.float32
    assert np.isin(out, (0.0, 1.0)).all()
    for bad in (0, 5):
        with pytest.raises(ValueError, match='out of range'):
            server.sample(bad)
    with pytest.raises(ValueError, match='unconditional'):
        server.sample(2, y=[1])


def test_seeded_requests_reproduce(server):
    a, b = server.sample(4, seed=9), server.sample(4, seed=9)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(server.sample(2, seed=9), a[:2])
    assert not np.array_equal(server.sample(4, seed=10), a)
    stats = server.stats()
    assert stats['requests'] >= 4 and stats['latency_p50_sec'] > 0


def test_coalescing_packs_concurrent_requests():
    srv = tserve.SampleServer(_port_model(), serve_bs=4)
    srv.enable_coalescing(2000.0)
    outs = [None] * 2

    def ask(i):
        outs[i] = srv.sample(2)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(o.shape == (2, 28, 28, 1) for o in outs)
    assert srv.coalesced_requests == 2 and srv.coalesced_batches == 1


def test_png_and_tile_grid_bytes_match_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(5, 4, 4, 1).astype(np.float32)
    grid = tserve.tile_grid(x)
    np.testing.assert_array_equal(grid, jserve.tile_grid(x))
    assert tserve.png_encode(grid) == jserve.png_encode(grid)
    rgb = rng.randint(0, 256, (3, 7, 3), np.uint8)
    assert tserve.png_encode(rgb) == jserve.png_encode(rgb)
    with pytest.raises(ValueError):
        tserve.png_encode(x[0])


def test_http_healthz_and_sample(server):
    httpd = tserve._http_serve(server, 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/healthz') as r:
            health = json.loads(r.read())
        assert health['model'] == 'pixel_transformer' and health['serve_bs'] == 4
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/sample?n=4&seed=3') as r:
            png = r.read()
        assert png[:8] == b'\x89PNG\r\n\x1a\n'
        expected = tserve.png_encode(tserve.tile_grid(server.sample(4, seed=3)))
        assert png == expected
        for path, code in (('/sample?n=99', 400), ('/sample?n=x', 400), ('/nope', 404)):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(f'http://127.0.0.1:{port}{path}')
            assert exc.value.code == code
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_global_defaults_have_the_jax_keys():
    from generative_models_tpu.utils.config import global_defaults as jax_defaults
    from generative_models_tpu_torch.utils.config import global_defaults

    assert list(global_defaults()) == list(jax_defaults())
    assert global_defaults().device == 'cuda'


def test_hps_yaml_round_trips_between_packages(tmp_path):
    from generative_models_tpu.utils import discover_models as jax_models
    from generative_models_tpu.utils.config import dump_hps as jax_dump_hps
    from generative_models_tpu.utils.config import parse_args as jax_parse_args

    # port -> JAX: the port's checkpoint dir is readable by the JAX CLI
    model = _port_model(n_embed=24)
    model.save(tmp_path / 'port')
    G, Model = jax_parse_args(
        [f'--weights_from={tmp_path / "port" / "model.pt"}'],
        discover_models=jax_models,
    )
    assert Model.__name__ == 'PixelTransformer'
    assert (G.n_embed, G.n_layer, G.n_head) == (24, 1, 2)
    # and the port reloads its own weights from it
    G2, PT = parse_args([f'--weights_from={tmp_path / "port" / "model.pt"}'])
    assert G2.device == 'cpu' and G2.n_embed == 24
    again = PT(G2)
    again.load_weights(tmp_path / 'port' / 'model.pt')
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, again.net.state_dict()[k]), k

    # JAX -> port: a JAX run's hps.yaml parses in the port
    G.n_embed = 40
    jax_dump_hps(G, tmp_path / 'jax')
    G3, PT3 = parse_args(
        [f'--weights_from={tmp_path / "jax" / "model.pt"}', '--device=cpu'],
        DG=tserve.serve_defaults(),
    )
    assert PT3 is PixelTransformer and G3.n_embed == 40 and G3.serve_bs == 64
    # a JAX run's model.pt (flax msgpack of its TrainState) is read
    jm = jax_models()['pixel_transformer'](G)
    jm.save(tmp_path / 'jax')
    served = PT3(G3)
    served.load_weights(tmp_path / 'jax' / 'model.pt')
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.state.params))
    for k, v in served.net.state_dict().items():
        assert torch.equal(v, want[k]), k
    # and a msgpack tree that is not a TrainState is refused, saying so
    (tmp_path / 'jax' / 'model.pt').write_bytes(b'\x81\xa6params\x80')
    with pytest.raises(ValueError, match='not a JAX TrainState'):
        PT3(G3).load_weights(tmp_path / 'jax' / 'model.pt')


def test_sample_returns_the_sampling_process_frames():
    model = _port_model()
    samples, frames = model.sample(2)
    T = model.block_size
    assert samples.shape == (2, 28, 28, 1) and frames.shape == (T, 2, 28, 28, 1)
    assert torch.equal(frames[-1], samples) and not frames[0].reshape(2, -1)[:, 1:].any()
    assert model.sample_images(2).shape == (2, 28, 28, 1)
    with pytest.raises(TypeError):
        model.sample_images(2, y=[1])
