"""The port's VQ-VAE (generative_models_tpu_torch/models/vqvae.py) against
the JAX package's on the CPU, at a small width (hidden_size=16, vqD=8,
vqK=16, prior n_layer=1, n_embed=32, n_head=2): weights from a JAX init
carried over by convert.vqvae_params_from_jax, then the encoder, decoder
and AE outputs, the loss metrics, one joint train step (plain, with
--grad_accum=2, with --grad_clip=0.1) parameter by parameter, and serving
from the same Gumbel uniforms; plus the training CLI, the flax
initializers, and a checkpoint that carries both optimizers. About 90 s
here."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import generative_models_tpu_torch.data.mnist as tm
from generative_models_tpu.models import vqvae as jvq
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils import dists as jax_dists
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.convert import vqvae_params_from_jax
from generative_models_tpu_torch.main import epoch_generator, load_model_and_data, main
from generative_models_tpu_torch.models.pixel_transformer import transformer_sample_scan
from generative_models_tpu_torch.serve import SampleServer
from generative_models_tpu_torch.utils.config import parse_args
from generative_models_tpu_torch.utils.dists import Categorical

torch.set_num_threads(1)

FLAGS = ['--model=vqvae', '--hidden_size=16', '--vqD=8', '--vqK=16', '--n_layer=1',
         '--n_embed=32', '--n_head=2']
T, K = 49, 16


def _jax_model(tmp_path_factory, *flags):
    G, Model = jax_parse_args(
        FLAGS + list(flags) + [f'--logdir={tmp_path_factory.mktemp("jax")}'],
        discover_models=jax_models,
    )
    return Model(G)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(params=None, *flags):
    G, Model = parse_args(FLAGS + ['--device=cpu', *flags])
    model = Model(G)
    if params is not None:
        model.net.load_state_dict(vqvae_params_from_jax(params))
    return model


@pytest.fixture(scope='module')
def jax_model(tmp_path_factory):
    return _jax_model(tmp_path_factory)


def _batch(B=3, seed=0):
    return (np.random.RandomState(seed).rand(B, 28, 28, 1) > 0.6).astype(np.float32)


def test_converter_covers_every_parameter(jax_model):
    model = _port()
    sd = vqvae_params_from_jax(_np(jax_model.state.params))
    ref = model.net.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k


def test_encoder_decoder_and_ae_match_flax(jax_model):
    p = _np(jax_model.state.params)
    model = _port(p)
    ae, jae = model.net.ae, jax_model.ae
    x = _batch(seed=1)
    rng = np.random.RandomState(2)
    z = rng.randn(3, 7, 7, 8).astype(np.float32)
    ref_enc = jvq.VQEncoder(16, 8).apply({'params': p['ae']['encoder']}, jnp.asarray(x))
    ref_dec = jvq.VQDecoder(16).apply({'params': p['ae']['decoder']}, jnp.asarray(z))
    ref_ae = jae.apply({'params': p['ae']}, jnp.asarray(x))
    one_hots = np.eye(K, dtype=np.float32)[rng.randint(0, K, (3, T))]
    ref_codes = jae.apply({'params': p['ae']}, jnp.asarray(one_hots),
                          method=jvq.VQAENet.decode_codes)
    with torch.no_grad():
        enc = ae.encoder(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        dec = ae.decoder(torch.from_numpy(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        out = ae(torch.from_numpy(x))
        codes = ae.decode_codes(torch.from_numpy(one_hots))
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec), rtol=1e-5, atol=1e-5)
    assert dec.shape == (3, 28, 28, 1)
    for name, g, r in zip(('embed_loss', 'decoded', 'perplexity', 'idxs'), out, ref_ae):
        assert tuple(g.shape) == tuple(r.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(codes.numpy(), np.asarray(ref_codes), rtol=1e-5, atol=1e-5)


def test_loss_metrics_match_jax(jax_model):
    p = _np(jax_model.state.params)
    x = _batch(seed=3)
    _, ref = jax_model.loss(jax_model.state.params, jnp.asarray(x), None, None, False)
    got = _port(p).eval_loss(x)
    assert set(got) == set(ref) == {'vq_vae_loss', 'recon_loss', 'embed_loss',
                                    'perplexity', 'prior_loss'}
    for k, v in got.items():
        np.testing.assert_allclose(v, float(ref[k]), rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize('flags', [[], ['--grad_accum=2'], ['--grad_clip=0.1']],
                         ids=['adam', 'accum', 'clip'])
def test_joint_train_steps_match_jax(tmp_path_factory, flags):
    """Two joint steps (AE then prior, each from the pre-update weights'
    gradients) on the same weights and batches: every AE and prior
    parameter after each step, and the metrics."""
    jmodel = _jax_model(tmp_path_factory, *flags)
    model = _port(_np(jmodel.state.params), *flags)
    for step in range(2):
        x = _batch(B=4, seed=10 + step)
        ref_metrics = jmodel.train_step(jnp.asarray(x))
        metrics = model.train_step(x)
        for k, v in metrics.items():
            np.testing.assert_allclose(float(v), float(ref_metrics[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f'step {step} {k}')
        ref = vqvae_params_from_jax(_np(jmodel.state.params))
        for name, v in model.net.state_dict().items():
            # key.bias: its exact gradient is 0 (softmax ignores a shift of
            # every key's score), so both sides step on rounding noise, which
            # Adam scales to at most prior_lr = 1e-3 a step
            atol = 1e-3 * (step + 1) if name.endswith('attn.key.bias') else 1e-5
            np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=1e-4, atol=atol,
                                       err_msg=f'{flags} step {step} {name}')
    assert model.step == 2 and model.updates == (1 if flags == ['--grad_accum=2'] else 2)


def test_serving_matches_jax_from_the_same_uniforms():
    """The JAX serving fn's Gumbel draws (jax.random.categorical is the
    argmax of logits - log(-log(u)), u uniform on [tiny, 1)) handed to the
    port give the same samples."""
    from generative_models_tpu.parallel import make_mesh, set_mesh

    n, seed = 3, 5
    try:
        set_mesh(make_mesh('', jax.devices()[:1]))
        G, Model = jax_parse_args(FLAGS, discover_models=jax_models)
        jmodel = Model(G)
        raw = jax.random.key_data(jax.random.key(seed))
        ref = np.asarray(jmodel.pure_serving_fn(n)(raw))
        params = _np(jmodel.state.params)
        # the codes behind the images: the JAX sampler's own scan, same key
        ref_codes = np.asarray(jax.jit(lambda p, rng: jvq.transformer_sample_scan(
            jmodel.prior, p, n, rng, lambda l, k: jax_dists.Categorical(logits=l).sample(k),
        ))(params['prior'], jax.random.wrap_key_data(raw)))
    finally:
        set_mesh(make_mesh('', jax.devices()))
    keys = jax.random.split(jax.random.wrap_key_data(raw), T)
    tiny = np.finfo(np.float32).tiny
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (n, K), minval=tiny, maxval=1.0))(keys))
    model = _port(params)
    with torch.no_grad():
        got = model.sample_fn(n, uniforms=torch.from_numpy(u)).numpy()
        codes = transformer_sample_scan(
            model.net.prior, n, lambda l, ut: Categorical(l).sample(uniforms=ut),
            torch.from_numpy(u)).numpy()
    assert ref.shape == got.shape == (n, 28, 28, 1)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(codes, ref_codes)
    assert len(np.unique(codes.argmax(-1))) > 1


def test_sample_server_serves_a_non_autoregressive_model():
    model = _port()
    server = SampleServer(model, serve_bs=4)
    a, b = server.sample(3, seed=9), server.sample(3, seed=9)
    assert a.shape == (3, 28, 28, 1) and np.isin(a, (0.0, 1.0)).all()
    np.testing.assert_array_equal(a, b)
    assert model.sample_images(2).shape == (2, 28, 28, 1)
    with pytest.raises(TypeError):
        model.sample_images(2, y=[1])


def test_flax_initializers(jax_model):
    """lecun-normal conv and deconv kernels with flax's fan_in (kh*kw*in,
    whichever way round torch stores the weight), zero biases, the
    codebook uniform on [-1/K, 1/K]: the JAX init's statistics."""
    ref = vqvae_params_from_jax(_np(jax_model.state.params))
    model = _port()
    for name, v in model.net.ae.state_dict().items():
        r = ref[f'ae.{name}']
        if name.endswith('bias'):
            assert not v.any() and not r.any(), name
            continue
        limit = 1.0 / K if name == 'codebook' else 2 * float(r.std()) * 1.2
        assert float(v.abs().max()) <= limit + 1e-7, name
        if v.numel() >= 1000:
            assert float(v.std()) == pytest.approx(float(r.std()), rel=0.1), name


def test_checkpoint_round_trips_both_optimizers(tmp_path):
    model = _port(None, '--grad_accum=2')
    for s in range(3):
        model.train_step(_batch(B=2, seed=s))
    model.save(tmp_path)
    again = _port(None, '--grad_accum=2')
    again.load_weights(tmp_path / 'model.pt')
    assert (again.step, again.updates, again.mini_step) == (3, 1, 1)
    for name in ('opt', 'prior_opt'):
        ref, got = model.optimizers()[name].state_dict(), again.optimizers()[name].state_dict()
        assert got['state'].keys() == ref['state'].keys() and ref['state'], name
        for i, st in ref['state'].items():
            for k, v in st.items():
                assert torch.equal(got['state'][i][k], v), (name, i, k)
    x = _batch(B=2, seed=9)
    model.train_step(x)
    again.train_step(x)
    for k, v in model.net.state_dict().items():
        assert torch.equal(again.net.state_dict()[k], v), k


@pytest.fixture(scope='module')
def cli_run(tmp_path_factory):
    logdir = tmp_path_factory.mktemp('cli')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, 'TRAIN_N', 32)  # 4 steps of 8
        mp.setattr(tm, 'TEST_N', 16)  # 2 eval batches
        with contextlib.redirect_stdout(io.StringIO()):
            history = main(FLAGS + ['--device=cpu', '--bs=8', '--epochs=1', '--save_n=1',
                                    '--data_source=synthetic', f'--logdir={logdir}'])
        yield logdir, history


def test_cli_trains_and_reloads(cli_run):
    logdir, history = cli_run
    for name in ('model.pt', 'hps.yaml'):
        assert (logdir / name).is_file(), name
    metrics = ('vq_vae_loss', 'recon_loss', 'embed_loss', 'perplexity', 'prior_loss')
    test_keys = {f'vqvae/test/{k}' for k in metrics}
    assert set(history[0]) == test_keys | {'dt/eval', 'num_vars'}
    assert set(history[1]) == set(history[0]) | {f'vqvae/train/{k}' for k in metrics} | {'dt/train'}
    assert all(np.isfinite(v) for h in history for v in h.values())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, 'TEST_N', 16)
        with contextlib.redirect_stdout(io.StringIO()):
            model, dataset, _, _, G = load_model_and_data([f'--weights_from={logdir / "model.pt"}',
                                                     '--device=cpu'])
    assert G.model == 'vqvae' and G.vqK == K and model.step == 4
    # the harness's eval stream: epoch 1's shuffle, from its own generator
    gen = epoch_generator(int(G.seed) + 1000, 1)
    got = model.eval_epoch(*dataset.epoch_batches(gen, train=False))
    for k in metrics:
        assert got[k] == pytest.approx(history[1][f'vqvae/test/{k}'], rel=1e-6), k
