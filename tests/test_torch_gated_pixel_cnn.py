"""The port's GatedPixelCNN (generative_models_tpu_torch/models/
gated_pixel_cnn.py) against the JAX package's on the CPU at the JAX tests'
small sizes (n_filters 8 and 16, 3-5 layers, kernel 3, 5 and 7): the same
weights (JAX params, perturbed, carried over by
convert.gated_pixel_cnn_params_from_jax) and the same draws. The checks and
tolerances are test_torch_pixel_cnn.py's, whose helpers these are: logits
and loss, gradients and one Adam step, the hybrid decode (the v stack a row
at a time) against the port's full forward and JAX's decode, causality and
no blind spot (tests/test_causality.py), sampling and frames, and --bf16."""

import jax
import pytest
import torch

from generative_models_tpu_torch.convert import gated_pixel_cnn_params_from_jax
from generative_models_tpu_torch.models.base import flax_init_
from generative_models_tpu_torch.models.gated_pixel_cnn import GatedPixelCNNNet
from test_torch_pixel_cnn import (
    bf16_case, check_decode, check_gradients_and_adam_step, check_loss_and_logits, flags_of,
    make_pair, raster_causal_check, uniforms,
)

torch.set_num_threads(1)

CONFIGS = [(8, 3, 3), (8, 4, 5), (16, 5, 7)]  # n_filters, n_layers, kernel_size
CONVERT = gated_pixel_cnn_params_from_jax


@pytest.fixture(scope='module', params=CONFIGS, ids=[f'f{c[0]}-l{c[1]}-k{c[2]}' for c in CONFIGS])
def pair(request, tmp_path_factory):
    return make_pair(tmp_path_factory, flags_of('gated_pixel_cnn', request.param), CONVERT)


def test_logits_and_loss_match_jax(pair):
    check_loss_and_logits(*pair[:2])


def test_gradients_and_adam_step_match_jax(pair):
    jm, _, port = pair
    check_gradients_and_adam_step(jm, port(), CONVERT)


def test_decode_matches_the_full_forward_and_jax(pair):
    jm, model, _ = pair
    check_decode(jm, model.net, GatedPixelCNNNet.input_canvas)


def _net(seed):
    net = GatedPixelCNNNet(8, 4, 5)
    flax_init_(net, torch.Generator().manual_seed(seed))
    return net


def test_causality():
    net = _net(0)
    for j in (0, 1, 11, 54, 99):
        raster_causal_check(net, j)


def test_no_blind_spot():
    """The pixel above and to the right of the target moves its logit
    (PixelCNN's blind spot, closed by the vertical stack)."""
    side, tgt, src = 10, 5 * 10 + 2, 4 * 10 + 4
    net = _net(1)
    x0 = torch.full((1, side, side, 1), 0.5)
    x1 = x0.clone().reshape(-1)
    x1[src] += 10.0
    with torch.no_grad():
        a, b = net(x0).reshape(-1)[tgt], net(x1.reshape(x0.shape)).reshape(-1)[tgt]
    assert abs(float(a - b)) > 1e-6


def test_sampling_and_frames_match_jax_from_the_same_uniforms(pair):
    jm, model, _ = pair
    n, seed = 2, 4
    samples, frames = jm._jit_sample(jm.state, n, jax.random.key(seed))
    with torch.no_grad():
        got, got_frames = model.sample_fn(n, uniforms=uniforms(seed, n))
    assert torch.equal(got, torch.from_numpy(jax.device_get(samples).copy()))
    assert torch.equal(got_frames, torch.from_numpy(jax.device_get(frames).copy()))
    assert 0 < float(got.mean()) < 1


def test_bf16_training_matches_jax_bf16(tmp_path_factory):
    bf16_case(tmp_path_factory, 'gated_pixel_cnn', (16, 4, 5), CONVERT)
