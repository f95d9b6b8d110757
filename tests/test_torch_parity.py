"""The port's loss-curve parity workload and contract
(generative_models_tpu_torch/data/parity.py) on the CPU: parity_arrays and
parity_batches bitwise the JAX package's (its digits from sklearn, the
port's from data/digits.npz), the contract's constants those of
tests/parity_common.py and check_parity's verdicts the same on made-up
curves, and made's whole 48-step curve at its default width held against
the original reference's recording within TOL['made']. The card runs all
twelve curves (chip_smoke.py's parity phase)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_common as jpc
from generative_models_tpu.data import parity as jparity
from generative_models_tpu_torch.data import mnist as tmnist
from generative_models_tpu_torch.data import parity as tparity

torch.set_num_threads(1)


def test_digits_npz_holds_the_jax_packages_upsampled_digits():
    """digits.npz is sklearn's digits through the JAX package's upsampling
    (generative_models_tpu/data/mnist.py: jax.image.resize, bilinear, to
    24x24), as this test rebuilds it."""
    from sklearn.datasets import load_digits

    d = load_digits()
    imgs = jnp.asarray(d.images.astype(np.float32) / 16.0)[..., None]
    up = np.asarray(jax.image.resize(imgs, (len(d.images), 24, 24, 1), method='bilinear'))
    got_up, got_y = tmnist.load_digits()
    assert got_up.dtype == np.float32
    np.testing.assert_array_equal(got_up, up[..., 0])
    np.testing.assert_array_equal(got_y, d.target)


@pytest.mark.parametrize('binarize', [1, 0])
def test_parity_arrays_are_the_jax_packages_bitwise(binarize):
    x, y = tparity.parity_arrays(4096, binarize)
    jx, jy = jparity.parity_arrays(4096, binarize)
    assert x.dtype == jx.dtype == np.float32 and x.shape == (4096, 28, 28, 1)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    bx, by = tparity.parity_batches(4096, 32, 20, binarize)
    jbx, jby = jparity.parity_batches(4096, 32, 20, binarize)
    np.testing.assert_array_equal(bx, jbx)
    np.testing.assert_array_equal(by, jby)


def test_the_contract_is_parity_commons():
    assert tparity.NAME_MAP == jpc.NAME_MAP
    assert tparity.EXTRA == jpc.EXTRA
    assert tparity.KEY_OVERRIDE == jpc.KEY_OVERRIDE
    assert tparity.TOL == jpc.TOL
    assert tparity.BAND == jpc.BAND
    assert tparity.reference_curves() == jpc.REF
    rng = np.random.RandomState(0)
    for n in (20, 24, 31, 48):
        c = list(np.cumsum(rng.randn(n)) + 5)
        assert tparity.window_mean(c) == jpc.window_mean(c)
        assert tparity.window_mean(c, last=False) == jpc.window_mean(c, last=False)
        assert tparity.thirds(c) == jpc.thirds(c)
    for name in sorted(jpc.REF):
        ref = jpc.ref_curve(name, jpc.REF[name]['steps'])
        assert tparity.ref_curve(jpc.REF[name], name, len(ref)) == ref
        # the reference itself, a worse copy, a flat one and a short one
        for ours in (ref, [v * 1.5 + 0.1 for v in ref], [ref[0]] * len(ref), ref[:19]):
            verdicts = []
            for check in (jpc.check_parity, tparity.check_parity):
                try:
                    check(name, ours, ref)
                    verdicts.append(True)
                except AssertionError:
                    verdicts.append(False)
            assert verdicts[0] == verdicts[1], (name, ours)


def test_made_curve_matches_the_reference_over_its_whole_length():
    ours, ref = tparity.run_curve('made', 'cpu')
    assert len(ours) == len(ref) == 48
    tparity.check_parity('made', ours, ref)
    assert tparity.excess('made', ours, ref) <= tparity.TOL['made']


def test_gated_pixel_cnn_from_the_jax_init_trains_the_jax_curve():
    """The trace of parity.TRACED['gated_pixel_cnn'] (tests/parity_trace.py
    runs it at full length): the port, handed the JAX package's initial
    weights through convert, trains the JAX package's curve on the
    reference's batches, here its first 6 steps within 1e-5. What moves the
    card's curve past TOL is the init's draw, not the training."""
    from generative_models_tpu_torch.convert import gated_pixel_cnn_params_from_jax

    assert set(tparity.TRACED) == {'gated_pixel_cnn', 'diffusion'}
    assert set(tparity.TRACED_BOUND) == set(tparity.TRACED) and 0 in tparity.SEEDS
    name, steps = 'gated_pixel_cnn', 6
    jm = jpc.build(name, 32)
    init = gated_pixel_cnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jm.state.params))
    bx, by = tparity.parity_batches(4096, 32, steps, 1)
    want = [float(jm.train_step(jnp.asarray(bx[i]), jnp.asarray(by[i]))['nlogp'])
            for i in range(steps)]
    got, _ = tparity.run_curve(name, 'cpu', steps=steps,
                               model=tparity.build(name, 32, 'cpu', init))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
