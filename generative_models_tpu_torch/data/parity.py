"""The loss-curve parity workload and its comparison contract. Counterpart
of generative_models_tpu/data/parity.py, with the port's own copy of the
contract in the JAX package's tests/parity_common.py (NAME_MAP, EXTRA,
KEY_OVERRIDE, TOL, BAND, window_mean, thirds, check_parity).

reference_cpu_baseline.json (the repo root) holds the original PyTorch
reference's seeded CPU loss curves of twelve models, 20-48 steps at bs=32,
trained on parity_batches: the first train_n digits-upsampled images in
order, no shuffle. run_curve trains a port model, at its registry defaults
and the recorder's overrides, on the same batches for the reference's
length and returns the two curves that check_parity compares.

The digits are data/mnist.py's, read from digits.npz as the JAX package's
loader makes them (jax.image.resize's values), so parity_arrays is bitwise
the JAX package's (tests/test_torch_parity.py holds them equal).
GMT_PARITY_DATA (or data_dir) pointing at MNIST idx files takes the first
train_n real images instead, as in the JAX package.
"""

import json
import os
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parents[2] / 'reference_cpu_baseline.json'

# the reference recorder's model name -> the registry's
NAME_MAP = {'diffusion': 'diffusion_model'}
# config overrides that give the recorder's exact workload
EXTRA = {
    'diffusion': {'bf16': 0, 'cf_drop_prob': 0.0, 'class_cond': 1, 'fused_cfg': 0},
}
# the metric compared in place of the recorded primary one (vqvae's
# vq_vae_loss includes the embed term, whose codebook warm-up depends on the
# init; recon_loss is the comparable quantity)
KEY_OVERRIDE = {'vqvae': 'recon_loss'}
# how much worse than the reference the converged window may be, relative
# (better always passes)
TOL = {
    'made': 0.05,
    'rnn': 0.10,
    'wavenet': 0.10,
    'pixel_cnn': 0.10,
    'gated_pixel_cnn': 0.20,
    'pixel_transformer': 0.10,
    'vae': 0.12,
    'vqvae': 0.10,
    'diffusion': 0.18,
    'autoencoder': 0.10,
    'classifier': 0.15,
}
# oscillating metrics (gan's discriminator loss has no better direction): a
# two-sided band, as a factor, around the reference's converged level
BAND = {'gan': 2.0}
# curves found outside TOL on the card and traced to their cause with
# tests/parity_trace.py on the CPU: from the JAX package's initial weights
# (and, for diffusion, its training draws) the port's curve is the JAX
# package's, within 2.2e-6, and within TOL; the level over 20-24 steps
# moves with the init's draw (and diffusion's draws of t and noise), which
# the port takes from torch's generators, and torch draws other numbers
# under other versions. Their converged level is held to TRACED_BOUND in
# place of TOL, set from the card's readings over SEEDS (chip_smoke.py's
# parity phase runs every seed), and every other part of the contract still
# holds them (PERF.md §6).
TRACED = {
    'gated_pixel_cnn': 'the init draw: from the JAX init the curve is the JAX one (excess '
                       '+0.175, TOL 0.20); another port init gave +0.131',
    'diffusion': 'the init and training draws: from the JAX init and draws the curve is the '
                 'JAX one (+0.088, TOL 0.18); the JAX init with the port\'s draws +0.134, '
                 'the port\'s init with the JAX draws +0.188',
}
TRACED_BOUND = {'gated_pixel_cnn': 0.35, 'diffusion': 0.30}
# the port's seeds a TRACED model's curve is run from on the card
SEEDS = (0, 1, 2, 3, 4)


def parity_arrays(train_n=4096, binarize=1, data_dir=None):
    """(x, y): train_n images (NHWC float32, transformed) and labels, the
    same at every call: the digits-upsampled set, or with data_dir (or
    GMT_PARITY_DATA) the first train_n images of the MNIST idx files
    there."""
    from generative_models_tpu_torch.data import mnist as M

    data_dir = data_dir or os.environ.get('GMT_PARITY_DATA') or None
    if data_dir:
        loaded = M._load_mnist_idx(data_dir)
        if loaded is None:
            raise FileNotFoundError(f'no MNIST idx files under {data_dir}')
        tx, ty = loaded[0][:train_n], loaded[1][:train_n]
        if tx.shape[0] != train_n:
            raise ValueError(f'{data_dir} holds {tx.shape[0]} < {train_n} train images')
    else:
        tx, ty, _, _ = M._load_digits_upsampled(train_n, 256)
    return np.asarray(M.apply_transforms(tx, binarize, 0)), np.asarray(ty)


def parity_batches(train_n, bs, steps, binarize=1):
    """Sequential (steps, bs, 28, 28, 1) images and (steps, bs) labels, no
    shuffle."""
    x, y = parity_arrays(train_n, binarize)
    n = steps * bs
    if n > x.shape[0]:
        raise ValueError(f'{steps} steps of {bs} need {n} > {x.shape[0]} images')
    return x[:n].reshape(steps, bs, *x.shape[1:]), y[:n].reshape(steps, bs)


def reference_curves(path=REF_PATH):
    """{name: the recording} of reference_cpu_baseline.json."""
    return json.loads(Path(path).read_text())['curves']


def ref_curve(info, name, steps):
    """The reference's curve of the compared metric, its first steps."""
    key = KEY_OVERRIDE.get(name, info['key'])
    if key == info['key']:
        return info['curve'][:steps]
    all_curves = info.get('all', {})
    if key not in all_curves:  # never compare another metric in its place
        raise KeyError(f'{name}: the recording has no {key!r} curve ({sorted(all_curves)})')
    return all_curves[key][:steps]


def build(name, bs, device, params=None, seed=0):
    """The port model of reference model name at its registry defaults and
    EXTRA's overrides, batch size bs, on device. params: a state dict for
    its net (a JAX init carried over through convert), else the port's
    own init from seed (which also seeds the model's draws)."""
    from generative_models_tpu_torch.utils.config import global_defaults
    from generative_models_tpu_torch.utils.registry import discover_models

    Model = discover_models()[NAME_MAP.get(name, name)]
    G = global_defaults()
    G.update(Model.DG)
    G.update(EXTRA.get(name, {}))
    G.model, G.bs, G.device, G.seed = NAME_MAP.get(name, name), bs, str(device), seed
    model = Model(G=G)
    if params is not None:
        model.net.load_state_dict(params)
    return model


def run_curve(name, device, refs=None, steps=None, model=None, seed=0):
    """Train the port's model name (built from seed unless given) on the
    reference's batches and return (its curve of the compared metric, the
    reference's), steps long (the reference's whole length by default).
    One sync, at the end."""
    import torch

    info = (refs or reference_curves())[name]
    steps = steps or info['steps']
    key = KEY_OVERRIDE.get(name, info['key'])
    bx, by = parity_batches(4096, info['bs'], steps, info['binarize'])
    model = model or build(name, info['bs'], device, seed=seed)
    dev = model.device
    x, y = torch.from_numpy(bx).to(dev), torch.from_numpy(by).to(dev)
    vals = [model.train_step(x[i], y[i])[key] for i in range(steps)]
    return torch.stack(vals).float().cpu().tolist(), ref_curve(info, name, steps)


def window_mean(curve, last=True):
    n = max(1, len(curve) // 3)
    return float(np.mean(curve[-n:] if last else curve[:n]))


def thirds(curve):
    n = max(1, len(curve) // 3)
    return [float(np.mean(curve[:n])), float(np.mean(curve[n:-n] or curve)),
            float(np.mean(curve[-n:]))]


def excess(name, ours, ref):
    """The converged window's level against the reference's, as check_parity
    bounds it: (ours - ref) / max(|ref|, 0.05) beside TOL, or for a BAND
    model ours / ref beside the band."""
    rf, of = window_mean(ref), window_mean(ours)
    if name in BAND:
        return of / rf
    return (of - rf) / max(abs(rf), 0.05)


def check_parity(name, ours, ref, tol=None):
    """The contract, as the JAX package's tests hold it: finite, >= 20
    aligned steps; where the reference learned over the window, our curve
    learns and descends through its thirds (5 % noise slack); the converged
    window no worse than the reference's beyond TOL (gan: inside BAND
    around it). tol: the converged window's bound in place of TOL[name]
    (a TRACED model's TRACED_BOUND). Raises AssertionError with the
    numbers."""
    assert np.all(np.isfinite(ours)), ours
    assert len(ours) >= 20, f'{name}: only {len(ours)} aligned steps'
    rf, of = window_mean(ref), window_mean(ours)
    if name in BAND:
        band = BAND[name]
        assert rf / band <= of <= rf * band, (
            f'{name}: ours {of:.4f} outside {band}x band of ref {rf:.4f}')
        return
    if window_mean(ref) < 0.95 * window_mean(ref, last=False):
        assert window_mean(ours) < window_mean(ours, last=False), (name, ours[:3], ours[-3:])
        w1, w2, w3 = thirds(ours)
        slack = 0.05 * max(abs(w1), 0.05)
        assert w2 <= w1 + slack and w3 <= w2 + slack, (
            f'{name}: curve not monotonically improving through thirds '
            f'({w1:.4f}, {w2:.4f}, {w3:.4f}); full ours={ours}')
    tol = TOL[name] if tol is None else tol
    assert of <= rf + tol * max(abs(rf), 0.05), (
        f'{name}: ours {of:.4f} vs reference {rf:.4f} (tol {tol:.0%}); '
        f'full ours={ours} ref={ref}')
