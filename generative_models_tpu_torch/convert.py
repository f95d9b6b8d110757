"""Carry a JAX model's params into the port: the one place where layouts
change. Pure numpy/torch.

The JAX trees are nested dicts of arrays, as flax's params. A TransformerNet
has the keys embed/kernel, pos_emb, block{i}/{ln1,ln2}/{scale,bias},
block{i}/attn/{query,key,value,proj}/{kernel,bias},
block{i}/{fc1,fc2}/{kernel,bias}, ln_f/{scale,bias} and
head_layer/Dense_0/{kernel,bias}. A VQVAE has ae/encoder/Conv_{0..3},
ae/decoder/ConvTranspose_{0..3}, ae/codebook and prior/<TransformerNet>. A
MADE has w0..w3 (in, out) and b0..b3, which the port keeps as they are.

Layouts: a flax Dense kernel is (in, out), a torch Linear weight (out, in);
a flax Conv kernel is HWIO, a torch Conv2d weight OIHW. A flax
ConvTranspose kernel (kh, kw, in, out) is not flipped when applied
(transpose_kernel=False), and torch's ConvTranspose2d flips its (in, out,
kh, kw) weight, so the kernel is flipped in both spatial axes on the way.
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(p, name):
    out = {f'{name}.weight': _t(p['kernel']).t().contiguous()}
    if 'bias' in p:
        out[f'{name}.bias'] = _t(p['bias'])
    return out


def _layernorm(p, name):
    return {f'{name}.weight': _t(p['scale']), f'{name}.bias': _t(p['bias'])}


def params_from_jax(tree):
    """JAX TransformerNet params -> state dict of the port's TransformerNet."""
    sd = {'pos_emb': _t(tree['pos_emb'])}
    sd.update(_linear(tree['embed'], 'embed'))
    i = 0
    while f'block{i}' in tree:
        b, pre = tree[f'block{i}'], f'blocks.{i}'
        sd.update(_layernorm(b['ln1'], f'{pre}.ln1'))
        sd.update(_layernorm(b['ln2'], f'{pre}.ln2'))
        for name in ('query', 'key', 'value', 'proj'):
            sd.update(_linear(b['attn'][name], f'{pre}.attn.{name}'))
        sd.update(_linear(b['fc1'], f'{pre}.fc1'))
        sd.update(_linear(b['fc2'], f'{pre}.fc2'))
        i += 1
    sd.update(_layernorm(tree['ln_f'], 'ln_f'))
    sd.update(_linear(tree['head_layer']['Dense_0'], 'head_layer.dense'))
    return sd


def _conv(p, name, transpose=False):
    k = np.array(p['kernel'], dtype=np.float32)
    k = k[::-1, ::-1].transpose(2, 3, 0, 1) if transpose else k.transpose(3, 2, 0, 1)
    return {f'{name}.weight': _t(k.copy()), f'{name}.bias': _t(p['bias'])}


def vqvae_params_from_jax(tree):
    """JAX VQVAE params {'ae': ..., 'prior': ...} -> state dict of the
    port's VQVAE net (keys ae.* and prior.*)."""
    ae = tree['ae']
    sd = {'ae.codebook': _t(ae['codebook'])}
    for i in range(4):
        sd.update(_conv(ae['encoder'][f'Conv_{i}'], f'ae.encoder.convs.{i}'))
        sd.update(_conv(ae['decoder'][f'ConvTranspose_{i}'], f'ae.decoder.deconvs.{i}',
                        transpose=True))
    sd.update({f'prior.{k}': v for k, v in params_from_jax(tree['prior']).items()})
    return sd


def made_params_from_jax(tree):
    """JAX MADE params {'w0'.., 'b0'..} -> state dict of the port's
    MaskedMLP, in the same (in, out) layout (the layout Kernel G reads)."""
    return {k: _t(v) for k, v in tree.items()}
