"""Carry a JAX TransformerNet's params into the port: the one place where
layouts change. Pure numpy/torch.

The JAX tree (nested dicts of arrays, as flax's params) has the keys
embed/kernel, pos_emb, block{i}/{ln1,ln2}/{scale,bias},
block{i}/attn/{query,key,value,proj}/{kernel,bias},
block{i}/{fc1,fc2}/{kernel,bias}, ln_f/{scale,bias} and
head_layer/Dense_0/{kernel,bias}. A flax Dense kernel is (in, out); a torch
Linear weight is (out, in).
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
