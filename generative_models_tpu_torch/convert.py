"""Carry a JAX model's params into the port: the one place where layouts
change. Pure numpy/torch.

The JAX trees are nested dicts of arrays, as flax's params. A TransformerNet
has the keys embed/kernel, pos_emb, block{i}/{ln1,ln2}/{scale,bias},
block{i}/attn/{query,key,value,proj}/{kernel,bias},
block{i}/{fc1,fc2}/{kernel,bias} (with --moe_experts block{i}/moe/router/kernel
and the expert-stacked block{i}/moe/{wi,bi,wo,bo} instead), ln_f/{scale,bias}
and head_layer/Dense_0/{kernel,bias}; under the JAX package's pipe axis
its Blocks are one tree, blocks/..., each leaf stacked on a leading
n_layer axis, which the port lays out as blocks.{i} (unstack_blocks). A
VQVAE has ae/encoder/Conv_{0..3},
ae/decoder/ConvTranspose_{0..3}, ae/codebook and prior/<TransformerNet>. A
MADE has w0..w3 (in, out) and b0..b3, which the port keeps as they are. A
diffusion SimpleUnet has flax's auto-names (time_embed, guide_embed,
cond_w_embed, Downsample_i, ResBlock_i, Upsample_i, GroupNorm_0, Conv_0).
A VAENet or an Autoencoder arbiter has encoder/Conv_{0..3} and
decoder/ConvTranspose_{0..3}, a Classifier arbiter Conv_{0..3}; a GAN has
gen/{ConvTranspose_{0..3}, BatchNorm_{0..2}} and disc/{Conv_{0..3},
BatchNorm_{0..1}}, with BatchNorm's running mean and var in a batch_stats
tree beside the params. An LSTMPixelNet has wi, wh (no bias) and fc; a
WavenetNet causal, block{i}/{dilated,res1x1} (or conv{i}) and out_dense; a
PixelCNNNet and a GatedPixelCNNNet flax's auto-names (MaskConv2d_i,
LayerNorm_i, PixelResBlock_i, GatedConv2d_i with its v_kernel, h_kernel,
Conv_0 and Conv_1, StackLayerNorm_i).

Layouts: a flax Dense kernel is (in, out), a torch Linear weight (out, in);
a flax Conv kernel is HWIO, a torch Conv2d weight OIHW. A flax
ConvTranspose kernel (kh, kw, in, out) is not flipped when applied
(transpose_kernel=False), and torch's ConvTranspose2d flips its (in, out,
kh, kw) weight, so the kernel is flipped in both spatial axes on the way.
"""

import re

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


def unstack_blocks(tree):
    """A TransformerNet tree (params, or an Adam moment of them) whose
    Blocks are stacked (the JAX package's pipe layout: blocks/... with a
    leading n_layer axis) -> the same tree with block{i} entries; any
    other tree as it is."""
    if 'blocks' not in tree:
        return tree
    stacked = tree['blocks']
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} if isinstance(t, dict) else np.asarray(t)[i]

    out = {k: v for k, v in tree.items() if k != 'blocks'}
    out.update({f'block{i}': take(stacked, i) for i in range(len(leaf))})
    return out


def params_from_jax(tree):
    """JAX TransformerNet params (either layout of its Blocks) -> state
    dict of the port's TransformerNet."""
    tree = unstack_blocks(tree)
    sd = {'pos_emb': _t(tree['pos_emb'])}
    sd.update(_linear(tree['embed'], 'embed'))
    i = 0
    while f'block{i}' in tree:
        b, pre = tree[f'block{i}'], f'blocks.{i}'
        sd.update(_layernorm(b['ln1'], f'{pre}.ln1'))
        sd.update(_layernorm(b['ln2'], f'{pre}.ln2'))
        for name in ('query', 'key', 'value', 'proj'):
            sd.update(_linear(b['attn'][name], f'{pre}.attn.{name}'))
        if 'moe' in b:  # --moe_experts: the router transposed, the stacked experts as they are
            moe = b['moe']
            sd.update(_linear(moe['router'], f'{pre}.moe.router'))
            sd.update({f'{pre}.moe.{k}': _t(moe[k]) for k in ('wi', 'bi', 'wo', 'bo')})
        else:
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


def vqvae_ae_params_from_jax(ae):
    """The JAX VQVAE's 'ae' tree -> the port's ae.* entries."""
    sd = {'ae.codebook': _t(ae['codebook'])}
    for i in range(4):
        sd.update(_conv(ae['encoder'][f'Conv_{i}'], f'ae.encoder.convs.{i}'))
        sd.update(_conv(ae['decoder'][f'ConvTranspose_{i}'], f'ae.decoder.deconvs.{i}',
                        transpose=True))
    return sd


def vqvae_prior_params_from_jax(prior):
    """The JAX VQVAE's 'prior' TransformerNet tree -> the port's prior.*
    entries."""
    return {f'prior.{k}': v for k, v in params_from_jax(prior).items()}


def vqvae_params_from_jax(tree):
    """JAX VQVAE params {'ae': ..., 'prior': ...} -> state dict of the
    port's VQVAE net (keys ae.* and prior.*)."""
    return {**vqvae_ae_params_from_jax(tree['ae']),
            **vqvae_prior_params_from_jax(tree['prior'])}


def made_params_from_jax(tree):
    """JAX MADE params {'w0'.., 'b0'..} -> state dict of the port's
    MaskedMLP, in the same (in, out) layout (the layout Kernel G reads)."""
    return {k: _t(v) for k, v in tree.items()}


def _module_name(path):
    """A flax module path tuple -> the port's qualified module name:
    block{i} -> blocks.{i}, a head's Dense_0 -> dense; () -> ''."""
    parts = []
    for p in path:
        m = re.fullmatch(r'block(\d+)', p)
        parts += ['blocks', m.group(1)] if m else ['dense' if p == 'Dense_0' else p]
    return '.'.join(parts)


def quant_table_from_jax(table):
    """A JAX int8 table ({module path tuple: (q, scale)} of
    quantize_dense_tree, or {(): ((q, scale), ...)} of
    quantize_masked_mlp) -> the same table keyed by the port's qualified
    module names, as torch tensors (q int8 (in, out), scale f32)."""
    conv = lambda qs: (torch.from_numpy(np.array(qs[0])), torch.from_numpy(np.array(qs[1])))
    out = {}
    for path, v in table.items():
        out[_module_name(path)] = conv(v) if not isinstance(v[0], tuple) else tuple(map(conv, v))
    return out


def _diffusion_resblock(p, pre):
    sd = {}
    for j in (0, 1):
        sd.update(_layernorm(p[f'GroupNorm_{j}'], f'{pre}.norm{j}'))
        sd.update(_conv(p[f'Conv_{j}'], f'{pre}.conv{j}'))
    sd.update(_linear(p['Dense_0'], f'{pre}.dense'))
    if 'Conv_2' in p:  # the 1x1 projection of an up block's [h, skip]
        sd.update(_conv(p['Conv_2'], f'{pre}.skip'))
    return sd


def diffusion_params_from_jax(tree):
    """JAX SimpleUnet params -> state dict of the port's SimpleUnet:
    time_embed / guide_embed / cond_w_embed Dense_0, Dense_1 -> dense0,
    dense1; Downsample_i/Conv_0 -> down.i; ResBlock_i -> blocks.i (GroupNorm_j
    -> normj, Conv_0/1 -> conv0/1, Conv_2 -> skip, Dense_0 -> dense);
    Upsample_i/Conv_0 -> ups.i.conv; the last GroupNorm_0 / Conv_0 ->
    norm_out / conv_out."""
    sd = {}
    for name in ('time_embed', 'guide_embed', 'cond_w_embed'):
        if name in tree:
            for j in (0, 1):
                sd.update(_linear(tree[name][f'Dense_{j}'], f'{name}.dense{j}'))
    i = 0
    while f'Downsample_{i}' in tree:
        sd.update(_conv(tree[f'Downsample_{i}']['Conv_0'], f'down.{i}'))
        i += 1
    i = 0
    while f'ResBlock_{i}' in tree:
        sd.update(_diffusion_resblock(tree[f'ResBlock_{i}'], f'blocks.{i}'))
        i += 1
    i = 0
    while f'Upsample_{i}' in tree:
        sd.update(_conv(tree[f'Upsample_{i}']['Conv_0'], f'ups.{i}.conv'))
        i += 1
    sd.update(_layernorm(tree['GroupNorm_0'], 'norm_out'))
    sd.update(_conv(tree['Conv_0'], 'conv_out'))
    return sd


def conv_tree_from_jax(tree, prefix=''):
    """A flax tree of Conv_i / ConvTranspose_i modules (in sub-dicts that
    keep their names) -> state dict: Conv_i -> convs.i, ConvTranspose_i ->
    deconvs.i (flipped in both spatial axes). The layout of the port's
    ConvEncoder and ConvDecoder (models/vae.py)."""
    sd = {}
    for key, v in tree.items():
        m = re.fullmatch(r'(Conv|ConvTranspose)_(\d+)', key)
        if m is None:
            sd.update(conv_tree_from_jax(v, f'{prefix}{key}.'))
            continue
        transpose = m.group(1) == 'ConvTranspose'
        name = f'{prefix}{"deconvs" if transpose else "convs"}.{m.group(2)}'
        sd.update(_conv(v, name, transpose=transpose))
    return sd


def conv_tree_to_jax(sd):
    """The inverse of conv_tree_from_jax: a state dict of convs.i /
    deconvs.i -> the flax tree of numpy float32 arrays (HWIO kernels,
    ConvTranspose kernels (kh, kw, in, out) unflipped)."""
    tree = {}
    for key, v in sd.items():
        *mods, kind, i, leaf = key.split('.')
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        transpose = kind == 'deconvs'
        entry = node.setdefault(f'{"ConvTranspose" if transpose else "Conv"}_{i}', {})
        a = v.detach().cpu().float().numpy()
        if leaf == 'weight':
            a = a.transpose(2, 3, 0, 1)[::-1, ::-1] if transpose else a.transpose(2, 3, 1, 0)
            entry['kernel'] = np.ascontiguousarray(a)
        else:
            entry['bias'] = np.ascontiguousarray(a)
    return tree


ARBITERS = ('Autoencoder', 'Classifier')


def arbiter_params_from_jax(tree, class_name):
    """A JAX arbiter's params -> state dict of the port's arbiter net: an
    Autoencoder's AENet (encoder/Conv_i, decoder/ConvTranspose_i ->
    encoder.convs.i, decoder.deconvs.i), a Classifier's ConvEncoder (Conv_i
    -> convs.i)."""
    if class_name not in ARBITERS:
        raise ValueError(f'{class_name!r} is not an arbiter ({ARBITERS})')
    return conv_tree_from_jax(tree)


def arbiter_params_to_jax(sd, class_name):
    """The inverse of arbiter_params_from_jax (Arbiter.save's params)."""
    if class_name not in ARBITERS:
        raise ValueError(f'{class_name!r} is not an arbiter ({ARBITERS})')
    return conv_tree_to_jax(sd)


def vae_params_from_jax(tree):
    """JAX VAENet params (encoder/Conv_i, decoder/ConvTranspose_i) -> state
    dict of the port's VAENet."""
    return conv_tree_from_jax(tree)


def gan_params_from_jax(params, batch_stats=None):
    """JAX GAN params {'gen': ConvTranspose_i, BatchNorm_i; 'disc': Conv_i,
    BatchNorm_i} and their batch_stats -> state dict of the port's GAN net:
    gen.deconvs.i, disc.convs.i, and {gen,disc}.bns.i.{weight, bias} from
    BatchNorm_i's scale and bias, .{mean, var} from its batch_stats; with
    --spectral_norm=1 the discriminator's batch_stats also hold
    SpectralNorm_i's Conv_i/kernel/u (1, out) and Conv_i/kernel/sigma (),
    which become disc.sns.i.{u, sigma}. batch_stats=None converts a
    params-shaped tree alone (an optimizer's moments); a net missing from
    params is skipped (one optimizer's moments)."""
    sd = {}
    for net in ('gen', 'disc'):
        if net not in params:
            continue
        tree = params[net]
        sd.update(conv_tree_from_jax(
            {k: v for k, v in tree.items() if not k.startswith('BatchNorm_')}, f'{net}.'))
        for key in (k for k in tree if k.startswith('BatchNorm_')):
            pre = f'{net}.bns.{key.split("_")[1]}'
            sd[f'{pre}.weight'], sd[f'{pre}.bias'] = _t(tree[key]['scale']), _t(tree[key]['bias'])
            if batch_stats is not None:
                st = batch_stats[net][key]
                sd[f'{pre}.mean'], sd[f'{pre}.var'] = _t(st['mean']), _t(st['var'])
        for key, st in (batch_stats or {}).get(net, {}).items():
            m = re.fullmatch(r'SpectralNorm_(\d+)', key)
            if m:
                sd[f'{net}.sns.{m.group(1)}.u'] = _t(st[f'Conv_{m.group(1)}/kernel/u'])
                sd[f'{net}.sns.{m.group(1)}.sigma'] = _t(st[f'Conv_{m.group(1)}/kernel/sigma'])
    return sd


def rnn_params_from_jax(tree):
    """JAX LSTMPixelNet params -> state dict of the port's LSTMPixelNet."""
    sd = {}
    for name in ('wi', 'wh', 'fc'):
        sd.update(_linear(tree[name], name))
    return sd


def _causal_conv(p, name):
    """A CausalConv1x2's (2, C, F) kernel as its two (C, F) taps."""
    k = _t(p['kernel'])
    return {f'{name}.k0': k[0].contiguous(), f'{name}.k1': k[1].contiguous(),
            f'{name}.bias': _t(p['bias'])}


def wavenet_params_from_jax(tree):
    """JAX WavenetNet params -> state dict of the port's WavenetNet:
    block{i}/{dilated,res1x1} and conv{i} -> blocks.{i}."""
    sd = {**_causal_conv(tree['causal'], 'causal'), **_linear(tree['out_dense'], 'out_dense')}
    for key, p in tree.items():
        m = re.fullmatch(r'(block|conv)(\d+)', key)
        if m is None:
            continue
        pre = f'blocks.{m.group(2)}'
        if m.group(1) == 'conv':
            sd.update(_causal_conv(p, pre))
        else:
            sd.update(_causal_conv(p['dilated'], f'{pre}.dilated'))
            sd.update(_linear(p['res1x1'], f'{pre}.res1x1'))
    return sd


def _conv_weight(kernel):
    """A flax HWIO kernel as a torch OIHW weight."""
    return _t(np.array(kernel, dtype=np.float32).transpose(3, 2, 0, 1).copy())


def pixel_cnn_params_from_jax(tree):
    """JAX PixelCNNNet params -> state dict of the port's PixelCNNNet:
    MaskConv2d_0 -> conv_in; LayerNorm_i -> lns.i; PixelResBlock_i's
    MaskConv2d_0..2 -> blocks.i.conv_a, conv_mid, conv_b, then MaskConv2d_1,
    _2 -> conv_out1, conv_out2; without resblocks MaskConv2d_{1..n} ->
    blocks.{0..n-1}, then MaskConv2d_{n+1}, _{n+2} -> conv_out1, conv_out2."""
    n = sum(1 for k in tree if k.startswith('LayerNorm_'))
    res = 'PixelResBlock_0' in tree
    names = ['conv_in'] + ([] if res else [f'blocks.{i}' for i in range(n)]) + [
        'conv_out1', 'conv_out2']
    sd = {}
    for j, name in enumerate(names):
        sd.update(_conv(tree[f'MaskConv2d_{j}'], name))
    for i in range(n):
        sd.update(_layernorm(tree[f'LayerNorm_{i}'], f'lns.{i}'))
        if res:
            for j, part in enumerate(('conv_a', 'conv_mid', 'conv_b')):
                sd.update(_conv(tree[f'PixelResBlock_{i}'][f'MaskConv2d_{j}'], f'blocks.{i}.{part}'))
    return sd


def gated_pixel_cnn_params_from_jax(tree):
    """JAX GatedPixelCNNNet params -> state dict of the port's
    GatedPixelCNNNet: MaskConv2d_0, _1 -> conv_in, conv_out; GatedConv2d_i's
    v_kernel, h_kernel, Conv_0, Conv_1 -> gated.i.{v_conv, h_conv, link,
    out1x1}.weight; StackLayerNorm_i's LayerNorm_0, _1 -> stack_lns.i.ln_v,
    ln_h."""
    sd = {**_conv(tree['MaskConv2d_0'], 'conv_in'), **_conv(tree['MaskConv2d_1'], 'conv_out')}
    i = 0
    while f'GatedConv2d_{i}' in tree:
        g, pre = tree[f'GatedConv2d_{i}'], f'gated.{i}'
        sd[f'{pre}.v_conv.weight'] = _conv_weight(g['v_kernel'])
        sd[f'{pre}.h_conv.weight'] = _conv_weight(g['h_kernel'])
        sd[f'{pre}.link.weight'] = _conv_weight(g['Conv_0']['kernel'])
        sd[f'{pre}.out1x1.weight'] = _conv_weight(g['Conv_1']['kernel'])
        ln = tree[f'StackLayerNorm_{i}']
        sd.update(_layernorm(ln['LayerNorm_0'], f'stack_lns.{i}.ln_v'))
        sd.update(_layernorm(ln['LayerNorm_1'], f'stack_lns.{i}.ln_h'))
        i += 1
    return sd
