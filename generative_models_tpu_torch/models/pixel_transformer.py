"""PixelTransformer: minGPT-style decoder-only transformer over 784 pixel
tokens. Counterpart of generative_models_tpu/models/pixel_transformer.py.

Two paths, each through the port's kernels on the card:
  * scoring: the full forward (loss / eval_loss) runs causal attention
    through Kernel C (ops/attention.py causal_attention);
  * sampling: a KV-cached decode loop, one token per step, whose dense
    chains are Kernels A and B (ops/decode_fused.py ln_matmul and
    block_tail) and whose single-token attention is plain torch.

Not ported yet, and refused when set: --moe_experts, --remat, and the ring
and pipe paths (which --mesh selects; utils/config.py refuses --mesh).
"""

import functools

import torch
import torch.nn.functional as F
from torch import nn

from generative_models_tpu_torch.models.base import Autoreg
from generative_models_tpu_torch.models.heads import BinaryHead, CategoricalHead
from generative_models_tpu_torch.ops.attention import (
    causal_attention, decode_cache_dtype, decode_step_attention,
)
from generative_models_tpu_torch.ops.common import dense, matmul_dtype
from generative_models_tpu_torch.ops.decode_fused import (
    LN_EPS, block_tail, block_tail_plain, ln_matmul, ln_matmul_plain,
)
from generative_models_tpu_torch.utils import dists, register
from generative_models_tpu_torch.utils.config import AttrDict


def _kernel_weight(*layers, dtype):
    """(in, out) kernel layout of one or more Linear layers concatenated
    along out, in the kernels' operand dtype."""
    w = torch.cat([m.weight for m in layers], 0)
    return w.t().to(dtype).contiguous()


class CausalSelfAttention(nn.Module):
    def __init__(self, n_embed, n_head):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_embed, n_embed)
        self.key = nn.Linear(n_embed, n_embed)
        self.value = nn.Linear(n_embed, n_embed)
        self.proj = nn.Linear(n_embed, n_embed)

    def _heads(self, x):
        B, T, _ = x.shape
        return x.reshape(B, T, self.n_head, -1).transpose(1, 2)

    def forward(self, x):
        q, k, v = (self._heads(dense(x, m)) for m in (self.query, self.key, self.value))
        y, _ = causal_attention(q, k, v)
        B, H, T, D = y.shape
        return dense(y.transpose(1, 2).reshape(B, T, H * D), self.proj)


class Block(nn.Module):
    """pre-LN attention + MLP."""

    def __init__(self, n_embed, n_head):
        super().__init__()
        self.ln1 = nn.LayerNorm(n_embed, eps=LN_EPS)
        self.ln2 = nn.LayerNorm(n_embed, eps=LN_EPS)
        self.attn = CausalSelfAttention(n_embed, n_head)
        self.fc1 = nn.Linear(n_embed, 4 * n_embed)
        self.fc2 = nn.Linear(4 * n_embed, n_embed)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(dense(self.ln2(x), self.fc1), approximate='tanh')
        return x + dense(h, self.fc2)

    def fused_layer_params(self, dtype):
        """Param bundle for the decode kernels: weights (in, out) in the
        operand dtype, with the Q/K/V kernels concatenated (query first)."""
        a = self.attn
        return dict(
            ln1_scale=self.ln1.weight, ln1_bias=self.ln1.bias,
            wqkv=_kernel_weight(a.query, a.key, a.value, dtype=dtype),
            bqkv=torch.cat([a.query.bias, a.key.bias, a.value.bias]),
            wproj=_kernel_weight(a.proj, dtype=dtype), bproj=a.proj.bias,
            ln2_scale=self.ln2.weight, ln2_bias=self.ln2.bias,
            wfc1=_kernel_weight(self.fc1, dtype=dtype), bfc1=self.fc1.bias,
            wfc2=_kernel_weight(self.fc2, dtype=dtype), bfc2=self.fc2.bias,
        )


class TransformerNet(nn.Module):
    """Decoder-only transformer with a Binary or Categorical head. The input
    is right-shifted inside forward.

    use_fused_decode routes each decode step through Kernels A and B (on CPU
    tensors their wrappers run the plain versions); False runs the plain
    versions in the operand dtype everywhere, the per-op chain."""

    def __init__(self, in_size, block_size, n_embed, n_head, n_layer,
                 head='bin', use_fused_decode=True):
        super().__init__()
        self.in_size = in_size
        self.block_size = block_size
        self.n_embed = n_embed
        self.n_head = n_head
        self.use_fused_decode = use_fused_decode
        self.pos_emb = nn.Parameter(torch.zeros(1, block_size, n_embed))
        self.embed = nn.Linear(in_size, n_embed, bias=False)
        self.blocks = nn.ModuleList(Block(n_embed, n_head) for _ in range(n_layer))
        self.ln_f = nn.LayerNorm(n_embed, eps=LN_EPS)
        head_cls = BinaryHead if head == 'bin' else CategoricalHead
        self.head_layer = head_cls(n_embed, in_size)

    def forward(self, x):
        """x: (B, T, in_size) unshifted targets; returns the dist over x."""
        B, T, C = x.shape
        x = torch.cat([x.new_zeros(B, 1, C), x[:, :-1]], dim=1)
        h = dense(x, self.embed) + self.pos_emb[:, :T]
        for block in self.blocks:
            h = block(h)
        return self.head_layer(self.ln_f(h))

    def init_cache(self, batch):
        """One (T, batch, 2, C) packed T-major K/V cache per layer."""
        dev = self.pos_emb.device
        shape = (self.block_size, batch, 2, self.n_embed)
        return [
            torch.zeros(shape, dtype=decode_cache_dtype(dev), device=dev)
            for _ in self.blocks
        ]

    def decode_params(self):
        """The decode chain's loop-invariant params, built once per pass."""
        dt = matmul_dtype(self.pos_emb.device)
        hd = self.head_layer.dense
        return dict(
            layers=[b.fused_layer_params(dt) for b in self.blocks],
            ln_f_scale=self.ln_f.weight, ln_f_bias=self.ln_f.bias,
            whead=_kernel_weight(hd, dtype=dt), bhead=hd.bias,
        )

    def decode_step(self, prev_token, caches, t, params=None):
        """prev_token: (B, in_size) (zeros at t=0); caches from init_cache
        (or leading-row views of them), updated in place at row t. Returns
        the logits (B, in_size)."""
        if params is None:
            params = self.decode_params()
        if self.use_fused_decode:
            lm, bt = ln_matmul, block_tail
        else:
            dt = matmul_dtype(prev_token.device)
            lm = functools.partial(ln_matmul_plain, dtype=dt)
            bt = functools.partial(block_tail_plain, dtype=dt)
        C = self.n_embed
        h = dense(prev_token, self.embed) + self.pos_emb[0, t]
        for lp, cache in zip(params['layers'], caches):
            qkv = lm(h, lp['ln1_scale'], lp['ln1_bias'], lp['wqkv'], lp['bqkv'])
            cache[t] = qkv[:, C:].reshape(-1, 2, C)  # K at [:, 0], V at [:, 1]
            y = decode_step_attention(qkv[:, :C], cache, t, self.n_head)
            h = bt(h, y, lp)
        return lm(h, params['ln_f_scale'], params['ln_f_bias'],
                  params['whead'], params['bhead'])


@torch.no_grad()
def decode_loop(net, n, next_token, segments=1):
    """Run the T-step KV-cached decode chain on a batch of n. next_token(t,
    logits_t) returns the (n, in_size) token that step t+1 is fed.

    segments > 1 splits the T steps into S runs where run k attends over
    only the first (k+1)*T/S cache rows, so the attention read per step
    shrinks from T rows to ~T/2 on average. Rows past t get exactly zero
    weight either way, so the tokens do not depend on S (the CPU tests hold
    this bitwise)."""
    T = net.block_size
    caches = net.init_cache(n)
    params = net.decode_params()
    prev = torch.zeros((n, net.in_size), device=net.pos_emb.device)
    seg = T // segments if segments > 1 and T % segments == 0 else T
    for start in range(0, T, seg):
        # leading-row views: decode_step's in-place writes land in caches
        view = [c[: start + seg] for c in caches]
        for t in range(start, start + seg):
            prev = next_token(t, net.decode_step(prev, view, t, params))


def transformer_sample_scan(net, n, sample_token, uniforms, segments=1):
    """KV-cached AR sampling. sample_token(logits, u_t) -> (n, in_size)
    token; uniforms: (T, n, in_size), the draws of step t in row t. Returns
    the tokens (T, n, in_size)."""
    tokens = torch.empty((net.block_size, n, net.in_size), device=uniforms.device)

    def next_token(t, logits):
        tokens[t] = sample_token(logits, uniforms[t])
        return tokens[t]

    decode_loop(net, n, next_token, segments)
    return tokens


def teacher_forced_logits(net, x, segments=1):
    """Logits (B, T, in_size) of the decode chain fed the tokens x (B, T,
    in_size) shifted right: what sampling computed at each position when it
    drew x (bitwise, at the same segments). Equals net(x).logits up to
    rounding."""
    logits = []

    def next_token(t, logits_t):
        logits.append(logits_t)
        return x[:, t].contiguous()

    decode_loop(net, x.shape[0], next_token, segments)
    return torch.stack(logits, dim=1)


@register
class PixelTransformer(Autoreg):
    DG = AttrDict()
    DG.n_layer = 2
    DG.n_head = 4
    DG.n_embed = 128
    DG.lr = 1e-3
    DG.fused_decode = 1  # Kernels A/B in each decode step; 0 = the per-op chain
    DG.decode_unroll = 1  # accepted for hps.yaml parity; no effect: the
    # decode loop is a Python loop, there is no scan to unroll
    DG.decode_segments = -1  # triangular cache reads (transformer_sample_scan);
    # -1 = auto: 4 on the card, 1 on the CPU
    DG.moe_experts = 0  # not ported yet: > 0 raises
    DG.moe_cap = 2.0
    DG.moe_aux = 0.01

    def __init__(self, G):
        self.side = 32 if G.get('pad32', 0) else 28
        self.block_size = self.side * self.side
        super().__init__(G)

    def build(self):
        G = self.G
        if int(G.get('moe_experts', 0)):
            raise NotImplementedError('--moe_experts is not ported yet')
        if int(G.get('remat', 0)):
            raise NotImplementedError('--remat is not ported yet (training slice)')
        return TransformerNet(
            in_size=1,
            block_size=self.block_size,
            n_embed=int(G.n_embed),
            n_head=int(G.n_head),
            n_layer=int(G.n_layer),
            head='bin',
            use_fused_decode=bool(G.get('fused_decode', 1)),
        )

    def loss(self, x, y=None):
        x = x.reshape(x.shape[0], self.block_size, 1)
        loss = -self.net(x).log_prob(x).mean()
        return loss, {'nlogp': loss}

    def sample_fn(self, n, generator=None, uniforms=None, with_frames=True):
        """n samples (n, H, W, 1); uniforms (T, n, 1) replace the draws from
        generator. With with_frames, also the (T, n, H, W, 1) frames of the
        sampling process."""
        segments = int(self.G.get('decode_segments', -1))
        if segments < 0:
            segments = 4 if self.device.type == 'cuda' else 1
        T = self.block_size
        if uniforms is None:
            uniforms = torch.rand((T, n, 1), generator=generator, device=self.device)
        sample_token = lambda logits, u: dists.Bernoulli(logits=logits).sample(uniforms=u)
        tokens = transformer_sample_scan(self.net, n, sample_token, uniforms, segments)
        samples = tokens.permute(1, 0, 2).reshape(n, self.side, self.side, 1)
        if not with_frames:
            return samples
        tri = torch.ones((T, T), device=tokens.device).tril()
        frames = (tri[:, :, None] * tokens[None, :, :, 0]).permute(0, 2, 1)
        return samples, frames.reshape(T, n, self.side, self.side, 1)
