"""PixelTransformer: minGPT-style decoder-only transformer over 784 pixel
tokens. Counterpart of generative_models_tpu/models/pixel_transformer.py.

Two paths, each through the port's kernels on the card:
  * scoring and training: the full forward runs causal attention through
    Kernel C and its backward through Kernels E and D
    (ops/attention.py causal_attention, an autograd Function); --remat=1
    recomputes each Block in the backward (torch.utils.checkpoint), which
    launches Kernel C again. Under --mesh=seq:N, with N > 1 dividing the
    sequence, attention goes through a ring of N chunks instead
    (parallel/ring_attention.py: Kernel K a hop forward, L and M a hop
    backward), all N ring positions on one card (parallel/mesh.py's
    one-card rule); seq:1 and an N that does not divide take the normal
    path, as in the JAX package;
  * sampling: a KV-cached decode loop, one token per step, whose dense
    chains are Kernels A and B (ops/decode_fused.py ln_matmul and
    block_tail) and whose single-token attention is plain torch; with
    --decode_unroll=k >= 1 (the default 1) each k steps are one CUDA graph
    on the card, t a device counter (DecodeGraphs, utils/loop.py
    fori_loop's graphed form), bitwise the per-step loop of
    --decode_unroll=0;
  * quantized sampling (serve.py --quantize): the same loop given a
    QuantTable (ops/int8.py) as quant=, each step run module by module, as
    the JAX package's Block.step does under its interceptor, every Linear
    in the table through int8_matmul (Kernel I or J) and Kernels A and B
    not at all: their fused weights are the unquantized ones.
Under the ring sampling takes the per-op chain, as the JAX package turns
its fused decode off there: Kernels A and B are not launched.

--moe_experts=N puts models/moe.py's MoEMLP in place of every Block's
fc1/fc2; the loss adds moe_aux times the layers' mean aux and reports
{'nlogp', 'moe_aux'}, and the decode takes the module-by-module step
(_module_step, the MoE's dense step), without Kernels A and B, as the JAX
package's use_fused_decode excludes n_experts.

Under a process group (parallel/mesh.py) the mesh's axes apply as the JAX
package's rules lay them out: the batch's rows over data; Megatron TP over
model (param_sharding_rules: q/k/v and fc1 column-parallel, heads over the
axis, proj and fc2 row-parallel, one all-reduce after each row-parallel
product; the MoE's hidden dim), with the decode on the module-by-module
step above model:1; and with seq > 1 dividing the sequence each rank its
chunk of it, attention the ring over the axis's ranks. Kernels C, E and D
(K, L and M on the ring) take each rank's local tensors, (B/data,
H/model, T, D). It is the only model with ring attention: the others
replicate over seq. The pipe axis (--mesh=pipe:S, S dividing n_layer, the
JAX package's use_pipe rule) runs the Blocks as S GPipe stages over its
ranks (parallel/pipeline.py: M microbatches, M + S - 1 ticks, Kernels C,
E and D once a tick and layer), each rank holding its stage's Blocks and
their Adam moments under their global names; pipe:1 runs the schedule in
one process. Its decode hands each step's activations from stage to stage
(each stage its layers' KV caches) and broadcasts the last stage's
logits, without Kernels A and B, as the JAX package turns its fused
decode off under pipe. The expert axis splits the MoE's experts
(models/moe.py). Refused, as the JAX package cannot build them: pipe with
ring attention, MoE inside the GPipe stack.
"""

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from generative_models_tpu_torch import convert
from generative_models_tpu_torch.models.base import Autoreg
from generative_models_tpu_torch.models.heads import BinaryHead, CategoricalHead
from generative_models_tpu_torch.ops.attention import (
    causal_attention, decode_cache_dtype, decode_step_attention,
)
from generative_models_tpu_torch.ops.common import dense, matmul_dtype
from generative_models_tpu_torch.ops.decode_fused import (
    LN_EPS, _ln, block_tail, block_tail_plain, ln_matmul, ln_matmul_plain,
)
from generative_models_tpu_torch.models.moe import MoEMLP, moe_rules
from generative_models_tpu_torch.parallel.mesh import (
    MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, get_mesh, parse_mesh_spec, ring_size, tp_copy, tp_reduce,
)
from generative_models_tpu_torch.parallel.pipeline import (
    pipe_group, pipeline_apply, stage_broadcast_last, stage_recv, stage_send, stage_layers,
)
from generative_models_tpu_torch.parallel.ring_attention import ring_causal_attention
from generative_models_tpu_torch.utils import dists, register
from generative_models_tpu_torch.utils.config import AttrDict
from generative_models_tpu_torch.utils.graphs import StepGraphs
from generative_models_tpu_torch.utils.loop import exporting, fori_loop, take, write


def _kernel_weight(*layers, dtype):
    """(in, out) kernel layout of one or more Linear layers concatenated
    along out, in the kernels' operand dtype."""
    w = torch.cat([m.weight for m in layers], 0)
    return w.t().to(dtype).contiguous()


DECODE_GRAPHS_KEPT = 4  # a model's DecodeGraphs kept (PixelTransformer.decode_graphs)


# Megatron TP over the model axis (the JAX package's transformer_tp_rules,
# torch names: a Linear's weight is (out, in)): q/k/v and fc1
# column-parallel, proj and fc2 row-parallel
TP_RULES = [
    (r'attn\.(query|key|value)\.weight$', (MODEL_AXIS, None)),
    (r'attn\.(query|key|value)\.bias$', (MODEL_AXIS,)),
    (r'attn\.proj\.weight$', (None, MODEL_AXIS)),
    (r'fc1\.weight$', (MODEL_AXIS, None)),
    (r'fc1\.bias$', (MODEL_AXIS,)),
    (r'fc2\.weight$', (None, MODEL_AXIS)),
]


def transformer_rules(n_experts=0, with_model=True):
    """The param layout of a TransformerNet: TP_RULES, after moe_rules
    under MoE (the JAX package's param_sharding_rules)."""
    return (moe_rules(with_model) if n_experts else []) + TP_RULES


class CausalSelfAttention(nn.Module):
    """ring > 1: attention through a ring of that many chunks, all on this
    device (sequence parallelism, --mesh=seq:N), or over the seq axis's
    ranks (seq_group). The heads this rank holds follow from its q
    weight's rows (n_head / model under TP)."""

    def __init__(self, n_embed, n_head, ring=1):
        super().__init__()
        self.n_head = n_head
        self.head_dim = n_embed // n_head
        self.ring = ring
        self.query = nn.Linear(n_embed, n_embed)
        self.key = nn.Linear(n_embed, n_embed)
        self.value = nn.Linear(n_embed, n_embed)
        self.proj = nn.Linear(n_embed, n_embed)

    def local_heads(self):
        return self.query.weight.shape[0] // self.head_dim

    def _heads(self, x):
        B, T, _ = x.shape
        return x.reshape(B, T, -1, self.head_dim).transpose(1, 2)

    def forward(self, x, seq_group=None):
        x = tp_copy(x)
        q, k, v = (self._heads(dense(x, m)) for m in (self.query, self.key, self.value))
        if seq_group is not None:
            y = ring_causal_attention(q, k, v, group=seq_group)
        elif self.ring > 1:
            y = ring_causal_attention(q, k, v, self.ring)
        else:
            y, _ = causal_attention(q, k, v)
        B, H, T, D = y.shape
        return dense(y.transpose(1, 2).reshape(B, T, H * D), self.proj, tp_reduce)


class Block(nn.Module):
    """pre-LN attention + MLP: fc1/fc2, or with n_experts the MoE layer
    (forward then returns (x, aux))."""

    def __init__(self, n_embed, n_head, ring=1, n_experts=0, moe_cap=2.0):
        super().__init__()
        self.ln1 = nn.LayerNorm(n_embed, eps=LN_EPS)
        self.ln2 = nn.LayerNorm(n_embed, eps=LN_EPS)
        self.attn = CausalSelfAttention(n_embed, n_head, ring)
        if n_experts:
            self.moe = MoEMLP(n_embed, n_experts, moe_cap)
        else:
            self.fc1 = nn.Linear(n_embed, 4 * n_embed)
            self.fc2 = nn.Linear(4 * n_embed, n_embed)

    def forward(self, x, seq_group=None):
        x = x + self.attn(self.ln1(x), seq_group)
        if hasattr(self, 'moe'):
            y, aux = self.moe(self.ln2(x), seq_group)
            return x + y, aux
        h = F.gelu(dense(tp_copy(self.ln2(x)), self.fc1), approximate='tanh')
        return x + dense(h, self.fc2, tp_reduce)

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
    versions in the operand dtype everywhere, the per-op chain. remat
    recomputes each Block in the backward instead of keeping its
    activations (nn.remat in the JAX package). ring > 1 runs the full
    forward's attention through a ring of that many chunks (use_ring).
    n_experts > 0: MoE blocks (moe_cap their capacity factor). module_step:
    the decode takes _module_step (MoE, the model axis, quantization).
    pipe > 0: the Blocks run as that many pipeline stages over the pipe
    axis (parallel/pipeline.py), a stage's n_layer / pipe Blocks on each of
    its ranks (drop_other_stages leaves the others' slots empty, so the
    names stay blocks.{i}); pipe 0: one sequential stack."""

    def __init__(self, in_size, block_size, n_embed, n_head, n_layer,
                 head='bin', use_fused_decode=True, remat=False, ring=1,
                 n_experts=0, moe_cap=2.0, module_step=False, pipe=0):
        super().__init__()
        self.in_size = in_size
        self.block_size = block_size
        self.n_embed = n_embed
        self.n_head = n_head
        self.use_fused_decode = use_fused_decode
        self.remat = remat
        self.ring = ring
        self.n_experts = n_experts
        self.module_step = module_step or bool(n_experts)
        self.pipe = pipe
        self.pos_emb = nn.Parameter(torch.zeros(1, block_size, n_embed))
        self.embed = nn.Linear(in_size, n_embed, bias=False)
        self.blocks = nn.ModuleList(Block(n_embed, n_head, ring, n_experts, moe_cap)
                                    for _ in range(n_layer))
        self.ln_f = nn.LayerNorm(n_embed, eps=LN_EPS)
        head_cls = BinaryHead if head == 'bin' else CategoricalHead
        self.head_layer = head_cls(n_embed, in_size)

    @property
    def use_ring(self):
        return self.ring > 1

    @property
    def use_pipe(self):
        return self.pipe > 0

    def stage_blocks(self):
        """[(i, Block)] of the Blocks this rank holds (all of them but under
        the pipe axis's group), in order."""
        return [(i, b) for i, b in enumerate(self.blocks) if isinstance(b, Block)]

    def drop_other_stages(self, stage):
        """Keep the Blocks of pipeline stage `stage` alone; the others'
        slots hold an empty module."""
        keep = stage_layers(len(self.blocks), self.pipe, stage)
        for i in range(len(self.blocks)):
            if i not in keep:
                self.blocks[i] = nn.Module()

    def _group(self):
        """The pipe axis's group when the Blocks are split over its ranks."""
        return pipe_group() if self.use_pipe else None

    def seq_group(self):
        """The seq axis's group when this rank holds a chunk of the
        sequence (a ring over ranks), else None."""
        return get_mesh().ring_group(self.block_size) if self.ring > 1 else None

    def seq_slice(self, T):
        """The positions of a length-T sequence this rank's forward covers
        (all of them unless the sequence is split over the seq axis)."""
        if self.seq_group() is None:
            return slice(None)
        mesh = get_mesh()
        n, r = mesh.size(SEQ_AXIS), mesh.rank(SEQ_AXIS)
        return slice(r * T // n, (r + 1) * T // n)

    def forward(self, x, with_aux=False):
        """x: (B, T, in_size) unshifted targets; returns the dist over x (over
        its seq_slice where the sequence is split), and with with_aux the
        MoE layers' mean aux."""
        B, T, C = x.shape
        x = torch.cat([x.new_zeros(B, 1, C), x[:, :-1]], dim=1)
        group, sl = self.seq_group(), self.seq_slice(T)
        h = dense(x[:, sl], self.embed) + self.pos_emb[:, :T][:, sl]
        remat = self.remat and torch.is_grad_enabled()
        run = (lambda block, h: checkpoint(block, h, group, use_reentrant=False)) if remat else (
            lambda block, h: block(h, group))
        auxes = []
        if self.use_pipe:
            def stage(h):
                for _, block in self.stage_blocks():
                    h = run(block, h)
                return h

            h = pipeline_apply(stage, h, group=self._group())
        else:
            for block in self.blocks:
                h = run(block, h)
                if isinstance(h, tuple):
                    h, aux = h
                    auxes.append(aux)
        dist = self.head_layer(self.ln_f(h))
        if not with_aux:
            return dist
        return dist, (sum(auxes) / len(auxes) if auxes else None)

    def init_cache(self, batch):
        """One (T, batch, 2, C) packed T-major K/V cache per layer this rank
        holds (C / model under TP: this rank's heads)."""
        dev = self.pos_emb.device
        blocks = [b for _, b in self.stage_blocks()]
        shape = (self.block_size, batch, 2, blocks[0].attn.query.weight.shape[0])
        return [torch.zeros(shape, dtype=decode_cache_dtype(dev), device=dev) for _ in blocks]

    def decode_params(self):
        """The decode chain's loop-invariant params, built once per pass."""
        dt = matmul_dtype(self.pos_emb.device)
        hd = self.head_layer.dense
        return dict(
            layers=[b.fused_layer_params(dt) for _, b in self.stage_blocks()],
            ln_f_scale=self.ln_f.weight, ln_f_bias=self.ln_f.bias,
            whead=_kernel_weight(hd, dtype=dt), bhead=hd.bias,
        )

    def decode_step(self, prev_token, caches, t, params=None, quant=None):
        """prev_token: (B, in_size) (zeros at t=0); caches from init_cache,
        updated in place at row t. Returns the logits (B, in_size). quant:
        a QuantTable keyed from this net, which takes the quantized
        per-module step instead."""
        return self.step(prev_token, caches, t, params, quant)[0]

    def step(self, prev_token, caches, t, params=None, quant=None, rows=None, pos=None):
        """One decode step, the body of the sampling loop: (logits (B,
        in_size), the caches with row t written), in place when eager and
        as new tensors under torch.export (utils/loop.py write). t: an int,
        or a 0-dim device tensor (the graphed loop's). rows:
        attention reads each cache's first rows only (a segment's view;
        None: all); pos: torch.arange(block_size) on the device, made once
        a pass (None: made here)."""
        if quant is not None or self.module_step:
            return self._module_step(prev_token, caches, t, quant, rows, pos)
        if params is None:
            params = self.decode_params()
        if self.use_fused_decode:
            lm, bt = ln_matmul, block_tail
        else:
            dt = matmul_dtype(prev_token.device)
            lm = functools.partial(ln_matmul_plain, dtype=dt)
            bt = functools.partial(block_tail_plain, dtype=dt)
        C = self.n_embed
        h = self._stage_in(dense(prev_token, self.embed) + take(self.pos_emb[0], t))
        written = []
        for lp, cache in zip(params['layers'], caches):
            qkv = lm(h, lp['ln1_scale'], lp['ln1_bias'], lp['wqkv'], lp['bqkv'])
            cache = write(cache, t, qkv[:, C:].reshape(-1, 2, C))  # K at [:, 0], V at [:, 1]
            y = decode_step_attention(qkv[:, :C], cache[:rows], t, self.n_head, pos)
            h = bt(h, y, lp)
            written.append(cache)
        return self._stage_out(h, lambda h: lm(h, params['ln_f_scale'], params['ln_f_bias'],
                                               params['whead'], params['bhead'])), written

    def _stage_in(self, h):
        """A decode step's input to this rank's Blocks: h, or under the pipe
        axis's group the output of the stage before (stage 0 keeps h)."""
        g = self._group()
        return h if g is None or g.rank() == 0 else stage_recv(h, g)

    def _stage_out(self, h, head):
        """A decode step's logits from this rank's last Block's output h:
        head(h), or under the pipe axis's group h sent on to the next stage
        and the last stage's head(h) broadcast to every stage, so each
        draws the same token."""
        g = self._group()
        if g is None:
            return head(h)
        if g.rank() < g.size() - 1:
            stage_send(h, g)
            logits = h.new_empty((h.shape[0], self.in_size))
        else:
            logits = head(h)
        return stage_broadcast_last(logits, g)

    def _module_step(self, prev_token, caches, t, quant=None, rows=None, pos=None):
        """One decode step module by module (the JAX package's
        CausalSelfAttention.step, Block.step and decode_step): LayerNorm,
        query, key and value, the cache write, attention, proj, then fc1,
        gelu(tanh) and fc2 or the MoE's dense step, ln_f, the head. quant:
        each Linear through quant.linear, int8_matmul + bias where the table
        holds it (the JAX package's quantization interceptor); the plain
        dense product elsewhere and without quant. Under the model axis the
        column-parallel products give this rank's heads and hidden units,
        the row-parallel ones are summed over the axis (tp_reduce). Returns
        as step."""
        if quant is not None:  # refused above model:1 (serve.py), so no product is split
            lin = row = quant.linear
        else:
            lin = lambda x, name, layer: dense(x, layer)
            row = lambda x, name, layer: dense(x, layer, tp_reduce)
        h = self._stage_in(lin(prev_token, 'embed', self.embed) + take(self.pos_emb[0], t))
        written = []
        for (i, blk), cache in zip(self.stage_blocks(), caches):
            pre, a = f'blocks.{i}.', blk.attn
            x = _ln(h, blk.ln1.weight, blk.ln1.bias)
            q = lin(x, pre + 'attn.query', a.query)
            cache = write(cache, t, torch.stack([lin(x, pre + 'attn.key', a.key),
                                                 lin(x, pre + 'attn.value', a.value)], 1))
            y = decode_step_attention(q, cache[:rows], t, a.local_heads(), pos)
            h = h + row(y, pre + 'attn.proj', a.proj)
            x = _ln(h, blk.ln2.weight, blk.ln2.bias)
            if hasattr(blk, 'moe'):
                h = h + blk.moe.step(x)
            else:
                g = lin(x, pre + 'fc1', blk.fc1)
                h = h + row(F.gelu(g, approximate='tanh'), pre + 'fc2', blk.fc2)
            written.append(cache)
        return self._stage_out(h, lambda h: lin(_ln(h, self.ln_f.weight, self.ln_f.bias),
                                                'head_layer.dense', self.head_layer.dense)), written


@torch.no_grad()
def decode_loop(net, n, next_token, state=(), segments=1, quant=None, bufs=None):
    """Run the T-step KV-cached decode chain on a batch of n, one
    net.step a step through utils/loop.py fori_loop (a Python loop, or one
    while_loop a segment under torch.export). next_token(t, logits_t,
    state) returns the (n, in_size) token that step t+1 is fed and the
    state; returns the last state. quant: a QuantTable keyed from net (the
    quantized per-module step).

    segments > 1 splits the T steps into S runs where run k attends over
    only the first (k+1)*T/S cache rows, so the attention read per step
    shrinks from T rows to ~T/2 on average. Rows past t get exactly zero
    weight either way, so the tokens do not depend on S (the CPU tests hold
    this bitwise).

    bufs (a DecodeGraphs): fori_loop's graphed form, bufs.unroll steps a
    graph, t bufs' device counter, over its fixed params, caches, first
    token and state."""
    T = net.block_size
    dev = net.pos_emb.device
    seg = T // segments if segments > 1 and T % segments == 0 else T
    if bufs is None:
        params = None if quant is not None or net.module_step else net.decode_params()
        pos = torch.arange(T, device=dev)
        carry = (torch.zeros((n, net.in_size), device=dev), net.init_cache(n), state)
        graphed = (0, None, None)
    else:
        params, pos = bufs.params, bufs.pos
        carry = (bufs.prev, bufs.caches, state)
        graphed = (bufs.unroll, bufs.graphs, bufs.t)

    def body(rows):
        def run(t, carry):
            prev, caches, state = carry
            logits, caches = net.step(prev, caches, t, params, quant, rows, pos)
            prev, state = next_token(t, logits, state)
            return prev, caches, state
        return run

    for start in range(0, T, seg):
        carry = fori_loop(start, start + seg, body(start + seg), carry, *graphed)
    return carry[2]


class DecodeGraphs:
    """A graphed sampling pass's fixed tensors (--decode_unroll=unroll): the
    decode params' operand copies, which each pass refills from the weights
    (so a pass after a train step reads the moved weights), the positions,
    the first token, the KV caches, the draws, the tokens and the device
    counter t, and the StepGraphs of its segments' step groups (capturing on
    the card). One a batch size, segments, unroll, quant table (which it
    holds) and sampler: a graph records the sample_token it was captured
    with and replays that one, so its caller keeps it for one sampler
    (PixelTransformer.decode_graphs)."""

    def __init__(self, net, n, uniforms, quant, unroll):
        dev = net.pos_emb.device
        self.quant, self.unroll = quant, unroll
        self.params = None if quant is not None or net.module_step else net.decode_params()
        self.pos = torch.arange(net.block_size, device=dev)
        self.prev = torch.zeros((n, net.in_size), device=dev)
        self.caches = net.init_cache(n)
        self.uniforms = torch.empty_like(uniforms)
        self.tokens = torch.empty((net.block_size, n, net.in_size), device=dev)
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        self.graphs = StepGraphs(capture=dev.type == 'cuda')

    def start(self, net, uniforms):
        """Set the buffers for a pass on uniforms: the params refilled from
        the weights, the first token and the caches zeroed, the draws
        copied."""
        if self.params is not None:
            fresh = torch.utils._pytree.tree_leaves(net.decode_params())
            for buf, val in zip(torch.utils._pytree.tree_leaves(self.params), fresh, strict=True):
                if buf is not val:
                    buf.copy_(val)
        self.prev.zero_()
        for cache in self.caches:
            cache.zero_()
        self.uniforms.copy_(uniforms)


def transformer_sample_scan(net, n, sample_token, uniforms, segments=1, quant=None, bufs=None):
    """KV-cached AR sampling. sample_token(logits, u_t) -> (n, in_size)
    token; uniforms: (T, n, in_size), the draws of step t in row t; quant as
    decode_loop. bufs: a DecodeGraphs made for this batch, segments, quant
    and sample_token, for the graphed decode (not under torch.export);
    None: a Python loop. Returns the tokens (T, n, in_size)."""
    if bufs is not None:
        bufs.start(net, uniforms)

        def next_token(t, logits, tokens):
            token = sample_token(logits, take(bufs.uniforms, t))
            return token, write(tokens, t, token)

        return decode_loop(net, n, next_token, bufs.tokens, segments, quant, bufs).clone()

    def next_token(t, logits, tokens):
        token = sample_token(logits, uniforms[t])
        return token, write(tokens, t, token)

    tokens = torch.empty((net.block_size, n, net.in_size), device=uniforms.device)
    return decode_loop(net, n, next_token, tokens, segments, quant)


def teacher_forced_logits(net, x, segments=1, quant=None):
    """Logits (B, T, in_size) of the decode chain fed the tokens x (B, T,
    in_size) shifted right: what sampling computed at each position when it
    drew x (bitwise, at the same segments and quant). Unquantized, equals
    net(x).logits up to rounding."""

    def next_token(t, logits_t, logits):
        logits.append(logits_t)
        return x[:, t].contiguous(), logits

    return torch.stack(decode_loop(net, x.shape[0], next_token, [], segments, quant), dim=1)


@register
class PixelTransformer(Autoreg):
    params_from_jax = staticmethod(convert.params_from_jax)  # a JAX model.pt
    DG = AttrDict()
    DG.n_layer = 2
    DG.n_head = 4
    DG.n_embed = 128
    DG.lr = 1e-3
    DG.fused_decode = 1  # Kernels A/B in each decode step; 0 = the per-op chain
    DG.decode_unroll = 1  # decode steps a CUDA graph (the scan's unroll):
    # each unroll steps of the sampling pass are one graph on the card (a
    # device t, uncaptured on the CPU); 0: the per-step Python loop
    DG.decode_segments = -1  # triangular cache reads (transformer_sample_scan);
    # -1 = auto: 4 on the card, 1 on the CPU
    DG.moe_experts = 0  # > 0: a top-1 MoE of that many experts in every Block
    DG.moe_cap = 2.0
    DG.moe_aux = 0.01

    def __init__(self, G):
        self.side = 32 if G.get('pad32', 0) else 28
        self.block_size = self.side * self.side
        self._decode_graphs = {}  # decode_graphs' DecodeGraphs, the newest last
        super().__init__(G)

    def decode_graphs(self, n, uniforms, segments, unroll, quant):
        """sample_fn's DecodeGraphs (its Bernoulli sampler's) of a batch of n
        at these segments, unroll and quant table (keyed by its id: the
        DecodeGraphs holds the table, so the id is not reused), made at its
        first pass; the DECODE_GRAPHS_KEPT last used are kept, their caches
        and graphs' memory with them."""
        key = (n, tuple(uniforms.shape), segments, unroll, id(quant))
        bufs = self._decode_graphs.pop(key, None)
        if bufs is None:
            bufs = DecodeGraphs(self.net, n, uniforms, quant, unroll)
        self._decode_graphs[key] = bufs
        while len(self._decode_graphs) > DECODE_GRAPHS_KEPT:
            self._decode_graphs.pop(next(iter(self._decode_graphs)))
        return bufs

    def build(self):
        G = self.G
        mesh = get_mesh()
        # sequence parallelism: --mesh=seq:N routes attention through a ring
        # of N chunks when N > 1 divides the sequence; the decode chain then
        # takes the per-op path, as in the JAX package, and so it does under
        # MoE, the pipe axis and above model:1
        ring = ring_size(mesh.spec, self.block_size)
        n_experts = int(G.get('moe_experts', 0))
        tp = mesh.size(MODEL_AXIS)
        if int(G.n_head) % tp:
            raise ValueError(f'--n_head={G.n_head} does not split over model:{tp}')
        # pipeline parallelism: --mesh=pipe:S with S dividing n_layer runs the
        # Blocks as S GPipe stages (parallel/pipeline.py); pipe:1 runs the
        # whole machinery in one process (the JAX package's use_pipe rule)
        S = mesh.size(PIPE_AXIS)
        use_pipe = PIPE_AXIS in dict(parse_mesh_spec(mesh.spec)) and int(G.n_layer) % S == 0
        if use_pipe and n_experts:
            raise ValueError('MoE blocks inside the GPipe stack are not supported yet: the '
                             'aux loss cannot cross the pipeline (--moe_experts with --mesh=pipe)')
        if use_pipe and ring > 1:
            # the JAX package fails to build it: its stacked Block init traces a
            # one-token sequence through the ring, which refuses to split it
            raise NotImplementedError(
                f'--mesh={mesh.spec}: the pipe axis with ring attention (seq:{ring}) is not '
                'ported yet to generative_models_tpu_torch, as the JAX package cannot build '
                'it (its stacked Block init runs a one-token sequence through the ring)')
        return TransformerNet(
            in_size=1,
            block_size=self.block_size,
            n_embed=int(G.n_embed),
            n_head=int(G.n_head),
            n_layer=int(G.n_layer),
            head='bin',
            use_fused_decode=(bool(G.get('fused_decode', 1)) and ring == 1 and not use_pipe
                              and not n_experts and tp == 1),
            remat=bool(G.get('remat', 0)),
            ring=ring,
            n_experts=n_experts,
            moe_cap=float(G.get('moe_cap', 2.0)),
            module_step=tp > 1,
            pipe=S if use_pipe else 0,
        )

    def place_stages(self):
        """Under the pipe axis, keep this rank's stage's Blocks alone:
        {state dict name: the stage that holds it} of every Block entry."""
        if not self.net.use_pipe:
            return {}
        S = self.net.pipe
        stage_of = {i: s for s in range(S) for i in stage_layers(len(self.net.blocks), S, s)}
        names = {k: stage_of[int(k.split('.')[1])] for k in self.net.state_dict()
                 if k.startswith('blocks.')}
        self.net.drop_other_stages(self.mesh.rank(PIPE_AXIS))
        return names

    def param_sharding_rules(self):
        return transformer_rules(self.net.n_experts)

    def seq_split(self):
        return self.net.seq_group() is not None

    def loss(self, x, y=None):
        x = x.reshape(x.shape[0], self.block_size, 1)
        target = x[:, self.net.seq_slice(self.block_size)]
        if self.net.n_experts:
            dist, aux = self.net(x, with_aux=True)
            nlogp = -dist.log_prob(target).mean()
            # every MoE layer gives one aux; their mean, weighted by moe_aux
            loss = nlogp + float(self.G.get('moe_aux', 0.01)) * aux
            return loss, {'nlogp': nlogp, 'moe_aux': aux}
        loss = -self.net(x).log_prob(target).mean()
        return loss, {'nlogp': loss}

    def uniform_shape(self, n):
        return (self.block_size, n, 1)

    def sample_fn(self, n, generator=None, uniforms=None, with_frames=True, quant=None):
        """n samples (n, H, W, 1); uniforms (T, n, 1) replace the draws from
        generator; quant: a QuantTable over self.net. With with_frames, also
        the (T, n, H, W, 1) frames of the sampling process."""
        segments = int(self.G.get('decode_segments', -1))
        if segments < 0:
            segments = 4 if self.device.type == 'cuda' else 1
        T = self.block_size
        if uniforms is None:
            uniforms = torch.rand((T, n, 1), generator=generator, device=self.device)
        sample_token = lambda logits, u: dists.Bernoulli(logits=logits).sample(uniforms=u)
        # under a process group the decode steps eagerly (NCCL's collectives
        # stay out of graphs), and under torch.export as a while_loop
        unroll = int(self.G.get('decode_unroll', 1))
        bufs = None
        if unroll and self.mesh.dm is None and not exporting():
            bufs = self.decode_graphs(n, uniforms, segments, unroll, quant)
        tokens = transformer_sample_scan(self.net, n, sample_token, uniforms, segments, quant,
                                         bufs)
        samples = tokens.permute(1, 0, 2).reshape(n, self.side, self.side, 1)
        if not with_frames:
            return samples
        tri = torch.ones((T, T), device=tokens.device).tril()
        frames = (tri[:, :, None] * tokens[None, :, :, 0]).permute(0, 2, 1)
        return samples, frames.reshape(T, n, self.side, self.side, 1)
