"""Mixture-of-Experts MLP. Counterpart of
generative_models_tpu/models/moe.py:46-128: Switch-Transformer top-1
routing with a per-expert capacity, in GShard's dispatch / combine einsum
form; --moe_experts=N puts it in place of every transformer Block's dense
MLP.

Routing is static-shape algebra, as the JAX package's: one-hot dispatch
and combine tensors over capacity slots, cap = max(1, ceil(T / E *
capacity_factor)), a token's slot its position in its expert's queue
counted along its batch row. Tokens past cap are dropped and give 0 (the
Block's residual passes them through). The experts' weights are stacked
along a leading E axis (wi (E, C, 4C), bi, wo (E, 4C, C), bo). The
dispatch, the expert FFNs and the combine are torch.einsum, as the JAX
package computes them outside any Pallas kernel (:88-104); the FFN's
operands take the port's operand policy (ops/common.py dense).

The load-balance aux, E * sum_e(f_e * p_e) (Switch eq. 4), is returned
beside the output (the JAX package sows it). Under a process group f and p
are global means, taken over the ranks that split the batch before their
product (parallel/mesh.py batch_mean); where the sequence is split over the
seq axis, a token's queue position also counts the tokens of its row on
the ranks before it. The model axis splits the experts' hidden dim
(moe_rules(with_model=True)): the FFN's input reads tp_copy and its output
is summed by tp_reduce before bo.

The expert axis splits the stacked leaves' leading dim, E / expert
experts a rank (moe_rules), with the batch over data alone, as the JAX
package lays it out: the expert ranks of a data group see the same
tokens and route them alike; each dispatches to its own experts, runs
their FFNs and combines their share, and the shares are summed over the
axis (tp_reduce, the identity backward). The FFN's input and the gates
enter through the axis's copy (tp_copy), so their gradients, each rank's
share, are summed too and the router and everything below it get the
whole gradient; the aux loss reads the probabilities directly (every rank
computes the same), its f and p global means over data, as tokens do not
move between expert ranks.

The decode step is the dense form over all experts (:106-115): drop-free,
so it equals the forward wherever no token overflowed.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from generative_models_tpu_torch.ops.common import matmul_dtype
from generative_models_tpu_torch.parallel.mesh import (
    EXPERT_AXIS, MODEL_AXIS, axis_slice, batch_mean, tp_copy, tp_reduce,
)


def _lecun_stack_(w, generator):
    """flax lecun_normal on a stacked (E, in, out) leaf: its fan_in counts
    the leading axis, E * in, as variance_scaling's receptive field does."""
    from generative_models_tpu_torch.models.base import _lecun_normal_

    _lecun_normal_(w, w.shape[0] * w.shape[1], generator)


def _op(x):
    """An FFN operand under the operand policy: rounded to matmul_dtype,
    multiplied in f32."""
    return x.to(matmul_dtype(x.device)).float()


class MoEMLP(nn.Module):
    def __init__(self, n_embed, n_experts, capacity_factor=2.0):
        super().__init__()
        E, C, H = n_experts, n_embed, 4 * n_embed
        self.n_experts, self.capacity_factor = E, capacity_factor
        self.router = nn.Linear(C, E, bias=False)
        self.wi = nn.Parameter(torch.zeros(E, C, H))
        self.bi = nn.Parameter(torch.zeros(E, H))
        self.wo = nn.Parameter(torch.zeros(E, H, C))
        self.bo = nn.Parameter(torch.zeros(E, C))

    def flax_init(self, generator):
        """wi and wo from lecun_normal with fan_in E * in; zero biases. The
        router takes flax_init_'s Linear draw after these."""
        _lecun_stack_(self.wi, generator)
        _lecun_stack_(self.wo, generator)
        nn.init.zeros_(self.bi)
        nn.init.zeros_(self.bo)

    def _route(self, x):
        """Top-1 routing in f32: (..., C) -> (gate, idx, probs)."""
        probs = torch.softmax(F.linear(x.float(), self.router.weight.float()), -1)
        gate, idx = probs.max(-1)
        return gate, idx, probs

    def forward(self, x, seq_group=None):
        """x (B, T, C) -> ((B, T, C), aux). seq_group: the seq axis's group
        when x is this rank's chunk of the sequence."""
        B, T, C = x.shape
        E = self.n_experts
        n_seq = 1 if seq_group is None else torch.distributed.get_world_size(seq_group)
        cap = max(1, int(math.ceil(T * n_seq / E * self.capacity_factor)))
        gate, idx, probs = self._route(x)
        onehot = F.one_hot(idx, E).to(x.dtype)  # (B, T, E)

        split = seq_group is not None
        f = batch_mean(onehot.mean((0, 1)), split)
        p = batch_mean(probs.mean((0, 1)), split)
        aux = E * torch.sum(f * p)

        pos = torch.cumsum(onehot, 1) - onehot  # the row's tokens before this one
        if split:
            pos = pos + self._earlier_counts(onehot.sum(1), seq_group)[:, None]
        pos_in_e = torch.sum(pos * onehot, -1).long()  # (B, T)
        kept = onehot * (pos_in_e < cap)[..., None]
        slot = (pos_in_e[..., None] == torch.arange(cap, device=x.device)).to(x.dtype)
        dispatch = kept[..., None] * slot[:, :, None, :]  # (B, T, E, cap)
        # this rank's experts (all of them but under the expert axis)
        mine = axis_slice(EXPERT_AXIS, E)
        dispatch = dispatch[:, :, mine]
        combine = dispatch * tp_copy(gate, EXPERT_AXIS)[..., None, None]

        xe = torch.einsum('btec,btm->ebcm', dispatch, tp_copy(tp_copy(x, EXPERT_AXIS)))
        h = F.gelu(torch.einsum('ebcm,emh->ebch', _op(xe), _op(self.wi))
                   + self.bi[:, None, None, :], approximate='tanh')
        ye = tp_reduce(torch.einsum('ebch,ehm->ebcm', _op(h), _op(self.wo)))
        ye = ye + self.bo[:, None, None, :]
        return tp_reduce(torch.einsum('ebcm,btec->btm', ye, combine), EXPERT_AXIS), aux

    @staticmethod
    def _earlier_counts(counts, group):
        """(B, E) tokens a row routed to each expert on this rank -> the
        sums over the seq axis's ranks before it."""
        dist = torch.distributed
        parts = [torch.empty_like(counts) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, counts.contiguous(), group=group)
        r = dist.get_rank(group)
        return sum(parts[:r], torch.zeros_like(counts))

    def step(self, x):
        """One decode step, x (B, C) -> (B, C): every expert's FFN on the
        batch (this rank's experts, their outputs summed over the expert
        axis) and the routed one's output, times its gate."""
        gate, idx, _ = self._route(x)
        h = F.gelu(torch.einsum('bm,emh->beh', _op(tp_copy(x)), _op(self.wi)) + self.bi[None],
                   approximate='tanh')
        ye = tp_reduce(torch.einsum('beh,ehm->bem', _op(h), _op(self.wo))) + self.bo[None]
        sel = F.one_hot(idx, self.n_experts).to(x.dtype)[:, axis_slice(EXPERT_AXIS, self.n_experts)]
        return tp_reduce(torch.einsum('bem,be->bm', ye, sel), EXPERT_AXIS) * gate[:, None]


def moe_rules(with_model=False):
    """The layout of MoEMLP's stacked leaves, torch names: the expert axis
    leading, with a model axis the hidden dim split over it (Megatron TP
    composed on the experts)."""
    h = MODEL_AXIS if with_model else None
    return [
        (r'moe\.wi$', (EXPERT_AXIS, None, h)),
        (r'moe\.bi$', (EXPERT_AXIS, h)),
        (r'moe\.wo$', (EXPERT_AXIS, h, None)),
        (r'moe\.bo$', (EXPERT_AXIS, None)),
    ]
