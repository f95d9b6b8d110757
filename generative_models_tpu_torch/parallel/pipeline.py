"""Pipeline parallelism over the pipe axis: a GPipe microbatch schedule.
Counterpart of generative_models_tpu/parallel/pipeline.py.

pipeline_apply runs S stages, one a rank of the pipe axis's group (S = 1
without one), over M microbatches in M + S - 1 lockstep ticks, as the JAX
package's scan does. At each tick every stage runs its stage_fn once, on
the microbatch stage 0 takes in (clamped once the feed runs dry: bubble
work, never recorded) or on what the stage before it sent at the tick
before, and sends its output to the next stage (_Shift: one
batch_isend_irecv a tick, the reverse exchange in the backward). The last
stage records microbatch t - (S - 1) at tick t, and the recorded outputs
are summed over the axis (zeros elsewhere): every rank gets the last
stage's, and the sum's backward is the identity, as the transpose of the
JAX package's closing psum with out_specs=P().

The schedule keeps the three properties that make its backward exchanges
match up across ranks: every rank makes the same _Shift calls in the same
order; each tick's input is where(stage == 0, feed, state), so even stage
0's received state is on the graph and its _Shift backward runs (a Python
branch would leave it off, and its neighbour would wait for a gradient
that never comes); and the input x, which only stage 0 reads, enters
through the axis's copy (tp_copy), so its gradient, stage 0's, reaches
every rank. At S = 1 the same schedule runs, as the JAX package's pipe:1
does: the where picks the feed, _Shift has no peer and gives zeros (no
message is sent), and every tick's output is recorded.
"""

import torch

from generative_models_tpu_torch.parallel.mesh import PIPE_AXIS, get_mesh, tp_copy, tp_reduce


def pick_n_micro(batch, n_stages):
    """Default microbatch count: the largest of {4S, 2S, S} dividing the
    batch (GPipe wants M >= S to keep the bubble fraction small), falling
    back to the largest divisor of the batch <= 4S: searching the full
    range keeps e.g. batch=6, S=4 at M=6 (bubble 33%) instead of M=3
    (bubble 50%)."""
    for m in (4 * n_stages, 2 * n_stages, n_stages):
        if m <= batch and batch % m == 0:
            return m
    for m in range(min(batch, 4 * n_stages), 0, -1):
        if batch % m == 0:
            return m
    return 1


def _exchange(send, send_to, recv, recv_from, group):
    """Post send to rank send_to and recv from rank recv_from (ranks of
    group; None: no such message) together, and wait for both."""
    import torch.distributed as dist

    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(group, send_to), group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, recv_from), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


class _Shift(torch.autograd.Function):
    """One tick's move toward the next stage: stage s sends h to s + 1 and
    receives s - 1's (zeros at stage 0); the backward sends the received
    tensor's gradient back to s - 1 and receives h's from s + 1 (zeros at
    the last stage). With one stage (group None or of one rank) there is
    no peer: zeros both ways, and no message."""

    @staticmethod
    def forward(ctx, h, group):
        ctx.group = group
        if group is None or group.size() == 1:  # one stage: no peer
            return torch.zeros_like(h)
        S, s = group.size(), group.rank()
        return _exchange(h, s + 1 if s < S - 1 else None, torch.zeros_like(h),
                         s - 1 if s > 0 else None, group)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        if group is None or group.size() == 1:
            return torch.zeros_like(g), None
        S, s = group.size(), group.rank()
        return _exchange(g, s - 1 if s > 0 else None, torch.zeros_like(g),
                         s + 1 if s < S - 1 else None, group), None


def pipeline_apply(stage_fn, x, n_micro=None, group=None):
    """Run x (B, ...) through the S stages of the pipe axis (group: its
    process group; None: one stage, in this process). stage_fn(h) -> h,
    of h's shape, is this rank's stage (its Blocks, in order); n_micro:
    the microbatch count (default pick_n_micro(B, S)). Returns (B, ...),
    the last stage's outputs, on every rank."""
    S, s = (1, 0) if group is None else (group.size(), group.rank())
    B = x.shape[0]
    M = n_micro or pick_n_micro(B, S)
    if B % M:
        raise ValueError(f'a batch of {B} does not split into {M} microbatches')
    micro = tp_copy(x, PIPE_AXIS).reshape(M, B // M, *x.shape[1:])
    # filled on the device: a host tensor's copy to the card would sync it
    first = torch.full((), s == 0, dtype=torch.bool, device=x.device)
    last = torch.full((), s == S - 1, dtype=torch.bool, device=x.device)
    state, outs = torch.zeros_like(micro[0]), []
    for t in range(M + S - 1):
        h = stage_fn(torch.where(first, micro[min(t, M - 1)], state))
        if t >= S - 1:  # the last stage finishes microbatch t - (S - 1)
            outs.append(h)
        if t < M + S - 2:  # the last tick's output goes nowhere
            state = _Shift.apply(h, group)
    # every stage records (its gradient 0 but for the last stage's), so
    # each stage's graph reaches the loss and every _Shift runs backward
    out = torch.cat(outs)
    return tp_reduce(torch.where(last, out, torch.zeros_like(out)), PIPE_AXIS)


def stage_layers(n_layer, S, stage):
    """The layer indices stage (of S) holds: n_layer / S consecutive ones
    (the JAX package's reshape of the stacked layer axis to (S, n_layer /
    S))."""
    k = n_layer // S
    return range(stage * k, (stage + 1) * k)


def pipe_group():
    """The pipe axis's process group (None without a group)."""
    return get_mesh().group(PIPE_AXIS)


def stage_send(h, group):
    """A decode step's activations to the next stage of group."""
    _exchange(h, group.rank() + 1, None, None, group)


def stage_recv(like, group):
    """A decode step's activations from the stage before, shaped as like."""
    return _exchange(None, None, torch.empty_like(like), group.rank() - 1, group)


def stage_broadcast_last(t, group):
    """The last stage's t, on every stage of group."""
    import torch.distributed as dist

    t = t.contiguous()
    dist.broadcast(t, src=dist.get_global_rank(group, group.size() - 1), group=group)
    return t
