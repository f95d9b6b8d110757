"""The --mesh over the ranks of a process group. Counterpart of
generative_models_tpu/parallel/mesh.py: the spec and its axis names, the
mesh object, the env-gated init (maybe_initialize_distributed),
shard_by_rules and the FSDP placement (fsdp_place).

The JAX package's rule is that a mesh's product equals the device count,
and GSPMD makes every mesh compute the one-device numbers. The port keeps
that contract with one process a rank:
  * with a process group (torchrun's env: init_distributed), the mesh's
    product must equal the world size. Each axis is a sub-group of a
    torch.distributed DeviceMesh, NCCL on the card and gloo on the CPU, and
    the collectives below run at every axis size, size 1 included: one card
    under torchrun --nproc_per_node=1 makes the calls N cards would;
  * without one, only seq may exceed 1 (the one-card rule, a recorded
    deviation, ROADMAP.md queue 3): parallel/ring_attention.py runs all N
    ring positions on one card, the rotation an index. A data, model, pipe
    or expert axis above 1 raises and names torchrun.

The axes, each as the JAX package lays it out:
  * data: each rank takes its rows of every global batch (data/mnist.py),
    the gradients are averaged over the axis before every optimizer step
    (sync_grads), batch statistics and the training draws are global
    (batch_sum, dists.batch_draw), and metrics are global means;
  * model: Megatron tensor parallelism by the models' param_sharding_rules,
    torch names and dims (shard_by_rules keeps each rank's slice of the
    full init). A column-parallel product reads tp_copy(x) (identity
    forward, all-reduce of the gradient), a row-parallel one ends in
    tp_reduce (all-reduce forward, identity backward) before its bias;
  * seq: under a group, each rank holds its chunk of the sequence and ring
    attention rotates K/V between the ranks of the axis; a model without
    ring attention replicates over seq (its seq ranks compute the same
    rows, as the JAX package's GSPMD does);
  * pipe: pixel_transformer's Blocks split into stages, a stage a rank
    (parallel/pipeline.py, GPipe): the ranks of the axis hold different
    entries of the state (stage_broadcast gathers them into model.pt);
  * expert: MoE's stacked expert leaves split over the axis
    (shard_by_rules, the leading dim), the batch over data alone, so the
    expert ranks of a data group see the same tokens;
  * --fsdp=1: FSDP2 fully_shard over the data axis's sub-mesh (fsdp), on
    top of the model and expert axes' local slices.
Without a group pipe:1 and expert:1 build (pipe:1 runs the whole pipeline
machinery in one process, as the JAX package's); above 1 they need
torchrun, as data and model do.

The process's mesh is global (get_mesh / set_mesh), as the JAX package's:
GM.__init__ installs its model's, and the models' collectives read it.
"""

import math
import os
import re
from datetime import timedelta

import torch

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
SEQ_AXIS = 'seq'
PIPE_AXIS = 'pipe'
EXPERT_AXIS = 'expert'
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS, EXPERT_AXIS)

FSDP_MIN_SIZE = 2 ** 14  # leaves below this stay replicated in the JAX layout


def parse_mesh_spec(spec):
    """'data:4,seq:2' -> (('data', 4), ('seq', 2)); '' -> ('data', 1). No
    device count is matched here: Mesh holds the product to the world
    size under a group."""
    if not spec:
        return ((DATA_AXIS, 1),)
    axes = []
    for part in spec.split(','):
        name, size = part.split(':')
        if int(size) < 1:
            raise ValueError(f'mesh {spec}: axis {name.strip()} has size {size}')
        axes.append((name.strip(), int(size)))
    return tuple(axes)


def seq_size(spec):
    """The seq axis's size under --mesh=spec (1 when it has none)."""
    return dict(parse_mesh_spec(spec)).get(SEQ_AXIS, 1)


def ring_size(spec, block_size):
    """Ring positions for a sequence of block_size under --mesh=spec: the
    seq axis's size N when N > 1 divides block_size (the JAX package's
    use_ring, models/pixel_transformer.py:476-480), else 1: the normal
    path, seq:1 and an N that does not divide included."""
    n = seq_size(spec)
    return n if n > 1 and block_size % n == 0 else 1


def _dist():
    import torch.distributed as dist

    return dist


def grouped():
    """Whether this process is a rank of a torch.distributed group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def launched():
    """Whether this process is, or is to be, a rank of a process group:
    torchrun's env (RANK and WORLD_SIZE), or a group joined already."""
    return ('RANK' in os.environ and 'WORLD_SIZE' in os.environ) or grouped()


def init_distributed(device):
    """The env-gated init (maybe_initialize_distributed): under torchrun
    (RANK and WORLD_SIZE in the environment) join the process group, NCCL
    on the card and gloo on the CPU, unless one is joined already (a test's
    FileStore group). Returns the device this rank runs on: cuda:LOCAL_RANK
    for a bare cuda device under a group."""
    dist = _dist()
    if device.type == 'cuda' and device.index is None and launched():
        device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    if device.type == 'cuda' and device.index is not None:
        torch.cuda.set_device(device)
    if launched() and not grouped():
        if device.type == 'cuda':
            dist.init_process_group('nccl', device_id=device)
        else:
            dist.init_process_group('gloo', timeout=timedelta(seconds=120))
    return device


class _Reduce(torch.autograd.Function):
    """all_reduce(SUM) over group in the forward; the backward is the
    identity (grad_sum False: tp_reduce, a broadcast of the last pipe
    stage's output) or an all_reduce(SUM) of the gradient (batch_sum)."""

    @staticmethod
    def forward(ctx, x, group, grad_sum):
        ctx.group, ctx.grad_sum = group, grad_sum
        y = x.contiguous().clone()
        _dist().all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = g.contiguous().clone()
            _dist().all_reduce(g, group=ctx.group)
        return g, None, None


class _Copy(torch.autograd.Function):
    """The identity in the forward, all_reduce(SUM) of the gradient in the
    backward (Megatron's f before a column-parallel product; the input of
    a pipeline or of the local experts)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _dist().all_reduce(g, group=ctx.group)
        return g, None


class Mesh:
    """The --mesh of this process: each axis's size, this rank's
    coordinate on it and, under a process group, its sub-group. Without a
    group every axis but seq has size 1 and every group is None."""

    def __init__(self, spec='', device=None):
        self.spec = str(spec or '')
        axes = parse_mesh_spec(self.spec)
        unknown = sorted({a for a, _ in axes} - set(AXES))
        if unknown:
            raise ValueError(f'--mesh={self.spec}: unknown axis {unknown}; the axes are {AXES}')
        sizes = dict(axes)
        self.sizes = {a: sizes.get(a, 1) for a in AXES}
        self.grouped = grouped()
        self.dm = None
        if not self.grouped:
            spread = {a: n for a, n in self.sizes.items() if a != SEQ_AXIS and n > 1}
            if spread:
                n = math.prod(spread.values()) * self.sizes[SEQ_AXIS]
                raise RuntimeError(
                    f'--mesh={self.spec}: the {sorted(spread)} axes span the ranks of a '
                    f'process group; launch with torchrun --nproc_per_node={n} (one rank a '
                    'mesh slot), or run without them')
            return
        from torch.distributed.device_mesh import init_device_mesh

        world = _dist().get_world_size()
        prod = math.prod(self.sizes.values())
        if prod != world:
            raise ValueError(f'--mesh={self.spec} needs {prod} ranks, the group has {world}')
        # the spec's order (the JAX package reshapes its devices so), the
        # axes it leaves out after it
        order = [a for a, _ in axes if a in self.sizes]
        order += [a for a in self.sizes if a not in order]
        dev = (device or torch.device('cpu')).type
        self.dm = init_device_mesh(dev, tuple(self.sizes[a] for a in order),
                                   mesh_dim_names=tuple(order))

    def size(self, axis):
        return self.sizes.get(axis, 1)

    def rank(self, axis):
        return 0 if self.dm is None else self.dm.get_local_rank(axis)

    def group(self, axis):
        """The axis's process group (None without a group)."""
        return None if self.dm is None else self.dm.get_group(axis)

    def ring_group(self, block_size):
        """The seq axis's group when attention runs as a ring over ranks
        (a group, and seq > 1 dividing block_size), else None."""
        if self.dm is None or ring_size(self.spec, block_size) == 1:
            return None
        return self.group(SEQ_AXIS)

    @property
    def is_main(self):
        """Rank 0 of the group (or no group): the rank that writes files."""
        return not self.grouped or _dist().get_rank() == 0

    def batch_groups(self, seq_split=False):
        """The groups a batch quantity is spread over: data, and seq when
        the sequence is split over its ranks (seq_split)."""
        if self.dm is None:
            return []
        return [self.group(DATA_AXIS)] + ([self.group(SEQ_AXIS)] if seq_split else [])

    def batch_shards(self, seq_split=False):
        return self.size(DATA_AXIS) * (self.size(SEQ_AXIS) if seq_split else 1)


_MESH = None


def get_mesh():
    """The process's mesh (an empty one until set_mesh)."""
    global _MESH
    if _MESH is None:
        _MESH = Mesh('')
    return _MESH


def set_mesh(mesh):
    global _MESH
    _MESH = mesh


# ---------------------------------------------------------------------- #
# collectives the models call (identities without a group)
# ---------------------------------------------------------------------- #
def tp_copy(x, axis=MODEL_AXIS):
    """Before a column-parallel product (or where the ranks of axis each
    read x for a share of the work: a pipeline's input, the local
    experts'): x, its gradient summed over the axis."""
    g = get_mesh().group(axis)
    return x if g is None else _Copy.apply(x, g)


def tp_reduce(x, axis=MODEL_AXIS):
    """After a row-parallel product (before its bias), or of partial sums
    over the axis's ranks (the local experts' combine, the last pipe
    stage's output): their sum; the gradient passes through."""
    g = get_mesh().group(axis)
    return x if g is None else _Reduce.apply(x, g, False)


def batch_sum(x, seq_split=False):
    """x summed over the ranks that split the batch (data, and seq where
    the sequence is split: seq_split), differentiable: the gradient is
    summed too, as each rank's loss is a share of the global mean's."""
    for g in get_mesh().batch_groups(seq_split):
        x = _Reduce.apply(x, g, True)
    return x


def batch_mean(x, seq_split=False):
    """The mean of x over the ranks that split the batch (batch_sum / their
    count)."""
    mesh = get_mesh()
    if mesh.dm is None:
        return x
    return batch_sum(x, seq_split) / mesh.batch_shards(seq_split)


def axis_slice(axis, n):
    """This rank's slice of n entries split over axis."""
    mesh = get_mesh()
    m, r = mesh.size(axis), mesh.rank(axis)
    return slice(r * n // m, (r + 1) * n // m)


def model_slice(n):
    """This rank's slice of n features split over the model axis."""
    return axis_slice(MODEL_AXIS, n)


def data_slice(n):
    """This rank's rows of a global batch of n."""
    mesh = get_mesh()
    d, r = mesh.size(DATA_AXIS), mesh.rank(DATA_AXIS)
    if n % d:
        raise ValueError(f'a batch of {n} does not split over data:{d}')
    return slice(r * n // d, (r + 1) * n // d)


# ---------------------------------------------------------------------- #
# parameter layout: the model and expert axes' slices, FSDP over data,
# pipe stages
# ---------------------------------------------------------------------- #
SLICED = (MODEL_AXIS, EXPERT_AXIS)  # the axes a rule slices a leaf over


def _rule_dims(name, shape, rules, mesh):
    """The first rule matching name: its per-dim axes when its rank fits
    and every sharded dim divides (shard_by_rules' test), else None."""
    for pat, axes in rules:
        if re.search(pat, name):
            if len(axes) != len(shape):
                return None
            ok = all(a is None or d % mesh.size(a) == 0 for d, a in zip(shape, axes))
            return tuple(axes) if ok else None
    return None


def shard_by_rules(module, rules, mesh=None):
    """Keep this rank's slice of every parameter of module that a rule
    shards over the model or expert axis: rules [(regex on the state
    dict's name, per-dim axes)], the first match wins, as the JAX
    package's (a rule whose rank does not fit, or whose dims do not
    divide, leaves the leaf whole). Returns {name: dims} of the sliced
    entries; every size counts, 1 too, so the layout is the same at
    model:1 and expert:1."""
    mesh = mesh or get_mesh()
    layout = {}
    if mesh.dm is None:
        return layout
    with torch.no_grad():
        for name, p in module.named_parameters():
            dims = _rule_dims(name, p.shape, rules, mesh)
            if dims is None or not set(SLICED) & set(dims):
                continue
            data = p.data
            for axis in SLICED:
                if axis in dims:
                    d = dims.index(axis)
                    data = data.narrow(d, *_slice_of(axis, data.shape[d]))
            p.data = data.contiguous()
            if MODEL_AXIS in dims:
                p.tp_dim = dims.index(MODEL_AXIS)  # fsdp_placement leaves it to the model axis
            p.full_numel = math.prod(p.shape) * math.prod(
                mesh.size(a) for a in SLICED if a in dims)
            layout[name] = dims
    return layout


def fsdp_placement(p, n):
    """FSDP2's Shard of a parameter over data:n: the largest dim n divides
    that the model axis does not slice (the last of equals, as
    fsdp_place's max over (size, index)), else dim 0. FSDP2 shards every
    parameter, the small ones too (the JAX package replicates leaves
    under FSDP_MIN_SIZE: ROADMAP.md queue 3)."""
    from torch.distributed.tensor import Shard

    tp = getattr(p, 'tp_dim', None)
    size = getattr(p, 'full_numel', p.numel())  # the full leaf's
    free = [(d, i) for i, d in enumerate(p.shape) if d % n == 0 and i != tp]
    return Shard(max(free)[1] if free and size >= FSDP_MIN_SIZE else 0)


def fsdp(modules, mesh=None):
    """FSDP2 fully_shard of each module over the data axis's sub-mesh
    (each module a root: a model's nets the train step calls)."""
    from torch.distributed.fsdp import fully_shard

    mesh = mesh or get_mesh()
    if mesh.dm is None:
        raise RuntimeError('--fsdp=1 shards over the ranks of a process group: launch with '
                           'torchrun (--nproc_per_node=1 on one card)')
    n = mesh.size(DATA_AXIS)
    for mod in modules:
        fully_shard(mod, mesh=mesh.dm[DATA_AXIS],
                    shard_placement_fn=lambda p: fsdp_placement(p, n))


def is_fsdp(module):
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


class unsharded:
    """FSDP2 roots among modules all-gathered for a block that reads their
    weights outside forward (a decode loop): unshard, no resharding after
    a forward inside, resharded at the end. Nothing for other modules."""

    def __init__(self, *modules):
        self.roots = [m for m in modules if m is not None and is_fsdp(m)]

    def __enter__(self):
        for m in self.roots:
            m.set_reshard_after_forward(False)
            m.unshard()
        return self

    def __exit__(self, *exc):
        for m in self.roots:
            m.reshard()
            m.set_reshard_after_forward(True)


def local(t):
    """A DTensor's local shard (the tensor itself otherwise)."""
    return t.to_local() if hasattr(t, 'to_local') else t


def gather_full(t, dims=None):
    """The full tensor of an entry laid out on the mesh: a DTensor's
    all-gather over data (FSDP), then the model and expert axes' slices
    concatenated (dims: the entry's shard_by_rules dims). Collective under
    a group."""
    if hasattr(t, 'full_tensor'):
        t = t.full_tensor()
    t = t.detach()
    if dims is None:
        return t
    mesh = get_mesh()
    for axis in SLICED:
        if axis in dims:
            parts = [torch.empty_like(t) for _ in range(mesh.size(axis))]
            _dist().all_gather(parts, t.contiguous(), group=mesh.group(axis))
            t = torch.cat(parts, dims.index(axis))
    return t


def stage_broadcast(t, stage, shape, dtype, device):
    """An entry that one pipe stage holds (a Block of its stage), from
    that stage's ranks to the others of the pipe axis: t on the holder,
    None elsewhere (a tensor of shape and dtype on device is received).
    t itself without a group."""
    mesh = get_mesh()
    if mesh.dm is None:
        return t
    if t is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    t = t.contiguous()
    g = mesh.group(PIPE_AXIS)
    _dist().broadcast(t, src=_dist().get_global_rank(g, stage), group=g)
    return t


def layout_like(full, like, dims=None):
    """full laid out as like: its model and expert axes' slices (dims as
    gather_full's), then, where like is a DTensor, its FSDP shard (no
    collective)."""
    full = full.to(like.device, like.dtype)
    for axis in SLICED:
        if dims is not None and axis in dims:
            d = dims.index(axis)
            full = full.narrow(d, *_slice_of(axis, full.shape[d]))
    if hasattr(like, 'device_mesh'):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(full, like.device_mesh, like.placements, src_data_rank=None)
    return full.contiguous()


def _slice_of(axis, n):
    s = axis_slice(axis, n)
    return s.start, s.stop - s.start


def put_(dst, full, dims=None):
    """Copy a full tensor into dst, an entry laid out on the mesh, in
    place."""
    src = local(layout_like(full, dst, dims))
    if src.shape != local(dst).shape:
        raise ValueError(f'a full {tuple(full.shape)} does not fit an entry of local '
                         f'shape {tuple(local(dst).shape)}')
    with torch.no_grad():
        local(dst).copy_(src)


# ---------------------------------------------------------------------- #
# gradients
# ---------------------------------------------------------------------- #
def sync_grads(params, seq_split=False, fsdp_done=False):
    """Average each parameter's gradient over the ranks that split the
    batch, in one flat buffer a group: data (unless FSDP2 averaged over it
    already: fsdp_done) and seq where the sequence is split. Nothing
    without a group."""
    mesh = get_mesh()
    if mesh.dm is None:
        return
    groups = mesh.batch_groups(seq_split)[1 if fsdp_done else 0:]
    grads = [local(p.grad) for p in params if p.grad is not None]
    if not groups or not grads:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(grads)
    for g in groups:
        _dist().all_reduce(flat, group=g)
    flat.div_(math.prod(_dist().get_world_size(g) for g in groups))
    for g, v in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(v)


NORM_AXES = (DATA_AXIS, MODEL_AXIS, EXPERT_AXIS, PIPE_AXIS)  # the bits of a norm bucket


def norm_buckets(grads, split):
    """How global_sq_norm sums its entries' squares: (weights, axes).
    weights: the (16, n) 0/1 matrix that puts each entry in its bucket, one
    a set of axes the entry is split over: data where FSDP shards it (a
    DTensor), and those of split (each grad's axes among model, expert and
    pipe: a rule's slices, a pipe stage's own entry). axes: the (bit, axis)
    pairs to all-reduce over, those above size 1 that some entry is split
    over. The layout never changes, so a caller makes them once."""
    kinds = [int(hasattr(g, 'to_local'))
             + sum(2 ** NORM_AXES.index(a) for a in set(axes) if a in NORM_AXES[1:])
             for g, axes in zip(grads, split)]
    dev = local(grads[0]).device if grads else None
    n = 2 ** len(NORM_AXES)
    weights = torch.nn.functional.one_hot(torch.tensor(kinds, dtype=torch.long), n).T.float()
    mesh = get_mesh()
    axes = tuple((bit, axis) for bit, axis in enumerate(NORM_AXES)
                 if mesh.dm is not None and mesh.size(axis) > 1
                 and any(k >> bit & 1 for k in kinds))
    return weights.to(dev), axes


def global_sq_norm(grads, buckets):
    """The squared global norm of grads on the mesh: each entry's local
    sum of squares, summed over every axis its bucket splits it over
    (buckets: norm_buckets' (weights, axes); one all-reduce an axis of
    axes); a replicated entry counts once. No host sync."""
    if not grads:
        return torch.zeros(())
    sq = torch.stack([local(g).float().square().sum() for g in grads])
    weights, axes = buckets
    if not axes:
        return sq.sum()
    # selections by where, not by 0/1 products: an overflowed (inf) square
    # stays inf, as in one process, instead of turning 0 * inf into NaN
    zero = sq.new_zeros(())
    parts = torch.where(weights.bool(), sq, zero).sum(1)
    kinds = torch.arange(parts.numel(), device=parts.device)
    mesh = get_mesh()
    for bit, axis in axes:
        mask = ((kinds >> bit) & 1).bool()  # the buckets split over axis
        summed = torch.where(mask, parts, zero)
        _dist().all_reduce(summed, group=mesh.group(axis))
        parts = torch.where(mask, summed, parts)
    return parts.sum()
