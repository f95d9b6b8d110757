"""GM base class. Counterpart of generative_models_tpu/models/base.py
(GM/Autoreg/Arbiter, :113-479).

Every model owns a torch module (self.net) on self.device, initialised from
G.seed with flax's initializer families, and the host API of the JAX
package: loss / eval_loss / eval_epoch, train_step / train_epoch with the
trainer knobs, sample / sample_images / evaluate, the serving fn, and
save / load_weights.

The optimizer is torch.optim.Adam on G.lr (optax.adam's b1, b2, eps and
bias correction; capturable on the card, GM.adam), wrapped as
make_optimizer wraps optax.adam:
  * --grad_clip: optax.clip_by_global_norm, g * max_norm / |g| only when
    |g| >= max_norm (not clip_grad_norm_'s max_norm / (|g| + 1e-6));
  * --grad_accum=k: optax.MultiSteps, a running mean over k micro-steps;
    clip and Adam act on the mean every k-th step;
  * --lr_scheduler=cosine / --warmup_steps / --lr_decay_steps: the optax
    schedules, evaluated at the count of optimizer updates made so far.
self.step counts train_step calls (micro-steps), as TrainState.step does.
A step is host work (_schedule, _advance: the lr and the counters) around
device work (device_step) that reads the host's counters and changes none,
so train_epoch (--jit_epoch=1) replays it as a CUDA graph on the card
(utils/graphs.py), bitwise the per-step train_step loop.

A model may own a second optimizer beside self.opt (the VQ-VAE prior's
Adam): optimizers() names every one whose state a checkpoint keeps, and
trained_params() the parameters self.opt steps.

Checkpoints: model.pt holds the full train state (net, every optimizer's
state, step counters, the training draws' generator state, and what
extra_state() names: the diffusion model's EMA copy and frozen teacher, as
the JAX package's TrainState.extra) as a torch pickle of tensors, beside an
hps.yaml that both packages read; load_weights also reads a params-only
state dict, and a JAX package's model.pt (flax msgpack of its TrainState,
read by utils/msgpack.py): the params and each Adam's moments through the
model's params_from_jax (convert.*_from_jax), optax's count as torch
Adam's step counters, the --grad_clip chain and the --grad_accum
MultiSteps window, step and extra (load_jax_state). TrainState.rng has no
torch counterpart: the model's generators keep their --seed streams.
model.pt holds full tensors whatever the mesh: under a process group
(parallel/mesh.py) save gathers every entry laid out on the mesh (the
model and expert axes' slices, FSDP's shards, and the Blocks a pipe stage
alone holds, broadcast from it) and rank 0 writes, and load_weights,
--resume and load_jax_state read a full state and lay it out again, so a
checkpoint moves between meshes and one process.
Every checkpoint is read on the CPU, so a restored optimizer keeps Adam's
step counters where a fresh one does (on the device for the card's
capturable form, GM.adam; on the CPU for the float form), and its steps
make no device-to-host copy. An Arbiter saves and loads the JAX package's
model.jit.pt payload instead (models/arbiters/).

SAMPLE_RANGE is the range of a model's samples; serving maps it to [0, 1].
Every sampling pass (the server's, sample, sample_images) runs as CUDA
graphs on the card (pass_graphs, utils/graphs.py PassGraphs), as the JAX
package jits its samplers, bitwise the per-step loop that graph_sampling =
False selects (the tests' and chip_smoke.py's twin), which a pass under a
process group or torch.export runs too.
"""

import math
from pathlib import Path

import torch
from torch import nn

from generative_models_tpu_torch.ops.common import deterministic_convs, resolve_device  # noqa: F401
from generative_models_tpu_torch.parallel import mesh as pmesh
from generative_models_tpu_torch.utils import dists
from generative_models_tpu_torch.utils.config import AttrDict, dump_hps
from generative_models_tpu_torch.utils.graphs import (
    PASS_GRAPHS_KEPT, PassGraphs, StepGraphs, kept,
)
from generative_models_tpu_torch.utils.logger import write_grid, write_gridvid
from generative_models_tpu_torch.utils.loop import exporting, take, write

# an optimizer's param-group entries that are its form, not its state:
# a checkpoint's param groups take this optimizer's (GM.adam)
ADAM_FORM = ('lr', 'capturable', 'foreach', 'fused', 'differentiable')

# std of a unit normal truncated to [-2, 2]: flax's variance_scaling divides
# by it so the truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def flax_init_(module, generator):
    """flax's default initializers: lecun-normal (truncated normal, fan_in)
    Linear, Conv and ConvTranspose weights, zero biases, LayerNorm scale 1
    and bias 0. A module with a flax_init(generator) method draws its own
    parameters (the VQ codebook); those of other modules (pos_emb) keep
    their constructor values."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, 'flax_init'):
                m.flax_init(generator)
                continue
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # flax's fan_in of a (kh, kw, in, out) kernel, whichever way
                # round torch stores it (ConvTranspose2d's dim 1 is out)
                kh, kw = m.kernel_size
                _lecun_normal_(m.weight, kh * kw * m.in_channels, generator)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
            else:
                continue
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def mean_metrics(ms):
    """Step metrics (dicts of device scalars) -> each one's mean over the
    steps, as floats (one sync)."""
    return {k: float(torch.stack([m[k] for m in ms]).mean()) for k in ms[0]}


def global_metrics(metrics, seq_split=False):
    """A step's metrics (device scalars) as their means over the ranks that
    split the batch: one all-reduce a group under a process group, the
    metrics themselves without one."""
    if not metrics or pmesh.get_mesh().dm is None:
        return metrics
    vals = pmesh.batch_mean(torch.stack([v.detach().float() for v in metrics.values()]),
                            seq_split)
    return dict(zip(metrics, vals.unbind(0)))


class JaxTrainState(dict):
    """A JAX package's model.pt as read_checkpoint reads it: the flax
    msgpack tree of its TrainState (step, params, opt_state, rng, extra),
    leaves as numpy arrays."""


def read_checkpoint(path):
    """A model.pt read on the CPU: one written by GM.save (or a params-only
    state dict), a torch zip archive, as a dict of tensors; or a JAX
    package's (flax msgpack of its TrainState) as a JaxTrainState."""
    path = Path(path)
    with open(path, 'rb') as f:
        head = f.read(2)
    if head == b'PK':  # torch.save writes a zip archive
        return torch.load(path, map_location='cpu', weights_only=True)
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):  # a msgpack map
        from generative_models_tpu_torch.utils import msgpack

        tree = msgpack.decode(path.read_bytes())
        if isinstance(tree, dict):
            return JaxTrainState(tree)
    raise ValueError(f'{path} is neither a torch checkpoint nor a JAX (flax msgpack) one')


def jax_adam_state(tree):
    """optax's ScaleByAdamState (count, mu, nu) inside an optax state tree:
    adam's (ScaleByAdamState, EmptyState) pair, under
    chain(clip_by_global_norm, adam) ({'0': {}, '1': adam's}) or under
    MultiSteps' inner_opt_state."""
    if not isinstance(tree, dict):
        return None
    if {'count', 'mu', 'nu'} <= set(tree):
        return tree
    for key in sorted(k for k in tree if k != 'acc_grads'):
        found = jax_adam_state(tree[key])
        if found is not None:
            return found
    return None


class GM:
    """GenerativeModel base."""

    DG = AttrDict()  # model-specific config defaults
    # the native range of sample_fn / sample_images: eval_heavy compares
    # samples with the test set in that range; serving maps it to [0, 1]
    # (_serving_unit_range). gan's tanh generator and diffusion's clipped
    # x_hat are in [-1, 1].
    SAMPLE_RANGE = (0.0, 1.0)
    # whether serving runs on cuDNN's deterministic algorithms (vae's and
    # gan's transposed convs), which an artifact records for its server
    SERVE_DETERMINISTIC_CONVS = False

    def __init__(self, G):
        self.G = G
        # under torchrun (or a group joined already) this rank's device and
        # the process group, then the mesh the models' collectives read; a
        # model without ring attention replicates over seq, as the JAX
        # package's GSPMD does
        self.device = pmesh.init_distributed(resolve_device(G.get('device', '')))
        self.mesh = pmesh.Mesh(str(G.get('mesh', '') or ''), self.device)
        pmesh.set_mesh(self.mesh)
        seed = int(G.get('seed', 0))
        self.net = self.build()
        # init on the CPU from one generator: the same seed gives the same
        # weights whatever the device, and the mesh
        flax_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(self.device).eval()
        # the whole net's names, in order, and the entries a pipe stage
        # alone holds ({name: stage}, with their full shapes): the full
        # model's layout, which model.pt keeps whatever the mesh
        self._full_param_names = [n for n, _ in self.net.named_parameters()]
        self.num_vars = sum(p.numel() for p in self.net.parameters())  # logged as num_vars
        full = self.net.state_dict()
        self._full_sd_names = list(full)
        self.stage_of = self.place_stages()
        self._full_meta = {k: (full[k].shape, full[k].dtype) for k in self.stage_of}
        del full
        # {state dict name: dims} of the entries the model and expert axes
        # slice
        self.layout = pmesh.shard_by_rules(self.net, self.param_sharding_rules(), self.mesh)
        self.post_build()
        self.fsdp_roots = []
        if int(G.get('fsdp', 0) or 0):
            self.fsdp_roots = self.fsdp_modules()
            pmesh.fsdp(self.fsdp_roots, self.mesh)
        # the net's names of its parameters (FSDP2's sharded ones, which the
        # optimizers step; between a forward and its backward the net holds
        # the unsharded ones)
        self._param_names = {id(p): n for n, p in self.net.named_parameters()}
        # the training draws (noise, label drops), kept in model.pt so a
        # resumed run draws what an uninterrupted one would; sampling draws
        # from a stream of its own, as the JAX package's host key. Every rank
        # draws the global batch's (dists.batch_draw)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self._sample_gen = torch.Generator(self.device).manual_seed(seed)
        self.opt = self.adam(self.trained_params(), self.lr_at(0), (0.9, 0.999), scheduled=True)
        self.step = 0  # train_step calls, micro-steps included
        self.updates = 0  # optimizer updates: the schedule's count
        self.mini_step = 0  # position inside the --grad_accum window
        self._acc = None  # the window's running mean of the gradients
        self._norm_buckets = None  # _clip_'s per-layout weights, made once
        self._graphs = None  # train_epoch's StepGraphs, made at its first call
        self._static_bufs = {}  # train_epoch's fixed input buffers
        self._row_keys = {}  # {graph key: its metric row's keys}
        # sampling passes as CUDA graphs (pass_graphs); False: the per-step loop
        self.graph_sampling = True
        self._pass_graphs = {}  # pass_graphs' PassGraphs, the newest last

    def build(self):
        """Return the torch module."""
        raise NotImplementedError

    def adam(self, params, lr, betas, scheduled=False):
        """torch.optim.Adam (optax.adam's eps and bias correction) in the
        form a CUDA graph can replay on the card: capturable, its step
        counters on the device, and, where the schedule moves it
        (scheduled), lr a 0-dim device tensor that _schedule writes before
        each update. The same form steps eagerly (--jit_epoch=0), so both
        modes are bitwise. On the CPU, where capturable Adam is refused,
        the float form."""
        cuda = self.device.type == 'cuda'
        if cuda and scheduled:
            lr = torch.full((), lr, dtype=torch.float32, device=self.device)
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8, capturable=cuda)

    def trained_params(self):
        """The parameters self.opt (Adam with the trainer knobs) steps."""
        return self.net.parameters()

    # ------------------------------------------------------------------ #
    # the mesh (parallel/mesh.py)
    # ------------------------------------------------------------------ #
    def param_sharding_rules(self):
        """[(regex on a state dict name, per-dim mesh axes)]: the entries the
        model and expert axes slice (the JAX package's
        param_sharding_rules); none by default, every parameter
        replicated."""
        return []

    def place_stages(self):
        """Hook after the net is built and initialised: under the pipe
        axis, drop the entries other pipe stages hold and return {state
        dict name: its stage} of every entry one stage holds; {} by
        default (every rank holds the whole net)."""
        return {}

    def split_axes(self, name):
        """The axes over which the entry name is split, beside FSDP's data:
        the model and expert axes where a rule slices it, pipe where one
        stage holds it."""
        axes = set(self.layout.get(name) or ()) & {pmesh.MODEL_AXIS, pmesh.EXPERT_AXIS}
        return axes | ({pmesh.PIPE_AXIS} if name in self.stage_of else set())

    def post_build(self):
        """Hook after the net is built, initialised and laid out over the
        model axis, before FSDP and the optimizers (diffusion's EMA copy)."""

    def fsdp_modules(self):
        """The modules --fsdp=1 shards, each an FSDP2 root: the nets a train
        step calls."""
        return [self.net]

    def seq_split(self):
        """Whether this rank holds a chunk of each sequence (a ring over the
        seq axis's ranks)."""
        return False

    def unsharded(self):
        """A context in which the FSDP roots' weights are whole (sampling
        reads them outside forward); nothing without --fsdp."""
        return pmesh.unsharded(*self.fsdp_roots)

    def sync_grads(self, params):
        """Average params' gradients over the ranks that split the batch
        (FSDP2 has averaged those it shards over data)."""
        pmesh.sync_grads(list(params), self.seq_split(), fsdp_done=bool(self.fsdp_roots))

    def net_state(self, module=None):
        """module's (default self.net's, the whole net under the pipe axis)
        state dict as full tensors on every rank: collective under a
        group."""
        module = self.net if module is None else module
        if module is self.net and self.stage_of:
            own = module.state_dict()
            return {k: self._full_entry(own.get(k), k) for k in self._full_sd_names}
        return {k: pmesh.gather_full(v, self.layout.get(k)) for k, v in module.state_dict().items()}

    def _net_names(self):
        """The names of the whole net's state dict (every pipe stage's)."""
        return self._full_sd_names if self.stage_of else list(self.net.state_dict())

    def _full_entry(self, t, name):
        """The full tensor of the net's entry name, laid out as t on this
        rank (None where another pipe stage holds it): gathered over the
        axes that slice it, then broadcast from the stage that holds it.
        Collective under a group."""
        if t is not None:
            t = pmesh.gather_full(t, self.layout.get(name))
        if name in self.stage_of:
            t = pmesh.stage_broadcast(t, self.stage_of[name], *self._full_meta[name], self.device)
        return t

    def load_net_state(self, module, sd):
        """A full state dict into module (self.net, or a copy of it with its
        names), laid out on the mesh: under the pipe axis each rank takes
        its stage's Blocks."""
        own = module.state_dict()
        names = set(own) | (set(self.stage_of) if module is self.net else set())
        if names != set(sd):
            raise KeyError(f'state dict keys differ: missing {sorted(names - set(sd))[:4]}, '
                           f'unexpected {sorted(set(sd) - names)[:4]}')
        for k, dst in own.items():
            pmesh.put_(dst, sd[k], self.layout.get(k))

    def _laid_out(self, full, param, name):
        """A full tensor shaped as the parameter named name, laid out as
        param."""
        return pmesh.layout_like(full, param, self.layout.get(name))

    def _full_names(self, opt):
        """The names of opt's parameters in the whole model, in its state
        dict's order: under the pipe axis every stage's, whose moments
        model.pt keeps."""
        return self._full_param_names if self.stage_of and opt is self.opt else self._opt_names(opt)

    def _full_opt_state(self, opt):
        """opt's state dict with its moments full, indexed as the whole
        model's parameters (collective under a group)."""
        sd = opt.state_dict()
        local = self._opt_names(opt)
        names = self._full_names(opt)
        mine = {n: sd['state'].get(i) for i, n in enumerate(local)}
        state = {}
        # Adam steps every parameter at once: the ranks have state or none
        some = next(iter(sd['state'].values()), None)
        for j, n in enumerate(names):
            st = mine.get(n)
            if some is None or (st is None and n not in self.stage_of):
                continue
            state[j] = {k: (st or some)[k] if k == 'step' else
                        self._full_entry(None if st is None else st[k], n) for k in some}
        groups = sd['param_groups']
        if len(names) != len(local):
            groups = [dict(groups[0], params=list(range(len(names))))]
        return {'state': state, 'param_groups': groups}

    def optimizers(self):
        """{name: optimizer} of every optimizer whose state save() keeps."""
        return {'opt': self.opt}

    def loss(self, x, y=None):
        """(batch) -> (loss, metrics dict)."""
        raise NotImplementedError

    def train_loss(self, x, y=None):
        """(batch) -> (the objective a train step differentiates, metrics)."""
        return self.loss(x, y)

    def evaluate(self, writer, x, y, epoch):
        raise NotImplementedError(
            'you need to implement the evaluate method. make some samples or something.'
        )

    def has_loss(self):
        """Whether the harness runs the test-set loss sweep."""
        return type(self).loss is not GM.loss

    @property
    def params(self):
        return list(self.net.parameters())

    def _as_input(self, x):
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    # ------------------------------------------------------------------ #
    # optimizer
    # ------------------------------------------------------------------ #
    def lr_at(self, count):
        """The learning rate of optimizer update number count (0-based):
        G.lr, or optax.linear_schedule(0, lr, warmup) with --warmup_steps,
        or optax.warmup_cosine_decay_schedule(0, lr, warmup, warmup + decay,
        0) with --lr_scheduler=cosine. Warmup starts at lr 0, as optax's."""
        G = self.G
        base = float(G.lr)
        sched = str(G.get('lr_scheduler', 'none') or 'none')
        warm = int(G.get('warmup_steps', 0) or 0)
        if sched not in ('none', 'cosine'):
            raise ValueError(f'unknown --lr_scheduler={sched}')
        if sched == 'cosine':
            decay = int(G.get('lr_decay_steps', 0) or 0)
            if decay <= 0:
                raise ValueError('--lr_scheduler=cosine needs --lr_decay_steps')
            if count < warm:
                return base * count / warm
            c = min(count - warm, decay)
            return base * 0.5 * (1.0 + math.cos(math.pi * c / decay))
        if warm == 0:
            return base
        return base * min(count, warm) / warm

    def _clip_(self, grads):
        """optax.clip_by_global_norm of self.opt's gradients in place, on
        the device (no sync). Under a group the norm is global: each
        gradient's squares summed over the ranks that hold its shards, a
        replicated one counted once."""
        clip = float(self.G.get('grad_clip', 0) or 0)
        if clip <= 0:
            return
        if self._norm_buckets is None:  # the layout is fixed from __init__ on
            self._norm_buckets = pmesh.norm_buckets(
                grads, [self.split_axes(n) for n in self._opt_names(self.opt)])
        norm = pmesh.global_sq_norm(grads, self._norm_buckets).sqrt()
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        torch._foreach_mul_([pmesh.local(g) for g in grads], scale)

    def transform_grads(self):
        """Hook between the backward and the optimizer, acting on p.grad in
        place (default: nothing). MADE masks its weight gradients here on
        its premasked route."""

    def accum(self):
        """The --grad_accum window's length (1: no accumulation)."""
        return int(self.G.get('grad_accum', 1) or 1)

    def _applies(self):
        """Whether the micro-step at the host's mini_step makes an update
        (the window's last micro-step)."""
        return self.mini_step == self.accum() - 1

    def _schedule(self):
        """Host work before a micro-step: the scheduled lr of the update it
        makes, if it makes one, into self.opt (a fill of the device lr on
        the card, which a graph reads)."""
        if not self._applies():
            return
        lr = self.lr_at(self.updates)
        for group in self.opt.param_groups:
            if isinstance(group['lr'], torch.Tensor):
                group['lr'].fill_(lr)
            else:
                group['lr'] = lr

    def _advance(self):
        """Host work after a micro-step: the window's position and the
        update count."""
        if self._applies():
            self.mini_step = 0
            self.updates += 1
        else:
            self.mini_step += 1

    def apply_grads(self):
        """One optimizer micro-step on the gradients in p.grad: transform
        them (transform_grads), fold them into the --grad_accum window's
        running mean and, at the window's last micro-step (every step
        without accumulation), clip the mean and take one Adam step at the
        scheduled lr; then advance the window and the update count."""
        self._schedule()
        self.update()
        self._advance()

    def update(self):
        """apply_grads' device work at the host's mini_step, which it reads
        and does not change: the host's counters move in _advance, so a
        graph can replay it."""
        self.transform_grads()
        self.sync_grads(p for o in self.optimizers().values()
                        for group in o.param_groups for p in group['params'])
        params = [p for group in self.opt.param_groups for p in group['params']]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        k = self.accum()
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in params]
            # optax.MultiSteps' running mean: acc += (g - acc) / (n + 1)
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            if not self._applies():
                return
            grads = self._acc
        self._clip_(grads)
        for p, g in zip(params, grads):
            p.grad = g
        self.opt.step()
        if k > 1:
            for a in self._acc:
                a.zero_()

    # ------------------------------------------------------------------ #
    # steps and epochs
    # ------------------------------------------------------------------ #
    def backward(self, x, y=None, **kw):
        """Forward and backward of one batch in train mode: leaves the
        batch's gradients in p.grad and returns its metrics (device
        scalars, not synced). kw goes to train_loss (the diffusion model's
        draws)."""
        self.net.train()
        self.net.zero_grad(set_to_none=True)
        loss, metrics = self.train_loss(self._as_input(x), y, **kw)
        loss.backward()
        return global_metrics({k: v.detach() for k, v in metrics.items()}, self.seq_split())

    def device_step(self, x, y=None, **kw):
        """One micro-step's device work at the host's counters, which it
        reads and does not change (a CUDA graph replays it): the backward
        and the update. Returns the metrics (device scalars)."""
        metrics = self.backward(x, y, **kw)
        self.update()
        return metrics

    def train_step(self, x, y=None, **kw):
        """One micro-step (kw: the draws a model takes in place of its
        generator's): the metrics, as device scalars."""
        self._schedule()
        metrics = self.device_step(x, y, **kw)
        self._advance()
        self.step += 1
        return metrics

    def step_graphs(self):
        """train_epoch's StepGraphs: capturing on the card without a process
        group (under one, NCCL's collectives stay eager), uncaptured
        elsewhere; the training draws' generator registered."""
        if self._graphs is None:
            capture = self.device.type == 'cuda' and self.mesh.dm is None
            self._graphs = StepGraphs(capture, [self._gen])
        return self._graphs

    def train_epoch(self, bx, by=None):
        """(steps, bs, ...) batches -> the mean of each metric over the
        steps, as floats (one sync at the end): --jit_epoch=1, the JAX
        package's jitted epoch. Each step copies its batch into fixed
        buffers and runs device_step through step_graphs() (a CUDA graph a
        batch shape and micro-step kind on the card, captured once and
        reused across epochs), writes its metrics into a row of a (steps,
        n) device buffer, and the host's counters move as train_step moves
        them. The means are mean_metrics' over each metric's column, so the
        floats are bitwise those of the per-step loop."""
        graphs = self.step_graphs()
        steps = len(bx)
        xs = self._static('x', bx[0])
        ys = None if by is None else self._static('y', by[0])
        rows = keys = None
        for i in range(steps):
            xs.copy_(bx[i])
            if ys is not None:
                ys.copy_(by[i])
            self._schedule()
            key = (tuple(xs.shape), self.mini_step)
            out = graphs(key, lambda: self._metric_row(xs, ys, key))
            if rows is None:
                keys = self._row_keys[key]
                rows = torch.empty((steps, len(keys)), dtype=out.dtype, device=out.device)
            rows[i].copy_(out)
            self._advance()
            self.step += 1
        return {k: float(rows[:, j].contiguous().mean()) for j, k in enumerate(keys)}

    def _static(self, name, like):
        """A fixed buffer shaped as like, which graphs read: one a name,
        dtype and shape, kept for the model's life."""
        key = (name, like.dtype, tuple(like.shape))
        if key not in self._static_bufs:
            self._static_bufs[key] = torch.empty_like(like, device=self.device)
        return self._static_bufs[key]

    def _metric_row(self, x, y, key):
        """device_step's metrics stacked in one (n,) tensor, in their
        order (kept for key); the metrics share one dtype."""
        metrics = self.device_step(x, y)
        dtypes = {v.dtype for v in metrics.values()}
        if len(dtypes) != 1:
            raise TypeError(f'{type(self).__name__}: metrics of several dtypes {dtypes}')
        self._row_keys[key] = list(metrics)
        return torch.stack(list(metrics.values()))

    @torch.no_grad()
    def eval_loss(self, x, y=None):
        """Scoring: the full forward's metrics on one batch, as floats."""
        self.net.eval()
        _, metrics = self.loss(self._as_input(x), y)
        return {k: float(v) for k, v in global_metrics(metrics, self.seq_split()).items()}

    @torch.no_grad()
    def eval_epoch(self, bx, by=None):
        """(steps, bs, ...) batches -> the mean of each metric, as floats."""
        self.net.eval()
        ms = [global_metrics(self.loss(self._as_input(bx[i]), None if by is None else by[i])[1],
                             self.seq_split())
              for i in range(len(bx))]
        return mean_metrics(ms)

    # ------------------------------------------------------------------ #
    # checkpoints: the full train state, as the JAX package's
    # ------------------------------------------------------------------ #
    def save(self, path, tag=''):
        """model[_tag].pt (net, every optimizer's state, step counters) +
        hps.yaml into directory path: full tensors, gathered on every rank
        under a group and written by rank 0."""
        path = Path(path)
        acc = self._acc
        if acc is not None:
            mine = dict(zip(self._opt_names(self.opt), acc))
            acc = [self._full_entry(mine.get(n), n) for n in self._full_names(self.opt)]
        state = dict(
            net=self.net_state(), step=self.step, updates=self.updates,
            mini_step=self.mini_step, acc=acc, extra=self.extra_state(),
            gen_state=self._gen.get_state(),
            **{name: self._full_opt_state(o) for name, o in self.optimizers().items()},
        )
        if not self.mesh.is_main:
            return
        path.mkdir(parents=True, exist_ok=True)
        suffix = f'_{tag}' if tag else ''
        torch.save(state, path / f'model{suffix}.pt')
        dump_hps(self.G, path)

    def extra_state(self):
        """{name: state dict} of the model's other weights that a
        checkpoint keeps beside the net (the JAX package's
        TrainState.extra), full tensors (net_state); none by default."""
        return {}

    def load_extra_state(self, extra):
        """Restore what extra_state() saved (extra may be {})."""

    def fit_checkpoint(self, state):
        """A model.pt written by save, made to fit this model before it is
        restored (default: as it is; one that does not fit is refused)."""
        return state

    def load_weights(self, path):
        """Restore a model.pt written by save (the full train state), a
        params-only torch state dict, or a JAX package's model.pt
        (load_jax_state)."""
        state = read_checkpoint(path)
        if isinstance(state, JaxTrainState):
            self.load_jax_state(state, path)
            return
        if 'net' not in state:  # params only
            self.load_net_state(self.net, state)
            return
        state = self.fit_checkpoint(state)
        self.load_net_state(self.net, state['net'])
        self._graphs = None  # the graphs read the optimizers' state tensors
        # read on the CPU: load_state_dict moves Adam's moments to their
        # parameters' device and each step counter where this optimizer's
        # form keeps it (_laid_out_opt): on the device for the card's
        # capturable Adam, on the CPU for the float form, where a device
        # counter would make Adam.step sync on it with .item() twice a
        # parameter
        for name, o in self.optimizers().items():
            o.load_state_dict(self._laid_out_opt(o, state[name]))
        self.step, self.updates = int(state['step']), int(state['updates'])
        self.mini_step = int(state['mini_step'])
        self._load_acc(state['acc'])
        self.load_extra_state(state.get('extra', {}))
        gen = state.get('gen_state')  # absent from checkpoints before it was kept
        # a generator's state has one size a device kind: a checkpoint of
        # the card restored on the CPU (or back) keeps the seeded stream
        if gen is not None and gen.numel() == self._gen.get_state().numel():
            self._gen.set_state(gen)

    def _load_acc(self, acc):
        """The --grad_accum window (full tensors in _full_names' order, or
        None) laid out as self.opt's parameters."""
        if acc is None:
            self._acc = None
            return
        full = dict(zip(self._full_names(self.opt), acc))
        params = [p for g in self.opt.param_groups for p in g['params']]
        self._acc = [self._laid_out(full[n], p, n)
                     for p, n in zip(params, self._opt_names(self.opt))]

    def _laid_out_opt(self, opt, sd):
        """An optimizer state dict with full moments, indexed as the whole
        model's parameters (_full_names) -> one laid out as opt's."""
        index = {n: j for j, n in enumerate(self._full_names(opt))}
        params = [p for g in opt.param_groups for p in g['params']]
        saved = {int(j): st for j, st in sd['state'].items()}
        state = {}
        for i, (p, n) in enumerate(zip(params, self._opt_names(opt))):
            st = saved.get(index[n])
            if st is not None:
                state[i] = {k: v if k == 'step' else self._laid_out(v, p, n)
                            for k, v in st.items()}
        # the hyperparameters saved, in this optimizer's form (its lr's type,
        # capturable): a checkpoint moves between the CPU and the card
        groups = [dict(g, params=own['params'], **{k: own[k] for k in ADAM_FORM if k in own})
                  for g, own in zip(sd['param_groups'], opt.state_dict()['param_groups'])]
        return {'state': state, 'param_groups': groups}

    # ------------------------------------------------------------------ #
    # a JAX package's model.pt
    # ------------------------------------------------------------------ #
    def params_from_jax(self, tree):
        """A JAX params-shaped tree (the params, an Adam moment) -> the
        entries of self.net's state dict it holds (convert.*_from_jax)."""
        raise NotImplementedError(f'{type(self).__name__} reads no JAX checkpoint')

    def net_state_from_jax(self, tree):
        """A JAX TrainState tree -> self.net's state dict: its params, and
        what the model keeps beside them (gan: the batch_stats in extra)."""
        return self.params_from_jax(tree['params'])

    def jax_optimizers(self, opt_state):
        """[(torch optimizer, its optax state, params_from_jax of its
        params-shaped trees)], the one with the trainer knobs (self.opt)
        first."""
        return [(self.opt, opt_state, self.params_from_jax)]

    def load_jax_extra(self, extra):
        """Restore what the JAX TrainState's extra holds beside the params
        (diffusion's EMA and teacher); nothing by default."""

    def _opt_names(self, opt):
        """The net's names of opt's parameters, in its state dict's order."""
        return [self._param_names[id(p)] for group in opt.param_groups for p in group['params']]

    def _load_jax_adam(self, opt, adam, params_from_jax):
        """optax's ScaleByAdamState into a torch Adam: mu and nu as
        exp_avg and exp_avg_sq, count as each step counter, on the CPU,
        where a fresh Adam keeps it. Returns the count."""
        mu, nu = params_from_jax(adam['mu']), params_from_jax(adam['nu'])
        count = float(adam['count'])
        state = {j: {'step': torch.tensor(count), 'exp_avg': mu[n], 'exp_avg_sq': nu[n]}
                 for j, n in enumerate(self._full_names(opt))}
        opt.load_state_dict(self._laid_out_opt(
            opt, {'state': state, 'param_groups': opt.state_dict()['param_groups']}))
        return int(count)

    def load_jax_state(self, tree, path=''):
        """Restore a JAX package's TrainState (read_checkpoint's
        JaxTrainState): the params through params_from_jax, each Adam's
        moments through the same converter and its count as torch Adam's
        step counters; plain adam, chain(clip_by_global_norm, adam) and
        MultiSteps (mini_step, gradient_step and acc_grads become
        mini_step, updates and the --grad_accum window); step; extra
        (load_jax_extra). TrainState.rng has no torch counterpart: the
        model's generators keep their --seed streams. A tree that does not
        fit the model is refused with a ValueError."""
        missing = sorted({'params', 'opt_state', 'step'} - set(tree))
        if missing:
            raise ValueError(f'{path}: not a JAX TrainState (no {", ".join(missing)})')
        self._graphs = None
        try:
            sd = self.net_state_from_jax(tree)
            own = self._net_names()
            absent = sorted(set(own) - set(sd))
            if absent:
                raise KeyError(f'no entry for {absent[:4]}')
            # the other way round flax's strict=False merge keeps: entries
            # the model lacks (a student's cond_w_embed) are not read
            self.load_net_state(self.net, {k: sd[k] for k in own})
            opts = self.jax_optimizers(tree['opt_state'])
            counts = []
            for opt, opt_state, conv in opts:
                adam = jax_adam_state(opt_state)
                if adam is None:
                    raise KeyError(f'no Adam state in {sorted(opt_state)}')
                counts.append(self._load_jax_adam(opt, adam, conv))
            self.step, self.updates = int(tree['step']), counts[0]
            self.mini_step, self._acc = 0, None
            _, window, conv = opts[0]
            if 'mini_step' in window:  # optax.MultiSteps around self.opt's chain
                self.updates = int(window['gradient_step'])
                self.mini_step = int(window['mini_step'])
                acc = conv(window['acc_grads'])
                self._load_acc([acc[n] for n in self._full_names(self.opt)])
            self.load_jax_extra(tree.get('extra') or {})
        except (KeyError, TypeError, RuntimeError) as e:
            raise ValueError(
                f'{path}: a JAX TrainState that does not fit {type(self).__name__} '
                f'at these flags: {e}') from e


    # ------------------------------------------------------------------ #
    # sampling and serving
    # ------------------------------------------------------------------ #
    def quant_net(self):
        """The module whose Linears serve.py --quantize quantizes (the
        QuantTable's root): the net the serving fn runs."""
        return self.net

    def sample_fn(self, n, generator=None, uniforms=None, quant=None):
        """n samples from the generator's draws, or from the random numbers
        given (uniforms), so a test can hand both packages the same draws.
        quant: a QuantTable over self.net (ops/int8.py) for quantized
        serving."""
        raise NotImplementedError

    def draw_spec(self, n):
        """[(name, shape, kind)] of the random draws that one serving pass
        of n samples takes, in the order a generator gives them (kind
        'uniform': torch.rand, 'normal': torch.randn; float32 both), as
        dists.draw makes them."""
        raise NotImplementedError

    def sample_from_draws(self, n, draws, y=None, quant=None):
        """n samples (n, H, W, 1) in SAMPLE_RANGE from draws, the tensors
        of draw_spec(n) in its order, under labels y (a class-conditional
        model's (n,) int32, -1 unconditional). quant: a QuantTable over
        quant_net()."""
        raise NotImplementedError

    def serving_modules(self):
        """The modules a serving pass reads."""
        return [self.net]

    def graphed_sampling(self):
        """Whether a sampling pass runs graphed: graph_sampling on, and
        neither a process group (NCCL's collectives stay out of graphs) nor
        torch.export (its while_loop) at work."""
        return self.graph_sampling and self.mesh.dm is None and not exporting()

    def pass_graphs(self, key, refs=(), generators=(), make=None):
        """The PassGraphs (utils/graphs.py) of a sampling pass keyed by key
        and the ids of refs (what its graphs read beside the weights: a
        quant table, a net, a generator; kept alive by it), made at its
        first pass by make(refs) (a subclass's: pixel_transformer's
        DecodeGraphs), the PASS_GRAPHS_KEPT last used kept; generators: the
        ones its graphs draw from. None where the pass steps eagerly
        (graphed_sampling)."""
        if not self.graphed_sampling():
            return None
        make = make or (lambda refs: PassGraphs(self.device, generators, refs))
        return kept(self._pass_graphs, (key, *map(id, refs)), lambda: make(refs),
                    PASS_GRAPHS_KEPT)

    def graphed_pass(self, key, fn, *inputs):
        """fn(*inputs), a sampling pass without a loop (vae's, gan's), as
        one CUDA graph of the PassGraphs of key, the inputs its fixed
        buffers; eager where graphed_sampling says so."""
        graphs = self.pass_graphs(key)
        if graphs is None:
            return fn(*inputs)
        inputs = graphs.start(*inputs)
        return graphs('pass', lambda: fn(*inputs)).clone()  # not the graph's output

    def _draw(self, n, generator, quant=None):
        """n samples (n, H, W, 1) in SAMPLE_RANGE and nothing else."""
        return self.sample_from_draws(n, dists.draw(self.draw_spec(n), generator, self.device),
                                      quant=quant)

    def _serving_unit_range(self, x):
        """A batch in SAMPLE_RANGE mapped to the serving range [0, 1]."""
        lo, hi = self.SAMPLE_RANGE
        return x if (lo, hi) == (0.0, 1.0) else (x - lo) / (hi - lo)

    @torch.no_grad()
    def sample(self, n):
        """sample_fn's output from the model's own sampling stream (the same
        on every rank of a group)."""
        self.net.eval()
        with self.unsharded():
            return self.sample_fn(n, generator=self._sample_gen)

    @torch.no_grad()
    def sample_images(self, n, y=None):
        """n samples (n, H, W, 1) in SAMPLE_RANGE, for eval_heavy."""
        if y is not None:
            raise TypeError(f'{type(self).__name__}.sample takes no labels')
        self.net.eval()
        with self.unsharded():
            return self._draw(n, self._sample_gen)

    def serving_program(self, n, quant=None):
        """The ServingProgram of a pass of n: what the live server runs and
        serve.py --export writes."""
        return ServingProgram(self, n, quant)

    def pure_serving_fn(self, n, quant=None):
        """(seed[, y]) -> (n, H, W, 1) float32 numpy samples in [0, 1]: the
        draws of draw_spec(n) from torch.Generator(device).manual_seed(seed)
        (the same seed, and labels, give the same batch), then the serving
        program. quant: a QuantTable over quant_net() (serve.py
        --quantize), which every pass applies."""
        from generative_models_tpu_torch.serve import program_fn

        program = self.serving_program(n, quant)
        return program_fn(program.eval(), self.draw_spec(n), self.device, n,
                          program.class_cond, self.SERVE_DETERMINISTIC_CONVS)


class ServingProgram(nn.Module):
    """forward(*draws[, y]) -> (n, H, W, 1) in [0, 1]: one serving pass of
    model on the draws of model.draw_spec(n), and the labels y (n,) int32
    of a class-conditional model, mapped from SAMPLE_RANGE. The modules the
    pass reads are its submodules and the QuantTable's tensors its buffers,
    so torch.export bakes the weights (the EMA copy under --ema, the int8
    table under --quantize) into an artifact (serve.py export_serving)."""

    def __init__(self, model, n, quant=None):
        super().__init__()
        self.model, self.n, self.quant = model, n, quant
        self.class_cond = bool(model.G.get('class_cond', 0))
        self.nets = nn.ModuleList(model.serving_modules())
        if quant is not None:
            leaves = [t for v in (*quant.dense.values(), *quant.masked.values())
                      for t in torch.utils._pytree.tree_leaves(v)]
            for i, t in enumerate(leaves):
                self.register_buffer(f'quant{i}', t)

    def forward(self, *inputs):
        draws, y = (inputs[:-1], inputs[-1]) if self.class_cond else (inputs, None)
        out = self.model.sample_from_draws(self.n, draws, y, self.quant)
        return self.model._serving_unit_range(out)


class Autoreg(GM):
    """Autoregressive models: sample_fn(n, generator, uniforms, with_frames)
    returns samples in [0, 1], plus the sampling-process frames when
    asked."""

    is_autoreg = True  # enables eval/bits_per_dim logging in the harness

    def evaluate(self, writer, x, y, epoch):
        """25 samples -> 5x5 grid + the sampling-process GIF."""
        samples, frames = self.sample(25)
        write_grid(writer, 'samples', samples, epoch)
        write_gridvid(writer, 'sampling_process', frames, epoch, logdir=self.G.logdir)

    def draw_spec(self, n):
        return [('uniforms', self.uniform_shape(n), 'uniform')]

    def uniform_shape(self, n):
        """The shape of a pass's uniforms: sample_fn's, step t's in row t."""
        raise NotImplementedError

    def sample_from_draws(self, n, draws, y=None, quant=None):
        return self.sample_fn(n, uniforms=draws[0], with_frames=False, quant=quant)


class RasterAutoreg(Autoreg):
    """Autoregressive models whose sampler draws the side x side pixels in
    raster order, one a step, through decode_chain (rnn, wavenet and the
    pixel CNNs). side is 28, or 32 with --pad32."""

    def __init__(self, G):
        self.side = 32 if G.get('pad32', 0) else 28
        self.canvas_size = self.side * self.side
        super().__init__(G)

    def uniform_shape(self, n):
        return (self.canvas_size, n)

    def decode_chain(self, n, next_pixel, state=(), quant=None, graphs=None):
        """Run the T = canvas_size decode steps on a batch of n, one step a
        body of utils/loop.py fori_loop: step t computes the logits of
        pixel t (n,) and next_pixel(t, logits, state) returns the pixel (n,)
        that the chain reads from then on and the state; returns the last
        state. quant: a QuantTable over self.net. graphs: a PassGraphs,
        for the graphed form (fixed tensors in state): the first carry made
        in one graph, the steps in graphs of k (a device t, or a host t
        baked in where t moves views)."""
        raise NotImplementedError

    @torch.no_grad()
    def teacher_forced_logits(self, x, quant=None):
        """(B, T) logits of the decode chain fed the pixels of x (B, side,
        side, 1): what sampling computed at each position when it drew x."""
        flat = x.reshape(x.shape[0], self.canvas_size)

        def next_pixel(t, logit, logits):
            logits.append(logit)
            return flat[:, t], logits

        return torch.stack(self.decode_chain(x.shape[0], next_pixel, [], quant), 1)

    def sample_fn(self, n, generator=None, uniforms=None, with_frames=True, quant=None):
        """Raster-order sampling through decode_chain, pixel t set to u_t <
        sigmoid(logit_t). uniforms (T, n), the draws of step t in row t,
        replace the generator's; quant: a QuantTable over self.net. Returns
        the samples (n, side, side, 1) and, with with_frames, the (T, n,
        side, side, 1) canvas after each step (the pixels after t still
        0)."""
        T, side = self.canvas_size, self.side
        if uniforms is None:
            uniforms = torch.rand((T, n), generator=generator, device=self.device)
        graphs = self.pass_graphs(('raster', n), refs=(quant,))
        make = lambda: torch.empty((T, n), device=self.device)
        if graphs is None:
            pixels = make()
        else:
            (uniforms,) = graphs.start(uniforms)
            pixels = graphs.fixed('pixels', make)

        def next_pixel(t, logit, pixels):
            pixel = dists.Bernoulli(logits=logit).sample(uniforms=take(uniforms, t))
            return pixel, write(pixels, t, pixel)

        pixels = self.decode_chain(n, next_pixel, pixels, quant, graphs)
        flat = pixels.t() if graphs is None else pixels.t().clone()  # not the fixed buffer
        samples = flat.reshape(n, side, side, 1)
        if not with_frames:
            return samples
        tri = torch.ones((T, T), device=self.device).tril()
        return samples, (tri[:, None, :] * flat[None]).reshape(T, n, side, side, 1)


class Arbiter(GM):
    """Eval models (autoencoder, classifier): feature_fn(x) is what
    eval_heavy scores samples with. save writes model.jit.pt in the JAX
    package's payload format, a pickle of {'class_name', 'G' (Paths as
    str), 'params' (flax-layout params as flax msgpack bytes)}, so either
    package's arbiters.load_arbiter reads the other's files."""

    is_arbiter = True

    def feature_fn(self, x):
        """NHWC images -> (N, features)."""
        raise NotImplementedError

    def save(self, path, tag=''):
        import pickle

        from generative_models_tpu_torch.convert import arbiter_params_to_jax
        from generative_models_tpu_torch.utils import msgpack

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        suffix = f'_{tag}' if tag else ''
        name = type(self).__name__
        params = arbiter_params_to_jax(self.net_state(), name)
        if not self.mesh.is_main:
            return
        payload = {
            'class_name': name,
            'G': {k: str(v) if isinstance(v, Path) else v for k, v in self.G.items()},
            'params': msgpack.encode(params),
        }
        with open(path / f'model{suffix}.jit.pt', 'wb') as f:
            pickle.dump(payload, f)
