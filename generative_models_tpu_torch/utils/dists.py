"""Minimal distribution library: Bernoulli / Normal / independent
Categorical, with numerically stable log_probs. Counterpart of
generative_models_tpu/utils/dists.py.

Sampling takes either a torch.Generator or the random numbers themselves
(uniforms / noise), so a test can hand both packages the same draws.

Bernoulli and Categorical, a net's outputs, are dataclasses of their
logits and pytree nodes of them: what walks a forward's outputs for their
tensors finds them there, by either walk (FSDP2, --fsdp=1, hooks its
backward on a root's outputs: torch 2.13 walks dataclasses, earlier
versions pytrees).
"""

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(init=False)
class Bernoulli:
    logits: torch.Tensor

    def __init__(self, logits=None, probs=None):
        if logits is None:
            eps = 1e-7
            p = probs.clamp(eps, 1 - eps)
            logits = torch.log(p) - torch.log1p(-p)
        self.logits = logits

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    def log_prob(self, x):
        l = self.logits
        return x * F.logsigmoid(l) + (1.0 - x) * F.logsigmoid(-l)

    def sample(self, generator=None, uniforms=None):
        """1 where uniform < sigmoid(logits): the JAX package's comparison,
        so the same uniforms give the same tokens."""
        if uniforms is None:
            uniforms = torch.rand(
                self.logits.shape, generator=generator, device=self.logits.device
            )
        return (uniforms < self.probs).to(self.logits.dtype)

    def mode(self):
        return (self.logits > 0).to(self.logits.dtype)


class Normal:
    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def log_prob(self, x):
        var = torch.as_tensor(self.scale) ** 2
        return -0.5 * (
            math.log(2 * math.pi) + torch.log(var) + (x - self.loc) ** 2 / var
        )

    def sample(self, generator=None, noise=None):
        if noise is None:
            shape = torch.broadcast_shapes(
                torch.as_tensor(self.loc).shape, torch.as_tensor(self.scale).shape
            )
            device = torch.as_tensor(self.loc).device
            noise = torch.randn(shape, generator=generator, device=device)
        return self.loc + self.scale * noise

    rsample = sample  # reparameterized by construction


def normal_kl(p_loc, p_scale, q_loc=0.0, q_scale=1.0):
    """KL(N(p) || N(q)) elementwise."""
    var_ratio = (p_scale / q_scale) ** 2
    t1 = ((p_loc - q_loc) / q_scale) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


@dataclasses.dataclass(init=False)
class Categorical:
    """Independent categorical over the last axis; log_prob of a one-hot x is
    the multinomial(total_count=1) log-pmf."""

    logits: torch.Tensor

    def __init__(self, logits):
        self.logits = logits

    def log_prob(self, one_hot_x):
        return torch.sum(one_hot_x * F.log_softmax(self.logits, dim=-1), dim=-1)

    def sample_index(self, generator=None, uniforms=None):
        """Gumbel-max draw from uniforms of the logits' shape."""
        if uniforms is None:
            uniforms = torch.rand(
                self.logits.shape, generator=generator, device=self.logits.device
            )
        tiny = torch.finfo(uniforms.dtype).tiny
        gumbel = -torch.log(-torch.log(uniforms.clamp_min(tiny)))
        return torch.argmax(self.logits + gumbel, dim=-1)

    def sample(self, generator=None, uniforms=None):
        idx = self.sample_index(generator, uniforms)
        return F.one_hot(idx, self.logits.shape[-1]).to(self.logits.dtype)


for _cls in (Bernoulli, Categorical):
    torch.utils._pytree.register_pytree_node(
        _cls, lambda d: ([d.logits], None), lambda xs, _, cls=_cls: cls(logits=xs[0]))



def draw(spec, generator, device):
    """The draws of a spec [(name, shape, kind)], in its order, from
    generator: torch.rand for kind 'uniform', torch.randn for 'normal',
    float32 on device (a serving pass's, models/base.py draw_spec)."""
    make = {'uniform': torch.rand, 'normal': torch.randn}
    return tuple(make[kind](tuple(shape), generator=generator, device=device)
                 for _, shape, kind in spec)


def batch_draw(fn, shape, generator, device):
    """fn(shape, generator=, device=) (torch.rand, torch.randn, ...) for a
    batch of shape[0] rows on this rank. Under a process group with a data
    axis every rank draws the global batch's (shape[0] times the axis's
    size) from its generator, the same on every rank, and keeps its rows:
    a data:N run draws what one process does (parallel/mesh.py)."""
    from generative_models_tpu_torch.parallel.mesh import DATA_AXIS, data_slice, get_mesh

    mesh = get_mesh()
    d = mesh.size(DATA_AXIS) if mesh.dm is not None else 1
    if d == 1:
        return fn(tuple(shape), generator=generator, device=device)
    n = shape[0] * d
    return fn((n, *shape[1:]), generator=generator, device=device)[data_slice(n)]
