"""Distribution heads: a single dense layer producing Bernoulli or
Categorical logits. Counterpart of generative_models_tpu/models/heads.py;
torch needs the input width that flax infers."""

from torch import nn

from generative_models_tpu_torch.ops.common import dense
from generative_models_tpu_torch.utils import dists


class BinaryHead(nn.Module):
    def __init__(self, in_features, out_n):
        super().__init__()
        self.dense = nn.Linear(in_features, out_n)

    def forward(self, x):
        return dists.Bernoulli(logits=dense(x, self.dense))


class CategoricalHead(nn.Module):
    def __init__(self, in_features, out_n):
        super().__init__()
        self.dense = nn.Linear(in_features, out_n)

    def forward(self, x):
        return dists.Categorical(logits=dense(x, self.dense))
