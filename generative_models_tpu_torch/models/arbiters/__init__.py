"""Arbiters: eval-only models. Counterpart of
generative_models_tpu/models/arbiters/__init__.py: load_arbiter reads a
model.jit.pt written by either package's Arbiter.save (a pickle of the
class name, its config and flax msgpack params; utils/msgpack.py decodes
them without flax) and returns a handle on the harness's device."""

import pickle
from pathlib import Path

import torch

from generative_models_tpu_torch.models.arbiters.autoencoder import AENet, Autoencoder  # noqa: F401
from generative_models_tpu_torch.models.arbiters.classifier import Classifier  # noqa: F401


class ArbiterHandle:
    """apply(x): the arbiter's features (the autoencoder's z, the
    classifier's logits) of NHWC images, under torch.no_grad() on the
    arbiter's device."""

    def __init__(self, model):
        self.model = model
        self.device = model.device

    @torch.no_grad()
    def apply(self, x):
        self.model.net.eval()
        return self.model.feature_fn(torch.as_tensor(x, dtype=torch.float32).to(self.device))


def load_arbiter(path, device='cuda'):
    """path: a model.jit.pt, or the directory holding one. The class comes
    from the registry by the payload's class name, built from the port's
    defaults overridden by the payload's G where the port knows the key
    (the shipped files' G carries device 'tpu', logdir, mesh, full_cmd);
    the device is the caller's."""
    from generative_models_tpu_torch.convert import arbiter_params_from_jax
    from generative_models_tpu_torch.utils import msgpack
    from generative_models_tpu_torch.utils.config import AttrDict, global_defaults
    from generative_models_tpu_torch.utils.registry import (
        convert_camel_to_snake, discover_models,
    )

    path = Path(path)
    if path.is_dir():
        path = path / 'model.jit.pt'
    with open(path, 'rb') as f:
        payload = pickle.load(f)
    name = payload['class_name']
    Model = discover_models()[convert_camel_to_snake(name)]
    G = AttrDict(global_defaults(), **Model.DG)
    G.update({k: v for k, v in payload['G'].items() if k in G and k != 'device'})
    G.device = str(device)
    model = Model(G)
    tree = msgpack.decode(payload['params'])
    model.net.load_state_dict(arbiter_params_from_jax(tree, name))
    return ArbiterHandle(model)
