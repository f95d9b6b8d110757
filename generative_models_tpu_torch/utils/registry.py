"""Model registry: @register adds a model under its snake-cased class name,
the same names as generative_models_tpu/utils/registry.py. Only the models
this port has are registered; asking for one of the JAX package's others
raises a clear 'not ported yet'."""

import re

_REGISTRY = {}

# the names the JAX package registers that are not ported yet
JAX_MODELS = ('rnn', 'wavenet', 'pixel_cnn', 'gated_pixel_cnn')


def convert_camel_to_snake(name):
    s1 = re.sub('(.)([A-Z][a-z]+)', r'\1_\2', name)
    return re.sub('([a-z0-9])([A-Z])', r'\1_\2', s1).lower()


def register(cls=None, *, name=None):
    """Class decorator: add a GM subclass to the registry under its
    snake-cased class name."""

    def wrap(c):
        _REGISTRY[name or convert_camel_to_snake(c.__name__)] = c
        return c

    return wrap if cls is None else wrap(cls)


class _Models(dict):
    def __missing__(self, key):
        if key in JAX_MODELS:
            raise NotImplementedError(
                f'model {key!r} is not ported yet to generative_models_tpu_torch '
                f'(ported: {sorted(self)})'
            )
        raise KeyError(key)


def discover_models():
    """{snake_name: ModelClass} of the ported models."""
    import generative_models_tpu_torch.models  # noqa: F401  (runs @register)

    return _Models(_REGISTRY)
