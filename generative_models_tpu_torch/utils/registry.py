"""Model registry: @register adds a model under its snake-cased class name,
the same names as generative_models_tpu/utils/registry.py: every model the
JAX package registers is registered here too."""

import re

_REGISTRY = {}


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


def discover_models():
    """{snake_name: ModelClass} of every model."""
    import generative_models_tpu_torch.models  # noqa: F401  (runs @register)

    return dict(_REGISTRY)
