from generative_models_tpu_torch.utils.config import AttrDict  # noqa: F401
from generative_models_tpu_torch.utils.registry import (  # noqa: F401
    discover_models,
    register,
)
