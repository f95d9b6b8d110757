# importing a model module runs its @register
from generative_models_tpu_torch.models import pixel_transformer  # noqa: F401
