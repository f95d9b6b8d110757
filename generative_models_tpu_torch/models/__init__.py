# importing a model module runs its @register
from generative_models_tpu_torch.models import made, pixel_transformer, vqvae  # noqa: F401
