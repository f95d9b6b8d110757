# importing a model module runs its @register
from generative_models_tpu_torch.models import diffusion, made, pixel_transformer, vqvae  # noqa: F401
