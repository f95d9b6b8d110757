# importing a model module runs its @register
from generative_models_tpu_torch.models import (  # noqa: F401
    arbiters, diffusion, gan, made, pixel_transformer, vae, vqvae,
)
