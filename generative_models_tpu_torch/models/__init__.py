# importing a model module runs its @register
from generative_models_tpu_torch.models import (  # noqa: F401
    arbiters, diffusion, gan, gated_pixel_cnn, made, pixel_cnn, pixel_transformer, rnn, vae,
    vqvae, wavenet,
)
