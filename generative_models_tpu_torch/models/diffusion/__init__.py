from generative_models_tpu_torch.models.diffusion.gaussian_diffusion import GaussianDiffusion  # noqa: F401
from generative_models_tpu_torch.models.diffusion.model import DiffusionModel  # noqa: F401
from generative_models_tpu_torch.models.diffusion.unet import SimpleUnet  # noqa: F401
