from generative_models_tpu_torch.data.mnist import Dataset, load_mnist  # noqa: F401
