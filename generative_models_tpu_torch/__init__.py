"""PyTorch/CUDA port of generative_models_tpu for one NVIDIA H100.

The JAX package beside this one is the reference; this package mirrors its
module names so each counterpart is easy to find. It imports torch and never
jax, flax, or anything of generative_models_tpu. Every Pallas kernel on a
ported path has a hand-written CUDA kernel under ops/csrc/, built at first
use into build/torch_kernels/.

Ported so far: pixel_transformer inference (KV-cached serving through
serve.py and the scoring forward through models/base.py eval_loss).
"""
