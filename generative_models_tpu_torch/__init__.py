"""PyTorch/CUDA port of generative_models_tpu for one NVIDIA H100.

The JAX package beside this one is the reference; this package mirrors its
module names so each counterpart is easy to find. It imports torch and never
jax, flax, or anything of generative_models_tpu. Every Pallas kernel on a
ported path has a hand-written CUDA kernel under ops/csrc/, built at first
use into build/torch_kernels/.

Ported so far: pixel_transformer inference (KV-cached serving through
serve.py, the scoring forward through models/base.py eval_loss) and
training (main.py: Adam with the trainer knobs, the data pipeline, the
logger, checkpoints), with the flash-attention backward on the card; and
vqvae training, eval and serving (models/vqvae.py: the codebook search
kernel, the joint AE and transformer-prior step with two optimizers); made;
diffusion_model (models/diffusion/: the UNet, the samplers, --ema,
distillation, class-conditional serving); vae and gan (models/vae.py,
models/gan.py); and the arbiters (models/arbiters/: the autoencoder and the
classifier, whose files either package reads and writes through
utils/msgpack.py) with main.py's --eval_heavy (FID, precision, recall and
the conditional metrics, utils/metrics.py). Diffusion, vae, gan and the
arbiters run no kernel of ops/. serve.py --export writes any model's
serving program as a torch.export artifact (the serving kernels are
torch.library ops, the sampling loops utils/loop.py's), which
--from_export serves with no model code.
"""
