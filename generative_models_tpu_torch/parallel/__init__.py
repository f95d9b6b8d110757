"""Parallelism. Counterpart of generative_models_tpu/parallel/: the mesh
spec and its axis names (mesh.py) and ring attention (ring_attention.py).
The data, model, pipe and expert axes are not ported yet."""

from generative_models_tpu_torch.parallel.mesh import (
    DATA_AXIS, SEQ_AXIS, parse_mesh_spec, ring_size, seq_size,
)
