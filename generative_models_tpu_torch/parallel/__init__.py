"""Parallelism. Counterpart of generative_models_tpu/parallel/: the mesh
over a process group's ranks, its axes and collectives (mesh.py) and ring
attention (ring_attention.py). The pipe and expert axes are not ported
yet."""

from generative_models_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, get_mesh, parse_mesh_spec, ring_size, seq_size,
    set_mesh,
)
