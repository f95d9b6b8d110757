"""Parallelism. Counterpart of generative_models_tpu/parallel/: the mesh
over a process group's ranks, its axes and collectives (mesh.py), the
GPipe schedule over the pipe axis (pipeline.py) and ring attention
(ring_attention.py)."""

from generative_models_tpu_torch.parallel.mesh import (
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh, get_mesh, parse_mesh_spec,
    ring_size, seq_size, set_mesh,
)
