"""The --mesh spec. Counterpart of generative_models_tpu/parallel/mesh.py's
parse_mesh_spec and axis names (the JAX package builds a jax.sharding.Mesh
from them; the port has no mesh object).

The one-card rule, a recorded deviation (ROADMAP.md, queue 3): JAX's
parse_mesh_spec asserts that the mesh's product equals the device count,
one device a ring position. The port runs --mesh=seq:N without that: with
no process group, parallel/ring_attention.py runs all N ring positions on
one card, the rotation an index; given a torch.distributed group of N
ranks, one position a rank, the rotation point-to-point sends. The numbers
are the ring's either way. Sharding the batch and the parameters over ranks
(the data, model, pipe and expert axes) is not ported yet: utils/config.py
refuses a spec with any of them above size 1, and a model whose class does
not set supports_ring refuses a seq axis above 1 (models/base.py).
"""

DATA_AXIS = 'data'
SEQ_AXIS = 'seq'


def parse_mesh_spec(spec):
    """'data:4,seq:2' -> (('data', 4), ('seq', 2)); '' -> ('data', 1). No
    device count is matched (the one-card rule)."""
    if not spec:
        return ((DATA_AXIS, 1),)
    axes = []
    for part in spec.split(','):
        name, size = part.split(':')
        if int(size) < 1:
            raise ValueError(f'mesh {spec}: axis {name.strip()} has size {size}')
        axes.append((name.strip(), int(size)))
    return tuple(axes)


def seq_size(spec):
    """The seq axis's size under --mesh=spec (1 when it has none)."""
    return dict(parse_mesh_spec(spec)).get(SEQ_AXIS, 1)


def ring_size(spec, block_size):
    """Ring positions for a sequence of block_size under --mesh=spec: the
    seq axis's size N when N > 1 divides block_size (the JAX package's
    use_ring, models/pixel_transformer.py:476-480), else 1: the normal
    path, seq:1 and an N that does not divide included."""
    n = seq_size(spec)
    return n if n > 1 and block_size % n == 0 else 1
