"""Config system: AttrDict + per-model DG defaults + two-phase argparse +
hps.yaml round-trip.

Counterpart of generative_models_tpu/utils/config.py, with the same global
keys so an hps.yaml written by either package is read by the other. PyYAML is
imported only where hps.yaml is read or written.

Differences: --device defaults to 'cuda' (see ops/common.resolve_device).
check_ported refuses two things by name: --ckpt=orbax (the card has no
orbax; model.pt holds the full train state) and a --mesh axis no package
has. Every other flag runs: --mesh takes the data, model, seq, pipe and
expert axes (parallel/mesh.py: seq:N on one card without a process
group, the others over ranks under torchrun; a model without ring
attention replicates over seq, as the JAX package's GSPMD does), and
--fsdp=1 shards over the data axis under a group.
--jit_epoch=1 (the default) trains each epoch as CUDA graphs on the card,
one a batch shape and micro-step kind, replayed step after step
(utils/graphs.py; eager under a process group, and on the CPU the same
step uncaptured); 0 is the per-step loop. pixel_transformer's
--decode_unroll=k runs each k decode steps of a sampling pass as one graph
(0: the per-step loop). Every other sampler (diffusion's chains, made,
vqvae's prior and decoder, rnn, wavenet, the pixel CNNs, vae, gan) runs
each pass as CUDA graphs on the card without a flag, as the JAX package
jits it (models/base.py pass_graphs; eager under a process group, under
torch.export and for diffusion's history chains; the per-step loop is the
model's graph_sampling = False, for comparison). All are bitwise their
eager forms.
--compile_cache is accepted with no effect: graphs are captured in the
process and not kept, and the kernels build once into the ignored build
directory (ops/common.py).
"""

import argparse
import sys
from pathlib import Path


class AttrDict(dict):
    """dict with attribute access."""

    __setattr__ = dict.__setitem__
    __getattr__ = dict.__getitem__


def prefix_dict(name, d):
    return {name + key: d[key] for key in d}


def args_type(default):
    """Coerce CLI strings like the reference: bools parse 'False'/'True',
    ints promote to float when the string looks float-y, Paths
    expanduser."""
    if isinstance(default, bool):
        return lambda x: bool(['False', 'True'].index(x))
    if isinstance(default, int):
        return lambda x: float(x) if ('e' in x or '.' in x) else int(x)
    if isinstance(default, Path):
        return lambda x: Path(x).expanduser()
    return type(default)


def global_defaults():
    """Global default config: the JAX package's keys, so hps.yaml
    round-trips. compile_cache, which only the JAX harness reads, is kept
    for that round-trip."""
    DG = AttrDict()
    DG.model = 'vae'
    DG.bs = 64
    DG.hidden_size = 256
    DG.device = 'cuda'  # 'cuda' | 'cuda:i' | 'cpu'; no silent CPU fallback
    DG.epochs = 50
    DG.save_n = 5
    DG.logdir = Path('./logs/')
    DG.lr = 3e-4
    DG.class_cond = 0
    DG.binarize = 1
    DG.pad32 = 0
    DG.mode = 'train'
    DG.weights_from = Path('.')
    DG.autoencoder = Path('./weights/autoencoder.pt')
    DG.classifier = Path('./weights/classifier.pt')
    DG.eval_heavy = 0
    DG.skip_training = 0
    DG.seed = 0
    DG.jit_epoch = 1
    DG.data_source = 'auto'
    DG.data_dir = Path('./data/')
    DG.mesh = ''
    DG.profile = 0
    DG.lr_scheduler = 'none'
    DG.grad_clip = 0.0
    DG.grad_accum = 1
    DG.warmup_steps = 0
    DG.lr_decay_steps = 0
    DG.fsdp = 0
    DG.remat = 0
    DG.stream_data = 0
    DG.prefetch_depth = 2
    DG.stream_chunk = 1
    DG.ckpt = 'flax'
    DG.compile_cache = ''
    DG.nan_guard = 1
    DG.keep_best = ''
    DG.resume = 0
    return DG


def check_ported(G):
    """Refuse what the port does not implement, by name: an axis no
    package has, and --ckpt=orbax. --jit_epoch and --decode_unroll run (as
    CUDA graphs on the card, as every sampler does); --compile_cache has no
    effect."""
    mesh = str(G.get('mesh', '') or '')
    if mesh:
        from generative_models_tpu_torch.parallel.mesh import AXES, parse_mesh_spec

        for a, _ in parse_mesh_spec(mesh):
            if a not in AXES:
                raise ValueError(f'--mesh={mesh}: unknown axis {a}; the axes are {AXES}')
    if G.get('ckpt', 'flax') != 'flax':
        # the card's machine has no orbax: model.pt (the port's, or a JAX
        # package's flax msgpack) holds the full train state
        raise NotImplementedError(
            f'--ckpt={G.ckpt} is not ported yet to generative_models_tpu_torch '
            '(model.pt holds the full train state)'
        )


def parse_args(argv=None, discover_models=None, DG=None):
    """Two-phase CLI parse. Phase 1 parses the global defaults to learn
    --model / --weights_from; phase 2 adds the model's DG (or the hps.yaml
    of the weights_from run) and re-parses everything. Returns (G, Model)."""
    if argv is None:
        argv = sys.argv[1:]
    if DG is None:
        DG = global_defaults()
    if discover_models is None:
        from generative_models_tpu_torch.utils.registry import discover_models
    parser = argparse.ArgumentParser()
    for key, value in DG.items():
        parser.add_argument(f'--{key}', type=args_type(value), default=value)
    tempG, _ = parser.parse_known_args(argv)

    defaults = {}
    if tempG.weights_from != Path('.'):
        import yaml

        loaded_hp_file = Path(tempG.weights_from).parent / 'hps.yaml'
        with open(loaded_hp_file) as f:
            loadedG = AttrDict(yaml.load(f, Loader=yaml.Loader))
        for key, value in loadedG.items():
            defaults[key] = value
            if key not in tempG:
                parser.add_argument(f'--{key}', type=args_type(value), default=value)
        Model = discover_models()[loadedG.model]
        # DG keys the model gained after this checkpoint was written
        for key, value in Model.DG.items():
            if key not in loadedG and key not in tempG:
                defaults[key] = value
                parser.add_argument(f'--{key}', type=args_type(value), default=value)
    else:
        Model = discover_models()[tempG.model]
        for key, value in Model.DG.items():
            defaults[key] = value
            if key not in tempG:
                parser.add_argument(f'--{key}', type=args_type(value), default=value)
        defaults['logdir'] = Path(tempG.logdir) / tempG.model

    defaults.pop('full_cmd', None)
    defaults.pop('commit_hash', None)
    parser.set_defaults(**defaults)
    G = AttrDict(parser.parse_args(argv).__dict__)
    check_ported(G)
    return G, Model


def dump_hps(G, logdir=None):
    """Write hps.yaml so runs can be reloaded with --weights_from."""
    import yaml

    logdir = Path(logdir or G.logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    dumpable = {k: str(v) if isinstance(v, Path) else v for k, v in G.items()}
    with open(logdir / 'hps.yaml', 'w') as f:
        yaml.dump(dumpable, f, width=float('inf'))
