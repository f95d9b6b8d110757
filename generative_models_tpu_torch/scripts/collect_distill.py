"""Collect the progressive-distillation chain's stages into one JSON (the
JAX system's scripts/collect_distill.py): for each stage under LOGROOT, in
chain order (teacher, step1, step2_<steps>...), the last logged value of
each of KEYS from its TensorBoard event files, and timesteps and epochs
from its hps.yaml (the last run's: after eval_distill_chain, epochs is
that run's 0, as in the JAX package):

    python3 -m generative_models_tpu_torch.scripts.collect_distill [LOGROOT] [OUT.json]

LOGROOT defaults to $LOGROOT, else logs/distillation; OUT.json to
LOGROOT/DISTILL.json. A LOGROOT with no stage is refused, and nothing is
written.
"""

import json
from pathlib import Path

from generative_models_tpu_torch.scripts import (
    CHAIN_STAGES, DEFAULT_LOGROOT, cli_argv, env_or,
)

KEYS = [
    'eval/fid', 'eval/ignite_fid', 'eval/precision', 'eval/recall',
    'eval/f1', 'diffusion_model/test/loss', 'dt/eval', 'dt/train',
]


def paths(argv=(), env=None):
    """(LOGROOT, the JSON's path) from the positional arguments."""
    root = Path(argv[0] if argv else env_or(env, 'LOGROOT', DEFAULT_LOGROOT))
    return root, Path(argv[1]) if len(argv) > 1 else root / 'DISTILL.json'


def stage_metrics(logdir):
    """{key: its last logged value} of KEYS in logdir's event files."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir), size_guidance={'scalars': 0})
    acc.Reload()
    tags = acc.Tags().get('scalars', [])
    return {key: acc.Scalars(key)[-1].value for key in KEYS
            if key in tags and acc.Scalars(key)}


def main(argv=None, env=None):
    import yaml

    root, out_path = paths(cli_argv(argv), env)
    result = {'logroot': str(root), 'stages': {}}
    for stage in CHAIN_STAGES:
        d = root / stage
        if not (d / 'hps.yaml').exists():
            continue
        hps = yaml.safe_load((d / 'hps.yaml').read_text())
        m = stage_metrics(d)
        m['timesteps'] = hps.get('timesteps')
        m['epochs'] = hps.get('epochs')
        result['stages'][stage] = m
        print(stage, json.dumps(m))
    if not result['stages']:
        # never clobber a written record with an empty chain (a LOGROOT
        # typo, or a chain not trained yet)
        raise SystemExit(f'no chain stages found under {root}: refusing to write {out_path}')
    out_path.write_text(json.dumps(result, indent=1))
    print('wrote', out_path)
    return result


if __name__ == '__main__':
    main()
