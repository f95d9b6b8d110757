"""The orchestration layer of the port: the JAX system's run_all.sh,
scripts/train_arbiters.sh, progressive_distillation.sh,
eval_distill_chain.sh and eval_no_progressive.sh, and its two Python
tools collect_distill.py and distill_latency.py, one module each:

    python3 -m generative_models_tpu_torch.scripts.<name> [args] [--flag=value ...]

A shell script's module has commands(argv, env) -> the argv of each
generative_models_tpu_torch.main run, in order, with the script's stages
and flags, and main(argv=None, env=None), which runs them one after
another in this process (run_stages) and stops at the first exception, as
set -e does. The environment variables are the scripts' own (LOGROOT,
EPOCHS, EPOCHS_TEACHER, EPOCHS_STUDENT), with their defaults; an empty
one takes the default, as ${VAR:-default}.

One deviation: flags after the script's own arguments go to every stage,
after the script's own flags (of the JAX scripts only train_arbiters.sh
passes "$@" on), so that --device=cpu or a small width reaches each
stage.
"""

import os
import sys
from pathlib import Path

# the progressive-distillation chain: a 256-step teacher, a step1 student
# at 256 steps, then step2 students halving the steps down to one
STEP2_STEPS = (128, 64, 32, 16, 8, 4, 2, 1)
CHAIN_STAGES = ('teacher', 'step1') + tuple(f'step2_{n}' for n in STEP2_STEPS)
DEFAULT_LOGROOT = 'logs/distillation'


def env_or(env, key, default):
    """${key:-default} of env (os.environ when None)."""
    env = os.environ if env is None else env
    return env.get(key) or default


def split_args(argv):
    """(the leading positional arguments, the flags from the first one
    that starts with '--' on)."""
    argv = list(argv)
    n = next((i for i, a in enumerate(argv) if a.startswith('--')), len(argv))
    return argv[:n], argv[n:]


def cli_argv(argv):
    return sys.argv[1:] if argv is None else list(argv)


def flag_value(argv, name):
    """The value of --name=value in argv (the last one), or None."""
    vals = [a.split('=', 1)[1] for a in argv if a.startswith(f'--{name}=')]
    return vals[-1] if vals else None


def run_stages(argvs, label=''):
    """Run generative_models_tpu_torch.main.main on each argv in turn, in
    this process, printing '=== <label><stage> ===' first (stage: the
    --logdir's last part); the first exception ends the run. Returns each
    run's history."""
    from generative_models_tpu_torch.main import main as train_main

    histories = []
    for argv in argvs:
        print(f'=== {label}{Path(flag_value(argv, "logdir") or ".").name} ===', flush=True)
        histories.append(train_main(list(argv)))
    return histories
