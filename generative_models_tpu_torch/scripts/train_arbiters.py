"""Train the eval arbiters, autoencoder then classifier, and install each
model.jit.pt as WEIGHTS_DIR/autoencoder.pt and WEIGHTS_DIR/classifier.pt
(the JAX system's scripts/train_arbiters.sh):

    EPOCHS=10 LOGROOT=logs/arbiters python3 -m \\
        generative_models_tpu_torch.scripts.train_arbiters [--flag=value ...]

WEIGHTS_DIR defaults to $LOGROOT/weights, not weights/: the shipped
weights/autoencoder.pt and classifier.pt are read by both packages, so
they are replaced only where WEIGHTS_DIR names that directory. The last
line printed is the --autoencoder and --classifier flags that select the
new files.
"""

import shutil
from pathlib import Path

from generative_models_tpu_torch.scripts import cli_argv, env_or, run_stages

ARBITERS = ('autoencoder', 'classifier')


def logroot(env=None):
    return env_or(env, 'LOGROOT', 'logs/arbiters')


def commands(argv=(), env=None):
    epochs = env_or(env, 'EPOCHS', '10')
    return [[f'--model={name}', f'--epochs={epochs}', f'--logdir={logroot(env)}/{name}', *argv]
            for name in ARBITERS]


def main(argv=None, env=None):
    """Train and install both arbiters; returns (each run's history, the
    flags that select the installed files)."""
    histories = run_stages(commands(cli_argv(argv), env))
    weights = Path(env_or(env, 'WEIGHTS_DIR', f'{logroot(env)}/weights'))
    weights.mkdir(parents=True, exist_ok=True)
    for name in ARBITERS:
        shutil.copyfile(Path(logroot(env), name, 'model.jit.pt'), weights / f'{name}.pt')
    flags = [f'--{name}={weights / f"{name}.pt"}' for name in ARBITERS]
    print(f'installed {weights}/autoencoder.pt and {weights}/classifier.pt')
    print(' '.join(flags), flush=True)
    return histories, flags


if __name__ == '__main__':
    main()
