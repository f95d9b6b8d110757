"""Heavy-eval every stage of a finished progressive-distillation chain
(the JAX system's scripts/eval_distill_chain.sh): each stage that has a
model.pt is reloaded with --epochs=0 --eval_heavy=1, so FID, precision,
recall and the cond_* metrics land in the stage's event file, for
collect_distill:

    LOGROOT=logs/distillation python3 -m \\
        generative_models_tpu_torch.scripts.eval_distill_chain [--flag=value ...]

As in the JAX package, the reload writes the stage's model.pt and
hps.yaml anew, and a student reloaded by --weights_from drops its
cond_w_embed and samples as a guided model (models/diffusion/model.py
fit_checkpoint).
"""

from pathlib import Path

from generative_models_tpu_torch.scripts import (
    CHAIN_STAGES, DEFAULT_LOGROOT, cli_argv, env_or, run_stages,
)


def commands(argv=(), env=None):
    root = env_or(env, 'LOGROOT', DEFAULT_LOGROOT)
    return [[f'--weights_from={root}/{stage}/model.pt', f'--logdir={root}/{stage}',
             '--epochs=0', '--eval_heavy=1', *argv]
            for stage in CHAIN_STAGES if Path(root, stage, 'model.pt').is_file()]


def main(argv=None, env=None):
    return run_stages(commands(cli_argv(argv), env), label='eval_heavy: ')


if __name__ == '__main__':
    main()
