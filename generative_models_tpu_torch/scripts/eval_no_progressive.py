"""Re-evaluate one diffusion checkpoint at every step count of the chain,
256 down to 1, with no distillation (the JAX system's
scripts/eval_no_progressive.sh):

    python3 -m generative_models_tpu_torch.scripts.eval_no_progressive \\
        <logdir-with-model.pt> [--flag=value ...]

Each step count logs under <logdir>/eval_<steps>.
"""

from generative_models_tpu_torch.scripts import cli_argv, run_stages, split_args

STEPS = (256, 128, 64, 32, 16, 8, 4, 2, 1)
USAGE = 'usage: eval_no_progressive <logdir-with-model.pt> [--flag=value ...]'


def commands(argv=(), env=None):
    pos, extra = split_args(argv)
    if not pos or not pos[0]:
        raise SystemExit(USAGE)
    weights = pos[0]
    return [['--model=diffusion_model', f'--weights_from={weights}/model.pt',
             f'--timesteps={steps}', '--skip_training=1', '--epochs=0', '--eval_heavy=1',
             f'--logdir={weights}/eval_{steps}', *extra] for steps in STEPS]


def main(argv=None, env=None):
    return run_stages(commands(cli_argv(argv), env))


if __name__ == '__main__':
    main()
