"""The progressive-distillation chain (the JAX system's
scripts/progressive_distillation.sh): a 256-step teacher, then a step1
student (classifier-free guidance baked into a student conditioned on the
guidance weight w), then step2 students, each taught by the stage before
it, halving the step count from 128 down to 1:

    LOGROOT=logs/distillation EPOCHS_TEACHER=20 EPOCHS_STUDENT=5 python3 -m \\
        generative_models_tpu_torch.scripts.progressive_distillation [--flag=value ...]

Each stage logs under $LOGROOT/<stage> (teacher, step1, step2_<steps>).
"""

from generative_models_tpu_torch.scripts import (
    DEFAULT_LOGROOT, STEP2_STEPS, cli_argv, env_or, run_stages,
)

MODEL = '--model=diffusion_model'


def commands(argv=(), env=None):
    root = env_or(env, 'LOGROOT', DEFAULT_LOGROOT)
    teacher_epochs = env_or(env, 'EPOCHS_TEACHER', '20')
    epochs = env_or(env, 'EPOCHS_STUDENT', '5')
    out = [
        [MODEL, '--timesteps=256', f'--epochs={teacher_epochs}', f'--logdir={root}/teacher',
         *argv],
        [MODEL, '--timesteps=256', f'--epochs={epochs}', f'--teacher_path={root}/teacher/model.pt',
         '--teacher_mode=step1', '--lr=3e-4', f'--logdir={root}/step1', *argv],
    ]
    prev = f'{root}/step1'
    for steps in STEP2_STEPS:
        out.append([MODEL, f'--timesteps={steps}', f'--epochs={epochs}',
                    f'--teacher_path={prev}/model.pt', '--teacher_mode=step2', '--lr=1e-4',
                    f'--logdir={root}/step2_{steps}', *argv])
        prev = f'{root}/step2_{steps}'
    return out


def main(argv=None, env=None):
    return run_stages(commands(cli_argv(argv), env))


if __name__ == '__main__':
    main()
