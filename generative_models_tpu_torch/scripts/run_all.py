"""Train every model of the registry for EPOCHS epochs, one after another
(the JAX system's run_all.sh):

    python3 -m generative_models_tpu_torch.scripts.run_all [EPOCHS] [--flag=value ...]

EPOCHS defaults to 10; each model logs under logs/run_all/<model>.
"""

from generative_models_tpu_torch.scripts import cli_argv, run_stages, split_args

MODELS = ('made', 'rnn', 'wavenet', 'pixel_cnn', 'gated_pixel_cnn', 'pixel_transformer',
          'vae', 'vqvae', 'gan', 'diffusion_model', 'autoencoder', 'classifier')


def commands(argv=(), env=None):
    pos, extra = split_args(argv)
    epochs = pos[0] if pos and pos[0] else '10'
    return [[f'--model={m}', f'--epochs={epochs}', f'--logdir=logs/run_all/{m}', *extra]
            for m in MODELS]


def main(argv=None, env=None):
    return run_stages(commands(cli_argv(argv), env))


if __name__ == '__main__':
    main()
