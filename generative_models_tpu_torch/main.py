"""Training harness / CLI. Counterpart of generative_models_tpu/main.py:

    python -m generative_models_tpu_torch.main --model=<name> [--flag=val ...]

Same two-phase flag parsing, same epoch structure (eval first, evaluate,
save every --save_n, train, a final eval after the last epoch), same logger
keys (eval/nlogp, eval/bits_per_dim, train/nlogp, <model>/train/<k>,
<model>/test/<k>, dt/train, dt/eval, num_vars), same artifacts (model.pt,
hps.yaml, sampling_process_<epoch>.gif for the autoregressive models),
--weights_from, --keep_best with best.json, --nan_guard and
--skip_training. Models: pixel_transformer, vqvae and made.

Runs on the card unless given --device=cpu, and raises without CUDA. An
epoch is a Python loop of train steps whose metrics stay on the device
until its end (one sync an epoch). Not ported yet, and refused by
utils/config.py: --eval_heavy, --stream_data, --resume, --profile,
--ckpt=orbax.
"""

import json
import time
from itertools import count
from pathlib import Path

import numpy as np
import torch

from generative_models_tpu_torch import data as data_lib
from generative_models_tpu_torch.utils import (
    count_vars, dump_logger, make_logger, make_writer, parse_args,
)


def load_model_and_data(argv=None):
    """Two-phase parse, then the model (with --weights_from loaded) and the
    dataset on the model's device."""
    G, Model = parse_args(argv)
    G.logdir = Path(G.logdir)
    model = Model(G=G)
    if G.weights_from != Path('.'):
        model.load_weights(G.weights_from)
    dataset = data_lib.load_mnist(G, model.device)
    print('num_vars', count_vars(model.params))
    return model, dataset, G


def _log_metrics(logger, metrics, G, split):
    for key, val in metrics.items():
        if key == 'nlogp':
            logger['eval/nlogp' if split == 'test' else 'train/nlogp'].append(val)
        else:
            logger[f'{G.model}/{split}/{key}'].append(val)


def train(model, dataset, G):
    """The epoch loop. Returns what dump_logger printed at each epoch: its
    eval metrics and the train metrics of the epoch before, as in the JAX
    package's logs."""
    writer = make_writer(G.logdir)
    dump_logger(make_logger(), writer, 0, G)
    logger, history = make_logger(), []
    seed = int(G.get('seed', 0))
    # one shuffling stream each for eval and train, as the JAX package's
    # eval_key / data_key
    eval_gen = torch.Generator().manual_seed(seed + 1000)
    data_gen = torch.Generator().manual_seed(seed + 2000)

    best_metric = {'nlogp': 'eval/nlogp', 'fid': 'eval/fid'}.get(
        str(G.get('keep_best', '')), str(G.get('keep_best', ''))
    )
    best_path = Path(G.logdir) / 'best.json'
    best = {'metric': best_metric, 'value': float('inf'), 'epoch': -1}

    for epoch in count():
        # ---- TEST (eval first) ----
        if model.has_loss():
            bx, by = dataset.epoch_batches(eval_gen, train=False)
            test_metrics = model.eval_epoch(bx, by)
            _log_metrics(logger, test_metrics, G, 'test')
            if getattr(model, 'is_autoreg', False) and 'nlogp' in test_metrics:
                # the AR losses are mean per-pixel Bernoulli NLL in nats
                logger['eval/bits_per_dim'].append(test_metrics['nlogp'] / np.log(2.0))
        test_x, test_y = dataset.first_test_batch(epoch)
        eval_time = time.time()
        model.evaluate(writer, test_x, test_y, epoch)
        logger['dt/eval'] = [time.time() - eval_time]

        # ---- LOGGING / SAVE ----
        logger['num_vars'] = [count_vars(model.params)]
        if epoch % G.save_n == 0:
            model.save(G.logdir)
            print('SAVED MODEL', G.logdir)
        if best_metric and logger.get(best_metric):
            val = float(np.mean(logger[best_metric]))
            if val < float(best['value']):
                best = {'metric': best_metric, 'value': val, 'epoch': epoch}
                model.save(G.logdir, tag='best')
                best_path.write_text(json.dumps(best))
                print(f'SAVED BEST ({best_metric}={val:.4f} @ epoch {epoch})')
        history.append(dump_logger(logger, writer, epoch, G))
        logger = make_logger()

        if epoch >= G.epochs:
            break

        # ---- TRAIN ----
        train_time = time.time()
        if not G.skip_training:
            bx, by = dataset.epoch_batches(data_gen, train=True)
            _log_metrics(logger, model.train_epoch(bx, by), G, 'train')
        logger['dt/train'] = [time.time() - train_time]

        if int(G.get('nan_guard', 1)):
            # fail fast on a blown-up run: every later epoch would be wasted
            bad = sorted(k for k, v in logger.items()
                         if k.split('/')[-2:-1] == ['train'] and not np.all(np.isfinite(v)))
            if bad:
                raise FloatingPointError(
                    f'non-finite train metrics at epoch {epoch}: {bad} '
                    '(set --nan_guard=0 to train through)'
                )
    if writer is not None:
        writer.close()
    return history


def main(argv=None):
    model, dataset, G = load_model_and_data(argv)
    return train(model, dataset, G)


if __name__ == '__main__':
    main()
