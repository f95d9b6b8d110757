"""Training harness / CLI. Counterpart of generative_models_tpu/main.py:

    python -m generative_models_tpu_torch.main --model=<name> [--flag=val ...]

Same two-phase flag parsing, same epoch structure (eval first, evaluate,
save every --save_n, eval_heavy after each save, train, a final eval after
the last epoch), same logger keys (eval/nlogp, eval/bits_per_dim,
train/nlogp, <model>/train/<k>, <model>/test/<k>, dt/train, dt/eval,
dt/eval_heavy, num_vars, and eval_heavy's eval/*), same artifacts
(model.pt, or model.jit.pt for an arbiter, hps.yaml,
sampling_process_<epoch>.gif for the autoregressive models),
--weights_from (a port model.pt or a JAX package's), --keep_best with
best.json, --nan_guard, --skip_training, --resume, --stream_data and
--profile. Models: every model of the JAX package (pixel_transformer,
vqvae, made, rnn, wavenet, pixel_cnn, gated_pixel_cnn, diffusion_model,
vae, gan and the arbiters autoencoder and classifier); pixel_transformer
also under --mesh=seq:N (ring attention, all N ring positions on the one
card: parallel/mesh.py).

--eval_heavy=1 loads the arbiters (--autoencoder always, --classifier with
--class_cond=1; a model.jit.pt of either package, models/arbiters/) and
after each save draws >= 500 samples (fewer where the test set runs out)
and scores them in the autoencoder's features against as many test images:
FID (the reference's mean-of-squares form and the standard one,
eval/ignite_fid), k-NN precision, recall and F1, and with --class_cond=1
the classifier's loss on samples drawn with the test labels and the cond_*
metrics of those samples (utils/metrics.py). Samples are compared in the
model's native range (SAMPLE_RANGE), as the test set's.

--resume=1 reloads logdir/model.pt when there is one (RESUMED <logdir> at
step N; --weights_from takes precedence) and starts at epoch step //
steps_per_epoch (RESUMING at epoch E; the step counts micro-steps, so
--grad_accum does not divide it), keeping best.json when it tracks the
same metric. Each epoch's shuffle (and the test sweep's) comes from a
generator seeded from (seed, epoch), as the JAX package folds the epoch
into its keys, and model.pt keeps the model's own training draws' stream,
so a resumed run trains exactly the uninterrupted one.

--stream_data=1 keeps the training split on the host (data/stream.py,
--prefetch_depth batches staged ahead) and trains on the same batches in
the same order as the on-device split; --stream_chunk=k stages (k, bs, ...)
blocks, the last one partial, and every step weighs the same in the
epoch's metrics (a partial block as much as its steps).

--mesh=data:N, model:N, pipe:N, expert:N (with seq:N) and --fsdp=1 run
under a process group, one process a mesh slot: `torchrun --nproc_per_node=N -m
generative_models_tpu_torch.main ...` (NCCL on the card, gloo with
--device=cpu; parallel/mesh.py). Every rank draws the same epoch order and
trains on its rows of each global batch, the metrics are global means, and
rank 0 alone writes model.pt (full tensors whatever the mesh), hps.yaml,
best.json, the event file and the GIFs.

--profile=1 runs the epoch loop under torch.profiler (the CPU, and CUDA on
the card) and writes a Chrome trace under logdir/profile/, also when the
loop raises; where the platform cannot trace, it says so and trains on.

Runs on the card unless given --device=cpu, and raises without CUDA.
--jit_epoch=1 (the default, the JAX package's jitted epoch) trains an
epoch through model.train_epoch: on the card each step is a CUDA graph,
captured once a batch shape and micro-step kind and replayed (utils/graphs.py),
bitwise the per-step loop; on the CPU the same step runs uncaptured; under
a process group the steps run eagerly, and the run prints a line that says
so. --jit_epoch=0 is the per-step loop, as --stream_data's. Either way the
metrics stay on the device until the epoch's end (one sync an epoch);
eval_heavy syncs once, at its end. Not ported, and refused by
utils/config.py: --ckpt=orbax.
"""

import contextlib
import json
import time
from itertools import count
from pathlib import Path

import numpy as np
import torch

from generative_models_tpu_torch import data as data_lib
from generative_models_tpu_torch.models.base import mean_metrics
from generative_models_tpu_torch.utils import (
    dump_logger, make_logger, make_writer, parse_args, prefix_dict,
)

TOTAL_HEAVY_SAMPLES = 500  # the reference's sample count for eval_heavy


def load_model_and_data(argv=None):
    """Two-phase parse, then the model (with --weights_from loaded), the
    dataset on the model's device and, with --eval_heavy, the arbiters
    (the classifier only with --class_cond). Returns (model, dataset,
    autoencoder, classifier, G)."""
    G, Model = parse_args(argv)
    G.logdir = Path(G.logdir)
    model = Model(G=G)
    if G.weights_from != Path('.'):
        model.load_weights(G.weights_from)
    elif int(G.get('resume', 0)) and (G.logdir / 'model.pt').exists():
        # the same command again after an interruption: pick up the
        # logdir's own checkpoint; the first run starts fresh
        model.load_weights(G.logdir / 'model.pt')
        print(f'RESUMED {G.logdir} at step {model.step}')
    dataset = data_lib.load_mnist(G, model.device)
    print('num_vars', model.num_vars)
    autoencoder = classifier = None
    if G.eval_heavy:
        from generative_models_tpu_torch.models.arbiters import load_arbiter

        autoencoder = load_arbiter(G.autoencoder, model.device)
        if G.class_cond:
            classifier = load_arbiter(G.classifier, model.device)
    return model, dataset, autoencoder, classifier, G


def eval_heavy(logger, model, dataset, autoencoder, classifier, G):
    """Draw >= TOTAL_HEAVY_SAMPLES samples in batches of --bs, one a test
    batch, until the test set runs out, and log eval/{fid, ignite_fid,
    precision, recall, f1} of their autoencoder features against the test
    batches'; with --class_cond=1 the samples are drawn unconditionally
    (labels -1) and a second set with the test labels, which adds
    eval/classifier_loss and eval/cond_{fid, precision, recall, f1}. The
    features and losses stay on the device; one sync at the end."""
    from generative_models_tpu_torch.utils import metrics as M

    bs, n_test = int(G.bs), dataset.test_x.shape[0]
    z_samp, z_real, z_cond, cls_losses = [], [], [], []
    sample_ct = offset = 0
    while sample_ct < TOTAL_HEAVY_SAMPLES:
        test_x = dataset.test_x[offset:offset + bs]
        test_y = dataset.test_y[offset:offset + bs]
        offset += bs
        if test_x.shape[0] < bs or offset > n_test:
            break
        if G.class_cond:
            cond = model.sample_images(bs, y=test_y)
            cls_losses.append(M.cross_entropy(classifier.apply(cond), test_y))
            z_cond.append(autoencoder.apply(cond))
            samp = model.sample_images(bs, y=-torch.ones_like(test_y))
        else:
            samp = model.sample_images(bs)
        z_real.append(autoencoder.apply(test_x))
        z_samp.append(autoencoder.apply(samp))
        sample_ct += bs

    z_samp, z_real = torch.cat(z_samp), torch.cat(z_real)
    results = {'ignite_fid': M.frechet_distance(z_samp, z_real, mean_of_sq=False),
               'fid': M.compute_fid(z_samp, z_real)}
    results.update(M.precision_recall_f1(real=z_real, gen=z_samp))
    if G.class_cond:
        results['classifier_loss'] = torch.stack(cls_losses).mean()
        z_cond = torch.cat(z_cond)
        cond = M.precision_recall_f1(real=z_real, gen=z_cond)
        cond['fid'] = M.compute_fid(z_cond, z_real)
        results.update(prefix_dict('cond_', cond))
    values = torch.stack([v.float() for v in results.values()]).cpu().tolist()
    for key, val in zip(results, values):
        logger[f'eval/{key}'].append(val)


def _log_metrics(logger, metrics, G, split):
    for key, val in metrics.items():
        if key == 'nlogp':
            logger['eval/nlogp' if split == 'test' else 'train/nlogp'].append(val)
        else:
            logger[f'{G.model}/{split}/{key}'].append(val)


def epoch_generator(seed, epoch):
    """A CPU generator for one epoch, seeded from (seed, epoch), as the JAX
    package takes fold_in(key, epoch): an epoch's order does not depend on
    the epochs drawn before it in this process."""
    state = np.random.SeedSequence([int(seed), int(epoch)]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def train_epoch_streamed(model, dataset, generator, chunk):
    """One epoch from a StreamingDataset: a train step a batch, or a block
    of chunk, the steps' metrics kept on the device and averaged at the
    end, every step weighing the same."""
    ms = []
    with dataset.stream_epoch(generator, chunk=chunk) as batches:
        for bx, by in batches:
            if chunk == 1:
                ms.append(model.train_step(bx, by))
            else:
                ms.extend(model.train_step(bx[i], by[i]) for i in range(len(bx)))
    return mean_metrics(ms)


@contextlib.contextmanager
def profiled(G, device):
    """torch.profiler around the block when --profile=1 (CUDA activity too
    on the card): the Chrome trace is written to logdir/profile/ when the
    block ends, also by an exception. Where tracing cannot start, it says
    so and runs the block unprofiled."""
    if not int(G.get('profile', 0)):
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    out = Path(G.logdir) / 'profile'
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    try:
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # a platform that cannot trace
        print(f'[profiler] trace unavailable: {e}')
        yield None
        return
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        path = out / f'trace_{int(time.time())}.json'
        prof.export_chrome_trace(str(path))
        print(f'[profiler] trace written to {path}')


def train(model, dataset, autoencoder, classifier, G):
    """The epoch loop. Returns what dump_logger printed at each epoch: its
    eval metrics and the train metrics of the epoch before, as in the JAX
    package's logs."""
    main_rank = model.mesh.is_main
    writer = make_writer(G.logdir) if main_rank else None
    dump_logger(make_logger(), writer, 0, G)
    logger, history = make_logger(), []
    seed = int(G.get('seed', 0))
    resume = int(G.get('resume', 0))

    best_metric = {'nlogp': 'eval/nlogp', 'fid': 'eval/fid'}.get(
        str(G.get('keep_best', '')), str(G.get('keep_best', ''))
    )
    best_path = Path(G.logdir) / 'best.json'
    best = {'metric': best_metric, 'value': float('inf'), 'epoch': -1}
    if best_metric and resume and best_path.exists():
        prev = json.loads(best_path.read_text())
        if prev.get('metric') == best_metric:
            best = prev  # the best checkpoint does not regress across resumes

    if (int(G.get('jit_epoch', 1)) and model.device.type == 'cuda' and model.mesh.dm is not None
            and not G.skip_training):
        print('[jit_epoch] under a process group the train steps run eagerly (no CUDA graph)')
    start_epoch = 0
    if resume and model.step > 0:
        start_epoch = model.step // max(1, dataset.steps_per_epoch)
        print(f'RESUMING at epoch {start_epoch}')

    # the writer closes also when the loop raises: a script that runs
    # stages in one process leaves no event file open behind a failed one
    with profiled(G, model.device), writer or contextlib.nullcontext():
        for epoch in count(start_epoch):
            # ---- TEST (eval first) ----
            if model.has_loss():
                bx, by = dataset.epoch_batches(epoch_generator(seed + 1000, epoch), train=False)
                test_metrics = model.eval_epoch(bx, by)
                _log_metrics(logger, test_metrics, G, 'test')
                if getattr(model, 'is_autoreg', False) and 'nlogp' in test_metrics:
                    # the AR losses are mean per-pixel Bernoulli NLL in nats
                    logger['eval/bits_per_dim'].append(test_metrics['nlogp'] / np.log(2.0))
            test_x, test_y = dataset.first_test_batch(epoch)
            eval_time = time.time()
            model.evaluate(writer, test_x, test_y, epoch)
            logger['dt/eval'] = [time.time() - eval_time]

            # ---- LOGGING / SAVE / HEAVY EVAL ----
            logger['num_vars'] = [model.num_vars]
            if epoch % G.save_n == 0:
                model.save(G.logdir)  # every rank gathers; rank 0 writes
                print('SAVED MODEL', G.logdir)
                if G.eval_heavy:
                    print('RUNNING HEAVY EVAL...')
                    t0 = time.time()
                    eval_heavy(logger, model, dataset, autoencoder, classifier, G)
                    logger['dt/eval_heavy'] = [time.time() - t0]
                    print('DONE HEAVY EVAL')
            if best_metric and logger.get(best_metric):
                val = float(np.mean(logger[best_metric]))
                if val < float(best['value']):
                    best = {'metric': best_metric, 'value': val, 'epoch': epoch}
                    model.save(G.logdir, tag='best')
                    if main_rank:
                        best_path.write_text(json.dumps(best))
                    print(f'SAVED BEST ({best_metric}={val:.4f} @ epoch {epoch})')
            history.append(dump_logger(logger, writer, epoch, G))
            logger = make_logger()

            if epoch >= G.epochs:
                break

            # ---- TRAIN ----
            train_time = time.time()
            if not G.skip_training:
                data_gen = epoch_generator(seed + 2000, epoch)
                if getattr(dataset, 'is_streaming', False):
                    metrics = train_epoch_streamed(model, dataset, data_gen,
                                                   max(1, int(G.get('stream_chunk', 1))))
                else:
                    bx, by = dataset.epoch_batches(data_gen, train=True)
                    if int(G.get('jit_epoch', 1)):
                        metrics = model.train_epoch(bx, by)
                    else:
                        # the per-step path: each step issued from Python, the
                        # metrics kept on the device until the epoch's end
                        metrics = mean_metrics([model.train_step(bx[i], by[i])
                                                for i in range(len(bx))])
                _log_metrics(logger, metrics, G, 'train')
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
    return history


def main(argv=None):
    model, dataset, autoencoder, classifier, G = load_model_and_data(argv)
    return train(model, dataset, autoencoder, classifier, G)


if __name__ == '__main__':
    main()
