"""The 64-image sampling latency of each progressive-distillation stage
(the JAX system's scripts/distill_latency.py): each stage's model.pt
under LOGROOT is loaded (its hps.yaml sets the stage's step count) and
model.sample(64) with labels -1 is called to warm (on the card twice: the
eager pass and the capture of its CUDA graphs, utils/graphs.py), then
--reps times, timed with the device synchronised around the loop. The curve from
the 256-step teacher down to the 1-step student is the chain's payoff; it
goes into the JSON's sample_latency, the device (nvidia-smi's name and
power limit on the card) into sample_latency_device:

    python3 -m generative_models_tpu_torch.scripts.distill_latency \\
        [LOGROOT] [DISTILL.json] [--reps=5] [--flag=value ...]

LOGROOT defaults to $LOGROOT, else logs/distillation; the JSON to
LOGROOT/DISTILL.json, read first where it exists. The other flags go to
each load (--device=cpu runs on the CPU; without it, on the card, and
without CUDA it raises, as every entry point).
"""

import json
import subprocess
import time

import torch

from generative_models_tpu_torch.scripts import CHAIN_STAGES, cli_argv, split_args
from generative_models_tpu_torch.scripts.collect_distill import paths
from generative_models_tpu_torch.utils.graphs import WARMUP

N = 64


def device_name(device):
    """nvidia-smi's 'name, power.limit' of the card, or the device's
    type where it is not one."""
    if device.type != 'cuda':
        return device.type
    try:
        return subprocess.run(
            ['nvidia-smi', f'--id={device.index or 0}', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True, timeout=30,
        ).stdout.strip() or torch.cuda.get_device_name(device)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def time_stage(logdir, extra=(), reps=5):
    """({timesteps, sample64_sec, imgs_per_sec}, the model's device) of
    the stage in logdir."""
    from generative_models_tpu_torch.main import load_model_and_data

    model, _, _, _, G = load_model_and_data(
        [f'--weights_from={logdir}/model.pt', '--eval_heavy=0', *extra])
    y = torch.full((N,), -1, dtype=torch.int32, device=model.device)
    sync = torch.cuda.synchronize if model.device.type == 'cuda' else (lambda: None)
    for _ in range(WARMUP + 1):  # warm: the eager pass, then the capture
        model.sample(N, y)
    sync()
    t0 = time.time()
    for _ in range(reps):
        model.sample(N, y)
    sync()
    dt = (time.time() - t0) / reps
    return {'timesteps': int(G.timesteps), 'sample64_sec': dt, 'imgs_per_sec': N / dt}, model.device


def main(argv=None, env=None):
    pos, flags = split_args(cli_argv(argv))
    reps = [int(a.split('=', 1)[1]) for a in flags if a.startswith('--reps=')]
    extra = [a for a in flags if not a.startswith('--reps=')]
    root, out_path = paths(pos, env)
    result = json.loads(out_path.read_text()) if out_path.exists() else {}
    lat, device = {}, None
    for stage in CHAIN_STAGES:
        d = root / stage
        if not (d / 'model.pt').exists():
            continue
        lat[stage], device = time_stage(d, extra, reps[-1] if reps else 5)
        print(stage, json.dumps(lat[stage]), flush=True)
    result['sample_latency'] = lat
    if device is not None:
        result['sample_latency_device'] = device_name(device)
    out_path.write_text(json.dumps(result, indent=1))
    print('wrote', out_path)
    return result


if __name__ == '__main__':
    main()
