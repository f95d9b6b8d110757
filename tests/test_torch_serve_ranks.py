"""Serving over ranks (generative_models_tpu_torch/serve.py under a
process group) against the JAX package's one-device server and the port's
one-process server, on the CPU: a JAX pixel_transformer's model.pt (2
layers, 128 wide: the width --quantize needs), read through --weights_from,
served at data:2, model:2, pipe:2 and data:2 --quantize=w8a16 in two gloo
ranks (test_torch_mesh.py's _spawn: a process-group timeout and a join
timeout). Rank 0 takes the requests and broadcasts each to the other rank,
which follows until the stop message. Fed the uniforms the JAX serving fn
draws at seed 7, each rank server gives the JAX server's seed-7 batch (as
tests/test_torch_export.py holds the one-process port); its own seed-7
batch is the one-process port server's at the same seed and flags, an
unseeded request runs one seed on both ranks, and its batch is the
one-process server's at that seed."""

import numpy as np
import torch

from test_torch_mesh import _spawn

torch.set_num_threads(1)

PT = ['--model=pixel_transformer', '--n_layer=2', '--n_embed=128', '--n_head=4']
BS = 4


def _case_serve(case, out):
    """load_server on every rank: rank 0 serves a seed-7 request of BS
    and an unseeded one of 3, then stops the others, which follow; every
    rank's pass seeds."""
    import torch.distributed as dist

    from generative_models_tpu_torch.serve import load_server

    server, _ = load_server(case['argv'])
    res = {'jax_draws': server.run_draws((torch.from_numpy(np.load(out / 'u7.npy')),))}
    if server.is_main:
        res['seed7'] = server.sample(BS, seed=7)
        res['unseeded'] = server.sample(3)
        server.stop()
    else:
        server.follow()
    seeds = [None] * dist.get_world_size()
    dist.all_gather_object(seeds, server.seeds)
    res['seeds'] = np.array(seeds)
    res['data_rows'] = np.array(server.program.n)
    return res


def test_servers_over_two_ranks_serve_the_one_process_batch(tmp_path):
    """data:2 (a row each), model:2 (the TP decode), pipe:2 (a stage each,
    the step's activations passed on and the logits broadcast) and data:2
    with --quantize=w8a16, serving a JAX model.pt: from the JAX serving
    fn's seed-7 uniforms, bitwise the JAX one-device server's seed-7 batch
    (plain or w8a16); the seed-7 batch bitwise the one-process port
    server's, the unseeded request one seed on both ranks (rank 0's) and
    the one-process batch at that seed."""
    from generative_models_tpu import serve as jserve
    from generative_models_tpu.utils import discover_models as jax_models
    from generative_models_tpu.utils.config import dump_hps as jax_dump_hps
    from generative_models_tpu.utils.config import parse_args as jax_parse_args
    from generative_models_tpu_torch.serve import load_server
    from test_torch_export import _uniforms
    from test_torch_mesh import _one_device

    with _one_device():
        G, Model = jax_parse_args(PT + ['--bs=8', f'--logdir={tmp_path / "ckpt"}'],
                                  discover_models=jax_models)
        jm = Model(G)
        jm.save(tmp_path / 'ckpt')
        jax_dump_hps(G, tmp_path / 'ckpt')
        jax_ref = {q: np.asarray(jserve.SampleServer(jm, serve_bs=BS, quantize=q).sample(BS, seed=7))
                   for q in ('', 'w8a16')}
    np.save(tmp_path / 'u7.npy', _uniforms(7, 784, (BS, 1)))
    base = [f'--weights_from={tmp_path / "ckpt" / "model.pt"}', '--device=cpu',
            f'--serve_bs={BS}']
    meshes = {'data2': ['--mesh=data:2'], 'model2': ['--mesh=model:2'],
              'pipe2': ['--mesh=pipe:2'], 'data2_w8a16': ['--mesh=data:2', '--quantize=w8a16']}
    cases = [dict(kind='serve', name=name, argv=base + flags) for name, flags in meshes.items()]
    out = _spawn(2, cases, tmp_path, module='test_torch_serve_ranks')

    one = {q: load_server(base + ([f'--quantize={q}'] if q else []))[0] for q in ('', 'w8a16')}
    for name, res in out.items():
        q = 'w8a16' if 'w8a16' in name else ''
        np.testing.assert_array_equal(res['jax_draws'], jax_ref[q], err_msg=name)
        server = one[q]
        np.testing.assert_array_equal(res['seed7'], server.sample(BS, seed=7), err_msg=name)
        seeds = res['seeds']
        assert seeds.shape == (2, 2) and (seeds[0] == seeds[1]).all() and seeds[0, 0] == 7, name
        np.testing.assert_array_equal(res['unseeded'], server.sample(3, seed=int(seeds[0, 1])),
                                      err_msg=name)
        assert int(res['data_rows']) == (BS // 2 if name.startswith('data2') else BS), name
