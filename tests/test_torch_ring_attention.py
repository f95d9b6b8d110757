"""The port's ring attention (generative_models_tpu_torch/parallel/ and the
hop functions of ops/attention.py, Kernels K, L and M's plain versions on
the CPU) against the JAX package: each hop against _ring_chunk_fwd /
_ring_chunk_bwd (Pallas in interpret mode), the one-card ring against JAX's
ring_causal_attention on the 8-device CPU mesh and against dense attention,
the process-group form in 4 gloo ranks against the one-card form, and a
--mesh=seq:8 pixel_transformer train step against JAX's. Inputs come from
numpy with a seed. About 30 s here."""

import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops import attention as jatt
from generative_models_tpu.parallel import make_mesh, mesh as jmesh
from generative_models_tpu.parallel import parse_mesh_spec as jax_parse_mesh_spec
from generative_models_tpu.parallel.ring_attention import ring_causal_attention as jax_ring
from generative_models_tpu.utils import discover_models as jax_models
from generative_models_tpu.utils.config import parse_args as jax_parse_args
from generative_models_tpu_torch.convert import params_from_jax
from generative_models_tpu_torch.ops import attention as tat
from generative_models_tpu_torch.parallel import parse_mesh_spec, ring_size, seq_size
from generative_models_tpu_torch.parallel.ring_attention import (
    _chunks, ring_causal_attention, ring_forward,
)
from generative_models_tpu_torch.utils.config import parse_args

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

# (t_valid, ring position of the queries, of the visiting chunk, carry?)
HOP_CASES = {
    'init': (24, 2, 2, False),  # the diagonal hop, the init variant
    'carry': (24, 3, 1, True),  # a chunk wholly in the past
    'future': (24, 1, 3, True),  # wholly in the future: live bound 0, carry unchanged
    'ragged': (20, 2, 1, True),  # t_valid 20 in a 24-row chunk: keys 20-23 masked
    'multiblock': (392, 1, 1, False),  # blk 56: seven blocks, the live bound inside
}


def _hop_inputs(case, BH=4, D=8, seed=0):
    """One hop's inputs. v and dO at a tenth of q's and k's scale (delta,
    their product, at a hundredth): the f32 sums over 392 keys differ from
    XLA's by a few ulps of their largest terms, which must stay under atol
    1e-6 where a sum cancels to near 0."""
    t_valid, p, c, carry = HOP_CASES[case]
    Tp = tat._pick_chunk_blk(t_valid)[1]
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (scale * rng.randn(*s)).astype(np.float32)
    d = dict(q=f(BH, Tp, D), k=f(BH, Tp, D), v=f(BH, Tp, D, scale=0.1),
             do=f(BH, Tp, D, scale=0.1), lse=f(BH, Tp) + 3.0, delta=f(BH, Tp, scale=0.01))
    if carry:
        d.update(acc=f(BH, Tp, D), m=f(BH, Tp), l=1.0 + rng.rand(BH, Tp).astype(np.float32),
                 dq=f(BH, Tp, D), dk=f(BH, Tp, D), dv=f(BH, Tp, D))
    return d, p * t_valid, c * t_valid, t_valid


def _t(d, key):
    return torch.from_numpy(d[key]) if key in d else None


def _j(d, key):
    return jnp.asarray(d[key]) if key in d else None


@pytest.mark.parametrize('case', sorted(HOP_CASES))
def test_hop_forward_matches_jax(case):
    d, qs, ks, tv = _hop_inputs(case)
    scale = 1.0 / math.sqrt(d['q'].shape[-1])
    ref = jatt._ring_chunk_fwd(*(_j(d, x) for x in ('q', 'k', 'v', 'acc', 'm', 'l')),
                               qs, ks, tv, scale, interpret=True)
    got = tat.ring_chunk_fwd_plain(*(_t(d, x) for x in ('q', 'k', 'v', 'acc', 'm', 'l')),
                                   qs, ks, tv)
    for name, g, r in zip(('acc', 'm', 'l'), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6, err_msg=name)
    if case == 'future':
        for g, x in zip(got, ('acc', 'm', 'l')):
            assert torch.equal(g, _t(d, x))


@pytest.mark.parametrize('case', sorted(HOP_CASES))
def test_hop_backward_matches_jax(case):
    d, qs, ks, tv = _hop_inputs(case, seed=1)
    scale = 1.0 / math.sqrt(d['q'].shape[-1])
    names = ('q', 'k', 'v', 'do', 'lse', 'delta', 'dq', 'dk', 'dv')
    ref = jatt._ring_chunk_bwd(*(_j(d, x) for x in names), qs, ks, tv, scale, interpret=True)
    got = tat.ring_chunk_bwd_plain(*(_t(d, x) for x in names), qs, ks, tv)
    for name, g, r in zip(('dq', 'dk', 'dv'), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6, err_msg=name)


def _first_live_q_block(q0, k0, kb, blk, n_q):
    """First query block (of the chunk starting at global q0) with any
    causally live pair against KV block kb of the chunk starting at k0: the
    transpose of _live_kv_bound. Query block i and KV block kb share a live
    pair iff q0 + i*blk + blk - 1 >= k0 + kb*blk, i.e. i >= ceil((k0 + kb*blk
    - q0 - blk + 1) / blk) = floor((k0 + kb*blk - q0) / blk). At blk = 1 it
    is Kernel M's start of a key row's query loop, max(0, k_start + key -
    q_start)."""
    return min(max((k0 + kb * blk - q0) // blk, 0), n_q)


def test_live_bound_and_its_transpose():
    """_first_live_q_block is the transpose of _live_kv_bound: query block i
    and KV block j share a live pair iff j < the bound of i iff i >= the
    first live block of j, and both agree with a brute-force count; the
    bound and the block plan equal the JAX package's. blk=1 is the per-row
    form Kernels K, L (the keys a row sees) and M (the first query that
    sees a key) use."""
    for blk, n in ((1, 12), (8, 3), (56, 7), (104, 1), (128, 2)):
        for q0 in range(0, 3 * n * blk, blk // 2 + 3):
            for k0 in range(0, 3 * n * blk, blk // 2 + 5):
                for i in range(n):
                    bound = tat._live_kv_bound(q0 + i * blk, k0, blk, n)
                    assert bound == int(jatt._live_kv_bound(q0 + i * blk, k0, blk, n))
                    for j in range(n):
                        live = q0 + i * blk + blk - 1 >= k0 + j * blk
                        assert (j < bound) == live == (i >= _first_live_q_block(
                            q0, k0, j, blk, n)), (blk, q0, k0, i, j)
    for T in (10, 20, 24, 98, 128, 196, 392, 784, 1000):
        assert tat._pick_chunk_blk(T) == jatt._pick_chunk_blk(T), T


def _qkvw(B=2, H=2, T=64, D=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(4)]


def _port_ring(arrays, n):
    q, k, v, w = (torch.from_numpy(a) for a in arrays)
    qkv = [u.clone().requires_grad_() for u in (q, k, v)]
    o = ring_causal_attention(*qkv, n)
    (o * w).sum().backward()
    return o.detach().numpy(), [u.grad.numpy() for u in qkv]


def test_one_card_ring_matches_jax_ring_and_dense():
    """The one-card ring at seq:8 against JAX's ring on the 8-device CPU
    mesh and against xla_causal_attention: output and the three gradients
    at the JAX tests' rtol 1e-4 / atol 1e-5."""
    arrays = _qkvw()
    o, grads = _port_ring(arrays, 8)
    mesh = make_mesh('seq:8', jax.devices())
    q, k, v, w = (jnp.asarray(a) for a in arrays)

    def loss(f):
        return lambda q, k, v: (f(q, k, v) * w).sum()

    ring = lambda q, k, v: jax_ring(q, k, v, mesh=mesh, axis='seq')
    for f in (ring, jatt.xla_causal_attention):
        np.testing.assert_allclose(o, np.asarray(f(q, k, v)), rtol=1e-4, atol=1e-5)
        ref = jax.grad(loss(f), argnums=(0, 1, 2))(q, k, v)
        for g, r in zip(grads, ref):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('n', [2, 4, 7])
def test_ring_sizes_agree_with_causal_attention(n):
    """Ragged chunks (T=56: 28 -> 32 rows, 14 -> 16, 8) against the port's
    own causal_attention (Kernels C, E, D's plain versions)."""
    arrays = _qkvw(T=56, seed=n)
    o, grads = _port_ring(arrays, n)
    q, k, v, w = (torch.from_numpy(a) for a in arrays)
    qkv = [u.clone().requires_grad_() for u in (q, k, v)]
    od, _ = tat.causal_attention(*qkv)
    (od * w).sum().backward()
    np.testing.assert_allclose(o, od.detach().numpy(), rtol=1e-5, atol=1e-6)
    for g, u in zip(grads, qkv):
        np.testing.assert_allclose(g, u.grad.numpy(), rtol=1e-5, atol=1e-6)


WORKER = '''
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, {repo!r})
from generative_models_tpu_torch.parallel.ring_attention import ring_causal_attention

rank, n, store, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
torch.set_num_threads(1)
dist.init_process_group('gloo', store=dist.FileStore(store, n), rank=rank, world_size=n,
                        timeout=timedelta(seconds=60))
d = np.load(inp)
Tl = d['q'].shape[2] // n
sl = slice(rank * Tl, (rank + 1) * Tl)
q, k, v = (torch.from_numpy(d[x][:, :, sl]).requires_grad_() for x in 'qkv')
o = ring_causal_attention(q, k, v, group=dist.group.WORLD)
(o * torch.from_numpy(d['w'][:, :, sl])).sum().backward()
np.savez(out, o=o.detach().numpy(), dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy())
dist.destroy_process_group()
'''


def test_process_group_ring_matches_one_card(tmp_path):
    """4 gloo ranks, one ring position each, K/V (then K/V/dK/dV) sent to
    rank + 1, against the one-card form at 1e-6. Each rank is a
    subprocess with a timeout, meeting through a FileStore: a wrong
    send/recv pairing fails the test instead of hanging."""
    n = 4
    arrays = _qkvw(T=56, seed=5)  # 14 a rank, padded to 16
    inp = tmp_path / 'in.npz'
    np.savez(inp, **dict(zip('qkvw', arrays)))
    code = WORKER.format(repo=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, '-c', code, str(r), str(n), str(tmp_path / 'store'), str(inp),
         str(tmp_path / f'out{r}.npz')], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * n, logs
    o, grads = _port_ring(arrays, n)
    outs = [np.load(tmp_path / f'out{r}.npz') for r in range(n)]
    for name, ref in zip(('o', 'dq', 'dk', 'dv'), [o, *grads]):
        got = np.concatenate([d[name] for d in outs], axis=2)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, err_msg=name)


FLAGS = ['--model=pixel_transformer', '--n_layer=1', '--n_embed=16', '--n_head=2']


def _port(*flags):
    G, Model = parse_args(FLAGS + ['--device=cpu', *flags])
    return Model(G)


def test_seq8_train_step_matches_jax(tmp_path):
    """One batch's loss and every parameter's gradient under --mesh=seq:8:
    the port's one-card ring against JAX's ring on the seq:8 mesh, from the
    same weights, at test_torch_train.py's tolerances."""
    x = (np.random.RandomState(4).rand(2, 28, 28, 1) > 0.5).astype(np.float32)
    old = jmesh._GLOBAL_MESH
    try:
        jmesh.set_mesh(make_mesh('seq:8', jax.devices()))
        G, Model = jax_parse_args(FLAGS + [f'--logdir={tmp_path}'], discover_models=jax_models)
        jm = Model(G)
        assert jm.net.use_ring
        loss_fn = lambda p, x: jm.loss(p, x, None, None, True)
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jm.state.params, jnp.asarray(x))
        params = jax.tree_util.tree_map(np.asarray, jm.state.params)
        grads = jax.tree_util.tree_map(np.asarray, grads)
    finally:
        jmesh.set_mesh(old)
    model = _port('--mesh=seq:8')
    assert model.net.use_ring and model.net.ring == 8 and not model.net.use_fused_decode
    model.net.load_state_dict(params_from_jax(params))
    metrics = model.backward(x)
    np.testing.assert_allclose(float(metrics['nlogp']), float(loss), rtol=1e-6)
    ref = params_from_jax(grads)
    got = {k: p.grad for k, p in model.net.named_parameters()}
    assert set(got) == set(ref)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize('mesh, ring', [('', 1), ('seq:1', 1), ('seq:5', 1), ('seq:3', 1),
                                        ('seq:2', 2), ('seq:8', 8), ('data:1,seq:4', 4)])
def test_use_ring_follows_the_seq_axis(mesh, ring):
    """The ring when seq > 1 divides 784, as JAX's build(); otherwise the
    normal path and the fused decode kernels."""
    assert ring_size(mesh, 784) == ring
    model = _port(f'--mesh={mesh}')
    assert (model.net.ring, model.net.use_ring) == (ring, ring > 1)
    assert model.net.use_fused_decode == (ring == 1)
    assert all(b.attn.ring == ring for b in model.net.blocks)


def test_ring_model_forward_and_sampling(monkeypatch):
    """Under the ring: the full forward equals the normal path's from the
    same weights, and sampling takes the per-op chain, calling neither
    fused decode wrapper (on the CPU their counters stay 0 either way, so
    they are patched to fail), drawing the same tokens as the per-op chain
    of the normal path."""
    ring, plain = _port('--mesh=seq:4'), _port('--fused_decode=0')
    plain.net.load_state_dict(ring.net.state_dict())
    x = torch.from_numpy((np.random.RandomState(2).rand(2, 784, 1) > 0.5).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(ring.net(x).logits.numpy(), plain.net(x).logits.numpy(),
                                   rtol=1e-5, atol=1e-5)
    u = torch.from_numpy(np.random.RandomState(3).rand(784, 2, 1).astype(np.float32))
    ref = plain.sample_fn(2, uniforms=u, with_frames=False)
    for name in ('ln_matmul', 'block_tail'):
        monkeypatch.setattr(f'generative_models_tpu_torch.models.pixel_transformer.{name}',
                            lambda *a, **k: pytest.fail('a fused decode kernel ran'))
    assert torch.equal(ring.sample_fn(2, uniforms=u, with_frames=False), ref)


def test_mesh_spec_matches_jax_and_the_one_card_rule():
    for spec in ('data:4,model:2', 'seq:8', 'data:2,seq:4', 'data:1,seq:8'):
        assert parse_mesh_spec(spec) == jax_parse_mesh_spec(spec, 8)
    # JAX asserts one device a mesh slot; the port matches no device count
    # (the one-card rule): seq:4 is 4 ring positions on 8 devices or on one
    for spec in ('data:3', 'seq:4'):
        with pytest.raises(AssertionError):
            jax_parse_mesh_spec(spec, 8)
    assert parse_mesh_spec('seq:4') == (('seq', 4),) and parse_mesh_spec('') == (('data', 1),)
    assert parse_mesh_spec('') == jax_parse_mesh_spec('', 1)
    assert (seq_size(''), seq_size('data:2'), seq_size('data:1,seq:4')) == (1, 1, 4)
    with pytest.raises(ValueError):
        parse_mesh_spec('seq:0')


@pytest.mark.parametrize('fn', ['ring_chunk_fwd', 'ring_chunk_bwd_dq', 'ring_chunk_bwd_dkv'])
def test_hop_wrappers_refuse_tensors_off_the_cpu(fn):
    u = torch.zeros((2, 1, 8, 8), device='meta')
    row = torch.zeros((2, 1, 8), device='meta')
    args = (u, u, u, None, 0, 8) if fn == 'ring_chunk_fwd' else (u, u, u, u, row, row, None, 0, 8)
    with pytest.raises(ValueError, match='CUDA tensor'):
        getattr(tat, fn)(*args)


def _emulate_ring_dq(q, k, v, do, lse, delta, dq, hop, t_valid, pair):
    """Kernel L's arithmetic for every ring position of a one-card launch,
    in f32 on the CPU: S and dP from the bf16 operands with f32 sums, P =
    2^(S scale log2 e - lse log2 e) under the global-position mask, dS =
    P (dP - delta) carried as hi = bf16(dS), lo = bf16(dS - hi) into two
    f32 products (pair) or rounded to bf16 once (the TPU kernel's rounding);
    rows at or past t_valid keep dq (the kernel loads them as zeros)."""
    bf = torch.bfloat16
    P, _, Tp, D = q.shape
    log2e = math.log2(math.e)
    r = torch.arange(Tp)
    outs = []
    for j, kv, qs, ks in tat._hop_items(P, hop, t_valid, 0, P):
        qf, kf, vf, dof = (u.to(bf).float() for u in (q[j], k[kv], v[kv], do[j]))
        p = torch.exp2((qf @ kf.transpose(-1, -2)) * (log2e / math.sqrt(D))
                       - lse[j][..., None] * log2e)
        live = ((qs + r[:, None] >= ks + r[None, :]) & (r[None, :] < t_valid)
                & (r[:, None] < t_valid))
        ds = p.masked_fill(~live, 0.0) * (dof @ vf.transpose(-1, -2) - delta[j][..., None])
        hi = ds.to(bf).float()
        prod = hi @ kf + (ds - hi).to(bf).float() @ kf if pair else hi @ kf
        outs.append(prod / math.sqrt(D) if dq is None else dq[j] + prod / math.sqrt(D))
    return torch.stack(outs)


@pytest.mark.parametrize('hop', [0, 1])
@pytest.mark.parametrize('pair', [True, False])
def test_ring_dq_as_bf16_pairs_holds_the_plain_hop(hop, pair):
    """Why Kernel L splits dS: on pixel_transformer's ring of 4 (T=784,
    D=32, t_valid 196 in 256-row chunks), with bf16-valued inputs and lse
    and delta from the forward ring, the emulated kernel with dS as a hi/lo
    pair holds ring_hop_bwd_dq_plain(dtype=bf16) within chip_smoke.py's
    atol 1e-4 + rtol 1e-3 at the first hop and at a carry hop; rounding dS
    to bf16 once misses it (6653 and 3690 of 65536 outputs at seed 3)."""
    bf = torch.bfloat16
    rng = np.random.RandomState(3)
    n, T, D = 4, 784, 32
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, T, D).astype(np.float32)).to(bf).float()
                   for _ in range(4))
    Tl = T // n
    Tp = tat._pick_chunk_blk(Tl)[1]
    qc, kc, vc, doc = (_chunks(u, n, Tp, torch.float32) for u in (q, k, v, do))
    o, lse = ring_forward(qc, kc, vc, Tl)
    delta = (doc * o).sum(-1)
    dq_in = None if hop == 0 else tat.ring_hop_bwd_dq_plain(qc, kc, vc, doc, lse, delta, None, 0,
                                                            Tl, dtype=bf)
    ref = tat.ring_hop_bwd_dq_plain(qc, kc, vc, doc, lse, delta, dq_in, hop, Tl, dtype=bf)
    got = _emulate_ring_dq(qc, kc, vc, doc, lse, delta, dq_in, hop, Tl, pair)
    outside = int(((got - ref).abs() > 1e-4 + 1e-3 * ref.abs()).sum())
    if pair:
        assert outside == 0
    else:
        assert outside > 1000, outside


def _split(x, parts):
    """x as the kernels carry it into a tensor-core product: its bf16 parts
    (parts=2: hi = bf16(x), lo = bf16(x - hi); parts=3 adds mid between
    them), or rounded to bf16 once (parts=1)."""
    out, r = [], x
    for _ in range(parts):
        out.append(r.to(torch.bfloat16).float())
        r = r - out[-1]
    return out


def _emulate_ring_fwd(q, k, v, carry, hop, t_valid, parts, tile=64):
    """Kernel K's arithmetic for every ring position of a one-card launch,
    in f32 on the CPU: S from the bf16 operands with f32 sums, dead pairs
    (global positions, keys past t_valid) at NEG_INF; one online-softmax
    step a 64-key tile in log2 units, the carry's m converted at entry (m
    log2 e) and at exit (m ln 2); P = 2^(S scale log2 e - m) carried into
    P v in `parts` bf16 parts (_split); l adds the f32 P. Rows at or past
    t_valid are computed from q as it lies."""
    bf = torch.bfloat16
    P, BH, Tp, D = q.shape
    log2e = math.log2(math.e)
    sl2 = (1.0 / math.sqrt(D)) * log2e
    r = torch.arange(Tp)
    outs = ([], [], [])
    for j, kv, qs, ks in tat._hop_items(P, hop, t_valid, 0, P):
        qf, kf, vf = (u.to(bf).float() for u in (q[j], k[kv], v[kv]))
        live = (qs + r[:, None] >= ks + r[None, :]) & (r[None, :] < t_valid)
        s = (qf @ kf.transpose(-1, -2)).masked_fill(~live, tat.NEG_INF)
        if carry is None:
            acc, m = torch.zeros((BH, Tp, D)), torch.full((BH, Tp), tat.NEG_INF)
            l = torch.zeros((BH, Tp))
        else:
            acc, m, l = carry[0][j], carry[1][j] * log2e, carry[2][j]
        for k0 in range(0, t_valid, tile):
            st, vt = s[..., k0:k0 + tile], vf[:, k0:k0 + tile]
            m_new = torch.maximum(m, st.max(-1).values * sl2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(st * sl2 - m_new[..., None])
            acc = acc * alpha[..., None] + sum(u @ vt for u in _split(p, parts))
            l, m = l * alpha + p.sum(-1), m_new
        for o, u in zip(outs, (acc, m * math.log(2.0), l)):
            o.append(u)
    return tuple(torch.stack(o) for o in outs)


def _emulate_ring_dkv(q, k, v, do, lse, delta, dkv, hop, t_valid, pair):
    """Kernel M's arithmetic for every ring position of a one-card launch,
    in f32 on the CPU: the transposed S^T and dP^T from the bf16 operands
    with f32 sums, P = 2^(S scale log2 e - lse log2 e) under the
    global-position mask, dS = P (dP - delta); dV += P^T dO and dK += dS^T
    Q, P and dS each carried as a hi/lo pair (pair) or rounded to bf16
    once. Queries at or past t_valid add nothing (the kernel loads them as
    zeros), and keys at or past t_valid keep the carry."""
    bf = torch.bfloat16
    P, BH, Tp, D = q.shape
    log2e = math.log2(math.e)
    r = torch.arange(Tp)
    dk = torch.empty(k.shape)
    dv = torch.empty(k.shape)
    for j, kv, qs, ks in tat._hop_items(P, hop, t_valid, 0, P):
        qf, kf, vf, dof = (u.to(bf).float() for u in (q[j], k[kv], v[kv], do[j]))
        p = torch.exp2((qf @ kf.transpose(-1, -2)) * (log2e / math.sqrt(D))
                       - lse[j][..., None] * log2e)
        live = ((qs + r[:, None] >= ks + r[None, :]) & (r[None, :] < t_valid)
                & (r[:, None] < t_valid))
        p = p.masked_fill(~live, 0.0)
        ds = p * (dof @ vf.transpose(-1, -2) - delta[j][..., None])
        n_parts = 2 if pair else 1
        gv = sum(u.transpose(-1, -2) @ dof for u in _split(p, n_parts))
        gk = sum(u.transpose(-1, -2) @ qf for u in _split(ds, n_parts)) / math.sqrt(D)
        dk[kv], dv[kv] = (gk, gv) if dkv is None else (dkv[0][kv] + gk, dkv[1][kv] + gv)
    return dk, dv


def _seq4_ring(B=1, H=2, seed=3, n=4, T=784, D=32):
    """pixel_transformer's ring of 4 (T=784, D=32, t_valid 196 in 256-row
    chunks) at BH=B*H: bf16-valued q, k, v, dO chunks, and lse and delta
    from the forward ring."""
    bf = torch.bfloat16
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, H, T, D).astype(np.float32)).to(bf).float()
                   for _ in range(4))
    Tl = T // n
    Tp = tat._pick_chunk_blk(Tl)[1]
    qc, kc, vc, doc = (_chunks(u, n, Tp, torch.float32) for u in (q, k, v, do))
    o, lse = ring_forward(qc, kc, vc, Tl)
    return Tl, qc, kc, vc, doc, lse, (doc * o).sum(-1)


def _outside(got, ref, atol, rtol):
    return sum(int((~((g - r).abs() <= atol + rtol * r.abs())).sum()) for g, r in zip(got, ref))


@pytest.mark.parametrize('hop', [0, 1])
@pytest.mark.parametrize('parts', [3, 2, 1])
def test_ring_fwd_as_three_bf16_parts_holds_the_plain_hop(hop, parts):
    """Why Kernel K carries P into P v in three bf16 parts, and that its
    log2 units and the conversion of the carry's m at entry and exit cost
    nothing: on pixel_transformer's ring of 4 at BH=32, the emulated kernel
    with P as hi + mid + lo holds ring_hop_fwd_plain(dtype=bf16) within
    chip_smoke.py's atol 2e-5 + rtol 2e-4 on acc, m and l at the first hop
    and at a carry hop (the carry from the plain first hop). A hi/lo pair,
    which holds Kernel C's normalised o, misses it on a few elements of the
    unnormalised acc where |acc| is small (4 and 2 of 1114112 outputs at
    seed 3; at the card's BH=256, 26-35, up to 4.7e-5 off); P rounded once
    misses it on half of them (711103 and 532774)."""
    Tl, qc, kc, vc, doc, lse, delta = _seq4_ring(B=8, H=4)
    bf = torch.bfloat16
    carry = None if hop == 0 else tat.ring_hop_fwd_plain(qc, kc, vc, None, 0, Tl, dtype=bf)
    ref = tat.ring_hop_fwd_plain(qc, kc, vc, carry, hop, Tl, dtype=bf)
    got = _emulate_ring_fwd(qc, kc, vc, carry, hop, Tl, parts)
    outside = _outside(got, ref, 2e-5, 2e-4)
    if parts == 3:
        assert outside == 0
    elif parts == 2:
        assert outside > 0
    else:
        assert outside > 100000, outside


@pytest.mark.parametrize('hop', [0, 1])
@pytest.mark.parametrize('pair', [True, False])
def test_ring_dkv_as_bf16_pairs_holds_the_plain_hop(hop, pair):
    """Why Kernel M carries P and dS as bf16 pairs: on pixel_transformer's
    ring of 4, the emulated kernel with both as hi/lo pairs holds
    ring_hop_bwd_dkv_plain(dtype=bf16) within chip_smoke.py's atol 1e-4 +
    rtol 1e-3 on dk and dv at the first hop and at a carry hop; both
    rounded to bf16 once miss it (9940 and 6082 of 131072 outputs at
    seed 3)."""
    Tl, qc, kc, vc, doc, lse, delta = _seq4_ring()
    bf = torch.bfloat16
    dkv = None if hop == 0 else tat.ring_hop_bwd_dkv_plain(qc, kc, vc, doc, lse, delta, None, 0,
                                                           Tl, dtype=bf)
    ref = tat.ring_hop_bwd_dkv_plain(qc, kc, vc, doc, lse, delta, dkv, hop, Tl, dtype=bf)
    got = _emulate_ring_dkv(qc, kc, vc, doc, lse, delta, dkv, hop, Tl, pair)
    outside = _outside(got, ref, 1e-4, 1e-3)
    if pair:
        assert outside == 0
    else:
        assert outside > 1000, outside
