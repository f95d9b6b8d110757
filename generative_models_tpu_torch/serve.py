"""Serving path: build (or load) a model and serve samples on the card.

Counterpart of generative_models_tpu/serve.py:

  python -m generative_models_tpu_torch.serve --model=pixel_transformer \
      --n=25 --out=grid.png                        # one-shot
  python -m generative_models_tpu_torch.serve --model=pixel_transformer \
      --weights_from=logs/model.pt --port=8000     # HTTP server
  python -m generative_models_tpu_torch.serve --model=vqvae --n=25 --out=vq.png
  python -m generative_models_tpu_torch.serve --model=made --hidden_size=2048 \
      --n=25 --out=made.png                        # Kernel G, 784 forwards
  python -m generative_models_tpu_torch.serve --model=made --quantize=int8 \
      --n=25 --out=made8.png                       # w8a8 through Kernel I
  python -m generative_models_tpu_torch.serve --model=diffusion_model \
      --port=8000                                  # /sample?n=16&y=3
  python -m generative_models_tpu_torch.serve --model=gan --n=25 --out=gan.png
  python -m generative_models_tpu_torch.serve --model=wavenet --quantize=w8a16 \
      --n=25 --out=wn.png                          # nine res1x1 through Kernel J
  python -m generative_models_tpu_torch.serve --model=pixel_transformer \
      --export=pt.pt2                              # write an artifact and exit
  python -m generative_models_tpu_torch.serve --from_export=pt.pt2 \
      --port=8000                                  # serve it, no model code

Serving shape, as in the JAX package:
  * requests are padded up to a fixed --serve_bs and sliced back down, so
    every request runs the same batch (the kernels see one shape);
  * the server is warmed at startup (kernel build, then the passes that
    capture its CUDA graphs: every sampler runs as graphs on the card,
    models/base.py pass_graphs, so request #1 replays them);
  * requests serialize through a lock (one card, one stream); the HTTP
    layer is stdlib ThreadingHTTPServer;
  * --coalesce_ms=W micro-batches concurrent unseeded requests into one
    padded pass; seeded requests run solo (the seed pins the whole batch);
  * /healthz reports rolling latency stats; /sample?n=16&seed=3 returns a
    PNG grid (stdlib zlib PNG encoder);
  * a class-conditional model (--class_cond=1: diffusion_model) takes labels
    y: one label broadcasts to n, or n of them, each in [-1, 10) (-1 =
    unconditional); the batch past n is padded with -1, and coalesced
    requests pack their labels at their offsets (/sample?n=16&y=3 or
    y=1,2,3). An unconditional server refuses labels. The CLI takes none,
    as the JAX package's.

Post-training quantization: --quantize=int8 (= w8a8) or w8a16 quantizes
every nn.Linear with both dims >= 64 and >= 16384 elements, and MADE's
masked layers with each mask folded in, once at startup (ops/int8.py
build_quant_table); every pass then runs those products through Kernel I
(w8a8: int8 activations and weights, int32 sums) or Kernel J (w8a16: bf16
activations, int8 weights widened on chip). The table is passed to the
model's serving fn as quant=; pixel_transformer's and the vqvae prior's
decode steps then run module by module, without Kernels A and B. rnn's
table holds wh and wavenet's its nine res1x1 (blocks.{i}.res1x1); the
pixel CNNs and wavenet --use_resblock=0 have nothing large enough, and
exit, as the JAX package's server does.

Every served batch is in [0, 1]: a model whose samples are in another
range (SAMPLE_RANGE: gan's and diffusion's [-1, 1]) is mapped to it by
its serving fn. A seed becomes torch.Generator(device).manual_seed(seed):
the same seed (and labels) gives the same batch on the same card.
diffusion_model's --quantize holds the UNet's embedding MLPs and ResBlock
emb projections (models/diffusion/unet.py), from the net sampling reads
(the EMA copy under --ema). --mesh=seq:N serves
pixel_transformer with its scoring forward through the ring (sampling
takes the per-op decode chain) and refuses --quantize, as the JAX package
does.

Serving over ranks: under a process group (torchrun, one process a mesh
slot, as for training) every rank builds the model on the mesh and runs
every pass. Rank 0 parses the requests, keeps the coalescing dispatcher
and the HTTP front, and before each pass broadcasts the request's (n,
seed, labels) to the other ranks, which loop on that broadcast until a
stop message (SampleServer.follow); an unseeded request's seed is rank
0's. On a data axis (serve_bs divisible by its size) each rank makes the
whole batch's draws from the seed, runs its rows, and the data axis's
ranks gather the batch; a model axis runs the TP decode, a pipe axis its
stages and an expert axis its experts (models/pixel_transformer.py,
models/moe.py), each rank on the same rows. --quantize is refused with any
axis but data above 1, as the JAX package's. Without a group the server
is one process: the axes of a checkpoint's mesh that span ranks (data,
model, pipe, expert) and its --fsdp are dropped, its seq axis kept (the
one-card ring); under a group the checkpoint's mesh is inherited, unless
--mesh says otherwise. --export and --from_export run in one process: an
artifact is the one-process program of the mesh-free model.pt.

A pass is two parts (models/base.py): the draws of the model's
draw_spec, from the seed's generator in a fixed order (uniforms (T, n) or
(T, n, K); vae's z, gan's noise; diffusion's noise, then w, then the noisy
sampler's (S, n, 28, 28, 1) step noise), and the ServingProgram, an
nn.Module forward(*draws[, y]) -> (n, H, W, 1) in [0, 1] that holds the
weights (the EMA copy under --ema, the int8 table under --quantize).

Deployment artifacts: --export=path writes the live server's program
through torch.export (export_serving: every sampling loop one while_loop
node, every serving kernel a gmt:: op node) with a serving.json beside it
in the archive (serve_bs, class_cond, the draw spec, model, quantize mode,
device type), prints its byte count and exits; --from_export=path serves
it (ExportedServer) with no model code: nothing of models/ is imported.
An artifact serves on the device type that wrote it, and at the same seed
(and labels) gives bitwise the live server's batch on the same device.
The JAX artifact takes a raw PRNG key; this one's server makes the draws
from the seed, as a torch.Generator cannot be an exported input.
"""

import contextlib
import json
import os
import struct
import threading
import time
import zlib
from pathlib import Path

import numpy as np


def png_encode(img):
    """uint8 (H, W), (H, W, 1) or (H, W, 3) -> PNG bytes (stdlib only)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'png_encode wants uint8, got {img.dtype}')
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0  # grayscale
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2  # truecolor
    else:
        raise ValueError(f'png_encode wants (H,W[,1|3]), got {img.shape}')
    h, w = img.shape[:2]
    raw = b''.join(b'\x00' + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        body = tag + data
        return struct.pack('>I', len(data)) + body + struct.pack(
            '>I', zlib.crc32(body)
        )

    ihdr = struct.pack('>IIBBBBB', w, h, 8, color, 0, 0, 0)
    return (
        b'\x89PNG\r\n\x1a\n'
        + chunk(b'IHDR', ihdr)
        + chunk(b'IDAT', zlib.compress(raw, 6))
        + chunk(b'IEND', b'')
    )


def program_fn(program, spec, device, n, class_cond, deterministic=False):
    """(seed) -> (n, H, W, 1) float32 numpy, or (seed, y) with y the n
    labels (None: -1, unconditional) of a class-conditional program: the
    draws of spec from torch.Generator(device).manual_seed(seed)
    (utils/dists.py draw), then program(*draws[, y]) without autograd;
    deterministic: on cuDNN's deterministic algorithms. One device-to-host
    copy, the batch."""
    import torch

    from generative_models_tpu_torch.ops.common import deterministic_convs
    from generative_models_tpu_torch.utils.dists import draw

    @torch.no_grad()
    def run(seed, y=None):
        args = draw(spec, torch.Generator(device).manual_seed(int(seed)), device)
        if class_cond:
            y = -np.ones((n,), np.int32) if y is None else np.asarray(y, np.int32)
            # staged from pageable memory, so the host may reuse y at once;
            # non_blocking: no stream sync, the batch's copy is the only one
            args += (torch.from_numpy(y).to(device, non_blocking=True),)
        with deterministic_convs() if deterministic else contextlib.nullcontext():
            return program(*args).cpu().numpy()

    if class_cond:
        return run
    return lambda seed: run(seed)


def batch_axes(model, n):
    """The batch axis of each draw of model.draw_spec(n): the axis whose
    size changes with n (dim 1 of a (T, n, ...) uniform table, dim 0 of a
    noise batch)."""
    return [next(i for i, (a, b) in enumerate(zip(s1, s2)) if a != b)
            for (_, s1, _), (_, s2, _) in zip(model.draw_spec(n), model.draw_spec(2 * n))]


def ranks_program_fn(model, program, spec, n, class_cond, deterministic=False):
    """program_fn over the ranks of a process group: each rank makes the
    whole batch's draws of spec (n rows) from the seed, runs program on its
    rows of the data axis (program: the pass of n / data rows; the model's
    FSDP roots unsharded), and the data axis's ranks gather the batch.
    Every rank of the group calls it at once (SampleServer's broadcast).
    Returns run(seed, y) and run_draws(full, y), the same pass on given
    draws of the whole batch."""
    import torch
    import torch.distributed as dist

    from generative_models_tpu_torch.ops.common import deterministic_convs
    from generative_models_tpu_torch.parallel.mesh import DATA_AXIS, data_slice, get_mesh
    from generative_models_tpu_torch.utils.dists import draw

    device, axes, rows = model.device, batch_axes(model, n), data_slice(n)
    group = get_mesh().group(DATA_AXIS)

    @torch.no_grad()
    def run_draws(full, y=None):
        args = tuple(d.narrow(a, rows.start, rows.stop - rows.start).contiguous()
                     for d, a in zip(full, axes))
        if class_cond:
            y = -np.ones((n,), np.int32) if y is None else np.asarray(y, np.int32)
            args += (torch.from_numpy(y[rows].copy()).to(device),)
        with deterministic_convs() if deterministic else contextlib.nullcontext(), \
                model.unsharded():
            out = program(*args).contiguous()
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, out, group=group)
        return torch.cat(parts).cpu().numpy()

    def run(seed, y=None):
        return run_draws(draw(spec, torch.Generator(device).manual_seed(int(seed)), device), y)

    return run, run_draws


def tile_grid(x, cols=None):
    """(n, H, W, C) float [0,1] -> uint8 (rows*H, cols*W, C) grid,
    zero-padding the last row."""
    from generative_models_tpu_torch.utils.logger import _to_hwc_uint8, grid_image

    x = np.asarray(x, np.float32)
    n, h, w, c = x.shape
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    canvas = np.zeros((rows * cols, h, w, c), np.float32)
    canvas[:n] = x
    return _to_hwc_uint8(grid_image(canvas, rows, cols), expand=False)


class _ServerBase:
    """Shared serving mechanics: pad-to-serve_bs label handling, the
    request lock (the card is a single stream), request coalescing, rolling
    latency stats. Subclasses set _call(seed) (or _call(seed, y) when
    class-conditional) -> (serve_bs, H, W, 1) numpy and _model_name()."""

    def _init_serving(self, serve_bs, class_cond=False):
        self.serve_bs = int(serve_bs)
        self.class_cond = bool(class_cond)
        self.n_classes = 10  # valid labels: -1 (unconditional) .. 9
        self.quant_mode = ''  # '' | 'w8a8' | 'w8a16' (ops/int8.py)
        self.quant_kernels = 0
        self._lock = threading.Lock()
        self._requests = 0
        self.seeds = []  # every pass's seed, in order
        # unseeded requests draw from a urandom-salted stream so restarts
        # and replicas never replay the same samples
        self._salt = int.from_bytes(os.urandom(4), 'little')
        self.latencies = []
        self.warm_sec = None
        self.warm_passes = 1  # warm()'s passes
        self.coalesce_ms = 0.0
        # backstop so a dispatcher death can never hang requests forever
        self.coalesce_timeout_sec = 120.0
        self.coalesced_batches = 0
        self.coalesced_requests = 0
        self._queue = []
        self._queue_cv = threading.Condition()
        self._dispatcher = None

    def warm(self):
        """Build the kernels and run warm_passes passes so request #1 is
        fast: one, or, where the pass is graphed, the eager pass and the
        capture (utils/graphs.py WARMUP), so that request #1 replays."""
        t0 = time.time()
        for _ in range(self.warm_passes):
            self._run(0, self._pad_y(None, self.serve_bs))
        self.warm_sec = time.time() - t0
        return self.warm_sec

    def _validate_y(self, y, n):
        """One request's labels as exactly n: a single label broadcasts to
        n, otherwise len(y) must be n; each must lie in [-1, n_classes)
        (the UNet's one-hot maps a label out of range to zeros, which would
        silently drop the conditioning)."""
        y = np.asarray(y, np.int32).reshape(-1)
        if len(y) == 1:
            y = np.repeat(y, n)
        if len(y) != n:
            raise ValueError(f'len(y)={len(y)} must be 1 or n={n}')
        if ((y < -1) | (y >= self.n_classes)).any():
            raise ValueError(
                f'labels must be in [-1, {self.n_classes}) (-1 = unconditional); '
                f'got {int(y.min())}..{int(y.max())}'
            )
        return y

    def _request_y(self, y, n):
        """One request's n labels, validated, or None; an unconditional
        server refuses labels. The dispatcher packs a coalesced request's
        at its offset."""
        if y is None:
            return None
        if not self.class_cond:
            raise ValueError('this server is unconditional; got y')
        return self._validate_y(y, n)

    def _pad_y(self, y, n):
        """Labels for the whole serve_bs batch: the request's, then -1
        (unconditional) past n; None for an unconditional server."""
        y = self._request_y(y, n)
        if not self.class_cond:
            return None
        full = -np.ones((self.serve_bs,), np.int32)
        if y is not None:
            full[:n] = y
        return full

    def _run(self, seed, y_full, n=None):
        """One pass of the whole batch (n: the request's rows); on rank 0
        of a process group, the request broadcast to the other ranks
        first."""
        self._announce(1, n or self.serve_bs, seed, y_full)
        self.seeds.append(int(seed))
        return self._call(seed) if y_full is None else self._call(seed, y_full)

    def _announce(self, cmd, n=0, seed=0, y_full=None):
        """Nothing in one process (SampleServer broadcasts under a group)."""

    def sample(self, n, y=None, seed=None):
        """n samples (labels y: one broadcast to n, or n of them, for a
        class-conditional server) -> (n, H, W, 1) float array in [0, 1].
        With an explicit seed the request is reproducible (same seed and
        labels -> bitwise-same batch); without one, requests draw from a
        urandom-salted stream. With coalescing on, unseeded requests smaller
        than serve_bs share one padded pass. 1 <= n <= serve_bs; larger
        requests are refused."""
        n = int(n)
        if not 1 <= n <= self.serve_bs:
            raise ValueError(
                f'n={n} out of range [1, serve_bs={self.serve_bs}]; '
                'restart with a larger --serve_bs for bigger batches'
            )
        if self.coalesce_ms > 0 and seed is None and n < self.serve_bs:
            return self._sample_coalesced(n, y)
        y_full = self._pad_y(y, n)
        with self._lock:
            self._requests += 1
            s = int(seed) if seed is not None else self._salt + self._requests
            t0 = time.time()
            out = self._run(s, y_full, n)
            self._record_latency(time.time() - t0)
        return out[:n]

    def _record_latency(self, dt):
        self.latencies.append(dt)
        if len(self.latencies) > 1000:
            del self.latencies[:-1000]

    # ------------------------- request coalescing ------------------------ #
    def enable_coalescing(self, window_ms):
        """Start the micro-batching dispatcher: concurrent unseeded requests
        queued within window_ms of each other (and fitting in one serve_bs
        batch) run as one pass, each taking a disjoint slice."""
        self.coalesce_ms = float(window_ms)
        if self.coalesce_ms > 0 and self._dispatcher is None:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True
            )
            self._dispatcher.start()

    def _sample_coalesced(self, n, y=None):
        req = {'n': n, 'y': self._request_y(y, n), 'done': threading.Event(),
               't0': time.time(), 'out': None, 'err': None}
        with self._queue_cv:
            self._queue.append(req)
            self._queue_cv.notify_all()
        if not req['done'].wait(timeout=self.coalesce_timeout_sec):
            with self._queue_cv:
                if req in self._queue:
                    self._queue.remove(req)
            raise RuntimeError(
                f'coalesced request timed out after '
                f'{self.coalesce_timeout_sec:.0f}s (dispatcher dead?)'
            )
        if req['err'] is not None:
            raise req['err']
        return req['out']

    def _take_batch(self):
        """Block for the first request, then collect until the batch is full
        or the window (anchored at the oldest request) closes. Returns the
        packed requests in arrival order, total n <= serve_bs."""
        with self._queue_cv:
            while not self._queue:
                self._queue_cv.wait()
            deadline = self._queue[0]['t0'] + self.coalesce_ms / 1e3

            def packable():
                used, take = 0, []
                for r in self._queue:
                    if used + r['n'] <= self.serve_bs:
                        used += r['n']
                        take.append(r)
                return used, take

            used, take = packable()
            while used < self.serve_bs:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._queue_cv.wait(timeout=remaining)
                used, take = packable()
            for r in take:
                self._queue.remove(r)
            return take

    def _dispatch_loop(self):
        # every step after _take_batch sits inside the try: an exception is
        # delivered to the batch's waiters instead of killing the thread
        while True:
            batch = self._take_batch()
            try:
                y_full = None
                if self.class_cond:
                    y_full = -np.ones((self.serve_bs,), np.int32)
                    off = 0
                    for r in batch:
                        if r['y'] is not None:
                            y_full[off:off + r['n']] = r['y']
                        off += r['n']
                with self._lock:
                    self._requests += len(batch)
                    out = self._run(self._salt + self._requests, y_full,
                                    sum(r['n'] for r in batch))
                    self.coalesced_batches += 1
                    self.coalesced_requests += len(batch)
                    now = time.time()
                    for r in batch:
                        self._record_latency(now - r['t0'])
                off = 0
                for r in batch:
                    r['out'] = out[off:off + r['n']]
                    off += r['n']
            except Exception as e:  # deliver, don't kill the dispatcher
                for r in batch:
                    r['err'] = e
            finally:
                for r in batch:
                    r['done'].set()

    def _model_name(self):
        raise NotImplementedError

    def stats(self):
        lat = sorted(self.latencies)
        pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))] if lat else None
        return {
            'model': self._model_name(),
            'serve_bs': self.serve_bs,
            'class_cond': self.class_cond,
            'requests': self._requests,
            'warm_sec': self.warm_sec,
            'latency_p50_sec': pick(0.50),
            'latency_p90_sec': pick(0.90),
            'quantize': self.quant_mode or None,
            'quantized_kernels': self.quant_kernels,
            'coalesce_ms': self.coalesce_ms or None,
            'coalesced_batches': self.coalesced_batches,
            'coalesced_requests': self.coalesced_requests,
        }


def check_quantize_mesh(quantize, mesh):
    """--quantize on a mesh with an axis other than data above 1 is
    refused, as the JAX package's serve.py refuses it: the quantized
    weights do not compose with a sharded mesh."""
    from generative_models_tpu_torch.parallel import DATA_AXIS, parse_mesh_spec

    non_data = {a: n for a, n in parse_mesh_spec(str(mesh or '')) if a != DATA_AXIS and n > 1}
    if quantize and non_data:
        raise SystemExit(
            f'--quantize does not compose with a {non_data}-sharded mesh; serve '
            'quantized models on a single chip or a data-only mesh'
        )


class SampleServer(_ServerBase):
    """Owns the model and its serving fn. Every request pads to serve_bs,
    runs the same pass, and slices to n. quantize: '' | 'int8' (= 'w8a8') |
    'w8a8' | 'w8a16'; the weights are quantized once, here."""

    def __init__(self, model, serve_bs=64, quantize=''):
        self.model = model
        self._init_serving(serve_bs, model.G.get('class_cond', 0))
        quantize = quantize or ''
        self.quant_mode = {'int8': 'w8a8'}.get(quantize, quantize)
        if self.quant_mode not in ('', 'w8a8', 'w8a16'):
            raise SystemExit(f'--quantize={quantize}: choose int8|w8a8|w8a16')
        self.quant = None  # the QuantTable every pass applies
        if self.quant_mode:
            from generative_models_tpu_torch.ops.int8 import build_quant_table

            self.quant, self.quant_kernels = build_quant_table(model, self.quant_mode)
            if not self.quant_kernels:
                raise SystemExit(
                    f'--quantize: {model.G.model} has no Linear or masked layers '
                    'large enough to quantize (ops/int8.py thresholds)'
                )
        self.draw_spec = model.draw_spec(self.serve_bs)
        self.ranks = model.mesh.dm is not None  # serving over a process group's ranks
        if not self.ranks:
            if model.graphed_sampling():
                from generative_models_tpu_torch.utils.graphs import WARMUP

                self.warm_passes = WARMUP + 1
            self.program = model.serving_program(self.serve_bs, quant=self.quant).eval()
            self._call = program_fn(self.program, self.draw_spec, model.device, self.serve_bs,
                                    self.class_cond, model.SERVE_DETERMINISTIC_CONVS)
            return
        from generative_models_tpu_torch.parallel.mesh import DATA_AXIS

        d = model.mesh.size(DATA_AXIS)
        if self.serve_bs % d:
            raise SystemExit(f'--serve_bs={self.serve_bs} does not split over data:{d}')
        self.program = model.serving_program(self.serve_bs // d, quant=self.quant).eval()
        self._call, self.run_draws = ranks_program_fn(
            model, self.program, self.draw_spec, self.serve_bs, self.class_cond,
            model.SERVE_DETERMINISTIC_CONVS)
        self.is_main = model.mesh.is_main

    def _message(self, cmd, n=0, seed=0, y_full=None):
        """The int64 request message of a pass: cmd (0 stop, 1 run), the
        request's n, its seed, the batch's labels (-1 past n and for an
        unconditional server)."""
        import torch

        msg = torch.full((3 + self.serve_bs,), -1, dtype=torch.int64)
        msg[:3] = torch.tensor([cmd, n, seed])
        if y_full is not None:
            msg[3:] = torch.from_numpy(np.asarray(y_full, np.int64))
        return msg.to(self.model.device)

    def _announce(self, cmd, n=0, seed=0, y_full=None):
        """Rank 0 of a group: broadcast a request (or the stop) to every
        rank."""
        if self.ranks and self.is_main:
            import torch.distributed as dist

            dist.broadcast(self._message(cmd, n, seed, y_full), src=0)

    def follow(self):
        """A rank other than 0: run every pass rank 0 broadcasts, until its
        stop message."""
        import torch.distributed as dist

        while True:
            msg = self._message(0)
            dist.broadcast(msg, src=0)
            cmd, n, seed = (int(v) for v in msg[:3].tolist())
            if cmd == 0:
                return
            y = msg[3:].cpu().numpy().astype(np.int32) if self.class_cond else None
            self.seeds.append(seed)
            self._call(seed) if y is None else self._call(seed, y)

    def stop(self):
        """Rank 0 of a group: send the other ranks the stop message."""
        self._announce(0)


    def _model_name(self):
        return self.model.G.model

    def export_serving(self, path):
        """Write the live server's own program (self.program) as a
        torch.export artifact at path: the weights baked in, inputs the
        draws (and the labels of a class-conditional server), output the
        batch; serving.json in the archive records what ExportedServer
        needs to serve it. Returns the artifact's byte count."""
        import torch

        from generative_models_tpu_torch.utils.loop import serializable

        dev = self.model.device
        args = tuple(torch.zeros(shape, device=dev) for _, shape, _ in self.draw_spec)
        if self.class_cond:
            args += (-torch.ones((self.serve_bs,), dtype=torch.int32, device=dev),)
        meta = dict(
            serve_bs=self.serve_bs, class_cond=self.class_cond,
            draws=[dict(name=name, shape=list(shape), dtype='float32', kind=kind)
                   for name, shape, kind in self.draw_spec],
            model=self.model.G.model, quantize=self.quant_mode or None,
            quantized_kernels=self.quant_kernels, device=dev.type,
            deterministic_convs=self.model.SERVE_DETERMINISTIC_CONVS,
        )
        with torch.no_grad():
            ep = serializable(torch.export.export(self.program, args))
        torch.export.save(ep, path, extra_files={'serving.json': json.dumps(meta)})
        return os.path.getsize(path)


class ExportedServer(_ServerBase):
    """Serve an artifact written by SampleServer.export_serving: no model
    class, no params file, no config; the artifact is the model. It
    imports the ops that register the serving kernels and nothing of
    models/, makes the draws its serving.json records from each request's
    seed, and runs the exported program. Same sample()/stats()/warm()
    surface as SampleServer, so the HTTP front and the one-shot path work
    unchanged. device: where it serves ('' = cuda); an artifact written on
    another device type is refused."""

    def __init__(self, path, device=''):
        import torch

        import generative_models_tpu_torch.ops.decode_fused  # noqa: F401  (gmt:: ops)
        import generative_models_tpu_torch.ops.int8  # noqa: F401
        import generative_models_tpu_torch.ops.masked_dense  # noqa: F401
        from generative_models_tpu_torch.ops.common import resolve_device

        self.path = str(path)
        dev = resolve_device(device)
        extra = {'serving.json': ''}
        ep = torch.export.load(self.path, extra_files=extra)
        self.meta = meta = json.loads(extra['serving.json'])
        if meta['device'] != dev.type:
            raise ValueError(
                f'{self.path} was exported on {meta["device"]} and serves only there, '
                f'not on {dev.type}'
            )
        self._init_serving(meta['serve_bs'], meta['class_cond'])
        self.quant_mode = meta['quantize'] or ''
        self.quant_kernels = meta['quantized_kernels']
        self.draw_spec = [(d['name'], tuple(d['shape']), d['kind']) for d in meta['draws']]
        self.program = ep.module()
        self._call = program_fn(self.program, self.draw_spec, dev, self.serve_bs,
                                self.class_cond, meta['deterministic_convs'])

    def _model_name(self):
        return f'exported:{self.path}'


def _http_serve(server, port, host='127.0.0.1'):
    """stdlib HTTP front: GET /healthz (JSON), GET /sample?n=16&seed=3 or
    ?n=16&y=3 (PNG). Binds localhost by default (there is no auth)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == '/healthz':
                body = json.dumps(server.stats()).encode()
                return self._send(200, 'application/json', body)
            if url.path == '/sample':
                q = parse_qs(url.query)
                try:
                    n_default = str(min(25, server.serve_bs))
                    n = int(q.get('n', [n_default])[0])
                    seed = int(q['seed'][0]) if 'seed' in q else None
                    y = [int(v) for v in q['y'][0].split(',')] if 'y' in q else None
                except ValueError:
                    return self._send(400, 'text/plain', b'bad n/y/seed')
                try:
                    imgs = server.sample(n, y=y, seed=seed)
                except ValueError as e:
                    return self._send(400, 'text/plain', str(e).encode())
                except Exception as e:  # noqa: broad, last HTTP hop
                    # a failed pass must surface as a 500, not as a torn
                    # connection
                    return self._send(
                        500, 'text/plain', f'sampling failed: {e}'.encode()
                    )
                return self._send(200, 'image/png', png_encode(tile_grid(imgs)))
            return self._send(404, 'text/plain', b'try /healthz or /sample')

    return ThreadingHTTPServer((host, port), Handler)


def serve_defaults():
    """The training CLI's global flags plus the serving ones."""
    from generative_models_tpu_torch.utils.config import global_defaults

    DG = global_defaults()
    DG.serve_bs = 64
    DG.port = 0  # >0: run the HTTP server
    DG.host = '127.0.0.1'  # HTTP bind address (0.0.0.0 to expose; no auth)
    DG.n = 25  # one-shot sample count
    DG.out = Path('samples.png')
    DG.export = ''  # write a torch.export artifact here and exit
    DG.from_export = ''  # serve a torch.export artifact (no model build)
    DG.quantize = ''  # int8 post-training quant: int8|w8a8|w8a16 (ops/int8.py)
    DG.coalesce_ms = 0.0  # >0: micro-batch concurrent requests (window, ms)
    return DG


def serving_mesh(G, argv):
    """The mesh the server runs on: --mesh and --fsdp as given on the
    command line; under a process group a checkpoint's mesh (its hps.yaml)
    inherited; without one, the inherited axes that span ranks (data,
    model, pipe, expert) and --fsdp dropped, the seq axis kept (the
    one-card ring), so a model.pt trained on any mesh serves in one
    process."""
    from generative_models_tpu_torch.parallel.mesh import SEQ_AXIS, launched, parse_mesh_spec

    given = lambda flag: any(a == flag or a.startswith(flag + '=') for a in argv)
    if launched():
        return
    if not given('--mesh'):
        axes = parse_mesh_spec(str(G.get('mesh', '') or ''))
        G.mesh = ','.join(f'{a}:{n}' for a, n in axes if a == SEQ_AXIS or n == 1)
    if not given('--fsdp'):
        G.fsdp = 0


def load_server(argv=None):
    """Parse serve flags (two-phase parse plus --serve_bs/--port/--n/--out),
    build the model on --device (default cuda), load weights; or, with
    --from_export, load the artifact alone (the serving flags parsed, no
    model imported)."""
    import argparse
    import sys

    from generative_models_tpu_torch.utils.config import AttrDict, args_type, parse_args

    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser()
    for key, value in serve_defaults().items():
        parser.add_argument(f'--{key}', type=args_type(value), default=value)
    pre = AttrDict(parser.parse_known_args(argv)[0].__dict__)
    from generative_models_tpu_torch.parallel.mesh import launched

    if launched() and (str(pre.export) or str(pre.from_export)):
        raise SystemExit(
            '--export and --from_export run in one process, not under a process group: an '
            'artifact is the one-process program of the mesh-free model.pt')
    if str(pre.from_export):
        if str(pre.export):
            raise SystemExit(
                '--from_export serves an existing artifact; it cannot be '
                'combined with --export (which needs a model to trace)'
            )
        if str(pre.quantize):
            raise SystemExit(
                '--quantize applies when the serving graph is traced; an '
                'exported artifact is already baked (re-export with '
                '--quantize to get a quantized artifact)'
            )
        return ExportedServer(pre.from_export, pre.device), pre
    G, Model = parse_args(argv, DG=serve_defaults())
    serving_mesh(G, argv)
    check_quantize_mesh(G.quantize, G.mesh)
    model = Model(G=G)
    if G.weights_from != Path('.'):
        model.load_weights(G.weights_from)
    return SampleServer(model, serve_bs=G.serve_bs, quantize=G.quantize), G


def main(argv=None):
    server, G = load_server(argv)
    if str(G.get('export', '')):
        nbytes = server.export_serving(G.export)
        print(f'exported serving artifact: {G.export} ({nbytes} bytes)')
        return
    if getattr(server, 'ranks', False) and not server.is_main:
        server.follow()  # rank 0 takes the requests
        return
    try:
        _serve_main(server, G)
    finally:
        if getattr(server, 'ranks', False):
            server.stop()


def _serve_main(server, G):
    print(f'warming {G.model} serve_bs={server.serve_bs} ...', flush=True)
    warm = server.warm()
    print(f'warm in {warm:.2f}s', flush=True)
    if float(G.get('coalesce_ms', 0)) > 0:
        server.enable_coalescing(float(G.coalesce_ms))
    if int(G.port) > 0:
        httpd = _http_serve(server, int(G.port), host=str(G.get('host', '127.0.0.1')))
        print(f'serving on {G.host}:{G.port} (/healthz, /sample?n=16&seed=3)', flush=True)
        httpd.serve_forever()
        return
    n = int(G.n)
    if n > server.serve_bs:
        print(f'--n={n} exceeds --serve_bs={server.serve_bs}; clamping')
        n = server.serve_bs
    imgs = server.sample(n)
    Path(G.out).write_bytes(png_encode(tile_grid(imgs)))
    print(json.dumps(server.stats()))
    print(f'wrote {G.out}')


if __name__ == '__main__':
    main()
