"""Serving path: build (or load) a model and serve samples on the card.

Counterpart of generative_models_tpu/serve.py:

  python -m generative_models_tpu_torch.serve --model=pixel_transformer \
      --n=25 --out=grid.png                        # one-shot
  python -m generative_models_tpu_torch.serve --model=pixel_transformer \
      --weights_from=logs/model.pt --port=8000     # HTTP server
  python -m generative_models_tpu_torch.serve --model=vqvae --n=25 --out=vq.png
  python -m generative_models_tpu_torch.serve --model=made --hidden_size=2048 \
      --n=25 --out=made.png                        # Kernel G, 784 forwards

Serving shape, as in the JAX package:
  * requests are padded up to a fixed --serve_bs and sliced back down, so
    every request runs the same batch (the kernels see one shape);
  * the server is warmed at startup (kernel build + one pass);
  * requests serialize through a lock (one card, one stream); the HTTP
    layer is stdlib ThreadingHTTPServer;
  * --coalesce_ms=W micro-batches concurrent unseeded requests into one
    padded pass; seeded requests run solo (the seed pins the whole batch);
  * /healthz reports rolling latency stats; /sample?n=16&seed=3 returns a
    PNG grid (stdlib zlib PNG encoder).

A seed becomes torch.Generator(device).manual_seed(seed): the same seed
gives the same batch on the same card. Not ported yet: --export,
--from_export and --quantize (utils/config.py refuses them).
"""

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
    """Shared serving mechanics: the request lock (the card is a single
    stream), request coalescing, rolling latency stats. Subclasses set
    _call(seed) -> (serve_bs, H, W, 1) numpy and _model_name()."""

    def _init_serving(self, serve_bs):
        self.serve_bs = int(serve_bs)
        self._lock = threading.Lock()
        self._requests = 0
        # unseeded requests draw from a urandom-salted stream so restarts
        # and replicas never replay the same samples
        self._salt = int.from_bytes(os.urandom(4), 'little')
        self.latencies = []
        self.warm_sec = None
        self.coalesce_ms = 0.0
        # backstop so a dispatcher death can never hang requests forever
        self.coalesce_timeout_sec = 120.0
        self.coalesced_batches = 0
        self.coalesced_requests = 0
        self._queue = []
        self._queue_cv = threading.Condition()
        self._dispatcher = None

    def warm(self):
        """Build the kernels and run one pass so request #1 is fast."""
        t0 = time.time()
        self._call(0)
        self.warm_sec = time.time() - t0
        return self.warm_sec

    def sample(self, n, y=None, seed=None):
        """n samples -> (n, H, W, 1) float array in [0, 1]. With an explicit
        seed the request is reproducible (same seed -> bitwise-same batch);
        without one, requests draw from a urandom-salted stream. With
        coalescing on, unseeded requests smaller than serve_bs share one
        padded pass. 1 <= n <= serve_bs; larger requests are refused."""
        if y is not None:
            raise ValueError('this server is unconditional; got y')
        n = int(n)
        if not 1 <= n <= self.serve_bs:
            raise ValueError(
                f'n={n} out of range [1, serve_bs={self.serve_bs}]; '
                'restart with a larger --serve_bs for bigger batches'
            )
        if self.coalesce_ms > 0 and seed is None and n < self.serve_bs:
            return self._sample_coalesced(n)
        with self._lock:
            self._requests += 1
            s = int(seed) if seed is not None else self._salt + self._requests
            t0 = time.time()
            out = self._call(s)
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

    def _sample_coalesced(self, n):
        req = {'n': n, 'done': threading.Event(), 't0': time.time(),
               'out': None, 'err': None}
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
                with self._lock:
                    self._requests += len(batch)
                    out = self._call(self._salt + self._requests)
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
            'requests': self._requests,
            'warm_sec': self.warm_sec,
            'latency_p50_sec': pick(0.50),
            'latency_p90_sec': pick(0.90),
            'coalesce_ms': self.coalesce_ms or None,
            'coalesced_batches': self.coalesced_batches,
            'coalesced_requests': self.coalesced_requests,
        }


class SampleServer(_ServerBase):
    """Owns the model and its serving fn. Every request pads to serve_bs,
    runs the same pass, and slices to n."""

    def __init__(self, model, serve_bs=64):
        if model.G.get('class_cond', 0):
            raise NotImplementedError('class-conditional serving is not ported yet')
        self.model = model
        self._init_serving(serve_bs)
        self._call = model.pure_serving_fn(self.serve_bs)

    def _model_name(self):
        return self.model.G.model


def _http_serve(server, port, host='127.0.0.1'):
    """stdlib HTTP front: GET /healthz (JSON), GET /sample?n=16&seed=3 (PNG).
    Binds localhost by default (there is no auth)."""
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
    DG.export = ''  # not ported yet
    DG.from_export = ''  # not ported yet
    DG.quantize = ''  # not ported yet
    DG.coalesce_ms = 0.0  # >0: micro-batch concurrent requests (window, ms)
    return DG


def load_server(argv=None):
    """Parse serve flags (two-phase parse plus --serve_bs/--port/--n/--out),
    build the model on --device (default cuda), load weights."""
    from generative_models_tpu_torch.utils.config import parse_args

    G, Model = parse_args(argv, DG=serve_defaults())
    model = Model(G=G)
    if G.weights_from != Path('.'):
        model.load_weights(G.weights_from)
    return SampleServer(model, serve_bs=G.serve_bs), G


def main(argv=None):
    server, G = load_server(argv)
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
