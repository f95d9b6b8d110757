"""CUDA graphs: the port's counterpart of jax.jit for a step (--jit_epoch=1),
of lax.scan's unrolled body (--decode_unroll) and of a jitted sampling pass
(PassGraphs: every sampler, on the card by default).

StepGraphs runs a step function over fixed buffers: the caller copies each
step's inputs into tensors the function reads, and the function leaves its
results in place or returns them. The first WARMUP calls of a key run the
function eagerly, on a side stream on the card; these are real steps, bitwise
the graphed ones. The next call captures it with torch.cuda.graph and replays
the graph once, and every later call replays it. A graph replays the kernels
of the eager path, the hand-written ones included, so a graphed step is
bitwise the eager one; the generators given (the model's training draws) are
registered with each graph, so their state after a replay is the eager one's,
and the default generator follows the graph's draws as torch.cuda.graph keeps
it. On the CPU, and where graphs are off, every call runs the function.

The kernel wrappers count their launches on the host (ops/common.py
KERNEL_COUNTERS), and a replay runs no Python: a capture runs the Python but
launches nothing. So StepGraphs restores every counter after a capture,
keeps the capture's increments and adds them once a replay, and the counts
equal the eager path's (chip_smoke.py's graphs phase holds them against
the kernels a traced replay launches).

A sampling pass (PassGraphs) copies its inputs into fixed buffers, runs
what precedes its loop as one graph (whose outputs, the loop's first carry
and tables, are then the same tensors at every pass), its loop as graphs
of k steps (utils/loop.py fori_loop) and what follows as one more; all of
a pass's graphs share one memory pool and warm up together: the first pass
runs eagerly, the second captures each graph, and later passes replay
them, so every graph reads the tensors that the graphs before it wrote.

A capture or a replay that fails raises; nothing steps eagerly instead.
"""

import gc

import torch

from generative_models_tpu_torch.ops.common import kernel_counters

WARMUP = 1  # eager calls of a key (a pass of PassGraphs) before its capture
PASS_GRAPHS_KEPT = 4  # a model's PassGraphs kept (kept), their buffers and pools with them


class CapturedGraph:
    """A function captured by torch.cuda.graph: replay() runs its kernels
    again; out is what the function returned at capture, the tensors each
    replay rewrites."""

    def __init__(self, fn, generators=(), pool=None):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        # cyclic garbage is collected before the capture and not during it:
        # a graph that the collector destroys (an old model's) invalidates
        # the capture under way (cudaErrorStreamCaptureInvalidated;
        # chip_smoke.py's graph_gc provokes it)
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = fn()
        finally:
            if enabled:
                gc.enable()

    def replay(self):
        self.graph.replay()


class StepGraphs:
    """One graph a key (a batch shape and micro-step kind, a decode
    segment's group of steps) of the step functions given to __call__.
    capture=False runs every call eagerly (the CPU, a process group);
    generators: the CUDA generators the functions draw from beside the
    default one; shared_pool: every graph in one memory pool (a pass's
    graphs, replayed in the order of their captures). While warming is
    set, no key is captured (PassGraphs' first pass)."""

    def __init__(self, capture=True, generators=(), shared_pool=False):
        self.capture = capture
        self.generators = [g for g in generators if g.device.type == 'cuda']
        self.pool = torch.cuda.graph_pool_handle() if capture and shared_pool else None
        self.warming = False
        self.graphs = {}  # key -> (graph, [(counter, increment a replay)])
        self.eager = {}  # key -> eager calls so far

    def __call__(self, key, fn):
        """fn()'s result for this call: fn run eagerly, or its graph
        replayed (its outputs then the graph's static tensors, rewritten by
        the next replay of this key)."""
        if not self.capture:
            return fn()
        entry = self.graphs.get(key)
        if entry is None:
            done = self.eager.get(key, 0)
            if done < WARMUP or self.warming:
                self.eager[key] = done + 1
                return _on_side_stream(fn)
            entry = self.graphs[key] = self._capture(fn)
        graph, delta = entry
        graph.replay()
        for counter, n in delta:
            counter.launches += n
        return graph.out

    def _capture(self, fn):
        """(graph, [(counter, the capture's increment)] of the counters it
        moved), every counter as it was before the capture."""
        counters = kernel_counters()
        before = [c.launches for c in counters]
        try:
            graph = self.captured(fn)
        finally:
            delta = [(c, c.launches - b) for c, b in zip(counters, before) if c.launches != b]
            for c, b in zip(counters, before):
                c.launches = b
        return graph, delta

    def captured(self, fn):
        """fn captured as a graph (replay() and out)."""
        return CapturedGraph(fn, self.generators, self.pool)


class PassGraphs:
    """A graphed sampling pass's fixed tensors and graphs, one a key of
    the pass (a batch size, sampler, net, quant table; GM.pass_graphs):
    the inputs' fixed buffers, refilled at each pass (start), the device
    counter t of its loop (utils/loop.py fori_loop's graphed form) and the
    StepGraphs of its stages, in one memory pool, capturing on the card
    from the second pass (uncaptured on the CPU). refs: what the key names
    by id (a quant table, a net), kept so that the id is not reused;
    generators: the CUDA generators its graphs draw from."""

    def __init__(self, device, generators=(), refs=()):
        self.graphs = StepGraphs(device.type == 'cuda', generators, shared_pool=True)
        self.t = torch.zeros((), dtype=torch.int64, device=device)
        self.refs = refs
        self.inputs = None
        self.passes = 0
        self.bufs = {}  # fixed()'s tensors

    def start(self, *inputs):
        """The inputs (tensors, or None) copied into the pass's fixed
        buffers, made at the first pass: returns the buffers."""
        self.passes += 1
        self.graphs.warming = self.passes <= WARMUP
        if self.inputs is None:
            self.inputs = tuple(None if x is None else torch.empty_like(x) for x in inputs)
        for buf, x in zip(self.inputs, inputs, strict=True):
            if buf is not None:
                buf.copy_(x)
        return self.inputs

    def fixed(self, name, make):
        """The pass's fixed tensor name (its graphs write and read it),
        made by make() at the first pass."""
        if name not in self.bufs:
            self.bufs[name] = make()
        return self.bufs[name]

    def __call__(self, key, fn):
        return self.graphs(key, fn)


def stage(graphs, key, fn):
    """fn() as a stage of a sampling pass: one graph of graphs (a
    PassGraphs) under key, its outputs the graph's fixed tensors; fn()
    itself where graphs is None (the per-step loop)."""
    return fn() if graphs is None else graphs(key, fn)


def kept(cache, key, make, limit):
    """cache[key], made by make() if absent, as the newest entry of the
    dict cache, which keeps the limit last used."""
    value = cache.pop(key, None)
    if value is None:
        value = make()
    cache[key] = value
    while len(cache) > limit:
        cache.pop(next(iter(cache)))
    return value


def _on_side_stream(fn):
    """fn() on a side stream of the current device, ordered after the work
    issued so far and before what follows (torch.cuda.graph's warm-up)."""
    if not torch.cuda.is_available() or torch.cuda.is_current_stream_capturing():
        return fn()
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out
