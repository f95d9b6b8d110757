"""CUDA graphs: the port's counterpart of jax.jit for a step (--jit_epoch=1)
and of lax.scan's unrolled body (--decode_unroll).

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

A capture or a replay that fails raises; nothing steps eagerly instead.
"""

import gc

import torch

from generative_models_tpu_torch.ops.common import kernel_counters

WARMUP = 1  # eager calls of a key before its capture


class CapturedGraph:
    """A function captured by torch.cuda.graph: replay() runs its kernels
    again; out is what the function returned at capture, the tensors each
    replay rewrites."""

    def __init__(self, fn, generators=()):
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
            with torch.cuda.graph(self.graph):
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
    default one."""

    def __init__(self, capture=True, generators=()):
        self.capture = capture
        self.generators = [g for g in generators if g.device.type == 'cuda']
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
            if done < WARMUP:
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
        return CapturedGraph(fn, self.generators)


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
