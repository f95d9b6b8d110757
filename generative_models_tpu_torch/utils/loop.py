"""The sampling loops' helpers: one body a step for the live path and for
an artifact that torch.export writes (serve.py --export).

  fori_loop -- body(t, carry) -> carry for t in range(start, stop). Called
               eagerly it is a plain Python loop with an int t, so the live
               path keeps its launches; under torch.export it emits one
               while_loop node, whatever the count, whose counter is a
               0-dim int64 tensor on the host: the loop's condition never
               reads the device, and the body sees t as t.item(), a host
               read, which indexes and slices the device tensors as views.
               Given unroll=k >= 1, a utils/graphs.py StepGraphs (or
               PassGraphs) and its counter t (the third form, lax.scan's
               unroll: pixel_transformer's --decode_unroll, diffusion's
               chain, made's and rnn's passes), t is that 0-dim int64
               tensor on the carry's device, which the steps advance, and
               each k steps are one call of the StepGraphs: on the card one
               CUDA graph, captured once and replayed (stop - start) // k
               times, the remainder's r steps a second graph; uncaptured on
               the CPU. Given unroll=k and graphs without t (the fourth
               form, for a body whose t moves views: the pixel CNNs'
               windows, wavenet's ring slots), t stays a host int and each
               run of k steps is a graph of its own, keyed by its first
               step and replayed once a loop.
  take      -- x[t] along a dim: a view for an int t, a gather
               (index_select) for a device t, which no host read indexes.
  pick      -- a step's choice between two tensors (diffusion's first
               and last steps): an if when eager, torch.where over both
               under export and for a device predicate (the graphed
               chain's k == 0).
  when      -- a step's data-dependent branch (gated_pixel_cnn's row
               update): an if when eager, torch.cond under export.
  write     -- buf[index] = value: in place when eager, out of place under
               export (whose loops take no in-place write to a carried
               tensor); the values are the same, so an artifact serves
               bitwise what the live path does. Out of place costs a copy
               of the whole buffer a write, on the artifact's path only.
               A device index (the graphed loop's t) writes by index_copy_,
               at dim 0 or after leading full slices.
  serializable -- an exported program made ready for torch.export.save.

A body's carry is a pytree of tensors (tuples, lists, dicts). Under export
torch traces the body with dynamo, so it must trace whole (index with
select and narrow where an index derives from t: a tuple index that holds
a symbolic int is refused); an output that is one of the inputs is cloned,
as while_loop takes no output that aliases an input, and a body returns
no view of one.
"""

import operator

import torch
from torch.utils import _pytree as pytree


def exporting():
    """Whether torch.export is tracing the call."""
    return torch.compiler.is_exporting()


def fori_loop(start, stop, body, carry, unroll=0, graphs=None, t=None):
    """carry after body(t, carry) for t = start .. stop - 1 (start and stop
    ints). unroll >= 1 with graphs (a StepGraphs) and t (its 0-dim int64
    counter), or with graphs and no t (each run of unroll steps a graph of
    its own, t a host int): the graphed forms, whose carry, t and every
    tensor the body reads must be the same tensors at each call of the
    loop with these graphs (the graphs read their addresses); the carry is
    updated in place (a leaf the body returns anew is copied into the
    carry's) and returned."""
    if not exporting():
        if unroll:
            return _unrolled(start, stop, body, carry, unroll, graphs, t)
        for t in range(start, stop):
            carry = body(t, carry)
        return carry
    if stop <= start:
        return carry
    from torch._higher_order_ops.while_loop import while_loop

    leaves, spec = pytree.tree_flatten(carry)

    def cond(i, *xs):
        return i < stop

    def step(i, *xs):
        t = i.item()
        torch._check(t >= start)
        torch._check(t < stop)
        out = pytree.tree_leaves(body(t, pytree.tree_unflatten(list(xs), spec)))
        fresh = [o.clone() if any(o is x for x in xs) else o for o in out]
        return (i + 1, *fresh)

    i0 = torch.full((), start, dtype=torch.int64)  # on the host
    # dynamo traces the body; the shapes stay those of the program
    with torch._dynamo.config.patch(automatic_dynamic_shapes=False,
                                    assume_static_by_default=True):
        out = while_loop(cond, step, (i0, *leaves))
    return pytree.tree_unflatten(list(out[1:]), spec)


def _unrolled(start, stop, body, carry, k, graphs, t):
    """fori_loop's graphed forms. With a device t: the steps in groups of
    k, then the remainder, each group one call of graphs keyed (start,
    stop, size), t the fixed counter, set to start here and advanced by
    each step. Without: each run of k steps from s one call keyed (start,
    stop, s), its steps' host ints baked into its graph."""
    leaves = pytree.tree_leaves(carry)

    def group(steps):
        def run():
            c = carry
            for i in steps:
                c = body(t if t is not None else i, c)
                if t is not None:
                    t.add_(1)
            for a, b in zip(leaves, pytree.tree_leaves(c), strict=True):
                if b is not a:
                    a.copy_(b)
        return run

    if t is None:
        for s in range(start, stop, k):
            graphs((start, stop, s), group(range(s, min(s + k, stop))))
        return carry
    t.fill_(start)
    full, rest = divmod(stop - start, k)
    for _ in range(full):
        graphs((start, stop, k), group(range(k)))
    if rest:
        graphs((start, stop, rest), group(range(rest)))
    return carry


def take(x, t, dim=0):
    """x[t] along dim: x.select for an int t (a view), index_select for a
    0-dim device tensor t (the same values, read without a host sync)."""
    if isinstance(t, torch.Tensor):
        return x.index_select(dim, t.view(1)).squeeze(dim)
    return x.select(dim, t)


def pick(pred, a, other):
    """a if pred else other(), other a function giving a tensor of a's
    shape: a step's data-dependent choice (diffusion's first and last
    steps). Eager a Python choice, other() called only when taken; under
    export, and for a 0-dim device tensor pred, torch.where over both."""
    if isinstance(pred, torch.Tensor):
        return torch.where(pred, a, other())
    if not exporting():
        return a if pred else other()
    return torch.where(torch.scalar_tensor(pred, dtype=torch.bool, device=a.device), a, other())


def when(pred, fn, operands):
    """fn(*operands) if pred else operands, fn returning a tuple of
    tensors shaped as operands: a Python if when eager, torch.cond under
    export (where the untaken branch returns copies)."""
    if not exporting():
        return fn(*operands) if pred else tuple(operands)
    return tuple(torch.cond(pred, fn, lambda *xs: tuple(x.clone() for x in xs),
                            tuple(operands)))


def write(buf, index, value):
    """buf with buf[index] = value (value cast to buf's dtype and broadcast
    as an indexed assignment does). index: an int, or a tuple of ints and
    slices over buf's leading dims, or a 0-dim device tensor t, alone or
    after full slices (slice(None), ..., t: the graphed loop's step). Eager
    and for a device t: in place, returns buf. Under export: a new tensor,
    buf untouched."""
    index = index if isinstance(index, tuple) else (index,)
    if isinstance(index[-1], torch.Tensor):  # a device t: index t of dim len(index) - 1
        dim = len(index) - 1
        if any(i != slice(None) for i in index[:-1]):
            raise ValueError(f'a device index follows full slices only, not {index[:-1]}')
        row = value.to(buf.dtype).expand(buf.shape[:dim] + buf.shape[dim + 1:]).unsqueeze(dim)
        return buf.index_copy_(dim, index[-1].view(1), row)
    if not exporting():
        buf[index] = value
        return buf
    return _scatter(buf, index, value, 0)


def _scatter(buf, index, value, dim):
    if not index:
        return value.to(buf.dtype).expand(buf.shape)
    i, rest = index[0], index[1:]
    if isinstance(i, slice):
        if i == slice(None):
            return _scatter(buf, rest, value, dim + 1)
        start, stop = i.start or 0, buf.shape[dim] if i.stop is None else i.stop
        part = buf.narrow(dim, start, stop - start)
        return buf.slice_scatter(_scatter(part, rest, value, dim + 1), dim, start, stop)
    return buf.select_scatter(_scatter(buf.select(dim, i), rest, value, dim), dim, i)


def serializable(ep):
    """ep with each torch.sym_sum node of its graphs (dynamo writes one for
    a sum of symbolic ints, such as an index derived from t, and
    torch.export.save takes none) rewritten as a chain of additions, and
    without the Python stack trace of each node, which would make most of
    a saved artifact. Returns ep, rewritten in place."""
    for gm in ep.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            node.meta.pop('stack_trace', None)
        for node in [n for n in gm.graph.nodes if n.target is torch.sym_sum]:
            val = lambda a: a.meta['val'] if isinstance(a, torch.fx.Node) else a
            terms = list(node.args[0])
            acc = terms[0]
            with gm.graph.inserting_before(node):
                for term in terms[1:]:
                    total = gm.graph.call_function(operator.add, (acc, term))
                    total.meta['val'] = val(acc) + val(term)
                    acc = total
            node.replace_all_uses_with(acc)
            gm.graph.erase_node(node)
        gm.recompile()
    return ep
