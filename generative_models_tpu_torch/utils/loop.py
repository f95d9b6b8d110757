"""The sampling loops' helpers: one body a step for the live path and for
an artifact that torch.export writes (serve.py --export).

  fori_loop -- body(t, carry) -> carry for t in range(start, stop). Called
               eagerly it is a plain Python loop with an int t, so the live
               path keeps its launches; under torch.export it emits one
               while_loop node, whatever the count, whose counter is a
               0-dim int64 tensor on the host: the loop's condition never
               reads the device, and the body sees t as t.item(), a host
               read, which indexes and slices the device tensors as views.
  pick      -- a step's choice between two tensors (diffusion's first
               and last steps): an if when eager, torch.where under export.
  when      -- a step's data-dependent branch (gated_pixel_cnn's row
               update): an if when eager, torch.cond under export.
  write     -- buf[index] = value: in place when eager, out of place under
               export (whose loops take no in-place write to a carried
               tensor); the values are the same, so an artifact serves
               bitwise what the live path does. Out of place costs a copy
               of the whole buffer a write, on the artifact's path only.
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


def fori_loop(start, stop, body, carry):
    """carry after body(t, carry) for t = start .. stop - 1 (start and stop
    ints)."""
    if not exporting():
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


def pick(pred, a, other):
    """a if pred else other(), other a function giving a tensor of a's
    shape: a step's data-dependent choice (diffusion's first and last
    steps). Eager a Python choice, other() called only when taken; under
    export torch.where over both."""
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
    slices over buf's leading dims. Eager: in place, returns buf. Under
    export: a new tensor, buf untouched."""
    index = index if isinstance(index, tuple) else (index,)
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
