"""``HybridBlock.hybridize`` on the card (counterpart of
``incubator_mxnet_tpu/gluon/_functional.py`` and the compiled call of
``gluon/block.py``, MXNet's CachedOp).

A hybridized block on a CUDA device keeps one captured call per
signature: the training flag, whether the call records a backward, the
structure of its arguments (tensors, None, and tuples, lists and dicts of
them, as the word-LM call ``model(x, [h, c])`` passes) and its tensors'
shapes, dtypes and gradient needs (the JAX package keys its
compiled programs the same way, ``block.py:341``). The first call of a
signature runs eagerly (which also finishes deferred initialisation); at
its second call, once the first call's backward has set up what a
capture cannot (cuDNN builds its backward plans at their first use, and
allocates doing so), the forward is captured into a CUDA graph on static
copies of the inputs, with the parameters' storage bound, and replayed.
A call that records (``autograd.record()``, or torch's grad mode
for tensor inputs) also captures the forward's backward into a second
graph in the same memory pool, as ``torch.cuda.make_graphed_callables``
does, and returns outputs of one ``torch.autograd.Function``:

- its forward copies the inputs into the static buffers, replays the
  forward graph and returns fresh copies of the static outputs;
- its backward copies the output gradients in, replays the backward graph
  and returns copies of the gradients of the inputs and parameters, which
  reach each parameter's ``grad()`` through the post-accumulate hooks
  ("write" and "add" as for an eager backward).

State in the graph: batch norm's running statistics update inside the
forward graph; dropout draws from the device's default generator and
``nd.random`` from its own, both registered with the capture, so each
replay draws afresh. The graph reads the activations its forward wrote, so
a signature whose backward is still to run when it is called again takes
a second capture (its ``owner`` holds the first until that backward has
run or its outputs are dropped). The capture reads the parameters
through leaves of its own over the same storage, so no autograd node of
a graph the caller still holds (made on another stream) enters it. A parameter rebound to another tensor (``cast``, a
re-initialisation) or rewritten by ``set_data``/``load_parameters``
(``Parameter._version``) captures again at its next call (no eager run
first); ``Trainer.step`` updates in place and keeps the graphs. The captures live in an LRU bounded by
``MXTPU_EXEC_CACHE_SIZE``, the JAX package's bound of a hybridized block's
cache.

Inside ``plain()`` (a ``jit.TrainStep`` or ``EvalStep``, which capture or
serve the whole step themselves, and a hybridized block's own eager run
and capture, so graphs never nest) a hybridized block runs its plain
forward, and so does any block whose inputs are on the CPU: there
hybridize changes nothing, bit for bit. A capture that fails raises,
naming the block and the operation, gives its memory pool back and keeps
nothing; nothing runs eagerly in its place. The kernels launched in a
graph are counted at each replay (``_kernels.add_launches``), not at the
capture.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .. import autograd
from .. import config
from .. import jit
from ..ops import _kernels

__all__ = ["plain", "in_plain", "call"]


class _PlainState(threading.local):
    def __init__(self):
        self.depth = 0


_PLAIN = _PlainState()


@contextlib.contextmanager
def plain():
    """Hybridized blocks run their plain forward inside this scope."""
    _PLAIN.depth += 1
    try:
        yield
    finally:
        _PLAIN.depth -= 1


def in_plain():
    """True inside ``plain()`` or a rematerialised forward (whose
    recomputation runs in the backward, on autograd's thread)."""
    return _PLAIN.depth > 0 or autograd._in_remat()


def _uses_graphs(device):
    """Whether a block whose inputs are on ``device`` replays graphs."""
    return device.type == "cuda"


def _flatten(tree, leaves):
    """Append the leaves of ``tree`` (nested tuples, lists and dicts) to
    ``leaves``; return its structure, hashable, for ``_unflatten``."""
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(t, leaves) for t in tree))
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return (dict, keys, tuple(_flatten(tree[k], leaves) for k in keys))
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    """The tree of structure ``spec`` over the iterator ``leaves``."""
    if spec is None:
        return next(leaves)
    if spec[0] is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    return spec[0](_unflatten(s, leaves) for s in spec[1])


def _flat(out, name):
    """(the tensors of a forward's output, its structure): a tensor, or
    tuples and lists of them, nested."""
    outs = []
    spec = _flatten(out, outs)
    if not all(isinstance(o, torch.Tensor) for o in outs):
        raise TypeError("hybridized %s returned %s: a captured forward "
                        "returns tensors, or tuples and lists of them"
                        % (name, type(out).__name__))
    return outs, spec


def _rebuild(outs, spec):
    return _unflatten(spec, iter(outs))


def _plain_call(block, args, kwargs):
    """The block's forward through ``nn.Module.__call__``: the caller
    (``HybridBlock.__call__``) has run the MXNet hooks."""
    return torch.nn.Module.__call__(block, *args, **kwargs)


class _Instance:
    """One capture of a signature: the forward graph and, for a recording
    signature, the backward graph; their static inputs, outputs and
    gradient buffers; the kernel launches one replay of each makes; the
    parameter tensors it was captured on; and who holds its activations
    (``owner``: the call whose backward is still to run)."""

    def __init__(self):
        self.fwd = self.bwd = None
        self.inputs = []          # static inputs (None for a None argument)
        self.outputs = []         # static outputs
        self.kind = None          # how the outputs rebuild
        self.diff_out = []        # indices of outputs that carry gradients
        self.grad_outputs = []    # static output gradients
        self.grads = []           # static gradients of inputs, reached
        self.launches = ({}, {})  # (forward, backward) per replay
        self.params = []          # the parameter tensors bound
        self.reached = []         # those the backward gives a gradient
        self.owner = None


class _Lease:
    """Marks an instance's activations as taken until the backward that
    reads them has run, or its call's autograd graph is gone."""

    def __init__(self, inst):
        self.inst = inst
        inst.owner = self

    def release(self):
        if self.inst.owner is self:
            self.inst.owner = None

    def __del__(self):
        self.release()


class _Entry:
    """A signature's instances and the bindings they were captured on."""

    def __init__(self, bindings, eager=False):
        self.bindings = bindings
        self.instances = []
        self.eager = eager        # its first call ran parallel.shard_map


class _Replay(torch.autograd.Function):
    """One replay of a recording instance: forward graph now, backward
    graph when autograd reaches it. Arguments: the instance, then the call's
    inputs (None where the call passed None) and the parameter tensors the
    backward reaches (the others are read from their storage and, as in an
    eager backward, left out of it)."""

    @staticmethod
    def forward(ctx, inst, *tensors):
        outs = _run_forward(inst, tensors[:len(inst.inputs)])
        ctx.inst = inst
        ctx.lease = _Lease(inst)
        ctx.mark_non_differentiable(*[o for i, o in enumerate(outs)
                                      if i not in inst.diff_out])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *out_grads):
        inst = ctx.inst
        for buf, i in zip(inst.grad_outputs, inst.diff_out):
            if out_grads[i] is None:
                buf.zero_()
            else:
                buf.copy_(out_grads[i])
        inst.bwd.replay()
        _kernels.add_launches(inst.launches[1])
        ctx.lease.release()
        return (None,) + tuple(None if g is None else g.detach().clone()
                               for g in inst.grads)


def _run_forward(inst, inputs):
    """Copy ``inputs`` into the static buffers, replay the forward graph,
    return fresh copies of its outputs."""
    with torch.no_grad():
        for buf, x in zip(inst.inputs, inputs):
            if buf is not None:
                buf.copy_(x)
    inst.fwd.replay()
    _kernels.add_launches(inst.launches[0])
    return [o.detach().clone() for o in inst.outputs]


def _params(block):
    """The block's parameters, each once (a tied weight is one tensor)."""
    return list({id(p): p for p in block.collect_params().values()}
                .values())


def _bindings(params):
    return tuple((p._tensor().data_ptr(), p._version, p.grad_req)
                 for p in params)


def call(block, *args, **kwargs):
    """A hybridized block's call on tensors (``HybridBlock.__call__`` has
    unwrapped any NDArrays). Arguments are tensors, None, or tuples,
    lists and dicts of them."""
    inputs = []
    spec = _flatten((args, kwargs), inputs)
    for x in inputs:
        if x is not None and not isinstance(x, torch.Tensor):
            raise TypeError("hybridized %s takes arrays (or None), or lists "
                            "of them, got %s"
                            % (type(block).__name__, type(x).__name__))
    device = next((x.device for x in inputs if x is not None), None)
    if device is None or not _uses_graphs(device):
        with plain():
            return _plain_call(block, args, kwargs)
    recording = torch.is_grad_enabled()
    sig = (autograd.is_training(), recording, spec, tuple(
        None if x is None else (tuple(x.shape), x.dtype, x.requires_grad)
        for x in inputs))
    cache = block._graphs
    entry = cache.pop(sig, None)
    params = _params(block)
    if entry is None or any(p._data is None for p in params):
        from ..parallel import compat
        with plain():
            mapped, out = compat.tracking(
                lambda: _plain_call(block, args, kwargs))
        # a forward that runs shard_map launches from its positions'
        # threads: its signature stays eager
        _store(cache, sig, _Entry(_bindings(_params(block)), bool(mapped)))
        return out
    if entry.eager:
        _store(cache, sig, entry)
        with plain():
            return _plain_call(block, args, kwargs)
    bindings = _bindings(params)
    if entry.bindings != bindings:
        entry = _Entry(bindings)           # rebound or rewritten: again
    inst = next((i for i in entry.instances if i.owner is None), None)
    if inst is None:
        inst = _capture(block, spec, inputs, params, recording)
        entry.instances.append(inst)
    _store(cache, sig, entry)
    if inst.bwd is None:
        return _rebuild(_run_forward(inst, inputs), inst.kind)
    outs = _Replay.apply(inst, *inputs, *inst.reached)
    return _rebuild(list(outs), inst.kind)


def _store(cache, sig, entry):
    cache[sig] = entry
    config.evict_to_bound(cache)


def _capture(block, spec, inputs, params, recording):
    """Capture the block's forward (and, when ``recording`` and anything
    needs a gradient, its backward) for calls like this one (arguments of
    structure ``spec`` over ``inputs``); runs nothing."""
    name = type(block).__name__
    inst = _Instance()
    inst.inputs = [None if x is None else
                   x.detach().clone().requires_grad_(x.requires_grad)
                   for x in inputs]
    inst.params = [p._tensor() for p in params]
    # the capture reads the parameters' storage through leaves of its own,
    # so it reuses no autograd node of a graph the caller still holds
    # (those belong to the stream they were made on, not the capture's)
    aliases = [t.detach().requires_grad_(t.requires_grad)
               for t in inst.params]
    diff_in = [x for x in inst.inputs if x is not None and x.requires_grad]
    diff_params = [t for t in aliases if t.requires_grad]
    holder = {}

    def forward():
        static = inst.inputs
        saved = [p._data for p in params]
        for p, t in zip(params, aliases):
            p._data = t
        try:
            with plain(), torch.set_grad_enabled(recording):
                args, kwargs = _unflatten(spec, iter(static))
                out = _plain_call(block, args, kwargs)
        finally:
            for p, t in zip(params, saved):
                p._data = t
        holder["out"], holder["kind"] = _flat(out, name)
        return holder["out"]

    def backward():
        outs = [holder["out"][i] for i in inst.diff_out]
        got = torch.autograd.grad(outs, diff_in + diff_params,
                                  inst.grad_outputs, allow_unused=True)
        return list(got)

    cap = jit._GraphCapture(next(x for x in inputs if x is not None).device)
    what = "forward"
    try:
        with _kernels.collecting() as launches_fwd:
            inst.fwd, inst.outputs = cap.capture(forward)
        inst.kind = holder["kind"]
        inst.diff_out = [i for i, o in enumerate(inst.outputs)
                         if o.requires_grad]
        if recording and inst.diff_out and (diff_in or diff_params):
            what = "backward"
            inst.grad_outputs = [torch.empty_like(inst.outputs[i])
                                 for i in inst.diff_out]
            with _kernels.collecting() as launches_bwd:
                inst.bwd, got = cap.capture(backward, pool=cap.pool)
            by_id = dict(zip(map(id, diff_in + diff_params), got))
            inst.grads = [None if x is None else by_id.get(id(x))
                          for x in inst.inputs]
            for t, a in zip(inst.params, aliases):
                if by_id.get(id(a)) is not None:   # reached by the backward
                    inst.reached.append(t)
                    inst.grads.append(by_id[id(a)])
        else:
            launches_bwd = {}
            inst.diff_out = []
    except Exception as exc:
        first_error, where = jit._where(exc)
        raise RuntimeError(
            "hybridized %s: capturing the %s into a CUDA graph failed at "
            "%s: %s" % (name, what, where, first_error)) from exc
    inst.launches = (launches_fwd, launches_bwd)
    block._captures += 1
    return inst
