"""MXNet's imperative autograd over torch's (counterpart of
``incubator_mxnet_tpu/autograd.py``).

The JAX package keeps its own tape; the port lets ``torch.autograd``
record and differentiate, and keeps MXNet's contract on top:

- ``record(train_mode=True)`` turns recording on (torch's grad mode) and
  sets the training flag; ``pause(train_mode=False)`` turns recording off;
  ``train_mode()`` / ``predict_mode()`` set only the flag. The flag is
  thread-local and decides whether dropout is active (``nd.Dropout``) and
  whether batch norm uses the batch's statistics, where the JAX package's
  flag does. NDArray operations record only inside ``record()``.
- Variables are marked (``mark_variables``, ``NDArray.attach_grad``, every
  initialized ``gluon.Parameter``) with a ``grad_req``:

  * "write": a backward that reaches the variable replaces its gradient
    with this backward's; one that does not reach it leaves it as it was
    (the JAX package's ``_write_grad``);
  * "add": backwards add into the gradient;
  * "null": no gradient.

  ``NDArray.grad`` and ``Parameter.grad()`` are the variable's gradient
  (``_grad_array``); torch's ``.grad`` only passes it on (``_take_grad``).
- ``backward(heads, head_grads)`` seeds each head with ones (or the given
  gradients). ``grad(...)`` returns the gradients and leaves ``.grad``
  alone. ``Function`` is a custom differentiable function written in
  NDArray operations, run through ``torch.autograd.Function``.
- ``remat_contexts`` is the ``context_fn`` of ``jit.TrainStep``'s
  rematerialisation (``torch.utils.checkpoint``): the recomputation in
  the backward runs with the forward's flags, takes back the values the
  forward kept for it (``_remat_keep``: dropout masks, batch norm's
  running mean as it was) and leaves batch norm's running statistics alone
  (``_recomputing``), as ``jax.checkpoint`` does. It reads no generator
  state, so a CUDA graph can capture it.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        self.remat = None       # ("record" | "replay", _RematTape)


_STATE = _State()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(is_record):
    """Set the recording flag (and torch's grad mode); returns the old flag."""
    prev = _STATE.recording
    _STATE.recording = bool(is_record)
    torch.set_grad_enabled(_STATE.recording)
    return prev


def set_training(train_mode_):
    prev = _STATE.training
    _STATE.training = bool(train_mode_)
    return prev


class _Scope:
    """Set recording and/or training on entry, restore both on exit."""

    def __init__(self, is_record, train_mode_):
        self._record = is_record
        self._train = train_mode_
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training,
                      torch.is_grad_enabled())
        if self._record is not None:
            _STATE.recording = self._record
            torch.set_grad_enabled(self._record)
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training, grad_ = self._prev
        torch.set_grad_enabled(grad_)


def record(train_mode=True):
    """Scope in which operations are recorded for ``backward``."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    """Scope in which nothing is recorded."""
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


# ================================================================== remat

class _RematTape:
    """What a rematerialised forward leaves for its recomputation: the
    recording and training flags and the values it kept, in order."""

    def __init__(self):
        self.flags = None
        self.kept = []
        self.pos = 0


class _RematScope:
    """The forward's ("record") or the recomputation's ("replay") side of a
    ``_RematTape``. The recomputation runs on autograd's thread, whose
    flags are its own: "replay" sets the forward's."""

    def __init__(self, kind, tape):
        self._kind, self._tape = kind, tape
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training, _STATE.remat)
        if self._kind == "record":
            self._tape.flags = (_STATE.recording, _STATE.training)
        else:
            _STATE.recording, _STATE.training = self._tape.flags
            self._tape.pos = 0
        _STATE.remat = (self._kind, self._tape)
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training, _STATE.remat = self._prev


def remat_contexts():
    """(forward context, recomputation context) sharing one tape: the
    ``context_fn`` of a non-reentrant ``torch.utils.checkpoint``."""
    tape = _RematTape()
    return _RematScope("record", tape), _RematScope("replay", tape)


def _in_remat():
    """True inside a rematerialised forward or its recomputation."""
    return _STATE.remat is not None


def _remat_keep(make):
    """``make()`` (a random mask, a snapshot of a state the forward then
    updates), kept for the recomputation inside a rematerialised forward
    and taken back, in order, inside it."""
    if _STATE.remat is None:
        return make()
    kind, tape = _STATE.remat
    if kind == "record":
        value = make()
        tape.kept.append(value)
        return value
    value = tape.kept[tape.pos]
    tape.pos += 1
    return value


def _recomputing():
    """True inside the recomputation of a rematerialised forward."""
    return _STATE.remat is not None and _STATE.remat[0] == "replay"


# ================================================================ variables
# A variable's grad_req and the NDArray over its gradient ride on the tensor
# (_mx_req, _mx_grad). Torch's own .grad is scratch: backward accumulates
# into it from None, and _take_grad moves it into the gradient at once.

_REQS = ("write", "add", "null")


def _mark(tensor, grad_req="write"):
    """Mark a leaf tensor as a variable with ``grad_req``."""
    if grad_req not in _REQS:
        raise ValueError("grad_req must be one of %s, got %r"
                         % (_REQS, grad_req))
    tensor.requires_grad_(grad_req != "null")
    tensor.grad = None
    if grad_req == "null":
        tensor._mx_grad = None
    elif not hasattr(tensor, "_mx_hook"):
        tensor._mx_hook = tensor.register_post_accumulate_grad_hook(
            _take_grad)
    tensor._mx_req = grad_req


def _take_grad(tensor):
    """Move the gradient a backward just left in ``tensor.grad`` into the
    variable's gradient by its grad_req. Torch runs this hook only on the
    variables a ``backward`` reaches (``torch.autograd.grad`` runs none),
    so a variable it misses keeps its gradient, as the JAX package's
    ``_write_grad`` does."""
    from .ndarray import NDArray
    g, tensor.grad = tensor.grad, None
    if g is None:           # reached with no gradient: left as it was
        return
    buf = getattr(tensor, "_mx_grad", None)
    if buf is None:
        tensor._mx_grad = NDArray(g)
    elif tensor._mx_req == "add":
        buf._data = buf._data + g
    else:
        buf._data = g


def _grad_array(tensor):
    """The NDArray over a variable's gradient (zeros before any backward;
    always the same object), or None for a tensor that is not a variable
    or has grad_req "null"."""
    if getattr(tensor, "_mx_req", "null") == "null":
        return None
    g = getattr(tensor, "_mx_grad", None)
    if g is None:
        from .ndarray import NDArray
        g = tensor._mx_grad = NDArray(torch.zeros_like(tensor.detach()))
    return g


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make ``variables`` (NDArrays) differentiation leaves whose gradients
    live in ``gradients`` (NDArrays of the same shapes), with ``grad_reqs``
    (one for all, or one each)."""
    from .ndarray import NDArray
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, gradient, req in zip(variables, gradients, grad_reqs):
        t = var._data.detach()
        _mark(t, req)
        t._mx_own = True
        var._data = t
        if req != "null":
            g = gradient._data.detach().to(device=t.device, dtype=t.dtype)
            if g.shape != t.shape:
                raise ValueError("gradient shape %s for a variable of shape "
                                 "%s" % (tuple(g.shape), tuple(t.shape)))
            gradient._data = g
            t._mx_grad = gradient


def _held(tensor):
    """Whether ``tensor`` is the variable of one NDArray (``attach_grad``,
    ``mark_variables``; not a parameter's, which others share) and a live
    recorded graph holds it: a graph keeps the leaves it saved, and its
    gradient accumulator keeps the leaf, by reference, so a write in place
    would change what that graph's backward reads."""
    return getattr(tensor, "_mx_own", False) and tensor._use_count() > 1


def _rebind(old, new):
    """``new``, computed out of place, made the variable ``old`` was: the
    same grad_req and the same gradient NDArray, into which a graph that
    still holds ``old`` writes its gradient."""
    new = new.detach()
    buf = _grad_array(old)
    _mark(new, old._mx_req)
    new._mx_grad = buf
    new._mx_own = True
    return new


def _heads(heads, head_grads):
    """(head tensors, seed tensors), ones where no gradient is given."""
    from .ndarray import NDArray
    if isinstance(heads, (NDArray, torch.Tensor)):
        heads = [heads]
    heads = [h._data if isinstance(h, NDArray) else h for h in heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, (NDArray, torch.Tensor)):
        head_grads = [head_grads]
    seeds = [torch.ones_like(h) if g is None
             else (g._data if isinstance(g, NDArray) else g).to(h.device)
             for h, g in zip(heads, head_grads)]
    return heads, seeds


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """The gradients of ``heads`` into every variable they depend on, by
    each variable's grad_req. Each head is seeded with ones unless
    ``head_grads`` gives its gradient. A head that depends on no variable
    contributes nothing."""
    heads, seeds = _heads(heads, head_grads)
    pairs = [(h, s) for h, s in zip(heads, seeds) if h.requires_grad]
    if not pairs:
        return
    with _Scope(None, train_mode):
        torch.autograd.backward([h for h, _ in pairs], [s for _, s in pairs],
                                retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, returned
    (an NDArray for one variable, else a list), without touching any
    ``.grad``. A variable the heads do not depend on gets zeros. With
    ``create_graph`` the gradients are themselves recorded, so they can be
    differentiated again."""
    from .ndarray import NDArray
    single = isinstance(variables, (NDArray, torch.Tensor))
    if single:
        variables = [variables]
    tensors = [v._data if isinstance(v, NDArray) else v for v in variables]
    heads, seeds = _heads(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    live = [i for i, t in enumerate(tensors) if t.requires_grad]
    found = {}
    if live and any(h.requires_grad for h in heads):
        with _Scope(None, train_mode):
            got = torch.autograd.grad(
                [h for h in heads if h.requires_grad],
                [tensors[i] for i in live],
                [s for h, s in zip(heads, seeds) if h.requires_grad],
                retain_graph=retain_graph, create_graph=create_graph,
                allow_unused=True)
        found = dict(zip(live, got))
    out = []
    for i, t in enumerate(tensors):
        g = found.get(i)
        if g is None:
            g = torch.zeros_like(t, requires_grad=False)
        out.append(NDArray(g) if isinstance(variables[i], NDArray) else g)
    return out[0] if single else out


# ================================================================ Function

class _FunctionBridge(torch.autograd.Function):
    """Runs a ``Function``'s forward and backward, written in NDArray
    operations, as one torch autograd node."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray import NDArray
        ctx.func = func
        with pause():
            out = func.forward(*[NDArray(t) for t in tensors])
        func._single = isinstance(out, NDArray)
        outs = [out] if func._single else list(out)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray import NDArray
        with pause():
            in_grads = ctx.func.backward(*[NDArray(g) for g in out_grads])
        if isinstance(in_grads, NDArray):
            in_grads = (in_grads,)
        return (None,) + tuple(g._data if isinstance(g, NDArray) else g
                               for g in in_grads)


class Function:
    """A custom differentiable function: subclass it and write
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` in
    NDArray operations; ``save_for_backward`` keeps what backward needs.
    Calling an instance inside ``record()`` records it as one node whose
    gradient is ``backward``'s."""

    def __init__(self):
        self._saved = ()
        self._single = True

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        tensors = [x._data if isinstance(x, NDArray) else x for x in inputs]
        if not (is_recording() and any(t.requires_grad for t in tensors)):
            with pause():
                return self.forward(*inputs)
        outs = _FunctionBridge.apply(self, *tensors)
        outs = [NDArray(o) for o in outs]
        return outs[0] if self._single else outs
