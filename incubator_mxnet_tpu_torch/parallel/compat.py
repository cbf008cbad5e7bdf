"""``shard_map`` and its collectives, without XLA (counterpart of
``incubator_mxnet_tpu/parallel/compat.py``).

The JAX package partitions one program over a ``jax.sharding.Mesh`` and
reaches ``lax.ppermute``/``psum``/``all_to_all``/``axis_index`` inside
``shard_map``. Here a mesh is an array of ``torch.device``s with axis names
(``mesh.Mesh``), and ``shard_map(fn, mesh, in_specs, out_specs)``:

- splits each global input by its spec (``mesh.P``: one entry per
  dimension, an axis name, a tuple of them or None) into one shard per mesh
  position, on that position's device (``narrow`` and ``to``: both
  differentiable, and ``to`` of a tensor already there is the tensor);
- runs ``fn`` once per position, position 0 on the calling thread and each
  other in a thread of its own (as ``torch.nn.parallel.parallel_apply``
  does), and joins the outputs by ``out_specs`` on the device of position
  0; an axis an out spec leaves out is taken at index 0 (replicated);
- gives the body its collectives as plain differentiable torch ops on the
  tensors the positions exchange through an in-process rendezvous:
  ``psum`` adds the members' tensors moved to this position's device in
  axis order, ``ppermute`` takes its source's, ``all_to_all`` concatenates
  the members' chunks. ``axis_index`` and
  ``axis_size`` are Python ints, so a branch on the position is static.

Properties the design keeps:

1. The bodies keep the JAX package's structure (the ring loop of
   ``ppermute``, Ulysses' two ``all_to_all``).
2. One backward over the joined output walks the whole graph, across the
   threads that built it, on autograd's engine: a collective's backward is
   the backward of ``to``/``add``/``cat``, and no collective waits for a
   peer in the backward (a body must not rematerialise a collective).
3. A rendezvous that misses a participant raises ``RendezvousTimeout``
   within its deadline (``timeout``, default ``MXTPU_SPMD_TIMEOUT_S``)
   instead of hanging; a position that raises fails its peers' waits at
   once, and the caller gets the first error.
4. Positions on distinct devices run concurrently (each thread launches
   onto its device's stream); positions on one device hand tensors over
   without a copy, and the rendezvous orders their launches on the
   caller's stream.

The thread-local state a body depends on is entered in each shard thread
as the caller had it: grad and inference mode, autocast, the port's
``autograd.record``/``is_training`` state, ``plain()``, the default
context, ``nd.random``'s generators, the caller's current CUDA stream on
every device of the mesh (so a copy across devices is ordered on the
streams that made and read it: PyTorch's device-to-device copy records and
waits on both) and the kernel-launch collector
(``ops._kernels.collecting``), so launches from shard threads count where
the caller's count.
"""
from __future__ import annotations

import itertools
import threading
import time as _time
import unittest

import torch

from .. import config
from .mesh import P

__all__ = ["shard_map", "require_shard_map", "HAVE_SHARD_MAP",
           "ShardMapUnavailable", "RendezvousTimeout", "axis_size",
           "axis_index", "pcast", "psum", "ppermute", "all_to_all",
           "in_shard_map", "batch_axes"]

#: shard_map is always available here (the runtime below)
HAVE_SHARD_MAP = True


class ShardMapUnavailable(unittest.SkipTest):
    """Kept for the reference's surface: the port's ``shard_map`` is its
    own runtime and never unavailable."""


class RendezvousTimeout(TimeoutError):
    """A collective's rendezvous passed its deadline with a participant
    missing."""


class _PeerFailed(RuntimeError):
    """Raised in a waiting position when another position of the same
    ``shard_map`` call failed."""


def require_shard_map():
    """The ``shard_map`` callable (always present)."""
    return shard_map


def pcast(x, axes, to):
    """The identity: the port has no varying-manual-axes annotations."""
    return x


# --------------------------------------------------------------- the frames
# .frame: the innermost _Frame of this thread; .mapped: the shard_map calls
# made on this thread, with those its calls' positions made on theirs
_ENV = threading.local()


def _mapped():
    return getattr(_ENV, "mapped", 0)


def note_host_body():
    """Count a call whose body is host Python that must run at every
    step (a custom operator, ``operator.Custom``) as a ``shard_map`` call
    is counted: a capture site that sees one leaves the body uncaptured."""
    _ENV.mapped = _mapped() + 1


def tracking(fn):
    """(how many ``shard_map`` calls ``fn()`` made, its result). Calls of
    its positions on their own threads count, other threads' calls do
    not: a capture site runs its first call through this and leaves a
    body that mapped uncaptured (its positions launch from threads of
    their own)."""
    before = _mapped()
    out = fn()
    return _mapped() - before, out


def _frame():
    frame = getattr(_ENV, "frame", None)
    if frame is None:
        raise NameError("collective used outside shard_map: no mesh axis "
                        "is bound on this thread")
    return frame


def in_shard_map():
    """Whether this thread runs a position of a ``shard_map``."""
    return getattr(_ENV, "frame", None) is not None


def batch_axes():
    """The axes the innermost ``shard_map`` on this thread splits the batch
    over (a data-parallel step's), or None: where batch norm takes its
    statistics over the global batch."""
    frame = getattr(_ENV, "frame", None)
    return None if frame is None else frame.call.batch_axes


def _bound_frame(axes):
    """The innermost frame that binds every axis of ``axes``."""
    frame = _frame()
    for a in axes:
        if a not in frame.coords:
            raise NameError("axis %r is not bound by the enclosing shard_map "
                            "(bound: %s)" % (a, sorted(frame.coords)))
    return frame


def _axes(axis_name):
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


def axis_size(axis_name):
    """The size of a bound mesh axis (or the product over a tuple)."""
    axes = _axes(axis_name)
    frame = _bound_frame(axes)
    n = 1
    for a in axes:
        n *= frame.call.mesh.shape[a]
    return n


def axis_index(axis_name):
    """This position's index along a bound axis (row-major over a tuple),
    a Python int."""
    axes = _axes(axis_name)
    frame = _bound_frame(axes)
    idx = 0
    for a in axes:
        idx = idx * frame.call.mesh.shape[a] + frame.coords[a]
    return idx


class _Call:
    """What the positions of one ``shard_map`` call share: the mesh, the
    bound axes, the rendezvous slots and the first failure."""

    def __init__(self, mesh, axes, timeout, batch_axes=None):
        self.mesh = mesh
        self.axes = axes
        self.timeout = timeout
        self.batch_axes = batch_axes
        self.cond = threading.Condition()
        self.slots = {}
        self.failed = None

    def fail(self, exc):
        with self.cond:
            if self.failed is None:
                self.failed = exc
            self.cond.notify_all()


class _Frame:
    """One position of one call: its coordinates on the bound axes, its
    device, the mesh left over for nested code, and its count of
    collectives (the k-th collective of every position meets the k-th of
    its peers)."""

    def __init__(self, call, coords, device, rest):
        self.call = call
        self.coords = coords
        self.device = device
        self.rest = rest
        self.seq = 0

    def exchange(self, x, axis_name):
        """Every member's ``x`` (the positions that differ from this one
        only along ``axis_name``), in axis order, as each deposited it."""
        axes = _axes(axis_name)
        call = self.call
        n = axis_size(axes)
        me = axis_index(axes)
        group = tuple(sorted((a, i) for a, i in self.coords.items()
                             if a not in axes))
        self.seq += 1
        key = (self.seq, axes, group)
        deadline = _time.monotonic() + call.timeout
        with call.cond:
            slot = call.slots.setdefault(key, {"items": {}, "read": 0})
            slot["items"][me] = x
            call.cond.notify_all()
            while len(slot["items"]) < n:
                if call.failed is not None:
                    raise _PeerFailed("a peer position failed")
                left = deadline - _time.monotonic()
                if left <= 0:
                    exc = RendezvousTimeout(
                        "collective #%d over axis %s at position %s waited "
                        "%.3g s for %d of %d participants"
                        % (self.seq, axes, self.coords, call.timeout,
                           n - len(slot["items"]), n))
                    call.failed = call.failed or exc
                    call.cond.notify_all()
                    raise exc
                call.cond.wait(left)
            items = [slot["items"][i] for i in range(n)]
            slot["read"] += 1
            if slot["read"] == n:
                del call.slots[key]
        return items


# ------------------------------------------------------------ collectives
def psum(x, axis_name):
    """Sum of the members' ``x`` on this position's device, added in axis
    order (every member gets the same value)."""
    items = _frame().exchange(x, axis_name)
    dev = x.device
    out = items[0].to(dev)
    for t in items[1:]:
        out = out + t.to(dev)
    return out


def ppermute(x, axis_name, perm):
    """The ``x`` of the member whose index maps to this one's in ``perm``
    (pairs (source, destination)); zeros where none does."""
    items = _frame().exchange(x, axis_name)
    me = axis_index(axis_name)
    for src, dst in perm:
        if dst == me:
            return items[src].to(x.device)
    return torch.zeros_like(x)


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True):
    """Member j's chunk ``me`` of ``x`` split along ``split_axis``,
    concatenated over j along ``concat_axis`` (``tiled``; untiled the split
    dimension must equal the axis size and is removed, the gathered one
    inserted)."""
    items = _frame().exchange(x, axis_name)
    n, me = len(items), axis_index(axis_name)
    dev = x.device
    if tiled:
        parts = [t.chunk(n, dim=split_axis)[me].to(dev) for t in items]
        return torch.cat(parts, dim=concat_axis)
    parts = [t.select(split_axis, me).to(dev) for t in items]
    return torch.stack(parts, dim=concat_axis)


# --------------------------------------------------------- thread state
def _thread_state():
    """A snapshot of the calling thread's state that a body reads, and a
    function that enters it on another thread (returns an exit stack)."""
    import contextlib
    from .. import autograd
    from ..context import Context
    from ..gluon import _functional
    from ..gluon import parameter as _param
    from ..ndarray import random as _random
    from ..ops import _kernels
    locals_ = [autograd._STATE, _functional._PLAIN, _random._RNG,
               Context._default_ctx, _kernels._collector, _param._OVERRIDE]
    saved = [dict(loc.__dict__) for loc in locals_]
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    autocast = {}
    for dt in ("cuda", "cpu"):
        try:
            autocast[dt] = (torch.is_autocast_enabled(dt),
                            torch.get_autocast_dtype(dt))
        except (TypeError, AttributeError, RuntimeError):
            pass
    streams = []
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            streams.append(torch.cuda.current_stream(d))

    def enter(device):
        stack = contextlib.ExitStack()
        for loc, state in zip(locals_, saved):
            loc.__dict__.update(state)
        if inference:
            stack.enter_context(torch.inference_mode())
        else:
            stack.enter_context(torch.set_grad_enabled(grad))
        for dt, (on, dtype) in autocast.items():
            if on:
                stack.enter_context(torch.autocast(dt, dtype=dtype))
        if device.type == "cuda":
            torch.cuda.set_device(device)
            for s in streams:
                torch.cuda.set_stream(s)
        return stack
    return enter


# ---------------------------------------------------------- split & join
def _spec_axes(entry):
    if entry is None:
        return ()
    return _axes(entry)


def _coord_index(mesh, coords, axes):
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def _check_spec(spec, x, mesh, what):
    spec = tuple(spec)
    if len(spec) > x.dim():
        raise ValueError("%s spec %s has more entries than the tensor's %d "
                         "dimensions" % (what, spec, x.dim()))
    for d, entry in enumerate(spec):
        axes = _spec_axes(entry)
        n = 1
        for a in axes:
            if a not in mesh.shape:
                raise ValueError("%s spec %s names axis %r, not in the mesh "
                                 "%s" % (what, spec, a, dict(mesh.shape)))
            n *= mesh.shape[a]
        if x.shape[d] % n:
            raise ValueError("%s dimension %d of size %d does not divide "
                             "over %s (%d)" % (what, d, x.shape[d], axes, n))
    return spec


def _split(x, spec, mesh, coords, device):
    """This position's shard of the global ``x`` under ``spec``."""
    if not isinstance(x, torch.Tensor):
        return x
    for d, entry in enumerate(spec):
        axes = _spec_axes(entry)
        if not axes:
            continue
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        size = x.shape[d] // n
        x = x.narrow(d, _coord_index(mesh, coords, axes) * size, size)
    return x.to(device)


def _join(outs, spec, mesh, positions, axes, device):
    """The global tensor of the per-position ``outs`` under ``spec`` on
    ``device``: concatenated along each named dimension, index 0 of every
    bound axis the spec leaves out."""
    spec = tuple(spec)
    named = [a for e in spec for a in _spec_axes(e)]
    picked = {}
    for pos, coords in enumerate(positions):
        if any(coords[a] != 0 for a in axes if a not in named):
            continue
        picked[tuple(coords[a] for a in named)] = outs[pos]

    def build(d, fixed):
        if d == len(spec):
            key = tuple(fixed[a] for a in named)
            return picked[key].to(device)
        dims = _spec_axes(spec[d])
        if not dims:
            return build(d + 1, fixed)
        pieces = []
        for combo in itertools.product(*[range(mesh.shape[a])
                                          for a in dims]):
            f = dict(fixed)
            f.update(zip(dims, combo))
            pieces.append(build(d + 1, f))
        return torch.cat(pieces, dim=d)
    return build(0, {})


def _tree_map(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over a structure of tuples, lists and dicts whose
    spec tree matches it (a spec is a ``mesh.P`` or None, applying to a
    whole subtree)."""
    if spec_tree is None or isinstance(spec_tree, P):
        return _map_leaves(lambda leaf: fn(leaf, spec_tree), tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], spec_tree[k]) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t, s)
                          for t, s in zip(tree, spec_tree))
    return fn(tree, spec_tree)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, t) for t in tree)
    return fn(tree)


def _out_tree(outs, spec_tree, join):
    """Join the per-position output structures ``outs`` by ``spec_tree``."""
    first = outs[0]
    if spec_tree is None or isinstance(spec_tree, P):
        spec = P() if spec_tree is None else spec_tree
        if isinstance(first, dict):
            return {k: _out_tree([o[k] for o in outs], spec, join)
                    for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(_out_tree([o[i] for o in outs], spec, join)
                               for i in range(len(first)))
        if not isinstance(first, torch.Tensor):
            return first
        return join(outs, spec)
    if isinstance(first, dict):
        return {k: _out_tree([o[k] for o in outs], spec_tree[k], join)
                for k in first}
    return type(first)(_out_tree([o[i] for o in outs], s, join)
                       for i, s in enumerate(spec_tree))


# -------------------------------------------------------------- shard_map
def shard_map(f, mesh=None, in_specs=None, out_specs=None, check_vma=None,
              check_rep=None, axes=None, timeout=None, batch_axes=None):
    """``f`` mapped over the positions of ``mesh``: inputs split by
    ``in_specs`` (one spec, or a structure of specs, per argument), ``f``
    run once per position with the collectives of this module bound to
    ``axes`` (default every mesh axis), outputs joined by ``out_specs`` on
    position 0's device. ``check_vma``/``check_rep`` are accepted (there is
    no replication checker). With ``axes`` a subset, each position's
    ``mesh.current_mesh()`` is the mesh of the remaining axes at its
    coordinates. ``timeout`` bounds every rendezvous in seconds (default
    ``MXTPU_SPMD_TIMEOUT_S``). ``batch_axes`` names the bound axes the
    inputs' batch is split over (a data-parallel step's), over which batch
    norm all-reduces its statistics."""
    if mesh is None:
        from .mesh import current_mesh
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("shard_map needs a mesh (parallel.make_mesh)")
    bound = tuple(mesh.axis_names) if axes is None else tuple(axes)
    for a in bound:
        if a not in mesh.shape:
            raise ValueError("axis %r is not in the mesh %s"
                             % (a, dict(mesh.shape)))
    wait = float(config.get_env("MXTPU_SPMD_TIMEOUT_S")
                 if timeout is None else timeout)

    def mapped(*args):
        _ENV.mapped = _mapped() + 1
        specs = in_specs
        if specs is None or not isinstance(specs, (tuple, list)) or \
                isinstance(specs, P):
            specs = (specs,) * len(args)
        if len(specs) != len(args):
            raise ValueError("shard_map: %d in_specs for %d arguments"
                             % (len(specs), len(args)))
        checked = [_tree_map(lambda x, s: _check_spec(
            s if s is not None else (), x, mesh, "input")
            if isinstance(x, torch.Tensor) else s, a, s)
            for a, s in zip(args, specs)]
        positions = [dict(zip(bound, c)) for c in itertools.product(
            *[range(mesh.shape[a]) for a in bound])]
        call = _Call(mesh, bound, wait,
                     tuple(batch_axes) if batch_axes else None)
        enter = _thread_state()
        results = [None] * len(positions)
        errors = [None] * len(positions)
        nested = [0] * len(positions)

        def run(pos):
            coords = positions[pos]
            device = mesh.device_at(coords)
            prev = getattr(_ENV, "frame", None)
            before = _mapped()
            try:
                shards = [_tree_map(lambda x, s: _split(
                    x, s or (), mesh, coords, device), a, s)
                    for a, s in zip(args, checked)]
                _ENV.frame = _Frame(call, coords, device, mesh.rest(coords))
                results[pos] = f(*shards)
            except BaseException as exc:   # noqa: B902 — handed to caller
                errors[pos] = exc
                call.fail(exc)
            finally:
                _ENV.frame = prev
                nested[pos] = _mapped() - before

        def thread_main(pos):
            try:
                with enter(mesh.device_at(positions[pos])):
                    run(pos)
            except BaseException as exc:   # noqa: B902 — handed to caller
                errors[pos] = errors[pos] or exc
                call.fail(exc)

        threads = [threading.Thread(target=thread_main, args=(pos,),
                                    name="shard_map-%d" % pos, daemon=True)
                   for pos in range(1, len(positions))]
        for t in threads:
            t.start()
        run(0)
        for t in threads:
            t.join()
        _ENV.mapped = _mapped() + sum(nested[1:])   # position 0's counted
        first = next((e for e in errors if e is not None and
                      not isinstance(e, _PeerFailed)), None) or \
            next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
        home = mesh.device_at(positions[0])

        def join(outs, spec):
            for a in (a for e in spec for a in _spec_axes(e)):
                if a not in bound:
                    raise ValueError("output spec %s names axis %r, not "
                                     "bound by this shard_map %s"
                                     % (tuple(spec), a, bound))
            return _join(outs, spec, mesh, positions, bound, home)
        return _out_tree(results, out_specs, join)
    return mapped
