"""Training and inference steps (counterpart of
``incubator_mxnet_tpu/jit.py``).

``TrainStep`` is the JAX package's fused step: a forward in training mode,
the loss, its backward and the optimizer's update of every parameter in
place (the counterpart of the JAX step's donated buffers), single-device.
On a CUDA net the first call of each input signature (the inputs' shapes
and dtypes and ``n_net_inputs``, as the JAX step keys its programs) runs
one real step eagerly on a side stream, then captures the same body into a
``torch.cuda.CUDAGraph`` on static input buffers, with the learning rates,
weight decays, step and gradient rescale in one device vector; every later
call copies its inputs and that vector into the buffers and replays the
graph. The capture runs nothing, so the step and the optimizer's counts
advance once per real step, and step k is the JAX step's step k. The
step reads its inputs detached and the parameters through detached leaves
over their storage (``_on_leaves``), so a graph the caller still holds on
either (a recorded forward's states, not detached) does not enter it. A
parameter or optimizer state rebound to another tensor after a capture
(``cast``, ``_states`` replaced) forces a new capture: the graph keeps the
tensors it was captured on and compares their addresses each call. The
graphs live in an LRU bounded by ``MXTPU_AOT_CACHE_SIZE`` and go with the
``TrainStep``. A capture that fails raises, naming the line of the
operation; nothing falls back to eager. CPU nets run the same body
eagerly, and so does ``MXTPU_NO_DONATE`` on the card, whose update writes
new tensors (``Trainer._update``).

``remat`` (default ``MXTPU_REMAT``) runs the forward and loss under
``torch.utils.checkpoint`` and recomputes them in the backward, with the
forward's dropout masks and without a second running-statistics update
(``autograd.remat_contexts``). ``grad_postprocess`` maps the list of
gradients of the trainer's parameters (zeros where the loss does not
reach) before the update, as in the JAX step. ``mesh`` and ``zero`` wait
for the multi-GPU slice; ``data_axis`` (the mesh axis the batch is split
over) is accepted and only matters with a mesh. ``model_id`` is accepted
and stored: a training graph updates its own parameters in place and is
never shared, so ``TrainStep`` keeps its own table.

``EvalStep`` moves its inputs to the net's device and runs the forward
without recording. On a CUDA net each input signature is one CUDA graph
in the process-wide ``aot.CACHE`` (kind ``"eval"``), keyed by the model's
``model_id`` (``aot.model_id_for`` by default), the signature, the device
and the addresses of the parameters the graph reads: its first call runs
the forward eagerly on a side stream (that call's answer), then captures
it; every later call with that key, from this step or another over the
same parameter storage, copies its inputs into the graph's static buffers
and replays it. A capture counts on ``mxtpu_jit_compiles_total{kind}``
and ``mxtpu_jit_compile_seconds_total{kind}`` inside an ``eval:build``
span. CPU nets run the forward eagerly.

Captures are serialised process-wide (``_CAPTURE_LOCK``) and run in the
thread-local capture mode: a registry's prewarm captures on its warm
thread while batcher workers of this and other models launch, copy and
synchronise on the same card, which the global mode would let invalidate
the capture (or fail). Both steps run a hybridized net's plain forward
(``gluon._functional.plain``): graphs do not nest. Inputs may be NDArrays,
tensors or numpy arrays; both steps return NDArrays, as the JAX
package's do.
"""
from __future__ import annotations

import collections
import gc
import os
import threading
import time as _time
import traceback

import numpy as onp
import torch
from torch.utils.checkpoint import checkpoint

from . import aot
from . import autograd
from . import config
from . import telemetry
from .ndarray import NDArray
from .ndarray import random as _random
from .ops import _kernels
from .telemetry import flightrec, spans

__all__ = ["TrainStep", "EvalStep"]

# Capture observability, as the JAX package's compile counters: each
# shared-cache miss is one capture (an eager run and the graph's), counted
# with its wall time by kind.
_COMPILES = telemetry.counter(
    "mxtpu_jit_compiles_total",
    "Shape-keyed program-cache misses (one CUDA graph capture each).",
    ("kind",))
_COMPILE_SECONDS = telemetry.counter(
    "mxtpu_jit_compile_seconds_total",
    "Wall seconds spent in cache-miss first calls (eager run + capture).",
    ("kind",))

#: one capture at a time in the process (see the module's docstring)
_CAPTURE_LOCK = threading.Lock()


def _record_compile_span(name, dur_s):
    """Retroactive span over a just-finished build window, parented onto
    the ambient span."""
    try:
        from . import profiler
        spans.record_span(name, profiler.now_us() - dur_s * 1e6,
                          dur_s * 1e6, parent=spans.current_span())
    except Exception:   # tracing must never fail the step
        pass


def _uses_graphs(device):
    """Whether steps on ``device`` replay CUDA graphs (the CPU tests route
    the CPU through a stand-in by patching this and ``_GraphCapture``)."""
    return device.type == "cuda"


def net_device(net):
    """The device of the net's (first) parameter."""
    for p in net.parameters():
        return p.device
    raise RuntimeError("%s has no initialized parameters; call "
                       ".initialize() first" % type(net).__name__)


def _to_device(inputs, device):
    """The inputs as tensors on ``device``, detached: a step reads them as
    data, and no autograd graph they carry enters it."""
    inputs = [x._data if isinstance(x, NDArray) else x for x in inputs]
    return [x.detach().to(device) if isinstance(x, torch.Tensor)
            else torch.as_tensor(onp.asarray(x)).to(device) for x in inputs]


def _tensors(tree):
    """The tensors of an optimizer state (None, a tensor or nested
    tuples), in order."""
    if isinstance(tree, (tuple, list)):
        return [t for s in tree for t in _tensors(s)]
    return [] if tree is None else [tree]


def _where(exc):
    """(the first error of ``exc``'s chain, where it was raised): file:line,
    function and source of the innermost frame of its traceback outside
    torch's own package, the operation a failed capture reached (torch's
    capture then fails again on its way out)."""
    while exc.__cause__ is not None or exc.__context__ is not None:
        exc = exc.__cause__ or exc.__context__
    torch_dir = os.path.dirname(torch.__file__)
    frames = traceback.extract_tb(exc.__traceback__)
    outside = [f for f in frames if not f.filename.startswith(torch_dir)]
    f = (outside or frames)[-1]
    return exc, "%s:%d in %s: %s" % (f.filename, f.lineno, f.name,
                                     (f.line or "").strip())


class _GraphCapture:
    """The card's side of a capture on ``device``: the side stream the
    eager step and the capture run on, the ``torch.cuda.CUDAGraph``, and
    the upload of a step's scalars. Nothing else in ``TrainStep`` touches
    ``torch.cuda``."""

    def __init__(self, device):
        self.current = torch.cuda.current_stream(device)
        self.side = torch.cuda.Stream(device)
        self.device = device

    def eager(self, fn):
        """``fn()`` on the side stream, its tensors ready on the current
        one."""
        self.side.wait_stream(self.current)
        with torch.cuda.stream(self.side):
            out = fn()
        self.current.wait_stream(self.side)
        for t in out:
            t.record_stream(self.current)
        return out

    def capture(self, fn, pool=None):
        """(the graph of ``fn``, its output) captured on the side stream,
        into ``pool`` (a new memory pool by default; ``self.pool`` is the
        last one used, for a second graph that shares it). If ``fn`` or
        the capture's end fails, the capture is ended and its memory pool
        given back before the error goes on: left as ``torch.cuda.graph``
        leaves them, the allocator would route to the dead capture and
        never free a cached block again. Python's cyclic garbage collector
        runs before the capture and not during it: blocks hold their
        captured graphs in reference cycles (through their parameters),
        and a graph freed while another is being captured resets itself
        inside that capture and breaks it (as ``torch.cuda.graph``
        collects before capturing). One capture runs at a time in the
        process (``_CAPTURE_LOCK``), in the thread-local capture mode:
        other threads may launch, copy, allocate and synchronise
        meanwhile (a registry's prewarm captures under traffic). The
        launches autograd's thread makes onto the captured stream count
        with the caller's ``_kernels.collecting()`` (``capturing``)."""
        with _CAPTURE_LOCK, _kernels.capturing():
            return self._capture(fn, pool)

    def _capture(self, fn, pool):
        graph = torch.cuda.CUDAGraph()
        if hasattr(graph, "register_generator_state"):
            # nd.random's generator, for draws inside the step (dropout
            # draws from torch's default one, which every capture takes)
            graph.register_generator_state(_random._generator(self.device))
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        if pool is None:
            pool = torch.cuda.graph_pool_handle()   # known even if it fails
        self.pool = pool
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self.side):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn()
                except BaseException:
                    self._abandon(graph, pool, ended=False)
                    raise
                try:
                    graph.capture_end()
                except BaseException:
                    self._abandon(graph, pool, ended=True)
                    raise
        finally:
            if collecting:
                gc.enable()
        return graph, out

    def _abandon(self, graph, pool, ended):
        """End a failed capture (unless its end was what failed) and give
        its memory pool back."""
        if not ended:
            try:
                graph.capture_end()
            except RuntimeError:
                pass                   # invalidated: its end failed too
            else:
                graph.reset()          # a whole graph: reset frees its pool
                return
        index = self.device.index
        try:
            torch._C._cuda_endAllocateToPool(index, pool)
        except RuntimeError:
            pass                       # the failed end did stop routing
        torch._C._cuda_releasePool(index, pool)

    @staticmethod
    def upload(dst, host):
        """Copy the host tensor into ``dst`` without waiting for the
        card."""
        dst.copy_(host.pin_memory(), non_blocking=True)


class _Captured:
    """One signature's captured program: the graph, its static inputs and
    scalar vector (and how to upload them), its static outputs (the
    step's loss, a forward's tensors), the kernel launches one replay
    makes, and the tensors it was captured on (held, so their addresses
    stay theirs) with those addresses. ``lock`` serialises the threads
    that replay one graph (its static buffers are shared)."""

    def __init__(self, graph, upload, inputs, scalars, out, launches,
                 tensors, bindings):
        self.graph = graph
        self.upload = upload
        self.inputs = inputs
        self.scalars = scalars
        self.out = out
        self.launches = launches
        self.tensors = [t.detach() for t in tensors]
        self.bindings = bindings
        self.lock = threading.Lock()

    def replay(self, args):
        """Copy ``args`` into the static inputs, replay, count the
        launches (the caller holds ``lock`` while it reads the outputs)."""
        with torch.no_grad():
            for buf, a in zip(self.inputs, args):
                buf.copy_(a)
        self.graph.replay()
        _kernels.add_launches(self.launches)


def _capture(body, args, kind, tensors=()):
    """One capture of ``body(*inputs) -> list of tensors``: ``body`` runs
    eagerly on a side stream over copies of ``args`` (the static input
    buffers from then on), then is captured on those copies in a graph
    whose launches are collected apart (``_kernels.collecting``) and added
    back at each replay. ``tensors`` are held by the capture, so the
    addresses it reads stay theirs. Counts one compile of ``kind`` with
    its wall time. Returns (the ``_Captured``, the eager run's outputs).
    A capture that fails raises, naming the line of the operation."""
    t0 = _time.perf_counter()
    flightrec.record("compile_begin", kind=kind)
    cap = _GraphCapture(args[0].device)
    n = len(args)

    def eager():
        static = [a.clone() for a in args]
        return [*body(*static), *static]
    got = cap.eager(eager)
    out, static = got[:len(got) - n], got[len(got) - n:]
    try:
        with _kernels.collecting() as launches:
            graph, captured = cap.capture(lambda: body(*static))
    except Exception as exc:
        first_error, where = _where(exc)
        raise RuntimeError(
            "capturing a %s program into a CUDA graph failed at %s: %s"
            % (kind, where, first_error)) from exc
    dur = _time.perf_counter() - t0
    _COMPILES.inc(kind=kind)
    _COMPILE_SECONDS.inc(dur, kind=kind)
    flightrec.record("compile_end", kind=kind, dur_s=round(dur, 6))
    return _Captured(graph, cap.upload, static, None, captured, launches,
                     tensors, None), out


class TrainStep:
    """``step(*inputs)`` = one training step: ``inputs`` are the net's
    inputs (the first ``n_net_inputs``) followed by the loss's extra
    arguments (labels). Returns the per-sample loss as an NDArray (a fresh
    tensor each step).

    The step is: a forward in training mode, ``loss_fn(out, *extra)``, the
    gradients of the loss (seeded with ones, as ``loss.backward()``) with
    respect to the trainer's parameters, ``grad_postprocess`` of them, then
    the optimizer's update of every parameter (``Trainer._apply``:
    ``grad * rescale_grad / batch_size``, the clip, the fp32 update of the
    master or of the fp32 weight and the cast into the weight, in place).
    The gradients are the step's own: like the JAX ``TrainStep``, it leaves
    each parameter's ``grad()`` as it was. Adam's bias-correction step
    ``t`` is this step's own count. On the card the step is a replayed
    CUDA graph (see the module's docstring); ``captures`` counts the
    graphs captured."""

    def __init__(self, net, loss_fn, trainer, batch_axis=0,
                 grad_postprocess=None, mesh=None, data_axis="dp",
                 remat=None, zero=False, model_id=None):
        if mesh is not None or zero:
            raise NotImplementedError(
                "TrainStep mesh/zero (data-parallel and ZeRO-1 sharding) "
                "come with the multi-GPU slice of the port")
        self.net = net
        self.loss_fn = loss_fn
        self.trainer = trainer
        self.batch_axis = batch_axis
        self.data_axis = data_axis
        self._model_id = model_id
        self.remat = config.get_env("MXTPU_REMAT") if remat is None \
            else remat
        self._grad_postprocess = grad_postprocess
        self._step_count = 0
        self._graphs = collections.OrderedDict()
        self.captures = 0

    def __call__(self, *inputs, batch_size=None, n_net_inputs=1):
        args = self._prepare(inputs, n_net_inputs)
        if batch_size is None:
            batch_size = args[0].shape[self.batch_axis]
        donate = not config.get_env("MXTPU_NO_DONATE")
        if donate and net_device(self.net).type == "cuda":
            return NDArray(self._replay(args, n_net_inputs, batch_size))
        loss = self._forward(args, n_net_inputs)
        grads = self._backward(loss)
        self._update(batch_size, grads, donate)
        return NDArray(loss.detach())

    def _prepare(self, inputs, n_net_inputs):
        """Inputs on the net's device; deferred parameters initialized by
        one forward; the trainer's states created."""
        params = list(self.net.collect_params().values())
        if any(p._data is None for p in params):
            device = next((p._data.device for p in params
                           if p._data is not None), None) or \
                next(p._deferred_init[2] for p in params
                     if p._deferred_init is not None)
            args = _to_device(inputs, device)
            with autograd.pause(train_mode=True):
                self.net(*args[:n_net_inputs])
        else:
            args = _to_device(inputs, net_device(self.net))
        if not self.trainer._states_initialized:
            self.trainer._init_states()
        return args

    def _forward(self, args, n_net_inputs):
        """The loss tensor, recorded; under ``remat`` checkpointed, to be
        recomputed in the backward."""
        from .gluon._functional import plain

        def run(*a):
            loss = self.loss_fn(self.net(*a[:n_net_inputs]),
                                *a[n_net_inputs:])
            return loss._data if isinstance(loss, NDArray) else loss
        with autograd.record(train_mode=True), plain():
            if self.remat:
                return checkpoint(run, *args, use_reentrant=False,
                                  preserve_rng_state=False,
                                  context_fn=autograd.remat_contexts)
            return run(*args)

    def _backward(self, loss):
        """The loss's gradients (seeded with ones: those of its sum, which
        rescale_grad / batch_size makes the batch mean's), one per trainer
        parameter, None where it does not reach; with ``grad_postprocess``,
        its map of the live parameters' gradients (zeros where the loss
        does not reach)."""
        params = self.trainer._params
        live = self.trainer._live()
        got = torch.autograd.grad(loss, [params[i]._tensor() for i in live],
                                  torch.ones_like(loss), allow_unused=True)
        if self._grad_postprocess is not None:
            got = self._grad_postprocess(
                [torch.zeros_like(params[i]._tensor()) if g is None else g
                 for i, g in zip(live, got)])
        grads = [None] * len(params)
        for i, g in zip(live, got):
            grads[i] = g
        return grads

    def _update(self, batch_size, grads, donate=True):
        self._step_count += 1
        self.trainer._update(batch_size, t=self._step_count, grads=grads,
                             donate=donate)

    # -- the captured step ----------------------------------------------
    def _body(self, args, n_net_inputs, scalars):
        """Forward, backward and update with the device ``scalars``: what
        the graph captures. Returns the loss."""
        loss = self._forward(args, n_net_inputs)
        self.trainer._apply(self._backward(loss), scalars)
        return loss.detach()

    def _bound(self):
        """Every tensor the step reads or updates in place: the net's and
        the trainer's parameters and the optimizer's states."""
        return [p._tensor() for p in self.net.collect_params().values()] + \
            [p._tensor() for p in self.trainer._params] + \
            [t for s in self.trainer._states for t in _tensors(s)]

    def _bindings(self, tensors):
        """The addresses a graph captured on ``tensors`` writes, and which
        parameters it updates."""
        return tuple(t.data_ptr() for t in tensors) + \
            tuple(p.grad_req for p in self.trainer._params)

    def _replay(self, args, n_net_inputs, batch_size):
        """One step through this signature's graph, captured first if it
        has none (or its tensors were rebound); returns the loss."""
        sig = (tuple((tuple(a.shape), a.dtype) for a in args), n_net_inputs)
        tensors = self._bound()
        bindings = self._bindings(tensors)
        entry = self._graphs.pop(sig, None)
        if entry is not None and entry.bindings != bindings:
            entry = None                    # rebound: capture again
        self._step_count += 1
        scalars = self.trainer._scalars(batch_size, t=self._step_count)
        if entry is None:
            entry, loss = self._capture(args, n_net_inputs, scalars,
                                        tensors, bindings)
        else:
            with torch.no_grad():
                for buf, a in zip(entry.inputs, args):
                    buf.copy_(a)
            entry.upload(entry.scalars, scalars)
            entry.graph.replay()
            _kernels.add_launches(entry.launches)
            loss = entry.out.clone()
        self._graphs[sig] = entry
        config.evict_to_bound(self._graphs)
        return loss

    def _on_leaves(self, fn):
        """``fn()`` with every parameter of the net and the trainer read
        through a detached leaf of its own over the same storage (the
        update writes that storage in place), so no autograd node of a
        graph the caller still holds on them (made on another stream, say
        by a forward whose states were not detached) enters the step or
        its capture; ``_to_device`` has detached the inputs."""
        params = list({id(p): p for p in
                       list(self.net.collect_params().values())
                       + self.trainer._params}.values())
        saved = [p._data for p in params]
        for p, t in zip(params, saved):
            p._data = t.detach().requires_grad_(t.requires_grad)
        try:
            return fn()
        finally:
            for p, t in zip(params, saved):
                p._data = t

    def _capture(self, args, n_net_inputs, scalars, tensors, bindings):
        """This call's step, run eagerly on a side stream, then the same
        body captured (running nothing) on static copies of ``args`` and
        ``scalars``, both on the parameters' detached leaves
        (``_on_leaves``). Returns (the capture, the eager step's loss)."""
        cap = _GraphCapture(args[0].device)

        def first_step():
            inputs = [a.clone() for a in args]
            static = scalars.to(args[0].device)
            return [self._on_leaves(lambda: self._body(
                inputs, n_net_inputs, static)), static, *inputs]
        first, static, *inputs = cap.eager(first_step)
        try:
            with _kernels.collecting() as launches:
                graph, loss = cap.capture(lambda: self._on_leaves(
                    lambda: self._body(inputs, n_net_inputs, static)))
        except Exception as exc:
            first_error, where = _where(exc)
            raise RuntimeError(
                "TrainStep: capturing the step into a CUDA graph failed at "
                "%s: %s" % (where, first_error)) from exc
        self.captures += 1
        return _Captured(graph, cap.upload, inputs, static, loss, launches,
                         tensors, bindings), first


class EvalStep:
    """``step(*inputs)`` = ``net(*inputs)`` without recording on the net's
    device, as NDArrays. Inputs may be NDArrays, tensors or numpy arrays.
    On a CUDA net each signature replays a captured CUDA graph from
    ``aot.CACHE`` (see the module's docstring); ``captures`` counts the
    graphs this step captured. ``model_id`` names the model in the cache
    key (default ``aot.model_id_for(net, extra=("eval",))``). The step
    holds every entry it built or used (``_owner``) until ``release``."""

    def __init__(self, net, model_id=None):
        self.net = net
        self._model_id = model_id
        self.captures = 0
        self._owner = object()      # this step's token as a cache holder
        self._keys = set()          # cache keys this step built or used
        self._keys_lock = threading.Lock()

    def __call__(self, *inputs):
        from .ndarray.ndarray import _wrap
        args = _to_device(inputs, net_device(self.net))
        return _wrap(self._dispatch(args, inference=False), args)

    def _run(self, *inputs):
        """The forward's tensors, unwrapped (the serving path's call);
        eagerly they run under ``torch.inference_mode()``."""
        return self._dispatch(_to_device(inputs, net_device(self.net)),
                              inference=True)

    def _dispatch(self, args, inference):
        if not _uses_graphs(net_device(self.net)):
            return self._forward(args, inference)
        with spans.span("eval:step"):
            return self._replay(args)

    def _forward(self, args, inference=False):
        """The eager forward: what a graph captures, and the CPU's step."""
        from .gluon._functional import plain
        with (torch.inference_mode() if inference else torch.no_grad()), \
                plain():
            return self.net(*args)

    def _key(self, args):
        """This call's cache key: the model, the signature, the device and
        the addresses of the parameters a graph of it reads."""
        if self._model_id is None:
            self._model_id = aot.model_id_for(self.net, extra=("eval",))
        device = net_device(self.net)
        bindings = (str(device),) + tuple(
            p._tensor().data_ptr() for p in self.net.collect_params().values())
        return aot.cache_key(self._model_id, aot.input_signature(args),
                             kind="eval", extra=bindings)

    def _replay(self, args):
        """The forward through this signature's graph, captured first
        when the cache has none (that call answers with its eager run)."""
        key = self._key(args)
        with self._keys_lock:
            self._keys.add(key)
        first = []
        entry = aot.CACHE.lookup(key, self._owner)
        if entry is None:
            entry = aot.compile_cached(key, self._builder(args, first),
                                       owner=self._owner)
        from .gluon._functional import _unflatten
        if first:
            out = first[0]
        else:
            graph = entry.fn
            with graph.lock:
                graph.replay(args)
                out = [o.clone() for o in graph.out]
        return _unflatten(entry.extras, iter(out))

    def _builder(self, args, first):
        """The cache's build hook: one capture of the forward
        (``_capture``) inside an ``eval:build`` span, over the forward's
        output tensors flattened (``extras``: its structure); the eager
        run's outputs go to ``first``, the answer of the call that
        built."""
        from .gluon._functional import _flat

        def build():
            t0 = _time.perf_counter()
            spec = []

            def body(*static):
                outs, structure = _flat(self._forward(list(static)),
                                        "EvalStep's net")
                spec[:] = [structure]
                return outs
            with spans.span("eval:build"):
                captured, out = _capture(
                    body, args, "eval", tensors=[
                        p._tensor() for p in
                        self.net.collect_params().values()])
            self.captures += 1
            _record_compile_span("eval:compile",
                                 _time.perf_counter() - t0)
            first.append(out)
            return captured, spec[0], None
        return build

    def release(self):
        """Let go of every cache entry this step built or used: an entry
        no other step or engine holds leaves the cache with its graph,
        memory pool and the parameters it holds. A registry calls it when
        a served version goes."""
        with self._keys_lock:
            keys, self._keys = self._keys, set()
        for key in keys:
            aot.CACHE.release(key, self._owner)
