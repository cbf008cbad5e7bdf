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
tensors it was captured on, whose addresses are part of its key. Each
graph is an entry of kind ``"train"`` in the process-wide ``aot.CACHE``,
keyed as the JAX package keys its train programs (the model's
``model_id``, the signature, ``n_net_inputs`` and the step's instance
token, which goes in even under an explicit ``model_id``: two steps never
share an entry, since each updates its own parameters), bounded by
``MXTPU_AOT_CACHE_SIZE`` and counted on ``mxtpu_aot_{hits,misses,
evictions}_total{kind="train"}``. The captured body closes over the net,
the loss and the trainer, never over the step, so an entry does not keep
its step alive: a finalizer releases the step's entries when it is
collected, and an evicted entry captures again (a miss) at its next call.
The eager first step runs under ``devstats.measure``: the entry's FLOPs
(K1, K2 and K3 through their operators' formulas), with ``peak_bytes``
the capture's memory pool; ``_last_stats`` is the entry's stats after
every captured call, and each replay feeds ``devstats.observe_dispatch
("train", ...)`` (``mxtpu_device_mfu{kind="train"}``) with the host window
around it, or, under ``MXTPU_DEVSTATS_TRAIN_SYNC``, with its CUDA-event
time read after it has ended. Train entries are never persisted. A
capture that fails raises, naming the line of the operation; nothing
falls back to eager. CPU nets run the same body eagerly, and so does
``MXTPU_NO_DONATE`` on the card, whose update writes new tensors
(``Trainer._update``); a step that runs ``parallel.shard_map`` (a mesh
step, or a signature whose first run went through it) runs eagerly too.
None of these three is a program: they stay out of the cache, and their
``_last_stats`` is None (the JAX package's lazy mesh path has none
either).

Each ``TrainStep`` call carries the JAX package's training telemetry:
``mxtpu_train_step_seconds``, ``mxtpu_train_steps_total`` and
``mxtpu_train_examples_total``; a ``train:step`` span with its
``train:host_transfer``, ``train:build`` (a capture), ``train:dispatch``
and retroactive ``train:compile`` children; the ``step_begin`` and
``step_end`` flight records; the ``train_step`` watchdog channel (gone
with the last live step); and the ``train:loss``/``train:params``
numerics taps. It all runs on the host around the step: nothing of it
enters a capture, and a sampled tap reads the replay's outputs.

``remat`` (default ``MXTPU_REMAT``) runs the forward and loss under
``torch.utils.checkpoint`` and recomputes them in the backward, with the
forward's dropout masks and without a second running-statistics update
(``autograd.remat_contexts``). ``grad_postprocess`` maps the list of
gradients of the trainer's parameters (zeros where the loss does not
reach) before the update, as in the JAX step. With ``mesh`` the step is
data parallel over ``data_axis`` and, with ``zero``, keeps its optimizer
states in slices over it (``parallel.data_parallel``; the mesh step runs
eagerly, uncaptured, and takes no ``remat``). ``model_id`` names the
model in the cache key (default ``aot.model_id_for(net, extra=("train",
optimizer, loss))``).

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
span. CPU nets run the forward eagerly. With ``MXTPU_AOT_CACHE_DIR`` set
(``aot``'s artifact layer) the forward is exported once per signature by
``torch.export`` (``export_forward``: the parameters are the program's
first inputs, as the JAX package's pure function takes them; K1 is one
``mxtpu::flash_fwd`` node) and persisted; the graph captures that
program over the live parameters, and a fresh process loads the file and
captures it without running the net's Python forward. On the CPU the
program then runs as it is (``_Direct``). The file's name leaves out the
parameters' addresses; the in-memory key keeps them (``aot.Bound``).

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

import gc
import itertools
import os
import threading
import time as _time
import traceback
import weakref

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
from .telemetry import devstats, flightrec, numwatch, spans, watchdog

__all__ = ["TrainStep", "EvalStep", "export_forward"]

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
# The training step's own metrics, as the JAX package registers them.
_STEP_SECONDS = telemetry.histogram(
    "mxtpu_train_step_seconds",
    "Wall time per TrainStep call (cache-hit steady state included).",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
_STEPS = telemetry.counter(
    "mxtpu_train_steps_total", "Completed TrainStep calls.")
_EXAMPLES = telemetry.counter(
    "mxtpu_train_examples_total",
    "Examples consumed by TrainStep (batch-size sum); rate() of this is "
    "examples/sec.")

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


def _train_graphs(device):
    """Whether ``TrainStep`` captures its step on ``device``: on CUDA. The
    CPU tests route a TrainStep through a stand-in for its graph by
    patching this and ``_GraphCapture``; patching ``_uses_graphs`` alone
    routes the other steps and leaves TrainStep eager."""
    return device.type == "cuda"


def net_device(net):
    """The device of the net's (first) parameter, else of its first buffer
    (a net made int8 by ``contrib.quantization`` keeps its weights in
    buffers and owns no parameters)."""
    for p in net.parameters():
        return p.device
    for b in net.buffers():
        return b.device
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
    eager step and the capture run on, the ``torch.cuda.CUDAGraph``, the
    upload of a step's scalars and the CUDA-event timing of a replay.
    Nothing else in ``TrainStep`` touches ``torch.cuda``."""

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

    @staticmethod
    def timed(fn):
        """(``fn()``, the device seconds of the work it issued on the
        current stream): CUDA events around it, read once that work has
        ended (the host waits for it)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3


class _Captured:
    """One signature's captured program: the graph, its static inputs and
    scalar vector (and how to upload them), its static outputs (the
    step's loss, a forward's tensors), the kernel launches one replay
    makes, the tensors it was captured on (held, so their addresses stay
    theirs; the cache key carries the addresses) and how to time a replay
    on the card (``timed``). ``lock`` serialises the threads that replay
    one graph (its static buffers are shared)."""

    def __init__(self, graph, upload, inputs, scalars, out, launches,
                 tensors, timed=None):
        self.graph = graph
        self.upload = upload
        self.timed = timed
        self.inputs = inputs
        self.scalars = scalars
        self.out = out
        self.launches = launches
        self.tensors = [t.detach() for t in tensors]
        self.lock = threading.Lock()
        self.stats = None       # devstats' facts of the program (_capture)

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
    A capture that fails raises, naming the line of the operation. A body
    whose eager run went through ``parallel.shard_map`` (its positions
    launch from threads of their own) is not captured: it comes back as a
    ``_Direct`` program that runs it eagerly each call."""
    from .parallel import compat
    t0 = _time.perf_counter()
    flightrec.record("compile_begin", kind=kind)
    device = args[0].device
    cap = _GraphCapture(device)
    n = len(args)

    measured = []

    def eager():
        static = [a.clone() for a in args]
        got, stats = devstats.measure(lambda: body(*static))
        measured.append(stats)
        return [*got, *static]
    mapped, got = compat.tracking(lambda: cap.eager(eager))
    stats = measured[0]
    out, static = got[:len(got) - n], got[len(got) - n:]
    if mapped:
        direct = _Direct(body)
        direct.stats = stats
        flightrec.record("compile_end", kind=kind, dur_s=round(
            _time.perf_counter() - t0, 6))
        return direct, out
    try:
        with _kernels.collecting() as launches:
            graph, captured = cap.capture(lambda: body(*static))
    except Exception as exc:
        first_error, where = _where(exc)
        raise RuntimeError(
            "capturing a %s program into a CUDA graph failed at %s: %s"
            % (kind, where, first_error)) from exc
    stats["peak_bytes"] = devstats.pool_bytes(device,
                                              getattr(cap, "pool", None))
    dur = _time.perf_counter() - t0
    _COMPILES.inc(kind=kind)
    _COMPILE_SECONDS.inc(dur, kind=kind)
    flightrec.record("compile_end", kind=kind, dur_s=round(dur, 6))
    result = _Captured(graph, cap.upload, static, None, captured, launches,
                       tensors)
    result.stats = stats
    return result, out


class _ForwardProgram(torch.nn.Module):
    """``net``'s forward as a module ``torch.export`` can trace: the
    parameters' tensors come first among its inputs (as the JAX package's
    pure function takes them), or, ``baked``, are this module's buffers
    (a self-contained program, ``contrib.serving``). The net is held
    outside the module's tree, so none of its own tensors enter the
    program; during a call each parameter reads the tensor given."""

    def __init__(self, net, params, baked=False):
        super().__init__()
        object.__setattr__(self, "_net", net)
        object.__setattr__(self, "_params", params)
        self._baked = baked
        if baked:
            for i, p in enumerate(params):
                self.register_buffer("p%d" % i, p._tensor().detach())

    def forward(self, *flat):
        from .gluon._functional import plain
        n = len(self._params)
        if self._baked:
            tensors = [getattr(self, "p%d" % i) for i in range(n)]
        else:
            tensors, flat = flat[:n], flat[n:]
        saved = [p._data for p in self._params]
        for p, t in zip(self._params, tensors):
            p._data = t
        try:
            with plain():
                return self._net(*flat)
        finally:
            for p, t in zip(self._params, saved):
                p._data = t


#: one export at a time in the process: an export points the net's
#: parameters at traced tensors for its duration
_EXPORT_LOCK = threading.Lock()


def export_forward(net, args, baked=False):
    """The ``torch.export`` program of ``net``'s forward at the shapes of
    ``args`` (tensors), run as ``EvalStep`` runs it: without grad, inside
    ``plain()``. Its inputs are the parameters' tensors (in
    ``collect_params()`` order) then ``args``; ``baked`` puts the
    parameters in the program instead. K1 is one ``mxtpu::flash_fwd``
    node per attention. A forward that reads a value on the host
    (``.item()``, ``bool(t)``) cannot be exported and raises here."""
    params = list(net.collect_params().values())
    module = _ForwardProgram(net, params, baked)
    flat = tuple(args) if baked else \
        tuple(p._tensor().detach() for p in params) + tuple(args)
    with _EXPORT_LOCK, torch.no_grad():
        return torch.export.export(module, flat, strict=False)


class _Direct:
    """A loaded or exported program run as it is, without a graph (the
    artifact layer's entry for a net on the CPU): the interface of
    ``_Captured`` (``lock``, ``replay``, ``out``, ``stats``)."""

    def __init__(self, body):
        self.body = body
        self.lock = threading.Lock()
        self.out = None
        self.stats = None

    def replay(self, args):
        self.out = self.body(*args)


def run_program(program, args, stats, kind, model):
    """One replay of a cache entry's program (a ``_Captured`` graph or a
    ``_Direct`` program; the caller holds its ``lock``) and a copy of its
    outputs. Under a batcher's ``devstats.dispatch_context`` (or
    ``MXTPU_DEVSTATS_EVAL_SYNC``) with known stats, the replay's device
    time is read from CUDA events around it once it has ended (the
    batcher reads the outputs back right after anyway) and feeds
    ``devstats.observe_dispatch``; nothing reads the card inside a
    capture."""
    observe = stats is not None and (
        devstats.in_dispatch_context()
        or config.get_env("MXTPU_DEVSTATS_EVAL_SYNC"))
    if not observe:
        program.replay(args)
        return [o.clone() for o in program.out]
    if isinstance(program, _Captured) and args[0].device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        program.replay(args)
        end.record()
        out = [o.clone() for o in program.out]
        end.synchronize()
        dur_s = start.elapsed_time(end) / 1e3
    else:
        t0 = _time.perf_counter()
        program.replay(args)
        out = [o.clone() for o in program.out]
        dur_s = _time.perf_counter() - t0
    devstats.observe_dispatch(kind, stats, dur_s, model=model)
    return out


class _Uncapturable(Exception):
    """A train capture's eager first step ran ``parallel.shard_map``: no
    program is made, and ``loss`` is that step's answer."""

    def __init__(self, loss):
        super().__init__("the step runs shard_map")
        self.loss = loss


#: instance tokens of TrainSteps, in their cache keys
_TRAIN_TOKENS = itertools.count()


def _release_keys(keys, owner):
    """A collected TrainStep's finalizer: ``owner`` lets go of each of its
    cache entries (an entry holds none of the step's objects, so this runs
    when the step is collected)."""
    for key in list(keys):
        aot.CACHE.release(key, owner)
    keys.clear()


def _run_loss(net, loss_fn, remat, args, n_net_inputs):
    """The loss tensor of ``loss_fn(net(inputs), *extra)``, recorded;
    under ``remat`` checkpointed, to be recomputed in the backward."""
    from .gluon._functional import plain

    def run(*a):
        loss = loss_fn(net(*a[:n_net_inputs]), *a[n_net_inputs:])
        return loss._data if isinstance(loss, NDArray) else loss
    with autograd.record(train_mode=True), plain():
        if remat:
            return checkpoint(run, *args, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=autograd.remat_contexts)
        return run(*args)


def _grads(trainer, grad_postprocess, loss):
    """The loss's gradients (seeded with ones: those of its sum, which
    rescale_grad / batch_size makes the batch mean's), one per trainer
    parameter, None where it does not reach; with ``grad_postprocess``,
    its map of the live parameters' gradients (zeros where the loss does
    not reach)."""
    params = trainer._params
    live = trainer._live()
    got = torch.autograd.grad(loss, [params[i]._tensor() for i in live],
                              torch.ones_like(loss), allow_unused=True)
    if grad_postprocess is not None:
        got = grad_postprocess(
            [torch.zeros_like(params[i]._tensor()) if g is None else g
             for i, g in zip(live, got)])
    grads = [None] * len(params)
    for i, g in zip(live, got):
        grads[i] = g
    return grads


def _on_leaves(net, trainer, fn):
    """``fn()`` with every parameter of the net and the trainer read
    through a detached leaf of its own over the same storage (the update
    writes that storage in place), so no autograd node of a graph the
    caller still holds on them (made on another stream, say by a forward
    whose states were not detached) enters the step or its capture;
    ``_to_device`` has detached the inputs."""
    params = list({id(p): p for p in list(net.collect_params().values())
                   + trainer._params}.values())
    saved = [p._data for p in params]
    for p, t in zip(params, saved):
        p._data = t.detach().requires_grad_(t.requires_grad)
    try:
        return fn()
    finally:
        for p, t in zip(params, saved):
            p._data = t


def _step_body(net, loss_fn, trainer, remat, grad_postprocess):
    """``body(inputs, n_net_inputs, scalars) -> loss``: forward, backward
    and the update with the device ``scalars``, on the parameters' leaves
    (``_on_leaves``): what a train graph captures. It closes over the
    step's parts, never over the ``TrainStep``."""
    def body(inputs, n_net_inputs, scalars):
        def run():
            loss = _run_loss(net, loss_fn, remat, inputs, n_net_inputs)
            trainer._apply(_grads(trainer, grad_postprocess, loss), scalars)
            return loss.detach()
        return _on_leaves(net, trainer, run)
    return body


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
    CUDA graph, an ``aot.CACHE`` entry of kind ``"train"`` (see the
    module's docstring); ``captures`` counts the graphs captured and
    ``_last_stats`` is the newest replayed entry's stats."""

    def __init__(self, net, loss_fn, trainer, batch_axis=0,
                 grad_postprocess=None, mesh=None, data_axis="dp",
                 remat=None, zero=False, model_id=None):
        if mesh is not None and data_axis not in mesh.shape:
            raise ValueError("data_axis %r is not an axis of the mesh %s"
                             % (data_axis, dict(mesh.shape)))
        self.mesh = mesh
        self.zero = bool(zero)
        self.net = net
        self.loss_fn = loss_fn
        self.trainer = trainer
        self.batch_axis = batch_axis
        self.data_axis = data_axis
        self._model_id = model_id
        self.remat = config.get_env("MXTPU_REMAT") if remat is None \
            else remat
        if mesh is not None and remat:
            raise NotImplementedError(
                "remat under a mesh: a rematerialised forward would run its "
                "collectives again in the backward, where no peer waits")
        self._grad_postprocess = grad_postprocess
        self._step_count = 0
        self._uncaptured = set()     # signatures whose step runs shard_map
        self.captures = 0
        # the step's token in its cache keys and as their holder; the
        # finalizer holds the key set and the owner, never the step
        self._token = "i%x" % next(_TRAIN_TOKENS)
        self._owner = object()
        self._keys = set()
        self._last_stats = None      # the newest replayed entry's stats
        weakref.finalize(self, _release_keys, self._keys,
                         self._owner).atexit = False
        self._hb_registered = False
        self._built = False          # this call captured (``_replay``)

    #: live instances that have stepped at least once: the shared
    #: "train_step" watchdog channel goes when the last one does, so a
    #: finished training loop does not read as a stall
    _hb_live = 0

    def __call__(self, *inputs, batch_size=None, n_net_inputs=1):
        if not self._hb_registered:
            # on the first step, not at construction: a step built long
            # before training starts must not page while idle
            self._hb_registered = True
            TrainStep._hb_live += 1
        watchdog.heartbeat("train_step")
        with spans.span("train:step"):
            return NDArray(self._call_traced(inputs, batch_size,
                                             n_net_inputs))

    def __del__(self):
        try:
            if self._hb_registered:
                TrainStep._hb_live -= 1
                if TrainStep._hb_live <= 0:
                    watchdog.unregister("train_step")
        except Exception:
            pass          # interpreter-teardown __del__ must never raise

    def _call_traced(self, inputs, batch_size, n_net_inputs):
        """One step with the JAX package's telemetry around it: the
        ``train:host_transfer``, ``train:build`` (a capture, which runs the
        step itself eagerly first) and ``train:dispatch`` spans, the
        ``step_begin``/``step_end`` flight records, the step metrics, a
        capture's compile counters and retroactive ``train:compile`` span,
        and the ``train:loss``/``train:params`` taps. All of it runs on the
        host around the step, never inside a capture; a sampled tap reads
        the step's outputs after the replay."""
        with spans.span("train:host_transfer"):
            args = self._prepare(inputs, n_net_inputs)
        if batch_size is None:
            batch_size = args[0].shape[self.batch_axis]
        self._default_model_id()
        donate = not config.get_env("MXTPU_NO_DONATE")
        step_t0 = _time.perf_counter()
        self._built = False
        self._last_stats = None
        if self.mesh is None and donate and \
                _train_graphs(net_device(self.net)) and \
                self._sig(args, n_net_inputs) not in self._uncaptured:
            loss = self._replay(args, n_net_inputs, batch_size)
        else:
            flightrec.record("step_begin", step=self._step_count + 1,
                             compile=False)
            with spans.span("train:dispatch", compile=False):
                if self.mesh is not None:
                    loss = self._mesh_step(args, n_net_inputs, batch_size,
                                           donate)
                else:
                    loss = self._forward(args, n_net_inputs)
                    self._update(batch_size, self._backward(loss), donate)
                    loss = loss.detach()
        numwatch.tap(self._model_id, "train:loss", (loss,))
        numwatch.tap(self._model_id, "train:params",
                     (p._data for p in self.trainer._params))
        step_dur = _time.perf_counter() - step_t0
        _STEP_SECONDS.observe(step_dur)
        _STEPS.inc()
        _EXAMPLES.inc(int(batch_size))
        if self._built:
            if self._sig(args, n_net_inputs) not in self._uncaptured:
                _COMPILES.inc(kind="train")
                _COMPILE_SECONDS.inc(step_dur, kind="train")
                # the build window is this whole first step (its eager run
                # and the capture), a child of the open train:step span
                _record_compile_span("train:compile", step_dur)
            flightrec.record("compile_end", kind="train",
                             dur_s=round(step_dur, 6))
        flightrec.record("step_end", step=self._step_count,
                         dur_s=round(step_dur, 6))
        return loss

    def _default_model_id(self):
        """``model_id`` unless given: the JAX package's digest of the net
        with the optimizer's and the loss's class names."""
        if self._model_id is None:
            self._model_id = aot.model_id_for(
                self.net, extra=("train",
                                 type(self.trainer._optimizer).__name__,
                                 type(self.loss_fn).__name__))
        return self._model_id

    def _prepare(self, inputs, n_net_inputs):
        """Inputs on the net's device; deferred parameters initialized by
        one forward; the trainer's states created. A trainer that updates
        through a kvstore is refused (this step runs its own update)."""
        self.trainer._refuse_kvstore("jit.TrainStep")
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
        return _run_loss(self.net, self.loss_fn, self.remat, args,
                         n_net_inputs)

    # -- the mesh step ------------------------------------------------
    def _mesh_step(self, args, n_net_inputs, batch_size, donate):
        """One eager data-parallel step over ``mesh`` (see
        ``parallel.data_parallel``): the forward split over ``data_axis``,
        one backward, then the update (per slice under ``zero``)."""
        from .parallel import data_parallel
        if self.zero:
            data_parallel.shard_states(self.trainer, self.mesh,
                                       self.data_axis)
        loss = self._forward_mesh(args, n_net_inputs)
        self._update(batch_size, self._backward(loss), donate)
        return loss.detach()

    def _forward_mesh(self, args, n_net_inputs):
        """The per-sample loss of the whole batch, each position's slice
        computed by that position on its replica of the parameters."""
        from .gluon import parameter as _param
        from .gluon._functional import plain
        from .parallel.compat import shard_map
        from .parallel.mesh import P
        master = net_device(self.net)

        def run(*a):
            device = a[0].device
            saved = getattr(_param._OVERRIDE, "fn", None)
            if device != master:
                copies = {}

                def replica(p):
                    if p._data is None:
                        return None
                    t = copies.get(id(p))
                    if t is None:
                        t = copies[id(p)] = p._data.to(device)
                    return t
                _param._OVERRIDE.fn = replica
            try:
                loss = self.loss_fn(self.net(*a[:n_net_inputs]),
                                    *a[n_net_inputs:])
            finally:
                _param._OVERRIDE.fn = saved
            loss = loss._data if isinstance(loss, NDArray) else loss
            if loss.dim() <= self.batch_axis:
                raise ValueError("TrainStep over a mesh needs a per-sample "
                                 "loss (one value per batch row); got shape "
                                 "%s" % (tuple(loss.shape),))
            return loss
        spec = P(*([None] * self.batch_axis), self.data_axis)
        with autograd.record(train_mode=True), plain():
            return shard_map(run, self.mesh, in_specs=spec, out_specs=spec,
                             axes=(self.data_axis,),
                             batch_axes=(self.data_axis,))(*args)

    def _backward(self, loss):
        """The loss's gradients, one per trainer parameter (``_grads``)."""
        return _grads(self.trainer, self._grad_postprocess, loss)

    def _update(self, batch_size, grads, donate=True):
        self._step_count += 1
        self.trainer._update(batch_size, t=self._step_count, grads=grads,
                             donate=donate)

    # -- the captured step ----------------------------------------------
    def _bound(self):
        """Every tensor the step reads or updates in place: the net's and
        the trainer's parameters and the optimizer's states."""
        return [p._tensor() for p in self.net.collect_params().values()] + \
            [p._tensor() for p in self.trainer._params] + \
            [t for s in self.trainer._states for t in _tensors(s)]

    @staticmethod
    def _sig(args, n_net_inputs):
        return (tuple((tuple(a.shape), a.dtype) for a in args), n_net_inputs)

    def _key(self, args, n_net_inputs, tensors):
        """This call's cache key: the JAX package's train key (the model,
        the signature, the mesh, ``n_net_inputs`` and this step's token)
        with the addresses the graph reads and writes and which
        parameters it updates."""
        return aot.cache_key(
            self._default_model_id(), aot.input_signature(args),
            kind="train", mesh=aot.mesh_sig(self.mesh),
            extra=(n_net_inputs, self._token,
                   aot.Bound(t.data_ptr() for t in tensors),
                   tuple(p.grad_req for p in self.trainer._params)))

    def _replay(self, args, n_net_inputs, batch_size):
        """One step through this signature's graph in ``aot.CACHE``,
        captured first if the cache has none (first call, tensors rebound,
        evicted); returns the loss. A step whose first run went through
        ``parallel.shard_map`` (sequence parallel attention, tensor
        parallel layers) is not captured: its positions launch from
        threads of their own, and the signature runs eagerly from then
        on."""
        tensors = self._bound()
        key = self._key(args, n_net_inputs, tensors)
        self._step_count += 1
        scalars = self.trainer._scalars(batch_size, t=self._step_count)
        first = []

        def build():
            # a rebound signature's old graph goes before the new capture
            for old in [k for k in self._keys if k.input_sig ==
                        key.input_sig and k.extra[0] == n_net_inputs]:
                self._keys.discard(old)
                aot.CACHE.release(old, self._owner)
            self._built = True
            flightrec.record("step_begin", step=self._step_count,
                             compile=True)
            flightrec.record("compile_begin", kind="train")
            with spans.span("train:build"):
                entry, loss = self._capture(args, n_net_inputs, scalars,
                                            tensors)
            first.append(loss)
            return entry, None, None
        try:
            entry = aot.compile_cached(key, build, owner=self._owner)
        except _Uncapturable as exc:
            self._uncaptured.add(self._sig(args, n_net_inputs))
            return exc.loss
        self._keys.add(key)
        self._last_stats = entry.stats
        if first:
            return first[0]
        flightrec.record("step_begin", step=self._step_count, compile=False)
        program = entry.fn

        def replay():
            program.replay(args)
            return program.out.clone()
        with spans.span("train:dispatch", compile=False):
            program.upload(program.scalars, scalars)
            if config.get_env("MXTPU_DEVSTATS_TRAIN_SYNC"):
                loss, dur_s = program.timed(replay)
            else:
                t0 = _time.perf_counter()
                loss = replay()
                dur_s = _time.perf_counter() - t0
        devstats.observe_dispatch("train", entry.stats, dur_s,
                                  model=self._model_id)
        return loss

    def _capture(self, args, n_net_inputs, scalars, tensors):
        """This call's step, run eagerly on a side stream under
        ``devstats.measure`` (the program's FLOPs), then the same body
        captured (running nothing) on static copies of ``args`` and
        ``scalars``, both on the parameters' detached leaves. Returns (the
        capture, the eager step's loss); raises ``_Uncapturable`` when the
        step ran a ``shard_map``."""
        from .parallel import compat
        device = args[0].device
        cap = _GraphCapture(device)
        body = _step_body(self.net, self.loss_fn, self.trainer, self.remat,
                          self._grad_postprocess)
        measured = []

        def first_step():
            inputs = [a.clone() for a in args]
            static = scalars.to(device)
            loss, stats = devstats.measure(
                lambda: body(inputs, n_net_inputs, static))
            measured.append(stats)
            return [loss, static, *inputs]
        mapped, (first, static, *inputs) = compat.tracking(
            lambda: cap.eager(first_step))
        if mapped:
            raise _Uncapturable(first)
        try:
            with _kernels.collecting() as launches:
                graph, loss = cap.capture(
                    lambda: body(inputs, n_net_inputs, static))
        except Exception as exc:
            first_error, where = _where(exc)
            raise RuntimeError(
                "TrainStep: capturing the step into a CUDA graph failed at "
                "%s: %s" % (where, first_error)) from exc
        self.captures += 1
        stats = measured[0]
        stats["peak_bytes"] = devstats.pool_bytes(device,
                                                  getattr(cap, "pool", None))
        captured = _Captured(graph, cap.upload, inputs, static, loss,
                             launches, tensors, cap.timed)
        captured.stats = stats
        return captured, first


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
        self._last_stats = None     # the newest dispatched program's stats

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
        graphs = _uses_graphs(net_device(self.net))
        with spans.span("eval:step"):
            if not graphs and not config.get_env("MXTPU_AOT_CACHE_DIR"):
                return self._forward(args, inference)
            return self._replay(args, graphs)

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
        bindings = aot.Bound(
            p._tensor().data_ptr() for p in self.net.collect_params().values())
        return aot.cache_key(self._model_id, aot.input_signature(args),
                             kind="eval", extra=(str(device), bindings))

    def _replay(self, args, graphs=True):
        """The forward through this signature's program: a graph (or, on
        the CPU with the artifact layer on, the exported program run as it
        is), made first when the cache has none; that call answers with
        its eager run. With ``MXTPU_AOT_CACHE_DIR`` set the program is
        exported once and persisted, and a persisted one is loaded instead
        of running the net's Python forward."""
        key = self._key(args)
        with self._keys_lock:
            self._keys.add(key)
        first = []
        entry = aot.CACHE.lookup(key, self._owner)
        if entry is None:
            persist = aot.artifact_path(key) is not None
            entry = aot.compile_cached(
                key, self._builder(args, first, graphs, persist),
                exportable=persist, owner=self._owner,
                from_program=self._from_program(args, first, graphs))
        self._last_stats = entry.stats
        from .gluon._functional import _unflatten
        if first:
            out = first[0]
        else:
            graph = entry.fn
            with graph.lock:
                out = run_program(graph, args, entry.stats, "eval",
                                  self._model_id)
        return _unflatten(entry.extras, iter(out))

    def _params(self):
        return list(self.net.collect_params().values())

    def _builder(self, args, first, graphs, persist):
        """The cache's build hook: one capture of the forward
        (``_capture``) inside an ``eval:build`` span, over the forward's
        output tensors flattened (``extras``: its structure); with the
        artifact layer on, the forward is exported first and the program
        is what is captured (and returned for persisting). The eager
        run's outputs go to ``first``, the answer of the call that
        built."""
        from .gluon._functional import _flat

        def build():
            t0 = _time.perf_counter()
            if persist:
                with spans.span("eval:build"):
                    program = export_forward(self.net, args)
                if not graphs:
                    dur = _time.perf_counter() - t0
                    _COMPILES.inc(kind="eval")
                    _COMPILE_SECONDS.inc(dur, kind="eval")
                    _record_compile_span("eval:compile", dur)
                fn, extras = self._from_program(args, first, graphs)(program)
                return fn, extras, program
            spec = []

            def body(*static):
                outs, structure = _flat(self._forward(list(static)),
                                        "EvalStep's net")
                spec[:] = [structure]
                return outs
            with spans.span("eval:build"):
                captured, out = _capture(
                    body, args, "eval", tensors=[
                        p._tensor() for p in self._params()])
            self.captures += isinstance(captured, _Captured)
            _record_compile_span("eval:compile",
                                 _time.perf_counter() - t0)
            first.append(out)
            return captured, spec[0], None
        return build

    def _from_program(self, args, first, graphs):
        """The cache's hook for an exported or loaded program: captured
        over this step's live parameters (``graphs``), or run as it is.
        The net's Python forward does not run."""
        from .gluon._functional import _flat

        def make(program):
            module = program.module()
            tensors = [p._tensor().detach() for p in self._params()]
            spec = []

            def body(*static):
                outs, structure = _flat(module(*tensors, *static),
                                        "EvalStep's program")
                spec[:] = [structure]
                return outs
            if graphs:
                with spans.span("eval:build"):
                    captured, out = _capture(body, args, "eval",
                                             tensors=tensors)
                self.captures += isinstance(captured, _Captured)
            else:
                captured = _Direct(body)
                out, captured.stats = devstats.measure(lambda: body(*args))
            first.append(out)
            return captured, spec[0]
        return make

    def release(self):
        """Let go of every cache entry this step built or used: an entry
        no other step or engine holds leaves the cache with its graph,
        memory pool and the parameters it holds. A registry calls it when
        a served version goes."""
        with self._keys_lock:
            keys, self._keys = self._keys, set()
        for key in keys:
            aot.CACHE.release(key, self._owner)
