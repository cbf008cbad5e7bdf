"""Numerical-health observability (counterpart of ``incubator_mxnet_tpu/
telemetry/numwatch.py``, the numerics sentinel): value-level taps and
shadow-sampled divergence tracking.

Every other telemetry layer here measures *time and structure* (spans,
devstats MFU, profstats hotspots, SLO burn rates); this one observes the
*values* flowing through the system — the NaN storm in training, the
drifting int8 logits in serving, the non-finite decode logits a sampler
would silently turn into garbage tokens.

Two halves:

**On-device stats taps**: ``tap(model, site, leaves)`` runs one torch
reducer (``reduce_stats``) over a tensor tree on the tensors' own device
and brings back one packed bundle ``[finite_fraction, abs_max, rms]``.
The serving batcher taps without adding a host synchronise: it opens a
``tapping`` scope around its servable call, a ``BlockServable`` hands its
device outputs to ``device_tap`` after the replay and before its own
copy to the host, which launches the reducer and a non-blocking copy of
the bundle into pinned memory on the same stream, so the outputs'
blocking copy that follows lands it too; ``tapping.finish`` then reads it
(a servable that returns host arrays is reduced on the host). The
reducer never runs inside a captured graph. Taps are stride-sampled by
``MXTPU_NUMWATCH_SAMPLE`` (0 disables, the default; 1.0 every dispatch;
0.25 every 4th, deterministically). Sites: the batcher's
``serve:outputs`` and the decode loop's ``gen:logits`` (a ``note`` of the
step's fused per-row finiteness).

Non-finite detections increment
``mxtpu_numwatch_nonfinite_total{model,site}`` and fire a once-per-
episode ``nan_storm`` flight-recorder event with hysteresis (the
devstats hbm_pressure / watchdog precedent): the first non-finite tap at
a site opens an episode and records the event; further non-finite taps
in the same episode are counted but not re-recorded; a fully-finite tap
closes the episode and re-arms it. Rolling abs-max / rms land in
``mxtpu_numwatch_absmax{model,site}`` / ``mxtpu_numwatch_rms{...}``.

**Shadow execution sampling** — ``register_shadow(model, reference)``
attaches a reference servable (e.g. the bf16 original of an
int8-quantized deployment) to a served model. A deterministic stride
(``MXTPU_SHADOW_SAMPLE``) of dispatched batches is re-executed through
the reference OFF the hot path (a single daemon worker thread with a
bounded queue — overload drops samples, never delays serving) and the
primary/reference outputs are compared: max-abs-diff, top-1 agreement
and mean logit KL land in ``mxtpu_shadow_divergence{model,metric}``.
A max-abs-diff above ``MXTPU_SHADOW_THRESHOLD`` is a BREACH: the
``on_breach`` callback (the serving registry wires it to the model
entry's degraded flag — the hlolint refusal shape) fires once per
breach episode together with a ``shadow_breach`` flightrec event.

Everything in this module follows the R005 discipline: a telemetry
failure must never fail the traffic it observes — every public entry
point swallows exceptions into a debug log.

Surfaces: ``describe()`` backs ``GET /debug/numerics`` (serving/server)
and loadgen's between-stage scrape; ``detach_model()`` is called from
the batcher/generator close paths so an unloaded model exports no
frozen series (the detach-on-close contract).
"""
from __future__ import annotations

import logging
import queue as _queue
import threading

import numpy as onp

from .registry import counter, gauge
from . import devstats
from . import faultlab
from . import flightrec

__all__ = ["tap", "note", "shadow_offer", "register_shadow",
           "unregister_shadow", "shadow_drain", "describe", "detach_model",
           "reset", "sample_stride", "shadow_stride", "reduce_stats",
           "tapping", "device_tap"]

_LOG = logging.getLogger(__name__)

_NONFINITE = counter(
    "mxtpu_numwatch_nonfinite_total",
    "Sampled taps that observed at least one non-finite element",
    ("model", "site"))
_TAPS = counter(
    "mxtpu_numwatch_taps_total",
    "Sampled numerics taps executed (per model and tap site)",
    ("model", "site"))
_ABSMAX = gauge(
    "mxtpu_numwatch_absmax",
    "Rolling abs-max over the last sampled tap (non-finite masked out)",
    ("model", "site"))
_RMS = gauge(
    "mxtpu_numwatch_rms",
    "Rolling rms over the last sampled tap (non-finite masked out)",
    ("model", "site"))
_SHADOW_DIV = gauge(
    "mxtpu_shadow_divergence",
    "Primary-vs-reference divergence of the last shadow sample "
    "(metric: max_abs_diff | top1_agreement | logit_kl)",
    ("model", "metric"))
_SHADOW_SAMPLES = counter(
    "mxtpu_shadow_samples_total",
    "Batches re-executed through the registered reference servable",
    ("model",))
_SHADOW_BREACHES = counter(
    "mxtpu_shadow_breaches_total",
    "Shadow samples whose max-abs-diff exceeded MXTPU_SHADOW_THRESHOLD",
    ("model",))
_SHADOW_DROPS = counter(
    "mxtpu_shadow_drops_total",
    "Shadow samples dropped because the worker queue was full",
    ("model",))

_lock = threading.Lock()
_tap_counts = {}        # (model, site) -> dispatches seen (stride clock)
_storms = set()         # (model, site) keys inside a nan_storm episode
_storm_counts = {}      # (model, site) -> episodes fired (describe)
_last_stats = {}        # (model, site) -> (finite_frac, absmax, rms)


def sample_stride():
    """Tap stride from MXTPU_NUMWATCH_SAMPLE: 0 -> disabled (stride 0),
    rate r in (0, 1] -> every round(1/r)-th dispatch."""
    from .. import config
    try:
        rate = float(config.get_env("MXTPU_NUMWATCH_SAMPLE") or 0.0)
    except Exception:
        return 0
    if rate <= 0.0:
        return 0
    return max(1, int(round(1.0 / min(1.0, rate))))


def shadow_stride():
    """Shadow stride from MXTPU_SHADOW_SAMPLE (same 0-disables contract)."""
    from .. import config
    try:
        rate = float(config.get_env("MXTPU_SHADOW_SAMPLE") or 0.0)
    except Exception:
        return 0
    if rate <= 0.0:
        return 0
    return max(1, int(round(1.0 / min(1.0, rate))))


# --------------------------------------------------------------- reducers
def _leaf_data(a):
    """The tensor of an NDArray, else the object itself."""
    return getattr(a, "_data", a)


def _as_tensor(a):
    import torch
    a = _leaf_data(a)
    if isinstance(a, torch.Tensor):
        return a.detach()
    return torch.as_tensor(onp.asarray(a))


def reduce_stats(leaves):
    """(3,) float32 tensor ``[finite_fraction, abs_max, rms]`` over every
    element of ``leaves`` (tensors on one device), computed there with
    non-finite entries masked out of abs_max and rms."""
    import torch
    device = leaves[0].device
    total = max(1, sum(int(t.numel()) for t in leaves))
    finite = torch.zeros((), dtype=torch.float32, device=device)
    absmax = torch.zeros((), dtype=torch.float32, device=device)
    sumsq = torch.zeros((), dtype=torch.float32, device=device)
    for leaf in leaves:
        x = leaf.float()
        ok = torch.isfinite(x)
        finite = finite + ok.sum().float()
        masked = torch.where(ok, x, torch.zeros_like(x))
        if masked.numel():
            absmax = torch.maximum(absmax, masked.abs().amax())
        sumsq = sumsq + (masked * masked).sum()
    return torch.stack([finite / total, absmax, torch.sqrt(sumsq / total)])


def _sampled(model, site):
    """Advance (model, site)'s stride clock; whether this call taps."""
    stride = sample_stride()
    if stride <= 0:
        return False
    k = (str(model), str(site))
    with _lock:
        n = _tap_counts.get(k, 0)
        _tap_counts[k] = n + 1
    return n % stride == 0


def _tensors(leaves):
    out = [_as_tensor(a) for a in leaves
           if hasattr(a, "shape") and hasattr(a, "dtype")]
    return [t for t in out if t.is_floating_point()]


def tap(model, site, leaves):
    """Stride-sampled stats tap over ``leaves`` (NDArrays, tensors or
    numpy arrays), reduced on their device; the bundle is read back at
    once. Never raises. An unsampled call is a dict increment under a
    lock."""
    try:
        if not _sampled(model, site):
            return None
        leaves = _tensors(leaves)
        if not leaves:
            return None
        bundle = reduce_stats(leaves).cpu()
        return note(model, site, float(bundle[0]), float(bundle[1]),
                    float(bundle[2]))
    except Exception:
        _LOG.debug("numwatch tap at %s/%s dropped", model, site,
                   exc_info=True)
        return None


_pending = threading.local()


class tapping:
    """The batcher's tap around one servable call (see the module's
    docstring): ``with tap:`` around the call, then ``tap.finish(host
    outputs)``. A sampled scope lets ``device_tap`` reduce the device
    outputs before their copy to the host."""

    def __init__(self, model, site):
        self.model, self.site = str(model), str(site)
        try:
            self.sampled = _sampled(model, site)
        except Exception:
            self.sampled = False
        self.bundle = None

    def __enter__(self):
        self._prev = getattr(_pending, "tap", None)
        _pending.tap = self if self.sampled else None
        return self

    def __exit__(self, *exc):
        _pending.tap = self._prev
        return False

    def finish(self, outs):
        """Record the bundle ``device_tap`` left, or reduce ``outs`` (host
        arrays) here. Never raises."""
        if not self.sampled:
            return None
        try:
            bundle = self.bundle
            if bundle is None:
                leaves = _tensors(outs if isinstance(outs, (list, tuple))
                                  else (outs,))
                if not leaves:
                    return None
                bundle = reduce_stats(leaves)
            return note(self.model, self.site, float(bundle[0]),
                        float(bundle[1]), float(bundle[2]))
        except Exception:
            _LOG.debug("numwatch tap at %s/%s dropped", self.model,
                       self.site, exc_info=True)
            return None


def device_tap(outs):
    """Inside a sampled ``tapping`` scope on this thread: reduce the
    servable's device outputs and start the bundle's copy into pinned
    host memory without waiting (the caller's blocking copy of the
    outputs, on the same stream, lands it). Outside one, nothing."""
    t = getattr(_pending, "tap", None)
    if t is None:
        return
    try:
        import torch
        leaves = _tensors(outs)
        if not leaves:
            return
        bundle = reduce_stats(leaves)
        if bundle.device.type == "cuda":
            host = torch.empty(3, dtype=torch.float32, pin_memory=True)
            host.copy_(bundle, non_blocking=True)
            bundle = host
        t.bundle = bundle
    except Exception:
        _LOG.debug("numwatch device tap dropped", exc_info=True)


def note(model, site, finite_frac, absmax=None, rms=None):
    """Record one observation's health facts (the tap's back half, also
    called directly by sites that compute finiteness inside their own
    captured program — the decode loop's fused per-row check). Applies
    the counter/gauge updates and the nan_storm hysteresis: an episode
    OPENS (event fires once) when finite_frac drops below 1.0 and CLOSES
    (re-arms) on the next fully-finite observation."""
    try:
        model, site = str(model), str(site)
        _TAPS.inc(model=model, site=site)
        if absmax is not None:
            _ABSMAX.set(float(absmax), model=model, site=site)
        if rms is not None:
            _RMS.set(float(rms), model=model, site=site)
        k = (model, site)
        fire = False
        with _lock:
            _last_stats[k] = (float(finite_frac), absmax, rms)
            in_episode = k in _storms
            if finite_frac < 1.0 and not in_episode:
                _storms.add(k)
                _storm_counts[k] = _storm_counts.get(k, 0) + 1
                fire = True
            elif finite_frac >= 1.0 and in_episode:
                _storms.discard(k)
        if finite_frac < 1.0:
            _NONFINITE.inc(model=model, site=site)
        if fire:
            # outside the lock (devstats precedent): flightrec never
            # raises, but it must not serialize the tap path either
            flightrec.record("nan_storm", model=model, site=site,
                            finite_frac=round(float(finite_frac), 6))
        return bool(finite_frac >= 1.0)
    except Exception:
        _LOG.debug("numwatch note at %s/%s dropped", model, site,
                   exc_info=True)
        return None


# --------------------------------------------------------- shadow sampling
class _Shadow:
    """One model's registered reference + its stride clock and episode."""

    __slots__ = ("reference", "stride", "threshold", "on_breach",
                 "count", "breached", "last")

    def __init__(self, reference, stride, threshold, on_breach):
        self.reference = reference
        self.stride = stride
        self.threshold = threshold
        self.on_breach = on_breach
        self.count = 0          # dispatches seen (stride clock)
        self.breached = False   # inside a breach episode
        self.last = None        # last comparison dict (describe)


_shadows = {}                   # model -> _Shadow
_shadow_q = None                # _queue.Queue of (model, stacked, primary)
_shadow_thread = None
_SHADOW_QUEUE_SIZE = 64


def register_shadow(model, reference, stride=None, threshold=None,
                    on_breach=None):
    """Attach ``reference`` (a servable with predict_batch, or a bare
    callable) as ``model``'s shadow. ``stride`` defaults to the
    MXTPU_SHADOW_SAMPLE-derived stride resolved at offer time; ``threshold``
    to MXTPU_SHADOW_THRESHOLD. ``on_breach(reason)`` fires once per breach
    episode (the registry wires the degraded-health flip here)."""
    with _lock:
        _shadows[str(model)] = _Shadow(reference, stride, threshold,
                                       on_breach)
    _ensure_worker()


def unregister_shadow(model):
    with _lock:
        return _shadows.pop(str(model), None) is not None


def _ensure_worker():
    global _shadow_q, _shadow_thread
    with _lock:
        if _shadow_thread is not None and _shadow_thread.is_alive():
            return
        _shadow_q = _queue.Queue(maxsize=_SHADOW_QUEUE_SIZE)
        _shadow_thread = threading.Thread(
            target=_shadow_loop, args=(_shadow_q,), daemon=True,
            name="mxtpu-numwatch-shadow")
        _shadow_thread.start()


def _shadow_loop(q):
    while True:
        model, stacked, primary = q.get()
        try:
            # faultlab site "numwatch.shadow": an injected exception here
            # becomes a DROPPED sample (debug-logged below) — proof that
            # telemetry failure never fails traffic (R005 discipline)
            if faultlab.armed:
                faultlab.fire("numwatch.shadow", model=model)
            with devstats.LAUNCH_GATE.shared():
                _shadow_compare(model, stacked, primary)
        except Exception:
            _LOG.debug("shadow comparison for model %r dropped", model,
                       exc_info=True)
        finally:
            q.task_done()


def shadow_offer(model, stacked, primary_outs):
    """Hot-path hook (serving/batcher, AFTER results landed on host):
    stride-sample this dispatch into the shadow worker's bounded queue.
    Full queue -> sample dropped and counted, never blocks serving."""
    try:
        model = str(model)
        with _lock:
            sh = _shadows.get(model)
            if sh is None:
                return
            n = sh.count
            sh.count = n + 1
            stride = sh.stride
        if stride is None:
            stride = shadow_stride()
        if stride <= 0 or n % stride != 0:
            return
        q = _shadow_q
        if q is None:
            return
        try:
            # the batcher hands over outputs already on the host
            q.put_nowait((model, tuple(stacked),
                          tuple(onp.asarray(o) for o in primary_outs)))
        except _queue.Full:
            _SHADOW_DROPS.inc(model=model)
    except Exception:
        _LOG.debug("shadow offer for model %r dropped", model,
                   exc_info=True)


def shadow_drain(timeout=10.0):
    """Block until every queued shadow sample has been compared (tests /
    CI determinism; the serving path never calls this)."""
    q = _shadow_q
    if q is None:
        return True
    deadline = threading.Event()
    t = threading.Thread(target=lambda: (q.join(), deadline.set()),
                         daemon=True)
    t.start()
    return deadline.wait(timeout)


def _softmax(x):
    x = x.astype(onp.float64)
    x = x - x.max(axis=-1, keepdims=True)
    e = onp.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _shadow_compare(model, stacked, primary):
    sh = _shadows.get(model)
    if sh is None:
        return
    ref_outs = sh.reference.predict_batch(*stacked) \
        if hasattr(sh.reference, "predict_batch") else sh.reference(*stacked)
    if not isinstance(ref_outs, (list, tuple)):
        ref_outs = (ref_outs,)
    # the shadow worker's own transfer, off the serving path
    p = onp.asarray(primary[0], dtype=onp.float64)
    r = _leaf_data(ref_outs[0])
    if hasattr(r, "detach"):
        r = r.detach().float().cpu().numpy()
    r = onp.asarray(r, dtype=onp.float64)
    if p.shape != r.shape:
        raise ValueError("shadow output shape %s != primary %s"
                         % (r.shape, p.shape))
    max_abs = float(onp.max(onp.abs(p - r))) if p.size else 0.0
    comparison = {"max_abs_diff": max_abs}
    if p.ndim >= 2 and p.shape[-1] > 1:
        comparison["top1_agreement"] = float(
            onp.mean(p.argmax(axis=-1) == r.argmax(axis=-1)))
        sp, sr = _softmax(p), _softmax(r)
        comparison["logit_kl"] = float(onp.mean(onp.sum(
            sr * (onp.log(sr + 1e-12) - onp.log(sp + 1e-12)), axis=-1)))
    for metric, value in comparison.items():
        _SHADOW_DIV.set(value, model=model, metric=metric)
    _SHADOW_SAMPLES.inc(model=model)

    from .. import config
    threshold = sh.threshold
    if threshold is None:
        threshold = float(config.get_env("MXTPU_SHADOW_THRESHOLD"))
    breach = max_abs > threshold
    fire = False
    with _lock:
        sh.last = dict(comparison, breach=breach, threshold=threshold)
        if breach and not sh.breached:
            sh.breached = True
            fire = True
        elif not breach and sh.breached:
            # recovery re-arms the episode; the degraded flag the
            # registry set stays sticky until the next load (the
            # hlolint-refusal shape: an operator decision, not a flap)
            sh.breached = False
    if breach:
        _SHADOW_BREACHES.inc(model=model)
    if fire:
        reason = ("shadow divergence breach: max_abs_diff=%.4g > "
                  "threshold=%.4g" % (max_abs, threshold))
        flightrec.record("shadow_breach", model=model,
                         max_abs_diff=round(max_abs, 6),
                         threshold=threshold)
        cb = sh.on_breach
        if cb is not None:
            try:
                cb(reason)
            except Exception:
                _LOG.debug("shadow on_breach callback for %r failed",
                           model, exc_info=True)


# ------------------------------------------------------------- inspection
def describe():
    """JSON-able snapshot (GET /debug/numerics, loadgen scrape)."""
    with _lock:
        taps = {"%s/%s" % k: {"sampled": _TAPS.value(model=k[0], site=k[1]),
                              "nonfinite": _NONFINITE.value(model=k[0],
                                                            site=k[1]),
                              "storms": _storm_counts.get(k, 0),
                              "in_storm": k in _storms,
                              "last": list(_last_stats.get(k) or ())}
                for k in sorted(_last_stats)}
        shadows = {m: {"stride": sh.stride, "threshold": sh.threshold,
                       "offered": sh.count,
                       "samples": _SHADOW_SAMPLES.value(model=m),
                       "breaches": _SHADOW_BREACHES.value(model=m),
                       "drops": _SHADOW_DROPS.value(model=m),
                       "breached": sh.breached,
                       "last": dict(sh.last) if sh.last else None}
                   for m, sh in sorted(_shadows.items())}
    return {"sample_stride": sample_stride(),
            "shadow_stride": shadow_stride(),
            "taps": taps, "shadows": shadows}


def detach_model(model):
    """Drop every series and episode this model drove (the detach-on-close
    contract: an unloaded model must not export frozen health). Called
    from the batcher/generator close paths; never raises."""
    model = str(model)
    try:
        with _lock:
            keys = [k for k in _last_stats if k[0] == model]
            for k in keys:
                _last_stats.pop(k, None)
                _tap_counts.pop(k, None)
                _storm_counts.pop(k, None)
                _storms.discard(k)
            _shadows.pop(model, None)
        for _, site in keys:
            for g in (_ABSMAX, _RMS):
                try:
                    g.remove(model=model, site=site)
                except Exception:
                    pass
        for metric in ("max_abs_diff", "top1_agreement", "logit_kl"):
            try:
                _SHADOW_DIV.remove(model=model, metric=metric)
            except Exception:
                pass
    except Exception:
        _LOG.debug("numwatch detach for model %r dropped", model,
                   exc_info=True)


def reset():
    """Test hook: forget every episode, stride clock and shadow."""
    with _lock:
        _tap_counts.clear()
        _storms.clear()
        _storm_counts.clear()
        _last_stats.clear()
        _shadows.clear()
