"""Driver of ``"kind": "train"`` traffic: pre-training through the port's
captured ``jit.TrainStep``.

Set-up builds one step object (the net, the loss, ``gluon.Trainer`` with
fp32 masters) with the seed's weights, makes ``distinct_batches`` batches
on the device, and drives the step through its first ``checked_steps``
steps on the first batches: the first runs the step eagerly and captures
its CUDA graph, the later ones replay it, as every step of the window
does. The program's numbers for the check are read there: each step's
loss; step 1's gradient from Adam's first moment (m₁ = (1 - β1) g₁),
copied to the host as the step ends
(``jit.TrainStep`` keeps its gradients to itself: the parameters'
``grad()`` stay as they were, so the optimizer's state is the one place
that holds them); and, after the checked steps, the change of the net's
own weights (``Parameter.data()``, bf16), before a later step moves them.

The window then replays the same step on the next batches, cycling, until
``seconds`` have passed on the host's clock, with at most two steps in
flight (an event wait, no read-back), and ends at a synchronise. Once it
has closed, the memory peak read and the program freed, the reference
follows the checked steps in fp32 from the same weights and batches,
holding the net's weights in bf16 as the configuration does.
"""
from __future__ import annotations

import time

import torch

from portbench.core import compare, devtrace, weights
from portbench.core.trace import Trace
from portbench.reference import plain


def _first_moment(state):
    """Adam's m in one parameter's trainer state: ``(master, (m, v))``
    under multi_precision, ``(m, v)`` for an fp32 weight."""
    if isinstance(state[1], (tuple, list)):
        return state[1][0]
    return state[0]


def _gradients(moments, beta1):
    """{step: {leaf: gradient}} from Adam's first moment after step 1
    (host tensors): g₁ = m₁ / (1 - β1)."""
    return {t: {n: x / (1 - beta1) for n, x in m.items()}
            for t, m in moments.items() if t == 1}


def run(cell, seed, seconds, trace, dev):
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import aot, profiler
    from incubator_mxnet_tpu_torch.telemetry import spans
    from incubator_mxnet_tpu_torch.torch import to_torch

    cfg, tr, model = cell.config, cell.traffic, cell.model
    task = tr["task"]
    opt = tr["optimizer_params"]
    specs = model.param_specs(cfg, task)
    dtype = model.dtype(cfg)

    net, loss_fn, n_in = model.build(mxt, cfg, task, dev.ctx(mxt))
    w0 = weights.make(specs, seed, dev.torch, dtype)
    weights.load_into(net, w0)
    trainer = mxt.gluon.Trainer(net.collect_params(), tr["optimizer"],
                                dict(opt, multi_precision=True))
    step = mxt.jit.TrainStep(net, loss_fn, trainer)
    gen = weights.generator(seed, dev.torch, 1)
    batches = [model.make_batch(cfg, tr, gen, dev.torch)
               for _ in range(tr["distinct_batches"])]
    names = list(net.collect_params())
    params = net.collect_params()
    index = {id(p): i for i, p in enumerate(trainer._params)}

    def first_moment(n):
        return _first_moment(trainer._states[index[id(params[n])]])

    def served(n):
        return to_torch(params[n].data())

    checked = tr["checked_steps"]
    b1 = opt["beta1"]
    losses, moments = [], {}
    for k in range(checked):
        out = step(*batches[k], n_net_inputs=n_in)
        losses.append(to_torch(out).float().mean())
        if k + 1 in compare.GRAD_STEPS:
            moments[k + 1] = {n: first_moment(n).detach().to(
                "cpu", torch.float32, copy=True) for n in names}
    change = torch.stack([(served(n).float() - w0[n].float()).norm()
                          for n in names])
    losses = [float(x) for x in torch.stack(losses).tolist()]
    change = dict(zip(names, change.tolist()))
    del w0

    B, S = tr["batch"], tr["seq_len"]
    n_batches = len(batches)
    if trace:
        spans.reset()
    dev.sync()
    t0 = time.perf_counter()
    t0_us = profiler.now_us()
    inflight, n = [], 0
    while True:
        if len(inflight) == 2:
            inflight.pop(0).synchronize()
        step(*batches[(checked + n) % n_batches], n_net_inputs=n_in)
        inflight.append(dev.event())
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    dev.sync()
    t1 = time.perf_counter()
    t1_us = profiler.now_us()
    window_s = t1 - t0
    e2e = {"train_tokens_per_s": n * B * S / window_s}

    trace_data = seg = None
    if trace:
        seg_steps = tr["profiled_steps"]
        with devtrace.Segment(dev, profiler.now_us) as seg:
            for k in range(seg_steps):
                step(*batches[(checked + n + k) % n_batches],
                     n_net_inputs=n_in)
        trace_data = Trace(cell, dev, spans.snapshot(), t0_us, t1_us,
                           window_s, seg, steps=n, tokens=n * B * S,
                           segment_steps=seg_steps)
    peak = dev.peak_bytes()

    kept = batches[:checked]
    del step, trainer, loss_fn, net, batches, params, index, out
    aot.CACHE.clear()
    dev.release()

    t_ref = time.perf_counter()
    grads = _gradients(moments, b1)
    prog = (losses, {n: float(g.norm()) for n, g in grads[1].items()},
            change)
    error = compare.GradientError(grads, held_is_reference=False)
    plain.highest_precision()
    ref_w = weights.widened(specs, seed, dev.torch, dtype)
    ref_out = plain.train(ref_w, kept, getattr(cell.reference, task)(
        cfg, "fp32"), opt, tr["reference_rows_per_block"],
        served_dtype=dtype, on_grad=error)
    numbers, detail = compare.training(prog, ref_out, error)
    del ref_w, kept, grads, moments
    dev.release()
    detail["reference_s"] = time.perf_counter() - t_ref
    return dict(t0=t0, e2e=e2e, trace=trace_data, segment=seg,
                numbers=numbers, detail=detail, attempted=n, failed=0,
                memory_peak_bytes=peak)
