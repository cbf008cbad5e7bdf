"""Drivers of serving traffic through ``ModelRegistry``: ``"kind":
"serve_closed"``, a closed loop of client threads, each calling
``ModelRegistry.predict`` with one request and sending its next on the
reply; ``"kind": "serve_open"``, an open loop, one thread submitting
requests on a schedule of arrivals fixed by the mix's rate and the seed,
whatever the replies do.

Set-up builds the served block with the seed's weights, draws
``distinct_requests`` requests on the device, loads the block into a
``ModelRegistry`` with the mix's batcher settings (every bucket prewarmed:
one captured ``EvalStep`` graph each) and runs the same load for
``warm_s``. The window then runs ``seconds`` on the host's clock.

Closed loop: client c sends requests c, c + C, c + 2C, ... of the pool (C
clients), so every seed serves the same amount of work in another order.
A request's time is from its ``predict`` call to its reply; throughput
counts the replies received inside the window; the tail is over every
request sent inside it, each waited for.

Open loop: the gaps between arrivals are the ``gap_pool`` quantiles of an
exponential distribution at the mix's rate (a Poisson process), the same
set for every seed in the seed's order, cycled. A request's time runs
from when it was due to its reply, so a stall of the submitting thread
counts against the requests behind it; the tail is over every request due
inside the window, each waited for, a failed one counting as missing.

Once the window has closed (and, with ``--trace 1``, a profiled segment of
``profiled_s`` under the same load after it), the registry is closed and
the program freed; a sample of ``checked_replies`` replies drawn from the
seed is held against the fp32 reference of the same requests' tokens.
"""
from __future__ import annotations

import queue as _queue
import statistics
import threading
import time

import numpy as np
import torch

from portbench.core import compare, devtrace, weights
from portbench.core.trace import Trace
from portbench.reference import plain

REPLY_TIMEOUT_S = 60.0


class _Loop:
    """C client threads over a request pool; ``records[c]`` is a list of
    (request index, sent, received, reply or None) on the host's clock."""

    def __init__(self, reg, name, ids, types, clients, keep):
        self.reg, self.name = reg, name
        self.ids, self.types = ids, types
        self.clients, self.keep = clients, keep
        self.go = threading.Event()
        self.stop_at = float("inf")
        self.records = [[] for _ in range(clients)]
        self.threads = [threading.Thread(target=self._client, args=(c,),
                                         name="portbench-client-%d" % c)
                        for c in range(clients)]
        for t in self.threads:
            t.start()

    def _client(self, c):
        n = self.ids.shape[0]
        rec = self.records[c]
        self.go.wait()
        k = 0
        while True:
            sent = time.perf_counter()
            if sent >= self.stop_at:
                return
            j = (c + k * self.clients) % n
            k += 1
            try:
                out = self.reg.predict(self.name, self.ids[j], self.types[j],
                                       timeout=REPLY_TIMEOUT_S)[0]
            except Exception:      # noqa: BLE001 — a failed request counts
                out = None
            rec.append((j, sent, time.perf_counter(),
                        out if (self.keep or out is None) else True))

    def start(self, stop_at):
        self.stop_at = stop_at
        self.go.set()

    def stop(self):
        self.stop_at = time.perf_counter()
        for t in self.threads:
            t.join(REPLY_TIMEOUT_S + 30)
        alive = [t.name for t in self.threads if t.is_alive()]
        if alive:
            raise RuntimeError("clients still waiting: %s" % alive[:4])


class OpenLoop:
    """One thread submits request ``n % N`` of the pool at its due time;
    a second waits for the replies in the order they were sent (one
    replica serves its queue in order). ``records`` is a list of (request
    index, due, submitted, received, reply or None) on the host's
    clock."""

    def __init__(self, reg, name, ids, types, gaps, keep):
        self.reg, self.name = reg, name
        self.ids, self.types, self.gaps = ids, types, gaps
        self.keep = keep
        self.records = []
        self._pending = _queue.Queue()

    def run(self, start, stop):
        """Submit every arrival due in [start, stop), then wait for every
        reply. Returns the records of those arrivals."""
        self.records = []
        waiter = threading.Thread(target=self._wait,
                                  name="portbench-open-waiter")
        waiter.start()
        n, due = 0, start
        try:
            while due < stop:
                now = time.perf_counter()
                if due > now:
                    time.sleep(due - now)
                j = n % self.ids.shape[0]
                try:
                    req = self.reg.submit(self.name, self.ids[j],
                                          self.types[j])
                except Exception:  # noqa: BLE001 — a refused request counts
                    req = None
                self._pending.put((j, due, time.perf_counter(), req))
                due += self.gaps[n % len(self.gaps)]
                n += 1
        finally:
            self._pending.put(None)
            waiter.join()
        return self.records

    def _wait(self):
        while True:
            item = self._pending.get()
            if item is None:
                return
            j, due, submitted, req = item
            out = None
            if req is not None:
                try:
                    out = req.result(REPLY_TIMEOUT_S)[0]
                except Exception:  # noqa: BLE001 — a failed request counts
                    out = None
            self.records.append((j, due, submitted, time.perf_counter(),
                                 out if (self.keep or out is None)
                                 else True))


def arrival_gaps(traffic, seed):
    """The open loop's gaps in seconds: the ``gap_pool`` quantiles of an
    exponential distribution of mean 1 / ``rate_per_s``, in an order drawn
    from the seed."""
    n, rate = traffic["gap_pool"], float(traffic["rate_per_s"])
    q = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    gaps = -torch.log1p(-q) / rate
    order = torch.randperm(n, generator=weights.generator(
        seed, torch.device("cpu"), 3))
    return gaps[order].tolist()


def serve_setup(cell, seed, dev):
    """The loaded registry, its model's name, and the request pool on the
    host (ids, types)."""
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.serving import ModelRegistry

    cfg, tr, model = cell.config, cell.traffic, cell.model
    task = tr["task"]
    net = model.build(mxt, cfg, task, dev.ctx(mxt))
    weights.load_into(net, weights.make(model.param_specs(cfg, task), seed,
                                        dev.torch, model.dtype(cfg)))
    gen = weights.generator(seed, dev.torch, 1)
    ids_d, types_d = model.make_requests(cfg, tr, gen, dev.torch)
    ids, types = ids_d.cpu().numpy(), types_d.cpu().numpy()
    del ids_d, types_d
    reg = ModelRegistry()
    name = cell.entry["config"]
    S = tr["seq_len"]
    reg.load(name, net, prewarm=True,
             warm_spec=[((S,), "int32"), ((S,), "int32")],
             max_batch_size=tr["max_batch_size"],
             batch_timeout_ms=tr["batch_timeout_ms"])
    return reg, name, ids, types


def _check(cell, seed, dev, ids, types, done):
    """Hold a sample of the finished replies ``done`` [(request index,
    reply)], drawn from the seed, against the fp32 reference."""
    cfg, tr, model = cell.config, cell.traffic, cell.model
    t_ref = time.perf_counter()
    g = weights.generator(seed, torch.device("cpu"), 2)
    order = torch.randperm(len(done), generator=g)[:tr["checked_replies"]]
    sample = [done[int(i)] for i in order]
    rows = torch.tensor([j for j, _ in sample], dtype=torch.long)
    got = torch.from_numpy(np.stack([out for _, out in sample])).float()
    plain.highest_precision()
    ref_w = weights.widened(model.param_specs(cfg, tr["task"]), seed,
                            dev.torch, model.dtype(cfg))
    fn = getattr(cell.reference, tr["task"])(cfg, "fp32")
    want = plain.forward_blocks(
        lambda a, b: fn(ref_w, a, b),
        [torch.from_numpy(ids)[rows].to(dev.torch),
         torch.from_numpy(types)[rows].to(dev.torch)],
        tr["reference_rows_per_block"]).float().cpu()
    numbers, detail = compare.serving(
        got, want, ref_w[model.readout(tr["task"])].cpu())
    detail["compared"] = len(sample)
    del ref_w
    dev.release()
    detail["reference_s"] = time.perf_counter() - t_ref
    return numbers, detail


def _close(reg):
    from incubator_mxnet_tpu_torch import aot
    reg.close()
    aot.CACHE.clear()


def run_open(cell, seed, seconds, trace, dev):
    from incubator_mxnet_tpu_torch import profiler
    from incubator_mxnet_tpu_torch.telemetry import spans

    tr = cell.traffic
    reg, name, ids, types = serve_setup(cell, seed, dev)
    loop = OpenLoop(reg, name, ids, types, arrival_gaps(tr, seed),
                    keep=False)
    t = time.perf_counter()
    loop.run(t, t + tr["warm_s"])
    loop.keep = True

    if trace:
        spans.reset()
    t0 = time.perf_counter()
    t0_us = profiler.now_us()
    end = t0 + seconds
    seg = None
    if trace:
        # the segment profiles the same arrivals after the window
        box = {}
        feeder = threading.Thread(target=lambda: box.setdefault(
            "records", loop.run(t0, end + tr["profiled_s"] + 0.5)))
        feeder.start()
        time.sleep(max(0.0, end - time.perf_counter()))
        t1_us = profiler.now_us()
        with devtrace.Segment(dev, profiler.now_us) as seg:
            time.sleep(tr["profiled_s"])
        feeder.join()
        records = box["records"]
    else:
        records = loop.run(t0, end)
        t1_us = profiler.now_us()
    peak = dev.peak_bytes()

    due_in = [r for r in records if r[1] < end]
    failed = sum(1 for r in due_in if r[4] is None)
    times = [r[3] - r[1] if r[4] is not None else float("inf")
             for r in due_in]
    late = [r[2] - r[1] for r in due_in]
    e2e = {"serve_p95_ms": 1e3 * statistics.quantiles(times, n=20)[-1]}
    trace_data = None
    if trace:
        trace_data = Trace(cell, dev, spans.snapshot(), t0_us, t1_us,
                           seconds, seg, served=sum(
                               1 for r in due_in
                               if r[4] is not None and r[3] <= end))
    done = [(r[0], r[4]) for r in due_in if r[4] is not None]
    _close(reg)
    del reg, loop
    dev.release()
    numbers, detail = _check(cell, seed, dev, ids, types, done)
    detail.update(due=len(due_in), served_per_s=sum(
        1 for r in due_in if r[4] is not None and r[3] <= end) / seconds,
        p50_ms=1e3 * statistics.median(times),
        late_p99_ms=1e3 * statistics.quantiles(late, n=100)[-1])
    return dict(t0=t0, e2e=e2e, trace=trace_data, segment=seg,
                numbers=numbers, detail=detail, attempted=len(due_in),
                failed=failed, memory_peak_bytes=peak)


def run(cell, seed, seconds, trace, dev):
    from incubator_mxnet_tpu_torch import profiler
    from incubator_mxnet_tpu_torch.telemetry import spans

    tr = cell.traffic
    C = tr["clients"]
    reg, name, ids, types = serve_setup(cell, seed, dev)
    warm = _Loop(reg, name, ids, types, C, keep=False)
    warm.start(time.perf_counter() + tr["warm_s"])
    warm.stop()

    loop = _Loop(reg, name, ids, types, C, keep=True)
    if trace:
        spans.reset()
    t0 = time.perf_counter()
    t0_us = profiler.now_us()
    end = t0 + seconds
    loop.start(float("inf") if trace else end)
    time.sleep(max(0.0, end - time.perf_counter()))
    t1_us = profiler.now_us()
    seg = None
    if trace:
        with devtrace.Segment(dev, profiler.now_us) as seg:
            time.sleep(tr["profiled_s"])
    loop.stop()
    peak = dev.peak_bytes()

    records = [r for rec in loop.records for r in rec]
    sent_in = [r for r in records if r[1] < end]
    failed = sum(1 for r in sent_in if r[3] is None)
    done = [r for r in sent_in if r[3] is not None]
    served = sum(1 for r in done if r[2] <= end)
    times = [r[2] - r[1] if r[3] is not None else float("inf")
             for r in sent_in]
    e2e = {"serve_seqs_per_s": served / seconds}
    trace_data = None
    if trace:
        trace_data = Trace(cell, dev, spans.snapshot(), t0_us, t1_us,
                           seconds, seg, served=served)
    _close(reg)
    del reg, loop, warm
    dev.release()
    numbers, detail = _check(cell, seed, dev, ids, types,
                             [(r[0], r[3]) for r in done])
    detail.update(p50_ms=1e3 * statistics.median(times),
                  p95_ms=1e3 * statistics.quantiles(times, n=20)[-1])
    return dict(t0=t0, e2e=e2e, trace=trace_data, segment=seg,
                numbers=numbers, detail=detail, attempted=len(sent_in),
                failed=failed, memory_peak_bytes=peak)
