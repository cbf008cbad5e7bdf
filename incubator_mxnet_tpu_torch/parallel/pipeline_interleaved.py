"""Interleaved (virtual-stage) 1F1B pipeline schedule (counterpart of
``incubator_mxnet_tpu/parallel/pipeline_interleaved.py``).

Megatron-LM-style interleaving (arXiv:2104.04473 §2.2): each of the p
positions hosts ``v`` model chunks (virtual stages), so the model is cut
into V = v*p stages and the bubble shrinks about v-fold:
(p-1)/(v*m) of the step against (p-1)/m without interleaving.

The schedule is computed on the host by a greedy list scheduler over the op
DAG (one op per position per tick, +1-ring activation / -1-ring gradient
hops with one tick of latency, 1F1B drain priority): the tick tables (op /
chunk / micro / arrival per position) are plain Python and numpy, carried
over from the JAX package as they are. The SPMD body reads them with
(tick, ``axis_index``) and runs that tick's F or B: a stage's backward
recomputes it from its stashed input (``pipeline.stage_vjp``).
``schedule_stats`` gives the exact bubble fraction of any schedule.
"""
from __future__ import annotations

import functools

import numpy as onp
import torch
from torch.utils import _pytree as pytree

from .compat import (axis_index, axis_size, pcast,  # noqa: F401
                     ppermute, psum, shard_map)
from .mesh import P
from .pipeline import stage_vjp

__all__ = ["interleaved_schedule", "schedule_stats",
           "pipeline_interleaved_grads", "schedule_1f1b", "schedule_gpipe"]


# ------------------------------------------------------------- scheduler
def interleaved_schedule(m, p, v):
    """Greedy 1F1B list schedule for m microbatches, p devices, v chunks.

    Returns a list of ticks; each tick is a list of p entries
    ``None | ('F'|'B', chunk, micro)``.  Dependency model (1-tick ring
    latency, matching the executor's ppermute placement):

    * F(S, i) needs F(S-1, i) to have finished by tick t-1 (activation
      arrives at t); F(0, i) is always ready.
    * B(S, i) needs B(S+1, i) finished by t-1 (cotangent arrives at t);
      B(V-1, i) needs F(V-1, i) finished by t-1 (its stash slot written).
    * One op per device per tick; B preferred over F (1F1B drain rule),
      lower micro first, then lower chunk (FIFO).
    """
    V = v * p
    done_F = {}   # (S, i) -> finish tick
    done_B = {}
    ticks = []
    total = 2 * V * m
    ndone = 0
    t = 0
    while ndone < total:
        row = [None] * p
        for d in range(p):
            best = None
            # backwards first (1F1B), FIFO by micro then chunk
            for c in range(v - 1, -1, -1):
                S = c * p + d
                for i in range(m):
                    if (S, i) in done_B:
                        continue
                    if S == V - 1:
                        ready = done_F.get((S, i), t) < t
                    else:
                        ready = done_B.get((S + 1, i), t) < t
                    if ready:
                        cand = ("B", c, i)
                        if best is None or (cand[2], cand[1]) < \
                                (best[2], best[1]):
                            best = cand
                        break   # FIFO in i for this chunk
            if best is None:
                for c in range(v):
                    S = c * p + d
                    for i in range(m):
                        if (S, i) in done_F:
                            continue
                        ready = S == 0 or done_F.get((S - 1, i), t) < t
                        if ready:
                            cand = ("F", c, i)
                            if best is None or (cand[2], cand[1]) < \
                                    (best[2], best[1]):
                                best = cand
                            break
            if best is not None:
                typ, c, i = best
                S = c * p + d
                if typ == "F":
                    done_F[(S, i)] = t
                else:
                    done_B[(S, i)] = t
                ndone += 1
                row[d] = best
        ticks.append(row)
        t += 1
        assert t < 8 * total + 64, "scheduler livelock"
    return ticks


def schedule_1f1b(m, p):
    """Non-interleaved 1F1B = interleaved with v=1 (same dependency model)."""
    return interleaved_schedule(m, p, 1)


def schedule_gpipe(m, p):
    """GPipe: all forwards, then all backwards (synchronous flush) —
    expressed in the same tick table format for comparable stats."""
    ticks = []
    # forward wave
    for t in range(m + p - 1):
        row = [None] * p
        for d in range(p):
            i = t - d
            if 0 <= i < m:
                row[d] = ("F", 0, i)
        ticks.append(row)
    # backward wave (reverse ring)
    for t in range(m + p - 1):
        row = [None] * p
        for d in range(p):
            i = t - (p - 1 - d)
            if 0 <= i < m:
                row[d] = ("B", 0, i)
        ticks.append(row)
    return ticks


def schedule_stats(ticks, p, f_cost=1.0, b_cost=2.0):
    """Bubble fraction of a schedule, cost-weighted (backward ≈ 2x forward).

    Tick duration = the max op cost issued that tick (devices are
    lock-stepped by the ring); idle time = Σ_device (step − busy)."""
    step = 0.0
    busy = [0.0] * p
    for row in ticks:
        dur = max([f_cost if op[0] == "F" else b_cost
                   for op in row if op] or [0.0])
        step += dur
        for d in range(p):
            if row[d]:
                busy[d] += f_cost if row[d][0] == "F" else b_cost
    total = step * p
    return {
        "ticks": len(ticks),
        "step_cost": step,
        "bubble_fraction": (total - sum(busy)) / total,
        "per_device_busy": busy,
    }


# ------------------------------------------------------------- executor
def _stash_bound(ticks, p, v, m):
    """Exact stash-slot bound from the schedule: the max number of
    microbatches simultaneously in flight through any (device, chunk)'s
    forward-input / arrived-activation / arrived-cotangent windows.  The
    greedy scheduler issues FIFO per stage, so in-flight micros form a
    contiguous index range and ``i % K`` slots never collide for
    K >= the window size.  This is what makes interleaved memory bounded
    by the SCHEDULE depth (~p + v) instead of n_microbatches."""
    V = v * p
    fin_F, fin_B = {}, {}
    for t, row in enumerate(ticks):
        for d, op in enumerate(row):
            if op:
                typ, c, i = op
                (fin_F if typ == "F" else fin_B)[(c * p + d, i)] = t
    bound = 1
    T = len(ticks)
    for S in range(V):
        windows = [(lambda i: fin_F[(S, i)], lambda i: fin_B[(S, i)]),
                   (lambda i: (fin_B[(S + 1, i)] + 1) if S < V - 1
                    else fin_F[(S, i)], lambda i: fin_B[(S, i)])]
        if S > 0:
            # arrived-activation window; stage 0 has NO ring arrival (its
            # input is read straight from the replicated x_mb at F time),
            # so no window — counting one would make the bound linear in m
            windows.append((lambda i: fin_F[(S - 1, i)] + 1,
                            lambda i: fin_F[(S, i)]))
        for lo_fn, hi_fn in windows:
            events = [(lo_fn(i), hi_fn(i)) for i in range(m)]
            for t in range(T):
                live = sum(1 for lo, hi in events if lo <= t <= hi)
                bound = max(bound, live)
    return bound


def _tables(ticks, p, v, m):
    """Static numpy tick tables for the SPMD body (+ arrival decode)."""
    T = len(ticks)
    V = v * p
    op = onp.zeros((T, p), onp.int32)       # 0 none, 1 F, 2 B
    chk = onp.zeros((T, p), onp.int32)
    mic = onp.zeros((T, p), onp.int32)
    for t, row in enumerate(ticks):
        for d in range(p):
            if row[d]:
                typ, c, i = row[d]
                op[t, d] = 1 if typ == "F" else 2
                chk[t, d] = c
                mic[t, d] = i
    # arrivals at tick t on device d = neighbour's op at t-1
    arrF = onp.zeros((T, p), onp.int32)     # 1 if an activation arrives
    arrF_c = onp.zeros((T, p), onp.int32)   # destination chunk
    arrF_i = onp.zeros((T, p), onp.int32)
    arrB = onp.zeros((T, p), onp.int32)
    arrB_c = onp.zeros((T, p), onp.int32)
    arrB_i = onp.zeros((T, p), onp.int32)
    for t in range(1, T):
        for d in range(p):
            src = (d - 1) % p
            if op[t - 1, src] == 1:
                S = chk[t - 1, src] * p + src
                if S < V - 1:               # last stage's output: no consumer
                    arrF[t, d] = 1
                    arrF_c[t, d] = (S + 1) // p
                    arrF_i[t, d] = mic[t - 1, src]
            src = (d + 1) % p
            if op[t - 1, src] == 2:
                S = chk[t - 1, src] * p + src
                if S > 0:
                    arrB[t, d] = 1
                    arrB_c[t, d] = (S - 1) // p
                    arrB_i[t, d] = mic[t - 1, src]
    return [onp.asarray(a) for a in
            (op, chk, mic, arrF, arrF_c, arrF_i, arrB, arrB_c, arrB_i)]


def _interleaved_sharded(x_mb, y_mb, stacked_params, tables, stage_fn,
                         loss_fn, axis_name, v, m, kslots):
    """SPMD body: run the tick tables on the pp ring."""
    p = axis_size(axis_name)
    d = axis_index(axis_name)
    V = v * p
    # local params: (v, 1, ...) -> one structure per chunk
    params = pytree.tree_map(lambda q: q[:, 0].detach(), stacked_params)
    chunks = [pytree.tree_map(lambda q, c=c: q[c], params) for c in range(v)]
    (opT, chkT, micT, arrF, arrFc, arrFi, arrB, arrBc, arrBi) = [
        a[:, d].tolist() for a in tables]
    zeros = x_mb.new_zeros(x_mb.shape[1:])
    a_in, g_in = zeros, zeros
    a_stash, f_stash, g_stash = {}, {}, {}
    pgrads = [pytree.tree_map(lambda q: torch.zeros_like(
        q, dtype=torch.float32), chunk) for chunk in chunks]
    dx_buf = [zeros] * m
    loss_acc = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    fwd = [(j, (j + 1) % p) for j in range(p)]
    bwd = [(j, (j - 1) % p) for j in range(p)]
    for t in range(len(opT)):
        # bank the arrivals (activation from d-1, cotangent from d+1)
        if arrF[t]:
            a_stash[(arrFc[t], arrFi[t] % kslots)] = a_in
        if arrB[t]:
            g_stash[(arrBc[t], arrBi[t] % kslots)] = g_in
        c, i = chkT[t], micT[t]
        S = c * p + d
        slot = (c, i % kslots)
        a_out, g_out = zeros, zeros
        if opT[t] == 1:
            inp = x_mb[i] if S == 0 else a_stash[slot]
            with torch.no_grad():
                a_out = stage_fn(chunks[c], inp)
            f_stash[slot] = inp
        elif opT[t] == 2:
            if S == V - 1:
                lv, dpar, dx = stage_vjp(stage_fn, chunks[c], f_stash[slot],
                                         loss_fn, y_mb[i])
            else:
                lv, dpar, dx = stage_vjp(stage_fn, chunks[c], f_stash[slot],
                                         cotangent=g_stash[slot])
            loss_acc = loss_acc + lv
            pgrads[c] = pytree.tree_map(torch.add, pgrads[c], dpar)
            if S == 0:
                dx_buf[i] = dx
            g_out = dx
        a_in = ppermute(a_out, axis_name, fwd)
        g_in = ppermute(g_out.to(x_mb.dtype), axis_name, bwd)
    loss = psum(loss_acc if d == p - 1 else torch.zeros_like(loss_acc),
                axis_name) / m
    dx = torch.stack(dx_buf)
    dx = psum(dx if d == 0 else torch.zeros_like(dx), axis_name)
    # (v, 1, ...) per position: chunk-major, this position's stage slice
    stacked = pytree.tree_map(lambda *gs: torch.stack(gs)[:, None], *pgrads)
    return loss, stacked, dx


def pipeline_interleaved_grads(stage_fn, loss_fn, stacked_params, x, y,
                               mesh, n_microbatches, v, axis="pp"):
    """Interleaved-1F1B train-step core. ``stacked_params``: leading dims
    (v, p), chunk-major; virtual stage S = c*p + d runs chunk c's slice on
    position d. Returns (mean loss, parameter gradients (v, p, ...) fp32,
    input gradients): the contract of ``pipeline_1f1b_grads``, which is
    this with v=1."""
    p = int(mesh.shape[axis])
    leaves = pytree.tree_leaves(stacked_params)
    if leaves and tuple(leaves[0].shape[:2]) != (v, p):
        raise ValueError("stacked_params leading dims must be (v=%d, p=%d)"
                         % (v, p))
    if x.shape[0] % n_microbatches:
        raise ValueError("batch %d not divisible by n_microbatches %d"
                         % (x.shape[0], n_microbatches))
    m = n_microbatches
    mb = x.shape[0] // m
    x_mb = x.reshape((m, mb) + tuple(x.shape[1:]))
    y_mb = y.reshape((m, mb) + tuple(y.shape[1:]))
    ticks = interleaved_schedule(m, p, v)
    tables = _tables(ticks, p, v, m)
    kslots = _stash_bound(ticks, p, v, m)
    specs = pytree.tree_map(
        lambda q: P(None, axis, *([None] * (q.dim() - 2))), stacked_params)
    fn = functools.partial(_interleaved_sharded, tables=tables,
                           stage_fn=stage_fn, loss_fn=loss_fn,
                           axis_name=axis, v=v, m=m, kslots=kslots)
    with torch.no_grad():
        loss, pgrads, dx = shard_map(
            fn, mesh=mesh, in_specs=(P(), P(), specs),
            out_specs=(P(), specs, P()), check_vma=False, axes=(axis,))(
                x_mb, y_mb, stacked_params)
    return loss, pgrads, dx.reshape((x.shape[0],) + tuple(dx.shape[2:]))
