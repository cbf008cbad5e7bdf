"""Pipeline parallelism (counterpart of
``incubator_mxnet_tpu/parallel/pipeline.py``).

GPipe-style microbatching over structurally identical stages with
``shard_map`` and ``ppermute`` over the ``pp`` mesh axis: stage weights are
stacked on a leading stage dim split over ``pp``; activations move one
stage along the ring per microbatch tick. The GPipe path is differentiable
(the ring's exchanges are differentiable ops), so one backward over its
output trains every stage. ``pipeline_1f1b_grads`` is the hand-scheduled
1F1B: each stage's backward recomputes the stage from its stashed input
with ``torch.autograd.grad`` at its B tick and hands the cotangent back
along the ring.

As in the JAX package's ``lax.cond``s, a stage computes only at the ticks
its schedule gives it (a static branch here: ``axis_index`` is an int);
every stage still takes part in each tick's exchange. ``data_axis``
composes pp with data parallelism (the microbatch dim split over it);
``key`` (an int seed) gives each stage and tick its own
``torch.Generator``, passed as ``stage_fn``'s third argument.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import _pytree as pytree

from .compat import (axis_index, axis_size, pcast,  # noqa: F401
                     ppermute, psum, shard_map)
from .mesh import P

__all__ = ["PipelineParallel", "pipeline_spmd", "pipeline_1f1b_grads"]


def _stage_generator(key, stage, tick, device):
    """The generator of one stage at one tick, from the seed ``key``."""
    seed = (int(key) * 1000003 + stage * 10007 + tick) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(seed)


def _pipeline_sharded(x_mb, stacked_params, stage_fn, axis_name,
                      n_microbatches, key=None):
    """Inside shard_map: this position holds one stage's parameters (a
    leading stage dim of 1) and the whole stream of microbatches. Returns
    (n_micro, mb, ...) outputs, the last stage's, on every position."""
    n_stages = axis_size(axis_name)
    stage = axis_index(axis_name)
    params = pytree.tree_map(lambda p: p[0], stacked_params)
    mb_shape = x_mb.shape[1:]
    zeros = x_mb.new_zeros(mb_shape)
    perm = [(j, (j + 1) % n_stages) for j in range(n_stages)]
    state = zeros
    outputs = [zeros] * n_microbatches
    for t in range(n_microbatches + n_stages - 1):
        i = t - stage                     # the microbatch at this stage now
        if 0 <= i < n_microbatches:
            cur = x_mb[i] if stage == 0 else state
            if key is None:
                out = stage_fn(params, cur)
            else:
                out = stage_fn(params, cur, _stage_generator(
                    key, stage, t, x_mb.device))
            if stage == n_stages - 1:
                outputs[i] = out
        else:
            out = zeros
        state = ppermute(out, axis_name, perm)
    outputs = torch.stack(outputs)
    # only the last stage holds real outputs: every position takes its
    return psum(outputs if stage == n_stages - 1
                else torch.zeros_like(outputs), axis_name)


def _param_specs(stacked_params, lead):
    return pytree.tree_map(
        lambda p: P(*lead, *([None] * (p.dim() - len(lead)))),
        stacked_params)


def pipeline_spmd(stage_fn, stacked_params, x, mesh, n_microbatches,
                  axis="pp", data_axis=None, key=None):
    """Run a pipeline of structurally identical stages. ``stage_fn(params,
    x[, generator]) -> y`` keeps the shape; ``stacked_params`` (a structure
    of tensors) has a leading dim of ``mesh.shape[axis]`` stages; x (batch,
    ...) is split into ``n_microbatches`` on dim 0. With ``data_axis`` the
    microbatch dim is split over that mesh axis too."""
    n_stages = int(mesh.shape[axis])
    leaves = pytree.tree_leaves(stacked_params)
    if leaves and leaves[0].shape[0] != n_stages:
        raise ValueError(
            "stacked_params leading dim (%d stages) must equal the %r mesh "
            "axis size (%d) — a divisible mismatch would silently drop "
            "stages" % (leaves[0].shape[0], axis, n_stages))
    if x.shape[0] % n_microbatches:
        raise ValueError("batch %d not divisible by n_microbatches %d"
                         % (x.shape[0], n_microbatches))
    mb = x.shape[0] // n_microbatches
    x_mb = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))
    fn = functools.partial(_pipeline_sharded, stage_fn=stage_fn,
                           axis_name=axis, n_microbatches=n_microbatches,
                           key=key)
    io_spec = P(None, data_axis) if data_axis else P()
    axes = (axis, data_axis) if data_axis else (axis,)
    out = shard_map(fn, mesh=mesh,
                    in_specs=(io_spec, _param_specs(stacked_params, (axis,))),
                    out_specs=io_spec, axes=axes)(x_mb, stacked_params)
    return out.reshape((x.shape[0],) + tuple(out.shape[2:]))


class PipelineParallel:
    """Pipeline a stack of identical stages: ``stage_fn`` with parameters
    stacked on a leading dim split over ``pp``."""

    def __init__(self, stage_fn, n_stages, mesh, axis="pp",
                 n_microbatches=None):
        self.stage_fn = stage_fn
        self.n_stages = n_stages
        self.mesh = mesh
        self.axis = axis
        self.n_microbatches = n_microbatches or n_stages

    def __call__(self, stacked_params, x):
        return pipeline_spmd(self.stage_fn, stacked_params, x, self.mesh,
                             self.n_microbatches, self.axis)


# ----------------------------------------------------------------- 1F1B
def stage_vjp(stage_fn, params, x, loss_fn=None, y=None, cotangent=None):
    """One stage's backward, recomputed from its input: (loss or 0, the
    parameters' gradients in fp32, dx). With ``loss_fn`` the loss of the
    stage's output against ``y`` is differentiated; otherwise the output
    with ``cotangent``."""
    leaves, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        leaves = [q.detach().requires_grad_() for q in leaves]
        xin = x.detach().requires_grad_()
        out = stage_fn(pytree.tree_unflatten(leaves, spec), xin)
        if loss_fn is not None:
            lv = loss_fn(out, y)
            got = torch.autograd.grad(lv, leaves + [xin], allow_unused=True)
            lv = lv.detach().float()
        else:
            got = torch.autograd.grad(out, leaves + [xin],
                                      cotangent.to(out.dtype),
                                      allow_unused=True)
            lv = torch.zeros((), dtype=torch.float32, device=x.device)
    grads = [torch.zeros_like(q, dtype=torch.float32) if g is None
             else g.float() for q, g in zip(leaves, got[:-1])]
    dx = torch.zeros_like(x) if got[-1] is None else got[-1]
    return lv, pytree.tree_unflatten(grads, spec), dx


def _pipeline_1f1b_sharded(x_mb, y_mb, stacked_params, stage_fn, loss_fn,
                           axis_name):
    """Hand-scheduled 1F1B (PipeDream-flush) inside shard_map: stage s runs
    F_i at tick t = s + 2i and B_i at t = 2(p+i) - s - 1 (opposite parity,
    so each tick is one F, one B or idle); activations move +1 on the ring
    each tick, cotangents -1; the stash holds p inputs per stage. Returns
    (mean loss, this stage's parameter gradients with a leading dim of 1,
    dx per microbatch)."""
    p = axis_size(axis_name)
    s = axis_index(axis_name)
    params = pytree.tree_map(lambda q: q[0].detach(), stacked_params)
    m = x_mb.shape[0]
    zeros = x_mb.new_zeros(x_mb.shape[1:])
    K = p
    fwd_perm = [(j, (j + 1) % p) for j in range(p)]
    bwd_perm = [(j, (j - 1) % p) for j in range(p)]
    a_reg, g_reg = zeros, zeros
    stash = [None] * K
    pgrads = pytree.tree_map(lambda q: torch.zeros_like(
        q, dtype=torch.float32), params)
    dx_buf = [zeros] * m
    loss_acc = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    for t in range(2 * (m + p - 1)):
        a_out, g_out = zeros, zeros
        iF, rF = divmod(t - s, 2)
        if rF == 0 and t >= s and iF < m:
            finp = x_mb[iF] if s == 0 else a_reg
            with torch.no_grad():
                a_out = stage_fn(params, finp)
            stash[iF % K] = finp
        iB, rB = divmod(t + s + 1 - 2 * p, 2)
        if rB == 0 and 0 <= iB < m:
            binp = stash[iB % K]
            if s == p - 1:
                lv, dpar, dx = stage_vjp(stage_fn, params, binp, loss_fn,
                                         y_mb[iB])
            else:
                lv, dpar, dx = stage_vjp(stage_fn, params, binp,
                                         cotangent=g_reg)
            loss_acc = loss_acc + lv
            pgrads = pytree.tree_map(torch.add, pgrads, dpar)
            if s == 0:
                dx_buf[iB] = dx
            g_out = dx
        a_reg = ppermute(a_out, axis_name, fwd_perm)
        g_reg = ppermute(g_out.to(x_mb.dtype), axis_name, bwd_perm)
    loss = psum(loss_acc if s == p - 1 else torch.zeros_like(loss_acc),
                axis_name) / m
    dx = torch.stack(dx_buf)
    dx = psum(dx if s == 0 else torch.zeros_like(dx), axis_name)
    return loss, pytree.tree_map(lambda g: g[None], pgrads), dx


def pipeline_1f1b_grads(stage_fn, loss_fn, stacked_params, x, y, mesh,
                        n_microbatches, axis="pp"):
    """1F1B pipeline train-step core: (mean loss, stage parameter gradients
    (stacked as the parameters, fp32), input gradients). Same bubble as
    the GPipe path (2(m+p-1) ticks); the stash holds n_stages inputs per
    stage instead of n_microbatches. ``stage_fn(params, x) -> y`` keeps
    the shape; ``loss_fn(out, y_mb) -> scalar`` runs on the last stage."""
    p = int(mesh.shape[axis])
    leaves = pytree.tree_leaves(stacked_params)
    if leaves and leaves[0].shape[0] != p:
        raise ValueError("stacked_params leading dim must equal the %r "
                         "axis size %d" % (axis, p))
    if x.shape[0] % n_microbatches:
        raise ValueError("batch %d not divisible by n_microbatches %d"
                         % (x.shape[0], n_microbatches))
    mb = x.shape[0] // n_microbatches
    x_mb = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))
    y_mb = y.reshape((n_microbatches, mb) + tuple(y.shape[1:]))
    specs = _param_specs(stacked_params, (axis,))
    fn = functools.partial(_pipeline_1f1b_sharded, stage_fn=stage_fn,
                           loss_fn=loss_fn, axis_name=axis)
    with torch.no_grad():
        loss, pgrads, dx = shard_map(
            fn, mesh=mesh, in_specs=(P(), P(), specs),
            out_specs=(P(), specs, P()), check_vma=False, axes=(axis,))(
                x_mb, y_mb, stacked_params)
    return loss, pgrads, dx.reshape((x.shape[0],) + tuple(dx.shape[2:]))
