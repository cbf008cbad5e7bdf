"""MXNet's optimizer update operators (counterpart of
``incubator_mxnet_tpu/ndarray/optimizer_ops.py``; MXNet's
``optimizer_op.cc``): ``sgd_update`` through
``preloaded_multi_mp_sgd_mom_update``, the LAMB phases, ``multi_sum_sq``,
``multi_lars``, ``all_finite``, ``multi_all_finite`` and ``reset_arrays``.

They write in place, as MXNet's do: state arguments are updated in their
own tensors, and the new weight is copied into ``out`` (into ``weight``
when ``out`` is None), so that a captured CUDA graph's static buffers see
every write. ``out=`` here is MXNet's contract, not the general ``out=``
the port's other operators refuse.

Where an operator's formula is an optimizer's, it runs that optimizer's
``multi_update_rule`` (``optimizer/optimizer.py``) through ``_update``, the
same steps as ``Optimizer.update_all``: the gradient in fp32 times
``rescale_grad``, clipped where ``clip_gradient > 0``, the rule on the fp32
weight (the fp32 master of the ``mp_*`` operators) and the cast back. So
``sgd_update`` is SGD's rule, ``adam_update`` Adam's moments with the step
size given (MXNet's operator takes the bias-corrected rate; no correction
inside), and so on. ``signsgd_update`` (the sign of the raw gradient plus
``wd * w``) and the LAMB phases (split at the trust ratio) have their own
arithmetic. Learning rates and weight decays become fp32 device vectors by
fills, and the ``preloaded_*`` operators take them as device arrays as
they are: nothing reads a device value on the host, so each operator can
run inside a captured graph.
"""
from __future__ import annotations

import torch

from ..optimizer import optimizer as _opt
from .ndarray import NDArray

__all__ = [
    "sgd_update", "sgd_mom_update", "mp_sgd_update", "mp_sgd_mom_update",
    "nag_mom_update", "mp_nag_mom_update", "adam_update", "rmsprop_update",
    "rmspropalex_update", "ftrl_update", "ftml_update", "signsgd_update",
    "signum_update", "lamb_update_phase1", "lamb_update_phase2",
    "mp_lamb_update_phase1", "mp_lamb_update_phase2",
    "multi_sgd_update", "multi_sgd_mom_update", "multi_mp_sgd_update",
    "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
    "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
    "preloaded_multi_mp_sgd_mom_update", "multi_sum_sq", "multi_lars",
    "all_finite", "multi_all_finite", "reset_arrays",
]


def _t(x):
    return x._data if isinstance(x, NDArray) else x


def _clip(c):
    return c if c is not None and c > 0 else None


def _vector(values, n, device):
    """``values`` (a number, numbers, or a device array) as an (n,) fp32
    vector on ``device``, made by fills so that a capture may run it."""
    if isinstance(values, (NDArray, torch.Tensor)):
        return _t(values).to(device=device, dtype=torch.float32).reshape(-1)
    if isinstance(values, (list, tuple)):
        return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                       device=device) for v in values])
    return torch.full((n,), float(values), dtype=torch.float32,
                      device=device)


class _AdamOp(_opt.Adam):
    """Adam's moments with the given step size: MXNet's ``adam_update``
    takes the bias-corrected rate from its caller."""

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        torch._foreach_add_(grads, _opt._wd_terms(weights, wds))
        steps, _ = self._moments(grads, states, lrs, 1)
        torch._foreach_mul_(steps, list(lrs.unbind(0)))
        torch._foreach_sub_(weights, steps)


@torch.no_grad()
def _update(opt, weights, grads, states, lrs, wds, out=None, masters=None,
            rescale_grad=1.0, t=1):
    """One update of the NDArrays ``weights`` by ``opt``'s rule, in place:
    ``states`` per weight (None, a tensor or a tuple, NDArrays or tensors;
    a state not in fp32 runs on an fp32 copy written back), ``masters`` the
    fp32 masters of the ``mp_*`` operators, ``out`` the targets of the new
    weights (default: the weights). Returns the targets."""
    outs = list(out) if out is not None else list(weights)
    w = [_t(x) for x in weights]
    device = w[0].device
    n = len(w)
    rescale = torch.full((), float(rescale_grad), dtype=torch.float32,
                         device=device)
    g32 = torch._foreach_mul([_t(g).float() for g in grads], rescale)
    if opt.clip_gradient is not None:
        torch._foreach_clamp_min_(g32, -opt.clip_gradient)
        torch._foreach_clamp_max_(g32, opt.clip_gradient)
    if masters is not None:
        w32 = [_t(m) for m in masters]
    else:
        w32 = [x if x.dtype == torch.float32 and _t(o) is x
               else x.float().clone() for x, o in zip(w, outs)]
    back = []

    def fp32(s):
        if s is None:
            return None
        if isinstance(s, (tuple, list)):
            return tuple(fp32(e) for e in s)
        s = _t(s)
        if s.dtype == torch.float32:
            return s
        s32 = s.float()
        back.append((s, s32))
        return s32

    inner = [fp32(s) for s in states]
    opt._rescale = rescale
    opt.multi_update_rule(w32, g32, inner, _vector(lrs, n, device),
                          _vector(wds, n, device), t)
    for s, s32 in back:
        s.copy_(s32)
    for o, x in zip(outs, w32):
        if _t(o) is not x:
            _t(o).copy_(x)
    return outs


def _one(opt, weight, grad, state, lr, wd, out, master=None,
         rescale_grad=1.0, t=1):
    return _update(opt, [weight], [grad], [state], lr, wd,
                   None if out is None else [out],
                   None if master is None else [master], rescale_grad, t)[0]


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
               lazy_update=True, out=None):
    """``w -= lr * (g + wd * w)``. ``lazy_update`` matters only for a
    row_sparse gradient; gradients are dense here."""
    return _one(_opt.SGD(clip_gradient=_clip(clip_gradient)), weight, grad,
                None, lr, wd, out, rescale_grad=rescale_grad)


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                   out=None):
    """``mom = momentum * mom - lr * (g + wd * w)``, ``w += mom``."""
    return _one(_opt.SGD(momentum=momentum,
                         clip_gradient=_clip(clip_gradient)),
                weight, grad, mom, lr, wd, out, rescale_grad=rescale_grad)


def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, out=None):
    """``sgd_update`` on the fp32 master ``weight32``, cast into the
    weight."""
    return _one(_opt.SGD(clip_gradient=_clip(clip_gradient)), weight, grad,
                None, lr, wd, out, weight32, rescale_grad)


def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, out=None):
    return _one(_opt.SGD(momentum=momentum,
                         clip_gradient=_clip(clip_gradient)),
                weight, grad, mom, lr, wd, out, weight32, rescale_grad)


def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """Nesterov: ``g' = g + wd * w``, ``mom = momentum * mom + g'``,
    ``w -= lr * (g' + momentum * mom)``."""
    return _one(_opt.NAG(momentum=momentum,
                         clip_gradient=_clip(clip_gradient)),
                weight, grad, mom, lr, wd, out, rescale_grad=rescale_grad)


def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, out=None):
    return _one(_opt.NAG(momentum=momentum,
                         clip_gradient=_clip(clip_gradient)),
                weight, grad, mom, lr, wd, out, weight32, rescale_grad)


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True, out=None):
    """``g' = g + wd * w``, Adam's moments, ``w -= lr * m / (sqrt(v) +
    eps)``: no bias correction (the caller passes the corrected rate)."""
    return _one(_AdamOp(beta1=beta1, beta2=beta2, epsilon=epsilon,
                        clip_gradient=_clip(clip_gradient)),
                weight, grad, (mean, var), lr, wd, out,
                rescale_grad=rescale_grad)


def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0,
                   out=None):
    """``n = (1 - gamma1) g'² + gamma1 n``, ``w -= lr * g' / sqrt(n +
    eps)``, ``g' = g + wd * w``; ``clip_weights > 0`` clips the result."""
    return _one(_opt.RMSProp(gamma1=gamma1, epsilon=epsilon,
                             clip_weights=_clip(clip_weights),
                             clip_gradient=_clip(clip_gradient)),
                weight, grad, (n,), lr, wd, out, rescale_grad=rescale_grad)


def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0, out=None):
    """Graves' centred RMSProp: ``delta = gamma2 * delta - lr * g' /
    sqrt(n - g² + eps)``, ``w += delta``."""
    return _one(_opt.RMSProp(gamma1=gamma1, gamma2=gamma2, epsilon=epsilon,
                             centered=True, clip_weights=_clip(clip_weights),
                             clip_gradient=_clip(clip_gradient)),
                weight, grad, (n, g, delta), lr, wd, out,
                rescale_grad=rescale_grad)


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """FTRL-proximal (``optimizer.Ftrl``'s rule)."""
    return _one(_opt.Ftrl(lamda1=lamda1, beta=beta,
                          clip_gradient=_clip(clip_gradient)),
                weight, grad, (z, n), lr, wd, out, rescale_grad=rescale_grad)


def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0, out=None):
    """FTML at step ``t`` (``optimizer.FTML``'s rule)."""
    return _one(_opt.FTML(beta1=beta1, beta2=beta2, epsilon=epsilon,
                          clip_gradient=_clip(clip_grad)),
                weight, grad, (d, v, z), lr, wd, out,
                rescale_grad=rescale_grad, t=t)


class _SignSGDOp(_opt.Optimizer):
    """``w -= lr * (sign(g) + wd * w)``: the sign of the gradient alone,
    where ``Signum`` without momentum takes the sign of ``g + wd * w``."""

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        step = torch._foreach_sign(grads)
        torch._foreach_add_(step, _opt._wd_terms(weights, wds))
        torch._foreach_mul_(step, list(lrs.unbind(0)))
        torch._foreach_sub_(weights, step)


def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, out=None):
    return _one(_SignSGDOp(clip_gradient=_clip(clip_gradient)), weight,
                grad, None, lr, wd, out, rescale_grad=rescale_grad)


def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, out=None):
    """``mom = momentum * mom - (1 - momentum) * (g + wd * w)``,
    ``w = (1 - lr * wd_lh) * w + lr * sign(mom)`` (``Signum``'s rule)."""
    return _one(_opt.Signum(momentum=momentum, wd_lh=wd_lh,
                            clip_gradient=_clip(clip_gradient)),
                weight, grad, None if momentum == 0.0 else mom, lr, wd, out,
                rescale_grad=rescale_grad)


@torch.no_grad()
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """LAMB's direction ``m̂ / (sqrt(v̂) + eps) + wd * w``, the moments
    advanced in place; phase 2 applies the trust ratio."""
    w = _t(weight).float()
    g = _t(grad).float() * rescale_grad
    if _clip(clip_gradient) is not None:
        g = g.clamp(-clip_gradient, clip_gradient)
    m, v = _t(mean), _t(var)
    m.mul_(beta1).add_(g, alpha=1 - beta1)
    v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
    mh, vh = m, v
    if bias_correction:
        mh, vh = m / (1 - beta1 ** t), v / (1 - beta2 ** t)
    upd = mh / (vh.sqrt() + epsilon) + wd * w
    if out is None:
        return NDArray(upd)
    _t(out).copy_(upd)
    return out


@torch.no_grad()
def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0, out=None):
    """``w -= lr * (r1 / r2) * g``, ``r1 = ||w||`` (clamped to the bounds
    that are > 0) and ``r2 = ||g||``; the ratio is 1 where either is 0."""
    w = _t(weight).float()
    r1v = torch.as_tensor(_t(r1), dtype=torch.float32, device=w.device)
    r2v = torch.as_tensor(_t(r2), dtype=torch.float32, device=w.device)
    if lower_bound is not None and lower_bound > 0:
        r1v = r1v.clamp_min(lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1v = r1v.clamp_max(upper_bound)
    ratio = torch.where((r1v > 0) & (r2v > 0), r1v / r2v,
                        torch.ones_like(r1v))
    target = out if out is not None else weight
    _t(target).copy_(w - lr * ratio * _t(g))
    return target


# the reference's aliases: the fp32 masters are the arrays passed
mp_lamb_update_phase1 = lamb_update_phase1
mp_lamb_update_phase2 = lamb_update_phase2


def multi_sgd_update(weights, grads, lrs, wds, rescale_grad=1.0,
                     clip_gradient=-1.0, out=None):
    """``sgd_update`` of every weight in one call (one multi-tensor
    update); ``lrs``/``wds`` one entry per weight."""
    return _update(_opt.SGD(clip_gradient=_clip(clip_gradient)), weights,
                   grads, [None] * len(weights), lrs, wds, out,
                   rescale_grad=rescale_grad)


def multi_sgd_mom_update(weights, grads, moms, lrs, wds, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0, out=None):
    return _update(_opt.SGD(momentum=momentum,
                            clip_gradient=_clip(clip_gradient)),
                   weights, grads, list(moms), lrs, wds, out,
                   rescale_grad=rescale_grad)


def multi_mp_sgd_update(weights, grads, weights32, lrs, wds, rescale_grad=1.0,
                        clip_gradient=-1.0, out=None):
    return _update(_opt.SGD(clip_gradient=_clip(clip_gradient)), weights,
                   grads, [None] * len(weights), lrs, wds, out,
                   list(weights32), rescale_grad)


def multi_mp_sgd_mom_update(weights, grads, moms, weights32, lrs, wds,
                            momentum=0.0, rescale_grad=1.0,
                            clip_gradient=-1.0, out=None):
    return _update(_opt.SGD(momentum=momentum,
                            clip_gradient=_clip(clip_gradient)),
                   weights, grads, list(moms), lrs, wds, out,
                   list(weights32), rescale_grad)


# the preloaded forms take lrs/wds as device arrays; the multi forms above
# already keep them on the device
def preloaded_multi_sgd_update(weights, grads, lrs, wds, **kw):
    return multi_sgd_update(weights, grads, lrs, wds, **kw)


def preloaded_multi_sgd_mom_update(weights, grads, moms, lrs, wds, **kw):
    return multi_sgd_mom_update(weights, grads, moms, lrs, wds, **kw)


def preloaded_multi_mp_sgd_update(weights, grads, weights32, lrs, wds, **kw):
    return multi_mp_sgd_update(weights, grads, weights32, lrs, wds, **kw)


def preloaded_multi_mp_sgd_mom_update(weights, grads, moms, weights32, lrs,
                                      wds, **kw):
    return multi_mp_sgd_mom_update(weights, grads, moms, weights32, lrs,
                                   wds, **kw)


def _first(arrays, num_arrays):
    return arrays[:num_arrays] if num_arrays else arrays


def multi_sum_sq(*arrays, num_arrays=None):
    """The sum of squares of each array, in fp32: one (n,) array."""
    arrs = [_t(a) for a in _first(arrays, num_arrays)]
    with torch.no_grad():
        return NDArray(torch.stack([a.float().square().sum() for a in arrs]))


@torch.no_grad()
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8,
               rescale_grad=1.0, out=None):
    """LARS: ``lr_i *= eta ||w|| / (||g|| rescale + wd ||w|| + eps)`` where
    both norms are > 0."""
    lr = _t(lrs)
    w_n = _t(weights_sum_sq).sqrt()
    g_n = _t(grads_sum_sq).sqrt() * rescale_grad
    ratio = eta * w_n / (g_n + _t(wds) * w_n + eps)
    new = torch.where((w_n > 0) & (g_n > 0), lr * ratio, lr)
    if out is not None:
        _t(out).copy_(new)
        return out
    return NDArray(new)


def _finite_out(ok, init_output, out):
    ok = ok.float().reshape(1)
    if out is None:
        return NDArray(ok)
    if init_output:
        _t(out).copy_(ok)
    else:
        _t(out).mul_(ok)
    return out


@torch.no_grad()
def all_finite(data, init_output=True, out=None):
    """[1.0] when every element is finite, else [0.0] (AMP's overflow
    check); with ``init_output=False`` it multiplies into ``out``."""
    return _finite_out(torch.isfinite(_t(data)).all(), init_output, out)


@torch.no_grad()
def multi_all_finite(*arrays, num_arrays=None, init_output=True, out=None):
    oks = [torch.isfinite(_t(a)).all() for a in _first(arrays, num_arrays)]
    return _finite_out(torch.stack(oks).all(), init_output, out)


@torch.no_grad()
def reset_arrays(*arrays, num_arrays=None):
    """Zero every array in place."""
    for a in _first(arrays, num_arrays):
        _t(a).zero_()
