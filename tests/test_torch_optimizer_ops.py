"""MXNet's optimizer update operators (``nd.*_update``, ``multi_*``,
``preloaded_*``, the LAMB phases, ``multi_sum_sq``, ``multi_lars``,
``all_finite``, ``reset_arrays``) against the JAX package's, on the CPU.

Each operator takes three steps from the same numpy weight, gradients and
states (float32, from a seed) in both packages; the weights and every
state agree within 1e-6 of their largest entry (the mp_* operators' fp16
weights within one fp16 rounding). The port writes in place: each state
keeps its tensor, ``out`` receives the new weight and the weight is left
as it was. Where an operator's formula is an optimizer's, its step equals
``Optimizer.update_all`` of that optimizer on the same state bit for bit.
"""
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import nd as jnd

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch import optimizer as topt

SHAPE = (3, 5)

#: name -> (number of state arrays, keyword arguments, mp: a fp32 master)
OPS = {
    "sgd_update": (0, dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                           clip_gradient=0.8), False),
    "sgd_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01), False),
    "mp_sgd_update": (0, dict(lr=0.1, wd=0.01), True),
    "mp_sgd_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01), True),
    "nag_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01,
                               clip_gradient=1.0), False),
    "mp_nag_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01), True),
    "adam_update": (2, dict(lr=0.01, wd=0.01, rescale_grad=2.0), False),
    "rmsprop_update": (1, dict(lr=0.01, gamma1=0.9, wd=0.01,
                               clip_weights=0.9), False),
    "rmspropalex_update": (3, dict(lr=0.01, gamma1=0.9, gamma2=0.8),
                           False),
    "ftrl_update": (2, dict(lr=0.1, lamda1=0.01, beta=1.0, wd=0.01), False),
    "ftml_update": (3, dict(lr=0.1, t=2, wd=0.01), False),
    "signsgd_update": (0, dict(lr=0.1, wd=0.01), False),
    "signum_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01, wd_lh=0.01),
                      False),
}


def _close(got, want, tol=1e-6, what=""):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    assert got.shape == want.shape, what
    scale = max(float(onp.abs(want).max()), 1e-30)
    err = float(onp.abs(got - want).max()) / scale
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


def _data(rng, n_states, mp):
    w = rng.randn(*SHAPE).astype("float32")
    grads = [rng.randn(*SHAPE).astype("float32") for _ in range(3)]
    states = [onp.abs(rng.randn(*SHAPE)).astype("float32") * 0.1
              for _ in range(n_states)]
    if n_states == 3:      # centred RMSProp's mean gradient: n - g² > 0
        states[1] = states[1] * 0.1
    return w, grads, states


def _run(pkg, name, w, grads, states, kw, mp):
    """Three steps of ``name``; returns (weight, states, the arrays)."""
    nd = jnd if pkg == "jax" else tnd
    arr = (lambda a, dt="float32": jnd.array(a, dtype=dt)) if pkg == "jax" \
        else (lambda a, dt="float32": tnd.array(a, ctx=mxt.cpu(), dtype=dt))
    wdt = "float16" if mp else "float32"
    weight = arr(w, wdt)
    st = [arr(s) for s in states]
    if mp:
        st.append(arr(w))
    for g in grads:
        getattr(nd, name)(weight, arr(g, wdt), *st, **kw)
    return weight.asnumpy(), [s.asnumpy() for s in st], (weight, st)


@pytest.mark.parametrize("name", sorted(OPS))
def test_update_op_three_steps(name):
    n_states, kw, mp = OPS[name]
    w, grads, states = _data(onp.random.RandomState(len(name)), n_states, mp)
    jw, js, _ = _run("jax", name, w, grads, states, kw, mp)
    tw, ts, (weight, st) = _run("port", name, w, grads, states, kw, mp)
    _close(tw, jw, 1e-3 if mp else 1e-6, name + " weight")
    for i, (a, b) in enumerate(zip(ts, js)):
        _close(a, b, 1e-6, "%s state %d" % (name, i))


@pytest.mark.parametrize("name", ["sgd_mom_update", "adam_update",
                                  "ftrl_update"])
def test_update_op_writes_in_place_and_into_out(name):
    n_states, kw, mp = OPS[name]
    w, grads, states = _data(onp.random.RandomState(3), n_states, mp)
    arr = lambda a: tnd.array(a, ctx=mxt.cpu())  # noqa: E731
    weight, out = arr(w), arr(onp.zeros(SHAPE, "float32"))
    st = [arr(s) for s in states]
    ptrs = [s._data.data_ptr() for s in st] + [out._data.data_ptr()]
    res = getattr(tnd, name)(weight, arr(grads[0]), *st, out=out, **kw)
    assert res is out
    assert [s._data.data_ptr() for s in st] + [out._data.data_ptr()] == ptrs
    onp.testing.assert_array_equal(weight.asnumpy(), w)
    ref = arr(w)
    getattr(tnd, name)(ref, arr(grads[0]), *[arr(s) for s in states], **kw)
    onp.testing.assert_array_equal(out.asnumpy(), ref.asnumpy())


#: op -> (optimizer, its keyword arguments, the op's keyword arguments,
#: the optimizer's state from the op's states)
SHARED = {
    "sgd_mom_update": ("sgd", dict(momentum=0.9, clip_gradient=0.5),
                       dict(momentum=0.9, clip_gradient=0.5), lambda s: s[0]),
    "nag_mom_update": ("nag", dict(momentum=0.9), dict(momentum=0.9),
                       lambda s: s[0]),
    "rmsprop_update": ("rmsprop", dict(gamma1=0.9), dict(gamma1=0.9),
                       tuple),
    "rmspropalex_update": ("rmsprop", dict(gamma1=0.9, gamma2=0.8,
                                           centered=True),
                           dict(gamma1=0.9, gamma2=0.8), tuple),
    "ftrl_update": ("ftrl", dict(lamda1=0.01), dict(lamda1=0.01), tuple),
    "ftml_update": ("ftml", dict(), dict(t=3), tuple),
    "signum_update": ("signum", dict(momentum=0.9, wd_lh=0.01),
                      dict(momentum=0.9, wd_lh=0.01), lambda s: s[0]),
    "adam_update": ("adam", dict(), dict(), tuple),
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_update_op_equals_update_all_bit_for_bit(name):
    opt_name, okw, kw, state_of = SHARED[name]
    n_states = OPS[name][0]
    w, grads, states = _data(onp.random.RandomState(9), n_states, False)
    lr, wd, rescale, t = 0.05, 0.01, 0.5, 3
    opt = topt.create(opt_name, learning_rate=lr, wd=wd, **okw)
    w_opt = torch.tensor(w)
    st_opt = [torch.tensor(s) for s in states]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    lrs = f32([lr])
    step_lr = lr
    if name == "adam_update":      # the op takes the corrected rate
        lr_t = lrs * torch.sqrt(1 - opt.beta2 ** f32(t)) \
            / (1 - opt.beta1 ** f32(t))
        step_lr = lr_t
    weight = tnd.array(w, ctx=mxt.cpu())
    st_op = [tnd.array(s, ctx=mxt.cpu()) for s in states]
    for g in grads:
        # FTML's operator takes its step t on the host
        opt.update_all([w_opt], [torch.tensor(g)], [state_of(st_opt)], lrs,
                       f32([wd]), t if name == "ftml_update" else f32(t),
                       f32(rescale))
        getattr(tnd, name)(weight, tnd.array(g, ctx=mxt.cpu()), *st_op,
                           lr=step_lr, wd=wd, rescale_grad=rescale, **kw)
    assert torch.equal(weight._data, w_opt), name
    for a, b in zip(st_op, st_opt):
        assert torch.equal(a._data, b), name


def _lists(rng, n=3):
    ws = [rng.randn(2 + i, 3).astype("float32") for i in range(n)]
    gs = [rng.randn(*w.shape).astype("float32") for w in ws]
    ms = [rng.randn(*w.shape).astype("float32") * 0.1 for w in ws]
    return ws, gs, ms


@pytest.mark.parametrize("name", ["multi_sgd_update", "multi_sgd_mom_update",
                                  "multi_mp_sgd_update",
                                  "multi_mp_sgd_mom_update",
                                  "preloaded_multi_sgd_update",
                                  "preloaded_multi_sgd_mom_update",
                                  "preloaded_multi_mp_sgd_update",
                                  "preloaded_multi_mp_sgd_mom_update"])
def test_multi_update_ops(name):
    ws, gs, ms = _lists(onp.random.RandomState(len(name)))
    mom, mp = "mom" in name, "_mp_" in name
    lrs, wds = [0.1, 0.05, 0.2], [0.0, 0.01, 0.02]
    results = []
    for pkg in ("jax", "port"):
        nd = jnd if pkg == "jax" else tnd
        ctx = {} if pkg == "jax" else dict(ctx=mxt.cpu())
        dt = "float16" if mp else "float32"
        weights = [nd.array(w, dtype=dt, **ctx) for w in ws]
        args = [weights, [nd.array(g, dtype=dt, **ctx) for g in gs]]
        moms = [nd.array(m, **ctx) for m in ms]
        masters = [nd.array(w, **ctx) for w in ws]
        if mom:
            args.append(moms)
        if mp:
            args.append(masters)
        if name.startswith("preloaded"):
            args += [nd.array(lrs, **ctx), nd.array(wds, **ctx)]
        else:
            args += [lrs, wds]
        kw = dict(momentum=0.9) if mom else {}
        for _ in range(2):
            getattr(nd, name)(*args, rescale_grad=0.5, **kw)
        results.append([a.asnumpy() for a in weights + moms + masters])
    for a, b in zip(results[1], results[0]):
        _close(a, b, 1e-3 if mp else 1e-6, name)


def test_lamb_phases():
    rng = onp.random.RandomState(2)
    w, g = rng.randn(4, 3).astype("float32"), rng.randn(4, 3).astype(
        "float32")
    out = []
    for pkg in ("jax", "port"):
        nd = jnd if pkg == "jax" else tnd
        ctx = {} if pkg == "jax" else dict(ctx=mxt.cpu())
        weight = nd.array(w, **ctx)
        mean, var = nd.zeros((4, 3), **ctx), nd.zeros((4, 3), **ctx)
        for t in (1, 2):
            d = nd.lamb_update_phase1(weight, nd.array(g, **ctx), mean, var,
                                      t=t, wd=0.01, rescale_grad=0.5)
            r1 = nd.array([float(onp.linalg.norm(weight.asnumpy()))], **ctx)
            r2 = nd.array([float(onp.linalg.norm(d.asnumpy()))], **ctx)
            nd.mp_lamb_update_phase2(weight, d, r1, r2, lr=0.01,
                                     lower_bound=0.1, upper_bound=10.0)
        out.append([weight.asnumpy(), mean.asnumpy(), var.asnumpy(),
                    d.asnumpy()])
    for a, b in zip(out[1], out[0]):
        _close(a, b, 1e-6, "lamb")


def test_sum_sq_lars_finite_and_reset():
    rng = onp.random.RandomState(8)
    arrays = [rng.randn(3, 4).astype("float32"),
              rng.randn(5).astype("float32")]
    got = {}
    for pkg in ("jax", "port"):
        nd = jnd if pkg == "jax" else tnd
        ctx = {} if pkg == "jax" else dict(ctx=mxt.cpu())
        xs = [nd.array(a, **ctx) for a in arrays]
        ssq = nd.multi_sum_sq(*xs, num_arrays=2)
        lrs = nd.multi_lars(nd.array([0.1, 0.2], **ctx), ssq,
                            nd.array([4.0, 0.0], **ctx),
                            nd.array([0.01, 0.02], **ctx), eta=0.5,
                            rescale_grad=2.0)
        bad = nd.array([1.0, float("inf")], **ctx)
        flags = [nd.all_finite(xs[0]).asnumpy(),
                 nd.all_finite(bad).asnumpy(),
                 nd.multi_all_finite(xs[0], xs[1], num_arrays=2).asnumpy(),
                 nd.multi_all_finite(xs[0], bad, num_arrays=2).asnumpy()]
        nd.reset_arrays(*xs, num_arrays=2)
        got[pkg] = [ssq.asnumpy(), lrs.asnumpy()] + flags + \
            [x.asnumpy() for x in xs]
    for a, b in zip(got["port"], got["jax"]):
        _close(a, b, 1e-6, "multi ops")
    out = tnd.array([1.0], ctx=mxt.cpu())
    ptr = out._data.data_ptr()
    tnd.all_finite(tnd.array([float("nan")], ctx=mxt.cpu()), out=out,
                   init_output=False)
    assert out.asnumpy().tolist() == [0.0] and out._data.data_ptr() == ptr
