"""The port's TrainStep and its shared multi-tensor update against the JAX
package, on the CPU.

Small models, float32 unless stated: an MLP (8 -> 16 -> 4) and a
ResNet v1 of two basic blocks (channels 8, 8, 16, 3x3 stem, 10 classes) on
(8, 3, 16, 16), the JAX model's weights carried into the port. The JAX
side's TrainStep is the reference: losses within 1e-5 relative of the
largest, parameters and running statistics within 1e-5 of their largest
value (the same float32 arithmetic, summed in another order; the ResNet's
BatchNorm divides by the batch's standard deviation, which the two
libraries round differently: about 1e-6 after three steps). The update
function alone is held to the JAX step's update arithmetic within 1e-6
relative. Port against port (remat or not, captured or not), results are
equal bit for bit.

The captured path (one CUDA graph per signature) needs the card: here a
CPU stand-in for ``jit._GraphCapture`` runs the captured body and undoes
it (a capture runs nothing), and a replay runs it again, so the step
count, the scalar vector, the signature LRU, the rebinding check and the
launch accounting are exercised on the CPU. ``chip_smoke.py`` holds the
real graphs against the eager body on the card.
"""
import threading

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import jit as jjit
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import jit as tjit
from incubator_mxnet_tpu_torch import optimizer as topt
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_tpu_torch.ops import _kernels

REL = 1e-5


def _rel(got, ref, rel=REL, what=""):
    scale = max(float(onp.abs(ref).max()), 1e-30)
    err = float(onp.abs(onp.asarray(got) - onp.asarray(ref)).max()) / scale
    assert err <= rel, "%s: %.3g of the largest value" % (what, err)


def _jax_arrays(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _mlp(pkg, dropout=0.0):
    nn = (jgluon if pkg == "jax" else mxt.gluon).nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8))
    if dropout:
        net.add(nn.Dropout(dropout))
    net.add(nn.Dense(4, in_units=16))
    return net


def _resnet(pkg):
    v = jvision if pkg == "jax" else tvision
    return v.ResNetV1(v.BasicBlockV1, [1, 1], [8, 8, 16], classes=10,
                      thumbnail=True)


def _pair(kind, x):
    """(JAX net, port net) with the JAX net's weights in both."""
    jnet, tnet = (_mlp("jax"), _mlp("torch")) if kind == "mlp" else \
        (_resnet("jax"), _resnet("torch"))
    mx.random.seed(0)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(x))
    tnet.initialize(mxt.init.Zero(), ctx=mxt.cpu())
    tnet(torch.from_numpy(x))
    mxt.from_jax_params(tnet, _jax_arrays(jnet), strict=True)
    return jnet, tnet


def _batch(kind, n=8, seed=0):
    rng = onp.random.RandomState(seed)
    shape = (n, 8) if kind == "mlp" else (n, 3, 16, 16)
    classes = 4 if kind == "mlp" else 10
    return (rng.randn(*shape).astype("float32"),
            rng.randint(0, classes, n).astype("float32"))


def _port_net(kind, x, seed=0, dropout=0.0):
    net = _mlp("torch", dropout) if kind == "mlp" else _resnet("torch")
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    with mxt.autograd.pause():
        net(torch.from_numpy(x))
    return net


def _steps(kind, x, y, opt, opt_params, n=3, jax_kw=None, port_kw=None,
           between=None, batch_sizes=None, mults=None):
    """Run ``n`` TrainSteps of both packages from the same weights; returns
    (JAX losses, port losses, JAX arrays, port arrays). ``between(i,
    jtrainer, ttrainer)`` runs before step i; ``mults`` ({param name:
    (lr_mult, wd_mult)}) is set on both nets' parameters."""
    jnet, tnet = _pair(kind, x)
    for net in (jnet, tnet):
        for name, (lm, wm) in (mults or {}).items():
            p = net._collect_params_with_prefix()[name]
            p.lr_mult, p.wd_mult = lm, wm
    loss = "SoftmaxCrossEntropyLoss"
    jtr = jgluon.Trainer(jnet.collect_params(), opt, dict(opt_params))
    ttr = mxt.gluon.Trainer(tnet.collect_params(), opt, dict(opt_params))
    jstep = jjit.TrainStep(jnet, getattr(jgluon.loss, loss)(), jtr,
                           **(jax_kw or {}))
    tstep = tjit.TrainStep(tnet, getattr(mxt.gluon.loss, loss)(), ttr,
                           **(port_kw or {}))
    jl, tl = [], []
    for i in range(n):
        if between is not None:
            between(i, jtr, ttr)
        bs = None if batch_sizes is None else batch_sizes[i]
        jl.append(jstep(mx.nd.array(x), mx.nd.array(y),
                        batch_size=bs).asnumpy())
        tl.append(tstep(x, y, batch_size=bs).asnumpy())
    return jl, tl, _jax_arrays(jnet), mxt.to_numpy_params(tnet)


def _hold(jl, tl, ja, ta, rel=REL):
    for i, (a, b) in enumerate(zip(tl, jl)):
        _rel(a, b, rel, "loss of step %d" % i)
    assert set(ja) == set(ta)
    for k in ja:
        _rel(ta[k], ja[k], rel, k)


@pytest.fixture(scope="module")
def resnet_batch():
    return _batch("resnet")


@pytest.mark.parametrize("remat", [False, True])
def test_small_resnet_sgd_momentum_matches_jax(resnet_batch, remat):
    """Three SGD-momentum steps of the small ResNet, weights and running
    statistics held to the JAX TrainStep's; with ``remat`` on both sides
    (``jax.checkpoint`` / ``torch.utils.checkpoint``) the running
    statistics still move once a step."""
    x, y = resnet_batch
    jl, tl, ja, ta = _steps("resnet", x, y, "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9},
                            jax_kw=dict(remat=remat),
                            port_kw=dict(remat=remat))
    _hold(jl, tl, ja, ta)
    assert any("running_mean" in k for k in ta)
    assert tl[-1].mean() < tl[0].mean()


def _port_run(kind, x, y, n=3, dropout=0.0, seed=0, **kw):
    net = _port_net(kind, x, dropout=dropout)
    torch.manual_seed(seed)
    step = tjit.TrainStep(net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                          mxt.gluon.Trainer(net.collect_params(), "sgd", {
                              "learning_rate": 0.05, "momentum": 0.9}), **kw)
    losses = [step(x, y).asnumpy() for _ in range(n)]
    return losses, mxt.to_numpy_params(net)


@pytest.mark.parametrize("kind,dropout", [("resnet", 0.0), ("mlp", 0.3)])
def test_remat_equals_no_remat_exactly(resnet_batch, kind, dropout):
    """remat recomputes the forward in the backward with the forward's
    dropout masks and one running-statistics update: the same losses and
    weights, bit for bit."""
    x, y = resnet_batch if kind == "resnet" else _batch("mlp")
    a = _port_run(kind, x, y, dropout=dropout, remat=True)
    b = _port_run(kind, x, y, dropout=dropout, remat=False)
    for la, lb in zip(a[0], b[0]):
        assert onp.array_equal(la, lb)
    for k in a[1]:
        assert onp.array_equal(a[1][k], b[1][k]), k
    if dropout:
        c = _port_run(kind, x, y, dropout=dropout, seed=1, remat=True)
        assert not onp.array_equal(a[0][0], c[0][0])   # masks are drawn


def _jax_clip(max_norm):
    def clip(grads):
        norm = jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                            for g in grads))
        s = jnp.minimum(1.0, max_norm / (norm + 1e-6))
        return [g * s.astype(g.dtype) for g in grads]
    return clip


def _port_clip(max_norm):
    def clip(grads):
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        s = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        return [g * s.to(g.dtype) for g in grads]
    return clip


def test_grad_postprocess_global_norm_clip_matches_jax():
    x, y = _batch("mlp")
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jl, tl, ja, ta = _steps("mlp", x, y, "sgd", opt,
                            jax_kw=dict(grad_postprocess=_jax_clip(0.05)),
                            port_kw=dict(grad_postprocess=_port_clip(0.05)))
    _hold(jl, tl, ja, ta)
    _, _, _, plain = _steps("mlp", x, y, "sgd", opt)
    assert not all(onp.allclose(plain[k], ta[k]) for k in ta)


def test_set_learning_rate_between_steps_matches_jax():
    def between(i, jtr, ttr):
        if i == 2:
            jtr.set_learning_rate(0.02)
            ttr.set_learning_rate(0.02)
    x, y = _batch("mlp")
    _hold(*_steps("mlp", x, y, "adam", {"learning_rate": 0.005}, n=4,
                  between=between))


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
def test_lr_wd_mult_clip_and_batch_size_match_jax(opt):
    """Per-parameter lr_mult/wd_mult, weight decay, clip_gradient and a
    batch_size that changes between steps (the rescale is a runtime value
    in both packages)."""
    x, y = _batch("mlp")
    params = {"learning_rate": 0.02, "wd": 0.1, "clip_gradient": 0.05}
    if opt == "sgd":
        params["momentum"] = 0.9
    _hold(*_steps("mlp", x, y, opt, params, n=3, batch_sizes=[8, 4, 16],
                  mults={"0.weight": (0.5, 2.0), "1.bias": (3.0, 0.0)}))


def test_remat_env_default_and_explicit_argument(monkeypatch):
    net = mxt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mxt.cpu())
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd")
    loss = mxt.gluon.loss.L2Loss()
    monkeypatch.setenv("MXTPU_REMAT", "1")
    assert tjit.TrainStep(net, loss, trainer).remat is True
    monkeypatch.delenv("MXTPU_REMAT")
    assert tjit.TrainStep(net, loss, trainer).remat is False
    monkeypatch.setenv("MXTPU_REMAT", "1")
    assert tjit.TrainStep(net, loss, trainer, remat=False).remat is False
    assert mxt.config.get_env("MXTPU_AOT_CACHE_SIZE") == 64


def _donate_run(monkeypatch, no_donate):
    """Two Adam steps of the MLP; around the second, whether a view of a
    weight's and of a state's storage taken before it kept its values.
    Returns (kept, loss, params)."""
    x, y = _batch("mlp")
    net = _port_net("mlp", x)
    trainer = mxt.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.01})
    step = tjit.TrainStep(net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                          trainer)
    step(x, y)
    if no_donate:
        monkeypatch.setenv("MXTPU_NO_DONATE", "1")
    else:
        monkeypatch.delenv("MXTPU_NO_DONATE", raising=False)
    w = net[0].weight._tensor()
    taken = [w.detach(), trainer._states[0][0].detach()]
    before = [t.clone() for t in taken]
    loss = step(x, y).asnumpy()
    assert not torch.equal(w.detach(), before[0])
    kept = all(torch.equal(t, b) for t, b in zip(taken, before))
    return kept, loss, mxt.to_numpy_params(net)


def test_no_donate_keeps_pre_step_tensors(monkeypatch):
    """With MXTPU_NO_DONATE a tensor taken before the step keeps its values
    (the update wrote new tensors and rebound the parameter and its
    state), and the step's results equal the in-place step's bit for bit;
    without it the update is in place."""
    kept, loss, params = _donate_run(monkeypatch, no_donate=True)
    kept_in_place, ref_loss, ref_params = _donate_run(monkeypatch, False)
    assert kept and not kept_in_place
    assert onp.array_equal(loss, ref_loss)
    for k in params:
        assert onp.array_equal(params[k], ref_params[k]), k


# ------------------------------------------------- the update function

def _jax_step_update(opt, weights, grads, states, lrs, wds, t, rescale):
    """The update loop of the JAX TrainStep's program
    (``incubator_mxnet_tpu/jit.py:236-257``): traced lrs, wds, int32 t
    and rescale, the optimizer's ``update_rule`` on the fp32 master or
    weight, the cast back."""
    masters = [opt.multi_precision and w.dtype == jnp.bfloat16
               for w in weights]

    def fn(ws, gs, sts, lrs, wds, t, rescale):
        new_w, new_s = [], []
        for i, (w, g, s) in enumerate(zip(ws, gs, sts)):
            g = g * rescale
            if opt.clip_gradient is not None:
                g = jnp.clip(g, -opt.clip_gradient, opt.clip_gradient)
            gf = g.astype(jnp.float32)
            if masters[i]:
                master, inner = s
                nw, ns = opt.update_rule(master, gf, jjit._tree_wrap(inner),
                                         lrs[i], wds[i], t)
                new_s.append((nw, jjit._tree_to_data(ns)))
            else:
                nw, ns = opt.update_rule(w.astype(jnp.float32), gf,
                                         jjit._tree_wrap(s), lrs[i], wds[i], t)
                new_s.append(jjit._tree_to_data(ns))
            new_w.append(nw.astype(w.dtype))
        return new_w, new_s
    return jax.jit(fn)(weights, grads, states, jnp.asarray(lrs, jnp.float32),
                       jnp.asarray(wds, jnp.float32),
                       jnp.asarray(t, jnp.int32),
                       jnp.asarray(rescale, jnp.float32))


UPDATE_CASES = {
    "sgd": dict(learning_rate=0.1, momentum=0.9, clip_gradient=2.0),
    "adam": dict(learning_rate=0.01),
    "adamw": dict(learning_rate=0.01, clip_gradient=2.0),
}


@pytest.mark.parametrize("name", sorted(UPDATE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_all_matches_the_jax_step_arithmetic(name, dtype):
    """Three weights of different shapes, lr and wd, four steps with a
    changing rescale: ``Optimizer.update_all`` against the JAX step's
    update; fp32 weights (and bf16 weights' fp32 masters) within 1e-6
    relative, a bf16 weight equal to its master cast."""
    kw = dict(UPDATE_CASES[name], wd=0.01,
              multi_precision=dtype == "bfloat16")
    shapes = [(5, 7), (7,), (3, 2, 4)]
    rng = onp.random.RandomState(len(name))
    w0 = [rng.randn(*s).astype("float32") for s in shapes]
    lrs = [kw["learning_rate"] * m for m in (1.0, 0.5, 2.0)]
    wds = [0.01 * m for m in (1.0, 0.0, 3.0)]
    jopt = mx.optimizer.create(name, **kw)
    topt_ = topt.create(name, **kw)
    jw = [jnp.asarray(w).astype(dtype) for w in w0]
    tw = [torch.from_numpy(w.copy()).to(getattr(torch, dtype)) for w in w0]
    js = [jjit._tree_to_data(jopt.create_state_multi_precision(
        i, mx.nd.array(w).astype(dtype))) for i, w in enumerate(w0)]
    ts = [topt_.create_state_multi_precision(i, w) for i, w in enumerate(tw)]
    for t in range(1, 5):
        grads = [rng.randn(*s).astype("float32") * 3 for s in shapes]
        rescale = 1.0 / (4 * t)
        jw, js = _jax_step_update(jopt, jw, [jnp.asarray(g).astype(dtype)
                                             for g in grads], js, lrs, wds,
                                  t, rescale)
        vec = torch.tensor(lrs + wds + [float(t)] * 3 + [rescale])
        topt_.update_all(tw, [torch.from_numpy(g).to(getattr(torch, dtype))
                              for g in grads], ts,
                         *topt_.split_scalars(vec))
    for i in range(len(shapes)):
        got, ref = tw[i].float().numpy(), onp.asarray(
            jw[i].astype(jnp.float32))
        assert not onp.allclose(got, w0[i])
        if dtype == "float32":
            onp.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        else:
            master, ref_master = ts[i][0].numpy(), onp.asarray(js[i][0])
            onp.testing.assert_allclose(master, ref_master, rtol=1e-6,
                                        atol=1e-7)
            assert torch.equal(tw[i], ts[i][0].bfloat16())


def test_step_scalars_advance_counts_and_lay_out_the_vector():
    p = [mxt.gluon.Parameter("w%d" % i, shape=(2,), lr_mult=m, wd_mult=2.0)
         for i, m in enumerate((1.0, 0.5))]
    opt = topt.create("adam", learning_rate=0.1, wd=0.01, rescale_grad=0.25,
                      param_dict=dict(enumerate(p)))
    vec = opt.step_scalars([0, 1])
    lrs, wds, t, rescale = opt.split_scalars(vec)
    assert vec.dtype == torch.float32 and vec.shape == (7,)
    onp.testing.assert_allclose(lrs.numpy(), [0.1, 0.05], rtol=1e-7)
    onp.testing.assert_allclose(wds.numpy(), [0.02, 0.02], rtol=1e-7)
    assert t.tolist() == [1.0, 1.0] and float(rescale) == 0.25
    assert opt.step_scalars([0], t=7)[2] == 7.0
    assert opt._index_update_count == {0: 2, 1: 1}


# ------------------------------------------ the captured path on the CPU

class _CpuGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        """Run the body again; its launches are the capture's, which the
        step adds itself."""
        with _kernels.collecting():
            out = self.fn()
        self.out.copy_(out)


def _cpu_capture(step, fail=None):
    """A stand-in for ``jit._GraphCapture`` bound to ``step``; with
    ``fail`` (a list), the capture sets ``fail[0]`` while the body runs
    and, when the body raises, fails again on its way out, as torch's
    capture does."""
    class Capture:
        def __init__(self, device):
            pass

        def eager(self, fn):
            return fn()

        def capture(self, fn):
            """Run ``fn`` and undo what it wrote: a capture runs
            nothing."""
            saved = [t.detach().clone() for t in step._bound()]
            rng = torch.get_rng_state()
            if fail is not None:
                fail[0] = True
                try:
                    fn()
                except RuntimeError:
                    raise RuntimeError("capture invalidated")
            out = fn()
            with torch.no_grad():
                for t, s in zip(step._bound(), saved):
                    t.copy_(s)
            torch.set_rng_state(rng)
            return _CpuGraph(fn, out), out

        @staticmethod
        def upload(dst, host):
            dst.copy_(host)
    return Capture


def _captured(step, x, y, batch_size=None):
    args = step._prepare((x, y), 1)
    return step._replay(args, 1, batch_size or args[0].shape[0])


def _counting_loss():
    base = mxt.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss(out, label):
        _kernels.count("probe_kernel")     # one "launch" a step
        return base(out, label)
    return loss


def test_captured_path_equals_eager_and_counts_replays(monkeypatch):
    """Captured (the CPU stand-in) against eager, same weights: the same
    losses and weights bit for bit over five steps with a learning-rate
    change and a batch_size change; one capture for the signature; the
    counted launches equal the steps, the capture's own taken out."""
    x, y = _batch("mlp")
    runs = []
    for captured in (True, False):
        net = _port_net("mlp", x)
        trainer = mxt.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.01})
        step = tjit.TrainStep(net, _counting_loss(), trainer)
        monkeypatch.setattr(tjit, "_GraphCapture", _cpu_capture(step))
        _kernels.reset_launches()
        losses = []
        for i in range(5):
            if i == 3:
                trainer.set_learning_rate(0.05)
            bs = 4 if i == 4 else None
            losses.append(_captured(step, x, y, bs).numpy() if captured
                          else step(x, y, batch_size=bs).asnumpy())
        runs.append((losses, mxt.to_numpy_params(net), step))
        assert _kernels.LAUNCHES["probe_kernel"] == 5
    (la, pa, sa), (lb, pb, _) = runs
    assert sa.captures == 1 and sa._step_count == 5
    for a, b in zip(la, lb):
        assert onp.array_equal(a, b)
    for k in pa:
        assert onp.array_equal(pa[k], pb[k]), k


def test_signature_rebinding_and_lru(monkeypatch):
    """A new input shape captures anew; ``set_data`` writes in place (the
    same graph); ``cast`` or replaced optimizer states rebind tensors and
    capture again; past MXTPU_AOT_CACHE_SIZE the least recently used
    signature is released."""
    x, y = _batch("mlp")
    net = _port_net("mlp", x)
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.01, "momentum": 0.9})
    step = tjit.TrainStep(net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                          trainer)
    monkeypatch.setattr(tjit, "_GraphCapture", _cpu_capture(step))
    monkeypatch.setenv("MXTPU_AOT_CACHE_SIZE", "2")
    _captured(step, x, y)
    _captured(step, x, y)
    assert step.captures == 1
    _captured(step, x[:4], y[:4])
    assert step.captures == 2 and len(step._graphs) == 2
    w = net[0].weight
    w.set_data(onp.zeros(w.shape, "float32"))
    _captured(step, x, y)
    assert step.captures == 2
    trainer._states = [None if s is None else s.clone()
                       for s in trainer._states]
    _captured(step, x, y)
    assert step.captures == 3
    net.cast("float64")
    net.cast("float32")         # the same dtype, new storage
    _captured(step, x, y)
    assert step.captures == 4 and len(step._graphs) == 2
    _captured(step, x[:2], y[:2])
    assert step.captures == 5 and len(step._graphs) == 2
    sigs = [s[0][0][0] for s in step._graphs]
    assert sigs == [(8, 8), (2, 8)]


def test_a_failed_capture_raises_naming_the_operation(monkeypatch):
    """A body that cannot be captured (here a loss that reads a value back
    to the host, which a capture refuses) makes the step raise, naming
    the loss's line; nothing falls back to eager."""
    x, y = _batch("mlp")
    net = _port_net("mlp", x)
    capturing = [False]
    base = mxt.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss(out, label):
        if capturing[0]:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return base(out, label)
    step = tjit.TrainStep(net, loss, mxt.gluon.Trainer(
        net.collect_params(), "sgd", {"learning_rate": 0.1}))
    monkeypatch.setattr(tjit, "_GraphCapture", _cpu_capture(step,
                                                            capturing))
    with pytest.raises(RuntimeError) as info:
        _captured(step, x, y)
    msg = str(info.value)
    assert "capturing the step into a CUDA graph failed" in msg
    assert "test_torch_jit.py" in msg and "in loss" in msg
    assert "not permitted when stream is capturing" in msg
    assert step.captures == 0 and not step._graphs


def test_take_and_add_launches():
    """A capture's launches are collected on its own thread, apart from
    ``LAUNCHES`` (another thread's launches meanwhile still count there),
    and each replay adds them back."""
    _kernels.reset_launches()
    _kernels.count("a")
    with _kernels.collecting() as taken:
        _kernels.count("a")
        _kernels.count("b")
        other = threading.Thread(target=_kernels.count, args=("a",))
        other.start()
        other.join(10)
    assert taken == {"a": 1, "b": 1}
    assert _kernels.LAUNCHES["a"] == 2 and _kernels.LAUNCHES.get("b", 0) == 0
    _kernels.add_launches(taken)
    _kernels.add_launches(taken)
    assert (_kernels.LAUNCHES["a"], _kernels.LAUNCHES["b"]) == (4, 2)
    _kernels.reset_launches()


@pytest.mark.parametrize("on_captured_stream", [True, False])
def test_capture_collects_launches_of_autograds_thread(monkeypatch,
                                                       on_captured_stream):
    """Inside ``capturing()`` (a capture in progress), a launch another
    thread makes onto the captured stream (autograd's thread running the
    captured backward) goes to the capture's counts; one onto another
    stream (a batcher worker's) still counts in ``LAUNCHES``."""
    _kernels.reset_launches()
    capturing = threading.local()
    monkeypatch.setattr(_kernels, "_stream_capturing",
                        lambda: getattr(capturing, "on", False))

    def backward():
        capturing.on = on_captured_stream
        _kernels.count("bwd")
    with _kernels.collecting() as taken, _kernels.capturing():
        _kernels.count("fwd")
        other = threading.Thread(target=backward)
        other.start()
        other.join(10)
    _kernels.count("bwd")                     # after the capture
    if on_captured_stream:
        assert taken == {"fwd": 1, "bwd": 1}
        assert _kernels.LAUNCHES["bwd"] == 1
    else:
        assert taken == {"fwd": 1} and _kernels.LAUNCHES["bwd"] == 2
    assert _kernels.LAUNCHES.get("fwd", 0) == 0
    _kernels.reset_launches()
