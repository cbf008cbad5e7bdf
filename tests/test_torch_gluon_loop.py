"""The port's training-loop helpers against the JAX package, on the CPU:
learning-rate schedulers, the losses, the metrics, ``clip_global_norm``,
``split_and_load`` and the callbacks.

Schedulers are plain host arithmetic: equal to the JAX package's exactly
over updates 1..1000. Losses: the same numpy-seeded inputs through both
packages' loss blocks, forward and the gradient of the summed loss with
respect to every input within 1e-6 of the largest value (the JAX side's
gradient is its autograd's, ``jax.vjp``). Metrics: within 1e-6 relative
of the JAX package's, whose sums are host floats where the port's device
metrics keep float64 tensors.
"""
import itertools
import logging
import math

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import lr_scheduler as jlr
from incubator_mxnet_tpu import metric as jmetric

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import lr_scheduler as tlr
from incubator_mxnet_tpu_torch import metric as tmetric


def _rel(got, ref, what="", tol=1e-6):
    ref = onp.asarray(ref, dtype="float64")
    scale = max(float(onp.abs(ref).max()), 1e-30)
    err = float(onp.abs(onp.asarray(got, dtype="float64") - ref).max()) \
        / scale
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


# ----------------------------------------------------------- schedulers

def _schedulers(mod, warmup):
    w = dict(warmup_steps=50, warmup_begin_lr=0.001, warmup_mode=warmup)
    return {
        "factor": mod.FactorScheduler(step=100, factor=0.7, base_lr=0.1,
                                      stop_factor_lr=1e-3, **w),
        "multifactor": mod.MultiFactorScheduler(step=[120, 400, 800],
                                                factor=0.5, base_lr=0.1,
                                                **w),
        "poly": mod.PolyScheduler(max_update=900, base_lr=0.1, pwr=2,
                                  final_lr=1e-4, **w),
        "cosine": mod.CosineScheduler(max_update=900, base_lr=0.1,
                                      final_lr=1e-4, **w),
    }


@pytest.mark.parametrize("kind", ["factor", "multifactor", "poly", "cosine"])
@pytest.mark.parametrize("warmup", ["linear", "constant"])
def test_schedulers_equal_the_jax_package(kind, warmup):
    """Every update from 1 to 1000 (past max_update), exactly. With
    "constant" warm-up the rate during the warm-up is warmup_begin_lr, as
    in MXNet (the JAX package squares a ramp there: ROADMAP §3); after it
    they are equal."""
    ref = _schedulers(jlr, warmup)[kind]
    got = _schedulers(tlr, warmup)[kind]
    for n in range(1, 1001):
        a, b = got(n), ref(n)
        if warmup == "constant" and n < 50:
            assert a == 0.001
        else:
            assert a == b, (n, a, b)


def test_base_scheduler_and_bad_warmup_mode():
    got, ref = tlr.LRScheduler(base_lr=0.2, warmup_steps=10), \
        jlr.LRScheduler(base_lr=0.2, warmup_steps=10)
    assert [got.get_warmup_lr(n) for n in range(10)] == \
        [ref.get_warmup_lr(n) for n in range(10)]
    with pytest.raises(NotImplementedError):
        got(3)
    with pytest.raises(ValueError, match="warmup_mode"):
        tlr.LRScheduler(warmup_mode="exponential")


def test_scheduled_rate_reaches_trainer_and_train_step():
    """SGD under a FactorScheduler with linear warm-up: the port's
    Trainer.step and its TrainStep (whose rate reaches the step's device
    vector each step) land on the JAX eager Trainer's weights; the
    optimizer's learning_rate follows the schedule and set_learning_rate
    refuses, as in the JAX package."""
    from test_torch_optimizers import (_data, _jax_run, _port_step_run,
                                       _port_trainer_run, _rel as hold)
    w, grads = _data(seed=4)

    def kw(mod):
        return dict(learning_rate=0.1, lr_scheduler=mod.FactorScheduler(
            step=1, factor=0.5, base_lr=0.1, warmup_steps=2,
            warmup_begin_lr=0.02))
    jparams, jtr = _jax_run("sgd", kw(jlr), w, grads, "float32")
    for run in (_port_trainer_run, _port_step_run):
        tparams, ttr = run("sgd", kw(tlr), w, grads, "float32")
        for jp, tp in zip(jparams, tparams):
            hold(tp._tensor().detach().numpy(), jp.data().asnumpy())
        assert ttr.learning_rate == jtr.learning_rate
        with pytest.raises(UserWarning):
            ttr.set_learning_rate(0.5)


# --------------------------------------------------------------- losses

def _loss_inputs(name, rng):
    """(loss kwargs, input arrays as float32 numpy, names of the inputs
    that take a gradient)."""
    p = rng.randn(6, 5).astype("float32")
    if name == "SigmoidBinaryCrossEntropyLoss":
        return {}, [p, rng.randint(0, 2, (6, 5)).astype("float32")], [0]
    if name == "SigmoidBCE_from_sigmoid":
        return {"from_sigmoid": True}, [
            1 / (1 + onp.exp(-p)), rng.rand(6, 5).astype("float32")], [0]
    if name == "SigmoidBCE_pos_weight":
        return {}, [p, rng.randint(0, 2, (6, 5)).astype("float32"), None,
                    rng.rand(6, 5).astype("float32") + 0.5], [0]
    if name == "KLDivLoss":
        lab = onp.exp(p) / onp.exp(p).sum(-1, keepdims=True)
        return {"from_logits": False}, [rng.randn(6, 5).astype("float32"),
                                        lab.astype("float32")], [0]
    if name == "HuberLoss":
        return {"rho": 0.7}, [p, rng.randn(6, 5).astype("float32")], [0, 1]
    if name in ("HingeLoss", "SquaredHingeLoss", "LogisticLoss"):
        lab = rng.randint(0, 2, (6, 5)).astype("float32") * 2 - 1
        kw = {"margin": 0.8} if name != "LogisticLoss" else {}
        return kw, [p, lab], [0]
    if name == "LogisticLoss_binary":
        return {"label_format": "binary"}, [
            p, rng.randint(0, 2, (6, 5)).astype("float32")], [0]
    if name == "TripletLoss":
        return {"margin": 0.5}, [p, rng.randn(6, 5).astype("float32"),
                                 rng.randn(6, 5).astype("float32")], [0, 1, 2]
    if name == "PoissonNLLLoss":
        return {"compute_full": True}, [
            p * 0.3, rng.poisson(2.0, (6, 5)).astype("float32")], [0]
    if name == "PoissonNLL_rate":
        return {"from_logits": False}, [
            onp.abs(p) + 0.1, rng.poisson(2.0, (6, 5)).astype("float32")],\
            [0]
    if name == "CosineEmbeddingLoss":
        return {"margin": 0.1}, [p, rng.randn(6, 5).astype("float32"),
                                 onp.array([1, -1, 1, 1, -1, -1],
                                           "float32")], [0, 1]
    if name == "SDMLLoss":
        return {"smoothing_parameter": 0.2}, [
            p, p + 0.1 * rng.randn(6, 5).astype("float32")], [0, 1]
    raise KeyError(name)


LOSSES = ["SigmoidBinaryCrossEntropyLoss", "SigmoidBCE_from_sigmoid",
          "SigmoidBCE_pos_weight", "KLDivLoss", "HuberLoss", "HingeLoss",
          "SquaredHingeLoss", "LogisticLoss", "LogisticLoss_binary",
          "TripletLoss", "PoissonNLLLoss", "PoissonNLL_rate", "SDMLLoss"]


def _loss_class(pkg, name):
    base = name.split("_")[0]
    base = {"SigmoidBCE": "SigmoidBinaryCrossEntropyLoss",
            "PoissonNLL": "PoissonNLLLoss"}.get(base, base)
    return getattr(pkg.loss, base)


@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax_forward_and_gradient(name):
    kw, inputs, diff = _loss_inputs(name, onp.random.RandomState(
        len(name)))
    weight = {} if name in ("SDMLLoss",) else {"weight": 0.7}
    jl = _loss_class(jgluon, name)(**kw, **weight)
    tl = _loss_class(mxt.gluon, name)(**kw, **weight)
    jin = [None if a is None else mx.nd.array(a) for a in inputs]
    tin = [None if a is None else mxt.nd.array(a, ctx=mxt.cpu())
           for a in inputs]
    for i in diff:
        jin[i].attach_grad()
        tin[i].attach_grad()
    with mx.autograd.record():
        jout = jl(*jin)
        jsum = jout.sum()
    jsum.backward()
    with mxt.autograd.record():
        tout = tl(*tin)
        tsum = tout.sum()
    tsum.backward()
    assert tout.shape == jout.shape
    _rel(tout.asnumpy(), jout.asnumpy(), name)
    for i in diff:
        _rel(tin[i].grad.asnumpy(), jin[i].grad.asnumpy(),
             "%s d/d input %d" % (name, i))


def test_cosine_embedding_loss_follows_mxnet():
    """``CosineEmbeddingLoss`` against a float64 oracle of MXNet's
    definition (the cosine of input1 and input2), forward and gradients
    within 1e-6. The JAX package takes the cosine of input2 with itself
    (ROADMAP §3): its loss is 0 on every label-1 row."""
    kw, inputs, _ = _loss_inputs("CosineEmbeddingLoss",
                                 onp.random.RandomState(19))
    a, b, lab = inputs
    ta = torch.tensor(a, dtype=torch.float64, requires_grad=True)
    tb = torch.tensor(b, dtype=torch.float64, requires_grad=True)
    cos = (ta * tb).sum(-1) / (ta.norm(dim=-1) * tb.norm(dim=-1) + 1e-12)
    ref = torch.where(torch.from_numpy(lab) == 1, 1 - cos,
                      torch.relu(cos - kw["margin"])) * 0.7
    ref.sum().backward()
    tin = [mxt.nd.array(v, ctx=mxt.cpu()) for v in inputs]
    tin[0].attach_grad()
    tin[1].attach_grad()
    with mxt.autograd.record():
        out = mxt.gluon.loss.CosineEmbeddingLoss(weight=0.7, **kw)(*tin)
    out.backward()
    _rel(out.asnumpy(), ref.detach().numpy(), "loss")
    _rel(tin[0].grad.asnumpy(), ta.grad.numpy(), "d input1")
    _rel(tin[1].grad.asnumpy(), tb.grad.numpy(), "d input2")
    jout = jgluon.loss.CosineEmbeddingLoss(weight=0.7, **kw)(
        *[mx.nd.array(v) for v in inputs]).asnumpy()
    assert onp.allclose(jout[lab == 1], 0, atol=1e-6)


def test_ctc_loss_waits_for_its_op():
    """``ops/ctc.py`` is ported: the loss block equals the JAX package's
    (blank last, -1 padding), within 1e-5 relative."""
    rng = onp.random.RandomState(4)
    pred = rng.randn(2, 7, 5).astype("float32")
    label = onp.array([[1, 2, -1], [3, 3, 1]], "float32")
    want = jgluon.loss.CTCLoss()(mx.nd.array(pred),
                                 mx.nd.array(label)).asnumpy()
    got = mxt.gluon.loss.CTCLoss()(
        mxt.nd.array(pred, ctx=mxt.cpu()),
        mxt.nd.array(label, ctx=mxt.cpu())).asnumpy()
    _rel(got, want, "ctc loss", 1e-5)


# -------------------------------------------------------------- metrics

def _metric_batches(rng):
    """Two batches of (labels, probabilities) of 10 classes."""
    out = []
    for n in (12, 7):
        p = rng.rand(n, 10).astype("float32")
        out.append((rng.randint(0, 10, n).astype("float32"),
                    p / p.sum(-1, keepdims=True)))
    return out


METRICS = {
    "acc": {}, "top_k_accuracy": {"top_k": 3}, "perplexity": {},
    "perplexity_ignore": {"ignore_label": 2}, "ce": {}, "nll_loss": {},
    "mae": {}, "mse": {}, "rmse": {}, "f1": {}, "mcc": {}, "pearsonr": {},
    "loss": {},
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_match_jax(name):
    rng = onp.random.RandomState(len(name))
    batches = _metric_batches(rng)
    create = name.split("_ignore")[0]
    jm = jmetric.create(create, **METRICS[name])
    tm = tmetric.create(create, **METRICS[name])
    for lab, p in batches:
        if name in ("f1", "mcc"):
            lab = (lab > 4).astype("float32")
            p = p[:, :2] / p[:, :2].sum(-1, keepdims=True)
        if name in ("mae", "mse", "rmse", "pearsonr"):
            p = p[:, :1]
        jm.update([mx.nd.array(lab)], [mx.nd.array(p)])
        tm.update([mxt.nd.array(lab, ctx=mxt.cpu())],
                  [torch.from_numpy(p)])
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert jn == tn
    assert math.isclose(tv, jv, rel_tol=1e-6), (tv, jv)
    jg = jm.get_global()[1]
    if create == "perplexity":      # the JAX package skips the exp here
        jg = math.exp(jg)
    if create == "rmse":            # and the square root
        jg = math.sqrt(jg)
    assert math.isclose(tm.get_global()[1], jg, rel_tol=1e-6)
    tm.reset_local()
    assert math.isnan(tm.get()[1])


def test_device_metrics_keep_their_sums_on_the_device(monkeypatch):
    """Accuracy, TopKAccuracy, Perplexity, CrossEntropy, MAE, MSE and Loss
    keep float64 tensor sums and copy nothing to the host in an update."""
    monkeypatch.setattr(tmetric, "_as_np", lambda x: (_ for _ in ()).throw(
        AssertionError("host copy")))
    lab, p = _metric_batches(onp.random.RandomState(0))[0]
    lab_t, p_t = torch.from_numpy(lab), torch.from_numpy(p)
    for m in (tmetric.Accuracy(), tmetric.TopKAccuracy(5),
              tmetric.Perplexity(), tmetric.CrossEntropy(), tmetric.MAE(),
              tmetric.MSE(), tmetric.Loss()):
        m.update([lab_t], [p_t[:, :1] if isinstance(m, tmetric.MAE)
                           else p_t])
        assert isinstance(m.sum_metric, torch.Tensor)
        assert m.sum_metric.dtype == torch.float64
        assert math.isfinite(m.get()[1])


def test_composite_create_and_custom_metrics():
    rng = onp.random.RandomState(3)
    (lab, p), _ = _metric_batches(rng)

    def my_err(label, pred):
        return float(onp.abs(label - pred.argmax(-1)).sum()), label.size
    for ms in (["acc", "ce"], [my_err]):
        jm, tm = jmetric.create(ms), tmetric.create(ms)
        jm.update([mx.nd.array(lab)], [mx.nd.array(p)])
        tm.update([torch.from_numpy(lab)], [torch.from_numpy(p)])
        (jn, jv), (tn, tv) = jm.get(), tm.get()
        assert jn == tn
        onp.testing.assert_allclose(tv, jv, rtol=1e-6)
    jc = jmetric.np(lambda a, b: float((a == b.argmax(-1)).mean()))
    tc = tmetric.np(lambda a, b: float((a == b.argmax(-1)).mean()))
    jc.update([mx.nd.array(lab)], [mx.nd.array(p)])
    tc.update([torch.from_numpy(lab)], [torch.from_numpy(p)])
    assert tc.get() == jc.get()
    assert str(tmetric.create("acc")) == "EvalMetric: {'accuracy': nan}"


# ------------------------------------------------------- gluon.utils

@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_global_norm_matches_jax(max_norm):
    """The norm (one read) and the arrays scaled in place (the same NDArray
    objects), against the JAX package's; and its warning on a NaN."""
    rng = onp.random.RandomState(1)
    arrays = [rng.randn(*s).astype("float32") for s in
              ((4, 3), (7,), (2, 2, 2))]
    jarr = [mx.nd.array(a) for a in arrays]
    tarr = [mxt.nd.array(a, ctx=mxt.cpu()) for a in arrays]
    ids = [id(t._data) for t in tarr]
    jn = jgluon.utils.clip_global_norm(jarr, max_norm)
    tn = mxt.gluon.utils.clip_global_norm(tarr, max_norm)
    assert math.isclose(tn, jn, rel_tol=1e-6)
    assert [id(t._data) for t in tarr] == ids
    for a, b in zip(tarr, jarr):
        _rel(a.asnumpy(), b.asnumpy())
    with pytest.warns(UserWarning, match="nan or inf"):
        mxt.gluon.utils.clip_global_norm(
            [mxt.nd.array(onp.array([onp.nan], "float32"), ctx=mxt.cpu())],
            1.0)


def test_split_and_load_matches_jax():
    x = onp.arange(30, dtype="float32").reshape(10, 3)
    ctxs = [mxt.cpu(0), mxt.cpu(0), mxt.cpu(0)]
    got = mxt.gluon.utils.split_and_load(x, ctxs, even_split=False)
    ref = jgluon.utils.split_and_load(x, [mx.cpu()] * 3, even_split=False)
    assert [g.asnumpy().tolist() for g in got] == \
        [r.asnumpy().tolist() for r in ref]
    assert all(g.context == mxt.cpu() for g in got)
    with pytest.raises(ValueError, match="evenly split"):
        mxt.gluon.utils.split_data(mxt.nd.array(x, ctx=mxt.cpu()), 3)
    two = mxt.gluon.split_and_load(x, ctxs[:2], batch_axis=0)
    assert [t.shape for t in two] == [(5, 3), (5, 3)]


def test_check_sha1_and_download(tmp_path):
    import hashlib
    f = tmp_path / "blob"
    f.write_bytes(b"mxnet" * 1000)
    good = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert mxt.gluon.utils.check_sha1(str(f), good)
    assert not mxt.gluon.utils.check_sha1(str(f), "0" * 40)
    with pytest.raises(RuntimeError, match="downloads nothing"):
        mxt.gluon.utils.download("http://example.invalid/x")


# ------------------------------------------------------------ callbacks

class _Param:
    def __init__(self, epoch, nbatch, metric):
        self.epoch, self.nbatch, self.eval_metric = epoch, nbatch, metric


def test_callbacks_log_as_the_jax_package(caplog, monkeypatch):
    """Speedometer (with a fixed clock), ProgressBar, log_train_metric and
    LogValidationMetricsCallback log the JAX package's lines."""
    lines = []
    for pkg, metric in ((mx, jmetric), (mxt, tmetric)):
        ticks = itertools.count(10.0, 2.0)
        monkeypatch.setattr(pkg.callback.time, "perf_counter",
                            lambda: next(ticks))
        m = metric.create("acc")
        m.update([onp.array([1, 2])], [onp.array([[0, 1, 0], [1, 0, 0]],
                                                 "float32")])
        caplog.clear()
        with caplog.at_level(logging.INFO):
            speed = pkg.callback.Speedometer(batch_size=8, frequent=2)
            for nb in range(0, 5):
                speed(_Param(1, nb, m))
                m.update([onp.array([1])], [onp.array([[0, 1, 0]],
                                                      "float32")])
            pkg.callback.ProgressBar(total=10, length=10)(_Param(0, 3, m))
            pkg.callback.log_train_metric(1)(_Param(2, 4, m))
            pkg.callback.LogValidationMetricsCallback()(_Param(3, 0, m))
        lines.append([r.getMessage() for r in caplog.records])
    assert lines[0] == lines[1] and len(lines[1]) == 5
    # the checkpoint callbacks came with the Module API; their files are
    # held against the JAX package's in test_torch_module.py
    assert callable(mxt.callback.do_checkpoint("x"))
    assert callable(mxt.callback.module_checkpoint(None, "x"))
