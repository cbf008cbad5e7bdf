"""The port's ``contrib.svrg.SVRGModule`` and ``contrib.tensorboard
.LogMetricsCallback`` against the JAX package's, on the CPU.

SVRG: a linear regression symbol (MXNet's SVRG example) from the same
parameters through ``fit`` over two epochs with a full-gradient pass every
epoch (``update_freq=1``) and every other epoch (2): the weights within
1e-5 of the largest value (float32 summation orders), and the full
gradient mu itself. The metrics callback writes the same JSON records (the
wall-clock ``ts`` left out; the metric's value within 1e-6, the metrics
reduce in float32 there and in double here) as the JAX package's
JSON-lines sink.
"""
import json
import sys

import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.symbol import symbol as jsymm

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.symbol import symbol as tsymm

TOL = 1e-5
BATCH, N, D = 4, 16, 3


def _close(got, want, what):
    want = onp.asarray(want, "float64")
    err = float(onp.abs(onp.asarray(got, "float64") - want).max()) / max(
        float(onp.abs(want).max()), 1e-30)
    assert err <= TOL, "%s: %.3g of the largest value" % (what, err)


@pytest.fixture(autouse=True)
def _fresh_names():
    jsymm._NAME_COUNT.clear()
    tsymm._NAME_COUNT.clear()
    yield


def _arr(pkg, a):
    return mx.nd.array(a) if pkg is mx else mxt.nd.array(a, ctx=mxt.cpu())


def _svrg(pkg, update_freq):
    S = pkg.sym
    net = S.LinearRegressionOutput(
        S.FullyConnected(S.var("data"), num_hidden=1, name="fc"),
        S.var("lin_reg_label"), name="lro")
    rng = onp.random.RandomState(0)
    x = rng.randn(N, D).astype("float32")
    y = (x @ onp.array([[1.5], [-2.0], [0.5]], "float32") + 0.3).ravel()
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH,
                            label_name="lin_reg_label")
    ctx = mx.cpu() if pkg is mx else mxt.cpu()
    mod = pkg.contrib.svrg.SVRGModule(net, data_names=["data"],
                                      label_names=["lin_reg_label"],
                                      context=ctx, update_freq=update_freq)
    mod.fit(it, num_epoch=2, eval_metric="mse", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.05),),
            arg_params={"fc_weight": _arr(pkg, rng.randn(1, D).astype(
                "float32") * 0.1), "fc_bias": _arr(pkg, onp.zeros(1))})
    return mod


@pytest.mark.parametrize("update_freq", [1, 2])
def test_svrg_fit_is_the_references(update_freq):
    jmod, tmod = _svrg(mx, update_freq), _svrg(mxt, update_freq)
    (ja, _), (ta, _) = jmod.get_params(), tmod.get_params()
    assert sorted(ta) == sorted(ja) == ["fc_bias", "fc_weight"]
    for k in ta:
        _close(ta[k].asnumpy(), ja[k].asnumpy(), k)
    assert sorted(tmod._mu) == sorted(jmod._mu)
    for k in tmod._mu:
        _close(tmod._mu[k].asnumpy(), jmod._mu[k].asnumpy(), "mu " + k)
    # the snapshot module holds the parameters of the last full pass
    aux_w = tmod._mod_aux.get_params()[0]["fc_weight"].asnumpy()
    assert not onp.array_equal(aux_w, ta["fc_weight"].asnumpy())


def test_svrg_before_the_first_full_gradient_is_plain_sgd():
    """Without mu the step is the Module's own (no snapshot pass)."""
    mod = _svrg(mxt, 1)
    mod._mu = None
    batch = mxt.io.DataBatch(data=[_arr(mxt, onp.ones((BATCH, D)))],
                             label=[_arr(mxt, onp.zeros(BATCH))])
    mod.forward_backward(batch)
    g = mod._exec.grad_dict["fc_weight"].asnumpy().copy()
    plain = mxt.mod.Module(mod.symbol, data_names=["data"],
                           label_names=["lin_reg_label"], context=mxt.cpu())
    plain.bind(data_shapes=[("data", (BATCH, D))],
               label_shapes=[("lin_reg_label", (BATCH,))])
    plain.init_params(arg_params=mod.get_params()[0])
    plain.forward_backward(batch)
    onp.testing.assert_array_equal(
        plain._exec.grad_dict["fc_weight"].asnumpy(), g)


def _callback_lines(pkg, tmp, monkeypatch):
    if pkg is mx:       # the JAX package's JSON-lines sink, not TensorBoard
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    metric = pkg.metric.create(["mse", "acc"])
    metric.update([_arr(pkg, onp.array([1.0, 0.0, 2.0]))],
                  [_arr(pkg, onp.array([0.5, 0.0, 2.0]))])
    with pkg.contrib.tensorboard.LogMetricsCallback(str(tmp), "train") as cb:
        for nbatch in range(2):
            cb(pkg.model.BatchEndParam(epoch=0, nbatch=nbatch,
                                       eval_metric=metric, locals=None))
        cb(pkg.model.BatchEndParam(epoch=0, nbatch=2, eval_metric=None,
                                   locals=None))
    with pytest.raises(ValueError, match="closed"):
        cb(pkg.model.BatchEndParam(epoch=0, nbatch=3, eval_metric=metric,
                                   locals=None))
    cb.close()
    with open(str(tmp / "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert all(isinstance(r.pop("ts"), float) for r in records)
    assert [r["name"] for r in records[:2]] == ["train-mse",
                                                "train-accuracy"]
    return records


def test_log_metrics_callback_writes_the_references_records(tmp_path,
                                                            monkeypatch):
    want = _callback_lines(mx, tmp_path / "j", monkeypatch)
    got = _callback_lines(mxt, tmp_path / "t", monkeypatch)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        # the metric's value: float32 in the JAX package, a double here
        assert g.pop("value") == pytest.approx(w.pop("value"), rel=1e-6)
        assert g == w
