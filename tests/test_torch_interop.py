"""``operator`` (``nd.Custom``), ``contrib.text`` and the torch bridge
(``incubator_mxnet_tpu_torch.torch``) against the JAX package's, on the
CPU. (``tests/test_torch_bridge.py`` is the JAX package's own bridge
test.)

- A custom operator's forward and backward through the port's
  ``nd.Custom`` within 1e-6 of the JAX package's with the same operator;
  ``req`` and ``assign`` ("write", "add", "null") as in the reference; a
  ``TrainStep`` whose net calls one runs that signature uncaptured (the
  captured path through the CPU stand-in for the graph).
- ``contrib.text``: the vocabulary, the indices and the vectors of a local
  embedding file equal the reference's.
- The bridge: ``to_torch`` does not alias and keeps the device,
  ``from_torch`` copies onto ``ctx``, ``torch_function``'s gradients equal
  the reference's, and ``TorchBlock`` trains its module.
- The reference's own tests of these modules (``test_torch_bridge.py``,
  the custom-op tests of ``test_extension.py``, the text test of
  ``test_legacy_api.py``) run against the port with the package's name
  swapped.
"""
import inspect
import pathlib

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
import incubator_mxnet_tpu_torch as mxt
import incubator_mxnet_tpu_torch.torch as tbridge

CPU = mxt.cpu()
_TESTS = pathlib.Path(__file__).parent


def _softmax_op(pkg, nd, name):
    """MXNet's example/numpy-ops/custom_softmax.py: the softmax loss head
    (forward softmax, backward p - onehot(label))."""

    class Softmax(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            y = nd.exp(x - nd.max(x, axis=1, keepdims=True))
            y = y / nd.sum(y, axis=1, keepdims=True)
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1]
            y = out_data[0]
            onehot = nd.one_hot(lab, y.shape[1])
            self.assign(in_grad[0], req[0], y - onehot)
            self.assign(in_grad[1], "null", lab)

    @pkg.operator.register(name)
    class SoftmaxProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()
    return SoftmaxProp


@pytest.fixture(scope="module")
def softmax_ops():
    _softmax_op(mx, mx.nd, "interop_softmax")
    _softmax_op(mxt, mxt.nd, "interop_softmax")


def _mlp_grads(pkg, ctx_kw, x, lab, w):
    nd = pkg.nd
    xa = nd.array(x, **ctx_kw)
    wa = nd.array(w, **ctx_kw)
    la = nd.array(lab, **ctx_kw)
    wa.attach_grad()
    with pkg.autograd.record():
        h = nd.dot(xa, wa)
        p = nd.Custom(h, la, op_type="interop_softmax")
    p.backward()
    return p.asnumpy(), wa.grad.asnumpy()


def test_custom_forward_backward_against_the_reference(softmax_ops):
    rng = onp.random.RandomState(0)
    x = rng.randn(6, 5).astype("float32")
    w = rng.randn(5, 4).astype("float32")
    lab = rng.randint(0, 4, (6,)).astype("float32")
    jp, jg = _mlp_grads(mx, {}, x, lab, w)
    tp, tg = _mlp_grads(mxt, {"ctx": CPU}, x, lab, w)
    onp.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
    onp.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)


def test_assign_req_semantics():
    op = mxt.operator.CustomOp()
    with mxt.cpu():
        dst = mxt.nd.array([1.0, 2.0])
        op.assign(dst, "write", mxt.nd.array([5.0, 5.0]))
        assert dst.asnumpy().tolist() == [5.0, 5.0]
        op.assign(dst, "add", mxt.nd.array([1.0, 2.0]))
        assert dst.asnumpy().tolist() == [6.0, 7.0]
        op.assign(dst, "null", mxt.nd.array([0.0, 0.0]))
        assert dst.asnumpy().tolist() == [6.0, 7.0]
        with pytest.raises(ValueError):
            op.assign(dst, "bogus", dst)


class _CustomHead(mxt.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.fc = mxt.gluon.nn.Dense(4, in_units=5)

    def forward(self, x, lab):
        h = self.fc(x)
        return mxt.nd.Custom(h, lab, op_type="interop_softmax")._data


def test_train_step_runs_a_custom_op_uncaptured(softmax_ops, monkeypatch):
    """TrainStep's captured path (through the CPU stand-in for the graph):
    a step whose body calls nd.Custom runs eagerly, captures nothing, and
    runs the signature eagerly from then on."""
    from test_torch_jit import _cpu_capture
    net = _CustomHead()
    net.initialize(mxt.init.Xavier(), ctx=CPU,
                   generator=torch.Generator().manual_seed(0))
    tr = mxt.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})

    def loss_fn(p, lab):
        return -(torch.log(p + 1e-9) * torch.nn.functional.one_hot(
            lab.long(), 4)).sum(1)
    step = mxt.jit.TrainStep(net, loss_fn, tr)
    monkeypatch.setattr(mxt.jit, "_GraphCapture", _cpu_capture(step))
    rng = onp.random.RandomState(1)
    x = rng.randn(6, 5).astype("float32")
    lab = rng.randint(0, 4, (6,)).astype("float32")
    args = step._prepare((x, lab, lab), 2)
    loss = step._replay(args, 2, 6)
    assert step.captures == 0 and len(step._uncaptured) == 1
    assert torch.isfinite(loss).all()
    step(x, lab, lab, n_net_inputs=2)
    assert step.captures == 0


def test_text_against_the_reference(tmp_path):
    emb_file = tmp_path / "emb.txt"
    emb_file.write_text("cat 1.0 2.0 0.5\ndog 3.0 4.0 -1.0\nmat 0 0 1\n")
    src = "the cat sat on the mat\nthe dog saw the cat"
    outs = []
    for pkg, kw in ((mx, {}), (mxt, {"ctx": CPU})):
        text = pkg.contrib.text
        c = text.count_tokens_from_str(src)
        vocab = text.Vocabulary(c, reserved_tokens=["<pad>"])
        emb = text.CustomEmbedding(file_path=str(emb_file), vocabulary=vocab,
                                   **kw)
        outs.append((dict(c), vocab.idx_to_token,
                     vocab.to_indices(["cat", "zebra", "the"]),
                     emb.idx_to_vec.asnumpy(),
                     emb.get_vecs_by_tokens(["dog", "Cat"],
                                            lower_case_backup=True)
                     .asnumpy()))
    for got, want in zip(outs[1], outs[0]):
        if isinstance(want, onp.ndarray):
            onp.testing.assert_array_equal(got, want)
        else:
            assert got == want


def test_to_torch_keeps_the_device_and_does_not_alias():
    a = mxt.nd.array([[1.0, 2.0]], ctx=CPU)
    t = tbridge.to_torch(a)
    assert isinstance(t, torch.Tensor) and t.device == a._data.device
    t += 1
    assert a.asnumpy().tolist() == [[1.0, 2.0]]
    src = torch.tensor([3.0, 4.0])
    b = tbridge.from_torch(src, ctx=CPU)
    src += 1
    assert b.asnumpy().tolist() == [3.0, 4.0]


def test_torch_function_gradient_against_the_reference():
    from incubator_mxnet_tpu import torch as jbridge
    x = onp.array([1.0, -2.0, 3.0], "float32")
    grads = []
    for pkg, br, kw in ((mx, jbridge, {}), (mxt, tbridge, {"ctx": CPU})):
        a = pkg.nd.array(x, **kw)
        a.attach_grad()
        with pkg.autograd.record():
            h = pkg.nd.relu(a)
            y = br.torch_function(torch.sigmoid, h)
            loss = (y * y).sum()
        loss.backward()
        grads.append(a.grad.asnumpy())
    onp.testing.assert_allclose(grads[1], grads[0], rtol=1e-6, atol=1e-7)


def test_bridge_not_imported_by_the_package():
    import subprocess
    import sys
    code = ("import sys, incubator_mxnet_tpu_torch as m; "
            "print('incubator_mxnet_tpu_torch.torch' in sys.modules, "
            "m.nd.ndarray.torch.__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(_TESTS.parent)).stdout.split()
    assert out == ["False", "torch"]


def _port_tests(name, select=None):
    """The test functions of the JAX package's ``tests/<name>`` (those
    ``select`` keeps), with every name of the JAX package read as the
    port's."""
    src = (_TESTS / name).read_text().replace("incubator_mxnet_tpu",
                                              "incubator_mxnet_tpu_torch")
    ns = {"__name__": "port_" + name[:-3], "__file__": str(_TESTS / name)}
    exec(compile(src, "port/" + name, "exec"), ns)
    return {k: v for k, v in ns.items() if k.startswith("test_")
            and (select is None or select(k))}


_REF = {}
_REF.update({("test_torch_bridge.py", k): None
             for k in _port_tests("test_torch_bridge.py")})
_REF.update({("test_extension.py", k): None
             for k in _port_tests("test_extension.py",
                                  lambda k: "custom" in k
                                  or "subgraph" in k)})
_REF.update({("test_legacy_api.py", k): None
             for k in _port_tests("test_legacy_api.py",
                                  lambda k: "text" in k)})


@pytest.mark.parametrize("where", sorted(_REF), ids=lambda w: "%s::%s" % w)
def test_reference_tests_hold(where, tmp_path):
    name, test = where
    fn = _port_tests(name, lambda k: k == test)[test]
    with mxt.cpu():
        if "tmp_path" in inspect.signature(fn).parameters:
            fn(tmp_path)
        else:
            fn()
