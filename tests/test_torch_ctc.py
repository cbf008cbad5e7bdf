"""``ops/ctc.py`` (``nd.CTCLoss``, ``gluon.loss.CTCLoss``),
``ops/deformable.py`` and the CTC acoustic model of
``example/speech_recognition/train_ctc.py`` against the JAX package, on the
CPU.

The loss, per sample, within 1e-5 of the reference's largest value and its
gradient (``jax.grad`` of the reference) within 1e-5: blank "first" and
"last", -1 padding, explicit label lengths, ``data_lengths`` (the lattice
freezes past each sample's length), an impossible alignment (a loss near
1e30, not inf), a label id ≥ C (clamped as ``jnp`` indexing clamps it) and
an empty label. The deformable convolution (v1 and the DCNv2 mask, two
deformable groups, stride and dilation) within 1e-5, with the gradients of
input, offsets, mask and weight. The small model (Dense → bidirectional
LSTM → Dense, the blank last) with the JAX model's weights: the loss and
every gradient of an eager step, then the losses and weights of three Adam
steps through ``jit.TrainStep`` against the JAX package's, within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import jit as jjit
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ops import ctc as jctc
from incubator_mxnet_tpu.ops import deformable as jdef

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import jit as tjit
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.ops import ctc as tctc
from incubator_mxnet_tpu_torch.ops import deformable as tdef


def _rel(got, ref, what="", tol=1e-5):
    ref = onp.asarray(ref, dtype="float64")
    scale = max(float(onp.abs(ref).max()), 1e-30)
    err = float(onp.abs(onp.asarray(got, dtype="float64") - ref).max()) \
        / scale
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


T, N, C, L = 14, 4, 6, 5


def _ctc_inputs(seed=0):
    rng = onp.random.RandomState(seed)
    x = rng.randn(T, N, C).astype("float32")
    lab = rng.randint(1, C - 1, (N, L)).astype("float32")
    lab[1, 4:] = -1
    lab[2, 2:] = -1
    lab[3, :] = -1                      # an empty label
    lab[0, 1] = lab[0, 2]               # a repeat needs a blank between
    return x, lab


CASES = {
    "first": dict(blank_label="first"),
    "last": dict(blank_label="last"),
    "data_lengths": dict(blank_label="last", data_lengths=[14, 9, 5, 3]),
    "label_lengths": dict(blank_label="first", label_lengths=[5, 3, 1, 0]),
}


def _ctc_pair(x, lab, kw):
    kw = dict(kw)
    blank = kw.pop("blank_label")
    dl = kw.pop("data_lengths", None)
    ll = kw.pop("label_lengths", None)

    def jf(a):
        return jctc.ctc_loss(a, jnp.asarray(lab),
                             None if dl is None else jnp.asarray(dl),
                             None if ll is None else jnp.asarray(ll), blank)
    want, vjp = jax.vjp(jax.jit(jf), jnp.asarray(x))
    cot = onp.random.RandomState(5).rand(N).astype("float32")
    xt = torch.tensor(x, requires_grad=True)
    got = tctc.ctc_loss(xt, torch.tensor(lab),
                        None if dl is None else torch.tensor(dl),
                        None if ll is None else torch.tensor(ll), blank)
    (got * torch.tensor(cot)).sum().backward()
    return (onp.asarray(want), onp.asarray(vjp(jnp.asarray(cot))[0]),
            got.detach().numpy(), xt.grad.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_ctc_loss_and_gradient(case):
    x, lab = _ctc_inputs()
    want, jgrad, got, tgrad = _ctc_pair(x, lab, CASES[case])
    assert onp.isfinite(got).all()
    _rel(got, want, "loss")
    _rel(tgrad, jgrad, "gradient")


def test_ctc_impossible_alignment_and_out_of_range_ids():
    """Four labels in three frames cannot align: ~1e30, as the reference
    (not inf). An id ≥ C reads class C - 1, as the reference's clamped
    gather does: the loss is the reference's."""
    x, lab = _ctc_inputs(1)
    want, _, got, _ = _ctc_pair(x[:3], lab, dict(blank_label="first"))
    assert got[0] == pytest.approx(1e30, rel=1e-6) and onp.isfinite(got).all()
    _rel(got, want, "impossible")
    lab[1, 0] = C + 4
    want, jgrad, got, tgrad = _ctc_pair(x, lab, dict(blank_label="last"))
    _rel(got, want, "id >= C")
    keep = [0, 2, 3]
    _rel(tgrad[:, keep], jgrad[:, keep], "gradient of the other samples")


def test_ctc_gradient_departs_at_an_out_of_range_id():
    """The reference's gather clamps an id ≥ C in the forward, but its
    transpose drops that id's cotangent, so its gradient is not the
    derivative of its own loss. The port's is: equal to the gradient with
    the id C - 1 that the forward reads (which equals the reference's)."""
    x, lab = _ctc_inputs(1)
    clamped = lab.copy()
    clamped[1, 0] = C - 1
    lab[1, 0] = C + 4
    _, _, got, tgrad = _ctc_pair(x, lab, dict(blank_label="first"))
    want, jgrad, got_c, tgrad_c = _ctc_pair(x, clamped,
                                            dict(blank_label="first"))
    onp.testing.assert_array_equal(got, got_c)
    onp.testing.assert_array_equal(tgrad, tgrad_c)
    _rel(tgrad, jgrad, "gradient at id C - 1")


def test_nd_ctc_loss_and_gluon_ctc_loss():
    x, lab = _ctc_inputs(2)
    dl = onp.array([14, 12, 10, 8], "float32")
    ll = onp.array([5, 3, 2, 0], "float32")
    want = jnd.CTCLoss(jnd.array(x), jnd.array(lab), jnd.array(dl),
                       jnd.array(ll), use_data_lengths=True,
                       use_label_lengths=True).asnumpy()
    arr = lambda a: tnd.array(a, ctx=mxt.cpu())  # noqa: E731
    got = tnd.ctc_loss(arr(x), arr(lab), arr(dl), arr(ll),
                       use_data_lengths=True,
                       use_label_lengths=True).asnumpy()
    _rel(got, want, "nd.CTCLoss")
    pred = onp.swapaxes(x, 0, 1).copy()
    for layout, p in (("NTC", pred), ("TNC", x)):
        jl = jgluon.loss.CTCLoss(layout=layout, label_layout="TN")(
            jnd.array(p), jnd.array(lab.T.copy()), jnd.array(dl)).asnumpy()
        tl = mxt.gluon.loss.CTCLoss(layout=layout, label_layout="TN")(
            arr(p), arr(lab.T.copy()), arr(dl)).asnumpy()
        _rel(tl, jl, "gluon CTCLoss " + layout)


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), pad=(1, 1)),
    dict(kernel=(3, 2), stride=(2, 1), dilate=(1, 2), pad=(1, 0),
         num_deformable_group=2, mask=True)])
def test_deformable_conv2d_and_gradients(kw):
    kw = dict(kw)
    use_mask = kw.pop("mask", False)
    rng = onp.random.RandomState(3)
    n, c, h, w, co = 2, 4, 7, 6, 5
    kh, kwd = kw["kernel"]
    sh, sw = kw.get("stride", (1, 1))
    dh, dw = kw.get("dilate", (1, 1))
    ph, pw = kw.get("pad", (0, 0))
    ndg = kw.get("num_deformable_group", 1)
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kwd - 1) - 1) // sw + 1
    arrays = [rng.randn(n, c, h, w).astype("float32"),
              (rng.randn(n, ndg * 2 * kh * kwd, ho, wo) * 1.5)
              .astype("float32"),
              rng.randn(co, c, kh, kwd).astype("float32"),
              rng.randn(co).astype("float32")]
    if use_mask:
        arrays.append(rng.rand(n, ndg * kh * kwd, ho, wo).astype("float32"))

    def jf(x, off, wt, b, *m):
        return jdef.deformable_conv2d(x, off, wt, b, mask=m[0] if m else None,
                                      **kw)
    want, vjp = jax.vjp(jax.jit(jf), *[jnp.asarray(a) for a in arrays])
    tin = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = tdef.deformable_conv2d(*tin[:4], mask=tin[4] if use_mask else None,
                                 **kw)
    _rel(got.detach().numpy(), want, "deformable conv")
    cot = rng.randn(*got.shape).astype("float32")
    (got * torch.tensor(cot)).sum().backward()
    for t, g in zip(tin, vjp(jnp.asarray(cot))):
        _rel(t.grad.numpy(), g, "gradient")


# ------------------------------------------------------ the CTC model

MELS, HIDDEN, PHONES, FRAMES, BATCH = 6, 8, 4, 12, 3


def _model(g, rnn):
    net = g.nn.HybridSequential()
    net.add(g.nn.Dense(HIDDEN, activation="relu", in_units=MELS,
                       flatten=False),
            rnn.LSTM(HIDDEN, num_layers=1, layout="NTC", bidirectional=True),
            g.nn.Dense(PHONES + 1, flatten=False))
    return net


def _ctc_batch(seed):
    rng = onp.random.RandomState(seed)
    x = rng.randn(BATCH, FRAMES, MELS).astype("float32")
    y = rng.randint(0, PHONES, (BATCH, 4)).astype("float32")
    y[1, 3:] = -1
    y[2, 2:] = -1
    return x, y


def _ctc_pair_nets():
    jnet = _model(jgluon, jgluon.rnn)
    jnet.initialize(mx.init.Xavier())
    x, _ = _ctc_batch(0)
    jnet(jnd.array(x))
    tnet = _model(mxt.gluon, mxt.gluon.rnn)
    tnet.initialize(ctx=mxt.cpu())
    with mxt.cpu():
        tnet(tnd.array(x, ctx=mxt.cpu()))
    mxt.from_jax_params(tnet, jnet)
    return jnet, tnet


def test_ctc_model_eager_gradients_and_train_step():
    jnet, tnet = _ctc_pair_nets()
    x, y = _ctc_batch(1)
    jloss, tloss = (jgluon.loss.CTCLoss(), mxt.gluon.loss.CTCLoss())
    with jautograd.record():
        jl = jloss(jnet(jnd.array(x)), jnd.array(y))
    jl.backward()
    with tautograd.record():
        tl = tloss(tnet(tnd.array(x, ctx=mxt.cpu())),
                   tnd.array(y, ctx=mxt.cpu()))
    tl.backward()
    _rel(tl.asnumpy(), jl.asnumpy(), "eager loss")
    tg = {k: p.grad().asnumpy()
          for k, p in tnet._collect_params_with_prefix().items()}
    jparams = jnet._collect_params_with_prefix()
    for k in ("0.weight", "0.bias", "2.weight", "2.bias"):
        _rel(tg[k], jparams[k].grad().asnumpy(), "gradient of " + k)
    assert all(onp.isfinite(g).all() and onp.abs(g).max() > 0
               for g in tg.values())
    jtr = jgluon.Trainer(jnet.collect_params(), "adam",
                         {"learning_rate": 3e-3})
    ttr = mxt.gluon.Trainer(tnet.collect_params(), "adam",
                            {"learning_rate": 3e-3})
    jstep = jjit.TrainStep(jnet, jloss, jtr)
    tstep = tjit.TrainStep(tnet, tloss, ttr)
    for s in range(3):
        x, y = _ctc_batch(2 + s)
        want = jstep(jnd.array(x), jnd.array(y)).asnumpy()
        got = tstep(x, y).asnumpy()
        _rel(got, want, "TrainStep loss %d" % s, 1e-4)
    want = mxt.convert.jax_arrays(jnet)
    got = mxt.to_numpy_params(tnet)
    assert set(got) == set(want)
    for k in want:
        _rel(got[k], onp.asarray(want[k].asnumpy() if hasattr(
            want[k], "asnumpy") else want[k]), k + " after three steps", 1e-4)
