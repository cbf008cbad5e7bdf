"""The port's training path against the JAX package, on the CPU.

Small configurations (2 layers, units 128, 2 heads so the head width is 64
and attention takes the kernels' route, vocab 97, S 256, B 2, dropout 0,
float32): the JAX model is initialized, its weights are carried into the
port with ``from_jax_params``, and both take three Adam (lr 1e-3)
``TrainStep``s on the same tokens. The JAX side runs its Pallas kernels in
interpret mode with 128-row blocks; the port runs the kernels' plain
versions. Tolerances: per-step losses within 1e-5 (both compute the same
float32 forward, differing in the order of sums); parameters after three
steps within 1e-4 absolute (Adam's normalised step amplifies gradient
rounding only where a gradient is near zero, and moves a weight by at most
about 3e-3 in three steps).
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import jit as jjit
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu.ops import lm_ce as jlm_ce

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import models as tmodels
from incubator_mxnet_tpu_torch.ops import lm_ce as tlm_ce

V, S, B, STEPS = 97, 256, 2, 3
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_ATOL = 1e-4


def _config(kind):
    kw = dict(vocab_size=V, units=128, num_layers=2, num_heads=2,
              max_length=S, attention="flash")
    if kind == "bert":
        kw.update(hidden_size=256, dropout=0.0)
    return kw


def _tokens():
    return onp.random.RandomState(0).randint(0, V, (B, S)).astype("int32")


def _jax_arrays(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _port_net(kind, arrays):
    cls = tmodels.BERTModel if kind == "bert" else tmodels.GPTModel
    net = cls(**_config(kind))
    net.initialize(mxt.init.Zero(), ctx=mxt.cpu())
    mxt.from_jax_params(net, arrays)
    return net


def _port_step(kind, net):
    """The port's (step-net, loss) pair for ``kind``."""
    if kind == "bert":
        return net, mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    return tmodels.FeaturesView(net), tmodels.ChunkedLMLoss(net, chunk=64)


@pytest.fixture(scope="module", params=["bert", "gpt"])
def jax_run(request):
    """(kind, initial arrays, per-step losses, arrays after the steps) of
    the JAX package's TrainStep."""
    kind = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXTPU_FLASH_INTERPRET", "1")
        mp.setenv("MXTPU_FLASH_BLOCK_Q", "128")
        mp.setenv("MXTPU_FLASH_BLOCK_K", "128")
        mx.random.seed(0)
        cls = jmodels.BERTModel if kind == "bert" else jmodels.GPTModel
        net = cls(**_config(kind))
        net.initialize(mx.init.Xavier())
        arrays = _jax_arrays(net)
        if kind == "bert":
            step_net, loss_fn = net, jgluon.loss.SoftmaxCrossEntropyLoss()
        else:
            step_net = jmodels.FeaturesView(net)
            loss_fn = jmodels.ChunkedLMLoss(net, chunk=64)
        trainer = jgluon.Trainer(step_net.collect_params(), "adam",
                                 {"learning_rate": 1e-3})
        step = jjit.TrainStep(step_net, loss_fn, trainer)
        tok = mx.nd.array(_tokens())
        losses = [step(tok, tok).asnumpy() for _ in range(STEPS)]
        return kind, arrays, losses, _jax_arrays(net)


def test_train_steps_match_jax(jax_run):
    kind, arrays, ref_losses, ref_after = jax_run
    net = _port_net(kind, arrays)
    step_net, loss_fn = _port_step(kind, net)
    trainer = mxt.gluon.Trainer(step_net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
    step = mxt.jit.TrainStep(step_net, loss_fn, trainer)
    tok = _tokens()
    for ref in ref_losses:
        loss = step(tok, tok)
        assert loss.shape == (B,) and not loss.requires_grad
        onp.testing.assert_allclose(loss.numpy(), ref, **LOSS_TOL)
    after = mxt.to_numpy_params(net)
    assert set(after) == set(ref_after)
    moved = 0
    for name, ref in ref_after.items():
        onp.testing.assert_allclose(after[name], ref, atol=PARAM_ATOL,
                                    rtol=0, err_msg=name)
        moved += not onp.allclose(ref, arrays[name])
    assert moved > len(ref_after) // 2


@pytest.mark.parametrize("kind", ["bert", "gpt"])
def test_train_step_equals_the_eager_step(kind):
    """TrainStep = autograd.record() forward, backward, Trainer.step(B),
    exactly, over two steps."""
    arrays = _random_arrays(kind)
    nets = [_port_net(kind, arrays) for _ in range(2)]
    tok = torch.from_numpy(onp.random.RandomState(1)
                           .randint(0, V, (B, S)).astype("int32"))
    step_net, loss_fn = _port_step(kind, nets[0])
    step = mxt.jit.TrainStep(step_net, loss_fn, mxt.gluon.Trainer(
        step_net.collect_params(), "adam", {"learning_rate": 1e-3}))
    eager_net, eager_loss = _port_step(kind, nets[1])
    trainer = mxt.gluon.Trainer(eager_net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
    for _ in range(2):
        a = step(tok, tok)
        with mxt.autograd.record():
            b = eager_loss(eager_net(tok), tok)
        mxt.autograd.backward(b)
        trainer.step(B)
        assert torch.equal(a, b.detach())
    for name, p in nets[0].collect_params().items():
        assert torch.equal(p.data(), nets[1].collect_params()[name].data()), \
            name


def test_train_step_finishes_deferred_init_and_takes_batch_size():
    """A Dense whose input width waits for the first forward is initialized
    inside the first step, on its parameters' device, and the step equals
    the eager one; ``batch_size=`` sets the rescale's denominator."""
    rng = onp.random.RandomState(6)
    x, y = (torch.from_numpy(rng.randn(4, n).astype("float32"))
            for n in (5, 3))
    nets = []
    for _ in range(2):
        net = mxt.gluon.nn.Dense(3)
        net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                       generator=torch.Generator().manual_seed(0))
        nets.append(net)
    loss_fn = mxt.gluon.loss.L2Loss()
    step = mxt.jit.TrainStep(nets[0], loss_fn, mxt.gluon.Trainer(
        nets[0].collect_params(), "sgd", {"learning_rate": 0.1}))
    assert nets[0].weight._data is None
    a = step(x, y, batch_size=8)
    assert nets[0].weight.data().shape == (3, 5)
    with mxt.autograd.pause():
        nets[1](x)
    trainer = mxt.gluon.Trainer(nets[1].collect_params(), "sgd",
                                {"learning_rate": 0.1})
    with mxt.autograd.record():
        b = loss_fn(nets[1](x), y)
    mxt.autograd.backward(b)
    trainer.step(8)
    assert torch.equal(a, b.detach())
    for name in ("weight", "bias"):
        assert torch.equal(getattr(nets[0], name).data(),
                           getattr(nets[1], name).data()), name


def test_train_step_gives_trainer_params_outside_the_net_fresh_grads():
    """A trainer parameter that lives outside the net (here the loss's
    scale) is updated from this step's gradient only: three TrainSteps
    equal three eager steps, and its gradient is released after each."""
    rng = onp.random.RandomState(7)
    x, y = (torch.from_numpy(rng.randn(4, n).astype("float32"))
            for n in (5, 3))
    runs = []
    for _ in range(2):
        net = mxt.gluon.nn.Dense(3, in_units=5)
        net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                       generator=torch.Generator().manual_seed(0))
        scale = mxt.gluon.Parameter("scale", shape=(1,), init=mxt.init.One())
        scale.initialize(ctx=mxt.cpu())

        def loss_fn(out, label, scale=scale, l2=mxt.gluon.loss.L2Loss()):
            return l2(out * scale.data(), label)
        trainer = mxt.gluon.Trainer(
            list(net.collect_params().values()) + [scale], "sgd",
            {"learning_rate": 0.1})
        runs.append((net, scale, loss_fn, trainer))
    (net_a, scale_a, loss_a, trainer_a), (net_b, scale_b, loss_b,
                                          trainer_b) = runs
    step = mxt.jit.TrainStep(net_a, loss_a, trainer_a)
    for _ in range(3):
        a = step(x, y)
        assert scale_a.data().grad is None
        with mxt.autograd.record():
            b = loss_b(net_b(x), y)
        mxt.autograd.backward(b)
        trainer_b.step(4)
        assert torch.equal(a, b.detach())
    assert not torch.equal(scale_a.data(), torch.ones(1))
    assert torch.equal(scale_a.data(), scale_b.data())
    assert torch.equal(net_a.weight.data(), net_b.weight.data())


def test_train_step_and_sgd_refuse_options_the_port_has_not():
    """Options whose machinery the port does not have yet raise instead of
    being ignored."""
    net = mxt.gluon.nn.Dense(3, in_units=5)
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd")
    loss = mxt.gluon.loss.L2Loss()
    for kw in (dict(model_id="m"), dict(data_axis="dp")):
        with pytest.raises(TypeError):
            mxt.jit.TrainStep(net, loss, trainer, **kw)
    with pytest.raises(TypeError, match="lazy_update"):
        mxt.optimizer.create("sgd", lazy_update=True)


def _random_arrays(kind):
    net = (tmodels.BERTModel if kind == "bert" else tmodels.GPTModel)(
        **_config(kind))
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                   generator=torch.Generator().manual_seed(3))
    return mxt.to_numpy_params(net)


@pytest.mark.parametrize("bias", [False, True])
def test_chunked_cross_entropy_and_grads_match_jax(bias):
    """A ragged T (2 x 37 tokens at chunk 16: zero-padded to 80), the
    recomputing backward, and the dense single-chunk route."""
    rng = onp.random.RandomState(4)
    h = rng.randn(2, 37, 32).astype("float32")
    w = (rng.randn(V, 32) * 0.3).astype("float32")
    b = rng.randn(V).astype("float32") if bias else None
    y = rng.randint(0, V, (2, 37)).astype("int32")

    def jfn(h_, w_, b_=None):
        return jlm_ce.chunked_lm_cross_entropy(h_, w_, jnp.asarray(y), 16,
                                               head_b=b_)
    jargs = [jnp.asarray(a) for a in (h, w, b) if a is not None]
    ref = onp.asarray(jfn(*jargs))
    ref_grads = jax.grad(lambda *a: jfn(*a).sum(),
                         argnums=tuple(range(len(jargs))))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_()
             for a in (h, w, b) if a is not None]
    for chunk in (16, None):
        for t in targs:
            t.grad = None
        got = tlm_ce.chunked_lm_cross_entropy(
            targs[0], targs[1], torch.from_numpy(y), chunk,
            head_b=targs[2] if bias else None)
        assert got.shape == (2, 37) and got.dtype == torch.float32
        onp.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5,
                                    rtol=1e-5)
        got.sum().backward()
        for t, r in zip(targs, ref_grads):
            onp.testing.assert_allclose(t.grad.numpy(), onp.asarray(r),
                                        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["bert", "gpt"])
def test_chunked_lm_loss_equals_the_dense_softmax_ce(kind):
    """ChunkedMLMLoss (untied, biased head) and ChunkedLMLoss (tied) over
    FeaturesView equal SoftmaxCrossEntropyLoss over the model's logits."""
    net = _port_net(kind, _random_arrays(kind))
    tok = torch.from_numpy(_tokens())
    hidden = tmodels.FeaturesView(net)(tok)
    head = tmodels.ChunkedMLMLoss if kind == "bert" else tmodels.ChunkedLMLoss
    chunked = head(net, chunk=96)(hidden, tok)
    dense = mxt.gluon.loss.SoftmaxCrossEntropyLoss()(net(tok), tok)
    torch.testing.assert_close(chunked, dense, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sparse", [True, False])
def test_losses_match_jax(sparse):
    rng = onp.random.RandomState(5)
    pred = rng.randn(3, 4, 6).astype("float32")
    sw = rng.rand(3, 4).astype("float32")
    label = rng.randint(0, 6, (3, 4)).astype("int32") if sparse else \
        rng.rand(3, 4, 6).astype("float32")
    pairs = [(jgluon.loss.SoftmaxCrossEntropyLoss(sparse_label=sparse,
                                                  weight=0.7),
              mxt.gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=sparse,
                                                     weight=0.7), sw)]
    if not sparse:      # elementwise losses: the weight broadcasts over C
        pairs += [(jgluon.loss.L2Loss(), mxt.gluon.loss.L2Loss(),
                   sw[..., None]),
                  (jgluon.loss.L1Loss(weight=2.0),
                   mxt.gluon.loss.L1Loss(weight=2.0), sw[..., None])]
    for jl, tl, w in pairs:
        ref = jl(mx.nd.array(pred), mx.nd.array(label), mx.nd.array(w))
        got = tl(torch.from_numpy(pred), torch.from_numpy(label),
                 torch.from_numpy(w))
        assert got.shape == (3,)
        onp.testing.assert_allclose(got.numpy(), ref.asnumpy(), atol=1e-6,
                                    rtol=1e-6)


def test_from_jax_params_takes_features_view_and_model_names():
    arrays = _random_arrays("gpt")
    view = tmodels.FeaturesView(_port_net("gpt", arrays))
    assert set(view.collect_params().keys()) == \
        {"model." + k for k in arrays}
    mxt.from_jax_params(view, arrays)
    mxt.from_jax_params(view, {"model." + k: a for k, a in arrays.items()})
    assert all(onp.array_equal(mxt.to_numpy_params(view.model)[k], a)
               for k, a in arrays.items())


def test_dropout_follows_the_training_flag():
    x = torch.ones(1000)
    drop = mxt.gluon.nn.Dropout(0.5)
    assert torch.equal(drop(x), x)                       # predict mode
    with mxt.autograd.record():
        assert mxt.autograd.is_recording() and mxt.autograd.is_training()
        assert not torch.equal(drop(x), x)
        with mxt.autograd.pause():
            assert not torch.is_grad_enabled()
            assert torch.equal(drop(x), x)
    with mxt.autograd.train_mode():
        assert not mxt.autograd.is_recording()
        assert not torch.equal(drop(x), x)
    assert not mxt.autograd.is_training()


def test_train_step_options_wait_for_their_slices():
    net = _port_net("gpt", _random_arrays("gpt"))
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd")
    loss = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    for kw in (dict(mesh=object()), dict(zero=True), dict(remat=True),
               dict(grad_postprocess=lambda g: g)):
        with pytest.raises(NotImplementedError, match="slice"):
            mxt.jit.TrainStep(net, loss, trainer, **kw)
