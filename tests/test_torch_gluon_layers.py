"""The second half of the port's Gluon against the JAX package, on the CPU:
the initializers, the new ``nn`` layers (forward and gradients), 1-D and
3-D convolution and pooling, transposed convolutions, ``params=``
sharing, forward hooks, ``Block.apply``, ``gluon.Constant`` and
``SyncBatchNorm``.

Layers run the same numpy-seeded inputs and weights (carried by
``from_jax_params``) through both packages in training mode under
``record()``; the output, the input's gradient and every parameter's
gradient of a seeded linear function of the output must agree within 1e-5
of the largest value (float32 summation orders). Deterministic
initializers agree bit for bit; random ones are held by their laws.
Where the JAX package departs from MXNet (grouped and ``target_shape``
transposed convolutions, a hybridized block's own hooks, clip's gradient
at its bounds), the port is held against MXNet's definition (a numpy
loop, the output size MXNet infers, the hooks at every call, the gradient
passed at a bound) and the fault is logged in ROADMAP.md §3.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import initializer as jinit
from incubator_mxnet_tpu import nd as jnd

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import initializer as tinit
from incubator_mxnet_tpu_torch import nd as tnd

TOL = 1e-5


def _rel(got, ref, what="", tol=TOL):
    ref = onp.asarray(ref, dtype="float64")
    scale = max(float(onp.abs(ref).max()), 1e-30)
    err = float(onp.abs(onp.asarray(got, dtype="float64") - ref).max()) \
        / scale
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


# ------------------------------------------------------------ initializers

def _jax_init(init, name, shape):
    arr = jnd.zeros(shape)
    init(name, arr)
    return arr.asnumpy()


def _port_init(init, name, shape):
    arr = torch.zeros(shape)
    init(name, arr, torch.Generator().manual_seed(0))
    return arr.numpy()


@pytest.mark.parametrize("name,make,shape", [
    ("zero", lambda m: m.Zero(), (3, 4)),
    ("one", lambda m: m.One(), (3, 4)),
    ("constant", lambda m: m.Constant(0.7), (3, 4)),
    ("bilinear", lambda m: m.Bilinear(), (2, 3, 4, 4)),
    ("bilinear_odd", lambda m: m.Bilinear(), (1, 1, 3, 5)),
    ("mixed", lambda m: m.Mixed(["fc.*", ".*"], [m.Constant(0.3), m.One()]),
     (2, 5))])
@pytest.mark.parametrize("param", ["fc_weight", "conv_weight", "conv_bias",
                                   "bn_gamma"])
def test_deterministic_initializers_equal_the_reference(name, make, shape,
                                                        param):
    """Bit for bit, through the name-suffix dispatch (bias → 0, gamma → 1)
    and ``Mixed``'s pattern dispatch."""
    want = _jax_init(make(jinit), param, shape)
    got = _port_init(make(tinit), param, shape)
    assert onp.array_equal(got, want), (name, param)


def test_lstm_bias_and_explicit_initializers():
    """LSTMBias sets the forget slice [H, 2H) (it acts as an explicit
    per-parameter init, the suffix dispatch would zero a bias), equal to
    the reference's in an LSTM layer; Mixed without a matching pattern
    raises in both packages; create knows the new names."""
    want = jinit.LSTMBias(1.5)._init_weight
    arr = jnd.zeros((12,))
    want("b", arr)
    got = torch.zeros(12)
    tinit.LSTMBias(1.5)._init_weight("b", got, None)
    assert onp.array_equal(got.numpy(), arr.asnumpy())
    assert list(got.numpy()) == [0] * 3 + [1.5] * 3 + [0] * 6
    jl = jgluon.rnn.LSTM(3, input_size=2,
                         i2h_bias_initializer=jinit.LSTMBias(2.0))
    jl.initialize()
    tl = mxt.gluon.rnn.LSTM(3, input_size=2,
                            i2h_bias_initializer=tinit.LSTMBias(2.0))
    tl.initialize(ctx=mxt.cpu())
    assert onp.array_equal(tl.l0_i2h_bias.data().asnumpy(),
                           jl._i2hb[0].data().asnumpy())
    with pytest.raises(ValueError):
        jinit.Mixed(["fc.*"], [jinit.One()])("conv_weight", jnd.zeros((2,)))
    with pytest.raises(ValueError):
        tinit.Mixed(["fc.*"], [tinit.One()])("conv_weight", torch.zeros(2))
    for name in ("constant", "orthogonal", "msraprelu", "bilinear",
                 "lstmbias"):
        assert isinstance(tinit.create(name), tinit.Initializer), name


@pytest.mark.parametrize("shape", [(8, 12), (12, 8), (6, 2, 3, 3)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_is_orthonormal_as_the_reference(shape, rand_type):
    """The draws differ (two RNGs); the law holds in both: the (out,
    prod(rest)) matrix Q has QᵀQ (or QQᵀ, on the smaller side) equal to
    scale²·I within 1e-5."""
    for got in (_jax_init(jinit.Orthogonal(1.3, rand_type), "w", shape),
                _port_init(tinit.Orthogonal(1.3, rand_type), "w", shape)):
        q = got.reshape(shape[0], -1).astype("float64")
        small = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
        onp.testing.assert_allclose(small, 1.3 ** 2 * onp.eye(len(small)),
                                    atol=1e-5)


def test_msra_prelu_draws_by_its_variance():
    """Normal with mean 0 and variance 2 / ((1 + slope²) · fan), fan the
    average of fan-in and fan-out: the sample moments of both packages'
    draws within 5 standard errors."""
    shape, slope = (64, 48, 3, 3), 0.3
    fan = (48 * 9 + 64 * 9) / 2.0
    var = 2.0 / ((1 + slope ** 2) * fan)
    n = onp.prod(shape)
    for got in (_jax_init(jinit.MSRAPrelu("avg", slope), "w", shape),
                _port_init(tinit.MSRAPrelu("avg", slope), "w", shape)):
        assert abs(got.mean()) < 5 * onp.sqrt(var / n)
        assert abs(got.var() - var) < 5 * var * onp.sqrt(2.0 / n)


# ------------------------------------------------------------------ layers

def _bn(m):
    return m.SyncBatchNorm(in_channels=3)


LAYERS = {
    "instance_norm": (lambda m: m.InstanceNorm(in_channels=3, scale=True),
                      (2, 3, 5, 4)),
    "instance_norm_deferred": (lambda m: m.InstanceNorm(), (2, 3, 6)),
    "group_norm": (lambda m: m.GroupNorm(num_groups=2, in_channels=4),
                   (2, 4, 3, 3)),
    "group_norm_deferred": (lambda m: m.GroupNorm(num_groups=3), (2, 6, 5)),
    "identity": (lambda m: m.Identity(), (3, 4)),
    "hybrid_lambda": (lambda m: m.HybridLambda("tanh"), (3, 4)),
    "lambda": (lambda m: m.Lambda(lambda x: x * 3.0), (3, 4)),
    "prelu": (lambda m: m.PReLU(in_channels=3), (2, 3, 4)),
    "leaky": (lambda m: m.LeakyReLU(0.1), (3, 4)),
    "elu": (lambda m: m.ELU(0.7), (3, 4)),
    "selu": (lambda m: m.SELU(), (3, 4)),
    "gelu": (lambda m: m.GELU(), (3, 4)),
    "swish": (lambda m: m.Swish(1.5), (3, 4)),
    "sync_batch_norm": (_bn, (4, 3, 2, 2)),
    "conv1d": (lambda m: m.Conv1D(4, 3, padding=1, in_channels=2), (2, 2, 7)),
    "conv1d_deferred": (lambda m: m.Conv1D(4, 2, strides=2, dilation=1),
                        (2, 3, 8)),
    "conv3d": (lambda m: m.Conv3D(4, (2, 3, 3), strides=(1, 2, 1),
                                  padding=(0, 1, 1), in_channels=2),
               (1, 2, 4, 5, 5)),
    "conv3d_grouped": (lambda m: m.Conv3D(4, 2, groups=2, in_channels=4),
                       (1, 4, 3, 3, 3)),
    "conv1d_transpose": (lambda m: m.Conv1DTranspose(
        3, 3, strides=2, output_padding=1, in_channels=2), (2, 2, 5)),
    "conv2d_transpose": (lambda m: m.Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, in_channels=2),
        (2, 2, 4, 4)),
    "conv2d_transpose_dilated": (lambda m: m.Conv2DTranspose(
        2, (3, 2), strides=(1, 2), dilation=(2, 1), in_channels=3),
        (1, 3, 3, 4)),
    "conv3d_transpose": (lambda m: m.Conv3DTranspose(
        2, 2, strides=2, in_channels=3), (1, 3, 2, 3, 3)),
    "max_pool1d": (lambda m: m.MaxPool1D(3, 2), (2, 3, 9)),
    "avg_pool1d": (lambda m: m.AvgPool1D(2, padding=1,
                                         count_include_pad=False),
                   (2, 3, 7)),
    "max_pool3d": (lambda m: m.MaxPool3D(2, ceil_mode=True),
                   (1, 2, 5, 4, 5)),
    "avg_pool3d": (lambda m: m.AvgPool3D((2, 1, 2), strides=1, padding=1),
                   (1, 2, 3, 4, 4)),
    "global_max_pool1d": (lambda m: m.GlobalMaxPool1D(), (2, 3, 7)),
    "global_avg_pool1d": (lambda m: m.GlobalAvgPool1D(), (2, 3, 7)),
    "global_max_pool3d": (lambda m: m.GlobalMaxPool3D(), (1, 2, 3, 4, 2)),
    "global_avg_pool3d": (lambda m: m.GlobalAvgPool3D(), (1, 2, 3, 4, 2)),
    "reflection_pad2d": (lambda m: m.ReflectionPad2D(2), (1, 2, 4, 5)),
    "sequential": (lambda m: _stack(m.Sequential, m), (3, 5)),
    "hybrid_sequential": (lambda m: _stack(m.HybridSequential, m), (3, 5)),
}


def _stack(cls, m):
    s = cls()
    s.add(m.Dense(6, in_units=5), m.ELU(), m.Dense(2, in_units=6))
    return s


def _randomize(jnet, seed):
    rng = onp.random.RandomState(seed)
    for p in jnet.collect_params().values():
        if p._data is not None:
            p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype("float32"))


def _run(net, m, ag, x, **ctx):
    """(output, input gradient) of ``net`` on ``x`` in training mode; the
    gradient is that of sum(out · c), ``c`` seeded uniform in (-1, 1) (a
    normalisation's sum(out²) is nearly constant in x)."""
    xa = m.array(x, **ctx)
    xa.attach_grad()
    with ag.record():
        out = net(xa)
        c = onp.random.RandomState(99).uniform(-1, 1, out.shape)
        s = (out * m.array(c.astype("float32"), **ctx)).sum()
    s.backward()
    return out.asnumpy(), xa.grad.asnumpy()


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_match_the_reference(name):
    make, shape = LAYERS[name]
    x = onp.random.RandomState(1).uniform(-1, 1, shape).astype("float32")
    jnet = make(jgluon.nn)
    jnet.initialize()
    jnet(jnd.array(x))                  # deferred shapes
    _randomize(jnet, 2)
    tnet = make(mxt.gluon.nn)
    tnet.initialize(ctx=mxt.cpu())
    with mxt.cpu():
        tnet(tnd.array(x, ctx=mxt.cpu()))
    mxt.from_jax_params(tnet, {k: p.data() for k, p in
                               jnet._collect_params_with_prefix().items()})
    want_out, want_dx = _run(jnet, jnd, jautograd, x)
    got_out, got_dx = _run(tnet, tnd, tautograd, x, ctx=mxt.cpu())
    assert got_out.shape == want_out.shape
    _rel(got_out, want_out, "output")
    _rel(got_dx, want_dx, "input gradient")
    for k, p in jnet._collect_params_with_prefix().items():
        tp = tnet._collect_params_with_prefix()[k]
        assert tp.grad_req == p.grad_req, k
        ref = p.grad().asnumpy() if p.grad_req != "null" else \
            p.data().asnumpy()
        got = tp.grad().asnumpy() if tp.grad_req != "null" else \
            tp.data().asnumpy()
        _rel(got, ref, k)


def test_sync_batch_norm_is_batch_norm_on_one_device():
    """The same weights and batch: SyncBatchNorm and BatchNorm give the
    same output, gradients and running statistics bit for bit; with
    num_devices > 1 it is the same layer (it takes the global batch's
    statistics inside a data-parallel step: tests/test_torch_parallel.py)."""
    x = onp.random.RandomState(3).randn(4, 3, 5, 5).astype("float32")
    runs = []
    for cls in (mxt.gluon.nn.SyncBatchNorm, mxt.gluon.nn.BatchNorm):
        bn = cls(in_channels=3)
        bn.initialize(ctx=mxt.cpu())
        out, dx = _run(bn, tnd, tautograd, x, ctx=mxt.cpu())
        runs.append([out, dx] + [p.data().asnumpy() for p in
                                 bn.collect_params().values()])
    for a, b in zip(*runs):
        assert onp.array_equal(a, b)
    bn = mxt.gluon.nn.SyncBatchNorm(in_channels=3, num_devices=2)
    bn.initialize(ctx=mxt.cpu())
    out, dx = _run(bn, tnd, tautograd, x, ctx=mxt.cpu())
    assert onp.array_equal(out, runs[1][0]) and onp.array_equal(dx,
                                                                runs[1][1])


def _transposed_conv_numpy(x, w, stride, pad, adj, groups):
    """MXNet's Deconvolution by its definition: each input element scatters
    its kernel-weighted values into the output (2-D, dilation 1)."""
    n, cin, hi, wi = x.shape
    _, cout_g, kh, kw = w.shape
    cin_g = cin // groups
    ho = (hi - 1) * stride[0] - 2 * pad[0] + kh + adj[0]
    wo = (wi - 1) * stride[1] - 2 * pad[1] + kw + adj[1]
    full = onp.zeros((n, cout_g * groups, ho + 2 * pad[0] + kh,
                      wo + 2 * pad[1] + kw), "float64")
    for g in range(groups):
        for i in range(cin_g):
            ci = g * cin_g + i
            for a in range(hi):
                for b in range(wi):
                    full[:, g * cout_g:(g + 1) * cout_g,
                         a * stride[0]:a * stride[0] + kh,
                         b * stride[1]:b * stride[1] + kw] += \
                        x[:, ci, a, b][:, None, None, None] * w[ci][None]
    return full[:, :, pad[0]:pad[0] + ho, pad[1]:pad[1] + wo]


def test_grouped_transposed_convolution_against_its_definition():
    """num_group 2 with stride, pad and adj: the port equals a numpy loop
    of MXNet's definition (weight (in, out / groups, kh, kw)) within 1e-5;
    the JAX package raises (its IO layout takes the whole input channel
    count per group, a fault)."""
    rng = onp.random.RandomState(4)
    x = rng.randn(2, 4, 3, 4).astype("float32")
    w = rng.randn(4, 3, 3, 2).astype("float32")
    kw = dict(kernel=(3, 2), stride=(2, 3), pad=(1, 0), adj=(1, 2),
              num_filter=6, num_group=2, no_bias=True)
    want = _transposed_conv_numpy(x, w, (2, 3), (1, 0), (1, 2), 2)
    got = tnd.Deconvolution(torch.from_numpy(x), torch.from_numpy(w), None,
                            **kw).numpy()
    assert got.shape == want.shape
    _rel(got, want, "grouped transposed conv")
    ungrouped = tnd.Deconvolution(torch.from_numpy(x), torch.from_numpy(
        w[:, :3]), None, **dict(kw, num_filter=3, num_group=1)).numpy()
    _rel(ungrouped, _transposed_conv_numpy(x, w[:, :3], (2, 3), (1, 0),
                                           (1, 2), 1), "ungrouped")
    with pytest.raises(ValueError, match="feature_group_count"):
        jnd.Deconvolution(jnd.array(x), jnd.array(w), None, **kw)
    layer = mxt.gluon.nn.Conv2DTranspose(6, (3, 2), strides=(2, 3),
                                         padding=(1, 0),
                                         output_padding=(1, 2), groups=2,
                                         use_bias=False)
    layer.initialize(ctx=mxt.cpu())
    layer(torch.from_numpy(x))
    assert layer.weight.shape == (4, 3, 3, 2)
    layer.weight.set_data(w)
    _rel(layer(torch.from_numpy(x)).detach().numpy(), want, "the layer")


def test_transposed_convolution_target_shape():
    """A target_shape sets pad and adj so the output has that size, as
    MXNet's InferPad does (the JAX package ignores target_shape, a
    fault): equal to the explicit pad/adj MXNet derives."""
    rng = onp.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 4, 5, 5).astype("float32"))
    w = torch.from_numpy(rng.randn(4, 3, 3, 3).astype("float32"))
    # s·(i - 1) + k = 11: target 11 → pad 0, adj 0; target 10 → total 1,
    # adj 1, pad 1; target 12 would need a negative pad and is refused
    got = tnd.Deconvolution(x, w, None, kernel=(3, 3), stride=(2, 2),
                            num_filter=3, target_shape=(11, 10),
                            no_bias=True)
    assert got.shape == (1, 3, 11, 10)
    want = tnd.Deconvolution(x, w, None, kernel=(3, 3), stride=(2, 2),
                             num_filter=3, pad=(0, 1), adj=(0, 1),
                             no_bias=True)
    assert onp.array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="too big"):
        tnd.Deconvolution(x, w, None, kernel=(3, 3), stride=(2, 2),
                          num_filter=3, target_shape=(12, 12), no_bias=True)
    ref = jnd.Deconvolution(jnd.array(x.numpy()), jnd.array(w.numpy()), None,
                            kernel=(3, 3), stride=(2, 2), num_filter=3,
                            target_shape=(11, 10), no_bias=True)
    assert ref.shape == (1, 3, 11, 11)


@pytest.mark.parametrize("shape,kernel,stride", [
    ((2, 3, 9), (3,), (2,)), ((2, 3, 6, 7), (2, 3), (2, 2)),
    ((1, 2, 4, 5, 6), (2, 2, 3), (1, 2, 3))])
@pytest.mark.parametrize("p_value", [1, 2, 3])
def test_lp_pooling_on_one_to_three_axes(shape, kernel, stride, p_value):
    """(Σ|x|ᵖ)^(1/p) over each window, equal to the reference's forward and
    gradient."""
    x = onp.random.RandomState(6).uniform(0.1, 2, shape).astype("float32")

    def call(m, a):
        return m.Pooling(a, kernel=kernel, stride=stride, pool_type="lp",
                         p_value=p_value, pad=(1,) * len(kernel))
    want = _run(lambda a: call(jnd, a), jnd, jautograd, x)
    got = _run(lambda a: call(tnd, a), tnd, tautograd, x, ctx=mxt.cpu())
    _rel(got[0], want[0], "lp pooling")
    _rel(got[1], want[1], "lp pooling gradient")


@pytest.mark.parametrize("mode", ["edge", "reflect"])
@pytest.mark.parametrize("shape,pad_width", [
    ((3, 4), (1, 2, 0, 3)), ((2, 3, 5), (0, 0, 2, 1, 4, 4)),
    ((1, 2, 3, 4), (0, 0, 1, 0, 2, 2, 3, 1))])
def test_pad_edge_and_reflect_on_any_axis(mode, shape, pad_width):
    """Any axis, as jnp.pad pads (reflect past the far end included):
    forward and gradient equal the reference's."""
    x = onp.random.RandomState(7).randn(*shape).astype("float32")
    want = _run(lambda a: jnd.pad(a, mode=mode, pad_width=pad_width), jnd,
                jautograd, x)
    got = _run(lambda a: tnd.pad(a, mode=mode, pad_width=pad_width), tnd,
               tautograd, x, ctx=mxt.cpu())
    assert got[0].shape == want[0].shape
    _rel(got[0], want[0], "pad")
    _rel(got[1], want[1], "pad gradient")


# ---------------------------------------------------------- sharing

def _shared_pair(m):
    net = m.nn.HybridSequential()
    first = m.nn.Dense(4, in_units=4)
    net.add(first, m.nn.Dense(4, in_units=4, params=first.params))
    return net


def test_shared_parameters_update_once_and_save_under_both_names(tmp_path):
    """Two Dense layers sharing one weight and bias (params=): the JAX
    package's and the port's collect_params list each once, both files
    hold the same structural keys (the shared ones twice), and three SGD
    steps, each updating the shared parameters once with the sum of their
    uses' gradients, give the same weights within 1e-5."""
    jnet = _shared_pair(jgluon)
    jnet.initialize()
    _randomize(jnet, 8)
    tnet = _shared_pair(mxt.gluon)
    tnet.initialize(ctx=mxt.cpu())
    assert tnet[1].weight is tnet[0].weight
    mxt.from_jax_params(tnet, {k: p.data() for k, p in
                               jnet._collect_params_with_prefix().items()})
    assert len(jnet.collect_params()) == len(tnet.collect_params()) == 2
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1})
    ttr = mxt.gluon.Trainer(tnet.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    rng = onp.random.RandomState(9)
    for _ in range(3):
        x = rng.randn(5, 4).astype("float32")
        for net, m, ag, tr, ctx in ((jnet, jnd, jautograd, jtr, {}),
                                    (tnet, tnd, tautograd, ttr,
                                     dict(ctx=mxt.cpu()))):
            with ag.record():
                out = net(m.array(x, **ctx))
                loss = (out * out).sum()
            loss.backward()
            tr.step(5)
    for k, p in jnet._collect_params_with_prefix().items():
        _rel(tnet._collect_params_with_prefix()[k].data().asnumpy(),
             p.data().asnumpy(), k)
    jfile, tfile = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnet.save_parameters(jfile)
    tnet.save_parameters(tfile)
    assert sorted(jnd.load(jfile)) == sorted(tnd.load(tfile)) == [
        "0.bias", "0.weight", "1.bias", "1.weight"]
    fresh = _shared_pair(mxt.gluon)
    fresh.load_parameters(jfile, ctx=mxt.cpu())
    assert fresh[1].weight is fresh[0].weight
    _rel(fresh[0].weight.data().asnumpy(),
         jnet[0].weight.data().asnumpy(), "loaded")


def test_a_whole_tree_shared_through_collect_params():
    """params=net.collect_params() shares every parameter of a same-shaped
    tree, children added after construction included; an incompatible
    shape raises."""
    def make(params=None):
        net = mxt.gluon.nn.HybridSequential(params=params)
        net.add(mxt.gluon.nn.Dense(3, in_units=2),
                mxt.gluon.nn.BatchNorm(in_channels=3))
        return net
    a = make()
    b = make(a.collect_params())
    assert all(pa is pb for pa, pb in zip(a.collect_params().values(),
                                          b.collect_params().values()))
    a.initialize(ctx=mxt.cpu())
    x = torch.randn(4, 2)
    assert torch.equal(a(x), b(x))
    with pytest.raises(ValueError):
        mxt.gluon.nn.Dense(3, in_units=5, params=a[0].params)
    assert list(a.collect_params(".*weight")) == ["0.weight"]


# ------------------------------------------------------------------ hooks

def _hooked(m):
    net = m.nn.HybridSequential()
    net.add(m.nn.Dense(3, in_units=4), m.nn.Activation("tanh"))
    return net


def test_forward_hooks_see_the_callers_arguments_as_the_reference():
    """register_forward_pre_hook(hook(block, args)) and
    register_forward_hook(hook(block, args, out)) on a block and on a
    child: called in the same order with NDArrays of the same values as
    the JAX package's; detach() and the handle as a context manager take
    them off."""
    x = onp.random.RandomState(10).randn(2, 4).astype("float32")
    logs = []
    for m, nd_mod, ctx in ((jgluon, jnd, {}),
                           (mxt.gluon, tnd, dict(ctx=mxt.cpu()))):
        net = _hooked(m)
        net.initialize(**ctx)
        if m is jgluon:
            jw = {k: p.data() for k, p in
                  net._collect_params_with_prefix().items()}
        else:
            mxt.from_jax_params(net, jw)
        log = []

        def pre(block, args, _log=log):
            _log.append(("pre", type(block).__name__,
                         [type(a).__name__ for a in args],
                         [a.asnumpy() for a in args]))

        def post(block, args, out, _log=log):
            _log.append(("post", type(block).__name__, type(out).__name__,
                         out.asnumpy()))
        h1 = net.register_forward_pre_hook(pre)
        h2 = net[0].register_forward_hook(post)
        h3 = net.register_forward_hook(post)
        net(nd_mod.array(x, **ctx))
        h2.detach()
        net(nd_mod.array(x, **ctx))
        with net[1].register_forward_pre_hook(pre):
            net(nd_mod.array(x, **ctx))
        net(nd_mod.array(x, **ctx))
        for h in (h1, h3):
            h.detach()
        net(nd_mod.array(x, **ctx))
        logs.append(log)
    want, got = logs
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[2] == w[2], (g[:3], w[:3])
        for a, b in zip(g[-1] if isinstance(g[-1], list) else [g[-1]],
                        w[-1] if isinstance(w[-1], list) else [w[-1]]):
            _rel(a, b, "hooked value")


def test_hooks_of_a_hybridized_block_run_at_every_call():
    """MXNet runs a hybridized block's own hooks at every call; the JAX
    package's hybridized __call__ skips them (a fault): the port runs
    them, on the card and here. torch's own module hooks stay reachable
    and see tensors."""
    x = onp.random.RandomState(11).randn(2, 4).astype("float32")
    counts = {}
    for m, nd_mod, ctx in ((jgluon, jnd, {}),
                           (mxt.gluon, tnd, dict(ctx=mxt.cpu()))):
        net = _hooked(m)
        net.initialize(**ctx)
        net.hybridize()
        calls = []
        net.register_forward_hook(lambda b, a, o, _c=calls: _c.append(1))
        for _ in range(3):
            net(nd_mod.array(x, **ctx))
        counts[m] = len(calls)
    assert counts[jgluon] == 0 and counts[mxt.gluon] == 3
    net = _hooked(mxt.gluon)
    net.initialize(ctx=mxt.cpu())
    seen = []
    handle = torch.nn.Module.register_forward_hook(
        net, lambda mod, args, out: seen.append(type(out)))
    net(tnd.array(x, ctx=mxt.cpu()))
    handle.remove()
    assert seen == [torch.Tensor]


def test_apply_visits_children_then_the_block_as_the_reference():
    orders = []
    for m in (jgluon, mxt.gluon):
        net = m.nn.HybridSequential()
        inner = m.nn.HybridSequential()
        inner.add(m.nn.Dense(2, in_units=2), m.nn.ELU())
        net.add(inner, m.nn.Dense(1, in_units=2))
        seen = []
        assert net.apply(lambda b, _s=seen: _s.append(type(b).__name__)) \
            is net
        orders.append(seen)
    assert orders[0] == orders[1] == ["Dense", "ELU", "HybridSequential",
                                      "Dense", "HybridSequential"]


# --------------------------------------------------------------- Constant

VALUE = onp.array([[1.5, -2.0], [0.25, 3.0]], "float32")


def _const_block(m):
    class Scaled(m.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = m.nn.Dense(2, in_units=2)
            self.scale = self.params.get_constant("scale", VALUE)

        def forward(self, x):
            w = self.scale.data() if m is jgluon else self.scale._tensor()
            return m_dot(self.dense(x), w)
    m_dot = jnd.dot if m is jgluon else tnd.dot
    return Scaled()


def test_constant_parameter_keeps_its_value_and_round_trips(tmp_path):
    """gluon.Constant: grad_req "null", its value through any initialize
    (force_reinit with another initializer included) and a Trainer's step,
    and .params files both ways with the JAX package's (the key "scale"
    and the value bit for bit)."""
    jb = _const_block(jgluon)
    jb.initialize()
    tb = _const_block(mxt.gluon)
    tb.initialize(mxt.init.One(), ctx=mxt.cpu())
    tb.initialize(mxt.init.Uniform(), ctx=mxt.cpu(), force_reinit=True)
    assert tb.scale.grad_req == "null"
    assert onp.array_equal(tb.scale.data().asnumpy(), VALUE)
    jfile, tfile = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jb.save_parameters(jfile)
    tb.load_parameters(jfile)
    x = onp.random.RandomState(12).randn(3, 2).astype("float32")
    _rel(tb(tnd.array(x, ctx=mxt.cpu())).asnumpy(),
         jb(jnd.array(x)).asnumpy(), "forward")
    tr = mxt.gluon.Trainer(tb.collect_params(), "sgd", {"learning_rate": 1})
    with tautograd.record():
        loss = tb(tnd.array(x, ctx=mxt.cpu())).sum()
    loss.backward()
    tr.step(1)
    assert onp.array_equal(tb.scale.data().asnumpy(), VALUE)
    tb.save_parameters(tfile)
    loaded = jnd.load(tfile)
    assert sorted(loaded) == sorted(jnd.load(jfile)) == [
        "dense.bias", "dense.weight", "scale"]
    assert onp.array_equal(loaded["scale"].asnumpy(), VALUE)
    assert mxt.gluon.Constant("c", [1, 2]).dtype == \
        jgluon.Constant("c", [1, 2]).dtype


def test_symbol_block_and_export_wait_for_their_slices(tmp_path):
    """SymbolBlock came with the symbolic API (its parity tests are in
    test_torch_module.py). ``HybridBlock.export`` writes what the JAX
    package's writes: a block never called has no input signature, so
    its manifest names no artifact, and ``imports`` of such a manifest
    is refused in both packages (the served round trip is in
    tests/test_torch_export.py)."""
    import json
    d = mxt.sym.var("data")
    blk = mxt.gluon.SymbolBlock(mxt.sym.FullyConnected(d, num_hidden=2,
                                                       name="fc"), d)
    assert sorted(blk.collect_params()) == ["fc_bias", "fc_weight"]
    manifest = tmp_path / "net-symbol.json"
    manifest.write_text('{"format": "incubator_mxnet_tpu.hybrid"}')
    for pkg in (mxt, mx):
        with pytest.raises(ValueError, match="without a serving artifact"):
            pkg.gluon.SymbolBlock.imports(str(manifest), ["data"])
    port = mxt.gluon.nn.Dense(2, in_units=2)
    port.initialize(ctx=mxt.cpu())
    port.export(str(tmp_path / "port"))
    ref = jgluon.nn.Dense(2, in_units=2)
    ref.initialize()
    ref.export(str(tmp_path / "ref"))
    for name in ("port", "ref"):
        assert (tmp_path / ("%s-0000.params" % name)).exists()
        assert not (tmp_path / ("%s.mxtpu" % name)).exists()
    got = json.loads((tmp_path / "port-symbol.json").read_text())
    want = json.loads((tmp_path / "ref-symbol.json").read_text())
    assert got == want == {"format": "incubator_mxnet_tpu.hybrid",
                           "class": "Dense", "artifact": None}
    assert sorted(mxt.nd.load(str(tmp_path / "port-0000.params"))) == \
        sorted(mx.nd.load(str(tmp_path / "ref-0000.params")))


def test_clip_passes_the_gradient_at_its_bounds_as_mxnet():
    """MXNet's clip passes the gradient where x equals a bound (its
    backward keeps a_min <= x <= a_max), and so does the port; the JAX
    package's jnp.clip passes half of it there (a fault, ROADMAP.md §3),
    which MobileNet's ReLU6 meets at the exact zeros of a zero input
    patch."""
    x = onp.array([-1.0, 0.0, 3.0, 6.0, 7.0], "float32")
    grads = []
    for m, ag, ctx in ((jnd, jautograd, {}),
                       (tnd, tautograd, dict(ctx=mxt.cpu()))):
        a = m.array(x, **ctx)
        a.attach_grad()
        with ag.record():
            y = m.clip(a, 0, 6)
        y.backward()
        grads.append(a.grad.asnumpy())
    assert list(grads[1]) == [0, 1, 1, 1, 0]
    assert list(grads[0]) == [0, 0.5, 1, 0.5, 0]
