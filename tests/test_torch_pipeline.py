"""The port's pipelines against the JAX package's, on the CPU.

``pipeline_spmd`` (GPipe ring, forward and gradients through the ring),
``pipeline_1f1b_grads`` and ``pipeline_interleaved_grads`` (loss, stage
gradients, input gradients) against the JAX package's on the same numpy
weights; the host-side schedule tables equal the JAX package's;
``PipelineStack`` forward and a data x pipeline ``TrainStep`` against the
sequential stack and the JAX package's. The port's meshes are
``[cpu] * n``. Tolerances: 1e-5 relative on losses, 1e-4 relative on
gradients (the JAX package's own), 1e-4 / 1e-5 on outputs.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import jit as jjit
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu.parallel import pipeline_interleaved as jpi

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch.parallel import pipeline_interleaved as tpi

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _reset_meshes():
    yield
    tpar.set_current_mesh(None)
    jpar.set_current_mesh(None)


def _rel(a, b):
    a, b = onp.asarray(a), onp.asarray(b)
    return float(onp.abs(a - b).max() / (onp.abs(b).max() + 1e-9))


def test_pipeline_spmd_forward_and_ring_gradients_match_jax():
    """8 tanh stages over pp = 8, then 4 over a dp x pp mesh with the
    microbatch dim over dp: outputs and the gradient of sum(y²) in the
    stacked weights, against the JAX package's and the sequential stack."""
    rng = onp.random.RandomState(1)
    Ws = (rng.randn(8, 16, 16) * 0.1).astype("float32")
    X = rng.randn(32, 16).astype("float32")
    jmesh = jpar.make_mesh({"pp": 8})
    want = jpar.pipeline_spmd(lambda W, x: jnp.tanh(x @ W), jnp.asarray(Ws),
                              jnp.asarray(X), jmesh, n_microbatches=8)
    tmesh = tpar.make_mesh({"pp": 8}, devices=CPU8)
    got = tpar.pipeline_spmd(lambda W, x: torch.tanh(x @ W),
                             torch.tensor(Ws), torch.tensor(X), tmesh,
                             n_microbatches=8)
    seq = torch.tensor(X)
    for i in range(8):
        seq = torch.tanh(seq @ torch.tensor(Ws[i]))
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), rtol=1e-4,
                                atol=1e-5)
    onp.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-4,
                                atol=1e-5)

    Ws4 = (rng.randn(4, 8, 8) * 0.3).astype("float32")
    X8 = rng.randn(8, 8).astype("float32")
    jmesh = jpar.make_mesh({"dp": 2, "pp": 4})

    def jloss(W):
        y = jpar.pipeline_spmd(lambda W, x: jnp.tanh(x @ W), W,
                               jnp.asarray(X8), jmesh, n_microbatches=4,
                               data_axis="dp")
        return jnp.sum(y ** 2)
    jg = jax.grad(jloss)(jnp.asarray(Ws4))
    tmesh = tpar.make_mesh({"dp": 2, "pp": 4}, devices=CPU8)
    W = torch.tensor(Ws4, requires_grad=True)
    y = tpar.pipeline_spmd(lambda W, x: torch.tanh(x @ W), W,
                           torch.tensor(X8), tmesh, n_microbatches=4,
                           data_axis="dp")
    (tg,) = torch.autograd.grad((y ** 2).sum(), W)
    assert _rel(tg.numpy(), jg) < 1e-4


def test_pipeline_spmd_validates_and_gives_each_stage_a_generator():
    mesh = tpar.make_mesh({"pp": 4}, devices=CPU8[:4])
    with pytest.raises(ValueError, match="leading dim"):
        tpar.pipeline_spmd(lambda W, x: x, torch.zeros(2, 3), torch.zeros(
            4, 3), mesh, 2)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.pipeline_spmd(lambda W, x: x, torch.zeros(4, 3), torch.zeros(
            5, 3), mesh, 2)
    seen = []

    def stage(W, x, gen):
        seen.append(gen.initial_seed())
        return x + torch.rand(x.shape, generator=gen)
    out = tpar.pipeline_spmd(stage, torch.zeros(4, 3), torch.zeros(8, 3),
                             mesh, 4, key=7)
    assert out.shape == (8, 3)
    assert len(seen) == 16 and len(set(seen)) == 16
    again = tpar.pipeline_spmd(stage, torch.zeros(4, 3), torch.zeros(8, 3),
                               mesh, 4, key=7)
    assert torch.equal(out, again)


def _stage_fn(lib):
    tanh = jnp.tanh if lib == "jax" else torch.tanh

    def stage_fn(par, h):
        return tanh(h @ par["w"] + par["b"])
    return stage_fn


def test_pipeline_1f1b_matches_jax_and_gpipe():
    p, D, m, mb = 8, 8, 16, 2
    rng = onp.random.RandomState(5)
    W = (rng.randn(p, D, D) * 0.3).astype("float32")
    b = (rng.randn(p, D) * 0.1).astype("float32")
    x = rng.randn(m * mb, D).astype("float32")
    y = rng.randn(m * mb, D).astype("float32")
    jl, jg, jdx = jpar.pipeline_1f1b_grads(
        _stage_fn("jax"), lambda o, t: jnp.sum((o - t) ** 2),
        {"w": jnp.asarray(W), "b": jnp.asarray(b)}, jnp.asarray(x),
        jnp.asarray(y), jpar.make_mesh({"pp": 8}), n_microbatches=m)
    tmesh = tpar.make_mesh({"pp": 8}, devices=CPU8)

    def tloss(o, t):
        return ((o - t) ** 2).sum()
    tl, tg, tdx = tpar.pipeline_1f1b_grads(
        _stage_fn("torch"), tloss, {"w": torch.tensor(W),
                                    "b": torch.tensor(b)},
        torch.tensor(x), torch.tensor(y), tmesh, n_microbatches=m)
    assert abs(float(tl) - float(jl)) / abs(float(jl)) < 1e-5
    for k in ("w", "b"):
        assert tg[k].shape == W.shape[:1] + jg[k].shape[1:]
        assert _rel(tg[k].numpy(), jg[k]) < 1e-4, k
    assert _rel(tdx.numpy(), jdx) < 1e-4
    # the GPipe ring under autograd gives the same gradients (times m)
    params = {"w": torch.tensor(W, requires_grad=True),
              "b": torch.tensor(b, requires_grad=True)}
    xt = torch.tensor(x, requires_grad=True)
    out = tpar.pipeline_spmd(_stage_fn("torch"), params, xt, tmesh,
                             n_microbatches=m)
    loss = sum(tloss(o, t) for o, t in zip(out.reshape(m, mb, D),
                                            torch.tensor(y).reshape(m, mb,
                                                                    D))) / m
    gw, gb, gx = torch.autograd.grad(loss, [params["w"], params["b"], xt])
    assert abs(float(loss) - float(tl)) / abs(float(tl)) < 1e-5
    assert _rel(tg["w"].numpy() / m, gw.numpy()) < 1e-4
    assert _rel(tg["b"].numpy() / m, gb.numpy()) < 1e-4
    assert _rel(tdx.numpy() / m, gx.numpy()) < 1e-4


def test_pipeline_interleaved_matches_jax():
    p, v, D, m, mb = 4, 2, 8, 8, 2
    V = v * p
    rng = onp.random.RandomState(7)
    W = (rng.randn(V, D, D) * 0.3).astype("float32")
    b = (rng.randn(V, D) * 0.1).astype("float32")
    x = rng.randn(m * mb, D).astype("float32")
    y = rng.randn(m * mb, D).astype("float32")
    from jax.sharding import Mesh
    jmesh = Mesh(onp.array(jax.devices()[:4]), ("pp",))

    def jstage(par, h):
        return jnp.tanh(h @ par[0] + par[1])
    jl, jg, jdx = jpi.pipeline_interleaved_grads(
        jstage, lambda o, t: jnp.sum((o - t) ** 2),
        (jnp.asarray(W.reshape(v, p, D, D)), jnp.asarray(b.reshape(v, p, D))),
        jnp.asarray(x), jnp.asarray(y), jmesh, n_microbatches=m, v=v)
    tmesh = tpar.make_mesh({"pp": 4}, devices=CPU8[:4])

    def tstage(par, h):
        return torch.tanh(h @ par[0] + par[1])
    tl, tg, tdx = tpar.pipeline_interleaved_grads(
        tstage, lambda o, t: ((o - t) ** 2).sum(),
        (torch.tensor(W.reshape(v, p, D, D)),
         torch.tensor(b.reshape(v, p, D))),
        torch.tensor(x), torch.tensor(y), tmesh, n_microbatches=m, v=v)
    assert abs(float(tl) - float(jl)) / abs(float(jl)) < 1e-5
    for a, want in zip(tg, jg):
        assert tuple(a.shape) == tuple(want.shape)
        assert _rel(a.numpy(), want) < 1e-4
    assert _rel(tdx.numpy(), jdx) < 1e-4
    with pytest.raises(ValueError, match="leading dims"):
        tpar.pipeline_interleaved_grads(
            tstage, None, (torch.zeros(4, 2, D, D), torch.zeros(4, 2, D)),
            torch.tensor(x), torch.tensor(y), tmesh, m, v)


@pytest.mark.parametrize("m,p,v", [(8, 4, 2), (16, 4, 2), (6, 3, 1),
                                   (4, 2, 3)])
def test_schedules_equal_the_jax_packages(m, p, v):
    ticks = tpi.interleaved_schedule(m, p, v)
    assert ticks == jpi.interleaved_schedule(m, p, v)
    assert tpi.schedule_1f1b(m, p) == jpi.schedule_1f1b(m, p)
    assert tpi.schedule_gpipe(m, p) == jpi.schedule_gpipe(m, p)
    assert tpi.schedule_stats(ticks, p) == jpi.schedule_stats(ticks, p)
    assert tpi._stash_bound(ticks, p, v, m) == jpi._stash_bound(ticks, p, v,
                                                                m)
    for a, b in zip(tpi._tables(ticks, p, v, m), jpi._tables(ticks, p, v, m)):
        assert onp.array_equal(a, b)


def _ffn_stage(pkg, dim, hidden):
    class FFNStage(pkg.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            nn = pkg.gluon.nn
            if hasattr(self, "name_scope"):
                with self.name_scope():
                    self._make(nn)
            else:
                self._make(nn)

        def _make(self, nn):
            self.norm = nn.LayerNorm(in_channels=dim)
            self.fc1 = nn.Dense(hidden, activation="relu", in_units=dim,
                                flatten=False)
            self.fc2 = nn.Dense(dim, in_units=hidden, flatten=False)

        def forward(self, x):
            return x + self.fc2(self.fc1(self.norm(x)))
    return FFNStage()


def _lms(jmesh, tmesh, n_stages=4, vocab=32, dim=16):
    """The JAX package's embed -> PipelineStack -> head and the port's,
    from one set of weights, and the port's blocks."""
    nets = []
    for pkg, par, mesh in ((mx, jpar, jmesh), (mxt, tpar, tmesh)):
        mx.random.seed(5)
        embed = pkg.gluon.nn.Embedding(vocab, dim)
        stages = [_ffn_stage(pkg, dim, 2 * dim) for _ in range(n_stages)]
        trunk = par.PipelineStack(stages, mesh, n_microbatches=4,
                                  data_axis="dp")
        head = pkg.gluon.nn.Dense(vocab, in_units=dim, flatten=False)
        net = pkg.gluon.nn.HybridSequential()
        net.add(embed, trunk, head)
        if pkg is mx:
            net.initialize(mx.init.Xavier())
        else:
            net.initialize(ctx=mxt.cpu())
        nets.append((net, (embed, stages, head)))
    (jnet, _), (tnet, parts) = nets
    mxt.from_jax_params(tnet, jnet)
    return jnet, tnet, parts


def test_pipeline_stack_forward_matches_sequential_and_jax():
    jmesh = jpar.make_mesh({"dp": 2, "pp": 4})
    tmesh = tpar.make_mesh({"dp": 2, "pp": 4}, devices=CPU8)
    jnet, tnet, (embed, stages, head) = _lms(jmesh, tmesh)
    tok = onp.random.RandomState(0).randint(0, 32, (8, 6)).astype("int32")
    ref = jnet(jnd.array(tok, dtype="int32")).asnumpy()
    out = tnet(torch.tensor(tok))
    h = embed(torch.tensor(tok))
    for s in stages:
        h = s(h)
    seq = head(h)
    onp.testing.assert_allclose(out.detach().numpy(), seq.detach().numpy(),
                                rtol=1e-4, atol=1e-5)
    onp.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                                atol=1e-5)


def test_pipeline_stack_train_step_matches_sequential_and_jax():
    """Three SGD steps of embed -> PipelineStack -> head through TrainStep
    over the dp x pp mesh (batch over dp, ring over pp) against the same
    blocks in a plain HybridSequential on one device and the JAX package's
    TrainStep over its mesh."""
    rng = onp.random.RandomState(1)
    tok = rng.randint(0, 32, (8, 6)).astype("int32")
    lab = rng.randint(0, 32, (8, 6)).astype("int32")
    jmesh = jpar.make_mesh({"dp": 2, "pp": 4})
    tmesh = tpar.make_mesh({"dp": 2, "pp": 4}, devices=CPU8)
    jnet, tnet, (embed, stages, head) = _lms(jmesh, tmesh)
    _, tseq_src, _ = _lms(jmesh, tmesh)
    seq = mxt.gluon.nn.HybridSequential()
    e2, s2, h2 = tseq_src[0], tseq_src[1].stages, tseq_src[2]
    seq.add(e2, *s2, h2)

    def losses(step, arrays):
        return [float(step(*arrays).asnumpy().mean()) for _ in range(3)]
    jl = losses(jjit.TrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                               jgluon.Trainer(jnet.collect_params(), "sgd",
                                              {"learning_rate": 0.1}),
                               mesh=jmesh),
                (jnd.array(tok, dtype="int32"), jnd.array(lab,
                                                          dtype="int32")))
    tloss = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    tl = losses(mxt.jit.TrainStep(tnet, tloss, mxt.gluon.Trainer(
        tnet.collect_params(), "sgd", {"learning_rate": 0.1}), mesh=tmesh),
        (tok, lab))
    sl = losses(mxt.jit.TrainStep(seq, tloss, mxt.gluon.Trainer(
        seq.collect_params(), "sgd", {"learning_rate": 0.1})), (tok, lab))
    onp.testing.assert_allclose(tl, sl, rtol=1e-4, atol=1e-5)
    onp.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    assert tl[-1] < tl[0]


def test_pipeline_stack_refuses_batch_norm_and_unlike_stages():
    mesh = tpar.make_mesh({"pp": 2}, devices=CPU8[:2])
    nn = mxt.gluon.nn

    def bn_stage():
        s = nn.HybridSequential()
        s.add(nn.Dense(4, in_units=4), nn.BatchNorm(in_channels=4))
        return s
    stack = tpar.PipelineStack([bn_stage(), bn_stage()], mesh)
    stack.initialize(ctx=mxt.cpu())
    with pytest.raises(ValueError, match="BatchNorm"):
        stack(torch.zeros(2, 4))
    stack = tpar.PipelineStack([nn.Dense(4, in_units=4),
                                nn.Dense(4, in_units=4, use_bias=False)],
                               mesh)
    stack.initialize(ctx=mxt.cpu())
    with pytest.raises(ValueError, match="structurally identical"):
        stack(torch.zeros(2, 4))
