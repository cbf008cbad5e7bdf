"""The port's MoELayer against the JAX package's, on the CPU.

Both routings (dense, capacity 1.25 with dropping), the auxiliary loss
(Switch load balancing + z-loss) and the gradients of the output and the
loss in x and the three weights, from one set of weights carried by
``from_jax_params``; the port's layer runs over an 8-position ``ep`` mesh
(each position its experts' share, summed) and on one device. Tolerance:
1e-5 absolute / 1e-4 relative on values, 1e-4 relative on gradients
(float32; the sums run in another order).
"""
import warnings

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import parallel as jpar

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch.parallel import compat

CPU8 = [torch.device("cpu")] * 8
E, D, H = 8, 16, 32


@pytest.fixture(autouse=True)
def _reset_meshes():
    yield
    tpar.set_current_mesh(None)


def _pair(capacity_factor, activation="relu"):
    kw = dict(num_experts=E, hidden_size=D, ffn_hidden=H, top_k=2,
              capacity_factor=capacity_factor, activation=activation)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jl = jpar.MoELayer(**kw)
        tl = tpar.MoELayer(**kw)
    mx.random.seed(1)
    jl.initialize(mx.init.Xavier())
    tl.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tl, jl)
    return jl, tl


def _rel(a, b):
    return float(onp.abs(a - b).max() / max(onp.abs(b).max(), 1e-30))


@pytest.mark.parametrize("capacity_factor", [None, 1.25])
@pytest.mark.parametrize("ep", [8, 1])
def test_moe_output_aux_and_gradients_match_jax(capacity_factor, ep):
    jl, tl = _pair(capacity_factor, "gelu" if capacity_factor else "relu")
    x = onp.random.RandomState(2).randn(4, 16, D).astype("float32")
    jw = [jnp.asarray(p.data().asnumpy())
          for p in (jl.gate_weight, jl.w1, jl.w2)]

    def jloss(xd, gw, w1, w2):
        out, aux = jl._fn(xd, gw, w1, w2, compute_aux=True)
        return jnp.sum(jnp.sin(out)) + aux, (out, aux)
    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, (0, 1, 2, 3), has_aux=True))(jnp.asarray(x), *jw)

    tpar.make_mesh({"ep": ep}, devices=CPU8[:ep])
    tx = torch.tensor(x, requires_grad=True)
    tout, taux = tl.forward_with_aux(tx)
    params = [tl.gate_weight._tensor(), tl.w1._tensor(), tl.w2._tensor()]
    tg = torch.autograd.grad(tout.sin().sum() + taux, [tx] + params)
    onp.testing.assert_allclose(tout.detach().numpy(), onp.asarray(jout),
                                rtol=1e-4, atol=1e-5)
    onp.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    for a, b in zip(tg, jg):
        assert _rel(a.numpy(), onp.asarray(b)) <= 1e-4
    assert torch.equal(tl(torch.tensor(x)).detach(), tout.detach())


def test_moe_losses_and_capacity_dropping_match_jax():
    g = onp.random.RandomState(3).rand(32, E).astype("float32")
    g /= g.sum(-1, keepdims=True)
    logits = onp.random.RandomState(4).randn(32, E).astype("float32")
    idx = onp.argsort(-g, -1)[:, :2].astype("int32")
    onp.testing.assert_allclose(
        float(tpar.load_balancing_loss(torch.tensor(g), torch.tensor(idx),
                                       E)),
        float(jpar.load_balancing_loss(jnp.asarray(g), jnp.asarray(idx), E)),
        rtol=1e-6)
    onp.testing.assert_allclose(
        float(tpar.router_z_loss(torch.tensor(logits))),
        float(jpar.router_z_loss(jnp.asarray(logits))), rtol=1e-6)
    # a tight capacity drops tokens exactly where the JAX dispatch does
    jl, tl = _pair(0.25)
    x = onp.random.RandomState(5).randn(64, D).astype("float32")
    ref = jl(jnd.array(x)).asnumpy()
    got = tl(torch.tensor(x)).detach().numpy()
    onp.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert (onp.abs(ref).sum(-1) == 0).any()      # some tokens dropped


def test_moe_warns_on_dense_dispatch_at_eight_experts():
    with pytest.warns(UserWarning, match="capacity_factor"):
        tpar.MoELayer(8, D, H)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tpar.MoELayer(4, D, H)
        tpar.MoELayer(8, D, H, capacity_factor=1.25)
    layer = tpar.MoELayer(4, D, H, ep_axis="ep")
    P = tpar.mesh.P
    assert layer.w1.sharding == P("ep", None, None)
    assert layer.w2.sharding == P("ep", None, None)
    assert layer.gate_weight.sharding is None


def test_moe_in_a_data_parallel_step_over_dp_x_ep():
    """An MoE layer between two Dense layers, three SGD steps through
    DataParallelTrainStep over a dp = 2 x ep = 4 mesh (each dp position
    splits its experts over ep; the capacity leaves no token out) against
    TrainStep on one device with no mesh."""
    runs = []
    for split in (False, True):
        tpar.set_current_mesh(None)
        mesh = tpar.make_mesh({"dp": 2, "ep": 4}, devices=CPU8) \
            if split else None
        net = mxt.gluon.nn.HybridSequential()
        net.add(mxt.gluon.nn.Dense(D, in_units=8, flatten=False),
                tpar.MoELayer(E, D, H, top_k=2, capacity_factor=2.0),
                mxt.gluon.nn.Dense(4, in_units=D, flatten=False))
        net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                       generator=torch.Generator().manual_seed(3))
        tr = mxt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        loss = mxt.gluon.loss.L2Loss()
        step = mxt.jit.TrainStep(net, loss, tr) if mesh is None else \
            tpar.DataParallelTrainStep(net, loss, tr, mesh=mesh)
        rng = onp.random.RandomState(4)
        x = rng.randn(8, 6, 8).astype("float32")
        y = rng.randn(8, 6, 4).astype("float32")
        mapped, losses = compat.tracking(
            lambda: [step(x, y).asnumpy() for _ in range(3)])
        # a step: the dp split, then each dp position's ep split
        assert mapped == (3 * (1 + 2) if split else 0)
        runs.append((losses, mxt.to_numpy_params(net)))
    (l0, p0), (l1, p1) = runs
    for a, b in zip(l1, l0):
        onp.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    for k in p0:
        onp.testing.assert_allclose(p1[k], p0[k], rtol=1e-4, atol=1e-5)
