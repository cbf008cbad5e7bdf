"""The port's sequence parallelism against the JAX package's, on the CPU.

Ring and Ulysses attention on an 8-position mesh (the port's mesh is
``[cpu] * 8``, the JAX package's its 8 forced host devices), from numpy
inputs made from a seed; the JAX calls are jitted and run their flash path
as the JAX package's own tests do (``MXTPU_FLASH_INTERPRET=1``). Head width
64 takes the port's kernel route (the kernels' plain versions on the CPU),
16 its composite. Tolerances are the JAX package's own
(``tests/test_parallel.py``): forward max-abs 2e-4, gradients relative
1e-3. Then the models with ``attention="ring"|"ulysses"`` and ``tp_axis``,
and the launch counts of the causal and full rings.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import parallel as jpar

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import models as tmodels
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch.ops import attention as tattn

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _interpret_and_reset(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_INTERPRET", "1")
    yield
    tpar.set_current_mesh(None)
    jpar.set_current_mesh(None)


def _meshes(axes):
    return (jpar.make_mesh(axes),
            tpar.make_mesh(axes, devices=CPU8))


def _qkv(shape, seed):
    rng = onp.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.3).astype("float32") for _ in range(3)]


def _rel(a, b):
    return float(onp.abs(a - b).max() / onp.abs(b).max())


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 16])
def test_sequence_parallel_attention_matches_jax(kind, causal, D):
    """Forward and the gradients of sum(sin(out)) in q, k and v."""
    jmesh, tmesh = _meshes({"sp": 8})
    shape = (1, 8, 256, D)
    q, k, v = _qkv(shape, seed=D + causal)
    jfn = getattr(jpar, kind + "_attention")
    tfn = getattr(tpar, kind + "_attention")

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jfn(q, k, v, mesh=jmesh, causal=causal)))
    jout = jax.jit(lambda q, k, v: jfn(q, k, v, mesh=jmesh,
                                      causal=causal))(q, k, v)
    jgrads = jax.jit(jax.grad(jloss, (0, 1, 2)))(q, k, v)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = tfn(tq, tk, tv, mesh=tmesh, causal=causal)
    tgrads = torch.autograd.grad(tout.sin().sum(), (tq, tk, tv))
    assert tout.shape == shape
    assert float(onp.abs(tout.detach().numpy() - onp.asarray(jout)).max()) \
        <= 2e-4
    for a, b in zip(tgrads, jgrads):
        assert _rel(a.numpy(), onp.asarray(b)) <= 1e-3


@pytest.mark.parametrize("causal,want", [(True, 4 + 6), (False, 16)])
def test_ring_launches_k1_k2_k3_per_static_schedule(monkeypatch, causal,
                                                    want):
    """A causal ring over n = 4 positions runs the kernel route n +
    n(n-1)/2 times (positions whose source is later launch nothing), a full
    ring n² times; the backward as often (K2 and K3 each)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tattn._fa_call, tattn._fa_bwd_call

    def count_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)
    monkeypatch.setattr(tattn, "_fa_call", count_fwd)
    monkeypatch.setattr(tattn, "_fa_bwd_call", count_bwd)
    mesh = tpar.make_mesh({"sp": 4}, devices=CPU8[:4])
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _qkv((1, 2, 256, 64), seed=3))
    out = tpar.ring_attention(q, k, v, mesh=mesh, causal=causal)
    assert calls["fwd"] == want
    out.sum().backward()
    assert calls["bwd"] == want
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_ulysses_refuses_heads_that_do_not_divide():
    mesh = tpar.make_mesh({"sp": 8}, devices=CPU8)
    q = torch.zeros(1, 4, 64, 16)
    with pytest.raises(ValueError, match="num_heads 4 not divisible"):
        tpar.ulysses_attention(q, q, q, mesh=mesh)


def test_combine_keeps_nan_out_of_empty_partials():
    """The merge of a partial with the empty one (0, -inf, 0) is the
    partial, and its gradient is finite (the JAX ``_combine`` rules)."""
    import importlib
    r = importlib.import_module(
        "incubator_mxnet_tpu_torch.parallel.ring_attention")
    o = torch.randn(1, 1, 4, 8, requires_grad=True)
    m = torch.randn(1, 1, 4, 1, requires_grad=True)
    l = torch.rand(1, 1, 4, 1) + 1.0
    e = (torch.zeros_like(o), torch.full_like(m, -float("inf")),
         torch.zeros_like(l))
    for args in ((o, m, l) + e, e + (o, m, l)):
        oo, mm, ll = r._combine(*args)
        assert torch.equal(oo, o) and torch.equal(mm, m)
        oo.sum().backward()
        assert torch.isfinite(o.grad).all() and torch.isfinite(m.grad).all()
        o.grad = m.grad = None
    oo, mm, ll = r._combine(*e, *e)
    assert torch.equal(oo, e[0]) and torch.equal(ll, e[2])


def _pair(kind, attention, tp_axis=None, units=128, heads=8):
    kw = dict(vocab_size=97, units=units, num_layers=2, num_heads=heads,
              max_length=256, attention=attention, tp_axis=tp_axis)
    if kind == "bert":
        kw.update(hidden_size=2 * units, dropout=0.0)
        jnet, tnet = jmodels.BERTModel(**kw), tmodels.BERTModel(**kw)
    else:
        jnet, tnet = jmodels.GPTModel(**kw), tmodels.GPTModel(**kw)
    mx.random.seed(0)
    jnet.initialize(mx.init.Xavier())
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tnet.initialize(mxt.init.Zero(), ctx=mxt.cpu())
    mxt.from_jax_params(tnet, arrays)
    return jnet, tnet


@pytest.mark.parametrize("kind", ["bert", "gpt"])
@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_models_with_sequence_parallel_attention_match_jax(kind, attention):
    """The port's model with ``attention=`` ring or Ulysses over the
    current ``sp`` mesh against the JAX package's with flash attention
    (the same function: eager, the JAX ring refuses arrays that live on one
    device, and its own tests never run a model through it), from one set
    of weights: logits within 1e-4 (the models' own tolerance in
    test_torch_models.py)."""
    jnet, _ = _pair(kind, "flash")
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tnet = _pair(kind, attention)[1]
    mxt.from_jax_params(tnet, arrays)
    tpar.make_mesh({"sp": 8}, devices=CPU8)
    tok = onp.random.RandomState(1).randint(0, 97, (2, 256)).astype("int32")
    ref = jnet(jnd.array(tok)).asnumpy()
    got = mxt.jit.EvalStep(tnet)(tok).asnumpy()
    onp.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["bert", "gpt"])
def test_models_with_tp_axis_match_jax(kind):
    """``tp_axis="tp"`` annotates the JAX package's split (q, k, v and the
    first FFN column parallel; proj and the second row parallel); the
    port's forward over a dp x tp mesh computes those layers per shard and
    matches the JAX model's forward."""
    jnet, tnet = _pair(kind, "flash", tp_axis="tp")
    assert tnet.encoder.layers[0].attention_cell.query.weight.sharding == \
        tpar.mesh.P("tp", None) if kind == "bert" else True
    _meshes({"dp": 2, "tp": 4})
    tok = onp.random.RandomState(2).randint(0, 97, (2, 256)).astype("int32")
    ref = jnet(jnd.array(tok)).asnumpy()
    got = mxt.jit.EvalStep(tnet)(tok).asnumpy()
    onp.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_gpt_train_step_with_sequence_parallel_attention_equals_flash(
        attention):
    """Two SGD steps of a small GPT (FeaturesView + ChunkedLMLoss) with
    ``attention`` over an sp = 4 mesh against the same model with flash on
    one device: losses and parameters within 1e-4 relative."""
    from incubator_mxnet_tpu_torch.models.gpt import (ChunkedLMLoss,
                                                      FeaturesView)
    tpar.make_mesh({"sp": 4}, devices=CPU8[:4])
    tok = onp.random.RandomState(3).randint(0, 97, (1, 256)).astype("int32")
    lab = onp.random.RandomState(4).randint(0, 97, (1, 256)).astype("int32")
    runs = []
    for att in ("flash", attention):
        net = tmodels.GPTModel(vocab_size=97, units=128, num_layers=2,
                               num_heads=4, max_length=256, attention=att)
        net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                       generator=torch.Generator().manual_seed(0))
        tr = mxt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5})
        step = mxt.jit.TrainStep(FeaturesView(net), ChunkedLMLoss(net), tr)
        losses = [step(tok, lab).asnumpy() for _ in range(2)]
        runs.append((losses, [p.data().asnumpy() for p in
                              net.collect_params().values()]))
    (l0, p0), (l1, p1) = runs
    onp.testing.assert_allclose(l1, l0, rtol=1e-4, atol=1e-5)
    for a, b in zip(p1, p0):
        onp.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_train_step_runs_a_shard_map_step_uncaptured(monkeypatch):
    """TrainStep's captured path (through the CPU stand-in for the graph)
    runs a step whose forward goes through shard_map once eagerly, keeps
    that answer, captures nothing and runs the signature eagerly from then
    on, out of ``aot.CACHE`` and with no stats; the losses equal the flash
    model's."""
    from test_torch_jit import _cpu_capture
    from incubator_mxnet_tpu_torch.models.gpt import (ChunkedLMLoss,
                                                      FeaturesView)
    tpar.make_mesh({"sp": 4}, devices=CPU8[:4])
    tok = onp.random.RandomState(5).randint(0, 97, (1, 256)).astype("int32")
    losses = []
    for att in ("flash", "ring"):
        net = tmodels.GPTModel(vocab_size=97, units=128, num_layers=1,
                               num_heads=2, max_length=256, attention=att)
        net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                       generator=torch.Generator().manual_seed(0))
        tr = mxt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5})
        step = mxt.jit.TrainStep(FeaturesView(net), ChunkedLMLoss(net), tr)
        monkeypatch.setattr(mxt.jit, "_GraphCapture", _cpu_capture(step))
        args = step._prepare((tok, tok), 1)
        got = [step._replay(args, 1, 1).numpy()]
        if att == "ring":
            assert step.captures == 0 and len(step._uncaptured) == 1
            got.append(step(tok, tok).asnumpy())
            assert not [k for k in mxt.aot.CACHE.keys()
                        if step._token in k.extra]
            assert step._last_stats is None
        else:
            assert step.captures == 1
            got.append(step._replay(args, 1, 1).numpy())
        losses.append(got)
    onp.testing.assert_allclose(losses[1], losses[0], rtol=1e-4, atol=1e-5)


def test_eval_step_and_hybridize_run_a_shard_map_forward_eagerly(
        monkeypatch):
    """EvalStep's captured path (the aot tests' CPU stand-in) and a
    hybridized block (the hybridize tests' stand-in) give a forward that
    runs shard_map no graph: its first call answers eagerly and later
    calls run it again, equal to the flash model's forward."""
    import test_torch_aot
    import test_torch_hybridize
    from incubator_mxnet_tpu_torch.gluon import _functional
    tpar.make_mesh({"sp": 4}, devices=CPU8[:4])
    tok = torch.tensor(onp.random.RandomState(6).randint(
        0, 97, (1, 256)).astype("int32"))
    nets = {}
    for att in ("flash", "ring"):
        net = tmodels.GPTModel(vocab_size=97, units=128, num_layers=1,
                               num_heads=2, max_length=256, attention=att)
        net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                       generator=torch.Generator().manual_seed(1))
        nets[att] = net
    want = nets["flash"](tok).detach()
    monkeypatch.setattr(mxt.jit, "_uses_graphs", lambda device: True)
    monkeypatch.setattr(mxt.jit, "_GraphCapture", test_torch_aot.CpuCapture)
    step = mxt.jit.EvalStep(nets["ring"])
    for _ in range(2):
        torch.testing.assert_close(step(tok)._data, want, rtol=1e-4,
                                   atol=1e-5)
    assert step.captures == 0
    step.release()
    monkeypatch.setattr(_functional, "_uses_graphs", lambda device: True)
    ring = nets["ring"]
    monkeypatch.setattr(mxt.jit, "_GraphCapture",
                        test_torch_hybridize._stand_in(ring))
    ring.hybridize()
    for _ in range(3):
        torch.testing.assert_close(ring(tok).detach(), want, rtol=1e-4,
                                   atol=1e-5)
    assert ring._captures == 0
    assert all(e.eager for e in ring._graphs.values())


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_sequence_parallel_gpt_inside_a_data_parallel_step(attention):
    """A TrainStep over a dp = 2 x sp = 4 mesh: each dp position runs its
    attention over the sp axis left to it (``current_mesh()`` inside a
    position); two SGD steps equal flash on one device."""
    from incubator_mxnet_tpu_torch.models.gpt import (ChunkedLMLoss,
                                                      FeaturesView)
    tok = onp.random.RandomState(7).randint(0, 97, (4, 256)).astype("int32")
    runs = []
    for att, axes in (("flash", None), (attention, {"dp": 2, "sp": 4})):
        tpar.set_current_mesh(None)
        mesh = tpar.make_mesh(axes, devices=CPU8) if axes else None
        net = tmodels.GPTModel(vocab_size=97, units=128, num_layers=2,
                               num_heads=4, max_length=256, attention=att)
        net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                       generator=torch.Generator().manual_seed(0))
        tr = mxt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5})
        step = mxt.jit.TrainStep(FeaturesView(net), ChunkedLMLoss(net), tr,
                                 mesh=mesh)
        runs.append([step(tok, tok).asnumpy() for _ in range(2)])
    onp.testing.assert_allclose(runs[1], runs[0], rtol=1e-4, atol=1e-5)
