"""All 17 registered optimizers of the port against the JAX package, on
the CPU, and the Trainer's state files in both directions.

Three parameters of different shapes (one with lr_mult 0.5 and wd_mult 2,
one with wd_mult 0), made with numpy from a seed, take three steps of the
same gradients (bf16-representable, so a bf16 weight sees exactly the
same gradient in both packages). The reference is the JAX package's eager
``Trainer.step``. The port runs ``Trainer.step`` (the gradients written
into ``grad()``) and ``jit.TrainStep`` (a net whose loss's gradient is
exactly those gradients). Tolerance: every fp32 weight (a bf16 weight's
fp32 master) within 1e-6 of the largest value of the JAX package's
tensor: the same fp32 arithmetic, with the bias-correction powers in fp32
on the device where the JAX eager update takes them in double (Adam's
step size at t = 1 is 6.7e-6 relative apart, which moves a weight near 0
by about 2e-7 after three steps of lr 0.01). A bf16 weight equals its
master cast.

SGLD's drift is held with its noise set to zero on both sides (the two
packages' generators differ); its noise alone is held to a standard
normal's moments.
"""
import pickle

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import jit as tjit
from incubator_mxnet_tpu_torch import optimizer as topt

SHAPES = [(5, 7), (7,), (3, 2, 4)]
MULTS = [(1.0, 1.0), (0.5, 2.0), (1.0, 0.0)]
STEPS = 3

CASES = {
    "sgd": dict(learning_rate=0.05, momentum=0.9),
    "nag": dict(learning_rate=0.05, momentum=0.9),
    "signum": dict(learning_rate=0.01, wd_lh=0.01),
    "sgld": dict(learning_rate=0.01),
    "dcasgd": dict(learning_rate=0.05, momentum=0.5),
    "adam": dict(learning_rate=0.01),
    "adamw": dict(learning_rate=0.01),
    "adamax": dict(learning_rate=0.01),
    "nadam": dict(learning_rate=0.01),
    "rmsprop": dict(learning_rate=0.01, clip_weights=1.5),
    "rmsprop_centered": dict(learning_rate=0.01, centered=True),
    "adagrad": dict(learning_rate=0.05),
    "adadelta": dict(rho=0.9),
    "ftrl": dict(learning_rate=0.1),
    "ftml": dict(learning_rate=0.01),
    "lamb": dict(learning_rate=0.01, lower_bound=0.1, upper_bound=10.0),
    "lars": dict(learning_rate=0.1, momentum=0.9),
    "test": dict(),
}


def _opt(case):
    name = "rmsprop" if case.startswith("rmsprop") else case
    kw = dict(CASES[case], wd=0.01, clip_gradient=2.5)
    return name, kw


def _data(seed):
    """(weights, gradients of each step), the gradients rounded to bf16."""
    rng = onp.random.RandomState(seed)
    w = [rng.randn(*s).astype("float32") for s in SHAPES]
    g = [[torch.from_numpy(rng.randn(*s).astype("float32") * 2)
          .bfloat16().float().numpy() for s in SHAPES]
         for _ in range(STEPS)]
    return w, g


def _jax_run(name, kw, w, grads, dtype, batch_size=4):
    params = []
    for i, (s, (lm, wm)) in enumerate(zip(SHAPES, MULTS)):
        p = jgluon.Parameter("w%d" % i, shape=s, dtype=dtype, lr_mult=lm,
                             wd_mult=wm)
        p.initialize(ctx=mx.cpu())
        p.set_data(mx.nd.array(w[i]).astype(dtype))
        params.append(p)
    trainer = jgluon.Trainer(params, name, dict(kw), kvstore=None)
    for step in grads:
        for p, g in zip(params, step):
            p.grad()._data = jnp.asarray(g).astype(dtype)
        trainer.step(batch_size)
    return params, trainer


def _port_params(w, dtype):
    params = []
    for i, (s, (lm, wm)) in enumerate(zip(SHAPES, MULTS)):
        p = mxt.gluon.Parameter("w%d" % i, shape=s, dtype=dtype, lr_mult=lm,
                                wd_mult=wm)
        p.initialize(ctx=mxt.cpu())
        p.set_data(w[i])
        params.append(p)
    return params


def _port_trainer_run(name, kw, w, grads, dtype, batch_size=4):
    params = _port_params(w, dtype)
    trainer = mxt.gluon.Trainer(params, name, dict(kw))
    for step in grads:
        for p, g in zip(params, step):
            p.grad()._data = torch.from_numpy(g).to(p._tensor().dtype)
        trainer.step(batch_size)
    return params, trainer


class _Exact(mxt.gluon.HybridBlock):
    """A net whose output's gradient with respect to each parameter is the
    matching input: ``sum_i sum(w_i * c_i)``, one sample."""

    def __init__(self, params):
        super().__init__()
        for i, p in enumerate(params):
            setattr(self, "w%d" % i, p)
        self._n = len(params)

    def forward(self, *cs):
        return sum((getattr(self, "w%d" % i)._tensor().float() * c).sum()
                   for i, c in enumerate(cs)).reshape(1)


def _port_step_run(name, kw, w, grads, dtype, batch_size=4):
    params = _port_params(w, dtype)
    trainer = mxt.gluon.Trainer(params, name, dict(kw))
    step = tjit.TrainStep(_Exact(params), lambda out: out, trainer)
    for gs in grads:
        step(*gs, batch_size=batch_size, n_net_inputs=len(gs))
    return params, trainer


def _hold(jparams, jtrainer, tparams, ttrainer, dtype, what):
    """Each port weight (a bf16 weight's master, which the weight must
    equal cast) against the JAX package's."""
    for i, (jp, tp) in enumerate(zip(jparams, tparams)):
        if dtype == "bfloat16":
            master = ttrainer._states[i][0]
            assert torch.equal(tp._tensor(), master.bfloat16()), what
            got, ref = master.numpy(), jtrainer._states[i][0].asnumpy()
        else:
            got = tp._tensor().detach().numpy()
            ref = jp.data().asnumpy()
        _rel(got, ref, "%s w%d" % (what, i))


def _rel(got, ref, what=""):
    """|got - ref| within 1e-6 of ref's largest value."""
    scale = max(float(onp.abs(ref).max()), 1e-30)
    err = float(onp.abs(onp.asarray(got) - ref).max()) / scale
    assert err <= 1e-6, "%s: %.3g of the largest value" % (what, err)


@pytest.fixture
def no_sgld_noise(monkeypatch):
    """SGLD's noise set to zero in both packages."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(
                            shape, dtype))
    monkeypatch.setattr(topt.SGLD, "_noise", lambda self, ws: [
        torch.zeros_like(w) for w in ws])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_optimizer_matches_the_jax_eager_trainer(case, dtype,
                                                       no_sgld_noise):
    name, kw = _opt(case)
    kw["multi_precision"] = dtype == "bfloat16"
    w, grads = _data(seed=len(case))
    jparams, jtrainer = _jax_run(name, kw, w, grads, dtype)
    for run, what in ((_port_trainer_run, "Trainer.step"),
                      (_port_step_run, "TrainStep")):
        tparams, ttrainer = run(name, kw, w, grads, dtype)
        assert not onp.allclose(tparams[0]._tensor().detach().float().numpy(),
                               w[0])
        _hold(jparams, jtrainer, tparams, ttrainer, dtype,
              "%s %s" % (case, what))


def test_nadam_schedule_runs_over_the_parameters_in_index_order():
    """Nadam's momentum schedule is a running product over every
    parameter update: after three steps of three parameters it is the
    JAX package's host value (nine factors)."""
    w, grads = _data(seed=3)
    kw = dict(learning_rate=0.01, wd=0.01)
    _, jtrainer = _jax_run("nadam", kw, w, grads, "float32")
    _, ttrainer = _port_trainer_run("nadam", kw, w, grads, "float32")
    ref = jtrainer._optimizer.m_schedule
    assert ttrainer.optimizer.m_schedule == pytest.approx(ref, rel=1e-12)
    assert 0 < ref < 0.45 ** 8


def test_sgld_noise_is_standard_normal_times_sqrt_lr():
    """With a zero gradient and no weight decay, one SGLD step adds
    normal noise of variance lr; nd.random.seed repeats it."""
    lr = 0.25
    draws = []
    for _ in range(2):
        mxt.random.seed(7)
        p = mxt.gluon.Parameter("w", shape=(200000,))
        p.initialize(init=mxt.init.Zero(), ctx=mxt.cpu())
        trainer = mxt.gluon.Trainer([p], "sgld", {"learning_rate": lr})
        trainer.step(1)
        draws.append(p._tensor().detach().numpy().copy())
    assert onp.array_equal(draws[0], draws[1])
    x = draws[0] / onp.sqrt(lr)
    n = x.size
    assert abs(x.mean()) < 5 / onp.sqrt(n)
    assert abs(x.var() - 1) < 5 * onp.sqrt(2.0 / n)


def test_lamb_trust_ratio_is_one_for_a_zero_weight():
    """The (w_norm > 0) & (r_norm > 0) guard: a zero weight takes the
    plain step lr * r, as in the JAX package. Through each package's
    Updater (the per-index update, whose bias-correction powers are host
    doubles in both: a zero weight's whole value is the step, so the fp32
    powers of Trainer.step would show at 7e-6)."""
    _, grads = _data(seed=9)
    jup = mx.optimizer.get_updater(mx.optimizer.create(
        "lamb", learning_rate=0.01))
    tup = topt.get_updater(topt.create("lamb", learning_rate=0.01))
    for i, (s, g) in enumerate(zip(SHAPES, grads[0])):
        jw, tw = mx.nd.zeros(s), torch.zeros(s)
        jup(i, mx.nd.array(g), jw)
        tup(i, torch.from_numpy(g), tw)
        assert float(onp.abs(jw.asnumpy()).max()) > 0
        _rel(tw.numpy(), jw.asnumpy(), "w%d" % i)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("reader", ["jax", "port"])
def test_state_files_cross_between_the_packages(tmp_path, writer, reader):
    """A save_states file written after two steps by either package loads
    in either (states on each parameter's device), and two more steps
    from the same weights land on the same weights within 1e-6. Update
    counts: a port file carries them and the port restores them; the JAX
    package ignores them, and restarts its counts, so the reference run
    here restarts them too (a fresh optimizer for the last two steps)."""
    name, kw = "adam", dict(learning_rate=0.01, wd=0.01)
    w, grads = _data(seed=21)
    fname = str(tmp_path / "states")
    if writer == "jax":
        jparams, jtrainer = _jax_run(name, kw, w, grads[:2], "float32")
        jtrainer.save_states(fname)
        mid = [p.data().asnumpy() for p in jparams]
    else:
        tparams, ttrainer = _port_trainer_run(name, kw, w, grads[:2],
                                              "float32")
        ttrainer.save_states(fname)
        mid = [p._tensor().detach().numpy().copy() for p in tparams]
    with open(fname, "rb") as f:
        raw = pickle.load(f)
    states = raw[0] if isinstance(raw, tuple) else raw
    assert sorted(states) == [0, 1, 2]
    assert all(isinstance(a, onp.ndarray) for s in states.values()
               for a in s)
    # the reference: the JAX package resuming its own way (counts restart)
    ref_params, ref_trainer = _jax_run(name, kw, mid, [], "float32")
    ref_trainer.load_states(fname)
    for step in grads[2:]:
        for p, g in zip(ref_params, step):
            p.grad()._data = jnp.asarray(g)
        ref_trainer.step(4)
    if reader == "jax":
        got = [p.data().asnumpy() for p in ref_params]
    else:
        tparams = _port_params(mid, "float32")
        trainer = mxt.gluon.Trainer(tparams, name, dict(kw))
        trainer.load_states(fname)
        if writer == "port":
            assert trainer.optimizer._index_update_count == {0: 2, 1: 2,
                                                             2: 2}
            trainer.optimizer._index_update_count = {}
            trainer.optimizer.num_update = 0
        for step in grads[2:]:
            for p, g in zip(tparams, step):
                p.grad()._data = torch.from_numpy(g)
            trainer.step(4)
        got = [p._tensor().detach().numpy() for p in tparams]
    for a, b in zip(got, [p.data().asnumpy() for p in ref_params]):
        _rel(a, b)


def test_port_resume_continues_counts_and_schedule(tmp_path):
    """The port's own file restores the update counts: two steps, save,
    a fresh Trainer (and scheduler) that loads, two more steps = four
    uninterrupted steps, bit for bit, LAMB under a PolyScheduler with
    warm-up."""
    w, grads = _data(seed=5)
    grads = grads + grads[:1]

    def kw():
        return dict(learning_rate=0.01, wd=0.01, lr_scheduler=mxt
                    .lr_scheduler.PolyScheduler(8, base_lr=0.01,
                                                warmup_steps=2))
    full, _ = _port_trainer_run("lamb", kw(), w, grads, "float32")
    part, trainer = _port_trainer_run("lamb", kw(), w, grads[:2], "float32")
    fname = str(tmp_path / "lamb.states")
    trainer.save_states(fname)
    mid = [p._tensor().detach().numpy().copy() for p in part]
    params = _port_params(mid, "float32")
    resumed = mxt.gluon.Trainer(params, "lamb", kw())
    resumed.load_states(fname)
    for step in grads[2:]:
        for p, g in zip(params, step):
            p.grad()._data = torch.from_numpy(g)
        resumed.step(4)
    for a, b in zip(params, full):
        assert torch.equal(a._tensor(), b._tensor())


def test_loading_states_rebinds_so_train_step_captures_again(
        tmp_path, monkeypatch):
    """States loaded after a capture are new tensors: the captured step's
    address check captures again (through a CPU stand-in for the graph)."""
    from test_torch_jit import _cpu_capture, _captured
    w, grads = _data(seed=2)
    params = _port_params(w, "float32")
    trainer = mxt.gluon.Trainer(params, "adam", {"learning_rate": 0.01})
    step = tjit.TrainStep(_Exact(params), lambda out: out, trainer)
    monkeypatch.setattr(tjit, "_GraphCapture", _cpu_capture(step))
    args = step._prepare(grads[0], 3)
    step._replay(args, 3, 1)
    step._replay(args, 3, 1)
    assert step.captures == 1
    fname = str(tmp_path / "s")
    trainer.save_states(fname)
    trainer.load_states(fname)
    step._replay(args, 3, 1)
    assert step.captures == 2


def test_updater_round_trip_and_registry():
    """get_updater keeps a state per index; get_states/set_states round
    trip; every reference optimizer name is registered."""
    for n in ("test", "nag", "signum", "sgld", "dcasgd", "adamax", "nadam",
              "rmsprop", "adagrad", "adadelta", "ftrl", "ftml", "lamb",
              "lars", "sgd", "adam", "adamw"):
        assert isinstance(topt.create(n), topt.Optimizer)
    opt = topt.create("adam", learning_rate=0.1)
    up = topt.get_updater(opt)
    w = torch.ones(3)
    up(0, torch.full((3,), 0.5), w)
    blob = up.get_states()
    up2 = topt.get_updater(topt.create("adam", learning_rate=0.1))
    up2.set_states(blob)
    assert torch.equal(up2.states[0][0], up.states[0][0])
    w2 = w.clone()
    up(0, torch.full((3,), 0.5), w)
    up2.optimizer._index_update_count = {0: 1}
    up2(0, torch.full((3,), 0.5), w2)
    assert torch.equal(w, w2)
    jup = mx.optimizer.get_updater(mx.optimizer.create("adam"))
    jup.set_states(blob)
    onp.testing.assert_array_equal(jup.states[0][1].asnumpy(),
                                   up.states[0][1].numpy() * 0 +
                                   pickle.loads(blob)[0][1])
