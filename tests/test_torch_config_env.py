"""The port's environment registry (incubator_mxnet_tpu_torch/config.py)
against the JAX package's (incubator_mxnet_tpu/config.py), with the
reference's own wiring tests (its tests/test_config_env.py) run against
the port: each knob must be READ somewhere real, not only documented.

- The registry parity test holds every key of either registry to a
  decision: declared by both with the same type and default, or named in
  ``DEPARTURES``/``PORT_ONLY`` with its reason. A knob added to either
  registry later fails it until it is decided.
- ``MXTPU_EXEC_CACHE_SIZE`` bounds a hybridized block's cache
  (``config.evict_to_bound``) and ``MXTPU_AOT_CACHE_SIZE`` the shared AOT
  cache, as in the reference; the eval-step eviction runs through
  tests/test_torch_aot.py's CPU stand-in for the graph, beside the JAX
  package's own.
- The import-time knobs (``MXTPU_SEED``, ``MXTPU_PROFILER_AUTOSTART`` and
  ``MXTPU_PROFILER_FILENAME``, ``MXTPU_MATMUL_PRECISION``) run in fresh
  processes, bounded by ``timeout=300`` as the reference's are.
"""
import os
import subprocess
import sys

import numpy as onp
import pytest

from incubator_mxnet_tpu import config as jconfig

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import config

from test_torch_aot import cpu_graphs  # noqa: F401 — a fixture

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

#: reference knobs the port does not declare, each with its reason
DEPARTURES = {
    "MXTPU_FLASH_BLOCK_Q": "the Pallas kernel's TPU tile; Hopper's tiles "
                           "are the CUDA kernels' own (ROADMAP §3)",
    "MXTPU_FLASH_BLOCK_K": "the Pallas kernel's TPU tile (as BLOCK_Q)",
    "MXTPU_FLASH_FORCE": "forces the Pallas kernel past the TPU "
                         "profitability heuristic, which is not carried "
                         "over: legal shapes always take the kernel",
    "MXTPU_FLASH_INTERPRET": "Pallas interpret mode; a CUDA kernel has no "
                             "interpreter (CPU tensors take the plain "
                             "version)",
    "MXTPU_HLOLINT_GATE": "tools/hlolint reads StableHLO: no analog "
                          "(ROADMAP §3)",
    "MXTPU_HLOLINT_HBM_BUDGET": "tools/hlolint (as MXTPU_HLOLINT_GATE)",
    "MXTPU_HLOLINT_PAD_WASTE": "tools/hlolint (as MXTPU_HLOLINT_GATE)",
    "MXTPU_HLODIFF_GATE": "tools/hlodiff reads StableHLO: no analog "
                          "(ROADMAP §3)",
    "MXTPU_HLODIFF_FLOPS_TOL": "tools/hlodiff (as MXTPU_HLODIFF_GATE)",
    "MXTPU_HLODIFF_PEAK_TOL": "tools/hlodiff (as MXTPU_HLODIFF_GATE)",
    "MXTPU_LOADGEN_MAX_CLIENTS": "read only by the JAX package's "
                                 "tools/loadgen.py",
    "MXTPU_LOADGEN_SEED": "read only by the JAX package's tools/loadgen.py",
    "MXTPU_LOADGEN_TIMEOUT_S": "read only by the JAX package's "
                               "tools/loadgen.py",
    "MXTPU_PERFGATE_REPEATS": "read only by the JAX package's "
                              "tools/perfgate.py",
    "MXTPU_PERFGATE_TOLERANCE": "read only by the JAX package's "
                                "tools/perfgate.py",
    "JAX_PLATFORMS": "JAX's backend selection; the port's is the context "
                     "(cpu()/gpu(i)) and MXTPU_CAPI_CONTEXT",
    "XLA_FLAGS": "XLA's compiler flags; the port compiles no XLA",
}

#: port knobs the reference does not declare, each with its reason
PORT_ONLY = {
    "MXTPU_CAPI_CONTEXT": "the embedded C ABI's device, the counterpart "
                          "of the reference's JAX_PLATFORMS pin",
    "MXTPU_DIST_TIMEOUT_S": "torch.distributed's process-group timeout "
                            "(jax.distributed has its own)",
    "MXTPU_SPMD_TIMEOUT_S": "the in-process rendezvous deadline of "
                            "parallel.shard_map's collectives (XLA's "
                            "collectives need none)",
}


def test_registry_parity_names_every_departure():
    ref, port = set(jconfig.ENV_VARS), set(config.ENV_VARS)
    assert ref - port == set(DEPARTURES), \
        "undecided reference knobs: %s; stale departures: %s" % (
            sorted(ref - port - set(DEPARTURES)),
            sorted(set(DEPARTURES) - (ref - port)))
    assert port - ref == set(PORT_ONLY), \
        "undecided port knobs: %s; stale entries: %s" % (
            sorted(port - ref - set(PORT_ONLY)),
            sorted(set(PORT_ONLY) - (port - ref)))
    assert all(DEPARTURES.values()) and all(PORT_ONLY.values())
    for name in ref & port:
        assert config.ENV_VARS[name][:2] == jconfig.ENV_VARS[name][:2], name
        assert config.ENV_VARS[name][2], name


def test_registry_size_and_render():
    assert len(config.ENV_VARS) >= 25
    text = config.describe()
    for name in config.ENV_VARS:
        assert name in text


@pytest.mark.parametrize("pkg", [config, jconfig], ids=["port", "jax"])
def test_exec_cache_bound(monkeypatch, pkg):
    monkeypatch.setenv("MXTPU_EXEC_CACHE_SIZE", "2")
    monkeypatch.setenv("MXTPU_AOT_CACHE_SIZE", "64")
    cache = {}
    for i in range(5):
        cache[i] = i
        pkg.evict_to_bound(cache)
    assert list(cache) == [3, 4]


@pytest.mark.parametrize("pkg", [config, jconfig], ids=["port", "jax"])
def test_exec_cache_bound_lru_and_on_evict(monkeypatch, pkg):
    """evict_to_bound is LRU when callers move-to-end on hit, and the
    on_evict hook sees every victim."""
    monkeypatch.setenv("MXTPU_EXEC_CACHE_SIZE", "2")
    cache = {1: "a", 2: "b"}
    cache[1] = cache.pop(1)          # touch 1: recency order is 2, 1
    cache[3] = "c"
    evicted = []
    pkg.evict_to_bound(cache, on_evict=lambda k, v: evicted.append(k))
    assert list(cache) == [1, 3] and evicted == [2]


def test_exec_cache_default_bounds_a_hybridized_block():
    """Unset, a hybridized block keeps 16 signatures (the reference's
    default), whatever MXTPU_AOT_CACHE_SIZE says."""
    assert config.get_env("MXTPU_EXEC_CACHE_SIZE") == \
        jconfig.get_env("MXTPU_EXEC_CACHE_SIZE") == 16
    cache = {}
    for i in range(20):
        cache[i] = i
        config.evict_to_bound(cache)
    assert list(cache) == list(range(4, 20))


def test_eval_step_cache_evicts(monkeypatch, cpu_graphs):  # noqa: F811
    """EvalStep entries live in the shared AOT cache, bounded by
    MXTPU_AOT_CACHE_SIZE with LRU-by-last-dispatch eviction; the JAX
    package's EvalStep keeps the same shapes."""
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu import aot as jaot
    from incubator_mxnet_tpu import jit as jjit
    from incubator_mxnet_tpu_torch import aot, jit
    monkeypatch.setenv("MXTPU_AOT_CACHE_SIZE", "2")
    net = mxt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mxt.cpu())
    step = jit.EvalStep(net)
    jnet = mx.gluon.nn.Dense(3, in_units=4)
    jnet.initialize()
    jstep = jjit.EvalStep(jnet)
    got = []
    for pkg, cache, run, ones in (
            ("port", aot.CACHE, step, lambda n: onp.ones((n, 4), "float32")),
            ("jax", jaot.CACHE, jstep, lambda n: mx.nd.ones((n, 4)))):
        for n in (2, 3, 4, 5):
            run(ones(n))
        keys = cache.keys()
        assert len(keys) == 2, pkg
        shapes = sorted(k.input_sig[0][0] for k in keys)
        assert shapes == [(4, 4), (5, 4)], pkg
        # LRU, not dict order: re-dispatching the older survivor then
        # adding a new shape must evict the untouched one, never the hot
        # one
        run(ones(4))
        run(ones(6))
        shapes = sorted(k.input_sig[0][0] for k in cache.keys())
        assert shapes == [(4, 4), (6, 4)], pkg
        got.append(shapes)
    assert got[0] == got[1]
    step.release()


def test_remat_default_env(monkeypatch):
    from incubator_mxnet_tpu_torch import gluon, jit
    net = gluon.nn.Dense(2)
    net.initialize(ctx=mxt.cpu())
    trainer = gluon.Trainer(net.collect_params(), "sgd")
    loss = gluon.loss.L2Loss()
    monkeypatch.setenv("MXTPU_REMAT", "1")
    assert jit.TrainStep(net, loss, trainer).remat is True
    monkeypatch.delenv("MXTPU_REMAT")
    assert jit.TrainStep(net, loss, trainer).remat is False
    # explicit arg wins over env
    monkeypatch.setenv("MXTPU_REMAT", "1")
    assert jit.TrainStep(net, loss, trainer, remat=False).remat is False


def test_engine_bulk_size_env():
    # import-time default is the registered default when env unset
    assert mxt.engine.set_bulk_size(mxt.engine.set_bulk_size(31)) == 31


def test_cpu_worker_nthreads_default(monkeypatch):
    monkeypatch.setenv("MXTPU_CPU_WORKER_NTHREADS", "3")
    assert config.get_env("MXTPU_CPU_WORKER_NTHREADS") == 3


# ------------------------------------------------ knobs applied at import
def _run(code, **env_vars):
    """``code`` in a fresh interpreter at the repo's root with
    ``env_vars`` set (the port imports no JAX)."""
    env = dict(os.environ, **env_vars)
    for name in ("MXTPU_SEED", "MXTPU_PROFILER_AUTOSTART",
                 "MXTPU_PROFILER_FILENAME", "MXTPU_MATMUL_PRECISION"):
        if name not in env_vars:
            env.pop(name, None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)


def test_seed_env_subprocess():
    """MXTPU_SEED seeds nd.random and mx.np.random at import: the first
    draws of each repeat after ``mx.random.seed`` of the same value."""
    code = (
        "import incubator_mxnet_tpu_torch as mx;"
        "a = mx.nd.random.uniform(shape=(4,), ctx=mx.cpu());"
        "c = mx.np.random.uniform(size=(4,), ctx=mx.cpu());"
        "mx.random.seed(1234);"
        "b = mx.nd.random.uniform(shape=(4,), ctx=mx.cpu());"
        "d = mx.np.random.uniform(size=(4,), ctx=mx.cpu());"
        "import numpy as np;"
        "assert np.allclose(a.asnumpy(), b.asnumpy());"
        "assert np.allclose(c.asnumpy(), d.asnumpy());"
        "print('SEED OK')")
    r = _run(code, MXTPU_SEED="1234")
    assert r.returncode == 0 and "SEED OK" in r.stdout, (r.stdout, r.stderr)


def test_profiler_autostart_subprocess(tmp_path):
    out = tmp_path / "auto.json"
    code = (
        "import incubator_mxnet_tpu_torch as mx;"
        "assert mx.profiler.state() == 'run';"
        "mx.nd.ones((2, 2), ctx=mx.cpu()).asnumpy();"
        "print('AUTO OK')")
    r = _run(code, MXTPU_PROFILER_AUTOSTART="1",
             MXTPU_PROFILER_FILENAME=str(out))
    assert r.returncode == 0 and "AUTO OK" in r.stdout, (r.stdout, r.stderr)
    assert out.exists() and out.stat().st_size > 0


@pytest.mark.parametrize("name,want", [
    (None, ("highest", True)),            # unset: torch's defaults stay
    ("default", ("high", True)),
    ("high", ("high", True)),
    ("highest", ("highest", False)),
])
def test_matmul_precision_env_subprocess(name, want):
    """MXTPU_MATMUL_PRECISION, read as XLA's GPU backend reads it: TF32
    for 'default' and 'high' (matmuls and cuDNN), full fp32 for
    'highest'; unset, torch's defaults."""
    code = (
        "import incubator_mxnet_tpu_torch, torch;"
        "print(torch.get_float32_matmul_precision(),"
        " torch.backends.cudnn.allow_tf32)")
    r = _run(code, **({} if name is None else
                      {"MXTPU_MATMUL_PRECISION": name}))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want[0], str(want[1])], r.stdout


def test_matmul_precision_env_refuses_other_names():
    r = _run("import incubator_mxnet_tpu_torch",
             MXTPU_MATMUL_PRECISION="bf16")
    assert r.returncode != 0 and "MXTPU_MATMUL_PRECISION" in r.stderr
