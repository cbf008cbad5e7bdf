"""The port's BERT and GPT against the JAX package, on the CPU.

Small configurations (2 layers, units 64, 2 heads, vocab 97, S = 128,
float32, flash attention): the JAX model is initialized, its weights are
carried into the port with ``from_jax_params``, and both forward the same
tokens. The JAX side runs its Pallas kernel in interpret mode. Tolerance:
1e-4 absolute and relative on the logits — the two run the same float32
arithmetic and differ in the order of the sums, through two layers.
"""
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import nd as jnd

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import models as tmodels

TOL = dict(atol=1e-4, rtol=1e-4)
V, S = 97, 128


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_INTERPRET", "1")


def _pair(kind, units=64, heads=2):
    kw = dict(vocab_size=V, units=units, num_layers=2, num_heads=heads,
              max_length=S, attention="flash")
    if kind == "bert":
        kw.update(hidden_size=2 * units, dropout=0.0)
        jnet, tnet = jmodels.BERTModel(**kw), tmodels.BERTModel(**kw)
    else:
        jnet, tnet = jmodels.GPTModel(**kw), tmodels.GPTModel(**kw)
    jnet.initialize(mx.init.Xavier())
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tnet.initialize(mxt.init.Zero(), ctx=mxt.cpu())
    mxt.from_jax_params(tnet, arrays)
    return jnet, tnet, arrays


def _tokens(B=2, seed=0):
    return onp.random.RandomState(seed).randint(0, V, (B, S)).astype("int32")


@pytest.mark.parametrize("kind,units", [("bert", 64), ("bert", 128),
                                        ("gpt", 64)])
def test_logits_match_jax(kind, units):
    """units 64 → head width 32 (the port's composite route); units 128 →
    head width 64 (the port's kernel route, its plain version here)."""
    jnet, tnet, _ = _pair(kind, units)
    tok = _tokens()
    ref = jnet(jnd.array(tok)).asnumpy()
    out = mxt.jit.EvalStep(tnet)(tok)
    assert out.shape == ref.shape == (2, S, V)
    onp.testing.assert_allclose(out.asnumpy(), ref, **TOL)


@pytest.mark.parametrize("kind", ["bert", "gpt"])
def test_token_ids_out_of_range_give_nan_where_jax_does(kind):
    """Row 0 holds the ids V and -V - 1 (out of range: NaN embeddings, which
    attention spreads over the whole row); row 1 holds -1, which wraps to
    V - 1 and stays finite."""
    jnet, tnet, _ = _pair(kind)
    tok = _tokens()
    tok[0, 3], tok[0, 10], tok[1, 5] = V, -V - 1, -1
    ref = jnet(jnd.array(tok)).asnumpy()
    out = mxt.jit.EvalStep(tnet)(tok).asnumpy()
    onp.testing.assert_array_equal(onp.isnan(out), onp.isnan(ref))
    assert onp.isnan(out[0, 10:]).all() and onp.isfinite(out[1]).all()
    onp.testing.assert_allclose(out[1], ref[1], **TOL)


@pytest.mark.parametrize("kind", ["bert", "gpt"])
def test_state_dict_keys_are_jax_structural_names(kind):
    jnet, tnet, arrays = _pair(kind)
    assert list(tnet.state_dict()) == list(arrays)
    assert set(tnet.collect_params().keys()) == set(arrays)
    for name, t in tnet.state_dict().items():
        assert tuple(t.shape) == arrays[name].shape


def test_from_jax_params_checks_names_and_shapes():
    _, tnet, arrays = _pair("gpt")
    missing = dict(arrays)
    missing.pop("ln_f.gamma")
    with pytest.raises(KeyError, match="ln_f.gamma"):
        mxt.from_jax_params(tnet, missing)
    wrong = dict(arrays, **{"ln_f.gamma": onp.ones(3, "float32")})
    with pytest.raises(ValueError, match="ln_f.gamma"):
        mxt.from_jax_params(tnet, wrong)


def test_cast_to_bf16_keeps_tied_weights_and_registration():
    _, tnet, arrays = _pair("gpt")
    tnet.cast("bfloat16")
    sd = tnet.state_dict(keep_vars=True)
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    assert sd["tok_embed.weight"] is tnet.tok_embed.weight.data()._data
    out = mxt.jit.EvalStep(tnet)(_tokens(B=1))
    assert out.dtype == "bfloat16" and onp.isfinite(out.asnumpy()).all()


def test_deferred_dense_and_layernorm_shapes():
    net = mxt.gluon.nn.HybridSequential()
    net.add(mxt.gluon.nn.Dense(8, flatten=False),
            mxt.gluon.nn.LayerNorm())
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu())
    assert net[0].weight.shape == (8, 0)
    x = torch.from_numpy(onp.random.RandomState(0).randn(3, 5)
                         .astype("float32"))
    y = net(x)
    assert y.shape == (3, 8)
    assert net[0].weight.shape == (8, 5)
    assert set(net.state_dict()) == {"0.weight", "0.bias", "1.gamma",
                                     "1.beta"}


def test_seeded_generator_fixes_the_init():
    def init(seed):
        net = tmodels.GPTModel(vocab_size=V, units=64, num_layers=1,
                               num_heads=2, max_length=S)
        net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                       generator=torch.Generator().manual_seed(seed))
        return net.state_dict()
    a, b, c = init(1), init(1), init(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tok_embed.weight"], c["tok_embed.weight"])


def test_gpt_rejects_sequences_past_max_length():
    _, tnet, _ = _pair("gpt")
    with pytest.raises(ValueError, match="max_length"):
        tnet(torch.zeros(1, S + 1, dtype=torch.int32))


def test_ring_and_ulysses_wait_for_the_multi_gpu_slice():
    """They no longer wait: ``attention="ring"|"ulysses"`` run over the
    current mesh's ``sp`` axis and equal flash attention from the same
    weights (against the JAX package: tests/test_torch_ring_attention.py);
    an unknown attention still raises."""
    from incubator_mxnet_tpu_torch import parallel
    x = torch.tensor(onp.random.RandomState(4).randn(2, 64, 64)
                     .astype("float32"))
    flash = tmodels.MultiHeadAttention(64, 4, attention="flash",
                                       causal=True)
    flash.initialize(ctx=mxt.cpu())
    want = flash(x).detach()
    parallel.make_mesh({"sp": 4}, devices=[torch.device("cpu")] * 4)
    try:
        for attention in ("ring", "ulysses"):
            cell = tmodels.MultiHeadAttention(64, 4, attention=attention,
                                              causal=True)
            cell.initialize(ctx=mxt.cpu())
            cell.load_state_dict(flash.state_dict())
            torch.testing.assert_close(cell(x).detach(), want, **TOL)
    finally:
        parallel.set_current_mesh(None)
    with pytest.raises(ValueError, match="unknown attention"):
        tmodels.MultiHeadAttention(64, 2, attention="sparse")


#: modules every walk of the port must reach (the array layer, serving,
#: the AOT cache, the KV cache and telemetry)
PORT_MODULES = ("ndarray.ndarray", "ndarray.random", "ndarray.serialization",
                "ndarray.linalg", "ndarray.optimizer_ops", "ndarray.sparse",
                "ndarray.contrib", "ops.ctc", "ops.deformable",
                "autograd", "base", "error", "name", "attribute", "registry",
                "context", "test_utils", "convert", "gluon.parameter",
                "gluon.block", "gluon.trainer", "gluon.loss", "jit",
                "symbol", "symbol.symbol", "symbol.contrib", "executor",
                "kvstore", "kvstore.kvstore", "kvstore.kvstore_server",
                "model", "module", "module.base_module", "module.module",
                "module.bucketing_module", "module.sequential_module",
                "io", "io.io", "recordio", "image", "monitor", "aot",
                "ops.kvcache", "serving.server", "serving.accesslog",
                "serving.resilience", "serving.generate", "telemetry",
                "telemetry.registry", "telemetry.spans",
                "telemetry.flightrec", "telemetry.watchdog",
                "telemetry.faultlab", "parallel", "parallel.compat",
                "parallel.mesh", "parallel.data_parallel",
                "parallel.tensor_parallel", "parallel.ring_attention",
                "parallel.ulysses", "parallel.moe", "parallel.pipeline",
                "parallel.pipeline_interleaved", "parallel.gluon_pipeline",
                "serving.sharded", "parallel.dist", "parallel.compression",
                "gluon.contrib", "gluon.contrib.nn", "gluon.contrib.cnn",
                "gluon.contrib.rnn", "gluon.contrib.data",
                "gluon.contrib.estimator", "contrib.svrg",
                "contrib.tensorboard", "numpy", "numpy.fallback",
                "numpy_extension", "numpy_extension.image",
                "numpy_extension.random", "contrib.quantization",
                "contrib.onnx", "contrib.onnx_proto", "contrib.text",
                "operator", "torch", "library", "subgraph", "runtime",
                "native", "native.lib", "native.capi",
                "native._predict_embed", "native._invoke_embed",
                "native._graph_embed", "native._ext_embed")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "import incubator_mxnet_tpu_torch as m\n"
        "seen = set()\n"
        "for i in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
        "    importlib.import_module(i.name)\n"
        "    seen.add(i.name[len(m.__name__) + 1:])\n"
        "missing = set(%r) - seen\n"
        "assert not missing, missing\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'incubator_mxnet_tpu' or "
        "n.startswith('incubator_mxnet_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n") % (PORT_MODULES,)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """Every import statement of chip_smoke.py, at any depth."""
    import ast
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert "incubator_mxnet_tpu_torch" in names
    bad = sorted(n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "incubator_mxnet_tpu"))
    assert not bad, bad


def test_default_context_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default context resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        mxt.current_context()
    net = tmodels.GPTModel(vocab_size=V, units=64, num_layers=1, num_heads=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        net.initialize()
    with mxt.cpu():
        assert mxt.current_context() == mxt.cpu()
    assert mxt.tpu(0) == mxt.gpu(0)
