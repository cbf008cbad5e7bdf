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
    onp.testing.assert_allclose(out.numpy(), ref, **TOL)


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
    assert sd["tok_embed.weight"] is tnet.tok_embed.weight.data()
    out = mxt.jit.EvalStep(tnet)(_tokens(B=1))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


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
    for attention in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            tmodels.MultiHeadAttention(64, 2, attention=attention)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "import incubator_mxnet_tpu_torch as m\n"
        "for i in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
        "    importlib.import_module(i.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'incubator_mxnet_tpu' or "
        "n.startswith('incubator_mxnet_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


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
