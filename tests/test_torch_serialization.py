"""``.params`` files between the JAX package and the port, on the CPU.

``nd.save`` in either package writes MXNet's binary list format and the
other's ``nd.load`` reads it bit for bit: float32, float16, bfloat16 (raw
16-bit patterns, never through float32), int32, uint8, and int64 where the
writing package holds it (the port; JAX runs without x64, so the JAX
package reads the int64 record's values and holds them as int32), as dicts
and as lists. Both packages write the same bytes for the same arrays. A
small BERT saved with the JAX package's ``save_parameters`` loads into the
port's ``load_parameters`` and forwards within the model tests' 1e-4; the
port's ``save_parameters`` loads back into the JAX package bit for bit.
``serialization.save_ndarray_list``/``load_ndarray_list`` are the JAX
package's functions under its names: the same bytes for the same arrays,
each package's file read by the other's bit for bit (exact).
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu.ndarray import serialization as jser

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import models as tmodels
from incubator_mxnet_tpu_torch.ndarray import serialization as tser

DTYPES = ["float32", "float16", "bfloat16", "int32", "uint8"]
V, S = 97, 64


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_INTERPRET", "1")


def _values(dtype, seed=0, shape=(3, 5)):
    rng = onp.random.RandomState(seed)
    if dtype in ("int32", "uint8", "int64"):
        hi = 250 if dtype == "uint8" else 2 ** 30
        return rng.randint(0, hi, shape).astype(dtype)
    return (rng.randn(*shape) * 10).astype("float32")


def _bits(t):
    """The raw bytes of a port tensor (bfloat16 as its 16-bit patterns)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _jax_bits(a):
    return onp.ascontiguousarray(a).tobytes()


def _pair_arrays(dtype, seed):
    """The same array in both packages (bfloat16: cast from the same
    float32 values in each, which rounds alike)."""
    x = _values(dtype, seed)
    j = mx.nd.array(x)
    t = mxt.nd.array(x, ctx=mxt.cpu())
    if dtype == "bfloat16":
        j, t = j.astype("bfloat16"), t.astype("bfloat16")
    elif dtype != "float32":
        j, t = j.astype(dtype), t.astype(dtype)
    return j, t


@pytest.mark.parametrize("as_dict", [True, False])
def test_port_file_loads_in_the_jax_package_bit_for_bit(tmp_path, as_dict):
    arrays = [_pair_arrays(dt, i)[1] for i, dt in enumerate(DTYPES)]
    arrays.append(mxt.nd.array(_values("int64", 9), ctx=mxt.cpu(),
                               dtype="int64"))
    names = DTYPES + ["int64"]
    fname = str(tmp_path / "port.params")
    mxt.nd.save(fname, dict(zip(names, arrays)) if as_dict else arrays)
    raw, raw_names = jser.load_ndarray_list(fname)
    assert raw_names == (names if as_dict else [])
    for t, r, dt in zip(arrays, raw, names):
        assert str(r.dtype) == dt and r.shape == t.shape
        assert _jax_bits(r) == _bits(t._data), dt
    loaded = mx.nd.load(fname)
    got = [loaded[n] for n in names] if as_dict else loaded
    for t, j, dt in zip(arrays, got, names):
        want = t.asnumpy().astype("int32") if dt == "int64" else t.asnumpy()
        onp.testing.assert_array_equal(j.asnumpy().astype(want.dtype), want)


@pytest.mark.parametrize("as_dict", [True, False])
def test_jax_file_loads_in_the_port_bit_for_bit(tmp_path, as_dict):
    arrays = [_pair_arrays(dt, i)[0] for i, dt in enumerate(DTYPES)]
    fname = str(tmp_path / "jax.params")
    mx.nd.save(fname, dict(zip(DTYPES, arrays)) if as_dict else arrays)
    loaded = mxt.nd.load(fname)
    if as_dict:
        assert list(loaded) == DTYPES
        loaded = [loaded[n] for n in DTYPES]
    for j, t, dt in zip(arrays, loaded, DTYPES):
        assert t.dtype == dt and t.shape == j.shape
        assert t.context == mxt.cpu()
        assert _bits(t._data) == _jax_bits(onp.asarray(j._data)), dt


def test_both_packages_write_the_same_bytes(tmp_path):
    pairs = [_pair_arrays(dt, i) for i, dt in enumerate(DTYPES)]
    files = []
    for k, pkg in enumerate((mx, mxt)):
        fname = str(tmp_path / ("%d.params" % k))
        pkg.nd.save(fname, {dt: p[k] for dt, p in zip(DTYPES, pairs)})
        files.append(open(fname, "rb").read())
    assert files[0] == files[1]


@pytest.mark.parametrize("given", ["ndarray", "numpy"])
def test_ndarray_list_functions_are_the_references(tmp_path, given):
    """The port's save_ndarray_list takes NDArrays (bfloat16 too) or numpy
    arrays and writes the JAX package's bytes; load_ndarray_list gives
    NDArrays on the CPU with the names, and each package reads the
    other's file bit for bit."""
    dtypes = DTYPES if given == "ndarray" else \
        [d for d in DTYPES if d != "bfloat16"]
    pairs = [_pair_arrays(dt, i) for i, dt in enumerate(dtypes)]
    names = ["w%d" % i for i in range(len(pairs))]
    jf, tf = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    jser.save_ndarray_list(jf, [onp.asarray(j._data) for j, _ in pairs],
                           names)
    tser.save_ndarray_list(tf, [t if given == "ndarray" else t.asnumpy()
                                for _, t in pairs], names)
    assert open(jf, "rb").read() == open(tf, "rb").read()
    arrays, got_names = tser.load_ndarray_list(jf)
    assert got_names == names
    for t, (j, _), dt in zip(arrays, pairs, dtypes, strict=True):
        assert isinstance(t, mxt.nd.NDArray) and t.context == mxt.cpu()
        assert t.dtype == dt
        assert _bits(t._data) == _jax_bits(onp.asarray(j._data)), dt
    raw, raw_names = jser.load_ndarray_list(tf)
    assert raw_names == names
    for r, (_, t) in zip(raw, pairs, strict=True):
        assert _jax_bits(r) == _bits(t._data)


def test_a_jax_bert_loads_into_the_port_and_back(tmp_path):
    kw = dict(vocab_size=V, units=64, hidden_size=128, num_layers=2,
              num_heads=2, max_length=S, dropout=0.0, attention="flash")
    jnet = jmodels.BERTModel(**kw)
    jnet.initialize(mx.init.Xavier())
    jfile = str(tmp_path / "jax_bert.params")
    jnet.save_parameters(jfile)
    tnet = tmodels.BERTModel(**kw)
    tnet.initialize(mxt.init.Zero(), ctx=mxt.cpu())
    tnet.load_parameters(jfile)
    tok = onp.random.RandomState(0).randint(0, V, (2, S)).astype("int32")
    ref = jnet(mx.nd.array(tok)).asnumpy()
    got = tnet(mxt.nd.array(tok, ctx=mxt.cpu())).asnumpy()
    onp.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    tfile = str(tmp_path / "port_bert.params")
    tnet.save_parameters(tfile)
    assert open(tfile, "rb").read() == open(jfile, "rb").read()
    back = jmodels.BERTModel(**kw)
    back.initialize(mx.init.Zero())
    back.load_parameters(tfile)
    for name, p in jnet._collect_params_with_prefix().items():
        onp.testing.assert_array_equal(
            back._collect_params_with_prefix()[name].data().asnumpy(),
            p.data().asnumpy())


def test_load_parameters_checks_names_and_fills_deferred_shapes(tmp_path):
    net = mxt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mxt.cpu())
    fname = str(tmp_path / "dense.params")
    net.save_parameters(fname)
    fresh = mxt.gluon.nn.Dense(3)
    fresh.initialize(ctx=mxt.cpu())
    assert fresh.weight._data is None
    fresh.load_parameters(fname)
    onp.testing.assert_array_equal(fresh.weight.data().asnumpy(),
                                   net.weight.data().asnumpy())
    other = mxt.gluon.nn.HybridSequential()
    other.add(mxt.gluon.nn.Dense(3, in_units=4))
    other.initialize(ctx=mxt.cpu())
    with pytest.raises(AssertionError, match="missing"):
        other.load_parameters(fname)
    other.load_parameters(fname, allow_missing=True, ignore_extra=True)
    with pytest.raises(ValueError, match="0x112"):
        bad = tmp_path / "bad.params"
        bad.write_bytes(b"PK\x03\x04" + b"\0" * 20)
        mxt.nd.load(str(bad))
