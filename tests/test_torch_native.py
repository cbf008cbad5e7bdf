"""The port's native library (``incubator_mxnet_tpu_torch/native``) against
the JAX package's, on the CPU.

Both are built from the same C++ (``native/src/recordio.cc``, ``image.cc``,
``c_api.cc``), the port's with ``g++`` into the checkout's ``build/native/``
(one library a digest of its sources and flags, built once a session). The
RecordIO writer and scanner, the batch reader, the JPEG pipeline, the
flat C ABI's iterator and ``ImageRecordIter``'s two native tiers give the
JAX package's bytes, bit for bit, on the same seeded files. The JAX
package's own ``test_native.py``, ``test_native_tsan.py`` (over the port's
copy of the sources) and ``test_cpp_package.py`` (the C ABI in process,
and cpp_package's predict, train_mlp and kvstore_io binaries, unchanged,
over the port's libmxtpu_predict through ``MXTPU_PREDICT_LIB``, their
embedded interpreter on the CPU through ``MXTPU_CAPI_CONTEXT``) run
against the port.
"""
import ast
import inspect
import os

import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.native import capi as jcapi
from incubator_mxnet_tpu.native import lib as jlib

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.native import capi as tcapi
from incubator_mxnet_tpu_torch.native import lib as tlib

from test_torch_interop import _port_tests


@pytest.fixture(autouse=True, scope="module")
def _native_libraries():
    """Both libraries, built where this file runs (not where it is
    collected); a failed build fails the tests."""
    if not (jlib.available() and tlib.available()):
        pytest.skip("no g++ here to build the native libraries")


def _write(lib, path, payloads):
    h = lib.rio_writer_open(path.encode())
    assert h
    for p in payloads:
        assert lib.rio_write(h, p, len(p)) == 0
    lib.rio_writer_close(h)


def _jpeg_rec(tmp_path, n=13, name="img.rec", fmt=".jpg"):
    """A .rec of ``n`` seeded RGB images (sizes vary) with labels."""
    path = str(tmp_path / name)
    rng = onp.random.RandomState(7)
    w = mxt.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        img = rng.randint(0, 256, (36 + 2 * i, 44, 3)).astype("uint8")
        w.write_idx(i, mxt.recordio.pack_img(
            mxt.recordio.IRHeader(0, float(i % 5), i, 0), img, quality=90,
            img_fmt=fmt))
    w.close()
    return path


def _epochs(it, n=2):
    """Every batch of ``n`` epochs, copied as it comes: a batch of the JAX
    package's native tiers may alias the pipeline's reused host buffer
    (its ``nd.array`` takes the CPU buffer without a copy), so one kept
    past the next ``next()`` changes (ROADMAP §3, reference faults)."""
    got = []
    for _ in range(n):
        it.reset()
        got.extend((b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy(),
                    b.pad) for b in it)
    return got


def test_library_builds_under_build_native_by_digest():
    path = tlib.build()
    assert os.path.dirname(path) == tlib.BUILD_DIR
    assert os.path.basename(path).startswith("libmxtpu-")
    assert os.readlink(os.path.join(tlib.BUILD_DIR, "libmxtpu.so")) == \
        os.path.basename(path)
    assert tlib.build() == path            # built once: the same file
    native_dir = os.path.dirname(tlib.__file__)
    assert not [f for f in os.listdir(native_dir) if f.endswith(".so")]


def test_failed_build_raises_with_gpp_output(monkeypatch, tmp_path):
    monkeypatch.setattr(tlib, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "bad.cc"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*bad.cc"):
        tlib._compile("libbad", [str(src)], ["-shared", "-fPIC"])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


def test_no_native_and_force_python_take_the_python_tier(monkeypatch,
                                                         tmp_path):
    rec = _jpeg_rec(tmp_path, n=4)
    kw = dict(path_imgrec=rec, data_shape=(3, 24, 24), batch_size=2)
    assert mxt.io.ImageRecordIter(**kw).tier == 1
    assert mxt.io.ImageRecordIter(force_python=True, **kw).tier == 3
    png = _jpeg_rec(tmp_path, n=4, name="png.rec", fmt=".png")
    assert mxt.io.ImageRecordIter(**dict(kw, path_imgrec=png)).tier == 2
    assert mxt.io.ImageRecordIter(**dict(kw, data_shape=(1, 24, 24))) \
        .tier == 2
    monkeypatch.setenv("MXTPU_NO_NATIVE", "1")
    assert not tlib.available()
    assert mxt.io.ImageRecordIter(**kw).tier == 3
    assert mxt.runtime.Features().is_enabled("NATIVE_RECORDIO") is False


def test_writer_scan_and_reader_bytes_are_the_references(tmp_path):
    rng = onp.random.RandomState(3)
    payloads = [rng.bytes(n) for n in (1, 3, 4, 7, 1024, 5000, 0, 9)]
    paths = {}
    for tag, lib in (("jax", jlib), ("port", tlib)):
        paths[tag] = str(tmp_path / (tag + ".rec"))
        _write(lib.get(), paths[tag], payloads)
    with open(paths["jax"], "rb") as f, open(paths["port"], "rb") as g:
        assert f.read() == g.read()
    for a, b in zip(jlib.scan_offsets(paths["jax"]),
                    tlib.scan_offsets(paths["port"])):
        onp.testing.assert_array_equal(a, b)
    for shuffle in (False, True):
        got = {}
        for tag, lib in (("jax", jlib), ("port", tlib)):
            rd = lib.NativeBatchReader(paths[tag], batch_size=3,
                                       shuffle=shuffle, seed=11,
                                       num_threads=2)
            got[tag] = []
            for _ in range(2):
                while True:
                    b = rd.next()
                    if b is None:
                        break
                    got[tag].append(b)
                rd.reset(reshuffle=shuffle)
        assert got["port"] == got["jax"]
        epoch = sum(got["port"][:3], [])
        assert len(epoch) == 9 and set(epoch) == set(payloads)


def test_image_pipeline_is_the_references_bit_for_bit(tmp_path):
    """The C++ JPEG pipeline (decode, short-side resize, centre crop,
    mean/std; shuffled, 3 threads) gives the JAX package's floats."""
    rec = _jpeg_rec(tmp_path)
    kw = dict(batch_size=4, data_shape=(3, 28, 28), resize_short=30,
              mean_rgb=(120.0, 110.0, 100.0), std_rgb=(50.0, 60.0, 70.0),
              shuffle=True, seed=5, num_threads=3)
    got = {}
    for tag, lib in (("jax", jlib), ("port", tlib)):
        pipe = lib.NativeImagePipeline(rec, **kw)
        got[tag] = []
        while True:
            b = pipe.next()
            if b is None:
                break
            got[tag].append((b[0].copy(), b[1].copy(), b[2]))
    assert len(got["port"]) == len(got["jax"]) == 4
    for (gd, gl, gb), (wd, wl, wb) in zip(got["port"], got["jax"]):
        assert gb == wb == 0
        onp.testing.assert_array_equal(gd, wd)
        onp.testing.assert_array_equal(gl, wl)


def test_image_record_iter_native_tiers_are_the_references(tmp_path):
    """ImageRecordIter's tier 1 (JPEG) and tier 2 (PNG: the native reader,
    PIL decode) against the JAX package's, over two epochs: the same
    batches and the same pad on the wrapped last batch."""
    for fmt, tier, extra in ((".jpg", 1, dict(resize=30,
                                               preprocess_threads=3)),
                             (".png", 2, dict(rand_crop=True,
                                              rand_mirror=True,
                                              preprocess_threads=1))):
        rec = _jpeg_rec(tmp_path, n=10, name="t%d.rec" % tier, fmt=fmt)
        kw = dict(path_imgrec=rec, data_shape=(3, 28, 28), batch_size=4,
                  mean_r=120.0, std_r=50.0, seed=6, **extra)
        it = mxt.io.ImageRecordIter(**kw)
        assert it.tier == tier
        port = _epochs(it)
        ref = _epochs(mx.io.ImageRecordIter(**kw))
        assert [p for _, _, p in port] == [p for _, _, p in ref] == \
            [0, 0, 2] * 2
        for (gd, gl, _), (wd, wl, _) in zip(port, ref):
            onp.testing.assert_array_equal(gd, wd)
            onp.testing.assert_array_equal(gl, wl)
        it.reset()             # the port's batches own their arrays
        kept = [(b, b.data[0].asnumpy().copy()) for b in it]
        assert kept[0][0].data[0].context == mxt.cpu()
        for b, d in kept:
            onp.testing.assert_array_equal(b.data[0].asnumpy(), d)


def test_c_abi_iterator_and_arrays_are_the_references(tmp_path):
    rec = _jpeg_rec(tmp_path, n=6)
    got = {}
    for tag, capi in (("jax", jcapi), ("port", tcapi)):
        it = capi.CImageRecordIter(rec, 4, (3, 20, 20), resize_short=22,
                                   mean_rgb=(1.0, 2.0, 3.0), num_threads=2)
        got[tag] = []
        while True:
            b = it.next()
            if b is None:
                break
            got[tag].append((b[0].asnumpy(), b[1].asnumpy()))
        arr = capi.CArray((2, 3), "int32").copy_from(
            onp.arange(6).reshape(2, 3))
        assert arr.shape == (2, 3) and arr.dtype == onp.int32
        onp.testing.assert_array_equal(arr.asnumpy(),
                                       onp.arange(6).reshape(2, 3))
    assert len(got["port"]) == len(got["jax"]) == 2
    for (gd, gl), (wd, wl) in zip(got["port"], got["jax"]):
        assert gd.shape == (4, 3, 20, 20) and gl.shape == (4, 1)
        onp.testing.assert_array_equal(gd, wd)
        onp.testing.assert_array_equal(gl, wl)


def _test_names(name):
    """The test functions of ``tests/<name>``, read without importing it
    (its module-level skip would build the library at collection)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    with open(path) as f:
        tree = ast.parse(f.read())
    return sorted(n.name for n in tree.body if isinstance(
        n, ast.FunctionDef) and n.name.startswith("test_"))


_REFERENCE = {name: _test_names(name) for name in (
    "test_native.py", "test_native_tsan.py", "test_cpp_package.py")}


@pytest.mark.parametrize("where", sorted(
    (name, k) for name, tests in _REFERENCE.items() for k in tests),
    ids=lambda w: "%s::%s" % w)
def test_reference_native_tests_hold(where, tmp_path, monkeypatch):
    """The JAX package's native and C++ client tests, every name of the
    JAX package read as the port's."""
    monkeypatch.setenv("MXTPU_CAPI_CONTEXT", "cpu")
    name, test = where
    fn = _port_tests(name, lambda k: k == test)[test]
    with mxt.cpu():
        fn(*[tmp_path for _ in inspect.signature(fn).parameters])
