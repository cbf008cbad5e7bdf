"""The port's data layer against the JAX package's, on the CPU: RecordIO,
image decoding, resizing and augmenters, the data iterators and the Gluon
datasets over RecordIO files and image folders.

- RecordIO: ``MXRecordIO``/``MXIndexedRecordIO`` files (and ``.idx``
  sidecars), ``pack``/``unpack`` and ``pack_img`` (PNG and JPEG) are the
  same bytes in both packages; each package reads the other's.
- ``imresize`` against ``jax.image.resize`` (``linear``, upsampling and
  downsampling with its antialiasing, and ``nearest``): float32 within 1e-5
  of the largest value, uint8 within 1 (the float result truncated).
- The 12 augmenters, ``CreateAugmenter``, ``ImageIter``,
  ``ImageRecordIter`` (crops, mirrors, shuffle, mean/std, one decode
  thread) and the detection pipeline (``ImageDetRecordIter``,
  ``ImageDetIter`` and its augmenters) from one seed: the same random draws
  as the JAX package's, outputs within 1e-5 of the largest value; where a
  uint8 image is resized first, within one grey level (the truncation of
  a float result the two packages round differently) on fewer than 5 % of
  the values.
- The iterators (``NDArrayIter`` in its three last-batch modes and
  shuffled, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter``,
  ``LibSVMIter``, ``MNISTIter``) give the JAX package's batches exactly,
  on the host.
- ``nd.imdecode``, ``RecordFileDataset``, ``ImageRecordDataset`` and
  ``ImageFolderDataset`` give the JAX package's items exactly.
"""
import os
import random

import jax
import jax.numpy as jnp
import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import image as jimage
from incubator_mxnet_tpu import recordio as jrec

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import image as timage
from incubator_mxnet_tpu_torch import recordio as trec

TOL = 1e-5
CPU = mxt.cpu()


def _close(got, want, what="", tol=TOL):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(onp.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(onp.abs(got - want).max()) / scale if got.size else 0.0
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


def _img(seed, h=20, w=24):
    return onp.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype("uint8")


def _seed(s):
    random.seed(s)
    onp.random.seed(s)


# ================================================================ RecordIO

def _write_records(rec, path, idx=None):
    w = rec.MXIndexedRecordIO(idx, path, "w") if idx else \
        rec.MXRecordIO(path, "w")
    for i in range(6):
        hdr = rec.IRHeader(0, float(i), i, 0) if i % 2 else \
            rec.IRHeader(0, [float(i), 0.5, 2.0], i, 7)
        payload = rec.pack(hdr, b"payload-%d" % i * (i + 1))
        if idx:
            w.write_idx(i, payload)
        else:
            w.write(payload)
    w.close()


@pytest.mark.parametrize("indexed", [False, True])
def test_recordio_files_are_the_references_byte_for_byte(tmp_path, indexed):
    paths = {}
    for name, rec in (("jax", jrec), ("port", trec)):
        p = str(tmp_path / (name + ".rec"))
        idx = str(tmp_path / (name + ".idx")) if indexed else None
        _write_records(rec, p, idx)
        paths[name] = (p, idx)
    for k in (0, 1) if indexed else (0,):
        with open(paths["jax"][k], "rb") as a, open(paths["port"][k], "rb") as b:
            assert a.read() == b.read()
    # each package reads the other's file
    for reader, (p, idx) in ((trec, paths["jax"]), (jrec, paths["port"])):
        r = reader.MXIndexedRecordIO(idx, p, "r") if indexed else \
            reader.MXRecordIO(p, "r")
        for i in ([4, 1, 3] if indexed else range(6)):
            raw = r.read_idx(i) if indexed else r.read()
            hdr, body = reader.unpack(raw)
            assert body == b"payload-%d" % i * (i + 1)
            assert hdr.id == i
        r.close()


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_pack_img_is_the_references(fmt):
    img = _img(1)
    hdr = jrec.IRHeader(0, 3.0, 9, 0)
    a = jrec.pack_img(hdr, img, quality=90, img_fmt=fmt)
    b = trec.pack_img(trec.IRHeader(0, 3.0, 9, 0), img, quality=90,
                      img_fmt=fmt)
    assert a == b
    (h1, i1), (h2, i2) = jrec.unpack_img(a, 1), trec.unpack_img(a, 1)
    assert tuple(h1) == tuple(h2)
    onp.testing.assert_array_equal(i1, i2)
    onp.testing.assert_array_equal(
        timage.imdecode(a[24:]).asnumpy(), jimage.imdecode(a[24:]).asnumpy())
    onp.testing.assert_array_equal(
        mxt.nd.imdecode(a[24:], channels=1).asnumpy(),
        mx.nd.imdecode(a[24:], channels=1).asnumpy())


# ================================================================ resize

@pytest.mark.parametrize("size,interp", [((31, 27), 1), ((9, 7), 1),
                                         ((40, 10), 1), ((9, 33), 0),
                                         ((30, 17), 0)])
def test_imresize_is_jax_image_resize(size, interp):
    w, h = size
    x = onp.random.RandomState(2).rand(20, 24, 3).astype("float32") * 255
    want = jax.jit(lambda a: jax.image.resize(
        a, (h, w, 3), method="linear" if interp else "nearest"))(
            jnp.asarray(x))
    got = timage.imresize(mxt.nd.array(x, ctx=CPU), w, h, interp)
    _close(got.asnumpy(), onp.asarray(want), "float32")
    u8 = x.astype("uint8")
    want8 = jimage.imresize(mx.nd.array(u8, dtype="uint8"), w, h, interp)
    got8 = timage.imresize(mxt.nd.array(u8, ctx=CPU, dtype="uint8"), w, h,
                           interp)
    diff = onp.abs(got8.asnumpy().astype(int) - want8.asnumpy().astype(int))
    assert got8.dtype == onp.uint8 and diff.max() <= 1


# ================================================================ augmenters

def _augs(pkg):
    im = pkg.image
    eigval = [55.46, 4.794, 1.148]
    eigvec = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
              [-0.5836, -0.6948, 0.4203]]
    return [
        ("ResizeAug", im.ResizeAug(14)),
        ("RandomCropAug", im.RandomCropAug((10, 8))),
        ("CenterCropAug", im.CenterCropAug((10, 8))),
        ("HorizontalFlipAug", im.HorizontalFlipAug(0.7)),
        ("CastAug", im.CastAug()),
        ("ColorNormalizeAug", im.ColorNormalizeAug([120.0, 110.0, 100.0],
                                                   [50.0, 60.0, 70.0])),
        ("BrightnessJitterAug", im.BrightnessJitterAug(0.3)),
        ("ContrastJitterAug", im.ContrastJitterAug(0.3)),
        ("SaturationJitterAug", im.SaturationJitterAug(0.3)),
        ("ColorJitterAug", im.ColorJitterAug(0.2, 0.3, 0.4)),
        ("LightingAug", im.LightingAug(0.1, eigval, eigvec)),
        ("RandomGrayAug", im.RandomGrayAug(0.6)),
    ]


AUG_NAMES = [n for n, _ in _augs(mx)]


@pytest.mark.parametrize("k", range(len(AUG_NAMES)), ids=AUG_NAMES)
def test_augmenter_is_the_references(k):
    img = _img(3).astype("float32")
    outs = []
    for pkg in (mx, mxt):
        aug = _augs(pkg)[k][1]
        src = mx.nd.array(img) if pkg is mx else mxt.nd.array(img, ctx=CPU)
        got = []
        _seed(11)
        for _ in range(4):
            got.append(aug(src).asnumpy())
        outs.append(got)
    for g, w in zip(outs[1], outs[0]):
        _close(g, w, AUG_NAMES[k])


def _grey_close(got, want, what, std):
    """uint8 resizing truncates a float result that the two packages round
    differently by ~1e-5, so a pixel can differ by one grey level: after
    normalising by ``std`` and jitters of at most 1.5x, 1.5 / std."""
    err = onp.abs(onp.asarray(got, "float64") - onp.asarray(want, "float64"))
    assert err.max() <= 1.5 / std, (what, err.max())
    assert (err > 1e-4).mean() < 0.05, (what, (err > 1e-4).mean())


@pytest.mark.parametrize("resize", [0, 16])
def test_create_augmenter_and_image_iter_are_the_references(tmp_path, resize):
    files = []
    for i in range(5):
        p = str(tmp_path / ("im%d.png" % i))
        with open(p, "wb") as f:
            f.write(jrec.pack_img(jrec.IRHeader(0, 0.0, 0, 0), _img(i, 18, 22),
                                  img_fmt=".png")[24:])
        files.append((float(i % 3), p))
    kw = dict(resize=resize, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.2, contrast=0.2, saturation=0.2,
              pca_noise=0.05, rand_gray=0.3)
    assert [type(a).__name__ for a in timage.CreateAugmenter(
        (3, 12, 12), **kw)] == [type(a).__name__ for a in
                                jimage.CreateAugmenter((3, 12, 12), **kw)]
    batches = []
    for pkg in (mx, mxt):
        _seed(5)
        it = pkg.image.ImageIter(2, (3, 12, 12), imglist=files, **kw)
        batches.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                        for b in it])
    assert len(batches[1]) == len(batches[0]) == 3
    for (gd, gl), (wd, wl) in zip(*batches[::-1]):
        if resize:
            _grey_close(gd, wd, "ImageIter data", std=57.12)
        else:
            _close(gd, wd, "ImageIter data")
        onp.testing.assert_array_equal(gl, wl)


# ================================================================ .rec iters

def _image_rec(tmp_path, n=7, det=False):
    path = str(tmp_path / ("det.rec" if det else "img.rec"))
    idx = path[:-4] + ".idx"
    w = jrec.MXIndexedRecordIO(idx, path, "w")
    for i in range(n):
        if det:
            label = [2.0, 5.0, float(i % 3), 0.1, 0.2, 0.6, 0.7,
                     1.0, 0.3, 0.1, 0.9, 0.5][: 2 + 5 * (1 + i % 2)]
        else:
            label = float(i % 4)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, label, i, 0),
                                     _img(20 + i, 20, 24), img_fmt=".png"))
    w.close()
    return path


def test_image_record_iter_is_the_references(tmp_path):
    path = _image_rec(tmp_path)
    kw = dict(path_imgrec=path, data_shape=(3, 16, 16), batch_size=3,
              shuffle=True, rand_crop=True, rand_mirror=True, mean_r=120.0,
              mean_g=110.0, mean_b=100.0, std_r=50.0, std_g=60.0,
              std_b=70.0, preprocess_threads=1, seed=4, force_python=True)
    outs = []
    for pkg in (mx, mxt):
        it = pkg.io.ImageRecordIter(**kw)
        got = []
        for _ in range(2):
            it.reset()
            got.extend((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                       for b in it)
        outs.append(got)
    assert len(outs[1]) == len(outs[0]) == 6
    for (gd, gl, gp), (wd, wl, wp) in zip(outs[1], outs[0]):
        _close(gd, wd, "data")
        onp.testing.assert_array_equal(gl, wl)
        assert gp == wp
    it = mxt.io.ImageRecordIter(**kw)
    b = next(iter(it))
    assert b.data[0].context == CPU
    assert it.provide_data[0].shape == (3, 3, 16, 16)


def test_image_det_record_iter_and_image_det_iter_are_the_references(tmp_path):
    path = _image_rec(tmp_path, n=5, det=True)
    kw = dict(path_imgrec=path, data_shape=(3, 16, 16), batch_size=2,
              rand_mirror=True, label_pad_width=4, preprocess_threads=1,
              seed=2)
    outs = []
    for pkg in (mx, mxt):
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy())
               for b in pkg.io.ImageDetRecordIter(**kw)]
        outs.append(got)
    for (gd, gl), (wd, wl) in zip(outs[1], outs[0]):
        _close(gd, wd, "det data")
        _close(gl, wl, "det labels")
    files = []
    for i in range(3):
        p = str(tmp_path / ("d%d.png" % i))
        with open(p, "wb") as f:
            f.write(jrec.pack_img(jrec.IRHeader(0, 0.0, 0, 0), _img(i, 30, 26),
                                  img_fmt=".png")[24:])
        files.append(([[1, 0.1, 0.2, 0.5, 0.6], [0, 0.4, 0.3, 0.9, 0.8]], p))
    outs = []
    for pkg in (mx, mxt):
        _seed(9)
        it = pkg.image.ImageDetIter(1, (3, 16, 16), imglist=files,
                                    label_pad_width=3, rand_crop=0.5,
                                    rand_mirror=True, mean=[100, 100, 100],
                                    std=[50, 50, 50])
        outs.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                     for b in it])
    for (gd, gl), (wd, wl) in zip(outs[1], outs[0]):
        _grey_close(gd, wd, "ImageDetIter data", std=50.0)
        _close(gl, wl, "ImageDetIter labels")


# ================================================================ iterators

@pytest.mark.parametrize("mode", ["pad", "discard", "roll_over"])
def test_ndarray_iter_is_the_references(mode):
    x = onp.arange(40, dtype="float32").reshape(10, 4)
    y = onp.arange(10, dtype="float32")
    got = []
    for pkg in (mx, mxt):
        _seed(3)
        it = pkg.io.NDArrayIter({"a": x, "b": x * 2}, y, batch_size=4,
                                shuffle=True, last_batch_handle=mode)
        batches = []
        for _ in range(2):
            it.reset()
            batches.extend(([d.asnumpy() for d in b.data],
                            b.label[0].asnumpy(), b.pad) for b in it)
        got.append((batches, [tuple(d) for d in it.provide_data]))
    assert got[0] == got[0] and len(got[1][0]) == len(got[0][0])
    for (gd, gl, gp), (wd, wl, wp) in zip(got[1][0], got[0][0]):
        for a, b in zip(gd, wd):
            onp.testing.assert_array_equal(a, b)
        onp.testing.assert_array_equal(gl, wl)
        assert gp == wp
    assert got[1][1] == got[0][1]


def test_ndarray_iter_hands_out_host_arrays():
    it = mxt.io.NDArrayIter(onp.ones((4, 2), "float32"), batch_size=2)
    b = next(iter(it))
    assert b.data[0].context == CPU and b.label == []


def test_resize_prefetching_csv_libsvm_and_mnist_iters(tmp_path):
    x = onp.arange(24, dtype="float32").reshape(12, 2)
    csv = str(tmp_path / "d.csv")
    onp.savetxt(csv, x, delimiter=",")
    svm = str(tmp_path / "d.svm")
    with open(svm, "w") as f:
        f.write("1 0:1.5 3:2\n0 1:-1\n1 2:0.5 4:4\n")
    for make in (
            lambda pkg: pkg.io.ResizeIter(pkg.io.NDArrayIter(x, batch_size=5),
                                          4),
            lambda pkg: pkg.io.PrefetchingIter(
                pkg.io.NDArrayIter(x, batch_size=5)),
            lambda pkg: pkg.io.CSVIter(data_csv=csv, data_shape=(2,),
                                       batch_size=5),
            lambda pkg: pkg.io.MNISTIter(batch_size=7, shuffle=False)):
        want = [b.data[0].asnumpy() for _, b in zip(range(4), make(mx))]
        got = [b.data[0].asnumpy() for _, b in zip(range(4), make(mxt))]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            onp.testing.assert_array_equal(g, w)
    jb = list(mx.io.LibSVMIter(data_libsvm=svm, data_shape=(5,),
                               batch_size=2))
    tb = list(mxt.io.LibSVMIter(data_libsvm=svm, data_shape=(5,),
                                batch_size=2))
    assert len(tb) == len(jb) == 2
    for g, w in zip(tb, jb):
        onp.testing.assert_array_equal(g.data[0].tostype("default").asnumpy(),
                                       w.data[0].tostype("default").asnumpy())
        onp.testing.assert_array_equal(g.label[0].asnumpy(),
                                       w.label[0].asnumpy())
        assert g.pad == w.pad


# ================================================================ datasets

def test_record_datasets_and_image_folder_are_the_references(tmp_path):
    path = _image_rec(tmp_path, n=4)
    jd = mx.gluon.data.RecordFileDataset(path)
    td = mxt.gluon.data.RecordFileDataset(path)
    assert len(td) == len(jd) == 4 and [td[i] for i in range(4)] == \
        [jd[i] for i in range(4)]
    for flag in (1, 0):
        jd = mx.gluon.data.vision.ImageRecordDataset(path, flag=flag)
        td = mxt.gluon.data.vision.ImageRecordDataset(path, flag=flag)
        for i in range(4):
            (ti, tl), (ji, jl) = td[i], jd[i]
            onp.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
            assert float(tl) == float(jl)
    root = tmp_path / "folder"
    for c, cls in enumerate(("cat", "dog")):
        os.makedirs(str(root / cls))
        for i in range(2):
            with open(str(root / cls / ("%d.png" % i)), "wb") as f:
                f.write(jrec.pack_img(jrec.IRHeader(0, 0.0, 0, 0),
                                      _img(10 * c + i), img_fmt=".png")[24:])
    jf = mx.gluon.data.vision.ImageFolderDataset(str(root))
    tf = mxt.gluon.data.vision.ImageFolderDataset(str(root))
    assert tf.synsets == jf.synsets == ["cat", "dog"] and len(tf) == 4
    for i in range(4):
        onp.testing.assert_array_equal(tf[i][0].asnumpy(), jf[i][0].asnumpy())
        assert tf[i][1] == jf[i][1]
