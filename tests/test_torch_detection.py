"""The port's MultiBox, detection and ``nd.contrib`` operators against the
JAX package's, on the CPU.

Every operator of ``ops/multibox.py``, ``ops/detection.py`` and the ported
part of ``ndarray/contrib.py`` runs on the same numpy inputs (float32, from
a seed) through both packages. Index outputs (class ids, matches, kept
rows, sort orders) are exact; values within 1e-5 of the largest value of
the reference's output. The gradients of ``roi_align``,
``bilinear_sampler`` and ``spatial_transformer`` (and ``ROIAlign``,
``RROIAlign``, ``gradientmultiplier``) are held against ``jax.vjp`` of the
JAX package's operator, within 1e-5 of the largest.

Where the port departs from the JAX package on purpose, a test says so by
name (``test_*_departs_*``) and holds the port to MXNet's behaviour:

- ``MultiBoxTarget``: a valid box whose best anchor is anchor 0 forces it
  positive even beside padding rows (which also pick anchor 0), where the
  JAX package's duplicate-index scatter leaves the winner undefined;
- ``MultiBoxDetection`` honours ``nms_topk``, which the JAX package
  ignores (with -1, or at least the anchor count, the rows are equal);
- ``box_nms`` honours ``in_format``/``out_format``, which the JAX package
  ignores.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.ndarray import NDArray as JNDArray
from incubator_mxnet_tpu.ndarray import contrib as jcontrib
from incubator_mxnet_tpu.ops import detection as jdet
from incubator_mxnet_tpu.ops import multibox as jmb

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.ndarray import contrib as tcontrib
from incubator_mxnet_tpu_torch.ops import detection as tdet
from incubator_mxnet_tpu_torch.ops import multibox as tmb

TOL = 1e-5


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return onp.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _close(got, want, what=""):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(onp.nanmax(onp.abs(want))) if want.size else 0.0,
                1e-30)
    assert onp.array_equal(onp.isnan(got), onp.isnan(want)), what
    err = onp.nan_to_num(onp.abs(got - want)).max() if got.size else 0.0
    assert err <= TOL * scale, "%s: %.3g of the largest value" % (what,
                                                                   err / scale)


def _exact(got, want, what=""):
    assert onp.array_equal(onp.asarray(got), onp.asarray(want)), what


def _datas(out):
    if isinstance(out, (list, tuple)):
        return [_datas(o) for o in out]
    return out._data


def _jitted(jfn):
    """The JAX package's operator traced once into one program (its
    NDArray operations take tracers), so a test compiles it once rather
    than op by op."""
    return jax.jit(lambda *xs: _datas(jfn(*[JNDArray(x) for x in xs])))


def _both(jfn, tfn, *arrays):
    """(the JAX package's outputs, the port's) of the same numpy arrays."""
    want = _jitted(jfn)(*[jnp.asarray(a) for a in arrays])
    with mxt.cpu():
        got = tfn(*[mxt.nd.array(a, ctx=mxt.cpu()) for a in arrays])
    return _np(want), _np(got)


def _vjp_check(jfn, tfn, arrays, diff, seed=7):
    """Gradients of <op(arrays), cotangent> for the arrays at ``diff``:
    ``jax.vjp`` of the JAX package's operator against the port's autograd."""
    jin = [jnp.asarray(a) for a in arrays]

    def jf(*xs):
        full = list(jin)
        for i, x in zip(diff, xs):
            full[i] = x
        return jfn(*[JNDArray(x) for x in full])._data
    out, vjp = jax.vjp(jax.jit(jf), *[jin[i] for i in diff])
    cot = onp.random.RandomState(seed).randn(*out.shape).astype("float32")
    want = vjp(jnp.asarray(cot))
    tin = [torch.tensor(a, requires_grad=i in diff)
           for i, a in enumerate(arrays)]
    tout = tfn(*tin)
    got = torch.autograd.grad(tout, [tin[i] for i in diff],
                              torch.from_numpy(cot))
    _close(tout.detach(), out, "forward")
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, "gradient %d" % i)


# =================================================================== multibox

@pytest.mark.parametrize("kw", [
    dict(sizes=(0.2, 0.272), ratios=(1, 2, 0.5)),
    dict(sizes=(0.5,), ratios=(1.0,), clip=True),
    dict(sizes=(0.3, 0.6, 0.9), ratios=(1, 3), steps=(0.25, 0.2),
         offsets=(0.4, 0.6), clip=True)])
def test_multibox_prior(kw):
    x = onp.zeros((1, 2, 5, 4), "float32")
    want, got = _both(lambda d: jmb.MultiBoxPrior(d, **kw),
                      lambda d: tmb.MultiBoxPrior(d, **kw), x)
    _close(got, want)


def test_multibox_box_iou():
    rng = onp.random.RandomState(1)
    a = onp.sort(rng.rand(7, 2, 2), axis=1).reshape(7, 4)[:, [0, 2, 1, 3]]
    b = onp.sort(rng.rand(5, 2, 2), axis=1).reshape(5, 4)[:, [0, 2, 1, 3]]
    b[0] = [0.5, 0.5, 0.5, 0.5]                      # empty box
    want = jmb.box_iou(jnp.asarray(a), jnp.asarray(b))
    with mxt.cpu():
        got = tmb.box_iou(mxt.nd.array(a, ctx=mxt.cpu()),
                          mxt.nd.array(b, ctx=mxt.cpu()))
    _close(_np(got), want)


def _anchors(h=6, w=6):
    x = onp.zeros((1, 1, h, w), "float32")
    return _np(_jitted(lambda d: jmb.MultiBoxPrior(
        d, sizes=(0.25, 0.4), ratios=(1, 2, 0.5)))(x))


def _labels():
    """Two images, three rows each: boxes and padding (class -1)."""
    return onp.array([[[1, 0.1, 0.1, 0.45, 0.5], [0, 0.5, 0.4, 0.9, 0.95],
                       [-1, 0, 0, 0, 0]],
                      [[2, 0.2, 0.3, 0.6, 0.7], [-1, 0, 0, 0, 0],
                       [-1, 0, 0, 0, 0]]], "float32")


@pytest.mark.parametrize("mining", [-1, 3])
def test_multibox_target(mining):
    anc = _anchors()
    rng = onp.random.RandomState(2)
    cls_pred = rng.randn(2, 4, anc.shape[1]).astype("float32")
    kw = dict(negative_mining_ratio=mining, overlap_threshold=0.4)
    want, got = _both(lambda a, l, c: jmb.MultiBoxTarget(a, l, c, **kw),
                      lambda a, l, c: tmb.MultiBoxTarget(a, l, c, **kw),
                      anc, _labels(), cls_pred)
    _close(got[0], want[0], "loc_target")
    _exact(got[1], want[1], "loc_mask")
    _exact(got[2], want[2], "cls_target")
    assert (got[2] > 0).sum() >= 3
    if mining > 0:
        assert (got[2] == -1).any() and (got[2] == 0).any()


def test_multibox_target_mining_ties_in_anchor_order():
    """A fresh class head gives equal background probabilities: the
    negatives kept are the first anchors in order (a stable sort), in both
    packages."""
    anc = _anchors()
    cls_pred = onp.zeros((2, 4, anc.shape[1]), "float32")
    kw = dict(negative_mining_ratio=3)
    want, got = _both(lambda a, l, c: jmb.MultiBoxTarget(a, l, c, **kw),
                      lambda a, l, c: tmb.MultiBoxTarget(a, l, c, **kw),
                      anc, _labels(), cls_pred)
    _exact(got[2], want[2], "cls_target")
    neg = onp.flatnonzero(got[2][0] == 0)
    assert len(neg) and (neg == onp.sort(neg)).all()
    first = onp.flatnonzero(got[2][0] <= 0)[:len(neg)]
    assert set(neg) == set(first)


def test_multibox_target_departs_on_the_anchor_0_collision():
    """A real box whose best anchor is anchor 0, beside padding rows whose
    (all -1) IoU also picks anchor 0: MXNet's multibox_target.cc skips the
    padding rows, so anchor 0 is positive, matched to the box. The JAX
    package's scatter of duplicate indices leaves the winner undefined; the
    port's OR of the valid rows is the reference behaviour we keep."""
    anc = _anchors()
    box = [3, 0.0, 0.0, 0.12, 0.12]             # inside anchor 0, IoU 0.23
    label = onp.array([[box, [-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0]]],
                      "float32")
    iou = _np(jmb.box_iou(jnp.asarray(anc[0]), jnp.asarray(label[0, :1, 1:])))
    assert iou[:, 0].argmax() == 0 and iou[0, 0] < 0.5   # forced, not by IoU
    cls_pred = onp.zeros((1, 5, anc.shape[1]), "float32")
    with mxt.cpu():
        loc, mask, cls_t = _np(tmb.MultiBoxTarget(
            mxt.nd.array(anc, ctx=mxt.cpu()),
            mxt.nd.array(label, ctx=mxt.cpu()),
            mxt.nd.array(cls_pred, ctx=mxt.cpu())))
    assert cls_t[0, 0] == 4.0 and mask[0, :4].tolist() == [1, 1, 1, 1]
    assert onp.abs(loc[0, :4]).max() > 0
    # everything else is the JAX package's
    want = _np(_jitted(jmb.MultiBoxTarget)(anc, label, cls_pred))
    _exact(cls_t[0, 1:], want[2][0, 1:], "other anchors")


def _detection_inputs(a, classes=3, seed=3):
    rng = onp.random.RandomState(seed)
    logits = rng.randn(2, classes + 1, a).astype("float32") * 2
    prob = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(2, a * 4) * 0.5).astype("float32")
    return prob.astype("float32"), loc


@pytest.mark.parametrize("kw", [
    dict(nms_threshold=0.45), dict(nms_threshold=0.3, force_suppress=True),
    dict(nms_threshold=0.5, threshold=0.3, clip=False),
    dict(nms_threshold=0.45, nms_topk=10 ** 6)])
def test_multibox_detection(kw):
    anc = _anchors(4, 4)
    prob, loc = _detection_inputs(anc.shape[1])
    want, got = _both(lambda c, l, a: jmb.MultiBoxDetection(c, l, a, **kw),
                      lambda c, l, a: tmb.MultiBoxDetection(c, l, a, **kw),
                      prob, loc, anc)
    _exact(got[..., 0], want[..., 0], "class ids")
    _close(got[..., 1:], want[..., 1:], "scores and boxes")
    assert (got[..., 0] >= 0).sum() > 0 and (got[..., 0] == -1).sum() > 0


def test_multibox_detection_departs_by_honouring_nms_topk():
    """Only the nms_topk best candidates enter suppression (MXNet's
    multibox_detection.cc); the JAX package ignores nms_topk. The first
    nms_topk rows equal a detection over those candidates alone, and every
    later row has class id -1; its scores and boxes are the JAX
    package's."""
    anc = _anchors(4, 4)
    prob, loc = _detection_inputs(anc.shape[1])
    k = 7
    with mxt.cpu():
        got = _np(tmb.MultiBoxDetection(
            mxt.nd.array(prob, ctx=mxt.cpu()), mxt.nd.array(loc, ctx=mxt.cpu()),
            mxt.nd.array(anc, ctx=mxt.cpu()), nms_threshold=0.45,
            nms_topk=k))
    full = _np(_jitted(lambda c, l, a: jmb.MultiBoxDetection(
        c, l, a, nms_threshold=0.45, nms_topk=k))(prob, loc, anc))
    _close(got[..., 1:], full[..., 1:], "scores and boxes (sorted)")
    assert (got[:, k:, 0] == -1).all()
    assert ((full[:, k:, 0] >= 0).sum()) > 0        # the reference keeps some
    # the classes before suppression (an IoU never exceeds 2), then greedy
    # suppression among the first k by hand
    unsuppressed = _np(_jitted(lambda c, l, a: jmb.MultiBoxDetection(
        c, l, a, nms_threshold=2.0))(prob, loc, anc))
    for n in range(2):
        rows = full[n, :k]
        cls = unsuppressed[n, :k, 0]
        iou = _np(jmb.box_iou(jnp.asarray(rows[:, 2:]),
                              jnp.asarray(rows[:, 2:])))
        keep = cls >= 0
        for i in range(k):
            if keep[i]:
                for j in range(i + 1, k):
                    if iou[i, j] > 0.45 and cls[j] == cls[i]:
                        keep[j] = False
        _exact(got[n, :k, 0], onp.where(keep, cls, -1.0), "image %d" % n)


# ================================================================= detection

def _rois():
    return onp.array([[0, 0.5, 0.5, 5.5, 4.0], [1, 2.0, 1.0, 7.5, 7.0],
                      [0, 3.2, 2.1, 3.9, 2.9], [5, -1.0, -2.0, 9.0, 9.5]],
                     "float32")


def _feature():
    return onp.random.RandomState(4).randn(2, 3, 8, 8).astype("float32")


@pytest.mark.parametrize("sample_ratio", [1, 2, 3])
def test_roi_align(sample_ratio):
    jfn = lambda d, r: jdet.roi_align(d, r, (3, 2), 0.75,  # noqa: E731
                                      sample_ratio)
    tfn = lambda d, r: tdet.roi_align(d, r, (3, 2), 0.75,  # noqa: E731
                                      sample_ratio)
    want, got = _both(jfn, tfn, _feature(), _rois())
    _close(got, want)
    _vjp_check(jfn, tfn, [_feature(), _rois()], [0, 1])


def test_roi_pooling():
    want, got = _both(lambda d, r: jdet.roi_pooling(d, r, (2, 3), 1.0),
                      lambda d, r: tdet.roi_pooling(d, r, (2, 3), 1.0),
                      _feature(), _rois())
    _close(got, want)


def _theta(n=2):
    rng = onp.random.RandomState(5)
    return (onp.array([[0.9, 0.1, 0.05, -0.1, 1.1, -0.2]] * n)
            + rng.randn(n, 6) * 0.1).astype("float32")


def test_grid_generator():
    want, got = _both(
        lambda t: jdet.grid_generator(t, "affine", (5, 4)),
        lambda t: tdet.grid_generator(t, "affine", (5, 4)), _theta())
    _close(got, want)
    with pytest.raises(ValueError):
        tdet.grid_generator(torch.zeros(1, 6), "warp", (2, 2))


def test_bilinear_sampler():
    rng = onp.random.RandomState(6)
    grid = rng.uniform(-1.2, 1.2, (2, 2, 5, 6)).astype("float32")
    _vjp_check(jdet.bilinear_sampler, tdet.bilinear_sampler,
               [_feature(), grid], [0, 1])


def test_spatial_transformer():
    jfn = lambda d, t: jdet.spatial_transformer(d, t, (6, 5))  # noqa: E731
    tfn = lambda d, t: tdet.spatial_transformer(d, t, (6, 5))  # noqa: E731
    _vjp_check(jfn, tfn, [_feature(), _theta()], [0, 1])


def _boxes(n, seed, batch=()):
    rng = onp.random.RandomState(seed)
    xy = rng.rand(*batch, n, 2) * 0.7
    wh = rng.rand(*batch, n, 2) * 0.4 + 0.05
    return onp.concatenate([xy, xy + wh], -1).astype("float32")


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    want, got = _both(lambda a, b: jdet.box_iou(a, b, fmt),
                      lambda a, b: tdet.box_iou(a, b, fmt),
                      _boxes(6, 7, (2,)), _boxes(4, 8, (2,)))
    _close(got, want)


def _nms_rows(n=12, seed=9, batch=(2,)):
    rng = onp.random.RandomState(seed)
    ids = rng.randint(0, 3, (*batch, n, 1)).astype("float32")
    scores = rng.rand(*batch, n, 1).astype("float32")
    scores[..., :2, 0] = 0.0                      # at the valid threshold
    return onp.concatenate([ids, scores, _boxes(n, seed + 1, batch)], -1)


@pytest.mark.parametrize("kw", [
    dict(), dict(id_index=0), dict(id_index=0, force_suppress=True),
    dict(topk=3, overlap_thresh=0.3), dict(valid_thresh=0.4, id_index=0),
    dict(coord_start=2, score_index=1, overlap_thresh=0.1)])
def test_box_nms(kw):
    want, got = _both(lambda d: jdet.box_nms(d, **kw),
                      lambda d: tdet.box_nms(d, **kw), _nms_rows())
    _exact(got, want)
    assert (got[..., 0] == -1).any() and (got[..., 1] > 0).any()


def test_box_nms_departs_by_honouring_box_formats():
    """MXNet's box_nms reads boxes in ``in_format`` and writes them in
    ``out_format``; the JAX package ignores both. Centre-format input
    gives the JAX package's result on the same boxes in corner format,
    written back in centre format."""
    rows = _nms_rows()
    corner = rows[..., 2:]
    center = onp.concatenate([(corner[..., :2] + corner[..., 2:]) / 2,
                              corner[..., 2:] - corner[..., :2]], -1)
    want = _np(_jitted(lambda d: jdet.box_nms(d, id_index=0))(rows))
    with mxt.cpu():
        got = _np(tdet.box_nms(mxt.nd.array(onp.concatenate(
            [rows[..., :2], center], -1), ctx=mxt.cpu()), id_index=0,
            in_format="center"))
        back = _np(tdet.box_nms(mxt.nd.array(rows, ctx=mxt.cpu()),
                                id_index=0, out_format="center"))
    kept = want[..., 0] >= 0
    _exact(got[..., 0], want[..., 0], "kept rows")
    _close(got[..., 2:][kept], rows[..., 2:][kept], "boxes read as centre")
    _close(back[..., 2:][kept], center[kept], "boxes written as centre")


@pytest.mark.parametrize("is_ascend,threshold,topk", [
    (False, 0.2, -1), (True, 0.6, -1), (False, 0.1, 2)])
def test_bipartite_matching(is_ascend, threshold, topk):
    s = onp.random.RandomState(11).rand(5, 4).astype("float32")
    s[1, 2] = s[3, 0]                                   # a tie
    want, got = _both(
        lambda d: jdet.bipartite_matching(d, threshold, is_ascend, topk),
        lambda d: tdet.bipartite_matching(d, threshold, is_ascend, topk), s)
    _exact(got[0], want[0], "row matches")
    _exact(got[1], want[1], "column matches")


def test_bipartite_matching_batched_equals_each_matrix():
    s = onp.random.RandomState(12).rand(3, 5, 4).astype("float32")
    with mxt.cpu():
        rows, cols = _np(tdet.bipartite_matching(
            mxt.nd.array(s, ctx=mxt.cpu()), 0.3))
    for b in range(3):
        want = _np(jdet.bipartite_matching(mx.nd.array(s[b]), 0.3))
        _exact(rows[b], want[0])
        _exact(cols[b], want[1])


def test_multi_proposal():
    rng = onp.random.RandomState(13)
    kw = dict(feature_stride=8, scales=(2, 4), ratios=(0.5, 1, 2),
              rpn_pre_nms_top_n=40, rpn_post_nms_top_n=9, threshold=0.6,
              rpn_min_size=4)
    cls_prob = rng.rand(2, 12, 4, 5).astype("float32")
    bbox = (rng.randn(2, 24, 4, 5) * 0.2).astype("float32")
    info = onp.array([[30, 38, 1], [26, 40, 1]], "float32")
    want, got = _both(lambda c, b, i: jdet.multi_proposal(c, b, i, **kw),
                      lambda c, b, i: tdet.multi_proposal(c, b, i, **kw),
                      cls_prob, bbox, info)
    _exact(got[:, 0], want[:, 0], "batch index")
    _close(got, want)


def test_fft_and_ifft():
    x = onp.random.RandomState(14).randn(3, 2, 8).astype("float32")
    want, got = _both(jdet.fft, tdet.fft, x)
    _close(got, want, "fft")
    want, got = _both(jdet.ifft, tdet.ifft, want)
    _close(got, want, "ifft")
    _close(got, x * 8, "round trip")


# ============================================================== nd.contrib

def _special():
    return onp.array([[1.0, onp.inf, -onp.inf], [onp.nan, 0.0, -2.0]],
                     "float32")


@pytest.mark.parametrize("name", ["isinf", "isnan", "isfinite"])
def test_contrib_float_predicates(name):
    want, got = _both(getattr(jcontrib, name), getattr(tcontrib, name),
                      _special())
    _exact(got, want)
    assert got.dtype == onp.float32


@pytest.mark.parametrize("sample_ratio", [-1, 2])
def test_contrib_roi_align(sample_ratio):
    jfn = lambda d, r: jcontrib.ROIAlign(d, r, (2, 2), 0.5,  # noqa: E731
                                         sample_ratio)
    tfn = lambda d, r: tcontrib.ROIAlign(d, r, (2, 2), 0.5,  # noqa: E731
                                         sample_ratio)
    want, got = _both(jfn, tfn, _feature(), _rois() * 2)
    _close(got, want)
    _vjp_check(jfn, tfn, [_feature(), _rois() * 2], [0])
    with pytest.raises(NotImplementedError):
        tcontrib.ROIAlign(torch.zeros(1, 1, 2, 2), torch.zeros(1, 5), (1, 1),
                          1.0, position_sensitive=True)


def test_contrib_detection_wrappers():
    rng = onp.random.RandomState(15)
    kw = dict(feature_stride=8, scales=(2,), ratios=(1, 2),
              rpn_pre_nms_top_n=12, rpn_post_nms_top_n=4, rpn_min_size=2)
    args = (rng.rand(1, 4, 3, 3).astype("float32"),
            (rng.randn(1, 8, 3, 3) * 0.1).astype("float32"),
            onp.array([[24, 24, 1]], "float32"))
    want, got = _both(lambda *a: jcontrib.MultiProposal(*a, **kw),
                      lambda *a: tcontrib.MultiProposal(*a, **kw), *args)
    _close(got, want, "MultiProposal")
    want, got = _both(lambda a, b: jcontrib.box_iou(a, b, "center"),
                      lambda a, b: tcontrib.box_iou(a, b, "center"),
                      _boxes(5, 16), _boxes(3, 17))
    _close(got, want, "box_iou")
    want, got = _both(lambda d: jcontrib.box_nms(d, topk=4, id_index=0),
                      lambda d: tcontrib.box_nms(d, topk=4, id_index=0),
                      _nms_rows(batch=()))
    _exact(got, want, "box_nms")
    s = rng.rand(4, 6).astype("float32")
    want, got = _both(lambda d: jcontrib.bipartite_matching(d, True, 0.5),
                      lambda d: tcontrib.bipartite_matching(d, True, 0.5), s)
    _exact(got[0], want[0], "bipartite_matching")
    _exact(got[1], want[1], "bipartite_matching")
    with pytest.raises(ValueError):
        tcontrib.bipartite_matching(torch.zeros(2, 2))
    x = rng.randn(2, 6).astype("float32")
    want, got = _both(jcontrib.fft, tcontrib.fft, x)
    _close(got, want, "fft")
    want, got = _both(jcontrib.ifft, tcontrib.ifft, want)
    _close(got, want, "ifft")


def test_contrib_multibox_aliases_are_the_operators():
    assert tcontrib.MultiBoxPrior is tmb.MultiBoxPrior
    assert tcontrib.MultiBoxTarget is tmb.MultiBoxTarget
    assert tcontrib.MultiBoxDetection is tmb.MultiBoxDetection
    assert mxt.nd.contrib.MultiBoxTarget is mxt.ops.MultiBoxTarget


@pytest.mark.parametrize("size", [1, 3, (2, 5)])
def test_contrib_adaptive_avg_pooling(size):
    x = onp.random.RandomState(18).randn(2, 3, 7, 10).astype("float32")
    want, got = _both(lambda d: jcontrib.AdaptiveAvgPooling2D(d, size),
                      lambda d: tcontrib.AdaptiveAvgPooling2D(d, size), x)
    _close(got, want)


def test_contrib_boolean_mask_and_its_gradient():
    x = onp.random.RandomState(19).randn(5, 3).astype("float32")
    mask = onp.array([1, 0, 1, 1, 0], "float32")
    grads = []
    for pkg in (mx, mxt):
        ctx = {} if pkg is mx else dict(ctx=mxt.cpu())
        contrib = jcontrib if pkg is mx else tcontrib
        d = pkg.nd.array(x, **ctx)
        d.attach_grad()
        with pkg.autograd.record():
            out = contrib.boolean_mask(d, pkg.nd.array(mask, **ctx))
            s = (out * out).sum()
        s.backward()
        grads.append((out.asnumpy(), d.grad.asnumpy()))
    _close(grads[1][0], grads[0][0], "rows")
    _close(grads[1][1], grads[0][1], "gradient")


def test_contrib_index_copy():
    rng = onp.random.RandomState(20)
    old, new = rng.randn(6, 3).astype("float32"), rng.randn(2, 3) \
        .astype("float32")
    idx = onp.array([4, 1], "float32")
    want, got = _both(jcontrib.index_copy, tcontrib.index_copy, old, idx,
                      new)
    _close(got, want)


def test_contrib_gradientmultiplier():
    x = onp.random.RandomState(21).randn(4, 3).astype("float32")
    _vjp_check(lambda d: jcontrib.gradientmultiplier(d, 0.25),
               lambda d: tcontrib.gradientmultiplier(d, 0.25), [x], [0])


def test_contrib_quadratic_allclose_arange_like():
    x = onp.random.RandomState(22).randn(3, 4).astype("float32")
    want, got = _both(lambda d: jcontrib.quadratic(d, 0.5, -1.0, 2.0),
                      lambda d: tcontrib.quadratic(d, 0.5, -1.0, 2.0), x)
    _close(got, want, "quadratic")
    for y in (x, x + 1e-7, x + 1e-3):
        want, got = _both(jcontrib.allclose, tcontrib.allclose, x,
                          y.astype("float32"))
        _exact(got, want, "allclose")
        assert got.shape == () and got.dtype == onp.float32
    for kw in (dict(), dict(start=2.0, step=0.5), dict(axis=1)):
        want, got = _both(lambda d: jcontrib.arange_like(d, **kw),
                          lambda d: tcontrib.arange_like(d, **kw), x)
        _close(got, want, "arange_like %s" % kw)


def test_contrib_sync_batch_norm_on_one_device():
    rng = onp.random.RandomState(23)
    args = [rng.randn(4, 3, 2, 2).astype("float32"),
            rng.rand(3).astype("float32") + 0.5,
            rng.randn(3).astype("float32"), rng.randn(3).astype("float32"),
            rng.rand(3).astype("float32") + 0.5]
    want, got = _both(lambda *a: jcontrib.SyncBatchNorm(*a, ndev=1, key="k"),
                      lambda *a: tcontrib.SyncBatchNorm(*a, ndev=1, key="k"),
                      *args)
    _close(got, want)
    # across devices it is the same operator outside a data-parallel step
    # (inside one it takes the global batch's statistics:
    # tests/test_torch_parallel.py)
    two = tcontrib.SyncBatchNorm(*[torch.from_numpy(a) for a in args],
                                 ndev=2)
    assert torch.equal(two, tcontrib.SyncBatchNorm(
        *[torch.from_numpy(a) for a in args], ndev=1, key="k"))


def test_contrib_sparse_embedding_and_index_array():
    rng = onp.random.RandomState(24)
    w = rng.randn(6, 3).astype("float32")
    ids = onp.array([[0, 5], [2, 2]], "float32")
    want, got = _both(
        lambda i, ww: jcontrib.SparseEmbedding(i, ww, 6, 3),
        lambda i, ww: tcontrib.SparseEmbedding(i, ww, 6, 3), ids, w)
    _close(got, want, "SparseEmbedding")
    x = onp.zeros((2, 3, 4), "float32")
    for axes in (None, (2, 0)):
        want, got = _both(lambda d: jcontrib.index_array(d, axes),
                          lambda d: tcontrib.index_array(d, axes), x)
        _exact(got, want, "index_array %s" % (axes,))
        assert got.dtype == want.dtype


@pytest.mark.parametrize("clip", [-1.0, 0.5])
def test_contrib_group_adagrad_update(clip):
    rng = onp.random.RandomState(25)
    w, g = rng.randn(4, 3).astype("float32"), rng.randn(4, 3) \
        .astype("float32")
    h = rng.rand(4, 1).astype("float32")
    got = []
    for pkg, contrib, ctx in ((mx, jcontrib, {}),
                              (mxt, tcontrib, dict(ctx=mxt.cpu()))):
        arrs = [pkg.nd.array(a, **ctx) for a in (w, g, h)]
        out = contrib.group_adagrad_update(arrs[0], arrs[1], arrs[2], 0.1,
                                           rescale_grad=0.5,
                                           clip_gradient=clip)
        assert out is arrs[0]
        got.append((arrs[0].asnumpy(), arrs[2].asnumpy()))
    _close(got[1][0], got[0][0], "weight")
    _close(got[1][1], got[0][1], "history")


def test_contrib_interleaved_matmuls():
    rng = onp.random.RandomState(26)
    heads, s, b, d = 2, 5, 3, 4
    qkv = rng.randn(s, b, heads * 3 * d).astype("float32")
    att = rng.rand(b * heads, s, s).astype("float32")
    q = rng.randn(s, b, heads * d).astype("float32")
    kv = rng.randn(7, b, heads * 2 * d).astype("float32")
    att2 = rng.rand(b * heads, s, 7).astype("float32")
    for name, args in (("interleaved_matmul_selfatt_qk", (qkv,)),
                       ("interleaved_matmul_selfatt_valatt", (qkv, att)),
                       ("interleaved_matmul_encdec_qk", (q, kv)),
                       ("interleaved_matmul_encdec_valatt", (kv, att2))):
        want, got = _both(
            lambda *a, _n=name: getattr(jcontrib, _n)(*a, heads=heads),
            lambda *a, _n=name: getattr(tcontrib, _n)(*a, heads=heads),
            *args)
        _close(got, want, name)


def test_contrib_box_encode_and_decode():
    rng = onp.random.RandomState(27)
    anchors = _boxes(6, 28, (2,))
    refs = _boxes(3, 29, (2,))
    samples = rng.randint(0, 2, (2, 6)).astype("float32")
    matches = rng.randint(-1, 3, (2, 6)).astype("float32")
    want, got = _both(jcontrib.box_encode, tcontrib.box_encode, samples,
                      matches, anchors, refs)
    _close(got[0], want[0], "targets")
    _exact(got[1], want[1], "masks")
    deltas = (rng.randn(2, 6, 4) * 0.3).astype("float32")
    for kw in (dict(), dict(clip=0.1, std0=0.2), dict(format="center")):
        want, got = _both(lambda d, a: jcontrib.box_decode(d, a, **kw),
                          lambda d, a: tcontrib.box_decode(d, a, **kw),
                          deltas, anchors)
        _close(got, want, "box_decode %s" % kw)


def test_contrib_rroi_align():
    rois = onp.array([[0, 3.5, 4.0, 4.0, 3.0, 0.3],
                      [1, 5.0, 3.0, 6.0, 2.0, -1.1]], "float32")
    jfn = lambda d, r: jcontrib.RROIAlign(d, r, (2, 3), 1.0)  # noqa: E731
    tfn = lambda d, r: tcontrib.RROIAlign(d, r, (2, 3), 1.0)  # noqa: E731
    want, got = _both(jfn, tfn, _feature(), rois)
    _close(got, want)
    _vjp_check(jfn, tfn, [_feature(), rois], [0])


@pytest.mark.parametrize("name,item", [
    ("quantized_pooling", 6), ("quantized_act", 6), ("quantized_flatten", 6),
    ("quantized_concat", 6), ("quantized_elemwise_add", 6),
    ("quantized_elemwise_mul", 6), ("quantized_embedding", 6),
    ("quantized_batch_norm", 6), ("quantize", 6), ("quantize_v2", 6),
    ("dequantize", 6), ("requantize", 6), ("calibrate_entropy", 6),
    ("quantized_conv", 6), ("quantized_fully_connected", 6)])
def test_contrib_entries_still_to_port_raise_naming_their_item(name, item):
    assert hasattr(jcontrib, name)
    with pytest.raises(NotImplementedError, match="item %d" % item):
        getattr(tcontrib, name)(torch.zeros(2))


def test_contrib_covers_the_reference_names():
    """Every public name of the JAX package's nd.contrib exists in the
    port's (ported, or raising with its ROADMAP item)."""
    missing = [n for n in jcontrib.__all__ if not hasattr(tcontrib, n)]
    assert missing == []
