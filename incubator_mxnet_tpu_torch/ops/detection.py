"""Detection and spatial-sampling operators (counterpart of
``incubator_mxnet_tpu/ops/detection.py``; MXNet's ``roi_align.cc``,
``roi_pooling.cc``, ``bilinear_sampler.cc``, ``spatial_transformer.cc``,
``bounding_box.cc``, ``multi_proposal.cc`` and ``fft.cc``).

Plain PyTorch on static shapes, as the JAX package leaves them to XLA.
Bilinear sampling is a flat gather (``torch.gather``) of the four
neighbours, each index clamped into the image (and the batch index of a
region clamped into the batch), so nothing reads out of bounds on the
card; a sample outside the image reads zero. Greedy suppression runs one
step per box, vectorised over the batch.

The JAX package's documented choices, kept: ``roi_pooling`` takes the max
over a 2×2 bilinear sample grid per bin (MXNet takes the max over the
bin's integer pixels); ``roi_align`` with MXNet's adaptive
``sample_ratio`` -1 samples 2×2 per bin (``nd.contrib.ROIAlign``). One
departure, MXNet's behaviour: ``box_nms`` honours ``in_format`` and
``out_format`` ("corner" or "center"), which the JAX package accepts and
ignores; with both "corner" (the default) every row equals the JAX
package's.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import _apply
from .multibox import greedy_nms

__all__ = ["roi_align", "roi_pooling", "bilinear_sampler", "grid_generator",
           "spatial_transformer", "box_iou", "box_nms", "bipartite_matching",
           "multi_proposal", "fft", "ifft"]


def _bilinear_gather(img, ys, xs):
    """img (N, C, H, W) sampled at pixel coordinates ys, xs (N, hs, ws):
    (N, C, hs, ws), zero outside the image."""
    n, c, h, w = img.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    flat = img.reshape(n, c, h * w)

    def at(yi, xi):
        yi = yi.clamp(0, h - 1).int()
        xi = xi.clamp(0, w - 1).int()
        idx = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1).long()
        return torch.gather(flat, 2, idx).reshape(n, c, *ys.shape[1:])

    v = (at(y0, x0) * ((1 - wy) * (1 - wx))[:, None]
         + at(y0, x0 + 1) * ((1 - wy) * wx)[:, None]
         + at(y0 + 1, x0) * (wy * (1 - wx))[:, None]
         + at(y0 + 1, x0 + 1) * (wy * wx)[:, None])
    inside = ((ys > -1) & (ys < h) & (xs > -1) & (xs < w))[:, None]
    return torch.where(inside, v, torch.zeros((), dtype=v.dtype,
                                              device=v.device))


def _roi_sample_grid(rois, pooled_size, spatial_scale, samples, align):
    """Sample coordinates (R, PH·s, PW·s) in y and in x of every region."""
    ph, pw = pooled_size
    off = 0.5 if align else 0.0
    x1 = rois[:, 1] * spatial_scale - off
    y1 = rois[:, 2] * spatial_scale - off
    x2 = rois[:, 3] * spatial_scale - off
    y2 = rois[:, 4] * spatial_scale - off
    roi_w = torch.clamp_min(x2 - x1, 1.0)
    roi_h = torch.clamp_min(y2 - y1, 1.0)
    kw = dict(dtype=torch.float32, device=rois.device)
    sub = (torch.arange(samples, **kw) + 0.5) / samples
    iy = (torch.arange(ph, **kw)[:, None] + sub[None]).reshape(-1)
    ix = (torch.arange(pw, **kw)[:, None] + sub[None]).reshape(-1)
    ys = y1[:, None] + iy[None] * (roi_h / ph)[:, None]
    xs = x1[:, None] + ix[None] * (roi_w / pw)[:, None]
    return (ys[:, :, None].expand(-1, -1, xs.shape[1]),
            xs[:, None, :].expand(-1, ys.shape[1], -1))


def _roi_fn(data, rois, pooled_size, spatial_scale, sample_ratio, reduce,
            align):
    ph, pw = pooled_size
    s = max(int(sample_ratio), 1)
    bidx = rois[:, 0].int().clamp(0, data.shape[0] - 1)
    img = data[bidx.long()]
    ys, xs = _roi_sample_grid(rois, pooled_size, spatial_scale, s, align)
    sampled = _bilinear_gather(img, ys, xs)
    blocks = sampled.reshape(sampled.shape[0], sampled.shape[1], ph, s, pw, s)
    return blocks.amax((3, 5)) if reduce == "max" else blocks.mean((3, 5))


def roi_align(data, rois, pooled_size, spatial_scale, sample_ratio=2):
    """ROIAlign: the mean of ``sample_ratio``² bilinear samples per bin,
    half-pixel aligned. data (N, C, H, W); rois (R, 5) [batch index, x1,
    y1, x2, y2] in input pixels; returns (R, C, PH, PW)."""
    return _apply(lambda d, r: _roi_fn(d, r, tuple(pooled_size),
                                       spatial_scale, sample_ratio, "mean",
                                       align=True), data, rois)


def roi_pooling(data, rois, pooled_size, spatial_scale):
    """ROIPooling: per bin the max over a 2×2 bilinear sample grid (the
    JAX package's static-shape form of MXNet's max over the bin)."""
    return _apply(lambda d, r: _roi_fn(d, r, tuple(pooled_size),
                                       spatial_scale, 2, "max", align=False),
                  data, rois)


def grid_generator(data, transform_type="affine", target_shape=None):
    """GridGenerator: affine parameters (N, 6) → a sampling grid (N, 2, H,
    W) in [-1, 1], x then y."""
    if transform_type != "affine":
        raise ValueError("grid_generator supports affine (a warp takes a "
                         "precomputed flow)")
    h, w = target_shape

    def fn(theta):
        # the grid is float32, and a narrower theta computes in it, as
        # JAX promotes
        dtype = torch.promote_types(theta.dtype, torch.float32)
        kw = dict(dtype=dtype, device=theta.device)
        gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, **kw),
                                torch.linspace(-1.0, 1.0, w, **kw),
                                indexing="ij")
        src = torch.stack([gx, gy, torch.ones_like(gx)], 0).reshape(3, -1)
        return torch.einsum("nij,jk->nik", theta.reshape(-1, 2, 3).to(dtype),
                            src).reshape(-1, 2, h, w)
    return _apply(fn, data)


def _sample(d, g):
    h, w = d.shape[2], d.shape[3]
    xs = (g[:, 0] + 1.0) * (w - 1) / 2.0
    ys = (g[:, 1] + 1.0) * (h - 1) / 2.0
    return _bilinear_gather(d, ys, xs)


def bilinear_sampler(data, grid):
    """BilinearSampler: data (N, C, H, W) at grid (N, 2, Ho, Wo), x and y
    in [-1, 1], zero outside."""
    return _apply(_sample, data, grid)


def spatial_transformer(data, loc, target_shape, transform_type="affine",
                        sampler_type="bilinear"):
    """SpatialTransformer: data warped by the affine ``loc`` (N, 6) onto
    ``target_shape``."""
    return bilinear_sampler(data, grid_generator(loc, "affine",
                                                 target_shape))


# ===================================================================== boxes

def _corners(b):
    """Centre boxes (x, y, w, h) as corner boxes."""
    return torch.cat([b[..., :2] - b[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2],
                     -1)


def _center_of(b):
    """Corner boxes as centre boxes (x, y, w, h)."""
    return torch.cat([(b[..., :2] + b[..., 2:]) / 2, b[..., 2:] - b[..., :2]],
                     -1)


def _iou_matrix(a, b, fmt="corner"):
    if fmt == "center":
        a, b = _corners(a), _corners(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-12)


def box_iou(lhs, rhs, format="corner"):
    """IoU of every box of ``lhs`` (..., Na, 4) with every box of ``rhs``
    (..., Nb, 4)."""
    return _apply(lambda a, b: _iou_matrix(a, b, format), lhs, rhs)


def _nms_keep(boxes, scores, iou_threshold, topk, cls=None):
    """Greedy suppression of corner boxes (B, n, 4) by ``scores`` (B, n),
    within a class when ``cls`` (B, n) is given, at most ``topk`` kept:
    the keep mask (B, n) in the boxes' order."""
    order = torch.argsort(-scores, dim=1, stable=True)
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    c = None if cls is None else torch.gather(cls, 1, order)
    # a box stays unless a kept box before it overlaps it: the same as
    # every alive box suppressing the later ones it overlaps
    keep = greedy_nms(_iou_matrix(b, b), torch.ones_like(scores,
                                                         dtype=torch.bool),
                      iou_threshold, c)
    if topk is not None and topk > 0:
        keep = keep & (torch.cumsum(keep.int(), 1) <= topk)
    return torch.zeros_like(keep).scatter_(1, order, keep)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner"):
    """Non-maximum suppression of rows (..., N, K) [id, score, x1, y1, x2,
    y2, ...] in their order; a suppressed row, or one with score at or
    below ``valid_thresh``, becomes -1. Per class when ``id_index`` ≥ 0
    and not ``force_suppress``. Boxes are read in ``in_format`` and
    written in ``out_format``."""
    for fmt in (in_format, out_format):
        if fmt not in ("corner", "center"):
            raise ValueError("box format must be 'corner' or 'center', got "
                             "%r" % (fmt,))

    def fn(x):
        rows = x.reshape((-1,) + x.shape[-2:])
        scores = rows[..., score_index]
        boxes = rows[..., coord_start:coord_start + 4]
        if in_format == "center":
            boxes = _corners(boxes)
        cls = None
        if not force_suppress and id_index >= 0:
            cls = rows[..., id_index]
        valid = scores > valid_thresh
        keep = _nms_keep(boxes, torch.where(valid, scores, torch.full(
            (), float("-inf"), dtype=scores.dtype, device=scores.device)),
            overlap_thresh, topk if topk > 0 else None, cls) & valid
        if in_format != out_format:
            out = boxes if out_format == "corner" else _center_of(boxes)
            rows = torch.cat([rows[..., :coord_start], out,
                              rows[..., coord_start + 4:]], -1)
        return torch.where(keep[..., None], rows,
                           -torch.ones_like(rows)).reshape(x.shape)
    return _apply(fn, data)


def bipartite_matching(data, threshold, is_ascend=False, topk=-1):
    """Greedy best-first matching over a score matrix (..., N, M):
    (row_match (..., N), col_match (..., M)), -1 where unmatched; a pair
    matches while its score is at least ``threshold`` (at most, with
    ``is_ascend``)."""

    def fn(s):
        lead, (n, m) = s.shape[:-2], s.shape[-2:]
        sc = s.reshape(-1, n, m).clone()
        b = sc.shape[0]
        blank = float("inf") if is_ascend else float("-inf")
        k = min(n, m) if topk <= 0 else min(topk, n, m)
        row = torch.full((b, n), -1.0, device=s.device)
        col = torch.full((b, m), -1.0, device=s.device)
        batch = torch.arange(b, device=s.device)
        for _ in range(k):
            flat = sc.reshape(b, -1)
            best = flat.argmin(1) if is_ascend else flat.argmax(1)
            i, j = best // m, best % m
            val = flat[batch, best]
            ok = val <= threshold if is_ascend else val >= threshold
            row[batch, i] = torch.where(ok, j.float(), row[batch, i])
            col[batch, j] = torch.where(ok, i.float(), col[batch, j])
            sc[batch, i, :] = blank
            sc[batch, :, j] = blank
        return row.reshape(*lead, n), col.reshape(*lead, m)
    return _apply(fn, data)


def _generate_anchors(stride, scales, ratios, device):
    """RPN base anchors (A, 4) centred on the first stride cell."""
    base = torch.tensor([0, 0, stride - 1, stride - 1], dtype=torch.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    out = []
    for r in ratios:
        ws = torch.round(torch.sqrt(w * h / r))
        hs = torch.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            out.append(torch.stack([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                                    cx + 0.5 * (wss - 1),
                                    cy + 0.5 * (hss - 1)]))
    return torch.stack(out).to(device)


def _apply_deltas(anchors, deltas):
    w = anchors[..., 2] - anchors[..., 0] + 1
    h = anchors[..., 3] - anchors[..., 1] + 1
    cx = anchors[..., 0] + 0.5 * (w - 1)
    cy = anchors[..., 1] + 0.5 * (h - 1)
    ncx = deltas[..., 0] * w + cx
    ncy = deltas[..., 1] * h + cy
    nw = torch.exp(deltas[..., 2]) * w
    nh = torch.exp(deltas[..., 3]) * h
    return torch.stack([ncx - 0.5 * (nw - 1), ncy - 0.5 * (nh - 1),
                        ncx + 0.5 * (nw - 1), ncy + 0.5 * (nh - 1)], -1)


def _top(x, k):
    """The ``k`` largest of each row of ``x`` and their indices, ties in
    index order (``lax.top_k``'s)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def multi_proposal(cls_prob, bbox_pred, im_info, feature_stride=16,
                   scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                   rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                   threshold=0.7, rpn_min_size=16):
    """RPN proposals (MXNet's ``MultiProposal``): anchors plus deltas,
    clipped to the image, boxes under ``rpn_min_size`` dropped, the
    ``rpn_pre_nms_top_n`` best suppressed at ``threshold``, the
    ``rpn_post_nms_top_n`` best kept. Returns (B · post, 5) [batch index,
    x1, y1, x2, y2]."""

    def fn(scores, deltas, info):
        bsz, a2, h, w = scores.shape
        a = a2 // 2
        if a != len(scales) * len(ratios):
            raise ValueError(
                "cls_prob has %d anchors/position but scales x ratios = %d"
                % (a, len(scales) * len(ratios)))
        base = _generate_anchors(feature_stride, scales, ratios,
                                 scores.device)
        kw = dict(dtype=torch.float32, device=scores.device)
        sy, sx = torch.meshgrid(torch.arange(h, **kw) * feature_stride,
                                torch.arange(w, **kw) * feature_stride,
                                indexing="ij")
        shift = torch.stack([sx, sy], -1).reshape(-1, 2)
        anchors = (base[None] + torch.cat([shift, shift], -1)[:, None]) \
            .reshape(-1, 4)                                    # (H·W·A, 4)
        fg = scores[:, a:].reshape(bsz, a, h * w).transpose(1, 2) \
            .reshape(bsz, -1)
        d = deltas.reshape(bsz, a, 4, h * w).permute(0, 3, 1, 2) \
            .reshape(bsz, -1, 4)
        boxes = _apply_deltas(anchors[None], d)
        hi = torch.stack([info[:, 1] - 1, info[:, 0] - 1] * 2, -1)[:, None]
        boxes = torch.minimum(boxes.clamp_min(0), hi)
        ws = boxes[..., 2] - boxes[..., 0] + 1
        hs = boxes[..., 3] - boxes[..., 1] + 1
        fg = torch.where((ws >= rpn_min_size) & (hs >= rpn_min_size), fg,
                         torch.full((), float("-inf"), dtype=fg.dtype,
                                    device=fg.device))
        n_pre = min(rpn_pre_nms_top_n, fg.shape[1])
        top_sc, top_i = _top(fg, n_pre)
        top_boxes = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
        keep = _nms_keep(top_boxes, top_sc, threshold, rpn_post_nms_top_n)
        n_post = min(rpn_post_nms_top_n, n_pre)
        _, sel_i = _top(torch.where(keep, top_sc, torch.full(
            (), float("-inf"), dtype=top_sc.dtype, device=top_sc.device)),
            n_post)
        rois = torch.gather(top_boxes, 1, sel_i[..., None].expand(-1, -1, 4))
        bidx = torch.arange(bsz, dtype=rois.dtype, device=rois.device)[
            :, None, None].expand(-1, n_post, 1)
        return torch.cat([bidx, rois], -1).reshape(-1, 5)
    return _apply(fn, cls_prob, bbox_pred, im_info)


# ======================================================================= fft

def fft(data, compute_size=None):
    """FFT over the last axis, real and imaginary parts interleaved:
    (..., n) → (..., 2n) (MXNet's cuFFT layout)."""
    def fn(x):
        c = torch.fft.fft(x.to(torch.complex64), dim=-1)
        return torch.stack([c.real, c.imag], -1).reshape(
            *x.shape[:-1], 2 * x.shape[-1])
    return _apply(fn, data)


def ifft(data, compute_size=None):
    """Inverse FFT of interleaved (..., 2n) data: the real part times n
    (cuFFT's unnormalised inverse), (..., n)."""
    def fn(x):
        n = x.shape[-1] // 2
        c = x.reshape(*x.shape[:-1], n, 2)
        z = torch.complex(c[..., 0].float(), c[..., 1].float())
        return torch.fft.ifft(z, dim=-1).real * n
    return _apply(fn, data)
