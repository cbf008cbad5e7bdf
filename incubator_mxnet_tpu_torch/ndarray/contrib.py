"""``nd.contrib``: MXNet's contrib operators (counterpart of
``incubator_mxnet_tpu/ndarray/contrib.py``), the part without control flow,
sparse storage or quantization.

Each operator takes NDArrays or tensors, as every ``nd`` operator does
(``_apply``). The detection operators are ``ops.detection``'s and
``ops.multibox``'s; the interleaved attention products are plain
``torch.matmul``, as the JAX package computes them outside its kernels.

Still to port, and raising with the ROADMAP item that brings them: the
control flow (``foreach``, ``while_loop``, ``cond``), the operators on
sparse storage (``getnnz``, ``edge_id``, the ``dgl_*`` graph samplers) and
``hawkesll`` (ROADMAP.md §1 item 2), and the quantized family
(``quantize*``, ``dequantize``, ``requantize``, ``calibrate_entropy``,
``quantized_*``; §1 item 6).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops import detection
from ..ops.multibox import (MultiBoxDetection, MultiBoxPrior,  # noqa: F401
                            MultiBoxTarget, _centers)
from .ndarray import (BatchNorm, Embedding, NDArray, _apply,  # noqa: F401
                      arange_like)

__all__ = ["isinf", "isnan", "isfinite", "ROIAlign", "MultiProposal",
           "box_iou", "box_nms", "bipartite_matching", "fft", "ifft",
           "AdaptiveAvgPooling2D", "boolean_mask", "index_copy",
           "gradientmultiplier", "quadratic", "allclose", "arange_like",
           "MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
           "SyncBatchNorm", "SparseEmbedding", "index_array",
           "group_adagrad_update", "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt", "interleaved_matmul_encdec_qk",
           "interleaved_matmul_encdec_valatt", "box_encode", "box_decode",
           "RROIAlign"]


def isinf(data):
    return _apply(lambda x: torch.isinf(x).float(), data)


def isnan(data):
    return _apply(lambda x: torch.isnan(x).float(), data)


def isfinite(data):
    return _apply(lambda x: torch.isfinite(x).float(), data)


# ================================================================ detection

def ROIAlign(data, rois, pooled_size, spatial_scale, sample_ratio=-1,
             position_sensitive=False, aligned=True):
    """``ops.detection.roi_align``; MXNet's adaptive ``sample_ratio`` -1
    samples 2×2 per bin (sample counts are static), as the JAX package."""
    if position_sensitive:
        raise NotImplementedError(
            "position_sensitive (PSRoIAlign) is not implemented")
    return detection.roi_align(data, rois, pooled_size, spatial_scale,
                               sample_ratio if sample_ratio > 0 else 2)


def MultiProposal(cls_prob, bbox_pred, im_info, **kw):
    return detection.multi_proposal(cls_prob, bbox_pred, im_info, **kw)


def box_iou(lhs, rhs, format="corner"):
    return detection.box_iou(lhs, rhs, format)


def box_nms(data, **kw):
    return detection.box_nms(data, **kw)


def bipartite_matching(data, is_ascend=False, threshold=None, topk=-1):
    """MXNet's positional order: (data, is_ascend, threshold, topk)."""
    if threshold is None:
        raise ValueError("bipartite_matching requires threshold")
    return detection.bipartite_matching(data, threshold, is_ascend, topk)


def fft(data, compute_size=None):
    return detection.fft(data, compute_size)


def ifft(data, compute_size=None):
    return detection.ifft(data, compute_size)


# ===================================================================== misc

def AdaptiveAvgPooling2D(data, output_size=1):
    """NCHW adaptive average pooling; bin i of n over H covers
    [floor(i·H/n), ceil((i+1)·H/n)), overlapping when n does not divide H."""
    size = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    return _apply(lambda x: F.adaptive_avg_pool2d(x, size), data)


def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero.
    Its shape depends on the mask, so the mask is read to the host (an
    eager operator); the gradient scatters into the kept slices."""
    mask = index._data if isinstance(index, NDArray) else \
        torch.as_tensor(index)
    keep = torch.nonzero(mask.reshape(-1) != 0).reshape(-1)
    return _apply(lambda d: torch.index_select(d, axis, keep.to(d.device)),
                  data)


def index_copy(old_tensor, index_vector, new_tensor):
    """``old_tensor`` with its rows at ``index_vector`` replaced by the rows
    of ``new_tensor``."""
    return _apply(lambda old, idx, new: old.index_put((idx.long(),), new),
                  old_tensor, index_vector, new_tensor)


class _GradientMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


def gradientmultiplier(data, scalar=1.0):
    """The identity whose gradient is scaled by ``scalar``."""
    return _apply(lambda x: _GradientMultiplier.apply(x, scalar), data)


def quadratic(data, a=0.0, b=0.0, c=0.0):
    """``a·x² + b·x + c``."""
    return _apply(lambda x: a * x * x + b * x + c, data)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    """1.0 when every element of ``a`` is within ``atol + rtol·|b|`` of
    ``b``, else 0.0 (a 0-dim float32 array)."""
    return _apply(lambda x, y: torch.isclose(
        x, y.to(x.dtype), rtol, atol, equal_nan).all().float(), a, b)


def SyncBatchNorm(data, gamma, beta, moving_mean, moving_var, **kw):
    """Batch norm over the batch on one device; across devices it comes
    with the multi-GPU slice (ROADMAP.md §1 item 5)."""
    ndev = kw.pop("ndev", 1)
    kw.pop("key", None)
    if ndev not in (None, 1):
        raise NotImplementedError("SyncBatchNorm across %d devices comes with "
                                  "the multi-GPU slice (ROADMAP.md §1 item "
                                  "5)" % ndev)
    return BatchNorm(data, gamma, beta, moving_mean, moving_var, **kw)


def SparseEmbedding(data, weight, input_dim=None, output_dim=None, **kw):
    """``Embedding``; its gradient stays dense, as in the JAX package."""
    return Embedding(data, weight, input_dim=input_dim, output_dim=output_dim)


def index_array(data, axes=None):
    """The coordinates of every element: shape ``data.shape + (len(axes),)``
    (every axis by default), int32 (the JAX package's narrowing of int64)."""
    def fn(x):
        grids = torch.meshgrid(*[torch.arange(n, dtype=torch.int32,
                                              device=x.device)
                                 for n in x.shape], indexing="ij")
        picked = range(x.dim()) if axes is None else axes
        return torch.stack([grids[a] for a in picked], -1)
    return _apply(fn, data)


@torch.no_grad()
def group_adagrad_update(weight, grad, history, lr, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5, out=None):
    """Row-wise AdaGrad: ``history += mean(g², every axis but the first)``,
    ``w -= lr · g / sqrt(history + eps)``; writes ``history`` and ``out``
    (``weight`` by default) and returns it."""
    g = grad._data * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    h = history._data + (g * g).mean(dim=tuple(range(1, g.dim())),
                                     keepdim=True)
    history._data = h
    target = out if out is not None else weight
    target._data = (weight._data - lr * g / torch.sqrt(h + epsilon)).to(
        target._data.dtype)
    return target


# ------------------------------------------------ interleaved attention

def _heads_first(x, b, heads, s, d):
    """(S, B, H, D) → (B·H, S, D)."""
    return x.permute(1, 2, 0, 3).reshape(b * heads, s, d)


def _seq_first(ctx, b, heads, s, d):
    """(B·H, S, D) → (S, B, H·D)."""
    return ctx.reshape(b, heads, s, d).permute(2, 0, 1, 3) \
        .reshape(s, b, heads * d)


def interleaved_matmul_selfatt_qk(queries_keys_values, heads):
    """qkv (S, B, H·3·D), heads interleaved → scores (B·H, S, S) over
    √D."""
    def fn(qkv):
        s, b, hd3 = qkv.shape
        d = hd3 // (heads * 3)
        x = qkv.reshape(s, b, heads, 3, d)
        q = _heads_first(x[:, :, :, 0], b, heads, s, d)
        k = _heads_first(x[:, :, :, 1], b, heads, s, d)
        return torch.matmul(q, k.transpose(1, 2)) / math.sqrt(d)
    return _apply(fn, queries_keys_values)


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, heads):
    """qkv (S, B, H·3·D) and attention (B·H, S, S) → context (S, B, H·D)."""
    def fn(qkv, att):
        s, b, hd3 = qkv.shape
        d = hd3 // (heads * 3)
        v = _heads_first(qkv.reshape(s, b, heads, 3, d)[:, :, :, 2], b,
                         heads, s, d)
        return _seq_first(torch.matmul(att, v), b, heads, s, d)
    return _apply(fn, queries_keys_values, attention)


def interleaved_matmul_encdec_qk(queries, keys_values, heads):
    """q (Sq, B, H·D) and kv (Sk, B, H·2·D) → scores (B·H, Sq, Sk) over
    √D."""
    def fn(q, kv):
        sq, b, hd = q.shape
        d = hd // heads
        sk = kv.shape[0]
        qq = _heads_first(q.reshape(sq, b, heads, d), b, heads, sq, d)
        kk = _heads_first(kv.reshape(sk, b, heads, 2, d)[:, :, :, 0], b,
                          heads, sk, d)
        return torch.matmul(qq, kk.transpose(1, 2)) / math.sqrt(d)
    return _apply(fn, queries, keys_values)


def interleaved_matmul_encdec_valatt(keys_values, attention, heads):
    """kv (Sk, B, H·2·D) and attention (B·H, Sq, Sk) → context (Sq, B,
    H·D)."""
    def fn(kv, att):
        sk, b, hd2 = kv.shape
        d = hd2 // (heads * 2)
        v = _heads_first(kv.reshape(sk, b, heads, 2, d)[:, :, :, 1], b,
                         heads, sk, d)
        return _seq_first(torch.matmul(att, v), b, heads, att.shape[1], d)
    return _apply(fn, keys_values, attention)


# ------------------------------------------------------- box coding

def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """Regression targets of matched reference boxes: samples (B, N) (> 0.5
    a positive), matches (B, N) indices into refs (B, M, 4), anchors (B, N,
    4), corner boxes. Returns (targets (B, N, 4), masks (B, N, 1)),
    targets zero where masked. A match index out of [-M, M) is clamped."""
    def fn(smp, mat, anc, ref):
        m = ref.shape[1]
        idx = mat.long()
        idx = torch.where(idx < 0, idx + m, idx).clamp(0, m - 1)
        ga = torch.gather(ref, 1, idx[..., None].expand(*idx.shape, 4))
        aw, ah, ax, ay = _centers(anc)
        gw, gh, gx, gy = _centers(ga)
        t = [(gx - ax) / aw, (gy - ay) / ah,
             torch.log(torch.clamp_min(gw / aw, 1e-12)),
             torch.log(torch.clamp_min(gh / ah, 1e-12))]
        t = torch.stack([(ti - float(mu)) / float(sd)
                         for ti, mu, sd in zip(t, means, stds)], -1)
        mask = (smp > 0.5)[..., None].to(t.dtype)
        return t * mask, mask
    return _apply(fn, samples, matches, anchors, refs)


def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):
    """Corner boxes (B, N, 4) from regression deltas and anchors (corner or
    centre ``format``), the inverse of ``box_encode``; ``clip`` > 0 caps
    the width and height deltas."""
    def fn(d, anc):
        if format == "corner":
            aw, ah, ax, ay = _centers(anc)
        else:
            ax, ay, aw, ah = anc[..., 0], anc[..., 1], anc[..., 2], anc[..., 3]
        dx, dy = d[..., 0] * std0, d[..., 1] * std1
        dw, dh = d[..., 2] * std2, d[..., 3] * std3
        if clip is not None and clip > 0:
            dw, dh = torch.clamp_max(dw, clip), torch.clamp_max(dh, clip)
        cx, cy = dx * aw + ax, dy * ah + ay
        w, h = torch.exp(dw) * aw, torch.exp(dh) * ah
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                           -1)
    return _apply(fn, data, anchors)


def RROIAlign(data, rois, pooled_size, spatial_scale, sampling_ratio=2):
    """Rotated ROIAlign: rois (R, 6) [batch index, cx, cy, w, h, angle in
    radians]; the mean of ``sampling_ratio``² bilinear samples per bin of
    the rotated grid. Returns (R, C, PH, PW)."""
    ph, pw = pooled_size
    s = sampling_ratio

    def fn(x, r):
        n_rois = r.shape[0]
        cx, cy = r[:, 1] * spatial_scale, r[:, 2] * spatial_scale
        w, h = r[:, 3] * spatial_scale, r[:, 4] * spatial_scale
        ang = r[:, 5]
        kw = dict(dtype=torch.float32, device=x.device)
        iy = (torch.arange(ph * s, **kw) + 0.5) / (ph * s) - 0.5
        ix = (torch.arange(pw * s, **kw) + 0.5) / (pw * s) - 0.5
        gy, gx = torch.meshgrid(iy, ix, indexing="ij")
        ca, sa = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
        lx = gx[None] * w[:, None, None]
        ly = gy[None] * h[:, None, None]
        xs = cx[:, None, None] + lx * ca - ly * sa
        ys = cy[:, None, None] + lx * sa + ly * ca
        bidx = r[:, 0].long()
        bidx = torch.where(bidx < 0, bidx + x.shape[0], bidx) \
            .clamp(0, x.shape[0] - 1)
        sampled = detection._bilinear_gather(x[bidx], ys, xs)
        return sampled.reshape(n_rois, x.shape[1], ph, s, pw, s) \
            .mean(dim=(3, 5))
    return _apply(fn, data, rois)


# ============================================================ still to port

def _waits(name, item, what):
    def op(*args, **kwargs):
        raise NotImplementedError(
            "nd.contrib.%s comes with the port of %s (ROADMAP.md §1 item %d)"
            % (name, what, item))
    op.__name__ = name
    return op


for _name in ("foreach", "while_loop", "cond"):
    globals()[_name] = _waits(_name, 2, "nd.contrib's control flow")
for _name in ("getnnz", "edge_id", "dgl_csr_neighbor_uniform_sample",
              "dgl_csr_neighbor_non_uniform_sample", "dgl_subgraph",
              "dgl_graph_compact", "dgl_adjacency"):
    globals()[_name] = _waits(_name, 2, "sparse storage (ndarray/sparse.py)")
globals()["hawkesll"] = _waits("hawkesll", 2, "nd.contrib's hawkesll")
for _name in ("quantize", "quantize_v2", "dequantize", "requantize",
              "calibrate_entropy", "quantized_fully_connected",
              "quantized_conv", "quantized_pooling", "quantized_act",
              "quantized_flatten", "quantized_concat",
              "quantized_elemwise_add", "quantized_elemwise_mul",
              "quantized_embedding", "quantized_batch_norm"):
    globals()[_name] = _waits(_name, 6, "contrib/quantization.py")
del _name
