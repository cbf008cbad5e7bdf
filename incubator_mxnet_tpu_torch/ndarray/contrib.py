"""``nd.contrib``: MXNet's contrib operators (counterpart of
``incubator_mxnet_tpu/ndarray/contrib.py``), the part without control flow,
sparse storage or quantization.

Each operator takes NDArrays or tensors, as every ``nd`` operator does
(``_apply``). The detection operators are ``ops.detection``'s and
``ops.multibox``'s; the interleaved attention products are plain
``torch.matmul``, as the JAX package computes them outside its kernels.

The control flow (``foreach``, ``while_loop``, ``cond``) runs the
reference's eager semantics outside a capture: Python loops and branches
whose predicates are read on the host, so autograd records through the
bodies. Inside ``plain()`` (a ``jit.TrainStep``'s body, eager or captured,
and a hybridized block's forward) it follows the reference's traced
contract without reading anything on the host: ``foreach`` unrolls over
the data's first axis; ``while_loop`` needs ``max_iterations`` and runs
exactly that many steps under a device mask (the loop variables stop
changing once the predicate fails, and the rows of the outputs past the
stop are zeros); ``cond`` evaluates both branches and selects. The
operators on CSR storage (``getnnz``, ``edge_id``, the ``dgl_*`` graph
samplers) are eager host operators, as in the JAX package; ``hawkesll``
is a loop over the sequence axis.

Still to port, and raising with the ROADMAP item that brings them: the
quantized family (``quantize*``, ``dequantize``, ``requantize``,
``calibrate_entropy``, ``quantized_*``; §1 item 6).
"""
from __future__ import annotations

import math

import numpy as onp
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
    """``BatchNorm``, whose statistics are those of the global batch inside
    a data-parallel step over a mesh (``ndev`` and ``key`` are accepted, as
    in the JAX package)."""
    kw.pop("ndev", None)
    kw.pop("key", None)
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


for _name in ("quantize", "quantize_v2", "dequantize", "requantize",
              "calibrate_entropy", "quantized_fully_connected",
              "quantized_conv", "quantized_pooling", "quantized_act",
              "quantized_flatten", "quantized_concat",
              "quantized_elemwise_add", "quantized_elemwise_mul",
              "quantized_embedding", "quantized_batch_norm"):
    globals()[_name] = _waits(_name, 6, "contrib/quantization.py")
del _name


# ============================================================ control flow

def _traced():
    """Whether the reference's traced contract applies: inside ``plain()``
    (a TrainStep's body, a hybridized block's forward) or a capture."""
    from ..gluon import _functional
    return _functional.in_plain() or (
        torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def _flatten(tree):
    """(leaves, rebuild) of nested lists/tuples of arrays or tensors, by
    hybridize's flattening."""
    from ..gluon import _functional
    leaves = []
    spec = _functional._flatten(tree, leaves)
    return leaves, lambda xs: _functional._unflatten(spec, iter(xs))


def _stack(cols):
    return _apply(lambda *xs: torch.stack(xs, 0), *cols)


def _stack_trees(trees):
    leaves0, rebuild = _flatten(trees[0])
    cols = [[_flatten(t)[0][i] for t in trees] for i in range(len(leaves0))]
    return rebuild([_stack(c) for c in cols])


def _host_bool(x):
    return bool((x._data if isinstance(x, NDArray) else x).reshape(-1)[0])


def _device_bool(x):
    return (x._data if isinstance(x, NDArray) else torch.as_tensor(x)) \
        .reshape(()).bool()


def _select(pred, a, b):
    """``a`` where the device scalar ``pred`` holds, else ``b``."""
    return _apply(lambda x, y: torch.where(pred.to(x.device), x, y), a, b)


def foreach(body, data, init_states):
    """``body(data[i], states) -> (out, states)`` over the first axis of
    ``data``; returns (the outputs stacked on a new first axis, the final
    states). Unrolled: eager and traced run the same steps."""
    data_leaves, data_rebuild = _flatten(data)
    if not data_leaves:
        raise ValueError("foreach needs at least one input array")
    n = data_leaves[0].shape[0]
    if n == 0:
        raise ValueError("foreach over zero-length data: its outputs are "
                         "undefined")
    states, outs = init_states, []
    for i in range(n):
        out, states = body(data_rebuild([d[i] for d in data_leaves]), states)
        outs.append(out)
    return _stack_trees(outs), states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``func(*loop_vars) -> (step_output, new_loop_vars)`` while
    ``cond(*loop_vars)``; returns (the step outputs stacked, the final loop
    variables). Eager: the steps that run, at most ``max_iterations``.
    Traced: exactly ``max_iterations`` steps under a device mask, the
    output rows past the stop zeros, no host read."""
    loop_vars = list(loop_vars)
    if not _traced():
        outs, steps = [], 0
        while (max_iterations is None or steps < max_iterations) and \
                _host_bool(cond(*loop_vars)):
            out, loop_vars = func(*loop_vars)
            loop_vars = list(loop_vars)
            outs.append(out)
            steps += 1
        if not outs:
            raise ValueError("while_loop ran zero steps: its outputs are "
                             "undefined")
        return _stack_trees(outs), loop_vars
    if max_iterations is None:
        raise ValueError("while_loop needs max_iterations inside a capture "
                         "or a hybridized block (static shapes)")
    var_leaves, var_rebuild = _flatten(loop_vars)
    active, outs = None, []
    for _ in range(max_iterations):
        pred = _device_bool(cond(*loop_vars))
        active = pred if active is None else active & pred
        out, new_vars = func(*loop_vars)
        out_leaves, out_rebuild = _flatten(out)
        outs.append(out_rebuild([
            _select(active, o, _apply(torch.zeros_like, o))
            for o in out_leaves]))
        new_leaves, _ = _flatten(list(new_vars))
        var_leaves = [_select(active, nv, v)
                      for nv, v in zip(new_leaves, var_leaves)]
        loop_vars = var_rebuild(var_leaves)
    return _stack_trees(outs), loop_vars


def cond(pred, then_func, else_func):
    """``then_func()`` if ``pred`` else ``else_func()``. Traced: both run
    and the outputs (of one structure) are selected on the device."""
    if not _traced():
        return then_func() if _host_bool(pred) else else_func()
    p = _device_bool(pred)
    then_leaves, rebuild = _flatten(then_func())
    else_leaves, _ = _flatten(else_func())
    if len(then_leaves) != len(else_leaves):
        raise ValueError("cond branches returned different structures")
    return rebuild([_select(p, a, b)
                    for a, b in zip(then_leaves, else_leaves)])


# ================================================================= hawkesll

def hawkesll(lda, alpha, beta, state, lags, marks, valid_length, max_time):
    """The log-likelihood of a marked Hawkes process (``hawkes_ll.cc``):
    intensity ``mu_k + alpha_k beta_k sum exp(-beta_k (t - t_i))`` over
    the earlier events of mark k. lda (N, K), alpha and beta (K,), state
    (N, K), lags and marks (N, T) with valid_length (N,), max_time (N,).
    Returns (loglik (N,), the decayed state at max_time (N, K))."""
    def fn(mu, a, b, st, lg, mk, vl, mt):
        n, t_len = lg.shape
        k = mu.shape[1]
        mk = mk.long().clamp(0, k - 1)
        last = torch.zeros_like(st)
        t = torch.zeros(n, dtype=mu.dtype, device=mu.device)
        ll = torch.zeros(n, dtype=mu.dtype, device=mu.device)
        classes = torch.arange(k, device=mu.device)
        for j in range(t_len):
            mark = mk[:, j]
            t2 = t + lg[:, j]
            pick = mark[:, None]
            d = t2 - last.gather(1, pick)[:, 0]
            a_c, b_c = a[mark], b[mark]
            st_c, mu_c = st.gather(1, pick)[:, 0], mu.gather(1, pick)[:, 0]
            ed = torch.exp(-b_c * d)
            lam = mu_c + a_c * b_c * st_c * ed
            comp = mu_c * d + a_c * st_c * (1 - ed)
            valid = j < vl
            ll = ll + torch.where(valid, torch.log(lam) - comp,
                                  torch.zeros_like(ll))
            upd = valid[:, None] & (classes[None] == mark[:, None])
            st = torch.where(upd, (1 + st_c * ed)[:, None], st)
            last = torch.where(upd, t2[:, None], last)
            t = torch.where(valid, t2, t)
        d = mt[:, None] - last
        ed = torch.exp(-b[None] * d)
        ll = ll - (mu * d + a[None] * st * (1 - ed)).sum(1)
        return ll, st * ed
    return _apply(fn, lda, alpha, beta, state, lags, marks, valid_length,
                  max_time)


# ===================================================== on CSR storage (host)

def _csr_parts(g):
    return (g.data.asnumpy(), g.indices.asnumpy().astype(onp.int64),
            g.indptr.asnumpy().astype(onp.int64), g.shape)


def _host_array(a, like):
    """Host values as an NDArray on ``like``'s context, by the JAX
    package's dtype rules (int64 → int32, float64 → float32)."""
    from .ndarray import array
    return array(onp.asarray(a), ctx=like.context)


def _make_csr(vals, idx, ptr, shape, like):
    from .sparse import CSRNDArray
    vals = onp.asarray(vals)
    if vals.size == 0:
        vals = vals.astype(onp.float32)
    return CSRNDArray(_host_array(vals, like),
                      _host_array(onp.asarray(idx, onp.int64), like),
                      _host_array(onp.asarray(ptr, onp.int64), like), shape)


def getnnz(data, axis=None):
    """The number of stored values of a CSR array, or of each row
    (``axis=0``), int64."""
    from .sparse import CSRNDArray
    if not isinstance(data, CSRNDArray):
        raise TypeError("getnnz expects CSR storage")
    if axis is None:
        return _host_array([data.data.shape[0]], data.data)
    if axis != 0:
        raise ValueError("getnnz supports axis=None or 0")
    ptr = data.indptr.asnumpy()
    return _host_array(ptr[1:] - ptr[:-1], data.data)


def edge_id(data, u, v):
    """``out[i]``: the value stored at (u[i], v[i]) of a CSR array, -1
    where none is."""
    _, idx, ptr, _ = _csr_parts(data)
    val = data.data.asnumpy()
    uu = u.asnumpy().astype(onp.int64)
    vv = v.asnumpy().astype(onp.int64)
    out = onp.full(uu.shape, -1.0, onp.float32)
    for i, (r, c) in enumerate(zip(uu, vv)):
        lo, hi = ptr[r], ptr[r + 1]
        pos = lo + onp.searchsorted(idx[lo:hi], c)
        if pos < hi and idx[pos] == c:
            out[i] = val[pos]
    return _host_array(out, data.data)


def _neighbor_sample(csr, seeds, num_hops, num_neighbor, max_num_vertices,
                     probability, seed):
    vals, idx, ptr, shape = _csr_parts(csr)
    rng = onp.random.RandomState(seed)
    seeds = seeds.asnumpy().astype(onp.int64)
    seeds = seeds[seeds >= 0]
    layer = {int(v): 0 for v in seeds}
    frontier = list(seeds)
    edges = {}
    for hop in range(1, num_hops + 1):
        nxt = []
        for u in frontier:
            lo, hi = ptr[u], ptr[u + 1]
            nbrs, evals = idx[lo:hi], vals[lo:hi]
            if len(nbrs) == 0:
                continue
            k = min(num_neighbor, len(nbrs))
            p = None
            if probability is not None:
                p = probability.asnumpy()[nbrs]
                p = p / p.sum() if p.sum() > 0 else None
            for s in rng.choice(len(nbrs), size=k, replace=False, p=p):
                w = int(nbrs[s])
                edges[(int(u), w)] = evals[s]
                if w not in layer:
                    layer[w] = hop
                    nxt.append(w)
        frontier = nxt
    verts = sorted(layer)[:max_num_vertices]
    vset = set(verts)
    out_v = onp.full(max_num_vertices + 1, -1, onp.int64)
    out_v[:len(verts)] = verts
    out_v[-1] = len(verts)
    out_layer = onp.full(max_num_vertices, -1, onp.int64)
    out_layer[:len(verts)] = [layer[v] for v in verts]
    rows = [[] for _ in range(shape[0])]
    for (u, w), e in sorted(edges.items()):
        if u in vset and w in vset:
            rows[u].append((w, e))
    new_ptr, new_idx, new_vals = [0], [], []
    for r in rows:
        for w, e in sorted(r):
            new_idx.append(w)
            new_vals.append(e)
        new_ptr.append(len(new_idx))
    like = csr.data
    return (_host_array(out_v, like),
            _make_csr(new_vals, new_idx, new_ptr, shape, like),
            _host_array(out_layer, like))


def dgl_csr_neighbor_uniform_sample(csr_matrix, *seed_arrays, num_args=None,
                                    num_hops=1, num_neighbor=2,
                                    max_num_vertices=100, seed=0):
    """Uniform neighbour sampling (DGL's): per seed array, (the vertices,
    padded to ``max_num_vertices + 1`` with their count last, the sampled
    CSR in the original ids, each vertex's hop)."""
    outs = []
    for s in seed_arrays:
        outs.extend(_neighbor_sample(csr_matrix, s, num_hops, num_neighbor,
                                     max_num_vertices, None, seed))
    return outs


def dgl_csr_neighbor_non_uniform_sample(csr_matrix, probability,
                                        *seed_arrays, num_args=None,
                                        num_hops=1, num_neighbor=2,
                                        max_num_vertices=100, seed=0):
    """Neighbour sampling weighted by a per-vertex ``probability``."""
    outs = []
    for s in seed_arrays:
        outs.extend(_neighbor_sample(csr_matrix, s, num_hops, num_neighbor,
                                     max_num_vertices, probability, seed))
    return outs


def dgl_subgraph(graph, *vids_arrays, return_mapping=False, num_args=None):
    """The subgraph induced by each vertex array, relabelled in its order;
    with ``return_mapping`` also CSRs whose values are the original edge
    positions."""
    vals, idx, ptr, _ = _csr_parts(graph)
    outs, maps = [], []
    for va in vids_arrays:
        vids = va.asnumpy().astype(onp.int64)
        vids = vids[vids >= 0]
        relabel = {int(v): i for i, v in enumerate(vids)}
        new_ptr, new_idx, new_vals, new_eid = [0], [], [], []
        for v in vids:
            lo, hi = ptr[v], ptr[v + 1]
            ents = sorted((relabel[int(c)], vals[e], e)
                          for e, c in zip(range(lo, hi), idx[lo:hi])
                          if int(c) in relabel)
            for cc, ee, eid in ents:
                new_idx.append(cc)
                new_vals.append(ee)
                new_eid.append(eid)
            new_ptr.append(len(new_idx))
        n = len(vids)
        outs.append(_make_csr(new_vals, new_idx, new_ptr, (n, n),
                              graph.data))
        maps.append(_make_csr(new_eid, new_idx, new_ptr, (n, n),
                              graph.data))
    return outs + maps if return_mapping else outs


def dgl_graph_compact(*graphs, graph_sizes=None, return_mapping=False,
                      num_args=None):
    """Each sampled graph cut to its first ``graph_sizes[i]`` vertices."""
    sizes = [int(x) for x in onp.asarray(
        graph_sizes.asnumpy() if hasattr(graph_sizes, "asnumpy")
        else graph_sizes)]
    outs = []
    for g, n in zip(graphs, sizes):
        vals, idx, ptr, _ = _csr_parts(g)
        new_ptr, new_idx, new_vals = [0], [], []
        for r in range(n):
            for e, c in zip(range(ptr[r], ptr[r + 1]),
                            idx[ptr[r]:ptr[r + 1]]):
                if c < n:
                    new_idx.append(int(c))
                    new_vals.append(vals[e])
            new_ptr.append(len(new_idx))
        outs.append(_make_csr(new_vals, new_idx, new_ptr, (n, n), g.data))
    return outs if len(outs) > 1 else outs[0]


def dgl_adjacency(graph):
    """The graph's CSR with every stored value 1."""
    _, idx, ptr, shape = _csr_parts(graph)
    from .sparse import CSRNDArray
    return CSRNDArray(_host_array(onp.ones(len(idx), onp.float32),
                                  graph.data),
                      _host_array(idx, graph.data),
                      _host_array(ptr, graph.data), shape)


__all__ += ["foreach", "while_loop", "cond", "hawkesll", "getnnz", "edge_id",
            "dgl_csr_neighbor_uniform_sample",
            "dgl_csr_neighbor_non_uniform_sample", "dgl_subgraph",
            "dgl_graph_compact", "dgl_adjacency"]
