"""INT8 quantization (counterpart of
``incubator_mxnet_tpu/contrib/quantization.py``; MXNet's
``src/operator/quantization/*`` and ``contrib/quantization.py``).

Symmetric int8: ``quantize`` rounds ``x / scale`` half to even (as
``jnp.round`` does) into [-127, 127] with ``scale = max(|lo|, |hi|) /
127`` a Python double, and ``dequantize`` multiplies back (the range's
denominator 127 for int8, 2^31 - 1 for int32 accumulators). Calibration
(min-max or the KL-entropy search) runs over forward hooks, as the
reference's does.

The int8 products accumulate in int32 exactly, as the reference's
``preferred_element_type=int32`` products do, and are rescaled in fp32:

- a Dense is ``torch._int_mm`` (int8 × int8 → int32; cuBLASLt on the card)
  over the input's LAST axis (MXNet's ``quantized_fully_connected``: the
  reference's ``QuantizedDense`` contracts axis 1, a fault it does not
  share with its own op; ROADMAP §3);
- a convolution is an im2col of the channels-last int8 input (a strided
  view, materialised by one copy; none for a 1×1 stride-1 conv) followed by
  ``torch._int_mm``: torch has no int8 convolution on CUDA, and an fp32
  convolution of the integer values is not exact (its sums reach 7.4e7 >
  2^24).

``_int_mm`` on the card wants more than 16 rows and a K and N that are
multiples of 8: rows, K and N are padded with zeros (``_int8_matmul``),
which leaves the sums unchanged. ``MXTPU_INT8_SIM=1`` selects the
reference's dequantize → fp32 → requantize route, and is the only way onto
it: nothing falls back to it on a failure. Scales are fixed when a block
is built (Python floats), so a quantized forward reads nothing from the
device and a captured ``EvalStep`` replays it.
"""
from __future__ import annotations

import functools

import numpy as onp
import torch
import torch.nn.functional as F

from .. import ndarray as nd
from ..ndarray import NDArray, _apply
from ..ndarray.contrib import _int8_native

__all__ = ["quantize", "dequantize", "requantize", "calib_minmax",
           "calib_entropy", "quantize_model", "quantize_net",
           "QuantizedDense", "QuantizedDenseBlock", "QuantizedConv2DBlock",
           "QuantizedConvGroup"]


def _scale(lo, hi, denom=127.0):
    return max(abs(lo), abs(hi)) / denom or 1.0


def _div(x, scale):
    """``x / scale`` as JAX divides by a weak Python float: the scale
    rounded to ``x``'s type and a true division (a Python number on the
    card would be multiplied by its reciprocal instead)."""
    return x / torch.full((), scale, dtype=x.dtype, device=x.device)


def _quantize_t(x, scale):
    return torch.clamp(torch.round(_div(x, scale)), -127, 127) \
        .to(torch.int8)


def _range_array(v, like):
    device = like._data.device if isinstance(like, NDArray) else like.device
    return NDArray(torch.tensor([v], dtype=torch.float32, device=device))


def quantize(data, min_range=None, max_range=None, out_type="int8"):
    """MXNet's quantize.cc: symmetric linear quantization. Without a
    range, the data's min and max (read on the host, as the reference
    reads them)."""
    if min_range is None or max_range is None:
        a = data.asnumpy() if isinstance(data, NDArray) else \
            data.detach().float().cpu().numpy()
        min_range, max_range = float(a.min()), float(a.max())
    scale = _scale(min_range, max_range)
    q = _apply(lambda x: _quantize_t(x, scale), data)
    return q, _range_array(min_range, q), _range_array(max_range, q)


def _host_float(v):
    return float(v.asnumpy()[0]) if isinstance(v, NDArray) else float(v)


def dequantize(data, min_range, max_range, out_type="float32"):
    """MXNet's dequantize.cc. The range's denominator follows the storage
    type: 127 for int8, 2^31 - 1 for int32 accumulators (kInt8Range /
    kInt32Range)."""
    lo, hi = _host_float(min_range), _host_float(max_range)
    dt = data._data.dtype if isinstance(data, NDArray) else data.dtype
    denom = 127.0 if dt.itemsize == 1 else float(2 ** 31 - 1)
    scale = _scale(lo, hi, denom)
    return _apply(lambda x: x.to(torch.float32) * scale, data)


def requantize(data, min_range, max_range, min_calib=None, max_calib=None):
    """MXNet's requantize.cc: int32 accumulators → int8."""
    deq = dequantize(data, min_range, max_range)
    return quantize(deq, min_calib, max_calib)


def calib_minmax(activations):
    """Min-max calibration thresholds (MXNet's calibrate.cc minmax)."""
    a = onp.concatenate([x.asnumpy().ravel() for x in activations])
    return float(a.min()), float(a.max())


def calib_entropy(activations, num_bins=8001, num_quantized_bins=255):
    """KL-divergence threshold search (MXNet's calibrate.cc entropy)."""
    a = onp.abs(onp.concatenate([x.asnumpy().ravel() for x in activations]))
    amax = float(a.max()) or 1.0
    hist, edges = onp.histogram(a, bins=num_bins, range=(0, amax))
    t = _entropy_threshold(hist, edges, num_quantized_bins)
    return -t, t


def _entropy_threshold(hist, edges, num_quantized_bins=255):
    """KL-optimal |threshold| from an |activation| histogram (the entry
    ``nd.contrib.calibrate_entropy`` shares; MXNet's calibrate.cc)."""
    num_bins = len(hist)
    amax = float(edges[-1]) or 1.0
    best_kl, best_t = onp.inf, amax
    for i in range(num_quantized_bins, num_bins, num_bins // 64 or 1):
        t = edges[i]
        clipped = hist[:i].astype(onp.float64)
        p = clipped.copy()
        p[-1] += hist[i:].sum()  # reference dist: outliers clip into last bin
        if p.sum() == 0:
            continue
        # candidate Q: the histogram WITHOUT the outlier lump quantized
        # into num_quantized_bins and expanded back (building Q from p
        # makes Q == P at i == num_quantized_bins, which always wins)
        factor = len(clipped) / num_quantized_bins
        q = onp.zeros_like(clipped)
        for j in range(num_quantized_bins):
            lo, hi = int(j * factor), max(int((j + 1) * factor),
                                          int(j * factor) + 1)
            mass = clipped[lo:hi].sum()
            nz = (clipped[lo:hi] > 0).sum()
            if nz:
                q[lo:hi] = onp.where(clipped[lo:hi] > 0, mass / nz, 0)
        p_n = p / p.sum()
        q_n = q / q.sum() if q.sum() else q
        # smoothed KL: P > 0 where Q = 0 is penalised with a floor, not
        # masked away (masking hides the clipping error the search needs)
        eps = 1e-12
        mask = p_n > 0
        kl = float((p_n[mask] *
                    onp.log(p_n[mask] / onp.maximum(q_n[mask], eps))).sum())
        if kl < best_kl:
            best_kl, best_t = kl, t
    return best_t


# ============================================================ int8 products

def _ceil8(n):
    return -(-n // 8) * 8


def _int8_matmul(a, w):
    """int32 ``a @ w.T`` for int8 ``a`` (M, K) and ``w`` (N, K), exact:
    ``torch._int_mm`` with M, K and N padded by zeros to what cuBLASLt
    takes (more than 16 rows, K and N multiples of 8)."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(_ceil8(m), 24), _ceil8(k), _ceil8(n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    acc = torch._int_mm(a, w.t())
    return acc[:m, :n]


def _int8_dense_acc(x, wq):
    """int32 accumulators of int8 ``x`` (..., K) against ``wq`` (N, K),
    contracting x's last axis (MXNet's quantized_fully_connected)."""
    lead = x.shape[:-1]
    acc = _int8_matmul(x.reshape(-1, x.shape[-1]), wq)
    return acc.reshape(*lead, wq.shape[0])


def _im2col(x, kernel, stride, pad, dilate):
    """(N·Ho·Wo, kh·kw·C) int8 columns of NCHW ``x`` from a channels-last
    strided view, and (Ho, Wo)."""
    kh, kw = kernel
    xh = x.permute(0, 2, 3, 1)
    if any(pad):
        xh = F.pad(xh, (0, 0, pad[1], pad[1], pad[0], pad[0]))
    else:
        xh = xh.contiguous()
    n, hp, wp, c = xh.shape
    ho = (hp - dilate[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (wp - dilate[1] * (kw - 1) - 1) // stride[1] + 1
    sn, sh, sw, sc = xh.stride()
    v = xh.as_strided((n, ho, wo, kh, kw, c),
                      (sn, sh * stride[0], sw * stride[1], sh * dilate[0],
                       sw * dilate[1], sc))
    return v.reshape(n * ho * wo, kh * kw * c), ho, wo


def _int8_conv_acc(xq, wq, stride, pad, dilate, groups):
    """int32 accumulators of the 2-D int8 convolution of NCHW ``xq`` by
    OIHW ``wq`` (cross-correlation, symmetric padding): im2col, then
    ``_int8_matmul`` a group at a time. NCHW out (channels-last memory)."""
    n = xq.shape[0]
    o, cg, kh, kw = wq.shape
    og = o // groups
    outs = []
    for g in range(groups):
        xg = xq[:, g * cg:(g + 1) * cg] if groups > 1 else xq
        cols, ho, wo = _im2col(xg, (kh, kw), stride, pad, dilate)
        wmat = wq[g * og:(g + 1) * og].permute(0, 2, 3, 1).reshape(og, -1)
        outs.append(_int8_matmul(cols, wmat))
    acc = outs[0] if groups == 1 else torch.cat(outs, 1)
    return acc.reshape(n, ho, wo, o).permute(0, 3, 1, 2)


def _conv_geometry(kw_):
    n = len(kw_["kernel"])
    if n != 2:
        raise NotImplementedError("int8 convolution takes 2-D kernels")

    def fit(v, fill):
        v = tuple(v) if v is not None else ()
        return v[:n] + (fill,) * (n - len(v[:n]))
    return (fit(kw_.get("stride"), 1), fit(kw_.get("pad"), 0),
            fit(kw_.get("dilate"), 1), kw_.get("num_group", 1))


class QuantizedDense:
    """INT8 inference dense layer (MXNet's quantized_fully_connected.cc):
    int8 input × int8 weight → int32 over the input's last axis, rescaled
    in fp32, bias added. The weight's and the input's scales are fixed
    here, as Python floats."""

    def __init__(self, dense_block, calib_min, calib_max):
        w = dense_block.weight.data()
        self._wq, self._wmin, self._wmax = quantize(w)
        self._ws = _scale(_host_float(self._wmin), _host_float(self._wmax))
        self._bias = dense_block.bias.data() if dense_block.bias is not None \
            else None
        self._cmin, self._cmax = calib_min, calib_max
        self._xs = _scale(calib_min, calib_max)
        self._units = dense_block._units

    def __call__(self, x):
        s = self._xs * self._ws
        xs = self._xs

        def fn(x_, wq_):
            xq = x_ if x_.dtype == torch.int8 else _quantize_t(x_, xs)
            return _int8_dense_acc(xq, wq_.to(xq.device)).to(
                torch.float32) * s

        out = _apply(fn, x, _like_input(x, self._wq))
        if self._bias is not None:
            out = _apply(lambda o, b_: o + b_.to(o.device), out,
                         _like_input(x, self._bias))
        return out


def _like_input(x, a):
    """``a`` as a tensor when the input is one (inside a block's forward),
    so the result is a tensor too; as it is otherwise."""
    if isinstance(a, NDArray) and not isinstance(x, NDArray):
        return a._data
    return a


def quantize_model(net, calib_data=None, calib_mode="minmax",
                   num_calib_batches=4):
    """Per-layer int8 Dense handles (the legacy API; ``quantize_net``
    swaps a whole net in place)."""
    from ..gluon import nn

    dense_layers = []

    def walk(b):
        if isinstance(b, nn.Dense):
            dense_layers.append(b)
        for c in b._modules.values():
            walk(c)

    walk(net)
    ranges = _calibrate(net, dense_layers, calib_data, calib_mode,
                        num_calib_batches)
    return {layer.name: QuantizedDense(layer, *ranges[id(layer)])
            for layer in dense_layers}


def _int8_conv_apply(x, wq, bias, conv_kwargs, in_scale, w_scale,
                     act_type=None, emit_scale=None, fp_dtype=None):
    """The one int8 convolution: quantize the input unless it arrives
    int8, accumulate in int32 (``_int8_conv_acc``), rescale and add the
    bias in fp32, optionally a fused relu, then int8 at ``emit_scale`` or
    the type ``fp_dtype`` (the input's when None)."""
    stride, pad, dilate, groups = _conv_geometry(conv_kwargs)
    fp_t = None if fp_dtype is None else nd.torch_dtype(fp_dtype)
    wq, bias = _like_input(x, wq), _like_input(x, bias)

    def fn(x_, wq_, *b_):
        out_dt = fp_t if fp_t is not None else x_.dtype
        if x_.dtype != torch.int8:
            xq = _quantize_t(x_.to(torch.float32), in_scale)
        else:
            xq = x_
        acc = _int8_conv_acc(xq, wq_.to(xq.device), stride, pad, dilate,
                             groups)
        y = acc.to(torch.float32) * (in_scale * w_scale)
        if b_:
            y = y + b_[0].to(device=y.device, dtype=torch.float32) \
                .reshape(1, -1, 1, 1)
        if act_type == "relu":
            y = torch.clamp_min(y, 0)
        if emit_scale is not None:
            return _quantize_t(y, emit_scale)
        return y.to(out_dt)

    return _apply(fn, x, wq, *([bias] if bias is not None else []))


def _unregistered(block, name, value):
    """``block.name = value`` kept out of torch's module registry (so the
    wrapped block's hooks and parameters stay out of the quantized net)."""
    object.__setattr__(block, name, value)


def _int8_buffer(block, wq):
    """The int8 weight as a (non-persistent) buffer of ``block``: a block
    owns no parameters, and its device is its buffers' (``jit.net_device``);
    ``cast`` leaves integer buffers as they are."""
    block.register_buffer("_int8_weight", wq._data, persistent=False)


@functools.cache
def _make_quantized_classes():
    from ..gluon.block import HybridBlock

    class _QuantizedDenseBlock(HybridBlock):
        """Int8 Dense replacement: a Block that owns no Parameters."""

        def __init__(self, dense_block, calib_min, calib_max, **kw):
            super().__init__(**kw)
            _unregistered(self, "_inner",
                          QuantizedDense(dense_block, calib_min, calib_max))
            _int8_buffer(self, self._inner._wq)
            self._flatten = getattr(dense_block, "_flatten", True)
            self._act_type = getattr(dense_block, "act_type", None)

        def forward(self, x):
            if self._flatten and len(x.shape) > 2:
                x = x.reshape((x.shape[0], -1))
            out = self._inner(x)
            if self._act_type is not None:
                out = nd.Activation(out, act_type=self._act_type)
            return out

    class _QuantizedConv2DBlock(HybridBlock):
        """Int8 Conv2D replacement: int8 operands and int32 accumulators
        (``_int8_conv_apply``), or under ``MXTPU_INT8_SIM=1`` the
        reference's QDQ route (fake-quant around the fp convolution)."""

        def __init__(self, conv_block, calib_min, calib_max, **kw):
            super().__init__(**kw)
            w = conv_block.weight.data()
            wq, wmin, wmax = quantize(w)
            _unregistered(self, "_conv", conv_block)
            self._cmin, self._cmax = calib_min, calib_max
            self._native = _int8_native()
            if self._native:
                _unregistered(self, "_wq", wq)
                _int8_buffer(self, wq)
                self._ws = _scale(_host_float(wmin), _host_float(wmax))
                self._xs = _scale(calib_min, calib_max)
            else:
                _unregistered(self, "_w_deq", dequantize(wq, wmin, wmax))

        def forward(self, x):
            if self._native:
                return self._forward_native(x)
            xq, _xmin, _xmax = quantize(x, self._cmin, self._cmax)
            x_deq = dequantize(xq, self._cmin, self._cmax)
            cb = self._conv
            w = self._w_deq._data.to(x.device if isinstance(
                x, torch.Tensor) else x._data.device)
            out = nd.Convolution(x_deq, w.to(cb.weight.data()._data.dtype),
                                 cb.bias.data()._data if cb.bias is not None
                                 else None, no_bias=cb.bias is None,
                                 **cb._kwargs)
            if cb.act_type:
                out = nd.Activation(out, act_type=cb.act_type)
            return out

        def _forward_native(self, x):
            cb = self._conv
            bias = cb.bias.data() if cb.bias is not None else None
            out = _int8_conv_apply(x, self._wq, bias, cb._kwargs,
                                   self._xs, self._ws)
            if cb.act_type:
                out = nd.Activation(out, act_type=cb.act_type)
            return out

    return _QuantizedDenseBlock, _QuantizedConv2DBlock


@functools.cache
def _make_group_class():
    """Fused [Conv2D (+folded BatchNorm) (+ReLU)] int8 group (the block
    form of MXNet's quantize_graph_pass.cc fusion): BN folds into the conv
    weights and bias (fp64 on the host) at quantize time, the conv runs
    int8 operands with int32 accumulators, and when the NEXT group is a
    direct consumer the group emits int8 itself."""
    from ..gluon.block import HybridBlock

    class _QuantizedConvGroup(HybridBlock):

        def __init__(self, conv_block, bn_block, act_type, in_rng, out_rng,
                     **kw):
            super().__init__(**kw)
            w = conv_block.weight.data()
            self._fp_dtype = w.dtype.name
            wf = w.asnumpy().astype(onp.float64)
            bias = (conv_block.bias.data().asnumpy().astype(onp.float64)
                    if conv_block.bias is not None
                    else onp.zeros(wf.shape[0], onp.float64))
            if bn_block is not None:
                g = bn_block.gamma.data().asnumpy().astype(onp.float64)
                be = bn_block.beta.data().asnumpy().astype(onp.float64)
                m = bn_block.running_mean.data().asnumpy().astype(onp.float64)
                v = bn_block.running_var.data().asnumpy().astype(onp.float64)
                s = g / onp.sqrt(v + bn_block._epsilon)
                wf = wf * s.reshape((-1,) + (1,) * (wf.ndim - 1))
                bias = (bias - m) * s + be
            ws = (float(onp.abs(wf).max()) / 127.0) or 1.0
            wq = onp.clip(onp.round(wf / ws), -127, 127).astype(onp.int8)
            ctx = w.context
            _unregistered(self, "_wq", nd.array(wq, ctx=ctx, dtype="int8"))
            _int8_buffer(self, self._wq)
            _unregistered(self, "_bias",
                          nd.array(bias.astype(onp.float32), ctx=ctx))
            self._ws = ws
            self._in_scale = _scale(*in_rng)
            self._out_scale = _scale(*out_rng)
            self._act_type = act_type
            self._kwargs = dict(conv_block._kwargs)
            self.emit_int8 = False   # set by the pass when a consumer links

        def set_in_scale(self, s):
            self._in_scale = s

        def out_scale(self):
            return self._out_scale

        def forward(self, x):
            act, emit, out_s = self._act_type, self.emit_int8, self._out_scale
            fuse_act = act in (None, "relu")
            out = _int8_conv_apply(
                x, self._wq, self._bias, self._kwargs,
                self._in_scale, self._ws,
                act_type=act if fuse_act else None,
                emit_scale=out_s if (fuse_act and emit) else None,
                fp_dtype=self._fp_dtype)
            if not fuse_act:   # another activation: fp, then (re)quantize
                out = nd.Activation(out, act_type=act)
                if emit:
                    out, _, _ = quantize(out, -127.0 * out_s, 127.0 * out_s)
            return out

    return _QuantizedConvGroup


@functools.cache
def _make_passthrough_class():
    from ..gluon.block import HybridBlock

    class _Passthrough(HybridBlock):
        """Replaces a BatchNorm/Activation absorbed into a conv group."""

        def forward(self, x):
            return x

    return _Passthrough


@functools.cache
def _make_residual_class():
    """Int8-aware wrapper of the model zoo's V1 residual blocks
    (``BasicBlockV1``/``BottleneckV1``: out = relu(body(x) +
    [downsample](x))): an int8 input flows straight into the body's first
    group and the downsample conv, only the identity leg rescales, and
    when the next block consumes int8 the output quantizes once at the
    block's boundary."""
    from ..gluon.block import HybridBlock
    GroupCls = _make_group_class()

    class _QuantizedResidualBlock(HybridBlock):

        def __init__(self, inner, in_rng, out_rng, **kw):
            super().__init__(**kw)
            self.inner = inner
            self._in_scale = _scale(*in_rng)
            self._out_scale = _scale(*out_rng)
            self.emit_int8 = False
            self.set_in_scale(self._in_scale)

        def _entry_groups(self):
            inner = self.inner
            outs = []
            body = getattr(inner, "body", None)
            if body is not None and body._modules:
                first = next(iter(body._modules.values()))
                if isinstance(first, GroupCls):
                    outs.append(first)
            ds = getattr(inner, "downsample", None)
            if ds is not None and getattr(ds, "_modules", None):
                first = next(iter(ds._modules.values()))
                if isinstance(first, GroupCls):
                    outs.append(first)
            return outs

        def set_in_scale(self, s):
            self._in_scale = s
            for g in self._entry_groups():
                g.set_in_scale(s)

        def can_accept_int8(self):
            """int8 may flow in only when EVERY entry conv is a quantized
            group (an excluded fp conv would see raw int8 codes)."""
            inner = self.inner
            n_entries = 1 + (getattr(inner, "downsample", None) is not None)
            return len(self._entry_groups()) == n_entries

        def out_scale(self):
            return self._out_scale

        def forward(self, x):
            inner = self.inner
            ds = getattr(inner, "downsample", None)
            residual = ds(x) if ds is not None else x
            y = inner.body(x)
            if residual.dtype == torch.int8:   # identity leg: rescale only
                in_s, dt = self._in_scale, y.dtype
                residual = (residual.to(torch.float32) * in_s).to(dt)
            out = nd.Activation(y + residual, act_type="relu")
            if self.emit_int8:
                out = _quantize_t(out, self._out_scale)
            return out

    return _QuantizedResidualBlock


_LAZY_CLASSES = {
    "QuantizedDenseBlock": lambda: _make_quantized_classes()[0],
    "QuantizedConv2DBlock": lambda: _make_quantized_classes()[1],
    "QuantizedConvGroup": _make_group_class,
    "QuantizedResidualBlock": _make_residual_class}


def __getattr__(name):
    """The block classes are built at their first use, so that importing
    this module does not import gluon (package init order)."""
    if name in _LAZY_CLASSES:
        return _LAZY_CLASSES[name]()
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


def _calib_inputs(calib_data, num_calib_batches):
    if calib_data is None:
        return
    for i, batch in enumerate(calib_data):
        if i >= num_calib_batches:
            break
        x = batch[0] if isinstance(batch, (list, tuple)) else batch
        yield x.data[0] if hasattr(x, "data") and not isinstance(
            x, (NDArray, torch.Tensor)) else x


def _calibrate(net, layers, calib_data, calib_mode, num_calib_batches):
    """Hook-based range collection shared by quantize_model and
    quantize_net: {id(layer): (lo, hi)}."""
    stats = {}

    def make_hook(key):
        def hook(blk, inputs, output):
            stats.setdefault(key, []).append(inputs[0])
        return hook

    handles = [l.register_forward_hook(make_hook(id(l))) for l in layers]
    try:
        for x in _calib_inputs(calib_data, num_calib_batches):
            net(x)
    finally:
        for h in handles:
            if h is not None:
                h.detach()
    out = {}
    for l in layers:
        acts = stats.get(id(l))
        if acts:
            out[id(l)] = (calib_entropy(acts) if calib_mode == "entropy"
                          else calib_minmax(acts))
        else:
            out[id(l)] = (-1.0, 1.0)
    return out


def quantize_net(net, calib_data=None, calib_mode="minmax",
                 num_calib_batches=4, quantize_conv=True,
                 exclude_layers=(), fold_bn=True):
    """Int8 conversion of a Gluon net in place (MXNet's quantize_net and
    quantize_graph_pass.cc): Dense layers become int8 matmul blocks; by
    default (``fold_bn``, the int8 route) Conv2D layers become fused
    [conv + folded BN + relu] int8 groups with int8 flowing between
    directly chained groups. Calibration collects the input (and group
    output) ranges over ``calib_data`` (minmax or KL-entropy). Captured
    forwards of hybridized blocks are dropped after the swap."""
    from ..gluon import nn

    if (fold_bn and quantize_conv and _int8_native()
            and not isinstance(net, (nn.Dense, nn.Conv2D))):
        return _quantize_net_groups(net, calib_data, calib_mode,
                                    num_calib_batches, exclude_layers)
    return _quantize_net_legacy(net, calib_data, calib_mode,
                                num_calib_batches, quantize_conv,
                                exclude_layers)


def _swap(parent, key, old, new):
    parent._modules[key] = new
    for attr, val in list(vars(parent).items()):
        if val is old:
            object.__setattr__(parent, attr, new)


def _quantize_net_legacy(net, calib_data, calib_mode, num_calib_batches,
                         quantize_conv, exclude_layers):
    """Per-block swap (no BN folding, no int8 between layers): Dense →
    int8 matmul block, Conv2D → int8 (or QDQ) block."""
    from ..gluon import nn
    QD, QC = _make_quantized_classes()

    def is_target(b):
        if isinstance(b, nn.Dense) and b.name not in exclude_layers:
            return "dense"
        if quantize_conv and isinstance(b, nn.Conv2D) and \
                b.name not in exclude_layers:
            return "conv"
        return None

    root_kind = is_target(net)
    targets = []  # (parent, child_key, block, kind)

    def walk(b):
        for key, child in list(b._modules.items()):
            kind = is_target(child)
            if kind:
                targets.append((b, key, child, kind))
            else:
                walk(child)

    if not root_kind:
        walk(net)
    layers = [net] if root_kind else [t[2] for t in targets]
    ranges = _calibrate(net, layers, calib_data, calib_mode,
                        num_calib_batches)

    def wrap(block, kind):
        lo, hi = ranges[id(block)]
        return QD(block, lo, hi) if kind == "dense" else QC(block, lo, hi)

    if root_kind:
        return wrap(net, root_kind)
    for parent, key, block, kind in targets:
        _swap(parent, key, block, wrap(block, kind))

    _clear_forward_caches(net)
    return net


def _clear_forward_caches(net):
    """Drop every captured forward after a swap: a hybridized block would
    otherwise replay its fp32 graphs."""
    graphs = getattr(net, "_graphs", None)
    if graphs is not None:
        graphs.clear()
    for c in net._modules.values():
        if c is not None:
            _clear_forward_caches(c)


def _quantize_net_groups(net, calib_data, calib_mode, num_calib_batches,
                         exclude_layers):
    """The fused-group pass (MXNet's quantize_graph_pass.cc):

    1. Walk every container. Inside a HybridSequential (child order is
       dataflow) each Conv2D absorbs a directly following BatchNorm
       (folded) and relu Activation into ONE group; in other parents each
       Conv2D becomes a standalone fp-in/fp-out group.
    2. Calibrate group input and output ranges, V1 residual blocks' in/out
       ranges and Dense input ranges in one hooked forward.
    3. Swap the groups in (absorbed blocks become passthroughs), wrap V1
       residual blocks int8-aware, then link chains (``_link_chains``).
    """
    from ..gluon import nn
    from ..gluon.model_zoo import vision as _zoo
    GroupCls = _make_group_class()
    ResCls = _make_residual_class()
    Pass = _make_passthrough_class()
    QD, _ = _make_quantized_classes()
    res_types = (_zoo.BasicBlockV1, _zoo.BottleneckV1)

    groups = []         # group descriptors
    res_blocks = []     # (parent, key, block)
    dense_targets = []  # (parent, key, block)

    def walk(parent):
        seq = isinstance(parent, nn.HybridSequential)
        kids = list(parent._modules.items())
        i = 0
        while i < len(kids):
            key, child = kids[i]
            if isinstance(child, nn.Dense) and \
                    child.name not in exclude_layers:
                dense_targets.append((parent, key, child))
                i += 1
                continue
            if isinstance(child, nn.Conv2D) and \
                    child.name not in exclude_layers:
                bn = act = None
                j = i + 1
                if seq and j < len(kids) \
                        and isinstance(kids[j][1], nn.BatchNorm) \
                        and kids[j][1]._axis == 1:
                    bn = kids[j]
                    j += 1
                if seq and j < len(kids) \
                        and isinstance(kids[j][1], nn.Activation) \
                        and kids[j][1]._act_type == "relu" \
                        and child.act_type is None:
                    act = kids[j]
                    j += 1
                groups.append({"parent": parent, "key": key, "conv": child,
                               "bn": bn, "act": act})
                i = j
                continue
            if isinstance(child, res_types) and \
                    child.name not in exclude_layers:
                res_blocks.append((parent, key, child))
            if child is not None:
                walk(child)
            i += 1

    walk(net)

    # --- calibration: group input/output + dense input ranges, one pass ---
    stats_in, stats_out = {}, {}

    def in_hook(key):
        def hook(blk, inputs, output):
            stats_in.setdefault(key, []).append(inputs[0])
        return hook

    def out_hook(key):
        def hook(blk, inputs, output):
            stats_out.setdefault(key, []).append(output)
        return hook

    handles = []
    for gi, g in enumerate(groups):
        handles.append(g["conv"].register_forward_hook(in_hook(("g", gi))))
        last = (g["act"] or g["bn"] or (None, g["conv"]))[1]
        handles.append(last.register_forward_hook(out_hook(("g", gi))))
    for parent, key, blk in res_blocks:
        handles.append(blk.register_forward_hook(in_hook(("r", id(blk)))))
        handles.append(blk.register_forward_hook(out_hook(("r", id(blk)))))
    for parent, key, blk in dense_targets:
        handles.append(blk.register_forward_hook(in_hook(("d", id(blk)))))
    try:
        for x in _calib_inputs(calib_data, num_calib_batches):
            net(x)
    finally:
        for h in handles:
            if h is not None:
                h.detach()

    calib = calib_entropy if calib_mode == "entropy" else calib_minmax

    def rng(stats, key):
        acts = stats.get(key)
        return calib(acts) if acts else (-1.0, 1.0)

    # --- build + swap ---
    for gi, g in enumerate(groups):
        obj = GroupCls(g["conv"], g["bn"] and g["bn"][1],
                       g["act"][1]._act_type if g["act"]
                       else g["conv"].act_type,
                       rng(stats_in, ("g", gi)), rng(stats_out, ("g", gi)))
        parent = g["parent"]
        _swap(parent, g["key"], g["conv"], obj)
        for absorbed in (g["bn"], g["act"]):
            if absorbed is not None:
                parent._modules[absorbed[0]] = Pass()

    for parent, key, blk in res_blocks:
        _swap(parent, key, blk, ResCls(blk, rng(stats_in, ("r", id(blk))),
                                       rng(stats_out, ("r", id(blk)))))

    for parent, key, blk in dense_targets:
        lo, hi = rng(stats_in, ("d", id(blk)))
        _swap(parent, key, blk, QD(blk, lo, hi))

    _link_chains(net)
    _clear_forward_caches(net)
    return net


def _link_chains(root):
    """int8 chain linking over the swapped tree: inside every
    HybridSequential, in dataflow order, a producer whose exit is
    int8-capable and a consumer whose entry is int8-capable, separated
    only by int8-transparent blocks (max-pool, passthroughs), are linked:
    the producer emits int8 and the consumer's input scale becomes the
    producer's output scale. A nested HybridSequential's entry/exit are
    its first/last child's, so model-zoo stages chain end to end."""
    from ..gluon import nn
    GroupCls = _make_group_class()
    ResCls = _make_residual_class()
    Pass = _make_passthrough_class()

    def transparent(b):
        return isinstance(b, (Pass, nn.MaxPool2D))

    def entry(b):
        if isinstance(b, GroupCls):
            return b
        if isinstance(b, ResCls):
            return b if b.can_accept_int8() else None
        if isinstance(b, nn.HybridSequential):
            for c in b._modules.values():
                if transparent(c):   # int8 passes through unchanged
                    continue
                return entry(c)
        return None

    def exit_(b):
        if isinstance(b, (GroupCls, ResCls)):
            return b
        if isinstance(b, nn.HybridSequential):
            for c in reversed(list(b._modules.values())):
                if transparent(c):   # trailing pool/passthrough keeps int8
                    continue
                return exit_(c)
        return None

    def link(parent):
        if isinstance(parent, GroupCls):
            return
        if isinstance(parent, ResCls):
            # the wrapper keeps its own entry/exit scales; its body still
            # chains inside (the last body group stays fp: the residual
            # add consumes it)
            body = getattr(parent.inner, "body", None)
            if body is not None:
                link(body)
            return
        if isinstance(parent, nn.HybridSequential):
            prev_exit = None
            for child in parent._modules.values():
                if isinstance(child, (Pass, nn.MaxPool2D)):
                    continue   # transparent: the chain continues across
                e = entry(child)
                if prev_exit is not None and e is not None:
                    prev_exit.emit_int8 = True
                    e.set_in_scale(prev_exit.out_scale())
                prev_exit = exit_(child)
        for child in parent._modules.values():
            if child is not None:
                link(child)

    link(root)
