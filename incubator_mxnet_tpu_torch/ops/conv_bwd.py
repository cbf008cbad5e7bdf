"""Fused 3x3 / stride-1 / pad-1 conv backward (counterpart of
``incubator_mxnet_tpu/ops/conv_bwd.py``).

K4, the JAX package's Pallas ``_conv_bwd_kernel``, is a hand-written CUDA
kernel here (``csrc/conv_bwd.cu``) that computes both gradients of

    y[n,p,q,k]  = sum_{r,s,c} x[n, p+r-1, q+s-1, c] * w[r,s,c,k]

in NHWC / HWIO layout:

    dx[n,a,b,c] = sum_{r,s}   dy[n, a+1-r, b+1-s, :] @ w[r,s].T   (9 taps)
    dw[r,s,c,k] = sum_{n,p,q} x[n, p+r-1, q+s-1, c] * dy[n,p,q,k]

with fp32 sums, dx cast once to x's type and dw once to w's (bf16/fp16
inputs run on tensor cores, float32 inputs on fp32 FMAs, routed by type
inside the C entry point; neither route rounds anything else). ``conv3x3_bwd``
launches it on CUDA tensors and runs its plain PyTorch version
(``_conv_bwd_reference``, the same nine taps as dense fp32 matrix products,
no conv call) on CPU tensors; a CUDA tensor of a shape or type the kernel
does not take raises instead of falling back.

``conv3x3_s1`` is the ``torch.autograd.Function`` around it, the
counterpart of the JAX ``custom_vjp``: the forward is the library conv
(``F.conv2d`` on channels-last views, as the JAX forward is ``lax.conv``),
the backward is ``conv3x3_bwd`` when ``conv3x3_bwd_legal`` holds and the
library conv's own gradient otherwise. Model-zoo convs do not route through
it, as in the JAX package (its ``config.py`` keeps them on the library
lowering).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import get_env
from . import _kernels

__all__ = ["conv3x3_bwd", "conv3x3_bwd_legal", "conv3x3_s1", "conv3x3_bytes"]

KERNEL = "conv_bwd"
SOURCE = "conv_bwd.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGNATURES = {
    # x, dy, wd, dx, dw, ws, N, H, W, C, K, splits, chunk, dtype, device,
    # stream
    "mxt_conv3x3_bwd": "pppppp" "iiiii" "ii" "ii" "p"}
_TILE = 64              # c and k per wgrad CTA in conv_bwd.cu (both routes)
_PIXELS = 64            # pixels per tensor-core wgrad step in conv_bwd.cu (the
                        # fp32 route steps 32, which divides it)
_TAPS = 3               # taps per tensor-core wgrad CTA (the fp32 route: 1)
_CTAS_IN_FLIGHT = 132 * 4   # tensor-core wgrad CTAs (8 warps) to aim for:
                            # 4 per SM of an H100


def conv3x3_bwd_legal(x_shape, w_shape, stride=(1, 1), padding=(1, 1),
                      dilation=(1, 1), groups=1, dtype=torch.float32):
    """True when ``conv3x3_s1``'s backward takes K4: the kernel takes the
    conv (``_kernel_takes``) and ``MXTPU_CONV_BWD_PALLAS`` is on."""
    return _kernel_takes(x_shape, w_shape, stride, padding, dilation, groups,
                         dtype) and get_env("MXTPU_CONV_BWD_PALLAS")


def _kernel_takes(x_shape, w_shape, stride=(1, 1), padding=(1, 1),
                  dilation=(1, 1), groups=1, dtype=torch.float32):
    """3x3, stride 1, pad 1, dilation 1, groups 1, NHWC x (N, H, W, C)
    against HWIO w (3, 3, C, K) with C and K multiples of 8 (16-byte bf16
    rows), N*H*W below 2^31, and a float32, bfloat16 or float16 ``dtype``.
    Shape-only: no memory budget (the kernel tiles any size), so conv5
    (C = K = 512) is legal."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    N, H, W, C = x_shape
    KH, KW, wc, K = w_shape
    if (KH, KW) != (3, 3) or wc != C or min(N, H, W, C, K) < 1:
        return False
    if tuple(stride) != (1, 1) or tuple(padding) != (1, 1):
        return False
    if tuple(dilation) != (1, 1) or groups != 1:
        return False
    return C % 8 == 0 and K % 8 == 0 and N * H * W < 2 ** 31 \
        and dtype in _DTYPE_CODES


def conv3x3_bytes(x_shape, k):
    """Fused-ideal HBM bytes for the backward: |x| + |dy| + |dx| + |dw|."""
    n, h, w, c = x_shape
    act = n * h * w
    return 2 * (act * c + act * k + act * c) + 2 * 9 * c * k


def _check_shapes(x, dy, w):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("conv3x3_bwd takes NHWC x and HWIO w; got x %s, w %s"
                         % (tuple(x.shape), tuple(w.shape)))
    N, H, W, C = x.shape
    K = w.shape[3]
    if tuple(w.shape) != (3, 3, C, K) or tuple(dy.shape) != (N, H, W, K):
        raise ValueError("conv3x3_bwd needs w (3, 3, C, K) and dy (N, H, W, K)"
                         " for x (N, H, W, C); got x %s, dy %s, w %s"
                         % (tuple(x.shape), tuple(dy.shape), tuple(w.shape)))


def _conv_bwd_reference(x, dy, w):
    """Plain version of K4: (dx in x's type, dw in w's type), the nine taps
    of the formulation above as dense fp32 matrix products on zero-padded
    x and dy, no conv call."""
    _check_shapes(x, dy, w)
    N, H, W, C = x.shape
    K = w.shape[3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    dyp = F.pad(dy.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    dy2 = dy.float().reshape(N * H * W, K)
    dx = torch.zeros(N * H * W, C, dtype=torch.float32, device=x.device)
    dw = torch.empty(3, 3, C, K, dtype=torch.float32, device=x.device)
    for r in range(3):
        for s in range(3):
            # dy[n, a+1-r, b+1-s] is dyp[n, a+2-r, b+2-s]; x[n, p+r-1, q+s-1]
            # is xp[n, p+r, q+s]
            dx += dyp[:, 2 - r:2 - r + H, 2 - s:2 - s + W, :] \
                .reshape(N * H * W, K) @ wf[r, s].t()
            dw[r, s] = xp[:, r:r + H, s:s + W, :].reshape(N * H * W, C).t() \
                @ dy2
    return dx.reshape(N, H, W, C).to(x.dtype), dw.to(w.dtype)


def _wgrad_split(m, c, k):
    """(splits, chunk): the wgrad's pixels cut into ``splits`` slices of
    ``chunk`` (a multiple of its 64-pixel step), enough slices that about
    ``_CTAS_IN_FLIGHT`` tensor-core CTAs run, each slice at least 256
    pixels. The fp32 route runs ``_TAPS`` times as many CTAs (one tap
    each) on the same slices."""
    tiles = 9 // _TAPS * -(-c // _TILE) * -(-k // _TILE)
    splits = max(1, min(-(-_CTAS_IN_FLIGHT // tiles), -(-m // 256)))
    chunk = -(-m // splits)
    chunk = -(-chunk // _PIXELS) * _PIXELS
    return -(-m // chunk), chunk


def _conv_bwd_cuda(x, dy, w):
    """Launch K4 on x's device and current stream → (dx, dw)."""
    _check_shapes(x, dy, w)
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype \
            or w.dtype != x.dtype:
        raise TypeError("conv_bwd takes x, dy and w of one type, float32, "
                        "bfloat16 or float16; got %s, %s, %s"
                        % (x.dtype, dy.dtype, w.dtype))
    if not _kernel_takes(x.shape, w.shape, dtype=x.dtype):
        raise ValueError("conv_bwd does not take x %s, w %s (see "
                         "conv3x3_bwd_legal)" % (tuple(x.shape),
                                                 tuple(w.shape)))
    if not all(t.is_contiguous() for t in (x, dy, w)):
        raise ValueError("conv_bwd needs contiguous NHWC x, dy and HWIO w")
    if any(t.device != x.device for t in (dy, w)) or x.device.type != "cuda":
        raise ValueError("conv_bwd launches on CUDA tensors of one device; "
                         "got %s" % sorted({str(t.device) for t in (x, dy, w)}))
    N, H, W, C = x.shape
    K = w.shape[3]
    # rotated weight: wd[(tr*3+ts)*K + k, c] = w[2-tr, 2-ts, c, k]
    wd = w.flip((0, 1)).permute(0, 1, 3, 2).reshape(9 * K, C).contiguous()
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    splits, chunk = _wgrad_split(N * H * W, C, K)
    ws = torch.empty(splits * 9 * C * K, dtype=torch.float32, device=x.device)
    lib = _kernels.bind(SOURCE, _SIGNATURES)
    _kernels.launched(lib, KERNEL, lib.mxt_conv3x3_bwd(
        x.data_ptr(), dy.data_ptr(), wd.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), ws.data_ptr(), N, H, W, C, K, splits, chunk,
        _DTYPE_CODES[x.dtype], x.device.index, _kernels.stream(x)))
    return dx, dw


def conv3x3_bwd(x, dy, w, *, block_n=None, interpret=None):
    """Fused backward of ``y = conv3x3_s1(x, w)`` (NHWC / HWIO) →
    ``(dx, dw)``: K4 on CUDA tensors, its plain version on CPU tensors.
    The JAX package's Pallas knobs are checked and change nothing:
    ``interpret`` (None or a bool) picks Pallas's interpret mode, which
    runs the kernel's own arithmetic without the TPU, so CUDA tensors
    launch K4 either way; ``block_n`` (None or a positive int) is a TPU
    tile, and Hopper's tiles are K4's own (ROADMAP §3, departures)."""
    if block_n is not None and (isinstance(block_n, bool) or
                                not isinstance(block_n, int) or block_n < 1):
        raise ValueError("block_n must be None or a positive int, got %r"
                         % (block_n,))
    if interpret is not None and not isinstance(interpret, bool):
        raise ValueError("interpret must be None or a bool, got %r"
                         % (interpret,))
    devices = {t.device.type for t in (x, dy, w)}
    if devices == {"cpu"}:
        return _conv_bwd_reference(x, dy, w)
    if devices != {"cuda"}:
        raise ValueError("conv3x3_bwd takes its tensors all on CUDA or all on "
                         "the CPU; got %s" % sorted(devices))
    return _conv_bwd_cuda(x, dy, w)


def _conv_fwd_ref(x, w):
    """The library conv in NHWC / HWIO: ``F.conv2d`` on the channels-last
    views of x and w, padding 1, returned as contiguous NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


class _Conv3x3S1(torch.autograd.Function):
    """Library forward; K4 backward where legal, else the library's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv_fwd_ref(x, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        if conv3x3_bwd_legal(x.shape, w.shape, dtype=x.dtype):
            return conv3x3_bwd(x, dy, w)
        with torch.enable_grad():
            xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
            return torch.autograd.grad(_conv_fwd_ref(xr, wr), (xr, wr), dy)


def conv3x3_s1(x, w):
    """3x3 / stride-1 / pad-1 NHWC conv with HWIO weights whose backward is
    K4 (``conv3x3_bwd``) when the shape is legal."""
    return _Conv3x3S1.apply(x.contiguous(), w.contiguous())
