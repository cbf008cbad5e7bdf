"""Flash attention, forward and backward (counterpart of
``incubator_mxnet_tpu/ops/attention.py``).

Three hand-written CUDA kernels stand for the three Pallas kernels: K1, the
forward (``csrc/flash_fwd.cu``, the port of ``_fa_kernel``), and K2 and K3,
the backward's dK/dV and dQ (``csrc/flash_bwd.cu``, the ports of
``_fa_bwd_dkv_kernel`` and ``_fa_bwd_dq_kernel``). Each wrapper launches its
kernel on CUDA tensors and runs its plain PyTorch version (``_fa_reference``,
``_fa_bwd_reference``) on CPU tensors. A CUDA tensor always goes to the
kernel; a shape, type or layout the kernel does not take raises instead of
falling back.

``flash_attention`` and ``flash_attention_lse`` are ``torch.autograd``
Functions around the kernels, the counterparts of the JAX package's
``custom_vjp``s: the forward runs K1 and saves q, k, v, out and lse, the
backward computes ``delta = rowsum(dO * out)`` (minus the LSE cotangent for
``flash_attention_lse``, whose LSE output is differentiable) and runs K2
and K3.

Routing is by shape alone: ``flash_attention_legal`` (q, k and v of one
shape, head width 64 or 128) takes the kernels, every other shape takes the
differentiable composites ``_blocked_reference`` and ``_dense_with_lse``, as
the JAX package routes shapes its kernels refuse. ``flash_attention_supported``
is the same gate: the TPU block-size and profitability heuristics are not
carried over, they were tuned for a TPU.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _kernels

__all__ = ["flash_attention", "flash_attention_legal",
           "flash_attention_supported", "flash_attention_lse",
           "attention_with_lse"]

KERNEL = "flash_fwd"
SOURCE = "flash_fwd.cu"
KERNEL_DKV = "flash_bwd_dkv"
KERNEL_DQ = "flash_bwd_dq"
BWD_SOURCE = "flash_bwd.cu"
SUPPORTED_D = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BLOCK = 64        # rows of a q or kv tile in flash_fwd.cu and flash_bwd.cu


def _causal_keep(sq, sk, device):
    """(sq, sk) bool mask of the kept (row >= column) score entries."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril()


def _blocked_reference(q, k, v, causal, scale):
    """Composite attention with an fp32 softmax: the route for shapes the
    kernel does not take."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[2], k.shape[2], s.device),
                          -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _dense_with_lse(q, k, v, causal, scale):
    """Composite (out, lse (B, H, S) fp32) with the -inf-safe softmax."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[2], k.shape[2], s.device),
                          -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    out = torch.matmul((p / l).to(v.dtype), v)
    lse = (m_safe + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _fa_reference(q, k, v, causal, scale):
    """Plain version of K1: the same function in dense form. fp32 scores of
    the pre-scaled q, the kernel's -inf-safe softmax, ``out = acc / l`` in
    q's type and ``lse = m + log l`` in fp32 with shape (B*H, 1, S)."""
    B, H, S, D = q.shape
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(~_causal_keep(S, S, s.device), -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    out = (torch.matmul(p, v.float()) / l).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B * H, 1, S)
    return out, lse


def _bwd_delta(o, do, g_lse=None):
    """(B*H, 1, S) fp32 ``rowsum(dO * O)``, shifted by ``-g_lse`` when the
    LSE output has a cotangent: d lse_i / d s_ij = p_ij, so it enters ds
    exactly as ``-delta`` does."""
    B, H, S, _ = o.shape
    delta = (do.float() * o.float()).sum(dim=-1).reshape(B * H, 1, S)
    if g_lse is not None:
        delta = delta - g_lse.float().reshape(B * H, 1, S)
    return delta


def _fa_bwd_reference(q, k, v, o, lse, do, causal, scale, g_lse=None):
    """Plain version of K2 and K3: (dq, dk, dv) in the input type, computed
    densely in fp32 as ``_recompute_p_ds`` does: ``s = (q kᵀ) * scale``
    (scaled after the product), ``p = exp(s - lse)`` and 0 where s is not
    finite, ``ds = p (dp - delta) * scale``, each gradient cast once."""
    B, H, S, D = q.shape
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = _bwd_delta(o, do, g_lse).reshape(B, H, S, 1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(S, S, s.device), -math.inf)
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_legal(q_shape, k_shape=None, v_shape=None):
    """True when the kernels take these shapes: (B, H, S, D) with D a
    supported head width, and k, v (when given) of q's shape."""
    q_shape = tuple(q_shape)
    if len(q_shape) != 4 or q_shape[3] not in SUPPORTED_D or \
            min(q_shape) < 1:
        return False
    return all(s is None or tuple(s) == q_shape for s in (k_shape, v_shape))


flash_attention_supported = flash_attention_legal


def _check_kernel_args(name, qkv, rows=()):
    """Raise unless ``qkv`` (q, k, v and dO for the backward) are contiguous
    (B, H, S, D) tensors of one shape, one supported type and one CUDA
    device, and ``rows`` (lse, delta) contiguous (B*H, 1, S) fp32 there."""
    q = qkv[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in qkv):
        raise ValueError("%s needs q, k, v%s of one (B, H, S, D) shape; got %s"
                         % (name, ", dO" if len(qkv) > 3 else "",
                            ", ".join(str(tuple(t.shape)) for t in qkv)))
    B, H, S, D = q.shape
    if D not in SUPPORTED_D:
        raise ValueError("%s takes head width D in %s, got %d"
                         % (name, SUPPORTED_D, D))
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in qkv):
        raise TypeError("%s takes float32, bfloat16 or float16 inputs of one "
                        "type; got %s" % (name, ", ".join(str(t.dtype)
                                                          for t in qkv)))
    for t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (B * H, 1, S):
            raise ValueError("%s needs lse and delta as (B*H, 1, S) float32; "
                             "got %s %s" % (name, tuple(t.shape), t.dtype))
    if not all(t.is_contiguous() for t in (*qkv, *rows)):
        raise ValueError("%s needs contiguous inputs" % name)
    if any(t.device != q.device for t in (*qkv, *rows)):
        raise ValueError("%s inputs lie on different devices" % name)
    if q.device.type != "cuda":
        raise ValueError("%s launches on CUDA tensors; got %s"
                         % (name, q.device))
    if B * H * -(-S // _BLOCK) >= 2 ** 31:
        raise ValueError("%s grid too large for shape %s"
                         % (name, tuple(q.shape)))


def _flash_fwd_cuda(q, k, v, causal, scale):
    """Launch K1 on q's device and current stream → (out, lse)."""
    _check_kernel_args(KERNEL, (q, k, v))
    B, H, S, D = q.shape
    lib = _lib(SOURCE)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, 1, S), dtype=torch.float32, device=q.device)
    _launched(lib, KERNEL, lib.mxt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B * H, S, D, float(scale), int(bool(causal)),
        _DTYPE_CODES[q.dtype], q.device.index, _stream(q)))
    return out, lse


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale):
    """Launch K2 on q's device and current stream → (dk, dv)."""
    _check_kernel_args(KERNEL_DKV, (q, k, v, do), (lse, delta))
    B, H, S, D = q.shape
    lib = _lib(BWD_SOURCE)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launched(lib, KERNEL_DKV, lib.mxt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B * H, S, D, float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
        q.device.index, _stream(q)))
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale):
    """Launch K3 on q's device and current stream → dq."""
    _check_kernel_args(KERNEL_DQ, (q, k, v, do), (lse, delta))
    B, H, S, D = q.shape
    lib = _lib(BWD_SOURCE)
    dq = torch.empty_like(q)
    _launched(lib, KERNEL_DQ, lib.mxt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, S, D,
        float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
        q.device.index, _stream(q)))
    return dq


def _stream(t):
    # the backward runs on autograd's thread: take the tensor's device's
    # current stream, never the thread's current device
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(lib, name, err):
    if err:
        raise RuntimeError("%s launch failed: %s"
                           % (name, lib.mxt_cuda_error_string(err).decode()))
    _kernels.count(name)


_ARGTYPES = {
    # q, k, v, out, lse, BH, S, D, scale, causal, dtype, device, stream
    "mxt_flash_fwd": "ppppp" "iii" "f" "iii" "p",
    # q, k, v, dO, lse, delta, dk, dv, BH, S, D, scale, causal, dtype, ...
    "mxt_flash_bwd_dkv": "pppppppp" "iii" "f" "iii" "p",
    # q, k, v, dO, lse, delta, dq, BH, S, D, scale, causal, dtype, ...
    "mxt_flash_bwd_dq": "ppppppp" "iii" "f" "iii" "p",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _lib(source):
    """The built library of ``source`` with its entry points' signatures."""
    lib = _kernels.load(source)
    if lib.mxt_cuda_error_string.restype is not ctypes.c_char_p:
        for fn, sig in _ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = [_CTYPES[c] for c in sig]
                getattr(lib, fn).restype = ctypes.c_int
        lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _on(tensors):
    """'cuda' or 'cpu' when every tensor lies there; raises otherwise."""
    devices = {t.device.type for t in tensors}
    if devices in ({"cuda"}, {"cpu"}):
        return devices.pop()
    raise ValueError("flash attention takes its tensors all on CUDA or all "
                     "on the CPU; got %s" % sorted(devices))


def _fa_call(q, k, v, causal, scale):
    """(out (B, H, S, D) in q's type, lse (B*H, 1, S) fp32): K1 on CUDA
    tensors, its plain version on CPU tensors."""
    if _on((q, k, v)) == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, scale)
    return _fa_reference(q, k, v, causal, scale)


def _fa_bwd_call(q, k, v, o, lse, do, causal, scale, g_lse=None):
    """(dq, dk, dv) in the input type: K2 and K3 on CUDA tensors, their
    plain version on CPU tensors."""
    if _on((q, k, v, o, lse, do)) == "cpu":
        return _fa_bwd_reference(q, k, v, o, lse, do, causal, scale, g_lse)
    delta = _bwd_delta(o, do, g_lse)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v): K1 forward, K2/K3 backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _fa_call(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # dO arrives from a transpose/reshape and may be strided
        return (*_fa_bwd_call(q, k, v, out, lse, do.contiguous(), ctx.causal,
                              ctx.scale), None, None)


class _FlashAttentionLSE(torch.autograd.Function):
    """(out, lse (B, H, S) fp32), both differentiable: the LSE cotangent
    folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        B, H, S, _ = q.shape
        out, lse = _fa_call(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse.reshape(B, H, S)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_fa_bwd_call(q, k, v, out, lse, do.contiguous(), ctx.causal,
                              ctx.scale, g_lse), None, None)


def flash_attention(q, k, v, causal=False, scale=None):
    """q, k, v: (B, H, S, D) → (B, H, S, D), differentiable."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if flash_attention_legal(q.shape, k.shape, v.shape):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _blocked_reference(q, k, v, causal, scale)


def flash_attention_lse(q, k, v, causal=False, scale=None):
    """Like ``flash_attention`` but also returns the per-row log-sum-exp
    (B, H, S) fp32, the statistic ring attention's online combine needs.
    Both outputs are differentiable. Requires a legal shape."""
    if not flash_attention_legal(q.shape, k.shape, v.shape):
        raise ValueError("flash_attention_lse: shapes %s, %s, %s are not "
                         "kernel-legal (see flash_attention_legal)"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttentionLSE.apply(q, k, v, causal, scale)


def attention_with_lse(q, k, v, causal=False, scale=None):
    """(out, lse) through the kernels for legal shapes, through the dense
    composite otherwise: the local step of ring/Ulysses attention."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if flash_attention_supported(q.shape, k.shape, v.shape):
        return flash_attention_lse(q, k, v, causal, scale)
    return _dense_with_lse(q, k, v, causal, scale)
