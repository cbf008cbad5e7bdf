"""Flash-attention forward (counterpart of
``incubator_mxnet_tpu/ops/attention.py``).

``_fa_call`` runs kernel K1, the hand-written CUDA flash-attention forward
in ``csrc/flash_fwd.cu`` (the port of the Pallas ``_fa_kernel``), on CUDA
tensors, and its plain PyTorch version ``_fa_reference`` on CPU tensors.
A CUDA tensor always goes to the kernel; a shape, type or layout the kernel
does not take raises instead of falling back.

``flash_attention`` routes by shape alone: ``flash_attention_legal`` (q, k
and v of one shape, head width 64 or 128) takes ``_fa_call``, every other
shape takes ``_blocked_reference``, as the JAX package routes shapes its
kernels refuse. The TPU block-size and profitability heuristics are not
carried over: they were tuned for a TPU.

Only the forward is here. The backward kernels (K2, K3) come with the
training slice, as a ``torch.autograd.Function``; until then a CUDA input
that requires grad raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _kernels

__all__ = ["flash_attention", "flash_attention_legal"]

KERNEL = "flash_fwd"
SOURCE = "flash_fwd.cu"
SUPPORTED_D = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BLOCK_Q = 64      # q rows per CTA in flash_fwd.cu


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


def flash_attention_legal(q_shape, k_shape=None, v_shape=None):
    """True when the kernel takes these shapes: (B, H, S, D) with D a
    supported head width, and k, v (when given) of q's shape."""
    q_shape = tuple(q_shape)
    if len(q_shape) != 4 or q_shape[3] not in SUPPORTED_D or \
            min(q_shape) < 1:
        return False
    return all(s is None or tuple(s) == q_shape for s in (k_shape, v_shape))


def _flash_fwd_cuda(q, k, v, causal, scale):
    """Launch K1 on q's device and current stream."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash-attention backward (kernels K2/K3) comes with the training "
            "slice; run the forward under torch.inference_mode()")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_fwd needs q, k, v of one (B, H, S, D) shape; "
                         "got %s, %s, %s" % (tuple(q.shape), tuple(k.shape),
                                             tuple(v.shape)))
    B, H, S, D = q.shape
    if D not in SUPPORTED_D:
        raise ValueError("flash_fwd takes head width D in %s, got %d"
                         % (SUPPORTED_D, D))
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError("flash_fwd takes float32, bfloat16 or float16 q, k, "
                        "v of one type; got %s, %s, %s"
                        % (q.dtype, k.dtype, v.dtype))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd needs contiguous q, k, v")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v lie on different devices")
    if B * H * -(-S // _BLOCK_Q) >= 2 ** 31:
        raise ValueError("flash_fwd grid too large for shape %s"
                         % (tuple(q.shape),))
    lib = _flash_lib()
    out = torch.empty_like(q)
    lse = torch.empty((B * H, 1, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mxt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), B * H, S, D,
                            float(scale), int(bool(causal)),
                            _DTYPE_CODES[q.dtype], q.device.index, stream)
    if err:
        raise RuntimeError("flash_fwd launch failed: %s"
                           % lib.mxt_cuda_error_string(err).decode())
    _kernels.count(KERNEL)
    return out, lse


def _flash_lib():
    lib = _kernels.load(SOURCE)
    if lib.mxt_flash_fwd.argtypes is None:
        p = ctypes.c_void_p
        lib.mxt_flash_fwd.argtypes = [p, p, p, p, p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, p]
        lib.mxt_flash_fwd.restype = ctypes.c_int
        lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _fa_call(q, k, v, causal, scale):
    """(out (B, H, S, D) in q's type, lse (B*H, 1, S) fp32): K1 on CUDA
    tensors, its plain version on CPU tensors."""
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cuda"}:
        return _flash_fwd_cuda(q, k, v, causal, scale)
    if devices == {"cpu"}:
        return _fa_reference(q, k, v, causal, scale)
    raise ValueError("flash attention takes q, k, v all on CUDA or all on "
                     "the CPU; got %s" % sorted(devices))


def flash_attention(q, k, v, causal=False, scale=None):
    """q, k, v: (B, H, S, D) → (B, H, S, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if flash_attention_legal(q.shape, k.shape, v.shape):
        return _fa_call(q, k, v, causal, scale)[0]
    return _blocked_reference(q, k, v, causal, scale)
