"""Runtime kernel compilation (counterpart of ``incubator_mxnet_tpu/rtc.py``).

The JAX package turns MXNet's NVRTC ``CudaModule`` into ``PallasModule``,
which compiles a user's Pallas kernel at run time (K5, ``PallasKernel.launch``).
On the card the facility is NVRTC again, as in MXNet:

- ``CudaModule(source, options=(), exports=())`` compiles CUDA C++ source
  with NVRTC for the current device's architecture (``sm_90a`` on an H100)
  into a cubin and loads it, per device, with CUDA's ``libcuda``
  (``cuModuleLoadData``, ``cuModuleGetFunction``). Both libraries are
  reached through ``ctypes``: ``libnvrtc`` under ``CUDA_HOME``/``lib64`` or
  in the ``nvidia/cuda_nvrtc`` directory of PyTorch's wheel, and
  ``libcuda.so.1``, which the GPU's kernel-mode installation provides.
  ``exports`` names C++ kernels (templates, namespaces) to be resolved
  through NVRTC's name expressions. A compile error raises with NVRTC's
  log.
- ``get_kernel(name, signature)`` parses MXNet's signature form
  (``"const float *x, float *y, int n"``): pointers and scalars of
  ``float``, ``double``, ``__half``, ``int``/``int32_t``, ``int64_t`` and
  ``uint8_t``.
- ``launch(args, ctx, grid_dims, block_dims, shared_mem=0)`` checks each
  tensor's type, device and contiguity against the signature and launches
  on ``torch.cuda.current_stream(device)`` under PyTorch's primary context
  of that device. There is no CPU route: a CPU context or tensor raises.
  What a launch needs beyond its arguments (the function, its context, its
  shared memory attribute, the argument slots) is resolved once per kernel
  and device, so back-to-back launches wait on the card, not the host.
- ``TritonModule(kernel_fn, out_shape_fn=None)`` takes over
  ``PallasModule``'s role for a ``@triton.jit`` function: ``launch`` makes
  a new output tensor (of ``out_shape_fn(*args)`` = (shape, dtype), else
  of ``args[0]``'s), calls ``kernel_fn[grid](*args, out, **meta)`` and
  returns the output, as ``PallasKernel.launch`` returns a new array.

Each launch counts one ``ops._kernels.count`` under ``"rtc"`` (NVRTC) or
``"rtc_triton"``. Nothing is loaded or compiled at import.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os
import re
import struct
import sys
import threading
import time

import torch

from .context import as_device
from .ops import _kernels

__all__ = ["CudaModule", "CudaKernel", "TritonModule", "TritonKernel"]

# signature type -> (torch dtype of a pointer's tensor, ctypes type of a scalar)
_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),   # a scalar passes its bits
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
}
_ARG = re.compile(r"^\s*(const\s+)?([A-Za-z_]\w*)\s*(\*)?\s*([A-Za-z_]\w*)?\s*$")
_MAX_DYNAMIC_SHARED = 8       # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
_STATIC_SHARED_LIMIT = 48 * 1024
_lock = threading.Lock()
_libs = {}          # "nvrtc", "cuda": the libraries
_contexts = {}      # device index -> its primary CUcontext, as an int
_resolved = {}      # a GPU Context, "cuda:N" or torch.device seen -> device


def _parse_signature(signature):
    """[(name, type, is_pointer, is_const)] of an MXNet kernel signature
    such as ``"const float *x, float *y, int n"``."""
    params = []
    for i, arg in enumerate(signature.split(",") if signature.strip() else []):
        m = _ARG.match(arg)
        if m is None:
            raise ValueError("cannot parse argument %d of the signature: %r"
                             % (i, arg))
        const, typ, star, name = m.groups()
        if typ not in _TYPES:
            raise ValueError("argument %d has type %r; rtc takes %s"
                             % (i, typ, ", ".join(sorted(_TYPES))))
        params.append((name or "arg%d" % i, typ, bool(star), bool(const)))
    return params


def _cuda_device(ctx):
    """The CUDA ``torch.device`` of ``ctx`` (a Context, device or string;
    None is the current context). A CPU context raises: rtc has no CPU
    route. A context naming its device is resolved once (later launches
    skip ``as_device`` and its device count); None, and "cuda" without an
    index, follow the current context and device at every launch."""
    try:
        return _resolved[ctx]
    except (KeyError, TypeError):
        pass
    device = as_device(ctx)
    if device.type != "cuda":
        raise ValueError("rtc launches CUDA kernels on a GPU context; got %s"
                         % device)
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if ctx is not None:
        _resolved[ctx] = device
    return device


def _half_bits(x):
    """The bits of ``x`` as an IEEE half, as PyTorch converts a Python
    number to float16: round to float32 first, then to half (round to
    nearest even); a value beyond the half range gives an infinity."""
    x = float(x)
    try:
        return struct.unpack("<H", struct.pack(
            "<e", struct.unpack("<f", struct.pack("<f", x))[0]))[0]
    except OverflowError:
        return 0xFC00 if x < 0 else 0x7C00


class _ArgLayout:
    """A kernel's arguments as ``cuLaunchKernel`` reads them: one ctypes
    slot per parameter of the signature and the ``void*[]`` array pointing
    at the slots, both made once. ``fill`` checks a launch's arguments and
    writes them into the slots in place; it raises unless each pointer
    argument is a contiguous tensor of the signature's type on ``device``
    and each scalar a number. The caller holds the slots until the launch
    has read them."""

    def __init__(self, params):
        self.params = params
        self.slots = [ctypes.c_void_p() if is_ptr else _TYPES[typ][1]()
                      for _name, typ, is_ptr, _const in params]
        self.array = (ctypes.c_void_p * max(1, len(params)))(
            *[ctypes.addressof(s) for s in self.slots])
        # per parameter: its slot, the tensor type of a pointer (else None)
        # and whether a scalar is a half
        self._plan = [(slot, _TYPES[typ][0] if is_ptr else None,
                       typ == "__half")
                      for slot, (_n, typ, is_ptr, _c) in zip(self.slots,
                                                             params)]

    def fill(self, args, device):
        if len(args) != len(self._plan):
            raise ValueError("the kernel takes %d arguments, got %d"
                             % (len(self._plan), len(args)))
        index = -1 if device.index is None else device.index   # cpu: -1
        for (slot, dtype, half), arg in zip(self._plan, args):
            if dtype is not None:
                if not isinstance(arg, torch.Tensor) or arg.dtype != dtype \
                        or arg.get_device() != index \
                        or not arg.is_contiguous():
                    self._refuse(args, device)
                slot.value = arg.data_ptr()
            elif isinstance(arg, torch.Tensor):
                self._refuse(args, device)
            else:
                slot.value = _half_bits(arg) if half else arg
        return self.slots

    def _refuse(self, args, device):
        """Raise for the first argument that ``fill`` cannot take."""
        for (name, typ, is_ptr, _const), arg in zip(self.params, args):
            dtype = _TYPES[typ][0]
            if not is_ptr:
                if isinstance(arg, torch.Tensor):
                    raise TypeError("argument %r is a %s scalar, got a "
                                    "tensor" % (name, typ))
            elif not isinstance(arg, torch.Tensor):
                raise TypeError("argument %r is a %s pointer: pass a tensor, "
                                "got %s" % (name, typ, type(arg).__name__))
            elif arg.dtype != dtype:
                raise TypeError("argument %r is a %s pointer: the tensor must "
                                "be %s, got %s" % (name, typ, dtype,
                                                   arg.dtype))
            elif arg.device != device:
                raise ValueError("argument %r lies on %s; the kernel launches "
                                 "on %s" % (name, arg.device, device))
            elif not arg.is_contiguous():
                raise ValueError("argument %r must be contiguous" % name)


def _dims(dims, what):
    """``dims`` (an int or 1 to 3 sizes) as three sizes; raises unless each
    is positive."""
    return _dims3(dims if isinstance(dims, (int, tuple)) else tuple(dims),
                  what)


@functools.lru_cache(maxsize=1024)
def _dims3(dims, what):
    dims = (int(dims),) if isinstance(dims, int) else tuple(map(int, dims))
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError("%s must be 1 to 3 positive sizes, got %r"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


# ------------------------------------------------------------ the libraries
def _find_nvrtc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    patterns = [os.path.join(home, "lib64", "libnvrtc.so*")]
    patterns += [os.path.join(p, "nvidia", "cuda_nvrtc", "lib", "libnvrtc.so*")
                 for p in sys.path if p]
    for pattern in patterns:
        for path in sorted(glob.glob(pattern)):
            if "builtins" not in os.path.basename(path):
                return path
    raise RuntimeError("NVRTC not found: CudaModule compiles with libnvrtc "
                       "from CUDA_HOME/lib64 or PyTorch's nvidia/cuda_nvrtc")


def _nvrtc():
    with _lock:
        lib = _libs.get("nvrtc")
        if lib is None:
            lib = ctypes.CDLL(_find_nvrtc())
            p, vp, sz = ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t
            for fn, args in (
                    ("nvrtcCreateProgram", [ctypes.POINTER(vp), p, p,
                                            ctypes.c_int, vp, vp]),
                    ("nvrtcAddNameExpression", [vp, p]),
                    ("nvrtcCompileProgram", [vp, ctypes.c_int,
                                             ctypes.POINTER(p)]),
                    ("nvrtcGetProgramLogSize", [vp, ctypes.POINTER(sz)]),
                    ("nvrtcGetProgramLog", [vp, p]),
                    ("nvrtcGetCUBINSize", [vp, ctypes.POINTER(sz)]),
                    ("nvrtcGetCUBIN", [vp, p]),
                    ("nvrtcGetLoweredName", [vp, p, ctypes.POINTER(p)]),
                    ("nvrtcDestroyProgram", [ctypes.POINTER(vp)])):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
            lib.nvrtcGetErrorString.restype = ctypes.c_char_p
            _libs["nvrtc"] = lib
        return lib


def _libcuda():
    lib = _libs.get("cuda")     # set once cuInit has succeeded
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get("cuda")
        if lib is None:
            lib = ctypes.CDLL("libcuda.so.1")
            vp, u = ctypes.c_void_p, ctypes.c_uint
            for fn, args in (
                    ("cuInit", [u]),
                    ("cuDeviceGet", [ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_int]),
                    ("cuDevicePrimaryCtxRetain", [ctypes.POINTER(vp),
                                                  ctypes.c_int]),
                    ("cuCtxPushCurrent_v2", [vp]),
                    ("cuCtxPopCurrent_v2", [ctypes.POINTER(vp)]),
                    ("cuCtxGetCurrent", [ctypes.POINTER(vp)]),
                    ("cuModuleLoadData", [ctypes.POINTER(vp), ctypes.c_char_p]),
                    ("cuModuleGetFunction", [ctypes.POINTER(vp), vp,
                                             ctypes.c_char_p]),
                    ("cuFuncSetAttribute", [vp, ctypes.c_int, ctypes.c_int]),
                    ("cuLaunchKernel", [vp, u, u, u, u, u, u, u, vp,
                                        ctypes.POINTER(vp), vp]),
                    ("cuGetErrorString", [ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_char_p)])):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            _check_cu(lib, lib.cuInit(0), "cuInit")
            _libs["cuda"] = lib
        return lib


def _check_cu(lib, err, what):
    if err:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(err, ctypes.byref(msg))
        raise RuntimeError("%s failed: %s (CUresult %d)"
                           % (what, (msg.value or b"?").decode(), err))


def _primary_context(lib, index):
    """PyTorch's primary context of device ``index`` (a ``CUcontext`` as an
    int), retained once per process."""
    with _lock:
        ctx = _contexts.get(index)
        if ctx is None:
            dev = ctypes.c_int()
            _check_cu(lib, lib.cuDeviceGet(ctypes.byref(dev), index),
                      "cuDeviceGet")
            handle = ctypes.c_void_p()
            _check_cu(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(handle),
                                                        dev),
                      "cuDevicePrimaryCtxRetain")
            ctx = _contexts[index] = handle.value
        return ctx


class _Function:
    """One kernel's ``CUfunction`` on one device, that device's primary
    context, and the largest dynamic shared memory size set on the
    function so far (48 KB needs no attribute)."""

    __slots__ = ("handle", "context", "max_shared")

    def __init__(self, handle, context):
        self.handle = handle
        self.context = context
        self.max_shared = _STATIC_SHARED_LIMIT

    def allow_shared(self, lib, nbytes, name):
        """Raise the function's dynamic shared memory limit to ``nbytes``
        (its context current); a no-op unless ``nbytes`` grows."""
        with _lock:
            if nbytes > self.max_shared:
                _check_cu(lib, lib.cuFuncSetAttribute(
                    self.handle, _MAX_DYNAMIC_SHARED, nbytes),
                    "cuFuncSetAttribute(%s)" % name)
                self.max_shared = nbytes


# ------------------------------------------------------------ CUDA modules
class CudaModule:
    """CUDA C++ ``source`` compiled by NVRTC, as MXNet's ``rtc.CudaModule``.

    ``options`` are extra NVRTC options; ``exports`` are C++ kernel names
    (for example ``"axpy<float>"``) to resolve to their mangled names. The
    source is compiled here, for the architecture of the current CUDA
    device, and loaded on each device at its first launch there.
    ``compile_ms`` is the NVRTC compile's wall time."""

    def __init__(self, source, options=(), exports=()):
        if not torch.cuda.is_available():
            raise RuntimeError("CudaModule compiles CUDA kernels with NVRTC "
                               "and needs CUDA, which is not available")
        major, minor = torch.cuda.get_device_capability()
        self.arch = "sm_%d%d%s" % (major, minor, "a" if major == 9 else "")
        if isinstance(exports, str):
            exports = [exports]
        t0 = time.perf_counter()
        self._cubin, self._lowered = self._compile(
            source, list(options), list(exports))
        self.compile_ms = (time.perf_counter() - t0) * 1e3
        self._loaded = {}     # device index -> CUmodule
        self._functions = {}  # (device index, name) -> _Function

    def _compile(self, source, options, exports):
        lib = _nvrtc()
        prog = ctypes.c_void_p()
        self._nvrtc_check(lib, lib.nvrtcCreateProgram(
            ctypes.byref(prog), source.encode(), b"rtc.cu", 0, None, None),
            "nvrtcCreateProgram")
        try:
            for name in exports:
                self._nvrtc_check(lib, lib.nvrtcAddNameExpression(
                    prog, name.encode()), "nvrtcAddNameExpression")
            opts = ["--gpu-architecture=%s" % self.arch, "-std=c++17"]
            home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
            if os.path.isdir(os.path.join(home, "include")):
                opts.append("-I%s" % os.path.join(home, "include"))
            opts += options
            arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
            err = lib.nvrtcCompileProgram(prog, len(opts), arr)
            if err:
                size = ctypes.c_size_t()
                lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
                log = ctypes.create_string_buffer(size.value)
                lib.nvrtcGetProgramLog(prog, log)
                raise RuntimeError("NVRTC compile failed (%s):\n%s" % (
                    lib.nvrtcGetErrorString(err).decode(),
                    log.value.decode(errors="replace")))
            lowered = {}
            for name in exports:
                out = ctypes.c_char_p()
                self._nvrtc_check(lib, lib.nvrtcGetLoweredName(
                    prog, name.encode(), ctypes.byref(out)),
                    "nvrtcGetLoweredName")
                lowered[name] = out.value.decode()
            size = ctypes.c_size_t()
            self._nvrtc_check(lib, lib.nvrtcGetCUBINSize(
                prog, ctypes.byref(size)), "nvrtcGetCUBINSize")
            cubin = ctypes.create_string_buffer(size.value)
            self._nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, cubin),
                              "nvrtcGetCUBIN")
            return cubin.raw, lowered
        finally:
            lib.nvrtcDestroyProgram(ctypes.byref(prog))

    @staticmethod
    def _nvrtc_check(lib, err, what):
        if err:
            raise RuntimeError("%s failed: %s"
                               % (what, lib.nvrtcGetErrorString(err).decode()))

    def _function(self, name, device, lib):
        """The kernel ``name`` on ``device`` as a ``_Function``, loading the
        module there at its first use. One ``_Function`` per function and
        device, shared by every ``CudaKernel`` of it, so the shared memory
        attribute it tracks is the function's own."""
        context = _primary_context(lib, device.index)
        with _lock:
            fn = self._functions.get((device.index, name))
            if fn is not None:
                return fn
            _check_cu(lib, lib.cuCtxPushCurrent_v2(context),
                      "cuCtxPushCurrent")
            try:
                mod = self._loaded.get(device.index)
                if mod is None:
                    mod = ctypes.c_void_p()
                    _check_cu(lib, lib.cuModuleLoadData(ctypes.byref(mod),
                                                        self._cubin),
                              "cuModuleLoadData")
                    self._loaded[device.index] = mod
                handle = ctypes.c_void_p()
                _check_cu(lib, lib.cuModuleGetFunction(
                    ctypes.byref(handle), mod,
                    self._lowered.get(name, name).encode()),
                    "cuModuleGetFunction(%s)" % name)
            finally:
                lib.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))
            fn = self._functions[(device.index, name)] = _Function(
                handle.value, context)
            return fn

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``extern "C"`` name or one of
        ``exports``) with MXNet's ``signature`` string."""
        return CudaKernel(self, name, signature)


class CudaKernel:
    """One kernel of a ``CudaModule``.

    A launch does the least host work it can, so that back-to-back launches
    wait on the card and not on Python: the function, its context and its
    shared memory attribute are resolved once per device; the arguments are
    written into slots made once (``_ArgLayout``); the context is pushed
    only when another one is current; the stream comes from PyTorch's C
    entry point (``_kernels.stream``). A lock keeps the slots a launch's own
    until ``cuLaunchKernel`` has copied them."""

    def __init__(self, module, name, signature):
        self._module = module
        self._name = name
        self._layout = _ArgLayout(_parse_signature(signature))
        self._functions = {}    # device index -> _Function
        self._current = ctypes.c_void_p()
        self._popped = ctypes.c_void_p()
        self._lock = threading.Lock()

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx``'s current stream with ``grid_dims`` blocks of
        ``block_dims`` threads and ``shared_mem`` bytes of dynamic shared
        memory. Asynchronous, like any launch on a stream."""
        device = _cuda_device(ctx)
        grid, block = _dims(grid_dims, "grid_dims"), _dims(block_dims,
                                                            "block_dims")
        shared_mem = int(shared_mem)
        with self._lock:
            self._layout.fill(args, device)
            lib = _libcuda()
            fn = self._functions.get(device.index)
            if fn is None:
                fn = self._functions[device.index] = self._module._function(
                    self._name, device, lib)
            err = lib.cuCtxGetCurrent(self._current)
            if err:
                _check_cu(lib, err, "cuCtxGetCurrent")
            pushed = self._current.value != fn.context
            if pushed:
                _check_cu(lib, lib.cuCtxPushCurrent_v2(fn.context),
                          "cuCtxPushCurrent")
            try:
                if shared_mem > fn.max_shared:
                    fn.allow_shared(lib, shared_mem, self._name)
                err = lib.cuLaunchKernel(
                    fn.handle, *grid, *block, shared_mem,
                    _kernels.stream(device), self._layout.array,
                    None)
                if err:
                    _check_cu(lib, err, "cuLaunchKernel(%s)" % self._name)
            finally:
                if pushed:
                    lib.cuCtxPopCurrent_v2(self._popped)
        _kernels.count("rtc")


# ------------------------------------------------------------ Triton modules
class TritonModule:
    """A ``@triton.jit`` function launched at run time, in the role of the
    JAX package's ``PallasModule``. ``out_shape_fn(*args)`` gives the
    output's (shape, dtype); by default it is ``args[0]``'s."""

    def __init__(self, kernel_fn, out_shape_fn=None):
        self._kernel_fn = kernel_fn
        self._out_shape_fn = out_shape_fn

    def get_kernel(self, name=None, signature=None):
        return TritonKernel(self._kernel_fn, self._out_shape_fn)


_triton = []        # [the triton module], once imported


def _import_triton():
    if not _triton:
        try:
            import triton
        except ImportError as e:
            raise RuntimeError("TritonModule launches @triton.jit kernels and "
                               "needs the triton package, which is not "
                               "installed") from e
        _triton.append(triton)
    return _triton[0]


class TritonKernel:
    """One ``@triton.jit`` function, launched through Triton's JIT
    dispatch, which compiles a specialization at its first launch and finds
    it by its own key at later ones."""

    def __init__(self, kernel_fn, out_shape_fn):
        self._kernel_fn = kernel_fn
        self._out_shape_fn = out_shape_fn

    def launch(self, args, ctx=None, grid_dims=None, **meta):
        """``kernel_fn[grid_dims](*args, out, **meta)`` on ``ctx``'s device
        and current stream → ``out``, a new tensor. ``meta`` carries the
        kernel's ``tl.constexpr`` arguments and launch options such as
        ``num_warps``."""
        _import_triton()
        device = _cuda_device(ctx)
        if torch.cuda.current_device() != device.index:
            # Triton compiles for, and launches on, the current device
            with torch.cuda.device(device):
                return self.launch(args, device, grid_dims, **meta)
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor) and a.get_device() != device.index:
                raise ValueError("argument %d lies on %s; the kernel launches "
                                 "on %s" % (i, a.device, device))
        if self._out_shape_fn is not None:
            shape, dtype = self._out_shape_fn(*args)
        else:
            shape, dtype = args[0].shape, args[0].dtype
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        grid = tuple(grid_dims) if grid_dims else (1,)
        self._kernel_fn[grid](*args, out, **meta)
        _kernels.count("rtc_triton")
        return out
