"""ctypes bindings for the native library (counterpart of
``incubator_mxnet_tpu/native/lib.py``), built from ``src/*.cc``.

``build`` compiles ``recordio.cc``, ``image.cc`` and ``c_api.cc`` with
``g++`` into ``libmxtpu-<digest>.so`` and ``build_predict`` the embedded-
interpreter C ABI (``c_predict_api.cc``) into ``libmxtpu_predict-<digest>
.so``, both under the checkout's git-ignored ``build/native/``, never next
to the sources. The digest covers the sources and the flags, so an edited
source is rebuilt; a build writes a temporary name and renames it, so
processes that build at the same moment do not race. The newest build of
each is also linked as ``build/native/libmxtpu.so`` and
``libmxtpu_predict.so``, the path ``MXTPU_PREDICT_LIB`` names for the C++
and language shims. ``build_flash_op`` and ``build_aoti_serve`` build, the
same way but against this interpreter's libtorch (never libpython), K1 as
the C++ operator ``mxtpu::flash_fwd`` and the Python-free runner of
``contrib.serving.export_pjrt_bundle``'s packages, linked as
``libmxtpu_flash_op.so`` and ``aoti_serve``; with a CUDA torch they link
libtorch_cuda, and the operator library K1's nvcc build
(``python -m incubator_mxnet_tpu_torch.native.lib`` builds all four and
prints their paths).

The JPEG decoder is the libjpeg (API 62) that Pillow loads: the library
its wheel bundles (``pillow.libs/``), else the system's ``-ljpeg``. The
headers are the ones in ``third_party/libjpeg`` (libjpeg-turbo's, API 62),
so no development package is needed. Tier 1 of ``io.ImageRecordIter``
(this decoder) and tier 2 (Pillow) then decode with one library.

``available()`` is False under ``MXTPU_NO_NATIVE`` or without ``g++``;
otherwise it builds, and a failed build raises with ``g++``'s output.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading

__all__ = ["available", "get", "build", "build_predict", "build_flash_op",
           "build_aoti_serve", "NativeBatchReader",
           "NativeImagePipeline", "HostBufferPool", "scan_offsets",
           "BUILD_DIR"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_JPEG_INCLUDE = os.path.join(_DIR, "third_party", "libjpeg")
_ROOT = os.path.dirname(os.path.dirname(_DIR))
BUILD_DIR = os.path.join(_ROOT, "build", "native")
_CXXFLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LIB_SOURCES = ("recordio.cc", "image.cc", "c_api.cc")
_LIB = None
_locks_lock = threading.Lock()
_build_locks = {}          # library path -> the lock of its build


def _jpeg_link():
    """The link arguments of the libjpeg Pillow loads."""
    try:
        import PIL
        bundled = sorted(glob.glob(os.path.join(
            os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs",
            "libjpeg*.so*")))
    except ImportError:
        bundled = []
    if bundled:
        return [bundled[0], "-Wl,-rpath," + os.path.dirname(bundled[0])]
    return ["-ljpeg"]


def _compile(stem, sources, flags, suffix=".so"):
    """``g++`` ``sources`` with ``flags`` into ``BUILD_DIR/<stem>-<digest>
    <suffix>`` unless it is there; link it as ``<stem><suffix>``; return its
    path. Raises with g++'s output if the build fails."""
    h = hashlib.sha256(" ".join(flags).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, "%s-%s%s" % (stem, h.hexdigest()[:16],
                                                suffix))
    with _locks_lock:
        lock = _build_locks.setdefault(path, threading.Lock())
    with lock:
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "%s.tmp%d" % (path, os.getpid())
            r = subprocess.run(["g++", *sources, *flags, "-o", tmp],
                               capture_output=True, text=True)
            if r.returncode:
                raise RuntimeError("g++ failed building %s (exit %d):\n%s%s"
                                   % (stem, r.returncode, r.stdout,
                                      r.stderr))
            os.replace(tmp, path)
        link = os.path.join(BUILD_DIR, stem + suffix)
        if not (os.path.islink(link)
                and os.readlink(link) == os.path.basename(path)):
            tmp = "%s.tmp%d" % (link, os.getpid())
            if os.path.lexists(tmp):
                os.remove(tmp)
            os.symlink(os.path.basename(path), tmp)
            os.replace(tmp, link)
    return path


def build():
    """The native library (RecordIO reader and writer, host pool, JPEG
    pipeline, flat C ABI): its path, built if missing."""
    srcs = [os.path.join(_SRC, s) for s in _LIB_SOURCES]
    return _compile("libmxtpu", srcs,
                    [*_CXXFLAGS, "-I", _JPEG_INCLUDE, *_jpeg_link()])


def build_predict():
    """The embedded-interpreter C ABI (``c_predict_api.cc``): its path,
    built if missing. Include and link flags come from this interpreter's
    sysconfig, so the library embeds a matching libpython; the checkout's
    root and this interpreter's path are compiled in (the root goes on the
    booted interpreter's ``sys.path``, the interpreter is the default of
    ``MXTPU_PYTHON``)."""
    import sysconfig
    inc = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR") or "/usr/local/lib"
    ver = "python" + (sysconfig.get_config_var("LDVERSION")
                      or "%d.%d" % sys.version_info[:2])
    flags = [*_CXXFLAGS, "-I", inc, "-L", libdir, "-Wl,-rpath," + libdir,
             "-l" + ver, "-ldl",
             "-DMXTPU_REPO_ROOT=" + json.dumps(_ROOT),
             "-DMXTPU_BUILD_PYTHON=" + json.dumps(sys.executable)]
    return _compile("libmxtpu_predict",
                    [os.path.join(_SRC, "c_predict_api.cc")], flags)


def _torch_with_cuda():
    """Whether this torch was built with CUDA (its ``libtorch_cuda.so`` is
    there): the operator library and the runner are then built for the
    card too."""
    import torch
    return torch.version.cuda is not None and os.path.exists(os.path.join(
        os.path.dirname(torch.__file__), "lib", "libtorch_cuda.so"))


def _libtorch_flags(cuda):
    """Compile and link flags against this interpreter's torch (its
    headers, its C++ ABI, ``libtorch`` and, with ``cuda``, ``libtorch_cuda``;
    never ``libtorch_python``)."""
    import torch
    base = os.path.dirname(torch.__file__)
    inc, libdir = os.path.join(base, "include"), os.path.join(base, "lib")
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if cuda:
        libs += ["-ltorch_cuda", "-lc10_cuda"]
    # the version enters the build's digest: another torch builds anew
    return ["-O2", "-std=c++17", "-pthread",
            "-DMXTPU_TORCH_VERSION=" + json.dumps(torch.__version__),
            "-I", inc, "-I",
            os.path.join(inc, "torch", "csrc", "api", "include"),
            "-D_GLIBCXX_USE_CXX11_ABI=%d" % int(
                torch._C._GLIBCXX_USE_CXX11_ABI),
            "-L", libdir, "-Wl,-rpath," + libdir, "-Wl,--no-as-needed",
            *libs, "-Wl,--as-needed"]


FLASH_OP_SOURCE = os.path.join(os.path.dirname(_DIR), "ops", "csrc",
                               "flash_fwd_op.cpp")


def build_flash_op():
    """K1 as the C++ operator ``mxtpu::flash_fwd`` (``ops/csrc/
    flash_fwd_op.cpp``): its path, built if missing. With a CUDA torch it
    also links K1's library, built by ``nvcc`` (``ops._kernels``), and its
    CUDA kernel launches K1; the CPU kernel is K1's plain version. Only a
    process without the Python registration (the AOTInductor runner) may
    load it."""
    cuda = _torch_with_cuda()
    flags = ["-shared", "-fPIC", *_libtorch_flags(cuda)]
    if cuda:
        from ..ops import _kernels
        k1 = _kernels.build("flash_fwd.cu")["flash_fwd.cu"]
        include = os.path.join(os.path.dirname(os.path.dirname(
            _kernels._nvcc())), "include")
        flags = ["-DMXTPU_WITH_CUDA", "-I", include, *flags, k1,
                 "-Wl,-rpath," + os.path.dirname(k1)]
    return _compile("libmxtpu_flash_op", [FLASH_OP_SOURCE], flags)


def build_aoti_serve():
    """The AOTInductor runner (``src/aoti_serve.cc``, the counterpart of
    ``tools/pjrt_serve.c``): its path, built if missing, linked against
    libtorch (and libtorch_cuda with a CUDA torch) and never libpython."""
    return _compile("aoti_serve", [os.path.join(_SRC, "aoti_serve.cc")],
                    [*_libtorch_flags(_torch_with_cuda()), "-ldl"], suffix="")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build())
    c = ctypes
    lib.rio_writer_open.restype = c.c_void_p
    lib.rio_writer_open.argtypes = [c.c_char_p]
    lib.rio_writer_tell.restype = c.c_long
    lib.rio_writer_tell.argtypes = [c.c_void_p]
    lib.rio_write.restype = c.c_int
    lib.rio_write.argtypes = [c.c_void_p, c.c_char_p, c.c_uint32]
    lib.rio_writer_close.argtypes = [c.c_void_p]
    lib.rio_scan.restype = c.c_long
    lib.rio_scan.argtypes = [c.c_char_p, c.POINTER(c.c_int64),
                             c.POINTER(c.c_int64), c.c_long]
    lib.pool_create.restype = c.c_void_p
    lib.pool_alloc.restype = c.c_void_p
    lib.pool_alloc.argtypes = [c.c_void_p, c.c_size_t]
    lib.pool_free.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]
    lib.pool_used_bytes.restype = c.c_size_t
    lib.pool_used_bytes.argtypes = [c.c_void_p]
    lib.pool_destroy.argtypes = [c.c_void_p]
    lib.rio_reader_create.restype = c.c_void_p
    lib.rio_reader_create.argtypes = [c.c_char_p, c.c_long, c.c_int, c.c_int,
                                      c.c_int, c.c_long, c.c_long, c.c_long]
    lib.rio_reader_num_batches.restype = c.c_long
    lib.rio_reader_num_batches.argtypes = [c.c_void_p]
    lib.rio_reader_num_records.restype = c.c_long
    lib.rio_reader_num_records.argtypes = [c.c_void_p]
    lib.rio_reader_next.restype = c.c_long
    lib.rio_reader_next.argtypes = [c.c_void_p, c.c_char_p, c.c_long,
                                    c.POINTER(c.c_int64)]
    lib.rio_reader_reset.argtypes = [c.c_void_p, c.c_int]
    lib.rio_reader_destroy.argtypes = [c.c_void_p]
    lib.img_pipe_create.restype = c.c_void_p
    lib.img_pipe_create.argtypes = [
        c.c_char_p, c.c_long, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.c_int, c.POINTER(c.c_float), c.POINTER(c.c_float), c.c_float,
        c.c_int, c.c_int, c.c_int, c.c_long, c.c_long, c.c_long]
    lib.img_pipe_num_batches.restype = c.c_long
    lib.img_pipe_num_batches.argtypes = [c.c_void_p]
    lib.img_pipe_num_records.restype = c.c_long
    lib.img_pipe_num_records.argtypes = [c.c_void_p]
    lib.img_pipe_next.restype = c.c_long
    lib.img_pipe_next.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                  c.POINTER(c.c_float)]
    lib.img_pipe_reset.argtypes = [c.c_void_p, c.c_int]
    lib.img_pipe_destroy.argtypes = [c.c_void_p]
    _LIB = lib
    return lib


def available():
    """Whether the native tiers run: not under ``MXTPU_NO_NATIVE``, and
    ``g++`` is there (the library is built now; a failed build raises)."""
    from ..config import get_env
    if get_env("MXTPU_NO_NATIVE") or shutil.which("g++") is None:
        return False
    _load()
    return True


def get():
    """The loaded native library (built at first use)."""
    return _load()


class NativeBatchReader:
    """Prefetching record-batch reader backed by C++ worker threads."""

    def __init__(self, path, batch_size, shuffle=False, seed=0, num_threads=2,
                 max_ready=4, part_index=0, num_parts=1):
        self._lib = get()
        self._h = self._lib.rio_reader_create(
            path.encode(), batch_size, int(shuffle), seed, num_threads,
            max_ready, part_index, num_parts)
        if not self._h:
            raise IOError("cannot open record file %s" % path)
        self.batch_size = batch_size
        self._sizes = (ctypes.c_int64 * batch_size)()
        self._cap = 1 << 22
        self._buf = ctypes.create_string_buffer(self._cap)

    @property
    def num_batches(self):
        return self._lib.rio_reader_num_batches(self._h)

    @property
    def num_records(self):
        return self._lib.rio_reader_num_records(self._h)

    def next(self):
        """The payloads (list of bytes) of the next batch, or None at the
        epoch's end."""
        total = self._lib.rio_reader_next(self._h, self._buf, self._cap,
                                          self._sizes)
        if total < 0:
            return None
        while total > self._cap:
            # an oversized batch stays queued on the C++ side: a larger
            # buffer fetches the same batch again
            self._cap = 1 << max(total.bit_length(), 22)
            self._buf = ctypes.create_string_buffer(self._cap)
            total = self._lib.rio_reader_next(self._h, self._buf, self._cap,
                                              self._sizes)
            if total < 0:
                return None
        raw = self._buf.raw
        out, off = [], 0
        for i in range(self.batch_size):
            n = self._sizes[i]
            if n < 0:
                raise IOError("truncated record in batch (record %d): file "
                              "shorter than its index claims" % i)
            out.append(raw[off:off + n])
            off += n
        return out

    def reset(self, reshuffle=True):
        self._lib.rio_reader_reset(self._h, int(reshuffle))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.rio_reader_destroy(self._h)
        except Exception:
            pass


class NativeImagePipeline:
    """C++ JPEG decode, augmentation and NCHW batch assembly
    (``src/image.cc``): no Python in the decode loop."""

    def __init__(self, path, batch_size, data_shape, label_width=1,
                 resize_short=0, rand_crop=False, rand_mirror=False,
                 mean_rgb=None, std_rgb=None, scale=1.0, shuffle=False,
                 seed=0, num_threads=4, part_index=0, num_parts=1):
        import numpy as onp
        self._lib = get()
        c, h, w = data_shape
        if c != 3:
            raise ValueError("native pipeline produces 3-channel RGB")
        mean = (ctypes.c_float * 3)(*(mean_rgb or (0., 0., 0.)))
        std = (ctypes.c_float * 3)(*(std_rgb or (1., 1., 1.)))
        self._h = self._lib.img_pipe_create(
            path.encode(), batch_size, h, w, label_width, resize_short,
            int(rand_crop), int(rand_mirror), mean, std, float(scale),
            int(shuffle), seed, num_threads, 4, part_index, num_parts)
        if not self._h:
            raise IOError("cannot open record file %s" % path)
        self.batch_size = batch_size
        self.data_shape = (batch_size, 3, h, w)
        self.label_shape = (batch_size, label_width)
        self._data = onp.empty(self.data_shape, onp.float32)
        self._labels = onp.empty(self.label_shape, onp.float32)

    @property
    def num_batches(self):
        return self._lib.img_pipe_num_batches(self._h)

    @property
    def num_records(self):
        return self._lib.img_pipe_num_records(self._h)

    def next(self):
        """(data NCHW float32, labels, undecodable records) or None at the
        epoch's end. The arrays are reused by the next call."""
        bad = self._lib.img_pipe_next(
            self._h,
            self._data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if bad < 0:
            return None
        return self._data, self._labels, int(bad)

    def reset(self, reshuffle=True):
        self._lib.img_pipe_reset(self._h, int(reshuffle))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.img_pipe_destroy(self._h)
        except Exception:
            pass


class HostBufferPool:
    """Pooled host staging allocator (C++ size-bucketed free lists)."""

    def __init__(self):
        self._lib = get()
        self._h = self._lib.pool_create()

    def alloc(self, size):
        return self._lib.pool_alloc(self._h, size)

    def free(self, ptr, size):
        self._lib.pool_free(self._h, ptr, size)

    def used_bytes(self):
        return self._lib.pool_used_bytes(self._h)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.pool_destroy(self._h)
        except Exception:
            pass


def scan_offsets(path):
    """The record offsets and lengths of a .rec (numpy int64 arrays)."""
    import numpy as onp
    lib = get()
    n = lib.rio_scan(path.encode(), None, None, 0)
    if n < 0:
        raise IOError("scan failed for %s (code %d)" % (path, n))
    offs = (ctypes.c_int64 * n)()
    lens = (ctypes.c_int64 * n)()
    lib.rio_scan(path.encode(), offs, lens, n)
    return onp.frombuffer(offs, dtype=onp.int64).copy(), \
        onp.frombuffer(lens, dtype=onp.int64).copy()


if __name__ == "__main__":
    print(build())
    print(build_predict())
    print(build_flash_op())
    print(build_aoti_serve())
