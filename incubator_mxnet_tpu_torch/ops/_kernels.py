"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. ``build`` compiles the
sources with ``nvcc`` for ``sm_90a`` into shared libraries under the
checkout's git-ignored ``build/kernels/`` (one library per source, named by
a digest of its content and flags, so an edited source is rebuilt), starting
one ``nvcc`` per missing library at once. ``load`` returns the library as a
``ctypes.CDLL``. Nothing is built at import: the CPU tests import every
module, and this machine may have no ``nvcc``.

``bind`` loads a library and declares its entry points' C signatures; each
entry point returns the launch's ``cudaError_t``, which ``launched`` turns
into an exception or a count. ``LAUNCHES`` counts each kernel's launches: a
wrapper calls ``count(name)`` (through ``launched``) right after its kernel
was launched, and nowhere else. A CUDA graph's capture runs the wrappers
but launches nothing: ``collecting`` keeps what the capture counts out of
``LAUNCHES`` (on the capturing thread, and through ``capturing`` on
autograd's thread when it runs a captured backward; other threads may
launch meanwhile), and each replay adds it back (``add_launches``), so
``LAUNCHES`` counts the kernels that ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["build", "load", "bind", "launched", "stream", "count",
           "reset_launches", "add_launches", "collecting", "capturing",
           "LAUNCHES", "BUILD_LOG", "NVCC_FLAGS"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {}      # kernel name -> launches since the last reset
BUILD_LOG = {}     # source -> nvcc's output (ptxas registers/spills)
_count_lock = threading.Lock()
_collector = threading.local()
_capture_sink = None   # the counts of the capture in progress (capturing)
_build_lock = threading.Lock()
_libs = {}
_bound = set()
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def count(name):
    """One launch of kernel ``name`` (called by its wrapper); inside
    ``collecting()`` on this thread, or onto the stream a capture is
    recording (``capturing``), it goes to the capture's counts instead."""
    sink = getattr(_collector, "sink", None)
    if sink is None and _capture_sink is not None and _stream_capturing():
        sink = _capture_sink
    with _count_lock:
        if sink is None:
            sink = LAUNCHES
        sink[name] = sink.get(name, 0) + 1


def _stream_capturing():
    """Whether this thread's current CUDA stream is recording a graph."""
    import torch
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class collecting:
    """``with collecting() as counts:`` — the launches this thread's
    wrappers count meanwhile go to ``counts`` (kernel name -> launches),
    not to ``LAUNCHES``: a capture's, which each replay adds back. It sees
    no other thread's launches, so a capture can run while other threads
    launch and replay."""

    def __enter__(self):
        self._prev = getattr(_collector, "sink", None)
        self.counts = {}
        _collector.sink = self.counts
        return self.counts

    def __exit__(self, *exc):
        _collector.sink = self._prev
        return False


class capturing:
    """``with capturing():`` around one CUDA graph capture, inside the
    capturing thread's ``collecting()`` (one capture runs at a time in the
    process): a launch another thread makes onto a stream being captured
    meanwhile goes to that thread's counts too. Autograd runs a captured
    backward on its own thread, onto the captured stream; another thread's
    launches onto its own streams still count in ``LAUNCHES``."""

    def __enter__(self):
        global _capture_sink
        self._prev = _capture_sink
        _capture_sink = getattr(_collector, "sink", None)

    def __exit__(self, *exc):
        global _capture_sink
        _capture_sink = self._prev
        return False


def reset_launches():
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def add_launches(counts):
    """Count ``counts`` (kernel name -> launches), as a graph replay does."""
    with _count_lock:
        for name, n in counts.items():
            LAUNCHES[name] = LAUNCHES.get(name, 0) + n


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from csrc/ at first use")


def _target(source):
    with open(os.path.join(_CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, "lib%s-%s.so"
                        % (stem, digest.hexdigest()[:16]))


def build(*sources):
    """Compile every source whose library is missing, all ``nvcc`` runs in
    parallel; return {source: library path}. Raises with nvcc's output if
    one fails."""
    with _build_lock:
        paths = {s: _target(s) for s in sources}
        missing = [s for s in sources if not os.path.exists(paths[s])]
        if not missing:
            return paths
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for s in missing:
            tmp = "%s.tmp%d" % (paths[s], os.getpid())
            procs[s] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for s, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[s] = out
            if proc.returncode:
                failed.append("%s (exit %d):\n%s" % (s, proc.returncode, out))
            else:
                os.replace(tmp, paths[s])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return paths


def load(source):
    """The built library of ``csrc/<source>`` as a ``ctypes.CDLL``."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(build(source)[source])
        with _build_lock:
            lib = _libs.setdefault(source, lib)
    return lib


def bind(source, signatures):
    """``load(source)`` with each entry point of ``signatures`` ({C name:
    argument codes, "p" pointer or stream, "i" int, "f" float}) declared to
    return an int ``cudaError_t``, and ``mxt_cuda_error_string`` declared."""
    lib = load(source)
    if source not in _bound:
        for fn, sig in signatures.items():
            getattr(lib, fn).argtypes = [_CTYPES[c] for c in sig]
            getattr(lib, fn).restype = ctypes.c_int
        lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxt_cuda_error_string.restype = ctypes.c_char_p
        _bound.add(source)
    return lib


def launched(lib, name, err):
    """Raise if the entry point returned an error, else count one launch of
    kernel ``name``."""
    if err:
        raise RuntimeError("%s launch failed: %s"
                           % (name, lib.mxt_cuda_error_string(err).decode()))
    count(name)


def stream(where):
    """The current stream of the CUDA device of ``where`` (a tensor, or a
    ``torch.device`` with its index), as an int for ``ctypes``: PyTorch's C
    entry point, which makes no ``torch.cuda.Stream``. A backward runs on
    autograd's thread: take the tensor's device's stream, never the
    thread's current device's."""
    import torch
    device = where.device if isinstance(where, torch.Tensor) else where
    return torch._C._cuda_getCurrentRawStream(device.index)
