"""ctypes bindings for the flat C ABI (``src/c_api.cc``; counterpart of
``incubator_mxnet_tpu/native/capi.py``): the surface another language
links against (ref include/mxnet/c_api.h: NDArray create, copy from and to
the host, shape and free, and ImageRecordIter create and next), over the
port's ``libmxtpu``.

Python itself uses the richer internal paths; this module exercises and
documents the ABI the way an external binding would.
"""
from __future__ import annotations

import ctypes

import numpy as onp

from . import lib as _nlib

_DTYPE = {0: onp.float32, 1: onp.float64, 2: onp.float16, 3: onp.uint8,
          4: onp.int32, 5: onp.int8, 6: onp.int64, 7: onp.bool_}
_DTYPE_REV = {onp.dtype(v): k for k, v in _DTYPE.items()}

_BOUND = False


def _lib():
    global _BOUND
    lib = _nlib.get()
    if not _BOUND:
        c = ctypes
        lib.MXTPUGetLastError.restype = c.c_char_p
        lib.MXTPUNDArrayCreate.argtypes = [c.POINTER(c.c_int64), c.c_int,
                                           c.c_int, c.POINTER(c.c_void_p)]
        lib.MXTPUNDArraySyncCopyFromCPU.argtypes = [c.c_void_p, c.c_void_p,
                                                    c.c_size_t]
        lib.MXTPUNDArraySyncCopyToCPU.argtypes = [c.c_void_p, c.c_void_p,
                                                  c.c_size_t]
        lib.MXTPUNDArrayGetShape.argtypes = [c.c_void_p, c.POINTER(c.c_int),
                                             c.POINTER(c.c_int64)]
        lib.MXTPUNDArrayGetDType.argtypes = [c.c_void_p, c.POINTER(c.c_int)]
        lib.MXTPUNDArrayGetData.argtypes = [c.c_void_p, c.POINTER(c.c_void_p)]
        lib.MXTPUNDArrayFree.argtypes = [c.c_void_p]
        lib.MXTPUImageRecordIterCreate.argtypes = [
            c.c_char_p, c.c_long, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
            c.c_int, c.POINTER(c.c_float), c.POINTER(c.c_float), c.c_float,
            c.c_int, c.c_int, c.c_int, c.c_long, c.c_long,
            c.POINTER(c.c_void_p)]
        lib.MXTPUDataIterNext.argtypes = [c.c_void_p, c.POINTER(c.c_int)]
        lib.MXTPUDataIterGetData.argtypes = [c.c_void_p,
                                             c.POINTER(c.c_void_p)]
        lib.MXTPUDataIterGetLabel.argtypes = [c.c_void_p,
                                              c.POINTER(c.c_void_p)]
        lib.MXTPUDataIterReset.argtypes = [c.c_void_p, c.c_int]
        lib.MXTPUDataIterFree.argtypes = [c.c_void_p]
        _BOUND = True
    return lib


def _check(rc):
    if rc != 0:
        raise RuntimeError("C API error: %s" %
                           _lib().MXTPUGetLastError().decode())


class CArray:
    """Host array behind an opaque C handle."""

    def __init__(self, shape=None, dtype="float32", _handle=None, _owns=True):
        lib = _lib()
        if _handle is None:
            shp = (ctypes.c_int64 * len(shape))(*shape)
            h = ctypes.c_void_p()
            _check(lib.MXTPUNDArrayCreate(
                shp, len(shape), _DTYPE_REV[onp.dtype(dtype)],
                ctypes.byref(h)))
            _handle = h
        self._h = _handle
        self._owns = _owns

    @property
    def shape(self):
        lib = _lib()
        nd = ctypes.c_int()
        _check(lib.MXTPUNDArrayGetShape(self._h, ctypes.byref(nd), None))
        shp = (ctypes.c_int64 * nd.value)()
        _check(lib.MXTPUNDArrayGetShape(self._h, ctypes.byref(nd), shp))
        return tuple(shp)

    @property
    def dtype(self):
        dt = ctypes.c_int()
        _check(_lib().MXTPUNDArrayGetDType(self._h, ctypes.byref(dt)))
        return onp.dtype(_DTYPE[dt.value])

    def copy_from(self, arr):
        arr = onp.ascontiguousarray(arr, dtype=self.dtype)
        _check(_lib().MXTPUNDArraySyncCopyFromCPU(
            self._h, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes))
        return self

    def asnumpy(self):
        out = onp.empty(self.shape, self.dtype)
        _check(_lib().MXTPUNDArraySyncCopyToCPU(
            self._h, out.ctypes.data_as(ctypes.c_void_p), out.nbytes))
        return out

    def __del__(self):
        try:
            if self._owns and getattr(self, "_h", None):
                _lib().MXTPUNDArrayFree(self._h)
        except Exception:
            pass


class CImageRecordIter:
    """ImageRecordIter through the flat C ABI."""

    def __init__(self, rec_path, batch_size, data_shape, label_width=1,
                 resize_short=0, rand_crop=False, rand_mirror=False,
                 mean_rgb=None, std_rgb=None, scale=1.0, shuffle=False,
                 seed=0, num_threads=2, part_index=0, num_parts=1):
        lib = _lib()
        _, h, w = data_shape
        mean = (ctypes.c_float * 3)(*(mean_rgb or (0., 0., 0.)))
        std = (ctypes.c_float * 3)(*(std_rgb or (1., 1., 1.)))
        hd = ctypes.c_void_p()
        _check(lib.MXTPUImageRecordIterCreate(
            rec_path.encode(), batch_size, h, w, label_width, resize_short,
            int(rand_crop), int(rand_mirror), mean, std, float(scale),
            int(shuffle), seed, num_threads, part_index, num_parts,
            ctypes.byref(hd)))
        self._h = hd

    def next(self):
        """Returns (data, label) CArrays (views into iter-owned buffers),
        or None at epoch end."""
        lib = _lib()
        has = ctypes.c_int()
        _check(lib.MXTPUDataIterNext(self._h, ctypes.byref(has)))
        if not has.value:
            return None
        d = ctypes.c_void_p()
        l = ctypes.c_void_p()
        _check(lib.MXTPUDataIterGetData(self._h, ctypes.byref(d)))
        _check(lib.MXTPUDataIterGetLabel(self._h, ctypes.byref(l)))
        return (CArray(_handle=d, _owns=False), CArray(_handle=l, _owns=False))

    def reset(self, reshuffle=True):
        _check(_lib().MXTPUDataIterReset(self._h, int(reshuffle)))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                _lib().MXTPUDataIterFree(self._h)
        except Exception:
            pass
