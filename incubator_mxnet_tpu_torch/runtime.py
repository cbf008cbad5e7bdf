"""Run-time feature detection (counterpart of
``incubator_mxnet_tpu/runtime.py``; ref python/mxnet/runtime.py,
include/mxnet/libinfo.h).

The keys are the JAX package's; the values are the port's: ``CUDA``,
``CUDNN`` and ``NCCL`` from torch, ``NATIVE_RECORDIO`` from the port's
native library, ``OPENMP`` and ``MKLDNN`` from torch's CPU backends, and
``TPU``, ``XLA`` and ``PALLAS`` False (a departure, ROADMAP §3).
"""
from __future__ import annotations

import platform

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return "[%s %s]" % ("✔" if self.enabled else "✖", self.name)


def _detect():
    import torch
    x86 = platform.machine().lower() in ("x86_64", "amd64")
    feats = {
        "TPU": False,
        "CUDA": torch.cuda.is_available(),
        "CUDNN": torch.backends.cudnn.is_available(),
        "NCCL": _has_nccl(),
        "XLA": False,
        "PALLAS": False,
        "BF16": True,
        "INT64_TENSOR_SIZE": True,
        "DIST_KVSTORE": torch.distributed.is_available(),
        "SPMD_SHARDING": True,
        "RING_ATTENTION": True,
        "OPENMP": torch.backends.openmp.is_available(),
        "NATIVE_RECORDIO": _has_native(),
        "SSE": x86,
        "F16C": x86,
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "OPENCV": _has_pil(),
    }
    return {k: Feature(k, bool(v)) for k, v in feats.items()}


def _has_nccl():
    import torch
    return torch.distributed.is_available() and \
        torch.distributed.is_nccl_available()


def _has_native():
    from .native import lib
    try:
        return lib.available()
    except RuntimeError:        # g++ is there and the build failed
        return False


def _has_pil():
    try:
        import PIL  # noqa: F401
        return True
    except ImportError:
        return False


class Features(dict):
    """ref runtime.py Features."""

    def __init__(self):
        super().__init__(_detect())

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError("Feature '%s' is unknown" % feature_name)
        return self[feature_name].enabled


def feature_list():
    return list(Features().values())
