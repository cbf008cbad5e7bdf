"""Operators with hand-written CUDA kernels (sources in ``csrc/``)."""
from .attention import flash_attention, flash_attention_legal  # noqa: F401
