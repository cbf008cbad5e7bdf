"""Operators of the port: those with hand-written CUDA kernels (sources in
``csrc/``), and the SSD and detection operators in plain PyTorch."""
from .attention import flash_attention, flash_attention_legal  # noqa: F401
from . import detection, multibox  # noqa: F401
from .multibox import (MultiBoxDetection, MultiBoxPrior,  # noqa: F401
                       MultiBoxTarget)
