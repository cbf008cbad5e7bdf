"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of incubator_mxnet_tpu.

It mirrors the JAX package's file layout and public names, imports
``torch`` and never JAX or the JAX package. Plain tensor code is PyTorch;
each TPU Pallas kernel on a ported path is a hand-written CUDA kernel for
Hopper (``ops/csrc``), built with ``nvcc`` at first use. Entry points run
on ``gpu(0)`` unless the caller passes ``cpu()``.

It serves BERT and GPT through ``serving.ModelRegistry`` with the
flash-attention forward kernel, and trains them through ``jit.TrainStep``
(``gluon.Trainer``, SGD/Adam/AdamW with fp32 masters) with the forward and
the two backward kernels.
"""
from . import autograd, config, context, initializer, ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import gluon, jit, models, ops, optimizer, serving  # noqa: F401
from .context import Context, cpu, current_context, gpu, num_gpus, tpu  # noqa: F401
from .convert import from_jax_params, to_numpy_params  # noqa: F401
from . import initializer as init  # noqa: F401

__version__ = "0.1.0"
