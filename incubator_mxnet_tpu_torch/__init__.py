"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of incubator_mxnet_tpu.

It mirrors the JAX package's file layout and public names, imports
``torch`` and never JAX or the JAX package. Plain tensor code is PyTorch;
each TPU Pallas kernel on a ported path is a hand-written CUDA kernel for
Hopper (``ops/csrc``), built with ``nvcc`` at first use. Entry points run
on ``gpu(0)`` unless the caller passes ``cpu()``.

Its array layer is MXNet's: ``nd.array`` and the ``nd`` operators give
``NDArray``s, ``autograd.record()``/``backward()`` differentiate them (with
MXNet's "write"/"add" gradients), ``nd.random`` draws from a seedable
generator per device, and ``nd.save``/``nd.load`` and
``Block.save_parameters``/``load_parameters`` read and write MXNet's
``.params`` format.

It serves BERT and GPT through ``serving.ModelRegistry`` with the
flash-attention forward kernel, and trains them through ``jit.TrainStep``
(``gluon.Trainer``, SGD/Adam/AdamW with fp32 masters) with the forward and
the two backward kernels; on the card ``TrainStep`` replays its whole step
as one captured CUDA graph per input signature. ``contrib.amp`` carries
MXNet's mixed-precision helpers. It trains LeNet, the model zoo (ResNet,
VGG, AlexNet, DenseNet, SqueezeNet, MobileNet v1/v2, Inception v3; conv
and pooling on cuDNN, batch norm in fp32) and the LSTM language model
(``gluon.rnn`` over ``nd.RNN``'s recurrence, cuDNN's fused RNN on the
card); ``ops.conv_bwd.conv3x3_s1`` carries the fused conv-backward
kernel, and ``rtc`` compiles user CUDA kernels with NVRTC at run time.

Around the model it carries MXNet's Gluon training loop: ``gluon.data``
(datasets, samplers, a ``DataLoader`` that batches on the host and moves
each batch to the card once), ``lr_scheduler``, the 17 optimizers of the
JAX package's registry, ``Trainer.save_states``/``load_states``,
``metric`` (reduced on the card), ``callback``, ``gluon.utils`` and
``HybridBlock.hybridize`` (one forward and backward CUDA graph per call
signature on the card).

Beside Gluon it carries MXNet's symbolic API: ``mx.sym`` (a graph over the
``nd`` operators, with MXNet's graph JSON), ``Executor``, ``mx.mod``
(``Module.fit``, ``BucketingModule``, ``SequentialModule``), ``model``
(checkpoints, ``FeedForward``), the local ``kvstore``, ``io`` (data
iterators), ``recordio``, ``image`` and ``monitor``, and the rest of
MXNet's legacy API: ``mx.rnn`` (the symbolic cells, ``BucketSentenceIter``,
RNN checkpoints), ``profiler`` (per-operator timing of the eager ``nd``
operators, chrome traces, ``torch.profiler`` device traces),
``visualization`` (``mx.viz``), ``engine`` and ``util`` (the NumPy-semantics
flags, ``inspect_tensor``).

Its serving front end is the JAX package's: ``serving.ServingServer``
(HTTP, the access log, ``/metrics`` from ``telemetry``'s registry, the
``/debug/`` routes), ``ModelRegistry`` with prewarmed hot reloads and
rollback, the ``DynamicBatcher`` with replica retry and the resilience
``Supervisor``, ``jit.EvalStep`` as captured CUDA graphs in the
process-wide ``aot`` cache, and ``serving.generate.GenerativeEngine``:
continuous batching over a paged KV cache (``ops.kvcache``), one
captured decode graph at ``max_batch`` rows.
"""
# telemetry depends only on config and the standard library: imported
# first, as in the JAX package, so every module can declare its metrics
from . import telemetry  # noqa: F401
telemetry._maybe_autostart()
from . import base, error, name, attribute, registry  # noqa: F401,E402
from .base import MXNetError  # noqa: F401
from . import autograd, config, context, initializer, ndarray  # noqa: F401
from . import aot  # noqa: F401
from . import ndarray as nd  # noqa: F401
from .ndarray import random  # noqa: F401
from . import contrib, gluon, jit, models, ops  # noqa: F401
from . import callback, lr_scheduler, metric  # noqa: F401
from . import optimizer, parallel, rtc, serving  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from .name import NameManager  # noqa: F401
from . import test_utils  # noqa: F401
from . import kvstore, recordio, io, image, model  # noqa: F401,E402
from . import kvstore as kv  # noqa: F401,E402
from .model import save_checkpoint, load_checkpoint, FeedForward  # noqa
from . import symbol  # noqa: F401,E402
from . import symbol as sym  # noqa: F401,E402
from .executor import Executor  # noqa: F401,E402
from . import module  # noqa: F401,E402
from . import module as mod  # noqa: F401,E402
from . import monitor  # noqa: F401,E402
from .monitor import Monitor  # noqa: F401,E402
from . import rnn, profiler, engine, util  # noqa: F401,E402
from .util import is_np_array, set_np, reset_np, np_shape, np_array  # noqa
from . import visualization  # noqa: F401,E402
from . import operator  # noqa: F401,E402
from . import library, runtime, subgraph  # noqa: F401,E402
from . import numpy  # noqa: F401,E402
from . import numpy as np  # noqa: F401,E402
from . import numpy_extension  # noqa: F401,E402
from . import numpy_extension as npx  # noqa: F401,E402
from . import visualization as viz  # noqa: F401,E402
from .context import (Context, cpu, cpu_pinned, current_context,  # noqa: F401
                      gpu, num_gpus, num_tpus, tpu)
from .convert import from_jax_params, to_numpy_params  # noqa: F401
from . import initializer as init  # noqa: F401

# several worker processes (tools/launch.py sets MXTPU_NUM_PROC and
# MXTPU_COORD_ADDR): the import starts the process group, as the JAX
# package's import starts jax.distributed
from .parallel import dist as _dist  # noqa: E402
_dist._init_from_launcher()

__version__ = "0.1.0"
