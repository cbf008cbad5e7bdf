"""Inference serving (counterpart of ``incubator_mxnet_tpu/serving``).

- ``batcher``  — DynamicBatcher: replica workers, each with a bounded queue
  and size-or-deadline coalescing into bucketed batch shapes.
- ``registry`` — ModelRegistry: named, versioned models, one batcher each;
  BlockServable runs a live block through ``jit.EvalStep``.
- ``metrics``  — ServingMetrics: counters, batch-size histogram, latency
  percentiles.

Start::

    import torch
    from incubator_mxnet_tpu_torch import gpu, models, serving

    net = models.BERTModel(..., attention="flash")
    net.initialize(ctx=gpu(0), generator=torch.Generator().manual_seed(0))
    reg = serving.ModelRegistry()
    reg.load("bert", net, max_batch_size=8)
    logits, = reg.predict("bert", tokens)     # tokens: (S,) int32
"""
from .batcher import (DynamicBatcher, QueueFullError,  # noqa: F401
                      DeadlineExceededError, ServingClosedError,
                      default_buckets)
from .metrics import ServingMetrics, percentile  # noqa: F401
from .registry import (ModelRegistry, BlockServable,  # noqa: F401
                       ModelNotFoundError)
