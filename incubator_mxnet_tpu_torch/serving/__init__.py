"""Inference serving (counterpart of ``incubator_mxnet_tpu/serving``).

- ``batcher``    — DynamicBatcher: replica workers, each with a bounded
  queue and size-or-deadline coalescing into bucketed batch shapes, fed
  by a least-depth router; dead replicas drain back to the survivors and
  a replica-death failure is retried once.
- ``registry``   — ModelRegistry: named, versioned models, prewarmed hot
  reload with draining and last-known-good rollback, one batcher per
  model, and generative engines; BlockServable runs a live block through
  ``jit.EvalStep`` (one captured CUDA graph per bucket on the card).
- ``generate``   — GenerativeEngine: continuous batching over a paged KV
  cache (``ops.kvcache``), one captured decode graph at max_batch rows.
- ``resilience`` — Supervisor: respawns dead replica workers under
  backoff, parks crash loops, resurrects dead decode loops.
- ``metrics``    — ServingMetrics: counters, batch-size histogram,
  latency percentiles, mirrored onto the telemetry registry.
- ``accesslog``  — the per-request access log.
- ``server``     — ServingServer: the HTTP front end (JSON tensors,
  chunked JSONL generation, /healthz, Prometheus /metrics, /debug/).

``MeshServable`` and ``serving_mesh`` (``sharded.py``, tensor-parallel
serving) wait for ROADMAP §1 item 5 and raise, naming it.

Start::

    import torch
    from incubator_mxnet_tpu_torch import gpu, models, serving

    net = models.BERTModel(..., attention="flash")
    net.initialize(ctx=gpu(0), generator=torch.Generator().manual_seed(0))
    srv = serving.serve({"bert": net}, port=8080, max_batch_size=8)
    # POST /v1/models/bert:predict {"inputs": [[...token ids...]],
    #                               "dtype": "int32"}
    srv.registry.load_generator("tinylm")      # POST /generate
    ...
    srv.stop()
"""
from .batcher import (DynamicBatcher, QueueFullError,  # noqa: F401
                      DeadlineExceededError, NoReplicasError,
                      ServingClosedError, default_buckets)
from .metrics import ServingMetrics, percentile  # noqa: F401
from .registry import (ModelRegistry, BlockServable,  # noqa: F401
                       ModelNotFoundError)
from .resilience import Supervisor  # noqa: F401
from .server import ServingServer, serve  # noqa: F401
from . import accesslog, generate  # noqa: F401

__all__ = [
    "DynamicBatcher", "QueueFullError", "DeadlineExceededError",
    "NoReplicasError", "ServingClosedError", "default_buckets",
    "ServingMetrics", "percentile",
    "ModelRegistry", "BlockServable", "ModelNotFoundError",
    "Supervisor",
    "ServingServer", "serve",
    "MeshServable", "serving_mesh",
]

_ITEM_5 = ("tensor-parallel serving (serving/sharded.py) comes with the "
           "multi-GPU slice of the port, ROADMAP §1 item 5")


class MeshServable:
    """The JAX package's tensor-parallel servable: item 5's."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_ITEM_5)

    @property
    def replicas(self):
        raise NotImplementedError(_ITEM_5)

    def predict_batch(self, *stacked_inputs, replica=0):
        raise NotImplementedError(_ITEM_5)


def serving_mesh(*args, **kwargs):
    """The JAX package's serving mesh: item 5's."""
    raise NotImplementedError(_ITEM_5)
