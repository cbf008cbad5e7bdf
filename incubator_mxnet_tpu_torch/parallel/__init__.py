"""Parallelism over a device mesh (counterpart of
``incubator_mxnet_tpu/parallel``): single-controller SPMD in one process.

- compat:            shard_map and its collectives, run in threads
- mesh:              device meshes (dp/tp/pp/sp/ep axes) and partition specs
- data_parallel:     the data-parallel step and ZeRO-1 optimizer states
- tensor_parallel:   column/row split Dense layers
- ring_attention:    sequence parallelism over the ring
- ulysses:           sequence parallelism by head-scatter all-to-all
- pipeline:          GPipe ring and hand-scheduled 1F1B pipeline
- pipeline_interleaved: virtual-stage (interleaved) 1F1B
- gluon_pipeline:    PipelineStack, a pipelined trunk as a Gluon block
- moe:               expert-parallel mixture of experts

Several processes (``init_distributed``, ``rank``, ``num_workers``,
gradient compression, the ``dist*`` kvstores) are the next slice of the
port (ROADMAP §1 item 5): those names raise, naming it.
"""
from .compat import shard_map, HAVE_SHARD_MAP, ShardMapUnavailable  # noqa
from .mesh import (make_mesh, current_mesh, set_current_mesh,  # noqa
                   replicated, shard_spec)
from .data_parallel import DataParallelTrainStep  # noqa
from .tensor_parallel import (ColParallelDense, RowParallelDense,  # noqa
                              shard_params)
from .ring_attention import ring_attention, local_attention  # noqa
from .ulysses import ulysses_attention  # noqa
from .pipeline import (PipelineParallel, pipeline_spmd,  # noqa
                       pipeline_1f1b_grads)
from .pipeline_interleaved import (  # noqa
    pipeline_interleaved_grads, interleaved_schedule, schedule_stats)
from .gluon_pipeline import PipelineStack  # noqa
from .moe import MoELayer, load_balancing_loss, router_z_loss  # noqa

_NEXT_SLICE = ("several processes (jax.distributed's counterpart: "
               "torch.distributed, gradient compression) come with the next "
               "slice of the port, ROADMAP §1 item 5")


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """The JAX package's ``jax.distributed`` start-up: item 5's next
    slice."""
    raise NotImplementedError(_NEXT_SLICE)


def rank():
    """This process's rank: item 5's next slice."""
    raise NotImplementedError(_NEXT_SLICE)


def num_workers():
    """The number of processes: item 5's next slice."""
    raise NotImplementedError(_NEXT_SLICE)


class GradientCompression:
    """The JAX package's 2-bit gradient compression: item 5's next
    slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NEXT_SLICE)

    def compress_decompress(self, grad, key):
        raise NotImplementedError(_NEXT_SLICE)
