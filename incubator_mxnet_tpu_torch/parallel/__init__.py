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
- compression:       2-bit gradient compression with error feedback
- dist:              several processes over torch.distributed
                     (``init_distributed``, ``rank``, ``num_workers``);
                     the ``dist*`` kvstores run over its process group
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
from .compression import GradientCompression  # noqa
from .dist import init_distributed, rank, num_workers  # noqa
