"""Gluon data (counterpart of ``incubator_mxnet_tpu/gluon/data``): datasets,
samplers, the ``DataLoader``, and the vision datasets and transforms."""
from .dataset import Dataset, SimpleDataset, ArrayDataset  # noqa: F401
from .dataset import RecordFileDataset  # noqa: F401
from .sampler import (Sampler, SequentialSampler,  # noqa: F401
                      RandomSampler, BatchSampler)
from .dataloader import DataLoader, default_batchify_fn  # noqa: F401
from . import vision  # noqa: F401
from .vision import transforms  # noqa: F401
