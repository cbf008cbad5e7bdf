"""The ``mx.io`` namespace (counterpart of ``incubator_mxnet_tpu/io``)."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,  # noqa
                 PrefetchingIter, ImageRecordIter, MNISTIter, CSVIter,
                 LibSVMIter, ImageDetRecordIter)
