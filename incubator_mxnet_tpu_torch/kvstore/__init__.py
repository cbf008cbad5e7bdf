"""KVStore: MXNet's push/pull API (counterpart of
``incubator_mxnet_tpu/kvstore``): the "local" and "device" stores of one
process, the "dist_sync", "dist_device_sync" and "dist_async" stores over
several processes (``parallel.dist``) with 2-bit gradient compression, and
the server role (``KVStoreServer``), which in the symmetric design has
nothing to serve."""
from .kvstore import (KVStore, KVStoreBase, create, LocalKVStore,  # noqa: F401
                      DistKVStore, DistAsyncKVStore)
from . import kvstore_server  # noqa: F401
from .kvstore_server import KVStoreServer  # noqa: F401
