"""KVStore: MXNet's push/pull API (counterpart of
``incubator_mxnet_tpu/kvstore``), for the "local" and "device" stores of
one process. The ``dist*`` stores and the server role come with the
multi-GPU slice (ROADMAP.md §1 item 5) and raise."""
from .kvstore import (KVStore, KVStoreBase, create, LocalKVStore,  # noqa: F401
                      DistKVStore, DistAsyncKVStore)
from . import kvstore_server  # noqa: F401
from .kvstore_server import KVStoreServer  # noqa: F401
