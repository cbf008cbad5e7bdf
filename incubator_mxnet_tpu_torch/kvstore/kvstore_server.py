"""The kvstore server role (counterpart of
``incubator_mxnet_tpu/kvstore/kvstore_server.py``): it comes with the
multi-GPU slice (ROADMAP.md §1 item 5) and raises."""
from __future__ import annotations

__all__ = ["KVStoreServer"]

_ITEM5 = "comes with the multi-GPU slice (ROADMAP.md §1 item 5)"


class KVStoreServer:
    """A kvstore server process: waits for the dist stores."""

    def __init__(self, kvstore):
        raise NotImplementedError("KVStoreServer " + _ITEM5)

    def init_logging(self):
        raise NotImplementedError("KVStoreServer " + _ITEM5)

    def run(self):
        raise NotImplementedError("KVStoreServer " + _ITEM5)


def _init_kvstore_server_module():
    raise NotImplementedError("the kvstore server role " + _ITEM5)
