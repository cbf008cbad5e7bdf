"""The kvstore server role (counterpart of
``incubator_mxnet_tpu/kvstore/kvstore_server.py``; MXNet's
``python/mxnet/kvstore_server.py``).

MXNet runs dedicated server processes (``DMLC_ROLE=server``) that loop,
applying the updates workers push. The dist stores here are symmetric, as
the JAX package's are: every worker applies the same update to the same
sum over the processes (``DistKVStore``), so no server process is needed.
The module keeps MXNet's surface so that launch scripts that branch on the
role keep working:

- ``KVStoreServer(kv).run()`` makes the command controller (an optimizer
  blob is set on this process's store) and returns: there is nothing to
  serve;
- ``_init_kvstore_server_module()``, MXNet's entry of a server process,
  does that for a process whose role is "server".
"""
from __future__ import annotations

import logging
import os
import pickle

from ..config import get_env

__all__ = ["KVStoreServer"]


class KVStoreServer:
    """MXNet's server loop over ``kvstore``: here its controller alone."""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.init_logging()

    def init_logging(self):
        self._verbose = get_env("MXTPU_KVSTORE_DEBUG")

    def _controller(self):
        """MXNet's server controller: the commands a worker sends (an
        optimizer, the sync mode, stop) apply to this process's store, which
        does what a server did."""
        def server_controller(cmd_id, cmd_body):
            if cmd_id == 0:          # kController: the optimizer's pickle
                self.kvstore.set_optimizer(pickle.loads(cmd_body))
            elif cmd_id in (1, 2, 3):
                # kSetMultiPrecision (the updater keeps fp32 masters),
                # kStopServer, kSyncMode: nothing runs to change
                pass
            else:
                logging.warning("server got unknown command %s", cmd_id)
        return server_controller

    def run(self):
        """MXNet's server blocks here; a symmetric worker has no loop, so
        this makes the controller and returns."""
        self._controller()
        logging.info(
            "kvstore server role: nothing to serve; every worker updates "
            "against the sum over the processes (kvstore.DistKVStore)")


def _init_kvstore_server_module():
    """MXNet's entry of a server process (the role from ``DMLC_ROLE`` or
    ``MXTPU_ROLE``): a ``KVStoreServer`` over a local store, run."""
    role = os.environ.get("DMLC_ROLE") or get_env("MXTPU_ROLE")
    if role == "server":
        from . import kvstore as _kv
        KVStoreServer(_kv.KVStore("local")).run()
