"""Several worker processes over ``torch.distributed`` (counterpart of
``incubator_mxnet_tpu/parallel/dist.py``).

``tools/launch.py -n N <command>`` starts N copies of a command with
``MXTPU_COORD_ADDR`` (host:port), ``MXTPU_NUM_PROC`` and ``MXTPU_PROC_ID``
in their environment (``DMLC_NUM_WORKER``, ``DMLC_RANK`` and
``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT`` stand in for an unset one).
``init_distributed`` turns them into the ``tcp://host:port`` init method:
rank 0 holds the TCP store there, every rank joins it, and the process
group is made over it. Importing the package does this already when
``MXTPU_NUM_PROC`` > 1 and an address is set, so the launcher alone starts
port workers, as it starts the JAX package's.

The backend rule: gloo when any rank computes on the CPU or when two ranks
share one CUDA device (NCCL refuses two ranks on one GPU); NCCL when every
rank owns a GPU of its own. Each rank writes its device's identity (its
UUID, or "cpu") into the store before the group is made, so every rank
reads the same list and picks the same backend. The choice is logged
(``backend()`` reads it back). A chosen NCCL that fails raises: there is no quiet
fall back to gloo. A caller may name the backend itself (``backend=``),
which also makes a group of one process (``num_processes=1``) when one is
wanted, say to drive NCCL on one card.

Every collective of the group has the group's timeout
(``MXTPU_DIST_TIMEOUT_S``): a rank that never arrives makes the others
raise instead of hang.
"""
from __future__ import annotations

import datetime
import logging
import os
import socket

__all__ = ["init_distributed", "rank", "num_workers", "is_initialized",
           "backend", "choose_backend"]

_LOG = logging.getLogger(__name__)

_STATE = {"initialized": False, "device": None}


def _launcher_env():
    """(address, number of processes, rank) from the launcher's
    environment, with the DMLC names standing in for unset MXTPU ones."""
    from ..config import get_env
    env = os.environ
    addr = get_env("MXTPU_COORD_ADDR")
    if not addr and env.get("DMLC_PS_ROOT_URI"):
        addr = "%s:%s" % (env["DMLC_PS_ROOT_URI"],
                          env.get("DMLC_PS_ROOT_PORT", "9091"))
    num = get_env("MXTPU_NUM_PROC") if "MXTPU_NUM_PROC" in env else \
        int(env.get("DMLC_NUM_WORKER", 1))
    pid = get_env("MXTPU_PROC_ID") if "MXTPU_PROC_ID" in env else \
        int(env.get("DMLC_RANK", 0))
    return addr, num, pid


def _identity(device):
    """What names ``device`` across processes: "cpu", or the CUDA device's
    UUID (its host and index where the build has no UUID)."""
    import torch
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
    return "cuda:%s" % (uuid if uuid is not None else
                        "%s/%d" % (socket.gethostname(), index))


def choose_backend(identities):
    """The backend for ranks on the devices ``identities`` (one a rank, in
    rank order, as ``_identity`` gives them): "nccl" when every rank is on
    a CUDA device no other rank uses, else "gloo"."""
    ids = list(identities)
    if ids and all(i.startswith("cuda:") for i in ids) and \
            len(set(ids)) == len(ids):
        return "nccl"
    return "gloo"


def _default_device(process_id):
    import torch
    if torch.cuda.is_available():
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return torch.device("cpu")


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, device=None,
                     timeout=None):
    """Start the process group from the arguments or the launcher's
    environment. Idempotent: a second call, or a call after the package
    import started the group, does nothing. With one process and no
    ``backend`` there is no group (``rank()`` 0, ``num_workers()`` 1).

    ``device`` is this rank's compute device (default ``cuda:rank %
    count`` where CUDA is available, else the CPU); ``backend`` overrides
    the rule of the module docstring; ``timeout`` (seconds, default
    ``MXTPU_DIST_TIMEOUT_S``) bounds the rendezvous and every
    collective."""
    import torch
    import torch.distributed as dist
    from ..config import get_env
    if _STATE["initialized"]:
        return
    if dist.is_available() and dist.is_initialized():
        _STATE["initialized"] = True
        return
    env_addr, env_num, env_pid = _launcher_env()
    coordinator_address = coordinator_address or env_addr
    num_processes = num_processes or env_num
    process_id = process_id if process_id is not None else env_pid
    if not coordinator_address or (num_processes <= 1 and backend is None):
        _STATE["initialized"] = True
        return
    device = torch.device(device) if device is not None else \
        _default_device(process_id)
    seconds = float(timeout if timeout is not None
                    else get_env("MXTPU_DIST_TIMEOUT_S"))
    wait = datetime.timedelta(seconds=seconds)
    url = "tcp://%s" % coordinator_address
    store, _, _ = next(dist.rendezvous(url, process_id, num_processes,
                                       timeout=wait))
    store.set("mxtpu/device/%d" % process_id, _identity(device))
    ids = [store.get("mxtpu/device/%d" % r).decode()
           for r in range(num_processes)]
    chosen = backend or choose_backend(ids)
    if chosen == "nccl":
        if device.type != "cuda":
            raise RuntimeError("NCCL needs a CUDA device; rank %d is on %s"
                               % (process_id, device))
        torch.cuda.set_device(device)
    dist.init_process_group(chosen, store=dist.PrefixStore("mxtpu", store),
                            rank=process_id, world_size=num_processes,
                            timeout=wait)
    _STATE.update(initialized=True, device=device)
    _LOG.info("torch.distributed: rank %d of %d, backend %s (devices %s), "
              "init method tcp://%s, timeout %.0f s", process_id,
              num_processes, chosen, ids, coordinator_address, seconds)


def _init_from_launcher():
    """The package import's start-up: the group, when the launcher's
    environment asks for several processes. A process that
    ``multiprocessing`` started (a DataLoader worker) inherits the
    environment but is not a rank, so it starts nothing."""
    import multiprocessing
    addr, num, _ = _launcher_env()
    if num > 1 and addr and multiprocessing.parent_process() is None:
        init_distributed()


def is_initialized():
    """Whether ``init_distributed`` has run (or a group is up)."""
    if _STATE["initialized"]:
        return True
    from ..base import distributed_is_initialized
    return distributed_is_initialized()


def backend():
    """The process group's backend ("gloo" or "nccl"), None without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def rank():
    """This process's rank: 0 without a process group."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def num_workers():
    """The number of processes: 1 without a process group."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
