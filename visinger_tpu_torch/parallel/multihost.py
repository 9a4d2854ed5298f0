"""Process-group bootstrap and per-host batch slices (the counterpart of
the JAX package's ``parallel/multihost.py``).

``initialize_distributed`` starts the ``torch.distributed`` process group
from explicit arguments, from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from
the JAX package's (``VISINGER_COORDINATOR``, ``VISINGER_NUM_PROCESSES``,
``VISINGER_PROCESS_ID``, ``visinger_tpu/run.py:123-127``).  Every rank
builds the same global batch from the same epoch plan and keeps its
contiguous slice (``host_batch_slice``, defined in ``mesh``, which
``shard_batch`` and the synthesis's frame split share), the JAX package's
rank-strided split; only the primary rank writes files (``is_primary``).

``global_batch_from_local`` has no counterpart: a rank's slice is all its
step reads, and the global batch is never assembled in one place; the
step sums what must be global (``mesh.global_sum``).

Nothing here falls back: a group that fails to start, a backend that is
not built in, or a world size that does not divide a batch raises.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from visinger_tpu_torch.parallel import mesh
from visinger_tpu_torch.parallel.mesh import host_batch_slice  # noqa: F401

_ENV = (("VISINGER_COORDINATOR", "VISINGER_NUM_PROCESSES",
         "VISINGER_PROCESS_ID"),
        ("MASTER_ADDR", "WORLD_SIZE", "RANK"))


def requested() -> bool:
    """Whether the environment asks for a process group (torchrun's or the
    JAX package's variables are set)."""
    return bool(os.environ.get("WORLD_SIZE")
                or os.environ.get("VISINGER_COORDINATOR"))


def choose_backend(device, world: int) -> str:
    """NCCL when the ranks run on CUDA and the ranks of this host
    (torchrun's ``LOCAL_WORLD_SIZE``, else the world size) are no more
    than its visible cards; gloo otherwise: on the CPU, or several ranks
    sharing a card (NCCL refuses two ranks on one GPU)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None, device="cuda",
                           timeout_s: float = 600.0) -> torch.device:
    """Start the process group and return this rank's device
    (``mesh.local_device(device)``; a CUDA rank is made its current
    device).

    ``coordinator_address`` is "host:port" (``tcp://`` optional); unset
    arguments come from the JAX package's variables, then torchrun's.
    ``backend`` defaults to ``choose_backend``: NCCL on CUDA when every
    local rank has a card, gloo on the CPU or when ranks share a card.  A
    group already started is kept.  Raises ``ValueError`` when the world
    size or rank is missing, ``RuntimeError`` when the backend is not
    available."""
    if mesh.distributed():
        return _bind(device)
    coord_env, n_env, id_env = _ENV[0]
    coordinator_address = coordinator_address or os.environ.get(coord_env)
    num_processes = num_processes or os.environ.get(n_env) \
        or os.environ.get("WORLD_SIZE")
    if process_id is None:
        process_id = os.environ.get(id_env, os.environ.get("RANK"))
    if not coordinator_address and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None or process_id is None \
            or not coordinator_address:
        raise ValueError(
            "initialize_distributed needs a coordinator address, a world "
            "size and a rank (arguments, torchrun's MASTER_ADDR/MASTER_PORT/"
            "WORLD_SIZE/RANK, or VISINGER_COORDINATOR/"
            "VISINGER_NUM_PROCESSES/VISINGER_PROCESS_ID)")
    backend = backend or choose_backend(device, int(num_processes))
    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not "
                           "available in this PyTorch build")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs CUDA")
    addr = coordinator_address
    if not addr.startswith(("tcp://", "file://", "env://")):
        addr = f"tcp://{addr}"
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=timedelta(seconds=timeout_s))
    return _bind(device)


def _bind(device) -> torch.device:
    dev = mesh.local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def is_primary() -> bool:
    """Rank-0 IO gating: checkpoints, logs, renders and test outputs."""
    return mesh.rank() == 0


def shutdown() -> None:
    """Destroy the process group, if one was started."""
    if mesh.distributed():
        dist.destroy_process_group()
