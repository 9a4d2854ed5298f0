"""Data parallelism over ``torch.distributed`` (the counterpart of the JAX
package's ``parallel/mesh.py``).

The JAX package builds a 1-D device mesh and jits the train step over it,
the batch sharded on its leading axis and the parameters replicated, so
XLA emits the gradient all-reduce inside one SPMD program over the global
batch.  The port runs one process per rank (``torchrun``, or
``multihost.initialize_distributed``), each holding its contiguous rows of
every global batch (``shard_batch``) and a full copy of the models, and
makes the reduction explicit:

- every loss divides a rank-local numerator (a masked sum over the rank's
  rows) by the global denominator (the masked count over every rank's rows:
  the step sums every count in one ``global_sums`` before its forward), so
  the ranks' losses sum to the global batch's loss;
- the gradients of those losses are summed over the ranks
  (``all_reduce_grads``) before the clip and the optimizer, so every rank
  applies the update of the global step.

A mean of per-rank means would not be that step: the ranks hold different
valid-frame counts, and a rank may hold only padding rows (item weight 0).

``jit_train_step`` has no counterpart: there is no compiled program to
place, and the step itself calls the collectives (``training/
train_step.py``).  ``make_mesh``, ``batch_sharding`` and ``replicated``
have none either: a rank's device is ``local_device``.

With no process group every function here is the identity and issues no
collective, so the single-process step is unchanged bit for bit.
Collectives run on the tensors' device: NCCL on CUDA tensors, gloo on CPU
tensors and, for ``all_reduce`` only, on CUDA tensors too (several ranks
on one card).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

# elements per all-reduce of the gradients (64 MB of float32): few
# collectives a step, without a second copy of every gradient at once
BUCKET_ELEMS = 1 << 24


def distributed() -> bool:
    """Whether a process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``; the
    global rank when the launcher does not set it)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_device(device="cuda") -> torch.device:
    """The device of this rank for a requested ``device``: a CUDA request
    without an index becomes ``cuda:<local rank>`` under a process group.
    Ranks share a card only under gloo (NCCL refuses two ranks on one
    GPU); under NCCL a local rank past the card count raises."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or not distributed():
        return dev
    n, lr = torch.cuda.device_count(), local_rank()
    if lr >= n and dist.get_backend() == "nccl":
        raise RuntimeError(f"local rank {lr} has no card of its own "
                           f"({n} visible) under NCCL")
    return torch.device("cuda", lr % max(n, 1))


def host_batch_slice(n: int, rank_: int | None = None,
                     world: int | None = None) -> slice:
    """Rank ``rank_``'s contiguous share of ``n`` rows (default this
    process's rank and world size); the world size must divide ``n``."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    per = n // world
    if per * world != n:
        raise ValueError(f"{n} rows not divisible by {world} ranks")
    return slice(rank_ * per, (rank_ + 1) * per)


def shard_batch(batch: dict, rank_: int | None = None,
                world: int | None = None) -> dict:
    """The rank's contiguous rows of a host-global batch (every value's
    leading axis; ``host_batch_slice``); the batch itself at world size
    1."""
    if (world_size() if world is None else world) == 1:
        return batch
    rows = host_batch_slice(len(next(iter(batch.values()))), rank_, world)
    return {k: v[rows] for k, v in batch.items()}


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, without gradient (loss denominators and
    metrics); ``x`` itself when there is no process group."""
    if not distributed():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def global_sums(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each 0-d tensor of the list summed over the ranks, in one
    collective; the list itself when there is no process group."""
    if not distributed() or not tensors:
        return tensors
    return list(global_sum(torch.stack([t.detach().float()
                                        for t in tensors])).unbind())


def _buckets(tensors: list[torch.Tensor], elems: int):
    bucket, n = [], 0
    for i, t in enumerate(tensors):
        if bucket and (n + t.numel() > elems
                       or t.dtype != tensors[bucket[0]].dtype):
            yield bucket
            bucket, n = [], 0
        bucket.append(i)
        n += t.numel()
    if bucket:
        yield bucket


def all_reduce_grads(grads: list[torch.Tensor],
                     bucket_elems: int = BUCKET_ELEMS) -> list[torch.Tensor]:
    """The gradients summed over the ranks: one all-reduce per bucket of
    ``bucket_elems`` elements, each bucket flattened into one buffer (the
    step is host-bound, so not one collective per parameter).  -> the list
    of summed gradients (views of the buffers); ``grads`` itself when there
    is no process group."""
    if not distributed():
        return grads
    out = list(grads)
    for idx in _buckets(grads, bucket_elems):
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        for i, piece in zip(idx, flat.split([grads[i].numel()
                                             for i in idx])):
            out[i] = piece.view_as(grads[i])
    return out


@torch.no_grad()
def replicated_check(tensors: list[torch.Tensor]) -> float:
    """The largest difference of any element of ``tensors`` between the
    ranks: max over ranks minus min over ranks, 0.0 when every rank holds
    the same values (NaN if one holds a NaN).  Two all-reduces of
    everything: for tests and ``chip_smoke.py``, not for the training
    loop."""
    if not distributed() or not tensors:
        return 0.0
    worst = 0.0
    for idx in _buckets(tensors, BUCKET_ELEMS):
        flat = torch.cat([tensors[i].detach().reshape(-1).float()
                          for i in idx])
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        d = float((hi - lo).max())
        if d != d:  # a NaN on some rank
            return d
        worst = max(worst, d)
    return worst


def barrier() -> None:
    """Wait for every rank; nothing without a process group."""
    if distributed():
        dist.barrier()
