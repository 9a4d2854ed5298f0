"""Masking ops (counterpart of the JAX package's ``ops/masking.py``)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths -> [B, max_length] bool mask (True = valid)."""
    pos = torch.arange(max_length, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def prefix_lengths(mask: torch.Tensor) -> torch.Tensor:
    """[B, T, 1] or [B, T] prefix mask -> [B] int32 valid lengths.

    Every caller's mask is a prefix (tokens ``text_tokens > 0`` and frames
    ``mel2ph > 0`` are padded only at the tail), so the count is the
    length."""
    if mask.dim() == 3:
        mask = mask[..., 0]
    return (mask > 0).sum(dim=1).to(torch.int32)


def slice_segments(x: torch.Tensor, ids_start: torch.Tensor,
                   segment_size: int) -> torch.Tensor:
    """Per-item windows along axis 1: x [B, T, ...], ids_start [B] ->
    [B, segment_size, ...].  A start past ``T - segment_size`` is clamped
    there, as ``jax.lax.dynamic_slice`` does."""
    t = x.shape[1]
    start = ids_start.long().clamp(0, max(t - segment_size, 0))
    idx = start[:, None] + torch.arange(segment_size, device=x.device)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        -1, -1, *x.shape[2:])
    return torch.gather(x, 1, idx)


def rand_slice_segments(x: torch.Tensor, segment_size: int,
                        lengths: torch.Tensor | None = None,
                        generator: torch.Generator | None = None,
                        ids: torch.Tensor | None = None):
    """Random windows of ``segment_size`` frames (the GAN-training slice).

    With ``lengths`` the windows are drawn inside each item's valid length,
    ``ids = floor(u * max(len - seg + 1, 1))`` with u ~ U[0, 1) from
    ``generator``; without, over the padded length.  ``ids`` [B] may be
    given instead of drawn.  Returns (slices, ids)."""
    b, t = x.shape[:2]
    if ids is None:
        if lengths is None:
            ids_max = torch.full((b,), t - segment_size + 1, device=x.device)
        else:
            ids_max = (lengths.to(x.device).long() - segment_size + 1
                       ).clamp(min=1)
        u = torch.rand(b, generator=generator, device=x.device)
        ids = (u * ids_max.float()).long()
    ids = ids.to(x.device).long()
    return slice_segments(x, ids, segment_size), ids
