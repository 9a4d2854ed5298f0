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
