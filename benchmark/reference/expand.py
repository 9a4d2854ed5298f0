"""Length regulator (a frozen plain copy of the PyTorch port's
``ops/expand.py``)."""

from __future__ import annotations

import torch


def expand_states(h: torch.Tensor, mel2token: torch.Tensor) -> torch.Tensor:
    """Length-regulate token-rate features to frame rate.

    Args:
      h: [B, T_tok, C] token-rate hidden states.
      mel2token: [B, T_frame] int; 0 = padding, i>0 selects token i-1.

    Returns [B, T_frame, C]; padding frames get zeros (a gather over the
    token axis with a zero row prepended).
    """
    b, _, c = h.shape
    padded = torch.cat([h.new_zeros(b, 1, c), h], dim=1)
    idx = mel2token.long()[..., None].expand(-1, -1, c)
    return torch.gather(padded, 1, idx)
