"""Normalizing flow: mean-only residual affine couplings with channel flips,
[B, C, T] layout (a frozen plain copy of the PyTorch port's
``modules/flow.py``).

Forward: x1' = m + x1.  Reverse: x1 = x1' - m.  ``post`` is zero-initialised
(its bias is not), so a freshly built flow is nearly the identity."""

from __future__ import annotations

import torch
from torch import nn

from .common import Conv1d
from .wavenet import WaveNet


class ResidualCouplingLayer(nn.Module):
    dtype = torch.float32

    def __init__(self, channels: int, hidden_channels: int,
                 kernel_size: int = 5, n_layers: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WaveNet(hidden_channels, kernel_size, n_layers,
                           gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1, init="zeros")

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x, x_mask = x.to(self.dtype), x_mask.to(self.dtype)
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=1)


class ResidualCouplingBlock(nn.Module):
    def __init__(self, channels: int, hidden_channels: int,
                 kernel_size: int = 5, n_layers: int = 4, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.n_flows = n_flows
        for i in range(n_flows):
            self.add_module(f"coupling_{i}", ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, n_layers,
                gin_channels))

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        """x: [B, C, T]; x_mask: [B, 1, T]; g: [B, gin, 1] or None."""
        layers = [getattr(self, f"coupling_{i}") for i in range(self.n_flows)]
        if not reverse:
            for layer in layers:
                x = torch.flip(layer(x, x_mask, g=g), dims=[1])
        else:
            for layer in reversed(layers):
                x = layer(torch.flip(x, dims=[1]), x_mask, g=g, reverse=True)
        return x
