"""HiFi-GAN waveform generator, [B, C, T] layout (a frozen plain copy of the
PyTorch port's ``modules/hifigan.py``): conv_pre k7 -> speaker cond -> N x
[leaky_relu -> weight-norm transposed conv up -> mean of multi-kernel
ResBlocks] -> leaky_relu -> conv_post k7 (no bias) -> tanh."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import (LRELU_SLOPE, Conv1d,
                                               ConvTranspose1d)


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"conv1_{i}", Conv1d(
                channels, channels, kernel_size, dilation=d, weight_norm=True))
            self.add_module(f"conv2_{i}", Conv1d(
                channels, channels, kernel_size, weight_norm=True))

    def forward(self, x):
        for i in range(self.n):
            xt = getattr(self, f"conv1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            xt = getattr(self, f"conv2_{i}")(F.leaky_relu(xt, LRELU_SLOPE))
            x = x + xt
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"conv_{i}", Conv1d(
                channels, channels, kernel_size, dilation=d, weight_norm=True))

    def forward(self, x):
        for i in range(self.n):
            x = x + getattr(self, f"conv_{i}")(F.leaky_relu(x, LRELU_SLOPE))
        return x


class HiFiGANGenerator(nn.Module):
    """z [B, C, T] -> waveform [B, T * prod(upsample_rates)], float32 (z is
    cast to the compute dtype on entry, the tanh runs in float32)."""

    dtype = torch.float32

    def __init__(self, in_channels: int, resblock_type: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 upsample_rates: Sequence[int] = (5, 5, 3, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (11, 11, 7, 4, 4),
                 gin_channels: int = 0):
        super().__init__()
        self.n_ups = len(upsample_rates)
        self.n_kernels = len(resblock_kernel_sizes)
        res_cls = ResBlock1 if resblock_type == "1" else ResBlock2
        ch = upsample_initial_channel
        self.conv_pre = Conv1d(in_channels, ch, 7)
        if gin_channels:
            self.cond = Conv1d(gin_channels, ch, 1)
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch_out = upsample_initial_channel // (2 ** (i + 1))
            self.add_module(f"up_{i}", ConvTranspose1d(ch, ch_out, k, u))
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes,
                                             resblock_dilations)):
                self.add_module(f"res_{i}_{j}", res_cls(ch_out, rk, tuple(rd)))
            ch = ch_out
        self.conv_post = Conv1d(ch, 1, 7, bias=False)

    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None):
        """x: [B, C, T]; g: [B, gin, 1] or None."""
        x = self.conv_pre(x.to(self.dtype))
        if g is not None and hasattr(self, "cond"):
            x = x + self.cond(g)
        for i in range(self.n_ups):
            x = getattr(self, f"up_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            acc = getattr(self, f"res_{i}_0")(x)
            for j in range(1, self.n_kernels):
                acc = acc + getattr(self, f"res_{i}_{j}")(x)
            x = acc / self.n_kernels
        x = self.conv_post(F.leaky_relu(x, LRELU_SLOPE))
        return torch.tanh(x.float())[:, 0]
