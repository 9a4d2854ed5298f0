"""Multi-period and scale discriminators, HiFi-GAN style (counterpart of the
JAX package's ``modules/discriminator.py``), weight norm, LeakyReLU 0.1.

  - ``DiscriminatorP`` (period p): reflect-pad the waveform to a multiple of
    p, fold it to [B, 1, T/p, p], five (5, 1) convs (stride 3 for the first
    four) with ``channels`` widths, then a (3, 1) post conv;
  - ``DiscriminatorS``: six grouped, strided 1-D convs (k 15/41/41/41/41/5,
    strides 1/4/4/4/4/1, groups 1/4/16/64/256/1, padding 7/20/20/20/20/2) and
    a k3 post conv;
  - ``MultiPeriodDiscriminator``: one S and one P per period; with
    ``pair_batch`` each sub-discriminator runs once on the real and fake
    halves concatenated along the batch (the convolutions are per item, so
    the result is the same).

Feature maps are in PyTorch's channels-first layout ([B, C, H, p] and
[B, C, T]); scores are flattened per item in the same order as the JAX
package's.  ``use_spectral_norm`` swaps every conv's weight norm for the
stateless spectral norm (``modules/common.py::spectral_normalize``).  The
waveforms are cast to the compute dtype (``set_compute_dtype``) on entry,
so the feature maps and scores come out in it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from visinger_tpu_torch.modules.common import LRELU_SLOPE, Conv1d, Conv2dP
from visinger_tpu_torch.utils.meters import span


class DiscriminatorP(nn.Module):
    dtype = torch.float32

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels: Sequence[int] = (32, 128, 512, 1024),
                 use_spectral_norm: bool = False):
        super().__init__()
        self.period = period
        self.n = len(channels)
        sn = use_spectral_norm
        c_in = 1
        for i, ch in enumerate(channels):
            self.add_module(f"conv_{i}", Conv2dP(c_in, ch, kernel_size,
                                                 stride, spectral_norm=sn))
            c_in = ch
        self.add_module(f"conv_{self.n}", Conv2dP(
            c_in, channels[-1], kernel_size, 1, spectral_norm=sn))
        self.conv_post = Conv2dP(channels[-1], 1, 3, 1, spectral_norm=sn)

    def forward(self, x: torch.Tensor):
        """x: [B, T] waveform -> (score [B, N], feature maps)."""
        b, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x[:, None], (0, p - t % p), mode="reflect")[:, 0]
        x = x.reshape(b, 1, -1, p).to(self.dtype)
        fmap = []
        for i in range(self.n + 1):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorS(nn.Module):
    dtype = torch.float32

    def __init__(self, base: int = 16, use_spectral_norm: bool = False):
        super().__init__()
        sn = use_spectral_norm
        m = base
        specs = [(m, 15, 1, 1), (4 * m, 41, 4, 4), (16 * m, 41, 4, 16),
                 (64 * m, 41, 4, 64), (64 * m, 41, 4, min(256, 16 * m)),
                 (64 * m, 5, 1, 1)]
        c_in = 1
        for i, (ch, k, s, groups) in enumerate(specs):
            pad = 7 if k == 15 else (20 if k == 41 else 2)
            self.add_module(f"conv_{i}", Conv1d(
                c_in, ch, k, stride=s, groups=groups, padding=pad,
                weight_norm=not sn, spectral_norm=sn))
            c_in = ch
        self.n = len(specs)
        self.conv_post = Conv1d(c_in, 1, 3, weight_norm=not sn,
                                spectral_norm=sn)

    def forward(self, x: torch.Tensor):
        """x: [B, T] waveform -> (score [B, N], feature maps)."""
        b = x.shape[0]
        x = x[:, None].to(self.dtype)
        fmap = []
        for i in range(self.n):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 s_base: int = 16,
                 p_channels: Sequence[int] = (32, 128, 512, 1024),
                 pair_batch: bool = True, use_spectral_norm: bool = False):
        super().__init__()
        self.pair_batch = pair_batch
        self.names = ["disc_s"] + [f"disc_p{p}" for p in periods]
        self.disc_s = DiscriminatorS(s_base, use_spectral_norm)
        for p in periods:
            self.add_module(f"disc_p{p}", DiscriminatorP(
                p, channels=tuple(p_channels),
                use_spectral_norm=use_spectral_norm))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat: [B, T] real and generated waveforms -> (real_scores,
        fake_scores, real_fmaps, fake_fmaps), one entry per
        sub-discriminator."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        b = y.shape[0]
        with span("model.disc"):
            for name in self.names:
                d = getattr(self, name)
                if self.pair_batch:
                    s, f = d(torch.cat([y, y_hat], 0))
                    sr, sg = s[:b], s[b:]
                    fr, fg = [a[:b] for a in f], [a[b:] for a in f]
                else:
                    (sr, fr), (sg, fg) = d(y), d(y_hat)
                y_d_rs.append(sr)
                y_d_gs.append(sg)
                fmap_rs.append(fr)
                fmap_gs.append(fg)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
