"""The stochastic duration predictor of VITS (jaywalnut310/vits
``models.py::StochasticDurationPredictor``, ``modules.py``,
``transforms.py``), [B, C, T] layout, on token-rate features.

  - ``DDSConv``: dilated depthwise-separable convolutions, layer i with
    dilation kernel_size^i, each followed by a channel LayerNorm (eps
    1e-5), GELU, a 1x1, LayerNorm, GELU and dropout, added to the input;
  - ``ElementwiseAffine``, ``Log`` and ``Flip``: the flows' small steps;
  - ``ConvFlow``: a coupling whose second half goes through a
    rational-quadratic spline of ``num_bins`` bins on [-tail_bound,
    tail_bound] with linear tails, its widths, heights (both over
    sqrt(filter_channels)) and derivatives from a DDSConv of the first
    half.

Training (``forward(..., w)``) returns each item's nll + log q of the
durations ``w`` [B, 1, T_x] under the flows with the posterior flows over
the noise ``e_q`` [B, 2, T_x]; ``reverse=True`` returns log w from noise.
The noise and the dropout masks come from ``generator`` (dropout in
training mode only); ``e_q`` may be given.

The spline is computed on every element with the out-of-interval ones
clamped into it and then replaced by the identity, where upstream gathers
the in-interval elements by a boolean mask: the same arithmetic on the
elements it keeps, with no host synchronisation."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visinger_tpu_torch.modules.common import (ChannelLayerNorm, Conv1d,
                                               dropout)

MIN_BIN_WIDTH = MIN_BIN_HEIGHT = MIN_DERIVATIVE = 1e-3


class DDSConv(nn.Module):
    def __init__(self, channels: int, kernel_size: int, n_layers: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.n_layers = n_layers
        self.p_dropout = p_dropout
        for i in range(n_layers):
            d = kernel_size ** i
            self.add_module(f"sep_{i}", Conv1d(channels, channels,
                                               kernel_size, dilation=d,
                                               groups=channels))
            self.add_module(f"conv_{i}", Conv1d(channels, channels, 1))
            self.add_module(f"norm1_{i}", ChannelLayerNorm(channels, 1e-5))
            self.add_module(f"norm2_{i}", ChannelLayerNorm(channels, 1e-5))

    def forward(self, x, x_mask, g=None, generator=None):
        gen = generator if self.training else None
        if g is not None:
            x = x + g
        for i in range(self.n_layers):
            y = getattr(self, f"sep_{i}")(x * x_mask)
            y = F.gelu(getattr(self, f"norm1_{i}")(y))
            y = getattr(self, f"conv_{i}")(y)
            y = F.gelu(getattr(self, f"norm2_{i}")(y))
            x = x + dropout(y, self.p_dropout, gen)
        return x * x_mask


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, x_mask, g=None, reverse=False):
        if reverse:
            return (x - self.m) * torch.exp(-self.logs) * x_mask
        y = (self.m + torch.exp(self.logs) * x) * x_mask
        return y, torch.sum(self.logs * x_mask, [1, 2])


class Log(nn.Module):
    def forward(self, x, x_mask, g=None, reverse=False):
        if reverse:
            return torch.exp(x) * x_mask
        y = torch.log(torch.clamp_min(x, 1e-5)) * x_mask
        return y, torch.sum(-y, [1, 2])


class Flip(nn.Module):
    def forward(self, x, x_mask, g=None, reverse=False):
        x = torch.flip(x, [1])
        if reverse:
            return x
        return x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)


def _searchsorted(locations, inputs, eps=1e-6):
    """The bin of each input: upstream's count of edges at or below it,
    the last edge raised by ``eps``."""
    edges = torch.cat([locations[..., :-1], locations[..., -1:] + eps], -1)
    return torch.sum(inputs[..., None] >= edges, dim=-1) - 1


def _edges(unnormalized, lo, hi, min_size):
    """(cumulative edges [..., K+1] from lo to hi, sizes [..., K])."""
    k = unnormalized.shape[-1]
    sizes = min_size + (1 - min_size * k) * F.softmax(unnormalized, dim=-1)
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0), value=0.0)
    cum = (hi - lo) * cum + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], hi)], -1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rq_spline(inputs, widths_u, heights_u, derivs_u, inverse: bool,
              tail_bound: float):
    """``piecewise_rational_quadratic_transform`` with linear tails:
    (outputs, log|det|) of ``inputs`` [...] given the unnormalised bin
    widths and heights [..., K] and inner derivatives [..., K-1]."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    x = inputs.clamp(-tail_bound, tail_bound)
    const = float(np.log(np.exp(1 - MIN_DERIVATIVE) - 1))
    derivs_u = F.pad(derivs_u, (1, 1), value=const)
    cumw, widths = _edges(widths_u, -tail_bound, tail_bound, MIN_BIN_WIDTH)
    cumh, heights = _edges(heights_u, -tail_bound, tail_bound,
                           MIN_BIN_HEIGHT)
    derivs = MIN_DERIVATIVE + F.softplus(derivs_u)
    k = widths.shape[-1]
    idx = _searchsorted(cumh if inverse else cumw, x).clamp(0, k - 1)
    idx = idx[..., None]

    def at(t):
        return t.gather(-1, idx)[..., 0]

    in_cumw, in_w = at(cumw), at(widths)
    in_cumh, in_h = at(cumh), at(heights)
    delta = heights / widths
    in_delta = at(delta)
    in_d, in_d1 = at(derivs), derivs[..., 1:].gather(-1, idx)[..., 0]
    slope = in_d + in_d1 - 2 * in_delta
    if inverse:
        rel = x - in_cumh
        a = rel * slope + in_h * (in_delta - in_d)
        b = in_h * in_d - rel * slope
        c = -in_delta * rel
        disc = b.pow(2) - 4 * a * c
        root = (2 * c) / (-b - torch.sqrt(disc))
        out = root * in_w + in_cumw
        theta = root
    else:
        theta = (x - in_cumw) / in_w
    t1mt = theta * (1 - theta)
    denom = in_delta + slope * t1mt
    deriv_num = in_delta.pow(2) * (in_d1 * theta.pow(2)
                                   + 2 * in_delta * t1mt
                                   + in_d * (1 - theta).pow(2))
    lad = torch.log(deriv_num) - 2 * torch.log(denom)
    if inverse:
        lad = -lad
    else:
        out = in_cumh + in_h * (in_delta * theta.pow(2) + in_d * t1mt) \
            / denom
    return (torch.where(inside, out, inputs),
            torch.where(inside, lad, torch.zeros_like(lad)))


class ConvFlow(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, n_layers: int, num_bins: int = 10,
                 tail_bound: float = 5.0):
        super().__init__()
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.half = in_channels // 2
        self.pre = Conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = Conv1d(filter_channels, self.half * (num_bins * 3 - 1),
                           1, init="zeros")
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask, g=None, reverse=False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.convs(self.pre(x0), x_mask, g=g)
        h = self.proj(h) * x_mask
        b, c, t = x0.shape
        h = h.reshape(b, c, -1, t).permute(0, 1, 3, 2)
        k, scale = self.num_bins, math.sqrt(self.filter_channels)
        x1, lad = rq_spline(x1, h[..., :k] / scale, h[..., k:2 * k] / scale,
                            h[..., 2 * k:], reverse, self.tail_bound)
        x = torch.cat([x0, x1], 1) * x_mask
        if reverse:
            return x
        return x, torch.sum(lad * x_mask, [1, 2])


class StochasticDurationPredictor(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float, n_flows: int = 4,
                 gin_channels: int = 0, num_bins: int = 10,
                 tail_bound: float = 5.0):
        super().__init__()
        fc = filter_channels

        def flows(n):
            out = [ElementwiseAffine(2)]
            for _ in range(n):
                out += [ConvFlow(2, fc, kernel_size, 3, num_bins,
                                 tail_bound), Flip()]
            return nn.ModuleList(out)

        self.log_flow = Log()
        self.flows = flows(n_flows)
        self.post_pre = Conv1d(1, fc, 1)
        self.post_proj = Conv1d(fc, fc, 1)
        self.post_convs = DDSConv(fc, kernel_size, 3, p_dropout)
        self.post_flows = flows(4)
        self.pre = Conv1d(in_channels, fc, 1)
        self.proj = Conv1d(fc, fc, 1)
        self.convs = DDSConv(fc, kernel_size, 3, p_dropout)
        if gin_channels:
            self.cond = Conv1d(gin_channels, fc, 1)

    def forward(self, x, x_mask, w=None, g=None, reverse=False,
                noise_scale=1.0, generator=None, e_q=None):
        """x [B, C, T_x] (detached here), x_mask [B, 1, T_x]; training: w
        [B, 1, T_x] -> nll + log q [B]; ``reverse``: -> log w [B, 1, T_x]
        (``e_q`` then the [B, 2, T_x] noise before its scale)."""
        x = self.pre(x.detach())
        if g is not None:
            x = x + self.cond(g.detach())
        x = self.convs(x, x_mask, generator=generator)
        x = self.proj(x) * x_mask
        shape = (x.shape[0], 2, x.shape[2])
        if reverse:
            flows = list(reversed(self.flows))
            flows = flows[:-2] + [flows[-1]]  # no unused affine (upstream)
            z = e_q if e_q is not None else torch.randn(
                shape, generator=generator, device=x.device)
            z = z * noise_scale
            for flow in flows:
                z = flow(z, x_mask, g=x, reverse=True)
            return z[:, :1]
        h_w = self.post_pre(w)
        h_w = self.post_convs(h_w, x_mask, generator=generator)
        h_w = self.post_proj(h_w) * x_mask
        if e_q is None:
            e_q = torch.randn(shape, generator=generator, device=x.device)
        e_q = e_q * x_mask
        z_q, logdet_q = e_q, 0.0
        for flow in self.post_flows:
            z_q, ld = flow(z_q, x_mask, g=x + h_w)
            logdet_q = logdet_q + ld
        z_u, z1 = z_q[:, :1], z_q[:, 1:]
        u = torch.sigmoid(z_u) * x_mask
        z0 = (w - u) * x_mask
        logdet_q = logdet_q + torch.sum(
            (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, [1, 2])
        logq = torch.sum(-0.5 * (math.log(2 * math.pi) + e_q ** 2) * x_mask,
                         [1, 2]) - logdet_q
        z0, logdet = self.log_flow(z0, x_mask)
        z = torch.cat([z0, z1], 1)
        for flow in self.flows:
            z, ld = flow(z, x_mask, g=x)
            logdet = logdet + ld
        nll = torch.sum(0.5 * (math.log(2 * math.pi) + z ** 2) * x_mask,
                        [1, 2]) - logdet
        return nll + logq
