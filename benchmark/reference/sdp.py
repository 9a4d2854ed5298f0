"""VITS's stochastic duration predictor in plain PyTorch, as upstream
writes it (jaywalnut310/vits ``models.py::StochasticDurationPredictor``,
``modules.py::DDSConv, ElementwiseAffine, Log, Flip, ConvFlow``,
``transforms.py``), [B, C, T] layout.  The spline gathers the elements
inside the tail bound by a boolean mask, as upstream does.

Departures, each for the comparison with the program: the layers are the
reference's ``Conv1d`` and ``ChannelLayerNorm`` (eps 1e-5, upstream's
``modules.LayerNorm``), under the program's parameter names; dropout masks
and the noise e_q come from the generator passed in, in upstream's order
(the encoder's convolutions, the posterior's, then e_q)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import ChannelLayerNorm, Conv1d, dropout

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


class DDSConv(nn.Module):
    def __init__(self, channels, kernel_size, n_layers, p_dropout=0.0):
        super().__init__()
        self.n_layers = n_layers
        self.p_dropout = p_dropout
        for i in range(n_layers):
            dilation = kernel_size ** i
            self.add_module(f"sep_{i}", Conv1d(channels, channels,
                                               kernel_size, dilation=dilation,
                                               groups=channels))
            self.add_module(f"conv_{i}", Conv1d(channels, channels, 1))
            self.add_module(f"norm1_{i}", ChannelLayerNorm(channels, 1e-5))
            self.add_module(f"norm2_{i}", ChannelLayerNorm(channels, 1e-5))

    def forward(self, x, x_mask, g=None, generator=None):
        if g is not None:
            x = x + g
        for i in range(self.n_layers):
            y = getattr(self, f"sep_{i}")(x * x_mask)
            y = getattr(self, f"norm1_{i}")(y)
            y = F.gelu(y)
            y = getattr(self, f"conv_{i}")(y)
            y = getattr(self, f"norm2_{i}")(y)
            y = F.gelu(y)
            y = dropout(y, self.p_dropout,
                        generator if self.training else None)
            x = x + y
        return x * x_mask


class ElementwiseAffine(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, x_mask, reverse=False, **kwargs):
        if not reverse:
            y = self.m + torch.exp(self.logs) * x
            y = y * x_mask
            logdet = torch.sum(self.logs * x_mask, [1, 2])
            return y, logdet
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class Log(nn.Module):
    def forward(self, x, x_mask, reverse=False, **kwargs):
        if not reverse:
            y = torch.log(torch.clamp_min(x, 1e-5)) * x_mask
            logdet = torch.sum(-y, [1, 2])
            return y, logdet
        return torch.exp(x) * x_mask


class Flip(nn.Module):
    def forward(self, x, *args, reverse=False, **kwargs):
        x = torch.flip(x, [1])
        if not reverse:
            logdet = torch.zeros(x.size(0)).to(dtype=x.dtype, device=x.device)
            return x, logdet
        return x


def searchsorted(bin_locations, inputs, eps=1e-6):
    bin_locations[..., -1] += eps
    return torch.sum(inputs[..., None] >= bin_locations, dim=-1) - 1


def unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=False, tail_bound=1.0,
        min_bin_width=DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Linear tails."""
    inside_interval_mask = (inputs >= -tail_bound) & (inputs <= tail_bound)
    outside_interval_mask = ~inside_interval_mask
    outputs = torch.zeros_like(inputs)
    logabsdet = torch.zeros_like(inputs)
    unnormalized_derivatives = F.pad(unnormalized_derivatives, pad=(1, 1))
    constant = np.log(np.exp(1 - min_derivative) - 1)
    unnormalized_derivatives[..., 0] = constant
    unnormalized_derivatives[..., -1] = constant
    outputs[outside_interval_mask] = inputs[outside_interval_mask]
    logabsdet[outside_interval_mask] = 0
    outputs[inside_interval_mask], logabsdet[inside_interval_mask] = \
        rational_quadratic_spline(
            inputs=inputs[inside_interval_mask],
            unnormalized_widths=unnormalized_widths[inside_interval_mask, :],
            unnormalized_heights=unnormalized_heights[inside_interval_mask, :],
            unnormalized_derivatives=unnormalized_derivatives[
                inside_interval_mask, :],
            inverse=inverse, left=-tail_bound, right=tail_bound,
            bottom=-tail_bound, top=tail_bound, min_bin_width=min_bin_width,
            min_bin_height=min_bin_height, min_derivative=min_derivative)
    return outputs, logabsdet


def rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=False, left=0.0, right=1.0,
        bottom=0.0, top=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=DEFAULT_MIN_DERIVATIVE):
    num_bins = unnormalized_widths.shape[-1]
    widths = F.softmax(unnormalized_widths, dim=-1)
    widths = min_bin_width + (1 - min_bin_width * num_bins) * widths
    cumwidths = torch.cumsum(widths, dim=-1)
    cumwidths = F.pad(cumwidths, pad=(1, 0), mode="constant", value=0.0)
    cumwidths = (right - left) * cumwidths + left
    cumwidths[..., 0] = left
    cumwidths[..., -1] = right
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]

    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    heights = F.softmax(unnormalized_heights, dim=-1)
    heights = min_bin_height + (1 - min_bin_height * num_bins) * heights
    cumheights = torch.cumsum(heights, dim=-1)
    cumheights = F.pad(cumheights, pad=(1, 0), mode="constant", value=0.0)
    cumheights = (top - bottom) * cumheights + bottom
    cumheights[..., 0] = bottom
    cumheights[..., -1] = top
    heights = cumheights[..., 1:] - cumheights[..., :-1]

    if inverse:
        bin_idx = searchsorted(cumheights, inputs)[..., None]
    else:
        bin_idx = searchsorted(cumwidths, inputs)[..., None]

    input_cumwidths = cumwidths.gather(-1, bin_idx)[..., 0]
    input_bin_widths = widths.gather(-1, bin_idx)[..., 0]
    input_cumheights = cumheights.gather(-1, bin_idx)[..., 0]
    delta = heights / widths
    input_delta = delta.gather(-1, bin_idx)[..., 0]
    input_derivatives = derivatives.gather(-1, bin_idx)[..., 0]
    input_derivatives_plus_one = derivatives[..., 1:].gather(
        -1, bin_idx)[..., 0]
    input_heights = heights.gather(-1, bin_idx)[..., 0]

    if inverse:
        a = (((inputs - input_cumheights)
              * (input_derivatives + input_derivatives_plus_one
                 - 2 * input_delta)
              + input_heights * (input_delta - input_derivatives)))
        b = (input_heights * input_derivatives
             - (inputs - input_cumheights)
             * (input_derivatives + input_derivatives_plus_one
                - 2 * input_delta))
        c = - input_delta * (inputs - input_cumheights)
        discriminant = b.pow(2) - 4 * a * c
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * input_bin_widths + input_cumwidths
        theta_one_minus_theta = root * (1 - root)
        denominator = input_delta + (
            (input_derivatives + input_derivatives_plus_one
             - 2 * input_delta) * theta_one_minus_theta)
        derivative_numerator = input_delta.pow(2) * (
            input_derivatives_plus_one * root.pow(2)
            + 2 * input_delta * theta_one_minus_theta
            + input_derivatives * (1 - root).pow(2))
        logabsdet = torch.log(derivative_numerator) \
            - 2 * torch.log(denominator)
        return outputs, -logabsdet
    theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    numerator = input_heights * (input_delta * theta.pow(2)
                                 + input_derivatives * theta_one_minus_theta)
    denominator = input_delta + (
        (input_derivatives + input_derivatives_plus_one - 2 * input_delta)
        * theta_one_minus_theta)
    outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta.pow(2) * (
        input_derivatives_plus_one * theta.pow(2)
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta).pow(2))
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, logabsdet


class ConvFlow(nn.Module):
    def __init__(self, in_channels, filter_channels, kernel_size, n_layers,
                 num_bins=10, tail_bound=5.0):
        super().__init__()
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.half_channels = in_channels // 2
        self.pre = Conv1d(self.half_channels, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers,
                             p_dropout=0.0)
        self.proj = Conv1d(filter_channels,
                           self.half_channels * (num_bins * 3 - 1), 1)

    def forward(self, x, x_mask, g=None, reverse=False):
        x0, x1 = torch.split(x, [self.half_channels] * 2, 1)
        h = self.pre(x0)
        h = self.convs(h, x_mask, g=g)
        h = self.proj(h) * x_mask
        b, c, t = x0.shape
        h = h.reshape(b, c, -1, t).permute(0, 1, 3, 2)
        unnormalized_widths = h[..., :self.num_bins] \
            / math.sqrt(self.filter_channels)
        unnormalized_heights = h[..., self.num_bins:2 * self.num_bins] \
            / math.sqrt(self.filter_channels)
        unnormalized_derivatives = h[..., 2 * self.num_bins:]
        x1, logabsdet = unconstrained_rational_quadratic_spline(
            x1, unnormalized_widths, unnormalized_heights,
            unnormalized_derivatives, inverse=reverse,
            tail_bound=self.tail_bound)
        x = torch.cat([x0, x1], 1) * x_mask
        logdet = torch.sum(logabsdet * x_mask, [1, 2])
        if not reverse:
            return x, logdet
        return x


class StochasticDurationPredictor(nn.Module):
    def __init__(self, in_channels, filter_channels, kernel_size, p_dropout,
                 n_flows=4, num_bins=10, tail_bound=5.0):
        super().__init__()
        self.log_flow = Log()
        self.flows = nn.ModuleList()
        self.flows.append(ElementwiseAffine(2))
        for _ in range(n_flows):
            self.flows.append(ConvFlow(2, filter_channels, kernel_size, 3,
                                       num_bins, tail_bound))
            self.flows.append(Flip())
        self.post_pre = Conv1d(1, filter_channels, 1)
        self.post_proj = Conv1d(filter_channels, filter_channels, 1)
        self.post_convs = DDSConv(filter_channels, kernel_size, 3, p_dropout)
        self.post_flows = nn.ModuleList()
        self.post_flows.append(ElementwiseAffine(2))
        for _ in range(4):
            self.post_flows.append(ConvFlow(2, filter_channels, kernel_size,
                                            3, num_bins, tail_bound))
            self.post_flows.append(Flip())
        self.pre = Conv1d(in_channels, filter_channels, 1)
        self.proj = Conv1d(filter_channels, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, 3, p_dropout)

    def forward(self, x, x_mask, w=None, reverse=False, noise_scale=1.0,
                generator=None, e_q=None):
        x = torch.detach(x)
        x = self.pre(x)
        x = self.convs(x, x_mask, generator=generator)
        x = self.proj(x) * x_mask
        if not reverse:
            flows = self.flows
            logdet_tot_q = 0
            h_w = self.post_pre(w)
            h_w = self.post_convs(h_w, x_mask, generator=generator)
            h_w = self.post_proj(h_w) * x_mask
            if e_q is None:
                e_q = torch.randn(w.size(0), 2, w.size(2),
                                  generator=generator, device=x.device)
            e_q = e_q.to(dtype=x.dtype) * x_mask
            z_q = e_q
            for flow in self.post_flows:
                z_q, logdet_q = flow(z_q, x_mask, g=(x + h_w))
                logdet_tot_q += logdet_q
            z_u, z1 = torch.split(z_q, [1, 1], 1)
            u = torch.sigmoid(z_u) * x_mask
            z0 = (w - u) * x_mask
            logdet_tot_q += torch.sum(
                (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, [1, 2])
            logq = torch.sum(-0.5 * (math.log(2 * math.pi) + (e_q ** 2))
                             * x_mask, [1, 2]) - logdet_tot_q
            logdet_tot = 0
            z0, logdet = self.log_flow(z0, x_mask)
            logdet_tot += logdet
            z = torch.cat([z0, z1], 1)
            for flow in flows:
                z, logdet = flow(z, x_mask, g=x, reverse=reverse)
                logdet_tot = logdet_tot + logdet
            nll = torch.sum(0.5 * (math.log(2 * math.pi) + (z ** 2))
                            * x_mask, [1, 2]) - logdet_tot
            return nll + logq
        flows = list(reversed(self.flows))
        flows = flows[:-2] + [flows[-1]]
        z = (e_q if e_q is not None else torch.randn(
            x.size(0), 2, x.size(2), generator=generator,
            device=x.device)) * noise_scale
        for flow in flows:
            z = flow(z, x_mask, g=x, reverse=reverse)
        z0, z1 = torch.split(z, [1, 1], 1)
        return z0
