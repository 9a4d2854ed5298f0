"""Shared layers, [B, C, T] layout (counterpart of the JAX package's
``modules/common.py``).

  - ``Conv1d`` / ``ConvTranspose1d`` with torch "same" padding and an
    explicit weight norm g·v/sqrt(Σv² + 1e-12) over every axis but the
    out-feature (``torch.nn.utils.weight_norm`` on a transposed conv
    normalises per *input* channel, the wrong axis);
  - ``ChannelLayerNorm`` (eps 1e-4, float32 statistics);
  - ``TokenEmbedding`` (row 0 zero, N(0, H^-0.5));
  - sinusoidal positions from the nonpadding cumsum.

Initialisers reproduce the JAX package's torch-default ones:
U(±1/sqrt(fan_in)) for kernels and biases, fan = k·out for a transposed
conv's kernel and bias, and weight-norm g = ||v|| at init.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def torch_conv_pad(kernel_size: int, dilation: int = 1) -> int:
    """Length-preserving pad for odd kernels."""
    return (kernel_size * dilation - dilation) // 2


def _weight_norm(v: torch.Tensor, g: torch.Tensor, out_dim: int) -> torch.Tensor:
    dims = [d for d in range(v.dim()) if d != out_dim]
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12)
    shape = [1] * v.dim()
    shape[out_dim] = -1
    return v * (g.reshape(shape) / norm)


def _init_weight_norm(module: nn.Module, v: torch.Tensor, out_dim: int):
    dims = [d for d in range(v.dim()) if d != out_dim]
    module.weight_v = nn.Parameter(v)
    module.weight_g = nn.Parameter(
        torch.sqrt(torch.sum(v * v, dim=dims) + 1e-12))


class Conv1d(nn.Module):
    """1-D convolution on [B, C, T]; weight [out, in, k].

    ``init``: "torch" (U(±1/sqrt(in·k))), "xavier" (xavier-uniform, the
    attention projections) or "zeros" (the flow's ``post``); the bias is
    always U(±1/sqrt(in·k)).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, dilation: int = 1, bias: bool = True,
                 weight_norm: bool = False, init: str = "torch"):
        super().__init__()
        self.dilation = dilation
        self.padding = torch_conv_pad(kernel_size, dilation)
        self.weight_norm = weight_norm
        fan_in = in_channels * kernel_size
        v = torch.empty(out_channels, in_channels, kernel_size)
        if init == "torch":
            nn.init.uniform_(v, -fan_in ** -0.5, fan_in ** -0.5)
        elif init == "xavier":
            nn.init.xavier_uniform_(v)
        elif init == "zeros":
            nn.init.zeros_(v)
        else:
            raise ValueError(f"Conv1d: unknown init {init!r}")
        if weight_norm:
            _init_weight_norm(self, v, 0)
        else:
            self.weight = nn.Parameter(v)
        self.bias = nn.Parameter(
            torch.empty(out_channels).uniform_(-fan_in ** -0.5,
                                               fan_in ** -0.5)) \
            if bias else None

    def effective_weight(self) -> torch.Tensor:
        if self.weight_norm:
            return _weight_norm(self.weight_v, self.weight_g, 0)
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.effective_weight(), self.bias,
                        padding=self.padding, dilation=self.dilation)


class ConvTranspose1d(nn.Module):
    """``F.conv_transpose1d(stride=u, padding=(k-u)//2)``: length T -> T·u.

    Weight [in, out, k] is the JAX kernel [k, in, out] permuted (1, 2, 0)
    with no flip: the JAX package flips only because it lowers the op to an
    lhs-dilated convolution."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int):
        super().__init__()
        self.stride = stride
        self.padding = (kernel_size - stride) // 2
        bound = (kernel_size * out_channels) ** -0.5
        v = torch.empty(in_channels, out_channels, kernel_size)
        nn.init.uniform_(v, -bound, bound)
        _init_weight_norm(self, v, 1)
        self.bias = nn.Parameter(
            torch.empty(out_channels).uniform_(-bound, bound))

    def effective_weight(self) -> torch.Tensor:
        return _weight_norm(self.weight_v, self.weight_g, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.effective_weight(), self.bias,
                                  stride=self.stride, padding=self.padding)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, C, T], eps 1e-4, statistics in
    float32."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = (xf - mean).square().mean(dim=1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.gamma[:, None] + self.beta[:, None]).to(x.dtype)


class TokenEmbedding(nn.Embedding):
    """Embedding with a zero row 0 (padding) and N(0, H^-0.5) init."""

    def __init__(self, vocab_size: int, features: int):
        super().__init__(vocab_size, features)
        with torch.no_grad():
            self.weight.normal_(0.0, features ** -0.5)
            self.weight[0] = 0.0


def sinusoidal_table(num_positions: int, dim: int) -> np.ndarray:
    """tensor2tensor-style sin/cos table with zeroed row 0 (padding):
    concat(sin, cos) halves, not interleaved."""
    half = dim // 2
    scale = math.log(10000) / (half - 1)
    freqs = np.exp(np.arange(half, dtype=np.float64) * -scale)
    ang = np.arange(num_positions, dtype=np.float64)[:, None] * freqs[None, :]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((num_positions, 1))], axis=1)
    emb[0, :] = 0.0
    return emb.astype(np.float32)


def positional_embedding(nonpadding: torch.Tensor, dim: int) -> torch.Tensor:
    """[B, T] mask -> [B, T, dim] sinusoidal embeddings; positions are the
    cumsum of the mask, so padding gets position 0 and a zero embedding."""
    half = dim // 2
    scale = math.log(10000) / (half - 1)
    freqs = torch.from_numpy(
        np.exp(np.arange(half) * -scale).astype(np.float32)).to(
            nonpadding.device)
    mask = (nonpadding > 0).to(torch.int32)
    positions = torch.cumsum(mask, dim=1) * mask
    ang = positions.float()[..., None] * freqs
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb * (positions != 0)[..., None]
