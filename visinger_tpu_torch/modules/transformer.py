"""Relative-position transformer encoder, [B, C, T] layout (counterpart of
the JAX package's ``modules/transformer.py``).

Self-attention with learned relative key/value embeddings in a ±window band
(shared by the heads), a conv FFN (ReLU), channel LayerNorm, post-LN
residual blocks, and optional conditioning g projected once and added
before every layer.  The attention core is kernel K1, and its backward K3
(``ops/rel_attention.py``); the 1x1 projections run as plain matmuls on
[B, T, C], the kernels' layout.

Dropout (``p_dropout``) sits where the JAX stack has it: on the attention
probabilities (inside K1, seeded per call), after the FFN's ReLU, and on each
sublayer's output before the residual add.  It runs in training mode only,
with masks and seeds drawn from the generator passed to ``forward``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from visinger_tpu_torch.modules.common import (ChannelLayerNorm, Conv1d,
                                               dropout)
from visinger_tpu_torch.ops.rel_attention import rel_attention


class RelativeMultiHeadAttention(nn.Module):
    def __init__(self, channels: int, n_heads: int, window_size: int = 4,
                 p_dropout: float = 0.0):
        super().__init__()
        if channels % n_heads:
            raise ValueError(f"channels {channels} not divisible by heads "
                             f"{n_heads}")
        self.window = window_size
        self.p_dropout = p_dropout
        dk = channels // n_heads
        self.scale = 1.0 / math.sqrt(dk)
        self.conv_q = Conv1d(channels, channels, init="xavier")
        self.conv_k = Conv1d(channels, channels, init="xavier")
        self.conv_v = Conv1d(channels, channels, init="xavier")
        self.conv_o = Conv1d(channels, channels)
        self.emb_rel_k = nn.Parameter(
            torch.randn(2 * window_size + 1, dk) * dk ** -0.5)
        self.emb_rel_v = nn.Parameter(
            torch.randn(2 * window_size + 1, dk) * dk ** -0.5)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: [B, C, T]; x_mask: [B, 1, T] prefix mask -> [B, C, T].  With
        a ``generator`` the attention probabilities are dropped at
        ``p_dropout``, from a fresh seed drawn on x's device."""
        xt = x.transpose(1, 2)
        rate, seed = 0.0, None
        if generator is not None and self.p_dropout > 0:
            rate = self.p_dropout
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=x.device, dtype=torch.int32)

        def proj(conv, a):
            return F.linear(a, conv.weight[:, :, 0], conv.bias)

        q, k, v = (proj(conv, xt).contiguous()
                   for conv in (self.conv_q, self.conv_k, self.conv_v))
        out = rel_attention(q, k, v, self.emb_rel_k, self.emb_rel_v,
                            x_mask.transpose(1, 2), window=self.window,
                            scale=self.scale, dropout_rate=rate, seed=seed)
        return proj(self.conv_o, out).transpose(1, 2)


class ConvFFN(nn.Module):
    """Conv k / ReLU / conv 1x1 feed-forward."""

    def __init__(self, channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_1 = Conv1d(channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, channels, 1)

    def forward(self, x, x_mask, generator=None):
        x = torch.relu(self.conv_1(x * x_mask))
        x = dropout(x, self.p_dropout, generator)
        return self.conv_2(x * x_mask)


class RelativeEncoder(nn.Module):
    """Post-LN stack of (relative MHA, conv FFN); ``pre_net(g)`` is added to
    x before every layer when g is given."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 window_size: int = 4, gin_channels: int = 0,
                 p_dropout: float = 0.0):
        super().__init__()
        self.n_layers = n_layers
        self.p_dropout = p_dropout
        if gin_channels:
            self.pre_net = Conv1d(gin_channels, hidden_channels, 1)
        for i in range(n_layers):
            self.add_module(f"attn_{i}", RelativeMultiHeadAttention(
                hidden_channels, n_heads, window_size, p_dropout))
            self.add_module(f"norm1_{i}", ChannelLayerNorm(hidden_channels))
            self.add_module(f"ffn_{i}", ConvFFN(
                hidden_channels, filter_channels, kernel_size, p_dropout))
            self.add_module(f"norm2_{i}", ChannelLayerNorm(hidden_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: [B, C, T]; x_mask: [B, 1, T]; g: [B, gin, 1|T] or None.  In
        training mode with ``p_dropout`` > 0, dropout masks come from
        ``generator``, which must then be given."""
        gen = None
        if self.training and self.p_dropout > 0:
            if generator is None:
                raise ValueError("RelativeEncoder: dropout in training mode "
                                 "needs a generator")
            gen = generator
        if g is not None:
            g = self.pre_net(g)
        for i in range(self.n_layers):
            if g is not None:
                x = x + g
            x = x * x_mask
            y = getattr(self, f"attn_{i}")(x, x_mask, gen)
            y = dropout(y, self.p_dropout, gen)
            x = getattr(self, f"norm1_{i}")(x + y)
            y = getattr(self, f"ffn_{i}")(x, x_mask, gen)
            y = dropout(y, self.p_dropout, gen)
            x = getattr(self, f"norm2_{i}")(x + y)
        return x * x_mask
