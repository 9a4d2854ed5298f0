"""Non-causal gated WaveNet stack, [B, C, T] layout (a frozen plain copy of
the PyTorch port's ``modules/wavenet.py``).

The parameters are those of the JAX module (weight-norm ``in_i`` C->2C,
``res_skip_i`` C->2C or C->C for the last layer, ``cond_layer``
gin->2C·L).  The forward assembles them the way
``fused_forward_from_params`` does and runs kernel K2
(``ops/wavenet_stack.py``): ``cond_layer(g)`` gives a per-layer bias
[B, L, 2C], and the last layer's C->C skip conv sits in the skip half of a
zero-padded [C, 2C].  Dilation is 1, as everywhere in VISinger.

K2 computes in float32 whatever the compute dtype, as the TPU kernel does:
in a bf16 model the conditioning conv runs in bf16, the activations are cast
to float32 at K2's edge and its output back to bf16.  (The JAX package's
bf16 training step runs this stack as bf16 XLA convolutions instead.)
"""

from __future__ import annotations

import torch
from torch import nn

from .common import Conv1d
from .wavenet_stack import wavenet_stack


class WaveNet(nn.Module):
    dtype = torch.float32

    def __init__(self, hidden_channels: int, kernel_size: int = 5,
                 n_layers: int = 4, gin_channels: int = 0):
        super().__init__()
        c = hidden_channels
        self.n_layers = n_layers
        if gin_channels:
            self.cond_layer = Conv1d(gin_channels, 2 * c * n_layers, 1,
                                     weight_norm=True)
        for i in range(n_layers):
            self.add_module(f"in_{i}", Conv1d(c, 2 * c, kernel_size,
                                              weight_norm=True))
            out = 2 * c if i < n_layers - 1 else c
            self.add_module(f"res_skip_{i}", Conv1d(c, out, 1,
                                                    weight_norm=True))

    def stack_weights(self):
        """(w_in [L, K, C, 2C], b_in [L, 2C], w_rs [L, C, 2C], b_rs [L, 2C])
        with the last layer's skip-only conv in columns [C:2C)."""
        convs_in = [getattr(self, f"in_{i}") for i in range(self.n_layers)]
        w_in = torch.stack([conv.effective_weight().permute(2, 1, 0)
                            for conv in convs_in])
        b_in = torch.stack([conv.bias for conv in convs_in])
        w_rs, b_rs = [], []
        for i in range(self.n_layers):
            conv = getattr(self, f"res_skip_{i}")
            w = conv.effective_weight()[:, :, 0].t()      # [C, out]
            bias = conv.bias
            if i == self.n_layers - 1:
                w = torch.cat([torch.zeros_like(w), w], dim=1)
                bias = torch.cat([torch.zeros_like(bias), bias])
            w_rs.append(w)
            b_rs.append(bias)
        return w_in, b_in, torch.stack(w_rs), torch.stack(b_rs)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: torch.Tensor | None = None) -> torch.Tensor:
        """x: [B, C, T]; x_mask: [B, 1, T]; g: [B, gin, 1] or None."""
        b, c, _ = x.shape
        w_in, b_in, w_rs, b_rs = self.stack_weights()
        g_bias = None
        if g is not None:
            g_bias = self.cond_layer(g)[..., 0].float().reshape(
                b, self.n_layers, 2 * c)
        mask = x_mask.float()
        out = wavenet_stack(x.float().transpose(1, 2).contiguous(), w_in,
                            b_in, w_rs, b_rs, g_bias,
                            mask.transpose(1, 2).contiguous())
        return (out.transpose(1, 2) * mask).to(self.dtype)
