"""The gated WaveNet stack in plain PyTorch: a frozen copy of the port's
plain version (``wavenet_stack_plain``), layer by layer through
``F.conv1d``; the gradient is autograd's."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _bias(b_in, g_bias, batch):
    """Conv bias plus per-(item, layer) conditioning -> [B, L, 2C]."""
    g_all = b_in[None].expand(batch, -1, -1)
    return g_all if g_bias is None else g_all + g_bias


def wavenet_stack_plain(x, w_in, b_in, w_rs, b_rs, g_bias, mask):
    """The same function in plain PyTorch, the counterpart of the JAX
    ``_stack_forward_xla``.

    x [B, T, C]; w_in [L, K, C, 2C]; b_in [L, 2C]; w_rs [L, C, 2C] (the last
    layer's skip weights in columns [C:2C)); b_rs [L, 2C]; g_bias [B, L, 2C]
    or None; mask [B, T, 1].  Returns the skip sum [B, T, C] (unmasked).
    """
    n_layers, k, c, _ = w_in.shape
    g_all = _bias(b_in, g_bias, x.shape[0])
    h = x.float().transpose(1, 2)                    # [B, C, T]
    m = mask.float().transpose(1, 2)                 # [B, 1, T]
    out = torch.zeros_like(h)
    for i in range(n_layers):
        a = F.conv1d(h, w_in[i].permute(2, 1, 0), padding=k // 2)
        a = a + g_all[:, i, :, None]
        z = torch.tanh(a[:, :c]) * torch.sigmoid(a[:, c:])
        rs = torch.einsum("bct,cd->bdt", z, w_rs[i]) + b_rs[i][None, :, None]
        if i < n_layers - 1:
            h = (h + rs[:, :c]) * m
        out = out + rs[:, c:]
    return out.transpose(1, 2)


def wavenet_stack(x, w_in, b_in, w_rs, b_rs, g_bias, mask):
    """The stack's skip sum; arguments as in ``wavenet_stack_plain``."""
    return wavenet_stack_plain(x, w_in, b_in, w_rs, b_rs, g_bias, mask)
