"""VISinger encoders on the synthesis path (counterpart of the JAX package's
``modules/encoders.py``): the score encoder, the pitch predictor and the
frame prior.  ``PosteriorEncoder`` and ``PhonemePredictor`` come with the
training slice."""

from __future__ import annotations

import math

import torch
from torch import nn

from visinger_tpu_torch.modules.common import (Conv1d, TokenEmbedding,
                                               positional_embedding)
from visinger_tpu_torch.modules.transformer import RelativeEncoder
from visinger_tpu_torch.ops.expand import expand_states


class TextEncoder(nn.Module):
    """(phoneme, note-pitch, note-duration) token triples -> relative
    transformer -> length-regulated frame-rate features [B, T_frame, H]."""

    def __init__(self, ph_vocab: int, pitch_vocab: int, dur_vocab: int,
                 hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int, window_size: int = 4,
                 use_pos_embed: bool = True):
        super().__init__()
        h = hidden_channels
        self.hidden = h
        self.use_pos_embed = use_pos_embed
        self.ph_emb = TokenEmbedding(ph_vocab, h)
        self.pitch_emb = TokenEmbedding(pitch_vocab, h)
        self.dur_emb = TokenEmbedding(dur_vocab, h)
        self.linear = nn.Linear(3 * h, h)
        bound = (3 * h) ** -0.5
        nn.init.uniform_(self.linear.weight, -bound, bound)
        nn.init.uniform_(self.linear.bias, -bound, bound)
        self.encoder = RelativeEncoder(h, filter_channels, n_heads, n_layers,
                                       kernel_size, window_size)

    def forward(self, text_tokens, pitch_tokens, dur_tokens, mel2ph):
        h = self.hidden
        nonpadding = (text_tokens > 0).float()[..., None]      # [B, N, 1]
        emb = torch.cat([self.ph_emb(text_tokens), self.pitch_emb(pitch_tokens),
                         self.dur_emb(dur_tokens)], dim=-1) * math.sqrt(h)
        x = self.linear(emb) * nonpadding
        if self.use_pos_embed:
            # Token-level positions are scrambled on purpose: the reference
            # builds its table with seq_len = H and views it [B, H, T] before
            # transposing — reproduced as the JAX package does.
            pos = positional_embedding(nonpadding[..., 0], h)
            b, t, _ = pos.shape
            x = x + pos.reshape(b, h, t).transpose(1, 2)
        x = x * nonpadding
        x = self.encoder(x.transpose(1, 2), nonpadding.transpose(1, 2))
        return expand_states(x.transpose(1, 2), mel2ph)


class FramePriorNetwork(nn.Module):
    """Frame-rate prior conditioned on log-f0 -> (mu_p, logs_p) in float32."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int,
                 window_size: int = 4, gin_channels: int = 1):
        super().__init__()
        h = hidden_channels
        self.hidden = h
        self.encoder = RelativeEncoder(h, filter_channels, n_heads, n_layers,
                                       kernel_size, window_size, gin_channels)
        self.proj = Conv1d(h, 2 * h, 1)

    def forward(self, x, x_mask, g=None):
        """x: [B, H, T]; x_mask: [B, 1, T]; g: [B, 1, T] -> 2 x [B, H, T]."""
        x = self.encoder(x, x_mask, g=g)
        stats = (self.proj(x) * x_mask).float()
        return stats[:, :self.hidden], stats[:, self.hidden:]


class PitchPredictor(nn.Module):
    """Relative encoder + 1x1 head -> [B, 2, T] (log-f0, uv logit)."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int,
                 window_size: int = 4, gin_channels: int = 0):
        super().__init__()
        self.encoder = RelativeEncoder(hidden_channels, filter_channels,
                                       n_heads, n_layers, kernel_size,
                                       window_size, gin_channels)
        self.linear = Conv1d(hidden_channels, 2, 1)

    def forward(self, x, x_mask, spk_emb=None):
        return self.linear(self.encoder(x, x_mask, g=spk_emb)).float()
