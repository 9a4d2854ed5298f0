"""VISinger encoders (counterpart of the JAX package's
``modules/encoders.py``): the score encoder, the pitch predictor, the frame
prior, the posterior encoder and the phoneme (CTC) predictor.  ``generator``
arguments carry the dropout masks in training mode (see
``modules/transformer.py``) and the posterior's noise."""

from __future__ import annotations

import math

import torch
from torch import nn

from visinger_tpu_torch.modules.common import (Conv1d, TokenEmbedding,
                                               positional_embedding)
from visinger_tpu_torch.modules.transformer import RelativeEncoder
from visinger_tpu_torch.modules.wavenet import WaveNet
from visinger_tpu_torch.ops.expand import expand_states


class TextEncoder(nn.Module):
    """(phoneme, note-pitch, note-duration) token triples -> relative
    transformer -> length-regulated frame-rate features [B, T_frame, H]."""

    def __init__(self, ph_vocab: int, pitch_vocab: int, dur_vocab: int,
                 hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int, window_size: int = 4,
                 use_pos_embed: bool = True, p_dropout: float = 0.0):
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
                                       kernel_size, window_size,
                                       p_dropout=p_dropout)

    def forward(self, text_tokens, pitch_tokens, dur_tokens, mel2ph,
                generator=None):
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
        x = self.encoder(x.transpose(1, 2), nonpadding.transpose(1, 2),
                         generator=generator)
        return expand_states(x.transpose(1, 2), mel2ph)


class FramePriorNetwork(nn.Module):
    """Frame-rate prior conditioned on log-f0 -> (mu_p, logs_p) in float32."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int,
                 window_size: int = 4, gin_channels: int = 1,
                 p_dropout: float = 0.0):
        super().__init__()
        h = hidden_channels
        self.hidden = h
        self.encoder = RelativeEncoder(h, filter_channels, n_heads, n_layers,
                                       kernel_size, window_size, gin_channels,
                                       p_dropout)
        self.proj = Conv1d(h, 2 * h, 1)

    def forward(self, x, x_mask, g=None, generator=None):
        """x: [B, H, T]; x_mask: [B, 1, T]; g: [B, 1, T] -> 2 x [B, H, T]."""
        x = self.encoder(x, x_mask, g=g, generator=generator)
        stats = (self.proj(x) * x_mask).float()
        return stats[:, :self.hidden], stats[:, self.hidden:]


class PitchPredictor(nn.Module):
    """Relative encoder + 1x1 head -> [B, 2, T] (log-f0, uv logit)."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int,
                 window_size: int = 4, gin_channels: int = 0,
                 p_dropout: float = 0.0):
        super().__init__()
        self.encoder = RelativeEncoder(hidden_channels, filter_channels,
                                       n_heads, n_layers, kernel_size,
                                       window_size, gin_channels, p_dropout)
        self.linear = Conv1d(hidden_channels, 2, 1)

    def forward(self, x, x_mask, spk_emb=None, generator=None):
        return self.linear(self.encoder(x, x_mask, g=spk_emb,
                                        generator=generator)).float()


class PosteriorEncoder(nn.Module):
    """Linear spectrogram -> ``pre`` 1x1 -> WaveNet (kernel K2) -> ``proj``
    -> (z_q, mu_q, logs_q), float32 stats; |logs_q| is clamped to
    ``logs_clamp`` before sampling when it is > 0."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int, kernel_size: int = 5,
                 n_layers: int = 16, gin_channels: int = 0,
                 logs_clamp: float = 0.0):
        super().__init__()
        self.out_channels = out_channels
        self.logs_clamp = logs_clamp
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WaveNet(hidden_channels, kernel_size, n_layers,
                           gin_channels)
        self.proj = Conv1d(hidden_channels, 2 * out_channels, 1)

    def forward(self, x, x_mask, g=None, eps=None, generator=None):
        """x: [B, C_in, T]; x_mask: [B, 1, T]; g: [B, gin, 1] or None; eps
        [B, out, T] is the noise, drawn from ``generator`` when None.
        Returns 3 x [B, out, T]."""
        h = self.pre(x) * x_mask
        h = self.enc(h, x_mask, g=g)
        stats = (self.proj(h) * x_mask).float()
        mu_q, logs_q = stats.split(self.out_channels, dim=1)
        if self.logs_clamp > 0:
            logs_q = logs_q.clamp(-self.logs_clamp, self.logs_clamp)
        if eps is None:
            eps = torch.randn(mu_q.shape, generator=generator,
                              device=mu_q.device)
        z_q = (mu_q + eps * torch.exp(logs_q)) * x_mask
        return z_q, mu_q, logs_q


class PhonemePredictor(nn.Module):
    """CTC head on z_q: relative encoder + 1x1 -> float32 log-softmax over
    the vocabulary, [B, V, T]."""

    def __init__(self, vocab_size: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, window_size: int = 4,
                 p_dropout: float = 0.0):
        super().__init__()
        self.encoder = RelativeEncoder(hidden_channels, filter_channels,
                                       n_heads, n_layers, kernel_size,
                                       window_size, p_dropout=p_dropout)
        self.ph_proj = Conv1d(hidden_channels, vocab_size, 1)

    def forward(self, x, x_mask, generator=None):
        logits = self.ph_proj(self.encoder(x, x_mask, generator=generator))
        return torch.log_softmax(logits.float(), dim=1)
