"""Streaming (chunked) synthesis (counterpart of the JAX package's
``infer/streaming.py``).

The infer path splits at the prior latent z_p (``VISinger.infer_prior`` /
``decode_frames``):

- the global stage (text encoder, pitch predictor, frame prior: the
  attention layers that need the whole score, K1) runs once on the padded
  batch;
- the local tail (flow reverse, K2, and the HiFi-GAN decoder: convolutions
  with a finite receptive field) runs window by window, each window
  ``chunk + 2·halo`` frames, so the waveform-rate activations take memory
  that does not grow with the score, and the first audio is ready after one
  window.

Exactness: every conv in the tail is same-padded and shift-equivariant, so
a sample computed inside a window equals the full-length decode's sample as
long as the window carries the tail's receptive field; ``halo_frames(cfg)``
is a conservative analytic bound on that radius.  Windows are clamped to lie
inside the score, so a window edge only ever falls on a true score edge,
where the window's own zero padding is the full decode's boundary.
"""

from __future__ import annotations

import math

import torch

from visinger_tpu_torch.config import Config, check_supported
from visinger_tpu_torch.models.factory import resolve_device


def flow_halo_frames(cfg: Config) -> int:
    """Receptive radius (frames) of the flow in reverse: each of
    ``flow_n_flows`` couplings runs a ``flow_wn_layers``-layer WaveNet of
    kernel ``flow_wn_kernel``, dilation 1 — radius layers·(k//2) per
    coupling; couplings compose, radii add."""
    k = int(cfg.flow_wn_kernel)
    per_coupling = sum(k // 2 for _ in range(int(cfg.flow_wn_layers)))
    return int(cfg.flow_n_flows) * per_coupling


def decoder_halo_frames(cfg: Config) -> int:
    """Receptive radius of the HiFi-GAN generator in input frames
    (conservative: the transposed convs' share rounded up): conv_pre (k7) +
    per stage [ConvT(k, u) + MRF resblocks] + conv_post (k7), each stage's
    radius taken at its own rate and divided by the upsampling so far."""
    r_frames = 7 // 2  # conv_pre at frame rate
    rate = 1
    res_type = str(cfg.dec_blocks)
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        prev_rate = rate
        rate *= int(u)
        # ConvT(k, u, pad (k-u)//2): an output sample depends on inputs
        # within ceil(k/u) of its source position at the previous rate
        r_frames += math.ceil(int(k) / int(u)) / prev_rate
        # MRF = mean of parallel resblocks -> the widest branch; ResBlock1
        # runs conv(d) + conv(1) per dilation, ResBlock2 conv(d) only
        rb = 0
        for rk, rd in zip(cfg.dec_kernel_size, cfg.dec_dilation_sizes):
            span = sum(int(x) for x in rd)
            if res_type == "1":
                span += len(rd)
            rb = max(rb, (int(rk) // 2) * span)
        r_frames += rb / rate
    r_frames += (7 // 2) / rate  # conv_post at waveform rate
    return math.ceil(r_frames)


def halo_frames(cfg: Config) -> int:
    """Total one-sided halo (frames) for exact chunked decoding."""
    return flow_halo_frames(cfg) + decoder_halo_frames(cfg)


class StreamingSynthesizer:
    """Chunked decode over a model's ``decode_frames``.

    ``decode(z_p, mask)`` takes the full-length prior latent and returns the
    waveform [B, T*hop], decoding ``chunk_frames`` frames per window of
    ``chunk_frames + 2·halo`` frames, with the model on ``device``."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 chunk_frames: int | None = None, halo: int | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        self.model = model.to(self.device).eval()
        self.hop = int(cfg.hop_size)
        self.chunk = int(chunk_frames or cfg.stream_chunk_frames)
        self.halo = int(halo if halo is not None else halo_frames(cfg))
        if self.chunk < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {self.chunk}")

    @property
    def window(self) -> int:
        return self.chunk + 2 * self.halo

    @torch.no_grad()
    def synthesize(self, batch: dict, eps: torch.Tensor) -> torch.Tensor:
        """The prior once on the padded batch (tensors on the model's
        device: text_tokens, note_pitch, note_dur, mel2ph, spk_ids), then the
        chunked tail; ``eps`` [B, T, H] is the prior noise.  -> [B, T*hop]."""
        z_p, mask = self.model.infer_prior(
            batch["text_tokens"], batch["note_pitch"], batch["note_dur"],
            batch["mel2ph"], spk_id=batch["spk_ids"], eps=eps)
        return self.decode(z_p, mask, spk_id=batch["spk_ids"])

    @torch.no_grad()
    def decode(self, z_p: torch.Tensor, mask: torch.Tensor,
               spk_id: torch.Tensor | None = None) -> torch.Tensor:
        """z_p [B, T, H], mask [B, T, 1] -> waveform [B, T*hop] equal to
        ``model.decode_frames`` on the full length.

        Windows are clamped inside the score: a window edge only ever falls
        on a true score edge.  (Zero-padding a halo instead is not the same:
        conv biases make every layer's output nonzero on zero input, while
        the full decode zero-pads each layer's own input at the edge.)  A
        score no longer than one window is padded with masked frames to the
        window, as the JAX package pads it to its one chunk shape."""
        b, t, _h = z_p.shape
        halo, chunk, hop, window = self.halo, self.chunk, self.hop, \
            self.window
        if spk_id is None:
            spk_id = torch.zeros(b, dtype=torch.long, device=z_p.device)
        decode = self.model.decode_frames
        if t <= window:
            pad = (0, 0, 0, window - t)
            wav = decode(torch.nn.functional.pad(z_p, pad),
                         torch.nn.functional.pad(mask, pad), spk_id=spk_id)
            return wav[:, :t * hop]
        outs = []
        for s in range(0, t, chunk):
            e = min(s + chunk, t)
            w0 = min(max(s - halo, 0), t - window)
            wav = decode(z_p[:, w0:w0 + window], mask[:, w0:w0 + window],
                         spk_id=spk_id)
            outs.append(wav[:, (s - w0) * hop:(e - w0) * hop])
        return torch.cat(outs, dim=1)

    def n_windows(self, t: int) -> int:
        """Windows ``decode`` runs for a score of ``t`` frames."""
        return 1 if t <= self.window else math.ceil(t / self.chunk)
