"""Differentiable STFT / log-mel spectrogram (counterpart of the JAX
package's ``ops/stft.py``), in two kinds (``STFTParams.kind``, the
config's ``model``):

  - "visinger": center-padded reflect STFT with a periodic Hann window
    zero-padded to n_fft, power-2 magnitude, HTK mel scale with no
    filterbank norm, ``log(mel + 1e-3)`` and the trailing-frame drop;
  - "vits" (jaywalnut310/vits ``mel_processing.py``): a reflect pad of
    (n_fft - hop) / 2 each side and no centering, so L = T·hop samples give
    T frames; magnitude sqrt(power + 1e-6), Slaney mel with Slaney norm,
    ``log(clamp(mel, 1e-5))``.

The DFT is a matmul against window-folded cosine/sine matrices, as in the
JAX package, so both compute the same sums.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from visinger_tpu_torch.ops.mel_filters import (hann_window, mel_filterbank,
                                                mel_filterbank_slaney)


def _dft_matrices(n_fft: int, win_length: int) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """Window-folded real-DFT matrices [n_fft, n_fft//2 + 1]; the angle is
    reduced with the integer ``(n*k) mod n_fft`` first."""
    n_bins = n_fft // 2 + 1
    window = np.zeros(n_fft, dtype=np.float64)
    lpad = (n_fft - win_length) // 2
    window[lpad:lpad + win_length] = hann_window(win_length)
    nk = (np.arange(n_fft)[:, None] * np.arange(n_bins)[None, :]) % n_fft
    ang = 2.0 * np.pi * nk / n_fft
    return ((window[:, None] * np.cos(ang)).astype(np.float32),
            (window[:, None] * np.sin(ang)).astype(np.float32))


class STFTParams:
    """The constants of one STFT / mel configuration, as tensors on
    ``device`` (built once, reused by every call) and as numpy arrays
    (``cos_m``, ``sin_m``, ``mel_fb_np``) for the ``*_np`` functions."""

    def __init__(self, n_fft: int, win_length: int, hop_length: int,
                 sample_rate: int = 24000, f_min: float = 20.0,
                 f_max: float | None = 12000.0, n_mels: int = 128,
                 device="cpu", kind: str = "visinger"):
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.kind = kind
        self.vits = kind == "vits"
        self.pad = (n_fft - hop_length) // 2 if self.vits else n_fft // 2
        self.n_bins = n_bins = n_fft // 2 + 1
        self.cos_m, self.sin_m = _dft_matrices(n_fft, win_length)
        if self.vits:
            self.mel_fb_np = mel_filterbank_slaney(n_fft, f_min, f_max,
                                                   n_mels, sample_rate)
        else:
            self.mel_fb_np = mel_filterbank(n_bins, f_min, f_max, n_mels,
                                            sample_rate)
        # [n_fft, 2 * n_bins]: real parts, then imaginary parts
        self.dft = torch.from_numpy(np.concatenate(
            [self.cos_m, self.sin_m], 1)).to(device)
        self.mel_fb = torch.from_numpy(self.mel_fb_np).to(device)

    @classmethod
    def from_config(cls, cfg, device="cpu") -> "STFTParams":
        return cls(cfg.fft_size, cfg.win_size, cfg.hop_size, cfg.sample_rate,
                   float(cfg.fmin),
                   None if cfg.fmax is None else float(cfg.fmax),
                   cfg.num_mel_bins, device, cfg.model)


def _power(frames: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """[B, F, n_fft] frames -> [B, F, n_bins] power."""
    y = frames @ params.dft
    re, im = y.chunk(2, dim=-1)
    return re * re + im * im


def _frames(x: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """Reflect-pad ``params.pad`` each side and frame: [B, L] -> [B, F,
    n_fft] (F = 1 + L//hop for "visinger", L//hop for "vits")."""
    pad = params.pad
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    return xp.unfold(1, params.n_fft, params.hop_length)


def _trim(x: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """The trailing-frame drop of the "visinger" kind."""
    return x if params.vits else x[:, :-1]


def _log_mel(power: torch.Tensor, params: STFTParams) -> torch.Tensor:
    if params.vits:
        mel = torch.sqrt(power + 1e-6) @ params.mel_fb
        return torch.log(torch.clamp(mel, min=1e-5))
    return torch.log(power @ params.mel_fb + 1e-3)


def power_spectrogram(x: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """[B, L] waveform -> [B, T, n_bins] power spectrogram (the trailing
    frame dropped for "visinger")."""
    return _trim(_power(_frames(x, params), params), params)


def linear_spectrogram(x: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """The posterior's input, [B, L] -> [B, T, n_bins]: the power
    spectrogram for "visinger", the magnitude sqrt(power + 1e-6) for
    "vits"."""
    power = power_spectrogram(x, params)
    return torch.sqrt(power + 1e-6) if params.vits else power


def log_mel_spectrogram(x: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """[B, L] waveform -> [B, T, n_mels] log-mel of the kind."""
    return _trim(_log_mel(_power(_frames(x, params), params), params),
                 params)


def log_mel_slices(x: torch.Tensor, ids_frame: torch.Tensor, seg: int,
                   params: STFTParams) -> torch.Tensor:
    """Log-mel of ``seg`` frames from per-item frame ``ids_frame``: the whole
    wav is reflect-padded first and then sliced, so the frames equal those
    of ``log_mel_spectrogram(x)[:, ids:ids+seg]``.  x [B, L] -> [B, seg,
    n_mels]."""
    n_fft, hop = params.n_fft, params.hop_length
    pad = params.pad
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    length = (seg - 1) * hop + n_fft
    idx = ids_frame.long()[:, None] * hop + torch.arange(length,
                                                         device=x.device)
    seg_wav = torch.gather(xp, 1, idx)
    return _log_mel(_power(seg_wav.unfold(1, n_fft, hop), params), params)


def power_spectrogram_np(x: np.ndarray, params: STFTParams) -> np.ndarray:
    """numpy: [L] waveform -> [F-1, n_bins] power spectrogram."""
    pad = params.n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(xp) - params.n_fft) // params.hop_length
    idx = (np.arange(n_frames)[:, None] * params.hop_length
           + np.arange(params.n_fft))
    frames = xp[idx]
    re = frames @ params.cos_m
    im = frames @ params.sin_m
    return (re * re + im * im)[:-1]


def log_mel_spectrogram_np(x: np.ndarray, params: STFTParams) -> np.ndarray:
    """numpy: [L] waveform -> [F-1, n_mels] log(mel + 1e-3)."""
    return np.log(power_spectrogram_np(x, params) @ params.mel_fb_np + 1e-3)
