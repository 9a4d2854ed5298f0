"""Differentiable STFT / log-mel spectrogram (a frozen plain copy of the
PyTorch port's ``ops/stft.py``).

Center-padded reflect STFT with a periodic Hann window zero-padded to n_fft,
power-2 magnitude, HTK mel scale with no filterbank norm, ``log(mel + 1e-3)``
and the trailing-frame drop.  The DFT is a matmul against window-folded
cosine/sine matrices, as in the JAX package, so both compute the same sums.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .mel_filters import hann_window, mel_filterbank


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
                 f_max: float = 12000.0, n_mels: int = 128, device="cpu"):
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.n_bins = n_bins = n_fft // 2 + 1
        self.cos_m, self.sin_m = _dft_matrices(n_fft, win_length)
        self.mel_fb_np = mel_filterbank(n_bins, f_min, f_max, n_mels,
                                        sample_rate)
        # [n_fft, 2 * n_bins]: real parts, then imaginary parts
        self.dft = torch.from_numpy(np.concatenate(
            [self.cos_m, self.sin_m], 1)).to(device)
        self.mel_fb = torch.from_numpy(self.mel_fb_np).to(device)

    @classmethod
    def from_config(cls, cfg, device="cpu") -> "STFTParams":
        return cls(cfg.fft_size, cfg.win_size, cfg.hop_size, cfg.sample_rate,
                   float(cfg.fmin), float(cfg.fmax), cfg.num_mel_bins, device)


def _power(frames: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """[B, F, n_fft] frames -> [B, F, n_bins] power."""
    y = frames @ params.dft
    re, im = y.chunk(2, dim=-1)
    return re * re + im * im


def _frames(x: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """Reflect-pad n_fft/2 each side and frame: [B, L] -> [B, 1 + L//hop,
    n_fft]."""
    pad = params.n_fft // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    return xp.unfold(1, params.n_fft, params.hop_length)


def power_spectrogram(x: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """[B, L] waveform -> [B, F-1, n_bins] power spectrogram (the trailing
    frame dropped)."""
    return _power(_frames(x, params), params)[:, :-1]


def log_mel_spectrogram(x: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """[B, L] waveform -> [B, F-1, n_mels] log(mel + 1e-3)."""
    mel = _power(_frames(x, params), params) @ params.mel_fb
    return torch.log(mel + 1e-3)[:, :-1]


def log_mel_slices(x: torch.Tensor, ids_frame: torch.Tensor, seg: int,
                   params: STFTParams) -> torch.Tensor:
    """Log-mel of ``seg`` frames from per-item frame ``ids_frame``: the whole
    wav is reflect-padded first and then sliced, so the frames equal those
    of ``log_mel_spectrogram(x)[:, ids:ids+seg]``.  x [B, L] -> [B, seg,
    n_mels]."""
    n_fft, hop = params.n_fft, params.hop_length
    pad = n_fft // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    length = (seg - 1) * hop + n_fft
    idx = ids_frame.long()[:, None] * hop + torch.arange(length,
                                                         device=x.device)
    seg_wav = torch.gather(xp, 1, idx)
    mel = _power(seg_wav.unfold(1, n_fft, hop), params) @ params.mel_fb
    return torch.log(mel + 1e-3)


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
