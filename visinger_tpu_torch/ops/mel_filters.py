"""The STFT's numpy constants that need no torch: the periodic Hann
window, the HTK mel filterbank (as the JAX package's ``ops/stft.py``
builds them) and the Slaney one (VITS's ``librosa.filters.mel``).  Kept apart from ``ops/stft.py`` so that host-only code, such
as the binarizer's worker processes, imports numpy alone."""

from __future__ import annotations

import numpy as np


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window`` default)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
        np.float32)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int) -> np.ndarray:
    """Triangular HTK mel filterbank, no norm -> [n_freqs, n_mels]."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max),
                        n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0,
                    15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / (np.log(6.4) / 27.0), lin)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= 15.0,
                    1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                    m * (200.0 / 3))


def mel_filterbank_slaney(n_fft: int, f_min: float, f_max: float | None,
                          n_mels: int, sample_rate: int) -> np.ndarray:
    """``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)`` (Slaney
    scale, Slaney area norm; ``f_max`` None is half the rate), transposed
    -> [n_fft // 2 + 1, n_mels]."""
    f_max = sample_rate / 2.0 if f_max is None else f_max
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    mel_f = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(f_min),
                                          _hz_to_mel_slaney(f_max),
                                          n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]
    return weights.T.astype(np.float32)
