"""ITU-R BS.1770-4 integrated loudness + loudness normalization (the port's
own copy of the JAX package's ``utils/audio/loudness.py``).

The reference normalizes every wav to -20 LUFS with pyloudnorm before VAD
(reference utils/audio/vad.py:46-49: ``pyln.Meter(sr)``,
``integrated_loudness``, ``pyln.normalize.loudness(wav, loudness, -20)``).
BS.1770 is a public spec; this implements the same algorithm (mono case)
without pyloudnorm:

  1. K-weighting: two biquads — a +4 dB high-shelf (fc 1500 Hz, Q 1/sqrt 2)
     and a high-pass (fc 38 Hz, Q 0.5), coefficients from the RBJ audio-EQ
     cookbook at the actual sample rate (the same parameterization
     pyloudnorm uses so the filter works at any fs, not just the spec's
     tabulated 48 kHz).
  2. Mean-square over 400 ms blocks, 75% overlap;
     block loudness L_j = -0.691 + 10 log10(z_j).
  3. Two-stage gating: absolute -70 LUFS, then relative (mean of surviving
     blocks - 10 LU); integrated loudness = -0.691 + 10 log10(mean z over
     blocks passing both gates).

Compliance anchor: a full-scale 997 Hz sine reads -3.01 LUFS — BS.1770's
-0.691 dB offset is defined to cancel the K-filter's gain at 997 Hz, and
10*log10(0.5) = -3.01.
"""

from __future__ import annotations

import numpy as np

# block layout per BS.1770-4 §2: T_g = 400 ms gating blocks, 75% overlap
_BLOCK_S = 0.400
_OVERLAP = 0.75
_ABS_GATE_LUFS = -70.0
_REL_GATE_LU = -10.0
_OFFSET_DB = -0.691


def _k_weighting_sos(sr: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The two K-weighting biquads (b, a) at sample rate ``sr``."""
    # stage 1: high shelf, +4 dB, fc 1500 Hz, Q = 1/sqrt(2)
    g_db, fc, q = 4.0, 1500.0, 1.0 / np.sqrt(2.0)
    a_ = 10.0 ** (g_db / 40.0)
    w0 = 2.0 * np.pi * fc / sr
    alpha = np.sin(w0) / (2.0 * q)
    cw = np.cos(w0)
    b = np.array([a_ * ((a_ + 1) + (a_ - 1) * cw + 2 * np.sqrt(a_) * alpha),
                  -2 * a_ * ((a_ - 1) + (a_ + 1) * cw),
                  a_ * ((a_ + 1) + (a_ - 1) * cw - 2 * np.sqrt(a_) * alpha)])
    a = np.array([(a_ + 1) - (a_ - 1) * cw + 2 * np.sqrt(a_) * alpha,
                  2 * ((a_ - 1) - (a_ + 1) * cw),
                  (a_ + 1) - (a_ - 1) * cw - 2 * np.sqrt(a_) * alpha])
    shelf = (b / a[0], a / a[0])
    # stage 2: high pass, fc 38 Hz, Q = 0.5
    fc, q = 38.0, 0.5
    w0 = 2.0 * np.pi * fc / sr
    alpha = np.sin(w0) / (2.0 * q)
    cw = np.cos(w0)
    b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2])
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    hp = (b / a[0], a / a[0])
    return [shelf, hp]


def k_weight(wav: np.ndarray, sr: int) -> np.ndarray:
    """Apply the K-weighting pre-filter chain."""
    from scipy.signal import lfilter

    y = np.asarray(wav, np.float64)
    for b, a in _k_weighting_sos(sr):
        y = lfilter(b, a, y)
    return y


def integrated_loudness(wav: np.ndarray, sr: int) -> float:
    """BS.1770-4 gated integrated loudness in LUFS (mono).

    Returns -inf for signals shorter than one 400 ms gating block or with
    no blocks above the -70 LUFS absolute gate (matches pyloudnorm, which
    warns and returns -inf).
    """
    wav = np.asarray(wav, np.float64)
    block = int(round(_BLOCK_S * sr))
    step = int(round(block * (1.0 - _OVERLAP)))
    if wav.ndim != 1:
        raise ValueError(f"mono only, got shape {wav.shape}")
    if len(wav) < block or step <= 0:
        return float("-inf")
    y = k_weight(wav, sr)
    n_blocks = 1 + (len(y) - block) // step
    # mean square per gating block via a cumulative sum (O(n))
    csum = np.concatenate([[0.0], np.cumsum(y * y)])
    starts = np.arange(n_blocks) * step
    z = (csum[starts + block] - csum[starts]) / block
    lj = _OFFSET_DB + 10.0 * np.log10(np.maximum(z, 1e-30))
    above_abs = lj > _ABS_GATE_LUFS
    if not above_abs.any():
        return float("-inf")
    rel_gate = (_OFFSET_DB + 10.0 * np.log10(np.mean(z[above_abs]))
                + _REL_GATE_LU)
    keep = above_abs & (lj > rel_gate)
    if not keep.any():
        return float("-inf")
    return float(_OFFSET_DB + 10.0 * np.log10(np.mean(z[keep])))


def normalize_loudness(wav: np.ndarray, input_loudness: float,
                       target_loudness: float) -> np.ndarray:
    """Scale ``wav`` from measured to target LUFS (pyln.normalize.loudness
    semantics: pure gain, no limiting — the reference peak-normalizes after
    if |wav| > 1, vad.py:48-49)."""
    if not np.isfinite(input_loudness):
        return np.asarray(wav, np.float32)
    gain = 10.0 ** ((target_loudness - input_loudness) / 20.0)
    return (np.asarray(wav, np.float64) * gain).astype(np.float32)
