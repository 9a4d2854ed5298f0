"""F0 extraction registry (the port's own copy of the JAX package's
``utils/audio/pitch_extract.py``).

Parity target: reference utils/audio/pitch_extractors.py:7-66 — a named
registry defaulting to parselmouth's autocorrelation method.  The default
backend here is a self-contained normalized-autocorrelation tracker (numpy,
FFT-based) with the same contract: hop-aligned f0 track in Hz, 0 where
unvoiced, padded to the mel frame count.  parselmouth/pyworld register
themselves when they import.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

PITCH_EXTRACTORS: dict[str, Callable] = {}


def register_pitch_extractor(name: str):
    def deco(fn):
        PITCH_EXTRACTORS[name] = fn
        return fn

    return deco


def get_pitch_extractor(name: str) -> Callable:
    if name not in PITCH_EXTRACTORS:
        raise KeyError(f"unknown pitch extractor {name!r}; have {sorted(PITCH_EXTRACTORS)}")
    return PITCH_EXTRACTORS[name]


@register_pitch_extractor("autocorr")
def autocorr_pitch(wav: np.ndarray, sample_rate: int, hop_size: int,
                   f0_min: float = 50.0, f0_max: float = 1250.0,
                   n_frames: int | None = None,
                   voicing_threshold: float = 0.45) -> np.ndarray:
    """Normalized-autocorrelation f0 tracker.

    Frames of 40 ms at the mel hop; NCCF-style normalized ACF via FFT; the
    highest peak in the [1/f0_max, 1/f0_min] lag band wins; frames whose
    normalized peak < threshold (or with negligible energy) are unvoiced (0).
    Parabolic interpolation refines the lag.
    """
    wav = np.asarray(wav, dtype=np.float64)
    win = int(0.040 * sample_rate)
    win += win % 2
    if n_frames is None:
        n_frames = len(wav) // hop_size
    lag_min = max(2, int(sample_rate / f0_max))
    lag_max = min(win - 2, int(np.ceil(sample_rate / f0_min)))

    pad = win // 2
    x = np.pad(wav, (pad, pad))
    idx = np.arange(n_frames)[:, None] * hop_size + np.arange(win)[None, :]
    idx = np.minimum(idx, len(x) - 1)
    frames = x[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)

    nfft = 1 << int(np.ceil(np.log2(2 * win)))
    spec = np.fft.rfft(frames, nfft, axis=1)
    acf = np.fft.irfft(spec * np.conj(spec), nfft, axis=1)[:, :lag_max + 2]
    e0 = acf[:, 0:1]
    nacf = acf / np.maximum(e0, 1e-9)

    band = nacf[:, lag_min:lag_max + 1]
    peak_rel = np.argmax(band, axis=1)
    peak = peak_rel + lag_min
    peak_val = band[np.arange(n_frames), peak_rel]

    # parabolic interpolation around the integer peak
    p0 = nacf[np.arange(n_frames), peak - 1]
    p1 = nacf[np.arange(n_frames), peak]
    p2 = nacf[np.arange(n_frames), peak + 1]
    denom = p0 - 2 * p1 + p2
    delta = np.where(np.abs(denom) > 1e-9, 0.5 * (p0 - p2) / np.where(
        np.abs(denom) > 1e-9, denom, 1.0), 0.0)
    lag = peak + np.clip(delta, -1, 1)

    f0 = sample_rate / lag
    energy = e0[:, 0] / win
    voiced = (peak_val > voicing_threshold) & (energy > 1e-7) \
        & (f0 >= f0_min) & (f0 <= f0_max)
    f0 = np.where(voiced, f0, 0.0)
    return f0.astype(np.float32)


try:  # optional high-quality backends, registered when they import
    import parselmouth  # noqa: F401

    @register_pitch_extractor("parselmouth")
    def parselmouth_pitch(wav, sample_rate, hop_size, f0_min=50.0,
                          f0_max=1250.0, n_frames=None, **kw):
        time_step = hop_size / sample_rate
        if n_frames is None:
            n_frames = len(wav) // hop_size
        f0 = (parselmouth.Sound(np.asarray(wav, np.float64), sample_rate)
              .to_pitch_ac(time_step=time_step, voicing_threshold=0.6,
                           pitch_floor=f0_min, pitch_ceiling=f0_max)
              .selected_array["frequency"])
        lpad = 2
        rpad = n_frames - len(f0) - lpad
        return np.pad(f0, (lpad, max(rpad, 0)))[:n_frames].astype(np.float32)
except ImportError:
    pass

try:  # pyworld dio+stonemask backend (reference pitch_extractors.py:53-66)
    import pyworld  # noqa: F401

    @register_pitch_extractor("pyworld")
    def pyworld_pitch(wav, sample_rate, hop_size, f0_min=50.0,
                      f0_max=1250.0, n_frames=None, **kw):
        x = np.asarray(wav, np.float64)
        if n_frames is None:
            n_frames = len(x) // hop_size
        frame_period = hop_size * 1000.0 / sample_rate
        _f0, t = pyworld.dio(x, sample_rate, f0_floor=f0_min,
                             f0_ceil=f0_max, frame_period=frame_period)
        f0 = pyworld.stonemask(x, _f0, t, sample_rate)
        # dio yields len(x)//hop + 1 frames; delta-pad to the mel frame
        # count like the reference (pitch_extractors.py:60-65)
        delta_l = n_frames - len(f0)
        if delta_l > 0:
            f0 = np.concatenate([f0, [f0[-1]] * delta_l])
        return f0[:n_frames].astype(np.float32)
except ImportError:
    pass


def extract_pitch(name: str, wav: np.ndarray, sample_rate: int, hop_size: int,
                  n_frames: int, f0_min: float = 50.0,
                  f0_max: float = 1250.0) -> np.ndarray:
    f0 = get_pitch_extractor(name)(
        wav, sample_rate, hop_size, f0_min=f0_min, f0_max=f0_max,
        n_frames=n_frames)
    if len(f0) < n_frames:
        f0 = np.pad(f0, (0, n_frames - len(f0)))
    return f0[:n_frames]
