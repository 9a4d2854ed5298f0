"""F0 transforms (numpy): log2 normalization with unvoiced interpolation,
its inverse, and mel-scale coarse quantization.  An own copy of the JAX
package's ``utils/audio/pitch.py`` (``f0_to_coarse``, ``norm_f0``,
``norm_interp_f0``, ``denorm_f0``).

Norm is ``log2(f0 + 1)``; denorm clamps to [50, 1250] Hz; coarse
quantization uses 300 mel-spaced bins over [50, 1250].
"""

from __future__ import annotations

import numpy as np

F0_BIN = 300
F0_MAX = 1250.0
F0_MIN = 50.0
_F0_MEL_MIN = 1127 * np.log(1 + F0_MIN / 700)
_F0_MEL_MAX = 1127 * np.log(1 + F0_MAX / 700)


def f0_to_coarse(f0: np.ndarray) -> np.ndarray:
    """Quantize f0 (Hz) to [1, 299] mel-spaced bins; 0/unvoiced -> bin 1."""
    f0 = np.asarray(f0, dtype=np.float64)
    f0_mel = 1127 * np.log(1 + f0 / 700)
    scaled = np.where(
        f0_mel > 0,
        (f0_mel - _F0_MEL_MIN) * (F0_BIN - 2) / (_F0_MEL_MAX - _F0_MEL_MIN) + 1,
        f0_mel,
    )
    scaled = np.clip(scaled, 1, F0_BIN - 1)
    return np.rint(scaled).astype(np.int64)


def norm_f0(f0: np.ndarray) -> np.ndarray:
    """Hz -> log2(f0 + 1)."""
    return np.log2(np.asarray(f0, dtype=np.float64) + 1.0)


def norm_interp_f0(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Normalize and linearly interpolate through unvoiced gaps.

    Returns (f0_norm [T] float32, uv [T] float32 where 1 = unvoiced)."""
    f0 = np.asarray(f0, dtype=np.float64)
    uv = f0 == 0
    f0 = norm_f0(f0)
    if uv.all():
        f0[:] = 0.0
    elif uv.any():
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
    return f0.astype(np.float32), uv.astype(np.float32)


def denorm_f0(f0, uv=None, pitch_padding=None, f0_min=F0_MIN, f0_max=F0_MAX):
    """log2(f0 + 1) -> Hz, clamped to [f0_min, f0_max]; 0 where ``uv`` > 0
    or ``pitch_padding``."""
    out = np.clip(np.power(2.0, f0) - 1.0, f0_min, f0_max)
    if uv is not None:
        out = np.where(uv > 0, 0.0, out)
    if pitch_padding is not None:
        out = np.where(pitch_padding, 0.0, out)
    return out
