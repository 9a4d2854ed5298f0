"""F0 transforms (numpy): log2 normalization with unvoiced interpolation,
and its inverse.  An own copy of the JAX package's ``utils/audio/pitch.py``
(``norm_f0``, ``norm_interp_f0``, ``denorm_f0``).

Norm is ``log2(f0 + 1)``; denorm clamps to [50, 1250] Hz.
"""

from __future__ import annotations

import numpy as np

F0_MAX = 1250.0
F0_MIN = 50.0


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
