"""Continuous-wavelet f0 decomposition (``with_f0cwt``; the port's own copy
of the JAX package's ``utils/audio/cwt.py``).

Parity target: reference base_binarizer.py:309-316, which calls
``get_cont_logf0`` / ``get_logf0_cwt`` — names that do not exist anywhere in
the reference tree (the flag is dead code there, off by default).  The
intended behavior is the standard FastSpeech2/NATSpeech prosody-CWT
pipeline those names come from: a Mexican-hat mother wavelet, dt = frame
period, dj = 1, J = 9 (10 dyadic scales), in numpy.
"""

from __future__ import annotations

import numpy as np

N_SCALES = 10
_DT = 0.005  # CSD frame period: hop 128 / sr 24000 ≈ 5.33 ms; 5 ms standard


def cwt_scales(dt: float = _DT, n_scales: int = N_SCALES) -> np.ndarray:
    """Dyadic scales s_j = s0 * 2^j with s0 = 2*dt (pycwt defaults)."""
    return 2.0 * dt * (2.0 ** np.arange(n_scales))


def get_cont_logf0(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f0 [T] (0 = unvoiced) -> (uv mask [T], continuous log-f0 [T]).

    Unvoiced gaps are linearly interpolated in the log domain (edge gaps
    hold the nearest voiced value); an all-unvoiced input yields zeros.
    """
    f0 = np.asarray(f0, np.float64)
    uv = (f0 == 0).astype(np.float32)
    voiced = np.where(f0 > 0)[0]
    cont = np.zeros_like(f0)
    if len(voiced):
        lf0 = np.log(f0[voiced])
        cont = np.interp(np.arange(len(f0)), voiced, lf0)
    return uv, cont


def _mexican_hat(t: np.ndarray) -> np.ndarray:
    """psi(t) = 2/(sqrt(3) pi^1/4) (1 - t^2) exp(-t^2/2)."""
    return (2.0 / (np.sqrt(3.0) * np.pi ** 0.25)) \
        * (1.0 - t * t) * np.exp(-0.5 * t * t)


def get_logf0_cwt(lf0: np.ndarray, dt: float = _DT,
                  n_scales: int = N_SCALES) -> tuple[np.ndarray, np.ndarray]:
    """Normalized continuous log-f0 [T] -> (cwt_spec [T, n_scales], scales).

    W(s, n) = sum_k x_k sqrt(dt/s) psi((k - n) dt / s) — direct convolution
    per scale (T ~ 1e3, 10 scales: trivial host work next to f0 extraction).
    """
    x = np.asarray(lf0, np.float64)
    scales = cwt_scales(dt, n_scales)
    out = np.zeros((len(x), n_scales), np.float32)
    for j, s in enumerate(scales):
        # wavelet support: |t| <= 5 s  (mexican hat decays as exp(-t^2/2))
        half = max(int(np.ceil(5.0 * s / dt)), 1)
        t = np.arange(-half, half + 1) * dt / s
        kern = _mexican_hat(t) * np.sqrt(dt / s)
        # centered 'same' slice by hand: np.convolve(..., "same") returns
        # the wrong length when the kernel outgrows the signal (coarse
        # scales on short phrases)
        full = np.convolve(x, kern, mode="full")
        start = (len(kern) - 1) // 2
        out[:, j] = full[start: start + len(x)]
    return out, scales


def inverse_cwt(cwt_spec: np.ndarray,
                scales: np.ndarray | None = None) -> np.ndarray:
    """Approximate reconstruction: sum_j W[:, j] * (j + 2.5)^(-2.5)
    (the NATSpeech empirical inverse for this scale family)."""
    cwt_spec = np.asarray(cwt_spec, np.float64)
    j = np.arange(cwt_spec.shape[1])
    b = ((j + 1 + 2.5) ** (-2.5))
    return (cwt_spec * b[None, :]).sum(axis=1)


def norm_cwt(cwt_spec: np.ndarray) -> tuple[np.ndarray, float, float]:
    mean = float(cwt_spec.mean())
    std = float(cwt_spec.std()) or 1.0
    return (cwt_spec - mean) / std, mean, std
