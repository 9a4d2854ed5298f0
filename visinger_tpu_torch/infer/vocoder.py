"""Vocoder registry + Griffin-Lim reference vocoder (the port's own copy of
the JAX package's ``infer/vocoder.py``; numpy only).

Parity target: reference tasks/vocoder_infer/base_vocoder.py:12-68 —
register_vocoder/get_vocoder_cls and the BaseVocoder spec2wav/wav2spec
interface.  The reference registers no vocoder anywhere (VISinger is
end-to-end); the registry serves the mel-based evaluation path, and
Griffin-Lim (the reference's unused ``griffin_lim_iters: 30`` key) makes
spec2wav work.
"""

from __future__ import annotations

import numpy as np

from visinger_tpu_torch.ops.stft import (STFTParams, hann_window,
                                         log_mel_spectrogram_np,
                                         power_spectrogram_np)

VOCODERS: dict[str, type] = {}


def register_vocoder(name: str):
    def deco(cls):
        VOCODERS[name.lower()] = cls
        cls.name = name
        return cls

    return deco


def get_vocoder_cls(name: str) -> type:
    return VOCODERS[name.lower()]


def _stft_params(cfg) -> STFTParams:
    return STFTParams(cfg.fft_size, cfg.win_size, cfg.hop_size,
                      cfg.sample_rate, float(cfg.fmin), float(cfg.fmax),
                      cfg.num_mel_bins)


class BaseVocoder:
    def spec2wav(self, spec: np.ndarray, **kwargs) -> np.ndarray:
        """[T, bins] spectrogram -> waveform."""
        raise NotImplementedError

    @staticmethod
    def wav2spec(wav_fn: str, cfg) -> dict:
        from visinger_tpu_torch.utils.audio.io import load_wav

        wav, _sr = load_wav(wav_fn, pad_to_hop=cfg.hop_size)
        params = _stft_params(cfg)
        return {
            "wav": wav,
            "linear": power_spectrogram_np(wav, params),
            "mel": log_mel_spectrogram_np(wav, params),
        }


@register_vocoder("griffin_lim")
class GriffinLimVocoder(BaseVocoder):
    """Phase retrieval from a linear POWER spectrogram by Griffin-Lim."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.params = _stft_params(cfg)
        self.n_iters = int(cfg.griffin_lim_iters)

    def _stft(self, wav: np.ndarray) -> np.ndarray:
        p = self.params
        pad = p.n_fft // 2
        x = np.pad(wav, (pad, pad), mode="reflect")
        n_frames = 1 + (len(x) - p.n_fft) // p.hop_length
        idx = (np.arange(n_frames)[:, None] * p.hop_length
               + np.arange(p.n_fft)[None, :])
        frames = x[idx] * self._window()
        return np.fft.rfft(frames, axis=1)

    def _window(self) -> np.ndarray:
        p = self.params
        w = np.zeros(p.n_fft)
        lpad = (p.n_fft - p.win_length) // 2
        w[lpad:lpad + p.win_length] = hann_window(p.win_length)
        return w

    def _istft(self, stft: np.ndarray, length: int) -> np.ndarray:
        p = self.params
        frames = np.fft.irfft(stft, p.n_fft, axis=1)
        w = self._window()
        pad = p.n_fft // 2
        out = np.zeros(length + 2 * pad)
        norm = np.zeros(length + 2 * pad)
        for i in range(frames.shape[0]):
            s = i * p.hop_length
            out[s:s + p.n_fft] += frames[i] * w
            norm[s:s + p.n_fft] += w * w
        out = out / np.maximum(norm, 1e-9)
        return out[pad:pad + length]

    def spec2wav(self, spec: np.ndarray, **kwargs) -> np.ndarray:
        """spec: [T, n_bins] linear POWER spectrogram -> waveform."""
        mag = np.sqrt(np.maximum(np.asarray(spec, np.float64), 0.0))
        t = spec.shape[0]
        length = t * self.params.hop_length
        rng = np.random.RandomState(0)
        angles = np.exp(2j * np.pi * rng.rand(t + 1, self.params.n_bins))
        mag_full = np.concatenate([mag, mag[-1:]], axis=0)  # undo frame drop
        for _ in range(self.n_iters):
            wav = self._istft(mag_full * angles, length)
            re = self._stft(wav)[: t + 1]
            angles = re / np.maximum(np.abs(re), 1e-9)
        return self._istft(mag_full * angles, length).astype(np.float32)
