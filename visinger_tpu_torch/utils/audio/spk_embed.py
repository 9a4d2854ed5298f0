"""Speaker embedding extractors for the binarizer (``with_spk_embed``; the
port's own copy of the JAX package's ``utils/audio/spk_embed.py``: the same
float32 embedding, bit for bit).

Parity target: reference preprocessor/base_binarizer.py:154-160,369-370 —
``with_spk_embed`` runs resemblyzer's ``VoiceEncoder.embed_utterance`` over
each item's waveform and stores a unit-norm 256-d float vector that the
model's ``use_spk_embed`` projection consumes.

A pluggable registry: the resemblyzer backend registers itself when the
package imports; the default ``mel_stats`` backend is a dependency-free
stand-in: a fixed random projection of log-mel mean/std timbre statistics,
L2-normalized like resemblyzer's output.  It is deterministic and
discriminates speakers at the spectral-envelope-statistics level.
"""

from __future__ import annotations

import numpy as np

from visinger_tpu_torch.ops.mel_filters import hann_window, mel_filterbank

SPK_EMBED_DIM = 256

SPK_EMBED_EXTRACTORS: dict[str, object] = {}


def register_spk_embed(name: str):
    def deco(fn):
        SPK_EMBED_EXTRACTORS[name] = fn
        return fn

    return deco


def _log_mel_80(wav: np.ndarray, sample_rate: int) -> np.ndarray:
    """[L] float32 -> [F-1, 80] float32 log(mel + 1e-3), n_fft = window =
    1024, hop 256, 0 to sr/2: the JAX package's numpy log-mel.  Its DFT
    angle is 2*pi*n*k/n_fft unreduced, so its float32 DFT matrices differ
    in the last bit from ``ops/stft.py``'s (which reduce n*k mod n_fft
    first); the embedding is stored, so it is built the JAX way here."""
    n_fft, hop, n_mels = 1024, 256, 80
    window = hann_window(n_fft).astype(np.float64)
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] \
        * np.arange(n_fft // 2 + 1)[None, :] / n_fft
    cos_m = (window[:, None] * np.cos(ang)).astype(np.float32)
    sin_m = (window[:, None] * np.sin(ang)).astype(np.float32)
    fb = mel_filterbank(n_fft // 2 + 1, 0.0, sample_rate / 2, n_mels,
                        sample_rate)
    xp = np.pad(wav, (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(xp) - n_fft) // hop
    frames = xp[np.arange(n_frames)[:, None] * hop + np.arange(n_fft)]
    re, im = frames @ cos_m, frames @ sin_m
    return np.log((re * re + im * im)[:-1] @ fb + 1e-3)


@register_spk_embed("mel_stats")
def mel_stats_embed(wav: np.ndarray, sample_rate: int) -> np.ndarray:
    """Log-mel mean/std statistics -> fixed random projection -> L2 norm.

    80-bin log-mel over the whole utterance; the (mean, std) vector [160]
    is projected by a seed-0 Gaussian matrix to SPK_EMBED_DIM and unit
    normalized (resemblyzer also emits unit-norm embeddings).
    """
    mel = _log_mel_80(np.asarray(wav, np.float32), sample_rate)
    stats = np.concatenate([mel.mean(axis=0), mel.std(axis=0)])  # [160]
    proj = np.random.RandomState(0).randn(stats.shape[0], SPK_EMBED_DIM)
    proj /= np.sqrt(stats.shape[0])
    emb = stats @ proj
    return (emb / max(np.linalg.norm(emb), 1e-8)).astype(np.float32)


try:  # reference backend (base_binarizer.py:369-370); optional
    from resemblyzer import VoiceEncoder  # type: ignore

    _VOICE_ENCODER = None

    @register_spk_embed("resemblyzer")
    def resemblyzer_embed(wav: np.ndarray, sample_rate: int) -> np.ndarray:
        global _VOICE_ENCODER
        if _VOICE_ENCODER is None:
            _VOICE_ENCODER = VoiceEncoder()
        return np.asarray(
            _VOICE_ENCODER.embed_utterance(np.asarray(wav, float)),
            np.float32)
except ImportError:
    pass


def extract_spk_embed(name: str, wav: np.ndarray,
                      sample_rate: int) -> np.ndarray:
    fn = SPK_EMBED_EXTRACTORS.get(name)
    if fn is None:
        raise ValueError(
            f"unknown spk_embed extractor {name!r}; "
            f"available: {sorted(SPK_EMBED_EXTRACTORS)}")
    emb = fn(wav, sample_rate)
    assert emb.shape == (SPK_EMBED_DIM,), emb.shape
    return emb
