"""WAV I/O without external audio libraries (stdlib ``wave`` + numpy; the
port's own copy of the JAX package's ``utils/audio/io.py``).

Replaces the reference's torchaudio.load / scipy save_wav
(utils/audio/mel_processing.py:7-12, utils/audio/io.py:8-15).
"""

from __future__ import annotations

import wave

import numpy as np


def load_wav(path: str, pad_to_hop: int = 0) -> tuple[np.ndarray, int]:
    """Read a PCM wav -> (float32 mono [-1, 1], sample_rate).

    When ``pad_to_hop`` > 0, zero-pads so len(wav) is the next multiple of
    hop (+1 hop, matching reference load_wav_to_torch's
    ``(len//hop + 1) * hop`` padding, mel_processing.py:7-12).
    """
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        channels = f.getnchannels()
        raw = f.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = ((a[:, 0].astype(np.int32)) | (a[:, 1].astype(np.int32) << 8)
             | (a[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    if pad_to_hop:
        p = (len(x) // pad_to_hop + 1) * pad_to_hop - len(x)
        x = np.pad(x, (0, p))
    return x, sr


def save_wav(wav: np.ndarray, path: str, sample_rate: int, norm: bool = False):
    """16-bit PCM save; a ``.mp3`` path transcodes via ffmpeg and removes the
    intermediate wav (reference utils/audio/io.py:8-23 semantics)."""
    is_mp3 = path.endswith(".mp3")
    wav_path = path[:-4] + ".wav" if is_mp3 else path
    wav = np.asarray(wav, dtype=np.float64)
    if norm:
        peak = np.abs(wav).max()
        if peak > 0:
            wav = wav / peak * 0.95
    pcm = np.clip(wav * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(wav_path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())
    if is_mp3:
        to_mp3(wav_path, remove_wav=True)


def to_mp3(wav_path: str, bitrate: str = "192k", remove_wav: bool = False) -> str:
    """Transcode a wav to mp3 with ffmpeg (reference to_mp3,
    utils/audio/io.py:17-23 — argument list instead of its shell string).
    Raises a clear error when no ffmpeg binary is on PATH."""
    import os
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "mp3 export needs an `ffmpeg` binary on PATH (none found); "
            "write .wav instead or install ffmpeg")
    out_path = wav_path[:-4] + ".mp3" if wav_path.endswith(".wav") else wav_path + ".mp3"
    subprocess.check_call(
        ["ffmpeg", "-threads", "1", "-loglevel", "error", "-i", wav_path,
         "-vn", "-b:a", bitrate, "-y", "-hide_banner", "-async", "1",
         out_path], stdin=subprocess.DEVNULL)
    if remove_wav:
        os.remove(wav_path)
    return out_path
