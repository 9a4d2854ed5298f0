"""Synthetic fixture batches (numpy only): a copy of the JAX package's
``data/synthetic.py::synthetic_batch``, so the same seed gives the same
token/frame batch in both packages.

Fields, channels-last:
  text_tokens/note_pitch/note_dur [B, N]  int32 (0 = pad)
  text_lengths [B]                        int32
  mel2ph [B, T]                           int32 monotonic, 0 = pad
  mel_lengths [B]                         int32
  f0 [B, T] float32, uv [B, T] float32
  spec [B, T, num_linear_bins] float32
  wavs [B, T * hop] float32
  spk_ids [B] int32
"""

from __future__ import annotations

import numpy as np


def synthetic_batch(
    batch_size: int = 2,
    n_tokens: int = 24,
    n_frames: int = 128,
    vocab: int = 40,
    pitch_vocab: int = 96,
    dur_vocab: int = 64,
    num_linear_bins: int = 1025,
    hop_size: int = 300,
    seed: int = 0,
) -> dict:
    rng = np.random.RandomState(seed)
    b, n, t = batch_size, n_tokens, n_frames

    text_lengths = rng.randint(max(4, n - 6), n + 1, size=b).astype(np.int32)
    mel_lengths = rng.randint(max(40, t - 24), t + 1, size=b).astype(np.int32)
    mel_lengths[0] = t  # keep at least one full-length item

    text_tokens = np.zeros((b, n), np.int32)
    note_pitch = np.zeros((b, n), np.int32)
    note_dur = np.zeros((b, n), np.int32)
    mel2ph = np.zeros((b, t), np.int32)
    for i in range(b):
        nl = text_lengths[i]
        text_tokens[i, :nl] = rng.randint(4, vocab, size=nl)
        note_pitch[i, :nl] = rng.randint(1, pitch_vocab, size=nl)
        note_dur[i, :nl] = rng.randint(1, dur_vocab, size=nl)
        # monotonic frame->token map covering tokens 1..nl
        bounds = np.sort(rng.choice(np.arange(1, mel_lengths[i]), nl - 1,
                                    replace=False))
        mel2ph[i, :mel_lengths[i]] = np.searchsorted(
            bounds, np.arange(mel_lengths[i]), side="right") + 1

    f0 = rng.uniform(7.0, 9.0, size=(b, t)).astype(np.float32)  # log2(f0+1)
    uv = (rng.uniform(size=(b, t)) < 0.2).astype(np.float32)
    for i in range(b):
        f0[i, mel_lengths[i]:] = 0.0
        uv[i, mel_lengths[i]:] = 0.0

    spec = np.abs(rng.randn(b, t, num_linear_bins)).astype(np.float32) * 0.01
    wavs = np.zeros((b, t * hop_size), np.float32)
    for i in range(b):
        valid = mel_lengths[i] * hop_size
        wavs[i, :valid] = (rng.randn(valid) * 0.1).astype(np.float32)
        spec[i, mel_lengths[i]:] = 0.0

    return {
        "text_tokens": text_tokens,
        "text_lengths": text_lengths,
        "note_pitch": note_pitch,
        "note_dur": note_dur,
        "mel2ph": mel2ph,
        "mel_lengths": mel_lengths,
        "f0": f0,
        "uv": uv,
        "spec": spec,
        "wavs": wavs,
        "spk_ids": np.zeros((b,), np.int32),
    }
