"""Synthetic singing corpus generator (the port's own copy of the JAX
package's ``data/synthetic_corpus.py``: for one seed both write the same
wavs, ``metadata.json``, ``phone_set.json`` and ``spk_map.json``).

Creates a small CSD-shaped dataset on disk — wav files of harmonic "vowels"
following random MIDI note sequences, plus the processed-metadata layout the
binarizer consumes.  ``run synth-data`` writes it, so a training run
reproduces from a clone with no external data.

midi_info rows follow the binarizer contract: one row per phoneme sub-note,
[Bar, Pos, Pitch, Dur_tok, start, end, Tempo, ph_tokens, phones].
"""

from __future__ import annotations

import json
import os

import numpy as np

from visinger_tpu_torch.utils.audio.io import save_wav
from visinger_tpu_torch.utils.text.token_encoder import TokenTextEncoder

# a small jamo-like phone inventory (real Hangul jamo codepoints)
_LEADS = [chr(c) for c in range(0x1100, 0x1108)]
_VOWELS = [chr(c) for c in range(0x1161, 0x1169)]
_TAILS = [chr(c) for c in range(0x11A8, 0x11B0)]


def midi_to_hz(note: int) -> float:
    return 440.0 * 2 ** ((note - 69) / 12)


def _render_note(f0: float, n_samples: int, sr: int, rng) -> np.ndarray:
    """Additive harmonic stack with vibrato + breath noise."""
    t = np.arange(n_samples) / sr
    vibrato = 1.0 + 0.005 * np.sin(2 * np.pi * 5.5 * t + rng.uniform(0, 6.28))
    phase = 2 * np.pi * np.cumsum(f0 * vibrato) / sr
    sig = np.zeros(n_samples)
    for h in range(1, 9):
        if f0 * h > sr / 2 * 0.9:
            break
        sig += (0.5 / h) * np.sin(phase * h + rng.uniform(0, 6.28))
    env = np.minimum(1.0, np.minimum(np.arange(n_samples), n_samples - np.arange(n_samples)) / (0.02 * sr))
    return (sig * env + rng.randn(n_samples) * 0.003) * 0.3


def generate_corpus(root: str, n_items: int = 12, sample_rate: int = 24000,
                    seed: int = 0, notes_per_item: tuple[int, int] = (4, 8),
                    tempo: int = 120) -> str:
    """Write wavs + metadata under ``root`` (the processed_data_dir).

    Returns the metadata.json path."""
    rng = np.random.RandomState(seed)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    phone_set = sorted(set(_LEADS + _VOWELS + _TAILS))
    TokenTextEncoder(phone_set).store_to_file(os.path.join(root, "phone_set.json"))
    encoder = TokenTextEncoder(phone_set)
    with open(os.path.join(root, "spk_map.json"), "w") as f:
        json.dump({"synth": 0}, f)

    metadata = []
    for i in range(n_items):
        n_notes = rng.randint(*notes_per_item)
        midi_info = []
        t_cur = 0.0
        audio = []
        for j in range(n_notes):
            note = int(rng.randint(55, 76))
            dur_s = float(rng.uniform(0.35, 0.9))
            n_samp = int(dur_s * sample_rate)
            audio.append(_render_note(midi_to_hz(note), n_samp, sample_rate, rng))
            # split the syllable into 1-3 jamo sub-notes (onset/nucleus/coda)
            n_ph = rng.choice([1, 2, 3], p=[0.2, 0.4, 0.4])
            phones = [rng.choice(_LEADS), rng.choice(_VOWELS), rng.choice(_TAILS)][:n_ph]
            # sub-note boundaries: onset/coda capped at 3 frames (12.5 ms hop)
            frame_s = 300 / sample_rate
            bounds = [t_cur, t_cur + dur_s]
            if n_ph == 2:
                bounds = [t_cur, t_cur + 3 * frame_s, t_cur + dur_s]
            elif n_ph == 3:
                bounds = [t_cur, t_cur + 3 * frame_s, t_cur + dur_s - 3 * frame_s,
                          t_cur + dur_s]
            dur_tok = max(1, int(round(dur_s * 4 * 16 / (240 / tempo))))
            for k, ph in enumerate(phones):
                midi_info.append([
                    0, j, note, dur_tok, bounds[k], bounds[k + 1], tempo,
                    [encoder.encode([ph])[0]], [ph],
                ])
            t_cur += dur_s
        # trailing silence + an explicit "|" row that owns it (overshooting
        # end is fine — alignment clips to the frame count); without this the
        # final frames map to no token and get_mel2note's coverage assert fires
        audio.append(np.zeros(int(0.3 * sample_rate)))
        midi_info.append([0, n_notes, 0, 0, t_cur, t_cur + 1.0, tempo,
                          [encoder.encode(["|"])[0]], ["|"]])
        wav = np.concatenate(audio)
        wav_fn = os.path.join(wav_dir, f"synth_{i:04d}.wav")
        save_wav(wav, wav_fn, sample_rate)
        metadata.append({
            "item_name": f"synth_{i:04d}",
            "wav_fn": wav_fn,
            "spk_id": 0,
            "midi_info": midi_info,
        })
    meta_fn = os.path.join(root, "metadata.json")
    with open(meta_fn, "w") as f:
        json.dump(metadata, f, ensure_ascii=False)
    return meta_fn
