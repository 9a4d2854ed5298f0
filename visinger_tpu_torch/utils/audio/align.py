"""MIDI-to-frame alignment (host-side NumPy; the port's own copy of the JAX
package's ``utils/audio/align.py``).

Parity target: reference utils/audio/align.py —
  get_mel2note (:6-55): training-time alignment; each cleaned midi_info note
    maps its [start, end) frames to its index+1 in mel2phone/mel2note;
    silence "|" notes get pitch 0 and are merged around <BOS>/<EOS>/repeats;
    last frame copies the second-to-last.
  get_note2dur (:58-104): inference-time alignment with no audio — frame
    count synthesized from the final MIDI end time, and each note's syllable
    split into (onset, nucleus, coda) jamo with onset/coda capped at 3 frames
    (the reference's Korean singing rule, README.md:57).
  mel2token_to_dur (:107-129): scatter-add duration recovery.

midi_info rows are lists:
  [Bar, Pos, Pitch, Dur_token, start_time, end_time, Tempo, ph_tokens, phones]
where ph_tokens/phones are lists (training) — for get_note2dur, index 7 holds
the phone list of the syllable.
"""

from __future__ import annotations

import numpy as np


def mel2token_to_dur_np(mel2token: np.ndarray, t_tokens: int | None = None) -> np.ndarray:
    mel2token = np.asarray(mel2token, dtype=np.int64)
    if t_tokens is None:
        t_tokens = int(mel2token.max())
    dur = np.zeros(t_tokens + 1, dtype=np.int64)
    np.add.at(dur, mel2token, 1)
    return dur[1:]


def _merge_midi_info(midi_info: list, min_sil_duration: float) -> list:
    """Silence/gap cleanup shared by both aligners (align.py:10-26)."""
    cleaned: list = []
    for midi in midi_info:
        midi = list(midi)
        if cleaned and midi[4] - cleaned[-1][5] < min_sil_duration:
            cleaned[-1][5] = midi[4]  # extend previous to close small gaps
        ph0 = midi[8][0] if isinstance(midi[8], (list, tuple)) else midi[8]
        prev0 = None
        if cleaned:
            prev = cleaned[-1][8]
            prev0 = prev[0] if isinstance(prev, (list, tuple)) else prev
        if cleaned and ph0 == "|" and prev0 in ("<BOS>", "|"):
            cleaned[-1][5] = midi[5]
            cleaned[-1][2] = 0
        elif cleaned and ph0 == "<EOS>" and prev0 == "|":
            cleaned[-1][5] = midi[5]
            cleaned[-1][2] = 0
        else:
            if ph0 == "|":
                midi[2] = 0
            cleaned.append(midi)
    # drop zero-duration BOS rows
    return [
        m for m in cleaned
        if not ((m[8][0] if isinstance(m[8], (list, tuple)) else m[8]) == "<BOS>"
                and m[5] - m[4] < 1e-3)
    ]


def get_mel2note(midi_info: list, n_frames: int, hop_size: int, sample_rate: int,
                 min_sil_duration: float = 0.0):
    """Training alignment: notes -> frame maps, given the true frame count.

    Returns (mel2phone, mel2note, duration, ph_token_list, ph_list,
    note_token_list, cleaned_midi_info) — all python lists like the
    reference.
    """
    cleaned = _merge_midi_info(midi_info, min_sil_duration)
    mel2phone = np.zeros(n_frames, dtype=np.int64)
    mel2note = np.zeros(n_frames, dtype=np.int64)
    ph_token_list: list = []
    ph_list: list = []
    note_token_list: list = []
    for i_note, midi in enumerate(cleaned):
        start = int(midi[4] * sample_rate / hop_size + 0.5)
        end = int(midi[5] * sample_rate / hop_size + 0.5)
        assert end - start > 0, f"zero-length note: {midi}"
        mel2phone[start:end] = i_note + 1
        mel2note[start:end] = i_note + 1
        ph_token_list.extend(midi[7])
        ph_list.extend(midi[8])
        note_token_list.append(midi[3])
    # The final token absorbs any trailing frames (recorded silence past the
    # score end).  The reference handles only a 1-frame overhang via
    # ``mel2phone[-1] = mel2phone[-2]`` (align.py:47-48) and asserts
    # otherwise; absorbing the whole zero-tail is the intended semantics and
    # makes alignment robust to wav/score end mismatch.  Interior gaps still
    # assert below.
    covered = np.nonzero(mel2phone)[0]
    assert len(covered) > 0, "no frames covered by any note"
    tail_start = covered[-1] + 1
    mel2phone[tail_start:] = len(cleaned)
    mel2note[tail_start:] = len(cleaned)
    assert (mel2phone != 0).all() and (mel2note != 0).all(), \
        "alignment gap: some frames map to no note"
    assert mel2phone[-1] == len(ph_token_list), \
        f"last index {mel2phone[-1]} != n tokens {len(ph_token_list)}"
    duration = mel2token_to_dur_np(mel2phone, len(ph_list))
    return (mel2phone.tolist(), mel2note.tolist(), duration.tolist(),
            ph_token_list, ph_list, note_token_list, cleaned)


def get_note2dur(midi_info: list, hop_size: int, sample_rate: int,
                 min_sil_duration: float = 0.0, num_frame: int = 3):
    """Inference alignment (no audio): synthesize the frame count from the
    last end time; split syllables by the onset/nucleus/coda frame rule —
    onset/coda get ``num_frame`` frames, the nucleus takes the rest.

    midi_info rows: [..., 7]=phone list for the syllable, [8]=syllable str.
    Returns (mel2phone, mel2note, duration, ph_list, cleaned_midi_info).
    """
    cleaned: list = []
    for midi in midi_info:
        midi = list(midi)
        if cleaned and midi[4] - cleaned[-1][5] < min_sil_duration:
            cleaned[-1][5] = midi[4]
        if cleaned and midi[8] == "|" and cleaned[-1][8] == "|":
            cleaned[-1][5] = midi[5]
        else:
            cleaned.append(midi)
    last_frame = int(cleaned[-1][5] * sample_rate / hop_size + 0.5)
    mel2phone = np.zeros(last_frame, dtype=np.int64)
    mel2note = np.zeros(last_frame, dtype=np.int64)
    ph_list: list = []
    i_ph = 0
    for i_note, midi in enumerate(cleaned):
        start = int(midi[4] * sample_rate / hop_size + 0.5)
        end = int(midi[5] * sample_rate / hop_size + 0.5)
        phones = midi[7]
        if len(phones) == 1:
            mel2phone[start:end] = i_ph + 1
            i_ph += 1
        elif len(phones) == 2:
            mel2phone[start:start + num_frame] = i_ph + 1
            mel2phone[start + num_frame:end] = i_ph + 2
            i_ph += 2
        elif len(phones) == 3:
            mel2phone[start:start + num_frame] = i_ph + 1
            mel2phone[start + num_frame:end - num_frame] = i_ph + 2
            mel2phone[end - num_frame:end] = i_ph + 3
            i_ph += 3
        else:
            raise ValueError(f"syllable with {len(phones)} phones: {midi}")
        ph_list.extend(phones)
        mel2note[start:end] = i_note + 1
    mel2phone[-1] = mel2phone[-2]
    mel2note[-1] = mel2note[-2]
    assert (mel2phone != 0).all() and (mel2note != 0).all(), "alignment gap"
    duration = mel2token_to_dur_np(mel2phone, len(ph_list))
    return (mel2phone.tolist(), mel2note.tolist(), duration.tolist(),
            ph_list, cleaned)
