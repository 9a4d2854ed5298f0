"""The binarizer's token codecs (the port's own copy of the codecs of the JAX
package's ``data/binarizer.py``; its ``Binarizer`` is not ported yet).

Parity target: reference preprocessor/base_binarizer.py:279-287 — the
note token maps: pitch_map (0 + note_range) and dur_map with
[PAD]/[BOS]/[EOS] reserved rows, and the exponentially-bucketed durations
(d2e) that ``VISingerInfer`` maps a note's duration token through.
"""

from __future__ import annotations


def build_dur_codec(max_durations: int, pos_resolution: int):
    """Exponential duration buckets (base_binarizer.py:279-287)."""
    dur_enc: list[int] = []
    dur_dec: list[int] = []
    for i in range(max_durations):
        for _ in range(pos_resolution):
            dur_dec.append(len(dur_enc))
            for _ in range(2 ** i):
                dur_enc.append(len(dur_dec) - 1)

    def d2e(x: int) -> int:
        return dur_enc[x] if x < len(dur_enc) else dur_enc[-1]

    return d2e, dur_dec


def build_pitch_map(note_range) -> dict:
    pitch_map = {"0": 0}
    for i, x in enumerate(range(note_range[0], note_range[1])):
        pitch_map[str(x)] = i + 1
    return pitch_map


def build_dur_map() -> dict:
    m = {"[PAD]": 0, "[BOS]": 1, "[EOS]": 2}
    for i, x in enumerate(range(0, 128)):
        m[str(x)] = i + 4
    return m
