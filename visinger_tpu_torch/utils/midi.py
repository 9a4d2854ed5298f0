"""Minimal Standard MIDI File (SMF) parser — pure Python, no dependencies
(the port's own copy of the JAX package's ``utils/midi.py``).

Replaces miditoolkit for the needs of the preprocessing pipeline
(reference preprocessor/base_preprocessor.py:146-283 reads notes, tempi,
time signatures, and lyric events).  Parses format 0/1 files into absolute-
tick events and merges all tracks.

Exposes:
  MidiFile(path or bytes) with
    .ticks_per_beat
    .notes          [Note(start, end, pitch, velocity, channel)]
    .tempo_changes  [(tick, microseconds_per_quarter)]
    .time_signatures[(tick, numerator, denominator)]
    .lyrics         [(tick, text)]
    .markers        [(tick, text)]
"""

from __future__ import annotations

import io
from dataclasses import dataclass


@dataclass
class Note:
    start: int
    end: int
    pitch: int
    velocity: int
    channel: int = 0


def _read_varlen(buf: io.BytesIO) -> int:
    value = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("unexpected EOF in varlen")
        byte = b[0]
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value


class MidiFile:
    def __init__(self, source: str | bytes):
        data = source if isinstance(source, bytes) else open(source, "rb").read()
        buf = io.BytesIO(data)
        if buf.read(4) != b"MThd":
            raise ValueError("not a MIDI file (missing MThd)")
        hlen = int.from_bytes(buf.read(4), "big")
        header = buf.read(hlen)
        self.format = int.from_bytes(header[0:2], "big")
        n_tracks = int.from_bytes(header[2:4], "big")
        division = int.from_bytes(header[4:6], "big")
        if division & 0x8000:
            raise ValueError("SMPTE time division not supported")
        self.ticks_per_beat = division

        self.notes: list[Note] = []
        self.tempo_changes: list[tuple[int, int]] = []
        self.time_signatures: list[tuple[int, int, int]] = []
        self.lyrics: list[tuple[int, str]] = []
        self.markers: list[tuple[int, str]] = []
        for _ in range(n_tracks):
            self._parse_track(buf)
        self.notes.sort(key=lambda n: (n.start, n.pitch))
        self.tempo_changes.sort()
        self.time_signatures.sort()
        self.lyrics.sort()
        if not self.tempo_changes:
            self.tempo_changes = [(0, 500000)]  # 120 bpm default
        if not self.time_signatures:
            self.time_signatures = [(0, 4, 4)]

    def _parse_track(self, buf: io.BytesIO):
        if buf.read(4) != b"MTrk":
            raise ValueError("missing MTrk chunk")
        length = int.from_bytes(buf.read(4), "big")
        track = io.BytesIO(buf.read(length))
        tick = 0
        running_status = 0
        active: dict[tuple[int, int], tuple[int, int]] = {}  # (ch,pitch)->(start,vel)
        while True:
            try:
                tick += _read_varlen(track)
            except EOFError:
                break
            b = track.read(1)
            if not b:
                break
            status = b[0]
            if status < 0x80:  # running status: put the byte back
                track.seek(-1, io.SEEK_CUR)
                status = running_status
            else:
                if status < 0xF0:
                    running_status = status
            kind = status & 0xF0
            ch = status & 0x0F
            if kind == 0x90:  # note on
                pitch, vel = track.read(2)
                if vel > 0:
                    active[(ch, pitch)] = (tick, vel)
                else:  # velocity-0 note-on == note-off
                    self._close_note(active, ch, pitch, tick)
            elif kind == 0x80:  # note off
                pitch, _vel = track.read(2)
                self._close_note(active, ch, pitch, tick)
            elif kind in (0xA0, 0xB0, 0xE0):
                track.read(2)
            elif kind in (0xC0, 0xD0):
                track.read(1)
            elif status == 0xFF:  # meta
                meta_type = track.read(1)[0]
                mlen = _read_varlen(track)
                payload = track.read(mlen)
                if meta_type == 0x51 and mlen == 3:
                    self.tempo_changes.append(
                        (tick, int.from_bytes(payload, "big")))
                elif meta_type == 0x58 and mlen >= 2:
                    self.time_signatures.append(
                        (tick, payload[0], 2 ** payload[1]))
                elif meta_type == 0x05:
                    self.lyrics.append((tick, payload.decode("utf-8", "replace")))
                elif meta_type == 0x06:
                    self.markers.append((tick, payload.decode("utf-8", "replace")))
                elif meta_type == 0x2F:
                    break  # end of track
            elif status in (0xF0, 0xF7):  # sysex
                slen = _read_varlen(track)
                track.read(slen)
            else:
                raise ValueError(f"unhandled status byte {status:#x}")
        # close any dangling notes at end of track
        for (ch, pitch), (start, vel) in active.items():
            self.notes.append(Note(start, tick, pitch, vel, ch))

    def _close_note(self, active, ch, pitch, tick):
        key = (ch, pitch)
        if key in active:
            start, vel = active.pop(key)
            if tick > start:
                self.notes.append(Note(start, tick, pitch, vel, ch))

    # ------------------------------------------------------------------
    def tick_to_seconds(self) -> "TickTimeMap":
        return TickTimeMap(self.ticks_per_beat, self.tempo_changes)


class TickTimeMap:
    """Piecewise-linear tick -> seconds conversion honoring tempo changes."""

    def __init__(self, ticks_per_beat: int, tempo_changes: list[tuple[int, int]]):
        self.tpb = ticks_per_beat
        self.points: list[tuple[int, float, int]] = []  # (tick, sec, us_per_beat)
        sec = 0.0
        prev_tick, prev_tempo = 0, tempo_changes[0][1]
        self.points.append((0, 0.0, prev_tempo))
        for tick, tempo in tempo_changes:
            if tick > prev_tick:
                sec += (tick - prev_tick) * prev_tempo / (self.tpb * 1e6)
                self.points.append((tick, sec, tempo))
                prev_tick = tick
            prev_tempo = tempo
            self.points[-1] = (self.points[-1][0], self.points[-1][1], tempo)

    def __call__(self, tick: int) -> float:
        pt, ps, tempo = self.points[0]
        for t, s, tp in self.points:
            if t > tick:
                break
            pt, ps, tempo = t, s, tp
        return ps + (tick - pt) * tempo / (self.tpb * 1e6)


def write_midi(path: str, notes: list[Note], ticks_per_beat: int = 480,
               tempo_bpm: float = 120.0, lyrics: list[tuple[int, str]] | None = None,
               time_signatures: list[tuple[int, int, int]] | None = None,
               tempo_changes: list[tuple[int, float]] | None = None):
    """Tiny SMF-0 writer (for tests and synthetic corpora).

    ``time_signatures``: [(tick, numerator, denominator)] — denominator must
    be a power of two.  ``tempo_changes``: [(tick, bpm)]; overrides
    ``tempo_bpm`` when given.
    """

    def varlen(v: int) -> bytes:
        out = [v & 0x7F]
        v >>= 7
        while v:
            out.append(0x80 | (v & 0x7F))
            v >>= 7
        return bytes(reversed(out))

    events: list[tuple[int, bytes]] = []
    for tick, bpm in (tempo_changes or [(0, tempo_bpm)]):
        events.append(
            (tick, b"\xff\x51\x03" + int(60e6 / bpm).to_bytes(3, "big")))
    for tick, num, den in (time_signatures or [(0, 4, 4)]):
        den_exp = den.bit_length() - 1
        if 2 ** den_exp != den:
            raise ValueError(f"denominator {den} is not a power of two")
        events.append(
            (tick, bytes([0xFF, 0x58, 0x04, num, den_exp, 0x18, 0x08])))
    for n in notes:
        events.append((n.start, bytes([0x90, n.pitch, n.velocity or 64])))
        events.append((n.end, bytes([0x80, n.pitch, 0])))
    for tick, text in (lyrics or []):
        raw = text.encode("utf-8")
        events.append((tick, b"\xff\x05" + varlen(len(raw)) + raw))
    events.sort(key=lambda e: e[0])
    body = b""
    prev = 0
    for tick, ev in events:
        body += varlen(tick - prev) + ev
        prev = tick
    body += varlen(0) + b"\xff\x2f\x00"
    with open(path, "wb") as f:
        f.write(b"MThd" + (6).to_bytes(4, "big") + (0).to_bytes(2, "big")
                + (1).to_bytes(2, "big") + ticks_per_beat.to_bytes(2, "big"))
        f.write(b"MTrk" + len(body).to_bytes(4, "big") + body)
