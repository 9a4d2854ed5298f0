"""Offline preprocessing: MIDI + lyrics -> metadata.json (the port's own
copy of the JAX package's ``data/preprocess.py``: on the same raw corpus
both write the same metadata, phone set, speaker map and processed wavs).

Parity target: reference preprocessor/base_preprocessor.py:38-394 and
preprocessor/text/ko_sing.py:167-246 —
  pass 1: MIDI -> midi_info rows (MusicBERT-style position quantization,
          tempo/time-signature tracking, "|" silence-note insertion and
          merging by min_sil_dur), Korean syllable -> jamo sub-notes with the
          onset/coda frame-time rules; wav processing (resampling);
  then:   phone-set build, speaker map;
  pass 2: <BOS>/<EOS> insertion + phoneme token encoding.

Uses the port's MIDI parser (utils/midi.py) and Hangul decomposition
(utils/text/korean.py) — no miditoolkit/g2pk/jamo dependencies.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from visinger_tpu_torch.utils.midi import MidiFile
from visinger_tpu_torch.utils.text.korean import (
    normalize_text,
    syllable_to_phonemes,
    try_g2p,
)
from visinger_tpu_torch.utils.text.token_encoder import TokenTextEncoder


_TRUNC_POS = 2 ** 16  # ~30 min / 1024 measures (base_preprocessor.py:162)


def time_signature_reduce(numerator: int, denominator: int,
                          max_ts_denominator_exp: int = 6,
                          max_notes_per_bar: int = 2) -> tuple[int, int]:
    """Refine a time signature (base_preprocessor.py:167-178): halve both
    terms while the denominator exceeds 2**max_ts_denominator_exp, then split
    the numerator while a bar would exceed max_notes_per_bar whole notes."""
    while (denominator > 2 ** max_ts_denominator_exp
           and denominator % 2 == 0 and numerator % 2 == 0):
        denominator //= 2
        numerator //= 2
    while numerator > max_notes_per_bar * denominator:
        for i in range(2, numerator + 1):
            if numerator % i == 0:
                numerator //= i
                break
    return numerator, denominator


def build_pos_to_info(midi: MidiFile, args, max_pos: int):
    """Per-quantized-position (bar, (ts_num, ts_den), pos_in_bar, tempo_bpm)
    table (base_preprocessor.py:192-226) honoring every time-signature and
    tempo change.  A time-signature change that lands mid-bar takes effect
    from the NEXT bar boundary (the current bar keeps its measure length;
    tests/test_midi_ts.py::test_mid_bar_ts_change_defers_to_next_bar)."""
    pos_res = args["pos_resolution"]
    tpb = midi.ticks_per_beat
    max_ts_den = int(args.get("max_ts_denominator", 6))
    max_npb = int(args.get("max_notes_per_bar", 2))
    beat_note_factor = int(args.get("beat_note_factor", 4))
    default_tempo = float(args.get("DEFAULT_TEMPO", 120))

    def time_to_pos(tick):
        return round(tick * pos_res / tpb)

    ts = [None] * max_pos
    tempo = [None] * max_pos
    tsc = midi.time_signatures
    for i, (tick, num, den) in enumerate(tsc):
        end = time_to_pos(tsc[i + 1][0]) if i < len(tsc) - 1 else max_pos
        for j in range(time_to_pos(tick), min(end, max_pos)):
            ts[j] = time_signature_reduce(num, den, max_ts_den, max_npb)
    tpc = midi.tempo_changes
    for i, (tick, us_per_beat) in enumerate(tpc):
        end = time_to_pos(tpc[i + 1][0]) if i < len(tpc) - 1 else max_pos
        for j in range(time_to_pos(tick), min(end, max_pos)):
            tempo[j] = 6e7 / us_per_beat
    default_ts = time_signature_reduce(4, 4, max_ts_den, max_npb)
    for j in range(max_pos):
        if ts[j] is None:
            ts[j] = default_ts
        if tempo[j] is None:
            tempo[j] = default_tempo

    bar = [0] * max_pos
    pos_in_bar = [0] * max_pos
    cnt, cur_bar, measure_length = 0, 0, None
    for j in range(max_pos):
        num, den = ts[j]
        if cnt == 0:
            measure_length = num * beat_note_factor * pos_res // den
        bar[j] = cur_bar
        pos_in_bar[j] = cnt
        cnt += 1
        if cnt >= measure_length:  # always lands exactly: cnt steps by 1 and
            cnt = 0                # measure_length is fixed while cnt > 0
            cur_bar += 1
    return bar, ts, pos_in_bar, tempo


def midi_to_encoding(midi: MidiFile, args, lyrics: list[str] | None = None):
    """MIDI -> rows [bar, pos, pitch, dur_tok, start_s, end_s, tempo, syllable].

    Follows reference MIDI_to_encoding (base_preprocessor.py:146-283):
    positions quantized to pos_resolution per beat; bars/tempi read from a
    time-signature/tempo-aware pos_to_info table; a "|" silence row is
    inserted for gaps >= min_sil, where min_sil is the duration of
    ``min_sil_dur`` 64th-notes under the CURRENT time signature
    (base_preprocessor.py:240: a x/8 signature halves the threshold);
    adjacent silences merge; overlapping notes clipped.

    Documented deviations from the reference (intended-behavior fixes, per
    SURVEY §2.6): the TS denominator is used numerically (the reference takes
    the last character of "num/den", misreading 2-digit denominators and
    crashing on x/1 and x/2); the overlap clip compares seconds to seconds
    (the reference compares seconds to ticks at :242, so its clip almost
    never fires); when no lyric list is given, lyric events pair with notes
    positionally like the reference's ``midi_obj.lyrics[i]`` (with a
    tick-matching fallback when the counts differ).

    Returns (rows, min_sil_seconds, text).
    """
    pos_res = args["pos_resolution"]
    tpb = midi.ticks_per_beat
    t2s = midi.tick_to_seconds()
    min_sil_dur = args["min_sil_dur"]

    def time_to_pos(tick):
        return round(tick * pos_res / tpb)

    notes = sorted(midi.notes, key=lambda n: (n.start, n.pitch))
    if not notes:
        return [], 0.0, ""
    if lyrics is None:
        lyr_events = sorted(midi.lyrics)
        if len(lyr_events) == len(notes):  # positional, like the reference
            lyrics = [txt for _t, txt in lyr_events]
        else:  # fallback: pair by start tick; unmatched notes sing "|"
            by_tick: dict[int, str] = {}
            for t, s in lyr_events:
                by_tick.setdefault(t, s)
            lyrics = [by_tick.get(n.start, "") for n in notes]
    assert len(lyrics) == len(notes), (len(lyrics), len(notes))

    max_pos = min(max(time_to_pos(n.start) for n in notes) + 1, _TRUNC_POS)
    bar_of, ts_of, _pos_in_bar, tempo_of = build_pos_to_info(midi, args, max_pos)

    min_sil = 0.0
    rows: list[list] = []
    for i, note in enumerate(notes):
        npos = time_to_pos(note.start)
        if npos >= _TRUNC_POS:  # truncate ultra-long scores (:235)
            continue
        start_s, end_s = t2s(note.start), t2s(note.end)
        bar = bar_of[npos]
        tempo = int(tempo_of[npos] + 0.5)
        # TS-dependent silence threshold: min_sil_dur 64th notes =
        # tpb // (den/4 * pos_res) * min_sil_dur ticks under ts_of[npos]
        den = ts_of[npos][1]
        min_sil_ticks = tpb // max(den // 4, 1) // pos_res * min_sil_dur \
            if den >= 4 else tpb * (4 // den) // pos_res * min_sil_dur
        min_sil = t2s(min_sil_ticks)
        dur_tok = time_to_pos(note.end) - npos
        if rows and rows[-1][5] > start_s:  # overlap: clip previous
            rows[-1][3] = npos - time_to_pos(notes[i - 1].start)
            rows[-1][5] = start_s
        if rows and start_s - rows[-1][5] >= min_sil:
            if rows[-1][7] in ("", "|"):
                rows[-1][5] = start_s
            else:
                rows.append([bar, npos, 0, 0, rows[-1][5], start_s, tempo, "|"])
        elif rows and start_s - rows[-1][5] < min_sil:
            rows[-1][5] = start_s
        syl = lyrics[i] if lyrics[i] is not None else ""
        syl = "|" if syl == "" else syl.replace(" ", "")
        if rows and syl == "|" and rows[-1][7] in ("", "|"):
            rows[-1][2] = 0
            rows[-1][5] = end_s
        else:
            rows.append([bar, npos, note.pitch, dur_tok,
                         start_s, end_s, tempo, syl])

    # final silence merge + text assembly (base_preprocessor.py:267-281);
    # like the reference, the merge threshold is the LAST note's min_sil
    merged: list[list] = []
    text = ""
    for i, row in enumerate(rows):
        if merged and row[4] - merged[-1][5] < min_sil:
            merged[-1][5] = row[4]
        if merged and row[7] == "|" and merged[-1][7] == "|":
            merged[-1][5] = row[5]
            merged[-1][2] = 0
        else:
            if row[7] == "|":
                row[2] = 0
            text += " " if row[7] == "|" else row[7]
            merged.append(row)
    merged.sort(key=lambda r: (r[0], r[4]))
    return merged, min_sil, text


def phonemize_rows(midi_info: list) -> list[str]:
    """Normalize + g2p the lyric syllables of midi_info rows, preserving the
    per-row syllable segmentation.

    Mirrors ko_sing.process's text handling (ko_sing.py:175-182): each row's
    syllable is first normalized (numbers/Latin -> Hangul readings,
    preprocess_text/num_to_hangeul parity via utils/text/korean.py), then
    pronunciation rules run over whole silence-delimited words — rules like
    liaison and nasal assimilation cross note boundaries WITHIN a word, so
    per-syllable conversion would miss them.  Returns one (possibly
    multi-character) converted syllable string per row; "|" for silences.
    """
    norm: list[str] = []
    for row in midi_info:
        syl = row[7]
        if syl in ("|", ""):
            norm.append("|")
            continue
        cleaned = normalize_text(syl).replace(" ", "")
        norm.append(cleaned if cleaned else "|")
    # g2p across the whole text; "|" passes through g2p_syllables untouched
    # and acts as a rule boundary (g2pk path: convert word-by-word like the
    # reference's text.split("|") loop)
    joined = "".join(norm)
    converted = try_g2p(joined)
    if len(converted) != len(joined):  # defensive: rules are length-preserving
        raise ValueError(
            f"g2p changed text length {len(joined)} -> {len(converted)}")
    out, p = [], 0
    for s in norm:
        out.append(converted[p: p + len(s)])
        p += len(s)
    return out


def split_syllables(midi_info: list, cfg) -> tuple[list[str], list[list]]:
    """Korean syllable rows -> per-jamo sub-note rows (ko_sing.process
    parity, ko_sing.py:167-246): onset/coda get num_frame frames worth of
    time with graceful fallbacks for short notes.  Syllables are normalized
    and pronunciation-converted first (phonemize_rows)."""
    n_frame = cfg.preprocess_args.num_frame
    sr, hop = cfg.sample_rate, cfg.hop_size
    frame_time = n_frame * hop / sr
    out_rows: list[list] = []
    ph_list: list[str] = []
    syllables = phonemize_rows(midi_info)
    for (bar, pos, pitch, dur, start, end, tempo, _syl), syl in zip(
            midi_info, syllables):
        if syl == "|" or syl == "":
            phs = ["|"]
        else:
            phs = []
            for ch in syl:
                phs.extend(syllable_to_phonemes(ch))
        n_frames_note = int((end - start) * sr / hop + 0.5)
        if len(phs) == 1:
            bounds = [start, end]
        elif len(phs) == 2:
            ft = frame_time if n_frames_note > n_frame else (n_frame - 2) * hop / sr
            bounds = [start, start + ft, end]
        elif len(phs) == 3:
            if n_frames_note >= n_frame * 3:
                ft = frame_time
            elif n_frames_note >= n_frame * 2:
                ft = (n_frame - 1) * hop / sr
            elif n_frames_note >= n_frame:
                ft = (n_frame - 2) * hop / sr
            else:
                ft = hop / sr
            bounds = [start, start + ft, end - ft, end]
        else:  # >3 jamo (multi-syllable lyric on one note): spread evenly
            bounds = list(np.linspace(start, end, len(phs) + 1))
        for j, p in enumerate(phs):
            out_rows.append([bar, pos, pitch, dur, bounds[j], bounds[j + 1],
                             tempo, p])
        ph_list.extend(phs)
    return ph_list, out_rows


def second_pass(midi_info: list, ph_encoder: TokenTextEncoder, spk_id: int):
    """<BOS>/<EOS> insertion + token encoding (base_preprocessor.py:335-365).

    Returns rows of 9 fields: [..., ph_tokens(list), phones(list)]."""
    rows = []
    ph_tokens: list[int] = []
    phs: list[str] = []
    for i, (bar, _pos, pitch, dur, start, end, tempo, ph) in enumerate(midi_info):
        if i == 0:
            tok = ph_encoder.encode(["<BOS>"])
            rows.append([bar, 0, 0, 0, 0.0, start, tempo, tok, ["<BOS>"]])
            ph_tokens.extend(tok)
            phs.append("<BOS>")
        ph_items = [ph] if isinstance(ph, str) else list(ph)
        ph_items = [p for p in ph_items if p not in ("", " ")]
        tok = ph_encoder.encode(ph_items)
        rows.append([bar, i + 1, pitch, dur, start, end, tempo, tok, ph_items])
        ph_tokens.extend(tok)
        phs.extend(ph_items)
        if i == len(midi_info) - 1:
            tok = ph_encoder.encode(["<EOS>"])
            rows.append([bar, i + 2, 0, 0, end, end + 0.1, tempo, tok, ["<EOS>"]])
            ph_tokens.extend(tok)
            phs.append("<EOS>")
    return rows, phs, ph_tokens


def resample_wav(wav: np.ndarray, src_sr: int, dst_sr: int) -> np.ndarray:
    if src_sr == dst_sr:
        return wav
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(src_sr, dst_sr)
    return resample_poly(wav, dst_sr // g, src_sr // g).astype(np.float32)


class Preprocessor:
    """CSD-style corpus -> metadata.json (+ phone_set/spk_map)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.processed_dir = cfg.processed_data_dir

    def meta_data(self):
        """Yield (item_name, midi_fn, lyric_fn_or_None, spk_name).

        CSD layout (config/datasets/svs/csd/preprocess.py:13-35): midi/*.mid
        with text/*.txt per-note syllable files."""
        raw = self.cfg.raw_data_dir
        for midi_fn in sorted(glob.glob(os.path.join(raw, "midi", "*.mid"))):
            name = os.path.splitext(os.path.basename(midi_fn))[0]
            lyric_fn = os.path.join(raw, "text", f"{name}.txt")
            wav_fn = os.path.join(raw, "wav", f"{name}.wav")
            yield (name, midi_fn, lyric_fn if os.path.exists(lyric_fn) else None,
                   wav_fn, self.cfg.speaker)

    def load_lyrics(self, lyric_fn: str | None, n_notes: int) -> list[str] | None:
        if lyric_fn is None:
            return None
        with open(lyric_fn, encoding="utf-8") as f:
            syllables = f.read().split()
        if len(syllables) != n_notes:
            raise ValueError(f"{lyric_fn}: {len(syllables)} syllables for "
                             f"{n_notes} notes")
        return syllables

    def process(self) -> str:
        cfg = self.cfg
        os.makedirs(self.processed_dir, exist_ok=True)
        wav_dir = os.path.join(self.processed_dir, "wav_processed")
        os.makedirs(wav_dir, exist_ok=True)
        pargs = dict(cfg.preprocess_args)

        first_pass = []
        ph_set: set[str] = set()
        spk_names: set[str] = set()
        for name, midi_fn, lyric_fn, wav_fn, spk in self.meta_data():
            try:
                midi = MidiFile(midi_fn)
                lyr = self.load_lyrics(lyric_fn, len(midi.notes))
                midi_info, min_sil, _text = midi_to_encoding(midi, pargs, lyr)
                if not midi_info:
                    continue
                ph_list, rows = split_syllables(midi_info, cfg)
                new_wav_fn = self._process_wav(name, wav_fn, wav_dir)
                first_pass.append({
                    "item_name": name, "midi_info": rows, "ph": ph_list,
                    "wav_fn": new_wav_fn, "spk_name": spk,
                    "silence": min_sil,
                })
                ph_set.update(p for p in ph_list if p != "|")
                spk_names.add(spk)
            except Exception as e:  # a corrupt item is skipped, not fatal
                print(f"| preprocess skip {name}: {e!r}")

        ph_set.update(["<BOS>", "<EOS>"])
        encoder = TokenTextEncoder(sorted(ph_set))
        encoder.store_to_file(os.path.join(self.processed_dir, "phone_set.json"))
        spk_map = {s: i for i, s in enumerate(sorted(spk_names))}
        with open(os.path.join(self.processed_dir, "spk_map.json"), "w") as f:
            json.dump(spk_map, f, ensure_ascii=False)

        metadata = []
        for item in first_pass:
            rows, phs, ph_tokens = second_pass(item["midi_info"], encoder,
                                               spk_map[item["spk_name"]])
            metadata.append({
                "item_name": item["item_name"],
                "wav_fn": item["wav_fn"],
                "spk_id": spk_map[item["spk_name"]],
                "midi_info": rows,
                "ph": phs,
                "ph_token": ph_tokens,
            })
        meta_fn = os.path.join(self.processed_dir, "metadata.json")
        with open(meta_fn, "w") as f:
            json.dump(metadata, f, ensure_ascii=False)
        print(f"| preprocessed {len(metadata)} items -> {meta_fn}")
        return meta_fn

    def _process_wav(self, name: str, wav_fn: str, out_dir: str) -> str:
        from visinger_tpu_torch.data.wav_processors import get_wav_processor_cls
        from visinger_tpu_torch.utils.audio.io import load_wav, save_wav

        cfg = self.cfg
        wav, sr = load_wav(wav_fn)
        for pname in cfg.preprocess_args.get("wav_processors", ["resample"]):
            proc_cls = get_wav_processor_cls(pname)
            if proc_cls is None:
                print(f"| unknown wav processor {pname!r}, skipping")
                continue
            wav, sr = proc_cls().process(wav, sr, cfg)
        if sr != cfg.sample_rate:
            wav = resample_wav(wav, sr, cfg.sample_rate)
        out_fn = os.path.join(out_dir, f"{name}.wav")
        save_wav(wav, out_fn, cfg.sample_rate)
        return out_fn
