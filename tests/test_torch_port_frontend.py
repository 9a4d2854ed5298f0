"""The port's own copies of the MIDI front end, held against the JAX
package's modules on the same inputs: the MIDI parser and writer, the Korean
text rules, the score rows, the frame alignment, the token codecs, wav I/O
and the Griffin-Lim vocoder.  Everything here is exact (integers, strings,
bytes) except the vocoder, held to 1e-6 (float64 FFTs in the same order).

The module fixture writes a small set of scores with ``write_midi`` (Hangul
lyric events, pitches and durations from a seed, one score with a rest, one
with tempo and time-signature changes) and the three JSON maps a binarized
data directory holds; ``tests/test_torch_port_infer.py`` reuses it.
"""

import json
import os

import numpy as np
import pytest

from visinger_tpu.data import binarizer as j_bin
from visinger_tpu.data import preprocess as j_pre
from visinger_tpu.infer.vocoder import GriffinLimVocoder as JGriffinLim
from visinger_tpu.models.factory import tiny_config as jax_tiny_config
from visinger_tpu.utils import midi as j_midi
from visinger_tpu.utils.audio import align as j_align
from visinger_tpu.utils.audio import io as j_io
from visinger_tpu.utils.text import g2p_ko as j_g2p
from visinger_tpu.utils.text import korean as j_ko
from visinger_tpu.utils.text.token_encoder import \
    TokenTextEncoder as JTokenTextEncoder
from visinger_tpu_torch.config import tiny_config
from visinger_tpu_torch.data import binarizer as p_bin
from visinger_tpu_torch.data import preprocess as p_pre
from visinger_tpu_torch.infer.vocoder import GriffinLimVocoder, get_vocoder_cls
from visinger_tpu_torch.utils import midi as p_midi
from visinger_tpu_torch.utils.audio import align as p_align
from visinger_tpu_torch.utils.audio import io as p_io
from visinger_tpu_torch.utils.text import g2p_ko as p_g2p
from visinger_tpu_torch.utils.text import korean as p_ko
from visinger_tpu_torch.utils.text.token_encoder import TokenTextEncoder

from test_g2p_ko import GOLDEN, LEXICAL_GOLDEN, NUMBER_GOLDEN

import test_torch_port_cores  # noqa: F401  (shares the cores)

SYLLABLES = list("나무소리가장하늘바다꽃잎국밥같이좋아")
# the jamo every Hangul syllable decomposes into, plus the score markers
JAMO = ([chr(c) for c in range(0x1100, 0x1113)]
        + [chr(c) for c in range(0x1161, 0x1176)]
        + [chr(c) for c in range(0x11A8, 0x11C3)])


def write_score(path, rng, n_notes, rest_before=(), tempo_changes=None,
                time_signatures=None, lo=300, hi=600):
    """A score of ``n_notes`` notes, each a Hangul syllable; a rest of one
    beat before each note index in ``rest_before``."""
    notes, lyrics, tick = [], [], 0
    for i in range(n_notes):
        if i in rest_before:
            tick += 480
        dur = int(rng.randint(lo, hi))
        notes.append(p_midi.Note(tick, tick + dur, int(rng.randint(57, 74)),
                                 80))
        lyrics.append((tick, str(rng.choice(SYLLABLES))))
        tick += dur
    p_midi.write_midi(path, notes, ticks_per_beat=480, lyrics=lyrics,
                      tempo_changes=tempo_changes,
                      time_signatures=time_signatures)
    return notes, lyrics


def write_data_dir(data_dir, note_range):
    """phone_set.json, pitch_map.json and dur_map.json, as the binarizer
    writes them."""
    os.makedirs(data_dir, exist_ok=True)
    TokenTextEncoder(JAMO + ["<BOS>"]).store_to_file(
        os.path.join(data_dir, "phone_set.json"))
    for name, m in (("pitch_map", p_bin.build_pitch_map(note_range)),
                    ("dur_map", p_bin.build_dur_map())):
        with open(os.path.join(data_dir, f"{name}.json"), "w") as f:
            json.dump(m, f)


@pytest.fixture(scope="module")
def scores(tmp_path_factory):
    """(data dir, {name: midi path}): 3 short scores, one with a rest that
    must split at 256 frames, one with tempo and time-signature changes."""
    root = str(tmp_path_factory.mktemp("port_scores"))
    rng = np.random.RandomState(3)
    fns = {}
    for i in range(3):
        fns[f"short{i}"] = os.path.join(root, f"short{i}.mid")
        write_score(fns[f"short{i}"], rng, 5)
    fns["split"] = os.path.join(root, "split.mid")
    write_score(fns["split"], rng, 12, rest_before=(6,))
    fns["meter"] = os.path.join(root, "meter.mid")
    write_score(fns["meter"], rng, 8, tempo_changes=[(0, 120.0),
                                                     (1200, 90.0)],
                time_signatures=[(0, 3, 4), (1440, 6, 8)])
    data_dir = os.path.join(root, "binary")
    write_data_dir(data_dir, tiny_config().note_range)
    return data_dir, fns


def _note_tuples(m):
    return [(n.start, n.end, n.pitch, n.velocity, n.channel) for n in m.notes]


def test_midi_parse_and_write_match_jax(scores, tmp_path):
    _, fns = scores
    for fn in fns.values():
        a, b = p_midi.MidiFile(fn), j_midi.MidiFile(fn)
        assert _note_tuples(a) == _note_tuples(b) and a.notes
        for key in ("ticks_per_beat", "format", "tempo_changes",
                    "time_signatures", "lyrics", "markers"):
            assert getattr(a, key) == getattr(b, key), key
        ta, tb = a.tick_to_seconds(), b.tick_to_seconds()
        assert [ta(t) for t in range(0, 12000, 97)] == \
            [tb(t) for t in range(0, 12000, 97)]
    # the writers give the same bytes
    rng = np.random.RandomState(8)
    notes, lyrics = write_score(str(tmp_path / "a.mid"), rng, 6,
                                tempo_changes=[(0, 100.0), (900, 140.0)],
                                time_signatures=[(0, 2, 4), (960, 3, 8)])
    j_midi.write_midi(str(tmp_path / "b.mid"),
                      [j_midi.Note(n.start, n.end, n.pitch, n.velocity)
                       for n in notes], ticks_per_beat=480, lyrics=lyrics,
                      tempo_changes=[(0, 100.0), (900, 140.0)],
                      time_signatures=[(0, 2, 4), (960, 3, 8)])
    assert (tmp_path / "a.mid").read_bytes() == (tmp_path / "b.mid").read_bytes()


_TEXTS = sorted({s for s, _ in GOLDEN + LEXICAL_GOLDEN + NUMBER_GOLDEN}
                | {"같이 좋아", "국|물", "안녕 123", "a", "3", "b", "가나다",
                   "ab 12개 3.5%", "꽃잎이 피었네 1,000원"})


@pytest.mark.parametrize("text", _TEXTS)
def test_text_rules_match_jax(text):
    assert p_g2p.g2p_syllables(text) == j_g2p.g2p_syllables(text)
    assert p_ko.normalize_text(text) == j_ko.normalize_text(text)
    assert p_ko.try_g2p(text) == j_ko.try_g2p(text)
    for ch in text:
        if p_ko.is_hangul_syllable(ch):
            assert p_ko.syllable_to_phonemes(ch) == \
                j_ko.syllable_to_phonemes(ch)


def test_token_encoder_matches_jax(scores):
    data_dir, _ = scores
    path = os.path.join(data_dir, "phone_set.json")
    a, b = TokenTextEncoder.from_file(path), JTokenTextEncoder.from_file(path)
    assert a.id_to_token == b.id_to_token and len(a) == len(b)
    probe = JAMO[:7] + ["<BOS>", "|", "<EOS>", "zz"]
    assert a.encode(probe) == b.encode(probe)
    assert a.decode(a.encode(probe)) == b.decode(b.encode(probe))
    assert a.sil_phonemes() == b.sil_phonemes()


def _score_rows(mod_pre, cfg, fn, midi_cls, enc):
    rows, min_sil, text = mod_pre.midi_to_encoding(
        midi_cls(fn), dict(cfg.preprocess_args))
    ph_list, sub_rows = mod_pre.split_syllables(rows, cfg)
    rows9, phs, toks = mod_pre.second_pass(sub_rows, enc, 0)
    return rows, min_sil, text, ph_list, sub_rows, rows9, phs, toks


def test_score_rows_and_alignment_match_jax(scores):
    data_dir, fns = scores
    path = os.path.join(data_dir, "phone_set.json")
    pcfg, jcfg = tiny_config(), jax_tiny_config()
    for fn in fns.values():
        got = _score_rows(p_pre, pcfg, fn, p_midi.MidiFile,
                          TokenTextEncoder.from_file(path))
        want = _score_rows(j_pre, jcfg, fn, j_midi.MidiFile,
                           JTokenTextEncoder.from_file(path))
        assert got == want
        assert p_pre.phonemize_rows(got[0]) == j_pre.phonemize_rows(want[0])
        rows9 = got[5]
        note_rows = [[r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[8], r[8]]
                     for r in rows9]
        for kw in ({}, {"min_sil_duration": 0.05, "num_frame": 2}):
            assert p_align.get_note2dur(note_rows, 300, 24000, **kw) == \
                j_align.get_note2dur(note_rows, 300, 24000, **kw)
    for num, den in ((4, 4), (6, 8), (3, 2), (7, 128), (12, 4)):
        assert p_pre.time_signature_reduce(num, den) == \
            j_pre.time_signature_reduce(num, den)


def test_codecs_and_maps_match_jax():
    for args in ((8, 16), (3, 4), (1, 1)):
        (pe, pd), (je, jd) = (p_bin.build_dur_codec(*args),
                              j_bin.build_dur_codec(*args))
        assert pd == jd
        assert [pe(x) for x in range(5000)] == [je(x) for x in range(5000)]
    assert p_bin.build_pitch_map((12, 128)) == j_bin.build_pitch_map((12, 128))
    assert p_bin.build_dur_map() == j_bin.build_dur_map()


def test_wav_io_matches_jax(tmp_path):
    wav = np.random.RandomState(4).uniform(-1.3, 1.3, 4001).astype(np.float32)
    for norm in (False, True):
        a, b = str(tmp_path / f"a{norm}.wav"), str(tmp_path / f"b{norm}.wav")
        p_io.save_wav(wav, a, 24000, norm=norm)
        j_io.save_wav(wav, b, 24000, norm=norm)
        assert open(a, "rb").read() == open(b, "rb").read()
        for hop in (0, 300):
            (xa, sra), (xb, srb) = p_io.load_wav(a, hop), j_io.load_wav(a, hop)
            assert sra == srb == 24000
            np.testing.assert_array_equal(xa, xb)
    x, _ = p_io.load_wav(str(tmp_path / "aFalse.wav"))
    # 16-bit round trip: save scales by 32767 and truncates, load divides by
    # 32768, so within two steps of the clipped input
    assert float(np.abs(x - np.clip(wav, -1, 1)).max()) <= 2 / 32767


def test_griffin_lim_matches_jax():
    cfg = tiny_config().replace(griffin_lim_iters=4)
    spec = np.random.RandomState(5).rand(12, cfg.fft_size // 2 + 1) ** 2
    assert get_vocoder_cls("Griffin_Lim") is GriffinLimVocoder
    got = GriffinLimVocoder(cfg).spec2wav(spec)
    want = JGriffinLim(jax_tiny_config().replace(
        griffin_lim_iters=4)).spec2wav(spec)
    assert got.shape == want.shape == (12 * cfg.hop_size,)
    assert float(np.abs(got - want).max()) <= 1e-6
