"""Binarizer: processed metadata -> per-split record files + token maps (the
port's own copy of the JAX package's ``data/binarizer.py``: on the same
metadata both write byte-identical records, lengths and maps).

Parity target: reference preprocessor/base_binarizer.py:114-341 —
  - note token maps: pitch_map (0 + note_range), dur_map / tempo_map with
    [PAD]/[BOS]/[EOS] reserved rows, exponentially-bucketed durations (d2e)
  - per item: wav -> frame count, MIDI-frame alignment (get_mel2note),
    per-note pitch/duration token mapping, f0 extraction + coarse bins
  - outputs: {split}.{data,idx}, {split}_lengths.npy, *_map.json,
    phone_set.json / spk_map.json copied through.

metadata.json rows (produced by preprocessing, see preprocess.py):
  {item_name, wav_fn, spk_id, midi_info, word: ..., ph: ...}
with midi_info rows [Bar, Pos, Pitch, Dur_tok, start, end, Tempo,
ph_tokens(list), phones(list)] — one row per phoneme sub-note.

The items are processed by a pool of ``binarize_workers`` processes (0: one
per CPU core) started with ``spawn``: a worker imports numpy and this
package's data modules afresh, and never the parent's CUDA state or its
threads (so a script that binarizes guards its top level with
``if __name__ == "__main__"``, which the workers would otherwise run again).
A pool that cannot start falls back to processing serially; the route
taken is printed.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import traceback

import numpy as np

from visinger_tpu_torch.data.record_store import RecordWriter
from visinger_tpu_torch.utils.audio.align import get_mel2note
from visinger_tpu_torch.utils.audio.io import load_wav
from visinger_tpu_torch.utils.audio.pitch import f0_to_coarse
from visinger_tpu_torch.utils.audio.pitch_extract import extract_pitch


class BinarizationError(Exception):
    pass


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


def build_tempo_map(tempo_range) -> dict:
    m = {"[PAD]": 0, "[BOS]": 1, "[EOS]": 2}
    for i, x in enumerate(range(tempo_range[0], tempo_range[1] + 1)):
        m[str(x)] = i + 4
    return m


def _process_one(binarizer, item, pitch_map, dur_map, tempo_map, d2e):
    """(record, None) or (None, why it was skipped)."""
    try:
        return binarizer.process_item(item, pitch_map, dur_map, tempo_map,
                                      d2e), None
    except BinarizationError as e:
        return None, f"{item.get('item_name')}: {e}"
    except Exception as e:  # one bad item is skipped, not fatal
        traceback.print_exc()
        return None, f"{item.get('item_name')} (unexpected: {e!r})"


def _binarize_worker(args):
    """Top-level worker fn (picklable) for the binarizer process pool."""
    binarizer, item, pitch_map, dur_map, tempo_map = args
    d2e, _ = build_dur_codec(binarizer.bin_args.max_durations,
                             binarizer.bin_args.pos_resolution)
    return _process_one(binarizer, item, pitch_map, dur_map, tempo_map, d2e)


class Binarizer:
    def __init__(self, cfg):
        self.cfg = cfg
        self.bin_args = cfg.binarization_args
        self.data_dir = cfg.binary_data_dir

    # ------------------------------------------------------------------
    def load_metadata(self) -> list[dict]:
        with open(f"{self.cfg.processed_data_dir}/metadata.json") as f:
            return json.load(f)

    def split_items(self, items: list[dict]) -> dict[str, list[dict]]:
        """Index-range splits (binarization_args.dataset_range: index)."""
        ba = self.bin_args
        n = len(items)

        def rng(r):
            lo, hi = r
            return items[lo: (n if hi == -1 else hi)]

        return {
            "test": rng(ba.test_range),
            "valid": rng(ba.valid_range),
            "train": rng(ba.train_range),
        }

    # ------------------------------------------------------------------
    def process(self) -> dict:
        """Binarize every split; returns {split: records written}."""
        cfg = self.cfg
        os.makedirs(self.data_dir, exist_ok=True)
        for fn in ("phone_set.json", "spk_map.json"):
            src = f"{cfg.processed_data_dir}/{fn}"
            if os.path.exists(src):
                shutil.copy(src, f"{self.data_dir}/{fn}")
        pitch_map = build_pitch_map(cfg.note_range)
        dur_map = build_dur_map()
        tempo_map = build_tempo_map(self.bin_args.tempo_range)
        for name, m in (("pitch_map", pitch_map), ("dur_map", dur_map),
                        ("tempo_map", tempo_map)):
            with open(f"{self.data_dir}/{name}.json", "w") as f:
                json.dump(m, f, ensure_ascii=False)
        items = self.load_metadata()
        n_workers = min(cfg.binarize_workers or (os.cpu_count() or 1),
                        len(items))
        pool = None
        if n_workers > 1:   # one pool for every split; workers start lazily
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            pool = ProcessPoolExecutor(
                max_workers=n_workers,
                mp_context=multiprocessing.get_context("spawn"))
            print(f"| binarize: a pool of {n_workers} spawned workers")
        try:
            return {prefix: self.process_split(prefix, split, pitch_map,
                                               dur_map, tempo_map, pool)
                    for prefix, split in self.split_items(items).items()}
        finally:
            if pool is not None:
                pool.shutdown()

    def process_split(self, prefix: str, items: list[dict], pitch_map,
                      dur_map, tempo_map, pool=None) -> int:
        d2e, _ = build_dur_codec(self.bin_args.max_durations,
                                 self.bin_args.pos_resolution)
        lengths, total_sec, n_ok = [], 0.0, 0
        with RecordWriter(f"{self.data_dir}/{prefix}") as writer:
            for rec, err in self._process_items(items, pitch_map, dur_map,
                                                tempo_map, d2e, pool):
                if rec is None:
                    print(f"| skip: {err}")
                    continue
                writer.add(rec)
                lengths.append(rec["len"])
                total_sec += rec["sec"]
                n_ok += 1
        np.save(f"{self.data_dir}/{prefix}_lengths.npy",
                np.asarray(lengths, np.int64))
        print(f"| {prefix}: {n_ok} items, {total_sec:.1f}s")
        return n_ok

    def _process_items(self, items, pitch_map, dur_map, tempo_map, d2e,
                       pool) -> list:
        """[(record | None, err)] in item order; through the spawned process
        ``pool`` for more than 2 items (the reference binarizes through a
        worker pool, utils/commons/multiprocess_utils.py:87), else
        serially."""
        if pool is not None and len(items) > 2:
            from concurrent.futures.process import BrokenProcessPool

            try:
                out = list(pool.map(_binarize_worker, [
                    (self, item, pitch_map, dur_map, tempo_map)
                    for item in items]))
                print(f"| binarize: {len(items)} items through the pool")
                return out
            except (OSError, pickle.PicklingError, AttributeError, TypeError,
                    BrokenProcessPool) as e:
                print(f"| binarize: the worker pool failed ({e!r}); "
                      "processing serially")
        print(f"| binarize: {len(items)} items serially")
        return [_process_one(self, item, pitch_map, dur_map, tempo_map, d2e)
                for item in items]

    # ------------------------------------------------------------------
    def process_item(self, item: dict, pitch_map, dur_map, tempo_map, d2e) -> dict:
        cfg = self.cfg
        hop, sr = cfg.hop_size, cfg.sample_rate
        wav, wav_sr = load_wav(item["wav_fn"], pad_to_hop=hop)
        if wav_sr != sr:
            raise BinarizationError(f"sample rate {wav_sr} != {sr}")
        # frame-count convention parity (mel_processing.py:7-12,38): wav padded
        # to (orig//hop + 1)*hop; center STFT gives 1 + L//hop frames, last
        # dropped -> exactly L//hop frames == len(wav)/hop.
        n_frames = len(wav) // hop
        min_sil = float(self.bin_args.get("min_sil_duration", 0.0))
        try:
            mel2ph, mel2note, duration, ph_token, ph_list, _, midi_info = \
                get_mel2note(item["midi_info"], n_frames, hop, sr, min_sil)
        except AssertionError as e:
            raise BinarizationError(f"alignment failed: {e}") from e
        if len(ph_list) < int(self.bin_args.get("min_text", 0)):
            raise BinarizationError(f"less than min_text: {len(ph_list)}")
        if max(mel2ph) - 1 >= len(ph_token):
            raise BinarizationError("alignment/token count mismatch")
        note_pitch = [pitch_map[str(n[2])] for n in midi_info]
        note_dur = [dur_map[str(d2e(n[3]))] for n in midi_info]
        note_tempo = [tempo_map[str(n[6])] for n in midi_info]
        rec = {
            "item_name": item["item_name"],
            "wav_fn": item["wav_fn"],
            "spk_id": int(item.get("spk_id", 0)),
            "ph_token": ph_token,
            "text": ph_list,
            "note_pitch": note_pitch,
            "note_dur": note_dur,
            "note_tempo": note_tempo,
            "mel2ph": mel2ph,
            "mel2note": mel2note,
            "duration": duration,
            "wav": wav.astype(np.float16),
            "len": n_frames,
            "sec": len(wav) / sr,
        }
        if self.bin_args.get("with_f0", True):
            f0 = extract_pitch(cfg.pitch_extractor, wav, sr, hop, n_frames,
                               float(cfg.f0_min), float(cfg.f0_max))
            if f0.sum() == 0:
                raise BinarizationError("empty f0")
            rec["f0"] = f0
            rec["pitch"] = f0_to_coarse(f0)
            if self.bin_args.get("with_f0cwt", False):
                # CWT prosody decomposition (reference base_binarizer.py:
                # 309-316 — its helpers are absent upstream; see utils/
                # audio/cwt.py)
                from visinger_tpu_torch.utils.audio.cwt import (
                    get_cont_logf0,
                    get_logf0_cwt,
                )

                _, cont_lf0 = get_cont_logf0(f0)
                mean, std = float(cont_lf0.mean()), float(cont_lf0.std()) or 1.0
                cwt_spec, _scales = get_logf0_cwt(
                    (cont_lf0 - mean) / std, dt=hop / sr)
                rec["cwt_spec"] = cwt_spec.astype(np.float16)
                rec["cwt_mean"] = mean
                rec["cwt_std"] = std
        if self.bin_args.get("with_spk_embed", False):
            # voice embedding (reference base_binarizer.py:154-160; pluggable
            # registry replaces the hard resemblyzer dependency)
            from visinger_tpu_torch.utils.audio.spk_embed import (
                extract_spk_embed,
            )

            rec["spk_embed"] = extract_spk_embed(
                cfg.spk_embed_extractor, wav, sr)
        return rec
