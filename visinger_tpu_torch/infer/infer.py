"""MIDI -> waveform serving (counterpart of the JAX package's
``infer/infer.py``): ``VISingerInfer`` and, below it, ``TorchSynthesizer``,
batched synthesis of pre-tokenised requests.

``VISingerInfer`` parses a MIDI file, phonemizes its syllables, assembles
<BOS>/<EOS> token rows (with an optional pitch transpose), builds the frame
alignment from the MIDI times (``get_note2dur``'s onset/coda rule), pads the
score to its (frame, token) bucket edges exactly as the JAX package does,
runs the prior (K1) and the flow reverse (K2) and HiFi-GAN decoder, and
returns the waveform and its real-time factor.  Scores longer than the
largest frame bucket are split into phrases.  With ``stream_infer`` the
decode runs window by window (``infer/streaming.py``).  The prior noise of a
score is drawn on the CPU from a ``torch.Generator`` seeded by ``seed``
([1, t_pad, H] per score), so a score's audio depends on the score and the
seed alone, on every device and in every group.

``TorchSynthesizer`` serves requests, dicts of int arrays ``text_tokens``,
``note_pitch``, ``note_dur`` ([N] or [1, N]), ``mel2ph`` ([T] or [1, T],
zero-padded only at the tail) and optionally ``spk_ids`` — the format the
JAX ``_pad_to_bucket`` produces — ``max_sentences`` at a time; each group is
padded to its own longest item (no buckets).
"""

from __future__ import annotations

import bisect
import json
import time
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from visinger_tpu_torch.config import Config, check_supported
from visinger_tpu_torch.convert import params_from_jax
from visinger_tpu_torch.data.binarizer import build_dur_codec
from visinger_tpu_torch.data.preprocess import (midi_to_encoding,
                                                second_pass, split_syllables)
from visinger_tpu_torch.infer.streaming import StreamingSynthesizer
from visinger_tpu_torch.models.factory import build_model, resolve_device
from visinger_tpu_torch.utils.audio.align import get_note2dur
from visinger_tpu_torch.utils.audio.io import save_wav
from visinger_tpu_torch.utils.midi import MidiFile
from visinger_tpu_torch.utils.text.token_encoder import build_token_encoder

_TOKEN_KEYS = ("text_tokens", "note_pitch", "note_dur")


@dataclass
class SynthesisResult:
    wavs: list            # per request, float32 [t_valid * hop]
    rtf: float            # synthesis seconds / audio seconds, all groups
    group_seconds: list   # wall seconds per group, device synchronised


def _flat(a) -> np.ndarray:
    return np.asarray(a, np.int64).reshape(-1)


def collate(requests: list[dict]) -> tuple[dict, list[int]]:
    """Pad requests to the group's longest token and frame counts ->
    ([B, N] / [B, T] int64 arrays, valid frame counts)."""
    n_max = max(len(_flat(r["text_tokens"])) for r in requests)
    t_max = max(len(_flat(r["mel2ph"])) for r in requests)
    b = len(requests)
    batch = {k: np.zeros((b, n_max), np.int64) for k in _TOKEN_KEYS}
    batch["mel2ph"] = np.zeros((b, t_max), np.int64)
    batch["spk_ids"] = np.zeros((b,), np.int64)
    t_valid = []
    for i, r in enumerate(requests):
        for k in _TOKEN_KEYS:
            v = _flat(r[k])
            batch[k][i, :len(v)] = v
        m = _flat(r["mel2ph"])
        batch["mel2ph"][i, :len(m)] = m
        if "spk_ids" in r:
            batch["spk_ids"][i] = _flat(r["spk_ids"])[0]
        t_valid.append(int((m > 0).sum()))
    return batch, t_valid


class TorchSynthesizer:
    def __init__(self, cfg: Config, model: torch.nn.Module, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def synthesize(self, batch: dict, generator=None) -> torch.Tensor:
        """One padded batch (numpy, as ``collate`` gives) -> wav [B, T*hop]
        on the device."""
        t = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        z_p, mask = self.model.infer_prior(
            t["text_tokens"], t["note_pitch"], t["note_dur"], t["mel2ph"],
            spk_id=t["spk_ids"], generator=generator)
        return self.model.decode_frames(z_p, mask, spk_id=t["spk_ids"])

    def synthesize_batch(self, requests: list[dict],
                         seed: int = 0) -> SynthesisResult:
        """Serve ``requests`` in groups of ``cfg.max_sentences``; returns each
        request's waveform trimmed to its valid length and the batch RTF."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        wavs, group_seconds, audio_s = [], [], 0.0
        for at in range(0, len(requests), cfg.max_sentences):
            batch, t_valid = collate(requests[at:at + cfg.max_sentences])
            t0 = time.perf_counter()
            wav = self.synthesize(batch, generator=gen)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            group_seconds.append(time.perf_counter() - t0)
            wav = wav.cpu().numpy()
            for i, tv in enumerate(t_valid):
                wavs.append(wav[i, :tv * cfg.hop_size])
                audio_s += tv * cfg.hop_size / cfg.sample_rate
        return SynthesisResult(wavs, sum(group_seconds) / max(audio_s, 1e-9),
                               group_seconds)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class VISingerInfer:
    """MIDI file -> waveform on ``device`` (CUDA unless the CPU is asked
    for).  ``model`` is a built port ``VISinger`` or a JAX generator
    parameter tree (nested dict of numpy arrays), converted by
    ``convert.params_from_jax`` into a model with the vocabularies of
    ``data_dir``'s ``phone_set.json``, ``pitch_map.json`` and
    ``dur_map.json`` (default ``cfg.binary_data_dir``)."""

    def __init__(self, cfg: Config, model, data_dir: str | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        data_dir = data_dir or cfg.binary_data_dir
        self.ph_encoder = build_token_encoder(f"{data_dir}/phone_set.json")
        with open(f"{data_dir}/pitch_map.json") as f:
            self.pitch_map = json.load(f)
        with open(f"{data_dir}/dur_map.json") as f:
            self.dur_map = json.load(f)
        if isinstance(model, Mapping):
            params = model
            model = build_model(cfg, len(self.ph_encoder), len(self.pitch_map),
                                len(self.dur_map), device="cpu")
            model.load_state_dict(params_from_jax(params), strict=True)
        self.model = model.to(self.device).eval()
        self._streamer = (StreamingSynthesizer(cfg, self.model,
                                               device=self.device)
                          if cfg.stream_infer else None)
        self.last_group_seconds: list[float] = []

    # ------------------------------------------------------------------
    def score_rows(self, midi_fn: str, lyrics: list[str] | None = None,
                   pitch_control: int = 0) -> list[list]:
        """MIDI file -> tokenized per-phoneme sub-note rows (9 fields)."""
        cfg = self.cfg
        midi = MidiFile(midi_fn)
        rows, _min_sil, _text = midi_to_encoding(
            midi, dict(cfg.preprocess_args), lyrics)
        _ph_list, sub_rows = split_syllables(rows, cfg)
        rows9, _phs, _ph_tokens = second_pass(sub_rows, self.ph_encoder, 0)
        if pitch_control:
            for r in rows9:
                if r[2] > 0:
                    r[2] = int(np.clip(r[2] + pitch_control,
                                       cfg.note_range[0],
                                       cfg.note_range[1] - 1))
        return rows9

    def preprocess_input(self, midi_fn: str, lyrics: list[str] | None = None,
                         pitch_control: int = 0) -> dict:
        """MIDI file -> model input arrays (one score)."""
        return self.rows_to_inputs(
            self.score_rows(midi_fn, lyrics, pitch_control))

    def rows_to_inputs(self, rows9: list) -> dict:
        cfg = self.cfg
        mel2ph, _mel2note, _duration, _ph_list, cleaned = get_note2dur(
            [[r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[8], r[8]]
             for r in rows9],
            cfg.hop_size, cfg.sample_rate,
            min_sil_duration=float(cfg.binarization_args.get(
                "min_sil_duration", 0.0)),
            num_frame=cfg.preprocess_args.num_frame)
        d2e, _ = build_dur_codec(self.bin_arg("max_durations", 8),
                                 self.bin_arg("pos_resolution", 16))
        note_pitch = [self.pitch_map.get(str(r[2]), 0) for r in cleaned]
        note_dur = [self.dur_map.get(str(d2e(r[3])), 0) for r in cleaned]
        text_tokens = []
        for r in cleaned:
            text_tokens.extend(self.ph_encoder.encode(r[7]))
        if len(text_tokens) != max(mel2ph):
            raise ValueError(
                f"malformed score: {len(text_tokens)} phoneme tokens but the "
                f"frame alignment covers {max(mel2ph)} tokens — the MIDI's "
                "notes/lyrics are inconsistent (check overlapping notes, "
                "empty lyrics, or a lyric/note count mismatch)")
        return {
            "text_tokens": np.asarray(text_tokens, np.int32),
            "note_pitch": np.asarray(note_pitch, np.int32),
            "note_dur": np.asarray(note_dur, np.int32),
            "mel2ph": np.asarray(mel2ph, np.int32),
        }

    def bin_arg(self, key, default):
        return int(self.cfg.binarization_args.get(key, default))

    # ------------------------------------------------------------------
    def _pad_to_bucket(self, inp: dict) -> tuple[dict, int]:
        """One score -> (a batch of 1 padded to the first frame and token
        bucket edges at or above its lengths, or unpadded past the largest,
        valid frames).  The padding sets the numerics (the token positions
        depend on the padded count; padded frames move the tail samples),
        so it is the JAX package's."""
        cfg = self.cfg
        t = len(inp["mel2ph"])
        buckets = list(cfg.frame_buckets)
        ti = bisect.bisect_left(buckets, t)
        t_pad = buckets[ti] if ti < len(buckets) else t
        n = len(inp["text_tokens"])
        tok_buckets = list(cfg.token_buckets)
        ni = bisect.bisect_left(tok_buckets, n)
        n_pad = tok_buckets[ni] if ni < len(tok_buckets) else n
        batch = {
            "text_tokens": np.zeros((1, n_pad), np.int32),
            "note_pitch": np.zeros((1, n_pad), np.int32),
            "note_dur": np.zeros((1, n_pad), np.int32),
            "mel2ph": np.zeros((1, t_pad), np.int32),
            "spk_ids": np.zeros((1,), np.int32),
        }
        batch["text_tokens"][0, :n] = inp["text_tokens"]
        batch["note_pitch"][0, :n] = inp["note_pitch"][:n]
        batch["note_dur"][0, :n] = inp["note_dur"][:n]
        batch["mel2ph"][0, :t] = inp["mel2ph"]
        return batch, t

    def prior_noise(self, t_pad: int, seed: int) -> torch.Tensor:
        """A score's prior noise eps [1, t_pad, H], drawn on the CPU."""
        gen = torch.Generator().manual_seed(seed)
        return torch.randn(1, t_pad, self.cfg.hidden_size, generator=gen)

    @torch.no_grad()
    def _infer(self, batch: dict, eps: torch.Tensor) -> torch.Tensor:
        """Padded batch (tensors on the device) and eps -> wav [B, T*hop]."""
        if self._streamer is not None:
            return self._streamer.synthesize(batch, eps)
        z_p, mask = self.model.infer_prior(
            batch["text_tokens"], batch["note_pitch"], batch["note_dur"],
            batch["mel2ph"], spk_id=batch["spk_ids"], eps=eps)
        return self.model.decode_frames(z_p, mask, spk_id=batch["spk_ids"])

    def _run(self, rows: list[dict], seed: int) -> tuple[np.ndarray, float]:
        """Padded batches of 1 with one bucket pair -> (wavs [B, T*hop],
        wall seconds from the inputs on the device to the waveform ready
        there)."""
        dev = self.device
        batch = {k: torch.from_numpy(np.concatenate([r[k] for r in rows]))
                 .long().to(dev) for k in rows[0]}
        eps = torch.cat([self.prior_noise(r["mel2ph"].shape[1], seed)
                         for r in rows]).to(dev)
        _synchronize(dev)
        t0 = time.perf_counter()
        wav = self._infer(batch, eps)
        _synchronize(dev)
        dt = time.perf_counter() - t0
        return wav.cpu().numpy(), dt

    # ------------------------------------------------------------------
    @staticmethod
    def divide_phrases(rows9: list, max_frames: int, hop: int,
                       sr: int) -> list[list]:
        """Split a long score into phrases so each chunk fits ``max_frames``.

        Split points prefer silence rows; a long passage with no internal
        silence falls back to the most recent bar boundary, the reference's
        split key (inference/visinger.py:106-148 groups rows by bar).  A
        single bar longer than ``max_frames`` cannot be split and stays
        oversized (the reference never splits inside a bar either)."""
        # pass 1: choose the row indices that start each new phrase
        splits = [0]
        cur_start_t = 0.0
        last_bar_boundary = 0
        for i, row in enumerate(rows9):
            if i > splits[-1] and row[0] != rows9[i - 1][0]:
                last_bar_boundary = i
            end_frames = int((row[5] - cur_start_t) * sr / hop + 0.5)
            if i <= splits[-1] or end_frames <= max_frames:
                continue
            if row[8][0] in ("|", "<BOS>", "<EOS>"):
                j = i
            elif last_bar_boundary > splits[-1]:
                j = last_bar_boundary
            else:
                continue  # mid-bar with no boundary behind us: keep growing
            splits.append(j)
            cur_start_t = rows9[j][4]
        # pass 2: materialize phrases with times re-based to each start
        phrases = []
        bounds = splits + [len(rows9)]
        for s, e in zip(bounds[:-1], bounds[1:]):
            t0 = rows9[s][4] if s else 0.0
            phrases.append([[r[0], r[1], r[2], r[3], r[4] - t0, r[5] - t0,
                             r[6], r[7], r[8]] for r in rows9[s:e]])
        return phrases

    def _phrases(self, rows9: list) -> list[list]:
        cfg = self.cfg
        max_frames = max(cfg.frame_buckets)
        total_frames = int(rows9[-1][5] * cfg.sample_rate / cfg.hop_size
                           + 0.5)
        if total_frames <= max_frames:
            return [rows9]
        return self.divide_phrases(rows9, max_frames, cfg.hop_size,
                                   cfg.sample_rate)

    def synthesize(self, midi_fn: str, lyrics: list[str] | None = None,
                   pitch_control: int = 0, seed: int = 0
                   ) -> tuple[np.ndarray, float]:
        """-> (waveform float32, rtf), rtf = synthesis seconds / audio
        seconds.  Scores longer than the largest frame bucket are split into
        phrases and synthesized one after another."""
        cfg = self.cfg
        rows9 = self.score_rows(midi_fn, lyrics, pitch_control)
        wavs, dt_total = [], 0.0
        for phrase in self._phrases(rows9):
            batch, t_valid = self._pad_to_bucket(self.rows_to_inputs(phrase))
            wav, dt = self._run([batch], seed)
            dt_total += dt
            wavs.append(wav[0, :t_valid * cfg.hop_size])
        wav = np.concatenate(wavs)
        audio_s = len(wav) / cfg.sample_rate
        return wav, dt_total / max(audio_s, 1e-9)

    def to_file(self, midi_fn: str, out_fn: str, **kw) -> float:
        wav, rtf = self.synthesize(midi_fn, **kw)
        save_wav(wav, out_fn, self.cfg.sample_rate,
                 norm=bool(self.cfg.out_wav_norm))
        return rtf

    # ------------------------------------------------------------------
    def synthesize_batch(self, midi_fns: list[str], pitch_control: int = 0,
                         seed: int = 0, max_sentences: int | None = None
                         ) -> list[dict]:
        """Batched serving: synthesize many scores, ``max_sentences`` at a
        time, grouped by (frame, token) bucket pair; each group is padded to
        ``max_sentences`` rows by repeating its last row.  Scores longer
        than the largest frame bucket fall back to per-file ``synthesize``.
        Each score gets the noise it gets alone, so its waveform equals
        ``synthesize``'s.

        Returns one record per input file: {fn, wav, audio_s, rtf,
        rtf_kind}; ``last_group_seconds`` holds each group's wall seconds."""
        cfg = self.cfg
        max_bs = max_sentences or int(cfg.max_sentences)
        max_frames = max(cfg.frame_buckets)
        singles: list[tuple[int, str]] = []
        grouped: dict[tuple[int, int], list] = {}
        for pos, fn in enumerate(midi_fns):
            rows9 = self.score_rows(fn, pitch_control=pitch_control)
            total_frames = int(rows9[-1][5] * cfg.sample_rate
                               / cfg.hop_size + 0.5)
            if total_frames > max_frames:
                singles.append((pos, fn))
                continue
            b1, t_valid = self._pad_to_bucket(self.rows_to_inputs(rows9))
            key = (b1["mel2ph"].shape[1], b1["text_tokens"].shape[1])
            grouped.setdefault(key, []).append((pos, fn, b1, t_valid))
        results: list[dict | None] = [None] * len(midi_fns)
        self.last_group_seconds = []
        for items in grouped.values():
            for chunk_at in range(0, len(items), max_bs):
                chunk = items[chunk_at:chunk_at + max_bs]
                rows = chunk + [chunk[-1]] * (max_bs - len(chunk))
                wavs, dt = self._run([r[2] for r in rows], seed)
                self.last_group_seconds.append(dt)
                audio_s = sum(r[3] for r in chunk) * cfg.hop_size \
                    / cfg.sample_rate
                for i, (pos, fn, _b, t_valid) in enumerate(chunk):
                    results[pos] = {
                        "fn": fn, "wav": wavs[i, :t_valid * cfg.hop_size],
                        "audio_s": t_valid * cfg.hop_size / cfg.sample_rate,
                        "rtf": dt / max(audio_s, 1e-9),
                        "rtf_kind": "batch_mean",
                    }
        for pos, fn in singles:
            wav, rtf = self.synthesize(fn, pitch_control=pitch_control,
                                       seed=seed)
            results[pos] = {"fn": fn, "wav": wav,
                            "audio_s": len(wav) / cfg.sample_rate,
                            "rtf": rtf, "rtf_kind": "per_item"}
        return results  # type: ignore[return-value]
