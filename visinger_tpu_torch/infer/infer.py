"""Batched synthesis of token requests (counterpart of the JAX package's
``VISingerInfer._infer`` and ``synthesize_batch``, from token batches on; the
MIDI front end comes with a later slice).

A request is a dict of int arrays ``text_tokens``, ``note_pitch``,
``note_dur`` ([N] or [1, N]), ``mel2ph`` ([T] or [1, T], zero-padded only at
the tail) and optionally ``spk_ids`` — the format the JAX
``_pad_to_bucket`` produces.  Requests are served ``max_sentences`` at a
time; each group is padded to its own longest item (no buckets).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from visinger_tpu_torch.config import Config
from visinger_tpu_torch.models.factory import resolve_device

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
