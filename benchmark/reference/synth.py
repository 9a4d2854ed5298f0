"""Batched synthesis in plain PyTorch: a frozen copy of the port's
``TorchSynthesizer.synthesize`` and its ``collate``.  A group is padded to
its longest request; the prior noise is drawn on the device from a
generator seeded by the call's seed, as the port draws it, so the same
seed gives the same noise.

Ties.  Inference gates the predicted log-f0 by a hard threshold, voiced
where the predicted uv logit is <= 0.  A frame whose logit lies within
rounding of 0 may fall either way in two sound float32 computations, and
the two waveforms then differ by far more than rounding.  ``candidates``
finds such frames itself, from its own logits (within ``tie`` of the
row's peak |logit| over its valid frames, at most ``MAX_TIES`` a row,
the nearest to 0 first), and gives each request's waveform on every
combination of their two sides, the plain one first."""

from __future__ import annotations

import numpy as np
import torch

_TOKEN_KEYS = ("text_tokens", "note_pitch", "note_dur")
MAX_TIES = 4          # tied frames of a row tried both ways


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
        t_valid.append(int((m > 0).sum()))
    return batch, t_valid


def tied_frames(logit: torch.Tensor, valid: torch.Tensor,
                tie: float) -> list[list[int]]:
    """For each row of ``logit`` [B, T], the valid frames whose value lies
    within ``tie`` of the row's peak |value| of 0: at most ``MAX_TIES``,
    the nearest to 0 first."""
    out = []
    for row, ok in zip(logit.float().abs().cpu(), valid.cpu()):
        if tie <= 0 or not bool(ok.any()):
            out.append([])
            continue
        near = torch.where(ok & (row < tie * row[ok].max()))[0]
        near = near[torch.argsort(row[near])][:MAX_TIES]
        out.append([int(f) for f in near])
    return out


@torch.no_grad()
def candidates(model, requests: list[dict], seed: int, hop: int, device,
               tie: float = 0.0) -> list[list[np.ndarray]]:
    """One group of requests -> for each request its waveforms, trimmed to
    its valid frames: the plain one, then one for each other combination
    of the sides of its tied frames (none when ``tie`` is 0)."""
    from .visinger import _sample

    batch, t_valid = collate(requests)
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    model.eval()
    args = (t["text_tokens"], t["note_pitch"], t["note_dur"], t["mel2ph"])
    stats = model.prior_stats(*args, spk_id=t["spk_ids"])
    ties = ([[]] * len(requests) if "f0_pred" not in stats else
            tied_frames(stats["f0_pred"][..., 1], t["mel2ph"] > 0, tie))
    out = [[] for _ in requests]
    for c in range(2 ** max(len(x) for x in ties)):
        if c:
            flip = torch.zeros(t["mel2ph"].shape, dtype=torch.bool,
                               device=t["mel2ph"].device)
            for r, frames in enumerate(ties):
                for bit, f in enumerate(frames):
                    flip[r, f] = bool((c >> bit) & 1)
            stats = model.prior_stats(*args, spk_id=t["spk_ids"], flip=flip)
        gen = torch.Generator(device=device).manual_seed(seed)
        z_p = _sample(stats, None, gen)
        wav = model.decode_frames(z_p, stats["tgt_nonpadding"],
                                  spk_id=t["spk_ids"]).cpu().numpy()
        for r, tv in enumerate(t_valid):
            if c < 2 ** len(ties[r]):
                out[r].append(wav[r, :tv * hop])
    return out


def synthesize_group(model, requests: list[dict], seed: int, hop: int,
                     device) -> list[np.ndarray]:
    """One group of requests -> each request's waveform, trimmed to its
    valid frames."""
    return [c[0] for c in candidates(model, requests, seed, hop, device)]
