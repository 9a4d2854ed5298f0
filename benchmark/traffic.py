"""The one traffic generator: reads a mix's parameters
(``traffic/<name>.json``) and makes its inputs from the run's seed.

Lengths.  A mix names a frame range [lo, hi] and a set size n.  The set of
score lengths is the same for every seed: n frame counts stratified over
the range, F_i = lo + (hi - lo) (i + 1/2) / n, each with a token count
stratified between F/8 and F/3 by the golden-ratio sequence and capped at
``max_tokens``.  The seed changes the order in which they come and every
token, pitch, duration, boundary, pitch curve, waveform and noise draw, so
every seed does the same work in another order.

Padding.  Rows are padded to the configuration's ``frame_buckets`` and
``token_buckets`` edges (the smallest edge at or above the length), the
rule of the port's ``VISingerDataset.collate`` and of the serving path's
bucket padding.

Content.  Tokens, pitches and durations are uniform over the vocabularies
(pad 0 excluded); ``mel2ph`` maps frames monotonically onto tokens 1..N at
random boundaries, as ``data/synthetic.py::synthetic_batch`` does; the
pitch is 220 Hz · 2^(z/6) per token with three unvoiced runs, and the
waveform a tone on that pitch with noise, as ``chip_smoke.py::write_corpus``
writes them; ``f0`` and ``uv`` are its log2(f0 + 1) interpolated through
the unvoiced frames and the unvoiced flags, as the dataset's
``norm_interp_f0`` gives them.

Mix kinds.  ``train``: a pool of ``pool_batches`` batches of ``batch``
items, the set sorted by length and cut into consecutive batches (as a
length-sorted sampler groups them), visited in a seed-made order.
``synth``: a book of scores, each client renders the book in a seed-made
order, one cycle after another; the ``clients`` outstanding scores form
one group."""

from __future__ import annotations

import bisect
import json
from pathlib import Path

import numpy as np

GOLDEN = 0.6180339887498949
RESERVED = 4          # token ids below this are the pad, EOS, UNK and SEG rows


def load(root: Path, name: str) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def edge(value: int, edges) -> int:
    """The smallest bucket edge at or above ``value``."""
    i = bisect.bisect_left(list(edges), value)
    if i == len(edges):
        raise ValueError(f"length {value} exceeds the largest edge "
                         f"{edges[-1]}")
    return int(edges[i])


def length_set(mix: dict, n: int) -> list[tuple[int, int]]:
    """The seed-independent (frames, tokens) of the mix's ``n`` scores,
    sorted by frames."""
    lo, hi = mix["frames"]
    t_lo, t_hi = mix["tokens_per_frame"]
    out = []
    for i in range(n):
        f = int(round(lo + (hi - lo) * (i + 0.5) / n))
        share = t_lo + (t_hi - t_lo) * ((i * GOLDEN) % 1.0)
        out.append((f, max(2, min(int(round(f * share)),
                                  mix["max_tokens"]))))
    return out


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one stream of draws of ``seed``."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), stream])


def score(rng: np.random.Generator, frames: int, tokens: int,
          vocabs, hop: int = 0, sample_rate: int = 24000) -> dict:
    """One score of ``tokens`` tokens over ``frames`` frames; with ``hop``
    also its pitch curve and waveform."""
    n_ph, n_pitch, n_dur = vocabs
    cuts = np.sort(rng.choice(np.arange(1, frames), tokens - 1,
                              replace=False))
    mel2ph = np.repeat(np.arange(1, tokens + 1, dtype=np.int32),
                       np.diff(np.concatenate([[0], cuts, [frames]])))
    out = {"text_tokens": rng.integers(RESERVED, n_ph, tokens,
                                       dtype=np.int32),
           "note_pitch": rng.integers(1, n_pitch, tokens, dtype=np.int32),
           "note_dur": rng.integers(1, n_dur, tokens, dtype=np.int32),
           "mel2ph": mel2ph}
    if hop:
        hz = 220.0 * 2 ** (rng.standard_normal(tokens) / 6)
        f0 = hz[mel2ph - 1]
        for _ in range(3):                             # unvoiced runs
            a = int(rng.integers(0, frames - 20))
            f0[a:a + int(rng.integers(5, 20))] = 0.0
        phase = 2 * np.pi * np.cumsum(np.repeat(f0, hop)) / sample_rate
        out["wav"] = (0.3 * np.sin(phase) + 0.01 * rng.standard_normal(
            frames * hop)).astype(np.float32)
        uv = f0 == 0
        logf0 = np.log2(f0 + 1.0)
        if uv.all():
            logf0[:] = 0.0
        elif uv.any():
            logf0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0],
                                  logf0[~uv])
        out["f0"] = logf0.astype(np.float32)
        out["uv"] = uv.astype(np.float32)
    return out


def collate(items: list[dict], frame_edges, token_edges, hop: int) -> dict:
    """Training items padded to their bucket edges (numpy)."""
    b = len(items)
    t = edge(max(len(it["mel2ph"]) for it in items), frame_edges)
    n = edge(max(len(it["text_tokens"]) for it in items), token_edges)
    batch = {k: np.zeros((b, n), np.int32)
             for k in ("text_tokens", "note_pitch", "note_dur")}
    batch.update(
        text_lengths=np.zeros((b,), np.int32),
        mel2ph=np.zeros((b, t), np.int32),
        mel_lengths=np.zeros((b,), np.int32),
        f0=np.zeros((b, t), np.float32), uv=np.zeros((b, t), np.float32),
        wavs=np.zeros((b, t * hop), np.float32),
        spk_ids=np.zeros((b,), np.int32),
        item_weights=np.ones((b,), np.float32))
    for i, it in enumerate(items):
        nl, tl = len(it["text_tokens"]), len(it["mel2ph"])
        for k in ("text_tokens", "note_pitch", "note_dur"):
            batch[k][i, :nl] = it[k]
        batch["text_lengths"][i] = nl
        batch["mel2ph"][i, :tl] = it["mel2ph"]
        batch["mel_lengths"][i] = tl
        batch["f0"][i, :tl] = it["f0"]
        batch["uv"][i, :tl] = it["uv"]
        batch["wavs"][i, :tl * hop] = it["wav"]
    return batch


def train_pool(mix: dict, cfg, vocabs, seed: int) -> tuple[list, list]:
    """(the pool's batches in visiting order, each batch's slice starts):
    numpy batches padded to the bucket edges, and for each item the start
    of its ``segment_size``-frame slice, drawn within its valid frames as
    the port's ``slice_starts`` draws them."""
    b, n_batches = mix["batch"], mix["pool_batches"]
    lengths = length_set(mix, b * n_batches)
    rng = seed_rng(seed, 1)
    batches, starts = [], []
    for j in rng.permutation(n_batches):
        group = [lengths[j * b + i] for i in rng.permutation(b)]
        items = [score(rng, f, n, vocabs, cfg.hop_size, cfg.sample_rate)
                 for f, n in group]
        batch = collate(items, cfg.frame_buckets, cfg.token_buckets,
                        cfg.hop_size)
        u = rng.random(b)
        ids_max = np.maximum(batch["mel_lengths"] - cfg.segment_size + 1, 1)
        batches.append(batch)
        starts.append((u * ids_max).astype(np.int64))
    return batches, starts


class SynthBook:
    """The requests of a ``synth`` mix, group after group: request r of the
    sequence is the (r mod n)-th score of cycle r // n's seed-made order,
    its rows padded to the bucket edges as the serving path pads a score."""

    def __init__(self, mix: dict, cfg, vocabs, seed: int):
        self.mix, self.cfg, self.vocabs, self.seed = mix, cfg, vocabs, seed
        self.clients = mix["clients"]
        self.lengths = length_set(mix, mix["book"])
        self._orders: dict[int, np.ndarray] = {}

    def _order(self, cycle: int) -> np.ndarray:
        if cycle not in self._orders:
            self._orders[cycle] = seed_rng(self.seed, 1000 + cycle
                                           ).permutation(len(self.lengths))
        return self._orders[cycle]

    def _which(self, r: int) -> int:
        n = len(self.lengths)
        return int(self._order(r // n)[r % n])

    def group_shape(self, g: int) -> tuple[int, int]:
        """(frame edge, token edge) group ``g`` is padded to."""
        picks = [self.lengths[self._which(r)] for r in
                 range(g * self.clients, (g + 1) * self.clients)]
        return (edge(max(f for f, _ in picks), self.cfg.frame_buckets),
                edge(max(n for _, n in picks), self.cfg.token_buckets))

    def request(self, r: int) -> dict:
        """Request ``r``: token rows [N_edge] and ``mel2ph`` [T_edge],
        zero-padded at the tail."""
        f, n = self.lengths[self._which(r)]
        s = score(seed_rng(self.seed, 10 ** 6 + r), f, n, self.vocabs)
        t_pad = edge(f, self.cfg.frame_buckets)
        n_pad = edge(n, self.cfg.token_buckets)
        out = {k: np.zeros(n_pad, np.int32)
               for k in ("text_tokens", "note_pitch", "note_dur")}
        for k in out:
            out[k][:n] = s[k]
        out["mel2ph"] = np.zeros(t_pad, np.int32)
        out["mel2ph"][:f] = s["mel2ph"]
        return out

    def group(self, g: int) -> list[dict]:
        return [self.request(r) for r in
                range(g * self.clients, (g + 1) * self.clients)]

    def call_seed(self, g: int) -> int:
        """The seed of group ``g``'s prior noise."""
        return int(seed_rng(self.seed, 2).integers(0, 2 ** 62)) + g
