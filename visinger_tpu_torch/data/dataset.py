"""Binarized records -> padded numpy batches (an own copy of the JAX
package's ``data/dataset.py``; the same seed gives the same batches).

Items are grouped fairseq-style under a frames-per-batch and
sentences-per-batch budget (``batch_by_size``), and each batch is padded to
the (frame, token) bucket edges of the recipe.  The port keeps the buckets
for the numerics, not for compiled programs: the reproduced token positions
depend on the padded token count (``modules/encoders.py``), so a batch
equals the JAX package's only when it is padded to the same edges.  With
``pad_to_max_sentences`` the batch axis is padded by repeating the last
item, and those rows get ``item_weights`` 0 so every loss ignores them.

The linear spectrogram is not computed here: the train step computes it
from the waveform on the device.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Iterator, Sequence

import numpy as np

from visinger_tpu_torch.data.record_store import RecordReader
from visinger_tpu_torch.utils.audio.pitch import norm_interp_f0


def bucket_edge(value: int, buckets: Sequence[int]) -> int:
    """The smallest edge of ``buckets`` (sorted) at or above ``value``."""
    i = bisect.bisect_left(buckets, value)
    if i == len(buckets):
        raise ValueError(f"length {value} exceeds largest bucket {buckets[-1]}")
    return buckets[i]


def batch_by_size(lengths: np.ndarray, max_tokens: int, max_sentences: int,
                  indices: np.ndarray | None = None) -> list[np.ndarray]:
    """Size-sorted indices greedily grouped under a frames-per-batch budget
    (the longest item times the batch size) and ``max_sentences``."""
    if indices is None:
        indices = np.argsort(lengths, kind="mergesort")
    batches, cur, cur_max = [], [], 0
    for idx in indices:
        n = int(lengths[idx])
        new_max = max(cur_max, n)
        if cur and (len(cur) + 1 > max_sentences
                    or new_max * (len(cur) + 1) > max_tokens):
            batches.append(np.asarray(cur))
            cur, cur_max = [], 0
        cur.append(int(idx))
        cur_max = max(cur_max, n)
    if cur:
        batches.append(np.asarray(cur))
    return batches


def epoch_plan(lengths: np.ndarray, max_tokens: int, max_sentences: int,
               shuffle: bool, seed: int) -> list[np.ndarray]:
    """One epoch's batches of item indices: ``batch_by_size`` over the
    size-sorted items, in an order shuffled by ``RandomState(seed)``."""
    order = np.argsort(lengths, kind="mergesort")
    batches = batch_by_size(lengths, max_tokens, max_sentences, order)
    if shuffle:
        np.random.RandomState(seed).shuffle(batches)
    return batches


class VISingerDataset:
    """Random-access view over a binarized split: the items whose frame
    count is above ``segment_size`` and at most ``max_frames``."""

    def __init__(self, cfg, prefix: str, data_dir: str | None = None,
                 cache_items: bool | None = None):
        self.cfg = cfg
        data_dir = data_dir or cfg.binary_data_dir
        self.reader = RecordReader(f"{data_dir}/{prefix}")
        self.lengths = np.load(f"{data_dir}/{prefix}_lengths.npy")
        self.hop_size = cfg.hop_size
        self.keep = np.where((self.lengths > cfg.segment_size)
                             & (self.lengths <= cfg.max_frames))[0]
        # decoded items kept in host memory: at CSD scale they fit, and
        # decoding each step would dominate the host's share of a step
        self._cache: dict[int, dict] | None = {} if (
            cache_items if cache_items is not None
            else cfg.cache_dataset) else None

    def __len__(self) -> int:
        return len(self.keep)

    def item_length(self, i: int) -> int:
        return int(self.lengths[self.keep[i]])

    def item_lengths(self) -> np.ndarray:
        return np.asarray([self.item_length(i) for i in range(len(self))])

    def __getitem__(self, i: int) -> dict:
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        item = self.reader[int(self.keep[i])]
        t = len(item["mel2ph"])
        f0, uv = norm_interp_f0(np.asarray(item["f0"][:t], np.float64))
        out = {
            "item_name": item.get("item_name", str(i)),
            "text_tokens": np.asarray(item["ph_token"], np.int32),
            "note_pitch": np.asarray(item["note_pitch"], np.int32),
            "note_dur": np.asarray(item["note_dur"], np.int32),
            "mel2ph": np.asarray(item["mel2ph"], np.int32),
            "f0": f0,
            "uv": uv,
            "wav": np.asarray(item["wav"], np.float32),
            "spk_id": int(item.get("spk_id", 0)),
        }
        if "spk_embed" in item:
            out["spk_embed"] = np.asarray(item["spk_embed"], np.float32)
        if self._cache is not None:
            self._cache[i] = out
        return out

    # ------------------------------------------------------------------
    def collate(self, items: list[dict], frame_buckets=None, token_buckets=None,
                n_real: int | None = None) -> dict:
        """Pad ``items`` to their bucket edges.  ``n_real``: the number of
        real items; rows at index >= n_real get item_weights 0.  With
        ``ship_wav_int16`` the waveforms are int16 PCM (the step
        dequantizes them)."""
        cfg = self.cfg
        frame_buckets = frame_buckets or list(cfg.frame_buckets)
        token_buckets = token_buckets or list(cfg.token_buckets)
        b = len(items)
        n_real = b if n_real is None else n_real
        t = bucket_edge(max(len(it["mel2ph"]) for it in items), frame_buckets)
        n = bucket_edge(max(len(it["text_tokens"]) for it in items),
                        token_buckets)
        hop = self.hop_size
        wav_i16 = bool(cfg.ship_wav_int16)
        batch = {
            "text_tokens": np.zeros((b, n), np.int32),
            "note_pitch": np.zeros((b, n), np.int32),
            "note_dur": np.zeros((b, n), np.int32),
            "text_lengths": np.zeros((b,), np.int32),
            "mel2ph": np.zeros((b, t), np.int32),
            "mel_lengths": np.zeros((b,), np.int32),
            "f0": np.zeros((b, t), np.float32),
            "uv": np.zeros((b, t), np.float32),
            "wavs": np.zeros((b, t * hop),
                             np.int16 if wav_i16 else np.float32),
            "spk_ids": np.zeros((b,), np.int32),
            "item_weights": (np.arange(b) < n_real).astype(np.float32),
        }
        if "spk_embed" in items[0]:
            batch["spk_embed"] = np.stack(
                [it["spk_embed"] for it in items]).astype(np.float32)
        for i, it in enumerate(items):
            nl, tl = len(it["text_tokens"]), len(it["mel2ph"])
            batch["text_tokens"][i, :nl] = it["text_tokens"]
            batch["note_pitch"][i, :nl] = it["note_pitch"][:nl]
            batch["note_dur"][i, :nl] = it["note_dur"][:nl]
            batch["text_lengths"][i] = nl
            batch["mel2ph"][i, :tl] = it["mel2ph"]
            batch["mel_lengths"][i] = tl
            batch["f0"][i, :tl] = it["f0"][:tl]
            batch["uv"][i, :tl] = it["uv"][:tl]
            wav = it["wav"][: tl * hop]
            if wav_i16:
                wav = np.clip(wav * 32767.0, -32768, 32767).astype(np.int16)
            batch["wavs"][i, : len(wav)] = wav
            batch["spk_ids"][i] = it["spk_id"]
        return batch

    def batches(self, max_tokens: int | None = None,
                max_sentences: int | None = None, shuffle: bool = True,
                seed: int = 0, pad_to_max_sentences: bool = True,
                ) -> Iterator[dict]:
        """One epoch of padded batches (``epoch_plan``); with
        ``pad_to_max_sentences`` every batch has ``max_sentences`` rows,
        the last item repeated with weight 0."""
        cfg = self.cfg
        max_tokens = max_tokens or cfg.max_tokens
        max_sentences = max_sentences or cfg.max_sentences
        for idx in epoch_plan(self.item_lengths(), max_tokens, max_sentences,
                              shuffle, seed):
            items = [self[int(i)] for i in idx]
            n_real = len(items)
            if pad_to_max_sentences:
                while len(items) < max_sentences:
                    items.append(items[-1])
            yield self.collate(items, n_real=n_real)


# ---------------------------------------------------------------------------
# Several binarized corpora train as one dataset, provided they share the
# exact token dictionaries.
# ---------------------------------------------------------------------------

_SHARED_DICTS = ("phone_set.json", "pitch_map.json", "dur_map.json",
                 "tempo_map.json", "spk_map.json")


def check_dict_consistency(data_dirs: Sequence[str]) -> None:
    """Raise ``ValueError`` unless every corpus was binarized with the first
    one's token dictionaries: token ids mean nothing across other maps."""
    ref_dir = data_dirs[0]
    for name in _SHARED_DICTS:
        ref_fn = os.path.join(ref_dir, name)
        if not os.path.exists(ref_fn):
            continue
        with open(ref_fn) as f:
            ref = json.load(f)
        for d in data_dirs[1:]:
            with open(os.path.join(d, name)) as f:
                other = json.load(f)
            if other != ref:
                raise ValueError(
                    f"concat datasets disagree on {name}: {d} vs {ref_dir} — "
                    "re-binarize every corpus with shared dictionaries")


class ConcatVISingerDataset(VISingerDataset):
    """Several binarized corpora behind the ``VISingerDataset`` interface;
    collate and batches are inherited unchanged."""

    def __init__(self, cfg, prefix: str, data_dirs: Sequence[str]):
        check_dict_consistency(list(data_dirs))
        self.cfg = cfg
        self.hop_size = cfg.hop_size
        self.parts = [VISingerDataset(cfg, prefix, data_dir=d)
                      for d in data_dirs]
        self._index = [(p, i) for p, part in enumerate(self.parts)
                       for i in range(len(part))]

    def __len__(self) -> int:
        return len(self._index)

    def item_length(self, i: int) -> int:
        p, j = self._index[i]
        return self.parts[p].item_length(j)

    def __getitem__(self, i: int) -> dict:
        p, j = self._index[i]
        return self.parts[p][j]


def build_dataset(cfg, prefix: str) -> VISingerDataset:
    """Every corpus of ``cfg.binary_data_dirs`` as one dataset when it is
    set, else ``cfg.binary_data_dir``'s split ``prefix``."""
    if cfg.binary_data_dirs:
        return ConcatVISingerDataset(cfg, prefix, list(cfg.binary_data_dirs))
    return VISingerDataset(cfg, prefix)
