"""Device-resident dataset store (the counterpart of the JAX package's
``data/device_store.py``): the whole split is uploaded to the device once,
so a training step reads no batch from the host.  Each step gathers its
rows with ``index_select`` from a [B] index vector on the device and slices
them to the batch's bucket.

Layout: items padded to the largest bucket (wavs float32, or int16 PCM
when ``store_wav_f32`` is false; f0 float32; uv int8; mel2ph int32; a
[n, 3, N] token block of phonemes, note pitches and note durations; frame
and token lengths; speaker ids).
"""

from __future__ import annotations

import numpy as np
import torch

from visinger_tpu_torch.data.dataset import (VISingerDataset, bucket_edge,
                                             epoch_plan)


class DeviceStore:
    """Padded tensors of one split on ``device``, and host-side epoch
    plans."""

    def __init__(self, ds: VISingerDataset, device):
        cfg = ds.cfg
        self.cfg = cfg
        self.hop = cfg.hop_size
        n = len(ds)
        t_max = max(cfg.frame_buckets)
        n_max = max(cfg.token_buckets)
        wav_dtype = np.float32 if cfg.store_wav_f32 else np.int16
        wavs = np.zeros((n, t_max * self.hop), wav_dtype)
        f0 = np.zeros((n, t_max), np.float32)
        uv = np.zeros((n, t_max), np.int8)
        mel2ph = np.zeros((n, t_max), np.int32)
        tokens = np.zeros((n, 3, n_max), np.int32)
        lengths = np.zeros((n,), np.int32)
        tok_lengths = np.zeros((n,), np.int32)
        spk = np.zeros((n,), np.int32)
        spk_embed = None
        for i in range(n):
            it = ds[i]
            if "spk_embed" in it:
                if spk_embed is None:
                    spk_embed = np.zeros((n, len(it["spk_embed"])), np.float32)
                spk_embed[i] = it["spk_embed"]
            t = min(len(it["mel2ph"]), t_max)
            nl = min(len(it["text_tokens"]), n_max)
            w = it["wav"][: t * self.hop]
            if wav_dtype == np.int16:
                w = np.clip(w * 32767.0, -32768, 32767).astype(np.int16)
            wavs[i, : len(w)] = w
            f0[i, :t] = it["f0"][:t]
            uv[i, :t] = it["uv"][:t]
            mel2ph[i, :t] = it["mel2ph"][:t]
            tokens[i, 0, :nl] = it["text_tokens"][:nl]
            tokens[i, 1, :nl] = it["note_pitch"][:nl]
            tokens[i, 2, :nl] = it["note_dur"][:nl]
            lengths[i] = t
            tok_lengths[i] = nl
            spk[i] = it["spk_id"]
        host = {"wavs": wavs, "f0": f0, "uv": uv, "mel2ph": mel2ph,
                "tokens": tokens, "mel_lengths": lengths,
                "text_lengths": tok_lengths, "spk_ids": spk}
        if spk_embed is not None:
            host["spk_embed"] = spk_embed
        self.arrays = {k: torch.from_numpy(v).to(device)
                       for k, v in host.items()}
        self.item_lengths = lengths
        self.item_tok_lengths = tok_lengths
        self.frame_buckets = list(cfg.frame_buckets)
        self.token_buckets = list(cfg.token_buckets)

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def plan_batches(self, max_tokens=None, max_sentences=None, shuffle=True,
                     seed=0) -> list[tuple[np.ndarray, int, int]]:
        """One epoch as [(item indices [B] int32, frame bucket, token
        bucket)]: the dataset's plan (``epoch_plan``) with each batch padded
        to ``max_sentences`` by repeating its last index."""
        cfg = self.cfg
        max_tokens = max_tokens or cfg.max_tokens
        max_sentences = max_sentences or cfg.max_sentences
        plans = []
        for idx in epoch_plan(self.item_lengths, max_tokens, max_sentences,
                              shuffle, seed):
            idx = list(idx) + [idx[-1]] * (max_sentences - len(idx))
            t_b = bucket_edge(int(self.item_lengths[idx].max()),
                              self.frame_buckets)
            n_b = bucket_edge(int(self.item_tok_lengths[idx].max()),
                              self.token_buckets)
            plans.append((np.asarray(idx, np.int32), t_b, n_b))
        return plans


def gather_batch(arrays: dict, idxs: torch.Tensor, t_bucket: int,
                 n_bucket: int, hop: int, rows: slice | None = None) -> dict:
    """The batch of rows ``idxs`` ([B], on the store's device), sliced to
    the bucket (sliced before the gather, so the padding past the bucket is
    not copied): the host collate's fields and dtypes (int16 wavs stay int16;
    the step dequantizes).  Plans pad a batch by repeating its last index
    and real indices in a batch are unique, so a row equal to its left
    neighbour is padding: item weight 0.  ``rows`` (a data-parallel rank's
    share of the batch): only those rows are gathered, with the weights
    they have in the whole batch."""
    weights = torch.cat([torch.ones(1, device=idxs.device),
                         (idxs[1:] != idxs[:-1]).float()])
    if rows is not None:
        idxs, weights = idxs[rows], weights[rows]

    def g(name, width=None):
        a = arrays[name]
        return (a if width is None else a[:, :width]).index_select(0, idxs)

    tokens = g("tokens")[:, :, :n_bucket]
    out = {
        "item_weights": weights,
        "wavs": g("wavs", t_bucket * hop),
        "f0": g("f0", t_bucket),
        "uv": g("uv", t_bucket).float(),
        "mel2ph": g("mel2ph", t_bucket),
        "text_tokens": tokens[:, 0],
        "note_pitch": tokens[:, 1],
        "note_dur": tokens[:, 2],
        # clamped into the bucket (plans guarantee the fit)
        "mel_lengths": g("mel_lengths").clamp(max=t_bucket),
        "text_lengths": g("text_lengths").clamp(max=n_bucket),
        "spk_ids": g("spk_ids"),
    }
    if "spk_embed" in arrays:
        out["spk_embed"] = g("spk_embed")
    return out
