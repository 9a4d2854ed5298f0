"""Sequence-parallel (time-sharded) synthesis of one score over the ranks
(the counterpart of the JAX package's ``parallel/sp.py``).

The JAX package shards the frame axis of every layer over a device mesh
and lets XLA's SPMD partitioner place the halo exchanges.  The port splits
the infer path where the streaming decode does (``infer/streaming.py``):

- every rank runs the prior (text encoder, pitch predictor, frame prior:
  the attention layers, K1) on the whole score, with the same noise, so
  every rank holds the same z_p;
- rank r decodes its contiguous range of T / world frames (flow reverse,
  K2, and HiFi-GAN) from a window that carries ``halo_frames(cfg)`` frames
  of context on each side, clamped inside the score: a window edge only
  falls on a true score edge, where the window's zero padding is the full
  decode's, so the piece equals the full-length decode's samples;
- the pieces are gathered with one all-reduce into a zeroed full-length
  buffer (each rank adds its range and zeros elsewhere, exact in floating
  point; gloo takes CUDA tensors in ``all_reduce`` but not in
  ``all_gather``).

The waveform is the single-device one; the attention layers are not
sharded.  The frame count is padded to a multiple of the world size
(``pad_frames_for_mesh``) as the JAX package pads it, so the noise has
JAX's shape and a score's audio equals JAX's for the same noise.
``make_sp_mesh`` and ``jit_sp_infer`` have no counterpart: the ranks are
the process group, and ``sp_decode`` is called eagerly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from visinger_tpu_torch.infer.streaming import halo_frames
from visinger_tpu_torch.parallel import mesh


def pad_frames_for_mesh(n_frames: int, world: int) -> int:
    """Frame count rounded up so the frame axis divides ``world``."""
    return -(-n_frames // world) * world


@torch.no_grad()
def sp_piece(model, z_p: torch.Tensor, mask: torch.Tensor, rank: int,
             world: int, halo: int | None = None, spk_id=None,
             spk_embed=None) -> torch.Tensor:
    """Rank ``rank``'s waveform piece [B, (T / world) * hop] of the decode
    of z_p [B, T, H] under mask [B, T, 1]: ``model.decode_frames`` on the
    rank's frames and ``halo`` frames of context (default
    ``halo_frames(model.cfg)``) on each side, clamped to [0, T].  A pure
    function of its inputs, so one process can run every rank's piece."""
    t = z_p.shape[1]
    own = mesh.host_batch_slice(t, rank, world)
    s, e = own.start, own.stop
    halo = halo_frames(model.cfg) if halo is None else halo
    w0, w1 = max(s - halo, 0), min(e + halo, t)
    hop = int(model.cfg.hop_size)
    wav = model.decode_frames(z_p[:, w0:w1], mask[:, w0:w1], spk_id=spk_id,
                              spk_embed=spk_embed)
    return wav[:, (s - w0) * hop:(e - w0) * hop]


@torch.no_grad()
def sp_decode(model, z_p: torch.Tensor, mask: torch.Tensor, spk_id=None,
              spk_embed=None, halo: int | None = None) -> torch.Tensor:
    """The full waveform [B, T * hop] on every rank, each rank decoding its
    piece (``sp_piece``) and one all-reduce gathering them.  Every rank
    passes the same z_p, mask and voice.  Without a process group it is
    the one piece of a world of 1."""
    world, rank = mesh.world_size(), mesh.rank()
    piece = sp_piece(model, z_p, mask, rank, world, halo, spk_id, spk_embed)
    if world == 1:
        return piece
    b, n = piece.shape
    out = piece.new_zeros(b, n * world)
    out[:, rank * n:(rank + 1) * n] = piece
    dist.all_reduce(out)
    return out
