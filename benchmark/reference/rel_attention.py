"""Relative-position self-attention in plain PyTorch: a frozen copy of the
port's plain version (``rel_attention_plain``), with the counter-based
dropout hash (murmur3's finaliser over (seed, b*H+h, i, j)) that the port's
kernels use, so the reference drops the same attention entries.  The
gradient is autograd's; no kernel is called."""

from __future__ import annotations

import torch

from .masking import prefix_lengths

MASK_VAL = -1e4

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """Keep an entry when its 32 hash bits are at least this."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def dropout_bits(seed: torch.Tensor, batch: int, heads: int,
                 t: int) -> torch.Tensor:
    """[B, H, T, T] int64 tensor of the 32 hash bits of each attention entry,
    from the int32 ``seed`` tensor (one element, on the device of the
    result): bits = fmix(fmix(fmix(seed + φ·(bh+1)) ^ i) + φ·j) with
    bh = b·H + h and φ = 0x9E3779B9, as in the kernels."""
    dev = seed.device
    s = seed.reshape(()).long() & _M32
    bh = torch.arange(batch * heads, device=dev).reshape(batch, heads, 1, 1)
    k0 = _fmix32((s + _mul32(bh + 1, _GOLD)) & _M32)
    rows = torch.arange(t, device=dev).reshape(t, 1)
    cols = torch.arange(t, device=dev).reshape(1, t)
    rk = _fmix32(k0 ^ rows)
    return _fmix32((rk + _mul32(cols, _GOLD)) & _M32)


def dropout_keep(seed: torch.Tensor, batch: int, heads: int, t: int,
                 rate: float) -> torch.Tensor:
    """[B, H, T, T] bool keep mask for attention dropout at ``rate``."""
    return dropout_bits(seed, batch, heads, t) >= keep_threshold(rate)


def rel_attention_plain(q, k, v, emb_rel_k, emb_rel_v, lengths, *,
                        window: int, scale: float, seed=None,
                        rate: float = 0.0, with_stats: bool = False):
    """The same function in plain PyTorch (float32 scores and softmax).

    q, k, v: [B, T, C], float32 or bf16 (then P is rounded to bf16 before
    P·V and the band term, and the result is bf16; the rounding passes the
    gradient through unrounded, as the TPU kernel's backward computes dP in
    float32), with head h in channels [h*dk, (h+1)*dk);
    emb_rel_k/v: [2w+1, dk] shared by the heads; lengths: [B] prefix lengths;
    seed: int32 tensor of one element, needed when ``rate`` > 0.
    Returns [B, T, C]; with ``with_stats`` also K1's stats [B, H, T, 2],
    each row's score max and sum of exp(score - max).
    """
    b, t, c = q.shape
    dk = emb_rel_k.shape[1]
    nh = c // dk

    def heads(a):
        return a.reshape(b, t, nh, dk).transpose(1, 2).float()  # [B,H,T,dk]

    qh, kh, vh = heads(q), heads(k), heads(v)
    idx = torch.arange(t, device=q.device)
    off = idx[None, :] - idx[:, None]                   # j - i, [T, T]
    scores = qh @ kh.transpose(-1, -2) * scale
    rel = qh @ emb_rel_k.float().t() * scale             # [B, H, T, 2w+1]
    in_band = off.abs() <= window
    gather = (off + window).clamp(0, 2 * window).expand(b, nh, t, t)
    scores = scores + torch.gather(rel, -1, gather) * in_band
    valid = idx[None, :] < lengths.to(q.device)[:, None]           # [B, T]
    valid = valid[:, None, :, None] & valid[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, MASK_VAL))
    p = torch.softmax(scores, dim=-1)
    if with_stats:
        row_max = scores.amax(dim=-1, keepdim=True)
        stats = torch.cat([row_max, torch.exp(scores - row_max).sum(
            dim=-1, keepdim=True)], dim=-1)
    if rate > 0:
        keep = dropout_keep(seed.to(q.device), b, nh, t, rate)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), torch.zeros_like(p))
    if v.dtype != torch.float32:
        p = p + (p.to(v.dtype).float() - p).detach()
    out = p @ vh
    # band columns: w_rel[i, m] = p[i, i + m - w] where that key exists
    cols = idx[:, None] + torch.arange(2 * window + 1, device=q.device) - window
    in_range = (cols >= 0) & (cols < t)
    w_rel = torch.gather(p, -1, cols.clamp(0, t - 1).expand(b, nh, t, -1))
    out = out + (w_rel * in_range) @ emb_rel_v.float()
    out = out.transpose(1, 2).reshape(b, t, c).to(q.dtype)
    return (out, stats) if with_stats else out


def rel_attention_bwd_plain(q, k, v, emb_rel_k, emb_rel_v, lengths, g, *,
                            window: int, scale: float, seed=None,
                            rate: float = 0.0):
    """K3's function in plain PyTorch: autograd of ``rel_attention_plain``
    with the same mask.  Returns (dq, dk, dv, d emb_rel_k, d emb_rel_v), dq,
    dk, dv in the inputs' dtype (g is taken in the output's, q's, dtype)."""
    def fwd(*ins):
        return rel_attention_plain(*ins, lengths, window=window, scale=scale,
                                   seed=seed, rate=rate)

    # ``torch.func.vjp``, not ``torch.autograd.grad``: it also works inside
    # the K3 op's CPU implementation, which runs below autograd
    _, vjp = torch.func.vjp(fwd, *(a.detach() for a in (q, k, v, emb_rel_k,
                                                        emb_rel_v)))
    return vjp(g.to(q.dtype))


def rel_attention(q, k, v, emb_rel_k, emb_rel_v, mask, *, window: int,
                  scale: float, dropout_rate: float = 0.0,
                  seed=None) -> torch.Tensor:
    """Relative-position attention; ``mask`` is the [B, T, 1] prefix mask;
    ``seed`` an int32 tensor of one element, needed when ``dropout_rate`` >
    0."""
    if dropout_rate > 0 and seed is None:
        raise ValueError("rel_attention: dropout needs a seed")
    return rel_attention_plain(q, k, v, emb_rel_k, emb_rel_v,
                               prefix_lengths(mask), window=window,
                               scale=float(scale), seed=seed,
                               rate=float(dropout_rate))
