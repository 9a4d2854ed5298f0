"""K1 and K3: relative-position self-attention, forward and backward.

K1 replaces ``visinger_tpu/ops/pallas/attention_kernel.py::_attn_fwd_kernel``
(host side ``_attn_pallas_fwd``), K3 replaces ``::_attn_bwd_kernel`` (host
side ``_attn_bwd_rule``); entry ``rel_attention``.  Both CUDA kernels are in
``csrc/rel_attention.cu``, whose note gives the design.  On the H100 both are
bound by operations (forward ~4·H·dk·Σ_b len_b² flops — a key at or past its
item's length gets no weight, and every masked row is the same mean of v —
against a few MB of q/k/v).  Both run their products on the tensor cores in
float32-accurate 3xTF32 (``csrc/tf32x3.cuh``); K1's key loop stops at each
item's length and a tile of masked rows does no q·kᵀ; K3's scratch is sized
by the CUDA source (``rel_attention_bwd_scratch``).  Both take a head width
dk that is a multiple of 8, at most 128.

Attention dropout keeps an entry when a counter-based hash of (seed, b·H+h,
i, j) is at least ⌊rate·2³²⌋ and scales kept entries by 1/(1−rate); the hash
is written once here (``dropout_keep``) and once in the CUDA source, so the
kernels and their plain versions drop the same entries.

``rel_attention`` is the entry point, differentiable: on CPU tensors it runs
``rel_attention_plain`` under ordinary autograd; on CUDA tensors its forward
is K1 and its backward K3 (``_RelAttention``), or it raises.  ``launches``
and ``bwd_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from visinger_tpu_torch.ops import cuda_build
from visinger_tpu_torch.ops.masking import prefix_lengths

MASK_VAL = -1e4
launches = 0
bwd_launches = 0

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

    q, k, v: [B, T, C] with head h in channels [h*dk, (h+1)*dk);
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
    with the same mask.  Returns (dq, dk, dv, d emb_rel_k, d emb_rel_v)."""
    with torch.enable_grad():
        ins = [a.detach().requires_grad_(True)
               for a in (q, k, v, emb_rel_k, emb_rel_v)]
        out = rel_attention_plain(*ins, lengths, window=window, scale=scale,
                                  seed=seed, rate=rate)
        return torch.autograd.grad(out, ins, g)


def _check(name, tensors, lengths, seed, rate, window):
    """Validate the kernels' arguments; returns (B, T, C, dk)."""
    q = tensors["q"]
    b, t, c = q.shape
    m, dk = tensors["emb_rel_k"].shape
    for key, a in tensors.items():
        if a.device != q.device or a.device.type != "cuda" \
                or a.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32 on {q.device}, "
                             f"got {a.device} {a.dtype}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte "
                             f"aligned (the kernels copy 16 bytes at a time)")
        if key in ("k", "v", "g", "out") and a.shape != q.shape:
            raise ValueError(f"{name}: {key} shape {tuple(a.shape)} != "
                             f"{tuple(q.shape)}")
    if tensors["emb_rel_v"].shape != (m, dk) or m != 2 * window + 1:
        raise ValueError(f"{name}: emb tables must be [2w+1, dk]")
    if c % dk or dk > 128 or dk % 8:
        raise ValueError(f"{name}: C={c} must be heads*dk, dk a multiple of "
                         f"8 and at most 128")
    if (lengths.device != q.device or lengths.dtype != torch.int32
            or lengths.shape != (b,) or not lengths.is_contiguous()):
        raise ValueError(f"{name}: lengths must be contiguous int32 [B] on "
                         f"{q.device}")
    if rate > 0 and (seed is None or seed.device != q.device
                     or seed.dtype != torch.int32 or seed.numel() != 1):
        raise ValueError(f"{name}: dropout needs an int32 seed of one "
                         f"element on {q.device}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{name}: dropout rate {rate} outside [0, 1)")
    return b, t, c, dk


def _drop_args(seed, rate):
    if rate > 0:
        return (seed.data_ptr(), keep_threshold(rate), 1.0 / (1.0 - rate), 1)
    return (None, 0, 1.0, 0)


_DROP_TYPES = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_float, ctypes.c_int]


def rel_attention_fwd(q, k, v, emb_rel_k, emb_rel_v, lengths, *,
                      window: int, scale: float, seed=None,
                      rate: float = 0.0):
    """Launch K1 (CUDA float32 contiguous tensors only).  Returns (out
    [B, T, C], stats [B, H, T, 2]), stats being each row's softmax max and
    sum."""
    global launches
    b, t, c, dk = _check("rel_attention_fwd", {
        "q": q, "k": k, "v": v, "emb_rel_k": emb_rel_k,
        "emb_rel_v": emb_rel_v}, lengths, seed, rate, window)
    fn = cuda_build.load("rel_attention").rel_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + _DROP_TYPES
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty_like(q)
    stats = torch.empty(b, c // dk, t, 2, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), emb_rel_k.data_ptr(),
             emb_rel_v.data_ptr(), lengths.data_ptr(), *_drop_args(seed, rate),
             out.data_ptr(), stats.data_ptr(), b, t, c, dk, window,
             float(scale), stream)
    cuda_build.check(err, "rel_attention_fwd")
    launches += 1
    return out, stats


def rel_attention_bwd(q, k, v, emb_rel_k, emb_rel_v, lengths, g, out, stats,
                      *, window: int, scale: float, seed=None,
                      rate: float = 0.0):
    """Launch K3 given K1's ``out`` and ``stats`` (CUDA float32 contiguous
    tensors only).  Returns (dq, dk, dv, d emb_rel_k, d emb_rel_v)."""
    global bwd_launches
    b, t, c, dk = _check("rel_attention_bwd", {
        "q": q, "k": k, "v": v, "emb_rel_k": emb_rel_k,
        "emb_rel_v": emb_rel_v, "g": g, "out": out, "stats": stats},
        lengths, seed, rate, window)
    if stats.shape != (b, c // dk, t, 2):
        raise ValueError("rel_attention_bwd: stats must be [B, H, T, 2]")
    lib = cuda_build.load("rel_attention")
    size = lib.rel_attention_bwd_scratch
    size.restype = ctypes.c_longlong
    size.argtypes = [ctypes.c_int] * 5
    n_scratch = size(b, t, c, dk, window)
    if n_scratch < 0:
        raise ValueError(f"rel_attention_bwd: head width {dk} must be a "
                         f"multiple of 8, at most 128")
    fn = lib.rel_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + _DROP_TYPES
                   + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    dq, dk_, dv = (torch.empty_like(q) for _ in range(3))
    dek = torch.empty_like(emb_rel_k)
    dev = torch.empty_like(emb_rel_v)
    scratch = torch.empty(n_scratch, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), emb_rel_k.data_ptr(),
             emb_rel_v.data_ptr(), lengths.data_ptr(), *_drop_args(seed, rate),
             g.data_ptr(), out.data_ptr(), stats.data_ptr(), dq.data_ptr(),
             dk_.data_ptr(), dv.data_ptr(), dek.data_ptr(), dev.data_ptr(),
             scratch.data_ptr(), b, t, c, dk, window, float(scale), stream)
    cuda_build.check(err, "rel_attention_bwd")
    bwd_launches += 1
    return dq, dk_, dv, dek, dev


class _RelAttention(torch.autograd.Function):
    """Forward K1, backward K3 (CUDA tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, emb_rel_k, emb_rel_v, lengths, seed, window,
                scale, rate):
        out, stats = rel_attention_fwd(q, k, v, emb_rel_k, emb_rel_v,
                                       lengths, window=window, scale=scale,
                                       seed=seed, rate=rate)
        ctx.save_for_backward(q, k, v, emb_rel_k, emb_rel_v, lengths, seed,
                              out, stats)
        ctx.cfg = (window, scale, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, ek, ev, lengths, seed, out, stats = ctx.saved_tensors
        window, scale, rate = ctx.cfg
        grads = rel_attention_bwd(q, k, v, ek, ev, lengths, g.contiguous(),
                                  out, stats, window=window, scale=scale,
                                  seed=seed, rate=rate)
        return (*grads, None, None, None, None, None)


def rel_attention(q, k, v, emb_rel_k, emb_rel_v, mask, *, window: int,
                  scale: float, dropout_rate: float = 0.0,
                  seed=None) -> torch.Tensor:
    """Fused relative-position attention; ``mask`` is the [B, T, 1] prefix
    mask (lengths are derived from it, as the JAX entry does); ``seed`` is
    an int32 tensor of one element on q's device, needed when
    ``dropout_rate`` > 0."""
    if dropout_rate > 0 and seed is None:
        raise ValueError("rel_attention: dropout needs a seed")
    lengths = prefix_lengths(mask)
    if q.device.type == "cpu":
        return rel_attention_plain(q, k, v, emb_rel_k, emb_rel_v, lengths,
                                   window=window, scale=scale, seed=seed,
                                   rate=dropout_rate)
    return _RelAttention.apply(q, k, v, emb_rel_k, emb_rel_v, lengths, seed,
                               window, scale, float(dropout_rate))
