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
by the CUDA source (``rel_attention_bwd_scratch``).  The kernels take a
head width dk that is a multiple of 8, at most 128; the wrappers take any dk
up to 128, as the TPU kernel does: another dk is zero-padded per head to
the next multiple of 8 on the card (``ops/pad_pack.py``, one launch for the
inputs and one for the results around each kernel launch), the softmax
scale staying the caller's.

Attention dropout keeps an entry when a counter-based hash of (seed, b·H+h,
i, j) is at least ⌊rate·2³²⌋ and scales kept entries by 1/(1−rate); the hash
is written once here (``dropout_keep``) and once in the CUDA source, so the
kernels and their plain versions drop the same entries.

bf16 q, k, v (the bf16 compute recipes) go to the bf16 builds of K1 and K3
(``csrc/rel_attention_bf16.cu``), which round where the TPU kernel rounds:
P to bf16 before P·V and the band term, the output in bf16; in the backward
g in bf16, the dropped P in bf16 for dv and d emb_rel_v, every other product
and dS in float32, dq/dk/dv in bf16.  The emb tables, the row statistics and
the emb gradients stay float32.  The plain versions take the same dtypes.
The bf16 forward keeps each block's scores in shared memory, or, for a T too
long for it, in a scratch the wrapper allocates
(``rel_attention_bf16_fwd_scratch`` gives its size, 0 at the model's
shapes).

K1 and K3 are registered ``torch.library`` ops,
``visinger_torch::rel_attention_fwd`` (-> out, stats) and
``visinger_torch::rel_attention_bwd``, so ``torch.export`` keeps them as
nodes of a program.  The device picks the implementation: on CUDA tensors
the kernel (or it raises), on CPU tensors the plain version; no other
device has one.  The forward op's gradient is the backward op, given the
forward's out and stats.  ``rel_attention`` is the entry point,
differentiable.  ``launches`` and ``bwd_launches`` count the float32
kernels' launches, ``launches_bf16`` and ``bwd_launches_bf16`` the bf16
builds'.
"""

from __future__ import annotations

import ctypes

import torch

from visinger_tpu_torch.ops import cuda_build, pad_pack
from visinger_tpu_torch.ops.masking import prefix_lengths

MASK_VAL = -1e4
launches = 0
bwd_launches = 0
launches_bf16 = 0
bwd_launches_bf16 = 0

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


# the tensors that take q's dtype (float32 or bf16); the rest are float32
_IN_DTYPE = ("q", "k", "v", "g", "out")


def _check(name, tensors, lengths, seed, rate, window):
    """Validate the kernels' arguments; returns (B, T, C, dk)."""
    q = tensors["q"]
    b, t, c = q.shape
    m, dk = tensors["emb_rel_k"].shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    for key, a in tensors.items():
        want = q.dtype if key in _IN_DTYPE else torch.float32
        if a.device != q.device or a.device.type != "cuda" \
                or a.dtype != want:
            raise ValueError(f"{name}: {key} must be {want} on {q.device}, "
                             f"got {a.device} {a.dtype}")
        # the kernels copy 16 bytes at a time; an off-grid dk goes through
        # the padding kernel, which copies one element at a time
        if not a.is_contiguous() or (dk % 8 == 0 and a.data_ptr() % 16):
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte "
                             f"aligned (the kernels copy 16 bytes at a time)")
        if key in ("k", "v", "g", "out") and a.shape != q.shape:
            raise ValueError(f"{name}: {key} shape {tuple(a.shape)} != "
                             f"{tuple(q.shape)}")
    if tensors["emb_rel_v"].shape != (m, dk) or m != 2 * window + 1:
        raise ValueError(f"{name}: emb tables must be [2w+1, dk]")
    if c % dk or dk > 128:
        raise ValueError(f"{name}: C={c} must be heads*dk, dk at most 128 "
                         f"(the TPU kernel's one 128-lane slab per head)")
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


def head_jobs(tensors, heads: int, dk: int, unpack: bool = False) -> list:
    """``pad_pack`` jobs that zero-pad [B, T, H*dk] tensors and [2w+1, dk]
    emb tables to the next head width the kernels take, a multiple of 8
    (with ``unpack``, that cut them back from it)."""
    dkp = pad_pack.padded(dk, 8)
    width = dk if unpack else dkp
    jobs = []
    for a in tensors:
        if a.dim() == 3:
            jobs.append((a, (1, 1, heads, dk, dkp),
                         (a.shape[0], a.shape[1], heads * width)))
        else:
            jobs.append((a, (1, 1, 1, dk, dkp), (a.shape[0], width)))
    return jobs


def pad_heads(tensors, heads: int, dk: int, unpack: bool = False) -> list:
    """``head_jobs`` run in one launch of the padding kernel."""
    return pad_pack.pack(head_jobs(tensors, heads, dk, unpack), unpack)


def _drop_args(seed, rate):
    if rate > 0:
        return (seed.data_ptr(), keep_threshold(rate), 1.0 / (1.0 - rate), 1)
    return (None, 0, 1.0, 0)


_DROP_TYPES = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_float, ctypes.c_int]


def rel_attention_fwd(q, k, v, emb_rel_k, emb_rel_v, lengths, *,
                      window: int, scale: float, seed=None,
                      rate: float = 0.0):
    """Launch K1 (CUDA contiguous tensors; q, k, v float32, or bf16 for the
    bf16 build; the emb tables float32).  Returns (out [B, T, C] in q's
    dtype, stats [B, H, T, 2] float32), stats being each row's softmax max
    and sum."""
    global launches, launches_bf16
    b, t, c, dk = _check("rel_attention_fwd", {
        "q": q, "k": k, "v": v, "emb_rel_k": emb_rel_k,
        "emb_rel_v": emb_rel_v}, lengths, seed, rate, window)
    if dk % 8:
        heads = c // dk
        padded = pad_heads((q, k, v, emb_rel_k, emb_rel_v), heads, dk)
        out, stats = rel_attention_fwd(*padded, lengths, window=window,
                                       scale=scale, seed=seed, rate=rate)
        return pad_heads((out,), heads, dk, unpack=True)[0], stats
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    stats = torch.empty(b, c // dk, t, 2, device=q.device)
    # the bf16 build takes a scratch for its score buffer when T is too long
    # for shared memory (its size is 0 otherwise)
    scratch, buf = [], None
    if bf16:
        lib = cuda_build.load("rel_attention_bf16")
        size = lib.rel_attention_bf16_fwd_scratch
        size.restype = ctypes.c_longlong
        size.argtypes = [ctypes.c_int] * 5
        n_scratch = size(b, t, c, dk, window)
        if n_scratch < 0:
            raise ValueError(f"rel_attention_fwd: head width {dk} must be a "
                             f"multiple of 8, at most 128")
        if n_scratch > 0:
            buf = torch.empty(n_scratch, device=q.device)
        scratch = [None if buf is None else buf.data_ptr()]
        fn = lib.rel_attention_bf16_fwd
    else:
        fn = cuda_build.load("rel_attention").rel_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + _DROP_TYPES
                   + [ctypes.c_void_p] * (2 + len(scratch))
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), emb_rel_k.data_ptr(),
             emb_rel_v.data_ptr(), lengths.data_ptr(), *_drop_args(seed, rate),
             out.data_ptr(), stats.data_ptr(), *scratch, b, t, c, dk, window,
             float(scale), stream)
    cuda_build.check(err, "rel_attention_fwd")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out, stats


def rel_attention_bwd(q, k, v, emb_rel_k, emb_rel_v, lengths, g, out, stats,
                      *, window: int, scale: float, seed=None,
                      rate: float = 0.0):
    """Launch K3 given K1's ``out`` and ``stats`` (CUDA contiguous tensors;
    q, k, v, g, out float32, or bf16 for the bf16 build, which reads no
    ``out``).  Returns (dq, dk, dv in q's dtype, d emb_rel_k, d emb_rel_v
    float32)."""
    b, t, c, dk = _check("rel_attention_bwd", {
        "q": q, "k": k, "v": v, "emb_rel_k": emb_rel_k,
        "emb_rel_v": emb_rel_v, "g": g, "out": out, "stats": stats},
        lengths, seed, rate, window)
    if stats.shape != (b, c // dk, t, 2):
        raise ValueError("rel_attention_bwd: stats must be [B, H, T, 2]")
    if dk % 8:
        heads = c // dk
        padded = pad_heads((q, k, v, emb_rel_k, emb_rel_v, g, out), heads,
                            dk)
        grads = rel_attention_bwd(*padded[:5], lengths, *padded[5:], stats,
                                  window=window, scale=scale, seed=seed,
                                  rate=rate)
        return tuple(pad_heads(grads, heads, dk, unpack=True))
    if q.dtype == torch.bfloat16:
        return _bwd_bf16(q, k, v, emb_rel_k, emb_rel_v, lengths, g, stats,
                         window, scale, seed, rate)
    global bwd_launches
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


def _bwd_bf16(q, k, v, emb_rel_k, emb_rel_v, lengths, g, stats, window,
              scale, seed, rate):
    """K3's bf16 build (arguments checked by ``rel_attention_bwd``)."""
    global bwd_launches_bf16
    b, t, c = q.shape
    dk = emb_rel_k.shape[1]
    lib = cuda_build.load("rel_attention_bf16")
    size = lib.rel_attention_bf16_bwd_scratch
    size.restype = ctypes.c_longlong
    size.argtypes = [ctypes.c_int] * 5
    n_scratch = size(b, t, c, dk, window)
    if n_scratch < 0:
        raise ValueError(f"rel_attention_bwd: head width {dk} must be a "
                         f"multiple of 8, at most 128")
    fn = lib.rel_attention_bf16_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + _DROP_TYPES
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    dq, dk_, dv = (torch.empty_like(q) for _ in range(3))
    dek = torch.empty_like(emb_rel_k)
    dev = torch.empty_like(emb_rel_v)
    scratch = torch.empty(n_scratch, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), emb_rel_k.data_ptr(),
             emb_rel_v.data_ptr(), lengths.data_ptr(), *_drop_args(seed, rate),
             g.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk_.data_ptr(),
             dv.data_ptr(), dek.data_ptr(), dev.data_ptr(),
             scratch.data_ptr(), b, t, c, dk, window, float(scale), stream)
    cuda_build.check(err, "rel_attention_bwd")
    bwd_launches_bf16 += 1
    return dq, dk_, dv, dek, dev


# --- the registered ops: each decorated body is the CPU implementation -------

_ARGS = ("Tensor q, Tensor k, Tensor v, Tensor emb_rel_k, Tensor emb_rel_v, "
         "Tensor lengths")
_CFG = "Tensor? seed, int window, float scale, float rate"


@torch.library.custom_op(
    "visinger_torch::rel_attention_fwd", mutates_args=(), device_types="cpu",
    schema=f"({_ARGS}, {_CFG}) -> (Tensor, Tensor)")
def rel_attention_fwd_op(q, k, v, emb_rel_k, emb_rel_v, lengths, seed,
                         window, scale, rate):
    """K1 as an op: (out in q's dtype, stats [B, H, T, 2] float32)."""
    return rel_attention_plain(q, k, v, emb_rel_k, emb_rel_v, lengths,
                               window=window, scale=scale, seed=seed,
                               rate=rate, with_stats=True)


@rel_attention_fwd_op.register_kernel("cuda")
def _fwd_cuda(q, k, v, emb_rel_k, emb_rel_v, lengths, seed, window, scale,
              rate):
    return rel_attention_fwd(q, k, v, emb_rel_k, emb_rel_v, lengths,
                             window=window, scale=scale, seed=seed, rate=rate)


@rel_attention_fwd_op.register_fake
def _fwd_fake(q, k, v, emb_rel_k, emb_rel_v, lengths, seed, window, scale,
              rate):
    b, t, c = q.shape
    heads = c // emb_rel_k.shape[1]
    return (torch.empty_like(q),
            q.new_empty((b, heads, t, 2), dtype=torch.float32))


@torch.library.custom_op(
    "visinger_torch::rel_attention_bwd", mutates_args=(), device_types="cpu",
    schema=f"({_ARGS}, Tensor g, Tensor out, Tensor stats, {_CFG}) -> "
           "(Tensor, Tensor, Tensor, Tensor, Tensor)")
def rel_attention_bwd_op(q, k, v, emb_rel_k, emb_rel_v, lengths, g, out,
                         stats, seed, window, scale, rate):
    """K3 as an op: (dq, dk, dv, d emb_rel_k, d emb_rel_v)."""
    return tuple(rel_attention_bwd_plain(
        q, k, v, emb_rel_k, emb_rel_v, lengths, g, window=window,
        scale=scale, seed=seed, rate=rate))


@rel_attention_bwd_op.register_kernel("cuda")
def _bwd_cuda(q, k, v, emb_rel_k, emb_rel_v, lengths, g, out, stats, seed,
              window, scale, rate):
    return rel_attention_bwd(q, k, v, emb_rel_k, emb_rel_v, lengths, g, out,
                             stats, window=window, scale=scale, seed=seed,
                             rate=rate)


@rel_attention_bwd_op.register_fake
def _bwd_fake(q, k, v, emb_rel_k, emb_rel_v, lengths, g, out, stats, seed,
              window, scale, rate):
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(emb_rel_k), torch.empty_like(emb_rel_v))


def _fwd_setup(ctx, inputs, output):
    q, k, v, ek, ev, lengths, seed, window, scale, rate = inputs
    out, stats = output
    ctx.mark_non_differentiable(stats)
    ctx.save_for_backward(q, k, v, ek, ev, lengths, seed, out, stats)
    ctx.cfg = (window, scale, rate)


def _fwd_backward(ctx, g, _g_stats):
    q, k, v, ek, ev, lengths, seed, out, stats = ctx.saved_tensors
    window, scale, rate = ctx.cfg
    grads = rel_attention_bwd_op(q, k, v, ek, ev, lengths,
                                 g.to(q.dtype).contiguous(), out, stats, seed,
                                 window, scale, rate)
    return (*grads, None, None, None, None, None)


rel_attention_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def rel_attention(q, k, v, emb_rel_k, emb_rel_v, mask, *, window: int,
                  scale: float, dropout_rate: float = 0.0,
                  seed=None) -> torch.Tensor:
    """Fused relative-position attention; ``mask`` is the [B, T, 1] prefix
    mask (lengths are derived from it, as the JAX entry does); ``seed`` is
    an int32 tensor of one element on q's device, needed when
    ``dropout_rate`` > 0."""
    if dropout_rate > 0 and seed is None:
        raise ValueError("rel_attention: dropout needs a seed")
    out, _stats = rel_attention_fwd_op(
        q, k, v, emb_rel_k, emb_rel_v, prefix_lengths(mask), seed, window,
        float(scale), float(dropout_rate))
    return out
