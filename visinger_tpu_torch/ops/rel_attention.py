"""K1: relative-position self-attention (forward).

Replaces ``visinger_tpu/ops/pallas/attention_kernel.py::_attn_fwd_kernel``
(host side ``_attn_pallas_fwd``, entry ``rel_attention``).  The CUDA kernel is
``csrc/rel_attention.cu``; its note gives the design.  On the H100 the
function is bound by operations (~4·H·dk·Σ_b len_b² flops — a key at or
past its item's length gets no weight, and every masked row is the same
mean of v — against a few MB of q/k/v), and this first kernel runs on the
float32 CUDA cores.

``rel_attention`` is the entry point: on a CPU tensor it runs
``rel_attention_plain``; on a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from visinger_tpu_torch.ops import cuda_build
from visinger_tpu_torch.ops.masking import prefix_lengths

MASK_VAL = -1e4
launches = 0


def rel_attention_plain(q, k, v, emb_rel_k, emb_rel_v, lengths, *,
                        window: int, scale: float) -> torch.Tensor:
    """The same function in plain PyTorch (float32 scores and softmax).

    q, k, v: [B, T, C] with head h in channels [h*dk, (h+1)*dk);
    emb_rel_k/v: [2w+1, dk] shared by the heads; lengths: [B] prefix lengths.
    Returns [B, T, C].
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
    out = p @ vh
    # band columns: w_rel[i, m] = p[i, i + m - w] where that key exists
    cols = idx[:, None] + torch.arange(2 * window + 1, device=q.device) - window
    in_range = (cols >= 0) & (cols < t)
    w_rel = torch.gather(p, -1, cols.clamp(0, t - 1).expand(b, nh, t, -1))
    out = out + (w_rel * in_range) @ emb_rel_v.float()
    return out.transpose(1, 2).reshape(b, t, c).to(q.dtype)


def rel_attention_fwd(q, k, v, emb_rel_k, emb_rel_v, lengths, *,
                      window: int, scale: float) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA float32 contiguous tensors only)."""
    global launches
    b, t, c = q.shape
    m, dk = emb_rel_k.shape
    for name, a in (("q", q), ("k", k), ("v", v), ("emb_rel_k", emb_rel_k),
                    ("emb_rel_v", emb_rel_v)):
        if a.device.type != "cuda" or a.dtype != torch.float32:
            raise ValueError(f"rel_attention_fwd: {name} must be CUDA float32, "
                             f"got {a.device} {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"rel_attention_fwd: {name} must be contiguous")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"rel_attention_fwd: q/k/v shapes differ: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if emb_rel_v.shape != emb_rel_k.shape or m != 2 * window + 1:
        raise ValueError("rel_attention_fwd: emb tables must be [2w+1, dk]")
    if c % dk or dk > 128:
        raise ValueError(f"rel_attention_fwd: C={c} must be heads*dk, dk<=128")
    if (lengths.device != q.device or lengths.dtype != torch.int32
            or lengths.shape != (b,)):
        raise ValueError("rel_attention_fwd: lengths must be CUDA int32 [B]")
    lengths = lengths.contiguous()
    lib = cuda_build.load("rel_attention")
    fn = lib.rel_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), emb_rel_k.data_ptr(),
             emb_rel_v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, t, c, dk, window, float(scale), stream)
    cuda_build.check(err, "rel_attention_fwd")
    launches += 1
    return out


def rel_attention(q, k, v, emb_rel_k, emb_rel_v, mask, *, window: int,
                  scale: float, dropout_rate: float = 0.0) -> torch.Tensor:
    """Fused relative-position attention; ``mask`` is the [B, T, 1] prefix
    mask (lengths are derived from it, as the JAX entry does)."""
    if dropout_rate > 0:
        raise NotImplementedError(
            "attention dropout comes with the training slice (Philox + K3)")
    lengths = prefix_lengths(mask)
    if q.device.type == "cpu":
        return rel_attention_plain(q, k, v, emb_rel_k, emb_rel_v, lengths,
                                   window=window, scale=scale)
    return rel_attention_fwd(q, k, v, emb_rel_k, emb_rel_v, lengths,
                             window=window, scale=scale)
