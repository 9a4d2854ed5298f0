"""Monotonic alignment search (MAS) of VITS training, as upstream runs it
(jaywalnut310/vits ``monotonic_align/__init__.py::maximum_path``): the
cost matrix on the device, the dynamic program on the host, the path back
on the device.

``neg_cent(z_p, m_p, logs_p)`` is the log-likelihood of every frame of
``z_p`` under every token's prior N(m_p, exp(logs_p)²), summed over the
channels, [B, T_y, T_x]: upstream's four terms, float32 products with
TF32 off, without gradient.

``maximum_path`` copies it to the host through a pinned buffer and runs
upstream's ``maximum_path_each`` (``monotonic_align/core.pyx``) on every
item at once, one frame after another: for each frame y, over the band
max(0, T_x + y - T_y) <= x <= min(T_x - 1, y),

    value[y, x] += max(v_prev, v_cur),
    v_cur  = value[y-1, x]    (-1e9 where x == y),
    v_prev = value[y-1, x-1]  (0 at (0, 0), -1e9 at x == 0 for y > 0),

each cell the same float32 max-and-add as the loop, so the same bits; then
the backtrack from x = T_x - 1, which steps down a token when x == y or
value[y-1, x] < value[y-1, x-1] (a tie stays on the token).  The result is
the token of every frame, [B, T_y] int64 on the device (0 on padded
frames), which the model turns into the path's durations and the expanded
prior; an item needs T_y >= T_x, as upstream's does."""

from __future__ import annotations

import math

import numpy as np
import torch

NEG = np.float32(-1e9)
_pinned: dict = {}


@torch.no_grad()
def neg_cent(z_p: torch.Tensor, m_p: torch.Tensor,
             logs_p: torch.Tensor) -> torch.Tensor:
    """z_p [B, H, T_y], m_p and logs_p [B, H, T_x] -> [B, T_y, T_x]."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s_p_sq_r = torch.exp(-2 * logs_p)
        nc1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, [1],
                        keepdim=True)
        nc2 = torch.matmul(-0.5 * (z_p ** 2).transpose(1, 2), s_p_sq_r)
        nc3 = torch.matmul(z_p.transpose(1, 2), m_p * s_p_sq_r)
        nc4 = torch.sum(-0.5 * (m_p ** 2) * s_p_sq_r, [1], keepdim=True)
        return nc1 + nc2 + nc3 + nc4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _host_buffer(name: str, shape, dtype) -> torch.Tensor:
    """A pinned host tensor of ``shape`` (grown as needed, kept)."""
    n = math.prod(shape)
    buf = _pinned.get(name)
    if buf is None or buf.numel() < n or buf.dtype != dtype:
        buf = _pinned[name] = torch.empty(n, dtype=dtype, pin_memory=True)
    return buf[:n].view(shape)


def to_host(x: torch.Tensor, name: str = "neg_cent") -> np.ndarray:
    """``x`` as a host numpy array: from a card into a pinned buffer kept
    for the next call (one wait), from the CPU a copy."""
    if x.device.type != "cuda":
        return x.detach().numpy().copy()
    host = _host_buffer(name, tuple(x.shape), x.dtype)
    host.copy_(x, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return host.numpy()


def dp_forward(value: np.ndarray, t_x: np.ndarray, t_y: np.ndarray) -> None:
    """Upstream's accumulation, in place on ``value`` [B, T_y, T_x]
    float32, vectorised over the items and the tokens."""
    b, ty, tx = value.shape
    x = np.arange(tx)[None, :]
    lo_base = (t_x - t_y)[:, None]
    hi_base = (t_x - 1)[:, None]
    live = t_y[:, None]
    v_prev = np.empty((b, tx), np.float32)
    for y in range(int(t_y.max(initial=0))):
        band = ((x >= np.maximum(lo_base + y, 0))
                & (x <= np.minimum(hi_base, y)) & (y < live))
        if y == 0:
            v_cur = np.full((b, tx), NEG, np.float32)
            v_prev[:] = NEG
            v_prev[:, 0] = 0.0
        else:
            row = value[:, y - 1]
            v_cur = np.where(x == y, NEG, row)
            v_prev[:, 1:] = row[:, :-1]
            v_prev[:, 0] = NEG
        cur = value[:, y]
        value[:, y] = np.where(band, cur + np.maximum(v_prev, v_cur), cur)


def dp_backtrack(value: np.ndarray, t_x: np.ndarray,
                 t_y: np.ndarray) -> np.ndarray:
    """The token of every frame [B, T_y] int64 (0 past an item's T_y)
    from the accumulated ``value``."""
    b, ty, _ = value.shape
    path = np.zeros((b, ty), np.int64)
    index = (t_x - 1).astype(np.int64)
    rows = np.arange(b)
    for y in range(int(t_y.max(initial=0)) - 1, -1, -1):
        active = y < t_y
        path[active, y] = index[active]
        if y == 0:
            break
        prev = value[:, y - 1]
        here = prev[rows, index]
        left = prev[rows, np.maximum(index - 1, 0)]
        down = active & (index != 0) & ((index == y) | (here < left))
        index = index - down
    return path


def host_path(value: np.ndarray, t_x: np.ndarray,
              t_y: np.ndarray) -> np.ndarray:
    """MAS of host costs ``value`` [B, T_y, T_x] (overwritten) ->
    [B, T_y] tokens."""
    dp_forward(value, t_x, t_y)
    return dp_backtrack(value, t_x, t_y)


def maximum_path(cost: torch.Tensor, t_x, t_y) -> torch.Tensor:
    """MAS of ``cost`` [B, T_y, T_x] (on any device) for the host lengths
    ``t_x`` (tokens) and ``t_y`` (frames) -> [B, T_y] int64 tokens on
    ``cost``'s device."""
    path = host_path(to_host(cost), np.asarray(t_x, np.int64),
                     np.asarray(t_y, np.int64))
    if cost.device.type != "cuda":
        return torch.from_numpy(path)
    back = _host_buffer("path", path.shape, torch.int64)
    back.copy_(torch.from_numpy(path))
    return back.to(cost.device, non_blocking=True)
