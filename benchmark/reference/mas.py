"""Monotonic alignment search in plain numpy: jaywalnut310/vits
``monotonic_align/core.pyx::maximum_path_each`` as its literal double loop
(``path_each_loop``, for the tests), and the same arithmetic frame after
frame over the token band of one item at a time (``path_each``), which the
reference runs.  Given the program's path as a ``hint``, a backtrack
decision whose two values lie within ``TIE`` of each other, relative to
the larger magnitude (a tie at the costs' float32 rounding), follows the
hint, as ``correct.TIE`` holds a tied voiced decision to the served side;
``splits`` collects the relative gap of every decision where the
reference's own choice leaves the hint's.  ``maximum_path`` is
upstream's ``monotonic_align/__init__.py::maximum_path``: the costs to the
host as float32, every item's path, the dense path [B, T_y, T_x] back on
the costs' device."""

from __future__ import annotations

import numpy as np
import torch

MAX_NEG = np.float32(-1e9)
TIE = 1e-6


def path_each_loop(value: np.ndarray, t_y: int, t_x: int) -> np.ndarray:
    """The literal loop on one item's float32 costs [>= t_y, >= t_x]
    (overwritten) -> its path [t_y, t_x] int32."""
    path = np.zeros((t_y, t_x), np.int32)
    index = t_x - 1
    for y in range(t_y):
        for x in range(max(0, t_x + y - t_y), min(t_x, y + 1)):
            if x == y:
                v_cur = MAX_NEG
            else:
                v_cur = value[y - 1, x]
            if x == 0:
                if y == 0:
                    v_prev = np.float32(0.0)
                else:
                    v_prev = MAX_NEG
            else:
                v_prev = value[y - 1, x - 1]
            value[y, x] = np.float32(value[y, x] + max(v_prev, v_cur))
    for y in range(t_y - 1, -1, -1):
        path[y, index] = 1
        if index != 0 and (index == y
                           or value[y - 1, index] < value[y - 1, index - 1]):
            index = index - 1
    return path


def path_each(value: np.ndarray, t_y: int, t_x: int,
              hint: np.ndarray | None = None,
              splits: list | None = None) -> np.ndarray:
    """The loop's arithmetic on one item, each frame's band at once;
    ``hint`` [>= t_y]: the token of each frame to follow at a tie;
    ``splits``: appended the relative gap of each decision that leaves the
    hint's."""
    v = value[:t_y, :t_x].astype(np.float32, copy=True)
    for y in range(t_y):
        lo, hi = max(0, t_x + y - t_y), min(t_x, y + 1)
        if lo >= hi:
            continue
        xs = np.arange(lo, hi)
        if y == 0:
            cur = np.full(len(xs), MAX_NEG, np.float32)
        else:
            cur = np.where(xs == y, MAX_NEG, v[y - 1, xs])
        prev = np.where(xs == 0, np.float32(0.0) if y == 0 else MAX_NEG,
                        v[max(y - 1, 0), np.maximum(xs - 1, 0)])
        v[y, lo:hi] = v[y, lo:hi] + np.maximum(prev, cur).astype(np.float32)
    path = np.zeros((t_y, t_x), np.int32)
    index = t_x - 1
    for y in range(t_y - 1, -1, -1):
        path[y, index] = 1
        if index == 0:
            continue
        if index == y:
            index -= 1
            continue
        a, b = v[y - 1, index], v[y - 1, index - 1]
        down = a < b
        if hint is not None and hint[y - 1] in (index, index - 1) \
                and down != (hint[y - 1] == index - 1):
            gap = float(abs(a - b)) / max(float(abs(a)), float(abs(b)),
                                          1e-30)
            if splits is not None:
                splits.append(gap)
            if gap <= TIE:
                down = not down
        index -= int(down)
    return path


def tokens_of(path: np.ndarray) -> np.ndarray:
    """A dense path [t_y, t_x] -> the token of each frame [t_y]."""
    return path.argmax(axis=1)


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor,
                 hints=None, splits: list | None = None) -> torch.Tensor:
    """neg_cent [B, T_y, T_x], mask [B, T_y, T_x] -> the path [B, T_y, T_x]
    (float32, on neg_cent's device); ``hints`` [B, >= T_y]: the program's
    token of each frame, followed at ties; ``splits`` as ``path_each``'s."""
    value = neg_cent.detach().cpu().numpy().astype(np.float32)
    t_ys = mask.sum(1)[:, 0].cpu().numpy().astype(np.int32)
    t_xs = mask.sum(2)[:, 0].cpu().numpy().astype(np.int32)
    path = np.zeros(value.shape, np.float32)
    for i, (t_y, t_x) in enumerate(zip(t_ys, t_xs)):
        path[i, :t_y, :t_x] = path_each(
            value[i], int(t_y), int(t_x),
            None if hints is None else hints[i], splits)
    return torch.from_numpy(path).to(neg_cent.device)
