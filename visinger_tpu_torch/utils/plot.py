"""Spectrogram/f0 plotting for validation logging (the port's own copy of
the JAX package's ``utils/plot.py``; matplotlib is imported inside the
functions, so the module imports without it).

Parity target: reference utils/plot/plot.py:14-48 (spec_to_figure) —
mel heatmap with optional f0-curve overlays (twin Hz axis, 0-1250) and
duration tick marks (blue GT vlines over the lower half, red predicted
vlines over the upper half) rendered to a matplotlib Figure or PNG for
TensorBoard/work-dir dumps.
"""

from __future__ import annotations

import numpy as np

LINE_COLORS = ["w", "r", "orange", "k", "cyan", "m", "b", "lime", "g",
               "brown", "navy"]


def spec_to_figure(spec: np.ndarray, vmin: float = -7, vmax: float = 12,
                   f0s: dict | None = None, dur_info: dict | None = None,
                   title: str = ""):
    """mel [T, n_mels] (or stacked comparison) -> matplotlib Figure.

    ``f0s``: {name: f0_hz [T]} curves drawn on a twin axis (ylim 0-1250 Hz).
    ``dur_info``: {"duration_gt": [N] frames per token[, "duration_pred"]};
    cumulative boundaries drawn as vertical ticks.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    spec = np.asarray(spec)
    h = spec.shape[1] // 2
    fig = plt.figure(figsize=(12, 6))
    plt.pcolor(spec.T, vmin=vmin, vmax=vmax)
    if title:
        plt.title(title)
    if dur_info is not None:
        dur_gt = np.cumsum(np.asarray(dur_info["duration_gt"])).astype(int)
        for x in dur_gt:
            plt.vlines(x, 0, h // 2, colors="b")  # blue = ground truth
        xmax = dur_gt[-1] if len(dur_gt) else spec.shape[0]
        if "duration_pred" in dur_info:
            dur_pred = np.cumsum(
                np.asarray(dur_info["duration_pred"])).astype(int)
            for x in dur_pred:
                plt.vlines(x, h, int(h * 1.5), colors="r")  # red = predicted
            if len(dur_pred):
                xmax = max(xmax, dur_pred[-1])
        plt.xlim(0, xmax)
    if f0s is not None:
        ax = plt.gca().twinx()
        if not isinstance(f0s, dict):
            f0s = {"f0": f0s}
        for i, (name, f0) in enumerate(f0s.items()):
            f0 = np.asarray(f0)
            ax.plot(np.arange(len(f0)), f0, label=name,
                    c=LINE_COLORS[i % len(LINE_COLORS)], linewidth=1,
                    alpha=0.5)
        ax.set_ylim(0, 1250)
        ax.legend()
    plt.tight_layout()
    return fig


def save_spec_png(path: str, spec: np.ndarray, **kw):
    fig = spec_to_figure(spec, **kw)
    fig.savefig(path, dpi=100)
    import matplotlib.pyplot as plt

    plt.close(fig)
