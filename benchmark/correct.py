"""How ``correct`` is decided: the numbers that compare what the timed path
produced with the plain reference, and their limits (``limits/<cell>.json``,
each set between the readings of sound runs and of the lower-precision
control; ``PERF.md`` gives the readings).

Training (the first ``checked_steps`` steps of the object the window
drives):
  - ``loss_gap``: the widest relative gap of a step's generator or
    discriminator loss;
  - ``grad_gap``: the first step's gradients as each optimizer got them
    (its first moment over 1 - beta1), by the worst leaf: the gap between
    the program's and the reference's norms of the leaf over the larger of
    the reference's norm of that leaf and of the median leaf;
  - ``update_gap``: the change of every parameter over the checked steps,
    by the worst leaf as above, leaving out leaves whose reference gradient
    is under a thousandth of the median leaf's (they move by round-off);
  - ``first_loss_gap``: ``loss_gap`` of the first step alone, and
    ``grad_gap_median``: ``grad_gap``'s per-leaf gap at the median leaf,
    the steady numbers of a cell whose widest gaps swing from seed to seed
    (the later steps, one leaf).
A cell compares the numbers its limits file names.
Synthesis (a sample of the window's groups, drawn from the seed, with the
longest group in it):
  - ``wav_gap``: the widest gap between a served waveform and the
    reference's, over the reference waveform's peak.  Where the reference
    finds a frame whose voiced decision lies within ``TIE`` of the uv
    logit's peak of its threshold, either side is a sound answer: the
    reference gives the waveform on each (``reference/synth.py``), and the
    served waveform is held to the nearer."""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

SMALL_GRAD = 1e-3      # leaves below this share of the median gradient norm
TIE = 1e-5             # a uv logit this share of its row's peak from 0 is a tie


def load_limits(root: Path, cell: str) -> dict:
    return json.loads((root / "limits" / f"{cell}.json").read_text())


def _median(values: list[float]) -> float:
    s = sorted(values)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1]
                                                    + s[len(s) // 2])


def leaf_norms(tensors) -> list[float]:
    return [float(v) for v in torch.stack(
        torch._foreach_norm([t.float() for t in tensors])).cpu()]


def leaf_gaps(prog: list[float], ref: list[float],
              keep: list[bool] | None = None) -> list[float]:
    """|prog - ref| / max(ref, median ref) of every kept leaf."""
    med = _median(ref)
    out = []
    for i, (p, r) in enumerate(zip(prog, ref)):
        if keep is not None and not keep[i]:
            continue
        if not (math.isfinite(p) and math.isfinite(r)):
            return [math.inf]
        out.append(abs(p - r) / max(r, med, 1e-30))
    return out


def worst_leaf_gap(prog: list[float], ref: list[float],
                   keep: list[bool] | None = None) -> float:
    return max(leaf_gaps(prog, ref, keep), default=0.0)


def worst_leaves(prog: dict, ref: dict, names: dict, key: str) -> dict:
    """For each model, the leaf behind ``train_numbers``' ``key`` ("grad"
    or "update"): its name, the two norms and the reference's median."""
    out = {}
    for m in ("g", "d"):
        med = _median(ref[key][m])
        gref = ref["grad"][m]
        gmed = _median(gref)
        best, where = -1.0, None
        for i, (p, r) in enumerate(zip(prog[key][m], ref[key][m])):
            if key == "update" and gref[i] < SMALL_GRAD * gmed:
                continue
            gap = abs(p - r) / max(r, med, 1e-30)
            if gap > best:
                best, where = gap, i
        out[m] = {"leaf": names[m][where], "gap": best,
                  "program": prog[key][m][where], "reference":
                  ref[key][m][where], "median": med}
    return out


def step_loss_gaps(prog: list[dict], ref: list[dict]) -> list:
    """[[generator, discriminator] relative loss gap] per step."""
    return [[abs(float(p[k]) - float(r[k])) / max(abs(float(r[k])), 1e-30)
             for k in ("total_g", "disc")] for p, r in zip(prog, ref)]


def loss_gap(prog: list[dict], ref: list[dict]) -> float:
    worst = 0.0
    for p, r in zip(prog, ref):
        for key in ("total_g", "disc"):
            a, b = float(p[key]), float(r[key])
            if not (math.isfinite(a) and math.isfinite(b)):
                return math.inf
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    return worst


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [metrics per step], "grad":
    {"g": [leaf norms], "d": [...]}, "update": {"g": [...], "d": [...]}}."""
    grad = max(worst_leaf_gap(prog["grad"][m], ref["grad"][m])
               for m in ("g", "d"))
    update = 0.0
    for m in ("g", "d"):
        med = _median(ref["grad"][m])
        keep = [g >= SMALL_GRAD * med for g in ref["grad"][m]]
        update = max(update, worst_leaf_gap(prog["update"][m],
                                            ref["update"][m], keep))
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": grad, "update_gap": update,
            "first_loss_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
            "grad_gap_median": max(
                _median(leaf_gaps(prog["grad"][m], ref["grad"][m]))
                for m in ("g", "d"))}


def _one_gap(p: torch.Tensor, r) -> float:
    r = torch.as_tensor(r, dtype=torch.float64)
    if p.shape != r.shape:
        return math.inf
    return float((p - r).abs().max() / r.abs().max().clamp(min=1e-30))


def wav_gap(prog_wavs, ref_wavs) -> float:
    """The widest over requests of the gap to the reference's waveform;
    where a reference entry is a list of waveforms (a tie's sides), the
    gap to the nearest of them."""
    worst = 0.0
    for p, r in zip(prog_wavs, ref_wavs):
        p = torch.as_tensor(p, dtype=torch.float64)
        if not bool(torch.isfinite(p).all()):
            return math.inf
        sides = r if isinstance(r, (list, tuple)) else [r]
        worst = max(worst, min(_one_gap(p, s) for s in sides))
    return worst


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that ``limits`` names within its limit, {name:
    {"value", "limit"}} of those)."""
    out = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= v
             for k, v in limits.items())
    return ok, out
