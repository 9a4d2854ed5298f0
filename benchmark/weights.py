"""Seed-made weights, drawn on the device in one call and handed alike to
the program and to the reference.

Every floating leaf of the models gets its values from one uniform draw
u in [-1, 1) of a ``torch.Generator`` seeded by the run's seed, sliced in
the order of the sorted leaf names, and scaled by a rule on the leaf's name
and shape that follows PyTorch's default initialisers:

  - a weight, weight-norm direction ``weight_v``, embedding or relative
    position table (two or more axes): u / sqrt(fan), fan the product of
    every axis but the first;
  - a bias: u / sqrt(fan) of its layer's weight (0.1 u without one);
  - a weight-norm gain ``weight_g``: (1 + 0.2 u) / sqrt(3), about the norm
    of a direction drawn as above;
  - a LayerNorm ``gamma``: 1 + 0.1 u; ``beta`` and any other vector: 0.1 u.

The values depend on the seed and on the leaves' names and shapes alone, so
two models with the same leaves get the same weights, whichever package
built them."""

from __future__ import annotations

import math

import torch


def _fan(shape) -> int:
    return max(math.prod(shape[1:]), 1)


def _scale_shift(name: str, shape, shapes: dict) -> tuple[float, float]:
    """(scale, shift) of leaf ``name``: its values are scale * u + shift."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) >= 2:
        return _fan(shape) ** -0.5, 0.0
    if leaf == "weight_g":
        return 0.2 / math.sqrt(3.0), 1.0 / math.sqrt(3.0)
    if leaf == "gamma":
        return 0.1, 1.0
    if leaf == "bias":
        prefix = name[: -len("bias")]
        for sibling in ("weight", "weight_v"):
            if prefix + sibling in shapes:
                return _fan(shapes[prefix + sibling]) ** -0.5, 0.0
    return 0.1, 0.0


def draw(shapes: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor} for ``shapes`` ({name: shape}), on ``device``,
    views into one buffer drawn from ``seed``."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        scale, shift = _scale_shift(name, shapes[name], shapes)
        leaf = flat[at:at + size].view(shapes[name])
        leaf.mul_(scale).add_(shift)
        out[name] = leaf
        at += size
    return out


def leaf_shapes(*modules: tuple[str, torch.nn.Module]) -> dict:
    """{prefix.name: shape} of every parameter of the (prefix, module)
    pairs."""
    return {f"{prefix}.{n}": tuple(p.shape)
            for prefix, m in modules for n, p in m.named_parameters()}


@torch.no_grad()
def fill(seed: int, **modules: torch.nn.Module) -> None:
    """Set every parameter of ``modules`` (keyword: prefix) to its
    seed-made value, drawn on the modules' device."""
    pairs = list(modules.items())
    device = next(pairs[0][1].parameters()).device
    values = draw(leaf_shapes(*pairs), seed, device)
    for prefix, m in pairs:
        for n, p in m.named_parameters():
            p.copy_(values[f"{prefix}.{n}"].to(p.dtype))
