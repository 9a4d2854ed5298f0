"""JAX parameters -> the port's ``state_dict``.

``params_from_jax`` takes a JAX parameter tree (``params_g`` for the
generator, ``params_d`` for the discriminator) as a nested dict of numpy
arrays (``jax.tree.map(np.asarray, params)``), so it imports no JAX.  The
port's modules carry the JAX module names, so a module at path ``a.b.c``
in the tree becomes keys ``a.b.c.<param>``.  Layout rules:

  Conv1d          kernel [k, in/groups, out] -> weight[_v] [out, in/groups, k];
                  g [out]
  ConvTranspose1d kernel [k, in, out] -> weight_v [in, out, k] (no flip)
                  (the decoder's ``up_<i>`` modules)
  Conv2dP         kernel [kh, 1, in, out] -> weight_v [out, in, kh, 1]
  Dense           kernel [in, out]    -> weight [out, in]
  Embed           embedding           -> weight, unchanged
  LayerNorm       gamma / beta        -> unchanged
  attention       emb_rel_k / emb_rel_v -> unchanged
"""

from __future__ import annotations

import re

import numpy as np
import torch

_CONV_T = re.compile(r"(^|\.)decoder\.up_\d+$")


def _module(path: str, leaves: dict) -> dict:
    """One module's leaves -> its state_dict entries."""
    out = {}
    rest = dict(leaves)
    kernel = rest.pop("kernel", None)
    g = rest.pop("g", None)
    if kernel is not None:
        if kernel.ndim == 3 and _CONV_T.search(path):
            w = kernel.transpose(1, 2, 0)
        elif kernel.ndim == 3:
            w = kernel.transpose(2, 1, 0)
        elif kernel.ndim == 4 and kernel.shape[1] == 1 and g is not None:
            w = kernel.transpose(3, 2, 0, 1)
        elif kernel.ndim == 2 and g is None:
            w = kernel.T
        else:
            raise ValueError(f"{path}: kernel of shape {kernel.shape} has no "
                             "torch layout rule")
        if g is not None:
            out["weight_v"], out["weight_g"] = w, g
        else:
            out["weight"] = w
    elif g is not None:
        raise ValueError(f"{path}: weight-norm g without a kernel")
    if "bias" in rest:
        out["bias"] = rest.pop("bias")
    if "embedding" in rest:
        out["weight"] = rest.pop("embedding")
    for name in ("gamma", "beta", "emb_rel_k", "emb_rel_v"):
        if name in rest:
            out[name] = rest.pop(name)
    if rest:
        raise ValueError(f"{path}: unconsumed JAX leaves {sorted(rest)}")
    return {f"{path}.{k}": v for k, v in out.items()}


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (a JAX parameter tree) -> the port's
    ``state_dict``.  Raises on any leaf it does not consume."""
    state: dict[str, torch.Tensor] = {}

    def walk(node: dict, path: str):
        leaves = {k: v for k, v in node.items() if not isinstance(v, dict)}
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}.{k}" if path else k)
        if leaves:
            if not path:
                raise ValueError(f"unconsumed top-level leaves {sorted(leaves)}")
            for key, arr in _module(path, leaves).items():
                state[key] = torch.from_numpy(np.array(arr, np.float32))

    walk(tree, "")
    return state
