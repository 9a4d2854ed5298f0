"""Plain PyTorch emulation of the tensor-core products in K2 and K3.

The kernels (``csrc/tf32x3.cuh``) multiply float32 matrices on the
tensor cores in TF32 (8-bit exponent, 10-bit mantissa).  One TF32 pass
rounds each operand to ~5e-4 relative, too coarse for the kernels' 1e-4
limits, so they split each operand x into ``hi = tf32(x)`` and
``lo = tf32(x - hi)`` and sum ``lo·hi + hi·lo + hi·hi`` with float32
accumulation (3xTF32; CUTLASS's ``OpMultiplyAddFastF32``).  ``tf32`` is
``cvt.rna.tf32.f32``: round to nearest, ties away from zero, done here on
the int32 bits.  Each product of two TF32 values is exact in float32, so
the float32 matmuls below see the same products as the tensor cores.  The
sums differ: the tensor core rounds its running sum toward zero, which the
kernels keep from compounding by summing each k-step's products from zero
and adding them in float32 (``csrc/tf32x3.cuh``); here every sum rounds to
nearest.

Only the tests use this module: it shows on the CPU what precision the
kernels' arithmetic has, before any time on the card.
"""

from __future__ import annotations

import torch

_LOW13 = -(1 << 13)   # 0xFFFFE000 as int32: keeps sign, exponent, 10 bits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32;
    for finite x, what ``cvt.rna.tf32.f32`` gives."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & _LOW13).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo), both TF32 values, hi = tf32(x), lo = tf32(x - hi)."""
    x = x.float()
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: three TF32 products, small terms
    first, float32 sums."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in a single TF32 pass (what the kernels do not use)."""
    return tf32_round(a) @ tf32_round(b)
