"""The precision plan of K2's and K3's tensor-core products, on the CPU.

The kernels split every float32 operand into two TF32 values and sum three
TF32 products (3xTF32); ``visinger_tpu_torch/ops/tf32x3.py`` emulates that
arithmetic.  At the kernels' depths (K2: 5 taps x 192 channels = 960;
K3: dk = 96) with unit-variance inputs and weights at the models' init
scale, the 3xTF32 product must stay within 2e-6 of the float64 result's
peak (a plain float32 matmul reads ~4-6e-7), and a single TF32 pass must
miss 1e-4 of it — the reason for the split.  Also: the split of known
values, and the kernel build's staleness check (headers count)."""

import os

import numpy as np
import pytest
import torch

from visinger_tpu_torch.ops import cuda_build
from visinger_tpu_torch.ops.tf32x3 import (matmul_3xtf32, matmul_tf32,
                                           split, tf32_round)

TOL_3X = 2e-6     # of the float64 result's peak
TOL_1X = 1e-4     # a single TF32 pass must exceed this


def _bits(x: float) -> int:
    return int(np.float32(x).view(np.uint32))


def _from_bits(b: int) -> float:
    return float(np.uint32(b).view(np.float32))


@pytest.mark.parametrize("bits,want", [
    (0x3F800FFF, 0x3F800000),   # below half an ulp: down
    (0x3F801000, 0x3F802000),   # a tie: away from zero
    (0xBF801000, 0xBF802000),   # a negative tie: away from zero
    (0x3F803001, 0x3F804000),   # above half an ulp: up
    (0x3FFFF000, 0x40000000),   # carries into the exponent
])
def test_tf32_round_on_known_bits(bits, want):
    got = tf32_round(torch.tensor([_from_bits(bits)]))
    assert _bits(float(got[0])) == want


def test_split_is_exact_for_22_bit_values():
    """hi + lo == x when x has at most 22 significant bits; hi and lo are
    TF32 values (their low 13 bits are zero)."""
    xs = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -11 + 2 ** -20,
                       -(3 + 2 ** -15), 0.1 * 2 ** -3], dtype=torch.float32)
    hi, lo = split(xs)
    assert hi[1] == 1 + 2 ** -10 and lo[1] == -2 ** -11
    assert hi[2] == 1 + 2 ** -10 and lo[2] == -(2 ** -11 - 2 ** -20)
    for h, l in zip(hi, lo):
        assert _bits(float(h)) & 0x1FFF == 0 and _bits(float(l)) & 0x1FFF == 0
    exact = xs[:4]
    assert torch.equal(hi[:4] + lo[:4], exact)
    # 0.1/8 has 24 significant bits: the split keeps 22 of them
    assert abs(float(hi[4] + lo[4]) - float(xs[4])) <= 2 ** -22 * float(xs[4])


@pytest.mark.parametrize("depth,w_scale,label", [
    (960, 960 ** -0.5, "K2 conv: 5 taps x 192 channels"),
    (192, 192 ** -0.5, "K2 1x1"),
    (96, 1.0, "K3 scores: q . k over dk"),
])
def test_3xtf32_is_float32_accurate_and_1xtf32_is_not(depth, w_scale, label):
    rng = np.random.default_rng(depth)
    a = rng.standard_normal((256, depth)).astype(np.float32)
    if w_scale == 1.0:
        b = rng.standard_normal((depth, 128)).astype(np.float32)
    else:   # the models' init: uniform within +-1/sqrt(fan_in)
        b = rng.uniform(-w_scale, w_scale, (depth, 384)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    peak = np.abs(ref).max()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    err3 = np.abs(matmul_3xtf32(ta, tb).double().numpy() - ref).max() / peak
    err1 = np.abs(matmul_tf32(ta, tb).double().numpy() - ref).max() / peak
    errf = np.abs((ta @ tb).double().numpy() - ref).max() / peak
    assert err3 <= TOL_3X, f"{label}: 3xTF32 {err3:.2e} (float32 {errf:.2e})"
    assert err1 > TOL_1X, f"{label}: 1xTF32 only {err1:.2e} of the peak"


def test_build_is_stale_when_a_header_changes(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    src, header, lib = csrc / "k.cu", csrc / "h.cuh", build / "libk.so"
    src.write_text("")
    assert cuda_build._stale("k")       # never built
    header.write_text("")
    lib.write_text("")
    for path, when in ((src, 100), (header, 100), (lib, 200)):
        os.utime(path, (when, when))
    assert not cuda_build._stale("k")
    os.utime(header, (300, 300))        # a newer header
    assert cuda_build._stale("k")
    os.utime(lib, (400, 400))
    assert not cuda_build._stale("k")
    os.utime(src, (500, 500))           # a newer source
    assert cuda_build._stale("k")
    lib.unlink()                        # no library at all
    assert cuda_build._stale("k")
