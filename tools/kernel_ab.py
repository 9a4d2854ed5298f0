#!/usr/bin/env python3
"""A/B the port's CUDA kernels against variants of their own sources, on
one CUDA card, in one process.

    python3 tools/kernel_ab.py                 # every variant below
    python3 tools/kernel_ab.py k2_tm128 mma_1x # some of them

Each variant is the checkout's ``visinger_tpu_torch/csrc`` with a few text
substitutions, built with ``nvcc`` into ``build/kernel_ab/<variant>/`` and
swapped in for the checkout's build between timings.  Two kinds:

- alternatives, which compute the same function (their errors against the
  plain versions are printed): ``k2_tm128`` (128-frame tiles, 8 warps, an
  8-deep weight ring, 120 blocks), ``k2_split_acc`` (the two small 3xTF32
  products summed in a long-lived accumulator, only hi*hi flushed per
  k-step); K1 with fewer key splits a block (``k1_splits4``, ``k1_splits2``,
  ``k1_splits1``: 4, 2 or 1 splits instead of the checkout's 8, with 32-
  and 16-row tiles alike), K1 with 16-row or 32-row tiles at every shape
  (``k1_rows16``, ``k1_rows32``; the checkout picks by T), K1's generic
  build at dk = 96 (``k1_generic``: the head width not a compile-time
  constant), K1 allowed 255
  registers a thread instead of 128 (``k1_regs255``), and the mma
  instructions without ``volatile`` (``mma_nv``, every kernel);
- ablations, which switch a part off to show what it costs (their outputs
  are wrong on purpose): ``no_split`` (operands passed to the tensor cores
  unsplit), ``mma_1x`` (one TF32 product instead of three), ``no_mma`` (no
  tensor-core products), ``k3_no_sdp`` (no S and dP products in K3's dk/dv
  pass), ``k3_no_dkv`` (no dK and dV products), ``k3_no_ew`` (no
  elementwise p / dropout / dS work), ``k1_no_ew`` (no exp in K1's online
  softmax and no dropout hash), ``k1_no_load`` (K1 loads only its first
  key/value tile), ``k1_one_tile`` (K1's key loop stops after one tile: the
  cost outside the loop), ``k1_no_merge`` (K1 stops after its key loop:
  no merge and no output), ``k1_launch_only`` (every K1 block returns at
  once: the launch and the empty grid).

Cases: K1 at [4, 640, 192] (dropout 0 and 0.1) and [4, 192, 192], K3
(dropout 0.1) at [4, 640, 192] and [4, 192, 192], K2 at x [4, 640, 192]
with L=4 and L=16, ragged lengths as in ``chip_smoke.py``.
Device times (``chip_smoke.device_ms``, median of 30) in turns: the
checkout's kernels, each variant, the variants in reverse, the checkout's
again.  Then a profiler table of the checkout's kernels per case.  Prints
the card's name and power limit first and one JSON line per case.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

R, W, H = "rel_attention.cu", "wavenet_stack.cu", "tf32x3.cuh"
_THREE = """  float d[4];
  mma_zero(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
"""
_WARP2X2 = "const int warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;"
VARIANTS = {
    "k2_tm128": [
        (W, "constexpr int TM = 64;", "constexpr int TM = 128;"),
        (W, "constexpr int NSTAGE = 4;", "constexpr int NSTAGE = 8;"),
        (W, "constexpr int NTHREADS = 128;", "constexpr int NTHREADS = 256;"),
        (W, _WARP2X2,
         "const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;"),
    ],
    "k2_split_acc": [
        (W, "  const int wld = 2 * C, cpt = C / KC, ld = lda(C);\n",
         "  const int wld = 2 * C, cpt = C / KC, ld = lda(C);\n"
         "  float sm[2][4][4] = {};\n"),
        (W, "        for (int mt = 0; mt < 2; ++mt) mma3(acc[mt][nt], a[mt], bf);",
         "        for (int mt = 0; mt < 2; ++mt) {\n"
         "          float d[4];\n"
         "          mma_zero(d, a[mt].hi, bf.hi);\n"
         "          mma(sm[mt][nt], a[mt].lo, bf.hi);\n"
         "          mma(sm[mt][nt], a[mt].hi, bf.lo);\n"
         "          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[e];\n"
         "        }"),
        (W, "      }\n    }\n  }\n}\n\n// (A) z",
         "      }\n    }\n  }\n"
         "  for (int mt = 0; mt < 2; ++mt)\n"
         "    for (int nt = 0; nt < 4; ++nt)\n"
         "      for (int v = 0; v < 4; ++v) acc[mt][nt][v] += sm[mt][nt][v];\n"
         "}\n\n// (A) z"),
    ],
    "no_split": [
        (H, '  hi = to_tf32(x);\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) '
            ': "f"(x - __uint_as_float(hi)));',
         "  hi = __float_as_uint(x);\n  lo = 0u;"),
    ],
    "mma_1x": [(H, _THREE, "  float d[4];\n  mma_zero(d, a.hi, b.hi);\n")],
    "no_mma": [
        (H, _THREE + "#pragma unroll\n  for (int e = 0; e < 4; ++e) acc[e] += d[e];",
         "  acc[0] += __uint_as_float(a.hi[0] ^ a.lo[1] ^ a.hi[2] ^ a.lo[3]"
         " ^ b.hi[0] ^ b.lo[1]);"),
    ],
    "k3_no_sdp": [(R, "    if (sd) {\n#pragma unroll 4",
                   "    if (false) {\n#pragma unroll 4")],
    "k3_no_dkv": [
        (R, "          mma3(accv[x], apd, load_b(Gt + kk * LC + 8 * nt, LC));\n"
            "          if (sd) mma3(acck[x], ads, load_b(Qt + kk * LC + 8 * nt, LC));",
         "          accv[x][0] += __uint_as_float(apd.hi[0]);\n"
         "          if (sd) acck[x][0] += __uint_as_float(ads.hi[1]);"),
    ],
    "k3_no_ew": [(R, "      if (i < T && j < T) {\n        const int off = j - i;",
                  "      pd = s[e];\n      ds = dp[e];\n"
                  "      if (false) {\n        const int off = j - i;")],
    "k1_no_ew": [
        (R, "      alpha[rr] = expf(m_run[rr] - m_new);",
         "      alpha[rr] = m_new;"),
        (R, "      const float p = expf(x[e] - m_run[e >> 1]);",
         "      const float p = x[e] - m_run[e >> 1];"),
        (R, "drop.on && keep_bits(rk[e >> 1], j) < drop.thr",
         "drop.on && rk[e >> 1] + j < drop.thr"),
    ],
    "k1_no_load": [(R, "    if (t + 1 < n_tiles) load_tile(t + 1, buf ^ 1);\n", "")],
    "k1_one_tile": [(R, "const int n_tiles = (kend + S::KT - 1) / S::KT;",
                     "const int n_tiles = 1;")],
    "k1_launch_only": [(R, "  const bool valid = q0 + S::ROWS <= len;    // every row below len\n",
                        "  const bool valid = q0 + S::ROWS <= len;    // every row below len\n"
                        "  if (len >= 0) return;\n")],
    "k1_no_merge": [(R, "  // merge the key splits in a fixed order\n",
                     "  if (len >= 0) return;\n")],
    "k1_splits4": [(R, "launch_fwd<2, 8, 96>", "launch_fwd<2, 4, 96>"),
                   (R, "launch_fwd<1, 8, 96>", "launch_fwd<1, 4, 96>")],
    "k1_splits2": [(R, "launch_fwd<2, 8, 96>", "launch_fwd<2, 2, 96>"),
                   (R, "launch_fwd<1, 8, 96>", "launch_fwd<1, 2, 96>")],
    "k1_splits1": [(R, "launch_fwd<2, 8, 96>", "launch_fwd<2, 1, 96>"),
                   (R, "launch_fwd<1, 8, 96>", "launch_fwd<1, 1, 96>")],
    "k1_rows16": [(R, "return (T + 31) / 32 * H * B < n_sm;",
                   "return true;")],
    "k1_rows32": [(R, "return (T + 31) / 32 * H * B < n_sm;",
                   "return false;")],
    "k1_generic": [(R, "dk == 96 ? launch_fwd", "dk == 0 ? launch_fwd")],
    "k1_regs255": [(R, "512 / K1Tile<RG, KS>::NT)", "1)")],
    "mma_nv": [(H, 'asm volatile(\n      "mma.sync', 'asm(\n      "mma.sync')],
}


def write_variant(name: str, csrc: Path, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for f in csrc.iterdir():
        text = f.read_text()
        for fname, old, new in VARIANTS[name]:
            if f.name == fname:
                if old not in text:
                    raise RuntimeError(f"{name}: no match in {fname}: "
                                       f"{old[:60]!r}")
                text = text.replace(old, new)
        (out / f.name).write_text(text)


def build(names, cuda_build):
    """Build every variant's libraries in parallel -> {variant: {kernel:
    CDLL}}; prints each build's register and spill lines."""
    procs = {}
    for v in names:
        out = ROOT / "build" / "kernel_ab" / v
        write_variant(v, cuda_build.CSRC, out)
        for n in cuda_build.KERNELS:
            lib = out / f"lib{n}.so"
            cmd = [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                   "-Xcompiler", "-fPIC", "-o", str(lib), str(out / f"{n}.cu")]
            procs[(v, n)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True), lib)
    libs = {}
    for (v, n), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v}/{n}:\n{log[-4000:]}")
        print(json.dumps({"build": v, "kernel": n, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
        libs.setdefault(v, {})[n] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from visinger_tpu_torch.ops import cuda_build
    from visinger_tpu_torch.ops import rel_attention as ra
    from visinger_tpu_torch.ops import wavenet_stack as ws

    names = sys.argv[1:] or list(VARIANTS)
    for n in names:
        if n not in VARIANTS:
            print(f"kernel_ab: unknown variant {n}", file=sys.stderr)
            return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all()
    libs = {"checkout": {n: cuda_build.load(n) for n in cuda_build.KERNELS}}
    libs.update(build(names, cuda_build))

    def use(v):
        cuda_build._libs.clear()
        cuda_build._libs.update(libs[v])

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    cases = []
    for label, t, lengths, rate in (
            ("frame", 640, [640, 600, 517, 333], 0.0),
            ("frame", 640, [640, 600, 517, 333], 0.1),
            ("token", 192, [192, 180, 151, 97], 0.0)):
        q, k, v, ek, ev = cs.attention_inputs(torch, gen, t, dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(window=4, scale=96 ** -0.5, seed=seed, rate=rate)
        ref = ra.rel_attention_plain(q, k, v, ek, ev, lens, **kw)
        cases.append((f"K1 [4, {t}, 192] dropout {rate}",
                      lambda a=(q, k, v, ek, ev, lens), kw=kw:
                      ra.rel_attention_fwd(*a, **kw)[0], (ref,)))
    for label, t, lengths in (("frame", 640, [640, 600, 517, 333]),
                              ("token", 192, [192, 180, 151, 97])):
        q, k, v, ek, ev = cs.attention_inputs(torch, gen, t, dev)
        g = torch.randn(4, t, 192, generator=gen).to(dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(window=4, scale=96 ** -0.5, seed=seed, rate=0.1)
        use("checkout")
        out, stats = ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw)
        ref = ra.rel_attention_bwd_plain(q, k, v, ek, ev, lens, g, **kw)
        cases.append((f"K3 [4, {t}, 192] dropout 0.1",
                      lambda a=(q, k, v, ek, ev, lens, g, out, stats), kw=kw:
                      ra.rel_attention_bwd(*a, **kw), ref))
    for n_layers in (4, 16):
        args = cs.stack_inputs(torch, gen, dev, [640, 600, 517, 333], 640,
                               192, n_layers, 5)
        cases.append((f"K2 x [4, 640, 192] L={n_layers}",
                      lambda a=args: ws.wavenet_stack_fwd(*a),
                      (ws.wavenet_stack_plain(*args),)))

    order = ["checkout", *names]
    for case, fn, ref in cases:
        row = {"case": case}
        for v in order:
            use(v)
            a, b = fn(), fn()
            torch.cuda.synchronize()
            a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
            row[v] = {"max_abs_err": max(float((x - r).abs().max())
                                         for x, r in zip(a, ref)),
                      "same_bits_twice": all(torch.equal(x, y)
                                             for x, y in zip(a, b)),
                      "ms": []}
        for v in order + order[::-1]:
            use(v)
            row[v]["ms"].append(cs.device_ms(torch, fn))
        print(json.dumps(row), flush=True)

    from torch.profiler import ProfilerActivity, profile

    use("checkout")
    for case, fn, _ in cases:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0)
            if us > 0:
                # "(anonymous namespace)::name(args...)" -> name
                name = re.search(r"(\w+)\(", e.key)
                kernels[name.group(1) if name else e.key[:60]] = {
                    "us_per_call": us / 5, "launches_per_call": e.count / 5}
        print(json.dumps({"profile": case, "kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
