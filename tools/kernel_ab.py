#!/usr/bin/env python3
"""A/B the port's CUDA kernels against variants of their own sources, on
one CUDA card, in one process.

    python3 tools/kernel_ab.py                 # every variant below
    python3 tools/kernel_ab.py k2_tm128 mma_1x # some of them
    python3 tools/kernel_ab.py --csrc old=build/old_csrc bf16_zero_start
                                               # an earlier design too

``--only TEXT`` keeps the cases whose name holds TEXT (``bf16``, ``K3``).
``--csrc NAME=DIR`` adds a variant built from the sources in DIR (a copy
of an earlier ``csrc/``, or only some of its files: the rest are the
checkout's), e.g. ``git show <commit>:visinger_tpu_torch/csrc/
rel_attention_bf16.cu > build/old_csrc/rel_attention_bf16.cu``.  A bf16
library without ``rel_attention_bf16_fwd_scratch`` (the design before the
score buffer) is called through its own forward signature.

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
  once: the launch and the empty grid); for the bf16 builds,
  ``bf16_zero_start`` (every bf16 mma starts from zero and is added to its
  sum in float32, as the 3xTF32 kernels do, instead of accumulating in the
  mma) and ``bf16_k1_rows16`` (K1-bf16 with 16-row tiles at every shape);
  their ablations ``bf16_k1_no_exp`` (no exp in K1-bf16's sum sweep and a
  product for P's division), ``bf16_k1_launch_only`` (every K1-bf16 block
  returns after choosing its tile), ``bf16_k3_no_exp`` (no exp and no
  division for p in K3-bf16's row and key passes), ``bf16_k3_no_emb`` (no
  emb partials in the row pass).

Cases: K1 at [4, 640, 192] (dropout 0 and 0.1) and [4, 192, 192], K3
(dropout 0.1) at [4, 640, 192] and [4, 192, 192], K2 at x [4, 640, 192]
with L=4 and L=16, K1-bf16 and K3-bf16 at [4, 640, 192] (dropout 0 and
0.1), [4, 192, 192] and K1-bf16 at the MIDI phrase [1, 1280, 192], ragged
lengths as in ``chip_smoke.py``.  Only the libraries whose sources a
variant changes are built for it.
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
RB = "rel_attention_bf16.cu"
_BF16_MMA = """      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}"""
_BF16_MMA_ZERO = """      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\\n"
      : "=f"(z[0]), "=f"(z[1]), "=f"(z[2]), "=f"(z[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
  for (int e = 0; e < 4; ++e) d[e] += z[e];
}"""
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
    "bf16_zero_start": [
        (RB, "                                    uint32_t b0, uint32_t b1) {\n"
             "  asm volatile(",
         "                                    uint32_t b0, uint32_t b1) {\n"
         "  float z[4];\n  asm volatile("),
        (RB, _BF16_MMA, _BF16_MMA_ZERO),
    ],
    "bf16_k1_rows16": [(RB, "  if ((T + 31) / 32 * (C / dk) * B >= n_sm &&",
                        "  if (false &&")],
    "bf16_k1_no_exp": [
        (RB, "      a.x = expf(a.x - m_row[0]);\n      a.y = expf(a.y - m_row[0]);\n"
             "      a.z = expf(a.z - m_row[1]);\n      a.w = expf(a.w - m_row[1]);",
         "      a.x -= m_row[0];\n      a.y -= m_row[0];\n"
         "      a.z -= m_row[1];\n      a.w -= m_row[1];"),
        (RB, "        float pe = p[n][e] / l_row[rr];",
         "        float pe = p[n][e] * l_row[rr];"),
    ],
    "bf16_k1_launch_only": [
        (RB, "  const bool valid = q0 + S::ROWS <= len;    // every row below len\n",
         "  const bool valid = q0 + S::ROWS <= len;    // every row below len\n"
         "  if (len >= 0) return;\n")],
    "bf16_k3_no_exp": [
        (RB, "        const float p = expf(x - m_row[rr]) / l_row[rr];",
         "        const float p = x - m_row[rr] * l_row[rr];"),
        (RB, "          const float p = expf(x - R[il * 2]) / R[il * 2 + 1];",
         "          const float p = x - R[il * 2] * R[il * 2 + 1];"),
    ],
    "bf16_k3_no_emb": [
        (RB, "    for (int r = 0; r < BT; ++r) {\n      sk = fmaf(Bp",
         "    for (int r = 0; r < 0; ++r) {\n      sk = fmaf(Bp")],
}


def write_variant(name: str, csrc: Path, out: Path, sources=None) -> None:
    """The checkout's sources with a variant's substitutions, or with the
    files of directory ``sources`` in their place, under ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    for f in csrc.iterdir():
        if sources is not None:
            own = sources / f.name
            (out / f.name).write_text((own if own.exists() else f)
                                      .read_text())
            continue
        text = f.read_text()
        for fname, old, new in VARIANTS[name]:
            if f.name == fname:
                if old not in text:
                    raise RuntimeError(f"{name}: no match in {fname}: "
                                       f"{old[:60]!r}")
                text = text.replace(old, new)
        (out / f.name).write_text(text)


class OldBf16Forward:
    """A bf16 library from before the score buffer, whose forward takes no
    scratch argument, behind the current forward signature (the wrapper
    sets ``argtypes`` on the functions it calls, so these are Python
    functions with their own attributes)."""

    def __init__(self, lib):
        self._lib = lib
        old = lib.rel_attention_bf16_fwd
        old.restype = ctypes.c_int
        old.argtypes = ([ctypes.c_void_p] * 6
                        + [ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
                           ctypes.c_int]
                        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_void_p])

        def fwd(*args):  # ..., out, stats, scratch, B, T, C, dk, w, scale, s
            return old(*args[:12], *args[13:])

        def fwd_scratch(*_):
            return 0

        self.rel_attention_bf16_fwd = fwd
        self.rel_attention_bf16_fwd_scratch = fwd_scratch

    def __getattr__(self, name):
        return getattr(self._lib, name)


def build(names, dirs, cuda_build, checkout):
    """Build every variant's changed libraries in parallel -> {variant:
    {kernel: library}}, the unchanged ones the checkout's; prints each
    build's register and spill lines.  ``dirs`` maps the ``--csrc``
    variants to their source directories."""
    procs, libs = {}, {}
    for v in [*names, *dirs]:
        out = ROOT / "build" / "kernel_ab" / v
        write_variant(v, cuda_build.CSRC, out, dirs.get(v))
        headers = [h.name for h in cuda_build.CSRC.glob("*.cuh")]
        libs[v] = dict(checkout)
        for n in cuda_build.KERNELS:
            if all((out / f).read_text() == (cuda_build.CSRC / f).read_text()
                   for f in (f"{n}.cu", *headers)):
                continue
            lib = out / f"lib{n}.so"
            cmd = [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                   "-Xcompiler", "-fPIC", "-o", str(lib), str(out / f"{n}.cu")]
            procs[(v, n)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True), lib)
    for (v, n), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v}/{n}:\n{log[-4000:]}")
        print(json.dumps({"build": v, "kernel": n, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
        cdll = ctypes.CDLL(str(lib))
        if n == "rel_attention_bf16" and not hasattr(
                cdll, "rel_attention_bf16_fwd_scratch"):
            cdll = OldBf16Forward(cdll)
        libs[v][n] = cdll
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

    names, dirs, argv, only = [], {}, sys.argv[1:], ""
    while argv:
        a = argv.pop(0)
        if a == "--csrc":
            name, _, path = argv.pop(0).partition("=")
            dirs[name] = ROOT / path
        elif a == "--only":
            only = argv.pop(0)
        elif a in VARIANTS:
            names.append(a)
        else:
            print(f"kernel_ab: unknown variant {a}", file=sys.stderr)
            return 2
    if not names and not dirs:
        names = list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all()
    checkout = {n: cuda_build.load(n) for n in cuda_build.KERNELS}
    libs = {"checkout": checkout}
    libs.update(build(names, dirs, cuda_build, checkout))
    names = [*names, *dirs]

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
    for t, lengths, c in ((640, [640, 600, 517, 333], 192),
                          (192, [192, 180, 151, 97], 192),
                          (1280, [1237], 192)):
        q, k, v, ek, ev, lens = cs.bf16_inputs(torch, gen, t, c, lengths,
                                               dev)
        g = torch.randn(len(lengths), t, c, generator=gen).to(dev).bfloat16()
        for rate in (0.0, 0.1):
            if rate and t != 640:
                continue
            kw = dict(window=4, scale=96 ** -0.5, seed=seed, rate=rate)
            shape = f"[{len(lengths)}, {t}, {c}] dropout {rate}"
            ref = ra.rel_attention_plain(q, k, v, ek, ev, lens, **kw)
            cases.append((f"K1-bf16 {shape}",
                          lambda a=(q, k, v, ek, ev, lens), kw=kw:
                          ra.rel_attention_fwd(*a, **kw)[0], (ref,)))
            if t == 1280:
                continue
            use("checkout")
            out, stats = ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw)
            ref = ra.rel_attention_bwd_plain(q, k, v, ek, ev, lens, g, **kw)
            cases.append((f"K3-bf16 {shape}",
                          lambda a=(q, k, v, ek, ev, lens, g, out, stats),
                          kw=kw: ra.rel_attention_bwd(*a, **kw), ref))
    for n_layers in (4, 16):
        args = cs.stack_inputs(torch, gen, dev, [640, 600, 517, 333], 640,
                               192, n_layers, 5)
        cases.append((f"K2 x [4, 640, 192] L={n_layers}",
                      lambda a=args: ws.wavenet_stack_fwd(*a),
                      (ws.wavenet_stack_plain(*args),)))

    cases = [c for c in cases if only in c[0]]
    order = ["checkout", *names]
    for case, fn, ref in cases:
        row = {"case": case}
        for v in order:
            use(v)
            a, b = fn(), fn()
            torch.cuda.synchronize()
            a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
            row[v] = {"max_abs_err": max(float((x.float() - r.float())
                                               .abs().max())
                                         for x, r in zip(a, ref)),
                      "err_of_peak": max(cs.bf16_err(x, r)
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
