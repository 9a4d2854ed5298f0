#!/usr/bin/env python3
"""Per-block timeline of K1 on one CUDA card: when each block starts on
its SM and how long its phases take.

    python3 tools/k1_timeline.py

The card's profilers (ncu, nsys) are not available where the port is
measured, so this builds a copy of ``visinger_tpu_torch/csrc`` under
``build/k1_timeline/`` in which thread 0 of every K1 block records the
card's global timer (``%globaltimer``, ns) at the kernel's start, after the
tile mapping, after the first loads, after the rel dot products, before the
key loop, after its first tile, after the loop and at the end (or at the
end of the masked closed form), with the SM it ran on.  It runs K1 at the
frame shape [4, 640, 192] (lengths 640, 600, 517, 333) and the token
shape [4, 192, 192] (192, 180, 151, 97), dropout off, and prints per
shape one JSON line: the kernel's span, the distinct block start times
(the waves), the median of each phase, and the blocks that end last.
The stamps cost a few instructions per block; the numbers describe the
instrumented build.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N_STAMPS = 10
MAX_BLOCKS = 4096
HEADER = f"""namespace {{
__device__ unsigned long long k1_tl[{MAX_BLOCKS}][{N_STAMPS}];
__device__ __forceinline__ unsigned smid() {{
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}}
__device__ __forceinline__ void stamp(int k) {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) k1_tl[blockIdx.x][k] = t;
}}
"""
# (text in rel_attention.cu, its instrumented form); slot 9 holds the SM,
# item, head and tile of the block
EDITS = [
    ("namespace {\n", HEADER),
    ("  const int dk = DK ? DK : dk_arg;\n",
     "  const int dk = DK ? DK : dk_arg;\n  stamp(0);\n"),
    ("  __syncthreads();  // order[] read: the K/V buffers are free\n",
     "  __syncthreads();  // order[] read: the K/V buffers are free\n"
     "  stamp(1);\n  if (threadIdx.x == 0) k1_tl[blockIdx.x][9] = smid() | "
     "(b << 8) | (h << 16) | ((unsigned long long)(q0 / S::ROWS) << 24);\n"),
    ("                           window);\n    return;",
     "                           window);\n    stamp(8);\n    return;"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n  if (!masked) {\n",
     "  cp_async_wait<0>();\n  __syncthreads();\n  stamp(2);\n"
     "  if (!masked) {\n"),
    ("    __syncthreads();  // raw q read; split it in place into hi and lo\n",
     "    __syncthreads();  // raw q read; split it in place into hi and lo\n"
     "    stamp(3);\n"),
    ("  for (int t = 0; t < n_tiles; ++t) {\n",
     "  stamp(4);\n  for (int t = 0; t < n_tiles; ++t) {\n"
     "    if (t == 1) stamp(5);\n"),
    ("  // merge the key splits in a fixed order\n",
     "  stamp(6);\n  // merge the key splits in a fixed order\n"),
    ("    *(float4*)(out + head + (size_t)i * C + d) = acc;\n  }\n}",
     "    *(float4*)(out + head + (size_t)i * C + d) = acc;\n  }\n"
     "  stamp(7);\n}"),
]
FOOTER = f"""
extern "C" int k1_timeline_read(unsigned long long* host) {{
  return (int)cudaMemcpyFromSymbol(host, k1_tl, sizeof(k1_tl));
}}
extern "C" int k1_timeline_clear() {{
  static unsigned long long zeros[{MAX_BLOCKS}][{N_STAMPS}];
  return (int)cudaMemcpyToSymbol(k1_tl, zeros, sizeof(zeros));
}}
"""


def instrumented_source(src: str) -> str:
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"k1_timeline: no single match for {old[:50]!r}")
        src = src.replace(old, new)
    return src + FOOTER


def build(cuda_build) -> ctypes.CDLL:
    out = ROOT / "build" / "k1_timeline"
    out.mkdir(parents=True, exist_ok=True)
    for f in cuda_build.CSRC.glob("*.cuh"):
        (out / f.name).write_text(f.read_text())
    src = out / "rel_attention.cu"
    src.write_text(instrumented_source(
        (cuda_build.CSRC / "rel_attention.cu").read_text()))
    lib = out / "librel_attention.so"
    subprocess.run([cuda_build._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    return ctypes.CDLL(str(lib))


def summarize(recs, label):
    t0 = min(r[0] for r in recs)
    us = lambda a, b: (b - a) / 1e3  # noqa: E731
    blocks = []
    for i, r in enumerate(recs):
        info = r[9]
        d = {"block": i, "sm": info & 255, "item": (info >> 8) & 255,
             "head": (info >> 16) & 255, "tile": info >> 24,
             "start_us": us(t0, r[0])}
        if r[8]:
            d.update(kind="closed form", closed_form_us=us(r[0], r[8]),
                     end_us=us(t0, r[8]))
        else:
            d.update(kind="key loop", map_us=us(r[0], r[1]),
                     loads_us=us(r[1], r[2]), rel_us=us(r[2], r[3]),
                     split_us=us(r[3], r[4]),
                     first_tile_us=us(r[4], r[5]) if r[5] else None,
                     loop_us=us(r[4], r[6]), merge_us=us(r[6], r[7]),
                     end_us=us(t0, r[7]))
        blocks.append(d)
    loop = [b for b in blocks if b["kind"] == "key loop"]
    med = {k: statistics.median(b[k] for b in loop)
           for k in ("map_us", "loads_us", "rel_us", "split_us", "loop_us",
                     "merge_us")}
    closed = [b["closed_form_us"] for b in blocks if b["kind"] == "closed form"]
    if closed:
        med["closed_form_us"] = statistics.median(closed)
    starts = sorted({round(b["start_us"], 1) for b in blocks})
    last = sorted(blocks, key=lambda b: -b["end_us"])[:4]
    return {"shape": label, "blocks": len(blocks),
            "span_us": max(b["end_us"] for b in blocks),
            "block_starts_us": starts, "median": med, "last_to_end": last}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_timeline: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from visinger_tpu_torch.ops import cuda_build
    from visinger_tpu_torch.ops import rel_attention as ra

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = build(cuda_build)
    cuda_build._libs["rel_attention"] = lib
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    for label, t, lengths in (("[4, 640, 192] frame", 640, [640, 600, 517, 333]),
                              ("[4, 192, 192] token", 192, [192, 180, 151, 97])):
        q, k, v, ek, ev = cs.attention_inputs(torch, gen, t, dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(window=4, scale=96 ** -0.5)
        for _ in range(5):
            ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw)
        torch.cuda.synchronize()
        cuda_build.check(lib.k1_timeline_clear(), "k1_timeline_clear")
        torch.cuda._sleep(10 ** 6)
        ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (MAX_BLOCKS * N_STAMPS))()
        cuda_build.check(lib.k1_timeline_read(buf), "k1_timeline_read")
        # the launcher's choice: 16-row tiles when 32-row ones leave SMs idle
        rows = 32 if -(-t // 32) * 2 * 4 >= n_sm else 16
        n = -(-t // rows) * 2 * 4
        recs = [[buf[i * N_STAMPS + j] for j in range(N_STAMPS)]
                for i in range(n)]
        print(json.dumps(summarize(recs, label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
