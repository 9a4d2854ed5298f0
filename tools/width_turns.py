#!/usr/bin/env python3
"""Time K1, K3, K2 and the bf16 builds of K1 and K3 at the model's widths
(dk 96, C 192: the shapes of ``chip_smoke.py``'s frame rows) through two
checkouts' wrappers, in turns, on one CUDA card.

    git archive <commit> | tar -x -C build/parent     # an earlier checkout
    python3 tools/width_turns.py --tree parent=build/parent

Turns: the named tree, this checkout, this checkout, the named tree.  Each
turn is a subprocess that puts its tree first on ``sys.path``, so it
imports that tree's ``visinger_tpu_torch`` (wrappers and CUDA sources; the
kernels are built under the tree's own ``build/``), and times each case
with ``chip_smoke.device_ms`` (device ms, median of 30, each call queued
behind a sleep kernel) and ``chip_smoke.call_ms`` (from an idle card, host
time included).  Prints the card's name and power limit, one JSON line per
turn, and the medians per case and tree.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = [640, 600, 517, 333]
CASES = ("K1 [4, 640, 192]", "K1 [4, 640, 192] dropout 0.1",
         "K3 [4, 640, 192] dropout 0.1", "K2 x [4, 640, 192] L=4",
         "K2 x [4, 640, 192] L=16", "K1-bf16 [4, 640, 192]",
         "K3-bf16 [4, 640, 192]")


def measure(tree: Path) -> dict:
    """Device and call ms of every case through ``tree``'s wrappers."""
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from visinger_tpu_torch.ops import cuda_build
    from visinger_tpu_torch.ops import rel_attention as ra
    from visinger_tpu_torch.ops import wavenet_stack as ws

    assert Path(ra.__file__).resolve().is_relative_to(tree.resolve())
    cuda_build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(1)
    window, dk = 4, 96
    lens = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    q, k, v, ek, ev = cs.attention_inputs(torch, gen, 640, dev)
    g = torch.randn(4, 640, 192, generator=gen).to(dev)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    kw = dict(window=window, scale=dk ** -0.5)
    drop = dict(kw, seed=seed, rate=0.1)
    out, stats = ra.rel_attention_fwd(q, k, v, ek, ev, lens, **drop)
    qb, kb, vb, gb = (a.bfloat16() for a in (q, k, v, g))
    outb, statsb = ra.rel_attention_fwd(qb, kb, vb, ek, ev, lens, **kw)
    stacks = {n: cs.stack_inputs(torch, gen, dev, LENGTHS, 640, 192, n, 5)
              for n in (4, 16)}
    fns = dict(zip(CASES, (
        lambda: ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw),
        lambda: ra.rel_attention_fwd(q, k, v, ek, ev, lens, **drop),
        lambda: ra.rel_attention_bwd(q, k, v, ek, ev, lens, g, out, stats,
                                     **drop),
        lambda: ws.wavenet_stack_fwd(*stacks[4]),
        lambda: ws.wavenet_stack_fwd(*stacks[16]),
        lambda: ra.rel_attention_fwd(qb, kb, vb, ek, ev, lens, **kw),
        lambda: ra.rel_attention_bwd(qb, kb, vb, ek, ev, lens, gb, outb,
                                     statsb, **kw))))
    return {name: {"ms": cs.device_ms(torch, fn),
                   "call_ms": cs.call_ms(torch, fn)}
            for name, fn in fns.items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", required=True,
                   help="NAME=DIR, an earlier checkout to time in turns")
    p.add_argument("--measure", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.measure:
        print(json.dumps(measure(Path(args.measure))), flush=True)
        return 0
    name, _, other = args.tree.partition("=")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    turns = [(name, Path(other)), ("checkout", ROOT), ("checkout", ROOT),
             (name, Path(other))]
    runs = {}
    for label, tree in turns:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--tree",
             args.tree, "--measure", str(tree.resolve())],
            capture_output=True, text=True, cwd=tree)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": label, **row}), flush=True)
        runs.setdefault(label, []).append(row)
    summary = {case: {label: {key: sorted(r[case][key] for r in rows)
                              for key in ("ms", "call_ms")}
                      for label, rows in runs.items()}
               for case in CASES}
    print(json.dumps({"width_turns": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
