#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from (``PERF.md`` keeps
them): for each seed, the numbers that sound runs of the program give
against the plain reference, and the numbers that the control gives (the
reference itself in the program's place, computed in the precision below
the configuration's: TF32 products for float32, fp8 for bfloat16), and
for a training cell the fault "half of the batch left out".  One process
reads every seed, without a measured window: the training cells compare the checked
steps of the set-up, the synthesis cell ``checked_calls`` of the first
groups a window serves.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 1 2 3]

prints one JSON line per reading and, last, the largest program reading
and the smallest control reading of each number."""

from __future__ import annotations

import argparse
import gc
import json
import sys

import run


def control_precision(bcfg) -> str:
    """The precision below the configuration's: TF32 products for float32,
    fp8 for bfloat16."""
    return "fp8" if bcfg.precision == "bfloat16" else "tf32"


def train_readings(spec, cell, seed, control: bool) -> dict:
    import correct
    import train_cell

    rt = run.Runtime(cell, seed, 0.0, False, "cuda", spec)
    n = rt.mix["checked_steps"]
    p = train_cell.Prepared(rt)
    rec = p.checked(seed, n)
    p.free_program()
    rt.empty_cache()
    ref = p.reference(rt.bcfg, seed, n)
    out = {"program": correct.train_numbers(rec, ref)}
    print(json.dumps({"seed": seed, "detail": {
        "step_loss_gaps": correct.step_loss_gaps(rec["losses"],
                                                 ref["losses"]),
        **{key: correct.worst_leaves(rec, ref, p.leaf_names, key)
           for key in ("grad", "update")}}}), file=sys.stderr)
    if control:
        out["control"] = correct.train_numbers(
            p.reference(rt.bcfg, seed, n, control_precision(rt.bcfg)), ref)
        # the fault "half of the batch left out, the mean taken over the
        # rest", planted in the reference put in the program's place
        halved = train_cell.reference(
            rt.bcfg, seed, p.gen_seed,
            [{k: v[: v.shape[0] // 2] for k, v in b.items()}
             for b in p.batches[:n]],
            [e[: e.shape[0] // 2] for e in p.eps[:n]],
            [i[: i.shape[0] // 2] for i in p.ids[:n]], rt.device)
        out["half_batch"] = correct.train_numbers(halved, ref)
    return out


def synth_readings(spec, cell, seed, control: bool) -> dict:
    import correct
    import synth_cell
    import traffic
    import weights
    from visinger_tpu_torch.infer.infer import TorchSynthesizer
    from visinger_tpu_torch.models.factory import build_model

    rt = run.Runtime(cell, seed, 0.0, False, "cuda", spec)
    bcfg, mix = rt.bcfg, rt.mix
    model = build_model(rt.cfg, *bcfg.vocabs, device=rt.device, seed=0)
    weights.fill(seed, model=model)
    synth = TorchSynthesizer(rt.cfg, model, device=rt.device)
    book = traffic.SynthBook(mix, bcfg, bcfg.vocabs, seed)
    n_groups = 4 * mix["checked_calls"]
    groups = [book.group(g) for g in range(n_groups)]
    outs = [synth.synthesize_batch(groups[g], seed=book.call_seed(g)).wavs
            for g in range(n_groups)]
    del synth, model
    gc.collect()
    rt.empty_cache()
    sample = synth_cell.check_sample(
        seed, [synth_cell._unit(g) for g in groups], mix["checked_calls"])
    args = ([groups[g] for g in sample], [book.call_seed(g) for g in sample],
            rt.device)
    ref = [w for ws in synth_cell.reference(bcfg, seed, *args) for w in ws]
    out = {"program": {"wav_gap": correct.wav_gap(
        [w for g in sample for w in outs[g]], ref)}}
    if control:
        ctl = [w for ws in synth_cell.reference(bcfg, seed, *args,
                                                control_precision(bcfg))
               for w in ws]
        out["control"] = {"wav_gap": correct.wav_gap(ctl, ref)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    spec = json.loads((run.REPO / "BENCHMARK.json").read_text())
    sys.path.insert(0, str(run.REPO))
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from visinger_tpu_torch.ops import cuda_build

    cuda_build.build_all()
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    kind = json.loads((run.BENCH / "traffic" / f"{cell['traffic']}.json")
                      .read_text())["kind"]
    readings = train_readings if kind == "train" else synth_readings
    worst: dict = {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        got = readings(spec, args.workload, seed,
                       seed in args.control_seeds)
        for side, numbers in got.items():
            if side == "program" and seed not in args.seeds:
                continue
            print(json.dumps({"seed": seed, "side": side, **numbers}),
                  flush=True)
            for k, v in numbers.items():
                pick = max if side == "program" else min
                key = f"{side}.{k}"
                worst[key] = v if key not in worst else pick(worst[key], v)
        torch.cuda.empty_cache()
    print(json.dumps({"largest_program_and_smallest_control": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
