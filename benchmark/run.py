#!/usr/bin/env python3
"""Run one cell of the benchmark of ``visinger_tpu_torch`` once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The cell (``BENCHMARK.json``) names a configuration
(``benchmark/configs/<name>.json``) and a traffic mix
(``benchmark/traffic/<name>.json``) whose ``kind`` picks the driver
``benchmark/<kind>_cell.py`` (``train``, ``synth``); every per-layer
metric is read by ``benchmark/metrics/<name>.py``, and the limits of the
comparison with the plain reference are ``benchmark/limits/<cell>.json``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each number compared beside its
limit.  Everything else goes to standard error.  The run exits nonzero,
and prints no result, without CUDA or with fewer cards than the cell asks
for, outside a checkout of the repository, or when ``jax``, ``jaxlib``,
``flax``, ``optax`` or ``visinger_tpu`` is loaded once the window has
closed."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "visinger_tpu")
META_KEYS = ("source", "precision", "assumed", "reduced", "vocabs")
_T_IMPORT = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (from ``/proc``; since this
    module was imported where that cannot be read)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = float(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


class BenchConfig(SimpleNamespace):
    """A configuration file's model and training fields (with ``vocabs``
    and ``precision``), as the reference and the counters read them."""

    @classmethod
    def load(cls, path: Path) -> "BenchConfig":
        data = json.loads(path.read_text())
        return cls(**{k: v for k, v in data.items()
                      if k not in ("source", "assumed", "reduced")})

    def fields(self) -> dict:
        """The fields the port's ``Config`` takes."""
        return {k: v for k, v in vars(self).items() if k not in META_KEYS}

    def reference(self) -> "BenchConfig":
        """The same configuration computed in float32 throughout."""
        return BenchConfig(**{**vars(self), "compute_dtype": "float32",
                              "bf16_f32_islands": []})


class Runtime:
    """One run's cell, seed, window and device, its configuration (the
    port's ``Config`` and the benchmark's view of it) and traffic mix, and
    the device calls the drivers make (no-ops on the CPU, where the tests
    run the harness)."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str, spec: dict, bcfg=None, mix=None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace = trace
        self.workload = next(w for w in spec["workloads"]
                             if w["name"] == cell)
        conf = next(c for c in spec["configs"]
                    if c["name"] == self.workload["config"])
        self.bcfg = bcfg or BenchConfig.load(REPO / conf["file"])
        self.mix = mix or json.loads((BENCH / "traffic" /
                                      f"{self.workload['traffic']}.json")
                                     .read_text())
        import torch

        from visinger_tpu_torch.config import Config

        self.torch = torch
        self.device = torch.device(device)
        self.cfg = Config().apply(self.bcfg.fields())

    def stream_seed(self, stream: int) -> int:
        """A seed of its own for each stream of draws of the run's seed."""
        import numpy as np

        return int(np.random.SeedSequence([self.seed & (2 ** 63 - 1),
                                           stream]).generate_state(
            1, np.uint64)[0] >> 1)

    def process_age(self) -> float:
        return process_age()

    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def synchronize(self):
        if self.on_cuda():
            self.torch.cuda.synchronize(self.device)

    def reset_peak(self):
        if self.on_cuda():
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        if self.on_cuda():
            return int(self.torch.cuda.max_memory_allocated(self.device))
        return 0

    def empty_cache(self):
        if self.on_cuda():
            self.torch.cuda.empty_cache()


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}", BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(spec: dict, cell: str, section: str) -> list[dict]:
    """The ``section`` metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])}
    out = []
    for m in spec[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def execute(spec: dict, cell: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", bcfg=None, mix=None) -> dict:
    """One run of ``cell``; returns the result object.  ``bcfg`` and
    ``mix`` replace the cell's configuration and traffic (the CPU tests run
    the harness at a small size)."""
    rt = Runtime(cell, seed, seconds, trace, device, spec, bcfg, mix)
    torch = rt.torch
    # the configuration's precision: float32 products in float32 (also the
    # float32 islands of a bf16 configuration), not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rt.on_cuda():
        from visinger_tpu_torch.ops import cuda_build

        cuda_build.build_all()
    driver = importlib.import_module(f"{rt.mix['kind']}_cell")
    out = driver.run(rt)

    import correct

    ok, compared = correct.judge(out["numbers"],
                                 correct.load_limits(BENCH, cell))
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    metrics = {}
    if trace:
        reading = out["reading"]
        for m in cell_metrics(spec, cell, "per_layer"):
            kernel = m["name"].split("_roofline")[0].upper()
            if kernel in reading.launches_off:
                continue
            value = load_metric(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(spec, cell, "end_to_end"):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": units[m["name"]]}
    if rt.on_cuda():
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = out["peak_bytes"]
    result = {"correct": ok, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out["reading"].trace is not None:
        tr = out["reading"].trace
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["compared"] = compared
    return result


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    if not (REPO / "visinger_tpu_torch").is_dir():
        print("run: visinger_tpu_torch/ is not beside benchmark/; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"run: no workload {args.workload!r}", file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(REPO))
    import torch

    chips = cells[args.workload]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"run: {args.workload} needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 3
    result = execute(spec, args.workload, args.seed, args.seconds,
                     bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"run: modules loaded that the benchmark may not load: "
              f"{found}", file=sys.stderr)
        return 4
    emit(result)
    return 0


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
