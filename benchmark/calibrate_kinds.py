#!/usr/bin/env python3
"""``calibrate.py`` for a cell of any kind: the same readings, one JSON line
each, and the same summary, where a kind's module ``<kind>_cell.py`` gives
its own ``readings(spec, cell, seed, control)`` (``vits_train``); the
``train`` and ``synth`` kinds read as ``calibrate.py`` reads them.

    python3 benchmark/calibrate_kinds.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 1 2 3]"""

from __future__ import annotations

import importlib
import json
import sys

import calibrate
import run

_BUILT_IN = {"train": calibrate.train_readings,
             "synth": calibrate.synth_readings}


def readings(spec, cell, seed, control: bool) -> dict:
    wl = next(w for w in spec["workloads"] if w["name"] == cell)
    kind = json.loads((run.BENCH / "traffic" / f"{wl['traffic']}.json")
                      .read_text())["kind"]
    if kind in _BUILT_IN:
        return _BUILT_IN[kind](spec, cell, seed, control)
    return importlib.import_module(f"{kind}_cell").readings(spec, cell, seed,
                                                            control)


def main(argv=None) -> int:
    # calibrate.main picks train_readings for the "train" kind and
    # synth_readings for any other: both now dispatch on the kind
    calibrate.train_readings = calibrate.synth_readings = readings
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
