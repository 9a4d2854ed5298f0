"""The benchmark at a size the CPU tests hold: ``tiny_config``'s widths
and depths, small vocabularies and bucket edges, and short mixes."""

import dataclasses
import json
from pathlib import Path

import run

BENCH = Path(__file__).resolve().parents[1]


def bench_config(**over) -> "run.BenchConfig":
    from visinger_tpu_torch.config import _plain, tiny_config

    full = json.loads((BENCH / "configs" / "visinger_csd.json").read_text())
    t = tiny_config()
    fields = {f.name: _plain(getattr(t, f.name))
              for f in dataclasses.fields(t) if f.name in full}
    fields.update(vocabs=[12, 20, 16], precision="float32",
                  frame_buckets=[32, 64, 96, 128],
                  token_buckets=[8, 16, 24, 48])
    fields.update(over)
    return run.BenchConfig(**fields)


def mix(spec: dict, cell: str) -> dict:
    wl = next(w for w in spec["workloads"] if w["name"] == cell)
    m = json.loads((BENCH / "traffic" / f"{wl['traffic']}.json").read_text())
    m.update(frames=[64, 128], max_tokens=48)
    if m["kind"] == "synth":
        m.update(max_calls_per_s=2, book=8, checked_calls=3, traced_calls=2)
    else:
        m.update(pool_batches=4)
    return m


def spec() -> dict:
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())
