"""The harness on the CPU: ``BENCHMARK.json`` resolves to its files and
keeps the contract's names, the generator repeats for a seed, a run at
``tiny_config`` prints the contract's last line, the import check, and
runs whose timed path is broken underneath come out not correct."""

import ast
import json
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import run
import tiny
import traffic

BENCH = Path(run.__file__).resolve().parent
SPEC = tiny.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 123


def test_every_name_resolves_to_its_file():
    for c in SPEC["configs"]:
        assert (BENCH.parent / c["file"]).is_file(), c["name"]
    for w in SPEC["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert w["config"] in {c["name"] for c in SPEC["configs"]}
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert callable(run.load_metric(m["name"]))


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]] + \
        [k for c in SPEC["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_every_moving_metric_lists_only_cells_that_report_it():
    reports = {m["name"]: set(m.get("workloads", [w["name"] for w in
                                                  SPEC["workloads"]]))
               for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= reports[m["moves"]], m["name"]
    for w in SPEC["workloads"]:
        e2e = run.cell_metrics(SPEC, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert run.cell_metrics(SPEC, w["name"], "per_layer")


def _train_pool(seed):
    bcfg = tiny.bench_config()
    return traffic.train_pool(tiny.mix(SPEC, "train.csd.f32.long"), bcfg,
                              bcfg.vocabs, seed)


def _book(seed, mix=None):
    bcfg = tiny.bench_config()
    return traffic.SynthBook(mix or tiny.mix(SPEC, "synth.csd.f32.batch"),
                             bcfg, bcfg.vocabs, seed)


def test_train_traffic_repeats_for_a_seed_and_differs_across_seeds():
    (a, sa), (b, sb), (c, _) = (_train_pool(SEED), _train_pool(SEED),
                                _train_pool(SEED + 1))
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(x[k], y[k]), k
    assert all(np.array_equal(x, y) for x, y in zip(sa, sb))
    assert any(not np.array_equal(x["wavs"], y["wavs"])
               for x, y in zip(a, c))
    # the same lengths, in another order
    lengths = sorted(int(n) for x in a for n in x["mel_lengths"])
    assert lengths == sorted(int(n) for x in c for n in x["mel_lengths"])


def test_synth_traffic_repeats_for_a_seed_and_differs_across_seeds():
    a, b, c = _book(SEED), _book(SEED), _book(SEED + 1)
    for g in range(6):
        for x, y in zip(a.group(g), b.group(g)):
            assert all(np.array_equal(x[k], y[k]) for k in x)
        assert a.call_seed(g) == b.call_seed(g) != c.call_seed(g)
    assert any(not np.array_equal(x["text_tokens"], y["text_tokens"])
               for g in range(6) for x, y in zip(a.group(g), c.group(g)))
    n = len(a.lengths)
    frames = sorted(int((r["mel2ph"] > 0).sum())
                    for g in range(n // 4) for r in a.group(g))
    assert frames == sorted(f for f, _ in a.lengths)


def test_rows_are_padded_to_bucket_edges():
    bcfg = tiny.bench_config()
    batches, _ = _train_pool(SEED)
    for x in batches:
        assert x["mel2ph"].shape[1] in bcfg.frame_buckets
        assert x["text_tokens"].shape[1] in bcfg.token_buckets
    for r in _book(SEED).group(0):
        assert len(r["mel2ph"]) in bcfg.frame_buckets


def _execute(cell, trace=False, seconds=1.0):
    return run.execute(SPEC, cell, SEED, seconds, trace, device="cpu",
                       bcfg=tiny.bench_config(), mix=tiny.mix(SPEC, cell))


@pytest.mark.parametrize("cell", ["train.csd.f32.long",
                                  "synth.csd.f32.batch",
                                  "train.csd.bf16.long"])
def test_a_tiny_run_prints_the_contract_line(cell, capsys):
    result = _execute(cell)
    run.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in run.cell_metrics(SPEC, cell, "end_to_end")}
    assert set(line["metrics"]) == want
    assert err.strip().splitlines()[-1].startswith("compared ")


def test_a_traced_tiny_run_reports_no_device_number_from_the_cpu():
    line = _execute("synth.csd.f32.batch", trace=True)
    assert line["device"]["platform"] == "cpu"
    assert line["metrics"] == {}
    assert "breakdown" in line


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    assert "visinger_tpu_torch" in sys.modules
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "visinger_tpu.models",
                        types.ModuleType("visinger_tpu.models"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.forbidden_modules() == ["jaxlib", "visinger_tpu"]


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in (
                    "visinger_tpu_torch", "visinger_tpu", "jax", "flax"), \
                    f"{path.name} imports {name}"


def test_the_test_file_names_are_unused_in_tests():
    ours = {p.name for p in (BENCH / "tests").glob("*.py")}
    theirs = {p.name for p in (BENCH.parent / "tests").glob("*.py")}
    assert not (ours - {"conftest.py"}) & theirs


# --- faults planted under the timed path: the run is not correct ----------

def _unchanged_state(monkeypatch):
    from visinger_tpu_torch.training import train_step

    real = train_step.TrainStep.__call__

    def call(self, state, batch, eps_q=None, ids_slice=None):
        saved = [p.detach().clone() for p in self.model.parameters()]
        state, metrics = real(self, state, batch, eps_q, ids_slice)
        with torch.no_grad():
            for p, s in zip(self.model.parameters(), saved):
                p.copy_(s)
        return state, metrics

    monkeypatch.setattr(train_step.TrainStep, "__call__", call)


def _half_batch(monkeypatch):
    from visinger_tpu_torch.training import train_step

    real = train_step.TrainStep.__call__

    def call(self, state, batch, eps_q=None, ids_slice=None):
        half = batch["mel2ph"].shape[0] // 2
        return real(self, state, {k: v[:half] for k, v in batch.items()},
                    eps_q[:half], ids_slice[:half])

    monkeypatch.setattr(train_step.TrainStep, "__call__", call)


def _altered_answer(monkeypatch):
    from visinger_tpu_torch.infer import infer

    real = infer.TorchSynthesizer.synthesize

    def synthesize(self, batch, generator=None):
        wav = real(self, batch, generator)
        wav[0, wav.shape[1] // 3] += 0.05
        return wav

    monkeypatch.setattr(infer.TorchSynthesizer, "synthesize", synthesize)


def _half_group(monkeypatch):
    from visinger_tpu_torch.infer import infer

    real = infer.TorchSynthesizer.synthesize

    def synthesize(self, batch, generator=None):
        half = batch["mel2ph"].shape[0] // 2
        wav = real(self, {k: v[:half] for k, v in batch.items()}, generator)
        return torch.cat([wav, wav], 0)

    monkeypatch.setattr(infer.TorchSynthesizer, "synthesize", synthesize)


# a training cell's faults are planted in each training cell's numbers and
# limits (the CPU runs every cell in float32, where sound runs read 0)
@pytest.mark.parametrize("cell,fault", [
    ("train.csd.f32.long", _unchanged_state),
    ("train.csd.f32.long", _half_batch),
    ("train.csd.bf16.long", _unchanged_state),
    ("train.csd.bf16.long", _half_batch),
    ("synth.csd.f32.batch", _altered_answer),
    ("synth.csd.f32.batch", _half_group)])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault,
                                                      monkeypatch):
    fault(monkeypatch)
    assert _execute(cell)["correct"] is False
