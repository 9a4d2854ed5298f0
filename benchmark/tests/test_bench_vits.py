"""The VITS cell (``vits_train_cell.py``, ``reference/vits.py``,
``counters_vits.py``) on the CPU at ``tiny_vits`` size: its traffic, a run
that prints the contract's line with ``correct`` true, faults planted
under the timed path that come out not correct, the model FLOP counter
against ``torch.utils.flop_counter``, and its spans."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import counters_vits
import run
import span_report
import tiny
import vits_train_cell
import weights
from reference import discriminator as rdisc
from reference import train as rtrain
from reference import vits as rvits
from test_bench_counters import _count

SPEC = tiny.spec()
CELL = "train.vits.ljs.f32"
SEED = 2 ** 31 + 4321


def bench_config(**over) -> "run.BenchConfig":
    from visinger_tpu_torch.config import _plain, tiny_vits

    full = json.loads((run.BENCH / "configs" / "vits_ljs.json").read_text())
    t = tiny_vits()
    fields = {f.name: _plain(getattr(t, f.name))
              for f in dataclasses.fields(t) if f.name in full}
    fields.update(vocabs=[20], precision="float32", **over)
    return run.BenchConfig(**fields)


def mix(**over) -> dict:
    m = json.loads((run.BENCH / "traffic" / "train_ljs.json").read_text())
    m.update(batch=4, pool_batches=3, frames=[24, 48], max_tokens=21)
    m.update(over)
    return m


def _execute(trace=False):
    return run.execute(SPEC, CELL, SEED, 1.0, trace, device="cpu",
                       bcfg=bench_config(), mix=mix())


def test_the_traffic_repeats_for_a_seed_and_has_blanks_between_symbols():
    bcfg = bench_config()
    (a, sa), (b, sb) = (vits_train_cell.vits_pool(mix(), bcfg, SEED)
                        for _ in range(2))
    c, _ = vits_train_cell.vits_pool(mix(), bcfg, SEED + 1)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert all(np.array_equal(x, y) for x, y in zip(sa, sb))
    assert any(not np.array_equal(x["wavs"], y["wavs"]) for x, y in zip(a, c))
    lengths = sorted(int(n) for x in a for n in x["mel_lengths"])
    assert lengths == sorted(int(n) for x in c for n in x["mel_lengths"])
    for x in a:
        n = x["text_lengths"]
        # each batch padded to its own longest item
        assert x["text_tokens"].shape[1] == n.max()
        assert x["wavs"].shape[1] == x["mel_lengths"].max() * bcfg.hop_size
        for row, k in zip(x["text_tokens"], n):
            assert k % 2 == 1 and k <= mix()["max_tokens"]
            assert (row[0:k:2] == 0).all() and (row[1:k:2] > 0).all()
            assert (row[k:] == 0).all()


def test_a_tiny_run_prints_the_contract_line(capsys):
    result = _execute()
    run.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert line["compared"]["mas_path_mismatch"]["value"] == 0
    assert err.strip().splitlines()[-1].startswith("compared ")


def test_a_traced_tiny_run_holds_the_alignment_and_duration_spans():
    with span_report.capture() as traces:
        line = _execute(trace=True)
    assert line["metrics"] == {} and line["device"]["platform"] == "cpu"
    ms = span_report.span_breakdown(traces[-1])["span_ms"]
    assert {"train.g.forward", "model.prior", "model.posterior",
            "model.flow", "model.mas", "model.sdp", "model.decoder",
            "model.disc"} <= set(ms)


def test_the_span_readers_read_the_alignment_and_duration_spans():
    import readers
    import tracing

    trace = tracing.Trace(window_s=100e-6, units=2)
    trace.kernels = [("k", 0, 10), ("k", 30, 40)]
    trace.host_ops = [("train.g.forward", 0, 60), ("model.mas", 5, 35),
                      ("model.sdp", 40, 50)]
    reading = readers.Reading("train", None)
    reading.trace = trace
    read = {m: run.load_metric(m)(reading) for m in
            ("train_mas_ms", "train_mas_idle_ms", "train_sdp_ms")}
    assert read == pytest.approx({"train_mas_ms": 15e-3,
                                  "train_mas_idle_ms": 10e-3,
                                  "train_sdp_ms": 5e-3})
    reading.kind = "synth"
    assert all(run.load_metric(m)(reading) is None for m in read)


def test_the_reference_alignment_follows_the_programs_path_at_ties():
    """On integer costs (exact ties everywhere), a hint that is an optimal
    path of its own (the loop's path of slightly perturbed costs) is
    followed frame for frame; without a hint the loop's path comes out."""
    from reference import mas as rmas

    rng = np.random.default_rng(5)
    for _ in range(6):
        t_y, t_x = int(rng.integers(8, 24)), int(rng.integers(2, 8))
        cost = rng.integers(-2, 3, (t_y, t_x)).astype(np.float32)
        loop = rmas.tokens_of(rmas.path_each_loop(cost.copy(), t_y, t_x))
        assert np.array_equal(rmas.tokens_of(rmas.path_each(cost, t_y, t_x)),
                              loop)
        noisy = cost + 1e-3 * rng.standard_normal(cost.shape).astype(
            np.float32)
        hint = rmas.tokens_of(rmas.path_each_loop(noisy, t_y, t_x))
        splits = []
        got = rmas.tokens_of(rmas.path_each(cost, t_y, t_x, hint, splits))
        assert np.array_equal(got, hint)
        assert all(gap == 0.0 for gap in splits)


# --- faults planted under the timed path: the run is not correct ----------

def _shifted_path(monkeypatch):
    from visinger_tpu_torch.ops import mas

    real = mas.host_path

    def host_path(value, t_x, t_y):
        path = real(value, t_x, t_y)
        path[:, 1:] = path[:, :-1].copy()             # one frame later
        return path

    monkeypatch.setattr(mas, "host_path", host_path)


def _no_logdet(monkeypatch):
    from visinger_tpu_torch.modules import sdp

    real = sdp.ConvFlow.forward

    def forward(self, x, x_mask, g=None, reverse=False):
        out = real(self, x, x_mask, g=g, reverse=reverse)
        return out if reverse else (out[0], torch.zeros_like(out[1]))

    monkeypatch.setattr(sdp.ConvFlow, "forward", forward)


def _clipped(monkeypatch):
    from visinger_tpu_torch.training import train_state

    real = train_state.make_optimizers

    def make_optimizers(cfg, steps_per_epoch=None):
        return tuple(dataclasses.replace(o, max_norm=1.0)
                     for o in real(cfg, steps_per_epoch))

    monkeypatch.setattr(train_state, "make_optimizers", make_optimizers)
    from visinger_tpu_torch.training import train_step

    monkeypatch.setattr(train_step, "make_optimizers", make_optimizers)


@pytest.mark.parametrize("fault", [_shifted_path, _no_logdet, _clipped])
def test_a_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert _execute()["correct"] is False


# --- the model FLOP counter ------------------------------------------------

@pytest.mark.parametrize("frames", [(24, 48), (40, 40)])
def test_vits_train_step_flops_match_flop_counter(frames):
    bcfg = bench_config()
    rcfg = bcfg.reference()
    batches, starts = vits_train_cell.vits_pool(mix(frames=list(frames)),
                                                bcfg, SEED)
    batch = batches[0]
    model = rvits.VITS(rcfg, 20)
    disc = rdisc.MultiPeriodDiscriminator(
        tuple(rcfg.disc_periods), rcfg.disc_s_base,
        tuple(rcfg.disc_p_channels), rcfg.disc_pair_batch,
        rcfg.use_spectral_norm)
    weights.fill(SEED, model=model, disc=disc)
    state = rtrain.ref_state(model, disc, 3)
    step = rvits.RefVITSStep(rcfg, model, disc, "cpu")
    t = batch["wavs"].shape[1] // bcfg.hop_size
    eps = torch.zeros(batch["wavs"].shape[0], t, bcfg.hidden_size)
    counted = _count(lambda: step(state, batch, eps,
                                  torch.from_numpy(starts[0])))
    b, n = batch["text_tokens"].shape
    assert counters_vits.train_step_flops(bcfg, b, n, t) == counted


def test_the_cell_is_named_in_the_lists_of_the_metrics_it_reports():
    lists = {m["name"]: m.get("workloads", []) for m in
             SPEC["end_to_end"] + SPEC["per_layer"]}
    for name in ("train_frames_per_s", "train_mfu", "train_idle",
                 "train_launches_per_step", "train_syncs_per_step",
                 "k1_roofline.train", "k3_roofline.train",
                 "k2_roofline.train", "conv_share.train", "train_mas_ms",
                 "train_mas_idle_ms", "train_sdp_ms"):
        assert CELL in lists[name], name
    assert lists["train_mas_ms"] == [CELL]
