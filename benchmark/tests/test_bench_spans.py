"""The readers of the program's spans (``spans.py``, the ``*_ms`` metrics,
``span_report.py``): on a hand-made trace with known kernel and host
intervals, on the CPU trace of a tiny run, and on the card (``-m card``)
that a span adds no device event to the trace."""

import contextlib

import pytest
import torch

import readers
import run
import span_report
import spans
import synth_cell
import tiny
import tracing
import train_cell

SPEC = tiny.spec()
SEED = 2 ** 31 + 321
NEW = {"train_forward_ms", "train_backward_ms", "train_optimizer_ms",
       "train_forward_idle_ms", "train_backward_idle_ms",
       "train_optimizer_idle_ms", "synth_prior_ms", "synth_decode_ms",
       "synth_fetch_ms", "synth_prior_idle_ms", "synth_decode_idle_ms"}
US = 1e-6


def hand_made(with_spans=True) -> tracing.Trace:
    """Kernels at 0-10, 20-30 (and 22-28 under it), 45-50 (the backward's,
    launched by another thread) and 70-75 us; the host in a step of 0-60
    us: forward 2-25, backward 25-55, and inside it a recompute 40-52 on
    the backward's thread; synchronising calls at 8, 52.5 and 65 us."""
    trace = tracing.Trace(window_s=80 * US, units=2)
    trace.kernels = [("k", 0, 10), ("k", 20, 30), ("k", 22, 28),
                     ("k_bwd", 45, 50), ("k", 70, 75)]
    trace.host_ops = [("aten::mul", 3, 4), ("cudaLaunchKernel", 19, 20),
                      ("cudaStreamSynchronize", 8, 9),
                      ("cudaDeviceSynchronize", 52.5, 53),
                      ("cudaDeviceSynchronize", 65, 66)]
    if with_spans:
        trace.host_ops += [("train.step", 0, 60),
                           ("train.g.forward", 2, 25),
                           ("train.g.backward", 25, 55),
                           ("model.flow", 40, 52)]
    return trace


def test_span_seconds_are_the_host_intervals():
    trace = hand_made()
    assert spans.span_seconds(trace, ("train.g.forward",)) == \
        pytest.approx(23 * US)
    assert spans.span_seconds(trace, ("train.g.forward",
                                      "train.g.backward")) == \
        pytest.approx(53 * US)


def test_span_idle_is_clipped_to_each_span_whatever_thread_launched():
    trace = hand_made()
    # forward 2-25: busy 2-10 and 20-25
    assert spans.span_idle_seconds(trace, ("train.g.forward",)) == \
        pytest.approx(10 * US)
    # backward 25-55: busy 25-30 and the other thread's 45-50
    assert spans.span_idle_seconds(trace, ("train.g.backward",)) == \
        pytest.approx(20 * US)
    phases = spans.span_idle_seconds(trace, ("train.g.forward",
                                             "train.g.backward"))
    assert phases <= trace.window_s - trace.busy_s


def test_idle_and_syncs_go_to_the_innermost_span():
    trace = hand_made()
    idle = dict(spans.idle_by_span(trace))
    assert idle == pytest.approx({
        "train.g.forward": 10 * US, "train.g.backward": 13 * US,
        "model.flow": 7 * US, "train.step": 5 * US,
        spans.OUTSIDE: 10 * US})
    # every stretch between the first kernel and the last, once
    gaps = 10 + 15 + 20
    assert sum(idle.values()) == pytest.approx(gaps * US)
    assert dict(spans.syncs_by_span(trace)) == {
        "train.g.forward": 1, "train.g.backward": 1, spans.OUTSIDE: 1}


def test_the_per_step_readers_divide_by_the_traced_steps():
    reading = readers.Reading("train", None)
    reading.trace = hand_made()
    read = {name: run.load_metric(name)(reading) for name in NEW}
    assert read["train_forward_ms"] == pytest.approx(23e-3 / 2)
    assert read["train_backward_ms"] == pytest.approx(30e-3 / 2)
    assert read["train_forward_idle_ms"] == pytest.approx(10e-3 / 2)
    assert read["train_backward_idle_ms"] == pytest.approx(20e-3 / 2)
    # no optimizer span in this trace; the synthesis metrics read only a
    # synthesis cell
    assert {k for k, v in read.items() if v is None} == {
        "train_optimizer_ms", "train_optimizer_idle_ms"} | {
        k for k in NEW if k.startswith("synth_")}


def test_a_program_without_spans_gives_nothing_and_raises_nothing():
    trace = hand_made(with_spans=False)
    assert spans.span_seconds(trace, ("train.g.forward",)) is None
    assert spans.span_idle_seconds(trace, ("train.g.forward",)) is None
    assert spans.idle_by_span(trace) == spans.syncs_by_span(trace) == []
    assert spans.span_ms(trace) == {}
    for kind in ("train", "synth"):
        reading = readers.Reading(kind, None)
        reading.trace = trace
        for name in NEW:
            assert run.load_metric(name)(reading) is None, name


def test_every_span_metric_is_declared_per_cell():
    declared = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        kind = name.split("_")[0]
        assert m["workloads"] == [w["name"] for w in SPEC["workloads"]
                                  if w["name"].startswith(kind + ".")]


@pytest.mark.parametrize("cell,top,children", [
    ("train.csd.f32.long", "train.step",
     ["train.g.forward", "train.g.backward", "train.g.optimizer",
      "train.d.forward", "train.d.backward", "train.d.optimizer",
      "train.metrics"]),
    ("synth.csd.f32.batch", "synth.call",
     ["model.prior", "model.flow", "model.decoder", "synth.fetch"])])
def test_a_traced_tiny_run_reads_the_spans_of_its_units(cell, top, children):
    with span_report.capture() as traces:
        run.execute(SPEC, cell, SEED, 1.0, True, device="cpu",
                    bcfg=tiny.bench_config(), mix=tiny.mix(SPEC, cell))
    trace = traces[-1]
    got = span_report.span_breakdown(trace)
    # no kernel on the CPU: no idle time to place
    assert got["idle_by_span"] == [] and got["syncs_by_span"] == []
    ms = got["span_ms"]
    assert set(children) | {top} <= set(ms)
    units = len([s for s in spans.program_spans(trace) if s[0] == top])
    assert units == trace.units
    # the child spans hold the unit's host time
    assert sum(ms[c][0] for c in children) >= 0.95 * ms[top][0]
    assert train_cell.profile is synth_cell.profile is tracing.profile


@pytest.mark.card
def test_a_span_adds_no_device_event_to_the_trace(card):
    from visinger_tpu_torch.utils.meters import span

    x = torch.randn(256, 256, device=card)

    def work(spanned):
        def fn():
            off = contextlib.nullcontext()
            with span("train.step", 0) if spanned else off:
                with span("train.g.forward") if spanned else off:
                    (x @ x).relu_().sum()
        return fn

    plain = tracing.profile(torch, work(False), 1)
    traced = tracing.profile(torch, work(True), 1)
    assert len(plain.kernels) > 0
    assert [k[0] for k in traced.kernels] == [k[0] for k in plain.kernels]
    assert {"train.step", "train.g.forward"} <= {
        op[0] for op in traced.host_ops}
