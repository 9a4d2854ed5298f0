"""The spans of ``utils/meters.span`` (the port alone, no JAX): one shared
no-op without a profiler; under ``torch.profiler`` the named ranges of a
training step and of a synthesis call, nested as the layers are, each an
ordinary host operation; and no number of the step or of the waveforms
moved by tracing."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_port_cores  # noqa: F401  (shares the cores)
from visinger_tpu_torch.config import tiny_config
from visinger_tpu_torch.data.synthetic import synthetic_batch
from visinger_tpu_torch.infer.infer import TorchSynthesizer
from visinger_tpu_torch.models.factory import build_models
from visinger_tpu_torch.training.train_state import create_train_state
from visinger_tpu_torch.training.train_step import make_train_step
from visinger_tpu_torch.utils import meters
from visinger_tpu_torch.utils.meters import span

VOCABS = (40, 96, 64)
PREFIXES = ("train.", "model.", "synth.")
STEP_CHILDREN = ["train.g.forward", "train.g.backward", "train.g.optimizer",
                 "train.d.forward", "train.d.backward", "train.d.optimizer",
                 "train.metrics"]


def traced(fn):
    """``fn()`` under the CPU profiler (shapes recorded, so the spans keep
    their ``unit``) -> (its result, the program's spans as (name, start,
    end, unit) in order of start)."""
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end,
                     e.kwinputs.get("unit")) for e in prof.events()
                    if e.name.startswith(PREFIXES)), key=lambda s: s[1])
    return out, spans


def inside(spans, outer):
    """The spans inside ``outer`` (a span), in order of start."""
    return [s for s in spans if s is not outer
            and outer[1] <= s[1] and s[2] <= outer[2]]


def children(spans, outer):
    """The spans directly inside ``outer``."""
    within = inside(spans, outer)
    return [s for s in within
            if not any(s in inside(within, o) for o in within)]


def names(spans):
    return [s[0] for s in spans]


def one(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, names(spans)
    return found[0]


# --- the primitive ----------------------------------------------------------

def test_without_a_profiler_a_span_is_one_shared_no_op(monkeypatch):
    def refuse(*args):
        raise AssertionError("a profiler call without a profiler")

    monkeypatch.setattr(meters, "_RecordFunctionFast", refuse)
    first = span("train.step", 3)
    assert span("model.prior") is first
    with first as entered:
        assert entered is None


def test_the_flag_span_reads_is_the_one_torch_profiler_sets():
    # a private attribute of torch.autograd.profiler: pinned here
    assert torch.autograd.profiler._is_profiler_enabled is False
    off = span("a")
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert span("a") is not off
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert span("a") is off


def test_a_span_is_a_host_operation_and_not_a_user_annotation():
    # a user annotation is also drawn on the device's track, as a CUDA
    # event that a trace reader would take for device work
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with span("synth.call", "7:0"):
            with span("synth.fetch"):
                torch.ones(4).sum()
    events = {e.name: e for e in prof.events()}
    for name in ("synth.call", "synth.fetch"):
        assert events[name].device_type == torch.autograd.DeviceType.CPU
        assert events[name].is_user_annotation is False
    assert events["synth.call"].kwinputs == {"unit": "7:0"}
    call = events["synth.call"].time_range
    fetch = events["synth.fetch"].time_range
    assert call.start <= fetch.start and fetch.end <= call.end


# --- the training step ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_weights():
    cfg = tiny_config()
    model, disc = build_models(cfg, *VOCABS, device="cpu")
    return cfg, model.state_dict(), disc.state_dict()


def one_step(tiny_weights, step=0, **over):
    """A fresh tiny model pair from the module's weights, one train step at
    ``state.step`` = ``step`` -> (metrics, parameters)."""
    cfg = tiny_weights[0].replace(**over)
    model, disc = build_models(cfg, *VOCABS, device="cpu")
    model.load_state_dict(tiny_weights[1])
    disc.load_state_dict(tiny_weights[2])
    state = create_train_state(model, disc, seed=0)
    state.step = step
    train_step = make_train_step(cfg, model, disc, device="cpu")
    batch = synthetic_batch(2, 12, 64, *VOCABS, cfg.num_linear_bins,
                            cfg.hop_size, seed=3)
    _, metrics = train_step(state, batch)
    params = [p.detach().clone() for m in (model, disc)
              for p in m.parameters()]
    return metrics, params


@pytest.fixture(scope="module")
def steps(tiny_weights):
    """One step at ``state.step`` 5 untraced, and the same step traced."""
    return (one_step(tiny_weights, step=5),
            traced(lambda: one_step(tiny_weights, step=5)))


def test_a_train_step_gives_the_span_tree_of_its_layers(steps):
    spans = steps[1][1]
    step = one(spans, "train.step")
    assert step[3] == 5
    assert names(children(spans, step)) == STEP_CHILDREN
    assert names(inside(spans, step)) == names(spans)[1:]
    g_fwd = one(spans, "train.g.forward")
    assert names(children(spans, g_fwd)) == [
        "model.prior", "model.posterior", "model.flow", "model.decoder",
        "model.disc"]
    assert names(children(spans, one(spans, "train.d.forward"))) == [
        "model.disc"]
    for name in ("train.g.backward", "train.g.optimizer",
                 "train.d.backward", "train.d.optimizer", "train.metrics"):
        assert children(spans, one(spans, name)) == []


def test_under_remat_the_recomputed_layers_fall_in_the_backward(
        tiny_weights):
    _, spans = traced(lambda: one_step(tiny_weights, remat_policy="full"))
    assert names(children(spans, one(spans, "train.g.backward"))) == [
        "model.prior", "model.posterior", "model.flow", "model.decoder",
        "model.disc"]
    assert names(children(spans, one(spans, "train.d.backward"))) == [
        "model.disc"]


def test_tracing_moves_no_number_of_the_step(steps):
    (metrics, params), ((metrics_t, params_t), _) = steps
    assert metrics.keys() == metrics_t.keys()
    for k in metrics:
        assert torch.equal(metrics[k], metrics_t[k]), k
    assert all(torch.equal(a, b) for a, b in zip(params, params_t))


# --- the synthesis call -----------------------------------------------------

@pytest.fixture(scope="module")
def synthesizer(tiny_weights):
    cfg = tiny_weights[0].replace(max_sentences=2)
    model, _ = build_models(cfg, *VOCABS, device="cpu")
    model.load_state_dict(tiny_weights[1])
    raw = synthetic_batch(3, 12, 64, *VOCABS, cfg.num_linear_bins,
                          cfg.hop_size, seed=4)
    requests = [{k: raw[k][i] for k in ("text_tokens", "note_pitch",
                                        "note_dur", "mel2ph")}
                for i in range(3)]
    return TorchSynthesizer(cfg, model, device="cpu"), requests


def test_a_synthesis_group_gives_the_span_tree_of_its_layers(synthesizer):
    synth, requests = synthesizer
    _, spans = traced(lambda: synth.synthesize_batch(requests, seed=11))
    calls = [s for s in spans if s[0] == "synth.call"]
    assert [c[3] for c in calls] == ["11:0", "11:2"]
    for call in calls:
        assert names(children(spans, call)) == [
            "model.prior", "model.flow", "model.decoder", "synth.fetch"]
        assert names(inside(spans, call)) == names(children(spans, call))


def test_tracing_moves_no_waveform(synthesizer):
    synth, requests = synthesizer
    wavs = synth.synthesize_batch(requests, seed=11).wavs
    traced_wavs = traced(
        lambda: synth.synthesize_batch(requests, seed=11))[0].wavs
    assert len(wavs) == len(traced_wavs) == 3
    assert all(np.array_equal(a, b) for a, b in zip(wavs, traced_wavs))
