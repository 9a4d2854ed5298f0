"""A ``synth`` cell: ``TorchSynthesizer.synthesize_batch`` of the port in a
closed loop of ``clients`` clients; the outstanding scores go to the port
together, one group a call, and each client sends its next score when the
call has returned its waveform.

Set-up builds the model with the seed-made weights, makes the request
sequence, and serves one group of each padded shape the window can reach.
Every request's latency is its call's, from the call's start until its
waveform is on the host.  After the window a sample of the groups served,
drawn from the seed and holding the longest group, is synthesized again by
the plain reference with the same prior-noise seed and compared."""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

import correct
import counters
import readers
import traffic
import weights
from tracing import profile
from train_cell import Unit


def _unit(group: list[dict]) -> Unit:
    return Unit(max(len(r["text_tokens"]) for r in group),
                max(len(r["mel2ph"]) for r in group),
                [int((r["text_tokens"] > 0).sum()) for r in group],
                [int((r["mel2ph"] > 0).sum()) for r in group])


def p95(values: list[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def sound(wav: np.ndarray, frames: int, hop: int) -> bool:
    """A waveform of the right length, finite, within [-1, 1] and not
    silent."""
    if wav.shape != (frames * hop,) or not np.isfinite(wav).all():
        return False
    peak = float(np.abs(wav).max())
    return 1e-6 < peak <= 1.0


def run(rt) -> dict:
    from visinger_tpu_torch.infer.infer import TorchSynthesizer
    from visinger_tpu_torch.models.factory import build_model
    from visinger_tpu_torch.ops import rel_attention as ra
    from visinger_tpu_torch.ops import wavenet_stack as ws

    cfg, bcfg, dev, mix = rt.cfg, rt.bcfg, rt.device, rt.mix
    hop, sr = cfg.hop_size, cfg.sample_rate
    model = build_model(cfg, *bcfg.vocabs, device=dev, seed=0)
    weights.fill(rt.seed, model=model)
    synth = TorchSynthesizer(cfg, model, device=dev)
    book = traffic.SynthBook(mix, bcfg, bcfg.vocabs, rt.seed)
    n_groups = int(mix["max_calls_per_s"] * rt.seconds) + 64
    groups = [book.group(g) for g in range(n_groups)]
    first = {}
    for g in range(n_groups):
        first.setdefault(book.group_shape(g), g)
    for g in first.values():                             # warm-up
        synth.synthesize_batch(groups[g], seed=book.call_seed(g))
    rt.synchronize()
    rt.reset_peak()
    setup_s = rt.process_age()

    def call(g):
        group = groups[g % n_groups]
        return synth.synthesize_batch(group, seed=book.call_seed(g)).wavs

    latencies, outs, audio_s, n_flops = [], [], 0.0, 0.0
    t0 = time.perf_counter()
    while True:
        g = len(outs)
        c0 = time.perf_counter()
        wavs = call(g)
        c1 = time.perf_counter()
        outs.append(wavs)
        latencies.extend([c1 - c0] * len(wavs))
        unit = _unit(groups[g % n_groups])
        audio_s += sum(unit.frame_lengths) * hop / sr
        n_flops += counters.synth_flops(bcfg, len(wavs), unit.n, unit.t)
        if c1 - t0 >= rt.seconds:
            break
    window = c1 - t0

    reading = readers.Reading("synth", bcfg)
    reading.mfu_flops, reading.mfu_seconds = n_flops, window
    if rt.trace:
        at = len(outs)
        units = mix.get("traced_calls", 8)
        counts0 = (ra.launches + ra.launches_bf16, ws.launches)
        reading.trace = profile(
            torch, lambda: [call(at + u) for u in range(units)], units,
            rt.on_cuda())
        counts = [c1 - c0 for c0, c1 in zip(
            counts0, (ra.launches + ra.launches_bf16, ws.launches))]
        reading.traced = [_unit(groups[(at + u) % n_groups])
                          for u in range(units)]
        tok = bcfg.enc_layers
        frame = bcfg.frame_prior_layers + (bcfg.pitch_predictor_layers
                                           if bcfg.use_pitch_embed else 0)
        reading.launch_check(counts, [(tok + frame) * units,
                                      bcfg.flow_n_flows * units],
                             ("K1", "K2"))
    peak_bytes = rt.peak_bytes()

    failed = 0
    for g, wavs in enumerate(outs):
        for r, wav in zip(groups[g % n_groups], wavs):
            failed += not sound(wav, int((r["mel2ph"] > 0).sum()), hop)

    del synth, model
    gc.collect()
    rt.empty_cache()
    sample = check_sample(rt.seed, [_unit(groups[g % n_groups])
                                    for g in range(len(outs))],
                          mix["checked_calls"])
    ref = reference(bcfg, rt.seed, [groups[g % n_groups] for g in sample],
                    [book.call_seed(g) for g in sample], dev)
    served = [w for g in sample for w in outs[g]]
    numbers = {"wav_gap": correct.wav_gap(served,
                                          [w for ws_ in ref for w in ws_])}
    return {"attempted": len(latencies), "failed": failed,
            "numbers": numbers,
            "e2e": {"synth_audio_s_per_s": audio_s / window,
                    "synth_p95_ms": 1e3 * p95(latencies),
                    "setup_s": setup_s},
            "reading": reading, "peak_bytes": peak_bytes}


def check_sample(seed: int, units: list[Unit], k: int) -> list[int]:
    """``k`` of the served groups, drawn from the seed, the longest (most
    padded frames, then most valid frames) first."""
    longest = max(range(len(units)), key=lambda g: (
        units[g].t, sum(units[g].frame_lengths)))
    rest = [g for g in range(len(units)) if g != longest]
    rng = traffic.seed_rng(seed, 3)
    picked = rng.choice(len(rest), min(k - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[i] for i in picked)


def reference(bcfg, seed: int, groups: list, call_seeds: list, device,
              control: str | None = None) -> list:
    """The plain reference's waveforms of ``groups`` from the seed-made
    weights: for each group, for each request the list of its waveforms
    on either side of every tied voiced decision (``correct.TIE``), the
    plain one first.  With ``control`` "tf32" its products in TF32 (the
    control of a float32 configuration) and each request's plain
    waveform alone, as the program would serve it."""
    from reference import synth as rsynth
    from reference import visinger as rvis

    rcfg = bcfg.reference()
    with torch.device(device):
        model = rvis.VISinger(rcfg, *bcfg.vocabs)
    weights.fill(seed, model=model)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        if tf32:
            return [rsynth.synthesize_group(model, group, s, rcfg.hop_size,
                                            device)
                    for group, s in zip(groups, call_seeds)]
        return [rsynth.candidates(model, group, s, rcfg.hop_size, device,
                                  correct.TIE)
                for group, s in zip(groups, call_seeds)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
