#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of VISinger on one CUDA card: the GAN
training step (the main path), synthesis, and MIDI-to-waveform serving.

    python3 chip_smoke.py              # the check (one card)
    python3 chip_smoke.py --profile    # also write torch.profiler summaries
                                       # of one training step, one
                                       # synthesis group and one MIDI score
                                       # (full and streamed) under
                                       # chiprun_out/

Phases, each printing a line; any failure raises and exits nonzero:
  1. the card's name and power limit (nvidia-smi); TF32 off for matmuls and
     convolutions (every comparison below is float32);
  2. build the CUDA kernels from ``visinger_tpu_torch/csrc`` (one nvcc per
     source, in parallel); print each kernel's registers and spills
     (``-Xptxas -v``) and its dynamic shared memory and resident blocks per
     SM at the model's shapes;
  3. K1 (relative attention) against its plain version, out and each
     row's softmax max and sum (which K3 reads), at the frame-rate shape
     [4, 640, 192], the token-rate shape [4, 192, 192], a ragged
     [4, 637, 192] (lengths 637, 600, 64, 1), head widths 64 and 128
     (K1's generic build), and the longest MIDI phrase [1, 1280, 192]
     (length 1237), 2 heads; beside its times,
     ``scaled_dot_product_attention`` on the same q, k, v with the band
     bias and mask as an additive float mask (``sdpa_partial_ms``, a
     yardstick: it lacks the band-column term); then with dropout 0.1
     against the plain version with the same seed, its keep rate and a
     second seed's different mask;
  4. K3 (attention backward) against autograd of the plain version at both
     shapes, dropout off and 0.1, with a random g; a second run on the same
     inputs must give bit-identical gradients;
  5. K2 (WaveNet stack) at the flow shape x [4, 640, 192], L=4, at the
     posterior shape, L=16, where the gradients of its autograd function are
     also held against plain autograd, and at the streaming window
     [1, 366, 192], L=4 (length 336);
     kernel / plain device times (CUDA events, median of 30, each call
     queued behind a sleep kernel so the wrapper's host time is not in it)
     and per-call times (from an idle card, host time included, the method
     of the earlier kernel tables), and two bounds, at
     the float32 CUDA-core rate (``bound_ms``) and at the float32-accurate
     3xTF32 tensor-core rate (``bound_tc_ms``);
  6. full-width ``visinger_csd`` training with seeded weights: 2 warm-up and
     5 timed steps of ``train_step`` on a synthetic batch of 4 (up to 640
     frames, 192 tokens), with the launches per step (K1 18, K3 18, K2 5),
     finite metrics, changed G and D parameters, ms per step, mel-frames/s
     and peak memory; then one step's losses and generator gradients on the
     card and on the CPU (B=1, T=160, dropout 0, same weights, posterior
     noise and slice), which must agree;
  7. full-width synthesis: 8 token requests of up to 640 frames / 192 tokens
     through ``TorchSynthesizer`` in groups of 4 (launches per group K1 16,
     K2 4), then one short request on the card and on the CPU;
  8. MIDI serving through ``VISingerInfer`` (full width, seeded weights):
     6 written scores of 5-8 s with Hangul lyrics served in bucket groups of
     up to 4 (launches per group K1 16, K2 4; every wav frames x hop long,
     finite, within +-1, not silent; audio-s/s, RTF, group ms, peak
     memory), a 24 s score split into phrases (16 and 4 launches per
     phrase) with pitch_control=4 moving the voiced rows by 4 and the audio,
     the streaming decode of a 600+ frame score (4 K2 launches per window,
     within 1e-4 of its peak of the full decode of the same z_p), and a
     short score on the card and on the CPU with the same noise;
  9. a ``kernels`` JSON line, then the final ``{"ok": true, ...}`` line.

It imports the port only (no JAX) and exits nonzero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_PEAK = 67e12      # H100 SXM float32 FLOP/s outside the tensor cores
TC_F32_PEAK = 495e12 / 3  # 3xTF32 on the tensor cores: three TF32 passes
HBM_RATE = 3.35e12    # H100 SXM device-memory bytes/s
TOL_KERNEL = 1e-4
# card vs CPU waveform: max abs err <= TOL_CPU_REL * max|wav|; the random
# weights give a waveform of ~1e-2 amplitude, so an absolute limit would
# hide a fault of a few percent
TOL_CPU_REL = 1e-4
# card vs CPU training step: each loss within TOL_LOSS_REL of the CPU's, each
# generator gradient tensor within TOL_GRAD_REL of that tensor's peak.  Not
# 1e-3: a ReLU input within rounding of 0 takes the other branch on one
# device, which moves whole rows of the next conv's weight gradient (the
# pitch predictor's FFN read 5.9e-3 of its peak, chip run 2, PR 3, with the
# losses within 2e-7); a wrong kernel moves gradients by O(1) of their peak
TOL_LOSS_REL = 1e-4
TOL_GRAD_REL = 1e-2
# the attention key projection's bias moves every score of a row by the same
# amount, which the softmax removes: its gradient is zero in exact arithmetic
# and rounding noise on both devices, so it is held to a share of the
# largest gradient instead of to its own peak
ZERO_GRAD = ".conv_k.bias"
TOL_ZERO_GRAD = 1e-4
KEEP_TOL = 0.005         # K1 dropout 0.1: keep rate within 0.9 +- this
# K1's stats (each row's score max and sum) against the plain ones, relative
# to max(1, |plain|): an error d in the max moves K3's p = exp(s - max) / sum
# by d of itself, so below 1 the max is held to 1e-5 absolute; the sum is
# at least 1 (the max's own term)
TOL_STATS_REL = 1e-5
VOCABS = (60, 117, 98)   # as bench.py's synthesis benchmark


def phase(tag: str, /, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def call_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Median over ``iters`` calls, each between two CUDA events recorded
    on an idle card: the device's work plus the host time of the call up
    to its last launch (the method of the earlier kernel tables)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


_CYCLES_PER_MS = []


def device_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``iters`` calls.  Each call is
    enqueued behind a sleep kernel three times longer than the host takes
    to enqueue it, so the interval between the events holds the device's
    work (and the gaps between its kernels), not the wrapper's host time."""
    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(10 ** 7 / start.elapsed_time(end))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(max(1.0, 3 * host_ms) * _CYCLES_PER_MS[0])
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def timings(torch, kernel, plain) -> dict:
    """The kernel's and its plain version's device times (``ms``,
    ``plain_ms``) and per-call times from an idle card (``call_ms``,
    ``plain_call_ms``), in turns: plain, kernel, kernel, plain."""
    plain_ms = device_ms(torch, plain)
    ms = device_ms(torch, kernel)
    return {"ms": ms, "plain_ms": plain_ms,
            "call_ms": call_ms(torch, kernel),
            "plain_call_ms": call_ms(torch, plain)}


def bounds(flops: float, nbytes: float) -> dict:
    """The least time for ``flops`` and ``nbytes``: ``bound_ms`` at the
    float32 CUDA-core rate, ``bound_tc_ms`` at the 3xTF32 tensor-core rate,
    each with what bounds it."""
    t_bytes = nbytes / HBM_RATE
    out = {}
    for key, peak in (("bound", F32_PEAK), ("bound_tc", TC_F32_PEAK)):
        t_ops = flops / peak
        out[f"{key}_ms"] = max(t_ops, t_bytes) * 1e3
        out[f"{key}_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


def k1_work(lengths, t, c, heads, window) -> tuple[float, float]:
    """Flops and bytes K1's function needs for these lengths.  A valid row
    gives a key at or past its item's length exp(-1e4 - max) = 0 weight, so
    it needs only len keys; every masked row is the same uniform mean of v
    (plus its band term), computed once per (item, head)."""
    dk, nb = c // heads, 2 * window + 1
    flops = nbytes = 0
    for n in lengths:
        flops += heads * (4 * dk * n * n + 4 * nb * dk * n
                          + (dk * (t + nb) if n < t else 0))
        nbytes += 4 * c * (2 * n + 2 * t)   # q, k: n rows; v, out: t rows
    return flops, nbytes + 4 * 2 * nb * dk + 4 * len(lengths)


def k3_work(lengths, t, c, heads, window) -> tuple[float, float]:
    """Flops and bytes K3's function needs for these lengths.  For each valid
    pair (i, j < len): the score, g.v, and the dq, dk and dv products
    (5 x 2·dk); per valid row the band terms (5 x 2·nb·dk); D_i = g.out
    per row; the masked rows are uniform, so their dv share is one sum of
    their g added to every key."""
    dk, nb = c // heads, 2 * window + 1
    flops = nbytes = 0
    for n in lengths:
        flops += heads * (10 * dk * n * n + 10 * nb * dk * n + 2 * dk * t
                          + (dk * (2 * t - n) if n < t else 0))
        # q, k, v, out: n rows; g: t rows; dq, dk, dv: t rows
        nbytes += 4 * c * (4 * n + 4 * t)
    return flops, nbytes + 4 * 4 * nb * dk + 4 * len(lengths) * (1 + heads
                                                                  * t)


def k2_work(lengths, t, c, n_layers, k) -> tuple[float, float]:
    """Flops and bytes K2's function needs for these lengths.  Layer 0
    reads x at every frame; later layers read h, which the stack zeroes at
    or past each item's length, so only len + K//2 frames differ and the
    rest share one value.  The last layer's 1x1 is C -> C (skip half only)."""
    flops = 0
    for n in lengths:
        live = min(t, n + k // 2) + (1 if n + k // 2 < t else 0)
        for i in range(n_layers):
            per_frame = k * c * 2 * c + (c * c if i == n_layers - 1
                                         else c * 2 * c)
            flops += 2 * (t if i == 0 else live) * per_frame
    b = len(lengths)
    weights = (n_layers * k * c * 2 * c + (n_layers - 1) * c * 2 * c + c * c
               + n_layers * 2 * c + (n_layers - 1) * 2 * c + c)
    nbytes = 4 * (2 * b * t * c + b * t + weights + b * n_layers * 2 * c)
    return flops, nbytes


def ragged_mask(torch, lengths, t, dev):
    """[B, T, 1] float prefix mask."""
    from visinger_tpu_torch.ops.masking import sequence_mask

    return sequence_mask(torch.tensor(lengths, device=dev), t).float()[
        ..., None]


def stats_err(got, ref) -> float:
    """Largest error of K1's stats against the plain ones, relative to
    max(1, |plain|)."""
    return float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())


def sdpa_partial_ms(torch, ra, q, k, v, ek, lens, window, scale) -> float:
    """Device ms of ``scaled_dot_product_attention`` on K1's q, k, v with the
    band bias and the length mask as one additive float mask: a yardstick
    only, since it lacks the band-column term and adds -1e4 where K1 sets
    it (the port never calls it)."""
    b, t, c = q.shape
    dk = ek.shape[1]
    qh, kh, vh = (a.reshape(b, t, c // dk, dk).transpose(1, 2).contiguous()
                  for a in (q, k, v))
    idx = torch.arange(t, device=q.device)
    off = idx[None, :] - idx[:, None]
    rel = (qh @ ek.t()) * scale
    bias = torch.gather(rel, -1, (off + window).clamp(0, 2 * window).expand(
        b, c // dk, t, t)) * (off.abs() <= window)
    valid = idx[None, :] < lens[:, None].long()
    valid = valid[:, None, :, None] & valid[:, None, None, :]
    mask = (bias + torch.where(valid, 0.0, ra.MASK_VAL)).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return device_ms(torch, lambda: sdpa(qh, kh, vh, attn_mask=mask,
                                         scale=scale))


def check_rel_attention(torch, ra, dev):
    """K1 against its plain version, out and stats, at the frame and token
    shapes, a ragged shape whose T is not a multiple of the tiles (lengths
    down to 1) and head widths 64 and 128."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    heads, window = 2, 4
    rows = []
    for label, t, c, lengths in (
            ("frame", 640, 192, [640, 600, 517, 333]),
            ("token", 192, 192, [192, 180, 151, 97]),
            ("ragged", 637, 192, [637, 600, 64, 1]),
            # head widths other than 96 take K1's generic build
            ("dk 64", 640, 128, [640, 600, 517, 333]),
            ("dk 128", 100, 256, [100, 37]),
            # the longest MIDI phrase: one score at the largest frame bucket
            ("midi phrase", 1280, 192, [1237])):
        dk = c // heads
        q, k, v = (torch.randn(len(lengths), t, c, generator=gen).to(dev)
                   for _ in range(3))
        ek, ev = (torch.randn(2 * window + 1, dk, generator=gen).mul(
            dk ** -0.5).to(dev) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(window=window, scale=dk ** -0.5)
        out, stats = ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw)
        ref, ref_stats = ra.rel_attention_plain(q, k, v, ek, ev, lens, **kw,
                                                with_stats=True)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        serr = stats_err(stats, ref_stats)
        check(bool(torch.isfinite(out).all()), f"K1 {label}: non-finite")
        check(err <= TOL_KERNEL, f"K1 {label}: max abs err {err} > {TOL_KERNEL}")
        check(serr <= TOL_STATS_REL, f"K1 {label}: stats err {serr} > "
              f"{TOL_STATS_REL}")
        times = timings(
            torch, lambda: ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw),
            lambda: ra.rel_attention_plain(q, k, v, ek, ev, lens, **kw))
        flops, nbytes = k1_work(lengths, t, c, heads, window)
        row = {"shape": f"[{len(lengths)}, {t}, {c}] {label}",
               "lengths": lengths,
               "max_abs_err": err, "stats_err": serr, **times,
               "sdpa_partial_ms": sdpa_partial_ms(torch, ra, q, k, v, ek,
                                                  lens, window, dk ** -0.5),
               **bounds(flops, nbytes),
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
        phase("k1_rel_attention", **row)
        rows.append(row)
    return rows


def attention_inputs(torch, gen, t, dev, c=192, heads=2, window=4):
    dk = c // heads
    q, k, v = (torch.randn(4, t, c, generator=gen).to(dev) for _ in range(3))
    ek, ev = (torch.randn(2 * window + 1, dk, generator=gen).mul(
        dk ** -0.5).to(dev) for _ in range(2))
    return q, k, v, ek, ev


def check_k1_dropout(torch, ra, dev):
    """K1 with dropout 0.1 against its plain version with the same seed at
    the frame shape; the kernel's keep rate (with q = 0 every row is uniform
    over T keys, so out = v-sum of kept keys / (T (1 - rate)) with v = 1);
    and a second seed's mask differs."""
    gen = torch.Generator(device="cpu").manual_seed(11)
    t, c, heads, window, rate = 640, 192, 2, 4, 0.1
    dk = c // heads
    q, k, v, ek, ev = attention_inputs(torch, gen, t, dev)
    lens = torch.tensor([640, 600, 517, 333], dtype=torch.int32, device=dev)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    kw = dict(window=window, scale=dk ** -0.5, seed=seed, rate=rate)
    out, stats = ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw)
    ref, ref_stats = ra.rel_attention_plain(q, k, v, ek, ev, lens, **kw,
                                            with_stats=True)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    serr = stats_err(stats, ref_stats)
    check(bool(torch.isfinite(out).all()), "K1 dropout: non-finite")
    check(err <= TOL_KERNEL, f"K1 dropout: max abs err {err} > {TOL_KERNEL}")
    check(serr <= TOL_STATS_REL, f"K1 dropout: stats err {serr} > "
          f"{TOL_STATS_REL}")
    full = torch.full((4,), t, dtype=torch.int32, device=dev)
    zeros, ones = torch.zeros_like(q), torch.ones_like(v)
    no_band = torch.zeros_like(ev)
    rates = []
    for s in (12345, 777):
        o, _ = ra.rel_attention_fwd(
            zeros, k, ones, ek, no_band, full, window=window, scale=1.0,
            seed=torch.tensor([s], dtype=torch.int32, device=dev), rate=rate)
        rates.append(o)
    keep = float(rates[0].mean()) * (1 - rate)
    differ = float((rates[0] != rates[1]).float().mean())
    check(abs(keep - (1 - rate)) <= KEEP_TOL,
          f"K1 dropout: keep rate {keep} not within {KEEP_TOL} of "
          f"{1 - rate}")
    check(differ > 0.5, f"K1 dropout: a second seed changed only "
          f"{differ} of the outputs")
    times = timings(
        torch, lambda: ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw),
        lambda: ra.rel_attention_plain(q, k, v, ek, ev, lens, **kw))
    row = {"shape": f"[4, {t}, {c}] frame, dropout {rate}",
           "max_abs_err": err, "stats_err": serr, "keep_rate": keep,
           "second_seed_outputs_changed": differ, **times}
    phase("k1_dropout", **row)
    return row


def check_rel_attention_bwd(torch, ra, dev):
    """K3 against autograd of K1's plain version at the frame and token
    shapes, ragged lengths, a random g, dropout off and 0.1 (same seed); a
    second run on the same inputs must give the same bits."""
    gen = torch.Generator(device="cpu").manual_seed(13)
    c, heads, window = 192, 2, 4
    dk = c // heads
    seed = torch.tensor([2024], dtype=torch.int32, device=dev)
    rows = []
    for label, t, lengths in (("frame", 640, [640, 600, 517, 333]),
                              ("token", 192, [192, 180, 151, 97])):
        q, k, v, ek, ev = attention_inputs(torch, gen, t, dev)
        g = torch.randn(4, t, c, generator=gen).to(dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for rate in (0.0, 0.1):
            kw = dict(window=window, scale=dk ** -0.5, seed=seed, rate=rate)
            out, stats = ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw)
            got = ra.rel_attention_bwd(q, k, v, ek, ev, lens, g, out, stats,
                                       **kw)
            again = ra.rel_attention_bwd(q, k, v, ek, ev, lens, g, out,
                                         stats, **kw)
            ref = ra.rel_attention_bwd_plain(q, k, v, ek, ev, lens, g, **kw)
            torch.cuda.synchronize()
            names = ("dq", "dk", "dv", "d_emb_rel_k", "d_emb_rel_v")
            errs = {name: float((a - r).abs().max())
                    for name, a, r in zip(names, got, ref)}
            for name, a, b in zip(names, got, again):
                check(bool(torch.isfinite(a).all()),
                      f"K3 {label} rate {rate}: {name} non-finite")
                check(errs[name] <= TOL_KERNEL, f"K3 {label} rate {rate}: "
                      f"{name} max abs err {errs[name]} > {TOL_KERNEL}")
                check(torch.equal(a, b), f"K3 {label} rate {rate}: {name} "
                      f"differs between two runs on the same inputs")
            times = timings(
                torch, lambda: ra.rel_attention_bwd(q, k, v, ek, ev, lens, g,
                                                    out, stats, **kw),
                lambda: ra.rel_attention_bwd_plain(q, k, v, ek, ev, lens, g,
                                                   **kw))
            flops, nbytes = k3_work(lengths, t, c, heads, window)
            row = {"shape": f"[4, {t}, {c}] {label}", "dropout": rate,
                   "max_abs_err": max(errs.values()), "errs": errs,
                   "bit_identical_rerun": True, **times,
                   **bounds(flops, nbytes),
                   "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
            phase("k3_rel_attention_bwd", **row)
            rows.append(row)
    return rows


def stack_inputs(torch, gen, dev, lengths, t, c, n_layers, k):
    def u(*shape, bound):
        return (torch.rand(*shape, generator=gen) * 2 - 1).mul(bound).to(dev)

    b = len(lengths)
    mask = ragged_mask(torch, lengths, t, dev)
    x = torch.randn(b, t, c, generator=gen).to(dev) * mask
    w_in = u(n_layers, k, c, 2 * c, bound=(k * c) ** -0.5)
    b_in = u(n_layers, 2 * c, bound=(k * c) ** -0.5)
    w_rs = u(n_layers, c, 2 * c, bound=c ** -0.5)
    b_rs = u(n_layers, 2 * c, bound=c ** -0.5)
    g_bias = u(b, n_layers, 2 * c, bound=0.5)
    return x, w_in, b_in, w_rs, b_rs, g_bias, mask


def check_wavenet_stack(torch, ws, dev, n_layers, label, grads=False,
                        t=640, lengths=(640, 600, 517, 333)):
    """K2 against its plain version at x [len(lengths), t, 192] with
    ``n_layers`` layers; with ``grads``, also the gradients of
    ``wavenet_stack`` (K2 forward, recomputed plain backward) against plain
    autograd."""
    gen = torch.Generator(device="cpu").manual_seed(2 + n_layers)
    b, c, k = len(lengths), 192, 5
    lengths = list(lengths)
    args = stack_inputs(torch, gen, dev, lengths, t, c, n_layers, k)
    out = ws.wavenet_stack_fwd(*args)
    ref = ws.wavenet_stack_plain(*args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()), f"K2 {label}: non-finite")
    check(err <= TOL_KERNEL, f"K2 {label}: max abs err {err} > {TOL_KERNEL}")
    row = {"shape": f"x [{b}, {t}, {c}] L={n_layers} K={k}",
           "max_abs_err": err}
    if grads:
        gy = torch.randn(b, t, c, generator=gen).to(dev)
        grad_errs = {}
        diff = [a.clone().requires_grad_(True) for a in args[:6]]
        plain = [a.clone().requires_grad_(True) for a in args[:6]]
        got = torch.autograd.grad(ws.wavenet_stack(*diff, args[6]), diff, gy)
        want = torch.autograd.grad(ws.wavenet_stack_plain(*plain, args[6]),
                                   plain, gy)
        names = ("x", "w_in", "b_in", "w_rs", "b_rs", "g_bias")
        for name, a, r in zip(names, got, want):
            tol = TOL_KERNEL * max(1.0, float(r.abs().max()))
            grad_errs[name] = float((a - r).abs().max())
            check(grad_errs[name] <= tol, f"K2 {label} grad {name}: max abs "
                  f"err {grad_errs[name]} > {tol}")
        row["grad_errs"] = grad_errs
    times = timings(torch, lambda: ws.wavenet_stack_fwd(*args),
                    lambda: ws.wavenet_stack_plain(*args))
    flops, nbytes = k2_work(lengths, t, c, n_layers, k)
    row.update(**times, **bounds(flops, nbytes),
               gflop=flops / 1e9, mbytes=nbytes / 1e6)
    phase(f"k2_{label}", **row)
    return row


def training_batch(cfg, b, n_tokens, n_frames, seed):
    """A synthetic batch without ``spec``: the step computes the linear
    spectrogram from the waveform, as on the real path."""
    from visinger_tpu_torch.data.synthetic import synthetic_batch

    batch = synthetic_batch(b, n_tokens, n_frames, *VOCABS,
                            num_linear_bins=cfg.num_linear_bins,
                            hop_size=cfg.hop_size, seed=seed)
    batch.pop("spec")
    return batch


def training(torch, ra, ws, dev, profile: bool):
    """Full-width training steps on the card; returns the launch counts of
    the timed steps."""
    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.models.factory import build_models
    from visinger_tpu_torch.training.train_state import create_train_state
    from visinger_tpu_torch.training.train_step import make_train_step

    cfg = visinger_csd()
    model, disc = build_models(cfg, *VOCABS, device=dev, seed=0)
    state = create_train_state(model, disc, seed=0)
    train_step = make_train_step(cfg, model, disc, device=dev)
    b, t = cfg.max_sentences, 640
    batch = training_batch(cfg, b, 192, t, seed=0)
    before = {"g": [p.detach().clone() for p in model.parameters()],
              "d": [p.detach().clone() for p in disc.parameters()]}
    for _ in range(2):                                    # warm-up
        state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps, step_ms, metrics = 5, [], []
    ra.launches = ra.bwd_launches = ws.launches = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    counts = {"rel_attention_fwd": ra.launches,
              "rel_attention_bwd": ra.bwd_launches,
              "wavenet_stack_fwd": ws.launches}
    n_attn = (cfg.enc_layers + cfg.pitch_predictor_layers
              + cfg.frame_prior_layers + cfg.phoneme_predictor_layers)
    per_step = {"rel_attention_fwd": n_attn, "rel_attention_bwd": n_attn,
                "wavenet_stack_fwd": 1 + cfg.flow_n_flows}
    for name, n in per_step.items():
        check(counts[name] == n * steps,
              f"training: {name} {counts[name]} launches != {n} x {steps}")
    for m in metrics:
        for k, v in m.items():
            check(bool(torch.isfinite(v)), f"training: metric {k} = {v}")
    changed = {}
    for name, mod in (("g", model), ("d", disc)):
        moved = [bool((p.detach() != p0).any())
                 for p, p0 in zip(mod.parameters(), before[name])]
        changed[name] = sum(moved) / len(moved)
        check(changed[name] > 0.9, f"training: only {changed[name]} of the "
              f"{name} parameter tensors changed")
    med = sorted(step_ms)[steps // 2]
    phase("training", batch=b, frames=t, tokens=192, steps=steps,
          launches=counts,
          launches_per_step={k: v / steps for k, v in counts.items()},
          median_step_ms=med, step_ms=step_ms,
          mel_frames_per_s=b * t / (med / 1e3),
          peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
          params_changed=changed,
          last_metrics={k: float(v) for k, v in metrics[-1].items()})
    if profile:
        profile_run(torch, lambda: train_step(state, batch), "train_step")
    return counts


def train_card_vs_cpu(torch, dev):
    """One training step's losses and generator gradients, full width, B=1,
    T=160, dropout 0: the same weights, posterior noise and slice on the
    card and on the CPU."""
    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.models.factory import build_models
    from visinger_tpu_torch.training.train_state import create_train_state
    from visinger_tpu_torch.training.train_step import make_train_step

    cfg = visinger_csd().replace(p_dropout=0.0)
    t = 160
    batch = training_batch(cfg, 1, 48, t, seed=4)
    gen = torch.Generator().manual_seed(6)
    eps_q = torch.randn(1, t, cfg.hidden_size, generator=gen)
    ids = torch.tensor([57])
    got = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model, disc = build_models(cfg, *VOCABS, device=d, seed=0)
        names = [n for n, _ in model.named_parameters()]
        state = create_train_state(model, disc, seed=0)
        state.step = 1  # past the KL warm-up, so every loss is nonzero
        train_step = make_train_step(cfg, model, disc, device=d)
        total, losses, _ = train_step.generator_loss(
            state, batch, eps_q=eps_q.to(d), ids_slice=ids.to(d))
        params = list(model.parameters())
        grads = torch.autograd.grad(total, params, allow_unused=True)
        got[name] = ({k: float(v.detach()) for k, v in losses.items()},
                     [None if g is None else g.detach().cpu() for g in grads])
    (loss_c, grad_c), (loss_r, grad_r) = got["cuda"], got["cpu"]
    loss_err = {k: abs(loss_c[k] - loss_r[k]) / max(abs(loss_r[k]), 1e-12)
                for k in loss_r}
    gmax = max(float(r.abs().max()) for r in grad_r if r is not None)
    grad_err, zero_noise, failures = {}, {}, []
    for name, a, r in zip(names, grad_c, grad_r):
        if (a is None) != (r is None):
            failures.append(f"grad {name}: reached on one device only")
            continue
        if r is None:
            continue
        if not bool(torch.isfinite(a).all()):
            failures.append(f"grad {name}: non-finite on the card")
        if name.endswith(ZERO_GRAD):
            zero_noise[name] = max(float(a.abs().max()),
                                   float(r.abs().max())) / gmax
        else:
            peak = float(r.abs().max())
            grad_err[name] = (float((a - r).abs().max()) / peak
                              if peak > 0 else float(a.abs().max()))
    worst = sorted(grad_err, key=grad_err.get, reverse=True)[:5]
    phase("train_card_vs_cpu", frames=t, losses=loss_r,
          loss_rel_err=loss_err, max_loss_rel_err=max(loss_err.values()),
          max_grad_err_of_peak=grad_err[worst[0]],
          median_grad_err_of_peak=sorted(grad_err.values())[
              len(grad_err) // 2],
          grads_over_1e_3=sum(e > 1e-3 for e in grad_err.values()),
          grad_tensors=len(grad_err),
          worst_grads={n: grad_err[n] for n in worst},
          max_zero_grad_noise=max(zero_noise.values()), grad_peak=gmax,
          loss_tol=TOL_LOSS_REL, grad_tol=TOL_GRAD_REL,
          zero_grad_tol=TOL_ZERO_GRAD)
    failures += [f"loss {k}: rel err {e} > {TOL_LOSS_REL}"
                 for k, e in loss_err.items() if e > TOL_LOSS_REL]
    failures += [f"grad {n}: max abs err {e} of its peak > {TOL_GRAD_REL}"
                 for n, e in grad_err.items() if e > TOL_GRAD_REL]
    failures += [f"grad {n}: {e} of the largest gradient > {TOL_ZERO_GRAD}"
                 for n, e in zero_noise.items() if e > TOL_ZERO_GRAD]
    check(not failures, "card vs CPU training: " + "; ".join(failures[:5]))


def requests_from(batch, n):
    return [{k: batch[k][i:i + 1, :batch[lk][i]]
             for k, lk in (("text_tokens", "text_lengths"),
                           ("note_pitch", "text_lengths"),
                           ("note_dur", "text_lengths"),
                           ("mel2ph", "mel_lengths"))}
            for i in range(n)]


def flow_model(torch, cfg, *vocabs):
    """The generator from seed 0 on the CPU, its flow's ``post`` weights
    (zero at init) set nonzero so the flow is not the identity."""
    from visinger_tpu_torch.models.factory import build_model

    model = build_model(cfg, *vocabs, device="cpu", seed=0)
    gen = torch.Generator(device="cpu").manual_seed(3)
    with torch.no_grad():
        for i in range(cfg.flow_n_flows):
            post = getattr(model.flow, f"coupling_{i}").post
            post.weight.copy_(torch.randn(post.weight.shape, generator=gen)
                              * 0.02)
    return model


def synthesis(torch, ra, ws, dev, profile: bool):
    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.data.synthetic import synthetic_batch
    from visinger_tpu_torch.infer.infer import TorchSynthesizer

    cfg = visinger_csd()
    model_cpu = flow_model(torch, cfg, *VOCABS)
    synth = TorchSynthesizer(cfg, copy.deepcopy(model_cpu), device=dev)
    batch = synthetic_batch(8, 192, 640, *VOCABS, hop_size=cfg.hop_size,
                            seed=0)
    requests = requests_from(batch, 8)
    synth.synthesize_batch(requests, seed=0)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    passes = 2
    ra.launches = ws.launches = 0
    results = [synth.synthesize_batch(requests, seed=0) for _ in range(passes)]
    counts = {"rel_attention_fwd": ra.launches,
              "wavenet_stack_fwd": ws.launches}
    groups = passes * len(results[0].group_seconds)
    # one K1 launch per attention layer (6 + 6 + 4 at full width), one K2
    # launch per flow coupling (4)
    per_group = {"rel_attention_fwd": cfg.enc_layers
                 + cfg.pitch_predictor_layers + cfg.frame_prior_layers,
                 "wavenet_stack_fwd": cfg.flow_n_flows}
    for name, n in per_group.items():
        check(counts[name] == n * groups,
              f"{name}: {counts[name]} launches != {n} x {groups} groups")
    for res in results:
        check(len(res.wavs) == 8, "expected 8 wavs")
        for wav, t_valid in zip(res.wavs, batch["mel_lengths"]):
            check(wav.shape == (t_valid * cfg.hop_size,),
                  f"wav shape {wav.shape} for {t_valid} frames")
            check(bool(abs(wav).max() <= 1.0) and float(abs(wav).max()) > 0,
                  "wav out of range or silent")
    group_ms = sorted(s * 1e3 for r in results for s in r.group_seconds)
    audio_s = float(batch["mel_lengths"].sum()) * cfg.hop_size \
        / cfg.sample_rate
    wall_s = sum(sum(r.group_seconds) for r in results) / passes
    phase("synthesis", requests=8, group_size=cfg.max_sentences,
          groups=groups, launches=counts,
          launches_per_group={k: v / groups for k, v in counts.items()},
          median_group_ms=group_ms[len(group_ms) // 2], group_ms=group_ms,
          audio_s_per_s=audio_s / wall_s, rtf=wall_s / audio_s,
          peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)

    if profile:
        from visinger_tpu_torch.infer.infer import collate

        group, _ = collate(requests[:4])
        profile_run(torch, lambda: synth.synthesize(group), "synthesis")

    # one short request on the card and on the CPU: same weights, same eps
    short = synthetic_batch(1, 48, 160, *VOCABS, hop_size=cfg.hop_size,
                            seed=4)
    keys = ("text_tokens", "note_pitch", "note_dur", "mel2ph", "spk_ids")
    eps = torch.randn(1, 160, cfg.hidden_size,
                      generator=torch.Generator().manual_seed(5))
    wavs = {}
    for name, model, d in (("cuda", synth.model, dev),
                           ("cpu", model_cpu, torch.device("cpu"))):
        t = {k: torch.from_numpy(short[k]).long().to(d) for k in keys}
        with torch.no_grad():
            z_p, mask = model.infer_prior(
                t["text_tokens"], t["note_pitch"], t["note_dur"], t["mel2ph"],
                spk_id=t["spk_ids"], eps=eps.to(d))
            wavs[name] = model.decode_frames(z_p, mask,
                                             spk_id=t["spk_ids"]).cpu()
    err = float((wavs["cuda"] - wavs["cpu"]).abs().max())
    peak = float(wavs["cpu"].abs().max())
    tol = TOL_CPU_REL * peak
    check(bool(torch.isfinite(wavs["cuda"]).all()), "short request non-finite")
    check(peak > 0, "short request silent")
    check(err <= tol, f"card vs CPU wav max abs err {err} > {tol}")
    phase("card_vs_cpu", shape=list(wavs["cuda"].shape), max_abs_err=err,
          tol=tol, wav_abs_max=peak)
    return counts


# the lyrics of the MIDI scores: Hangul syllables with and without a coda
SYLLABLES = list("나무소리가장하늘바다꽃잎국밥별빛노래")
# the jamo a Hangul syllable decomposes into: the phone set of the scores
JAMO = ([chr(c) for c in range(0x1100, 0x1113)]
        + [chr(c) for c in range(0x1161, 0x1176)]
        + [chr(c) for c in range(0x11A8, 0x11C3)])
# seconds of music per score: 6 served together, a long one that splits into
# phrases, a short one held against the CPU
SCORE_SECONDS = (5.0, 6.0, 7.0, 8.0, 7.6, 5.5)
LONG_SECONDS = 24.0
SHORT_SECONDS = 2.0


def write_scores(data_dir: Path, cfg, seed: int) -> dict:
    """MIDI files with Hangul lyrics (pitches, durations and rests drawn from
    ``seed``; 120 bpm, 480 ticks a beat) and the phone set, pitch map and
    duration map of a binarized data dir.  -> {"batch": [6 paths], "long":
    path, "short": path}."""
    import numpy as np

    from visinger_tpu_torch.data.binarizer import (build_dur_map,
                                                   build_pitch_map)
    from visinger_tpu_torch.utils.midi import Note, write_midi
    from visinger_tpu_torch.utils.text.token_encoder import TokenTextEncoder

    TokenTextEncoder(JAMO + ["<BOS>"]).store_to_file(
        str(data_dir / "phone_set.json"))
    for name, m in (("pitch_map", build_pitch_map(cfg.note_range)),
                    ("dur_map", build_dur_map())):
        (data_dir / f"{name}.json").write_text(json.dumps(m))
    rng = np.random.RandomState(seed)

    def score(name, seconds):
        notes, lyrics, tick = [], [], 0
        end = int(seconds * 960)                 # 960 ticks a second
        while tick < end:
            if notes and rng.rand() < 0.1:       # a rest of a beat
                tick += 480
            dur = min(int(rng.choice([240, 360, 480, 720])), end - tick)
            if dur < 240:
                break
            notes.append(Note(tick, tick + dur, int(rng.randint(55, 76)), 80))
            lyrics.append((tick, str(rng.choice(SYLLABLES))))
            tick += dur
        path = str(data_dir / f"{name}.mid")
        write_midi(path, notes, ticks_per_beat=480, lyrics=lyrics)
        return path

    return {"batch": [score(f"song{i}", s)
                      for i, s in enumerate(SCORE_SECONDS)],
            "long": score("long", LONG_SECONDS),
            "short": score("short", SHORT_SECONDS)}


def midi_infer(torch, ra, ws, dev, data_dir: Path, profile: bool):
    """MIDI files -> waveforms through ``VISingerInfer`` at full width:
    6 scores served in bucket groups, a 24 s score split into phrases, pitch
    control, streaming decode, and a short score on the card and the CPU.
    Returns the launch counts of the timed ``synthesize_batch`` passes and
    the streaming window's frames."""
    import numpy as np

    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.infer.infer import VISingerInfer

    cfg = visinger_csd()
    fns = write_scores(data_dir, cfg, seed=0)
    vocabs = [len(json.loads((data_dir / f"{name}.json").read_text()))
              for name in ("phone_set", "pitch_map", "dur_map")]
    inf = VISingerInfer(cfg, flow_model(torch, cfg, *vocabs), data_dir,
                        device=dev)
    per = {"rel_attention_fwd": cfg.enc_layers + cfg.pitch_predictor_layers
           + cfg.frame_prior_layers, "wavenet_stack_fwd": cfg.flow_n_flows}

    def counts():
        return {"rel_attention_fwd": ra.launches,
                "wavenet_stack_fwd": ws.launches}

    frames = [len(inf.preprocess_input(fn)["mel2ph"]) for fn in fns["batch"]]
    inf.synthesize_batch(fns["batch"], seed=0)           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    passes, group_s, wall = 2, [], 0.0
    ra.launches = ws.launches = 0
    for _ in range(passes):
        t0 = time.perf_counter()
        records = inf.synthesize_batch(fns["batch"], seed=0)
        wall += time.perf_counter() - t0
        group_s += inf.last_group_seconds
    batch_counts = counts()
    groups = len(group_s)
    for name, n in per.items():
        check(batch_counts[name] == n * groups, f"midi_infer: {name} "
              f"{batch_counts[name]} launches != {n} x {groups} groups")
    for rec, t_valid in zip(records, frames):
        wav = rec["wav"]
        check(rec["rtf_kind"] == "batch_mean", f"midi_infer: {rec['fn']} "
              f"served alone")
        check(wav.shape == (t_valid * cfg.hop_size,),
              f"midi_infer: wav shape {wav.shape} for {t_valid} frames")
        check(bool(np.isfinite(wav).all()), "midi_infer: non-finite wav")
        peak = float(np.abs(wav).max())
        check(0 < peak <= 1.0, f"midi_infer: wav peak {peak}")
    audio_s = sum(frames) * cfg.hop_size / cfg.sample_rate
    synth_s = sum(group_s) / passes
    group_ms = sorted(s * 1e3 for s in group_s)
    phase("midi_infer", scores=len(fns["batch"]), frames=frames,
          groups=groups // passes, launches=batch_counts,
          launches_per_group={k: v / groups for k, v in batch_counts.items()},
          median_group_ms=group_ms[len(group_ms) // 2], group_ms=group_ms,
          audio_s_per_s=audio_s / synth_s, rtf=synth_s / audio_s,
          wall_s_per_pass=wall / passes,
          peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)

    # a 24 s score: phrases, each one prior and one decode
    rows = inf.score_rows(fns["long"])
    n_phrases = len(inf._phrases(rows))
    check(n_phrases >= 2, f"midi_infer: the long score gave {n_phrases} "
          "phrase")
    inf.synthesize(fns["long"], seed=0)                  # warm-up
    ra.launches = ws.launches = 0
    wav, rtf = inf.synthesize(fns["long"], seed=0)
    long_counts = counts()
    for name, n in per.items():
        check(long_counts[name] == n * n_phrases, f"midi_infer long: {name} "
              f"{long_counts[name]} launches != {n} x {n_phrases} phrases")
    up_rows = inf.score_rows(fns["long"], pitch_control=4)
    check(all(u[2] == r[2] + 4 for u, r in zip(up_rows, rows) if r[2] > 0)
          and all(u[2] == 0 for u, r in zip(up_rows, rows) if r[2] == 0),
          "midi_infer: pitch_control=4 did not move the voiced rows by 4")
    wav_up, _ = inf.synthesize(fns["long"], pitch_control=4, seed=0)
    check(wav_up.shape == wav.shape and bool(np.isfinite(wav_up).all()),
          "midi_infer: pitch_control changed the length or is non-finite")
    moved = float(np.abs(wav_up - wav).max())
    check(moved > 1e-3 * float(np.abs(wav).max()),
          f"midi_infer: pitch_control=4 moved the audio by only {moved}")
    phase("midi_infer_long", seconds=len(wav) / cfg.sample_rate,
          phrases=n_phrases, launches=long_counts, rtf=rtf,
          audio_s_per_s=1 / rtf, pitch_control_4_max_change=moved)

    # streaming: the same weights, decode window by window
    stream = VISingerInfer(cfg.replace(stream_infer=True), inf.model,
                           data_dir, device=dev)
    streamer = stream._streamer
    fn = fns["batch"][frames.index(max(frames))]
    batch, t_valid = inf._pad_to_bucket(inf.preprocess_input(fn))
    t_pad = batch["mel2ph"].shape[1]
    check(t_valid >= 600, f"midi_infer: longest score {t_valid} frames")
    b = {k: torch.from_numpy(v).long().to(dev) for k, v in batch.items()}
    with torch.no_grad():
        z_p, mask = inf.model.infer_prior(
            b["text_tokens"], b["note_pitch"], b["note_dur"], b["mel2ph"],
            spk_id=b["spk_ids"], eps=inf.prior_noise(t_pad, 0).to(dev))
        full = inf.model.decode_frames(z_p, mask, spk_id=b["spk_ids"])
        ra.launches = ws.launches = 0
        streamed = streamer.decode(z_p, mask, spk_id=b["spk_ids"])
        torch.cuda.synchronize()
    windows = streamer.n_windows(t_pad)
    check(ws.launches == cfg.flow_n_flows * windows,
          f"midi_infer stream: {ws.launches} K2 launches != "
          f"{cfg.flow_n_flows} x {windows} windows")
    peak = float(full.abs().max())
    err = float((streamed - full).abs().max())
    check(peak > 0 and err <= TOL_CPU_REL * peak, f"midi_infer stream: "
          f"max abs err {err} against the full decode > {TOL_CPU_REL} x "
          f"{peak}")
    stream.synthesize(fn, seed=0)                        # warm-up
    _, stream_rtf = stream.synthesize(fn, seed=0)
    if profile:
        profile_run(torch, lambda: inf.synthesize(fn, seed=0), "midi_score")
        profile_run(torch, lambda: stream.synthesize(fn, seed=0),
                    "midi_stream")
    phase("midi_infer_stream", frames=t_valid, padded_frames=t_pad,
          chunk=streamer.chunk, halo=streamer.halo, window=streamer.window,
          windows=windows, k2_launches=windows * cfg.flow_n_flows,
          max_abs_err=err, tol=TOL_CPU_REL * peak, rtf=stream_rtf,
          audio_s_per_s=1 / stream_rtf)

    # one short score on the card and on the CPU: the same weights and eps
    cpu = VISingerInfer(cfg, copy.deepcopy(inf.model).cpu(), data_dir,
                        device="cpu")
    got, _ = inf.synthesize(fns["short"], seed=0)
    want, _ = cpu.synthesize(fns["short"], seed=0)
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    check(got.shape == want.shape and bool(np.isfinite(got).all()),
          "midi_infer card vs CPU: shape or non-finite")
    check(peak > 0 and err <= TOL_CPU_REL * peak, f"midi_infer card vs CPU: "
          f"max abs err {err} > {TOL_CPU_REL} x {peak}")
    phase("midi_card_vs_cpu", samples=len(got), max_abs_err=err,
          tol=TOL_CPU_REL * peak, wav_abs_max=peak)
    return batch_counts, streamer.window


def profile_run(torch, fn, tag: str):
    """Device time by kernel and the device idle share of one ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device busy time: the union of the kernels' intervals on the timeline
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{tag}.txt").write_text(
        f"wall_ms {wall * 1e3}\ndevice_busy_ms {busy_us / 1e3}\n"
        f"kernels {len(spans)}\n\n{table}\n")
    phase(f"profile_{tag}", wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
          device_kernels=len(spans),
          idle_share=1 - busy_us / 1e3 / (wall * 1e3),
          table=f"chiprun_out/profile_{tag}.txt")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "visinger_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.infer.streaming import halo_frames
    from visinger_tpu_torch.ops import cuda_build
    from visinger_tpu_torch.ops import rel_attention as ra
    from visinger_tpu_torch.ops import wavenet_stack as ws

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "entry function" in ln or "registers" in ln
                    or "spill" in ln]
             for name, log in logs.items()}
    phase("build", seconds=build_s, ptxas=ptxas)
    # at the model's shapes: dk = 96, window 4; C = 192, K = 5
    phase("kernel_resources",
          rel_attention=cuda_build.kernel_info("rel_attention", 96, 4),
          wavenet_stack=cuda_build.kernel_info("wavenet_stack", 192, 5))

    k1_rows = check_rel_attention(torch, ra, dev)
    k1_drop = check_k1_dropout(torch, ra, dev)
    k3_rows = check_rel_attention_bwd(torch, ra, dev)
    k2_row = check_wavenet_stack(torch, ws, dev, 4, "wavenet_stack")
    k2_post = check_wavenet_stack(torch, ws, dev, 16, "posterior",
                                  grads=True)
    # the streaming decode's window (chunk + 2 halo frames), the last window
    # of a score ragged
    window = visinger_csd().stream_chunk_frames + 2 * halo_frames(
        visinger_csd())
    k2_window = check_wavenet_stack(torch, ws, dev, 4, "stream_window",
                                    t=window, lengths=(window - 30,))
    train_counts = training(torch, ra, ws, dev, args.profile)
    train_card_vs_cpu(torch, dev)
    synth_counts = synthesis(torch, ra, ws, dev, args.profile)
    scores_dir = ROOT / "build" / "midi_scores"
    scores_dir.mkdir(parents=True, exist_ok=True)
    midi_counts, stream_window = midi_infer(torch, ra, ws, dev, scores_dir,
                                            args.profile)
    check(stream_window == window, f"streaming window {stream_window} != "
          f"the checked K2 shape's {window}")

    k1 = k1_rows[0]  # the frame-rate shape: 12 of the 18 layers per step
    k1_token = k1_rows[1]
    k1_phrase = next(r for r in k1_rows if r["shape"].endswith("phrase"))
    k3 = next(r for r in k3_rows if r["shape"].endswith("frame")
              and r["dropout"] > 0)
    kernels = [
        {"name": "rel_attention_fwd", "route": "cuda",
         "source": "visinger_tpu_torch/csrc/rel_attention.cu",
         "replaces": "visinger_tpu/ops/pallas/attention_kernel.py:291",
         "launches": train_counts["rel_attention_fwd"],
         "max_abs_err": max([r["max_abs_err"] for r in k1_rows]
                            + [k1_drop["max_abs_err"]]),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "call_ms": k1["call_ms"], "plain_call_ms": k1["plain_call_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "bound_tc_ms": k1["bound_tc_ms"],
         "library_ms": None, "sdpa_partial_ms": k1["sdpa_partial_ms"],
         "shape": k1["shape"],
         "stats_err": max([r["stats_err"] for r in k1_rows]
                          + [k1_drop["stats_err"]]),
         "token_ms": k1_token["ms"], "token_plain_ms": k1_token["plain_ms"],
         "token_bound_tc_ms": k1_token["bound_tc_ms"],
         "synthesis_launches": synth_counts["rel_attention_fwd"],
         "midi_launches": midi_counts["rel_attention_fwd"],
         "midi_phrase_shape": k1_phrase["shape"],
         "midi_phrase_ms": k1_phrase["ms"],
         "midi_phrase_plain_ms": k1_phrase["plain_ms"],
         "midi_phrase_bound_ms": k1_phrase["bound_ms"],
         "midi_phrase_bound_tc_ms": k1_phrase["bound_tc_ms"]},
        {"name": "rel_attention_bwd", "route": "cuda",
         "source": "visinger_tpu_torch/csrc/rel_attention.cu",
         "replaces": "visinger_tpu/ops/pallas/attention_kernel.py:250",
         "launches": train_counts["rel_attention_bwd"],
         "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "call_ms": k3["call_ms"], "plain_call_ms": k3["plain_call_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "bound_tc_ms": k3["bound_tc_ms"],
         "library_ms": None, "shape": f"{k3['shape']}, dropout 0.1",
         "bit_identical_rerun": True},
        {"name": "wavenet_stack_fwd", "route": "cuda",
         "source": "visinger_tpu_torch/csrc/wavenet_stack.cu",
         "replaces": "visinger_tpu/ops/pallas/wavenet_kernel.py:115",
         "launches": train_counts["wavenet_stack_fwd"],
         "max_abs_err": max(k2_row["max_abs_err"], k2_post["max_abs_err"],
                            k2_window["max_abs_err"]),
         "ms": k2_post["ms"], "plain_ms": k2_post["plain_ms"],
         "call_ms": k2_post["call_ms"],
         "plain_call_ms": k2_post["plain_call_ms"],
         "bound_ms": k2_post["bound_ms"], "bound_by": k2_post["bound_by"],
         "bound_tc_ms": k2_post["bound_tc_ms"],
         "library_ms": None, "shape": k2_post["shape"],
         "l4_ms": k2_row["ms"], "l4_plain_ms": k2_row["plain_ms"],
         "l4_bound_ms": k2_row["bound_ms"],
         "l4_bound_tc_ms": k2_row["bound_tc_ms"],
         "synthesis_launches": synth_counts["wavenet_stack_fwd"],
         "midi_launches": midi_counts["wavenet_stack_fwd"],
         "window_shape": k2_window["shape"], "window_ms": k2_window["ms"],
         "window_plain_ms": k2_window["plain_ms"],
         "window_bound_ms": k2_window["bound_ms"],
         "window_bound_tc_ms": k2_window["bound_tc_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
