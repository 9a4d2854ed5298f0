#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of VISinger on one CUDA card: the GAN
training step (the main path), synthesis, MIDI-to-waveform serving, the
trainer, the command line's whole drive from a synthetic corpus to a
tested voice, the serving export, the scale-out (data-parallel
training and time-sharded synthesis over ranks of ``torch.distributed``),
and the widths the kernels take padded, from a YAML experiment file.

    python3 chip_smoke.py              # the check (one card)
    python3 chip_smoke.py --profile    # also write torch.profiler summaries
                                       # of one training step (float32 and
                                       # bf16), one synthesis group and one
                                       # MIDI score (full and streamed)
                                       # under chiprun_out/

Phases, each printing a line; any failure raises and exits nonzero:
  1. the card's name and power limit (nvidia-smi); TF32 off for matmuls and
     convolutions (every comparison below is float32);
  2. build the CUDA kernels from ``visinger_tpu_torch/csrc`` (one nvcc per
     source, in parallel); print each kernel's registers and spills
     (``-Xptxas -v``; per kernel for the bf16 builds) and its dynamic
     shared memory and resident blocks per SM at the model's shapes;
  3. K1 (relative attention) against its plain version, out and each
     row's softmax max and sum (which K3 reads), at the frame-rate shape
     [4, 640, 192], the token-rate shape [4, 192, 192], a ragged
     [4, 637, 192] (lengths 637, 600, 64, 1), head widths 64 and 128
     (K1's generic build), the longest MIDI phrase [1, 1280, 192]
     (length 1237) and a data-parallel rank's rows [2, 640, 192], 2
     heads; beside its times,
     ``scaled_dot_product_attention`` on the same q, k, v with the band
     bias and mask as an additive float mask (``sdpa_partial_ms``, a
     yardstick: it lacks the band-column term); then with dropout 0.1
     against the plain version with the same seed, its keep rate and a
     second seed's different mask;
  4. K3 (attention backward) against autograd of the plain version at the
     frame, token and data-parallel rank's shapes, dropout off and 0.1,
     with a random g; a second run on the same
     inputs must give bit-identical gradients (beside it
     ``scaled_dot_product_attention`` forward and backward as a yardstick);
     then the bf16 builds of K1 and K3 (phases ``k1_bf16``, ``k3_bf16``)
     against the plain versions on the same bf16 q, k, v at every
     ``BF16_CASES`` shape ([4, 640, 192], [4, 192, 192], a ragged
     [4, 637, 192], head widths 64 and 128, the MIDI phrase
     [1, 1280, 192]) and, for K1, ``BF16_LONG`` ([2, 2600, 192], its
     global-scratch build), dropout off and 0.1: bf16 results within one
     bf16 ulp of their peak, K1's row max and sum within 1e-5, the float32
     emb gradients within 1e-3 of their peak, K3 bit-identical on a rerun;
     their times beside the float32 builds' and
     ``scaled_dot_product_attention`` in bf16 (K3: forward and backward);
     bounds at the bf16 dense tensor-core rate;
  5. K2 (WaveNet stack) at the flow shape x [4, 640, 192], L=4, at the
     posterior shape, L=16, where the gradients of its autograd function are
     also held against plain autograd, at the streaming window
     [1, 366, 192], L=4 (length 336), and at a rank's window of
     time-sharded synthesis [1, 695, 192], L=4 (length 652);
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
  9. the trainer (phase ``trainer``): a binarized corpus written from seed
     0 (24 train and 8 valid items of 150-192 tokens and 560-640 frames,
     batches of 4 in the 640-frame bucket) and ``Trainer.fit`` at full
     width: 8 steps on the device-store route (launches counted against
     the steps and eval batches), a new trainer resuming to 10, 8 logged
     steps on each data route (ms per step beside the bare ``training``
     phase), the lines that synchronise with the card in 3 steps, the
     step-8 checkpoint validated on the card and on the CPU (within 1e-4
     relative), the checkpoint files, ``best.json`` and the logs, and the
     costs of an eval batch, a checkpoint save (sync, async) and restore,
     and the device store's upload;
 10. the pipeline (phase ``pipeline``): the ``tpu_run`` recipe at full
     width through ``visinger_tpu_torch.run.main`` under
     ``build/pipeline/``: ``synth-data`` (28 songs of 6-10 notes),
     ``binarize`` (its route, seconds per item, 4 test, 4 valid and 20
     train records), ``train`` for 4 steps with a render of 2 valid items
     at step 4 and ``test_after_train``, and ``test`` from the step-4
     checkpoint in batches of 4 and of 1; every synthesized waveform and
     wav file checked (frames x hop long, finite, within +-1, not silent),
     ``results.json`` (4 items, finite MCD, mel-L1 and V/UV error, the RTF
     kind of each mode), the launches of the train command and of each
     render/test group (K1 16, K2 4, no K3), and the first test item from
     the checkpoint on the card and on the CPU with the same noise (within
     1e-4 of its peak); binarize seconds, render ms per item, test RTF in
     both modes, audio-s/s and peak memory are printed;
 11. the ``soak_r5`` recipe, bf16 compute (phase ``bf16``): a synthesis
     group of 4 beside the float32 model's, 5 full-width bf16 training
     steps in turns with 5 float32 steps after 2 warm-ups each (launches
     per bf16 step K1-bf16 18, K3-bf16 18, K2 5; under ``--profile`` the
     step's device time and K1-bf16's and K3-bf16's share), each kind's
     peak memory, a
     step with the ``phoneme`` island (its layers in float32: K1 and K3 2
     a step), one step's losses on the card and on the CPU (within
     TOL_BF16_LOSS_REL), and ``run synth-data``, ``binarize`` (with voice
     embeddings), ``train`` 2 steps, resumed to 4, and ``test`` under
     ``build/bf16/``;
 12. the training switches (phase ``train_variants``, full width, float32):
     spectral norm, accumulation over 2, remat full and dots, voice
     embeddings, 2 steps each on the card and on the CPU from the same
     weights and draws (within TOL_VARIANT_REL), remat's gradients against
     none's with dropout on, and the peak memory and step time of each
     remat policy at B=4, T=640;
 13. the serving export (phase ``export``): ``run export --device cuda``
     of a checkpoint of seeded ``visinger_csd`` weights into a float32
     artifact of buckets 96x320 and 192x640 and, with the ``soak_r5``
     recipe (bf16), of bucket 192x640; a subprocess that cannot import
     jax, flax, visinger_tpu or the port's models, modules, config,
     training, data and ``infer.infer`` loads them and serves 3 and 2
     scores (K1 16 and K2 4 launches a float32 call, K1-bf16 16 and K2 4
     a bf16 call), each waveform within 1e-4 of its peak of the live path
     on the card; export seconds per bucket, load seconds, bytes, and ms
     per call and audio-s/s in turns with the live path;
 14. the scale-out (phase ``scale_out``, full width, float32): the
     training phase's step (B=4, T=640, dropout 0, given draws) under an
     NCCL group of world size 1 against the bare step; 2 gloo ranks on the
     card (spawned after the build), 2 rows each: losses, metrics and
     ``gnorm_g`` within TOL_SO_REL of the 1-process step, gradients summed
     over the ranks within TOL_GRAD_REL of their peaks, the parameters the
     same bits on both ranks (launches per rank and step K1 18, K3 18,
     K2 5); ``Trainer.fit`` on both ranks, 4 steps and resumed to 6, one
     checkpoint set written by rank 0; ``VISingerInfer`` with ``sp_infer``
     on a 1280-frame score and the 24 s score within TOL_CPU_REL of their
     peaks of the single-device waveform (per rank and phrase K1 16, K2
     4), and the loop over both ranks' pieces in one process; ms of both
     kinds (not a claim: the ranks share one card);
     ``__graft_entry_torch__.entry()`` and ``dryrun_multichip(1)`` on NCCL;
 15. the widths (phase ``widths``): K1, K3 and their bf16 builds at head
     widths 90, 50 and 8 ([4, 640, 180] and [4, 640, 16] with 2 heads,
     [4, 640, 200] with 4), dropout off and 0.1, K3 the same bits on a
     rerun, and K2 at C 180 (L=16, with its autograd gradients) and C 16
     (L=4) against their plain versions, within the limits above, with
     device, call and plain ms and the bounds; the padding kernel
     (``csrc/pad_pack.cu``) bit for bit against plain zero padding on the
     jobs of K1, K3 and K2 at dk 90 / C 180; then a YAML experiment file
     written under ``build/widths/`` (``base_config`` the checkout's
     ``configs/tpu_run.yaml``, ``hidden_size: 180``, ``num_heads: 2``)
     driven through ``run.main``: ``synth-data``, ``binarize``, ``train``
     4 steps, ``infer`` on a MIDI score, ``train`` 2 steps in bf16 (K1,
     K3, K2 and the padding kernel launched, and K1-bf16 and K3-bf16 in
     the bf16 run); one training step of that config and one waveform
     from its step-4 checkpoint on the card and on the CPU; and
     ``tiny_config`` (dk 8, C 16) on the card, one step and one synthesis
     request against the CPU;
 16. a ``kernels`` JSON line (K1, K2, K3 and the bf16 builds of K1 and
     K3; K1, K2 and K1-bf16 with their launches in the export phase; K1,
     K3 and K2 with ``scale_out_launches``, per rank of a DP step and of an
     SP call; every kernel with its ``widths`` rows and launches; the
     padding kernel), then the final ``{"ok": true, ...}`` line.

It imports the port only (no JAX) and exits nonzero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import copy
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_PEAK = 67e12      # H100 SXM float32 FLOP/s outside the tensor cores
TC_F32_PEAK = 495e12 / 3  # 3xTF32 on the tensor cores: three TF32 passes
HBM_RATE = 3.35e12    # H100 SXM device-memory bytes/s
BF16_PEAK = 989e12    # H100 SXM bf16 dense tensor-core FLOP/s
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
# an FFN ReLU input that the card and the CPU round to opposite signs: both
# values within this share of the layer's largest input (float32 sums of
# K*C products on each device, after the same upstream layers)
TOL_FLIP = 1e-4
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
# K1/K3-bf16 against their plain versions: a bf16 result within one bf16
# ulp of the tensor's peak (2^-7 relative; the kernel and the plain version
# may round a value on either side of a tie), the float32 emb gradients
# within 1e-3 of their peaks
TOL_BF16_REL = 2.0 ** -7
TOL_BF16_EMB = 1e-3
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


def sdpa_operands(torch, ra, ek, lens, window, scale, *tensors):
    """[B, H, T, dk] heads of each [B, T, C] tensor, and the band bias and
    length mask of K1's scores (from the first tensor, q) as one additive
    float mask in q's dtype: the inputs of the ``scaled_dot_product_attention``
    yardsticks, which lack the band-column term (the port never calls it)."""
    b, t, c = tensors[0].shape
    dk = ek.shape[1]
    heads = [a.reshape(b, t, c // dk, dk).transpose(1, 2).contiguous()
             for a in tensors]
    idx = torch.arange(t, device=ek.device)
    off = idx[None, :] - idx[:, None]
    rel = (heads[0].float() @ ek.t()) * scale
    bias = torch.gather(rel, -1, (off + window).clamp(0, 2 * window).expand(
        b, c // dk, t, t)) * (off.abs() <= window)
    valid = idx[None, :] < lens[:, None].long()
    valid = valid[:, None, :, None] & valid[:, None, None, :]
    mask = (bias + torch.where(valid, 0.0, ra.MASK_VAL)).to(
        tensors[0].dtype).contiguous()
    return heads, mask


def sdpa_partial_ms(torch, ra, q, k, v, ek, lens, window, scale) -> float:
    """Device ms of ``scaled_dot_product_attention`` on K1's q, k, v with the
    band bias and the length mask as one additive float mask: a yardstick
    only, since it lacks the band-column term and adds -1e4 where K1 sets
    it (the port never calls it)."""
    heads, mask = sdpa_operands(torch, ra, ek, lens, window, scale, q, k, v)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return device_ms(torch, lambda: sdpa(*heads, attn_mask=mask,
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
            ("midi phrase", 1280, 192, [1237]),
            # a data-parallel rank's rows of the training batch (scale_out)
            ("dp rank", 640, 192, [640, 600])):
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


def attention_inputs(torch, gen, t, dev, c=192, heads=2, window=4, b=4):
    dk = c // heads
    q, k, v = (torch.randn(b, t, c, generator=gen).to(dev) for _ in range(3))
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
                              ("token", 192, [192, 180, 151, 97]),
                              ("dp rank", 640, [640, 600])):
        n_b = len(lengths)
        q, k, v, ek, ev = attention_inputs(torch, gen, t, dev, b=n_b)
        g = torch.randn(n_b, t, c, generator=gen).to(dev)
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
            row = {"shape": f"[{n_b}, {t}, {c}] {label}", "dropout": rate,
                   "max_abs_err": max(errs.values()), "errs": errs,
                   "bit_identical_rerun": True, **times,
                   **bounds(flops, nbytes),
                   "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
            if rate == 0.0:
                row["sdpa_partial_ms"] = sdpa_fwd_bwd_ms(
                    torch, ra, q, k, v, ek, g, lens, window, dk ** -0.5)
            phase("k3_rel_attention_bwd", **row)
            rows.append(row)
    return rows


def bf16_err(got, ref) -> float:
    """Largest error of a bf16 result against its plain version, as a share
    of the plain tensor's peak."""
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp(min=1e-30))


def bounds_bf16(flops: float, nbytes: float) -> dict:
    """The least time for ``flops`` at the bf16 dense tensor-core rate and
    ``nbytes`` at the memory rate, and what bounds it."""
    t_ops, t_bytes = flops / BF16_PEAK, nbytes / HBM_RATE
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# (label, T, C, lengths) with 2 heads: the frame, token and ragged shapes,
# head widths 64 and 128 (the generic build) and the longest MIDI phrase
BF16_CASES = (("frame", 640, 192, [640, 600, 517, 333]),
              ("token", 192, 192, [192, 180, 151, 97]),
              ("ragged", 637, 192, [637, 600, 64, 1]),
              ("dk 64", 640, 128, [640, 600, 517, 333]),
              ("dk 128", 100, 256, [100, 37]),
              ("midi phrase", 1280, 192, [1237]))
# K1-bf16 only: a T too long for its score buffer in shared memory (the
# build with the buffer in a global scratch)
BF16_LONG = ("long", 2600, 192, [2600, 1999])


def bf16_inputs(torch, gen, t, c, lengths, dev, heads=2, window=4):
    """bf16 q, k, v [len(lengths), t, c], float32 emb tables, int32 lengths."""
    dk = c // heads
    q, k, v = (torch.randn(len(lengths), t, c, generator=gen).to(dev)
               .bfloat16() for _ in range(3))
    ek, ev = (torch.randn(2 * window + 1, dk, generator=gen).mul(
        dk ** -0.5).to(dev) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, ek, ev, lens


def sdpa_fwd_bwd_ms(torch, ra, q, k, v, ek, g, lens, window, scale) -> float:
    """Device ms of ``scaled_dot_product_attention`` forward and backward on
    K3's q, k, v and g, in their dtype, with ``sdpa_operands``' mask: a
    yardstick only (no band-column term; the port never calls it)."""
    (qh, kh, vh, gh), mask = sdpa_operands(torch, ra, ek, lens, window,
                                           scale, q, k, v, g)
    ins = [a.detach().requires_grad_(True) for a in (qh, kh, vh)]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd_bwd():
        out = sdpa(*ins, attn_mask=mask, scale=scale)
        torch.autograd.grad(out, ins, gh)
    return device_ms(torch, fwd_bwd)


def check_k1_bf16(torch, ra, dev):
    """K1's bf16 build against the plain version on the same bf16 q, k, v
    (the plain version rounds P and the output where the TPU kernel does),
    at every ``BF16_CASES`` shape and ``BF16_LONG``, dropout off and 0.1;
    beside it (dropout off) the float32 K1 on the same values and
    ``scaled_dot_product_attention`` in bf16 (the yardstick without the
    band term)."""
    gen = torch.Generator(device="cpu").manual_seed(21)
    heads, window = 2, 4
    seed = torch.tensor([4242], dtype=torch.int32, device=dev)
    rows = []
    for label, t, c, lengths in (*BF16_CASES, BF16_LONG):
        dk = c // heads
        q, k, v, ek, ev, lens = bf16_inputs(torch, gen, t, c, lengths, dev)
        for rate in (0.0, 0.1):
            kw = dict(window=window, scale=dk ** -0.5, seed=seed, rate=rate)
            out, stats = ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw)
            ref, ref_stats = ra.rel_attention_plain(q, k, v, ek, ev, lens,
                                                    **kw, with_stats=True)
            torch.cuda.synchronize()
            check(out.dtype == torch.bfloat16, "K1-bf16: output not bf16")
            err, serr = bf16_err(out, ref), stats_err(stats, ref_stats)
            check(bool(torch.isfinite(out.float()).all()),
                  f"K1-bf16 {label} rate {rate}: non-finite")
            check(err <= TOL_BF16_REL, f"K1-bf16 {label} rate {rate}: err "
                  f"{err} of the peak > {TOL_BF16_REL}")
            check(serr <= TOL_STATS_REL, f"K1-bf16 {label} rate {rate}: "
                  f"stats err {serr} > {TOL_STATS_REL}")
            row = {"shape": f"[{len(lengths)}, {t}, {c}] {label}",
                   "lengths": lengths, "dropout": rate, "err_of_peak": err,
                   "stats_err": serr,
                   "max_abs_err": float((out.float() - ref.float()).abs()
                                        .max())}
            if rate == 0.0:
                q32, k32, v32 = (a.float() for a in (q, k, v))
                flops, nbytes32 = k1_work(lengths, t, c, heads, window)
                row.update(
                    **timings(torch,
                              lambda: ra.rel_attention_fwd(q, k, v, ek, ev,
                                                           lens, **kw),
                              lambda: ra.rel_attention_plain(
                                  q, k, v, ek, ev, lens, **kw)),
                    f32_ms=device_ms(torch, lambda: ra.rel_attention_fwd(
                        q32, k32, v32, ek, ev, lens, **kw)),
                    sdpa_bf16_ms=sdpa_partial_ms(torch, ra, q, k, v, ek,
                                                 lens, window, dk ** -0.5),
                    **bounds_bf16(flops, nbytes32 / 2),
                    gflop=flops / 1e9, mbytes=nbytes32 / 2e6)
            phase("k1_bf16", **row)
            rows.append(row)
    return rows


def check_k3_bf16(torch, ra, dev):
    """K3's bf16 build against the plain bf16 backward (autograd of the
    plain version, the rounding of P passing the gradient through) at every
    ``BF16_CASES`` shape, dropout off and 0.1, with a random bf16 g; dq,
    dk, dv (bf16) within TOL_BF16_REL of their peaks, the emb gradients
    (float32) within TOL_BF16_EMB; a second run gives the same bits; beside
    it (dropout off) the float32 K3 on the same values and
    ``scaled_dot_product_attention`` forward and backward in bf16."""
    gen = torch.Generator(device="cpu").manual_seed(23)
    heads, window = 2, 4
    seed = torch.tensor([2025], dtype=torch.int32, device=dev)
    names = ("dq", "dk", "dv", "d_emb_rel_k", "d_emb_rel_v")
    rows = []
    for label, t, c, lengths in BF16_CASES:
        dk = c // heads
        q, k, v, ek, ev, lens = bf16_inputs(torch, gen, t, c, lengths, dev)
        g = torch.randn(len(lengths), t, c, generator=gen).to(dev).bfloat16()
        for rate in (0.0, 0.1):
            kw = dict(window=window, scale=dk ** -0.5, seed=seed, rate=rate)
            out, stats = ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw)
            got = ra.rel_attention_bwd(q, k, v, ek, ev, lens, g, out, stats,
                                       **kw)
            again = ra.rel_attention_bwd(q, k, v, ek, ev, lens, g, out,
                                         stats, **kw)
            ref = ra.rel_attention_bwd_plain(q, k, v, ek, ev, lens, g, **kw)
            torch.cuda.synchronize()
            errs = {n: bf16_err(a, r) for n, a, r in zip(names, got, ref)}
            for i, (n, a, b) in enumerate(zip(names, got, again)):
                check(a.dtype == (torch.bfloat16 if i < 3 else torch.float32),
                      f"K3-bf16: {n} is {a.dtype}")
                check(bool(torch.isfinite(a.float()).all()),
                      f"K3-bf16 {label} rate {rate}: {n} non-finite")
                tol = TOL_BF16_REL if i < 3 else TOL_BF16_EMB
                check(errs[n] <= tol, f"K3-bf16 {label} rate {rate}: {n} "
                      f"err {errs[n]} of the peak > {tol}")
                check(torch.equal(a, b), f"K3-bf16 {label} rate {rate}: {n} "
                      f"differs between two runs on the same inputs")
            row = {"shape": f"[{len(lengths)}, {t}, {c}] {label}",
                   "lengths": lengths, "dropout": rate, "errs_of_peak": errs,
                   "bit_identical_rerun": True,
                   "max_abs_err": max(float((a.float() - r.float()).abs()
                                            .max())
                                      for a, r in zip(got, ref))}
            if rate == 0.0:
                q32, k32, v32, g32 = (a.float() for a in (q, k, v, g))
                o32, s32 = ra.rel_attention_fwd(q32, k32, v32, ek, ev, lens,
                                                **kw)
                flops, nbytes32 = k3_work(lengths, t, c, heads, window)
                row.update(
                    **timings(torch,
                              lambda: ra.rel_attention_bwd(
                                  q, k, v, ek, ev, lens, g, out, stats, **kw),
                              lambda: ra.rel_attention_bwd_plain(
                                  q, k, v, ek, ev, lens, g, **kw)),
                    f32_ms=device_ms(torch, lambda: ra.rel_attention_bwd(
                        q32, k32, v32, ek, ev, lens, g32, o32, s32, **kw)),
                    sdpa_partial_ms=sdpa_fwd_bwd_ms(
                        torch, ra, q, k, v, ek, g, lens, window, dk ** -0.5),
                    **bounds_bf16(flops, nbytes32 / 2),
                    gflop=flops / 1e9, mbytes=nbytes32 / 2e6)
            phase("k3_bf16", **row)
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
                        t=640, lengths=(640, 600, 517, 333), c=192):
    """K2 against its plain version at x [len(lengths), t, c] with
    ``n_layers`` layers; with ``grads``, also the gradients of
    ``wavenet_stack`` (K2 forward, recomputed plain backward) against plain
    autograd."""
    gen = torch.Generator(device="cpu").manual_seed(2 + n_layers)
    b, k = len(lengths), 5
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
    the timed steps and their median ms."""
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
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    phase("training", batch=b, frames=t, tokens=192, steps=steps,
          launches=counts,
          launches_per_step={k: v / steps for k, v in counts.items()},
          median_step_ms=med, step_ms=step_ms,
          mel_frames_per_s=b * t / (med / 1e3), peak_mem_gib=peak,
          params_changed=changed,
          last_metrics={k: float(v) for k, v in metrics[-1].items()})
    if profile:
        profile_run(torch, lambda: train_step(state, batch), "train_step")
    return counts, med, peak


def train_card_vs_cpu(torch, dev, cfg=None, tag="train_card_vs_cpu"):
    """One training step's losses and generator gradients, B=1, T=160,
    dropout 0: the same weights, posterior noise and slice on the card and
    on the CPU; at full width unless ``cfg`` is given.  Prints phase
    ``tag``; -> its row.

    A ReLU input within rounding of 0 can take the other branch on one
    device, which moves a row of the gradient of the conv before it (see
    TOL_GRAD_REL).  So the FFN ReLUs' branches are recorded on the card, and
    where the CPU's own step took another one the CPU step is run again on
    the card's branches; every such flip must lie within TOL_FLIP of its
    layer's peak on both devices (a wrong kernel moves inputs by O(1) and
    flips far more), and the gradients are held against that run.  The
    gradients against the CPU's own branches are printed beside them."""
    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.models.factory import build_models
    from visinger_tpu_torch.modules import transformer
    from visinger_tpu_torch.modules.common import dropout
    from visinger_tpu_torch.training.train_state import create_train_state
    from visinger_tpu_torch.training.train_step import make_train_step

    cfg = (cfg or visinger_csd()).replace(p_dropout=0.0)
    t = 160
    batch = training_batch(cfg, 1, 48, t, seed=4)
    gen = torch.Generator().manual_seed(6)
    eps_q = torch.randn(1, t, cfg.hidden_size, generator=gen)
    ids = torch.tensor([57])
    real_ffn = transformer.ConvFFN.forward

    def step(d, branches=None):
        """(losses, gradients, each FFN ReLU's input and mask) of one step
        on ``d``; with ``branches``, the ReLUs take those masks."""
        seen = []
        given = iter(branches) if branches is not None else None

        def ffn(self, x, x_mask, generator=None):
            h = self.conv_1(x * x_mask)
            seen.append((h.detach().cpu(), x_mask.detach().cpu() > 0))
            if given is None:
                x = torch.relu(h)
            else:
                x = h * next(given)[0].gt(0).to(h.device, h.dtype)
            x = dropout(x, self.p_dropout, generator)
            return self.conv_2(x * x_mask)

        transformer.ConvFFN.forward = ffn
        try:
            model, disc = build_models(cfg, *VOCABS, device=d, seed=0)
            state = create_train_state(model, disc, seed=0)
            state.step = 1  # past the KL warm-up, so every loss is nonzero
            train_step = make_train_step(cfg, model, disc, device=d)
            total, losses, _ = train_step.generator_loss(
                state, batch, eps_q=eps_q.to(d), ids_slice=ids.to(d))
            grads = torch.autograd.grad(total, list(model.parameters()),
                                        allow_unused=True)
        finally:
            transformer.ConvFFN.forward = real_ffn
        names = [n for n, _ in model.named_parameters()]
        return (names, {k: float(v.detach()) for k, v in losses.items()},
                [None if g is None else g.detach().cpu() for g in grads],
                seen)

    names, loss_c, grad_c, card_relu = step(dev)
    _, loss_r, grad_r, cpu_relu = step(torch.device("cpu"))
    flips = []
    for i, ((h_c, valid), (h_r, _)) in enumerate(zip(card_relu, cpu_relu)):
        diff = ((h_c > 0) != (h_r > 0)) & valid.expand_as(h_c)
        if diff.any():
            peak = float(h_r.abs().max())
            flips.append({"ffn_call": i, "flips": int(diff.sum()),
                          "max_abs_input_of_peak": max(
                              float(h_c[diff].abs().max()),
                              float(h_r[diff].abs().max())) / peak})
    own_branches = None
    if flips:
        own_branches = grad_errors(torch, names, grad_c, grad_r)[0]
        _, loss_r, grad_r, _ = step(torch.device("cpu"), card_relu)
    loss_err = {k: abs(loss_c[k] - loss_r[k]) / max(abs(loss_r[k]), 1e-12)
                for k in loss_r}
    grad_err, zero_noise, gmax, failures = grad_errors(torch, names, grad_c,
                                                       grad_r)
    worst = sorted(grad_err, key=grad_err.get, reverse=True)[:5]
    row = dict(frames=t, hidden_size=cfg.hidden_size,
               num_heads=cfg.num_heads, losses=loss_r,
               loss_rel_err=loss_err,
               max_loss_rel_err=max(loss_err.values()),
               max_grad_err_of_peak=grad_err[worst[0]],
               median_grad_err_of_peak=sorted(grad_err.values())[
                   len(grad_err) // 2],
               grads_over_1e_3=sum(e > 1e-3 for e in grad_err.values()),
               grad_tensors=len(grad_err),
               worst_grads={n: grad_err[n] for n in worst},
               max_zero_grad_noise=max(zero_noise.values()), grad_peak=gmax,
               loss_tol=TOL_LOSS_REL, grad_tol=TOL_GRAD_REL,
               zero_grad_tol=TOL_ZERO_GRAD, relu_flips=flips,
               flip_tol=TOL_FLIP)
    if own_branches is not None:
        own = sorted(own_branches, key=own_branches.get, reverse=True)[:5]
        row["own_branches_worst_grads"] = {n: own_branches[n] for n in own}
    phase(tag, **row)
    failures += [f"ReLU flip {f} beyond rounding of 0 (> {TOL_FLIP} of its "
                 f"layer's peak)" for f in flips
                 if f["max_abs_input_of_peak"] > TOL_FLIP]
    failures += [f"loss {k}: rel err {e} > {TOL_LOSS_REL}"
                 for k, e in loss_err.items() if e > TOL_LOSS_REL]
    check(not failures, f"card vs CPU training ({tag}): "
          + "; ".join(failures[:5]))
    return row


def grad_errors(torch, names, got, ref):
    """Each gradient tensor's max abs error against ``ref`` as a share of
    the reference's peak; the attention key bias's (``ZERO_GRAD``, zero in
    exact arithmetic) size as a share of the largest gradient.  -> (errors,
    zero-gradient noise, largest gradient, failures against TOL_GRAD_REL
    and TOL_ZERO_GRAD)."""
    gmax = max(float(r.abs().max()) for r in ref if r is not None)
    grad_err, zero_noise, failures = {}, {}, []
    for name, a, r in zip(names, got, ref):
        if (a is None) != (r is None):
            failures.append(f"grad {name}: reached on one side only")
            continue
        if r is None:
            continue
        if not bool(torch.isfinite(a).all()):
            failures.append(f"grad {name}: non-finite")
        if name.endswith(ZERO_GRAD):
            zero_noise[name] = max(float(a.abs().max()),
                                   float(r.abs().max())) / gmax
        else:
            peak = float(r.abs().max())
            grad_err[name] = (float((a - r).abs().max()) / peak
                              if peak > 0 else float(a.abs().max()))
    failures += [f"grad {n}: max abs err {e} of its peak > {TOL_GRAD_REL}"
                 for n, e in grad_err.items() if e > TOL_GRAD_REL]
    failures += [f"grad {n}: {e} of the largest gradient > {TOL_ZERO_GRAD}"
                 for n, e in zero_noise.items() if e > TOL_ZERO_GRAD]
    return grad_err, zero_noise, gmax, failures


def requests_from(batch, n):
    return [{k: batch[k][i:i + 1, :batch[lk][i]]
             for k, lk in (("text_tokens", "text_lengths"),
                           ("note_pitch", "text_lengths"),
                           ("note_dur", "text_lengths"),
                           ("mel2ph", "mel_lengths"))}
            for i in range(n)]


def flow_model(torch, cfg, *vocabs, model=None):
    """The generator from seed 0 on the CPU (or ``model``), its flow's
    ``post`` weights (zero at init) set nonzero so the flow is not the
    identity."""
    from visinger_tpu_torch.models.factory import build_model

    if model is None:
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

    wav_card_vs_cpu(torch, cfg, synth.model, model_cpu, dev)
    return counts


def wav_card_vs_cpu(torch, cfg, model_dev, model_cpu, dev,
                    tag="card_vs_cpu") -> dict:
    """One short request (48 tokens, 160 frames) through ``infer_prior``
    and ``decode_frames`` on the card and on the CPU: the same weights and
    the same noise; the waveforms within TOL_CPU_REL of the CPU's peak."""
    from visinger_tpu_torch.data.synthetic import synthetic_batch

    short = synthetic_batch(1, 48, 160, *VOCABS, hop_size=cfg.hop_size,
                            seed=4)
    keys = ("text_tokens", "note_pitch", "note_dur", "mel2ph", "spk_ids")
    eps = torch.randn(1, 160, cfg.hidden_size,
                      generator=torch.Generator().manual_seed(5))
    wavs = {}
    for name, model, d in (("cuda", model_dev, dev),
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
    check(err <= tol, f"{tag}: card vs CPU wav max abs err {err} > {tol}")
    row = dict(shape=list(wavs["cuda"].shape), max_abs_err=err, tol=tol,
               wav_abs_max=peak)
    phase(tag, **row)
    return row


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


def write_scores(data_dir: Path, cfg, seed: int, extra=()) -> dict:
    """MIDI files with Hangul lyrics (pitches, durations and rests drawn from
    ``seed``; 120 bpm, 480 ticks a beat) and the phone set, pitch map and
    duration map of a binarized data dir.  -> {"batch": [6 paths], "long":
    path, "short": path} and a path for each (name, seconds) of
    ``extra``, drawn after them."""
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

    out = {"batch": [score(f"song{i}", s)
                     for i, s in enumerate(SCORE_SECONDS)],
           "long": score("long", LONG_SECONDS),
           "short": score("short", SHORT_SECONDS)}
    out.update((name, score(name, s)) for name, s in extra)
    return out


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


# the trainer phase's corpus: full-width batches of 4 in the 640-frame bucket
TRAIN_ITEMS, VALID_ITEMS = 24, 8
ITEM_TOKENS, ITEM_FRAMES = (150, 192), (560, 640)
TOL_VALID_REL = 1e-4    # card vs CPU validation metrics, relative
ROUTE_STEPS = 8         # logged steps per data route, the first not timed


def write_corpus(data_dir: Path, n_train: int, n_valid: int, tokens, frames,
                 hop: int, seed: int = 0) -> None:
    """A binarized corpus in the record layout the JAX ``Binarizer`` writes
    (``ph_token``, ``note_pitch``, ``note_dur``, ``mel2ph``, ``f0`` in Hz
    with unvoiced runs, ``wav`` float32), ``{split}_lengths.npy`` and the
    phone set, pitch map and duration map at ``VOCABS``; items drawn from
    numpy ``seed`` with ``tokens`` and ``frames`` in the given ranges."""
    import numpy as np

    from visinger_tpu_torch.data.record_store import RecordWriter
    from visinger_tpu_torch.utils.text.token_encoder import (RESERVED_TOKENS,
                                                             TokenTextEncoder)

    n_ph, n_pitch, n_dur = VOCABS
    data_dir.mkdir(parents=True, exist_ok=True)
    TokenTextEncoder([f"ph{i}" for i in range(n_ph - len(RESERVED_TOKENS))]
                     ).store_to_file(str(data_dir / "phone_set.json"))
    maps = {"pitch_map": {str(i): i for i in range(n_pitch)},
            "dur_map": {str(i): i for i in range(n_dur)}}
    for name, m in maps.items():
        (data_dir / f"{name}.json").write_text(json.dumps(m))
    rng = np.random.RandomState(seed)
    for split, n_items in (("train", n_train), ("valid", n_valid)):
        lengths = []
        with RecordWriter(str(data_dir / split)) as w:
            for i in range(n_items):
                n = rng.randint(tokens[0], tokens[1] + 1)
                t = rng.randint(frames[0], frames[1] + 1)
                cuts = np.sort(rng.choice(np.arange(1, t), n - 1,
                                          replace=False))
                mel2ph = np.repeat(np.arange(1, n + 1),
                                   np.diff(np.concatenate([[0], cuts, [t]])))
                f0 = 220.0 * 2 ** (rng.randn(n)[mel2ph - 1] / 6)
                for _ in range(3):                 # unvoiced runs
                    a = rng.randint(0, t - 20)
                    f0[a:a + rng.randint(5, 20)] = 0.0
                phase = 2 * np.pi * np.cumsum(np.repeat(f0, hop)) / 24000
                wav = 0.3 * np.sin(phase) + 0.01 * rng.randn(t * hop)
                w.add({"item_name": f"{split}{i}", "spk_id": 0,
                       "ph_token": rng.randint(len(RESERVED_TOKENS), n_ph,
                                               n).tolist(),
                       "note_pitch": rng.randint(1, n_pitch, n).tolist(),
                       "note_dur": rng.randint(3, n_dur, n).tolist(),
                       "mel2ph": mel2ph.tolist(),
                       "f0": f0.astype(np.float32),
                       "wav": wav.astype(np.float32)})
                lengths.append(t)
        np.save(data_dir / f"{split}_lengths.npy", np.asarray(lengths))


def captured(fn):
    """(fn(), what it printed); the printed text is echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    print(buf.getvalue(), end="", flush=True)
    return result, buf.getvalue()


def sync_sites(torch, fn) -> dict:
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` and count
    the warnings by the line (and its code) that made them."""
    import linecache
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites: dict = {}
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        where = Path(w.filename)
        key = (f"{where.relative_to(ROOT)}:{w.lineno}"
               if where.is_relative_to(ROOT) else f"{where.name}:{w.lineno}")
        key += " " + linecache.getline(w.filename, w.lineno).strip()
        sites[key] = sites.get(key, 0) + 1
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def log_ms_per_step(work_dir: Path, skip: int = 1) -> list:
    """Wall ms per step from ``log.jsonl``'s ``steps_per_s`` of a run that
    logged every step (each log reads the meters, a synchronisation), the
    first ``skip`` steps left out."""
    recs = [json.loads(line) for line in
            (work_dir / "log.jsonl").read_text().splitlines()]
    return [1e3 / r["steps_per_s"] for r in recs
            if r["prefix"] == "train"][skip:]


def trainer(torch, ra, ws, dev, root: Path, training_ms: float):
    """``Trainer.fit`` at full width on a binarized corpus written from seed
    0 (24 train and 8 valid items, 150-192 tokens, 560-640 frames: batches
    of 4 in the 640-frame bucket): 8 steps on the device-store route with
    logs every 2 steps, validation and checkpoints every 4 and a sanity
    validation; a new trainer resuming to 10; 8 logged steps on each data
    route for the step time, between bare steps on a batch already on the
    card; the lines that wait for the card in 3 steps; the step-8
    checkpoint validated on the card and on the CPU; the costs of an eval
    batch, a checkpoint save and restore, the store's upload and the data
    plane's own work per batch.  Returns the launches of the 8-step fit."""
    import os
    import shutil
    import statistics

    import numpy as np

    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.data.dataset import build_dataset
    from visinger_tpu_torch.data.device_store import DeviceStore, gather_batch
    from visinger_tpu_torch.models.factory import build_models
    from visinger_tpu_torch.training.checkpoint import (AsyncCheckpointer,
                                                        restore_checkpoint,
                                                        save_checkpoint)
    from visinger_tpu_torch.training.train_state import create_train_state
    from visinger_tpu_torch.training.train_step import (device_batch,
                                                        make_train_step)
    from visinger_tpu_torch.training.trainer import Trainer

    shutil.rmtree(root, ignore_errors=True)
    data_dir = root / "data"
    base = visinger_csd()
    write_corpus(data_dir, TRAIN_ITEMS, VALID_ITEMS, ITEM_TOKENS, ITEM_FRAMES,
                 base.hop_size)
    base = base.replace(binary_data_dir=str(data_dir), num_ckpt_keep=3)
    b, t = base.max_sentences, 640

    def counts():
        return {"rel_attention_fwd": ra.launches,
                "rel_attention_bwd": ra.bwd_launches,
                "wavenet_stack_fwd": ws.launches}

    # 1. fit: 8 steps, the device store, validation at 4 and 8
    work = root / "store"
    cfg = base.replace(work_dir=str(work), tb_log_interval=2,
                       val_check_interval=4, num_sanity_val_steps=1,
                       eval_max_batches=2)
    tr = Trainer(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ra.launches = ra.bwd_launches = ws.launches = 0
    t0 = time.perf_counter()
    state, out = captured(lambda: tr.fit(max_updates=8))
    fit_s = time.perf_counter() - t0
    fit_counts = counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check("| sanity val (1 batches)" in out, "trainer: no sanity validation")
    check(state.step == 8, f"trainer: fit ended at step {state.step}")
    n_attn = (cfg.enc_layers + cfg.pitch_predictor_layers
              + cfg.frame_prior_layers + cfg.phoneme_predictor_layers)
    n_stack = 1 + cfg.flow_n_flows
    evals = 1 + 2 * 2                  # sanity, then 2 batches at 4 and 8
    want = {"rel_attention_fwd": n_attn * (8 + evals),
            "rel_attention_bwd": n_attn * 8,
            "wavenet_stack_fwd": n_stack * (8 + evals)}
    check(fit_counts == want, f"trainer: launches {fit_counts} != {want}")

    # 2. a new trainer resumes at 8 and goes on to 10
    state, out = captured(lambda: Trainer(cfg, device=dev).fit(
        max_updates=10))
    check("| resumed from step 8" in out and state.step == 10,
          f"trainer: resume ended at step {state.step}")
    files = sorted(os.listdir(work))
    for name in ("model_ckpt_steps_4.pt", "model_ckpt_steps_8.pt",
                 "model_ckpt_steps_10.pt", "model_ckpt_best.pt", "best.json",
                 "log.jsonl"):
        check(name in files, f"trainer: {name} missing ({files})")
    best = json.loads((work / "best.json").read_text())
    log = [json.loads(line) for line in
           (work / "log.jsonl").read_text().splitlines()]
    train_steps = [r["step"] for r in log if r["prefix"] == "train"]
    val = {r["step"]: r["val_loss"] for r in log if r["prefix"] == "val"}
    check(train_steps == [2, 4, 6, 8, 10] and sorted(val) == [4, 8],
          f"trainer: log steps {train_steps}, val {sorted(val)}")
    check(all(np.isfinite(v) for r in log for k, v in r.items()
              if k not in ("step", "prefix")), "trainer: a non-finite log")
    check(best["step"] in val and best["val_loss"] == min(val.values()),
          f"trainer: best.json {best} against {val}")

    # 3. 8 logged steps on each data route (steps 2-8 timed), between two
    # runs of bare steps on one of the corpus's batches: the host's speed
    # drifts within a call, so the data plane's cost is read against the
    # bare steps next to it
    bare_model, bare_disc = build_models(base, *VOCABS, device=dev, seed=0)
    bare_state = create_train_state(bare_model, bare_disc, seed=0)
    bare_step = make_train_step(base, bare_model, bare_disc, device=dev)
    ds = build_dataset(base, base.train_set_name)
    bare_batch = {k: torch.from_numpy(v).to(dev) for k, v in
                  ds.collate([ds[i] for i in range(b)]).items()}

    def time_bare(n: int = 6) -> list:
        """ms of n - 1 steps on a batch already on the card."""
        nonlocal bare_state
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            bare_state, _ = bare_step(bare_state, bare_batch)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out[1:]

    bare_before = time_bare()
    routes = {}
    for route, on in (("prefetch", False), ("device_store", True)):
        rcfg = base.replace(work_dir=str(root / route),
                            device_resident_data=on, tb_log_interval=1,
                            val_check_interval=10 ** 6,
                            num_sanity_val_steps=0, save_codes=False)
        ra.launches = ra.bwd_launches = ws.launches = 0
        Trainer(rcfg, device=dev).fit(max_updates=ROUTE_STEPS)
        rc = counts()
        check(all(v > 0 for v in rc.values()), f"trainer {route}: {rc}")
        ms = log_ms_per_step(root / route)
        med = statistics.median(ms)
        routes[route] = {"step_ms": ms, "median_step_ms": med,
                         "mel_frames_per_s": b * t / (med / 1e3),
                         "launches": rc}
        shutil.rmtree(root / route)

    bare_after = time_bare()
    bare_med = statistics.median(bare_before + bare_after)
    del bare_model, bare_disc, bare_state, bare_step

    # which lines wait for the card: 3 unlogged steps under the sync debug
    # mode (the final checkpoint's host copies are among them)
    scfg = base.replace(work_dir=str(root / "syncs"), tb_log_interval=10 ** 6,
                        val_check_interval=10 ** 6, num_sanity_val_steps=0,
                        save_codes=False)
    syncs = sync_sites(torch, lambda: Trainer(scfg, device=dev).fit(
        max_updates=3))
    shutil.rmtree(root / "syncs")

    # 4. the step-8 checkpoint on the card and on the CPU
    ckpt8 = str(work / "model_ckpt_steps_8.pt")
    metrics, trainers = {}, {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        trainers[name] = Trainer(cfg.replace(save_codes=False),
                                 work_dir=str(root / f"val_{name}"), device=d)
        st, _ = captured(lambda: restore_checkpoint(
            ckpt8, trainers[name].init_state()))
        metrics[name], _ = captured(
            lambda: trainers[name].validate(st, max_batches=1))
    rel = {k: abs(metrics["cuda"][k] - v) / max(abs(v), 1e-12)
           for k, v in metrics["cpu"].items()}
    check(set(metrics["cuda"]) == set(metrics["cpu"]) and all(
        np.isfinite(v) for v in metrics["cuda"].values()),
        f"trainer: validation metrics {metrics}")
    check(max(rel.values()) <= TOL_VALID_REL, f"trainer: card vs CPU "
          f"validation {rel} > {TOL_VALID_REL}")

    # costs: eval batches, checkpoint save and restore, the store's upload
    tr_c = trainers["cuda"]
    st = restore_checkpoint(ckpt8, tr_c.init_state())
    t0 = time.perf_counter()
    captured(lambda: tr_c.validate(st, max_batches=2))
    eval_ms = (time.perf_counter() - t0) * 1e3 / 2
    ck = root / "ckpt_timing"
    t0 = time.perf_counter()
    path = save_checkpoint(str(ck / "sync"), st)
    save_ms = (time.perf_counter() - t0) * 1e3
    size_mb = os.path.getsize(path) / 1e6
    ac = AsyncCheckpointer()
    t0 = time.perf_counter()
    ac.save(str(ck / "async"), st)
    async_caller_ms = (time.perf_counter() - t0) * 1e3
    ac.wait()
    async_total_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    restore_checkpoint(path, st)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = DeviceStore(ds, dev)
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    # the data plane's own work per batch, timed alone: the store's gather
    # (and the step's casts), and the prefetch route's collate + pin on the
    # producer thread and its copy to the card
    idxs, t_b, n_b = store.plan_batches(seed=0)[0]
    idxs = torch.from_numpy(idxs).to(dev)
    gather_ms = call_ms(torch, lambda: device_batch(gather_batch(
        store.arrays, idxs, t_b, n_b, base.hop_size), dev))
    t0 = time.perf_counter()
    host = list(tr_c._host_batches(ds, seed=0))
    collate_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    copy_ms = call_ms(torch, lambda: device_batch(tr_c._to_device(host[0]),
                                                  dev))
    phase("trainer", items={"train": TRAIN_ITEMS, "valid": VALID_ITEMS},
          batch=b, frames=t, fit_steps=8, fit_s=fit_s,
          launches=fit_counts, resumed_to=10, routes=routes,
          training_phase_median_step_ms=training_ms,
          bare_corpus_step_ms={"before": bare_before, "after": bare_after,
                               "median": bare_med},
          data_plane_ms={k: r["median_step_ms"] - bare_med
                         for k, r in routes.items()},
          eval_ms_per_batch=eval_ms, valid_card=metrics["cuda"],
          valid_cpu=metrics["cpu"], valid_rel_err=rel,
          valid_tol=TOL_VALID_REL, best=best,
          checkpoint_mb=size_mb, save_sync_ms=save_ms,
          save_async_caller_ms=async_caller_ms,
          save_async_total_ms=async_total_ms, restore_ms=restore_ms,
          store_upload_ms=upload_ms, store_mb=store.nbytes / 1e6,
          store_gather_call_ms=gather_ms, prefetch_collate_pin_ms=collate_ms,
          prefetch_copy_call_ms=copy_ms,
          peak_mem_gib=peak_gib, sync_sites_3_steps=syncs)
    shutil.rmtree(root, ignore_errors=True)
    return fit_counts


PIPELINE_SPLITS = {"test": 4, "valid": 4, "train": 20}   # tpu_run: 28 songs
PIPELINE_TRAIN = ("max_updates=4,render_valid=True,valid_infer_interval=2,"
                  "num_valid_plots=2,val_check_interval=4,"
                  "test_after_train=True")


def pipeline(torch, ra, ws, dev, root: Path) -> dict:
    """The ``tpu_run`` recipe at full width, all through
    ``visinger_tpu_torch.run.main`` in ``root``: ``synth-data`` (28 songs
    of 6-10 notes), ``binarize`` (route, seconds per item, records per
    split), ``train`` for 4 steps (validation and a render of 2 valid items
    at step 4, then the test split), ``test`` from the step-4 checkpoint in
    batches of 4 and of 1.  Every synthesized waveform (render and test) is
    checked (frames x hop long, finite, within +-1, not silent) and so is
    every wav file; the launches per render/test group are counted (K1 16,
    K2 4, K3 0); the first test item from the checkpoint on the card and on
    the CPU with the same noise agree within TOL_CPU_REL of its peak.
    Returns the launches of the ``train`` command."""
    import gc
    import os
    import re
    import shutil

    import numpy as np

    from visinger_tpu_torch import run
    from visinger_tpu_torch.config import tpu_run
    from visinger_tpu_torch.data.dataset import build_dataset
    from visinger_tpu_torch.models.factory import build_model
    from visinger_tpu_torch.training import trainer as trainer_mod
    from visinger_tpu_torch.training.checkpoint import load_checkpoint
    from visinger_tpu_torch.utils.audio.io import load_wav

    def counts():
        return {"rel_attention_fwd": ra.launches,
                "rel_attention_bwd": ra.bwd_launches,
                "wavenet_stack_fwd": ws.launches}

    # instrumentation, restored below: the launches of each render and test
    # call, and every waveform the trainer synthesizes
    groups, synthesized = [], []
    real = {"render_valid": trainer_mod.Trainer.render_valid,
            "test": trainer_mod.Trainer.test,
            "synthesize": trainer_mod.synthesize}

    def counted(name):
        def wrapper(self, *a, **k):
            before = counts()
            n0 = len(synthesized)
            out = real[name](self, *a, **k)
            groups.append({"call": name, "batches": len(synthesized) - n0,
                           "launches": {key: v - before[key]
                                        for key, v in counts().items()}})
            return out
        return wrapper

    def keep_synth(model, batch, seed):
        wavs, f0 = real["synthesize"](model, batch, seed)
        synthesized.append((wavs.detach().cpu().numpy(),
                            batch["mel_lengths"].copy(),
                            batch["item_weights"].copy()))
        return wavs, f0

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(root)
    trainer_mod.Trainer.render_valid = counted("render_valid")
    trainer_mod.Trainer.test = counted("test")
    trainer_mod.synthesize = keep_synth
    cfg = tpu_run()
    hop, sr = cfg.hop_size, cfg.sample_rate
    try:
        run.main(["synth-data", "--config", "tpu_run"])
        out, bin_out = captured(lambda: run.main(["binarize", "--config",
                                                  "tpu_run"]))
        check(out["counts"] == PIPELINE_SPLITS,
              f"pipeline: binarized {out['counts']} != {PIPELINE_SPLITS}")
        routes = [ln for ln in bin_out.splitlines()
                  if ln.startswith("| binarize:")]
        n_items = sum(out["counts"].values())

        torch.cuda.synchronize()
        ra.launches = ra.bwd_launches = ws.launches = 0
        t0 = time.perf_counter()
        state, train_out = captured(lambda: run.main(
            ["train", "--config", "tpu_run", "--device", str(dev), "-hp",
             PIPELINE_TRAIN]))
        train_s = time.perf_counter() - t0
        train_counts = counts()
        check(state.step == 4, f"pipeline: train ended at {state.step}")
        work = Path(cfg.work_dir)
        log = [json.loads(line) for line in
               (work / "log.jsonl").read_text().splitlines()]
        val = [r["val_loss"] for r in log if r["prefix"] == "val"]
        check(len(val) == 1 and np.isfinite(val[0]),
              f"pipeline: validation log {log}")

        # the test runs' peak alone: the train command's state let go
        del state
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tests = {}
        for per_item in (False, True):
            results, _ = captured(lambda: run.main(
                ["test", "--config", "tpu_run", "--device", str(dev), "-hp",
                 f"per_item_rtf={per_item}"]))
            saved = json.loads((work / "generated_4" / "results.json"
                                ).read_text())
            check(saved == results, "pipeline: results.json != returned")
            tests["per_item" if per_item else "batch_mean"] = results
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    finally:
        trainer_mod.Trainer.render_valid = real["render_valid"]
        trainer_mod.Trainer.test = real["test"]
        trainer_mod.synthesize = real["synthesize"]
        os.chdir(cwd)
    work = root / cfg.work_dir
    data_cfg = cfg.replace(binary_data_dir=str(root / cfg.binary_data_dir))

    # every synthesized waveform (real rows), and every wav file
    for wavs, lengths, weights in synthesized:
        for i in range(int(weights.sum())):
            w = wavs[i, : int(lengths[i]) * hop]
            check(np.isfinite(w).all() and np.abs(w).max() <= 1.0
                  and float(np.std(w)) > 1e-4,
                  f"pipeline: a synthesized waveform (frames "
                  f"{int(lengths[i])}) is not finite, within +-1 and "
                  f"audible: peak {np.abs(w).max()}, std {np.std(w)}")
    valid_batch = next(build_dataset(data_cfg, cfg.valid_set_name).batches(
        shuffle=False))
    rendered = sorted((work / "valid_4").glob("item*.wav"))
    check(len(rendered) == 2, f"pipeline: rendered {rendered}")
    for i, fn in enumerate(rendered):
        wav, _ = load_wav(str(fn))
        check(len(wav) == int(valid_batch["mel_lengths"][i]) * hop,
              f"pipeline: {fn.name} has {len(wav)} samples")
    pngs = sorted(p.name for p in (work / "valid_4").glob("*.png"))
    tests["after_train"] = json.loads(
        (work / "test_after_train" / "results.json").read_text())
    for kind, results in tests.items():
        check(len(results) == PIPELINE_SPLITS["test"] and all(
            np.isfinite(r[k]) for r in results
            for k in ("mcd", "mel_l1", "vuv_error")),
            f"pipeline: test {kind} results {results}")
        want_kind = "per_item" if kind == "per_item" else "batch_mean"
        check(all(r["rtf_kind"] == want_kind for r in results),
              f"pipeline: test {kind} rtf_kind")
    for r in tests["batch_mean"]:
        wav, _ = load_wav(str(work / "generated_4" / "wavs"
                              / r["wav_fn_pred"]))
        check(len(wav) == round(r["audio_s"] * sr),
              f"pipeline: {r['wav_fn_pred']} has {len(wav)} samples")

    # launches per render/test group: K1 16, K2 4, no K3
    n_attn = (cfg.enc_layers + cfg.pitch_predictor_layers
              + cfg.frame_prior_layers)
    per_group = {"rel_attention_fwd": n_attn, "rel_attention_bwd": 0,
                 "wavenet_stack_fwd": cfg.flow_n_flows}
    check([(g["call"], g["batches"]) for g in groups] == [
        ("render_valid", 1), ("test", 1), ("test", 1), ("test", 4)],
        f"pipeline: render/test calls {groups}")
    for g in groups:
        want = {k: v * g["batches"] for k, v in per_group.items()}
        check(g["launches"] == want, f"pipeline: {g['call']} launches "
              f"{g['launches']} != {want}")
    # the train command: 4 steps and 2 eval batches (the sanity batch and
    # the one valid batch at step 4; deterministic_eval false: each a train
    # step on a copy), then the render and the test split
    steps = 4 + 2
    n_train_attn = n_attn + cfg.phoneme_predictor_layers
    want = {"rel_attention_fwd": n_train_attn * steps + 2 * n_attn,
            "rel_attention_bwd": n_train_attn * steps,
            "wavenet_stack_fwd": (1 + cfg.flow_n_flows) * steps
            + 2 * cfg.flow_n_flows}
    check(train_counts == want,
          f"pipeline: train launches {train_counts} != {want}")

    # the first test item on the card and on the CPU, same checkpoint and ε
    ckpt = load_checkpoint(str(work / "model_ckpt_steps_4.pt"))
    first = next(build_dataset(data_cfg, cfg.test_set_name).batches(
        max_sentences=1, shuffle=False, pad_to_max_sentences=False))
    t = int(first["mel_lengths"][0])
    vocabs = [len(json.loads((root / cfg.binary_data_dir / f"{n}.json"
                              ).read_text()))
              for n in ("phone_set", "pitch_map", "dur_map")]
    wavs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = build_model(cfg, *vocabs, device=d)
        model.load_state_dict(ckpt["model"])
        w, _ = trainer_mod.synthesize(model, first, 0)
        wavs[name] = w[0, : t * hop].cpu().numpy()
        del model
    err = float(np.abs(wavs["cuda"] - wavs["cpu"]).max())
    peak = float(np.abs(wavs["cpu"]).max())
    check(err <= TOL_CPU_REL * peak, f"pipeline: card vs CPU test item "
          f"{err} > {TOL_CPU_REL} x peak {peak}")

    render_line = next(ln for ln in train_out.splitlines()
                       if ln.startswith("| render_valid step 4"))
    render_ms = float(re.search(r"\(([\d.]+) ms per item\)",
                                render_line).group(1))

    def throughput(results):
        audio = sum(r["audio_s"] for r in results)
        return audio / sum(r["rtf"] * r["audio_s"] for r in results)

    bin_s = out["seconds"]
    phase("pipeline", recipe="tpu_run", items=out["counts"],
          binarize_s=bin_s, binarize_s_per_item=bin_s / n_items,
          binarize_routes=routes, train_s=train_s, train_steps=4,
          train_launches=train_counts, val_loss=val[0],
          render_ms_per_item=render_ms, render_line=render_line,
          pngs=pngs or "skipped (matplotlib does not import)",
          test_rtf_batch_mean=[r["rtf"] for r in tests["batch_mean"]],
          test_rtf_per_item=[r["rtf"] for r in tests["per_item"]],
          test_audio_s=[r["audio_s"] for r in tests["per_item"]],
          audio_s_per_s={k: throughput(v) for k, v in tests.items()},
          quality_random_weights={k: {m: [r[m] for r in v] for m in (
              "mcd", "mel_l1", "f0_rmse_cents", "vuv_error")}
              for k, v in tests.items()},
          group_launches=groups, per_group=per_group,
          test_peak_mem_gib=peak_gib, card_vs_cpu_frames=t,
          card_vs_cpu_max_abs_err=err, card_vs_cpu_peak=peak,
          card_vs_cpu_tol=TOL_CPU_REL * peak)
    shutil.rmtree(root, ignore_errors=True)
    return train_counts


# card vs CPU, one bf16 training step (soak_r5, B=1, T=160, dropout 0): the
# card's bf16 convolutions and products (cuDNN, cuBLAS, K1/K3-bf16) and the
# CPU's round at other points and sum in other orders, so each loss is held
# to a bf16-sized share of itself (bf16 keeps 8 bits: 2^-8 = 3.9e-3 per
# rounding), not to the float32 step's 1e-4
TOL_BF16_LOSS_REL = 2e-2
# card vs CPU, two float32 steps of each training variant (B=1, T=160,
# dropout 0): the second step starts from parameters that went through
# Adam's normalised first update, where a gradient within rounding of zero
# may take the other sign on one device
TOL_VARIANT_REL = 1e-3
# remat against none on the card, one step's gradients with dropout on:
# the same draws, recomputed.  Not bit for bit: cuDNN's weight-gradient
# reductions do not repeat exactly (on an H100 the WaveNets' weight_g read
# 1.5e-5 of their peak between two runs of none; the phase prints that
# rerun beside remat's); a dropout mask drawn anew moves gradients by O(1)
# of their peak
TOL_REMAT_REL = 1e-4
BF16_TRAIN = ("max_updates={n},val_check_interval=2,valid_infer_interval=2,"
              "num_valid_plots=2,eval_max_batches=2,test_after_train={test}")


def bf16_counts(ra, ws) -> dict:
    return {"rel_attention_fwd": ra.launches,
            "rel_attention_bwd": ra.bwd_launches,
            "rel_attention_bf16_fwd": ra.launches_bf16,
            "rel_attention_bf16_bwd": ra.bwd_launches_bf16,
            "wavenet_stack_fwd": ws.launches}


def zero_counts(ra, ws) -> None:
    ra.launches = ra.bwd_launches = ws.launches = 0
    ra.launches_bf16 = ra.bwd_launches_bf16 = 0


def bf16_phase(torch, ra, ws, dev, root: Path, f32_step_ms: float,
               f32_peak_gib: float, profile: bool) -> dict:
    """The ``soak_r5`` recipe (bf16 compute) at full width, all on the card:
    a synthesis group of 4 beside the float32 model's (K1-bf16 16, K2 4 a
    group), 5 training steps in turns with 5 float32 steps (K1-bf16 18,
    K3-bf16 18, K2 5 a bf16 step; the float32 K1/K3 only in the float32
    steps), each kind's peak memory alone, one step
    with ``bf16_f32_islands=("phoneme",)`` (the phoneme head's layers in
    float32: K1 and K3 2 a step, their bf16 builds 16), one step's losses
    on the card and on the CPU, then ``run synth-data``/``binarize`` (with
    voice embeddings, for ``train_variants``), ``run train --config
    soak_r5`` for 2 steps, resumed to 4, and ``run test`` on its step-4
    checkpoint.  Returns the bf16 builds' launches of the timed training
    steps (5 of each kind, in turns); the corpus stays in ``root`` for
    ``train_variants``."""
    import os
    import shutil

    import numpy as np

    from visinger_tpu_torch import run
    from visinger_tpu_torch.config import soak_r5, visinger_csd
    from visinger_tpu_torch.data.synthetic import synthetic_batch
    from visinger_tpu_torch.infer.infer import TorchSynthesizer
    from visinger_tpu_torch.models.factory import build_models
    from visinger_tpu_torch.training.train_state import create_train_state
    from visinger_tpu_torch.training.train_step import make_train_step

    cfg = soak_r5()
    n_prior = cfg.enc_layers + cfg.pitch_predictor_layers \
        + cfg.frame_prior_layers
    n_attn = n_prior + cfg.phoneme_predictor_layers

    # synthesis: one group of 4, bf16 and float32 in turns
    batch = synthetic_batch(4, 192, 640, *VOCABS, hop_size=cfg.hop_size,
                            seed=0)
    requests = requests_from(batch, 4)
    synths = {"bf16": TorchSynthesizer(cfg, flow_model(torch, cfg, *VOCABS),
                                       device=dev),
              "f32": TorchSynthesizer(visinger_csd(), flow_model(
                  torch, visinger_csd(), *VOCABS), device=dev)}
    for sy in synths.values():
        sy.synthesize_batch(requests, seed=0)             # warm-up
    torch.cuda.synchronize()
    zero_counts(ra, ws)
    res = synths["bf16"].synthesize_batch(requests, seed=0)
    synth_counts = bf16_counts(ra, ws)
    want = {"rel_attention_fwd": 0, "rel_attention_bwd": 0,
            "rel_attention_bf16_fwd": n_prior, "rel_attention_bf16_bwd": 0,
            "wavenet_stack_fwd": cfg.flow_n_flows}
    check(synth_counts == want, f"bf16 synthesis launches {synth_counts} "
          f"!= {want}")
    for wav, t_valid in zip(res.wavs, batch["mel_lengths"]):
        check(wav.shape == (t_valid * cfg.hop_size,)
              and bool(np.isfinite(wav).all()) and abs(wav).max() <= 1.0
              and float(abs(wav).max()) > 0,
              f"bf16 synthesis: wav {wav.shape} for {t_valid} frames, "
              f"peak {abs(wav).max()}")
    group_s = {"f32": [], "bf16": []}
    for name in ("f32", "bf16", "bf16", "f32", "f32", "bf16"):
        group_s[name] += synths[name].synthesize_batch(
            requests, seed=0).group_seconds
    audio_s = float(batch["mel_lengths"].sum()) * cfg.hop_size \
        / cfg.sample_rate
    synth_row = {k: {"group_ms": [x * 1e3 for x in v],
                     "audio_s_per_s": audio_s / (sorted(v)[1])}
                 for k, v in group_s.items()}
    del synths

    # training at B=4, T=640: the bf16 and the float32 step, each with its
    # own models, 2 warm-ups, one step alone for its peak memory (above
    # what was allocated before its models were built), then 5 timed steps
    # of each in turns (bf16, f32, f32, bf16, ...)
    tb = training_batch(cfg, cfg.max_sentences, 192, 640, seed=0)
    runs, peak = {}, {}
    for name, rcfg in (("bf16", cfg), ("f32", visinger_csd())):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        model, disc = build_models(rcfg, *VOCABS, device=dev, seed=0)
        runs[name] = [create_train_state(model, disc, seed=0),
                      make_train_step(rcfg, model, disc, device=dev)]
        for i in range(3):
            if i == 2:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
            runs[name][0], _ = runs[name][1](runs[name][0], tb)
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    zero_counts(ra, ws)
    steps, step_ms, metrics = 5, {"bf16": [], "f32": []}, []
    for i in range(2 * steps):
        name = ("bf16", "f32")[(i + i // 2) % 2]
        t0 = time.perf_counter()
        runs[name][0], m = runs[name][1](runs[name][0], tb)
        torch.cuda.synchronize()
        step_ms[name].append((time.perf_counter() - t0) * 1e3)
        if name == "bf16":
            metrics.append(m)
    train_counts = bf16_counts(ra, ws)
    want = {"rel_attention_fwd": n_attn * steps,
            "rel_attention_bwd": n_attn * steps,
            "rel_attention_bf16_fwd": n_attn * steps,
            "rel_attention_bf16_bwd": n_attn * steps,
            "wavenet_stack_fwd": 2 * (1 + cfg.flow_n_flows) * steps}
    check(train_counts == want, f"bf16 and f32 training launches "
          f"{train_counts} != {want}")
    for m in metrics:
        for k, v in m.items():
            check(bool(torch.isfinite(v)), f"bf16 training: {k} = {v}")
    med = {k: sorted(v)[steps // 2] for k, v in step_ms.items()}
    if profile:
        state, train_step = runs["bf16"]
        profile_run(torch, lambda: train_step(state, tb), "train_step_bf16",
                    kernels={"k1_bf16": "rel_attention_bf16_fwd",
                             "k3_bf16": "rel_attention_bf16_bwd"
                                        "|sum_partials"})
    del runs

    # one step with the phoneme head in float32
    icfg = cfg.replace(bf16_f32_islands=("phoneme",))
    model, disc = build_models(icfg, *VOCABS, device=dev, seed=0)
    seen = {}

    def record(name):
        def hook(_m, _i, out):
            seen.setdefault(name, str(out.dtype))
        return hook

    for name, mod in (("phoneme", model.phoneme_predictor.encoder.ffn_0
                       .conv_2),
                      ("frame_prior", model.frame_prior.encoder.ffn_0
                       .conv_2)):
        mod.register_forward_hook(record(name))
    zero_counts(ra, ws)
    make_train_step(icfg, model, disc, device=dev)(
        create_train_state(model, disc, seed=0), tb)
    island_counts = bf16_counts(ra, ws)
    n_ph = cfg.phoneme_predictor_layers
    want = {"rel_attention_fwd": n_ph, "rel_attention_bwd": n_ph,
            "rel_attention_bf16_fwd": n_prior,
            "rel_attention_bf16_bwd": n_prior,
            "wavenet_stack_fwd": 1 + cfg.flow_n_flows}
    check(island_counts == want, f"island step launches {island_counts} "
          f"!= {want}")
    check(seen == {"phoneme": "torch.float32",
                   "frame_prior": "torch.bfloat16"},
          f"island step activations {seen}")
    del model, disc

    # one step's losses on the card and on the CPU: same weights and draws
    ccfg = cfg.replace(p_dropout=0.0)
    t = 160
    cb = training_batch(ccfg, 1, 48, t, seed=4)
    eps_q = torch.randn(1, t, cfg.hidden_size,
                        generator=torch.Generator().manual_seed(6))
    ids = torch.tensor([57])
    losses = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model, disc = build_models(ccfg, *VOCABS, device=d, seed=0)
        st = create_train_state(model, disc, seed=0)
        st.step = 1
        _, ls, _ = make_train_step(ccfg, model, disc, device=d).generator_loss(
            st, cb, eps_q=eps_q.to(d), ids_slice=ids.to(d))
        losses[name] = {k: float(v.detach()) for k, v in ls.items()}
        del model, disc, st
    loss_err = {k: abs(losses["cuda"][k] - v) / max(abs(v), 1e-12)
                for k, v in losses["cpu"].items()}
    check(all(e <= TOL_BF16_LOSS_REL for e in loss_err.values()),
          f"bf16 card vs CPU losses: {loss_err} > {TOL_BF16_LOSS_REL}")

    # the command line: synth-data, binarize (voice embeddings on), train 2
    # steps, resume to 4, test from the step-4 checkpoint
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        run.main(["synth-data", "--config", "soak_r5"])
        out, _ = captured(lambda: run.main(
            ["binarize", "--config", "soak_r5", "-hp",
             "binarization_args.with_spk_embed=True"]))
        check(out["counts"] == PIPELINE_SPLITS,
              f"bf16: binarized {out['counts']} != {PIPELINE_SPLITS}")
        zero_counts(ra, ws)
        runs = []
        for n, test in ((2, False), (4, True)):
            t0 = time.perf_counter()
            st, text = captured(lambda: run.main(
                ["train", "--config", "soak_r5", "--device", str(dev), "-hp",
                 BF16_TRAIN.format(n=n, test=test)]))
            runs.append({"steps": st.step, "s": time.perf_counter() - t0})
            check(st.step == n, f"bf16 run train ended at {st.step}")
            del st
        check("resumed from step 2" in text,
              "bf16 run train: the second run did not resume")
        cli_counts = bf16_counts(ra, ws)
        # 4 steps, and each eval batch a train step on a copy
        # (deterministic_eval false): all on the bf16 builds
        check(cli_counts["rel_attention_fwd"] == 0
              and cli_counts["rel_attention_bwd"] == 0
              and cli_counts["rel_attention_bf16_bwd"] >= n_attn * 4,
              f"bf16 run train launches {cli_counts}")
        work = Path(cfg.work_dir)
        results, _ = captured(lambda: run.main(
            ["test", "--config", "soak_r5", "--device", str(dev)]))
        check(len(results) == PIPELINE_SPLITS["test"] and all(
            np.isfinite(r[k]) for r in results
            for k in ("mcd", "mel_l1", "vuv_error")),
            f"bf16 run test results {results}")
        ckpts = sorted(p.name for p in work.glob("model_ckpt_steps_*.pt"))
        check("model_ckpt_steps_4.pt" in ckpts, f"bf16 checkpoints {ckpts}")
        after = json.loads((work / "test_after_train" / "results.json"
                            ).read_text())
        check(len(after) == PIPELINE_SPLITS["test"],
              "bf16 test_after_train results")
    finally:
        os.chdir(cwd)
    phase("bf16", recipe="soak_r5", synthesis=synth_row,
          synthesis_launches_per_group=synth_counts,
          train_launches_bf16_and_f32=train_counts,
          median_step_ms=med["bf16"], step_ms=step_ms["bf16"],
          f32_median_step_ms=med["f32"], f32_step_ms=step_ms["f32"],
          f32_training_phase_ms=f32_step_ms,
          mel_frames_per_s=cfg.max_sentences * 640 / (med["bf16"] / 1e3),
          f32_mel_frames_per_s=cfg.max_sentences * 640 / (med["f32"] / 1e3),
          peak_mem_gib=peak["bf16"], f32_peak_mem_gib=peak["f32"],
          f32_training_phase_peak_gib=f32_peak_gib,
          last_metrics={k: float(v) for k, v in metrics[-1].items()},
          island_launches=island_counts, island_activations=seen,
          card_vs_cpu_losses=losses["cpu"], card_vs_cpu_rel_err=loss_err,
          card_vs_cpu_tol=TOL_BF16_LOSS_REL, cli_runs=runs,
          cli_launches=cli_counts, checkpoints=ckpts,
          test_mcd=[r["mcd"] for r in results],
          test_rtf=[r["rtf"] for r in results])
    return train_counts


VARIANTS = {"spectral_norm": dict(use_spectral_norm=True),
            "accum2": dict(accumulate_grad_batches=2),
            "remat_full": dict(remat_policy="full"),
            "remat_dots": dict(remat_policy="dots"),
            "spk_embed": dict(use_spk_embed=True)}


def train_variants(torch, ra, ws, dev, data_dir: Path) -> dict:
    """The training switches at full width, float32: 2 steps of each on the
    card and on the CPU from the same weights and draws (B=1, a record of
    the corpus ``bf16_phase`` binarized with voice embeddings, dropout 0),
    every metric within TOL_VARIANT_REL; the two remat policies' generator
    gradients against none's on the card with dropout on; and the peak
    memory of one full-size step (B=4, T=640) under each remat policy."""
    import numpy as np

    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.data.dataset import build_dataset
    from visinger_tpu_torch.models.factory import build_models
    from visinger_tpu_torch.training.train_state import create_train_state
    from visinger_tpu_torch.training.train_step import (_grads,
                                                        make_train_step,
                                                        remat)

    base = visinger_csd().replace(binary_data_dir=str(data_dir))
    vocabs = [len(json.loads((data_dir / f"{n}.json").read_text()))
              for n in ("phone_set", "pitch_map", "dur_map")]
    # the shortest train record: the CPU runs each variant's steps too
    rec = min(build_dataset(base, base.train_set_name).batches(
        max_sentences=1, shuffle=False, pad_to_max_sentences=False),
        key=lambda r: int(r["mel_lengths"][0]))
    check(rec["spk_embed"].shape == (1, 256), "train_variants: the corpus "
          "has no voice embeddings")
    t = int(rec["mel2ph"].shape[1])
    eps = [torch.randn(1, t, base.hidden_size,
                       generator=torch.Generator().manual_seed(40 + i))
           for i in range(2)]
    ids = [torch.tensor([int(rec["mel_lengths"][0]) // 3 + i])
           for i in range(2)]
    rows = {}
    for name, over in VARIANTS.items():
        cfg = base.replace(p_dropout=0.0, **over)
        got, counts = {}, None
        for dname, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            model, disc = build_models(cfg, *vocabs, device=d, seed=0)
            st = create_train_state(model, disc, seed=0)
            step = make_train_step(cfg, model, disc, device=d)
            zero_counts(ra, ws)
            ms = []
            for i in range(2):
                st, m = step(st, rec, eps_q=eps[i].to(d),
                             ids_slice=ids[i].to(d))
                ms.append({k: float(v) for k, v in m.items()})
            if dname == "cuda":
                counts = bf16_counts(ra, ws)
            accum = cfg.accumulate_grad_batches
            check(st.opt_state_g.count == 2 // accum,
                  f"{name}: {st.opt_state_g.count} optimizer updates")
            got[dname] = ms
            del model, disc, st, step
        errs = [{k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b}
                for a, b in zip(got["cuda"], got["cpu"])]
        worst = max(max(e.values()) for e in errs)
        check(all(np.isfinite(v) for m in got["cuda"] for v in m.values()),
              f"{name}: non-finite metrics")
        check(worst <= TOL_VARIANT_REL, f"{name}: card vs CPU metrics "
              f"{errs} > {TOL_VARIANT_REL}")
        check(counts["rel_attention_fwd"] > 0
              and counts["rel_attention_bwd"] > 0
              and counts["wavenet_stack_fwd"] > 0,
              f"{name}: kernel launches {counts}")
        rows[name] = {"max_rel_err": worst, "launches_2_steps": counts,
                      "losses": got["cuda"][-1]}

    # remat on the card with dropout on: the same gradients as none (the
    # attention key bias, zero in exact arithmetic, against the largest
    # gradient, as in train_card_vs_cpu)
    remat_err, remat_worst, grads = {}, {}, {}
    for pol in ("none", "none_rerun", "full", "dots"):
        cfg = base.replace(remat_policy=pol.split("_")[0])
        model, disc = build_models(cfg, *vocabs, device=dev, seed=0)
        names = [n for n, _ in model.named_parameters()]
        st = create_train_state(model, disc, seed=0)
        step = make_train_step(cfg, model, disc, device=dev)
        total, _, _ = remat(cfg.remat_policy,
                            lambda: step.generator_loss(st, rec),
                            st.generator)
        grads[pol] = _grads(total, list(model.parameters()))
        del model, disc, st, step
    gmax = max(float(r.abs().max()) for r in grads["none"])
    for pol in ("none_rerun", "full", "dots"):
        errs = {}
        for name, g, r in zip(names, grads[pol], grads["none"]):
            peak = gmax * TOL_ZERO_GRAD / TOL_REMAT_REL \
                if name.endswith(ZERO_GRAD) else float(r.abs().max())
            errs[name] = float((g - r).abs().max()) / max(peak, 1e-30)
        worst = sorted(errs, key=errs.get, reverse=True)[:3]
        remat_err[pol] = errs[worst[0]]
        remat_worst[pol] = {n: errs[n] for n in worst}
        check(remat_err[pol] <= TOL_REMAT_REL, f"remat {pol}: gradients "
              f"from none's, of their peaks: {remat_worst[pol]}")
    del grads

    # peak memory of one full-size step under each remat policy
    tb = training_batch(base, base.max_sentences, 192, 640, seed=0)
    peak = {}
    for pol in ("none", "full", "dots"):
        cfg = base.replace(remat_policy=pol)
        model, disc = build_models(cfg, *VOCABS, device=dev, seed=0)
        st = create_train_state(model, disc, seed=0)
        step = make_train_step(cfg, model, disc, device=dev)
        st, _ = step(st, tb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        st, m = step(st, tb)
        torch.cuda.synchronize()
        peak[pol] = {"peak_mem_gib": torch.cuda.max_memory_allocated(dev)
                     / 2 ** 30,
                     "step_ms": (time.perf_counter() - t0) * 1e3}
        check(all(bool(torch.isfinite(v)) for v in m.values()),
              f"remat {pol}: non-finite metrics")
        del model, disc, st, step
    phase("train_variants", frames=t, variants=rows, tol=TOL_VARIANT_REL,
          remat_grad_err_of_peak=remat_err, remat_worst=remat_worst,
          remat_tol=TOL_REMAT_REL,
          remat_full_size=peak)
    return rows


# the serving export (phase ``export``): two float32 buckets, both among the
# configured ones, and the bf16 recipe's largest
EXPORT_BUCKETS = "96x320,192x640"
EXPORT_BF16_BUCKET = "192x640"
# (tokens, frames, seed) of each artifact's scores: one in the small bucket,
# one in the large, the small one again with a second seed
EXPORT_SCORES = {"f32": ((80, 300, 0), (180, 600, 0), (80, 300, 1)),
                 "bf16": ((180, 600, 0), (80, 300, 1))}
EXPORT_TIMED_CALLS = 10     # a turn's timed calls, after 3 to warm up
# the modules an artifact's loader must run without
EXPORT_BLOCKED = ("jax", "flax", "visinger_tpu", "visinger_tpu_torch.models",
                  "visinger_tpu_torch.modules", "visinger_tpu_torch.config",
                  "visinger_tpu_torch.training", "visinger_tpu_torch.data",
                  "visinger_tpu_torch.infer.infer")
# the loader's process: loads each artifact once it is written, serves its
# scores, and prints the launches of each call, its load seconds and the
# waveforms' paths
EXPORT_LOADER = """
import json, os, sys, time
for name in {blocked!r}:
    sys.modules[name] = None
import numpy as np
import torch
from visinger_tpu_torch.infer.export import ExportedSynthesizer
from visinger_tpu_torch.ops import rel_attention as ra
from visinger_tpu_torch.ops import wavenet_stack as ws

# as the live path it is held against: float32 products, no TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
job = json.loads(sys.argv[1])
out = {{"modules": sorted(m for m, mod in sys.modules.items()
                         if mod is not None
                         and m.startswith("visinger_tpu_torch."))}}
for name, spec in job.items():
    t0 = time.perf_counter()
    while not os.path.exists(spec["ready"]):     # written after the export
        if time.perf_counter() - t0 > 600:
            sys.exit(f"no artifact in {{spec['dir']}}")
        time.sleep(0.1)
    t0 = time.perf_counter()
    syn = ExportedSynthesizer(spec["dir"], device=spec["device"])
    for bucket in syn.buckets:
        syn.program(bucket)
    load_s = time.perf_counter() - t0
    calls = []
    for i, (npz, seed) in enumerate(spec["scores"]):
        score = np.load(npz)
        ra.launches = ra.launches_bf16 = ws.launches = 0
        wav = syn(*(score[f"arr_{{k}}"] for k in range(4)), seed=seed)
        calls.append({{"rel_attention_fwd": ra.launches,
                       "rel_attention_bf16_fwd": ra.launches_bf16,
                       "wavenet_stack_fwd": ws.launches,
                       "wav": npz.replace(".npz", f".{{name}}.wav.npy")}})
        np.save(calls[-1]["wav"], wav)
    out[name] = {{"load_s": load_s, "calls": calls}}
print(json.dumps(out))
""".format(blocked=EXPORT_BLOCKED)


def export_phase(torch, ra, ws, dev, root: Path) -> dict:
    """The serving export at full width (phase ``export``): a checkpoint of
    a fresh ``visinger_csd`` train state (seeded weights, the flow's
    ``post`` nonzero) written by ``training/checkpoint.py``, then ``run
    export --device cuda`` of it into a float32 artifact of two buckets
    (``EXPORT_BUCKETS``) and, with the ``soak_r5`` recipe (bf16 compute),
    a one-bucket artifact.  A subprocess that cannot import jax, flax,
    visinger_tpu or the port's models, modules, config, training, data and
    ``infer.infer`` loads both (the float32 one while the bf16 one is
    exported) and serves ``EXPORT_SCORES``; each call must launch K1 16
    and K2 4 times (float32) or K1-bf16 16 and K2 4 times (bf16), and each
    waveform must be within TOL_CPU_REL of its peak of the live path on
    the card (``infer_prior`` + ``decode_frames`` of the same weights,
    padded inputs and eps).  Prints export seconds per bucket, load
    seconds, the artifacts' bytes, and ms per call and audio-s/s of each
    artifact's longest score in turns with the live path (live, artifact,
    artifact, live).  Returns the subprocess's launches summed over its
    calls."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from visinger_tpu_torch import run
    from visinger_tpu_torch.config import soak_r5, visinger_csd
    from visinger_tpu_torch.data.synthetic import synthetic_batch
    from visinger_tpu_torch.infer.export import ExportedSynthesizer
    from visinger_tpu_torch.models.factory import build_model, build_models
    from visinger_tpu_torch.training.checkpoint import save_checkpoint
    from visinger_tpu_torch.training.train_state import create_train_state

    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    data_dir = root / "binary"
    data_dir.mkdir(parents=True)
    # vocabularies of VOCABS' sizes: what ``run export`` reads of the data
    (data_dir / "phone_set.json").write_text(json.dumps(
        [f"ph{i}" for i in range(VOCABS[0])]))
    for name, n in (("pitch_map", VOCABS[1]), ("dur_map", VOCABS[2])):
        (data_dir / f"{name}.json").write_text(json.dumps(
            {str(i): i for i in range(n)}))
    cfgs = {"f32": visinger_csd(), "bf16": soak_r5()}
    cfgs = {k: c.replace(work_dir=str(root / "work"),
                         binary_data_dir=str(data_dir))
            for k, c in cfgs.items()}
    hop, sr = cfgs["f32"].hop_size, cfgs["f32"].sample_rate
    model, disc = build_models(cfgs["f32"], *VOCABS, device="cpu", seed=0)
    flow_model(torch, cfgs["f32"], model=model)
    save_checkpoint(str(root / "work"), create_train_state(model, disc, 0))
    del disc

    # the scores, written before the loader's process starts
    jobs = {}
    for name, scores in EXPORT_SCORES.items():
        jobs[name] = {"dir": str(root / name), "device": dev.type,
                      "ready": str(root / f"{name}.ready"), "scores": []}
        for i, (n, t, seed) in enumerate(scores):
            # a score drawn by its shape: the same shape, the same score
            raw = synthetic_batch(1, n, t, *VOCABS, hop_size=hop, seed=n + t)
            k = int(raw["text_lengths"][0])
            npz = str(root / f"score_{name}_{i}.npz")
            np.savez(npz, *(raw[key][0, :k] for key in (
                "text_tokens", "note_pitch", "note_dur")), raw["mel2ph"][0])
            jobs[name]["scores"].append((npz, seed))

    lives, syns, timed = {}, {}, {}

    def run_live(name, inputs):
        with torch.no_grad():
            z_p, mask = lives[name].infer_prior(
                *inputs[:4], spk_id=inputs[4], eps=inputs[5])
            return lives[name].decode_frames(z_p, mask, spk_id=inputs[4])

    def turn_ms(fn) -> list:
        for _ in range(3):
            fn()
        ms = []
        for _ in range(EXPORT_TIMED_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    def prepare_timing():
        """The live models on the card, and the padded inputs of each
        artifact's longest score."""
        lives["f32"] = model.to(dev).eval()
        lives["bf16"] = build_model(cfgs["bf16"], *VOCABS, device="cpu")
        lives["bf16"].load_state_dict(model.state_dict())
        lives["bf16"] = lives["bf16"].to(dev).eval()
        for name, job in jobs.items():
            syns[name] = ExportedSynthesizer(job["dir"], device=dev)
            npz, seed = max(job["scores"],
                            key=lambda sc: len(np.load(sc[0])["arr_3"]))
            score = np.load(npz)
            timed[name] = syns[name].pad(
                *(score[f"arr_{k}"] for k in range(4)), seed=seed)

    # run export on the card, each bucket's trace and save timed; the
    # loader's process starts once the float32 artifact is written and
    # loads it while this process exports the bf16 one
    clocked, real = [], (torch.export.export, torch.export.save)

    def clock(fn, kind):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            clocked.append((kind, time.perf_counter() - t0))
            return out
        return wrapper

    metas, export_s, loader = {}, {}, None
    torch.export.export = clock(real[0], "trace")
    torch.export.save = clock(real[1], "save")
    try:    # a failure stops the loader's process too
        for name, buckets in (("f32", EXPORT_BUCKETS),
                              ("bf16", EXPORT_BF16_BUCKET)):
            cfg_fn = root / f"{name}.json"
            cfg_fn.write_text(json.dumps(cfgs[name].to_dict()))
            clocked.clear()
            t0 = time.perf_counter()
            metas[name] = run.main([
                "export", "--config", str(cfg_fn), "--device", dev.type,
                "--out_dir", str(root / name), "--batch_size", "1",
                "--buckets", buckets])
            export_s[name] = {
                "command_s": time.perf_counter() - t0,
                "per_bucket": [{"bucket": b, "trace_s": tr[1],
                                "save_s": sv[1]}
                               for b, tr, sv in zip(buckets.split(","),
                                                    clocked[0::2],
                                                    clocked[1::2])]}
            Path(jobs[name]["ready"]).touch()
            if loader is None:
                t_loader = time.perf_counter()
                loader = subprocess.Popen(
                    [sys.executable, "-c", EXPORT_LOADER, json.dumps(jobs)],
                    cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
        torch.export.export, torch.export.save = real
        prepare_timing()
        # this process loads the programs it times while the loader's
        # process runs (a thread: loading holds the interpreter, waiting on
        # a process does not)
        with ThreadPoolExecutor(1) as pool:
            preload = pool.submit(lambda: [syns[name].program(
                (timed[name][0].shape[1], timed[name][3].shape[1]))
                for name in jobs])
            stdout, stderr = loader.communicate(timeout=600)
            loader_s = time.perf_counter() - t_loader
            preload.result()
    except BaseException:
        if loader is not None and loader.poll() is None:
            loader.kill()
            loader.communicate()
        raise
    finally:
        torch.export.export, torch.export.save = real
    check(loader.returncode == 0, f"export loader failed:\n{stderr}")
    served = json.loads(stdout.strip().splitlines()[-1])
    leaked = [m for m in served["modules"] for b in EXPORT_BLOCKED
              if m == b or m.startswith(b + ".")]
    check(not leaked, f"the loader imported {leaked}")
    want = {"f32": ["rel_attention", "wavenet_stack"],
            "bf16": ["rel_attention_bf16", "wavenet_stack"]}
    for name, meta in metas.items():
        check(meta["device"] == dev.type and meta["kernels"] == want[name]
              and meta["compute_dtype"] == cfgs[name].compute_dtype,
              f"export {name}: meta {meta}")
    sizes = {name: {p.name: p.stat().st_size for p in (root / name).iterdir()}
             for name in metas}

    # each waveform against the live path on the card
    per_call = {"f32": {"rel_attention_fwd": 16, "rel_attention_bf16_fwd": 0,
                        "wavenet_stack_fwd": 4},
                "bf16": {"rel_attention_fwd": 0, "rel_attention_bf16_fwd": 16,
                         "wavenet_stack_fwd": 4}}
    launches = {"rel_attention_fwd": 0, "rel_attention_bf16_fwd": 0,
                "wavenet_stack_fwd": 0}
    rows, timing = {}, {}
    for name, job in jobs.items():
        syn = syns[name]
        rows[name] = []
        for (npz, seed), call in zip(job["scores"], served[name]["calls"]):
            for key, n in per_call[name].items():
                check(call[key] == n, f"export {name}: {key} {call[key]} "
                      f"launches in a call, not {n}")
                launches[key] += call[key]
            score = np.load(npz)
            arrays = [score[f"arr_{k}"] for k in range(4)]
            inputs = syn.pad(*arrays, seed=seed)
            ref = run_live(name, inputs)[0, :len(arrays[3]) * hop]
            ref = ref.float().cpu()
            got = torch.from_numpy(np.load(call["wav"]))
            peak = float(ref.abs().max())
            err = float((got - ref).abs().max())
            check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                  f"export {name}: wav {tuple(got.shape)}")
            check(peak > 0 and err <= TOL_CPU_REL * peak,
                  f"export {name}: artifact vs live max abs err {err} > "
                  f"{TOL_CPU_REL} x peak {peak}")
            rows[name].append({"tokens": len(arrays[0]),
                               "frames": len(arrays[3]), "seed": seed,
                               "bucket": list(syn.bucket_for(
                                   len(arrays[0]), len(arrays[3]))),
                               "max_abs_err": err, "peak": peak,
                               "launches": {k: call[k] for k in
                                            per_call[name]}})
        # ms per call at the longest score's padded inputs, in turns
        inputs = timed[name]
        ms = {"live": [], "artifact": []}
        for who in ("live", "artifact", "artifact", "live"):
            ms[who] += turn_ms(
                (lambda: run_live(name, inputs)) if who == "live"
                else (lambda: syn.synthesize(*inputs)))
        frames = int((inputs[3] > 0).sum())
        audio_s = frames * hop / sr
        medians = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
        timing[name] = {
            "bucket": [inputs[0].shape[1], inputs[3].shape[1]],
            "frames": frames, "ms_each": ms,
            **{f"{k}_ms": v for k, v in medians.items()},
            **{f"{k}_audio_s_per_s": audio_s / (v / 1e3)
               for k, v in medians.items()}}
    lives.clear()
    syns.clear()
    shutil.rmtree(root, ignore_errors=True)
    phase("export", seconds=time.perf_counter() - t_phase,
          export_s=export_s, loader_process_s=loader_s,
          load_s={k: served[k]["load_s"] for k in jobs},
          artifact_bytes=sizes, calls=rows, timing=timing,
          launches=launches, tol=TOL_CPU_REL)
    return launches


# phase scale_out: the data-parallel step, Trainer.fit and time-sharded
# synthesis over 2 ranks of gloo on the one card (NCCL refuses two ranks on
# one GPU; gloo takes CUDA tensors in all_reduce), NCCL at world size 1
SO_WORLD = 2
SO_BATCH, SO_TOKENS, SO_FRAMES = 4, 192, 640   # the training phase's batch
SO_TIMED_STEPS = 3
SO_FIT_STEPS, SO_RESUME_TO = 4, 6
SO_SP_SECONDS = 15.5      # one phrase in the 1280-frame bucket
SO_TURNS = 3              # timed turns of the 1-rank and the SP synthesis
TOL_SO_REL = 1e-4         # DP against the 1-process step: losses, gnorm_g


def so_step_inputs(torch, cfg):
    """The training phase's batch (B=4, up to 640 frames, 192 tokens) and
    fixed draws: eps_q [4, 640, H] and slice starts within each item's
    valid frames."""
    batch = training_batch(cfg, SO_BATCH, SO_TOKENS, SO_FRAMES, seed=0)
    gen = torch.Generator().manual_seed(8)
    eps_q = torch.randn(SO_BATCH, SO_FRAMES, cfg.hidden_size, generator=gen)
    room = (torch.from_numpy(batch["mel_lengths"]).long()
            - cfg.segment_size + 1).clamp(min=1)
    ids = (torch.rand(SO_BATCH, generator=gen) * room).long()
    return batch, eps_q, ids


def so_grad_step(torch, cfg, dev, batch, eps_q, ids, timed: int = 0):
    """From seeded weights at optimizer step 1 (past the KL warm-up), on
    this process's rows: the generator's losses and gradients (both summed
    over the ranks under a process group), one train step's metrics, then
    ``timed`` more steps (ms each, their launches, peak GiB)."""
    from visinger_tpu_torch.models.factory import build_models
    from visinger_tpu_torch.ops import rel_attention as ra
    from visinger_tpu_torch.ops import wavenet_stack as ws
    from visinger_tpu_torch.parallel import mesh
    from visinger_tpu_torch.training.train_state import create_train_state
    from visinger_tpu_torch.training.train_step import make_train_step

    model, disc = build_models(cfg, *VOCABS, device=dev, seed=0)
    state = create_train_state(model, disc, seed=0)
    state.step = 1
    step = make_train_step(cfg, model, disc, device=dev)
    eps_q, ids = eps_q.to(dev), ids.to(dev)
    total, losses, _ = step.generator_loss(state, batch, eps_q, ids)
    params = list(model.parameters())
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params, torch.autograd.grad(total, params, allow_unused=True))]
    grads = [g.cpu() for g in mesh.all_reduce_grads(grads)]
    losses = {k: float(v) for k, v in zip(
        losses, mesh.global_sums([v.detach() for v in losses.values()]))}
    state, m = step(state, batch, eps_q, ids)
    metrics = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(ra, ws)
    ms = []
    for _ in range(timed):
        mesh.barrier()
        t0 = time.perf_counter()
        state, _ = step(state, batch, eps_q, ids)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"rel_attention_fwd": ra.launches,
                "rel_attention_bwd": ra.bwd_launches,
                "wavenet_stack_fwd": ws.launches}
    return {"losses": losses, "grads": grads, "metrics": metrics,
            "names": [n for n, _ in model.named_parameters()],
            "step_ms": ms, "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "spread": mesh.replicated_check([*model.parameters(),
                                             *disc.parameters()])}


def so_rel(got: dict, ref: dict) -> dict:
    """Each value's error relative to the reference's (1e-7 of slack for a
    value of 0)."""
    return {k: abs(got[k] - r) / (abs(r) + 1e-7) for k, r in ref.items()}


def so_rank_dp(torch, dev, root: Path) -> dict:
    """(b) The DP step on this rank's 2 rows against the 1-process step on
    the whole batch (``ref.pt``, written by the parent)."""
    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.parallel import mesh, multihost

    ref = torch.load(root / "ref.pt", weights_only=False)
    rows = multihost.host_batch_slice(SO_BATCH)
    cfg = visinger_csd().replace(p_dropout=0.0)
    got = so_grad_step(torch, cfg, dev, mesh.shard_batch(ref["batch"]),
                       ref["eps_q"][rows], ref["ids"][rows],
                       timed=SO_TIMED_STEPS)
    loss_err = so_rel(got["losses"], ref["losses"])
    metric_err = so_rel(got["metrics"], ref["metrics"])
    grad_err, zero_noise, gmax, failures = grad_errors(
        torch, ref["names"], got["grads"], ref["grads"])
    failures += [f"{k}: rel err {e} > {TOL_SO_REL}" for k, e in
                 {**loss_err, **metric_err}.items() if e > TOL_SO_REL]
    check(not failures, f"scale_out dp rank {mesh.rank()}: "
          + "; ".join(failures[:5]))
    check(got["spread"] == 0.0, f"scale_out dp: parameters differ across "
          f"the ranks by {got['spread']}")
    n_attn = (cfg.enc_layers + cfg.pitch_predictor_layers
              + cfg.frame_prior_layers + cfg.phoneme_predictor_layers)
    want = {"rel_attention_fwd": n_attn * SO_TIMED_STEPS,
            "rel_attention_bwd": n_attn * SO_TIMED_STEPS,
            "wavenet_stack_fwd": (1 + cfg.flow_n_flows) * SO_TIMED_STEPS}
    check(got["launches"] == want, f"scale_out dp: launches "
          f"{got['launches']} != {want}")
    return {"rows": [rows.start, rows.stop],
            "max_loss_rel_err": max(loss_err.values()),
            "max_metric_rel_err": max(metric_err.values()),
            "gnorm_g_rel_err": metric_err["gnorm_g"],
            "max_grad_err_of_peak": max(grad_err.values()),
            "max_zero_grad_noise": max(zero_noise.values()),
            "param_spread": got["spread"], "step_ms": got["step_ms"],
            "launches": got["launches"], "peak_mem_gib": got["peak_mem_gib"]}


def so_rank_fit(torch, ra, ws, dev, root: Path) -> dict:
    """(c) ``Trainer.fit`` for SO_FIT_STEPS steps at full width on the
    trainer phase's corpus, then a new trainer resumed to SO_RESUME_TO."""
    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.parallel import mesh
    from visinger_tpu_torch.training.trainer import Trainer

    cfg = visinger_csd().replace(
        binary_data_dir=str(root / "data"), work_dir=str(root / "fit"),
        num_ckpt_keep=3, tb_log_interval=2, val_check_interval=4,
        num_sanity_val_steps=0, eval_max_batches=1)
    zero_counts(ra, ws)
    t0 = time.perf_counter()
    captured(lambda: Trainer(cfg, device=dev).fit(max_updates=SO_FIT_STEPS))
    state, out = captured(lambda: Trainer(cfg, device=dev).fit(
        max_updates=SO_RESUME_TO))
    seconds = time.perf_counter() - t0
    launches = {"rel_attention_fwd": ra.launches,
                "rel_attention_bwd": ra.bwd_launches,
                "wavenet_stack_fwd": ws.launches}
    n_attn = (cfg.enc_layers + cfg.pitch_predictor_layers
              + cfg.frame_prior_layers + cfg.phoneme_predictor_layers)
    steps, evals = SO_RESUME_TO, 1            # one valid batch at step 4
    want = {"rel_attention_fwd": n_attn * (steps + evals),
            "rel_attention_bwd": n_attn * steps,
            "wavenet_stack_fwd": (1 + cfg.flow_n_flows) * (steps + evals)}
    check(launches == want, f"scale_out fit: launches {launches} != {want}")
    check(f"| resumed from step {SO_FIT_STEPS}" in out
          and state.step == SO_RESUME_TO,
          f"scale_out fit rank {mesh.rank()}: resume ended at {state.step}")
    spread = mesh.replicated_check([*state.model.parameters(),
                                    *state.disc.parameters()])
    check(spread == 0.0, f"scale_out fit: parameters differ by {spread}")
    return {"resumed": True, "step": state.step, "seconds": seconds,
            "launches": launches, "param_spread": spread}


def so_rank_sp(torch, ra, ws, dev, root: Path) -> dict:
    """(d) Time-sharded synthesis through ``VISingerInfer`` with
    ``sp_infer``: the 1280-frame score and the 24 s score, against the
    single-device waveforms (``sp_ref.npz``), with the launches of one call
    and ms in turns with the single-device path (rank 0 alone, the other
    rank waiting)."""
    import numpy as np

    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.infer.infer import VISingerInfer
    from visinger_tpu_torch.parallel import mesh
    from visinger_tpu_torch.run import vocab_sizes

    cfg = visinger_csd()
    scores = root / "scores"
    inf = VISingerInfer(cfg.replace(sp_infer=True), flow_model(
        torch, cfg, *vocab_sizes(scores)), scores, device=dev)
    plain = VISingerInfer(cfg, inf.model, scores, device=dev)
    refs = np.load(root / "sp_ref.npz")
    out = {}
    for name in ("sp1280", "long"):
        fn = str(scores / f"{name}.mid")
        phrases = len(inf._phrases(inf.score_rows(fn)))
        inf.synthesize(fn, seed=0)                        # warm-up
        if mesh.rank() == 0:
            plain.synthesize(fn, seed=0)
        zero_counts(ra, ws)
        wav, _ = inf.synthesize(fn, seed=0)
        launches = {"rel_attention_fwd": ra.launches,
                    "wavenet_stack_fwd": ws.launches}
        per = {"rel_attention_fwd": (cfg.enc_layers
                                     + cfg.pitch_predictor_layers
                                     + cfg.frame_prior_layers) * phrases,
               "wavenet_stack_fwd": cfg.flow_n_flows * phrases}
        check(launches == per, f"scale_out sp {name}: launches {launches} "
              f"!= {per}")
        ref = refs[name]
        peak = float(np.abs(ref).max())
        err = float(np.abs(wav - ref).max()) if wav.shape == ref.shape \
            else float("inf")
        check(peak > 0 and err <= TOL_CPU_REL * peak, f"scale_out sp "
              f"{name}: max abs err {err} against the single-device "
              f"waveform > {TOL_CPU_REL} x {peak}")
        plain_ms, sp_ms = [], []
        for _ in range(SO_TURNS):
            mesh.barrier()
            if mesh.rank() == 0:
                t0 = time.perf_counter()
                plain.synthesize(fn, seed=0)
                plain_ms.append((time.perf_counter() - t0) * 1e3)
            mesh.barrier()
            t0 = time.perf_counter()
            inf.synthesize(fn, seed=0)
            sp_ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"phrases": phrases, "seconds": len(wav) / cfg.sample_rate,
                     "launches": launches, "max_abs_err": err,
                     "tol": TOL_CPU_REL * peak, "sp_ms": sp_ms,
                     "one_rank_ms": plain_ms}
    return out


def scale_out_rank(rank: int, world: int, port: int, root: str,
                   device: str) -> None:
    """One rank of phase ``scale_out`` (spawned after the kernels are
    built): gloo on ``device``, the card every rank shares; its results to
    ``root/rank{rank}.json``."""
    import torch

    from visinger_tpu_torch.ops import rel_attention as ra
    from visinger_tpu_torch.ops import wavenet_stack as ws
    from visinger_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(root)
    dev = multihost.initialize_distributed(f"localhost:{port}", world, rank,
                                           backend="gloo", device=device,
                                           timeout_s=300)
    try:
        res = {"dp": so_rank_dp(torch, dev, root)}
        torch.cuda.empty_cache()
        res["fit"] = so_rank_fit(torch, ra, ws, dev, root)
        torch.cuda.empty_cache()
        res["sp"] = so_rank_sp(torch, ra, ws, dev, root)
        (root / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        multihost.shutdown()


def scale_out(torch, ra, ws, dev, root: Path) -> dict:
    """The scale-out slice (phase ``scale_out``), at full width:
    (a) the float32 step of phase ``training`` (B=4, T=640, dropout 0,
        given draws) under an NCCL process group of world size 1 against
        the bare step, beside the bare step run again: losses and metrics
        within TOL_LOSS_REL, gradients within TOL_GRAD_REL of their peaks
        (the card's backward is not bit-reproducible: the rerun shows by
        how much);
    (b) 2 gloo ranks on the card, 2 rows each of the same batch and draws:
        losses, metrics and ``gnorm_g`` within TOL_SO_REL of the 1-process
        step on the whole batch, the summed gradients within TOL_GRAD_REL
        of their peaks, the parameters after the step the same bits on both
        ranks; the step ms of both kinds and each rank's peak GiB (not a
        claim: the ranks share the card);
    (c) ``Trainer.fit`` under the same ranks on the trainer phase's corpus:
        4 steps, then resumed to 6; one checkpoint set, written by rank 0;
    (d) ``VISingerInfer`` with ``sp_infer`` on the same ranks: a
        1280-frame score and the 24 s score within TOL_CPU_REL of their
        peaks of the single-device waveform; the single-process loop over
        both ranks' pieces (``sp_piece``) against the same reference;
    (e) ``__graft_entry_torch__.entry()`` on the card and
        ``dryrun_multichip(1)`` on NCCL.
    Returns the launches per rank of a DP step and of an SP call."""
    import gc
    import os

    import numpy as np
    import torch.multiprocessing as mp

    import __graft_entry_torch__ as graft
    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.infer.infer import VISingerInfer
    from visinger_tpu_torch.parallel import multihost, sp
    from visinger_tpu_torch.run import vocab_sizes

    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = visinger_csd().replace(p_dropout=0.0)
    batch, eps_q, ids = so_step_inputs(torch, cfg)

    # (a) the bare step, again (the card's own spread between two runs of
    # one step), then the same under NCCL at world size 1
    bare = so_grad_step(torch, cfg, dev, batch, eps_q, ids,
                        timed=SO_TIMED_STEPS)
    runs = {"bare_rerun": so_grad_step(torch, cfg, dev, batch, eps_q, ids)}
    multihost.initialize_distributed(f"localhost:{graft.free_port()}", 1, 0,
                                     backend="nccl", device=dev)
    try:
        runs["nccl_world_1"] = so_grad_step(torch, cfg, dev, batch, eps_q,
                                            ids)
    finally:
        multihost.shutdown()
    against_bare = {}
    for name, run in runs.items():
        grad_err, _, _, failures = grad_errors(torch, bare["names"],
                                               run["grads"], bare["grads"])
        worst = max(grad_err, key=grad_err.get)
        against_bare[name] = {
            "losses": max(so_rel(run["losses"], bare["losses"]).values()),
            "metrics": max(so_rel(run["metrics"], bare["metrics"]).values()),
            "grads_max_abs": max(float((a - b).abs().max()) for a, b in zip(
                run["grads"], bare["grads"])),
            "grad_err_of_peak": grad_err[worst], "worst_grad": worst,
            "grads_equal": sum(torch.equal(a, b) for a, b in zip(
                run["grads"], bare["grads"])),
            "grad_tensors": len(run["grads"])}
        check(not failures and against_bare[name]["losses"] <= TOL_LOSS_REL
              and against_bare[name]["metrics"] <= TOL_LOSS_REL,
              f"scale_out {name}: {against_bare[name]} {failures[:3]}")
    torch.save({k: bare[k] for k in ("losses", "metrics", "grads", "names")}
               | {"batch": batch, "eps_q": eps_q, "ids": ids},
               root / "ref.pt")
    del runs

    # (c)'s corpus; (d)'s scores and their single-device waveforms
    write_corpus(root / "data", TRAIN_ITEMS, VALID_ITEMS, ITEM_TOKENS,
                 ITEM_FRAMES, cfg.hop_size)
    vcfg = visinger_csd()
    (root / "scores").mkdir()
    scores = write_scores(root / "scores", vcfg, seed=0,
                          extra=(("sp1280", SO_SP_SECONDS),))
    inf = VISingerInfer(vcfg, flow_model(torch, vcfg, *vocab_sizes(
        root / "scores")), root / "scores", device=dev)
    one, t_valid = inf._pad_to_bucket(inf.preprocess_input(scores["sp1280"]))
    t_pad = one["mel2ph"].shape[1]
    check(t_pad == 1280 and len(inf._phrases(inf.score_rows(
        scores["sp1280"]))) == 1, f"scale_out: the SP score is {t_valid} "
        f"frames in a {t_pad}-frame bucket")
    refs = {name: inf.synthesize(scores[name], seed=0)[0]
            for name in ("sp1280", "long")}
    np.savez(root / "sp_ref.npz", **refs)
    x = {k: torch.from_numpy(v).long().to(dev) for k, v in one.items()}
    with torch.no_grad():
        z_p, mask = inf.model.infer_prior(
            x["text_tokens"], x["note_pitch"], x["note_dur"], x["mel2ph"],
            spk_id=x["spk_ids"], eps=inf.prior_noise(t_pad, 0).to(dev))
        full = inf.model.decode_frames(z_p, mask, spk_id=x["spk_ids"])
        pieces = torch.cat([sp.sp_piece(inf.model, z_p, mask, r, SO_WORLD,
                                        spk_id=x["spk_ids"])
                            for r in range(SO_WORLD)], dim=1)
    loop_err = float((pieces - full).abs().max())
    loop_tol = TOL_CPU_REL * float(full.abs().max())
    check(loop_err <= loop_tol, f"scale_out: the loop over the ranks' "
          f"pieces is {loop_err} from the full decode > {loop_tol}")
    del inf, x, z_p, mask, full, pieces
    gc.collect()
    torch.cuda.empty_cache()

    # (b), (c), (d) on 2 spawned ranks
    t0 = time.perf_counter()
    mp.start_processes(scale_out_rank, args=(SO_WORLD, graft.free_port(),
                                             str(root), str(dev)),
                       nprocs=SO_WORLD, start_method="spawn")
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in range(SO_WORLD)]
    fit_dir = root / "fit"
    files = sorted(os.listdir(fit_dir))
    ckpts = [f for f in files if f.startswith("model_ckpt_steps_")]
    check(ckpts == [f"model_ckpt_steps_{SO_FIT_STEPS}.pt",
                    f"model_ckpt_steps_{SO_RESUME_TO}.pt"]
          and not [f for f in files if f.endswith(".part")]
          and {"model_ckpt_best.pt", "best.json", "log.jsonl"} <= set(files),
          f"scale_out fit: work dir holds {files}")
    log = [json.loads(line) for line in
           (fit_dir / "log.jsonl").read_text().splitlines()]
    train_steps = [r["step"] for r in log if r["prefix"] == "train"]
    val_steps = [r["step"] for r in log if r["prefix"] == "val"]
    check(train_steps == [2, 4, 6] and val_steps == [4],
          f"scale_out fit: log steps {train_steps}, val {val_steps}")

    # (e) the entry points of __graft_entry_torch__.py
    fn, args = graft.entry(device=dev)
    wav_out, kl = fn(*args)
    torch.cuda.synchronize()
    check(tuple(wav_out.shape) == (2, visinger_csd().segment_size
                                   * visinger_csd().hop_size)
          and bool(torch.isfinite(wav_out).all())
          and bool(torch.isfinite(kl)), f"scale_out entry: {wav_out.shape}")
    del fn, args, wav_out
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    graft.dryrun_multichip(1)
    dryrun_s = time.perf_counter() - t0

    dp_launches = {k: v / SO_TIMED_STEPS
                   for k, v in ranks[0]["dp"]["launches"].items()}
    sp_launches = {name: {k: v / r["phrases"]
                          for k, v in r["launches"].items()}
                   for name, r in ranks[0]["sp"].items()}
    phase("scale_out", world=SO_WORLD, backend="gloo, one card",
          batch=SO_BATCH, frames=SO_FRAMES, against_bare=against_bare,
          one_process_step_ms=bare["step_ms"],
          one_process_peak_mem_gib=bare["peak_mem_gib"],
          ranks=ranks, ranks_seconds=ranks_s,
          fit_files=files, sp_loop_max_abs_err=loop_err, sp_loop_tol=loop_tol,
          sp_frames=t_pad, entry_kl=float(kl.detach()),
          dryrun_nccl_1_seconds=dryrun_s,
          dp_launches_per_step_per_rank=dp_launches,
          sp_launches_per_phrase_per_rank=sp_launches,
          seconds=time.perf_counter() - t_phase)
    shutil.rmtree(root, ignore_errors=True)
    return {"dp_step_per_rank": dp_launches,
            "sp_call_per_rank": {name: r["launches"]
                                 for name, r in ranks[0]["sp"].items()}}


# phase widths: head widths that are not a multiple of 8 and channel counts
# that are not a multiple of 32, which K1, K3 and K2 take zero-padded on the
# card (ops/pad_pack.py), as the TPU kernels take any dk <= 128 and any C.
# K1 and K3, float32 and bf16: (label, T, C, heads)
WIDTH_ATTN = (("dk 90", 640, 180, 2), ("dk 50", 640, 200, 4),
              ("dk 8", 640, 16, 2))
# K2: (label, C, layers, with its autograd gradients)
WIDTH_STACK = (("c180", 180, 16, True), ("c16", 16, 4, False))
WIDTH_LENGTHS = [640, 600, 517, 333]
# the experiment file: the tpu_run demo at dk 90 and C 180
WIDTH_HIDDEN, WIDTH_HEADS = 180, 2
WIDTH_KERNELS = ("rel_attention_fwd", "rel_attention_bwd",
                 "rel_attention_bf16_fwd", "rel_attention_bf16_bwd")


def width_counts(ra, ws, pp) -> dict:
    return {**bf16_counts(ra, ws), "pad_pack": pp.launches}


def zero_width_counts(ra, ws, pp) -> None:
    zero_counts(ra, ws)
    pp.launches = 0


def check_width_attention(torch, ra, dev) -> dict:
    """K1 and K3, float32 and bf16, at every ``WIDTH_ATTN`` head width
    against their plain versions on the same inputs, dropout off and 0.1
    (the float32 builds within TOL_KERNEL, the bf16 builds within one bf16
    ulp of the peak and the emb gradients within TOL_BF16_EMB, the row
    statistics within TOL_STATS_REL), K3 the same bits on a rerun; with
    dropout off the device and call ms of the wrapper (its padding launches
    included) beside the plain version's, and the bounds of the function at
    its real width.  -> {kernel name: [rows]}."""
    gen = torch.Generator(device="cpu").manual_seed(31)
    window = 4
    seed = torch.tensor([31337], dtype=torch.int32, device=dev)
    names = ("dq", "dk", "dv", "d_emb_rel_k", "d_emb_rel_v")
    rows = {name: [] for name in WIDTH_KERNELS}
    lengths = WIDTH_LENGTHS
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for label, t, c, heads in WIDTH_ATTN:
        dk = c // heads
        base = [torch.randn(len(lengths), t, c, generator=gen).to(dev)
                for _ in range(4)]
        ek, ev = (torch.randn(2 * window + 1, dk, generator=gen).mul(
            dk ** -0.5).to(dev) for _ in range(2))
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            q, k, v, g = (a.to(dtype) for a in base)
            sfx = "_bf16" if bf16 else ""
            for rate in (0.0, 0.1):
                kw = dict(window=window, scale=dk ** -0.5, seed=seed,
                          rate=rate)
                out, stats = ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw)
                ref, ref_stats = ra.rel_attention_plain(
                    q, k, v, ek, ev, lens, **kw, with_stats=True)
                got = ra.rel_attention_bwd(q, k, v, ek, ev, lens, g, out,
                                           stats, **kw)
                again = ra.rel_attention_bwd(q, k, v, ek, ev, lens, g, out,
                                             stats, **kw)
                want = ra.rel_attention_bwd_plain(q, k, v, ek, ev, lens, g,
                                                  **kw)
                torch.cuda.synchronize()
                what = (f"widths K1/K3{sfx.replace('_', '-')} {label} rate "
                        f"{rate}")
                check(out.dtype == dtype and bool(torch.isfinite(
                    out.float()).all()), f"{what}: output {out.dtype}, or "
                      "non-finite")
                serr = stats_err(stats, ref_stats)
                check(serr <= TOL_STATS_REL, f"{what}: stats err {serr} > "
                      f"{TOL_STATS_REL}")
                abs_err = float((out.float() - ref.float()).abs().max())
                fwd_row = {"shape": f"[{len(lengths)}, {t}, {c}] {label}, "
                                    f"{heads} heads", "dropout": rate,
                           "max_abs_err": abs_err, "stats_err": serr}
                if bf16:
                    err = bf16_err(out, ref)
                    fwd_row["err_of_peak"] = err
                    check(err <= TOL_BF16_REL, f"{what}: K1 err {err} of "
                          f"the peak > {TOL_BF16_REL}")
                    errs = {n: bf16_err(a, r)
                            for n, a, r in zip(names, got, want)}
                    tols = [TOL_BF16_REL] * 3 + [TOL_BF16_EMB] * 2
                else:
                    check(abs_err <= TOL_KERNEL, f"{what}: K1 max abs err "
                          f"{abs_err} > {TOL_KERNEL}")
                    errs = {n: float((a - r).abs().max())
                            for n, a, r in zip(names, got, want)}
                    tols = [TOL_KERNEL] * 5
                for (n, a, b), tol in zip(zip(names, got, again), tols):
                    check(bool(torch.isfinite(a.float()).all()),
                          f"{what}: {n} non-finite")
                    check(errs[n] <= tol, f"{what}: {n} err {errs[n]} > "
                          f"{tol}")
                    check(torch.equal(a, b), f"{what}: {n} differs between "
                          "two runs on the same inputs")
                bwd_row = {"shape": fwd_row["shape"], "dropout": rate,
                           "max_abs_err": max(
                               float((a.float() - r.float()).abs().max())
                               for a, r in zip(got, want)),
                           ("errs_of_peak" if bf16 else "errs"): errs,
                           "bit_identical_rerun": True}
                if rate == 0.0:
                    fl, nb = k1_work(lengths, t, c, heads, window)
                    fl3, nb3 = k3_work(lengths, t, c, heads, window)
                    bound = bounds_bf16 if bf16 else bounds
                    scale = 2 if bf16 else 1   # bf16 q, k, v, g, out, grads
                    fwd_row.update(
                        **timings(torch, lambda: ra.rel_attention_fwd(
                            q, k, v, ek, ev, lens, **kw),
                            lambda: ra.rel_attention_plain(
                                q, k, v, ek, ev, lens, **kw)),
                        **bound(fl, nb / scale), gflop=fl / 1e9)
                    bwd_row.update(
                        **timings(torch, lambda: ra.rel_attention_bwd(
                            q, k, v, ek, ev, lens, g, out, stats, **kw),
                            lambda: ra.rel_attention_bwd_plain(
                                q, k, v, ek, ev, lens, g, **kw)),
                        **bound(fl3, nb3 / scale), gflop=fl3 / 1e9)
                phase(f"widths_k1{sfx}", **fwd_row)
                phase(f"widths_k3{sfx}", **bwd_row)
                rows[f"rel_attention{sfx}_fwd"].append(fwd_row)
                rows[f"rel_attention{sfx}_bwd"].append(bwd_row)
    return rows


def check_pad_pack(torch, ra, ws, pp, dev) -> list:
    """The padding kernel against its plain version (the same zero pad in
    plain PyTorch; bit for bit, it copies) on the jobs of the main path at
    dk 90 and C 180: K1's q, k, v and emb tables at [4, 640, 180], K3's
    q, k, v, tables, g and out, their cuts back, and K2's x and weights at
    L = 16; device ms beside the plain version's and the bytes bound."""
    gen = torch.Generator(device="cpu").manual_seed(37)
    b, t, c, heads, window, n_layers, k = 4, 640, 180, 2, 4, 16, 5
    dk = c // heads
    big = [torch.randn(b, t, c, generator=gen).to(dev) for _ in range(5)]
    emb = [torch.randn(2 * window + 1, dk, generator=gen).to(dev)
           for _ in range(2)]
    x, w_in, b_in, w_rs, b_rs, g_bias, _ = stack_inputs(
        torch, gen, dev, WIDTH_LENGTHS, t, c, n_layers, k)
    g_all = (b_in[None] + g_bias).contiguous()
    padded = ra.pad_heads(big[:3] + emb, heads, dk)
    cases = (("K1 inputs, dk 90", ra.head_jobs(big[:3] + emb, heads, dk),
              False),
             ("K3 inputs, dk 90", ra.head_jobs(big + emb, heads, dk), False),
             ("K3 results cut, dk 96 -> 90",
              ra.head_jobs(padded, heads, dk, unpack=True), True),
             ("K2 inputs, C 180 L 16",
              ws.channel_jobs(x, w_in, g_all, w_rs, b_rs), False))
    rows = []
    for label, jobs, unpack in cases:
        got = pp.pack(jobs, unpack)
        want = [pp.pack_plain(a, dims, shape, unpack)
                for a, dims, shape in jobs]
        torch.cuda.synchronize()
        for a, r in zip(got, want):
            check(a.shape == r.shape and torch.equal(a, r),
                  f"pad_pack {label}: differs from its plain version")
        nbytes = sum(a.numel() * a.element_size() for a, _, _ in jobs) + sum(
            r.numel() * r.element_size() for r in want)
        times = timings(torch, lambda: pp.pack(jobs, unpack),
                        lambda: [pp.pack_plain(a, dims, shape, unpack)
                                 for a, dims, shape in jobs])
        row = {"shape": label, "jobs": len(jobs), "max_abs_err": 0.0,
               **times, "bound_ms": nbytes / HBM_RATE * 1e3,
               "bound_by": "bytes", "mbytes": nbytes / 1e6}
        phase("widths_pad_pack", **row)
        rows.append(row)
    # the round trip: padded and cut back gives the inputs
    back = ra.pad_heads(padded, heads, dk, unpack=True)
    check(all(torch.equal(a, r) for a, r in zip(back, big[:3] + emb)),
          "pad_pack: pad then cut does not give the inputs back")
    return rows


def widths(torch, ra, ws, pp, dev, root: Path) -> dict:
    """Phase ``widths``: the kernels at head widths that are not a multiple
    of 8 and channel counts that are not a multiple of 32 (``WIDTH_ATTN``,
    ``WIDTH_STACK``, the padding kernel), then an experiment file
    written under ``root`` (``base_config`` the repository's
    ``configs/tpu_run.yaml``, ``hidden_size`` 180, ``num_heads`` 2: dk 90,
    C 180) driven through ``run.main``: ``synth-data``, ``binarize``,
    ``train`` for 4 steps, ``infer`` on one MIDI score and 2 ``train``
    steps with bf16 compute, the launches of each counted; one training
    step and one waveform from the step-4 checkpoint on the card and on
    the CPU; then ``tiny_config`` (hidden 16: dk 8, C 16) on the card, one
    training step and one synthesis request against the CPU.  -> the rows
    and launch counts for the kernels line."""
    import os

    import numpy as np

    from visinger_tpu_torch import run
    from visinger_tpu_torch.config import tiny_config
    from visinger_tpu_torch.config_loader import load_config
    from visinger_tpu_torch.data.dataset import build_dataset
    from visinger_tpu_torch.models.factory import build_model
    from visinger_tpu_torch.training import trainer as trainer_mod
    from visinger_tpu_torch.training.checkpoint import load_checkpoint
    from visinger_tpu_torch.utils.audio.io import load_wav

    t_phase = time.perf_counter()
    rows = check_width_attention(torch, ra, dev)
    rows["wavenet_stack_fwd"] = [
        check_wavenet_stack(torch, ws, dev, n_layers, f"widths_{label}",
                            grads=grads, c=c)
        for label, c, n_layers, grads in WIDTH_STACK]
    rows["pad_pack"] = check_pad_pack(torch, ra, ws, pp, dev)
    kernels_s = time.perf_counter() - t_phase

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    exp = root / "widths.yaml"
    base = str(ROOT / "configs" / "tpu_run.yaml").replace("'", "''")
    exp.write_text(f"# the tpu_run demo at head width 90 and 180 channels\n"
                   f"base_config: '{base}'\n"
                   f"hidden_size: {WIDTH_HIDDEN}\n"
                   f"num_heads: {WIDTH_HEADS}  # dk 90\n")
    cfg = load_config(str(exp))
    check((cfg.hidden_size, cfg.num_heads, cfg.frame_buckets)
          == (WIDTH_HIDDEN, WIDTH_HEADS, (800,)),
          f"widths: the experiment file gave {cfg.hidden_size}, "
          f"{cfg.num_heads}, {cfg.frame_buckets}")
    counts = {}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        run.main(["synth-data", "--config", str(exp)])
        out, _ = captured(lambda: run.main(["binarize", "--config",
                                            str(exp)]))
        check(out["counts"] == PIPELINE_SPLITS,
              f"widths: binarized {out['counts']} != {PIPELINE_SPLITS}")
        (root / "scores").mkdir()
        score = write_scores(root / "scores", cfg, seed=5)["short"]
        for name, argv, steps in (
                ("train", ["train", "-hp", "max_updates=4"], 4),
                ("infer", ["infer", "--midi", score, "--out", "short.wav"],
                 0),
                ("train_bf16", ["train", "-hp",
                                "compute_dtype=bfloat16,max_updates=2,"
                                "work_dir=checkpoints/widths_bf16"], 2)):
            torch.cuda.synchronize()
            zero_width_counts(ra, ws, pp)
            result = run.main([*argv, "--config", str(exp), "--device",
                               str(dev)])
            torch.cuda.synchronize()
            counts[name] = width_counts(ra, ws, pp)
            if steps:
                check(result.step == steps, f"widths: {name} ended at step "
                      f"{result.step}, not {steps}")
            del result
    finally:
        os.chdir(cwd)
    f32 = ("rel_attention_fwd", "rel_attention_bwd", "wavenet_stack_fwd",
           "pad_pack")
    bf16 = ("rel_attention_bf16_fwd", "rel_attention_bf16_bwd",
            "wavenet_stack_fwd", "pad_pack")
    for name, need in (("train", f32), ("train_bf16", bf16),
                       ("infer", ("rel_attention_fwd", "wavenet_stack_fwd",
                                  "pad_pack"))):
        check(all(counts[name][k] > 0 for k in need),
              f"widths: {name} launches {counts[name]} miss one of {need}")
    check(counts["train"]["rel_attention_bf16_fwd"] == 0
          and counts["train_bf16"]["rel_attention_fwd"] == 0,
          f"widths: float32 and bf16 launches mixed: {counts}")
    wav, _ = load_wav(str(root / "short.wav"))
    check(len(wav) > 0 and np.isfinite(wav).all()
          and float(np.std(wav)) > 1e-4,
          f"widths: infer wrote {len(wav)} samples, std {np.std(wav)}")

    # card against CPU: one training step at dk 90 / C 180 (full depth),
    # one waveform from the step-4 checkpoint
    step_row = train_card_vs_cpu(torch, dev, cfg,
                                 tag="widths_train_card_vs_cpu")
    ckpt = load_checkpoint(str(root / cfg.work_dir / "model_ckpt_steps_4.pt"))
    data_cfg = cfg.replace(binary_data_dir=str(root / cfg.binary_data_dir))
    first = next(build_dataset(data_cfg, cfg.test_set_name).batches(
        max_sentences=1, shuffle=False, pad_to_max_sentences=False))
    n_frames = int(first["mel_lengths"][0])
    vocabs = [len(json.loads((root / cfg.binary_data_dir / f"{n}.json"
                              ).read_text()))
              for n in ("phone_set", "pitch_map", "dur_map")]
    wavs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = build_model(cfg, *vocabs, device=d)
        model.load_state_dict(ckpt["model"])
        w, _ = trainer_mod.synthesize(model, first, 0)
        wavs[name] = w[0, : n_frames * cfg.hop_size].cpu().numpy()
        del model
    del ckpt
    wav_err = float(np.abs(wavs["cuda"] - wavs["cpu"]).max())
    wav_peak = float(np.abs(wavs["cpu"]).max())
    check(np.isfinite(wavs["cuda"]).all() and wav_peak > 0
          and wav_err <= TOL_CPU_REL * wav_peak,
          f"widths: card vs CPU test item {wav_err} > {TOL_CPU_REL} x peak "
          f"{wav_peak}")
    shutil.rmtree(root, ignore_errors=True)

    # tiny_config on the card: dk 8 (K1, K3 unpadded) and C 16 (K2 padded)
    tiny = tiny_config()
    zero_width_counts(ra, ws, pp)
    tiny_step = train_card_vs_cpu(torch, dev, tiny,
                                  tag="tiny_train_card_vs_cpu")
    model_cpu = flow_model(torch, tiny, *VOCABS)
    model_dev = build_model(tiny, *VOCABS, device=dev)
    model_dev.load_state_dict(model_cpu.state_dict())
    tiny_wav = wav_card_vs_cpu(torch, tiny, model_dev, model_cpu, dev,
                               tag="tiny_card_vs_cpu")
    counts["tiny"] = width_counts(ra, ws, pp)
    check(all(counts["tiny"][k] > 0 for k in f32[:3] + ("pad_pack",)),
          f"widths: tiny_config launches {counts['tiny']}")
    phase("widths", seconds=time.perf_counter() - t_phase,
          kernel_checks_s=kernels_s, experiment=exp.name,
          hidden_size=WIDTH_HIDDEN, num_heads=WIDTH_HEADS,
          launches=counts, train_card_vs_cpu={
              k: step_row[k] for k in ("max_loss_rel_err",
                                       "max_grad_err_of_peak")},
          card_vs_cpu_frames=n_frames, card_vs_cpu_max_abs_err=wav_err,
          card_vs_cpu_peak=wav_peak, card_vs_cpu_tol=TOL_CPU_REL * wav_peak,
          tiny_train_card_vs_cpu={k: tiny_step[k] for k in (
              "max_loss_rel_err", "max_grad_err_of_peak")},
          tiny_card_vs_cpu=tiny_wav)
    return {"rows": rows, "launches": counts}


def width_entry(rows: list, launches: dict, name: str) -> dict:
    """The widths phase's rows of one kernel for the kernels line: each
    shape's dropout-off times, bound and error, and the launches of the
    experiment file's runs and of ``tiny_config``."""
    keep = ("shape", "ms", "plain_ms", "call_ms", "plain_call_ms",
            "bound_ms", "bound_by", "max_abs_err")
    return {"widths": [{k: r[k] for k in keep if k in r} for r in rows
                       if r.get("dropout", 0.0) == 0.0],
            "widths_max_abs_err": max(r["max_abs_err"] for r in rows),
            "widths_launches": {run: c[name] for run, c in launches.items()}}


def ptxas_functions(log: str) -> list:
    """Each kernel's registers and spill bytes from ``nvcc -Xptxas -v``."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def profile_run(torch, fn, tag: str, kernels=None):
    """Device time by kernel and the device idle share of one ``fn()``;
    ``kernels`` maps a label to a regular expression of kernel names whose
    device time the phase line sums (``kernel_ms``)."""
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
    averages = prof.key_averages()
    table = averages.table(sort_by="self_device_time_total", row_limit=40)
    kernel_ms = {label: sum(getattr(e, "self_device_time_total", 0)
                            for e in averages if re.search(pat, e.key)) / 1e3
                 for label, pat in (kernels or {}).items()}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{tag}.txt").write_text(
        f"wall_ms {wall * 1e3}\ndevice_busy_ms {busy_us / 1e3}\n"
        f"kernels {len(spans)}\n\n{table}\n")
    phase(f"profile_{tag}", wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
          device_kernels=len(spans),
          idle_share=1 - busy_us / 1e3 / (wall * 1e3),
          table=f"chiprun_out/profile_{tag}.txt", kernel_ms=kernel_ms)


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
    from visinger_tpu_torch.config import soak_r5, visinger_csd
    from visinger_tpu_torch.infer.streaming import halo_frames
    from visinger_tpu_torch.ops import cuda_build
    from visinger_tpu_torch.ops import pad_pack as pp
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
    # at the model's shapes: dk = 96, window 4; C = 192, K = 5; the bf16
    # builds at T = 640 (the frame shape) and 1280 (the longest MIDI
    # phrase; K1-bf16's scores take shared memory by T) and the generic
    # build at dk = 64, with each kernel's registers and spills from ptxas
    bf16_info = {f"T {t}, dk {d}": cuda_build.kernel_info(
        "rel_attention_bf16", t, d, 4) for t, d in ((640, 96), (1280, 96),
                                                     (640, 64))}
    phase("kernel_resources",
          rel_attention=cuda_build.kernel_info("rel_attention", 96, 4),
          rel_attention_bf16=bf16_info,
          rel_attention_bf16_ptxas=ptxas_functions(
              logs.get("rel_attention_bf16", "")),
          wavenet_stack=cuda_build.kernel_info("wavenet_stack", 192, 5))

    k1_rows = check_rel_attention(torch, ra, dev)
    k1_drop = check_k1_dropout(torch, ra, dev)
    k3_rows = check_rel_attention_bwd(torch, ra, dev)
    k1b_rows = check_k1_bf16(torch, ra, dev)
    k3b_rows = check_k3_bf16(torch, ra, dev)
    k2_row = check_wavenet_stack(torch, ws, dev, 4, "wavenet_stack")
    k2_post = check_wavenet_stack(torch, ws, dev, 16, "posterior",
                                  grads=True)
    # the streaming decode's window (chunk + 2 halo frames), the last window
    # of a score ragged
    window = visinger_csd().stream_chunk_frames + 2 * halo_frames(
        visinger_csd())
    k2_window = check_wavenet_stack(torch, ws, dev, 4, "stream_window",
                                    t=window, lengths=(window - 30,))
    # a rank's window of time-sharded synthesis (phase scale_out): half of
    # a 1280-frame score and one halo, the last rank's ragged
    sp_window = 1280 // SO_WORLD + halo_frames(visinger_csd())
    k2_sp = check_wavenet_stack(torch, ws, dev, 4, "sp_window", t=sp_window,
                                lengths=(sp_window - 43,))
    train_counts, bare_ms, train_peak = training(torch, ra, ws, dev,
                                                 args.profile)
    train_card_vs_cpu(torch, dev)
    synth_counts = synthesis(torch, ra, ws, dev, args.profile)
    scores_dir = ROOT / "build" / "midi_scores"
    scores_dir.mkdir(parents=True, exist_ok=True)
    midi_counts, stream_window = midi_infer(torch, ra, ws, dev, scores_dir,
                                            args.profile)
    check(stream_window == window, f"streaming window {stream_window} != "
          f"the checked K2 shape's {window}")
    trainer_counts = trainer(torch, ra, ws, dev, ROOT / "build" / "trainer",
                             bare_ms)
    pipeline_counts = pipeline(torch, ra, ws, dev,
                               ROOT / "build" / "pipeline")
    bf16_root = ROOT / "build" / "bf16"
    bf16_train = bf16_phase(torch, ra, ws, dev, bf16_root, bare_ms,
                            train_peak, args.profile)
    train_variants(torch, ra, ws, dev, bf16_root / soak_r5().binary_data_dir)
    shutil.rmtree(bf16_root, ignore_errors=True)
    export_counts = export_phase(torch, ra, ws, dev, ROOT / "build" / "export")
    scale_counts = scale_out(torch, ra, ws, dev, ROOT / "build" / "scale_out")
    width_out = widths(torch, ra, ws, pp, dev, ROOT / "build" / "widths")
    k1_dp = next(r for r in k1_rows if r["shape"].endswith("dp rank"))
    k3_dp = next(r for r in k3_rows if r["shape"].endswith("dp rank")
                 and r["dropout"] > 0)

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
         "pipeline_launches": pipeline_counts["rel_attention_fwd"],
         "trainer_launches": trainer_counts["rel_attention_fwd"],
         "export_launches": export_counts["rel_attention_fwd"],
         "midi_phrase_shape": k1_phrase["shape"],
         "midi_phrase_ms": k1_phrase["ms"],
         "midi_phrase_plain_ms": k1_phrase["plain_ms"],
         "midi_phrase_bound_ms": k1_phrase["bound_ms"],
         "midi_phrase_bound_tc_ms": k1_phrase["bound_tc_ms"],
         "scale_out_launches": {
             "dp_step_per_rank": scale_counts["dp_step_per_rank"][
                 "rel_attention_fwd"],
             "sp_call_per_rank": {n: c["rel_attention_fwd"] for n, c in
                                  scale_counts["sp_call_per_rank"].items()}},
         "dp_rank_shape": k1_dp["shape"], "dp_rank_ms": k1_dp["ms"],
         "dp_rank_plain_ms": k1_dp["plain_ms"],
         "dp_rank_bound_ms": k1_dp["bound_ms"]},
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
         "sdpa_partial_ms": next(
             r["sdpa_partial_ms"] for r in k3_rows
             if r["shape"].endswith("frame") and r["dropout"] == 0.0),
         "bit_identical_rerun": True,
         "pipeline_launches": pipeline_counts["rel_attention_bwd"],
         "trainer_launches": trainer_counts["rel_attention_bwd"],
         "scale_out_launches": {
             "dp_step_per_rank": scale_counts["dp_step_per_rank"][
                 "rel_attention_bwd"], "sp_call_per_rank": 0},
         "dp_rank_shape": f"{k3_dp['shape']}, dropout 0.1",
         "dp_rank_ms": k3_dp["ms"], "dp_rank_plain_ms": k3_dp["plain_ms"],
         "dp_rank_bound_ms": k3_dp["bound_ms"]},
        {"name": "wavenet_stack_fwd", "route": "cuda",
         "source": "visinger_tpu_torch/csrc/wavenet_stack.cu",
         "replaces": "visinger_tpu/ops/pallas/wavenet_kernel.py:115",
         "launches": train_counts["wavenet_stack_fwd"],
         "max_abs_err": max(k2_row["max_abs_err"], k2_post["max_abs_err"],
                            k2_window["max_abs_err"], k2_sp["max_abs_err"]),
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
         "pipeline_launches": pipeline_counts["wavenet_stack_fwd"],
         "trainer_launches": trainer_counts["wavenet_stack_fwd"],
         "export_launches": export_counts["wavenet_stack_fwd"],
         "window_shape": k2_window["shape"], "window_ms": k2_window["ms"],
         "window_plain_ms": k2_window["plain_ms"],
         "window_bound_ms": k2_window["bound_ms"],
         "window_bound_tc_ms": k2_window["bound_tc_ms"],
         "scale_out_launches": {
             "dp_step_per_rank": scale_counts["dp_step_per_rank"][
                 "wavenet_stack_fwd"],
             "sp_call_per_rank": {n: c["wavenet_stack_fwd"] for n, c in
                                  scale_counts["sp_call_per_rank"].items()}},
         "sp_window_shape": k2_sp["shape"], "sp_window_ms": k2_sp["ms"],
         "sp_window_plain_ms": k2_sp["plain_ms"],
         "sp_window_bound_ms": k2_sp["bound_ms"]},
    ]
    k1b = next(r for r in k1b_rows if r["shape"].endswith("frame"))
    k3b = next(r for r in k3b_rows if r["shape"].endswith("frame"))
    for name, rows, row, tpu_line, n in (
            ("rel_attention_bf16_fwd", k1b_rows, k1b, 291,
             bf16_train["rel_attention_bf16_fwd"]),
            ("rel_attention_bf16_bwd", k3b_rows, k3b, 250,
             bf16_train["rel_attention_bf16_bwd"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "visinger_tpu_torch/csrc/rel_attention_bf16.cu",
            "replaces": f"visinger_tpu/ops/pallas/attention_kernel.py:"
                        f"{tpu_line}",
            "launches": n,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "err_of_peak": max(r.get("err_of_peak", 0.0) for r in rows)
            if name.endswith("fwd") else max(
                max(r["errs_of_peak"].values()) for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
            "f32_ms": row["f32_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "sdpa_partial_ms": row.get("sdpa_bf16_ms",
                                       row.get("sdpa_partial_ms")),
            "shape": f"{row['shape']} bf16",
            # device ms at every other shape, dropout off
            "shapes_ms": {r["shape"]: r["ms"] for r in rows
                          if r["dropout"] == 0.0}})
    next(k for k in kernels if k["name"] == "rel_attention_bf16_fwd")[
        "export_launches"] = export_counts["rel_attention_bf16_fwd"]
    for k in kernels:
        k.update(width_entry(width_out["rows"][k["name"]],
                             width_out["launches"], k["name"]))
    pad = width_out["rows"]["pad_pack"][0]     # K1's inputs at dk 90
    kernels.append({
        "name": "pad_pack", "route": "cuda",
        "source": "visinger_tpu_torch/csrc/pad_pack.cu",
        "replaces": "visinger_tpu/modules/transformer.py:98",
        "launches": width_out["launches"]["train"]["pad_pack"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in width_out["rows"]["pad_pack"]),
        "ms": pad["ms"], "plain_ms": pad["plain_ms"],
        "call_ms": pad["call_ms"], "plain_call_ms": pad["plain_call_ms"],
        "bound_ms": pad["bound_ms"], "bound_by": pad["bound_by"],
        "library_ms": None, "shape": pad["shape"],
        "also_replaces": "visinger_tpu/ops/pallas/wavenet_kernel.py:140",
        "shapes": {r["shape"]: {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "mbytes")}
            for r in width_out["rows"]["pad_pack"]},
        "widths_launches": {run: c["pad_pack"] for run, c in
                            width_out["launches"].items()}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
