#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of VISinger synthesis on one CUDA card.

    python3 chip_smoke.py              # the check (one card)
    python3 chip_smoke.py --profile    # also write a torch.profiler summary
                                       # of one synthesis group to
                                       # chiprun_out/profile_synthesis.txt

Phases, each printing a line; any failure raises and exits nonzero:
  1. the card's name and power limit (nvidia-smi); TF32 off for matmuls and
     convolutions (every comparison below is float32);
  2. build both CUDA kernels from ``visinger_tpu_torch/csrc`` (one nvcc
     each, in parallel);
  3. K1 (relative attention) against its plain version at the frame-rate
     shape [4, 640, 192] and the token-rate shape [4, 192, 192], 2 heads,
     ragged lengths; kernel / plain times (CUDA events, median of 30) and
     the bound;
  4. K2 (WaveNet stack) likewise at the flow shape x [4, 640, 192], L=4;
  5. full-width ``visinger_csd`` synthesis with seeded weights (flow
     ``post`` set nonzero so K2's output matters): 8 token requests of up to
     640 frames / 192 tokens through ``TorchSynthesizer`` in groups of 4,
     with the launch counts per group (K1 16, K2 4), wall time per group,
     audio-s/s and peak memory; then one short request (B=1, T=160) on the
     card and on the CPU with the same weights and eps, which must agree;
  6. a ``kernels`` JSON line, then the final ``{"ok": true, ...}`` line.

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
HBM_RATE = 3.35e12    # H100 SXM device-memory bytes/s
TOL_KERNEL = 1e-4
# card vs CPU waveform: max abs err <= TOL_CPU_REL * max|wav|; the random
# weights give a waveform of ~1e-2 amplitude, so an absolute limit would
# hide a fault of a few percent
TOL_CPU_REL = 1e-4
VOCABS = (60, 117, 98)   # as bench.py's synthesis benchmark


def phase(tag: str, /, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Median over ``iters`` launches, each between two CUDA events."""
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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


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


def check_rel_attention(torch, ra, dev):
    """K1 against its plain version at the frame and token shapes."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    c, heads, window = 192, 2, 4
    dk = c // heads
    rows = []
    for label, t, lengths in (("frame", 640, [640, 600, 517, 333]),
                              ("token", 192, [192, 180, 151, 97])):
        q, k, v = (torch.randn(4, t, c, generator=gen).to(dev)
                   for _ in range(3))
        ek, ev = (torch.randn(2 * window + 1, dk, generator=gen).mul(
            dk ** -0.5).to(dev) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(window=window, scale=dk ** -0.5)
        out = ra.rel_attention_fwd(q, k, v, ek, ev, lens, **kw)
        ref = ra.rel_attention_plain(q, k, v, ek, ev, lens, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(bool(torch.isfinite(out).all()), f"K1 {label}: non-finite")
        check(err <= TOL_KERNEL, f"K1 {label}: max abs err {err} > {TOL_KERNEL}")
        ms = time_ms(torch, lambda: ra.rel_attention_fwd(q, k, v, ek, ev, lens,
                                                          **kw))
        plain_ms = time_ms(torch, lambda: ra.rel_attention_plain(
            q, k, v, ek, ev, lens, **kw))
        flops, nbytes = k1_work(lengths, t, c, heads, window)
        b_ms, b_by = bound_ms(flops, nbytes)
        row = {"shape": f"[4, {t}, {c}] {label}", "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
        phase("k1_rel_attention", **row)
        rows.append(row)
    return rows


def check_wavenet_stack(torch, ws, dev):
    """K2 against its plain version at the flow-coupling shape."""
    gen = torch.Generator(device="cpu").manual_seed(2)
    b, t, c, n_layers, k = 4, 640, 192, 4, 5

    def u(*shape, bound):
        return (torch.rand(*shape, generator=gen) * 2 - 1).mul(bound).to(dev)

    lengths = [640, 600, 517, 333]
    mask = ragged_mask(torch, lengths, t, dev)
    x = torch.randn(b, t, c, generator=gen).to(dev) * mask
    w_in = u(n_layers, k, c, 2 * c, bound=(k * c) ** -0.5)
    b_in = u(n_layers, 2 * c, bound=(k * c) ** -0.5)
    w_rs = u(n_layers, c, 2 * c, bound=c ** -0.5)
    b_rs = u(n_layers, 2 * c, bound=c ** -0.5)
    g_bias = u(b, n_layers, 2 * c, bound=0.5)
    args = (x, w_in, b_in, w_rs, b_rs, g_bias, mask)
    out = ws.wavenet_stack_fwd(*args)
    ref = ws.wavenet_stack_plain(*args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()), "K2: non-finite")
    check(err <= TOL_KERNEL, f"K2: max abs err {err} > {TOL_KERNEL}")
    ms = time_ms(torch, lambda: ws.wavenet_stack_fwd(*args))
    plain_ms = time_ms(torch, lambda: ws.wavenet_stack_plain(*args))
    flops, nbytes = k2_work(lengths, t, c, n_layers, k)
    b_ms, b_by = bound_ms(flops, nbytes)
    row = {"shape": f"x [{b}, {t}, {c}] L={n_layers} K={k}",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
           "mbytes": nbytes / 1e6}
    phase("k2_wavenet_stack", **row)
    return row


def requests_from(batch, n):
    return [{k: batch[k][i:i + 1, :batch[lk][i]]
             for k, lk in (("text_tokens", "text_lengths"),
                           ("note_pitch", "text_lengths"),
                           ("note_dur", "text_lengths"),
                           ("mel2ph", "mel_lengths"))}
            for i in range(n)]


def synthesis(torch, ra, ws, dev, profile: bool):
    from visinger_tpu_torch.config import visinger_csd
    from visinger_tpu_torch.data.synthetic import synthetic_batch
    from visinger_tpu_torch.infer.infer import TorchSynthesizer
    from visinger_tpu_torch.models.factory import build_model

    cfg = visinger_csd()
    model_cpu = build_model(cfg, *VOCABS, device="cpu", seed=0)
    gen = torch.Generator(device="cpu").manual_seed(3)
    with torch.no_grad():  # post is zero at init: make the flow non-trivial
        for i in range(cfg.flow_n_flows):
            post = getattr(model_cpu.flow, f"coupling_{i}").post
            post.weight.copy_(torch.randn(post.weight.shape, generator=gen)
                              * 0.02)
    synth = TorchSynthesizer(cfg, copy.deepcopy(model_cpu), device=dev)
    batch = synthetic_batch(8, 192, 640, *VOCABS, hop_size=cfg.hop_size,
                            seed=0)
    requests = requests_from(batch, 8)
    synth.synthesize_batch(requests, seed=0)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    passes = 3
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
        profile_group(torch, synth, requests[:4])

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


def profile_group(torch, synth, requests):
    """Device time by kernel for one synthesis group of 4."""
    from torch.profiler import ProfilerActivity, profile

    from visinger_tpu_torch.infer.infer import collate

    batch, _ = collate(requests)
    synth.synthesize(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth.synthesize(batch)
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
                                      row_limit=30)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_synthesis.txt").write_text(
        f"wall_ms {wall * 1e3}\ndevice_busy_ms {busy_us / 1e3}\n"
        f"kernels {len(spans)}\n\n{table}\n")
    phase("profile", wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
          device_kernels=len(spans), idle_share=1 - busy_us / 1e3 / (wall * 1e3),
          table="chiprun_out/profile_synthesis.txt")


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
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    phase("build", seconds=build_s, ptxas=ptxas)

    k1_rows = check_rel_attention(torch, ra, dev)
    k2_row = check_wavenet_stack(torch, ws, dev)
    counts = synthesis(torch, ra, ws, dev, args.profile)

    k1 = k1_rows[0]  # the frame-rate shape: 10 of the 16 layers
    kernels = [
        {"name": "rel_attention_fwd", "route": "cuda",
         "source": "visinger_tpu_torch/csrc/rel_attention.cu",
         "replaces": "visinger_tpu/ops/pallas/attention_kernel.py:291",
         "launches": counts["rel_attention_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None, "shape": k1["shape"]},
        {"name": "wavenet_stack_fwd", "route": "cuda",
         "source": "visinger_tpu_torch/csrc/wavenet_stack.cu",
         "replaces": "visinger_tpu/ops/pallas/wavenet_kernel.py:115",
         "launches": counts["wavenet_stack_fwd"],
         "max_abs_err": k2_row["max_abs_err"],
         "ms": k2_row["ms"], "plain_ms": k2_row["plain_ms"],
         "bound_ms": k2_row["bound_ms"], "bound_by": k2_row["bound_by"],
         "library_ms": None, "shape": k2_row["shape"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
