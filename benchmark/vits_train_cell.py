"""A ``vits_train`` cell: ``TrainStep.__call__`` of the port on its VITS
model (``models/vits.py``), step after step, on a pool of padded batches
held on the device.

Traffic.  The mix names a frame range and a token share a frame; the set
of (frames, tokens) is ``traffic.length_set``'s, the same for every seed,
with the token count made odd (n symbols drawn from 1 .. vocab - 1,
interleaved with the blank 0: 2n + 1 tokens, as upstream's ``add_blank``
gives them).  The set is sorted by length and cut into consecutive batches of
``batch`` items (as the bucket sampler's boundaries group them), each
padded to its own longest item (as ``TextAudioCollate`` pads), visited in
a seed-made order.  Each waveform is a tone on a pitch per symbol with
noise.  The seed changes the order and every symbol, boundary, pitch,
sample and noise draw.

Set-up, the window and the trace are ``train_cell.py``'s.  The checked
steps also record the program's cost matrix, lengths and path of every
alignment (``Alignments``, around ``ops/mas.py::maximum_path``); after the window the
reference (``reference/vits.py``) follows the checked steps from the same
weights, batches, draws and generator seed, and the plain MAS
(``reference/mas.py``) is run on the program's own costs:
``mas_path_mismatch`` counts the valid frames whose token differs."""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

import correct
import counters_vits
import readers
import traffic
import weights
import train_cell
from train_cell import Unit, record_checked

BLANK = 0


def vits_pool(mix: dict, cfg, seed: int) -> tuple[list, list]:
    """(the pool's numpy batches in visiting order, each batch's slice
    starts)."""
    b, n_batches = mix["batch"], mix["pool_batches"]
    lengths = traffic.length_set(mix, b * n_batches)
    rng = traffic.seed_rng(seed, 1)
    hop, sr, vocab = cfg.hop_size, cfg.sample_rate, cfg.vocabs[0]
    batches, starts = [], []
    for j in rng.permutation(n_batches):
        group = [lengths[j * b + i] for i in rng.permutation(b)]
        n_max = max(2 * ((n - 1) // 2) + 1 for _, n in group)
        t_max = max(f for f, _ in group)
        batch = {"text_tokens": np.zeros((b, n_max), np.int32),
                 "text_lengths": np.zeros((b,), np.int32),
                 "wavs": np.zeros((b, t_max * hop), np.float32),
                 "mel_lengths": np.zeros((b,), np.int32)}
        for i, (f, n) in enumerate(group):
            syms = max((n - 1) // 2, 1)
            tokens = np.full(2 * syms + 1, BLANK, np.int32)
            tokens[1::2] = rng.integers(1, vocab, syms)
            batch["text_tokens"][i, :len(tokens)] = tokens
            batch["text_lengths"][i] = len(tokens)
            batch["mel_lengths"][i] = f
            cuts = np.sort(rng.choice(np.arange(1, f), syms - 1,
                                      replace=False))
            per = np.diff(np.concatenate([[0], cuts, [f]]))
            hz = np.repeat(110.0 * 2 ** (rng.standard_normal(syms) / 6), per)
            phase = 2 * np.pi * np.cumsum(np.repeat(hz, hop)) / sr
            batch["wavs"][i, :f * hop] = (
                0.3 * np.sin(phase)
                + 0.01 * rng.standard_normal(f * hop)).astype(np.float32)
        u = rng.random(b)
        ids_max = np.maximum(batch["mel_lengths"] - cfg.segment_size + 1, 1)
        batches.append(batch)
        starts.append((u * ids_max).astype(np.int64))
    return batches, starts


class Alignments:
    """``ops/mas.py::maximum_path`` as the program calls it, recording each
    call's costs, lengths and path on the host (during the checked
    steps)."""

    def __init__(self, maximum_path):
        self.maximum_path = maximum_path
        self.calls = []

    def __call__(self, cost, t_x, t_y):
        host = cost.detach().cpu().numpy()
        path = self.maximum_path(cost, t_x, t_y)
        self.calls.append((host, np.asarray(t_x), np.asarray(t_y),
                           path.cpu().numpy()))
        return path

    def mismatch(self) -> int:
        """Valid frames whose token differs from the plain MAS's on the
        same costs."""
        from reference import mas as rmas

        wrong = 0
        for cost, t_x, t_y, path in self.calls:
            for i in range(len(t_x)):
                ref = rmas.tokens_of(rmas.path_each(cost[i], int(t_y[i]),
                                                    int(t_x[i])))
                wrong += int((ref != path[i, :t_y[i]]).sum())
        return wrong


class Prepared:
    """The port's training step on its VITS model, its state and the pool,
    on the device."""

    def __init__(self, rt):
        from visinger_tpu_torch.models.factory import build_models
        from visinger_tpu_torch.training.train_state import \
            create_train_state
        from visinger_tpu_torch.training.train_step import make_train_step

        cfg, bcfg, dev = rt.cfg, rt.bcfg, rt.device
        self.model, self.disc = build_models(cfg, *bcfg.vocabs, device=dev,
                                             seed=0)
        weights.fill(rt.seed, model=self.model, disc=self.disc)
        self.gen_seed = rt.stream_seed(1)
        self.state = create_train_state(self.model, self.disc,
                                        seed=self.gen_seed)
        self.step = make_train_step(cfg, self.model, self.disc, device=dev)
        self.n_params = sum(p.numel() for p in self.model.parameters()) \
            + sum(p.numel() for p in self.disc.parameters())
        self.leaf_names = {
            "g": [n for n, _ in self.model.named_parameters()],
            "d": [n for n, _ in self.disc.named_parameters()]}
        self.batches, starts = vits_pool(rt.mix, bcfg, rt.seed)
        self.pool = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                     for b in self.batches]
        noise = torch.Generator(device=dev).manual_seed(rt.stream_seed(2))
        self.eps = [torch.randn((b["wavs"].shape[0],
                                 b["wavs"].shape[1] // cfg.hop_size,
                                 cfg.hidden_size), generator=noise,
                                device=dev) for b in self.batches]
        self.ids = [torch.from_numpy(s).to(dev) for s in starts]
        self.beta1 = cfg.optimizer_adam_beta1
        self.hop = cfg.hop_size
        self.alignments = None

    def unit(self, i: int) -> Unit:
        b = self.batches[i % len(self.batches)]
        return Unit(b["text_tokens"].shape[1], b["wavs"].shape[1] // self.hop,
                    b["text_lengths"], b["mel_lengths"])

    def run_step(self, i: int) -> dict:
        j = i % len(self.pool)
        self.state, m = self.step(self.state, self.pool[j],
                                  eps_q=self.eps[j], ids_slice=self.ids[j])
        return m

    def checked(self, seed: int, n_steps: int) -> dict:
        """The checked steps 0 .. n_steps - 1 and their record, their
        alignments kept."""
        from visinger_tpu_torch.ops import mas

        real = mas.maximum_path
        mas.maximum_path = self.alignments = Alignments(real)
        try:
            return record_checked(
                self.run_step, seed, {"model": self.model,
                                      "disc": self.disc},
                self.beta1, n_steps,
                lambda: {"g": self.state.opt_state_g.mu,
                         "d": self.state.opt_state_d.mu})
        finally:
            mas.maximum_path = real

    def reference(self, bcfg, seed: int, n_steps: int,
                  control: str | None = None) -> dict:
        """The reference through the checked steps, its alignments held
        to the program's paths at ties."""
        return reference(bcfg, seed, self.gen_seed, self.batches[:n_steps],
                         self.eps[:n_steps], self.ids[:n_steps],
                         self.eps[0].device, control,
                         [c[3] for c in self.alignments.calls])

    def free_program(self) -> None:
        del self.step, self.state, self.model, self.disc, self.pool
        gc.collect()


def numbers(p: Prepared, rec: dict, ref: dict) -> dict:
    """``correct.train_numbers``, ``mas_path_mismatch``, and (not
    judged) ``ref_path_frames``: the valid frames where the reference's
    own path, on its own costs and held to the program's at ties, leaves
    the program's; ``ref_split_gap``: the largest relative gap of a
    decision where the reference's own choice left the program's, held
    to it or not (0 where none did)."""
    apart = 0
    for (_, _, t_y, path), theirs in zip(p.alignments.calls,
                                         ref.get("paths", [])):
        for i, n in enumerate(t_y):
            apart += int((theirs[i, :n].numpy() != path[i, :n]).sum())
    return {**correct.train_numbers(rec, ref),
            "mas_path_mismatch": float(p.alignments.mismatch()),
            "ref_path_frames": float(apart),
            "ref_split_gap": max(ref.get("splits") or [0.0])}


def run(rt) -> dict:
    from visinger_tpu_torch.ops import rel_attention as ra
    from visinger_tpu_torch.ops import wavenet_stack as ws

    bcfg = rt.bcfg
    p = Prepared(rt)
    batches, n_pool = p.batches, len(p.batches)
    frames = [int(b["mel_lengths"].sum()) for b in batches]
    flops = [counters_vits.train_step_flops(
        bcfg, b["text_tokens"].shape[0], b["text_tokens"].shape[1],
        b["wavs"].shape[1] // bcfg.hop_size, p.n_params) for b in batches]
    n_checked = rt.mix["checked_steps"]
    rec = p.checked(rt.seed, n_checked)
    done = n_checked
    seen = {batches[i % n_pool]["wavs"].shape
            + batches[i % n_pool]["text_tokens"].shape
            for i in range(n_checked)}
    for i in range(n_checked, n_pool):                   # warm-up
        shape = batches[i]["wavs"].shape + batches[i]["text_tokens"].shape
        if shape not in seen:
            seen.add(shape)
            p.run_step(i)
            done = i + 1
    rt.synchronize()
    rt.reset_peak()
    setup_s = rt.process_age()

    # the window
    losses, n_frames, n_flops, n_steps = [], 0, 0.0, 0
    t0 = time.perf_counter()
    while True:
        i = done + n_steps
        m = p.run_step(i)
        losses.append(torch.stack([m["total_g"], m["disc"]]))
        n_frames += frames[i % n_pool]
        n_flops += flops[i % n_pool]
        n_steps += 1
        if time.perf_counter() - t0 >= rt.seconds:
            break
    rt.synchronize()
    window = time.perf_counter() - t0

    reading = readers.Reading("train", bcfg)
    reading.mfu_flops, reading.mfu_seconds = n_flops, window
    if rt.trace:
        at = done + n_steps
        units = rt.mix.get("traced_steps", 2)

        def launches():
            return (ra.launches + ra.launches_bf16,
                    ra.bwd_launches + ra.bwd_launches_bf16, ws.launches)

        before = launches()
        # through train_cell's name, so that span_report.capture sees it
        reading.trace = train_cell.profile(
            torch, lambda: [p.run_step(at + u) for u in range(units)], units,
            rt.on_cuda())
        counts = [b - a for a, b in zip(before, launches())]
        reading.traced = [p.unit(at + u) for u in range(units)]
        attn = bcfg.enc_layers
        reading.launch_check(counts, [attn * units, attn * units,
                                      (1 + bcfg.flow_n_flows) * units],
                             ("K1", "K3", "K2"))
        reading.syncs = train_cell.sync_count(
            torch, lambda: p.run_step(at + units), rt.on_cuda())
        reading.sync_units = 1 if rt.on_cuda() else 0
    peak_bytes = rt.peak_bytes()
    stacked = torch.stack(losses).cpu()
    failed = int((~torch.isfinite(stacked).all(dim=1)).sum())

    p.free_program()
    rt.empty_cache()
    ref = p.reference(bcfg, rt.seed, n_checked)
    return {"attempted": n_steps, "failed": failed,
            "numbers": numbers(p, rec, ref),
            "e2e": {"train_frames_per_s": n_frames / window,
                    "setup_s": setup_s},
            "reading": reading, "peak_bytes": peak_bytes}


def reference(bcfg, seed: int, gen_seed: int, batches, eps, ids, device,
              control: str | None = None, hints=None) -> dict:
    """The plain reference through the checked steps from the seed-made
    weights; with ``control`` "tf32" its products in TF32 (the control);
    ``hints``: the program's path of each step, which the reference's
    alignment follows at ties (``reference/mas.py``)."""
    from reference import discriminator as rdisc
    from reference import train as rtrain
    from reference import vits as rvits

    rcfg = bcfg.reference()
    with torch.device(device):
        model = rvits.VITS(rcfg, bcfg.vocabs[0])
        disc = rdisc.MultiPeriodDiscriminator(
            tuple(rcfg.disc_periods), rcfg.disc_s_base,
            tuple(rcfg.disc_p_channels), rcfg.disc_pair_batch,
            rcfg.use_spectral_norm)
    weights.fill(seed, model=model, disc=disc)
    state = rtrain.ref_state(model, disc, gen_seed)
    step = rvits.RefVITSStep(rcfg, model, disc, device)
    tf32 = control == "tf32"
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        rec = record_checked(
            lambda i: step(state, batches[i], eps[i], ids[i],
                           None if hints is None else hints[i]), seed,
            {"model": model, "disc": disc}, rcfg.optimizer_adam_beta1,
            len(batches),
            lambda: {"g": state.opt_state_g.mu, "d": state.opt_state_d.mu})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    rec["paths"], rec["splits"] = step.paths, step.splits
    return rec


def readings(spec, cell, seed, control: bool) -> dict:
    """``calibrate.py``'s readings of this kind for one seed: the program's
    numbers and, with ``control``, the TF32 control's and the fault "half
    of the batch left out"."""
    import run

    rt = run.Runtime(cell, seed, 0.0, False, "cuda", spec)
    n = rt.mix["checked_steps"]
    p = Prepared(rt)
    rec = p.checked(seed, n)
    p.free_program()
    rt.empty_cache()
    ref = p.reference(rt.bcfg, seed, n)
    out = {"program": numbers(p, rec, ref)}
    print(json.dumps({"seed": seed, "detail": {
        "step_loss_gaps": correct.step_loss_gaps(rec["losses"],
                                                 ref["losses"]),
        **{key: correct.worst_leaves(rec, ref, p.leaf_names, key)
           for key in ("grad", "update")}}}), file=sys.stderr)
    if control:
        ctl = p.reference(rt.bcfg, seed, n, "tf32")
        out["control"] = correct.train_numbers(ctl, ref)
        halved = reference(
            rt.bcfg, seed, p.gen_seed,
            [{k: v[: v.shape[0] // 2] for k, v in b.items()}
             for b in p.batches[:n]],
            [e[: e.shape[0] // 2] for e in p.eps[:n]],
            [i[: i.shape[0] // 2] for i in p.ids[:n]], rt.device)
        out["half_batch"] = correct.train_numbers(halved, ref)
    return out
