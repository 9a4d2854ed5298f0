"""A ``train`` cell: ``TrainStep.__call__`` of the port, step after step,
on a pool of padded batches held on the device, as the trainer's device
store holds a split.

Set-up builds the models, gives them the seed-made weights, builds the
state and the step (one object), makes the pool, and drives the first
``checked_steps`` steps through the window's own call on pool batches that
all differ, recording what the reference is held to; then one step of each
padded shape not yet run.  The window runs steps until ``--seconds`` have
passed and ends at the synchronisation after the last step.  The
reference then follows the checked steps from the same weights, batches,
draws and generator seed."""

from __future__ import annotations

import gc
import time

import torch

import correct
import counters
import lowp
import readers
import traffic
import weights
from tracing import profile, sync_count


class Unit:
    """The shapes of one traced step or call."""

    def __init__(self, n, t, token_lengths, frame_lengths):
        self.n, self.t = int(n), int(t)
        self.token_lengths = [int(x) for x in token_lengths]
        self.frame_lengths = [int(x) for x in frame_lengths]


def _unit(batch: dict) -> Unit:
    return Unit(batch["text_tokens"].shape[1], batch["mel2ph"].shape[1],
                batch["text_lengths"], batch["mel_lengths"])


def record_checked(step_fn, seed: int, prefix_modules: dict, beta1: float,
                   n_steps: int, mu_of) -> dict:
    """Run ``n_steps`` checked steps with ``step_fn(i) -> metrics`` and
    return the losses, the first step's gradient norms (from the first
    moment after it, over 1 - beta1) and the change of every leaf."""
    rec = {"losses": []}
    for i in range(n_steps):
        m = step_fn(i)
        rec["losses"].append({k: float(m[k]) for k in ("total_g", "disc")})
        if i == 0:
            rec["grad"] = {k: [v / (1.0 - beta1) for v in
                               correct.leaf_norms(mu)]
                           for k, mu in mu_of().items()}
    shapes = weights.leaf_shapes(*prefix_modules.items())
    device = next(next(iter(prefix_modules.values())).parameters()).device
    p0 = weights.draw(shapes, seed, device)
    rec["update"] = {}
    for key, (prefix, module) in zip(("g", "d"), prefix_modules.items()):
        rec["update"][key] = correct.leaf_norms(
            [p.detach().float() - p0[f"{prefix}.{n}"]
             for n, p in module.named_parameters()])
    del p0
    return rec


class Prepared:
    """The port's training step, its state and the pool, on the device."""

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
        self.batches, starts = traffic.train_pool(rt.mix, bcfg, bcfg.vocabs,
                                                  rt.seed)
        self.pool = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                     for b in self.batches]
        noise = torch.Generator(device=dev).manual_seed(rt.stream_seed(2))
        self.eps = [torch.randn((b["mel2ph"].shape[0], b["mel2ph"].shape[1],
                                 cfg.hidden_size), generator=noise,
                                device=dev) for b in self.batches]
        self.ids = [torch.from_numpy(s).to(dev) for s in starts]
        self.beta1 = cfg.optimizer_adam_beta1

    def run_step(self, i: int) -> dict:
        j = i % len(self.pool)
        self.state, m = self.step(self.state, self.pool[j],
                                  eps_q=self.eps[j], ids_slice=self.ids[j])
        return m

    def checked(self, seed: int, n_steps: int) -> dict:
        """The checked steps 0 .. n_steps - 1 and their record."""
        return record_checked(
            self.run_step, seed, {"model": self.model, "disc": self.disc},
            self.beta1, n_steps, lambda: {"g": self.state.opt_state_g.mu,
                                          "d": self.state.opt_state_d.mu})

    def reference(self, bcfg, seed: int, n_steps: int,
                  control: str | None = None) -> dict:
        return reference(bcfg, seed, self.gen_seed, self.batches[:n_steps],
                         self.eps[:n_steps], self.ids[:n_steps],
                         self.eps[0].device, control)

    def free_program(self) -> None:
        del self.step, self.state, self.model, self.disc, self.pool
        gc.collect()


def run(rt) -> dict:
    from visinger_tpu_torch.ops import rel_attention as ra
    from visinger_tpu_torch.ops import wavenet_stack as ws

    bcfg = rt.bcfg
    p = Prepared(rt)
    batches, n_pool = p.batches, len(p.batches)
    frames = [int(b["mel_lengths"].sum()) for b in batches]
    flops = [counters.train_step_flops(bcfg, *b["text_tokens"].shape,
                                       b["mel2ph"].shape[1], p.n_params)
             for b in batches]
    n_checked = rt.mix["checked_steps"]
    rec = p.checked(rt.seed, n_checked)
    done = n_checked
    seen = {batches[i]["mel2ph"].shape + batches[i]["text_tokens"].shape
            for i in range(n_checked)}
    for i in range(n_checked, n_pool):                   # warm-up
        shape = batches[i]["mel2ph"].shape + batches[i]["text_tokens"].shape
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
        reading.trace = profile(
            torch, lambda: [p.run_step(at + u) for u in range(units)], units,
            rt.on_cuda())
        counts = [b - a for a, b in zip(before, launches())]
        reading.traced = [_unit(batches[(at + u) % n_pool])
                          for u in range(units)]
        tok, frame = readers.attention_layers(bcfg)
        attn = tok + frame + (bcfg.phoneme_predictor_layers
                              if bcfg.use_phoneme_pred else 0)
        reading.launch_check(counts, [attn * units, attn * units,
                                      (1 + bcfg.flow_n_flows) * units],
                             ("K1", "K3", "K2"))
        reading.syncs = sync_count(torch, lambda: p.run_step(at + units),
                                   rt.on_cuda())
        reading.sync_units = 1 if rt.on_cuda() else 0
    peak_bytes = rt.peak_bytes()
    stacked = torch.stack(losses).cpu()
    failed = int((~torch.isfinite(stacked).all(dim=1)).sum())

    p.free_program()
    rt.empty_cache()
    numbers = correct.train_numbers(rec, p.reference(bcfg, rt.seed,
                                                     n_checked))
    return {"attempted": n_steps, "failed": failed, "numbers": numbers,
            "e2e": {"train_frames_per_s": n_frames / window,
                    "setup_s": setup_s},
            "reading": reading, "peak_bytes": peak_bytes}


def reference(bcfg, seed: int, gen_seed: int, batches, eps, ids, device,
              control: str | None = None) -> dict:
    """The plain reference through the checked steps from the seed-made
    weights; with ``control`` "tf32" or "fp8" its products in that lower
    precision (the control)."""
    from reference import discriminator as rdisc
    from reference import train as rtrain
    from reference import visinger as rvis

    rcfg = bcfg.reference()
    with torch.device(device):
        model = rvis.VISinger(rcfg, *bcfg.vocabs)
        disc = rdisc.MultiPeriodDiscriminator(
            tuple(rcfg.disc_periods), rcfg.disc_s_base,
            tuple(rcfg.disc_p_channels), rcfg.disc_pair_batch,
            rcfg.use_spectral_norm)
    weights.fill(seed, model=model, disc=disc)
    state = rtrain.ref_state(model, disc, gen_seed)
    step = rtrain.RefTrainStep(
        rcfg, model, disc, device,
        lowp.Fp8Products if control == "fp8" else None)
    tf32 = control == "tf32"
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        rec = record_checked(
            lambda i: step(state, batches[i], eps[i], ids[i]), seed,
            {"model": model, "disc": disc}, rcfg.optimizer_adam_beta1,
            len(batches),
            lambda: {"g": state.opt_state_g.mu, "d": state.opt_state_d.mu})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return rec
