"""The GAN train step of VISinger (counterpart of the JAX package's
``training/train_step.py``) and of VITS (``cfg.model`` "vits": the batch's
text tokens, their lengths, the waveform and its frame count go to
``models/vits.py``, whose duration loss ``dur`` joins the sum; no pitch,
uv or CTC term; one process), in the JAX step's update order:

  1. the generator loss against the discriminator from before this step's
     update (its parameters take no gradient), the generator's AdamW update
     and ``gnorm_g``, its gradients' norm before the clip (the update's own
     norm; under accumulation the micro-batch's);
  2. the discriminator loss on the real slice and the detached fake from the
     same forward, then its AdamW update, gated by ``disc_start_steps`` /
     ``disc_interval`` on the optimizer step: a gated-off step leaves the
     discriminator's parameters and its Adam state untouched.

The linear spectrogram is computed from the waveform, without gradient,
unless the batch carries ``spec``.  Every random draw (posterior noise,
slice starts, dropout masks, attention-dropout seeds) comes from the
state's generator; ``eps_q`` and ``ids_slice`` may be passed in instead, so
that a test can give the port the JAX step's draws.  A ``use_spk_embed``
batch carries ``spk_embed`` [B, 256].

``accumulate_grad_batches`` = k: ``state.step`` counts micro-batches and
``state.step // k`` (the optimizer step) drives the KL warm-up and the
discriminator's gates; each optimizer averages k micro-batches' gradients
before its one update (``ClippedAdamW.step``).

``remat_policy`` (the JAX step's ``jax.checkpoint`` of its two loss
functions): "full" recomputes the generator's and the discriminator's loss
functions in the backward (``torch.utils.checkpoint``), "dots" does so but
keeps the matrix products' outputs (selective checkpointing).  The
recompute restores the state's generator to where the forward started, so
it draws the same noise, slices and dropout masks and the gradients are
those of "none".

Data parallelism (``parallel/``): under a process group each rank passes
its rows of the global batch.  Every loss divides the rank's masked sum by
the global count: the step computes every count from the batch and the
slice starts before its forward and sums them over the ranks in one
collective (``global_counts``), and after the forward one more sums the KL
for its ``kl_min`` clamp; the model and the losses call no collective, so
the recompute of "full" or "dots" issues none.  The gradients are summed
over the ranks before ``gnorm_g``, the clip and each optimizer (once per
micro-batch under accumulation), and the metrics are summed over the ranks,
so every rank holds the global step's metrics and makes the same update.
With more than one rank, ``eps_q`` and ``ids_slice`` (when not given) are
drawn at the global batch's shape from the state's generator, which every
rank holds in the same state, and the rank keeps its rows: with dropout
off the step is the 1-process step on the global batch.  Dropout masks and
attention-dropout seeds come from a generator of the rank's own
(``rank_generator``: seeded from the seed, the step and the rank), so no
two ranks drop the same entries of their items.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from visinger_tpu_torch.config import Config, check_supported
from visinger_tpu_torch.models.factory import resolve_device
from visinger_tpu_torch.ops.clipped_adamw import global_norm
from visinger_tpu_torch.ops.masking import slice_segments, slice_starts
from visinger_tpu_torch.ops.stft import (STFTParams, linear_spectrogram,
                                         log_mel_slices,
                                         log_mel_spectrogram,
                                         power_spectrogram)
from visinger_tpu_torch.parallel import mesh
from visinger_tpu_torch.training import losses as L
from visinger_tpu_torch.training.train_state import (TrainState,
                                                     make_optimizers)
from visinger_tpu_torch.utils.meters import span


def device_batch(batch: dict, device: torch.device) -> dict:
    """The batch as tensors on ``device``: float arrays as float32, int16
    ``wavs`` (PCM) dequantized to float32 / 32767 as the JAX step does,
    every other integer array as int64.  A tensor already on ``device`` is
    not copied."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                            device=device)
        if k == "wavs" and t.dtype == torch.int16:
            out[k] = t.float() / 32767.0
        else:
            out[k] = t.long() if not t.is_floating_point() else t.float()
    return out


def recon_losses(cfg: Config, stft: STFTParams, b: dict, out: dict, w,
                 counts: dict | None = None, tgt_slice=None) -> dict:
    """The generator's reconstruction losses but the KL, from the training
    branch's outputs ``out`` for the device batch ``b``: mel_l1 on the
    decoded slice, and uv/f0 and ctc where the recipe has those heads.
    ``counts``: the global denominators under data parallelism
    (``global_counts``); ``tgt_slice``: the target mel slices, if already
    made."""
    if tgt_slice is None:
        tgt_slice = log_mel_slices(b["wavs"], out["ids_slice"],
                                   cfg.segment_size, stft)
    c = counts or {}
    mel_out = log_mel_spectrogram(out["wav_out"], stft)
    losses = {"mel_l1": L.mel_losses_total(cfg.mel_losses, mel_out,
                                           tgt_slice, w, c.get("mel"))}
    if cfg.use_pitch_embed:
        losses["uv"], losses["f0"] = L.pitch_losses(
            out["f0_pred"], b["f0"], b["uv"], b["mel2ph"], cfg.lambda_uv,
            cfg.lambda_f0, w, c.get("frames"), c.get("voiced"))
    if cfg.use_phoneme_pred:
        losses["ctc"] = L.ctc_loss(
            out["ph_pred"], b["mel_lengths"], b["text_tokens"],
            b["text_lengths"], cfg.lambda_ctc, w, c.get("items"))
    return losses


def global_counts(cfg: Config, stft: STFTParams, b: dict,
                  ids_slice: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """(every loss's denominator summed over the ranks in one collective,
    the target mel slices) for the rank's device batch ``b`` and its slice
    starts: what a rank needs before its forward under data
    parallelism."""
    tgt_slice = log_mel_slices(b["wavs"], ids_slice, cfg.segment_size, stft)
    counts = L.loss_counts(tgt_slice, b["mel2ph"], b.get("uv"),
                           b.get("item_weights"))
    return dict(zip(counts, mesh.global_sums(list(counts.values())))), \
        tgt_slice


def rank_generator(seed: int, step: int, rank: int,
                   device) -> torch.Generator:
    """The generator of a rank's dropout draws at ``step``: seeded from
    (seed, step, rank) through ``numpy.random.SeedSequence``, so ranks and
    steps draw apart and a resumed run draws what the first run drew."""
    s = np.random.SeedSequence([seed, step, rank]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


# the matrix products whose outputs "dots" keeps (jax.checkpoint_policies
# .checkpoint_dots); convolutions and elementwise work are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(policy: str, fn, generator: torch.Generator):
    """``fn()`` under ``policy`` ("none", "full" or "dots").  The
    recompute in the backward first sets ``generator`` back to its state at
    the forward's start (and afterwards to its state after the forward), so
    it draws what the forward drew."""
    if policy == "none":
        return fn()
    start = generator.get_state()
    ran = []

    def run():
        if not ran:
            ran.append(True)
            return fn()
        after = generator.get_state()
        generator.set_state(start)
        try:
            return fn()
        finally:
            generator.set_state(after)

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(run, use_reentrant=False, **kw)


class TrainStep:
    """``train_step(state, batch) -> (state, metrics)``; see the module
    docstring.  ``batch`` holds the ``synthetic_batch`` fields (numpy arrays
    or tensors; ``spec`` and ``item_weights`` optional)."""

    def __init__(self, cfg: Config, model, disc, device="cuda",
                 steps_per_epoch: int | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        self.model = model.to(self.device)
        self.disc = disc.to(self.device)
        self.stft = STFTParams.from_config(cfg, self.device)
        self.opt_g, self.opt_d = make_optimizers(cfg, steps_per_epoch)
        if cfg.model == "vits" and mesh.world_size() > 1:
            raise NotImplementedError("data-parallel VITS training: its "
                                      "duration loss has no global count")

    def _batch(self, batch: dict) -> dict:
        return device_batch(batch, self.device)

    def global_draws(self, state: TrainState, batch: dict, eps_q=None,
                     ids_slice=None):
        """(eps_q [B, T, H], ids_slice [B]) for the rank's ``batch``: each
        one not given is drawn at the global batch's shape from the state's
        generator, in the model's order and layout (the posterior's noise
        [B_global, H, T], then the slice uniforms), and the rank's rows
        kept."""
        n, t = batch["mel2ph"].shape
        total = n * mesh.world_size()
        rows = mesh.host_batch_slice(total)
        gen = state.generator
        if eps_q is None:
            eps_q = torch.randn((total, self.cfg.hidden_size, t),
                                generator=gen, device=self.device
                                )[rows].transpose(1, 2)
        if ids_slice is None:
            u = torch.rand(total, generator=gen, device=self.device)[rows]
            lengths = None if self.cfg.slice_ref_padded else device_batch(
                {"mel_lengths": batch["mel_lengths"]},
                self.device)["mel_lengths"]
            ids_slice = slice_starts(u, lengths, t, self.cfg.segment_size)
        return eps_q, ids_slice

    def _prepare(self, state: TrainState, batch: dict, eps_q, ids_slice):
        """(device batch, eps_q, ids_slice, counts, target mel slices):
        the draws as given and no counts at world size 1; with more than
        one rank the draws not given come from ``global_draws`` and the
        global counts from ``global_counts``."""
        b = self._batch(batch)
        if mesh.world_size() == 1:
            return b, eps_q, ids_slice, None, None
        eps_q, ids_slice = self.global_draws(state, b, eps_q, ids_slice)
        ids_slice = torch.as_tensor(ids_slice, device=self.device).long()
        return (b, eps_q, ids_slice,
                *global_counts(self.cfg, self.stft, b, ids_slice))

    def generator_loss(self, state: TrainState, batch: dict, eps_q=None,
                       ids_slice=None, generator=None):
        """-> (total, losses, aux) at ``state.step``'s optimizer step, with
        the model in training mode, its draws from ``generator`` (default
        the state's); aux holds the generated and the real slices and the
        item weights.  Under data parallelism every loss is the rank's
        share of the global batch's."""
        b, eps_q, ids_slice, counts, tgt = self._prepare(state, batch, eps_q,
                                                         ids_slice)
        terms, aux = self._forward(state, b, eps_q, ids_slice, generator,
                                   counts, tgt)
        return (*self._with_kl(state, terms, counts), aux)

    def _with_kl(self, state: TrainState, terms: dict,
                 counts: dict | None) -> tuple[torch.Tensor, dict]:
        """(total, losses) from ``_forward``'s terms: the KL through its
        schedule (held to ``kl_min`` globally, one collective under data
        parallelism), its raw value as the metric "kl_v"."""
        cfg = self.cfg
        step = state.step // max(cfg.accumulate_grad_batches, 1)
        kl = terms["kl_v"]
        kl_global = None if counts is None else mesh.global_sum(kl)
        losses = {"kl_v": kl.detach(),
                  "kl": L.kl_schedule(kl, step, cfg.kl_min,
                                      cfg.kl_start_steps, cfg.lambda_kl,
                                      kl_global, mesh.world_size()),
                  **{k: v for k, v in terms.items() if k != "kl_v"}}
        return sum(v for k, v in losses.items() if k != "kl_v"), losses

    def _forward(self, state: TrainState, b: dict, eps_q, ids_slice,
                 generator, counts: dict | None, tgt_slice):
        """The training branch and every loss term but the KL's schedule
        (the raw KL, with its gradient, under "kl_v"), on the device batch
        ``b``; no collective.  -> (terms, aux)."""
        cfg = self.cfg
        generator = state.generator if generator is None else generator
        step = state.step // max(cfg.accumulate_grad_batches, 1)
        c = counts or {}
        self.model.train()
        spec = b.get("spec")
        if spec is None:
            with torch.no_grad():
                spec = linear_spectrogram(b["wavs"], self.stft)
        w = b.get("item_weights")
        eps_q = None if eps_q is None else torch.as_tensor(
            eps_q, device=self.device).float()
        ids_slice = None if ids_slice is None else torch.as_tensor(
            ids_slice, device=self.device)
        if cfg.model == "vits":
            # VITS's batch: text tokens and their lengths, the waveform
            # and its frame count
            out = self.model(
                b["text_tokens"], b["text_lengths"], spec, b["mel_lengths"],
                generator=generator, eps_q=eps_q, ids_slice=ids_slice,
                item_weights=w, kl_count=c.get("frames"))
        else:
            out = self.model(
                b["text_tokens"], b["note_pitch"], b["note_dur"],
                b["mel2ph"], spk_id=b.get("spk_ids"), infer=False,
                generator=generator, f0=b.get("f0"), uv=b.get("uv"),
                spec=spec, lengths=b.get("mel_lengths"), item_weights=w,
                eps_q=eps_q, ids_slice=ids_slice,
                spk_embed=b.get("spk_embed"), kl_count=c.get("frames"))
        terms = {"kl_v": out["kl"],
                 **recon_losses(cfg, self.stft, b, out, w, counts,
                                tgt_slice)}
        if "dur" in out:
            terms["dur"] = out["dur"]
        seg, hop = cfg.segment_size, cfg.hop_size
        real = slice_segments(b["wavs"], out["ids_slice"] * hop, seg * hop)
        adv_gate = float(step >= cfg.disc_start_steps)
        if cfg.lambda_mel_adv > 0:
            _, fake_scores, fmap_r, fmap_g = self.disc(real, out["wav_out"])
            terms["adv"] = L.generator_adv_loss(
                fake_scores, w, c.get("items")) * cfg.lambda_mel_adv \
                * adv_gate
            terms["fm"] = L.feature_matching_loss(
                fmap_r, fmap_g, w, c.get("items")) * cfg.lambda_fm * adv_gate
        return terms, {"wav_out": out["wav_out"], "real": real,
                       "item_weights": w}

    def __call__(self, state: TrainState, batch: dict, eps_q=None,
                 ids_slice=None) -> tuple[TrainState, dict]:
        with span("train.step", state.step):
            return self._step(state, batch, eps_q, ids_slice)

    def _step(self, state, batch, eps_q, ids_slice):
        cfg = self.cfg
        accum = max(cfg.accumulate_grad_batches, 1)
        opt_step = state.step // accum
        with span("train.g.forward"):
            b, eps_q, ids_slice, counts, tgt = self._prepare(
                state, batch, eps_q, ids_slice)
            gen = state.generator if counts is None else rank_generator(
                cfg.seed, state.step, mesh.rank(), self.device)
            terms, aux = remat(
                cfg.remat_policy,
                lambda: self._forward(state, b, eps_q, ids_slice, gen,
                                      counts, tgt), gen)
            total, losses = self._with_kl(state, terms, counts)
        with span("train.g.backward"):
            params_g = list(self.model.parameters())
            grads_g = mesh.all_reduce_grads(_grads(total, params_g))
        with span("train.g.optimizer"):
            if accum == 1:
                gnorm = self.opt_g.update(params_g, grads_g,
                                          state.opt_state_g)
            else:
                gnorm = global_norm(grads_g)
                self.opt_g.step(params_g, grads_g, state.opt_state_g, accum)

        loss_d = torch.zeros((), device=self.device)
        if (cfg.lambda_mel_adv > 0 and opt_step >= cfg.disc_start_steps
                and opt_step % cfg.disc_interval == 0):
            real, fake = aux["real"].detach(), aux["wav_out"].detach()

            def disc_loss():
                real_scores, fake_scores, _, _ = self.disc(real, fake)
                return L.discriminator_loss(
                    real_scores, fake_scores, aux["item_weights"],
                    None if counts is None else counts["items"])

            with span("train.d.forward"):
                loss_d = remat(cfg.remat_policy, disc_loss, gen)
            with span("train.d.backward"):
                params_d = list(self.disc.parameters())
                grads_d = mesh.all_reduce_grads(_grads(loss_d, params_d))
            with span("train.d.optimizer"):
                self.opt_d.step(params_d, grads_d, state.opt_state_d, accum)
        with span("train.metrics"):
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["total_g"] = total.detach()
            metrics["disc"] = loss_d.detach()
            metrics = _global_metrics(metrics)
            metrics["gnorm_g"] = gnorm  # of the summed gradients: global
        state.step += 1
        return state, metrics


def _global_metrics(metrics: dict) -> dict:
    """Each rank's share of every metric summed over the ranks (one
    collective); ``metrics`` itself without a process group."""
    if not mesh.distributed():
        return metrics
    return dict(zip(metrics, mesh.global_sums(list(metrics.values()))))


def _grads(loss: torch.Tensor, params: list) -> list[torch.Tensor]:
    """d loss / d params, each contiguous: the optimizer's kernel takes
    contiguous leaves, and autograd hands back K2's weights (permuted into
    its packed layout) as permuted views.  A parameter the loss does not
    reach gets zeros."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g.contiguous()
            for p, g in zip(params, grads)]


def make_train_step(cfg: Config, model, disc, device="cuda",
                    steps_per_epoch: int | None = None) -> TrainStep:
    """The train step for ``model`` and ``disc``, moved to ``device``
    (a CUDA device unless the caller asks for the CPU); the learning rate
    decays once per ``steps_per_epoch`` batches (``make_optimizers``)."""
    return TrainStep(cfg, model, disc, device, steps_per_epoch)


# The generator's reconstruction losses: what validation tracks for the best
# checkpoint (no adversarial, feature-matching or discriminator terms).
RECON_LOSS_KEYS = ("kl", "mel_l1", "uv", "f0", "ctc")


def recon_loss_total(metrics: dict) -> float:
    return float(sum(float(metrics[k]) for k in RECON_LOSS_KEYS
                     if k in metrics))


class EvalStep:
    """``eval_step(batch) -> metrics``: the training branch of the
    generator with every dropout off and no update, and only the
    reconstruction losses (kl, mel_l1, uv, f0, ctc; the KL without its
    warm-up schedule) and their sum ``total_g``.

    The posterior noise ``eps_q`` and the slice starts ``ids_slice`` may be
    given; otherwise each call draws them from a CPU generator seeded 0 and
    moves them to the device, so a validation loss is the same at every
    evaluation and on every device.  Under a process group each rank passes
    its rows, the draws are made at the global batch's shape and the
    rank's rows kept, and the metrics are summed over the ranks: the global
    batch's.  The model is back in training mode afterwards."""

    def __init__(self, cfg: Config, model, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        self.model = model.to(self.device)
        self.stft = STFTParams.from_config(cfg, self.device)
        if cfg.model == "vits":
            raise NotImplementedError("the validation step of VITS waits "
                                      "for its text-audio data pipeline")

    def draws(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(eps_q [B, T, H], ids_slice [B]) for a device batch: the normal
        and then the uniform draw from a CPU generator seeded 0, moved to the
        device; the slice starts from the uniforms as the model draws them
        (``ops/masking.py::rand_slice_segments``)."""
        b, t = batch["mel2ph"].shape
        total = b * mesh.world_size()
        rows = mesh.host_batch_slice(total)
        gen = torch.Generator().manual_seed(0)
        eps_q = torch.randn(total, t, self.cfg.hidden_size, generator=gen)
        u = torch.rand(total, generator=gen)[rows].to(self.device)
        return eps_q[rows].to(self.device), slice_starts(
            u, None if self.cfg.slice_ref_padded else batch["mel_lengths"],
            t, self.cfg.segment_size)

    @torch.no_grad()
    def __call__(self, batch: dict, eps_q=None, ids_slice=None) -> dict:
        cfg, b = self.cfg, device_batch(batch, self.device)
        if eps_q is None or ids_slice is None:
            eps_q, ids_slice = self.draws(b)
        counts = tgt = None
        if mesh.world_size() > 1:
            counts, tgt = global_counts(cfg, self.stft, b, torch.as_tensor(
                ids_slice, device=self.device).long())
        self.model.eval()
        try:
            spec = b.get("spec")
            if spec is None:
                spec = power_spectrogram(b["wavs"], self.stft)
            w = b.get("item_weights")
            out = self.model(
                b["text_tokens"], b["note_pitch"], b["note_dur"], b["mel2ph"],
                spk_id=b.get("spk_ids"), infer=False, f0=b.get("f0"),
                uv=b.get("uv"), spec=spec, lengths=b.get("mel_lengths"),
                item_weights=w,
                eps_q=torch.as_tensor(eps_q, device=self.device).float(),
                ids_slice=torch.as_tensor(ids_slice, device=self.device),
                spk_embed=b.get("spk_embed"),
                kl_count=None if counts is None else counts["frames"])
        finally:
            self.model.train()
        m = {"kl": out["kl"] * cfg.lambda_kl,
             **recon_losses(cfg, self.stft, b, out, w, counts, tgt)}
        m["total_g"] = sum(m.values())
        return _global_metrics(m)


def make_eval_step(cfg: Config, model, device="cuda") -> EvalStep:
    """The deterministic validation step for ``model`` on ``device`` (a CUDA
    device unless the caller asks for the CPU)."""
    return EvalStep(cfg, model, device)
