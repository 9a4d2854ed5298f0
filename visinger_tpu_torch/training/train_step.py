"""The VISinger GAN train step (counterpart of the JAX package's
``training/train_step.py``), in the JAX step's update order:

  1. the generator loss against the discriminator from before this step's
     update (its parameters take no gradient), ``gnorm_g`` before the clip,
     the generator's AdamW update;
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
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from visinger_tpu_torch.config import Config, check_supported
from visinger_tpu_torch.models.factory import resolve_device
from visinger_tpu_torch.ops.masking import slice_segments
from visinger_tpu_torch.ops.stft import (STFTParams, log_mel_slices,
                                         log_mel_spectrogram,
                                         power_spectrogram)
from visinger_tpu_torch.training import losses as L
from visinger_tpu_torch.training.train_state import (TrainState, global_norm,
                                                     make_optimizers)


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


def recon_losses(cfg: Config, stft: STFTParams, b: dict, out: dict,
                 w) -> dict:
    """The generator's reconstruction losses but the KL, from the training
    branch's outputs ``out`` for the device batch ``b``: mel_l1 on the
    decoded slice, and uv/f0 and ctc where the recipe has those heads."""
    tgt_slice = log_mel_slices(b["wavs"], out["ids_slice"], cfg.segment_size,
                               stft)
    mel_out = log_mel_spectrogram(out["wav_out"], stft)
    losses = {"mel_l1": L.mel_losses_total(cfg.mel_losses, mel_out,
                                           tgt_slice, w)}
    if cfg.use_pitch_embed:
        losses["uv"], losses["f0"] = L.pitch_losses(
            out["f0_pred"], b["f0"], b["uv"], b["mel2ph"], cfg.lambda_uv,
            cfg.lambda_f0, w)
    if cfg.use_phoneme_pred:
        losses["ctc"] = L.ctc_loss(
            out["ph_pred"], b["mel_lengths"], b["text_tokens"],
            b["text_lengths"], cfg.lambda_ctc, w)
    return losses


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

    def _batch(self, batch: dict) -> dict:
        return device_batch(batch, self.device)

    def generator_loss(self, state: TrainState, batch: dict, eps_q=None,
                       ids_slice=None):
        """-> (total, losses, aux) at ``state.step``'s optimizer step, with
        the model in training mode; aux holds the generated and the real
        slices and the item weights."""
        cfg, b = self.cfg, self._batch(batch)
        step = state.step // max(cfg.accumulate_grad_batches, 1)
        self.model.train()
        spec = b.get("spec")
        if spec is None:
            with torch.no_grad():
                spec = power_spectrogram(b["wavs"], self.stft)
        w = b.get("item_weights")
        out = self.model(
            b["text_tokens"], b["note_pitch"], b["note_dur"], b["mel2ph"],
            spk_id=b.get("spk_ids"), infer=False, generator=state.generator,
            f0=b.get("f0"), uv=b.get("uv"), spec=spec,
            lengths=b.get("mel_lengths"), item_weights=w,
            eps_q=None if eps_q is None else torch.as_tensor(
                eps_q, device=self.device).float(),
            ids_slice=None if ids_slice is None else torch.as_tensor(
                ids_slice, device=self.device),
            spk_embed=b.get("spk_embed"))
        losses = {"kl_v": out["kl"].detach(),
                  "kl": L.kl_schedule(out["kl"], step, cfg.kl_min,
                                      cfg.kl_start_steps, cfg.lambda_kl),
                  **recon_losses(cfg, self.stft, b, out, w)}
        seg, hop = cfg.segment_size, cfg.hop_size
        real = slice_segments(b["wavs"], out["ids_slice"] * hop, seg * hop)
        adv_gate = float(step >= cfg.disc_start_steps)
        if cfg.lambda_mel_adv > 0:
            _, fake_scores, fmap_r, fmap_g = self.disc(real, out["wav_out"])
            losses["adv"] = L.generator_adv_loss(fake_scores, w) \
                * cfg.lambda_mel_adv * adv_gate
            losses["fm"] = L.feature_matching_loss(fmap_r, fmap_g, w) \
                * cfg.lambda_fm * adv_gate
        total = sum(v for k, v in losses.items() if k != "kl_v")
        return total, losses, {"wav_out": out["wav_out"], "real": real,
                               "item_weights": w}

    def __call__(self, state: TrainState, batch: dict, eps_q=None,
                 ids_slice=None) -> tuple[TrainState, dict]:
        cfg = self.cfg
        accum = max(cfg.accumulate_grad_batches, 1)
        opt_step = state.step // accum
        total, losses, aux = remat(
            cfg.remat_policy,
            lambda: self.generator_loss(state, batch, eps_q, ids_slice),
            state.generator)
        params_g = list(self.model.parameters())
        grads_g = _grads(total, params_g)
        gnorm = global_norm(grads_g)
        self.opt_g.step(params_g, grads_g, state.opt_state_g, accum)

        loss_d = torch.zeros((), device=self.device)
        if (cfg.lambda_mel_adv > 0 and opt_step >= cfg.disc_start_steps
                and opt_step % cfg.disc_interval == 0):
            real, fake = aux["real"].detach(), aux["wav_out"].detach()

            def disc_loss():
                real_scores, fake_scores, _, _ = self.disc(real, fake)
                return L.discriminator_loss(real_scores, fake_scores,
                                            aux["item_weights"])

            loss_d = remat(cfg.remat_policy, disc_loss, state.generator)
            params_d = list(self.disc.parameters())
            self.opt_d.step(params_d, _grads(loss_d, params_d),
                            state.opt_state_d, accum)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_g"] = total.detach()
        metrics["disc"] = loss_d.detach()
        metrics["gnorm_g"] = gnorm
        state.step += 1
        return state, metrics


def _grads(loss: torch.Tensor, params: list) -> list[torch.Tensor]:
    """d loss / d params; a parameter the loss does not reach gets zeros."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
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
    evaluation and on every device.  The model is back in training mode
    afterwards."""

    def __init__(self, cfg: Config, model, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        self.model = model.to(self.device)
        self.stft = STFTParams.from_config(cfg, self.device)

    def draws(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(eps_q [B, T, H], ids_slice [B]) for a device batch: the normal
        and then the uniform draw from a CPU generator seeded 0, moved to the
        device; the slice starts from the uniforms as the model draws them
        (``ops/masking.py::rand_slice_segments``)."""
        b, t = batch["mel2ph"].shape
        gen = torch.Generator().manual_seed(0)
        eps_q = torch.randn(b, t, self.cfg.hidden_size, generator=gen)
        u = torch.rand(b, generator=gen).to(self.device)
        lengths = (torch.full((b,), t, device=self.device)
                   if self.cfg.slice_ref_padded else batch["mel_lengths"])
        ids_max = (lengths.long() - self.cfg.segment_size + 1).clamp(min=1)
        return eps_q.to(self.device), (u * ids_max.float()).long()

    @torch.no_grad()
    def __call__(self, batch: dict, eps_q=None, ids_slice=None) -> dict:
        cfg, b = self.cfg, device_batch(batch, self.device)
        if eps_q is None or ids_slice is None:
            eps_q, ids_slice = self.draws(b)
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
                spk_embed=b.get("spk_embed"))
        finally:
            self.model.train()
        m = {"kl": out["kl"] * cfg.lambda_kl,
             **recon_losses(cfg, self.stft, b, out, w)}
        m["total_g"] = sum(m.values())
        return m


def make_eval_step(cfg: Config, model, device="cuda") -> EvalStep:
    """The deterministic validation step for ``model`` on ``device`` (a CUDA
    device unless the caller asks for the CPU)."""
    return EvalStep(cfg, model, device)
