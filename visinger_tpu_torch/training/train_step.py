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
that a test can give the port the JAX step's draws.
"""

from __future__ import annotations

import numpy as np
import torch

from visinger_tpu_torch.config import Config, check_supported
from visinger_tpu_torch.models.factory import resolve_device
from visinger_tpu_torch.ops.masking import slice_segments
from visinger_tpu_torch.ops.stft import (STFTParams, log_mel_slices,
                                         log_mel_spectrogram,
                                         power_spectrogram)
from visinger_tpu_torch.training import losses as L
from visinger_tpu_torch.training.train_state import (TrainState, global_norm,
                                                     make_optimizers)


class TrainStep:
    """``train_step(state, batch) -> (state, metrics)``; see the module
    docstring.  ``batch`` holds the ``synthetic_batch`` fields (numpy arrays
    or tensors; ``spec`` and ``item_weights`` optional)."""

    def __init__(self, cfg: Config, model, disc, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        self.model = model.to(self.device)
        self.disc = disc.to(self.device)
        self.stft = STFTParams.from_config(cfg, self.device)
        self.opt_g, self.opt_d = make_optimizers(cfg)

    def _batch(self, batch: dict) -> dict:
        """The batch as tensors on the step's device: float arrays as
        float32, int16 ``wavs`` (PCM) dequantized to float32 / 32767 as
        the JAX step does, every other integer array as int64."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v, device=self.device)
            if k == "wavs" and t.dtype == torch.int16:
                out[k] = t.float() / 32767.0
            else:
                out[k] = t.long() if not t.is_floating_point() else t.float()
        return out

    def generator_loss(self, state: TrainState, batch: dict, eps_q=None,
                       ids_slice=None):
        """-> (total, losses, aux) at ``state.step``, with the model in
        training mode; aux holds the generated and the real slices and the
        item weights."""
        cfg, b = self.cfg, self._batch(batch)
        step = state.step
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
                ids_slice, device=self.device))
        losses = {"kl_v": out["kl"].detach(),
                  "kl": L.kl_schedule(out["kl"], step, cfg.kl_min,
                                      cfg.kl_start_steps, cfg.lambda_kl)}
        seg, hop = cfg.segment_size, cfg.hop_size
        tgt_slice = log_mel_slices(b["wavs"], out["ids_slice"], seg,
                                   self.stft)
        mel_out = log_mel_spectrogram(out["wav_out"], self.stft)
        losses["mel_l1"] = L.mel_losses_total(cfg.mel_losses, mel_out,
                                              tgt_slice, w)
        if cfg.use_pitch_embed:
            losses["uv"], losses["f0"] = L.pitch_losses(
                out["f0_pred"], b["f0"], b["uv"], b["mel2ph"], cfg.lambda_uv,
                cfg.lambda_f0, w)
        if cfg.use_phoneme_pred:
            losses["ctc"] = L.ctc_loss(
                out["ph_pred"], b["mel_lengths"], b["text_tokens"],
                b["text_lengths"], cfg.lambda_ctc, w)
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
        total, losses, aux = self.generator_loss(state, batch, eps_q,
                                                 ids_slice)
        params_g = list(self.model.parameters())
        grads_g = _grads(total, params_g)
        gnorm = global_norm(grads_g)
        self.opt_g.update(params_g, grads_g, state.opt_state_g)

        cfg, loss_d = self.cfg, torch.zeros((), device=self.device)
        if (cfg.lambda_mel_adv > 0 and state.step >= cfg.disc_start_steps
                and state.step % cfg.disc_interval == 0):
            real_scores, fake_scores, _, _ = self.disc(
                aux["real"].detach(), aux["wav_out"].detach())
            loss_d = L.discriminator_loss(real_scores, fake_scores,
                                          aux["item_weights"])
            params_d = list(self.disc.parameters())
            self.opt_d.update(params_d, _grads(loss_d, params_d),
                              state.opt_state_d)
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


def make_train_step(cfg: Config, model, disc, device="cuda") -> TrainStep:
    """The train step for ``model`` and ``disc``, moved to ``device``
    (a CUDA device unless the caller asks for the CPU)."""
    return TrainStep(cfg, model, disc, device)
