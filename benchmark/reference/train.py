"""The VISinger GAN train step in plain PyTorch, on one process: a frozen
copy of the port's ``TrainStep`` at world size 1 with no recompute.

The generator's loss against the discriminator from before this step's
update, its gradient norm before the clip and its AdamW update; then the
discriminator's loss on the real slice and the detached fake, and its AdamW
update.  The posterior noise ``eps_q`` and the slice starts ``ids_slice``
are given; the dropout masks and attention-dropout seeds are drawn from the
state's generator in the port's order, so the same generator state draws
the same masks."""

from __future__ import annotations

from dataclasses import dataclass

import contextlib

import numpy as np
import torch

from . import losses as L
from .masking import slice_segments
from .optim import AdamState, global_norm, init_adam, make_optimizers
from .stft import (STFTParams, log_mel_slices, log_mel_spectrogram,
                   power_spectrogram)


@dataclass
class RefState:
    model: torch.nn.Module
    disc: torch.nn.Module
    opt_state_g: AdamState
    opt_state_d: AdamState
    step: int
    generator: torch.Generator


def ref_state(model, disc, seed: int) -> RefState:
    """A fresh state with a generator on the models' device seeded from
    ``seed``."""
    dev = next(model.parameters()).device
    return RefState(model, disc, init_adam(list(model.parameters())),
                    init_adam(list(disc.parameters())), 0,
                    torch.Generator(device=dev).manual_seed(seed))


def device_batch(batch: dict, device) -> dict:
    """Float arrays as float32 and integer arrays as int64, on ``device``."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                            device=device)
        out[k] = t.float() if t.is_floating_point() else t.long()
    return out


def _grads(loss, params):
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


class RefTrainStep:
    """``products``: a context manager factory entered around every call of
    the model and the discriminators (a control computes their products in
    a lower precision there); none by default."""

    def __init__(self, cfg, model, disc, device, products=None):
        self.products = products or contextlib.nullcontext
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model
        self.disc = disc
        self.stft = STFTParams.from_config(cfg, self.device)
        self.opt_g, self.opt_d = make_optimizers(cfg)

    def _forward(self, state: RefState, b: dict, eps_q, ids_slice):
        cfg = self.cfg
        gen = state.generator
        step = state.step
        self.model.train()
        with torch.no_grad():
            spec = power_spectrogram(b["wavs"], self.stft)
        w = b.get("item_weights")
        with self.products():
            out = self.model(
                b["text_tokens"], b["note_pitch"], b["note_dur"],
                b["mel2ph"], spk_id=b.get("spk_ids"), infer=False,
                generator=gen, f0=b.get("f0"), uv=b.get("uv"), spec=spec,
                lengths=b.get("mel_lengths"), item_weights=w,
                eps_q=eps_q.float(), ids_slice=ids_slice)
        tgt_slice = log_mel_slices(b["wavs"], out["ids_slice"],
                                   cfg.segment_size, self.stft)
        mel_out = log_mel_spectrogram(out["wav_out"], self.stft)
        terms = {"kl_v": out["kl"],
                 "mel_l1": L.mel_losses_total(cfg.mel_losses, mel_out,
                                              tgt_slice, w)}
        if cfg.use_pitch_embed:
            terms["uv"], terms["f0"] = L.pitch_losses(
                out["f0_pred"], b["f0"], b["uv"], b["mel2ph"], cfg.lambda_uv,
                cfg.lambda_f0, w)
        if cfg.use_phoneme_pred:
            terms["ctc"] = L.ctc_loss(
                out["ph_pred"], b["mel_lengths"], b["text_tokens"],
                b["text_lengths"], cfg.lambda_ctc, w)
        seg, hop = cfg.segment_size, cfg.hop_size
        real = slice_segments(b["wavs"], out["ids_slice"] * hop, seg * hop)
        adv_gate = float(step >= cfg.disc_start_steps)
        if cfg.lambda_mel_adv > 0:
            with self.products():
                _, fake_scores, fmap_r, fmap_g = self.disc(real,
                                                           out["wav_out"])
            terms["adv"] = L.generator_adv_loss(fake_scores, w) \
                * cfg.lambda_mel_adv * adv_gate
            terms["fm"] = L.feature_matching_loss(fmap_r, fmap_g, w) \
                * cfg.lambda_fm * adv_gate
        return terms, {"wav_out": out["wav_out"], "real": real,
                       "item_weights": w}

    def __call__(self, state: RefState, batch: dict, eps_q,
                 ids_slice) -> dict:
        """One step in place on ``state``; returns its metrics."""
        cfg = self.cfg
        b = device_batch(batch, self.device)
        eps_q = torch.as_tensor(eps_q, device=self.device)
        ids_slice = torch.as_tensor(ids_slice, device=self.device).long()
        terms, aux = self._forward(state, b, eps_q, ids_slice)
        kl = terms["kl_v"]
        losses = {"kl_v": kl.detach(),
                  "kl": L.kl_schedule(kl, state.step, cfg.kl_min,
                                      cfg.kl_start_steps, cfg.lambda_kl),
                  **{k: v for k, v in terms.items() if k != "kl_v"}}
        total = sum(v for k, v in losses.items() if k != "kl_v")
        params_g = list(self.model.parameters())
        grads_g = _grads(total, params_g)
        gnorm = global_norm(grads_g)
        self.opt_g.step(params_g, grads_g, state.opt_state_g)
        loss_d = torch.zeros((), device=self.device)
        if (cfg.lambda_mel_adv > 0 and state.step >= cfg.disc_start_steps
                and state.step % cfg.disc_interval == 0):
            real, fake = aux["real"].detach(), aux["wav_out"].detach()
            with self.products():
                real_scores, fake_scores, _, _ = self.disc(real, fake)
            loss_d = L.discriminator_loss(real_scores, fake_scores,
                                          aux["item_weights"])
            params_d = list(self.disc.parameters())
            self.opt_d.step(params_d, _grads(loss_d, params_d),
                            state.opt_state_d)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_g"] = total.detach()
        metrics["disc"] = loss_d.detach()
        metrics["gnorm_g"] = gnorm
        state.step += 1
        return metrics
