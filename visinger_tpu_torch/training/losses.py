"""VISinger training losses (counterpart of the JAX package's
``training/losses.py``).

Every loss takes an optional per-item weight vector ``w`` [B] (1.0 = real
item, 0.0 = a padding duplicate) that masks items out of every reduction.
Layouts are the JAX package's: mels [B, T, n_mels], ``f0_pred`` [B, T, 2],
``ph_pred`` [B, T, vocab] log-probabilities.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _weights(x: torch.Tensor, w) -> torch.Tensor:
    return torch.ones(x.shape[0], device=x.device) if w is None \
        else w.to(x.device).float()


def parse_mel_losses(spec: str) -> dict[str, float]:
    """'l1:45.0|mse:1.0' -> {name: weight}."""
    out: dict[str, float] = {}
    for part in str(spec).split("|"):
        if not part:
            continue
        if ":" in part:
            name, weight = part.split(":")
            out[name] = float(weight)
        else:
            out[part] = 1.0
    return out


def _masked_mel(penalty, mel_out, mel_tgt, w=None) -> torch.Tensor:
    """Mean of ``penalty(mel_out - mel_tgt)`` over frames whose target is
    not all zero (and items with weight)."""
    weights = (mel_tgt.abs().sum(-1, keepdim=True) != 0).float()
    weights = (weights * _weights(mel_tgt, w)[:, None, None]).expand_as(
        mel_tgt)
    err = penalty(mel_out - mel_tgt) * weights
    return err.sum() / weights.sum().clamp(min=1.0)


MEL_LOSSES = {"l1": torch.abs, "mse": torch.square}


def mel_losses_total(spec: str, mel_out, mel_tgt, w=None) -> torch.Tensor:
    """The configured mel-loss mix, e.g. ``"l1:45.0"``."""
    total = 0.0
    for name, weight in parse_mel_losses(spec).items():
        if name not in MEL_LOSSES:
            raise ValueError(f"unsupported mel loss {name!r}")
        total = total + _masked_mel(MEL_LOSSES[name], mel_out, mel_tgt,
                                    w) * weight
    return total


def kl_schedule(kl: torch.Tensor, step: int, kl_min: float,
                kl_start_steps: int, lambda_kl: float) -> torch.Tensor:
    """max(kl, kl_min) · λ, warmed up linearly over ``kl_start_steps``
    optimizer steps (step 0 gives 0)."""
    warm = min(step / max(kl_start_steps, 1), 1.0)
    return warm * kl.clamp(min=kl_min) * lambda_kl


def pitch_losses(f0_pred, f0, uv, mel2ph, lambda_uv: float, lambda_f0: float,
                 w=None):
    """(uv BCE over valid frames, f0 L1 over voiced valid frames), each
    times its λ."""
    nonpadding = (mel2ph != 0).float() * _weights(mel2ph, w)[:, None]
    bce = F.binary_cross_entropy_with_logits(f0_pred[..., 1], uv,
                                             reduction="none")
    uv_loss = (bce * nonpadding).sum() / nonpadding.sum().clamp(min=1.0)
    voiced = nonpadding * (uv == 0).float()
    f0_loss = ((f0_pred[..., 0] - f0).abs() * voiced).sum() \
        / voiced.sum().clamp(min=1.0)
    return uv_loss * lambda_uv, f0_loss * lambda_f0


def ctc_loss(log_probs, mel_lengths, text_tokens, text_lengths,
             lambda_ctc: float, w=None) -> torch.Tensor:
    """CTC (blank 0) of ``log_probs`` [B, T, V] against the text tokens:
    infeasible items (fewer valid frames than labels) count 0, each item is
    divided by its label count, then a weighted mean times λ."""
    per_seq = F.ctc_loss(log_probs.transpose(0, 1), text_tokens.long(),
                         mel_lengths.long(), text_lengths.long(), blank=0,
                         reduction="none", zero_infinity=True)
    per_seq = per_seq / text_lengths.float().clamp(min=1.0)
    wb = _weights(per_seq, w)
    return (per_seq * wb).sum() / wb.sum().clamp(min=1.0) * lambda_ctc


def _per_item_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(1)


def _weighted_mean(per_item: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    return (per_item * wb).sum() / wb.sum().clamp(min=1.0)


def discriminator_loss(real_scores, fake_scores, w=None) -> torch.Tensor:
    """LSGAN: Σ_d mean((1 - D(y))²) + mean(D(G(z))²)."""
    loss = 0.0
    for r, g in zip(real_scores, fake_scores):
        wb = _weights(r, w)
        loss = loss + _weighted_mean(_per_item_mean((1.0 - r).square()), wb) \
            + _weighted_mean(_per_item_mean(g.square()), wb)
    return loss


def generator_adv_loss(fake_scores, w=None) -> torch.Tensor:
    """LSGAN generator: Σ_d mean((1 - D(G(z)))²)."""
    loss = 0.0
    for g in fake_scores:
        loss = loss + _weighted_mean(_per_item_mean((1.0 - g).square()),
                                     _weights(g, w))
    return loss


def feature_matching_loss(fmap_real, fmap_fake, w=None) -> torch.Tensor:
    """Σ of the L1 distance over every feature map of every
    sub-discriminator; the real maps take no gradient."""
    loss = 0.0
    for fr, ff in zip(fmap_real, fmap_fake):
        for r, f in zip(fr, ff):
            loss = loss + _weighted_mean(_per_item_mean((r.detach() - f).abs()),
                                         _weights(r, w))
    return loss
