"""VISinger training losses (a frozen plain copy of the PyTorch port's
``training/losses.py``).

Every loss takes an optional per-item weight vector ``w`` [B] (1.0 = real
item, 0.0 = a padding duplicate) that masks items out of every reduction.
Layouts are the JAX package's: mels [B, T, n_mels], ``f0_pred`` [B, T, 2],
``ph_pred`` [B, T, vocab] log-probabilities.

Every loss is a masked sum over the batch divided by a masked count
(``loss_counts``).  Under data parallelism the numerator is the rank's and
the count is passed in: the global one, which the step sums over the ranks
before its forward, so the ranks' losses sum to the loss of the global
batch.  Without a count the batch's own is used and the arithmetic is the
single-process step's.  Nothing here calls a collective.
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


def _denominator(local: torch.Tensor, count) -> torch.Tensor:
    """``count`` (the global count under data parallelism), else the
    batch's own ``local`` count; at least 1."""
    return (local if count is None else count).clamp(min=1.0)


def _mel_weights(mel_tgt, w) -> torch.Tensor:
    """[B, T, n_mels]: 1 on frames whose target is not all zero, of items
    with weight."""
    weights = (mel_tgt.abs().sum(-1, keepdim=True) != 0).float()
    return (weights * _weights(mel_tgt, w)[:, None, None]).expand_as(mel_tgt)


def _nonpadding(mel2ph, w) -> torch.Tensor:
    """[B, T]: 1 on the valid frames of items with weight."""
    return (mel2ph != 0).float() * _weights(mel2ph, w)[:, None]


def loss_counts(mel_tgt, mel2ph, uv, w=None) -> dict[str, torch.Tensor]:
    """Every loss's denominator over this batch, as 0-d tensors: "mel" (the
    target mel slices' weighted entries), "frames" (valid frames: the
    uv loss and the KL), "voiced" (valid voiced frames: the f0 loss, when
    ``uv`` is given) and "items" (the weight of the items: ctc, adversarial,
    feature matching, discriminator)."""
    nonpadding = _nonpadding(mel2ph, w)
    out = {"mel": _mel_weights(mel_tgt, w).sum(),
           "frames": nonpadding.sum(),
           "items": _weights(mel2ph, w).sum()}
    if uv is not None:
        out["voiced"] = (nonpadding * (uv == 0).float()).sum()
    return out


def _masked_mel(penalty, mel_out, mel_tgt, w=None,
                count=None) -> torch.Tensor:
    """Mean of ``penalty(mel_out - mel_tgt)`` over frames whose target is
    not all zero (and items with weight)."""
    weights = _mel_weights(mel_tgt, w)
    err = penalty(mel_out - mel_tgt) * weights
    return err.sum() / _denominator(weights.sum(), count)


MEL_LOSSES = {"l1": torch.abs, "mse": torch.square}


def mel_losses_total(spec: str, mel_out, mel_tgt, w=None,
                     count=None) -> torch.Tensor:
    """The configured mel-loss mix, e.g. ``"l1:45.0"``."""
    total = 0.0
    for name, weight in parse_mel_losses(spec).items():
        if name not in MEL_LOSSES:
            raise ValueError(f"unsupported mel loss {name!r}")
        total = total + _masked_mel(MEL_LOSSES[name], mel_out, mel_tgt,
                                    w, count) * weight
    return total


def kl_schedule(kl: torch.Tensor, step: int, kl_min: float,
                kl_start_steps: int, lambda_kl: float, kl_global=None,
                world: int = 1) -> torch.Tensor:
    """max(kl, kl_min) · λ, warmed up linearly over ``kl_start_steps``
    optimizer steps (step 0 gives 0).  Under data parallelism ``kl`` is the
    rank's share of the global KL ``kl_global`` (its sum over the ``world``
    ranks): the global value is held to ``kl_min`` (each rank then gives
    kl_min / world and no gradient)."""
    warm = min(step / max(kl_start_steps, 1), 1.0)
    if kl_global is not None:
        kl = torch.where(kl_global >= kl_min, kl,
                         kl.new_tensor(kl_min / world))
        return warm * kl * lambda_kl
    return warm * kl.clamp(min=kl_min) * lambda_kl


def pitch_losses(f0_pred, f0, uv, mel2ph, lambda_uv: float, lambda_f0: float,
                 w=None, n_frames=None, n_voiced=None):
    """(uv BCE over valid frames, f0 L1 over voiced valid frames), each
    times its λ."""
    nonpadding = _nonpadding(mel2ph, w)
    bce = F.binary_cross_entropy_with_logits(f0_pred[..., 1], uv,
                                             reduction="none")
    voiced = nonpadding * (uv == 0).float()
    uv_loss = (bce * nonpadding).sum() / _denominator(nonpadding.sum(),
                                                      n_frames)
    f0_loss = ((f0_pred[..., 0] - f0).abs() * voiced).sum() \
        / _denominator(voiced.sum(), n_voiced)
    return uv_loss * lambda_uv, f0_loss * lambda_f0


def ctc_loss(log_probs, mel_lengths, text_tokens, text_lengths,
             lambda_ctc: float, w=None, n_items=None) -> torch.Tensor:
    """CTC (blank 0) of ``log_probs`` [B, T, V] against the text tokens:
    infeasible items (fewer valid frames than labels) count 0, each item is
    divided by its label count, then a weighted mean times λ."""
    per_seq = F.ctc_loss(log_probs.transpose(0, 1), text_tokens.long(),
                         mel_lengths.long(), text_lengths.long(), blank=0,
                         reduction="none", zero_infinity=True)
    per_seq = per_seq / text_lengths.float().clamp(min=1.0)
    wb = _weights(per_seq, w)
    return (per_seq * wb).sum() / _denominator(wb.sum(), n_items) \
        * lambda_ctc


def _per_item_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(1)


def _weighted_mean(per_item: torch.Tensor, wb: torch.Tensor,
                   count: torch.Tensor) -> torch.Tensor:
    return (per_item * wb).sum() / count


def discriminator_loss(real_scores, fake_scores, w=None,
        n_items=None) -> torch.Tensor:
    """LSGAN: Σ_d mean((1 - D(y))²) + mean(D(G(z))²)."""
    loss = 0.0
    wb = _weights(real_scores[0], w)
    count = _denominator(wb.sum(), n_items)
    for r, g in zip(real_scores, fake_scores):
        loss = loss + _weighted_mean(_per_item_mean((1.0 - r).square()), wb,
                                     count) \
            + _weighted_mean(_per_item_mean(g.square()), wb, count)
    return loss


def generator_adv_loss(fake_scores, w=None,
        n_items=None) -> torch.Tensor:
    """LSGAN generator: Σ_d mean((1 - D(G(z)))²)."""
    loss = 0.0
    wb = _weights(fake_scores[0], w)
    count = _denominator(wb.sum(), n_items)
    for g in fake_scores:
        loss = loss + _weighted_mean(_per_item_mean((1.0 - g).square()), wb,
                                     count)
    return loss


def feature_matching_loss(fmap_real, fmap_fake, w=None,
        n_items=None) -> torch.Tensor:
    """Σ of the L1 distance over every feature map of every
    sub-discriminator; the real maps take no gradient."""
    loss = 0.0
    wb = _weights(fmap_real[0][0], w)
    count = _denominator(wb.sum(), n_items)
    for fr, ff in zip(fmap_real, fmap_fake):
        for r, f in zip(fr, ff):
            loss = loss + _weighted_mean(_per_item_mean((r.detach() - f).abs()),
                                         wb, count)
    return loss
