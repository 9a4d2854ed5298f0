"""VISinger synthesis (counterpart of the JAX package's
``models/visinger.py``, infer branch).

Score tokens -> TextEncoder (length-regulated) -> + frame positions ->
PitchPredictor (predicted log-f0 gated by the voiced flag) -> FramePrior
(mu_p, logs_p) -> z_p = mu_p + eps * exp(logs_p) -> flow reverse ->
HiFi-GAN.  The public methods keep the JAX layout at their boundary
([B, T, H] latents, [B, T, 1] masks, [B, T*hop] waveforms); inside, modules
run [B, C, T].  The training branch comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from visinger_tpu_torch.config import Config
from visinger_tpu_torch.modules.common import positional_embedding
from visinger_tpu_torch.modules.encoders import (FramePriorNetwork,
                                                 PitchPredictor, TextEncoder)
from visinger_tpu_torch.modules.flow import ResidualCouplingBlock
from visinger_tpu_torch.modules.hifigan import HiFiGANGenerator


def _ct(a: torch.Tensor) -> torch.Tensor:
    """[B, T, C] <-> [B, C, T]."""
    return a.transpose(1, 2)


def _sample(stats: dict, eps, generator) -> torch.Tensor:
    """z_p = (mu_p + eps * exp(logs_p)) * mask; eps [B, T, H] is drawn from
    ``generator`` when None."""
    mu_p = stats["mu_p"]
    if eps is None:
        eps = torch.randn(mu_p.shape, generator=generator, device=mu_p.device,
                          dtype=mu_p.dtype)
    return (mu_p + eps * torch.exp(stats["logs_p"])) * stats["tgt_nonpadding"]


class VISinger(nn.Module):
    def __init__(self, cfg: Config, ph_vocab: int, pitch_vocab: int,
                 dur_vocab: int):
        super().__init__()
        if cfg.use_spk_embed:
            raise NotImplementedError(
                "use_spk_embed (voice-embedding input) is not ported yet")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype}: this slice runs float32")
        self.cfg = cfg
        h = cfg.hidden_size
        w = cfg.attn_window_size
        self.text_encoder = TextEncoder(
            ph_vocab, pitch_vocab, dur_vocab, h, cfg.ffn_filter_channels,
            cfg.num_heads, cfg.enc_layers, cfg.ffn_kernel_size, w,
            use_pos_embed=True)
        gin = cfg.gin_channels if cfg.use_spk_id else 0
        if cfg.use_spk_id:
            self.spk_id_proj = nn.Embedding(cfg.num_spk, cfg.gin_channels)
            nn.init.normal_(self.spk_id_proj.weight, 0.0,
                            cfg.gin_channels ** -0.5)
        if cfg.use_pitch_embed:
            self.pitch_predictor = PitchPredictor(
                h, cfg.ffn_filter_channels, cfg.num_heads,
                cfg.pitch_predictor_layers, cfg.ffn_kernel_size, w, gin)
        self.frame_prior = FramePriorNetwork(
            h, cfg.ffn_filter_channels, cfg.num_heads, cfg.frame_prior_layers,
            cfg.ffn_kernel_size, w, 1 if cfg.use_pitch_embed else 0)
        self.flow = ResidualCouplingBlock(
            h, h, cfg.flow_wn_kernel, cfg.flow_wn_layers, cfg.flow_n_flows,
            gin)
        self.decoder = HiFiGANGenerator(
            h, str(cfg.dec_blocks), tuple(cfg.dec_kernel_size),
            tuple(tuple(d) for d in cfg.dec_dilation_sizes),
            tuple(cfg.upsample_rates), cfg.initial_upsample_channels,
            tuple(cfg.upsample_kernel_sizes), gin)

    def speaker_embedding(self, spk_id) -> torch.Tensor | None:
        """-> [B, 1, gin] or None."""
        if self.cfg.use_spk_id and spk_id is not None:
            return self.spk_id_proj(spk_id)[:, None, :]
        return None

    def forward_pitch(self, pitch_inp, spk_emb, tgt_nonpadding):
        """Infer branch: predicted log-f0 gated by the predicted voiced flag
        (uv logit <= 0).  Returns (cond_f0 [B, T, 1], pitch_pred [B, T, 2])."""
        pitch_pred = _ct(self.pitch_predictor(
            _ct(pitch_inp), _ct(tgt_nonpadding),
            None if spk_emb is None else _ct(spk_emb)))
        f0 = pitch_pred[..., 0]
        voiced = pitch_pred[..., 1] <= 0
        cond = (f0 * voiced.to(f0.dtype))[..., None] * tgt_nonpadding
        return cond, pitch_pred

    def prior_stats(self, text_tokens, pitch_tokens, dur_tokens, mel2ph,
                    spk_id=None) -> dict:
        """Everything that needs global attention: -> {mu_p, logs_p
        [B, T, H], tgt_nonpadding [B, T, 1], f0_pred [B, T, 2]}."""
        cfg = self.cfg
        tgt = (mel2ph > 0).float()[..., None]
        prior_inp = self.text_encoder(
            text_tokens, pitch_tokens, dur_tokens, mel2ph) * tgt
        if cfg.use_pos_embed:
            prior_inp = prior_inp + positional_embedding(tgt[..., 0],
                                                         cfg.hidden_size)
        spk_emb = self.speaker_embedding(spk_id)
        ret = {"tgt_nonpadding": tgt}
        cond = None
        if cfg.use_pitch_embed:
            cond, ret["f0_pred"] = self.forward_pitch(prior_inp, spk_emb, tgt)
        mu_p, logs_p = self.frame_prior(
            _ct(prior_inp), _ct(tgt), g=None if cond is None else _ct(cond))
        ret["mu_p"], ret["logs_p"] = _ct(mu_p), _ct(logs_p)
        return ret

    def infer_prior(self, text_tokens, pitch_tokens, dur_tokens, mel2ph,
                    spk_id=None, eps=None, generator=None):
        """Score -> sampled prior latent.  ``eps`` [B, T, H] is the prior
        noise; when None it is drawn from ``generator``.  Returns
        (z_p [B, T, H], tgt_nonpadding [B, T, 1])."""
        st = self.prior_stats(text_tokens, pitch_tokens, dur_tokens, mel2ph,
                              spk_id)
        return _sample(st, eps, generator), st["tgt_nonpadding"]

    def decode_frames(self, z_p, tgt_nonpadding, spk_id=None):
        """Flow reverse + HiFi-GAN: z_p [B, T, H] -> waveform [B, T*hop]."""
        g = self.speaker_embedding(spk_id)
        g = None if g is None else _ct(g)
        mask = _ct(tgt_nonpadding)
        z_q = self.flow(_ct(z_p), mask, g=g, reverse=True).float() * mask
        return self.decoder(z_q * mask, g=g)

    def forward(self, text_tokens, pitch_tokens, dur_tokens, mel2ph,
                spk_id=None, infer: bool = True, eps=None, generator=None):
        """``infer=True``: the same computation as the JAX ``__call__``'s
        infer branch -> {mu_p, logs_p, f0_pred, wav_out}."""
        if not infer:
            raise NotImplementedError("the training branch is not ported yet")
        ret = self.prior_stats(text_tokens, pitch_tokens, dur_tokens, mel2ph,
                               spk_id)
        z_p = _sample(ret, eps, generator)
        tgt = ret.pop("tgt_nonpadding")
        ret["wav_out"] = self.decode_frames(z_p, tgt, spk_id)
        return ret
