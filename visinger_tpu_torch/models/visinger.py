"""VISinger (counterpart of the JAX package's ``models/visinger.py``).

Infer: score tokens -> TextEncoder (length-regulated) -> + frame positions
-> PitchPredictor (predicted log-f0 gated by the voiced flag) -> FramePrior
(mu_p, logs_p) -> z_p = mu_p + eps * exp(logs_p) -> flow reverse ->
HiFi-GAN.  Train (``forward(infer=False)``): the same prior with the
teacher-forced log-f0, the posterior on the linear spectrogram (z_q), the
phoneme CTC head, flow z_q -> z_p, the KL, a random ``segment_size`` slice
of z_q and its decode.  The public methods keep the JAX layout at their
boundary ([B, T, H] latents, [B, T, 1] masks, [B, T*hop] waveforms);
inside, modules run [B, C, T].  In training mode (``model.train()``)
dropout is on, its masks drawn from the ``generator`` passed in.
"""

from __future__ import annotations

import torch
from torch import nn

from visinger_tpu_torch.config import Config, check_supported
from visinger_tpu_torch.modules.common import positional_embedding
from visinger_tpu_torch.modules.encoders import (FramePriorNetwork,
                                                 PhonemePredictor,
                                                 PitchPredictor,
                                                 PosteriorEncoder, TextEncoder)
from visinger_tpu_torch.modules.flow import ResidualCouplingBlock
from visinger_tpu_torch.modules.hifigan import HiFiGANGenerator
from visinger_tpu_torch.ops.masking import rand_slice_segments


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
        check_supported(cfg)
        self.cfg = cfg
        h = cfg.hidden_size
        w = cfg.attn_window_size
        drop = cfg.p_dropout
        self.text_encoder = TextEncoder(
            ph_vocab, pitch_vocab, dur_vocab, h, cfg.ffn_filter_channels,
            cfg.num_heads, cfg.enc_layers, cfg.ffn_kernel_size, w,
            use_pos_embed=True, p_dropout=drop)
        gin = cfg.gin_channels if cfg.use_spk_id else 0
        if cfg.use_spk_id:
            self.spk_id_proj = nn.Embedding(cfg.num_spk, cfg.gin_channels)
            nn.init.normal_(self.spk_id_proj.weight, 0.0,
                            cfg.gin_channels ** -0.5)
        if cfg.use_pitch_embed:
            self.pitch_predictor = PitchPredictor(
                h, cfg.ffn_filter_channels, cfg.num_heads,
                cfg.pitch_predictor_layers, cfg.ffn_kernel_size, w, gin, drop)
        if cfg.use_phoneme_pred:
            self.phoneme_predictor = PhonemePredictor(
                ph_vocab, h, cfg.ffn_filter_channels, cfg.num_heads,
                cfg.phoneme_predictor_layers, cfg.ffn_kernel_size, w, drop)
        self.frame_prior = FramePriorNetwork(
            h, cfg.ffn_filter_channels, cfg.num_heads, cfg.frame_prior_layers,
            cfg.ffn_kernel_size, w, 1 if cfg.use_pitch_embed else 0, drop)
        # the posterior's and the flow's WaveNets have no dropout, as in the
        # JAX package
        self.posterior_encoder = PosteriorEncoder(
            cfg.num_linear_bins, h, h, cfg.posterior_wn_kernel,
            cfg.posterior_wn_layers, gin, cfg.logs_clamp)
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

    def forward_pitch(self, pitch_inp, spk_emb, tgt_nonpadding, f0=None,
                      uv=None, generator=None):
        """Pitch prediction and the frame prior's condition.  Infer
        (``f0`` None): the predicted log-f0 gated by the predicted voiced
        flag (uv logit <= 0); train: the given f0 gated by uv == 0.  The
        predictor's input gradient is scaled by ``predictor_grad``.  Returns
        (cond_f0 [B, T, 1], pitch_pred [B, T, 2])."""
        grad_scale = self.cfg.predictor_grad
        if grad_scale != 1:
            sg = pitch_inp.detach()
            pitch_inp = sg + grad_scale * (pitch_inp - sg)
        pitch_pred = _ct(self.pitch_predictor(
            _ct(pitch_inp), _ct(tgt_nonpadding),
            None if spk_emb is None else _ct(spk_emb), generator=generator))
        if f0 is None:
            f0 = pitch_pred[..., 0]
            voiced = pitch_pred[..., 1] <= 0
        else:
            voiced = uv == 0
        cond = (f0 * voiced.to(f0.dtype))[..., None] * tgt_nonpadding
        return cond, pitch_pred

    def prior_stats(self, text_tokens, pitch_tokens, dur_tokens, mel2ph,
                    spk_id=None, f0=None, uv=None, generator=None) -> dict:
        """Everything that needs global attention: -> {mu_p, logs_p
        [B, T, H], tgt_nonpadding [B, T, 1], f0_pred [B, T, 2]}; ``f0``/``uv``
        [B, T] teacher-force the pitch condition (training)."""
        cfg = self.cfg
        tgt = (mel2ph > 0).float()[..., None]
        prior_inp = self.text_encoder(
            text_tokens, pitch_tokens, dur_tokens, mel2ph,
            generator=generator) * tgt
        if cfg.use_pos_embed:
            prior_inp = prior_inp + positional_embedding(tgt[..., 0],
                                                         cfg.hidden_size)
        spk_emb = self.speaker_embedding(spk_id)
        ret = {"tgt_nonpadding": tgt}
        cond = None
        if cfg.use_pitch_embed:
            cond, ret["f0_pred"] = self.forward_pitch(
                prior_inp, spk_emb, tgt, f0, uv, generator)
        mu_p, logs_p = self.frame_prior(
            _ct(prior_inp), _ct(tgt), g=None if cond is None else _ct(cond),
            generator=generator)
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
                spk_id=None, infer: bool = True, eps=None, generator=None,
                f0=None, uv=None, spec=None, lengths=None, item_weights=None,
                eps_q=None, ids_slice=None):
        """The JAX ``__call__``.  ``infer=True`` -> {mu_p, logs_p, f0_pred,
        wav_out}.  ``infer=False`` (training) also takes ``f0``/``uv``
        [B, T], the linear spectrogram ``spec`` [B, T, num_linear_bins],
        ``lengths`` (valid frames, for the slice draw) and ``item_weights``
        [B] (KL weights), and returns {mu_p, logs_p, f0_pred, ph_pred, z_p,
        z_q, mu_q, logs_q, kl, ids_slice, wav_out}.  The posterior noise
        ``eps_q`` [B, T, H] and the slice starts ``ids_slice`` [B] are drawn
        from ``generator`` unless given."""
        if infer:
            ret = self.prior_stats(text_tokens, pitch_tokens, dur_tokens,
                                   mel2ph, spk_id)
            z_p = _sample(ret, eps, generator)
            tgt = ret.pop("tgt_nonpadding")
            ret["wav_out"] = self.decode_frames(z_p, tgt, spk_id)
            return ret
        cfg = self.cfg
        ret = self.prior_stats(text_tokens, pitch_tokens, dur_tokens, mel2ph,
                               spk_id, f0, uv, generator)
        tgt = ret.pop("tgt_nonpadding")
        mask = _ct(tgt)
        g = self.speaker_embedding(spk_id)
        g = None if g is None else _ct(g)
        z_q, mu_q, logs_q = self.posterior_encoder(
            _ct(spec), mask, g=g, eps=None if eps_q is None else _ct(eps_q),
            generator=generator)
        if cfg.use_phoneme_pred:
            ret["ph_pred"] = _ct(self.phoneme_predictor(
                z_q, mask, generator=generator) * mask)
        z_p = self.flow(z_q, mask, g=g).float() * mask
        ret["z_p"], ret["z_q"] = _ct(z_p), _ct(z_q)
        ret["mu_q"], ret["logs_q"] = _ct(mu_q), _ct(logs_q)
        mu_p, logs_p = _ct(ret["mu_p"]), _ct(ret["logs_p"])
        if cfg.logs_clamp > 0:
            logs_p = logs_p.clamp(-cfg.logs_clamp, cfg.logs_clamp)
            logs_q = logs_q.clamp(-cfg.logs_clamp, cfg.logs_clamp)
        kl = (logs_p - logs_q - 0.5) \
            + 0.5 * (z_p - mu_p).square() * torch.exp(-2.0 * logs_p)
        # the numerator sums channels and frames, the denominator counts
        # valid frames
        kl_mask = mask
        if item_weights is not None:
            kl_mask = kl_mask * item_weights.float()[:, None, None]
        ret["kl"] = (kl * kl_mask).sum() / kl_mask.sum().clamp(min=1.0)
        z_slice, ret["ids_slice"] = rand_slice_segments(
            ret["z_q"], cfg.segment_size,
            None if cfg.slice_ref_padded else lengths, generator, ids_slice)
        ret["wav_out"] = self.decoder(_ct(z_slice), g=g)
        return ret
