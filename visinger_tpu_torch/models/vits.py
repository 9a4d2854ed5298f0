"""VITS (Kim et al. 2021, arXiv:2106.06103; jaywalnut310/vits
``models.py::SynthesizerTrn`` with ``use_sdp=True``), the port's second
architecture, trained by the same ``TrainStep`` as VISinger.

Training (``forward``), as upstream's:
  - text tokens -> embedding · sqrt(H) -> relative encoder (K1/K3, FFN
    kernel 3 on both convolutions, LayerNorm eps 1e-5) -> 1x1 ->
    (m_p, logs_p) at token rate;
  - the linear spectrogram -> posterior encoder (K2) -> z, (m_q, logs_q);
    z_p = flow(z) (K2);
  - monotonic alignment search (``ops/mas.py``) on ``neg_cent`` of z_p
    under the token priors: the token of every frame;
  - the durations w (frames a token), and the stochastic duration
    predictor's nll + log q of w on the detached encoder output,
    ``dur`` = Σ over items / Σ of the token mask;
  - m_p, logs_p expanded to the frames along the path; the KL as
    VISinger's (valid frames in the denominator);
  - a random ``segment_size`` slice of z into HiFi-GAN.

The public layout is the port's: spectrograms [B, T, bins], latents
[B, T, H] at the boundary.  The posterior noise ``eps_q`` [B, T, H], the
slice starts ``ids_slice`` and the duration predictor's noise ``e_q``
[B, 2, T_x] may be given; otherwise they, and every dropout mask, are drawn
from ``generator`` in upstream's order (encoder, posterior, duration
predictor, slice).  The expansion gathers each frame's token (upstream
multiplies by the one-hot path: the same values).  VITS has no speaker
condition here (``gin_channels`` 0, LJSpeech is one voice).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from visinger_tpu_torch.config import Config, check_supported
from visinger_tpu_torch.modules.common import Conv1d
from visinger_tpu_torch.modules.encoders import PosteriorEncoder
from visinger_tpu_torch.modules.flow import ResidualCouplingBlock
from visinger_tpu_torch.modules.hifigan import HiFiGANGenerator
from visinger_tpu_torch.modules.sdp import StochasticDurationPredictor
from visinger_tpu_torch.modules.transformer import RelativeEncoder
from visinger_tpu_torch.ops import mas
from visinger_tpu_torch.ops.masking import rand_slice_segments, sequence_mask
from visinger_tpu_torch.training.losses import kl_divergence
from visinger_tpu_torch.utils.meters import span


def _ct(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(1, 2)


class TextEncoder(nn.Module):
    """tokens [B, N] and lengths -> (x, m_p, logs_p [B, H, N], mask
    [B, 1, N])."""

    def __init__(self, n_vocab: int, cfg: Config):
        super().__init__()
        h = cfg.hidden_size
        self.hidden = h
        self.emb = nn.Embedding(n_vocab, h)
        nn.init.normal_(self.emb.weight, 0.0, h ** -0.5)
        self.encoder = RelativeEncoder(
            h, cfg.ffn_filter_channels, cfg.num_heads, cfg.enc_layers,
            cfg.ffn_kernel_size, cfg.attn_window_size, 0, cfg.p_dropout,
            ffn_out_kernel=cfg.ffn_kernel_size, ln_eps=1e-5)
        self.proj = Conv1d(h, 2 * h, 1)

    def forward(self, tokens, lengths, generator=None):
        x = _ct(self.emb(tokens) * math.sqrt(self.hidden))
        mask = sequence_mask(lengths, tokens.shape[1]).float()[:, None]
        x = self.encoder(x * mask, mask, generator=generator)
        stats = self.proj(x) * mask
        return x, stats[:, :self.hidden], stats[:, self.hidden:], mask


def alignment(z_p, m_p, logs_p, t_x, t_y) -> torch.Tensor:
    """The MAS path, [B, T_y] tokens, of ``z_p`` [B, H, T_y] under the
    token priors, for the host lengths ``t_x`` and ``t_y``."""
    b, ty, tx = z_p.shape[0], z_p.shape[2], m_p.shape[2]
    cells = int(sum(int(a) * int(c) for a, c in zip(t_x, t_y)))
    moved = 4 * b * ty * tx + 8 * b * ty
    with span("model.mas", cells=cells, bytes=moved):
        cost = mas.neg_cent(z_p, m_p, logs_p)
        return mas.maximum_path(cost, t_x, t_y)


class VITS(nn.Module):
    def __init__(self, cfg: Config, n_vocab: int):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        h = cfg.hidden_size
        self.text_encoder = TextEncoder(n_vocab, cfg)
        self.posterior_encoder = PosteriorEncoder(
            cfg.num_linear_bins, h, h, cfg.posterior_wn_kernel,
            cfg.posterior_wn_layers, 0, cfg.logs_clamp)
        self.flow = ResidualCouplingBlock(
            h, h, cfg.flow_wn_kernel, cfg.flow_wn_layers, cfg.flow_n_flows)
        self.decoder = HiFiGANGenerator(
            h, str(cfg.dec_blocks), tuple(cfg.dec_kernel_size),
            tuple(tuple(d) for d in cfg.dec_dilation_sizes),
            tuple(cfg.upsample_rates), cfg.initial_upsample_channels,
            tuple(cfg.upsample_kernel_sizes))
        self.dp = StochasticDurationPredictor(
            h, cfg.sdp_filter_channels, cfg.sdp_kernel_size,
            cfg.sdp_p_dropout, cfg.sdp_n_flows, 0, cfg.sdp_num_bins,
            cfg.sdp_tail_bound)

    def forward(self, text_tokens, text_lengths, spec, spec_lengths,
                generator=None, eps_q=None, ids_slice=None, e_q=None,
                item_weights=None, kl_count=None) -> dict:
        """``spec`` [B, T, bins]; lengths [B] -> {kl, dur, wav_out,
        ids_slice}: the terms ``TrainStep`` sums (the raw KL, the duration
        loss) and the generated slice with its starts."""
        cfg = self.cfg
        gen = generator if self.training else None
        with span("model.prior"):
            x, m_p, logs_p, x_mask = self.text_encoder(text_tokens,
                                                       text_lengths, gen)
        y_mask = sequence_mask(spec_lengths, spec.shape[1]).float()[:, None]
        with span("model.posterior"):
            z, _, logs_q = self.posterior_encoder(
                _ct(spec), y_mask, eps=None if eps_q is None else _ct(eps_q),
                generator=generator)
        with span("model.flow"):
            z_p = self.flow(z, y_mask)
        # the lengths on the host: the wait for the forward so far falls
        # here, before the alignment's span
        t_x, t_y = torch.stack([text_lengths, spec_lengths]).cpu().numpy()
        path = alignment(z_p, m_p, logs_p, t_x, t_y)
        w = torch.zeros_like(x_mask[:, 0]).scatter_add_(
            1, path, y_mask[:, 0])[:, None]                  # [B, 1, N]
        with span("model.sdp"):
            nll = self.dp(x, x_mask, w, generator=gen, e_q=e_q)
            dur = nll.sum() / x_mask.sum()
        idx = path[:, None].expand(-1, m_p.shape[1], -1)
        m_f = torch.gather(m_p, 2, idx) * y_mask
        logs_f = torch.gather(logs_p, 2, idx) * y_mask
        kl = kl_divergence(z_p, m_f, logs_f, logs_q, y_mask, item_weights,
                           kl_count)
        z_slice, ids = rand_slice_segments(_ct(z), cfg.segment_size,
                                           spec_lengths, generator,
                                           ids_slice)
        with span("model.decoder"):
            wav = self.decoder(_ct(z_slice))
        return {"kl": kl, "dur": dur, "wav_out": wav, "ids_slice": ids}
