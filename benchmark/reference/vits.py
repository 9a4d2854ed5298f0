"""VITS training in plain PyTorch (jaywalnut310/vits ``models.py::
SynthesizerTrn`` with ``use_sdp=True``, ``mel_processing.py``,
``losses.py``, ``train.py``), float32, for the benchmark's comparison
with the port's ``models/vits.py`` under its ``TrainStep``.

It uses the reference's plain layers (relative attention written out,
the WaveNet stack written out, HiFi-GAN, the discriminators, the GAN
losses, AdamW), ``sdp.py`` and ``mas.py``, and imports nothing of the
program.  Departures from upstream, each for the comparison:
  - the step is the port's order: the generator's loss against the
    discriminator from before the step's update and its AdamW step, then
    the discriminator's on the detached fake (upstream updates the
    discriminator first);
  - float32 throughout, where upstream trains in fp16 AMP;
  - the layers carry the program's parameter names, the text encoder's
    relative encoder is the reference's attention with upstream's FFN
    (kernel 3 on both convolutions) and LayerNorm (eps 1e-5);
  - the posterior noise and the slice starts are given, the dropout masks
    and the duration predictor's noise drawn from the state's generator in
    upstream's order (encoder, posterior noise, duration predictor);
  - the spectrogram's DFT is a product with the window-folded cosine and
    sine matrices (``torch.stft``'s sums), the Slaney mel filterbank
    ``librosa.filters.mel``'s formula in numpy;
  - no clipping: upstream's ``clip_grad_value_(..., None)`` only measures
    the norm; so does the reference."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import losses as L
from . import mas
from .common import ChannelLayerNorm, Conv1d, dropout
from .encoders import PosteriorEncoder
from .flow import ResidualCouplingBlock
from .hifigan import HiFiGANGenerator
from .masking import sequence_mask, slice_segments
from .optim import ClippedAdamW, global_norm
from .sdp import StochasticDurationPredictor
from .train import _grads, device_batch
from .transformer import RelativeMultiHeadAttention


# --- mel_processing.py -------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    mels = f / (200.0 / 3)
    log_t = f >= 1000.0
    mels = np.where(log_t, 15.0 + np.log(np.where(log_t, f, 1000.0) / 1000.0)
                    / (np.log(6.4) / 27.0), mels)
    return mels


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    freqs = (200.0 / 3) * m
    log_t = m >= 15.0
    return np.where(log_t, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                           * (m - 15.0)), freqs)


def librosa_mel(sr, n_fft, n_mels, fmin, fmax) -> np.ndarray:
    """``librosa.filters.mel`` (htk False, norm "slaney") -> [n_mels,
    n_fft // 2 + 1] float32."""
    fmax = sr / 2.0 if fmax is None else fmax
    fftfreqs = np.fft.rfftfreq(n=n_fft, d=1.0 / sr)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)
    weights = np.zeros((n_mels, 1 + n_fft // 2))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, np.newaxis]
    return weights.astype(np.float32)


class Spectrogram:
    """``spectrogram_torch`` and ``mel_spectrogram_torch``: a reflect pad of
    (n_fft - hop) / 2, no centering, a periodic Hann window, magnitude
    sqrt(re² + im² + 1e-6); mel log(clamp(·, 1e-5))."""

    def __init__(self, cfg, device):
        n_fft, win = cfg.fft_size, cfg.win_size
        self.n_fft, self.hop = n_fft, cfg.hop_size
        window = np.zeros(n_fft)
        off = (n_fft - win) // 2
        n = np.arange(win)
        window[off:off + win] = 0.5 - 0.5 * np.cos(2 * np.pi * n / win)
        ang = 2 * np.pi * np.outer(np.arange(n_fft),
                                   np.arange(n_fft // 2 + 1)) / n_fft
        self.cos = torch.from_numpy((window[:, None] * np.cos(ang))
                                    .astype(np.float32)).to(device)
        self.sin = torch.from_numpy((window[:, None] * np.sin(ang))
                                    .astype(np.float32)).to(device)
        self.mel_basis = torch.from_numpy(librosa_mel(
            cfg.sample_rate, n_fft, cfg.num_mel_bins, cfg.fmin,
            cfg.fmax)).to(device)

    def spec(self, y: torch.Tensor) -> torch.Tensor:
        """[B, L] -> [B, bins, L // hop]."""
        pad = int((self.n_fft - self.hop) / 2)
        y = F.pad(y.unsqueeze(1), (pad, pad), mode="reflect").squeeze(1)
        frames = y.unfold(1, self.n_fft, self.hop)
        re, im = frames @ self.cos, frames @ self.sin
        return torch.sqrt(re.pow(2) + im.pow(2) + 1e-6).transpose(1, 2)

    def spec_to_mel(self, spec: torch.Tensor) -> torch.Tensor:
        return torch.log(torch.clamp(torch.matmul(self.mel_basis, spec),
                                     min=1e-5))

    def mel(self, y: torch.Tensor) -> torch.Tensor:
        return self.spec_to_mel(self.spec(y))


# --- models.py ---------------------------------------------------------------

class FFN(nn.Module):
    def __init__(self, channels, filter_channels, kernel_size, p_dropout):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_1 = Conv1d(channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, channels, kernel_size)

    def forward(self, x, x_mask, generator):
        x = self.conv_1(x * x_mask)
        x = torch.relu(x)
        x = dropout(x, self.p_dropout, generator)
        x = self.conv_2(x * x_mask)
        return x * x_mask


class Encoder(nn.Module):
    """``attentions.Encoder`` (window 4, heads sharing the relative
    tables)."""

    def __init__(self, hidden, filter_channels, n_heads, n_layers,
                 kernel_size, window, p_dropout):
        super().__init__()
        self.n_layers, self.p_dropout = n_layers, p_dropout
        for i in range(n_layers):
            self.add_module(f"attn_{i}", RelativeMultiHeadAttention(
                hidden, n_heads, window, p_dropout))
            self.add_module(f"norm1_{i}", ChannelLayerNorm(hidden, 1e-5))
            self.add_module(f"ffn_{i}", FFN(hidden, filter_channels,
                                            kernel_size, p_dropout))
            self.add_module(f"norm2_{i}", ChannelLayerNorm(hidden, 1e-5))

    def forward(self, x, x_mask, generator):
        x = x * x_mask
        for i in range(self.n_layers):
            y = getattr(self, f"attn_{i}")(x, x_mask, generator)
            y = dropout(y, self.p_dropout, generator)
            x = getattr(self, f"norm1_{i}")(x + y)
            y = getattr(self, f"ffn_{i}")(x, x_mask, generator)
            y = dropout(y, self.p_dropout, generator)
            x = getattr(self, f"norm2_{i}")(x + y)
        return x * x_mask


class TextEncoder(nn.Module):
    def __init__(self, n_vocab, cfg):
        super().__init__()
        h = cfg.hidden_size
        self.hidden = h
        self.emb = nn.Embedding(n_vocab, h)
        self.encoder = Encoder(h, cfg.ffn_filter_channels, cfg.num_heads,
                               cfg.enc_layers, cfg.ffn_kernel_size,
                               cfg.attn_window_size, cfg.p_dropout)
        self.proj = Conv1d(h, 2 * h, 1)

    def forward(self, x, x_lengths, generator):
        x = self.emb(x) * math.sqrt(self.hidden)
        x = torch.transpose(x, 1, -1)
        x_mask = torch.unsqueeze(sequence_mask(x_lengths, x.size(2)),
                                 1).to(x.dtype)
        x = self.encoder(x * x_mask, x_mask, generator)
        stats = self.proj(x) * x_mask
        m, logs = torch.split(stats, self.hidden, dim=1)
        return x, m, logs, x_mask


def neg_cent(z_p, m_p, logs_p):
    s_p_sq_r = torch.exp(-2 * logs_p)
    neg_cent1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, [1],
                          keepdim=True)
    neg_cent2 = torch.matmul(-0.5 * (z_p ** 2).transpose(1, 2), s_p_sq_r)
    neg_cent3 = torch.matmul(z_p.transpose(1, 2), (m_p * s_p_sq_r))
    neg_cent4 = torch.sum(-0.5 * (m_p ** 2) * s_p_sq_r, [1], keepdim=True)
    return neg_cent1 + neg_cent2 + neg_cent3 + neg_cent4


class VITS(nn.Module):
    def __init__(self, cfg, n_vocab):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.text_encoder = TextEncoder(n_vocab, cfg)
        self.posterior_encoder = PosteriorEncoder(
            cfg.num_linear_bins, h, h, cfg.posterior_wn_kernel,
            cfg.posterior_wn_layers, 0, cfg.logs_clamp)
        self.flow = ResidualCouplingBlock(h, h, cfg.flow_wn_kernel,
                                          cfg.flow_wn_layers,
                                          cfg.flow_n_flows)
        self.decoder = HiFiGANGenerator(
            h, str(cfg.dec_blocks), tuple(cfg.dec_kernel_size),
            tuple(tuple(d) for d in cfg.dec_dilation_sizes),
            tuple(cfg.upsample_rates), cfg.initial_upsample_channels,
            tuple(cfg.upsample_kernel_sizes))
        self.dp = StochasticDurationPredictor(
            h, cfg.sdp_filter_channels, cfg.sdp_kernel_size,
            cfg.sdp_p_dropout, cfg.sdp_n_flows, cfg.sdp_num_bins,
            cfg.sdp_tail_bound)

    def forward(self, x, x_lengths, y, y_lengths, generator, eps_q,
                ids_slice, hint=None, splits=None):
        """x tokens, y the linear spectrogram [B, bins, T]; eps_q [B, H, T];
        ``hint`` the program's path, followed at ties (``mas.TIE``), and
        ``splits`` as ``mas.path_each``'s -> (o,
        l_length, attn, ids_slice, x_mask, y_mask, (z, z_p, m_p, logs_p,
        m_q, logs_q)) as upstream."""
        x, m_p, logs_p, x_mask = self.text_encoder(x, x_lengths, generator)
        z, m_q, logs_q = self.posterior_encoder(
            y, torch.unsqueeze(sequence_mask(y_lengths, y.size(2)),
                               1).to(y.dtype), eps=eps_q)
        y_mask = torch.unsqueeze(sequence_mask(y_lengths, y.size(2)),
                                 1).to(y.dtype)
        z_p = self.flow(z, y_mask)
        with torch.no_grad():
            cost = neg_cent(z_p, m_p, logs_p)
            attn_mask = torch.unsqueeze(x_mask, 2) * torch.unsqueeze(y_mask,
                                                                     -1)
            attn = mas.maximum_path(cost, attn_mask.squeeze(1), hint,
                                    splits).unsqueeze(1).detach()
        w = attn.sum(2)
        l_length = self.dp(x, x_mask, w, generator=generator)
        l_length = l_length / torch.sum(x_mask)
        m_p = torch.matmul(attn.squeeze(1), m_p.transpose(1, 2)
                           ).transpose(1, 2)
        logs_p = torch.matmul(attn.squeeze(1), logs_p.transpose(1, 2)
                              ).transpose(1, 2)
        z_slice = slice_segments(z.transpose(1, 2), ids_slice,
                                 self.cfg.segment_size).transpose(1, 2)
        o = self.decoder(z_slice)
        return (o, l_length, attn, ids_slice, x_mask, y_mask,
                (z, z_p, m_p, logs_p, m_q, logs_q), cost)


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask):
    kl = logs_p - logs_q - 0.5
    kl += 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2. * logs_p)
    kl = torch.sum(kl * z_mask)
    return kl / torch.sum(z_mask)


class RefVITSStep:
    """One training step of the reference, in place on a
    ``train.RefState``; ``products``: a context manager factory entered
    around the models' calls (the control's precision)."""

    def __init__(self, cfg, model, disc, device, products=None):
        import contextlib

        self.products = products or contextlib.nullcontext
        self.cfg, self.model, self.disc = cfg, model, disc
        self.device = torch.device(device)
        self.audio = Spectrogram(cfg, self.device)
        spe = cfg.steps_per_epoch or 280
        common = dict(lr=cfg.lr, decay_steps=spe, gamma=cfg.scheduler_gamma,
                      b1=cfg.optimizer_adam_beta1,
                      b2=cfg.optimizer_adam_beta2, eps=cfg.eps,
                      max_norm=math.inf)
        self.opt_g = ClippedAdamW(weight_decay=cfg.weight_decay, **common)
        self.opt_d = ClippedAdamW(weight_decay=cfg.disc_weight_decay,
                                  **common)
        self.paths: list = []
        self.splits: list = []

    def __call__(self, state, batch, eps_q, ids_slice, hint=None) -> dict:
        """One step; ``hint``: the program's path of this step ([B, T]
        tokens), which the alignment follows at ties; the relative gap of
        each decision where its own choice left the hint's is appended to
        ``splits``."""
        cfg = self.cfg
        b = device_batch(batch, self.device)
        ids_slice = torch.as_tensor(ids_slice, device=self.device).long()
        eps_q = torch.as_tensor(eps_q, device=self.device).float()
        self.model.train()
        with torch.no_grad():
            spec = self.audio.spec(b["wavs"])
        with self.products():
            (y_hat, l_length, attn, ids_slice, x_mask, z_mask,
             (z, z_p, m_p, logs_p, m_q, logs_q), _) = self.model(
                b["text_tokens"], b["text_lengths"], spec,
                b["mel_lengths"], state.generator, eps_q.transpose(1, 2),
                ids_slice, hint, self.splits)
        self.paths.append(attn[:, 0].argmax(-1).cpu())
        seg, hop = cfg.segment_size, cfg.hop_size
        mel = self.audio.spec_to_mel(spec)
        y_mel = slice_segments(mel.transpose(1, 2), ids_slice,
                               seg).transpose(1, 2)
        y_hat_mel = self.audio.mel(y_hat)
        y = slice_segments(b["wavs"], ids_slice * hop, seg * hop)
        with self.products():
            _, y_d_hat_g, fmap_r, fmap_g = self.disc(y, y_hat)
        loss_dur = torch.sum(l_length.float())
        loss_mel = F.l1_loss(y_mel, y_hat_mel) \
            * L.parse_mel_losses(cfg.mel_losses)["l1"]
        loss_kl = kl_loss(z_p, logs_q, m_p, logs_p, z_mask) * cfg.lambda_kl
        loss_fm = L.feature_matching_loss(fmap_r, fmap_g) * cfg.lambda_fm
        loss_gen = L.generator_adv_loss(y_d_hat_g)
        total = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl
        params_g = list(self.model.parameters())
        grads_g = _grads(total, params_g)
        gnorm = global_norm(grads_g)
        self.opt_g.step(params_g, grads_g, state.opt_state_g)
        real, fake = y.detach(), y_hat.detach()
        with self.products():
            real_scores, fake_scores, _, _ = self.disc(real, fake)
        loss_d = L.discriminator_loss(real_scores, fake_scores)
        params_d = list(self.disc.parameters())
        self.opt_d.step(params_d, _grads(loss_d, params_d),
                        state.opt_state_d)
        state.step += 1
        return {"total_g": total.detach(), "disc": loss_d.detach(),
                "kl": loss_kl.detach(), "mel_l1": loss_mel.detach(),
                "dur": loss_dur.detach(), "adv": loss_gen.detach(),
                "fm": loss_fm.detach(), "gnorm_g": gnorm}
