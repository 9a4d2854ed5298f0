"""Model FLOPs of one VITS training step (``vits_train`` cells), counted
as ``counters.py`` counts VISinger's: the matrix products and
convolutions the plain reference (``reference/vits.py``) computes at the
padded shapes, 2 per multiply-add, each forward and in training the
gradients autograd computes for it (none for an input without gradient:
the spectrogram, the duration predictor's detached input and its
durations, the alignment's costs and path), a grouped convolution's
weight gradient as one forward.  Held to ``torch.utils.flop_counter`` on
the reference in ``tests/test_bench_vits.py``."""

from __future__ import annotations

import counters
from counters import ADAM_FLOPS, Tally, _conv


def _text_encoder(tally, b, n, cfg):
    h, heads, w = cfg.hidden_size, cfg.num_heads, cfg.attn_window_size
    dk, nb, k = h // heads, 2 * w + 1, cfg.ffn_kernel_size
    for _ in range(cfg.enc_layers):
        for _ in range(4):                               # q, k, v, o
            tally.add(2.0 * b * n * h * h)
        for fwd in (2.0 * b * heads * n * n * dk, 2.0 * b * heads * n * dk
                    * nb, 2.0 * b * heads * n * n * dk,
                    2.0 * b * heads * n * nb * dk):
            tally.add(fwd)
        _conv(tally, b, n, h, cfg.ffn_filter_channels, k)
        _conv(tally, b, n, cfg.ffn_filter_channels, h, k)
    _conv(tally, b, n, h, 2 * h, 1)                      # proj


def _dds(tally, b, n, fc, k):
    for _ in range(3):
        _conv(tally, b, n, fc, fc, k, groups=fc)
        _conv(tally, b, n, fc, fc, 1)


def _duration_predictor(tally, b, n, cfg):
    fc, k, bins = (cfg.sdp_filter_channels, cfg.sdp_kernel_size,
                   cfg.sdp_num_bins)
    _conv(tally, b, n, cfg.hidden_size, fc, 1, dx=False)   # pre (detached)
    _dds(tally, b, n, fc, k)
    _conv(tally, b, n, fc, fc, 1)                          # proj
    _conv(tally, b, n, 1, fc, 1, dx=False)                 # post_pre (w)
    _dds(tally, b, n, fc, k)
    _conv(tally, b, n, fc, fc, 1)                          # post_proj
    for _ in range(cfg.sdp_n_flows + 4):                   # ConvFlows
        _conv(tally, b, n, 1, fc, 1)
        _dds(tally, b, n, fc, k)
        _conv(tally, b, n, fc, 3 * bins - 1, 1)


def train_step_flops(cfg, b: int, n: int, t: int, n_params: int = 0) -> float:
    """Model FLOPs of one VITS GAN step on ``b`` items padded to ``n``
    tokens and ``t`` frames; ``n_params`` parameters updated."""
    tally = Tally(train=True)
    h, seg, bins = cfg.hidden_size, cfg.segment_size, cfg.num_linear_bins
    _text_encoder(tally, b, n, cfg)
    # the linear spectrogram: frames @ cos and @ sin
    tally.add(2.0 * b * t * cfg.fft_size * 2 * bins, False, False)
    tally.add(2.0 * b * t * h * bins, dx=False)            # posterior pre
    counters._wavenet(tally, b, t, h, cfg.posterior_wn_layers,
                      cfg.posterior_wn_kernel, 0)
    _conv(tally, b, t, h, 2 * h, 1)                        # posterior proj
    counters._flow(tally, b, t, cfg)
    tally.add(2 * 2.0 * b * t * h * n, False, False)       # neg_cent
    _duration_predictor(tally, b, n, cfg)
    tally.add(2 * 2.0 * b * t * n * h, True, False)        # path @ m_p, logs_p
    counters._decoder(tally, b, seg, cfg)
    # the mel of the whole spectrogram (target), of the generated slice
    tally.add(2.0 * b * t * bins * cfg.num_mel_bins, False, False)
    tally.add(2.0 * b * seg * cfg.fft_size * 2 * bins, True, False)
    tally.add(2.0 * b * seg * bins * cfg.num_mel_bins, True, False)
    length = seg * cfg.hop_size
    counters._discriminators(tally, 2 * b, length, cfg, True, True, False)
    counters._discriminators(tally, 2 * b, length, cfg, False, True, True)
    return tally.flops + ADAM_FLOPS * n_params
