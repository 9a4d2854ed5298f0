"""The ``visinger_csd`` recipe as a Python dataclass (no YAML).

Holds the values the synthesis path and the training step read, copied from
the JAX package's ``config/defaults/{visinger,csd,base}.yaml``; a CPU test
holds every field against ``load_config(name="visinger_csd")`` (for the keys
the YAML leaves out, against the default the JAX code reads them with).  The
TPU-only knobs (``attn_impl``, ``use_pallas``,
``decoder_time_fold``/``decoder_polyphase``, ``grouped_conv_impl``,
frame/token buckets) have no counterpart: the port has one path.  Settings
this port does not run yet raise ``NotImplementedError`` when a model or a
train step is built (``check_supported``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    hidden_size: int = 192
    ffn_filter_channels: int = 768
    ffn_kernel_size: int = 9
    num_heads: int = 2
    attn_window_size: int = 4
    p_dropout: float = 0.1
    enc_layers: int = 6
    pitch_predictor_layers: int = 6
    frame_prior_layers: int = 4
    phoneme_predictor_layers: int = 2
    use_phoneme_pred: bool = True
    predictor_grad: float = 0.1
    posterior_wn_layers: int = 16
    posterior_wn_kernel: int = 5
    logs_clamp: float = 0.0
    flow_n_flows: int = 4
    flow_wn_layers: int = 4
    flow_wn_kernel: int = 5
    dec_blocks: str = "1"
    dec_kernel_size: tuple = (3, 7, 11)
    dec_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: tuple = (5, 5, 3, 2, 2)
    upsample_kernel_sizes: tuple = (11, 11, 7, 4, 4)
    initial_upsample_channels: int = 512
    gin_channels: int = 256
    use_spk_id: bool = True
    use_spk_embed: bool = False
    num_spk: int = 1
    use_pitch_embed: bool = True
    use_pos_embed: bool = True
    hop_size: int = 300
    sample_rate: int = 24000
    compute_dtype: str = "float32"
    max_sentences: int = 4
    # training: slices, spectrograms, losses
    segment_size: int = 32
    slice_ref_padded: bool = False
    fft_size: int = 2048
    win_size: int = 1200
    num_mel_bins: int = 128
    num_linear_bins: int = 1025
    fmin: int = 20
    fmax: int = 12000
    mel_losses: str = "l1:45.0"
    lambda_ctc: float = 45.0
    lambda_mel_adv: float = 1.0
    lambda_kl: float = 1.0
    lambda_fm: float = 2.0
    lambda_uv: float = 1.0
    lambda_f0: float = 10.0
    kl_start_steps: int = 1
    kl_min: float = 0.0
    # training: discriminators
    disc_periods: tuple = (2, 3, 5, 7, 11)
    disc_s_base: int = 16
    disc_p_channels: tuple = (32, 128, 512, 1024)
    disc_interval: int = 1
    disc_start_steps: int = 0
    disc_pair_batch: bool = True
    use_spectral_norm: bool = False
    # training: optimizers
    lr: float = 0.0002
    optimizer_adam_beta1: float = 0.8
    optimizer_adam_beta2: float = 0.99
    eps: float = 1e-09
    weight_decay: float = 0.001
    disc_weight_decay: float = 0.0
    scheduler_gamma: float = 0.999875
    clip_grad_norm: float = 1.0
    steps_per_epoch: int = 0     # 0: 280, as the JAX make_optimizers
    accumulate_grad_batches: int = 1
    remat_policy: str = "none"

    def replace(self, **overrides) -> "Config":
        return dataclasses.replace(self, **overrides)


def check_supported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for a setting this port does not run
    yet, rather than ignoring it."""
    unsupported = {
        "use_spk_embed": cfg.use_spk_embed,
        "compute_dtype != float32": cfg.compute_dtype != "float32",
        "use_spectral_norm": cfg.use_spectral_norm,
        "accumulate_grad_batches > 1": cfg.accumulate_grad_batches > 1,
        "remat_policy != none": cfg.remat_policy != "none",
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet")


def visinger_csd() -> Config:
    """The full-width recipe (VISinger on CSD)."""
    return Config()


def tiny_config() -> Config:
    """Unit-test size, the counterpart of the JAX ``models.factory.tiny_config``
    (all structure kept)."""
    return visinger_csd().replace(
        enc_layers=1,
        frame_prior_layers=1,
        pitch_predictor_layers=1,
        phoneme_predictor_layers=1,
        posterior_wn_layers=2,
        flow_n_flows=2,
        flow_wn_layers=1,
        ffn_filter_channels=32,
        hidden_size=16,
        num_heads=2,
        initial_upsample_channels=32,  # must exceed 2**len(upsample_rates)
        gin_channels=8,
        segment_size=8,
        steps_per_epoch=4,
        disc_periods=(2, 3),
        disc_s_base=4,
        disc_p_channels=(8, 16, 32, 32),
    )
