"""The ``visinger_csd`` recipe as a Python dataclass (no YAML).

Holds the values the synthesis path, the MIDI front end, serving and the
training step read, copied from the JAX package's
``config/defaults/{visinger,csd,base}.yaml``; a CPU test holds every field
against ``load_config(name="visinger_csd")`` (for the keys the YAML leaves
out, against the default the JAX code reads them with).  The TPU-only knobs
(``attn_impl``, ``use_pallas``, ``decoder_time_fold``/``decoder_polyphase``,
``grouped_conv_impl``) have no counterpart: the port has one path.

``frame_buckets`` and ``token_buckets`` are kept for their numerics, not for
compiled programs: ``VISingerInfer`` pads each score to its bucket edges as
the JAX package does, because the reproduced token positions
(``modules/encoders.py``) depend on the padded token count and every decoder
conv adds its bias on padded frames.  So a score's audio depends on the score
alone and equals the JAX package's for the same noise.

Settings this port does not run yet raise ``NotImplementedError`` when a
model, a server or a train step is built, and so do widths the CUDA kernels
do not take when it is built for a CUDA device (``check_supported``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from dataclasses import dataclass


class Args(Mapping):
    """A read-only mapping whose keys are also attributes: the recipe's
    argument dicts (``preprocess_args``, ``binarization_args``).  List values
    are stored as tuples."""

    def __init__(self, items=(), **more):
        data = dict(items, **more)
        object.__setattr__(self, "_data", {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in data.items()})

    def __getitem__(self, key):
        return self._data[key]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __getattr__(self, key):
        data = self.__dict__.get("_data", {})
        if key not in data:
            raise AttributeError(key)
        return data[key]

    def __reduce__(self):
        return Args, (self._data,)

    def __setattr__(self, key, value):
        raise AttributeError("Args is read-only")

    def __hash__(self):
        return hash(tuple(self._data.items()))

    def __repr__(self):
        return f"Args({self._data!r})"


PREPROCESS_ARGS = Args(
    use_text=True, text_processor="ko_sing", add_eos_bos=True, use_midi=True,
    DEFAULT_TEMPO=120, pos_resolution=16, max_durations=8,
    max_ts_denominator=6, max_notes_per_bar=2, max_note_dur=5.0,
    beat_note_factor=4, min_sil_dur=8, num_frame=3,
    wav_processors=["resample"])
BINARIZATION_ARGS = Args(
    shuffle=True, with_spk_embed=False, with_f0cwt=False, min_text=6,
    max_durations=8, pos_resolution=16, tempo_range=[16, 256], with_f0=True,
    min_sil_duration=0.0, dataset_range="index", train_range=[100, -1],
    test_range=[0, 50], valid_range=[50, 100])


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
    # the MIDI front end and serving
    binary_data_dir: str = "./data/binarize/svs/csd"
    preprocess_args: Args = PREPROCESS_ARGS
    binarization_args: Args = BINARIZATION_ARGS
    note_range: tuple = (12, 128)
    frame_buckets: tuple = (160, 320, 480, 640, 800, 960, 1120, 1280)
    token_buckets: tuple = (48, 96, 144, 192, 240, 288, 336, 384)
    stream_infer: bool = False
    stream_chunk_frames: int = 256
    out_wav_norm: bool = True
    sp_infer: bool = False
    griffin_lim_iters: int = 30

    def replace(self, **overrides) -> "Config":
        return dataclasses.replace(self, **overrides)


def check_supported(cfg: Config, device=None) -> None:
    """Raise ``NotImplementedError`` for a setting this port does not run
    yet, rather than ignoring it; for a build on a CUDA ``device``, also for
    a width the CUDA kernels do not take (K1 and K3: a head width that is
    not a multiple of 8 or is above 128; K2: channels not a multiple of 32).
    On the CPU the plain versions run any width.  ``sp_infer`` together
    with ``stream_infer`` raises ``ValueError``."""
    if cfg.sp_infer and cfg.stream_infer:
        raise ValueError(
            "sp_infer and stream_infer are mutually exclusive: "
            "sequence-parallel decoding shards one full-length program "
            "over the mesh while streaming chunks a single device's "
            "decode; pick one (configs: sp_infer / stream_infer)")
    unsupported = {
        "use_spk_embed": cfg.use_spk_embed,
        "compute_dtype != float32": cfg.compute_dtype != "float32",
        "use_spectral_norm": cfg.use_spectral_norm,
        "accumulate_grad_batches > 1": cfg.accumulate_grad_batches > 1,
        "remat_policy != none": cfg.remat_policy != "none",
        "sp_infer": cfg.sp_infer,
    }
    if str(device).startswith("cuda"):
        h, heads = cfg.hidden_size, cfg.num_heads
        dk = h // heads
        unsupported.update({
            f"hidden_size {h} not a multiple of num_heads {heads}": h % heads,
            f"head width {dk} on CUDA (K1/K3 take a multiple of 8, at most "
            "128)": dk % 8 or dk > 128,
            f"hidden_size {h} on CUDA (K2 takes a multiple of 32)": h % 32,
        })
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
