"""The ``visinger_csd``, ``tpu_run``, ``soak_r5``, ``parity_run`` and
``vits_ljs`` recipes as Python dataclasses (YAML experiment files are read
into a ``Config`` by ``config_loader.py``).

Holds the values the synthesis path, the MIDI front end, serving, the
training step, the trainer, the data pipeline (synthetic corpus,
preprocessing, binarization) and the render/test path read, copied from the
JAX package's ``config/defaults/{visinger,csd,base}.yaml`` and
``configs/{tpu_run,soak_r5}.yaml``; a CPU test holds every field of each recipe
against the YAML (for the keys the YAML leaves out, against the default the
JAX code reads them with).  The TPU-only knobs
(``attn_impl``, ``use_pallas``, ``decoder_time_fold``/``decoder_polyphase``,
``grouped_conv_impl``) have no counterpart: the port has one path, and
``apply`` drops them (``UNREAD_KEYS``).

``frame_buckets`` and ``token_buckets`` are kept for their numerics, not for
compiled programs: ``VISingerInfer`` pads each score to its bucket edges as
the JAX package does, because the reproduced token positions
(``modules/encoders.py``) depend on the padded token count and every decoder
conv adds its bias on padded frames.  So a score's audio depends on the score
alone and equals the JAX package's for the same noise.

``compute_dtype`` "bfloat16" runs every layer in bf16 with float32
parameters, LayerNorm statistics, softmax and distribution statistics, as
the JAX package does; ``bf16_f32_islands`` names subsystems (``ISLANDS``)
that stay float32.  Widths the TPU kernels do not take either raise
``NotImplementedError`` when a model, a server or a train step is built
for a CUDA device (``check_supported``).
"""

from __future__ import annotations

import ast
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


# Keys of the JAX package's experiment files that the port accepts and
# drops (in a YAML or JSON file and in ``--hparams`` alike), each for a
# stated reason; any other unknown key raises ``KeyError``.
UNREAD_KEYS = frozenset({
    # the TPU lowerings of one function, which the port computes one way:
    # the attention kernel's route, the WaveNet kernel's, the decoder's
    # time folding and polyphase upsampling, the grouped convolutions'
    "attn_impl", "use_pallas", "decoder_time_fold", "decoder_polyphase",
    "grouped_conv_impl",
    # carried by the JAX package's defaults and read by no code of either
    # package (the reference's names, kept there for its experiment files)
    "ckpt_save_interval", "ds_workers", "endless_ds", "sort_by_len",
    "frames_multiple", "print_nan_grads", "save_best", "valid_monitor_key",
    "valid_monitor_mode", "gen_dir_name", "max_valid_sentences",
    "max_valid_tokens", "min_frames", "max_input_tokens", "raw_sample_rate",
    "max_wav_value", "f0_resolution", "pitch_key", "loud_norm"})


@dataclass(frozen=True)
class Config:
    # the architecture: "visinger" (score -> frame prior by mel2ph) or
    # "vits" (text -> token prior aligned by monotonic alignment search,
    # stochastic duration predictor; ``models/vits.py``)
    model: str = "visinger"
    n_vocab: int = 0             # VITS: text symbols (0: the data's count)
    sdp_filter_channels: int = 192
    sdp_kernel_size: int = 3
    sdp_p_dropout: float = 0.5
    sdp_n_flows: int = 4
    sdp_num_bins: int = 10
    sdp_tail_bound: float = 5.0
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
    bf16_f32_islands: tuple = ()
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
    kl_start_steps: int = 1      # 0: no warm-up
    kl_min: float | None = 0.0   # None: no floor
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
    clip_grad_norm: float = 1.0  # 0: no clipping (the norm is still taken)
    steps_per_epoch: int = 0     # 0: the trainer's epoch plan (else 280)
    accumulate_grad_batches: int = 1
    remat_policy: str = "none"
    # the data pipeline: raw corpus -> preprocess -> binarize
    raw_data_dir: str = "./data/source/svs/csd"
    processed_data_dir: str = "./data/preprocessed/svs/csd"
    speaker: str = "csd"
    pitch_extractor: str = "autocorr"
    f0_min: int = 50
    f0_max: int = 1250
    binarize_workers: int = 0    # 0: one worker per CPU core
    spk_embed_extractor: str = "mel_stats"
    loud_norm_db: float = -20.0          # wav processor loud_norm
    vad_max_silence_length: int = 12     # wav processor trim_sil
    synth_n_items: int = 12      # run synth-data
    synth_notes: tuple = (4, 8)
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
    # the trainer: experiment, schedule of logs, validations and checkpoints
    work_dir: str = "./checkpoints"
    exp_name: str = ""
    seed: int = 1234
    load_ckpt: str = ""
    num_ckpt_keep: int = 100
    async_checkpoint: bool = False
    max_updates: int = 600000
    tb_log_interval: int = 100
    num_sanity_val_steps: int = 5
    val_check_interval: int = 1000
    deterministic_eval: bool = True
    eval_max_batches: int = 50
    profile_dir: str = ""
    profile_start_step: int = 10
    save_codes: bool = True
    debug: bool = False
    # rendered validation items and the test split
    render_valid: bool = False
    valid_infer_interval: int = 1000
    num_valid_plots: int = 10
    mel_vmin: float = -7
    mel_vmax: float = 12
    test_after_train: bool = False
    per_item_rtf: bool = False
    # the trainer's data: splits, batching, and where batches are assembled
    train_set_name: str = "train"
    valid_set_name: str = "valid"
    test_set_name: str = "test"
    binary_data_dirs: tuple = ()
    max_tokens: int = 60000
    max_frames: int = 1280
    cache_dataset: bool = True
    device_resident_data: bool = True
    device_data_max_mb: float = 4096
    store_wav_f32: bool = True
    ship_wav_int16: bool = False

    def replace(self, **overrides) -> "Config":
        return dataclasses.replace(self, **overrides)

    def to_dict(self) -> dict:
        """The fields as JSON values (tuples as lists, ``Args`` as dicts)."""
        return {f.name: _plain(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, data: Mapping) -> "Config":
        """The inverse of ``to_dict``; an unknown key raises ``KeyError``."""
        return cls().apply(data)

    def apply(self, overrides: Mapping) -> "Config":
        """A copy with ``overrides`` (``parse_overrides``' nested dict)
        applied: lists become tuples, a dict merges into an ``Args`` field,
        ``UNREAD_KEYS`` are dropped; another unknown key raises
        ``KeyError``."""
        fields = {f.name for f in dataclasses.fields(self)}
        updates = {}
        for key, value in overrides.items():
            if key in UNREAD_KEYS:
                continue
            if key not in fields:
                raise KeyError(f"unknown config key {key!r}")
            old = getattr(self, key)
            if isinstance(old, Args):
                unknown = set(value) - set(old)
                if unknown:
                    raise KeyError(f"unknown keys {sorted(unknown)} in {key}")
                value = Args(old, **value)
            updates[key] = _tuples(value)
        return self.replace(**updates)


def _plain(v):
    if isinstance(v, Mapping):
        return {k: _plain(v[k]) for k in v}
    if isinstance(v, (list, tuple)):
        return [_plain(e) for e in v]
    return v


def _tuples(v):
    if isinstance(v, (list, tuple)):
        return tuple(_tuples(e) for e in v)
    return v


def parse_overrides(spec: str) -> dict:
    """``"a=1,b.c=2,d=[1, 2, 3]"`` -> a nested dict (the JAX package's
    ``config/loader.py::parse_overrides``).  Values go through
    ``ast.literal_eval`` where they parse, else stay strings; commas inside
    brackets belong to the value."""
    out: dict = {}
    parts, depth, cur = [], 0, []
    for ch in spec:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    for part in parts:
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        k, v = k.strip(), v.strip().strip("'\"")
        try:
            val = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            val = v
        node = out
        keys = k.split(".")
        for kk in keys[:-1]:
            node = node.setdefault(kk, {})
        node[keys[-1]] = val
    return out


# the subsystems ``bf16_f32_islands`` may keep in float32 (the JAX
# package's models/visinger.py and, for "disc", models/factory.py)
ISLANDS = ("text_encoder", "pitch", "phoneme", "frame_prior", "posterior",
           "flow", "decoder", "disc")
COMPUTE_DTYPES = {"float32", "bfloat16"}
MODELS = ("visinger", "vits")
REMAT_POLICIES = ("none", "full", "dots")


def check_supported(cfg: Config, device=None) -> None:
    """Raise ``NotImplementedError``, for a build on a CUDA ``device``, for
    a width the TPU kernels do not take either: a ``hidden_size`` that is
    not a multiple of ``num_heads``, or a head width above 128 (the TPU
    kernel pads each head to one 128-lane slab,
    ``visinger_tpu/modules/transformer.py:92-103``).  K1 and K3 take any
    other head width and K2 any channel count (``ops/pad_pack.py`` pads
    the widths their CUDA kernels do not take).  ``sp_infer`` together
    with ``stream_infer``, a ``compute_dtype`` other than float32 and
    bfloat16 and an unknown island raise ``ValueError``, a ``remat_policy``
    other than none, full and dots ``KeyError``."""
    if cfg.sp_infer and cfg.stream_infer:
        raise ValueError(
            "sp_infer and stream_infer are mutually exclusive: "
            "sequence-parallel decoding shards one full-length program "
            "over the mesh while streaming chunks a single device's "
            "decode; pick one (configs: sp_infer / stream_infer)")
    if cfg.model not in MODELS:
        raise ValueError(f"model {cfg.model!r}: choose from {MODELS}")
    if cfg.model == "vits" and cfg.compute_dtype != "float32":
        raise ValueError("the VITS model computes in float32 only")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} is not one "
                         f"of {sorted(COMPUTE_DTYPES)}")
    unknown = set(cfg.bf16_f32_islands) - set(ISLANDS)
    if unknown:
        raise ValueError(f"bf16_f32_islands {sorted(unknown)} are not "
                         f"subsystems; choose from {ISLANDS}")
    if cfg.remat_policy not in REMAT_POLICIES:
        # the JAX step looks the policy up in a dict of these names
        raise KeyError(f"remat_policy {cfg.remat_policy!r} is not one of "
                       f"{REMAT_POLICIES}")
    if not str(device).startswith("cuda"):
        return
    h, heads = cfg.hidden_size, cfg.num_heads
    if h % heads:
        raise NotImplementedError(
            f"hidden_size {h} not a multiple of num_heads {heads}: the TPU "
            "kernel splits the channels into equal heads as well")
    if h // heads > 128:
        raise NotImplementedError(
            f"head width {h // heads} on CUDA: the TPU kernel takes at most "
            "128, one 128-lane slab per head")


def visinger_csd() -> Config:
    """The full-width recipe (VISinger on CSD)."""
    return Config()


def tpu_run() -> Config:
    """The demo run of ``configs/tpu_run.yaml`` on the full-width recipe: a
    28-item synthetic corpus (4 test, 4 valid, 20 train items) and one
    800-frame / 96-token bucket."""
    base = visinger_csd()
    return base.replace(
        work_dir="checkpoints/tpu_run",
        processed_data_dir="./data/synth",
        binary_data_dir="./data/binary/synth",
        synth_n_items=28,
        synth_notes=(6, 10),
        binarization_args=Args(
            base.binarization_args, test_range=(0, 4), valid_range=(4, 8),
            train_range=(8, -1), min_text=2),
        frame_buckets=(800,),
        token_buckets=(96,),
        max_frames=800,
        max_sentences=4,
        max_tokens=60000,
        max_updates=3600,
        tb_log_interval=25,
        val_check_interval=500,
        eval_max_batches=2,
        num_sanity_val_steps=1,
        num_ckpt_keep=3,
        logs_clamp=5.0,
        deterministic_eval=False,
        render_valid=False,
    )


def soak_r5() -> Config:
    """``configs/soak_r5.yaml`` as the JAX package loads it: the ``tpu_run``
    demo under the production defaults, bf16 compute (no float32 islands),
    async checkpoints, rendered validation and the test split scored after
    training, for 20000 optimizer steps.  The YAML's bucket lists and
    ``eval_max_batches`` do not take effect there: ``tpu_run.yaml``'s
    (its base config) win, so they are ``tpu_run``'s here too."""
    return tpu_run().replace(
        work_dir="checkpoints/soak_r5",
        compute_dtype="bfloat16",
        bf16_f32_islands=(),
        logs_clamp=5.0,
        max_updates=20000,
        test_after_train=True,
        val_check_interval=1000,
        num_ckpt_keep=3,
        async_checkpoint=True,
        render_valid=True,
        tb_log_interval=100,
        steps_per_epoch=0,
    )


def parity_run() -> Config:
    """``configs/parity_run.yaml``: the ``tpu_run`` demo (its corpus,
    binarization and batching) with the reference's validation semantics
    (``deterministic_eval``: dropout off, fixed eval draws), for the
    loss-curve and quality comparison with the upstream model."""
    return tpu_run().replace(
        work_dir="checkpoints/parity_run",
        logs_clamp=5.0,
        deterministic_eval=True,
        tb_log_interval=25,
        val_check_interval=250,
        max_updates=3600,
        render_valid=False,
    )


def vits_ljs() -> Config:
    """VITS on LJSpeech: jaywalnut310/vits ``configs/ljs_base.json`` and
    ``models.py::SynthesizerTrn`` with ``use_sdp=True``.  The widths are the
    published ones; so are the losses (c_mel 45, c_kl 1, no KL warm-up or
    floor, feature matching x2), AdamW (0.8, 0.99), eps 1e-9 and torch's
    default weight decay 0.01 on both optimizers, and no gradient clipping
    (upstream ``clip_grad_value_(..., None)`` only measures the norm).
    ``max_sentences`` is the per-GPU ``batch_size`` 64.  Departures: the
    step runs in the port's order (the generator against the discriminator
    from before the step's update, then the discriminator), and in
    float32, where upstream trains in fp16 AMP."""
    return Config(
        model="vits", n_vocab=178,
        hidden_size=192, ffn_filter_channels=768, ffn_kernel_size=3,
        num_heads=2, attn_window_size=4, p_dropout=0.1, enc_layers=6,
        pitch_predictor_layers=0, frame_prior_layers=0,
        phoneme_predictor_layers=0, use_phoneme_pred=False,
        use_pitch_embed=False, use_pos_embed=False,
        posterior_wn_layers=16, posterior_wn_kernel=5, flow_n_flows=4,
        flow_wn_layers=4, flow_wn_kernel=5,
        upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
        initial_upsample_channels=512, gin_channels=0, use_spk_id=False,
        hop_size=256, sample_rate=22050, segment_size=32, fft_size=1024,
        win_size=1024, num_mel_bins=80, num_linear_bins=513, fmin=0,
        fmax=None, mel_losses="l1:45.0", lambda_kl=1.0, lambda_fm=2.0,
        kl_start_steps=0, kl_min=None, weight_decay=0.01,
        disc_weight_decay=0.01, clip_grad_norm=0.0, max_sentences=64,
        work_dir="checkpoints/vits_ljs")


RECIPES = {"visinger_csd": visinger_csd, "tpu_run": tpu_run,
           "soak_r5": soak_r5, "parity_run": parity_run,
           "vits_ljs": vits_ljs}


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


def tiny_vits() -> Config:
    """``vits_ljs`` at unit-test size (every kind of layer kept)."""
    return vits_ljs().replace(
        n_vocab=20, hidden_size=16, ffn_filter_channels=32, enc_layers=1,
        posterior_wn_layers=2, flow_n_flows=2, flow_wn_layers=1,
        initial_upsample_channels=32, upsample_rates=(4, 4),
        upsample_kernel_sizes=(8, 8), hop_size=16, fft_size=64, win_size=64,
        num_linear_bins=33, num_mel_bins=10, segment_size=8,
        sdp_filter_channels=16, disc_periods=(2, 3), disc_s_base=4,
        disc_p_channels=(8, 16, 32, 32), max_sentences=4)
