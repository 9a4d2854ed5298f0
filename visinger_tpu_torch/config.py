"""The ``visinger_csd`` recipe as a Python dataclass (no YAML).

Holds the values the synthesis path reads, copied from the JAX package's
``config/defaults/{visinger,csd,base}.yaml``; a CPU test holds every field
against ``load_config(name="visinger_csd")``.  The TPU-only knobs
(``attn_impl``, ``use_pallas``, ``decoder_time_fold``/``decoder_polyphase``,
frame/token buckets) have no counterpart: the port has one path.
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
    enc_layers: int = 6
    pitch_predictor_layers: int = 6
    frame_prior_layers: int = 4
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

    def replace(self, **overrides) -> "Config":
        return dataclasses.replace(self, **overrides)


def visinger_csd() -> Config:
    """The full-width recipe (VISinger on CSD)."""
    return Config()


def tiny_config() -> Config:
    """Unit-test size, the counterpart of the JAX ``models.factory.tiny_config``
    restricted to the fields above (all structure kept)."""
    return visinger_csd().replace(
        enc_layers=1,
        frame_prior_layers=1,
        pitch_predictor_layers=1,
        flow_n_flows=2,
        flow_wn_layers=1,
        ffn_filter_channels=32,
        hidden_size=16,
        num_heads=2,
        initial_upsample_channels=32,  # must exceed 2**len(upsample_rates)
        gin_channels=8,
    )
