"""Text-processor registry (the port's own copy of the JAX package's
``utils/text/processors.py``).

Parity target: reference preprocessor/text/base_text_processor.py:7-18 —
named registry of text processors; `ko_sing` is the Korean singing
processor whose actual work (jamo decomposition + the onset/nucleus/coda
sub-note split) lives in data/preprocess.split_syllables and
utils/text/korean.py.
"""

from __future__ import annotations

TEXT_PROCESSORS: dict[str, type] = {}


def register_text_processor(name: str):
    def deco(cls):
        TEXT_PROCESSORS[name] = cls
        cls.name = name
        return cls

    return deco


def get_text_processor_cls(name: str) -> type:
    return TEXT_PROCESSORS[name]


class BaseTextProcessor:
    @staticmethod
    def process(midi_info, cfg):
        raise NotImplementedError


@register_text_processor("ko_sing")
class KoreanSingingProcessor(BaseTextProcessor):
    """Korean singing: g2p (when available) + jamo sub-note splitting."""

    @staticmethod
    def process(midi_info, cfg):
        from visinger_tpu_torch.data.preprocess import split_syllables

        return split_syllables(midi_info, cfg)
