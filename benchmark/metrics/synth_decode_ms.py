"""Host milliseconds a synthesis call spends decoding: the spans
``model.flow`` (the reverse flow) and ``model.decoder`` (HiFi-GAN) inside
``synth.call``."""

import spans

SPANS = ("model.flow", "model.decoder")


def read(reading):
    return spans.per_unit_ms(reading, "synth", SPANS)
