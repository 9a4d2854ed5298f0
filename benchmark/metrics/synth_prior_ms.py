"""Host milliseconds a synthesis call spends in the prior: the span
``model.prior`` (``VISinger.prior_stats``: text encoder, pitch predictor,
frame prior) inside ``synth.call``."""

import spans

SPANS = ("model.prior",)


def read(reading):
    return spans.per_unit_ms(reading, "synth", SPANS)
