"""Host milliseconds a VITS training step spends in the forward of its
stochastic duration predictor: the span ``model.sdp``."""

import spans

SPANS = ("model.sdp",)


def read(reading):
    return spans.per_unit_ms(reading, "train", SPANS)
