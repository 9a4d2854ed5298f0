"""Host milliseconds a training step spends in its backwards: the spans
``train.g.backward`` and ``train.d.backward`` (``autograd.grad`` and the
all-reduce)."""

import spans

SPANS = ("train.g.backward", "train.d.backward")


def read(reading):
    return spans.per_unit_ms(reading, "train", SPANS)
