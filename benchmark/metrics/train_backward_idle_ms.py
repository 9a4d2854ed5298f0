"""Milliseconds a training step's backward spans (``train.g.backward``,
``train.d.backward``) leave the device idle."""

import spans

SPANS = ("train.g.backward", "train.d.backward")


def read(reading):
    return spans.per_unit_ms(reading, "train", SPANS, idle=True)
