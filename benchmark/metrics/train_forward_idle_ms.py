"""Milliseconds a training step's forward spans (``train.g.forward``,
``train.d.forward``) leave the device idle."""

import spans

SPANS = ("train.g.forward", "train.d.forward")


def read(reading):
    return spans.per_unit_ms(reading, "train", SPANS, idle=True)
