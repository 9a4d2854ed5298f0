"""Milliseconds a training step's optimizer spans (``train.g.optimizer``,
``train.d.optimizer``) leave the device idle."""

import spans

SPANS = ("train.g.optimizer", "train.d.optimizer")


def read(reading):
    return spans.per_unit_ms(reading, "train", SPANS, idle=True)
