"""Milliseconds the alignment's span ``model.mas`` leaves the device idle
in a VITS training step: the host's dynamic program and the copies."""

import spans

SPANS = ("model.mas",)


def read(reading):
    return spans.per_unit_ms(reading, "train", SPANS, idle=True)
