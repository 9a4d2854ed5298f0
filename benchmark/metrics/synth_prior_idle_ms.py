"""Milliseconds a synthesis call's prior (the span ``model.prior``) leaves
the device idle."""

import spans

SPANS = ("model.prior",)


def read(reading):
    return spans.per_unit_ms(reading, "synth", SPANS, idle=True)
