"""Milliseconds a synthesis call's decode (the spans ``model.flow`` and
``model.decoder``) leaves the device idle."""

import spans

SPANS = ("model.flow", "model.decoder")


def read(reading):
    return spans.per_unit_ms(reading, "synth", SPANS, idle=True)
