"""Host milliseconds a synthesis call spends fetching its waveforms: the
span ``synth.fetch``, the wait for the device and the copy to the host."""

import spans

SPANS = ("synth.fetch",)


def read(reading):
    return spans.per_unit_ms(reading, "synth", SPANS)
