"""K2's least time (k2_work at the groups' real lengths) over its device
time in the traced synthesis calls, in %."""

import readers


def read(reading):
    return readers.roofline(reading, "synth", readers.K2,
                            readers.k2_least_seconds)
