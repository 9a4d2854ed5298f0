"""K1's least time (k1_work at the groups' real lengths) over its device
time in the traced synthesis calls, in %."""

import readers


def read(reading):
    return readers.roofline(reading, "synth", readers.K1, readers.k1_least)
