"""Model FLOPs of the synthesis calls over the window's seconds at the
configuration's peak (the whole call's share of the card), in %."""

import readers


def read(reading):
    return readers.mfu(reading, "synth")
