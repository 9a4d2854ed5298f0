"""Share of the traced stretch of synthesis calls in which no kernel ran, in
%."""

import readers


def read(reading):
    return readers.idle(reading, "synth")
