"""Share of the traced stretch of training steps in which no kernel ran, in
%."""

import readers


def read(reading):
    return readers.idle(reading, "train")
