"""Model FLOPs of the training steps over the window's seconds at the
configuration's peak (the whole step's share of the card), in %."""

import readers


def read(reading):
    return readers.mfu(reading, "train")
