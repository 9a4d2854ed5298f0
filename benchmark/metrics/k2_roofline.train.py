"""K2's least time (k2_work at the batches' real lengths) over its device
time in the traced training steps, in %."""

import readers


def read(reading):
    return readers.roofline(reading, "train", readers.K2,
                            readers.k2_least_seconds)
