"""K3's least time (k3_work at the batches' real lengths, at its build's
peak) over its device time in the traced training steps, in %."""

import readers


def read(reading):
    return readers.roofline(reading, "train", readers.K3, readers.k3_least)
