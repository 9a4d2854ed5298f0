"""Device kernels in the traced stretch over the training steps it holds."""

import readers


def read(reading):
    return readers.launches_per_unit(reading, "train")
