"""Device kernels in the traced stretch over the synthesis calls (groups) it
holds."""

import readers


def read(reading):
    return readers.launches_per_unit(reading, "synth")
