"""Share of the device's busy time in the traced synthesis calls spent in
cuDNN and cuBLAS convolution and GEMM kernels, in %."""

import readers


def read(reading):
    return readers.conv_share(reading, "synth")
