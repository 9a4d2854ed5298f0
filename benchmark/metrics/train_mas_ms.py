"""Host milliseconds a VITS training step spends in its alignment: the
span ``model.mas`` (the cost matrix, its copy to the host, the dynamic
program and the path's return), forward only."""

import spans

SPANS = ("model.mas",)


def read(reading):
    return spans.per_unit_ms(reading, "train", SPANS)
