"""Host milliseconds a training step spends in its forwards: the spans
``train.g.forward`` and ``train.d.forward`` of ``TrainStep.__call__``."""

import spans

SPANS = ("train.g.forward", "train.d.forward")


def read(reading):
    return spans.per_unit_ms(reading, "train", SPANS)
