"""Host milliseconds a training step spends in its optimizers: the spans
``train.g.optimizer`` (the gradient norm and the clipped AdamW) and
``train.d.optimizer``."""

import spans

SPANS = ("train.g.optimizer", "train.d.optimizer")


def read(reading):
    return spans.per_unit_ms(reading, "train", SPANS)
