"""Synchronising calls per training step, counted under
``torch.cuda.set_sync_debug_mode("warn")`` over a stretch of steps."""


def read(reading):
    if reading.kind != "train" or not reading.sync_units:
        return None
    return reading.syncs / reading.sync_units
