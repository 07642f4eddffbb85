"""device_ms.train.backward: device time launched in the training step's
backward (``gs.train.backward``, remat's recompute included) per step,
in ms."""

from bench.harness.spans import train_device_ms


def read(run):
    return train_device_ms(run, "backward")
