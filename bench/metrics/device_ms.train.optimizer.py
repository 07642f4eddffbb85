"""device_ms.train.optimizer: device time launched in the training step's
update (``gs.train.optimizer``, clipping included) per step, in ms."""

from bench.harness.spans import train_device_ms


def read(run):
    return train_device_ms(run, "optimizer")
