"""device_ms.train.forward: device time launched in the training step's
forward (``gs.train.forward``, the loss) per step, in ms."""

from bench.harness.spans import train_device_ms


def read(run):
    return train_device_ms(run, "forward")
