"""Share of the bf16 training steps' device time outside the program's own kernels:
sampling, encodings, compositing, resampling, the loss and Adam."""

from harness.readers import outside_percent


def read(ctx):
    return outside_percent(ctx)
