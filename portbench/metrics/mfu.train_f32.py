"""The f32 training steps' model operations (forward and backward) over the f32 peak."""

from harness.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx, 3, "float32")
