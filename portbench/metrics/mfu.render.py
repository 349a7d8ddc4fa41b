"""The f32 frames' model operations (forward) over the f32 peak."""

from harness.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx, 1, "float32")
