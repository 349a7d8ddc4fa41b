"""The bf16 training steps' model operations (forward and backward) over the bf16 peak."""

from harness.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx, 3, "bfloat16")
