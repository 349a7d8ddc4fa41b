"""bf16 B1 (csrc/mlp_fwd.cu) in the training steps: its bound time over its device time."""

from harness.readers import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "fwd", ["mlp_fwd_mma_kernel"], "bfloat16")
