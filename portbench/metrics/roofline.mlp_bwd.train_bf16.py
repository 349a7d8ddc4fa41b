"""bf16 B2 (csrc/mlp_bwd.cu, both of its launches) in the training steps: its bound
time over its device time."""

from harness.readers import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "bwd", ["mlp_bwd_mma_kernel", "reduce_partials"], "bfloat16")
