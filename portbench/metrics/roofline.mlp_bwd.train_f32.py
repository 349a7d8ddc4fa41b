"""f32 B2 (csrc/mlp_bwd.cu, 3xTF32, both of its launches) in the f32 training steps:
its bound time over its device time."""

from harness.readers import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "bwd", ["mlp_bwd_t32_kernel", "reduce_partials"], "float32")
