"""f32 B1 (csrc/mlp_fwd.cu, 3xTF32 wgmma) in the frames: its bound time over its device time."""

from harness.readers import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "fwd", ["mlp_fwd_tf32_kernel"], "float32")
