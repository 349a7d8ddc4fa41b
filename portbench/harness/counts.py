"""Operations, bytes, peaks and bounds: the yardstick of the per-layer metrics.

The operations are the work the algorithm needs, computed from the
configuration's widths, whatever implements it: a sample's forward is the
radiance MLP's matrix products (2 operations a multiply-add), its backward
twice that (the input and the weight gradients). Recompute and padding are not
counted, so a kernel that recomputes its forward reads no more work.
"""

from __future__ import annotations

from typing import Dict

from harness.weights import mlp_shapes

# NVIDIA H100 SXM data sheet, dense: bf16 989 TFLOP/s; float32 operands at
# most 495 TFLOP/s (the TF32 tensor-core rate, the highest published rate
# for float32 operands); HBM3 3.35 TB/s. At the card's full 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12
ITEM_BYTES = {"bfloat16": 2, "float32": 4}


def forward_flops(dims: Dict) -> int:
    """Operations of one sample's forward through one network."""
    return sum(2 * fi * fo for _, fi, fo in mlp_shapes(dims))


def backward_flops(dims: Dict) -> int:
    return 2 * forward_flops(dims)


def weight_count(dims: Dict) -> int:
    return sum(fi * fo + fo for _, fi, fo in mlp_shapes(dims))


def forward_bytes(dims: Dict, rows: int, launches: int, dtype: str) -> int:
    """Inputs read once (encodings in the operand type, the weights once a
    launch) and the raw (rows, 4) float32 written once."""
    item = ITEM_BYTES[dtype]
    return rows * ((dims["xyz"] + dims["dir"]) * item + 16) + launches * weight_count(dims) * item


def backward_bytes(dims: Dict, rows: int, launches: int, dtype: str) -> int:
    """Encodings and the raw cotangent read, the encodings' float32
    cotangents written, the weights read and their float32 gradients
    written once a launch."""
    item = ITEM_BYTES[dtype]
    per_row = (dims["xyz"] + dims["dir"]) * (item + 4) + 16
    return rows * per_row + launches * weight_count(dims) * (item + 4)


def bound_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: operations over the type's peak
    or bytes over the memory's, whichever is larger."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
