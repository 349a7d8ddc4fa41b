"""Operand roundings of the reference's matrix products.

A product's operands are rounded to the type named here and multiplied as
float32 (with TF32 off): the products are exact and the sums float32, the
semantics of a tensor-core product with float32 accumulation. The rounding's
backward rounds the cotangent the same way, so the backward's products see
rounded operands too.

- ``float32``: no rounding.
- ``tfloat32``: 10 mantissa bits, round to nearest even (what a TF32 product
  reads); the control of a float32 configuration.
- ``bfloat16``: bfloat16.
- ``float8``: per-tensor scaled fp8, e4m3 forward and e5m2 backward (the usual
  fp8 training recipe); the control of a bfloat16 configuration.
"""

from __future__ import annotations

import torch

# The control of each stated precision: the nearest type below it.
CONTROL_OF = {"float32": "tfloat32", "bfloat16": "float8"}

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    odd = (bits >> 13) & 1
    return ((bits + 0x0FFF + odd) & -0x2000).view(torch.float32)


def _scaled(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).float() / scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _e4m3(x):
    return _scaled(x, torch.float8_e4m3fn, _E4M3_MAX)


def _e5m2(x):
    return _scaled(x, torch.float8_e5m2, _E5M2_MAX)


def rounder(kind: str):
    """The rounding ``x -> x'`` (float32 in, float32 out) of ``kind``."""
    if kind == "float32":
        return lambda x: x.float()
    if kind == "bfloat16":
        return lambda x: x.float().to(torch.bfloat16).float()
    if kind == "tfloat32":
        return lambda x: _Round.apply(x.float(), _tf32, _tf32)
    if kind == "float8":
        return lambda x: _Round.apply(x.float(), _e4m3, _e5m2)
    raise ValueError(f"unknown precision {kind!r}")
