#!/usr/bin/env python
"""Experiment: how much of the fused forward (B1) is its epilogue?

v0 baseline = B1 itself. v1 = products only (no bias, no activation; the sum
is cast to bf16 directly): if v1 is much faster, the elementwise epilogue
matters. v5 = cast first, then bias + leaky in bf16 via max(x, a x). v3 = f32
bias, max-form leaky, then the cast: B1's function, bitwise B1's output. B1's
tensor-core tile with another epilogue policy.

    python -m nerf_and_dietnerf_tpu_torch.tools.exp_vpu [--device cpu] [--rows N]
"""

from __future__ import annotations

import torch

from nerf_and_dietnerf_tpu_torch import tools
from nerf_and_dietnerf_tpu_torch.ops.probe_kernels_cuda import mlp_fwd_variant
from nerf_and_dietnerf_tpu_torch.ops.raymarch_cuda import mlp_fwd
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    p = tools.parser(__doc__, reps=10)
    p.add_argument("--rows", type=int, default=786432)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    config, ws, bs, x, d = tools.mlp_case(args.rows, device)
    flops = tools.mlp_flops(config, args.rows)
    xb, db = x.to(torch.bfloat16), d.to(torch.bfloat16)

    ref = lambda: mlp_fwd(ws, bs, config, xb, db, torch.bfloat16)  # noqa: E731
    refout = ref()
    dt = tools.seconds_per_call(ref, device, args.reps)
    print(f"v0 baseline   {dt*1e3:6.2f} ms  {flops/dt/1e12:5.1f} TF/s{tools.note(device)}",
          flush=True)

    for variant in ("v1", "v5", "v3"):
        f = lambda v=variant: mlp_fwd_variant(ws, bs, config, x, d, v)  # noqa: E731
        err = float((f() - refout).abs().max())
        dt = tools.seconds_per_call(f, device, args.reps)
        print(f"{variant}           {dt*1e3:6.2f} ms  {flops/dt/1e12:5.1f} TF/s  "
              f"maxerr={err:.2e}{tools.note(device)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
