#!/usr/bin/env python
"""Experiment: do several independent row chains per block pay in the fused
forward (B1)? chains=1 is one 64-row chain per block; with 2 or 4 a block
walks that many 64-row chains in lockstep and uses every streamed weight chunk
for all of them. A chain count whose f32 activations do not fit a block's
shared memory prints FAILED.

    python -m nerf_and_dietnerf_tpu_torch.tools.exp_interleave [--device cpu] [--rows N]
"""

from __future__ import annotations

import torch

from nerf_and_dietnerf_tpu_torch import tools
from nerf_and_dietnerf_tpu_torch.ops.probe_kernels_cuda import SharedMemoryExceeded, mlp_fwd_chains
from nerf_and_dietnerf_tpu_torch.ops.raymarch_cuda import mlp_fwd
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device

CHAIN_ROWS = 64  # rows of one chain (csrc/mlp_common.cuh TM)


def main(argv=None) -> int:
    p = tools.parser(__doc__, reps=10)
    p.add_argument("--rows", type=int, default=786432)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    config, ws, bs, x, d = tools.mlp_case(args.rows, device)
    flops = tools.mlp_flops(config, args.rows)
    x, d = x.to(torch.bfloat16), d.to(torch.bfloat16)
    ref = mlp_fwd(ws, bs, config, x, d, torch.bfloat16)

    for chains in (1, 2, 4):
        tile = CHAIN_ROWS * chains
        f = lambda c=chains: mlp_fwd_chains(ws, bs, config, x, d, c)  # noqa: E731
        try:
            err = float((f() - ref).abs().max())
        except SharedMemoryExceeded as e:
            print(f"tile={tile} chains={chains}  FAILED {str(e)[:100]}", flush=True)
            continue
        dt = tools.seconds_per_call(f, device, args.reps)
        print(f"tile={tile:5d} chains={chains}  {dt*1e3:6.2f} ms  "
              f"{flops/dt/1e12:5.1f} TF/s ({tools.peak_share(flops, dt, device):>5s})  "
              f"maxerr={err:.2e}{tools.note(device)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
