#!/usr/bin/env python
"""Bisect the in-kernel encode cost of the fused ray-march kernel (B6).

Each stage runs bf16 B6's own input build (``build_mma_inputs`` of
``csrc/raymarch_tile.cuh``) in B6's grid, block and forward shared memory,
cut off after it: ``dma`` (the block's ray data and depths), ``repeat`` (each
(row, column) reads its ray's data and z), ``pts`` (o + z d), ``theta`` (the
angles), ``sin``, ``enc`` (rounded to bf16: the tiles B6's MLP reads). Each
stage does the work of the one before it, so the difference between two
lines is that stage's cost. A line is ms a call by CUDA events over
back-to-back calls: where a stage's device time is below the host's time a
call (``dma``), it reads the host; ``chip_smoke.py`` also reads each stage's
device time with the profiler.

    python -m nerf_and_dietnerf_tpu_torch.tools.exp_enccost [--device cpu] [--tiles N]
"""

from __future__ import annotations

import torch

from nerf_and_dietnerf_tpu_torch import tools
from nerf_and_dietnerf_tpu_torch.models.mlp import MLPConfig
from nerf_and_dietnerf_tpu_torch.ops.probe_kernels_cuda import ENC_STAGES, enc_cost
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    p = tools.parser(__doc__, reps=20)
    p.add_argument("--r-t", type=int, default=64, help="rays per tile")
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--tiles", type=int, default=64,
                   help="tiles (64 x 64 rays x 64 samples: the flagship coarse pass)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    config = MLPConfig()
    gen = torch.Generator(device=device).manual_seed(tools.SEED)
    n_rays = args.tiles * args.r_t
    rd = torch.randn((n_rays, 6 + config.n_angles + 1), generator=gen, device=device)
    z = 2.0 + 4.0 * torch.rand((n_rays, args.samples), generator=gen, device=device)
    for stage in ENC_STAGES:
        t = tools.seconds_per_call(lambda: enc_cost(rd, z, stage, config, args.r_t), device,
                                   args.reps)
        print(f"{stage:7s}: {t*1e3:7.3f} ms{tools.note(device)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
