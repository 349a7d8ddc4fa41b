#!/usr/bin/env python
"""Cost of turning per-ray data into per-(ray, sample) rows inside a kernel.

Sample-major row layout (row = s * R_t + r):
  A. per-sample scalars: a transposed (S, R_t) f32 block -> (S R_t, 1)
  B. per-ray attributes: (R_t, X) repeated S times -> (S R_t, X)
  C. both combined into an encode-shaped kernel (rows, 33 columns) over a grid
     of tiles: 3 coordinate blocks + view components repeated, a (6, T)
     product, sin, a (T, 33) product

    python -m nerf_and_dietnerf_tpu_torch.tools.exp_expand [--device cpu] [--tiles N]
"""

from __future__ import annotations

import torch

from nerf_and_dietnerf_tpu_torch import tools
from nerf_and_dietnerf_tpu_torch.ops.probe_kernels_cuda import expand_a, expand_b, expand_c
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device

N_THETA, N_ENC = 114, 33


def main(argv=None) -> int:
    p = tools.parser(__doc__, reps=50)
    p.add_argument("--r-t", type=int, default=64, help="rays per tile")
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--tiles", type=int, default=16, help="tiles of probe C")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(tools.SEED)
    r_t, n_s, n_tiles = args.r_t, args.samples, args.tiles

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    zt = randn(n_s, r_t)
    rd = randn(r_t, 8)
    px, py, pz = (randn(n_tiles * n_s, r_t) for _ in range(3))
    vc, sc, gx = randn(n_tiles * r_t, 3), randn(6, N_THETA), randn(N_THETA, N_ENC)
    for name, probe in [("A reshape", lambda: expand_a(zt)),
                        ("B repeat", lambda: expand_b(rd, n_s)),
                        ("C encode", lambda: expand_c(px, py, pz, vc, sc, gx))]:
        t = tools.seconds_per_call(probe, device, args.reps)
        print(f"{name}: {t*1e6:9.1f} us/iter{tools.note(device)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
