#!/usr/bin/env python
"""Tensor-core probe: sustained rate of a chain of (M, 256) @ (256, 256) bf16
products (bf16 ``wgmma``, f32 sums) with W held in shared memory and nothing
read from device memory inside the chain (the input is made in the kernel).

- chains=1: ``depth`` dependent products (h = h @ w)
- chains=4: 4 independent chains of ``depth / 4`` products each

    python -m nerf_and_dietnerf_tpu_torch.tools.exp_mxu [--device cpu] [--cases M:depth:chains ...]
"""

from __future__ import annotations

import torch

from nerf_and_dietnerf_tpu_torch import tools
from nerf_and_dietnerf_tpu_torch.ops.probe_kernels_cuda import MXU_WIDTH, mxu_chain
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device

CASES = ["2048:32:1", "2048:32:4", "8192:32:1", "512:32:4", "2048:8:1"]


def run(w, m: int, depth: int, n_chains: int, steps: int, reps: int) -> None:
    """Times the chain and prints the case's line."""
    dt = tools.seconds_per_call(lambda: mxu_chain(w, m, depth, n_chains, steps), w.device, reps)
    flops = 2 * m * MXU_WIDTH * MXU_WIDTH * depth * steps
    print(f"M={m:5d} depth={depth:2d} chains={n_chains}  {dt*1e3:7.3f} ms  "
          f"{flops/dt/1e12:6.1f} TF/s  ({tools.peak_share(flops, dt, w.device):>6s})"
          f"{tools.note(w.device)}", flush=True)


def main(argv=None) -> int:
    p = tools.parser(__doc__, reps=10)
    p.add_argument("--cases", nargs="+", default=CASES, metavar="M:depth:chains")
    p.add_argument("--steps", type=int, default=8, help="grid steps, each the same work")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(tools.SEED)
    w = torch.randn((MXU_WIDTH, MXU_WIDTH), generator=gen, device=device).to(torch.bfloat16)
    for case in args.cases:
        m, depth, chains = (int(v) for v in case.split(":"))
        run(w, m, depth, chains, args.steps, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
