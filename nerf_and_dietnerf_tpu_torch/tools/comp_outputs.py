#!/usr/bin/env python
"""Whether a change leaves the compositing backwards' results bitwise as
they were: B7's backward (``raymarch_comp_bwd``) and B5 (``mlp_loss_comp``),
both compute types and MLP variants, at S = 64 (two rays a 128-row tile) and
S = 192 (a ray over two tiles), on inputs made from fixed seeds.

Save the outputs in a checkout of the parent commit (copy this file into it
if the parent predates it), then compare them in the change's checkout (each
builds its own kernels):

    python -m nerf_and_dietnerf_tpu_torch.tools.comp_outputs --save PATH
    python -m nerf_and_dietnerf_tpu_torch.tools.comp_outputs --compare PATH

``--compare`` prints one line per case, ``equal`` or ``differ``, and exits 1
if any case differs. ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from nerf_and_dietnerf_tpu_torch.models import mlp
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
from nerf_and_dietnerf_tpu_torch.tools.comp_kink import enc_batch, ray_batch
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device

SAMPLES = (64, 192)


def outputs(device, rays: int) -> dict:
    """``{(kernel, variant, dtype, S): flat tensors}`` on fixed inputs."""
    out = {}
    for variant, n_angles in (("view_dirs", 2), ("xyz_only", 0)):
        cfg = mlp.MLPConfig(n_angles=n_angles)
        params = mlp.init_params(torch.Generator().manual_seed(0), cfg, device=device)
        for cd in (torch.bfloat16, torch.float32):
            ws, bs = rc.flatten_params(params, cfg, cd)
            for n_s in SAMPLES:
                gen = torch.Generator(device=device).manual_seed(7 + n_s)
                rd, z = ray_batch(cfg, rays, n_s, gen, device)
                g_rgb = 0.5 + torch.rand((rays, 3), generator=gen, device=device)
                g_w = 0.5 + torch.rand((rays, n_s), generator=gen, device=device)
                batch = enc_batch(cfg, cd, rd, z, gen)
                key = (variant, str(cd).split(".")[-1], n_s)
                dws, dbs, dz = rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, g_rgb, g_w, cd)
                out[("B7",) + key] = [*dws, *dbs, dz]
                mse, dz, dws, dbs = rk.mlp_loss_comp(ws, bs, cfg, *batch, cd)
                out[("B5",) + key] = [mse, dz, *dws, *dbs]
    return {k: [t.detach().cpu() for t in v] for k, v in out.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--save", type=Path, help="write the outputs to this file")
    g.add_argument("--compare", type=Path, help="compare the outputs with this file")
    p.add_argument("--device", default=None, help="cuda (default) or cpu (plain versions)")
    p.add_argument("--rays", type=int, default=1024)
    args = p.parse_args(argv)
    got = outputs(resolve_device(args.device), args.rays)
    if args.save is not None:
        args.save.parent.mkdir(parents=True, exist_ok=True)
        torch.save(got, args.save)
        return 0
    want = torch.load(args.compare)
    same = True
    for key in sorted(want):
        equal = key in got and len(got[key]) == len(want[key]) and all(
            torch.equal(a, b) for a, b in zip(got[key], want[key]))
        same &= equal
        print(" ".join(map(str, key)), "equal" if equal else "differ", flush=True)
    return 0 if same and set(got) == set(want) else 1


if __name__ == "__main__":
    raise SystemExit(main())
