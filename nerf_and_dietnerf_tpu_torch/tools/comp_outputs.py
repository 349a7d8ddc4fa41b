#!/usr/bin/env python
"""Whether a change leaves the MLP kernels' results bitwise as they were: B1
(``mlp_fwd``), B2 (``mlp_bwd``), B6 (``raymarch_fwd`` / ``raymarch_bwd``),
B7 (``raymarch_comp_fwd`` / ``raymarch_comp_bwd``), B4 (``mlp_comp_fwd`` /
``mlp_comp_bwd``) and B5 (``mlp_loss_comp``), both compute types and MLP
variants, the ray kernels at S = 64 (two rays a 128-row tile) and S = 192 (a
ray over two tiles), on inputs made from fixed seeds.

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
                g_raw = 0.5 + torch.rand((rays, n_s, 4), generator=gen, device=device)
                key = (variant, str(cd).split(".")[-1], n_s)
                dws, dbs, dz = rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, g_rgb, g_w, cd)
                out[("B7",) + key] = [*dws, *dbs, dz]
                mse, dz, dws, dbs = rk.mlp_loss_comp(ws, bs, cfg, *batch, cd)
                out[("B5",) + key] = [mse, dz, *dws, *dbs]
                # The other MLP kernels, on the same draws (drawn after the
                # cases above, so those keep their inputs).
                out[("B7_fwd",) + key] = list(rk.raymarch_comp_fwd(ws, bs, cfg, rd, z, cd))
                enc, encd, zb = batch[:3]
                out[("B4_fwd",) + key] = list(rk.mlp_comp_fwd(ws, bs, cfg, enc, encd, zb, cd))
                dws, dbs, denc, dencd, dz = rk.mlp_comp_bwd(ws, bs, cfg, enc, encd, zb, g_rgb,
                                                            g_w, cd)
                out[("B4",) + key] = [*dws, *dbs, denc, dz] + ([dencd] if dencd is not None
                                                              else [])
                out[("B6_fwd",) + key] = [rk.raymarch_fwd(ws, bs, cfg, rd, z, cd)]
                dws, dbs, dz = rk.raymarch_bwd(ws, bs, cfg, rd, z, g_raw, cd)
                out[("B6",) + key] = [*dws, *dbs, dz]
                _, x, d = rk._mlp_inputs(cfg, rd, z, cd)
                x, d = x.contiguous(), d.contiguous() if d is not None else None
                out[("B1",) + key] = [rc.mlp_fwd(ws, bs, cfg, x, d, cd)]
                dws, dbs, dx, dd = rc.mlp_bwd(ws, bs, cfg, x, d, g_raw.reshape(-1, 4), cd)
                out[("B2",) + key] = [*dws, *dbs, dx] + ([dd] if dd is not None else [])
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
