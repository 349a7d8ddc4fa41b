#!/usr/bin/env python
"""Accuracy report of the compositing backwards on the bf16 tensor cores:
B7's backward (``raymarch_comp_bwd``), B5 (``mlp_loss_comp``) and B4's
backward (``mlp_comp_bwd``), each held against its plain version evaluated
five ways.

The compositing takes ``sigma = max(raw sigma, 0)``, and the sigma cotangent
is 0 below the kink. A sample whose raw sigma lies within the forward's
rounding noise of 0 can fall on either side of it in two orders of
summation; its row then loses or gains its whole sigma cotangent, and the
row's dz and its share of every weight gradient move with it. The kernels
return the raw values they composited (``raw=``), so the plain version can
take each sample's side of the kink from the kernel
(``research_kernels_cuda.kink_of``). The references:

- ``plain``: products and sums in f32, the plain version's own kink;
- ``plain_kink``: the same with the kernel's kink;
- ``f64``: the same roundings to bf16 with the MLP's products and sums in
  f64 (nearly exact sums; the compositing stays f32), its own kink;
- ``f64_kink``: f64 with the kernel's kink;
- ``f64_branches``: f64 with the kernel's kink and the kernel's leaky
  slopes. The MLP has the same trouble at each hidden element: a
  pre-activation within rounding of 0 takes the slope 1 or alpha in two
  orders of summation, and on opaque rays, where 256 rows carry every
  gradient, one such row moves a whole weight-gradient leaf. The kernel's
  recording build (``branches=``, ``csrc/branch_sink.cuh``) writes the slope
  it took at every element; its outputs must be bitwise the kernel's, and
  the mask must pass ``raymarch_cuda.branch_guard`` against the f64 chain's
  own signs, or the reference is left out (``recording_bitwise``,
  ``branches``).

Per case it prints one JSON line: the kernel against each reference and the
plain version against ``f64`` (dz normwise and scaled max, the worst leaf's
scaled dparams error and which leaf, dparams normwise, B5's loss, B4's denc
and dencd normwise), the
samples whose raw sigma has another sign in the kernel than in ``plain`` and
in ``f64``: their count, where they lie (ray, sample, row in its 128-row
tile) and their largest |raw sigma| beside the largest |kernel - f64| raw
sigma of the case, and the guard's record of the leaky slopes. The last
line is the summary: per kernel, the worst dparams leaf over the cases
against each reference.

    python -m nerf_and_dietnerf_tpu_torch.tools.comp_kink [--seeds 0 1] [--out PATH]
    python -m nerf_and_dietnerf_tpu_torch.tools.comp_kink --opaque-only --seeds 0 1 2 3 4 5 6 7
    python -m nerf_and_dietnerf_tpu_torch.tools.comp_kink --device cpu --rays 8 --hidden 32
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

from nerf_and_dietnerf_tpu_torch.core import encoding
from nerf_and_dietnerf_tpu_torch.models import mlp
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device

BM = 128  # rows of a tensor-core tile (csrc/mlp_mma_tile.cuh)
F64 = torch.float64
# (rays, samples) of each case: the coarse and fine passes, a part-filled tile
# a ray, a last group of one ray.
SHAPES = ((4096, 64), (4096, 128), (4096, 100), (4093, 64))
OPAQUE = (256, 64)  # rays whose transmittance underflows after the first sample
MAX_LISTED = 16  # kink samples listed per case


def ray_batch(cfg, n_rays, n_samples, gen, device):
    """Rays from a radius-4 sphere towards its centre, z sorted in [2, 6]
    (``chip_smoke.py``'s batches): ``(rd, z)``."""
    from nerf_and_dietnerf_tpu_torch.core import cameras

    o = torch.randn((n_rays, 3), generator=gen, device=device)
    o = 4 * o / o.norm(dim=1, keepdim=True)
    d = -o / 4 + 0.3 * torch.randn((n_rays, 3), generator=gen, device=device)
    vc = cameras.view_direction_components(d, cfg.n_angles) if cfg.uses_view_dirs else None
    z = torch.sort(2 + 4 * torch.rand((n_rays, n_samples), generator=gen, device=device),
                   dim=1).values.contiguous()
    return rk.pack_rays(cfg, o, d, vc), z


def enc_batch(cfg, cd, rd, z, gen):
    """B5's inputs on the rays ``(rd, z)``: ``(enc, encd, z, dvec, target)``,
    the targets below every pixel."""
    pts = (rd[:, None, 0:3] + z[..., None] * rd[:, None, 3:6]).reshape(-1, 3)
    enc = encoding.encode_xyz(pts, cfg.n_freq_xyz).to(cd).contiguous()
    encd = (encoding.encode_view_dirs(rd[:, 6:], cfg.n_freq_dir).contiguous()
            if cfg.uses_view_dirs else None)
    target = -(0.5 + torch.rand((z.shape[0], 3), generator=gen, device=z.device))
    return enc, encd, z, rd[:, 3:6].contiguous(), target


# The floor of every scale below, as chip_smoke.py's checks take it: a leaf
# whose values are all below it (the sigma head on opaque rays, where every
# sigma cotangent underflows) counts as zero.
TINY = 1e-30


def _scaled(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(TINY))


def distance(got, ref) -> dict:
    """``got`` against ``ref``, each ``(dws, dbs, dz, loss | None[, rows])``;
    ``rows`` (B4) maps names to per-row / per-ray gradients, held normwise."""
    gl, rl = list(got[0]) + list(got[1]), list(ref[0]) + list(ref[1])
    leaf = [_scaled(a, b) for a, b in zip(gl, rl)]
    flat = lambda ts: torch.cat([t.reshape(-1).double() for t in ts])  # noqa: E731
    gp, rp = flat(gl), flat(rl)
    dz, rdz = got[2].double(), ref[2].double()
    out = {"dz_normwise": float((dz - rdz).norm() / rdz.norm().clamp_min(TINY)),
           "dz_scaled_max": _scaled(dz, rdz),
           "dparams_worst_leaf": max(leaf), "worst_leaf": leaf.index(max(leaf)),
           "dparams_normwise": float((gp - rp).norm() / rp.norm().clamp_min(TINY)),
           "max_abs": float(max((gp - rp).abs().max(), (dz - rdz).abs().max()))}
    if got[3] is not None:
        out["loss_rel"] = abs(float(got[3]) - float(ref[3])) / abs(float(ref[3]))
        out["max_abs"] = max(out["max_abs"], abs(float(got[3]) - float(ref[3])))
    for name, a in (got[4] if len(got) > 4 else {}).items():
        a, b = a.double(), ref[4][name].double()
        out[f"{name}_normwise"] = float((a - b).norm() / b.norm().clamp_min(TINY))
        out["max_abs"] = max(out["max_abs"], float((a - b).abs().max()))
    return out


def kink_samples(raw_k, raw_ref) -> dict:
    """The samples whose raw sigma has another sign in ``raw_k`` than in
    ``raw_ref`` (both (R, S, 4))."""
    sk, sr = raw_k[..., 3].double(), raw_ref[..., 3].double()
    S = sk.shape[1]
    flip = (sk > 0) != (sr > 0)
    where = flip.nonzero().tolist()
    rpg = 1 if S >= BM else BM // S
    return {"count": len(where), "share": len(where) / flip.numel(),
            "max_abs_sigma": float(sr[flip].abs().max()) if where else 0.0,
            "max_sigma_diff": float((sk - sr).abs().max()),
            "samples": [{"ray": r, "sample": s, "tile_row": ((r % rpg) * S + s) % BM}
                        for r, s in where[:MAX_LISTED]]}


def b4_result(dws, dbs, denc, dencd, dz) -> tuple:
    """B4's backward as :func:`distance` takes it."""
    rows = {"denc": denc} if dencd is None else {"denc": denc, "dencd": dencd}
    return dws, dbs, dz, None, rows


def plain_of(kernel: str, ws, bs, cfg, cd, args):
    """``(plain, raw_plain, guard)`` of kernel ``kernel`` ("B7" on ``args =
    (rd, z, g_rgb, g_w)``, "B5" on ``args = (enc, encd, z, dvec, target)``,
    "B4" on ``args = (enc, encd, z, g_rgb, g_w)``): ``plain(**kw)`` its plain
    version as ``(dws, dbs, dz, loss | None[, rows])`` (keywords ``work``,
    ``raw_sigma``, ``branches``), ``raw_plain(work)`` the raw values (R, S,
    4) that version composites, ``guard(mask)``
    :func:`raymarch_cuda.branch_guard`'s record of a recorded mask against
    the f64 chain's own signs."""
    if kernel == "B7":
        rd, z = args[:2]
        _, x, d = rk._mlp_inputs(cfg, rd, z, cd)

        def plain(**kw):
            return (*rk.raymarch_comp_bwd_plain(ws, bs, cfg, *args, cd, **kw), None)
    elif kernel == "B4":
        z = args[2]
        x, d = args[0], rk._dir_rows(cfg, args[1], z.shape[1], cd)

        def plain(**kw):
            return b4_result(*rk.mlp_comp_bwd_plain(ws, bs, cfg, *args, cd, **kw))
    else:
        z = args[2]
        x, d = args[0], rk._dir_rows(cfg, args[1], z.shape[1], cd)

        def plain(**kw):
            mse, dz, dws, dbs = rk.mlp_loss_comp_plain(ws, bs, cfg, *args, cd, **kw)
            return dws, dbs, dz, mse
    def guard(mask):
        pres: list = []
        rc._forward_plain(ws, bs, cfg, x, d, cd, F64, pres=pres)
        return rc.branch_guard(mask, pres, cfg, cd)

    return plain, lambda work: rc._forward_plain(ws, bs, cfg, x, d, cd, work)[0].reshape(
        *z.shape, 4), guard


def compare(plain, raw_plain, guard, got, raw=None, branches=None) -> dict:
    """The record of one case: the kernel's results ``got`` (as
    :func:`distance` takes them) against the references and, where the kernel gave the raw
    values it composited (``raw``), its kink samples and raw error; where it
    also gave the slopes it took (``branches``, a recording build's whose
    outputs were bitwise ``got``), the guard's record and, if that passes,
    ``f64_branches``."""
    refs = {"plain": plain(), "f64": plain(work=F64)}
    rec = {}
    if raw is not None:
        raw32 = raw_plain(torch.float32)
        rec["raw_scaled_err_vs_plain"] = _scaled(raw, raw32)
        rec["kink_vs_plain"] = kink_samples(raw, raw32)
        del raw32
        rec["kink_vs_f64"] = kink_samples(raw, raw_plain(F64))
        refs["plain_kink"] = plain(raw_sigma=raw[..., 3])
        refs["f64_kink"] = plain(work=F64, raw_sigma=raw[..., 3])
        if branches is not None:
            rec["branches"] = guard(branches)
            if rec["branches"]["ok"]:
                refs["f64_branches"] = plain(work=F64, raw_sigma=raw[..., 3], branches=branches)
    for key, ref in refs.items():
        rec[key] = distance(got, ref)
    rec["plain_vs_f64"] = distance(refs["plain"], refs["f64"])
    return rec


def run(kernel: str, ws, bs, cfg, cd, args, raw=None, branches=None) -> tuple:
    """Kernel ``kernel``'s wrapper (as :func:`plain_of`) on ``args``, its
    result as :func:`distance` takes it; ``raw`` and ``branches`` as the
    wrappers take them."""
    kw = {"raw": raw, "branches": branches}
    if kernel == "B7":
        return (*rk.raymarch_comp_bwd(ws, bs, cfg, *args, cd, **kw), None)
    if kernel == "B4":
        return b4_result(*rk.mlp_comp_bwd(ws, bs, cfg, *args, cd, **kw))
    mse, dz, dws, dbs = rk.mlp_loss_comp(ws, bs, cfg, *args, cd, **kw)
    return dws, dbs, dz, mse


def tensors_of(result) -> list:
    """Every tensor of a result as :func:`distance` takes it."""
    rows = result[4] if len(result) > 4 else {}
    return (list(result[0]) + list(result[1]) + [result[2]]
            + ([result[3]] if result[3] is not None else []) + list(rows.values()))


def recorded(run_kernel, got, z, cfg):
    """``(mask, bitwise)``: the slopes the recording build took, from
    ``run_kernel(branches=mask)`` on the inputs that gave ``got``, and
    whether its outputs are bitwise ``got``."""
    mask = rc.branch_mask(cfg, z.numel(), z.device)
    again = run_kernel(branches=mask)
    return mask, all(torch.equal(a, b) for a, b in zip(tensors_of(got), tensors_of(again)))


def held(kernel: str, ws, bs, cfg, cd, args) -> dict:
    """Kernel ``kernel`` (as :func:`plain_of`) in bf16, with its raw output
    and its recording build's slopes, against the references
    (:func:`compare`)."""
    z = args[1] if kernel == "B7" else args[2]
    raw = torch.empty((*z.shape, 4), dtype=torch.float32, device=z.device)
    got = run(kernel, ws, bs, cfg, cd, args, raw=raw)
    mask, bitwise = recorded(lambda **kw: run(kernel, ws, bs, cfg, cd, args, **kw), got, z, cfg)
    rec = compare(*plain_of(kernel, ws, bs, cfg, cd, args), got, raw, mask if bitwise else None)
    rec["recording_bitwise"] = bitwise
    return rec


def summary(records) -> dict:
    """Per kernel, the worst dparams leaf over ``records`` (``{"kernel", ...
    :func:`compare`'s keys}``) against each reference, and the cases."""
    out = {}
    for rec in records:
        k = out.setdefault(rec["kernel"], {"cases": 0})
        k["cases"] += 1
        for ref in ("plain", "f64", "plain_kink", "f64_kink", "f64_branches"):
            if ref in rec:
                k[ref] = max(k.get(ref, 0.0), rec[ref]["dparams_worst_leaf"])
        k["recording_bitwise"] = k.get("recording_bitwise", True) and rec["recording_bitwise"]
        k["guard_ok"] = k.get("guard_ok", True) and rec.get("branches", {}).get("ok", False)
    return out


def cases(device, seeds, rays, hidden, opaque_only=False):
    """``(label, kernel, ws, bs, cfg, args)`` of every case: the three kernels,
    both variants, the shapes of :data:`SHAPES` (``rays`` scales the ray
    counts) and the opaque rays, for each seed; with ``opaque_only`` the
    opaque rays alone."""
    cd = torch.bfloat16
    widths = {} if hidden is None else {"hidden_dim": hidden, "last_hidden_dim": hidden // 2}
    for seed in seeds:
        for variant, n_angles in (("view_dirs", 2), ("xyz_only", 0)):
            cfg = mlp.MLPConfig(n_angles=n_angles, **widths)
            params = mlp.init_params(torch.Generator().manual_seed(seed), cfg, device=device)
            shapes = [] if opaque_only else [(max(1, n_r * rays // 4096), n_s, False)
                                             for n_r, n_s in SHAPES]
            if variant == "xyz_only":
                shapes.append((max(1, OPAQUE[0] * rays // 4096), OPAQUE[1], True))
            for n_r, n_s, opaque in shapes:
                p = params
                if opaque:
                    p = {**params, "sigma_out": {**params["sigma_out"],
                                                 "bias": params["sigma_out"]["bias"] + 1e6}}
                ws, bs = rc.flatten_params(p, cfg, cd)
                gen = torch.Generator(device=device).manual_seed(1000 * seed + n_r + n_s)
                rd, z = ray_batch(cfg, n_r, n_s, gen, device)
                label = f"seed={seed} {variant} R={n_r} S={n_s}" + (" opaque" if opaque else "")
                g_rgb = (0.5 + torch.rand((n_r, 3), generator=gen, device=device)).contiguous()
                g_w = (0.5 + torch.rand((n_r, n_s), generator=gen, device=device)).contiguous()
                yield label, "B7", ws, bs, cfg, (rd, z, g_rgb, g_w)
                batch = enc_batch(cfg, cd, rd, z, gen)
                yield label, "B5", ws, bs, cfg, batch
                yield label, "B4", ws, bs, cfg, (*batch[:3], g_rgb, g_w)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu (plain versions)")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--rays", type=int, default=4096, help="ray count of the 4096-ray cases")
    p.add_argument("--hidden", type=int, default=None, help="trunk width (default the model's)")
    p.add_argument("--out", type=Path, default=None, help="also write the lines to this file")
    p.add_argument("--opaque-only", action="store_true", help="the opaque rays' cases alone")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    lines, records = [], []
    for label, kernel, ws, bs, cfg, inputs in cases(device, args.seeds, args.rays, args.hidden,
                                                    args.opaque_only):
        rec = {"case": label, "kernel": kernel, **held(kernel, ws, bs, cfg, torch.bfloat16, inputs)}
        assert all(math.isfinite(v) for k, v in rec.items() if isinstance(v, float))
        records.append(rec)
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    lines.append(json.dumps({"summary_worst_dparams_leaf": summary(records)}))
    print(lines[-1], flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
