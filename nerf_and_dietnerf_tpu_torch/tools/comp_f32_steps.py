#!/usr/bin/env python
"""Where f32 B7's backward (``raymarch_comp_bwd``, the 3xTF32 tensor-core
tiles of ``csrc/mlp_tf32_mma_tile.cuh``; the FMA tiles before) parts from
the f64 chain, step by step; f32 B4's backward (``mlp_comp_bwd``, the same
tiles through the same ray-group loop) beside it.

``chip_smoke.py``'s ``b7_vs_f64_chain`` holds a kernel's dparams against the
plain version with the MLP's products and sums in f64 and the compositing in
f32 (autograd of ``core.rendering.composite`` on the f64 raw values rounded to
f32): the "chain". On the FMA tiles f32 B7's backward read several times the
plain f32 version's distance to it with view dirs (ROADMAP C3). The kernel's
result is

    dparams = MLP_k(g_k),   g_k = VJP_serial(raw_k),

its own raw values through ``composite_ray_bwd`` (``csrc/composite_common.cuh``)
then the tiles' backward walk, where the plain version's is
``MLP_f32(VJP_autograd(raw_f32))``. Per case this prints one JSON line:

- ``raw``: the kernel's raw values (its ``raw=`` output) and the plain f32
  version's against the f64 forward's (normwise, and the largest sigma
  difference);
- ``g_raw``: ``VJP_serial`` (emulated here in the kernel's order) on the
  kernel's raw values and on the f64 raw values, and autograd's on the plain
  f32 raw values, against the chain's cotangent, and against an f64 VJP of
  the f64 raw values (``exact``, the same recurrence in f64);
- ``dparams``: the kernel's and the plain version's normwise distance to the
  chain and to the exact end (f64 MLP on the exact cotangent), the share the
  cotangent alone gives (f64 MLP on each cotangent) and the MLP's own (the
  kernel against the f64 MLP on its emulated cotangent; f32 B6's backward,
  B2's 3xTF32 tile in strided 64-row tiles, on that cotangent against B7's
  dparams), and the leaves
  where the kernel's distance is largest;
- for B4 the kernel's and the plain version's dparams against B4's chain.

    python -m nerf_and_dietnerf_tpu_torch.tools.comp_f32_steps [--seeds 0 1] [--out PATH]
    python -m nerf_and_dietnerf_tpu_torch.tools.comp_f32_steps --device cpu --rays 8 --hidden 32
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

from nerf_and_dietnerf_tpu_torch.models import mlp
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
from nerf_and_dietnerf_tpu_torch.tools.comp_kink import enc_batch, ray_batch
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device

F32, F64 = torch.float32, torch.float64
SAMPLES = 64  # the coarse pass, where chip_smoke.py reads C3
TOP_LEAVES = 4


def vjp_serial(raw, z, g_rgb, g_w):
    """``composite_ray_bwd`` for every ray at once, in its order, in the
    dtype of ``raw``: ``(g_raw (R, S, 4), dz (R, S))``."""
    n, S = z.shape
    dt = raw.dtype
    z, g_rgb, g_w = z.to(dt), g_rgb.to(dt), g_w.to(dt)
    big = torch.full((n,), 1e9, dtype=dt, device=raw.device)
    delta = [z[:, s + 1] - z[:, s] if s < S - 1 else big for s in range(S)]
    T, e_all, t_all = torch.ones(n, dtype=dt, device=raw.device), [], []
    for s in range(S):
        e = torch.exp(-torch.clamp_min(raw[:, s, 3], 0.0) * delta[s])
        e_all.append(e)
        t_all.append(T)
        T = T * (1.0 - (1.0 - e))
    g_raw = torch.zeros_like(raw)
    dz = torch.zeros_like(z)
    c_next = torch.zeros(n, dtype=dt, device=raw.device)
    for s in reversed(range(S)):
        e = e_all[s]
        alpha = 1.0 - e
        pre = raw[:, s, 3]
        c = 1.0 / (1.0 + torch.exp(-raw[:, s, :3]))
        gw = c[:, 0] * g_rgb[:, 0]
        gw = gw + c[:, 1] * g_rgb[:, 1]
        gw = gw + c[:, 2] * g_rgb[:, 2]
        gw = g_w[:, s] + gw
        da = (gw - c_next) * t_all[s]
        c_next = gw * alpha + (1.0 - alpha) * c_next
        w = alpha * t_all[s]
        g_raw[:, s, :3] = ((w[:, None] * g_rgb) * c) * (1.0 - c)
        g_raw[:, s, 3] = torch.where(pre > 0, da * delta[s] * e, torch.zeros_like(e))
        if s < S - 1:
            dd = da * torch.clamp_min(pre, 0.0) * e
            dz[:, s] = -dd
            dz[:, s + 1] = dz[:, s + 1] + dd
    return g_raw, dz


def _norm(a, ref) -> float:
    a, ref = a.reshape(-1).double(), ref.reshape(-1).double()
    return float((a - ref).norm() / ref.norm().clamp_min(1e-300))


def _flat(dws, dbs):
    return torch.cat([t.reshape(-1).double() for t in list(dws) + list(dbs)])


def _leaves(dws, dbs, ref_ws, ref_bs) -> list:
    """Per leaf normwise distance, weights 0.. then biases ("w3", "b9")."""
    out = [(f"w{i}", _norm(a, b)) for i, (a, b) in enumerate(zip(dws, ref_ws))]
    return out + [(f"b{i}", _norm(a, b)) for i, (a, b) in enumerate(zip(dbs, ref_bs))]


def b7_steps(ws, bs, cfg, rd, z, g_rgb, g_w) -> dict:
    """The record of one f32 B7 case (see the module docstring)."""
    _, x, d = rk._mlp_inputs(cfg, rd, z, F32)

    def mlp64(g):  # the chain's MLP backward (f64 sums) on the cotangent g
        return rc.mlp_bwd_plain(ws, bs, cfg, x, d, g.reshape(-1, 4), F32, F64)[:2]

    raw_k = torch.empty((*z.shape, 4), dtype=F32, device=z.device)
    kws, kbs, _ = rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, g_rgb, g_w, F32, raw=raw_k)
    raw64 = rc._forward_plain(ws, bs, cfg, x, d, F32, F64)[0].reshape(*z.shape, 4)
    raw32 = rk.raymarch_fwd_plain(ws, bs, cfg, rd, z, F32)
    rec = {"raw": {"kernel": _norm(raw_k, raw64), "plain": _norm(raw32, raw64),
                   "kernel_sigma_max_diff": float((raw_k[..., 3].double()
                                                   - raw64[..., 3]).abs().max()),
                   "plain_sigma_max_diff": float((raw32[..., 3].double()
                                                  - raw64[..., 3]).abs().max())}}
    g_chain = rk.composite_vjp(raw64.float(), z, g_rgb, g_w)[0]
    g_exact = vjp_serial(raw64, z, g_rgb, g_w)[0]  # in f64
    g_k = vjp_serial(raw_k, z, g_rgb, g_w)[0]
    g_ser64 = vjp_serial(raw64.float(), z, g_rgb, g_w)[0]
    g_p = rk.composite_vjp(raw32, z, g_rgb, g_w)[0]
    rec["g_raw"] = {who: {"vs_chain": _norm(g, g_chain), "vs_exact": _norm(g, g_exact)}
                    for who, g in (("kernel_serial", g_k), ("serial_on_f64_raw", g_ser64),
                                   ("plain_autograd", g_p), ("chain", g_chain))}
    ref_ws, ref_bs = mlp64(g_chain)
    ref, exact = _flat(ref_ws, ref_bs), _flat(*mlp64(g_exact))
    pws, pbs, _ = rk.raymarch_comp_bwd_plain(ws, bs, cfg, rd, z, g_rgb, g_w, F32)
    k, p = _flat(kws, kbs), _flat(pws, pbs)
    from_g_k, from_g_p, from_g_ser64 = (_flat(*mlp64(g)) for g in (g_k, g_p, g_ser64))
    b6ws, b6bs, _ = rk.raymarch_bwd(ws, bs, cfg, rd, z, g_k.contiguous(), F32)
    b6 = _flat(b6ws, b6bs)
    leaves = sorted(_leaves(kws, kbs, ref_ws, ref_bs), key=lambda t: -t[1])[:TOP_LEAVES]
    plain_leaves = dict(_leaves(pws, pbs, ref_ws, ref_bs))
    rec["dparams"] = {
        "kernel_vs_chain": _norm(k, ref), "plain_vs_chain": _norm(p, ref),
        "kernel_vs_exact": _norm(k, exact), "plain_vs_exact": _norm(p, exact),
        "chain_vs_exact": _norm(ref, exact),
        "cotangent_alone": {"kernel": _norm(from_g_k, ref), "plain": _norm(from_g_p, ref),
                            "serial_on_f64_raw": _norm(from_g_ser64, ref)},
        "mlp_alone": {"kernel": _norm(k, from_g_k), "plain": _norm(p, from_g_p)},
        "b6_on_kernel_cotangent_vs_b7": _norm(b6, k),
        "worst_leaves": [{"leaf": n, "kernel": v, "plain": plain_leaves[n]} for n, v in leaves],
    }
    rec["dparams"]["ratio_kernel_to_plain"] = (rec["dparams"]["kernel_vs_chain"]
                                               / max(rec["dparams"]["plain_vs_chain"], 1e-300))
    return rec


def b4_steps(ws, bs, cfg, enc, encd, z, g_rgb, g_w) -> dict:
    """f32 B4's and its plain version's dparams against B4's chain."""
    k = rk.mlp_comp_bwd(ws, bs, cfg, enc, encd, z, g_rgb, g_w, F32)
    p = rk.mlp_comp_bwd_plain(ws, bs, cfg, enc, encd, z, g_rgb, g_w, F32)
    e = rk.mlp_comp_bwd_plain(ws, bs, cfg, enc, encd, z, g_rgb, g_w, F32, work=F64)
    ref = _flat(e[0], e[1])
    out = {"kernel_vs_chain": _norm(_flat(k[0], k[1]), ref),
           "plain_vs_chain": _norm(_flat(p[0], p[1]), ref)}
    out["ratio_kernel_to_plain"] = out["kernel_vs_chain"] / max(out["plain_vs_chain"], 1e-300)
    return out


def cases(device, seeds, rays, hidden):
    """``(label, ws, bs, cfg, rd, z, g_rgb, g_w, b4_inputs)``: both variants,
    ``rays`` rays of :data:`SAMPLES` samples, for each seed (the batches of
    ``tools/comp_kink.py``)."""
    widths = {} if hidden is None else {"hidden_dim": hidden, "last_hidden_dim": hidden // 2}
    for seed in seeds:
        for variant, n_angles in (("view_dirs", 2), ("xyz_only", 0)):
            cfg = mlp.MLPConfig(n_angles=n_angles, **widths)
            params = mlp.init_params(torch.Generator().manual_seed(seed), cfg, device=device)
            ws, bs = rc.flatten_params(params, cfg, F32)
            gen = torch.Generator(device=device).manual_seed(1000 * seed + rays + SAMPLES)
            rd, z = ray_batch(cfg, rays, SAMPLES, gen, device)
            g_rgb = (0.5 + torch.rand((rays, 3), generator=gen, device=device)).contiguous()
            g_w = (0.5 + torch.rand((rays, SAMPLES), generator=gen, device=device)).contiguous()
            enc, encd = enc_batch(cfg, F32, rd, z, gen)[:2]
            yield (f"seed={seed} {variant} R={rays} S={SAMPLES}", ws, bs, cfg, rd, z, g_rgb, g_w,
                   (enc, encd))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu (plain versions)")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--rays", type=int, default=4096)
    p.add_argument("--hidden", type=int, default=None, help="trunk width (default the model's)")
    p.add_argument("--out", type=Path, default=None, help="also write the lines to this file")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    lines = []
    for label, ws, bs, cfg, rd, z, g_rgb, g_w, (enc, encd) in cases(
            device, args.seeds, args.rays, args.hidden):
        rec = {"case": label, "b7": b7_steps(ws, bs, cfg, rd, z, g_rgb, g_w),
               "b4": b4_steps(ws, bs, cfg, enc, encd, z, g_rgb, g_w)}
        assert all(math.isfinite(v) for v in (rec["b7"]["dparams"]["kernel_vs_chain"],
                                              rec["b4"]["kernel_vs_chain"]))
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
