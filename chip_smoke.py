#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the radiance-MLP kernels (B1 ``mlp_fwd``, B2 ``mlp_bwd``) from
``nerf_and_dietnerf_tpu_torch/csrc`` with ``nvcc`` into ``build/kernels/``,
holds each against its plain PyTorch version at the flagship widths in bf16
and f32, checks that B2's gradients are bitwise reproducible, then trains the
flagship-width NeRF (4096 rays, 64 + 128 samples, 256/128 wide, bf16 step,
f32 eval renders) for two epochs on a synthetic scene made from a seed,
saves and restores its state, and prints timings beside the card's name and
power limit. Any failed phase raises and the script exits non-zero; without
a GPU, or without the package beside it, it exits non-zero before printing
a result.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it holds the card's name and power limit, and the one before
that the per-kernel JSON record.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
N_ROWS = 4096 * 64  # the coarse pass of one train step
# Scaled max error |kernel - plain| / max|plain|. Forward, f32: both sum
# exact f32 products, only the summation order differs. Forward, bf16: the
# plain version rounds at the same places, but a 1-ulp difference in a sum
# can flip a bf16 rounding of an activation, which moves later layers by up
# to 2^-8.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Backward: the leaky gradient jumps from 1 to alpha at 0, so wherever a
# pre-activation lies within summation-order noise of 0 the two versions
# take different branches for that element; each such row moves its dx / dd
# row by up to (1 - alpha) of one term and every weight gradient by one
# row's share. The cotangent is random but positive, U(0.5, 1.5), so the
# weight gradients do not cancel to a small sum that one such row would
# dominate, and their f32 tolerance is 1e-3. The per-row dx and dd are held
# normwise (|k - p|_2 / |p|_2) to TOL_ROWS; their elementwise maximum and the
# share of rows beyond it are printed, not held, since single rows carry
# those flips whole (and in bf16 a 1-ulp flip of a rounded gradient, 2^-8
# relative, carried through the rest of the chain).
TOL_BWD = {"float32": 1e-3, "bfloat16": 2e-2}
TOL_ROWS = {"float32": 5e-3, "bfloat16": 2e-2}
# H100 SXM peaks: dense bf16 tensor-core and non-tensor f32 rates, HBM rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------- #
# Kernel phases                                                                #
# --------------------------------------------------------------------------- #

def _mlp_flops(cfg, n):
    xyz, hid, last = cfg.xyz_dim, cfg.hidden_dim, cfg.last_hidden_dim
    macs = xyz * hid + 6 * hid * hid + (xyz + hid) * hid
    if cfg.uses_view_dirs:
        feat = hid + cfg.dir_dim
        macs += feat * last + last * 3 + feat
    else:
        macs += hid * hid + hid * last + last * 3 + hid
    return 2 * macs * n


def _inputs(torch, cfg, cd, n, gen):
    from nerf_and_dietnerf_tpu_torch.core import encoding

    pts = torch.rand((n, 3), generator=gen, device="cuda") * 2 - 1
    x = encoding.encode_xyz(pts, cfg.n_freq_xyz).to(cd).contiguous()
    d = None
    if cfg.uses_view_dirs:
        dirs = torch.randn((n, cfg.n_angles + 1), generator=gen, device="cuda")
        d = encoding.encode_view_dirs(dirs, cfg.n_freq_dir).to(cd).contiguous()
    g = (0.5 + torch.rand((n, 4), generator=gen, device="cuda")).contiguous()
    return x, d, g


def _scaled_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def _row_errs(a, b, tol):
    """Per-row input gradients (dx, dd): ``(scaled max err, normwise err,
    share of rows whose scaled err exceeds tol)``."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    scale = b.abs().max().clamp_min(1e-30)
    row = diff.max(dim=1).values / scale
    return (float(row.max()), float(diff.norm() / b.norm().clamp_min(1e-30)),
            float((row > tol).float().mean()))


def _time_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _library_mlp(torch, ws, bs, cfg, x, d):
    """The same MLP as a chain of ``torch.addmm`` calls in the compute type
    (cuBLAS): a yardstick only, never used by the port."""
    a = cfg.leaky_relu_alpha
    cd = x.dtype
    bsc = [b.to(cd) for b in bs]
    leaky = lambda t: torch.where(t >= 0, t, a * t)  # noqa: E731
    h = x
    for layer in range(8):
        if layer == 4:
            h = leaky(torch.addmm(torch.addmm(bsc[4], x, ws[4]), h, ws[5]))
        else:
            h = leaky(torch.addmm(bsc[layer], h, ws[layer if layer < 4 else layer + 1]))
    if cfg.uses_view_dirs:
        r = leaky(torch.addmm(torch.addmm(bsc[8], h, ws[9]), d, ws[10]))
        rgb = torch.addmm(bsc[9], r, ws[11])
        sig = torch.addmm(torch.addmm(bsc[10], h, ws[12]), d, ws[13])
    else:
        r = leaky(torch.addmm(bsc[8], h, ws[9]))
        r = leaky(torch.addmm(bsc[9], r, ws[10]))
        rgb = torch.addmm(bsc[10], r, ws[11])
        sig = torch.addmm(bsc[11], h, ws[12])
    return torch.cat([rgb, sig], -1)


def kernel_phases(torch, timings: dict) -> None:
    from nerf_and_dietnerf_tpu_torch.models import mlp
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for variant, n_angles in (("view_dirs", 2), ("xyz_only", 0)):
        cfg = mlp.MLPConfig(n_angles=n_angles)
        params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device="cuda")
        for cd in (torch.bfloat16, torch.float32):
            name = str(cd).split(".")[-1]
            tol = TOL[name]
            ws, bs = rc.flatten_params(params, cfg, cd)
            x, d, g = _inputs(torch, cfg, cd, N_ROWS, gen)

            out_k = rc.mlp_fwd(ws, bs, cfg, x, d, cd)
            torch.cuda.synchronize()
            out_p = rc.mlp_fwd_plain(ws, bs, cfg, x, d, cd)
            e_fwd = _scaled_err(out_k, out_p)
            if not (torch.isfinite(out_k).all() and e_fwd <= tol):
                raise AssertionError(f"mlp_fwd {variant} {name}: scaled err {e_fwd} > {tol}")

            dws, dbs, dx, dd = rc.mlp_bwd(ws, bs, cfg, x, d, g, cd)
            torch.cuda.synchronize()
            pws, pbs, pdx, pdd = rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, cd)
            tol_b, tol_r = TOL_BWD[name], TOL_ROWS[name]
            e_par = max(_scaled_err(a, b) for a, b in zip(dws + dbs, pws + pbs))
            rows = [("dx", dx, pdx)] + ([("dd", dd, pdd)] if d is not None else [])
            row_stats = {k: _row_errs(a, b, tol_r) for k, a, b in rows}
            pairs = list(zip(dws + dbs, pws + pbs)) + [(a, b) for _, a, b in rows]
            abs_bwd = max(float((a - b).abs().max()) for a, b in pairs)
            abs_fwd = float((out_k - out_p).abs().max())
            bad = [k for k, (_, norm, _) in row_stats.items()
                   if norm > tol_r]
            if e_par > tol_b or bad:
                raise AssertionError(f"mlp_bwd {variant} {name}: dparams scaled err {e_par} "
                                     f"(tol {tol_b}); per-row {row_stats} (tol {tol_r})")

            dws2, dbs2, _, _ = rc.mlp_bwd(ws, bs, cfg, x, d, g, cd)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2)):
                raise AssertionError(f"mlp_bwd {variant} {name}: dparams differ between runs")
            log(f"kernel check {variant} {name} rows={N_ROWS}: fwd scaled err {e_fwd:.3e}, "
                f"bwd dparams scaled err {e_par:.3e} (tol {tol_b}); dx/dd (scaled max, "
                f"normwise, share of rows over tol): {row_stats} (tol {tol_r}); dparams bitwise equal "
                f"across two runs")

            if variant != "view_dirs":
                continue
            # Times at the main path's shapes: bf16 is the train step's coarse
            # pass, f32 the eval render's.
            del pws, pbs, pdx, pdd, dws2, dbs2
            flops = _mlp_flops(cfg, N_ROWS)
            es = x.element_size()
            n_par = sum(w.numel() for w in ws) + sum(b.numel() for b in bs)
            in_bytes = N_ROWS * (cfg.xyz_dim + cfg.dir_dim) * es + sum(
                w.numel() * es for w in ws) + sum(b.numel() * 4 for b in bs)
            leaves = [w.detach().clone().requires_grad_(True) for w in ws]

            def lib_bwd():
                out = _library_mlp(torch, leaves, bs, cfg, x, d)
                torch.autograd.grad(out, leaves, g.to(out.dtype))

            rec = {}
            for kname, fn, plain, lib, fl, nbytes in (
                ("mlp_fwd",
                 lambda: rc.mlp_fwd(ws, bs, cfg, x, d, cd),
                 lambda: rc.mlp_fwd_plain(ws, bs, cfg, x, d, cd),
                 lambda: _library_mlp(torch, ws, bs, cfg, x, d),
                 flops, in_bytes + N_ROWS * 16),
                ("mlp_bwd",
                 lambda: rc.mlp_bwd(ws, bs, cfg, x, d, g, cd),
                 lambda: rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, cd),
                 lib_bwd,
                 3 * flops,
                 in_bytes + N_ROWS * 16 + N_ROWS * (cfg.xyz_dim + cfg.dir_dim) * 4
                 + n_par * 4),
            ):
                before = dict(rc.LAUNCHES)
                ms = _time_ms(torch, fn)
                rc.LAUNCHES.update(before)  # timing launches are not the main path's
                rec[kname] = {
                    "rows": N_ROWS, "dtype": name,
                    "ms": ms,
                    "plain_ms": _time_ms(torch, plain, reps=2),
                    "library_ms": _time_ms(torch, lib),
                    "bound_ms": 1e3 * max(fl / PEAK_FLOPS[name], nbytes / PEAK_BYTES),
                    "bound_by": "operations" if fl / PEAK_FLOPS[name] >= nbytes / PEAK_BYTES
                    else "bytes",
                    "max_abs_err": abs_fwd if kname == "mlp_fwd" else abs_bwd,
                }
            if cd == torch.bfloat16:
                # The fine pass of a train step runs both kernels on twice the rows.
                x2, d2, g2 = (torch.cat([t, t]) for t in (x, d, g))
                before = dict(rc.LAUNCHES)
                rec["mlp_fwd"]["ms_fine_pass"] = _time_ms(
                    torch, lambda: rc.mlp_fwd(ws, bs, cfg, x2, d2, cd), reps=3)
                rec["mlp_bwd"]["ms_fine_pass"] = _time_ms(
                    torch, lambda: rc.mlp_bwd(ws, bs, cfg, x2, d2, g2, cd), reps=3)
                rc.LAUNCHES.update(before)
                log(f"time fine pass ({2 * N_ROWS} rows, bf16): mlp_fwd "
                    f"{rec['mlp_fwd']['ms_fine_pass']:.3f} ms, mlp_bwd "
                    f"{rec['mlp_bwd']['ms_fine_pass']:.3f} ms")
            timings[name] = rec
            for kname, r in rec.items():
                log(f"time {kname} {name} rows={N_ROWS}: kernel {r['ms']:.3f} ms, plain "
                    f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


# --------------------------------------------------------------------------- #
# Training phase                                                               #
# --------------------------------------------------------------------------- #

def synthetic_scene(n_views=9, size=128, seed=SEED):
    """A unit sphere coloured by its normal (0.5 + 0.5 n), black background,
    seen by ``n_views`` cameras on a radius-4 ring looking at the origin.
    Rendered analytically in numpy, so the views are consistent."""
    import numpy as np

    from nerf_and_dietnerf_tpu_torch.data.loaders import Dataset

    rng = np.random.default_rng(seed)
    fov = 0.7
    poses, images = [], []
    for i in range(n_views):
        phi = 2 * math.pi * i / n_views + rng.uniform(-0.1, 0.1)
        pos = np.array([4 * math.sin(phi), 1.0, 4 * math.cos(phi)])
        z = pos / np.linalg.norm(pos)             # the camera looks down -z
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
        u = (np.arange(size) + 0.5) / size
        xs, ys = np.meshgrid((2 * u - 1) * math.tan(fov / 2), (1 - 2 * u) * math.tan(fov / 2))
        d = np.stack([xs, ys, -np.ones_like(xs)], -1) @ c2w[:3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        b = (d * pos).sum(-1)
        disc = b * b - (pos @ pos - 1.0)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit = disc > 0
        normal = pos + t[..., None] * d
        img = np.where(hit[..., None], 0.5 + 0.5 * normal, 0.0)
        poses.append(c2w)
        images.append(img)
    return Dataset(
        images=np.asarray(images, np.float32), camera_poses=np.asarray(poses, np.float32),
        field_of_view=fov, near=2.0, far=6.0,
        average_c2w_before_recenter=np.eye(4), scale=1.0,
    )


def train_phase(torch, timings: dict) -> dict:
    import numpy as np

    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
    from nerf_and_dietnerf_tpu_torch.train.trainer import Trainer
    from nerf_and_dietnerf_tpu_torch.utils.config import RunConfig

    run = RunConfig(
        hidden_layer_dim=256, last_hidden_layer_dim=128, n_pos_enc_dim_xyz=5,
        n_pos_enc_view_dir=4, n_angles_for_model=2, n_rays_in_batch_train=4096,
        n_render_samples_coarse=64, n_render_samples_fine=128, n_epochs=2,
        test_img_idx=0, idx_train_img_to_plot=1, compute_dtype="bfloat16",
        backend="pallas", init_seed=SEED,
    )
    ds = synthetic_scene()
    save_dir = ROOT / "build" / "chip_smoke_run"
    trainer = Trainer(run, ds, save_dir, device="cuda")
    steps = trainer.data.batches_per_epoch
    log(f"train: {len(trainer.train_indices)} views of {ds.height}x{ds.width}, "
        f"{trainer.data.n_rays} rays, {steps} steps per epoch")

    torch.cuda.synchronize()
    rc.reset_launch_counts()
    stats = [trainer.train_epoch(epoch) for epoch in (1, 2)]
    torch.cuda.synchronize()
    launches = dict(rc.LAUNCHES)
    for s in stats:
        log(f"epoch {s.epoch}: loss={s.loss:.6f} psnr_train={s.psnr_train:.3f} "
            f"psnr_test={s.psnr_test:.3f} {s.rays_per_sec:.0f} rays/s ({s.seconds:.3f} s)")
    log(f"main-path launches: {launches}")
    if not all(math.isfinite(s.loss) for s in stats):
        raise AssertionError("non-finite training loss")
    if not stats[1].loss < stats[0].loss:
        raise AssertionError(f"loss did not fall: {stats[0].loss} -> {stats[1].loss}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")

    trainer.ckpt.save(2, trainer.state)
    restored = trainer.ckpt.restore()
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

    a, b = tree_leaves(trainer.state.params), tree_leaves(restored.params)
    if trainer.ckpt.latest_step() != 2 or len(a) != len(b) or not all(
            torch.equal(x, y) for x, y in zip(a, b)) or restored.step != trainer.state.step:
        raise AssertionError("checkpoint restore does not match the saved state")
    log(f"checkpoint: saved and restored step {restored.step} ({len(a)} tensors equal)")

    # Step and eval-frame times (the epoch's seconds include its first step).
    t0 = time.perf_counter()
    trainer._eval_render_cache = None
    renders = trainer.render_eval_images(3)
    torch.cuda.synchronize()
    frame_s = (time.perf_counter() - t0) / len(renders)
    for name, (_, rgb) in renders.items():
        if rgb.shape != (ds.height, ds.width, 3) or not np.isfinite(rgb).all():
            raise AssertionError(f"bad eval render {name}: {rgb.shape}")
    timings["train"] = {
        "ms_per_step": 1e3 * stats[1].seconds / steps,
        "rays_per_sec": stats[1].rays_per_sec,
        "ms_per_eval_frame": 1e3 * frame_s,
        "loss": [s.loss for s in stats],
        "psnr_test": [s.psnr_test for s in stats],
    }
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: the smoke run needs a GPU", file=sys.stderr)
        return 1
    if not (ROOT / "nerf_and_dietnerf_tpu_torch" / "csrc").is_dir():
        print("nerf_and_dietnerf_tpu_torch/ not found beside chip_smoke.py", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc

    card = gpu_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    build = rc.build_kernels()
    log(f"build: {build['seconds']:.1f} s")
    for line in build["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            log("  " + line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    timings: dict = {}
    kernel_phases(torch, timings)
    launches = train_phase(torch, timings)

    t = timings["train"]
    log(f"[{card}] train step {t['ms_per_step']:.3f} ms ({t['rays_per_sec']:.0f} rays/s), "
        f"eval frame {t['ms_per_eval_frame']:.3f} ms")
    for dt in ("bfloat16", "float32"):
        for kname, r in timings[dt].items():
            log(f"[{card}] {kname} {dt} rows={r['rows']}: {r['ms']:.3f} ms, plain "
                f"{r['plain_ms']:.3f} ms, library_ms {r['library_ms']:.3f}, bound "
                f"{r['bound_ms']:.4f} ms")
    sources = {"mlp_fwd": ("nerf_and_dietnerf_tpu_torch/csrc/mlp_fwd.cu",
                           "nerf_and_dietnerf_tpu/ops/raymarch_pallas.py:236"),
               "mlp_bwd": ("nerf_and_dietnerf_tpu_torch/csrc/mlp_bwd.cu",
                           "nerf_and_dietnerf_tpu/ops/raymarch_pallas.py:412")}
    kernels = []
    for kname, (src, replaces) in sources.items():
        r = timings["bfloat16"][kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "rows": r["rows"], "dtype": "bfloat16",
            "ms_fine_pass": r["ms_fine_pass"],
            "f32": timings["float32"][kname],
        })
    print(json.dumps({"kernels": kernels, "train": timings["train"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
