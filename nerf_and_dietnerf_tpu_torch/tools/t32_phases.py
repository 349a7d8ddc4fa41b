#!/usr/bin/env python
"""Where the f32 tensor-core kernels spend their time, phase by phase: f32
B7's backward (``raymarch_comp_bwd``), f32 B2 (``mlp_bwd``), f32 B5
(``mlp_loss_comp``), f32 B4's backward (``mlp_comp_bwd``), f32 B6's
backward (``raymarch_bwd``) and f32 B7's and B4's forwards
(``raymarch_comp_fwd``, ``mlp_comp_fwd``), all on the 3xTF32 ``mma.sync``
tile of ``csrc/mlp_tf32_mma_tile.cuh``.

The tool builds its own copies of a kernel's library into
``build/t32_phases/`` with ``-DNERF_T32_PHASES`` (``csrc/t32_phases.cuh``):
thread 0 of every block adds the ``clock64()`` cycles of each phase into
shared memory and writes them out at the end with the block's
``%globaltimer`` span. The port's own libraries (``build/kernels/``) are not
these; the tool makes the wrappers launch its copies for the length of a
case (``kernel_lib.use_library``). A phase mark passes a barrier, so the
phases are the block's; the marks inside a product's k-loop do not, and
split it into the ring's wait (the chunk's copies and the barrier) and the
products. Beside the stamped build it builds cut variants (``CUTS``,
``-DNERF_T32_CUT``), each of which leaves one part of the work out (its
results are wrong) and is stamped too, so the time a part costs shows twice:
as its phase and as the time its cut saves.

Per kernel it prints the reckoning per 64-row tile from the shapes (the
products at the TF32 peak, the bytes of the slab, the weight ring and the
kept slots at a 132nd of the HBM rate), then per build one JSON line: the
CUDA-event time of one call (the wrapper's: packs, kernel, the slabs' sum),
the mean block span, ms per phase (each block's cycles over its own clock,
summed over the blocks and divided by the SMs they ran on: the mean block
for the backwards' persistent grids, an SM's share of the forwards' one
block a ray group), their sum and its ratio to the event time; and
the same for the port's unchanged library (event time only).

    python -m nerf_and_dietnerf_tpu_torch.tools.t32_phases [--kernels b7 b2 b5 b4 b6 b7f b4f] [--out PATH]
    python -m nerf_and_dietnerf_tpu_torch.tools.t32_phases --device cpu --hidden 32

On the CPU only the reckoning runs (a CPU has no phases to stamp).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from nerf_and_dietnerf_tpu_torch.models import mlp
from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
from nerf_and_dietnerf_tpu_torch.tools import seconds_per_call
from nerf_and_dietnerf_tpu_torch.tools.comp_kink import enc_batch, ray_batch
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device

F32 = torch.float32
SEED = 0
BM = 64  # rows of an f32 tensor-core tile (csrc/mlp_tf32_mma_tile.cuh)
# csrc/t32_phases.cuh's Phase, in order.
PHASES = ("inputs", "fwd_wait", "fwd_mma", "fwd_epi", "composite", "bwd_wait", "bwd_mma",
          "wgrad", "narrow", "grad", "slot", "dz", "other")
# Cut variants (csrc/t32_phases.cuh): label -> NERF_T32_CUT mask.
CUTS = {"stamped": 0, "cut_old": 1, "cut_lo": 2, "cut_ring": 4}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "t32_phases"
# H100 SXM (NVIDIA's data sheet): dense TF32 tensor-core peak, HBM rate; SMs.
PEAK_TF32, PEAK_BYTES, SMS = 495e12, 3.35e12, 132
# (library, the flagship shapes the kernel runs at: rays, samples)
KERNELS = {"b7": ("raymarch_comp_bwd", 4096, 64), "b2": ("mlp_bwd", 4096, 64),
           "b5": ("mlp_loss_comp", 4096, 128), "b4": ("mlp_comp_bwd", 4096, 64),
           "b6": ("raymarch_bwd", 4096, 64), "b7f": ("raymarch_comp_fwd", 4096, 64),
           "b4f": ("mlp_comp_fwd", 4096, 64)}
_EXTRA = {"nerf_t32_phase_buffer": ([ctypes.c_void_p], ctypes.c_int),
          "nerf_t32_phase_count": ([], ctypes.c_int)}


def _tile_products(cfg) -> dict:
    """``m16n8k8`` products one 64-row tile issues (each 3xTF32 product
    counts three), by kind: the forward (W^T from the F pack: 64 x pad16(N)
    outputs over pad16(K)), the chain back (W from the B pack: pad16(K)
    outputs over pad16(N)) and the weight gradients (A^T G: every 32 x 32
    warp tile of pad8(K) x pad8(N), 2 x 4 fragment tiles over 64 rows), for
    the 11 matrices of the tile."""
    fwd = bwd = wgrad = 0
    for k, n in rc.weight_shapes(cfg)[0][:rc.N_TF32_PRODUCTS]:
        kp, np_ = rc._pad16(k), rc._pad16(n)
        fwd += (BM // 16) * (np_ // 8) * (kp // 8) * 3
        bwd += (BM // 16) * (kp // 8) * (np_ // 8) * 3
        wgrad += -(-rc._pad8(k) // 32) * -(-rc._pad8(n) // 32) * 8 * (BM // 8) * 3
    return {"fwd": fwd, "bwd": bwd, "wgrad": wgrad}


def reckon(cfg: mlp.MLPConfig) -> dict:
    """What one 64-row tile must do at the widths of ``cfg``, and its time
    on one of the H100's 132 SMs: the products at the TF32 peak (2,048 FLOP
    each), and at a 132nd of the HBM rate the weight-gradient slab (read and
    written), the weight ring (the F pack once forward, the B pack once
    back) and the kept activations (stored, then read back)."""
    layout, pack = rc.t32_layout(cfg)
    w_shapes, b_shapes = rc.weight_shapes(cfg)
    n_params = sum(k * n for k, n in w_shapes) + sum(b_shapes)
    products = _tile_products(cfg)
    hid, last = rc._pad16(cfg.hidden_dim), rc._pad16(cfg.last_hidden_dim)
    slots = BM * 4 * (8 * hid + last + (0 if cfg.uses_view_dirs else hid))
    nbytes = {"slab": 2 * 4 * n_params, "ring": 2 * 4 * pack, "slots": 2 * slots}
    per_sm_flops, per_sm_bytes = PEAK_TF32 / SMS, PEAK_BYTES / SMS
    ms = {f"products_{k}": v * 2048 / per_sm_flops * 1e3 for k, v in products.items()}
    ms.update({k: v / per_sm_bytes * 1e3 for k, v in nbytes.items()})
    return {"products": products, "bytes": nbytes, "ms_per_tile_on_one_sm": ms,
            "barriers": sum(kp // 16 + np_ // 16 for _, kp, np_ in layout)}


def _case(kernel: str, device, rays: int, samples: int, hidden):
    """``(config, call)``: the kernel's flagship case (view dirs, seed 0),
    ``call()`` running its f32 wrapper once."""
    widths = {} if hidden is None else {"hidden_dim": hidden, "last_hidden_dim": hidden // 2}
    cfg = mlp.MLPConfig(**widths)
    params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=device)
    ws, bs = rc.flatten_params(params, cfg, F32)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rd, z = ray_batch(cfg, rays, samples, gen, device)
    if kernel == "b6":
        g = (0.5 + torch.rand((rays, samples, 4), generator=gen, device=device)).contiguous()
        return cfg, lambda: rk.raymarch_bwd(ws, bs, cfg, rd, z, g, F32)

    def cotangents():  # of the pixels and the weights
        return ((0.5 + torch.rand((rays, 3), generator=gen, device=device)).contiguous(),
                (0.5 + torch.rand((rays, samples), generator=gen, device=device)).contiguous())

    if kernel == "b7":
        g_rgb, g_w = cotangents()
        return cfg, lambda: rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, g_rgb, g_w, F32)
    if kernel == "b7f":
        return cfg, lambda: rk.raymarch_comp_fwd(ws, bs, cfg, rd, z, F32)
    enc, encd, z, dvec, target = enc_batch(cfg, F32, rd, z, gen)
    if kernel == "b4f":
        return cfg, lambda: rk.mlp_comp_fwd(ws, bs, cfg, enc, encd, z, F32)
    if kernel == "b5":
        return cfg, lambda: rk.mlp_loss_comp(ws, bs, cfg, enc, encd, z, dvec, target, F32)
    if kernel == "b4":
        g_rgb, g_w = cotangents()
        return cfg, lambda: rk.mlp_comp_bwd(ws, bs, cfg, enc, encd, z, g_rgb, g_w, F32)
    n = rays * samples
    d = encd.repeat_interleave(samples, 0).contiguous()
    g = (0.5 + torch.rand((n, 4), generator=gen, device=device)).contiguous()
    return cfg, lambda: rc.mlp_bwd(ws, bs, cfg, enc, d, g, F32)


def stamped(lib, call, device, reps: int, rays: int) -> dict:
    """The event time of ``call`` on ``lib``, then one call's phases; the
    call launches at most one block a ray or ``SMS`` blocks."""
    ms = seconds_per_call(call, device, reps) * 1e3
    n = lib.nerf_t32_phase_count()
    buf = torch.zeros((max(rays, SMS), n + 1), dtype=torch.int64, device=device)
    if lib.nerf_t32_phase_buffer(buf.data_ptr()) != 0:
        raise RuntimeError("could not set the phase buffer")
    call()
    torch.cuda.synchronize(device)
    lib.nerf_t32_phase_buffer(None)
    st = buf.cpu().double()
    st = st[st[:, n] > 0]  # the blocks that ran
    cycles, span_ns = st[:, :n], st[:, n]
    per_ms = cycles.sum(1) / (span_ns / 1e6)  # each block's clock, cycles per ms
    phase_ms = (cycles / per_ms[:, None]).sum(0) / min(len(st), SMS)
    total = float(phase_ms.sum())
    return {"event_ms": ms, "block_span_ms": float(span_ns.mean() / 1e6), "blocks": len(st),
            "clock_ghz": float(per_ms.mean() / 1e6),
            "phase_ms": {p: float(v) for p, v in zip(PHASES, phase_ms)},
            "phases_sum_ms": total, "sum_over_event": total / ms}


def _ptxas(log: str) -> list:
    """The ``-Xptxas -v`` lines of the f32 tensor-core kernels in ``log``."""
    lines, keep = [], 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = 4 if "t32" in ln else 0
        if keep:
            lines.append(ln.strip())
            keep -= 1
    return lines


def sass_counts(path: Path, out_dir) -> dict:
    """Per f32 tensor-core kernel of the library at ``path``: its HMMA, LDL,
    STL and BAR instructions in the SASS (``cuobjdump``), the whole SASS
    written under ``out_dir`` where given."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"cuobjdump": "not installed"}
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True).stdout
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{path.stem}.sass").write_text(sass)
    counts, dsts, cur = {}, {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :")[1].strip() if "t32" in ln else None
            if cur:
                counts[cur] = {k: 0 for k in ("HMMA", "LDL", "STL", "BAR")}
                dsts[cur] = set()
        elif cur:
            for k in ("HMMA", "LDL", "STL", "BAR"):
                if f" {k}" in ln:
                    counts[cur][k] += 1
            if " HMMA" in ln:  # its destination: the partial a product sums into
                dsts[cur].add(ln.split(" HMMA")[1].split()[1].rstrip(","))
    for k in counts:  # how many partials the products can keep in flight
        counts[k]["HMMA_destinations"] = len(dsts[k])
    return counts


def ncu_report(kernels) -> str:
    """Nsight Compute's warp-stall section of the first kernel's unchanged
    build, where ``ncu`` is installed and works; else what stopped it."""
    tool = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    if not Path(tool).exists():
        return "ncu: not installed"
    cmd = [tool, "--section", "WarpStateStats", "--launch-count", "1", "-k", "regex:t32",
           sys.executable, "-m", "nerf_and_dietnerf_tpu_torch.tools.t32_phases", "--kernels",
           kernels[0], "--cuts", "--reps", "1",
           "--no-ncu"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except subprocess.TimeoutExpired:
        return "ncu: timed out after 240 s"
    return f"ncu: exit {r.returncode}\n" + (r.stdout + r.stderr)[-4000:]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu (the reckoning only)")
    p.add_argument("--kernels", nargs="+", default=["b7"], choices=sorted(KERNELS))
    p.add_argument("--cuts", nargs="*", default=list(CUTS), choices=list(CUTS),
                   help="builds to stamp (default all; none for the port's build alone)")
    p.add_argument("--reps", type=int, default=3, help="timed calls per build")
    p.add_argument("--hidden", type=int, default=None, help="trunk width (default the model's)")
    p.add_argument("--no-ncu", action="store_true", help="skip the Nsight Compute attempt")
    p.add_argument("--sass-dir", type=Path, default=None,
                   help="write the port library's SASS here")
    p.add_argument("--out", type=Path, default=None, help="also write the lines to this file")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    lines = []

    def emit(rec):
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    widths = {} if args.hidden is None else {"hidden_dim": args.hidden,
                                             "last_hidden_dim": args.hidden // 2}
    emit({"reckoning_per_tile": reckon(mlp.MLPConfig(**widths))})
    if device.type != "cuda":
        emit({"measured": "not measured: no card (the phases are stamped on the GPU)"})
    else:
        gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        emit({"card": gpu.stdout.strip()})
        for kernel in args.kernels:
            name, rays, samples = KERNELS[kernel]
            builds = kl.build_variants(
                name, {c: ["-DNERF_T32_PHASES", f"-DNERF_T32_CUT={CUTS[c]}"] for c in args.cuts},
                BUILD_DIR, _EXTRA) if args.cuts else {"libs": {}, "log": {}, "seconds": 0.0}
            cfg, call = _case(kernel, device, rays, samples, args.hidden)
            rec = {"kernel": kernel, "library": name, "rays": rays, "samples": samples,
                   "build_s": builds["seconds"],
                   "ptxas": {c: _ptxas(log) for c, log in builds["log"].items()},
                   "port_event_ms": seconds_per_call(call, device, args.reps) * 1e3,
                   "port_sass": sass_counts(kl.lib_path(name), args.sass_dir)}
            for c, lib in builds["libs"].items():
                kl.use_library(name, lib)
                try:
                    rec[c] = stamped(lib, call, device, args.reps, rays)
                finally:
                    kl.use_library(name, None)
            emit(rec)
        if not args.no_ncu:
            emit({"ncu": ncu_report(args.kernels)})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
