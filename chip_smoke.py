#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel of the port from ``nerf_and_dietnerf_tpu_torch/csrc``
with ``nvcc`` into ``build/kernels/`` (one process per source, in parallel):
the radiance-MLP kernels B1 ``mlp_fwd`` and B2 ``mlp_bwd``, the fused
ray-march kernels B6 ``raymarch_fwd`` / ``raymarch_bwd`` and B7
``raymarch_comp_fwd`` / ``raymarch_comp_bwd``, and the MLP + compositing
kernels B4 ``mlp_comp_fwd`` / ``mlp_comp_bwd`` and B5 ``mlp_loss_comp``. Holds
each against its plain PyTorch version at the flagship widths in bf16 and f32
(both MLP variants; the ray kernels at 64 samples per ray, in bf16 also at the
fine pass's 128, in f32 also at a ragged 100, the ray-march forwards at the
eval render's 192, B6 also at 4093 rays, a part-filled last 128-row tile, its
f32 forward also at widths beyond its tensor-core design's; B5 at 128 and at
the ragged 100), checks that the backwards' parameter gradients
(and B4's per-ray view-dir gradient and B5's loss) are bitwise reproducible
(B1/B2, whose products run on the tensor cores, also at a ragged row count in
both types, f32 B2 right after NaN was left in every SM's shared memory, and
at narrow widths; the ``-Xptxas -v`` lines of B1, B2 and B6 and, where ``cuobjdump``
is installed, the tensor-core instructions of their SASS are printed, and the
run fails if bf16 B1/B2/B6 have no HMMA or f32 B1/B6 forward no HGMMA), holds
B1 in both types, its former FMA design (P3 at one chain) and the plain
version against the forward chain evaluated in f64 (f32 B1 fails if it is more
than ``F64_FACTOR`` times as far as the plain version), B6 and its plain
version likewise (raw output, dz and dparams; JSON ``b6_vs_f64_chain``), B7
(pixels, dz, dparams; ``b7_vs_f64_chain``; in f32 also step by step,
``b7_f32_steps``, ``tools/comp_f32_steps.py``), B5 (loss, dz, dparams;
``b5_vs_f64_chain``) and B4 (pixels, weights, denc, dencd, dz, dparams;
``b4_vs_f64_chain``) at S = 64 and 128, and B2 in both types
(dx / dd; ``b2_vs_f64_chain``), holds the
bf16 B7 forward and backward, B5 and B4 (forward and backward, on the
tensor cores) also at S = 100, at 4093 rays and on opaque rays, and the f32
backwards of B7 and B4 and f32 B5 (3xTF32 on the tensor cores) at S = 64, 100
and 128 and on opaque rays, each against its plain version with f64 sums on the kernel's
side of the compositing's kink (``KINK_SHARE``), checks that bf16 B4's and
B7's backwards composite bitwise the raw values their forwards composited,
prints the registers, spills and HMMA counts of the five bf16 backwards (B2,
B6, B7, B5, B4), of B4's and B7's forwards and of the f32 backwards on the
3xTF32 tile (B2, B7, B5, B6, B4), times f32 B1 beside that FMA design and f32
B2, B5 and the backwards of B6 and B4 at both passes' shapes beside their
plain versions and library calls (f32 B6's backward is also held at 4093 rays
of 100 samples, a part-filled last 64-row tile), then drives seven training
paths at flagship width (4096 rays, 64 + 128
samples, 256/128 wide, bf16 step unless said, f32 eval renders) on a
synthetic scene made from a seed, each for two epochs with the launch counts
set to 0 just before it: backend "pallas" through the
``Trainer`` (B1, B2; with a state save and restore; its f32 eval renders
must launch B1, and a 32x32 patch of the held-out view rendered in f32 on
the card and on the CPU from the trained weights must agree to 1e-4),
backend "pallas_rm" through the ``Trainer`` (B6, eval renders included), and
through
``train_step.make_epoch_fn`` "pallas_rm" with ``fuse_compositing`` (B7),
"pallas" with ``fuse_compositing`` (B4 on both passes) and "pallas" with
``fuse_compositing`` and ``fuse_fine_loss`` (B4 on the coarse pass, B5 on the
fine pass), and "pallas" and "pallas_rm" with compute_dtype float32 through
the ``Trainer`` (f32 B1 and B2; f32 B6 in the step).
Then the seven probe kernels (P1 ``probe_mma``, P2
``probe_mlp_epilogue``, P3 ``probe_mlp_chains``, P4-P6 ``probe_expand_a/b/c``,
P7 ``probe_enccost``) are held against their plain versions at the probe
tools' own shapes, the five tools of ``nerf_and_dietnerf_tpu_torch/tools`` run
through their ``main([])`` (launch counts set to 0 before each), and four
"pallas_rm" steps, then four "pallas" steps run under
``utils.profiling.trace``: the device's idle share,
the ten device operations with the most time, and the torch operations of the
step that have no deterministic implementation; one step run twice from the
same state must give bitwise-equal parameters, with no kernel that adds with
atomics. Prints timings beside the
card's name and power limit. Any failed phase raises and the script exits
non-zero; without a GPU, or without the package beside it, it exits non-zero
before printing a result.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it holds the per-kernel JSON record, and the one before that
the card's name and power limit.
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
N_ROWS_RAGGED = N_ROWS - 37  # a part-filled last tile
N_ROWS_NARROW = 4096 - 5  # f32 B1 at narrow widths
# The product loops of B1 (and bf16 B2) by compute type
# (csrc/mlp_mma_tile.cuh, csrc/mlp_tf32_tile.cuh).
MLP_DESIGN = {"bfloat16": "tensor cores, mma.sync bf16, 128-row tiles",
              "float32": "tensor cores, 3xTF32 wgmma, 128-row tiles in persistent blocks, "
                         "a producer warp streaming hi / lo weight packs by bulk copies"}
# f32 B2 and f32 B6's backward run the 3xTF32 mma.sync tile of
# csrc/mlp_tf32_mma_tile.cuh as the f32 compositing backwards do: the forward
# keeping the slots, then the walk.
F32_BWD_DESIGN = ("tensor cores, 3xTF32 mma.sync m16n8k8, 64-row tiles in persistent blocks, "
                  "forward keeping the slots then the walk")
# bf16 B7 backward, B5 and B4 backward: the ray-group loop of
# csrc/comp_mma_tile.cuh on the tensor-core tiles, one forward per row; their
# f32 instances the same loop on the 3xTF32 mma.sync tiles of
# csrc/mlp_tf32_mma_tile.cuh.
COMP_MMA_DESIGN = (MLP_DESIGN["bfloat16"] + ", whole rays in a tile, one forward per row, "
                   "compositing VJP in the block, dx through a per-block slab")
T32_COMP_DESIGN = ("tensor cores, 3xTF32 mma.sync m16n8k8, 64-row tiles, whole rays in a group, "
                   "one forward per row, compositing VJP in the block, dx through a per-block "
                   "slab")
# B6 runs B1/B2's tensor-core tiles on the encodings it builds, in both
# types. B7's and B4's forwards run the forward loop of comp_mma_tile.cuh (B7
# on the encodings it builds), bf16 on the bf16 tiles, f32 on the 3xTF32
# mma.sync tiles of csrc/mlp_tf32_mma_tile.cuh, one block a ray group.
T32_FWD_DESIGN = ("tensor cores, 3xTF32 mma.sync m16n8k8, 64-row tiles, whole rays in a group, "
                  "one block a group, compositing in the block")
RM_DESIGN = {("raymarch_fwd", "bfloat16"): MLP_DESIGN["bfloat16"] + ", encodings built into "
                                                                    "the bf16 operand tiles",
             ("raymarch_fwd", "float32"): MLP_DESIGN["float32"] + " (two stages), encodings "
                                                                  "built into 64 input columns "
                                                                  "of the tile's rows",
             ("raymarch_bwd", "bfloat16"): MLP_DESIGN["bfloat16"] + ", encodings built into "
                                                                    "the bf16 operand tiles, dx "
                                                                    "through a per-block slab",
             ("raymarch_bwd", "float32"): F32_BWD_DESIGN + ", encodings built into the f32 "
                                                          "operand tiles, dx through a per-block "
                                                          "slab",
             ("raymarch_comp_bwd", "bfloat16"): COMP_MMA_DESIGN,
             ("raymarch_comp_bwd", "float32"): T32_COMP_DESIGN,
             ("raymarch_comp_fwd", "bfloat16"): MLP_DESIGN["bfloat16"] + ", whole rays in a "
                                                                       "tile, encodings built "
                                                                       "into the bf16 operand "
                                                                       "tiles, compositing in "
                                                                       "the block",
             ("mlp_loss_comp", "bfloat16"): COMP_MMA_DESIGN,
             ("mlp_loss_comp", "float32"): T32_COMP_DESIGN,
             ("mlp_comp_bwd", "bfloat16"): MLP_DESIGN["bfloat16"] + ", whole rays in a tile, one "
                                                                  "forward per row, compositing "
                                                                  "VJP in the block, dx rows to "
                                                                  "denc, dd rows through a "
                                                                  "per-block slab",
             ("mlp_comp_bwd", "float32"): T32_COMP_DESIGN.replace(
                 "dx through a per-block slab", "dx rows to denc, dd rows through a per-block "
                                                "slab"),
             ("mlp_comp_fwd", "bfloat16"): MLP_DESIGN["bfloat16"] + ", whole rays in a tile, "
                                                                  "compositing in the block",
             ("raymarch_comp_fwd", "float32"): T32_FWD_DESIGN + ", encodings built into the f32 "
                                                                "operand tiles",
             ("mlp_comp_fwd", "float32"): T32_FWD_DESIGN}
# B1's former f32 design, timed beside it: P3 with one chain is that FMA tile.
FMA_DESIGN = "f32 FMA tile, one 64-row chain (P3, chains=1)"
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
# Ray-march kernels (B6, B7) against their plain versions. The forwards add
# the encodings, built in the kernel with the same f32 operations and the
# same library sin as the plain version; a 1-ulp difference of a sin can flip
# a bf16 rounding of a feature, so the forward tolerances are TOL's. B7's
# pixels and weights pass the raw values through exp and a running product
# of up to 192 factors, which moves a raw value's rounding by a factor of
# order one: held to TOL as well, scaled by max |plain|. Backwards: dparams
# as B2's (TOL_BWD, positive cotangents); dz sums the dx of a row times
# cos(theta) f_k (f_k up to 16 pi at L = 5), so a leaky-branch flip in one
# row moves that row's dz whole: held normwise to TOL_ROWS, like dx / dd.
# Sample counts the ray-march kernels are held at: the coarse pass (64), the
# fine pass (128, all four kernels), the eval render's merged count (192, f32:
# a ray over three 64-row tiles of the f32 kit; the forwards, and B7's
# backward with cotangents of their own) and a count that is not a multiple
# of the f32 kit's 64-row tile (100, f32, all four kernels: one full tile a
# ray and one part-filled).
RAYS, SAMPLES, SAMPLES_EVAL, SAMPLES_RAGGED = 4096, 64, 192, 100
# B6 is also held at a ray count whose R S rows leave a part-filled last
# 128-row tile of its tensor-core kernels (4093 x 64 = 2046.5 tiles), in both
# types, the backward in bf16; its f32 backward (64-row tiles, which 4093 x
# 64 rows fill) at 4093 x 100 = 6395.3 tiles.
RAYS_RAGGED = RAYS - 3
# MLP + compositing kernels (B4, B5) against their plain versions, on torch-made
# encodings of the same ray batches: pixels, weights and B5's loss to TOL (the
# loss relative to itself); dparams to TOL_BWD; the per-row gradients denc and
# dz and the per-ray dencd (a sum of S rows' dd) normwise to TOL_ROWS, for the
# reasons above. B5 makes its cotangent itself, 2 (pixel - target) / (3 R): the
# targets are drawn below every pixel, -U(0.5, 1.5), so that cotangent is
# positive like the others' and the weight gradients do not cancel.
DEVICE = "cuda"  # every tensor of the run; main() refuses to start without a GPU
# H100 SXM peaks: dense bf16 tensor-core and non-tensor f32 rates, HBM rate.
# "float32_mma": an f32 matrix product at true f32 accuracy on the tensor
# cores, three TF32 products (3xTF32) at the 495 TFLOP/s TF32 rate; the bound
# of every MLP kernel's f32 row (B1, B2, B4-B7), which such products can
# compute. Non-matrix f32 work (P6, P7) keeps the 67 TFLOP/s FMA rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "float32_mma": 495e12 / 3}
# f32 B1 against the f64 forward chain: normwise at most this many times the
# plain f32 version's distance.
F64_FACTOR = 4.0
# The compositing kernels on the bf16 tensor cores (B7's backward, B5, B4's
# forward and backward) sum in an order of their own; the plain version's f32
# sums are one more such order. Two things then part them from it that do not
# part the kernels from the function: a sample whose raw sigma lies within the
# forward's rounding noise of 0 falls on the other side of the compositing's
# kink (max(sigma, 0); the sigma cotangent is 0 below it) and moves its row's
# dz and share of every weight gradient whole; and where few rows carry the
# gradients (opaque rays: 256 first samples) the f32 version's own sums sit
# up to 3e-2 from the exact ones in dparams' worst leaf. Each check of these
# kernels therefore holds the kernel against its plain version with the
# MLP's products and sums in f64 (the same roundings to bf16, nearly exact
# sums) and each sample on the kernel's side of the kink (the raw values the
# kernel composited, ``raw=``; ``research_kernels_cuda.kink_of``): dparams
# to TOL_BWD (the worst leaf), dz and B4's denc and dencd normwise to
# TOL_ROWS, B5's loss, B4's pixels and weights to TOL, the raw values to TOL
# against the plain forward's, and at most KINK_SHARE of the samples on the
# other side of the kink from the f64 evaluation's.
# ``tools/comp_kink.py`` computes the records; the distances to the plain f32
# version are printed beside.
KINK_SHARE = 1e-3
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

def _mlp_peak(name: str) -> float:
    """The peak that bounds an MLP kernel's matrix products in ``name``."""
    return PEAK_FLOPS["float32_mma" if name == "float32" else name]


def _inputs(torch, cfg, cd, n, gen):
    from nerf_and_dietnerf_tpu_torch.core import encoding

    pts = torch.rand((n, 3), generator=gen, device=DEVICE) * 2 - 1
    x = encoding.encode_xyz(pts, cfg.n_freq_xyz).to(cd).contiguous()
    d = None
    if cfg.uses_view_dirs:
        dirs = torch.randn((n, cfg.n_angles + 1), generator=gen, device=DEVICE)
        d = encoding.encode_view_dirs(dirs, cfg.n_freq_dir).to(cd).contiguous()
    g = (0.5 + torch.rand((n, 4), generator=gen, device=DEVICE)).contiguous()
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


def _vs_f64_chain(torch, rc, ws, bs, cfg, x, d, g, cd, rows, tol_r) -> dict:
    """Where B2's per-row gradients part from the plain version's: both against
    the plain chain with the same roundings but f64 products and sums. Each of
    ``rows`` (name, kernel, plain) gets (scaled max, normwise, share of rows
    over ``tol_r``) for kernel and plain against that chain. The leaky-branch
    flips of the plain f32 forward against the f64 one: the share of rows
    with one or more, and that share among the rows where the plain version's
    gradient is over ``tol_r`` against the f64 chain."""
    exact = rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, cd, work=torch.float64)[2:]
    out = {k: {"kernel": _row_errs(a, e, tol_r), "plain": _row_errs(p, e, tol_r)}
           for (k, a, p), e in zip(rows, exact)}
    dx_p, dx_e = rows[0][2], exact[0]
    over = (dx_p.double() - dx_e).abs().max(dim=1).values / dx_e.abs().max() > tol_r
    del exact, dx_e
    _, a32 = rc._forward_plain(ws, bs, cfg, x, d, cd)
    _, a64 = rc._forward_plain(ws, bs, cfg, x, d, cd, torch.float64)
    flip = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for p32, p64 in zip(a32, a64):
        flip |= ((p32 >= 0) != (p64 >= 0)).any(dim=1)
    del a32, a64
    out["rows_with_a_branch_flip"] = float(flip.float().mean())
    out["dx_rows_over_tol_with_a_branch_flip"] = (
        float((flip & over).float().sum() / over.float().sum()) if bool(over.any()) else None)
    return out


def _poison_shared_memory(torch, rc, cfg, n_sms):
    """A call that leaves NaN in every SM's shared memory where f32 B2's X
    and D tiles lie: f32 B1 with NaN weights, one 128-row tile a block on
    every SM, whose weight ring (its first 98,304 bytes) covers those bytes;
    made the last operation before f32 B2's kernel (``mlp_bwd``'s
    ``before_launch``), and both take the largest shared-memory carve-out.
    f32 B2 zeroes its X and D pads (columns up to pad16, ``load_rows``) so
    that whatever they held reaches no sum; after this a pad left as it was
    turns its outputs NaN."""
    from nerf_and_dietnerf_tpu_torch.models import mlp
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl

    params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
    ws, bs = rc.flatten_params(params, cfg, torch.float32)
    ws = [torch.full_like(w, float("nan")) for w in ws]
    n = 128 * n_sms
    x = torch.zeros((n, cfg.xyz_dim), device=DEVICE)
    d = torch.zeros((n, cfg.dir_dim), device=DEVICE) if cfg.uses_view_dirs else None

    def poison():
        before = dict(kl.LAUNCHES)
        rc.mlp_fwd(ws, bs, cfg, x, d, torch.float32)
        kl.LAUNCHES.update(before)
    return poison


def _poison_comp_fwd(torch, rk, rc, n_sms):
    """A call that leaves NaN in every SM's shared memory where f32 B4's
    forward keeps its D tile: that kernel itself, so its launch finds the
    same layout and carve-out, on NaN view-dir encodings 30 wide (Ld = 5),
    one ray group on every SM; made the last operation before f32 B4's
    forward (``mlp_comp_fwd``'s ``before_launch``). The forward zeroes its D
    tile's pad columns (to pad16 of the flagship's 24, load_comp_t32_inputs);
    after this a pad left as it was turns its outputs NaN. (f32 B1's poison
    of :func:`_poison_shared_memory` did not reach this kernel's D tile.)"""
    from nerf_and_dietnerf_tpu_torch.models import mlp
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl

    cfg = mlp.MLPConfig(n_freq_dir=5)
    params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
    ws, bs = rc.flatten_params(params, cfg, torch.float32)
    enc = torch.zeros((n_sms * SAMPLES, cfg.xyz_dim), device=DEVICE)
    encd = torch.full((n_sms, cfg.dir_dim), float("nan"), device=DEVICE)
    z = torch.linspace(2.0, 6.0, SAMPLES, device=DEVICE).expand(n_sms, SAMPLES).contiguous()

    def poison():
        before = dict(kl.LAUNCHES)
        rk.mlp_comp_fwd(ws, bs, cfg, enc, encd, z, torch.float32)
        kl.LAUNCHES.update(before)
    return poison


def _mlp_checks(torch, rc, ws, bs, cfg, x, d, g, cd, name, label):
    """B1 and B2 against their plain versions on (x, d, g), B2's dparams
    bitwise across two runs, f32 B2 right after NaN was left in every SM's
    shared memory (:func:`_poison_shared_memory`); returns the max |kernel -
    plain| of each and both types against the f64 chain
    (:func:`_vs_f64_chain`)."""
    tol, tol_b, tol_r = TOL[name], TOL_BWD[name], TOL_ROWS[name]
    out_k = rc.mlp_fwd(ws, bs, cfg, x, d, cd)
    torch.cuda.synchronize()
    out_p = rc.mlp_fwd_plain(ws, bs, cfg, x, d, cd)
    e_fwd = _scaled_err(out_k, out_p)
    abs_fwd = float((out_k - out_p).abs().max())
    if not (torch.isfinite(out_k).all() and e_fwd <= tol):
        raise AssertionError(f"mlp_fwd {label}: scaled err {e_fwd} > {tol}")
    del out_k, out_p

    poison = (_poison_shared_memory(
        torch, rc, cfg, torch.cuda.get_device_properties(x.device).multi_processor_count)
        if cd == torch.float32 else None)
    dws, dbs, dx, dd = rc.mlp_bwd(ws, bs, cfg, x, d, g, cd, before_launch=poison)
    torch.cuda.synchronize()
    pws, pbs, pdx, pdd = rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, cd)
    e_par = max(_scaled_err(a, b) for a, b in zip(dws + dbs, pws + pbs))
    rows = [("dx", dx, pdx)] + ([("dd", dd, pdd)] if d is not None else [])
    row_stats = {k: _row_errs(a, b, tol_r) for k, a, b in rows}
    pairs = list(zip(dws + dbs, pws + pbs)) + [(a, b) for _, a, b in rows]
    abs_bwd = max(float((a - b).abs().max()) for a, b in pairs)
    finite = all(bool(torch.isfinite(t).all()) for t in dws + dbs + [a for _, a, _ in rows])
    if not finite or e_par > tol_b or any(norm > tol_r for _, norm, _ in row_stats.values()):
        raise AssertionError(f"mlp_bwd {label}: dparams scaled err {e_par} (tol {tol_b}); "
                             f"per-row {row_stats} (tol {tol_r})")
    del pws, pbs, pdx, pdd, pairs
    exact = _vs_f64_chain(torch, rc, ws, bs, cfg, x, d, g, cd, rows, tol_r)
    log(f"kernel check {label}: dx/dd against the f64 chain (scaled max, normwise, share "
        f"of rows over tol), kernel and plain; leaky-branch flips plain f32 vs f64: {exact}")
    del rows
    dws2, dbs2, _, _ = rc.mlp_bwd(ws, bs, cfg, x, d, g, cd)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2)):
        raise AssertionError(f"mlp_bwd {label}: dparams differ between runs")
    log(f"kernel check {label}: fwd scaled err {e_fwd:.3e} (tol {tol}), bwd dparams scaled "
        f"err {e_par:.3e} (tol {tol_b}); dx/dd (scaled max, normwise, share of rows over "
        f"tol): {row_stats} (tol {tol_r}); dparams bitwise equal across two runs")
    return abs_fwd, abs_bwd, exact


def kernel_phases(torch, timings: dict) -> None:
    from nerf_and_dietnerf_tpu_torch.models import mlp
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.ops import probe_kernels_cuda as pk
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
    from nerf_and_dietnerf_tpu_torch.tools import mlp_flops

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for variant, n_angles in (("view_dirs", 2), ("xyz_only", 0)):
        cfg = mlp.MLPConfig(n_angles=n_angles)
        params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
        for cd in (torch.bfloat16, torch.float32):
            name = str(cd).split(".")[-1]
            ws, bs = rc.flatten_params(params, cfg, cd)
            # Both types (the tensor-core tiles) also at a ragged row count: a
            # part-filled last 128-row tile, whose rows past n add to no sum.
            xr, dr, gr = _inputs(torch, cfg, cd, N_ROWS_RAGGED, gen)
            ragged = _mlp_checks(torch, rc, ws, bs, cfg, xr, dr, gr, cd, name,
                                 f"{variant} {name} rows={N_ROWS_RAGGED}")
            del xr, dr, gr
            x, d, g = _inputs(torch, cfg, cd, N_ROWS, gen)
            abs_fwd, abs_bwd, exact = _mlp_checks(torch, rc, ws, bs, cfg, x, d, g, cd, name,
                                                  f"{variant} {name} rows={N_ROWS}")
            timings.setdefault("b2_vs_f64_chain", {})[
                variant if cd == torch.bfloat16 else f"{variant} {name}"] = exact
            if variant != "view_dirs":
                continue
            # Times at the main path's shapes: bf16 is the train step's coarse
            # pass, f32 the eval render's.
            flops = mlp_flops(cfg, N_ROWS)
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
                before = dict(kl.LAUNCHES)
                ms = _time_ms(torch, fn)
                kl.LAUNCHES.update(before)  # timing launches are not the main path's
                bound = _bound(fl, _mlp_peak(name), nbytes)
                rec[kname] = {
                    "rows": N_ROWS, "dtype": name,
                    "design": (F32_BWD_DESIGN if (kname, name) == ("mlp_bwd", "float32")
                               else MLP_DESIGN[name]),
                    "ms": ms,
                    "tflops": fl / ms / 1e9,
                    "share_of_bound": bound[0] / ms,
                    "plain_ms": _time_ms(torch, plain, reps=2),
                    "library_ms": _time_ms(torch, lib),
                    "library": "torch.addmm chain in the compute type"
                               + (" (autograd forward + backward)" if kname == "mlp_bwd" else ""),
                    "bound_ms": bound[0],
                    "bound_by": bound[1],
                    "bound_bytes": nbytes,
                    "max_abs_err": abs_fwd if kname == "mlp_fwd" else abs_bwd,
                }
                rec[kname]["max_abs_err_ragged"] = ragged[0 if kname == "mlp_fwd" else 1]
            if cd == torch.float32:
                # B1's former f32 design (the FMA tile) on the same inputs.
                before = dict(kl.LAUNCHES)
                rec["mlp_fwd"].update(
                    fma_design_ms=_time_ms(torch, lambda: pk.mlp_fwd_chains(ws, bs, cfg, x, d, 1)),
                    fma_design=FMA_DESIGN)
                kl.LAUNCHES.update(before)
                log(f"time mlp_fwd float32 rows={N_ROWS}: FMA design "
                    f"{rec['mlp_fwd']['fma_design_ms']:.3f} ms ({FMA_DESIGN})")
            # The fine pass of a train step runs both kernels on twice the
            # rows; f32 B2 (a float32 config's step) also beside its plain
            # version and its library call there.
            x2, d2, g2 = (torch.cat([t, t]) for t in (x, d, g))
            before = dict(kl.LAUNCHES)
            for kname, fn, fl in (
                    ("mlp_fwd", lambda: rc.mlp_fwd(ws, bs, cfg, x2, d2, cd), 2 * flops),
                    ("mlp_bwd", lambda: rc.mlp_bwd(ws, bs, cfg, x2, d2, g2, cd), 6 * flops)):
                ms = _time_ms(torch, fn, reps=3)
                rec[kname].update(ms_fine_pass=ms, tflops_fine_pass=fl / ms / 1e9)
            if cd == torch.float32:
                bound2 = _bound(6 * flops, _mlp_peak(name), rec["mlp_bwd"]["bound_bytes"]
                                + N_ROWS * (16 + (cfg.xyz_dim + cfg.dir_dim) * (es + 4)))

                def lib_bwd2():
                    out = _library_mlp(torch, leaves, bs, cfg, x2, d2)
                    torch.autograd.grad(out, leaves, g2.to(out.dtype))
                rec["mlp_bwd"].update(
                    share_of_bound_fine_pass=bound2[0] / rec["mlp_bwd"]["ms_fine_pass"],
                    plain_ms_fine_pass=_time_ms(
                        torch, lambda: rc.mlp_bwd_plain(ws, bs, cfg, x2, d2, g2, cd), reps=2),
                    library_ms_fine_pass=_time_ms(torch, lib_bwd2, reps=3))
            kl.LAUNCHES.update(before)
            del x2, d2, g2
            log(f"time fine pass ({2 * N_ROWS} rows, {name}): mlp_fwd "
                f"{rec['mlp_fwd']['ms_fine_pass']:.3f} ms, mlp_bwd "
                f"{rec['mlp_bwd']['ms_fine_pass']:.3f} ms ("
                f"{rec['mlp_bwd']['tflops_fine_pass']:.1f} TFLOP/s)"
                + (f", {100 * rec['mlp_bwd']['share_of_bound_fine_pass']:.2f} % of the bound, "
                   f"plain {rec['mlp_bwd']['plain_ms_fine_pass']:.3f} ms, library "
                   f"{rec['mlp_bwd']['library_ms_fine_pass']:.3f} ms"
                   if cd == torch.float32 else ""))
            timings[name] = rec
            for kname, r in rec.items():
                log(f"time {kname} {name} rows={N_ROWS} ({r['design']}): kernel {r['ms']:.3f} ms "
                    f"({r['tflops']:.1f} TFLOP/s, {100 * r['share_of_bound']:.2f} % of the bound), "
                    f"plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})")

    # f32 B1 and B2 at narrow widths (a 40-wide trunk, a 24-wide rgb layer):
    # B1's 64-column products and 8-column last chunks, B2's products with 5
    # or 3 n-tiles (one or two a warp) and part-filled weight-gradient tiles,
    # which the flagship widths do not reach, on a ragged row count.
    before = dict(kl.LAUNCHES)
    for variant, n_angles in (("view_dirs", 2), ("xyz_only", 0)):
        cfg = mlp.MLPConfig(hidden_dim=40, last_hidden_dim=24, n_angles=n_angles)
        params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
        ws, bs = rc.flatten_params(params, cfg, torch.float32)
        x, d, g = _inputs(torch, cfg, torch.float32, N_ROWS_NARROW, gen)
        out_k = rc.mlp_fwd(ws, bs, cfg, x, d, torch.float32)
        torch.cuda.synchronize()
        e = _scaled_err(out_k, rc.mlp_fwd_plain(ws, bs, cfg, x, d, torch.float32))
        if not (torch.isfinite(out_k).all() and e <= TOL["float32"]):
            raise AssertionError(f"mlp_fwd float32 narrow {variant}: scaled err {e}")
        # B2 against the chain with f64 sums: at these widths one row's
        # leaky-branch flip in the plain f32 version's own sums moves a leaf
        # by over TOL_BWD (on this draw, xyz only: 1.5e-3 against the f64
        # chain, one row of 4091 over TOL_ROWS); the plain version's
        # distance is printed beside.
        dws, dbs, dx, dd = rc.mlp_bwd(ws, bs, cfg, x, d, g, torch.float32)
        torch.cuda.synchronize()
        exact = rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, torch.float32, work=torch.float64)
        plain = rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, torch.float32)
        dist = {}
        for who, (a_ws, a_bs, a_dx, a_dd) in (("kernel", (dws, dbs, dx, dd)), ("plain", plain)):
            dist[who] = {
                "dparams": max(_scaled_err(a, b) for a, b in zip(a_ws + a_bs,
                                                                 exact[0] + exact[1])),
                **{k: _row_errs(a, b, TOL_ROWS["float32"]) for k, a, b in
                   [("dx", a_dx, exact[2])] + ([("dd", a_dd, exact[3])] if d is not None
                                               else [])}}
        k_ = dist["kernel"]
        if (not all(bool(torch.isfinite(t).all()) for t in dws + dbs + [dx])
                or k_["dparams"] > TOL_BWD["float32"]
                or any(k_[r][1] > TOL_ROWS["float32"] for r in ("dx", "dd") if r in k_)):
            raise AssertionError(f"mlp_bwd float32 narrow {variant} against the f64 chain: {dist}")
        log(f"kernel check mlp_fwd / mlp_bwd {variant} float32 hidden 40 / last 24 "
            f"rows={N_ROWS_NARROW}: fwd scaled err {e:.3e} (tol {TOL['float32']}); bwd against "
            f"the f64 chain, kernel and plain (dparams scaled, dx/dd (scaled max, normwise, "
            f"share of rows over tol)): {dist} (tol {TOL_BWD['float32']} / "
            f"{TOL_ROWS['float32']})")
    kl.LAUNCHES.update(before)


# --------------------------------------------------------------------------- #
# Ray-march kernel phases (B6, B7)                                             #
# --------------------------------------------------------------------------- #

RM_SOURCES = {
    "raymarch_fwd": ("nerf_and_dietnerf_tpu_torch/csrc/raymarch_fwd.cu",
                     "nerf_and_dietnerf_tpu/ops/research_kernels.py:373"),
    "raymarch_bwd": ("nerf_and_dietnerf_tpu_torch/csrc/raymarch_bwd.cu",
                     "nerf_and_dietnerf_tpu/ops/research_kernels.py:410"),
    "raymarch_comp_fwd": ("nerf_and_dietnerf_tpu_torch/csrc/raymarch_comp_fwd.cu",
                          "nerf_and_dietnerf_tpu/ops/research_kernels.py:932"),
    "raymarch_comp_bwd": ("nerf_and_dietnerf_tpu_torch/csrc/raymarch_comp_bwd.cu",
                          "nerf_and_dietnerf_tpu/ops/research_kernels.py:975"),
}


def _ray_batch(torch, cfg, n_rays, n_samples, gen):
    """Origins on a radius-4 sphere, unnormalised directions towards its
    centre, z sorted in [2, 6]: points reach |x| ~ 10, theta ~ 500 rad."""
    from nerf_and_dietnerf_tpu_torch.core import cameras
    from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk

    o = torch.randn((n_rays, 3), generator=gen, device=DEVICE)
    o = 4 * o / o.norm(dim=1, keepdim=True)
    d = -o / 4 + 0.3 * torch.randn((n_rays, 3), generator=gen, device=DEVICE)
    vc = cameras.view_direction_components(d, cfg.n_angles) if cfg.uses_view_dirs else None
    z = torch.sort(2 + 4 * torch.rand((n_rays, n_samples), generator=gen, device=DEVICE),
                   dim=1).values.contiguous()
    return rk.pack_rays(cfg, o, d, vc), z


def _library_raymarch(torch, ws, bs, cfg, rd, z, composite):
    """The yardstick: a composition of the port's torch encodings, the
    ``torch.addmm`` chain of :func:`_library_mlp` and (for B7)
    ``core.rendering.composite``. No single PyTorch call computes B6 or B7;
    the port never calls this."""
    from nerf_and_dietnerf_tpu_torch.core import encoding, rendering

    n_rays, n_samples = z.shape
    cd = ws[0].dtype
    pts = (rd[:, None, 0:3] + z[..., None] * rd[:, None, 3:6]).reshape(-1, 3)
    x = encoding.encode_xyz(pts, cfg.n_freq_xyz).to(cd)
    d = None
    if cfg.uses_view_dirs:
        e = encoding.encode_view_dirs(rd[:, 6:], cfg.n_freq_dir).to(cd)
        d = e[:, None, :].expand(n_rays, n_samples, e.shape[-1]).reshape(-1, e.shape[-1])
    raw = _library_mlp(torch, ws, bs, cfg, x, d).float().reshape(n_rays, n_samples, 4)
    if not composite:
        return (raw,)
    res = rendering.composite(raw, z)
    return res.rgb, res.weights


def _rm_bytes(cfg, ws, bs, rd, z, kname):
    """Bytes a ray-march kernel must move: per-ray inputs and outputs, the
    weights once, the f32 parameter gradients once."""
    n_rays, n_samples = z.shape
    rows = n_rays * n_samples
    params = sum(w.numel() * w.element_size() for w in ws) + sum(b.numel() * 4 for b in bs)
    n_par = sum(w.numel() for w in ws) + sum(b.numel() for b in bs)
    base = rd.numel() * 4 + z.numel() * 4 + params
    return base + {
        "raymarch_fwd": rows * 16,
        "raymarch_bwd": rows * 16 + rows * 4 + n_par * 4,
        "raymarch_comp_fwd": n_rays * 12 + rows * 4,
        "raymarch_comp_bwd": n_rays * 12 + rows * 4 + rows * 4 + n_par * 4,
    }[kname]


def _fine_pass_extras(torch, rec, fn, plain, lib, flops, name, nbytes,
                      at="fine_pass") -> None:
    """An f32 kernel's timing record ``rec`` at another sample count than its
    own (the fine pass's S = 128, or ``at`` = "s192", the eval render's): the
    kernel's ms, TFLOP/s and share of its bound (``flops`` over the peak for
    ``name``, ``nbytes`` over the HBM rate), its plain version's and its
    library composition's ms, each key ending in ``at``."""
    ms = _time_ms(torch, fn, reps=3)
    bound = _bound(flops, _mlp_peak(name), nbytes)
    rec.update({f"ms_{at}": ms, f"tflops_{at}": flops / ms / 1e9,
                f"share_of_bound_{at}": bound[0] / ms,
                f"plain_ms_{at}": _time_ms(torch, plain, reps=2),
                f"library_ms_{at}": _time_ms(torch, lib, reps=3)})


def _fine_pass_text(r: dict, at="fine_pass") -> str:
    return (f" ({r[f'tflops_{at}']:.1f} TFLOP/s, {100 * r[f'share_of_bound_{at}']:.2f} % of "
            f"the bound, plain {r[f'plain_ms_{at}']:.3f} ms, library "
            f"{r[f'library_ms_{at}']:.3f} ms)" if f"share_of_bound_{at}" in r else "")


def _normwise(a, exact) -> float:
    """|a - exact|_2 / |exact|_2, in f64."""
    return float((a.double() - exact).norm() / exact.norm().clamp_min(1e-300))


def _chain_ratios(out: dict) -> dict:
    for r in out.values():
        r["ratio_kernel_to_plain"] = r["kernel"] / max(r["plain"], 1e-300)
    return out


def _b6_vs_f64_chain(torch, rc, rk, ws, bs, cfg, rd, z, g, cd) -> dict:
    """B6 and its plain version against the plain chain with the same
    roundings but f64 products and sums (``work=torch.float64``), on the
    plain encode's encodings (:func:`_vs_f64_chain`'s approach): the normwise
    distance of the raw output and, given a cotangent ``g``, of dz (the f64
    dx through the encoding VJP, its angles and cosines as the plain version
    computes them) and of the flat dparams."""
    pts, x, d = rk._mlp_inputs(cfg, rd, z, cd)
    exact = rc._forward_plain(ws, bs, cfg, x, d, cd, torch.float64)[0]
    out = {"raw": {
        "kernel": _normwise(rk.raymarch_fwd(ws, bs, cfg, rd, z, cd).reshape(-1, 4), exact),
        "plain": _normwise(rk.raymarch_fwd_plain(ws, bs, cfg, rd, z, cd).reshape(-1, 4), exact)}}
    del exact
    if g is not None:
        dws, dbs, dx, _ = rc.mlp_bwd_plain(ws, bs, cfg, x, d, g.reshape(-1, 4), cd,
                                           work=torch.float64)
        dz_exact = rk._dz_from_dx(cfg, rd, pts, dx, z.shape[1])
        par_exact = torch.cat([t.reshape(-1) for t in dws + dbs])
        del dws, dbs, dx
        for who, fn in (("kernel", rk.raymarch_bwd), ("plain", rk.raymarch_bwd_plain)):
            kws, kbs, kdz = fn(ws, bs, cfg, rd, z, g, cd)
            out.setdefault("dz", {})[who] = _normwise(kdz.reshape(-1), dz_exact)
            out.setdefault("dparams", {})[who] = _normwise(
                torch.cat([t.reshape(-1) for t in kws + kbs]), par_exact)
    return _chain_ratios(out)


COMP_BWD_NAMES = {"B7": "raymarch_comp_bwd", "B5": "mlp_loss_comp", "B4": "mlp_comp_bwd"}


def _hold_comp_bwd(torch, kernel, label, name, ws, bs, cfg, cd, args, run) -> dict:
    """B7's backward (``kernel`` "B7"), B5 ("B5") or B4's backward ("B4") on
    ``args`` (as ``tools/comp_kink.plain_of`` takes them); ``run(raw)`` gives
    its result as ``comp_kink.distance`` takes it (``(dws, dbs, dz, loss |
    None[, rows])``), on the tensor cores writing the raw values it
    composited to ``raw``. Finite, dparams (and B5's loss, B4's dencd)
    bitwise equal across two runs, and held to the tolerances as KINK_SHARE
    sets out (every instance runs on the tensor cores, the f32 ones on 3xTF32
    tiles, each summing in an order of their own), in the compute type's
    tolerances. Returns ``tools/comp_kink.compare``'s record, ``held_to``
    naming the reference held to."""
    from nerf_and_dietnerf_tpu_torch.tools import comp_kink

    kname = COMP_BWD_NAMES[kernel]
    z = args[1] if kernel == "B7" else args[2]
    raw = torch.empty((*z.shape, 4), dtype=torch.float32, device=DEVICE)
    got, again = run(raw), run(None)
    torch.cuda.synchronize()

    def rep(r):  # what must be bitwise reproducible
        rows = r[4] if len(r) > 4 else {}
        return (list(r[0]) + list(r[1]) + ([r[3]] if r[3] is not None else [])
                + ([rows["dencd"]] if "dencd" in rows else []))

    rows = got[4] if len(got) > 4 else {}
    rec = comp_kink.compare(*comp_kink.plain_of(kernel, ws, bs, cfg, cd, args), got, raw)
    rec["held_to"] = "f64_kink"
    ref = rec[rec["held_to"]]
    bad = [what for what, fails in (
        ("non-finite", not all(bool(torch.isfinite(t).all())
                               for t in rep(got) + [got[2]] + list(rows.values()) + [raw])),
        ("dparams differ between two runs", not all(torch.equal(a, b)
                                                    for a, b in zip(rep(got), rep(again)))),
        (f"dparams over {TOL_BWD[name]}", ref["dparams_worst_leaf"] > TOL_BWD[name]),
        (f"dz over {TOL_ROWS[name]}", ref["dz_normwise"] > TOL_ROWS[name]),
        *((f"{k} over {TOL_ROWS[name]}", ref[f"{k}_normwise"] > TOL_ROWS[name]) for k in rows),
        (f"loss over {TOL[name]}", ref.get("loss_rel", 0.0) > TOL[name]),
        (f"raw values over {TOL[name]}", rec.get("raw_scaled_err_vs_plain", 0.0) > TOL[name]),
        (f"kink samples over {KINK_SHARE}",
         rec.get("kink_vs_f64", {"share": 0.0})["share"] > KINK_SHARE)) if fails]
    keys = ("dparams_worst_leaf", "dparams_normwise", "dz_normwise", "dz_scaled_max",
            "loss_rel", "denc_normwise", "dencd_normwise")
    summary = (f"against {rec['held_to']}: "
               + ", ".join(f"{k} {ref[k]:.3e}" for k in keys if k in ref)
               + f"; raw scaled err {rec['raw_scaled_err_vs_plain']:.3e}, samples on the other "
                 f"side of the kink: {rec['kink_vs_f64']['count']} of the f64 evaluation's, "
                 f"{rec['kink_vs_plain']['count']} of the f32's; against the plain f32 version: "
               + ", ".join(f"{k} {rec['plain'][k]:.3e}" for k in keys if k in rec["plain"]))
    if bad:
        raise AssertionError(f"{kname} {label}: {bad}; {summary}")
    log(f"kernel check {label}: {kname} {summary}; bitwise equal across two runs")
    return rec


def _chain_record(rec: dict, forward=None) -> dict:
    """A ``b7_vs_f64_chain`` / ``b5_vs_f64_chain`` / ``b4_vs_f64_chain`` entry
    from a record of :func:`_hold_comp_bwd`: the kernel's and the plain f32
    version's normwise distance to the f64 evaluation (its own kink) for dz,
    dparams, B4's denc and dencd and B5's loss (relative), the forward's
    entries ``forward`` (B7's pixels, B4's pixels and weights) if given and,
    where the kernel gave its raw values, its distance to the f64 evaluation
    on its side of the kink and the samples on the other side (their count,
    and the rows of their 128-row tiles of the first
    ``comp_kink.MAX_LISTED``)."""
    rows = [k for k in ("dz", "dparams", "denc", "dencd") if f"{k}_normwise" in rec["f64"]]
    out = {k: {"kernel": rec["f64"][f"{k}_normwise"], "plain": rec["plain_vs_f64"][f"{k}_normwise"]}
           for k in rows}
    if "loss_rel" in rec["f64"]:
        out["loss"] = {"kernel": rec["f64"]["loss_rel"], "plain": rec["plain_vs_f64"]["loss_rel"]}
    out.update(forward or {})
    _chain_ratios(out)
    if "f64_kink" in rec:
        for k in rows:
            out[k]["kernel_kink"] = rec["f64_kink"][f"{k}_normwise"]
        out["kink_samples"] = rec["kink_vs_f64"]["count"]
        out["kink_tile_rows"] = [k["tile_row"] for k in rec["kink_vs_f64"]["samples"]]
    return out


def _b7_pixels_vs_f64(torch, rk, ws, bs, cfg, rd, z, cd) -> dict:
    """B7's forward and its plain f32 version against the plain version with
    the MLP's sums in f64: normwise distance of the pixels."""
    exact = rk.raymarch_comp_fwd_plain(ws, bs, cfg, rd, z, cd, work=torch.float64)[0].double()
    return {"kernel": _normwise(rk.raymarch_comp_fwd(ws, bs, cfg, rd, z, cd)[0], exact),
            "plain": _normwise(rk.raymarch_comp_fwd_plain(ws, bs, cfg, rd, z, cd)[0], exact)}


def _hold_comp_fwd(torch, kname, label, cd, z, run, plain, raw_plain, raw_f64):
    """B7's or B4's forward (``kname``) on depths ``z``, both types on the
    tensor cores: ``run(raw)`` its (rgb, weights), writing the raw values it composited to
    ``raw``; ``plain(**kw)`` its plain version (keywords ``work``,
    ``raw_sigma``); ``raw_plain()`` / ``raw_f64()`` the raw values the plain
    version composites with the MLP's sums in f32 / f64. bf16: held as the
    backwards are (KINK_SHARE), against the plain version with f64 sums on
    the kernel's side of the kink. f32 (3xTF32 tiles): against the plain f32
    version, since the forward has no kink to take sides on (max(sigma, 0) is
    continuous). Both: finite, rgb and weights to TOL, the raw values to TOL
    against the plain forward's, outputs and raw values bitwise equal across
    two runs. Returns (scaled err, max |kernel - reference|, raw values,
    (rgb, weights), the text the caller logs)."""
    from nerf_and_dietnerf_tpu_torch.tools import comp_kink

    name = str(cd).split(".")[-1]
    tol = TOL[name]
    raw_f, raw_again = (torch.empty((*z.shape, 4), device=DEVICE) for _ in range(2))
    got, again = run(raw_f), run(raw_again)
    torch.cuda.synchronize()
    e_raw = _scaled_err(raw_f, raw_plain())
    bad = [what for what, fails in (
        ("non-finite", not all(bool(torch.isfinite(t).all()) for t in (*got, raw_f))),
        ("differs between two runs", not all(torch.equal(a, b) for a, b in zip(
            (*got, raw_f), (*again, raw_again)))),
        (f"raw values over {tol}", e_raw > tol)) if fails]
    extra = f", raw scaled err {e_raw:.3e}"
    if cd == torch.bfloat16:
        want = plain(work=torch.float64, raw_sigma=raw_f[..., 3])
        kink = comp_kink.kink_samples(raw_f, raw_f64())
        extra += f", {kink['count']} kink samples"
        if kink["share"] > KINK_SHARE:
            bad.append(f"kink share {kink['share']} over {KINK_SHARE}")
    else:
        want = plain()
    e_c = max(_scaled_err(got[0], want[0]), _scaled_err(got[1], want[1]))
    if e_c > tol:
        bad.append(f"scaled err {e_c} over {tol}")
    if bad:
        raise AssertionError(f"{kname} {label}: {bad}{extra}")
    return (e_c, max(float((a - b).abs().max()) for a, b in zip(got, want)), raw_f, got,
            extra + ", bitwise equal across two runs")


def _same_raw(torch, kernel, label, raw_fwd, raw_bwd) -> None:
    """One tile code of one kit, one order of sums: ``kernel``'s backward
    composites bitwise the raw values its forward composited (both types)."""
    if not torch.equal(raw_bwd, raw_fwd):
        raise AssertionError(f"{kernel} {label}: the backward's raw values differ from the "
                             f"forward's")
    log(f"kernel check {label}: {kernel}'s backward composited the forward's raw values, bitwise")


def _rm_checks(torch, rk, cfg, ws, bs, rd, z, cd, name, gen, label, backward=True, b7=True):
    """Each B6/B7 kernel (B6 alone without ``b7``) against its plain version on
    (rd, z), the backwards too if ``backward``; returns the max |kernel -
    plain| of each kernel (B7's: against the reference it is held to), the
    cotangents the timings reuse and B7's backward's record of
    :func:`_hold_comp_bwd` (None without the backwards)."""
    from nerf_and_dietnerf_tpu_torch.tools import comp_kink

    tol, tol_b, tol_r = TOL[name], TOL_BWD[name], TOL_ROWS[name]
    n_rays, n_samples = z.shape
    errs = {}

    raw_k = rk.raymarch_fwd(ws, bs, cfg, rd, z, cd)
    torch.cuda.synchronize()
    raw_p = rk.raymarch_fwd_plain(ws, bs, cfg, rd, z, cd)
    e = _scaled_err(raw_k, raw_p)
    errs["raymarch_fwd"] = float((raw_k - raw_p).abs().max())
    if not (torch.isfinite(raw_k).all() and e <= tol):
        raise AssertionError(f"raymarch_fwd {label}: scaled err {e} > {tol}")
    del raw_k, raw_p

    raw_f = None
    if b7:
        e_c, errs["raymarch_comp_fwd"], raw_f, _, extra = _hold_comp_fwd(
            torch, "raymarch_comp_fwd", label, cd, z,
            lambda raw: rk.raymarch_comp_fwd(ws, bs, cfg, rd, z, cd, raw=raw),
            lambda **kw: rk.raymarch_comp_fwd_plain(ws, bs, cfg, rd, z, cd, **kw),
            lambda: rk.raymarch_fwd_plain(ws, bs, cfg, rd, z, cd),
            lambda: comp_kink.plain_of("B7", ws, bs, cfg, cd, (rd, z))[1](torch.float64))
    log(f"kernel check {label}: B6 fwd scaled err {e:.3e}"
        + (f", B7 fwd {e_c:.3e} against {'f64_kink' if cd == torch.bfloat16 else 'plain'}"
           f"{extra}" if b7 else "") + f" (tol {tol})")
    if not backward:
        return errs, None, None

    g = (0.5 + torch.rand((n_rays, n_samples, 4), generator=gen, device=DEVICE)).contiguous()
    g_rgb = (0.5 + torch.rand((n_rays, 3), generator=gen, device=DEVICE)).contiguous()
    g_w = (0.5 + torch.rand((n_rays, n_samples), generator=gen, device=DEVICE)).contiguous()
    dws, dbs, dz = rk.raymarch_bwd(ws, bs, cfg, rd, z, g, cd)
    torch.cuda.synchronize()
    pws, pbs, pdz = rk.raymarch_bwd_plain(ws, bs, cfg, rd, z, g, cd)
    e_par = max(_scaled_err(a, b) for a, b in zip(dws + dbs, pws + pbs))
    dz_stats = _row_errs(dz, pdz, tol_r)
    errs["raymarch_bwd"] = max(float((a - b).abs().max()) for a, b in
                               list(zip(dws + dbs, pws + pbs)) + [(dz, pdz)])
    if not torch.isfinite(dz).all() or e_par > tol_b or dz_stats[1] > tol_r:
        raise AssertionError(f"raymarch_bwd {label}: dparams scaled err {e_par} (tol {tol_b}); "
                             f"dz (scaled max, normwise, share over tol) {dz_stats} "
                             f"(tol {tol_r})")
    dws2, dbs2, _ = rk.raymarch_bwd(ws, bs, cfg, rd, z, g, cd)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2)):
        raise AssertionError(f"raymarch_bwd {label}: dparams differ between runs")
    log(f"kernel check {label}: raymarch_bwd dparams scaled err {e_par:.3e} (tol {tol_b}), dz "
        f"(scaled max, normwise, share of rows over tol) {dz_stats} (tol {tol_r}), dparams "
        f"bitwise equal across two runs")
    rec = None
    if b7:
        raws = {}

        def run7(raw):
            if raw is not None:
                raws["bwd"] = raw
            return (*rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, g_rgb, g_w, cd, raw=raw), None)

        rec = _hold_comp_bwd(torch, "B7", label, name, ws, bs, cfg, cd, (rd, z, g_rgb, g_w), run7)
        errs["raymarch_comp_bwd"] = rec[rec["held_to"]]["max_abs"]
        _same_raw(torch, "B7", label, raw_f, raws["bwd"])
    return errs, (g, g_rgb, g_w), rec


def raymarch_kernel_phases(torch, timings: dict) -> None:
    from nerf_and_dietnerf_tpu_torch.models import mlp
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
    from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
    from nerf_and_dietnerf_tpu_torch.tools import mlp_flops

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    # The ragged-row checks draw from a generator of their own, so that every
    # other check here draws the inputs it drew before they were added.
    gen_ragged = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    # The checks added with B7's tensor-core backward (S = 100 in bf16, opaque
    # rays in bf16) draw from one more, for the same reason.
    gen_b7 = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    # f32 B7's backward at the fine pass's S = 128, added with its
    # tensor-core kernel, from one more; f32 B6's backward at a part-filled
    # last 64-row tile, added with its tensor-core kernel, from one more.
    gen_t32 = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    gen_b6 = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    # The cotangents of f32 B7's backward at the eval render's S = 192 (its
    # raw values held bitwise to the forward's there), added with f32 B7's
    # tensor-core forward, from one more (the rays keep their draw).
    gen_b7_fwd = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    for variant, n_angles in (("view_dirs", 2), ("xyz_only", 0)):
        cfg = mlp.MLPConfig(n_angles=n_angles)
        params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
        for cd in (torch.bfloat16, torch.float32):
            name = str(cd).split(".")[-1]
            ws, bs = rc.flatten_params(params, cfg, cd)
            # A ragged ray count (its backwards in bf16: f32 B6's backward
            # runs 64-row tiles, which 4093 x 64 rows fill; it is held at
            # 4093 x 100 below): B6's part-filled last 128-row tile, and in
            # bf16 B7 with a last group of one ray.
            rd_r, z_r = _ray_batch(torch, cfg, RAYS_RAGGED, SAMPLES, gen_ragged)
            ragged = _rm_checks(torch, rk, cfg, ws, bs, rd_r, z_r, cd, name, gen_ragged,
                                f"{variant} {name} R={RAYS_RAGGED} S={SAMPLES}",
                                backward=cd == torch.bfloat16, b7=cd == torch.bfloat16)[0]
            del rd_r, z_r
            rd, z = _ray_batch(torch, cfg, RAYS, SAMPLES, gen)
            errs, cots, rec7 = _rm_checks(torch, rk, cfg, ws, bs, rd, z, cd, name, gen,
                                          f"{variant} {name} R={RAYS} S={SAMPLES}")
            # B6 and its plain version against the f64 chain: the forward and
            # the backward's dz and dparams in both types (f32: the 3xTF32
            # tile, as f32 B2's).
            chain = _b6_vs_f64_chain(torch, rc, rk, ws, bs, cfg, rd, z, cots[0], cd)
            timings.setdefault("b6_vs_f64_chain", {}).setdefault(variant, {})[name] = chain
            log(f"kernel check B6 {variant} {name} R={RAYS} S={SAMPLES} against the f64 chain "
                f"(normwise, kernel and plain): {chain}")
            # The other sample counts: (rd, z, errors, cotangents, B7's backward's
            # record) by count, each from the generator of its rays and that of
            # its cotangents; in bf16 S = 100 too (one part-filled tile a ray in
            # B7's backward).
            other = {}
            for n_s, g_s, g_c in (
                    ((2 * SAMPLES, gen, gen), (SAMPLES_RAGGED, gen_b7, gen_b7))
                    if cd == torch.bfloat16
                    else ((SAMPLES_EVAL, gen, gen_b7_fwd), (SAMPLES_RAGGED, gen, gen),
                          (2 * SAMPLES, gen_t32, gen_t32))):
                rd_s, z_s = _ray_batch(torch, cfg, RAYS, n_s, g_s)
                other[n_s] = (rd_s, z_s, *_rm_checks(
                    torch, rk, cfg, ws, bs, rd_s, z_s, cd, name, g_c,
                    f"{variant} {name} R={RAYS} S={n_s}"))
            if cd == torch.float32:
                # f32 B6's backward with a part-filled last 64-row tile, and f32
                # B7 (forward and backward) on the same rays.
                rd_r, z_r = _ray_batch(torch, cfg, RAYS_RAGGED, SAMPLES_RAGGED, gen_b6)
                ragged_b6 = _rm_checks(torch, rk, cfg, ws, bs, rd_r, z_r, cd, name, gen_b6,
                                       f"{variant} {name} R={RAYS_RAGGED} S={SAMPLES_RAGGED}")[0]
                del rd_r, z_r
            # B7 and its plain version against the f64 evaluation: pixels, dz
            # and dparams at S = 64 and 128 (in f32 also ROADMAP C3's steps on
            # the S = 64 draw).
            for n_s, (rd_c, z_c, rec_c) in [(SAMPLES, (rd, z, rec7))] + [
                    (2 * SAMPLES, (other[2 * SAMPLES][0], other[2 * SAMPLES][1],
                                   other[2 * SAMPLES][4]))]:
                chain7 = _chain_record(rec_c, {"pixels": _b7_pixels_vs_f64(torch, rk, ws, bs, cfg,
                                                                           rd_c, z_c, cd)})
                timings.setdefault("b7_vs_f64_chain", {}).setdefault(variant, {}).setdefault(
                    name, {})[f"S={n_s}"] = chain7
                log(f"kernel check B7 {variant} {name} R={RAYS} S={n_s} against the f64 "
                    f"evaluation (normwise, kernel and plain): {chain7}")
            if cd == torch.float32:
                from nerf_and_dietnerf_tpu_torch.tools import comp_f32_steps

                steps = comp_f32_steps.b7_steps(ws, bs, cfg, rd, z, *cots[1:])
                timings.setdefault("b7_f32_steps", {})[variant] = steps
                log(f"kernel check B7 {variant} float32 R={RAYS} S={SAMPLES}, step by step "
                    f"against the f64 chain (tools/comp_f32_steps.py): {steps}")
            if variant != "view_dirs":
                continue
            g, g_rgb, g_w = cots
            flops = mlp_flops(cfg, RAYS * SAMPLES)
            leaves = [w.detach().clone().requires_grad_(True) for w in ws]
            zr = z.clone().requires_grad_(True)

            def lib_bwd(comp, rd_=rd, z_=zr, cot=(g_rgb, g_w, g)):
                outs = _library_raymarch(torch, leaves, bs, cfg, rd_, z_, comp)
                torch.autograd.grad(outs, leaves + [z_], cot[:2] if comp else cot[2:])

            cases = (
                ("raymarch_fwd", lambda: rk.raymarch_fwd(ws, bs, cfg, rd, z, cd),
                 lambda: rk.raymarch_fwd_plain(ws, bs, cfg, rd, z, cd),
                 lambda: _library_raymarch(torch, ws, bs, cfg, rd, z, False), flops),
                ("raymarch_bwd", lambda: rk.raymarch_bwd(ws, bs, cfg, rd, z, g, cd),
                 lambda: rk.raymarch_bwd_plain(ws, bs, cfg, rd, z, g, cd),
                 lambda: lib_bwd(False), 3 * flops),
                ("raymarch_comp_fwd", lambda: rk.raymarch_comp_fwd(ws, bs, cfg, rd, z, cd),
                 lambda: rk.raymarch_comp_fwd_plain(ws, bs, cfg, rd, z, cd),
                 lambda: _library_raymarch(torch, ws, bs, cfg, rd, z, True), flops),
                ("raymarch_comp_bwd",
                 lambda: rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, g_rgb, g_w, cd),
                 lambda: rk.raymarch_comp_bwd_plain(ws, bs, cfg, rd, z, g_rgb, g_w, cd),
                 lambda: lib_bwd(True), 3 * flops),
            )
            rec = {}
            before = dict(kl.LAUNCHES)
            for kname, fn, plain, lib, fl in cases:
                nbytes = _rm_bytes(cfg, ws, bs, rd, z, kname)
                t_ops, t_bytes = fl / _mlp_peak(name), nbytes / PEAK_BYTES
                ms = _time_ms(torch, fn)
                rec[kname] = {
                    "rays": RAYS, "samples": SAMPLES, "dtype": name,
                    "design": RM_DESIGN[(kname, name)],
                    "ms": ms,
                    "tflops": fl / ms / 1e9,
                    "share_of_bound": 1e3 * max(t_ops, t_bytes) / ms,
                    "plain_ms": _time_ms(torch, plain, reps=2),
                    "library_ms": _time_ms(torch, lib),
                    "library": "composition: torch encode + addmm chain"
                               + (" + composite" if "comp" in kname else ""),
                    "bound_ms": 1e3 * max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "max_abs_err": errs[kname],
                }
                if kname in ragged:
                    rec[kname]["max_abs_err_ragged"] = ragged[kname]
            if cd == torch.bfloat16:  # the fine pass of a train step, S = 128
                rd3, z3, errs128, (g3, g_rgb3, g_w3), _ = other[2 * SAMPLES]
                for kname, fn in (
                        ("raymarch_fwd", lambda: rk.raymarch_fwd(ws, bs, cfg, rd3, z3, cd)),
                        ("raymarch_bwd", lambda: rk.raymarch_bwd(ws, bs, cfg, rd3, z3, g3, cd)),
                        ("raymarch_comp_fwd",
                         lambda: rk.raymarch_comp_fwd(ws, bs, cfg, rd3, z3, cd)),
                        ("raymarch_comp_bwd",
                         lambda: rk.raymarch_comp_bwd(ws, bs, cfg, rd3, z3, g_rgb3, g_w3, cd))):
                    rec[kname]["ms_fine_pass"] = _time_ms(torch, fn, reps=3)
                    rec[kname]["tflops_fine_pass"] = (
                        (3 if "bwd" in kname else 1) * mlp_flops(cfg, RAYS * 2 * SAMPLES)
                        / rec[kname]["ms_fine_pass"] / 1e9)
                    rec[kname]["max_abs_err_s128"] = errs128[kname]
            for kname in RM_SOURCES:
                rec[kname]["max_abs_err_s100"] = other[SAMPLES_RAGGED][2][kname]
            if cd == torch.float32:  # f32 B6's backward and B7 at S = 128
                rd3, z3, errs128, (g3, g_rgb3, g_w3), _ = other[2 * SAMPLES]
                for kname in RM_SOURCES:
                    rec[kname]["max_abs_err_s128"] = errs128[kname]
                for kname in ("raymarch_bwd", "raymarch_comp_fwd", "raymarch_comp_bwd"):
                    rec[kname]["max_abs_err_ragged_s100"] = ragged_b6[kname]
                z3r = z3.clone().requires_grad_(True)
                _fine_pass_extras(
                    torch, rec["raymarch_bwd"],
                    lambda: rk.raymarch_bwd(ws, bs, cfg, rd3, z3, g3, cd),
                    lambda: rk.raymarch_bwd_plain(ws, bs, cfg, rd3, z3, g3, cd),
                    lambda: lib_bwd(False, rd3, z3r, (None, None, g3)),
                    3 * mlp_flops(cfg, RAYS * 2 * SAMPLES), name,
                    _rm_bytes(cfg, ws, bs, rd3, z3, "raymarch_bwd"))
                _fine_pass_extras(
                    torch, rec["raymarch_comp_fwd"],
                    lambda: rk.raymarch_comp_fwd(ws, bs, cfg, rd3, z3, cd),
                    lambda: rk.raymarch_comp_fwd_plain(ws, bs, cfg, rd3, z3, cd),
                    lambda: _library_raymarch(torch, ws, bs, cfg, rd3, z3, True),
                    mlp_flops(cfg, RAYS * 2 * SAMPLES), name,
                    _rm_bytes(cfg, ws, bs, rd3, z3, "raymarch_comp_fwd"))
                _fine_pass_extras(
                    torch, rec["raymarch_comp_bwd"],
                    lambda: rk.raymarch_comp_bwd(ws, bs, cfg, rd3, z3, g_rgb3, g_w3, cd),
                    lambda: rk.raymarch_comp_bwd_plain(ws, bs, cfg, rd3, z3, g_rgb3, g_w3, cd),
                    lambda: lib_bwd(True, rd3, z3r, (g_rgb3, g_w3, None)),
                    3 * mlp_flops(cfg, RAYS * 2 * SAMPLES), name,
                    _rm_bytes(cfg, ws, bs, rd3, z3, "raymarch_comp_bwd"))
            if cd == torch.float32:  # the eval render's forwards, S = 192
                rd2, z2, errs192, _, _ = other[SAMPLES_EVAL]
                rec["raymarch_fwd"]["ms_s192"] = _time_ms(
                    torch, lambda: rk.raymarch_fwd(ws, bs, cfg, rd2, z2, cd), reps=3)
                _fine_pass_extras(
                    torch, rec["raymarch_comp_fwd"],
                    lambda: rk.raymarch_comp_fwd(ws, bs, cfg, rd2, z2, cd),
                    lambda: rk.raymarch_comp_fwd_plain(ws, bs, cfg, rd2, z2, cd),
                    lambda: _library_raymarch(torch, ws, bs, cfg, rd2, z2, True),
                    mlp_flops(cfg, RAYS * SAMPLES_EVAL), name,
                    _rm_bytes(cfg, ws, bs, rd2, z2, "raymarch_comp_fwd"), at="s192")
                for kname in RM_SOURCES:
                    rec[kname]["max_abs_err_s192"] = errs192[kname]
            kl.LAUNCHES.update(before)  # timing launches are not the main path's
            # B7's forwards, f32 B7's and B6's backwards on the tensor cores:
            # their registers and spills beside their times.
            sass = timings.get("sass", {})
            for (kname, dt), (key, kernel) in SASS_OF.items():
                if dt == name and kname in rec:
                    rec[kname]["ptxas"] = sass.get(key, {}).get(kernel)
            timings["rm_" + name] = rec
            for kname, r in rec.items():
                log(f"time {kname} {name} R={RAYS} S={SAMPLES} ({r['design']}): kernel "
                    f"{r['ms']:.3f} ms ({r['tflops']:.1f} TFLOP/s, "
                    f"{100 * r['share_of_bound']:.2f} % of the bound), plain "
                    f"{r['plain_ms']:.3f} ms, library (composition) {r['library_ms']:.3f} ms, "
                    f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                    + (f"; S={SAMPLES_EVAL}: {r['ms_s192']:.3f} ms" if "ms_s192" in r else "")
                    + _fine_pass_text(r, "s192")
                    + (f"; S={2 * SAMPLES}: {r['ms_fine_pass']:.3f} ms" if "ms_fine_pass" in r
                       else "")
                    + (f" ({r['tflops_fine_pass']:.1f} TFLOP/s)"
                       if "tflops_fine_pass" in r and "share_of_bound_fine_pass" not in r else "")
                    + _fine_pass_text(r)
                    + (f"; registers, spill bytes, SASS HMMA {r['ptxas']}" if "ptxas" in r
                       else ""))

    # f32 B6 forward at widths beyond its 64 input columns (xyz L = 10: 63 +
    # 24 view-dir columns): its FMA design, on a ragged row count.
    cfg = mlp.MLPConfig(n_freq_xyz=10)
    params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
    ws, bs = rc.flatten_params(params, cfg, torch.float32)
    rd, z = _ray_batch(torch, cfg, 509, SAMPLES, gen_ragged)
    _rm_checks(torch, rk, cfg, ws, bs, rd, z, torch.float32, "float32", gen_ragged,
               f"xyz L=10 float32 R=509 S={SAMPLES}", backward=False, b7=False)

    # Opaque rays: transmittance underflows to exactly 0, the B7 backward
    # stays finite (it is division-free) and agrees with its plain version; in
    # f32 (3xTF32) and in bf16, both on the tensor cores. f32 B7's forward too,
    # its raw values bitwise the backward's.
    from nerf_and_dietnerf_tpu_torch.tools import comp_kink

    cfg = mlp.MLPConfig(n_angles=0)
    params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
    params["sigma_out"]["bias"] = params["sigma_out"]["bias"] + 1e6
    for cd, g_o in ((torch.float32, gen), (torch.bfloat16, gen_b7)):
        name = str(cd).split(".")[-1]
        label = f"opaque rays {name} R=256 S={SAMPLES}"
        ws, bs = rc.flatten_params(params, cfg, cd)
        rd, z = _ray_batch(torch, cfg, 256, SAMPLES, g_o)
        g_rgb = torch.ones((256, 3), device=DEVICE)
        g_w = torch.ones((256, SAMPLES), device=DEVICE)
        raws = {}
        if cd == torch.float32:
            e_o, _, raws["fwd"], _, extra = _hold_comp_fwd(
                torch, "raymarch_comp_fwd", label, cd, z,
                lambda raw: rk.raymarch_comp_fwd(ws, bs, cfg, rd, z, cd, raw=raw),
                lambda **kw: rk.raymarch_comp_fwd_plain(ws, bs, cfg, rd, z, cd, **kw),
                lambda: rk.raymarch_fwd_plain(ws, bs, cfg, rd, z, cd),
                lambda: comp_kink.plain_of("B7", ws, bs, cfg, cd, (rd, z))[1](torch.float64))
            log(f"kernel check {label}: B7 fwd scaled err {e_o:.3e} against plain{extra}")

        def run_o(raw):
            if raw is not None:
                raws["bwd"] = raw
            return (*rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, g_rgb, g_w, cd, raw=raw), None)

        _hold_comp_bwd(torch, "B7", label, name, ws, bs, cfg, cd, (rd, z, g_rgb, g_w), run_o)
        if "fwd" in raws:
            _same_raw(torch, "B7", label, raws["fwd"], raws["bwd"])
    ws, bs = rc.flatten_params(params, cfg, torch.float32)
    try:
        rk.raymarch_comp_fwd(ws, bs, cfg, *_ray_batch(torch, cfg, 8, rk.MAX_SAMPLES_COMPOSITED + 1,
                                                       gen), torch.float32)
    except ValueError as exc:
        log(f"kernel check: B7 above the maximum of samples raises: {exc}")
    else:
        raise AssertionError("raymarch_comp_fwd took more samples than its maximum")


# --------------------------------------------------------------------------- #
# MLP + compositing kernel phases (B4, B5)                                     #
# --------------------------------------------------------------------------- #

COMP_SOURCES = {
    "mlp_comp_fwd": ("nerf_and_dietnerf_tpu_torch/csrc/mlp_comp_fwd.cu",
                     "nerf_and_dietnerf_tpu/ops/research_kernels.py:1407"),
    "mlp_comp_bwd": ("nerf_and_dietnerf_tpu_torch/csrc/mlp_comp_bwd.cu",
                     "nerf_and_dietnerf_tpu/ops/research_kernels.py:1452"),
    "mlp_loss_comp": ("nerf_and_dietnerf_tpu_torch/csrc/mlp_loss_comp.cu",
                      "nerf_and_dietnerf_tpu/ops/research_kernels.py:1856"),
}


def _enc_batch(torch, cfg, cd, n_rays, n_samples, gen):
    """A ray batch of :func:`_ray_batch`, encoded by torch ops as the "pallas"
    backend does: ``(enc (R S, xyz) in the compute type, ray-major rows; encd
    (R, dir) f32 per ray or None; z (R, S); dvec (R, 3); target (R, 3))``,
    the targets below every pixel (see the tolerances above)."""
    from nerf_and_dietnerf_tpu_torch.core import encoding

    rd, z = _ray_batch(torch, cfg, n_rays, n_samples, gen)
    pts = (rd[:, None, 0:3] + z[..., None] * rd[:, None, 3:6]).reshape(-1, 3)
    enc = encoding.encode_xyz(pts, cfg.n_freq_xyz).to(cd).contiguous()
    encd = (encoding.encode_view_dirs(rd[:, 6:], cfg.n_freq_dir).contiguous()
            if cfg.uses_view_dirs else None)
    target = -(0.5 + torch.rand((n_rays, 3), generator=gen, device=DEVICE))
    return enc, encd, z, rd[:, 3:6].contiguous(), target


def _library_comp(torch, ws, bs, cfg, enc, encd, z, target=None):
    """The yardstick of B4 (and, with ``target``, B5): a composition of the
    ``torch.addmm`` chain of :func:`_library_mlp` on the same encodings,
    ``core.rendering.composite`` and the MSE. No single PyTorch call computes
    them; the port never calls this."""
    from nerf_and_dietnerf_tpu_torch.core import rendering

    n_rays, n_samples = z.shape
    d = None
    if encd is not None:
        d = encd.to(enc.dtype)[:, None, :].expand(n_rays, n_samples, encd.shape[-1]).reshape(
            n_rays * n_samples, -1)
    raw = _library_mlp(torch, ws, bs, cfg, enc, d).float().reshape(n_rays, n_samples, 4)
    res = rendering.composite(raw, z)
    if target is None:
        return res.rgb, res.weights
    return (torch.mean(torch.square(res.rgb - target)),)


def _comp_bytes(cfg, ws, bs, enc, encd, z, kname):
    """Bytes an MLP + compositing kernel must move: encodings, z, cotangents
    and targets in, its outputs and the f32 parameter gradients out, the
    weights once."""
    n_rays, n_samples = z.shape
    rows = n_rays * n_samples
    params = sum(w.numel() * w.element_size() for w in ws) + sum(b.numel() * 4 for b in bs)
    n_par = sum(w.numel() for w in ws) + sum(b.numel() for b in bs)
    dir_bytes = encd.numel() * 4 if encd is not None else 0
    base = enc.numel() * enc.element_size() + dir_bytes + z.numel() * 4 + params
    return base + {
        "mlp_comp_fwd": n_rays * 12 + rows * 4,
        "mlp_comp_bwd": n_rays * 12 + rows * 4 + enc.numel() * 4 + dir_bytes + rows * 4
                        + n_par * 4,
        "mlp_loss_comp": n_rays * 24 + rows * 4 + n_par * 4 + 4,
    }[kname]


def _comp_checks(torch, rk, cfg, ws, bs, batch, cd, name, gen, label, b4=True, b5=True):
    """B4's forward and backward and B5 against their plain versions on
    ``batch`` (:func:`_enc_batch`); returns the max |kernel - plain| of each
    kernel (against the reference it is held to), B4's cotangents for the
    timings and the records: B5's and B4's backward's of :func:`_hold_comp_bwd`
    ("B5", "B4") and B4's forward's distances to the f64 evaluation ("B4_fwd":
    pixels and weights, kernel and plain f32 version)."""
    from nerf_and_dietnerf_tpu_torch.tools import comp_kink

    tol = TOL[name]
    enc, encd, z, dvec, target = batch
    n_rays, n_samples = z.shape
    errs, cots, recs = {}, None, {}

    if b4:
        # The forward (_hold_comp_fwd); in f32 right after NaN was left in
        # every SM's shared memory where its D tile lies (_poison_comp_fwd): a
        # pad column of the D tile left as it was turns the outputs NaN.
        from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc

        bf = cd == torch.bfloat16
        d = rk._dir_rows(cfg, encd, n_samples, cd)
        poison = None if bf else _poison_comp_fwd(
            torch, rk, rc, torch.cuda.get_device_properties(z.device).multi_processor_count)
        e, errs["mlp_comp_fwd"], raw_f, (rgb_k, w_k), extra = _hold_comp_fwd(
            torch, "mlp_comp_fwd", label, cd, z,
            lambda raw: rk.mlp_comp_fwd(ws, bs, cfg, enc, encd, z, cd, raw=raw,
                                        before_launch=poison),
            lambda **kw: rk.mlp_comp_fwd_plain(ws, bs, cfg, enc, encd, z, cd, **kw),
            lambda: rk._raw_plain(ws, bs, cfg, enc, d, z, cd, torch.float32),
            lambda: rk._raw_plain(ws, bs, cfg, enc, d, z, cd, torch.float64))
        plain = rk.mlp_comp_fwd_plain(ws, bs, cfg, enc, encd, z, cd)
        exact = rk.mlp_comp_fwd_plain(ws, bs, cfg, enc, encd, z, cd, work=torch.float64)
        recs["B4_fwd"] = {k: {"kernel": _normwise(a, e_.double()), "plain": _normwise(p, e_.double())}
                          for k, a, p, e_ in (("pixels", rgb_k, plain[0], exact[0]),
                                              ("weights", w_k, plain[1], exact[1]))}
        del plain, exact, d
        log(f"kernel check {label}: B4 fwd scaled err {e:.3e} (tol {tol}) against "
            f"{'f64_kink' if bf else 'plain'}{extra}")
        g_rgb = (0.5 + torch.rand((n_rays, 3), generator=gen, device=DEVICE)).contiguous()
        g_w = (0.5 + torch.rand((n_rays, n_samples), generator=gen, device=DEVICE)).contiguous()
        cots = (g_rgb, g_w)
        raws = {}

        def run4(raw):
            if raw is not None:
                raws["bwd"] = raw
            return comp_kink.b4_result(*rk.mlp_comp_bwd(ws, bs, cfg, enc, encd, z, g_rgb, g_w, cd,
                                                        raw=raw))

        recs["B4"] = _hold_comp_bwd(torch, "B4", label, name, ws, bs, cfg, cd,
                                    (enc, encd, z, g_rgb, g_w), run4)
        errs["mlp_comp_bwd"] = recs["B4"][recs["B4"]["held_to"]]["max_abs"]
        _same_raw(torch, "B4", label, raw_f, raws["bwd"])
    if b5:
        def run(raw):
            mse, dz, dws, dbs = rk.mlp_loss_comp(ws, bs, cfg, enc, encd, z, dvec, target, cd,
                                                 raw=raw)
            return dws, dbs, dz, mse

        recs["B5"] = _hold_comp_bwd(torch, "B5", label, name, ws, bs, cfg, cd, batch, run)
        errs["mlp_loss_comp"] = recs["B5"][recs["B5"]["held_to"]]["max_abs"]
    return errs, cots, recs


def comp_kernel_phases(torch, timings: dict) -> None:
    from nerf_and_dietnerf_tpu_torch.models import mlp
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
    from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
    from nerf_and_dietnerf_tpu_torch.tools import mlp_flops

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    # The checks added with B5's tensor-core kernel (bf16 at S = 100, at 4093
    # rays, on opaque rays) draw from a generator of their own, so that every
    # other check here draws the inputs it drew before; those added with B4's
    # (the same cases) from one more.
    gen_b5 = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    gen_b4 = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    # f32 B4's backward at the fine pass's S = 128 (a ray over two 64-row
    # tiles), added with its tensor-core kernel, from one more.
    gen_b4_t32 = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    # f32 B4 at 4093 rays of the eval render's 192 samples (a ray over three
    # 64-row tiles), added with its tensor-core forward, from one more.
    gen_b4_fwd = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    for variant, n_angles in (("view_dirs", 2), ("xyz_only", 0)):
        cfg = mlp.MLPConfig(n_angles=n_angles)
        params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
        for cd in (torch.bfloat16, torch.float32):
            name = str(cd).split(".")[-1]
            ws, bs = rc.flatten_params(params, cfg, cd)
            # Sample counts: B4 at the coarse pass's 64, B4 and B5 at the fine
            # pass's 128; in f32 also at the ragged 100; B5 at 64 too (it draws
            # nothing: every other check keeps its inputs).
            batches, errs, cots, recs = {}, {}, {}, {}
            for n_s, b4, b5 in ((SAMPLES, True, True),
                                (2 * SAMPLES, cd == torch.bfloat16, True)) + (
                    ((SAMPLES_RAGGED, True, True),) if cd == torch.float32 else ()):
                batches[n_s] = _enc_batch(torch, cfg, cd, RAYS, n_s, gen)
                errs[n_s], cots[n_s], recs[n_s] = _comp_checks(
                    torch, rk, cfg, ws, bs, batches[n_s], cd, name, gen,
                    f"{variant} {name} R={RAYS} S={n_s}", b4, b5)
            if cd == torch.float32:
                # f32 B4 at S = 128 (on a batch of its own: B5's S = 128
                # checks keep theirs).
                batch4 = _enc_batch(torch, cfg, cd, RAYS, 2 * SAMPLES, gen_b4_t32)
                e4, cots4, r4 = _comp_checks(torch, rk, cfg, ws, bs, batch4, cd, name,
                                             gen_b4_t32, f"{variant} {name} R={RAYS} "
                                             f"S={2 * SAMPLES}", b5=False)
                errs[2 * SAMPLES].update(e4)
                recs[2 * SAMPLES].update(r4)
                label = f"{variant} {name} R={RAYS_RAGGED} S={SAMPLES_EVAL}"
                errs[label] = _comp_checks(
                    torch, rk, cfg, ws, bs,
                    _enc_batch(torch, cfg, cd, RAYS_RAGGED, SAMPLES_EVAL, gen_b4_fwd), cd, name,
                    gen_b4_fwd, label, b5=False)[0]
            if cd == torch.bfloat16:
                # bf16 B5 also at S = 100 (one part-filled tile a ray) and at
                # 4093 rays of 64 samples (a last group of one ray); then B5 and
                # its plain version against the f64 evaluation at S = 64 and 128.
                for n_r, n_s in ((RAYS, SAMPLES_RAGGED), (RAYS_RAGGED, SAMPLES)):
                    label = f"{variant} {name} R={n_r} S={n_s}"
                    errs[label] = _comp_checks(
                        torch, rk, cfg, ws, bs, _enc_batch(torch, cfg, cd, n_r, n_s, gen_b5), cd,
                        name, gen_b5, label, b4=False)[0]
                    # B4 on the tensor cores at the same shapes.
                    errs[label].update(_comp_checks(
                        torch, rk, cfg, ws, bs, _enc_batch(torch, cfg, cd, n_r, n_s, gen_b4), cd,
                        name, gen_b4, label, b5=False)[0])
            # B5 and its plain version against the f64 evaluation at S = 64 and
            # 128 (bf16 under "S=..", f32 under "float32 S=..").
            for n_s in (SAMPLES, 2 * SAMPLES):
                chain5 = _chain_record(recs[n_s]["B5"])
                timings.setdefault("b5_vs_f64_chain", {}).setdefault(variant, {})[
                    ("" if cd == torch.bfloat16 else f"{name} ") + f"S={n_s}"] = chain5
                log(f"kernel check B5 {variant} {name} R={RAYS} S={n_s} against the f64 "
                    f"evaluation (loss relative, dz and dparams normwise; kernel and "
                    f"plain): {chain5}")
            # B4 and its plain version against the f64 evaluation at S = 64
            # and 128.
            for n_s in (SAMPLES, 2 * SAMPLES):
                chain4 = _chain_record(recs[n_s]["B4"], recs[n_s]["B4_fwd"])
                timings.setdefault("b4_vs_f64_chain", {}).setdefault(variant, {}).setdefault(
                    name, {})[f"S={n_s}"] = chain4
                log(f"kernel check B4 {variant} {name} R={RAYS} S={n_s} against the f64 "
                    f"evaluation (normwise; kernel and plain): {chain4}")
            if variant != "view_dirs":
                continue
            leaves = [w.detach().clone().requires_grad_(True) for w in ws]

            def lib_bwd(n_s, wrt, loss):
                outs = _library_comp(torch, leaves, bs, cfg, *wrt,
                                     batches[n_s][4] if loss else None)
                torch.autograd.grad(outs, leaves + wrt, None if loss else cots[n_s])

            def case(kname, n_s):
                enc, encd, z, dvec, target = batches[n_s]
                wrt = [t.detach().clone().requires_grad_(True) for t in (enc, encd, z)]
                if kname == "mlp_comp_fwd":
                    return (lambda: rk.mlp_comp_fwd(ws, bs, cfg, enc, encd, z, cd),
                            lambda: rk.mlp_comp_fwd_plain(ws, bs, cfg, enc, encd, z, cd),
                            lambda: _library_comp(torch, ws, bs, cfg, enc, encd, z))
                if kname == "mlp_comp_bwd":
                    g_rgb, g_w = cots[n_s]
                    return (lambda: rk.mlp_comp_bwd(ws, bs, cfg, enc, encd, z, g_rgb, g_w, cd),
                            lambda: rk.mlp_comp_bwd_plain(ws, bs, cfg, enc, encd, z, g_rgb, g_w,
                                                          cd),
                            lambda: lib_bwd(n_s, wrt, False))
                return (lambda: rk.mlp_loss_comp(ws, bs, cfg, enc, encd, z, dvec, target, cd),
                        lambda: rk.mlp_loss_comp_plain(ws, bs, cfg, enc, encd, z, dvec, target,
                                                       cd),
                        lambda: lib_bwd(n_s, wrt, True))

            rec = {}
            before = dict(kl.LAUNCHES)
            # Times at the step's shapes: B4 at the coarse pass's S = 64 (and, in
            # bf16, the fine pass's 128), B5 at the fine pass's 128.
            for kname, n_s, mult in (("mlp_comp_fwd", SAMPLES, 1), ("mlp_comp_bwd", SAMPLES, 3),
                                     ("mlp_loss_comp", 2 * SAMPLES, 3)):
                fn, plain, lib = case(kname, n_s)
                enc, encd, z = batches[n_s][:3]
                t_ops = mult * mlp_flops(cfg, RAYS * n_s) / _mlp_peak(name)
                t_bytes = _comp_bytes(cfg, ws, bs, enc, encd, z, kname) / PEAK_BYTES
                ms = _time_ms(torch, fn)
                rec[kname] = {
                    "rays": RAYS, "samples": n_s, "dtype": name,
                    "design": RM_DESIGN[(kname, name)],
                    "ms": ms,
                    "tflops": mult * mlp_flops(cfg, RAYS * n_s) / ms / 1e9,
                    "share_of_bound": 1e3 * max(t_ops, t_bytes) / ms,
                    "plain_ms": _time_ms(torch, plain, reps=2),
                    "library_ms": _time_ms(torch, lib),
                    "library": "composition: addmm chain on the same encodings + composite"
                               + (" + MSE" if kname == "mlp_loss_comp" else ""),
                    "bound_ms": 1e3 * max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "max_abs_err": errs[n_s][kname],
                }
            if cd == torch.bfloat16:
                for kname in ("mlp_comp_fwd", "mlp_comp_bwd"):
                    rec[kname]["ms_fine_pass"] = _time_ms(torch, case(kname, 2 * SAMPLES)[0],
                                                          reps=3)
                    rec[kname]["max_abs_err_s128"] = errs[2 * SAMPLES][kname]
                rec["mlp_loss_comp"]["max_abs_err_s100"] = errs[
                    f"{variant} {name} R={RAYS} S={SAMPLES_RAGGED}"]["mlp_loss_comp"]
                rec["mlp_loss_comp"]["max_abs_err_ragged"] = errs[
                    f"{variant} {name} R={RAYS_RAGGED} S={SAMPLES}"]["mlp_loss_comp"]
                for kname in ("mlp_comp_fwd", "mlp_comp_bwd"):
                    rec[kname]["max_abs_err_s100"] = errs[
                        f"{variant} {name} R={RAYS} S={SAMPLES_RAGGED}"][kname]
                    rec[kname]["max_abs_err_ragged"] = errs[
                        f"{variant} {name} R={RAYS_RAGGED} S={SAMPLES}"][kname]
            else:
                for kname in COMP_SOURCES:
                    rec[kname]["max_abs_err_s100"] = errs[SAMPLES_RAGGED][kname]
                for kname in ("mlp_comp_fwd", "mlp_comp_bwd"):
                    rec[kname]["max_abs_err_ragged_s192"] = errs[
                        f"{variant} {name} R={RAYS_RAGGED} S={SAMPLES_EVAL}"][kname]
                # f32 B4's forward and backward at the fine pass's S = 128, on
                # their own batch.
                r4 = rec["mlp_comp_bwd"]
                for kname in ("mlp_comp_fwd", "mlp_comp_bwd"):
                    rec[kname]["max_abs_err_s128"] = errs[2 * SAMPLES][kname]
                enc4, encd4, z4 = batch4[:3]
                wrt4 = [t.detach().clone().requires_grad_(True) for t in (enc4, encd4, z4)]

                def lib4():
                    outs = _library_comp(torch, leaves, bs, cfg, *wrt4)
                    torch.autograd.grad(outs, leaves + wrt4, cots4)

                _fine_pass_extras(
                    torch, r4,
                    lambda: rk.mlp_comp_bwd(ws, bs, cfg, enc4, encd4, z4, *cots4, cd),
                    lambda: rk.mlp_comp_bwd_plain(ws, bs, cfg, enc4, encd4, z4, *cots4, cd),
                    lib4, 3 * mlp_flops(cfg, RAYS * 2 * SAMPLES), name,
                    _comp_bytes(cfg, ws, bs, enc4, encd4, z4, "mlp_comp_bwd"))
                _fine_pass_extras(
                    torch, rec["mlp_comp_fwd"],
                    lambda: rk.mlp_comp_fwd(ws, bs, cfg, enc4, encd4, z4, cd),
                    lambda: rk.mlp_comp_fwd_plain(ws, bs, cfg, enc4, encd4, z4, cd),
                    lambda: _library_comp(torch, ws, bs, cfg, enc4, encd4, z4),
                    mlp_flops(cfg, RAYS * 2 * SAMPLES), name,
                    _comp_bytes(cfg, ws, bs, enc4, encd4, z4, "mlp_comp_fwd"))
            # B5 at the coarse pass's count too (on the S = 64 batch); in f32
            # beside its plain version and its library composition there.
            fn, plain, lib = case("mlp_loss_comp", SAMPLES)
            r5 = rec["mlp_loss_comp"]
            r5["ms_s64"] = _time_ms(torch, fn)
            r5["tflops_s64"] = 3 * mlp_flops(cfg, RAYS * SAMPLES) / r5["ms_s64"] / 1e9
            if cd == torch.float32:
                r5["share_of_bound_s64"] = r5["bound_ms"] / 2 / r5["ms_s64"]
                r5["plain_ms_s64"] = _time_ms(torch, plain, reps=2)
                r5["library_ms_s64"] = _time_ms(torch, lib)
            kl.LAUNCHES.update(before)  # timing launches are not the main path's
            sass = timings.get("sass", {})
            for (kname, dt), (key, kernel) in SASS_OF.items():
                if dt == name and kname in rec:
                    rec[kname]["ptxas"] = sass.get(key, {}).get(kernel)
            timings["comp_" + name] = rec
            for kname, r in rec.items():
                log(f"time {kname} {name} R={RAYS} S={r['samples']} ({r['design']}): kernel "
                    f"{r['ms']:.3f} ms ({r['tflops']:.1f} TFLOP/s, "
                    f"{100 * r['share_of_bound']:.2f} % of the bound), plain "
                    f"{r['plain_ms']:.3f} ms, library (composition) {r['library_ms']:.3f} ms, "
                    f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                    + (f"; S={2 * SAMPLES}: {r['ms_fine_pass']:.3f} ms"
                       if "ms_fine_pass" in r else "")
                    + (f" ({r['tflops_fine_pass']:.1f} TFLOP/s)"
                       if "tflops_fine_pass" in r and "share_of_bound_fine_pass" not in r else "")
                    + _fine_pass_text(r)
                    + (f"; S={SAMPLES}: {r['ms_s64']:.3f} ms ({r['tflops_s64']:.1f} TFLOP/s"
                       + (f", {100 * r['share_of_bound_s64']:.2f} % of the bound, plain "
                          f"{r['plain_ms_s64']:.3f} ms, library {r['library_ms_s64']:.3f} ms"
                          if "plain_ms_s64" in r else "") + ")" if "ms_s64" in r else "")
                    + (f"; registers, spill bytes, SASS HMMA {r['ptxas']}" if "ptxas" in r
                       else ""))

    # Opaque rays: transmittance underflows to exactly 0; B4's backward and B5
    # stay finite (their compositing VJP is division-free) and agree with
    # their plain versions; in bf16 (the tensor-core kernels) too.
    cfg = mlp.MLPConfig(n_angles=0)
    params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
    params["sigma_out"]["bias"] = params["sigma_out"]["bias"] + 1e6
    ws, bs = rc.flatten_params(params, cfg, torch.float32)
    _comp_checks(torch, rk, cfg, ws, bs, _enc_batch(torch, cfg, torch.float32, 256, SAMPLES, gen),
                 torch.float32, "float32", gen, f"opaque rays float32 R=256 S={SAMPLES}")
    ws, bs = rc.flatten_params(params, cfg, torch.bfloat16)
    _comp_checks(torch, rk, cfg, ws, bs,
                 _enc_batch(torch, cfg, torch.bfloat16, 256, SAMPLES, gen_b5), torch.bfloat16,
                 "bfloat16", gen_b5, f"opaque rays bfloat16 R=256 S={SAMPLES}", b4=False)
    _comp_checks(torch, rk, cfg, ws, bs,
                 _enc_batch(torch, cfg, torch.bfloat16, 256, SAMPLES, gen_b4), torch.bfloat16,
                 "bfloat16", gen_b4, f"opaque rays bfloat16 R=256 S={SAMPLES}", b5=False)


# --------------------------------------------------------------------------- #
# Probe kernel phases (P1-P7)                                                  #
# --------------------------------------------------------------------------- #

_CSRC = "nerf_and_dietnerf_tpu_torch/csrc/"
PROBE_SOURCES = {
    "probe_mma": (_CSRC + "probe_mma.cu", "tools/exp_mxu.py:43"),
    "probe_mlp_epilogue": (_CSRC + "probe_mlp_epilogue.cu", "tools/exp_vpu.py:86"),
    "probe_mlp_chains": (_CSRC + "probe_mlp_chains.cu", "tools/exp_interleave.py:76"),
    "probe_expand_a": (_CSRC + "probe_expand.cu", "tools/exp_expand.py:54"),
    "probe_expand_b": (_CSRC + "probe_expand.cu", "tools/exp_expand.py:70"),
    "probe_expand_c": (_CSRC + "probe_expand.cu", "tools/exp_expand.py:106"),
    "probe_enccost": (_CSRC + "probe_enccost.cu", "tools/exp_enccost.py:93"),
}
# The probes against their plain versions, at the tools' own shapes.
# P1: a layer's f32 sums are taken in another order on the tensor cores, which
# can flip the bf16 rounding of single entries of h by one ulp. Up to depth 8
# the scaled max error is held within one bf16 ulp of the largest entry. The
# chain applies the same random W again and again, so later layers carry a
# flip on into every entry (all rows of h are equal, so the column sums do not
# average it out): at the tools' depth of 32 the tolerance is TOL["bfloat16"],
# as for every other bf16 kernel whose roundings compound through layers.
TOL_MMA = 2.0 ** -8
MMA_TIGHT_DEPTH = 8
# P2: TOL["bfloat16"], as B1. P3: against B1's kernel output, bitwise in f32
# (the sums run in B1's order) or else to TOL["float32"]; bf16 to
# TOL["bfloat16"]. P4, P5: exact. P6: 1e-4 scaled (two f32 products whose sums
# run in another order, and a sine between them).
TOL_EXPAND_C = 1e-4
# P7: `dma`, `repeat`, `pts` to f32 rounding (1e-6 scaled; the same f32
# operations, expected bitwise); `theta` 1e-4 scaled; `sin`: both sides call the
# full-range f32 sine (2 ulp each) on angles that may differ by an f32 ulp of
# the angle, so |diff| <= max|theta| 2^-23 + 4 * 2^-24, with max|theta| read
# from this run's `theta` stage; `enc` adds one bf16 ulp of each of the two
# rounded features it sums (2^-8 max|plain|).
TOL_ENC = {"dma": 1e-6, "repeat": 1e-6, "pts": 1e-6, "theta": 1e-4}
N_PROBE_ROWS = 786432  # the epilogue and chains tools' row count
MXU_CASES = ((2048, 32, 1), (2048, 32, 4), (8192, 32, 1), (512, 32, 4), (2048, 8, 1))


# A full-range f32 `sinf` in FLOPs of the f32 peak: about 20 instructions on its
# usual path (|theta| < 105,615: the quotient by pi/2 and its rounding, three
# FMAs of Cody-Waite reduction, the range test, the choice of polynomial, its
# square and five FMAs, the sign), each in an issue slot that an FMA (2 FLOP at
# the peak) would fill. A count of the library's code, not a measurement.
SINF_FLOPS = 40


def _bound(flops, peak, nbytes):
    """``(bound_ms, bound_by)``: operations over their peak rate against bytes
    over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _probe_record(torch, fn, plain, lib, err, bound, **extra):
    ms = _time_ms(torch, fn)
    return {"ms": ms, "plain_ms": _time_ms(torch, plain, reps=2),
            "library_ms": _time_ms(torch, lib) if lib is not None else None,
            "bound_ms": bound[0], "bound_by": bound[1], "max_abs_err": err, **extra}


def probe_kernel_phases(torch, timings: dict) -> None:
    from nerf_and_dietnerf_tpu_torch.models import mlp
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.ops import probe_kernels_cuda as pk
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
    from nerf_and_dietnerf_tpu_torch.tools import mlp_flops

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    rec = {}
    before = dict(kl.LAUNCHES)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    # P1 ------------------------------------------------------------------- #
    w = randn(256, 256).to(torch.bfloat16)
    errs = {}
    for m, depth, chains in dict.fromkeys(
            ((MXU_CASES[0][0], 1, 1),) + MXU_CASES + tuple((m, 8, c) for m, _, c in MXU_CASES)):
        tol = TOL_MMA if depth <= MMA_TIGHT_DEPTH else TOL["bfloat16"]
        out_k = pk.mxu_chain(w, m, depth, chains)
        torch.cuda.synchronize()
        out_p = pk.mxu_chain_plain(w, m, depth, chains)
        e = _scaled_err(out_k, out_p)
        again = pk.mxu_chain(w, m, depth, chains)
        torch.cuda.synchronize()
        if not (torch.isfinite(out_k).all() and e <= tol and float(out_p.abs().max()) > 0):
            raise AssertionError(f"probe_mma M={m} depth={depth} chains={chains}: scaled err {e} "
                                 f"> {tol} (max |plain| {float(out_p.abs().max())})")
        if not torch.equal(out_k, again):
            raise AssertionError(f"probe_mma M={m} depth={depth} chains={chains}: two runs differ")
        errs[(m, depth, chains)] = float((out_k - out_p).abs().max())
        log(f"kernel check probe_mma M={m} depth={depth} chains={chains}: scaled err {e:.3e} "
            f"(tol {tol:.3e}), max |plain| {float(out_p.abs().max()):.3e}, bitwise equal "
            f"across two runs")
    m, depth, chains = MXU_CASES[0]
    steps = 8

    def lib_chain():  # the same chain as cuBLAS bf16 products and torch elementwise ops
        h = (torch.arange(256, device=DEVICE) * 0.001).to(torch.bfloat16).expand(m, 256)
        for _ in range(depth):
            h = (h @ w) * 0.01
        return h.float().sum(0)

    rec["probe_mma"] = _probe_record(
        torch, lambda: pk.mxu_chain(w, m, depth, chains, steps),
        lambda: pk.mxu_chain_plain(w, m, depth, chains, steps),
        lambda: [lib_chain() for _ in range(steps)], errs[MXU_CASES[0]],
        _bound(2 * m * 256 * 256 * depth * steps, PEAK_FLOPS["bfloat16"],
               w.numel() * 2 + steps * 8 * 256 * 4),
        m=m, depth=depth, chains=chains, steps=steps,
        library="torch.matmul chain in bf16 (cuBLAS), one per step",
        ms_cases={f"{a}:{b}:{c}": _time_ms(torch, lambda: pk.mxu_chain(w, a, b, c, steps))
                  for a, b, c in MXU_CASES})

    # P2, P3 --------------------------------------------------------------- #
    cfg = mlp.MLPConfig()
    params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
    ws, bs = rc.flatten_params(params, cfg, torch.bfloat16)
    n = N_PROBE_ROWS
    x, d = randn(n, cfg.xyz_dim), randn(n, cfg.dir_dim)
    xb, db = x.to(torch.bfloat16), d.to(torch.bfloat16)
    flops = mlp_flops(cfg, n)
    par_bytes = sum(t.numel() * 2 for t in ws) + sum(t.numel() * 4 for t in bs)
    variants = {}
    for variant in ("v1", "v5", "v3"):
        out_k = pk.mlp_fwd_variant(ws, bs, cfg, x, d, variant)
        torch.cuda.synchronize()
        out_p = pk.mlp_fwd_variant_plain(ws, bs, cfg, x, d, variant)
        e = _scaled_err(out_k, out_p)
        if not (torch.isfinite(out_k).all() and e <= TOL["bfloat16"]):
            raise AssertionError(f"probe_mlp_epilogue {variant}: scaled err {e} > "
                                 f"{TOL['bfloat16']}")
        variants[variant] = float((out_k - out_p).abs().max())
        log(f"kernel check probe_mlp_epilogue {variant} bfloat16 rows={n}: scaled err {e:.3e} "
            f"(tol {TOL['bfloat16']})")
        del out_k, out_p
    b1_ms = _time_ms(torch, lambda: rc.mlp_fwd(ws, bs, cfg, xb, db, torch.bfloat16))
    # The epilogue probe reads f32 encodings (and rounds them itself), B1 bf16.
    rec["probe_mlp_epilogue"] = _probe_record(
        torch, lambda: pk.mlp_fwd_variant(ws, bs, cfg, x, d, "v1"),
        lambda: pk.mlp_fwd_variant_plain(ws, bs, cfg, x, d, "v1"),
        lambda: _library_mlp(torch, ws, bs, cfg, xb, db), max(variants.values()),
        _bound(flops, PEAK_FLOPS["bfloat16"],
               n * (cfg.xyz_dim + cfg.dir_dim) * 4 + par_bytes + n * 16),
        rows=n, variant="v1", library="torch.addmm chain in bf16 (v3's function)",
        max_abs_err_by_variant=variants,
        ms_v5=_time_ms(torch, lambda: pk.mlp_fwd_variant(ws, bs, cfg, x, d, "v5")),
        ms_v3=_time_ms(torch, lambda: pk.mlp_fwd_variant(ws, bs, cfg, x, d, "v3")),
        ms_v0_b1=b1_ms, ms_v0_b1_design=MLP_DESIGN["bfloat16"])

    ref = rc.mlp_fwd(ws, bs, cfg, xb, db, torch.bfloat16)
    plain = rc.mlp_fwd_plain(ws, bs, cfg, xb, db, torch.bfloat16)
    ws32, bs32 = rc.flatten_params(params, cfg, torch.float32)
    x32, d32 = x[:N_ROWS].contiguous(), d[:N_ROWS].contiguous()
    ref32 = rc.mlp_fwd(ws32, bs32, cfg, x32, d32, torch.float32)
    # B1 on the tensor cores, its former FMA design (one chain) and the plain
    # f32 version against the forward with the same roundings but f64 sums,
    # on the first N_ROWS rows: which of the three sums least exactly.
    exact = rc._forward_plain(ws, bs, cfg, xb[:N_ROWS], db[:N_ROWS], torch.bfloat16,
                              torch.float64)[0]
    fma = pk.mlp_fwd_chains(ws, bs, cfg, xb, db, 1)
    torch.cuda.synchronize()
    fwd_vs_exact = {k: _row_errs(o[:N_ROWS], exact, TOL["bfloat16"])
                    for k, o in (("b1_mma", ref), ("fma_design", fma), ("plain_f32", plain))}
    del exact, fma
    log(f"kernel check B1 bf16 rows={N_ROWS} against the f64 forward chain (scaled max, "
        f"normwise, share of rows over {TOL['bfloat16']}): {fwd_vs_exact}")
    # f32: B1 on the tensor cores (3xTF32), its former FMA design and the plain
    # f32 version against the f32 chain evaluated in f64.
    exact32 = rc._forward_plain(ws32, bs32, cfg, x32, d32, torch.float32, torch.float64)[0]
    fma32 = pk.mlp_fwd_chains(ws32, bs32, cfg, x32, d32, 1)
    plain32 = rc.mlp_fwd_plain(ws32, bs32, cfg, x32, d32, torch.float32)
    torch.cuda.synchronize()
    f32_vs_exact = {k: _row_errs(o, exact32, TOL["float32"])
                    for k, o in (("b1_tf32", ref32), ("fma_design", fma32), ("plain_f32", plain32))}
    del exact32, fma32, plain32
    ratio = f32_vs_exact["b1_tf32"][1] / max(f32_vs_exact["plain_f32"][1], 1e-30)
    f32_vs_exact["normwise_ratio_b1_tf32_to_plain"] = ratio
    timings["b1_f32_vs_f64_chain"] = f32_vs_exact
    log(f"kernel check B1 f32 rows={N_ROWS} against the f64 forward chain (scaled max, "
        f"normwise, share of rows over {TOL['float32']}): {f32_vs_exact}")
    if not ratio <= F64_FACTOR:
        raise AssertionError(f"B1 f32 is {ratio:.2f}x as far from the f64 chain as the plain f32 "
                             f"version (limit {F64_FACTOR})")
    chain_errs = {}
    for chains in (1, 2):
        out_k = pk.mlp_fwd_chains(ws, bs, cfg, xb, db, chains)
        out32 = pk.mlp_fwd_chains(ws32, bs32, cfg, x32, d32, chains)
        torch.cuda.synchronize()
        e16, e32 = _scaled_err(out_k, ref), _scaled_err(out32, ref32)
        bit16, bit32 = torch.equal(out_k, ref), torch.equal(out32, ref32)
        e_plain = _scaled_err(out_k, plain)
        if not (torch.isfinite(out_k).all() and e16 <= TOL["bfloat16"]
                and (bit32 or e32 <= TOL["float32"]) and e_plain <= TOL["bfloat16"]):
            raise AssertionError(f"probe_mlp_chains chains={chains}: against B1 bf16 {e16}, f32 "
                                 f"{e32}; against the plain version {e_plain}")
        chain_errs[chains] = float((out_k - plain).abs().max())
        log(f"kernel check probe_mlp_chains chains={chains}: against B1's kernel bf16 rows={n} "
            f"scaled err {e16:.3e} (bitwise {bit16}), f32 rows={N_ROWS} {e32:.3e} (bitwise "
            f"{bit32}); against the plain version {e_plain:.3e} (tol {TOL['bfloat16']})")
        del out_k, out32
    try:
        pk.mlp_fwd_chains(ws, bs, cfg, xb, db, 4)
    except ValueError as exc:
        log(f"kernel check probe_mlp_chains chains=4 raises: {exc}")
    else:
        raise AssertionError("probe_mlp_chains took 4 chains of f32 activations")
    del ref, plain, ref32
    rec["probe_mlp_chains"] = _probe_record(
        torch, lambda: pk.mlp_fwd_chains(ws, bs, cfg, xb, db, 2),
        lambda: rc.mlp_fwd_plain(ws, bs, cfg, xb, db, torch.bfloat16),
        lambda: _library_mlp(torch, ws, bs, cfg, xb, db), max(chain_errs.values()),
        _bound(flops, PEAK_FLOPS["bfloat16"],
               n * (cfg.xyz_dim + cfg.dir_dim) * 2 + par_bytes + n * 16),
        rows=n, chains=2, library="torch.addmm chain in bf16",
        ms_chains_1=_time_ms(torch, lambda: pk.mlp_fwd_chains(ws, bs, cfg, xb, db, 1)),
        ms_chains_1_design="B1's former bf16 design: f32 FMA tile, one 64-row chain",
        ms_v0_b1=b1_ms, ms_v0_b1_design=MLP_DESIGN["bfloat16"],
        fwd_vs_f64_chain=fwd_vs_exact)
    del x, d, xb, db, x32, d32

    # P4, P5, P6 ----------------------------------------------------------- #
    r_t, n_s, n_tiles, n_theta, n_enc = 64, 64, 16, 114, 33
    zt, rd8 = randn(n_s, r_t), randn(r_t, 8)
    px, py, pz = (randn(n_tiles * n_s, r_t) for _ in range(3))
    vc, sc, gx = randn(n_tiles * r_t, 3), randn(6, n_theta), randn(n_theta, n_enc)
    for kname, fn, plain_fn, tol in (
            ("probe_expand_a", lambda: pk.expand_a(zt), lambda: pk.expand_a_plain(zt), 0.0),
            ("probe_expand_b", lambda: pk.expand_b(rd8, n_s), lambda: pk.expand_b_plain(rd8, n_s),
             0.0),
            ("probe_expand_c", lambda: pk.expand_c(px, py, pz, vc, sc, gx),
             lambda: pk.expand_c_plain(px, py, pz, vc, sc, gx), TOL_EXPAND_C)):
        out_k = fn()
        torch.cuda.synchronize()
        out_p = plain_fn()
        e = _scaled_err(out_k, out_p)
        if out_k.shape != out_p.shape or not torch.isfinite(out_k).all() or e > tol:
            raise AssertionError(f"{kname}: scaled err {e} > {tol}")
        log(f"kernel check {kname} {tuple(out_k.shape)}: scaled err {e:.3e} (tol {tol})")
        rows = out_k.shape[0]
        if kname == "probe_expand_c":
            fl = rows * (2 * (6 * n_theta + n_theta * n_enc) + SINF_FLOPS * n_theta)
            nbytes = 4 * (3 * px.numel() + vc.numel() + sc.numel() + gx.numel() + out_k.numel())
            lib = plain_fn  # two torch.matmul and torch.sin: the library's form
        else:
            fl = out_k.numel()
            nbytes = 4 * ((zt if kname == "probe_expand_a" else rd8).numel() + out_k.numel())
            lib = plain_fn  # one broadcast add / repeat-and-scale in torch
        rec[kname] = _probe_record(torch, fn, plain_fn, lib, float((out_k - out_p).abs().max()),
                                   _bound(fl, PEAK_FLOPS["float32"], nbytes), rows=rows,
                                   library="the plain version's torch calls")

    # P7 ------------------------------------------------------------------- #
    n_rays = 64 * r_t
    rd = randn(n_rays, 9)
    z = (2.0 + 4.0 * torch.rand((n_rays, n_s), generator=gen, device=DEVICE)).contiguous()
    stage_ms, stage_err, max_theta = {}, {}, None
    for stage in pk.ENC_STAGES:
        out_k = pk.enc_cost(rd, z, stage)
        torch.cuda.synchronize()
        out_p = pk.enc_cost_plain(rd, z, stage)
        diff = float((out_k - out_p).abs().max())
        if stage == "theta":
            max_theta = float(out_p.abs().max())
        if stage in TOL_ENC:
            e, tol = _scaled_err(out_k, out_p), TOL_ENC[stage]
        else:
            e = diff
            tol = max_theta * 2.0 ** -23 + 4 * 2.0 ** -24
            if stage == "enc":
                tol += 2.0 ** -8 * float(out_p.abs().max())
        if out_k.shape != out_p.shape or not torch.isfinite(out_k).all() or e > tol:
            raise AssertionError(f"probe_enccost {stage}: err {e} > {tol}")
        stage_err[stage] = diff
        stage_ms[stage] = _time_ms(torch, lambda: pk.enc_cost(rd, z, stage))
        log(f"kernel check probe_enccost {stage}: "
            f"{'scaled' if stage in TOL_ENC else 'max abs'} err {e:.3e} (tol {tol:.3e}"
            + (f", from max |theta| {max_theta:.1f}" if stage not in TOL_ENC else "")
            + f"), bitwise {torch.equal(out_k, out_p)}; {stage_ms[stage]:.4f} ms")
    rows = n_rays * n_s
    # A row of the `enc` stage: the point under each of its 33 xyz columns (a
    # product and a sum, not contracted), an angle for each of the 54 other
    # columns (a product, and for the cos half a sum) and their 54 sines.
    n_sin = cfg.xyz_dim - 3 + cfg.dir_dim
    enc_flops = 2 * cfg.xyz_dim + n_sin + n_sin // 2 + SINF_FLOPS * n_sin
    rec["probe_enccost"] = _probe_record(
        torch, lambda: pk.enc_cost(rd, z, "enc"), lambda: pk.enc_cost_plain(rd, z, "enc"), None,
        max(stage_err.values()),
        _bound(rows * enc_flops, PEAK_FLOPS["float32"], 4 * (rd.numel() + z.numel() + rows * 4)),
        rays=n_rays, samples=n_s, stage="enc", ms_stages=stage_ms, max_abs_err_by_stage=stage_err)

    kl.LAUNCHES.update(before)  # check and timing launches are not the main path's
    timings["probes"] = rec
    for kname, r in rec.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"time {kname}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib}, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")


# The kernels each tool's main() must launch.
TOOL_KERNELS = {
    "exp_mxu": ("probe_mma",),
    "exp_vpu": ("mlp_fwd", "probe_mlp_epilogue"),
    "exp_interleave": ("mlp_fwd", "probe_mlp_chains"),
    "exp_expand": ("probe_expand_a", "probe_expand_b", "probe_expand_c"),
    "exp_enccost": ("probe_enccost",),
}


# exp_interleave with no arguments: chains 1 and 2 each launch once for the
# comparison with B1, once to warm up and 10 times under the clock; 4 chains
# are refused before any launch.
INTERLEAVE_LAUNCHES = 2 * (10 + 2)


def tools_phase(torch) -> dict:
    """Each probe tool's ``main([])`` on the card, as a user runs it, with the
    launch counts set to 0 just before; returns the probes' launch counts."""
    import importlib

    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl

    launches = {}
    for name, kernels in TOOL_KERNELS.items():
        tool = importlib.import_module(f"nerf_and_dietnerf_tpu_torch.tools.{name}")
        torch.cuda.synchronize()
        kl.reset_launch_counts()
        log(f"--- python -m nerf_and_dietnerf_tpu_torch.tools.{name}")
        rc = tool.main([])
        torch.cuda.synchronize()
        got = dict(kl.LAUNCHES)
        missing = [k for k in kernels if got[k] <= 0]
        if rc != 0 or missing:
            raise AssertionError(f"{name}: exit code {rc}, kernels not launched: {missing}")
        if name == "exp_interleave" and got["probe_mlp_chains"] != INTERLEAVE_LAUNCHES:
            raise AssertionError(f"exp_interleave: {got['probe_mlp_chains']} launches of "
                                 f"probe_mlp_chains, expected {INTERLEAVE_LAUNCHES}")
        log(f"{name}: main-path launches { {k: got[k] for k in kernels} }")
        launches.update({k: got[k] for k in kernels if k.startswith("probe_")})
    return launches


# --------------------------------------------------------------------------- #
# Profiler phase                                                               #
# --------------------------------------------------------------------------- #

PROFILE_STEPS = 4


def _traced_steps(torch, trainer, backend: str):
    """``PROFILE_STEPS`` train steps of ``backend`` (no fusion flags) under
    ``utils.profiling.trace``, after one untraced step: the device's idle
    share of the traced window and the ten device operations with the most
    time. Returns ``(record, config, state, batch, ray tables, device
    operations by time)``."""
    import dataclasses

    from nerf_and_dietnerf_tpu_torch.train import train_step as ts
    from nerf_and_dietnerf_tpu_torch.utils import profiling

    config = dataclasses.replace(trainer.config, backend=backend, fuse_compositing=False,
                                 fuse_fine_loss=False)
    state = ts.init_train_state(torch.Generator().manual_seed(SEED), config, trainer.optimizer,
                                device=DEVICE)
    batch = trainer.run.n_rays_in_batch_train
    tables = tuple(torch.as_tensor(a, device=DEVICE) for a in (
        trainer.data.origins, trainer.data.directions, trainer.data.rgb))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    state, _ = ts.make_epoch_fn(config, trainer.optimizer, 1, batch)(state, gen, *tables)
    torch.cuda.synchronize()

    log_dir = ROOT / "build" / ("chip_smoke_trace" if backend == "pallas"
                                else f"chip_smoke_trace_{backend}")
    epoch_fn = ts.make_epoch_fn(config, trainer.optimizer, PROFILE_STEPS, batch)
    t0 = time.perf_counter()
    with profiling.trace(str(log_dir)) as prof:
        state, metrics = epoch_fn(state, gen, *tables)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError(f"profiled {backend} steps: non-finite loss")
    if not (log_dir / profiling.TRACE_FILE).is_file():
        raise AssertionError("profiling.trace wrote no trace file")

    def device_us(evt):
        return float(getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0)))

    def on_device(evt):
        return str(evt.device_type).endswith("CUDA")

    # Device-side entries only (kernels and memory operations): the host-side
    # operations carry their kernels' time a second time.
    averages = sorted((a for a in prof.key_averages() if on_device(a)), key=device_us,
                      reverse=True)
    (log_dir / "ops.txt").write_text("\n".join(
        f"{device_us(a):14.1f} us  {a.count:6d} calls  {a.key}" for a in averages))
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if on_device(e))
    total_us = sum(device_us(a) for a in averages)
    rec = {"backend": backend, "steps": PROFILE_STEPS, "host_seconds": wall,
           "device_ops": len(spans)}
    if not spans or total_us <= 0:
        raise AssertionError(f"the profiler recorded no device time ({len(spans)} device events, "
                             f"{total_us} us): the idle share cannot be read")
    # The events' clock unit differs between PyTorch versions: scale it so
    # the intervals add up to the averages' device time, in microseconds.
    unit = total_us / sum(end - start for start, end in spans)
    busy, (cur_start, cur_end) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy = (busy + cur_end - cur_start) * unit
    window = (spans[-1][1] - spans[0][0]) * unit
    rec.update(window_ms=window / 1e3, busy_ms=busy / 1e3, idle_share=1.0 - busy / window,
               top=[{"name": a.key[:120], "ms": device_us(a) / 1e3, "calls": a.count}
                    for a in averages[:10]])
    log(f"profile: {PROFILE_STEPS} {backend} steps, traced window {window / 1e3:.3f} ms "
        f"(first to last device operation; host clock {wall * 1e3:.1f} ms with the "
        f"profiler's start and stop), device busy {busy / 1e3:.3f} ms, idle share "
        f"{rec['idle_share']:.4f}, {len(spans)} device operations")
    for a in averages[:10]:
        log(f"profile top: {device_us(a) / 1e3:10.3f} ms {100 * device_us(a) / total_us:5.1f}% "
            f"{a.count:5d} calls  {a.key[:120]}")
    return rec, config, state, batch, tables, averages


def profile_phase(torch, timings: dict, trainer) -> None:
    """Traced steps (:func:`_traced_steps`) of backend "pallas_rm", then of
    "pallas"; then one "pallas" step twice from one state, which must give
    bitwise-equal parameters with no kernel that adds with atomics, and once
    more under ``torch.use_deterministic_algorithms(warn_only=True)`` to name
    the torch operations on the path that have no deterministic
    implementation."""
    import warnings

    from nerf_and_dietnerf_tpu_torch.train import train_step as ts

    timings["profile_pallas_rm"] = _traced_steps(torch, trainer, "pallas_rm")[0]
    rec, config, state, batch, tables, averages = _traced_steps(torch, trainer, "pallas")

    # One step twice from the same state and seed, without
    # torch.use_deterministic_algorithms: the new parameters must be bitwise
    # equal (no kernel of the step adds with atomics). Then once more with
    # PyTorch asked to warn about operations that have no deterministic
    # implementation.
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

    step_fn = ts.make_epoch_fn(config, trainer.optimizer, 1, batch)

    def one_step():
        out, m = step_fn(state, torch.Generator(device=DEVICE).manual_seed(SEED + 7), *tables)
        torch.cuda.synchronize()
        return float(m["loss"]), tree_leaves(out.params)

    def same(a, b):
        return a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))

    first, second = one_step(), one_step()
    rec["step_bitwise_reproducible"] = same(first, second)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            det_first, det_second = one_step(), one_step()
    finally:
        torch.use_deterministic_algorithms(False)
    rec["step_bitwise_reproducible_deterministic_mode"] = same(det_first, det_second)
    names = sorted({str(w.message).split(" does not have")[0][:160] for w in caught
                    if "deterministic" in str(w.message).lower()})
    rec["nondeterministic_ops"] = names
    # Kernels of the traced steps that add with atomics: their sums depend on
    # the order the hardware happens to take.
    rec["atomic_add_kernels"] = [a.key[:160] for a in averages if "ReduceAdd" in a.key]
    log(f"profile: one pallas step twice from the same state and seed: losses {first[0]!r} and "
        f"{second[0]!r}, loss and new parameters bitwise equal: "
        f"{rec['step_bitwise_reproducible']}; with torch.use_deterministic_algorithms: "
        f"{rec['step_bitwise_reproducible_deterministic_mode']}, operations it reports as "
        f"having no deterministic implementation: {names if names else 'none'}; kernels of "
        f"the traced steps that add with atomics: {rec['atomic_add_kernels']}")
    if not rec["step_bitwise_reproducible"] or rec["atomic_add_kernels"]:
        raise AssertionError("a pallas step is not bitwise reproducible, or kernels of the step "
                             f"add with atomics: {rec['atomic_add_kernels']}")
    timings["profile"] = rec


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


# The kernels each training path must launch.
MAIN_PATHS = {
    "pallas": ("mlp_fwd", "mlp_bwd"),
    "pallas_rm": ("raymarch_fwd", "raymarch_bwd"),
    "pallas_rm_fused": ("raymarch_comp_fwd", "raymarch_comp_bwd"),
    "pallas_fused": ("mlp_comp_fwd", "mlp_comp_bwd"),
    "pallas_fused_loss": ("mlp_comp_fwd", "mlp_comp_bwd", "mlp_loss_comp"),
    "pallas_f32": ("mlp_fwd", "mlp_bwd"),
    "pallas_rm_f32": ("raymarch_fwd", "raymarch_bwd"),
    "pallas_rm_fused_f32": ("raymarch_comp_fwd", "raymarch_comp_bwd"),
    "pallas_fused_f32": ("mlp_comp_fwd", "mlp_comp_bwd"),
    "pallas_fused_loss_f32": ("mlp_comp_fwd", "mlp_comp_bwd", "mlp_loss_comp"),
}
# The paths driven through the Trainer: backend and compute type. "pallas_f32"
# and "pallas_rm_f32" are the steps of configs with compute_dtype float32
# (f32 B1 and B2; f32 B6 forward and backward).
TRAINER_PATHS = {"pallas": ("pallas", "bfloat16"), "pallas_rm": ("pallas_rm", "bfloat16"),
                 "pallas_f32": ("pallas", "float32"), "pallas_rm_f32": ("pallas_rm", "float32")}
# The model-config changes of the paths driven through train_step.make_epoch_fn
# (no YAML key sets the two flags); each "_f32" path is its bf16 twin in a
# compute_dtype float32 config (the f32 kernels of B7, B4 and B5).
FUSED_PATHS = {
    "pallas_rm_fused": dict(backend="pallas_rm", fuse_compositing=True),
    "pallas_fused": dict(backend="pallas", fuse_compositing=True),
    "pallas_fused_loss": dict(backend="pallas", fuse_compositing=True, fuse_fine_loss=True),
}
FUSED_PATHS.update({f"{path}_f32": dict(kw, compute_dtype="float32")
                    for path, kw in list(FUSED_PATHS.items())})


def _flagship_run(backend: str, compute_dtype: str = "bfloat16"):
    from nerf_and_dietnerf_tpu_torch.utils.config import RunConfig

    return RunConfig(
        hidden_layer_dim=256, last_hidden_layer_dim=128, n_pos_enc_dim_xyz=5,
        n_pos_enc_view_dir=4, n_angles_for_model=2, n_rays_in_batch_train=4096,
        n_render_samples_coarse=64, n_render_samples_fine=128, n_epochs=2,
        test_img_idx=0, idx_train_img_to_plot=1, compute_dtype=compute_dtype,
        backend=backend, init_seed=SEED,
    )


def _check_path(path: str, losses, launches: dict) -> None:
    log(f"{path}: main-path launches {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{path}: non-finite training loss {losses}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"{path}: loss did not fall: {losses[0]} -> {losses[1]}")
    missing = [k for k in MAIN_PATHS[path] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{path}: kernels not launched on the main path: {missing}")


def train_phase(torch, timings: dict, path: str):
    """Two epochs of the ``Trainer`` on the path ``path`` (a key of
    ``TRAINER_PATHS``: steps and eval renders) with the launch counts set to
    0 just before; returns ``(launches, trainer)``."""
    import numpy as np

    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.train.trainer import Trainer

    backend, compute_dtype = TRAINER_PATHS[path]
    ds = synthetic_scene()
    trainer = Trainer(_flagship_run(backend, compute_dtype), ds,
                      ROOT / "build" / f"chip_smoke_{path}", device=DEVICE)
    steps = trainer.data.batches_per_epoch
    log(f"train {path} ({backend}, {compute_dtype} step): {len(trainer.train_indices)} views "
        f"of {ds.height}x{ds.width}, {trainer.data.n_rays} rays, {steps} steps per epoch")

    torch.cuda.synchronize()
    kl.reset_launch_counts()
    stats = [trainer.train_epoch(epoch) for epoch in (1, 2)]
    torch.cuda.synchronize()
    launches = dict(kl.LAUNCHES)
    for s in stats:
        log(f"{path} epoch {s.epoch}: loss={s.loss:.6f} psnr_train={s.psnr_train:.3f} "
            f"psnr_test={s.psnr_test:.3f} {s.rays_per_sec:.0f} rays/s ({s.seconds:.3f} s)")
    _check_path(path, [s.loss for s in stats], launches)

    if path == "pallas":
        trainer.ckpt.save(2, trainer.state)
        restored = trainer.ckpt.restore()
        from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

        a, b = tree_leaves(trainer.state.params), tree_leaves(restored.params)
        if trainer.ckpt.latest_step() != 2 or len(a) != len(b) or not all(
                torch.equal(x, y) for x, y in zip(a, b)) or restored.step != trainer.state.step:
            raise AssertionError("checkpoint restore does not match the saved state")
        log(f"checkpoint: saved and restored step {restored.step} ({len(a)} tensors equal)")

    # Step and eval-frame times (the epoch's seconds include its first step).
    # The f32 eval renders' own launches of the path's forward kernel count
    # too: under "pallas" they are f32 B1's.
    fwd_kernel = MAIN_PATHS[path][0]
    before = kl.LAUNCHES[fwd_kernel]
    t0 = time.perf_counter()
    trainer._eval_render_cache = None
    renders = trainer.render_eval_images(3)
    torch.cuda.synchronize()
    frame_s = (time.perf_counter() - t0) / len(renders)
    eval_launches = kl.LAUNCHES[fwd_kernel] - before
    kl.LAUNCHES[fwd_kernel] = before
    for name, (_, rgb) in renders.items():
        if rgb.shape != (ds.height, ds.width, 3) or not np.isfinite(rgb).all():
            raise AssertionError(f"bad eval render {name}: {rgb.shape}")
    log(f"{path}: two f32 eval frames of {ds.height}x{ds.width}, {1e3 * frame_s:.3f} ms a "
        f"frame, {eval_launches} launches of {fwd_kernel}")
    if eval_launches <= 0:
        raise AssertionError(f"{path}: the f32 eval renders launched no {fwd_kernel}")
    timings["train_" + path] = {
        "ms_per_step": 1e3 * stats[1].seconds / steps,
        "rays_per_sec": stats[1].rays_per_sec,
        "ms_per_eval_frame": 1e3 * frame_s,
        "eval_frame_launches": eval_launches,
        "loss": [s.loss for s in stats],
        "psnr_test": [s.psnr_test for s in stats],
    }
    return launches, trainer


# The held-out patch rendered through models/nerf.render in f32 on the card
# and on the CPU: rays on a side, and the largest pixel difference allowed
# (both sides compute the same f32 chain; f32 B1 holds 1e-4 of the largest
# raw output against its plain version, and compositing does not enlarge it).
EVAL_PATCH = 32
TOL_PATCH = 1e-4


def eval_patch_phase(torch, timings: dict, trainer) -> None:
    """A 32x32-ray patch from the middle of the held-out view, rendered as the
    eval renders render (``nerf.render`` with the trainer's f32 eval config,
    coarse + fine), on the card (f32 B1) and on the CPU (the plain path),
    from the same trained weights and the same injected ``strat_u`` /
    ``fine_u`` draws. Fails if a pixel differs by more than ``TOL_PATCH``;
    records both PSNRs against the view's pixels."""
    import numpy as np

    from nerf_and_dietnerf_tpu_torch.core import cameras, rendering
    from nerf_and_dietnerf_tpu_torch.models import nerf
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_map

    ds, cfg, idx = trainer.dataset, trainer.eval_config, trainer.run.test_img_idx
    h0, w0 = (ds.height - EVAL_PATCH) // 2, (ds.width - EVAL_PATCH) // 2
    orig, dirs = cameras.rays_for_image(ds.height, ds.width, ds.field_of_view,
                                        torch.as_tensor(ds.camera_poses[idx], device=DEVICE))
    patch = (slice(h0, h0 + EVAL_PATCH), slice(w0, w0 + EVAL_PATCH))
    orig, dirs = (t.reshape(ds.height, ds.width, -1)[patch].reshape(EVAL_PATCH ** 2, -1)
                  .contiguous() for t in (orig, dirs))
    target = torch.as_tensor(ds.images[idx][patch]).reshape(-1, 3)
    rng = np.random.default_rng(SEED)
    n = EVAL_PATCH ** 2
    draws = {"strat_u": rng.uniform(size=(n, cfg.n_samples_coarse)).astype(np.float32),
             "fine_u": np.sort(rng.uniform(size=(n, cfg.n_samples_fine)), -1).astype(np.float32)}
    out = {}
    for dev in (DEVICE, "cpu"):
        params = tree_map(lambda t, d=dev: t.detach().to(d), trainer.state.params)
        before = kl.LAUNCHES["mlp_fwd"]
        result, _ = nerf.render(params, cfg, None, orig.to(dev), dirs.to(dev), diagnostics=False,
                                draws={k: torch.as_tensor(v, device=dev) for k, v in draws.items()})
        out[dev] = result.rgb.detach().float().cpu()
        launched = kl.LAUNCHES["mlp_fwd"] - before
        kl.LAUNCHES["mlp_fwd"] = before
        if (dev == DEVICE) != (launched > 0):
            raise AssertionError(f"eval patch on {dev}: {launched} launches of mlp_fwd")
    diff = float((out[DEVICE] - out["cpu"]).abs().max())
    psnr = {dev: float(rendering.psnr(target, rgb)) for dev, rgb in out.items()}
    rec = {"rays": n, "max_abs_pixel_diff": diff, "tol": TOL_PATCH, "psnr_card": psnr[DEVICE],
           "psnr_cpu": psnr["cpu"]}
    timings["eval_patch"] = rec
    log(f"eval patch {EVAL_PATCH}x{EVAL_PATCH} of view {idx} (f32, pallas): card vs CPU max "
        f"|pixel diff| {diff:.3e} (tol {TOL_PATCH}), PSNR card {psnr[DEVICE]:.4f} dB, CPU "
        f"{psnr['cpu']:.4f} dB")
    if not (math.isfinite(diff) and diff <= TOL_PATCH):
        raise AssertionError(f"eval patch: card and CPU renders differ by {diff} > {TOL_PATCH}")


def fused_phase(torch, timings: dict, trainer, path: str) -> dict:
    """Two epochs of ``train_step.make_epoch_fn`` under the model config of
    ``FUSED_PATHS[path]``, from a fresh state on the trainer's ray table, with
    the launch counts set to 0 just before; prints ms a step and rays a
    second."""
    import dataclasses

    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.train import train_step as ts

    change = dict(FUSED_PATHS[path])
    if "compute_dtype" in change:
        change["compute_dtype"] = getattr(torch, change["compute_dtype"])
    config = dataclasses.replace(trainer.config, **change)
    state = ts.init_train_state(torch.Generator().manual_seed(SEED), config, trainer.optimizer,
                                device=DEVICE)
    steps, batch = trainer.data.batches_per_epoch, trainer.run.n_rays_in_batch_train
    epoch_fn = ts.make_epoch_fn(config, trainer.optimizer, steps, batch)
    tables = tuple(torch.as_tensor(a, device=DEVICE) for a in (
        trainer.data.origins, trainer.data.directions, trainer.data.rgb))
    torch.cuda.synchronize()
    kl.reset_launch_counts()
    losses, seconds = [], []
    for epoch in (1, 2):
        gen = torch.Generator(device=DEVICE).manual_seed(epoch)
        t0 = time.perf_counter()
        state, metrics = epoch_fn(state, gen, *tables)
        losses.append(float(metrics["loss"]))
        seconds.append(time.perf_counter() - t0)
        log(f"{path} epoch {epoch}: loss={losses[-1]:.6f} ({seconds[-1]:.3f} s)")
    torch.cuda.synchronize()
    launches = dict(kl.LAUNCHES)
    _check_path(path, losses, launches)
    timings["train_" + path] = {
        "ms_per_step": 1e3 * seconds[1] / steps,
        "rays_per_sec": steps * batch / seconds[1],
        "loss": losses,
    }
    log(f"{path} ({config.backend}, {config.compute_dtype} step): "
        f"{timings['train_' + path]['ms_per_step']:.3f} ms a step, "
        f"{timings['train_' + path]['rays_per_sec']:.0f} rays/s (epoch 2)")
    return launches


# The kernels whose products must run on the tensor cores, and the SASS
# instruction they must hold: bf16 B1/B2/B4-B7, the f32 backwards of B2 and
# B4-B7 and the f32 forwards of B4 and B7 on `mma.sync` (HMMA; tf32 for the
# f32 ones), f32 B1/B6 forward on `wgmma` (HGMMA).
MMA_KERNELS = {"mlp_fwd": {"mlp_fwd_mma_kernel": "HMMA", "mlp_fwd_tf32_kernel": "HGMMA"},
               "mlp_bwd": {"mlp_bwd_mma_kernel": "HMMA", "mlp_bwd_t32_kernel": "HMMA"},
               "raymarch_fwd": {"rm_fwd_mma_kernel": "HMMA", "rm_fwd_tf32_kernel": "HGMMA"},
               "raymarch_bwd": {"rm_bwd_mma_kernel": "HMMA", "rm_bwd_t32_kernel": "HMMA"},
               "raymarch_comp_fwd": {"rm_comp_fwd_mma_kernel": "HMMA",
                                     "rm_comp_fwd_t32_kernel": "HMMA"},
               "raymarch_comp_bwd": {"rm_comp_bwd_mma_kernel": "HMMA",
                                     "rm_comp_bwd_t32_kernel": "HMMA"},
               "mlp_loss_comp": {"mlp_loss_comp_mma_kernel": "HMMA",
                                 "mlp_loss_comp_t32_kernel": "HMMA"},
               "mlp_comp_fwd": {"mlp_comp_fwd_mma_kernel": "HMMA",
                                "mlp_comp_fwd_t32_kernel": "HMMA"},
               "mlp_comp_bwd": {"mlp_comp_bwd_mma_kernel": "HMMA",
                                "mlp_comp_bwd_t32_kernel": "HMMA"}}
# The kernels on the tensor-core tiles whose registers, spills and SASS
# counts the run prints side by side: the bf16 backwards (B2, B6, B7, B5, B4),
# the forwards of the ray-group loop (B4, B7) and the f32 backwards (B2, B7,
# B5, B6, B4) and forwards (B4, B7) on the 3xTF32 tile.
BWD_MMA_KERNELS = {"mlp_bwd": "mlp_bwd_mma_kernel", "raymarch_bwd": "rm_bwd_mma_kernel",
                   "raymarch_comp_bwd": "rm_comp_bwd_mma_kernel",
                   "mlp_loss_comp": "mlp_loss_comp_mma_kernel",
                   "mlp_comp_bwd": "mlp_comp_bwd_mma_kernel"}
FWD_MMA_KERNELS = {"mlp_comp_fwd": "mlp_comp_fwd_mma_kernel",
                   "raymarch_comp_fwd": "rm_comp_fwd_mma_kernel"}
T32_MMA_KERNELS = {"mlp_bwd": "mlp_bwd_t32_kernel", "raymarch_comp_bwd": "rm_comp_bwd_t32_kernel",
                   "mlp_loss_comp": "mlp_loss_comp_t32_kernel",
                   "raymarch_bwd": "rm_bwd_t32_kernel", "mlp_comp_bwd": "mlp_comp_bwd_t32_kernel"}
T32_FWD_KERNELS = {"mlp_comp_fwd": "mlp_comp_fwd_t32_kernel",
                   "raymarch_comp_fwd": "rm_comp_fwd_t32_kernel"}
REPORTED = (("backwards", BWD_MMA_KERNELS), ("forwards", FWD_MMA_KERNELS),
            ("f32_backwards", T32_MMA_KERNELS), ("f32_forwards", T32_FWD_KERNELS))
# The kernel instances whose timing records carry their registers, spills and
# HMMA count: (library, compute type) -> (REPORTED key, kernel).
SASS_OF = {("raymarch_comp_fwd", "bfloat16"): ("forwards", "rm_comp_fwd_mma_kernel"),
           ("mlp_comp_fwd", "bfloat16"): ("forwards", "mlp_comp_fwd_mma_kernel"),
           **{(lib, "float32"): ("f32_forwards", k) for lib, k in T32_FWD_KERNELS.items()},
           **{(lib, "float32"): ("f32_backwards", k) for lib, k in T32_MMA_KERNELS.items()}}


def _ptxas_counts(build_log: str) -> dict:
    """The registers and spill bytes ``-Xptxas -v`` gives each kernel of
    ``REPORTED`` (its own lines, not those of a device function the compiler
    kept out of line); prints the ptxas lines of ``MMA_KERNELS``'s libraries."""
    import re

    block, entry, props, ptxas = None, None, None, {}
    counted = {(lib, k) for _, kernels in REPORTED for lib, k in kernels.items()}
    for line in build_log.splitlines():
        if line.startswith("--- "):
            block = line[4:].strip()
        elif block in MMA_KERNELS and "ptxas" in line:
            log(f"  ptxas {block}: {line.strip()}")
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            continue
        if "Function properties for " in line:
            # the lines after it are this function's (a device function the
            # compiler kept out of line has lines of its own)
            props = line.split("Function properties for ")[1].strip()
            continue
        for lib, k in counted:
            if block == lib and k in (entry or "") and props == entry:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    ptxas.setdefault(k, {}).update(spill_stores=int(m.group(1)),
                                                   spill_loads=int(m.group(2)))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    ptxas.setdefault(k, {})["registers"] = int(m.group(1))
    return ptxas


def tensor_core_report(kl, build_log: str) -> dict:
    """What the compiler made of B1, B2 and B6: their whole ``-Xptxas -v`` output
    (registers, shared memory, spills of each kernel, and any note that
    `wgmma` products were serialized), then, where the toolkit has
    ``cuobjdump``, the tensor-core (HMMA / HGMMA) and f32 FMA instructions of
    every kernel in their SASS. Fails if a kernel of ``MMA_KERNELS`` lacks
    its tensor-core instruction."""
    import re
    import shutil

    ptxas = _ptxas_counts(build_log)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("SASS: cuobjdump not available, tensor-core instructions not counted")
        return {"cuobjdump": "not available"}
    report = {}
    for lib, kernels in MMA_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(kl.lib_path(lib))], check=True,
                              capture_output=True, text=True).stdout
        counts = {}
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            fname = part.split("\n", 1)[0].strip()
            counts[fname] = {op: len(re.findall(rf"\b{op}\b", part))
                             for op in ("HMMA", "HGMMA", "FFMA")}
        report[lib] = counts
        for f, c in counts.items():
            log(f"SASS {lib} {f[:90]}: {c}")
        for kernel, op in kernels.items():
            mma = {f: c for f, c in counts.items() if kernel in f}
            if not mma or not all(c[op] > 0 for c in mma.values()):
                raise AssertionError(f"{lib}: no {op} instruction in {kernel}: {mma}")
    for key, kernels in REPORTED:
        report[key] = {}
        for lib, kernel in kernels.items():
            sass = next(c for f, c in report[lib].items() if kernel in f)
            report[key][kernel] = {**ptxas.get(kernel, {}), "HMMA": sass["HMMA"]}
        log(f"{key} on the tensor-core tiles (registers, spill bytes, SASS HMMA): "
            f"{report[key]}")
    return report


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
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl

    t_start = time.perf_counter()
    card = gpu_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    build = kl.build_kernels()
    log(f"build: {build['seconds']:.1f} s")
    for line in build["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            log("  " + line.strip())
    timings: dict = {"sass": tensor_core_report(kl, build["log"])}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernel_phases(torch, timings)
    raymarch_kernel_phases(torch, timings)
    comp_kernel_phases(torch, timings)
    probe_kernel_phases(torch, timings)
    log(f"kernel phases done at {time.perf_counter() - t_start:.0f} s")
    # Each kernel's launch count is that of the first path that must launch it.
    launches: dict = {}
    for backend in ("pallas", "pallas_rm"):
        got, trainer = train_phase(torch, timings, backend)
        launches.update({k: got[k] for k in MAIN_PATHS[backend]})
        if backend == "pallas":
            eval_patch_phase(torch, timings, trainer)
    for path in FUSED_PATHS:
        got = fused_phase(torch, timings, trainer, path)
        for k in MAIN_PATHS[path]:
            launches.setdefault(k, got[k])
    # The steps of compute_dtype float32 configs: f32 B1 and B2; f32 B6.
    train_phase(torch, timings, "pallas_f32")
    train_phase(torch, timings, "pallas_rm_f32")
    log(f"training paths done at {time.perf_counter() - t_start:.0f} s")
    launches.update(tools_phase(torch))
    profile_phase(torch, timings, trainer)
    log(f"tools and profile done at {time.perf_counter() - t_start:.0f} s")

    for path in MAIN_PATHS:
        t = timings["train_" + path]
        log(f"[{card}] {path} train step {t['ms_per_step']:.3f} ms ({t['rays_per_sec']:.0f} "
            f"rays/s)" + (f", eval frame {t['ms_per_eval_frame']:.3f} ms"
                          if "ms_per_eval_frame" in t else ""))
    r = timings["float32"]["mlp_fwd"]
    log(f"[{card}] mlp_fwd float32 ({r['design']}): {r['ms']:.3f} ms, {FMA_DESIGN} "
        f"{r['fma_design_ms']:.3f} ms, library_ms {r['library_ms']:.3f}, plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
        f"({100 * r['share_of_bound']:.1f} %); against the f64 chain "
        f"{timings['b1_f32_vs_f64_chain']['normwise_ratio_b1_tf32_to_plain']:.3f}x the plain "
        f"f32 version's normwise distance")
    for key in ("bfloat16", "float32", "rm_bfloat16", "rm_float32", "comp_bfloat16",
                "comp_float32"):
        for kname, r in timings[key].items():
            log(f"[{card}] {kname} {r['dtype']}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"library_ms {r['library_ms']:.3f}, bound {r['bound_ms']:.4f} ms")
    sources = {"mlp_fwd": ("nerf_and_dietnerf_tpu_torch/csrc/mlp_fwd.cu",
                           "nerf_and_dietnerf_tpu/ops/raymarch_pallas.py:236"),
               "mlp_bwd": ("nerf_and_dietnerf_tpu_torch/csrc/mlp_bwd.cu",
                           "nerf_and_dietnerf_tpu/ops/raymarch_pallas.py:412"),
               **RM_SOURCES, **COMP_SOURCES}
    kernels = []
    for kname, (src, replaces) in sources.items():
        prefix = "rm_" if kname in RM_SOURCES else "comp_" if kname in COMP_SOURCES else ""
        r = timings[prefix + "bfloat16"][kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dtype": "bfloat16",
            **{k: v for k, v in r.items() if k in (
                "rows", "rays", "samples", "ms_fine_pass", "max_abs_err_s128", "library", "design",
                "tflops", "share_of_bound", "tflops_fine_pass", "max_abs_err_ragged", "ms_s64",
                "max_abs_err_s100", "ptxas")},
            "f32": timings[prefix + "float32"][kname],
        })
    for kname, (src, replaces) in PROBE_SOURCES.items():
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[kname], **timings["probes"][kname]})
        r = timings["probes"][kname]
        log(f"[{card}] {kname}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library_ms "
            f"{r['library_ms']}, bound {r['bound_ms']:.5f} ms")
    train = {path: timings["train_" + path] for path in MAIN_PATHS}
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "train": train, "profile": timings["profile"],
                      "profile_pallas_rm": timings["profile_pallas_rm"],
                      "sass": timings["sass"], "b2_vs_f64_chain": timings["b2_vs_f64_chain"],
                      "b1_f32_vs_f64_chain": timings["b1_f32_vs_f64_chain"],
                      "b6_vs_f64_chain": timings["b6_vs_f64_chain"],
                      "b7_vs_f64_chain": timings["b7_vs_f64_chain"],
                      "b5_vs_f64_chain": timings["b5_vs_f64_chain"],
                      "b4_vs_f64_chain": timings["b4_vs_f64_chain"],
                      "b7_f32_steps": timings["b7_f32_steps"],
                      "eval_patch": timings["eval_patch"]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
