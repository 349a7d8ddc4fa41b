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
B1 in both types and the plain
version against the forward chain evaluated in f64 (f32 B1 fails if it is more
than ``F64_FACTOR`` times as far as the plain version, bf16 B1 if more than
``F64_FACTOR_BF16`` times), B6 and its plain
version likewise (raw output, dz and dparams at S = 64 and, in bf16, 128; JSON
``b6_vs_f64_chain``; bf16 held to ``F64_FACTOR_BF16``), B7
(pixels, dz, dparams; ``b7_vs_f64_chain``; in f32 also step by step,
``b7_f32_steps``, ``tools/comp_f32_steps.py``), B5 (loss, dz, dparams;
``b5_vs_f64_chain``) and B4 (pixels, weights, denc, dencd, dz, dparams;
``b4_vs_f64_chain``) at S = 64 and 128, and B2 in both types
(dx / dd; ``b2_vs_f64_chain``; bf16 held to ``F64_FACTOR_BF16``), holds the
bf16 B7 forward and backward, B5 and B4 (forward and backward, on the
tensor cores) also at S = 100, at 4093 rays and on opaque rays, and the f32
backwards of B7 and B4 and f32 B5 (3xTF32 on the tensor cores) at S = 64, 100
and 128 and on opaque rays, each against its plain version with f64 sums on the kernel's
side of the compositing's kink (``KINK_SHARE``) and, for the bf16 backwards,
on the leaky slopes the kernel took (``f64_branches``: the recording builds
of ``csrc/branch_sink.cuh``, built with the others into ``build/branches/``,
whose outputs must be bitwise the kernel's and whose masks must pass
``raymarch_cuda.branch_guard``), checks that bf16 B4's and
B7's backwards composite bitwise the raw values their forwards composited,
prints the registers, spills and HMMA counts of the five bf16 backwards (B2,
B6, B7, B5, B4), of B4's and B7's forwards and of the f32 backwards on the
3xTF32 tile (B2, B7, B5, B6, B4), times f32
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
Then the quality phase (``quality_phase``) trains eight paths through the
``Trainer`` for ``QUALITY_EPOCHS`` epochs each on ``quality_scene`` (48 views
of a textured unit sphere at 128x128, 6 held out: 168 steps an epoch),
"xla", "pallas", "pallas_rm" and the three fused paths ("pallas_rm" +
``fuse_compositing``: B7; "pallas" + ``fuse_compositing``: B4; "pallas" +
both flags: B4, B5) in bf16 and "xla" and "pallas" in f32, all from the
same initial weights, permutations and uniforms (their digests must agree,
and each first step must draw just what ``nerf.draw_training_uniforms``
draws); each path's held-out PSNR (the held-out views' pooled MSE,
deterministic f32 renders) must rise by ``QUALITY_RISE_DB`` from the initial
weights, each kernel path must end at most ``QUALITY_WINDOW_DB`` below its
plain "xla" twin of the same type, and its launches must be exact; B1 and
B2 are then held against their plain versions on the trained "pallas"
field's rays (``_trained_field_checks``). Its record is the JSON line
``{"quality": ...}`` printed before the card's line.
Then the runner phase drives the normal entry point,
``nerf_and_dietnerf_tpu_torch.main.main([cfg])``: a config of the "pallas"
path's widths with every task on, 2 epochs and 4 video frames a second,
through script-only stand-ins for what the card's machine cannot import
(``runner_phase``, ``_runner_stand_ins``: the config and the scene built in
Python, the video and plot writers recording their arrays, the ``.h5`` files
held with ``torch.save`` under their real names; the package keeps its real
writers). Each task runs with the launch counts set to 0 just before it and
must launch exactly its kernels (the training bf16 B1 and B2 and f32 B1 in
its eval renders, each rendered frame two f32 B1 launches); every frame is
checked (shape, finite, in [0, 1], depth frames equalised), a 32x32 patch of
the first left-to-right pose must agree card vs CPU to 1e-4 from the trained
weights, and the resume drill (4 epochs straight through ``main`` against 2,
then a second ``main`` resuming the directory to epoch 4) must give bitwise
equal parameters and PSNR histories.
Then two DietNeRF phases (``diet_phase``) train two epochs each at the
flagship DietNeRF config's widths (the "pallas" path's NeRF, the full
ViT-B/32, the 150x150 consistency render at 55 + 55 samples in 2,500-ray
chunks, K = 13, weight 0.1, 95 % of the steps) on the same scene, with the
launch counts set to 0 just before: "pallas" through
``main.main([cfg, "--vit-weights", npz])`` (the runner's stand-ins, the
training task alone; ``npz`` a ViT-B/32 file of random weights with its
geometry, written by the port's ``vit.save_npz``) and "pallas_rm" through
``DietTrainer.fit`` with the random embedder. Each must launch exactly its
kernels (``_check_diet_run``: 272 bf16 and 8 f32 forwards, 200 backwards),
take its diet steps at counters 13, 26, 39 and 52 with consistency losses
in [0, 0.1], and write each epoch's ``.h5``; its first diet step is held on
the card (``_diet_held_step``: the consistency loss and gradient in f32
through the kernels and their plain versions against the f64 chain, each
resampling from the held run's CDFs, with the f32 ViT pooled over
``DIET_DRAWS`` draws, and the
checkpointed render's gradient against the one without checkpoint), and the
plain and diet steps, the ViT, the consistency render, the target
embeddings and the diet step's peak memory are timed.
Then the distributed phase (``distributed_phase``, ``parallel/``): two ranks
spawned in one gloo group, both on the one card, first run a gloo
``all_reduce`` and ``broadcast`` of the card's tensors; then each trains one
epoch of the "pallas" flagship config on its 2,048 rows of every 4,096-ray
batch through the port's worker (``tools/multiprocess_worker.py``), with two
f32 eval frames tile-sharded, and one epoch of DietNeRF (diet steps at
counters 13 and 26); the ranks' parameters must be bitwise equal, their
launches exactly 64 bf16 B1 and 64 B2 and 4 f32 B1 a rank, their eval frames
bitwise this process's single-device frames of rank 0's parameters, their
reduced f32 gradient within ``TOL_DIST_GRAD`` of the one-process gradient
from the same state at each of the first ``DIST_HELD_STEPS`` steps, and
their first step's loss within ``TOL_DIST_STEP_LOSS`` of a one-process
epoch's (the epoch's mean loss printed); a
process of its own then runs ``main.main([cfg, "--distributed"])`` at a world
of one (NCCL), whose ``.h5`` must be bitwise the plain run's, and
``mesh.all_reduce_mean_`` on that one-rank NCCL group. The ranks share one
card: their times (ms a step a rank, the gloo all-reduce of the gradient)
say nothing of scaling across cards.
Then the parity phase (``parity_phase``, ``tools/parity_gpu.py`` at the
flagship shape): the fixed-z objective's loss and every gradient leaf of six
kernel paths ("pallas": B1, B2; + ``fuse_fine_loss``: B1 and B2 coarse, B5
fine; + ``fuse_compositing``: B4; + both: B4, B5; "pallas_rm": B6;
"pallas_rm" + ``fuse_compositing``: B7), each in f32 and bf16, against the
f64 chain of each path's plain version on the card, under the JAX tool's
two checks (check 1 against the oracle pinned to the leaky slopes each f32
run's backwards took); every run must pass and launch exactly
``PARITY_LAUNCHES`` of its path.
Then the embedder phase (``embedder_phase``): the DietNeRF embedder
trainer's default ViT trained ``EMBED_STEPS`` steps in each pairing mode on
three synthetic scenes made here, finite losses falling, saved and read
back bitwise, and the evaluator's line for each and for the random
embedder.
Then the seven probe kernels (P1 ``probe_mma``, P2
``probe_mlp_epilogue``, P3 ``probe_mlp_chains``, P4-P6 ``probe_expand_a/b/c``,
P7 ``probe_enccost``) are held against their plain versions at the probe
tools' own shapes (P2's v3 and P3 at one and two chains bitwise bf16 B1, P3
refusing four chains as its shared memory and registers predict; P2's and
P3's times in turns with B1's; P1, on bf16 ``wgmma``, at every case of
``MXU_CASES`` with its TFLOP/s and share of the bound, no ``wgmma``
serialized in its build log, HGMMA and no HMMA in its SASS; P5 bitwise its
plain version also at a width of 3 and on an offset view (its scalar path),
in turns with its one-call library and its plain version; P6 in turns with
its library and plain compositions; P4, P5 and P6 with their wrappers' host
splits), the five tools of ``nerf_and_dietnerf_tpu_torch/tools`` run
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
the line before it holds the per-kernel JSON record, the one before that
the card's name and power limit, and the one before that the quality
phase's record.
"""

from __future__ import annotations

import contextlib
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
MLP_DESIGN = {"bfloat16": "tensor cores, mma.sync bf16, 128-row tiles, a fresh f32 partial a "
                          "16-deep step",
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
# bf16 B1's output, B2's dx and dd and B6's raw output, dz and dparams against
# the f64 evaluation of their chain: normwise at most this many times the
# plain f32 version's distance. Every bf16 tensor-core product sums each
# 16-deep step into a fresh f32 partial (mlp_mma_tile.cuh mma_step), one
# rounding a step where the plain version's f32 sums round at every term;
# with the tensor core's running sum these kernels read 1.45-1.6x.
F64_FACTOR_BF16 = 1.25
# The compositing kernels on the bf16 tensor cores (B7's backward, B5, B4's
# forward and backward) sum in an order of their own; the plain version's f32
# sums are one more such order. Two things then part them from it that do not
# part the kernels from the function: a sample whose raw sigma lies within the
# forward's rounding noise of 0 falls on the other side of the compositing's
# kink (max(sigma, 0); the sigma cotangent is 0 below it) and moves its row's
# dz and share of every weight gradient whole; and a hidden pre-activation
# within rounding of 0 takes the other leaky slope (1 or alpha) in the
# kernel than in the f64 chain, which on opaque rays (256 first samples carry
# every gradient) moves a whole weight-gradient leaf. Each check of these
# kernels therefore holds the kernel against its plain version with the
# MLP's products and sums in f64 (the same roundings to bf16, nearly exact
# sums), each sample on the kernel's side of the kink (the raw values the
# kernel composited, ``raw=``; ``research_kernels_cuda.kink_of``) and, for
# the backwards, each leaky slope the kernel's (``f64_branches``: its
# recording build, ``branches=``, must give outputs bitwise the kernel's, and
# its mask must pass ``raymarch_cuda.branch_guard`` against the f64 chain's
# own signs: every disagreement within BRANCH_BAND, at most KINK_SHARE of the
# elements): dparams to TOL_BWD (the worst leaf), dz and B4's denc and dencd
# normwise to TOL_ROWS, B5's loss, B4's pixels and weights to TOL, the raw
# values to TOL against the plain forward's, and at most KINK_SHARE of the
# samples on the other side of the kink from the f64 evaluation's. The f32
# backwards (3xTF32) are held against ``f64_kink`` (no recording).
# ``tools/comp_kink.py`` computes the records; the distances to ``f64_kink``
# and to the plain f32 version are printed beside. BRANCH_BAND and KINK_SHARE
# are ``raymarch_cuda``'s, the guard's own.
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


def _vs_f64_chain(torch, rc, ws, bs, cfg, x, d, g, cd) -> dict:
    """B2 and its plain version against the plain chain with the same
    roundings but f64 products and sums (``tools/chain.distances``: dx, dd
    and the flat dparams normwise, kernel and plain, and their ratio; in bf16
    also the kernel's distance to that chain on the leaky slopes its
    recording build took, ``kernel_pinned``, with the guard's record,
    ``branches``), and the share of rows where the plain f32 forward takes
    another leaky branch than the f64 one somewhere."""
    from nerf_and_dietnerf_tpu_torch.tools import chain

    out = chain.distances(chain.mlp_chain(ws, bs, cfg, x, d, g, cd),
                          pinned=cd == torch.bfloat16)
    _, a32 = rc._forward_plain(ws, bs, cfg, x, d, cd)
    _, a64 = rc._forward_plain(ws, bs, cfg, x, d, cd, torch.float64)
    flip = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for p32, p64 in zip(a32, a64):
        flip |= ((p32 >= 0) != (p64 >= 0)).any(dim=1)
    del a32, a64
    out["rows_with_a_branch_flip"] = float(flip.float().mean())
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
    (:func:`_vs_f64_chain`; bf16 dx and dd held to ``F64_FACTOR_BF16``)."""
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
    exact = _vs_f64_chain(torch, rc, ws, bs, cfg, x, d, g, cd)
    log(f"kernel check {label}: against the f64 chain (normwise), kernel and plain; rows "
        f"where plain f32 takes another leaky branch than f64: {exact}")
    if cd == torch.bfloat16:
        _hold_bf16_chain(f"mlp_bwd {label}", exact, [k for k, _, _ in rows])
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


def _hold_bf16_chain(label: str, dist: dict, held) -> None:
    """Fails unless each output of ``held`` in ``dist`` (as
    ``tools/chain.distances`` gives it) reads at most ``F64_FACTOR_BF16``
    times the plain version's normwise distance to the f64 chain, or if the
    kernel's recording build, where it ran, gave other outputs than the
    kernel. Prints beside the kernel's distance to that chain on its own
    leaky slopes (``kernel_pinned``; not held) and the guard's record."""
    ratios = {k: dist[k]["ratio_kernel_to_plain"] for k in held}
    pinned = {k: (r["kernel"], r["kernel_pinned"]) for k, r in dist.items()
              if isinstance(r, dict) and "kernel_pinned" in r}
    log(f"{label} against the f64 chain, kernel over plain (normwise; limit "
        f"{F64_FACTOR_BF16}): {ratios}" + (
            f"; kernel against the f64 chain on its own and on the kernel's leaky slopes "
            f"(not held): {pinned}; its slopes against the chain's signs: {dist['branches']}"
            if "branches" in dist else ""))
    over = {k: r for k, r in ratios.items() if not r <= F64_FACTOR_BF16}
    if over:
        raise AssertionError(f"{label}: {over} times the plain version's distance to the f64 "
                             f"chain (limit {F64_FACTOR_BF16})")
    if not dist.get("branches", {}).get("recording_bitwise", True):
        raise AssertionError(f"{label}: the recording build's outputs differ from the kernel's")


def _b6_vs_f64_chain(torch, ws, bs, cfg, rd, z, g, cd) -> dict:
    """B6 and its plain version against the plain chain with the same
    roundings but f64 products and sums, on the plain encode's encodings
    (``tools/chain.ray_chain``): the normwise distance of the raw output and,
    given a cotangent ``g``, of dz and of the flat dparams; in bf16 also on
    the kernel's own leaky slopes (``kernel_pinned``, ``branches``)."""
    from nerf_and_dietnerf_tpu_torch.tools import chain

    return chain.distances(chain.ray_chain(ws, bs, cfg, rd, z, g, cd),
                           pinned=cd == torch.bfloat16 and g is not None)


COMP_BWD_NAMES = {"B7": "raymarch_comp_bwd", "B5": "mlp_loss_comp", "B4": "mlp_comp_bwd"}


def _hold_comp_bwd(torch, kernel, label, name, ws, bs, cfg, cd, args, run) -> dict:
    """B7's backward (``kernel`` "B7"), B5 ("B5") or B4's backward ("B4") on
    ``args`` (as ``tools/comp_kink.plain_of`` takes them); ``run(raw,
    branches=None)`` gives its result as ``comp_kink.distance`` takes it
    (``(dws, dbs, dz, loss | None[, rows])``), on the tensor cores writing the
    raw values it composited to ``raw`` and, given ``branches``, launching the
    recording build that writes the leaky slopes it took there. Finite,
    dparams (and B5's loss, B4's dencd) bitwise equal across two runs, and
    held to the tolerances as KINK_SHARE sets out (every instance runs on the
    tensor cores, the f32 ones on 3xTF32 tiles, each summing in an order of
    their own), in the compute type's tolerances: bf16 against
    ``f64_branches``, only after the recording build's outputs came out
    bitwise the kernel's and its mask passed the guard
    (``raymarch_cuda.branch_guard``); f32 against ``f64_kink``. Returns
    ``tools/comp_kink.compare``'s record, ``held_to`` naming the reference
    held to."""
    from nerf_and_dietnerf_tpu_torch.ops.raymarch_cuda import KINK_SHARE
    from nerf_and_dietnerf_tpu_torch.tools import comp_kink

    kname = COMP_BWD_NAMES[kernel]
    z = args[1] if kernel == "B7" else args[2]
    raw = torch.empty((*z.shape, 4), dtype=torch.float32, device=DEVICE)
    got, again = run(raw), run(None)
    pinned = cd == torch.bfloat16
    mask, bitwise = comp_kink.recorded(lambda **kw: run(None, **kw), got, z, cfg) if pinned \
        else (None, True)
    torch.cuda.synchronize()

    def rep(r):  # what must be bitwise reproducible
        rows = r[4] if len(r) > 4 else {}
        return (list(r[0]) + list(r[1]) + ([r[3]] if r[3] is not None else [])
                + ([rows["dencd"]] if "dencd" in rows else []))

    rows = got[4] if len(got) > 4 else {}
    rec = comp_kink.compare(*comp_kink.plain_of(kernel, ws, bs, cfg, cd, args), got, raw,
                            mask if bitwise else None)
    rec["held_to"] = "f64_branches" if pinned else "f64_kink"
    rec["recording_bitwise"] = bitwise
    del mask
    if rec["held_to"] not in rec:
        raise AssertionError(f"{kname} {label}: no {rec['held_to']} reference: the recording "
                             f"build's outputs {'equal' if bitwise else 'differ from'} the "
                             f"kernel's; branch guard {rec.get('branches')}")
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
    beside = ("f64_kink", "plain") if pinned else ("plain",)
    summary = (f"against {rec['held_to']}: "
               + ", ".join(f"{k} {ref[k]:.3e}" for k in keys if k in ref)
               + (f" (leaky slopes recorded bitwise the kernel's run; the kernel's against the "
                  f"f64 chain's own signs: {rec['branches']['disagreements']} of "
                  f"{rec['branches']['elements']}, largest |pre| over its row's "
                  f"{rec['branches']['max_rel_pre']:.3e}, band {rec['branches']['band']:.3e})"
                  if pinned else "")
               + f"; raw scaled err {rec['raw_scaled_err_vs_plain']:.3e}, samples on the other "
                 f"side of the kink: {rec['kink_vs_f64']['count']} of the f64 evaluation's, "
                 f"{rec['kink_vs_plain']['count']} of the f32's"
               + "".join(f"; against {b}: " + ", ".join(f"{k} {rec[b][k]:.3e}" for k in keys
                                                        if k in rec[b]) for b in beside))
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
    ``comp_kink.MAX_LISTED``); where it was held to ``f64_branches``, its
    distance to that reference too (``kernel_branches``)."""
    from nerf_and_dietnerf_tpu_torch.tools import chain

    rows = [k for k in ("dz", "dparams", "denc", "dencd") if f"{k}_normwise" in rec["f64"]]
    out = {k: {"kernel": rec["f64"][f"{k}_normwise"], "plain": rec["plain_vs_f64"][f"{k}_normwise"]}
           for k in rows}
    if "loss_rel" in rec["f64"]:
        out["loss"] = {"kernel": rec["f64"]["loss_rel"], "plain": rec["plain_vs_f64"]["loss_rel"]}
    out.update(forward or {})
    chain.ratios(out)
    if "f64_kink" in rec:
        for k in rows:
            out[k]["kernel_kink"] = rec["f64_kink"][f"{k}_normwise"]
            if "f64_branches" in rec:
                out[k]["kernel_branches"] = rec["f64_branches"][f"{k}_normwise"]
        out["kink_samples"] = rec["kink_vs_f64"]["count"]
        out["kink_tile_rows"] = [k["tile_row"] for k in rec["kink_vs_f64"]["samples"]]
    return out


def _b7_pixels_vs_f64(torch, rk, ws, bs, cfg, rd, z, cd) -> dict:
    """B7's forward and its plain f32 version against the plain version with
    the MLP's sums in f64: normwise distance of the pixels."""
    from nerf_and_dietnerf_tpu_torch.tools import chain

    exact = rk.raymarch_comp_fwd_plain(ws, bs, cfg, rd, z, cd, work=torch.float64)[0]
    return {"kernel": chain.normwise(rk.raymarch_comp_fwd(ws, bs, cfg, rd, z, cd)[0], exact),
            "plain": chain.normwise(rk.raymarch_comp_fwd_plain(ws, bs, cfg, rd, z, cd)[0],
                                    exact)}


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
    from nerf_and_dietnerf_tpu_torch.ops.raymarch_cuda import KINK_SHARE
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

        def run7(raw, branches=None):
            if raw is not None:
                raws["bwd"] = raw
            return (*rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, g_rgb, g_w, cd, raw=raw,
                                          branches=branches), None)

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
            chain = _b6_vs_f64_chain(torch, ws, bs, cfg, rd, z, cots[0], cd)
            timings.setdefault("b6_vs_f64_chain", {}).setdefault(variant, {})[name] = chain
            log(f"kernel check B6 {variant} {name} R={RAYS} S={SAMPLES} against the f64 chain "
                f"(normwise, kernel and plain): {chain}")
            if cd == torch.bfloat16:
                _hold_bf16_chain(f"B6 {variant} {name} R={RAYS} S={SAMPLES}", chain,
                                 ("raw", "dz", "dparams"))
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
            if cd == torch.bfloat16:
                rd_s, z_s, _, cots_s, _ = other[2 * SAMPLES]
                chain = _b6_vs_f64_chain(torch, ws, bs, cfg, rd_s, z_s, cots_s[0], cd)
                timings["b6_vs_f64_chain"][variant][f"{name} S={2 * SAMPLES}"] = chain
                log(f"kernel check B6 {variant} {name} R={RAYS} S={2 * SAMPLES} against the f64 "
                    f"chain (normwise, kernel and plain): {chain}")
                _hold_bf16_chain(f"B6 {variant} {name} R={RAYS} S={2 * SAMPLES}", chain,
                                 ("raw", "dz", "dparams"))
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

        def run_o(raw, branches=None):
            if raw is not None:
                raws["bwd"] = raw
            return (*rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, g_rgb, g_w, cd, raw=raw,
                                          branches=branches), None)

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
    from nerf_and_dietnerf_tpu_torch.tools import chain, comp_kink

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
        recs["B4_fwd"] = {k: {"kernel": chain.normwise(a, e_), "plain": chain.normwise(p, e_)}
                          for k, a, p, e_ in (("pixels", rgb_k, plain[0], exact[0]),
                                              ("weights", w_k, plain[1], exact[1]))}
        del plain, exact, d
        log(f"kernel check {label}: B4 fwd scaled err {e:.3e} (tol {tol}) against "
            f"{'f64_kink' if bf else 'plain'}{extra}")
        g_rgb = (0.5 + torch.rand((n_rays, 3), generator=gen, device=DEVICE)).contiguous()
        g_w = (0.5 + torch.rand((n_rays, n_samples), generator=gen, device=DEVICE)).contiguous()
        cots = (g_rgb, g_w)
        raws = {}

        def run4(raw, branches=None):
            if raw is not None:
                raws["bwd"] = raw
            return comp_kink.b4_result(*rk.mlp_comp_bwd(ws, bs, cfg, enc, encd, z, g_rgb, g_w, cd,
                                                        raw=raw, branches=branches))

        recs["B4"] = _hold_comp_bwd(torch, "B4", label, name, ws, bs, cfg, cd,
                                    (enc, encd, z, g_rgb, g_w), run4)
        errs["mlp_comp_bwd"] = recs["B4"][recs["B4"]["held_to"]]["max_abs"]
        _same_raw(torch, "B4", label, raw_f, raws["bwd"])
    if b5:
        def run(raw, branches=None):
            mse, dz, dws, dbs = rk.mlp_loss_comp(ws, bs, cfg, enc, encd, z, dvec, target, cd,
                                                 raw=raw, branches=branches)
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
# P2: v1 and v5 to TOL["bfloat16"] of their plain versions, as B1; v3 (B1's
# function on B1's products) bitwise B1's bf16 output. P3: bitwise B1's bf16
# output at every chain count that runs (B1's products, per row in B1's k
# order), and to TOL["bfloat16"] of B1's plain version. P4, P5: exact. P6: 1e-4 scaled (two f32 products whose sums
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
MXU_CALLS = 20  # P1's calls a case between two events


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


def _probe_record(torch, fn, plain, lib, err, bound, ms=None, **extra):
    ms = _time_ms(torch, fn) if ms is None else ms
    return {"ms": ms, "plain_ms": _time_ms(torch, plain, reps=2),
            "library_ms": _time_ms(torch, lib) if lib is not None else None,
            "bound_ms": bound[0], "bound_by": bound[1], "max_abs_err": err, **extra}


def _in_turns(torch, timed: dict, reps: int):
    """``(ms, passes)``: ms a call of each function of ``timed``, taken in
    turns (each in order, then in reverse: for two, a b b a), ``reps``
    back-to-back calls a pass between two events; ``ms`` the mean of the two
    passes, ``passes`` both."""
    passes = {k: [] for k in timed}
    for order in (list(timed), list(timed)[::-1]):
        for k in order:
            passes[k].append(_time_ms(torch, timed[k], reps=reps))
    return {k: sum(v) / len(v) for k, v in passes.items()}, passes


# P4's calls a pass in turns with its library call, and the warm calls a step
# of its host split is timed over (the median of each step's).
P4_TURN_CALLS = 1000
HOST_SPLIT_CALLS = 2000
# Calls of each kernel under the profiler, a pass (two passes); P7's stages
# and bf16 B6's forward in turns, calls a pass.
PROFILED_CALLS = 200
ENC_TURN_CALLS = 50
B6_TURN_CALLS = 20
# P6's calls a pass in turns with its library and plain compositions, and
# the warm calls a step of its host split.
P6_TURN_CALLS = 200
P6_SPLIT_CALLS = 200


def _host_split_us(torch, steps: dict, calls: int) -> dict:
    """The host time of each step of ``steps`` (name -> function), in µs: the
    median over ``calls`` warm calls of ``time.perf_counter_ns`` around it."""
    import statistics

    out = {}
    for name, fn in steps.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        ns = []
        for _ in range(calls):
            t0 = time.perf_counter_ns()
            fn()
            ns.append(time.perf_counter_ns() - t0)
        torch.cuda.synchronize()
        out[name] = statistics.median(ns) / 1e3
    return out


def _profiled_device_us(torch, runs: dict, kernels: dict) -> dict:
    """Device µs a launch of each kernel of ``kernels`` (label -> a part of
    its name in the trace): every function of ``runs`` called
    ``PROFILED_CALLS`` times under ``torch.profiler``, in order, then again in
    reverse under a second profiler; a kernel's CUDA time over its count in
    each pass. ``{label: {"us": mean of the two passes, "passes": [..],
    "launches": count a pass}}``; a label the trace lacks, or whose time
    reads 0, gets ``None`` (the profiler recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile

    per = {k: [] for k in kernels}
    counts = {}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            runs[name]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for name in order:
                for _ in range(PROFILED_CALLS):
                    runs[name]()
            torch.cuda.synchronize()
        averages = [a for a in prof.key_averages() if _on_device(a)]
        for label, part in kernels.items():
            hits = [a for a in averages if part in a.key]
            count = sum(a.count for a in hits)
            total = sum(_device_us(a) for a in hits)
            per[label].append(total / count if count and total > 0 else None)
            counts[label] = count
    return {k: None if None in v else {"us": sum(v) / 2, "passes": v, "launches": counts[k]}
            for k, v in per.items()}


def probe_kernel_phases(torch, timings: dict) -> None:
    from nerf_and_dietnerf_tpu_torch.models import mlp
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.ops import probe_kernels_cuda as pk
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
    from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
    from nerf_and_dietnerf_tpu_torch.tools import chain, mlp_flops

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

    # Every case: ms a call (MXU_CALLS back-to-back calls between two
    # events), TFLOP/s and the share of the bound; at the first case the
    # device µs of the W pack's gather, the chain and the reduce (profiler).
    def p1_bound(a, b):
        return _bound(2 * a * 256 * 256 * b * steps, PEAK_FLOPS["bfloat16"],
                      w.numel() * 2 + steps * 8 * 256 * 4)

    cases = {}
    for a, b, c in MXU_CASES:
        ms = _time_ms(torch, lambda: pk.mxu_chain(w, a, b, c, steps), reps=MXU_CALLS)
        cases[f"{a}:{b}:{c}"] = {"ms": ms, "tflops": 2 * a * 256 * 256 * b * steps / ms / 1e9,
                                 "share_of_bound": p1_bound(a, b)[0] / ms}
    dev_p1 = _profiled_device_us(torch, {"p1": lambda: pk.mxu_chain(w, m, depth, chains, steps)},
                                 {"pack": "gather", "chain": "mma_chain_kernel",
                                  "reduce": "mma_chain_reduce"})
    first = cases[f"{m}:{depth}:{chains}"]
    sass_p1 = timings.get("sass", {}).get("probe_mma_chain")
    rec["probe_mma"] = _probe_record(
        torch, None, lambda: pk.mxu_chain_plain(w, m, depth, chains, steps),
        lambda: [lib_chain() for _ in range(steps)], errs[MXU_CASES[0]], p1_bound(m, depth),
        ms=first["ms"], m=m, depth=depth, chains=chains, steps=steps,
        library="torch.matmul chain in bf16 (cuBLAS), one per step",
        design="bf16 wgmma m64n256k16 (A in registers, W in shared memory by descriptor), "
               "two warpgroups a block, a unit a (64-row tile, chain)",
        ms_cases={k: v["ms"] for k, v in cases.items()}, cases=cases,
        tflops=first["tflops"], share_of_bound=first["share_of_bound"],
        device_us={k: v and v["us"] for k, v in dev_p1.items()}, ptxas=sass_p1)
    log("P1 ms a call (" + f"{MXU_CALLS} calls), TFLOP/s, share of bound: " + "; ".join(
        f"{k} {v['ms']:.4f} ms, {v['tflops']:.1f}, {100 * v['share_of_bound']:.1f} %"
        for k, v in cases.items()) + f"; device us a call at {m}:{depth}:{chains} (profiler): "
        + ", ".join(f"{k} {v and round(v['us'], 3)}" for k, v in dev_p1.items())
        + f"; registers, spill bytes, SASS HGMMA / HMMA {sass_p1}")

    # P2, P3 --------------------------------------------------------------- #
    # Both run bf16 B1's tensor-core tile: P2 v3 and P3 at every chain count
    # that runs must give B1's output bitwise.
    cfg = mlp.MLPConfig()
    params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
    ws, bs = rc.flatten_params(params, cfg, torch.bfloat16)
    n = N_PROBE_ROWS
    x, d = randn(n, cfg.xyz_dim), randn(n, cfg.dir_dim)
    xb, db = x.to(torch.bfloat16), d.to(torch.bfloat16)
    flops = mlp_flops(cfg, n)
    par_bytes = sum(t.numel() * 2 for t in ws) + sum(t.numel() * 4 for t in bs)
    ref = rc.mlp_fwd(ws, bs, cfg, xb, db, torch.bfloat16)
    variants = {}
    for variant in ("v1", "v5", "v3"):
        out_k = pk.mlp_fwd_variant(ws, bs, cfg, x, d, variant)
        torch.cuda.synchronize()
        out_p = pk.mlp_fwd_variant_plain(ws, bs, cfg, x, d, variant)
        e, bit = _scaled_err(out_k, out_p), torch.equal(out_k, ref)
        if not (torch.isfinite(out_k).all() and e <= TOL["bfloat16"]
                and (bit or variant != "v3")):
            raise AssertionError(f"probe_mlp_epilogue {variant}: scaled err {e} > "
                                 f"{TOL['bfloat16']}, or v3 not bitwise B1 bf16 ({bit})")
        variants[variant] = float((out_k - out_p).abs().max())
        log(f"kernel check probe_mlp_epilogue {variant} bfloat16 rows={n}: scaled err {e:.3e} "
            f"(tol {TOL['bfloat16']}), bitwise B1 bf16 {bit}"
            + (" (required: v3 is B1's function)" if variant == "v3" else ""))
        del out_k, out_p

    plain = rc.mlp_fwd_plain(ws, bs, cfg, xb, db, torch.bfloat16)
    ws32, bs32 = rc.flatten_params(params, cfg, torch.float32)
    x32, d32 = x[:N_ROWS].contiguous(), d[:N_ROWS].contiguous()
    # B1 on the tensor cores and the plain f32 version against the forward
    # with the same roundings but f64 sums, on the first N_ROWS rows
    # (tools/chain.distances): which of the two sums less exactly. bf16 is
    # held to F64_FACTOR_BF16, f32 (3xTF32) to F64_FACTOR.
    fwd_vs_exact = chain.distances(chain.forward_chain(ws, bs, cfg, xb[:N_ROWS], db[:N_ROWS],
                                                       torch.bfloat16))
    log(f"kernel check B1 bf16 rows={N_ROWS} against the f64 forward chain (normwise): "
        f"{fwd_vs_exact}")
    _hold_bf16_chain(f"B1 bf16 rows={N_ROWS}", fwd_vs_exact, ("out",))
    f32_vs_exact = chain.distances(chain.forward_chain(ws32, bs32, cfg, x32, d32, torch.float32))
    ratio = f32_vs_exact["out"]["ratio_kernel_to_plain"]
    timings["b1_f32_vs_f64_chain"] = f32_vs_exact
    log(f"kernel check B1 f32 rows={N_ROWS} against the f64 forward chain (normwise): "
        f"{f32_vs_exact}")
    if not ratio <= F64_FACTOR:
        raise AssertionError(f"B1 f32 is {ratio:.2f}x as far from the f64 chain as the plain f32 "
                             f"version (limit {F64_FACTOR})")
    chain_errs = {}
    for chains in (1, 2):
        out_k = pk.mlp_fwd_chains(ws, bs, cfg, xb, db, chains)
        torch.cuda.synchronize()
        bit, e_plain = torch.equal(out_k, ref), _scaled_err(out_k, plain)
        if not (torch.isfinite(out_k).all() and bit and e_plain <= TOL["bfloat16"]):
            raise AssertionError(f"probe_mlp_chains chains={chains}: bitwise B1 bf16 {bit} "
                                 f"(required), against the plain version {e_plain}")
        chain_errs[chains] = float((out_k - plain).abs().max())
        log(f"kernel check probe_mlp_chains chains={chains} bfloat16 rows={n}: bitwise B1 bf16 "
            f"{bit}; against the plain version {e_plain:.3e} (tol {TOL['bfloat16']})")
        del out_k
    # Four chains: the outcome the card's own numbers predict. The shared
    # memory the kernel reports (equal to the Python mirror) against the
    # card's limit for a block decides; the registers that ptxas gave the
    # chain counts that were built, at 512 threads, are recorded beside it.
    lib = kl.load("probe_mlp_chains")
    smem = {c: lib.nerf_probe_chains_smem(c) for c in (1, 2, 4)}
    if smem != {c: pk.chains_smem_bytes(c) for c in smem}:
        raise AssertionError(f"probe_mlp_chains: the kernel's shared memory {smem} is not "
                             f"chains_smem_bytes' {[pk.chains_smem_bytes(c) for c in smem]}")
    props = torch.cuda.get_device_properties(0)
    for attr, mirror in (("shared_memory_per_block_optin", pk.MAX_SHARED_BYTES),
                         ("regs_per_multiprocessor", pk.REGISTERS_PER_SM)):
        if getattr(props, attr, mirror) != mirror:
            raise AssertionError(f"the card's {attr} is {getattr(props, attr)}, the probe "
                                 f"wrapper's {mirror}")
    # How many blocks of each chain count an SM holds (C = 1: two, as many
    # warps as one block of B1).
    per_sm = {c: lib.nerf_probe_chains_blocks_per_sm(c) for c in (1, 2)}
    log(f"probe_mlp_chains blocks an SM holds: {per_sm}")
    sass = timings.get("sass", {}).get("probes") or {}
    regs = max((sass.get(f"chains_{c}", {}).get("registers", 0) for c in (1, 2)), default=0)
    predicted = pk.chains_limits(4, registers=regs or None)
    refuse = smem[4] > getattr(props, "shared_memory_per_block_optin", pk.MAX_SHARED_BYTES)
    try:
        out_k = pk.mlp_fwd_chains(ws, bs, cfg, xb, db, 4)
    except pk.SharedMemoryExceeded as exc:
        if not refuse:
            raise AssertionError(f"probe_mlp_chains chains=4 refused, its {smem[4]} bytes of "
                                 f"shared memory fit the card's block: {exc}")
        log(f"kernel check probe_mlp_chains chains=4 raises as predicted (shared memory "
            f"{smem}): {exc}; the limits it exceeds at {regs or 'unknown'} registers a "
            f"thread: {predicted}")
    else:
        torch.cuda.synchronize()
        if refuse or not torch.equal(out_k, ref):
            raise AssertionError(f"probe_mlp_chains chains=4 ran: shared memory over the "
                                 f"block's {refuse}, bitwise B1 bf16 {torch.equal(out_k, ref)}")
        del out_k
    del ref, plain

    # Times in turns (B1, the probes, then the same in reverse), the mean of
    # the two passes; the epilogue's share of B1's time is (v3 - v1) / v3.
    timed = {"v0_b1": lambda: rc.mlp_fwd(ws, bs, cfg, xb, db, torch.bfloat16),
             **{v: (lambda v=v: pk.mlp_fwd_variant(ws, bs, cfg, x, d, v)) for v in variants},
             **{f"chains_{c}": (lambda c=c: pk.mlp_fwd_chains(ws, bs, cfg, xb, db, c))
                for c in chain_errs}}
    ms, passes = _in_turns(torch, timed, reps=10)
    share = (ms["v3"] - ms["v1"]) / ms["v3"]
    rec["probe_mlp_epilogue"] = _probe_record(
        torch, timed["v1"], lambda: pk.mlp_fwd_variant_plain(ws, bs, cfg, x, d, "v1"),
        lambda: _library_mlp(torch, ws, bs, cfg, xb, db), max(variants.values()),
        _bound(flops, PEAK_FLOPS["bfloat16"],
               n * (cfg.xyz_dim + cfg.dir_dim) * 4 + par_bytes + n * 16), ms=ms["v1"],
        rows=n, variant="v1", library="torch.addmm chain in bf16 (v3's function)",
        design=MLP_DESIGN["bfloat16"] + ", another epilogue policy",
        max_abs_err_by_variant=variants, ms_in_turns=ms, ms_passes=passes,
        ms_v5=ms["v5"], ms_v3=ms["v3"], ms_v0_b1=ms["v0_b1"], epilogue_share=share,
        ms_v0_b1_design=MLP_DESIGN["bfloat16"], ptxas=sass)
    rec["probe_mlp_chains"] = _probe_record(
        torch, timed["chains_2"], lambda: rc.mlp_fwd_plain(ws, bs, cfg, xb, db, torch.bfloat16),
        lambda: _library_mlp(torch, ws, bs, cfg, xb, db), max(chain_errs.values()),
        _bound(flops, PEAK_FLOPS["bfloat16"],
               n * (cfg.xyz_dim + cfg.dir_dim) * 2 + par_bytes + n * 16), ms=ms["chains_2"],
        rows=n, chains=2, library="torch.addmm chain in bf16",
        design=MLP_DESIGN["bfloat16"] + ", 64-row chains sharing each weight chunk",
        ms_in_turns=ms, ms_chains_1=ms["chains_1"], ms_chains_2=ms["chains_2"],
        ms_v0_b1=ms["v0_b1"], ms_v0_b1_design=MLP_DESIGN["bfloat16"], smem_bytes=smem,
        blocks_per_sm=per_sm,
        chains_4_limits=predicted, fwd_vs_f64_chain=fwd_vs_exact, ptxas=sass)
    p2, p3 = rec["probe_mlp_epilogue"], rec["probe_mlp_chains"]
    log(f"P2 / P3 rows={n} (ms in turns, mean of two passes): v0 (B1) {ms['v0_b1']:.3f}, v1 "
        f"{ms['v1']:.3f}, v5 {ms['v5']:.3f}, v3 {ms['v3']:.3f}; epilogue share (v3 - v1) / v3 "
        f"{share:.4f}; chains 1 {ms['chains_1']:.3f}, chains 2 {ms['chains_2']:.3f}; bound "
        f"{p2['bound_ms']:.4f} ms ({p2['bound_by']}), library {p2['library_ms']:.3f} / "
        f"{p3['library_ms']:.3f} ms; registers, spill bytes, SASS HMMA {sass}")
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
        rows, err = out_k.shape[0], float((out_k - out_p).abs().max())
        if kname == "probe_expand_c":
            fl = rows * (2 * (6 * n_theta + n_theta * n_enc) + SINF_FLOPS * n_theta)
            nbytes = 4 * (3 * px.numel() + vc.numel() + sc.numel() + gx.numel() + out_k.numel())
            bound = _bound(fl, PEAK_FLOPS["float32"], nbytes)
            rec[kname] = {"bound_ms": bound[0], "bound_by": bound[1], "max_abs_err": err,
                          "rows": rows}
            continue  # timed in turns below
        fl = out_k.numel()
        nbytes = 4 * ((zt if kname == "probe_expand_a" else rd8).numel() + out_k.numel())
        # ms and library_ms: in turns below
        rec[kname] = _probe_record(torch, fn, plain_fn, None, err,
                                   _bound(fl, PEAK_FLOPS["float32"], nbytes), rows=rows)
    # P4 is a launch's worth of work, so its time a call is the host's: the
    # kernel and its library call in turns, each pass P4_TURN_CALLS calls; the
    # kernel's device time from the profiler; and where the wrapper's host
    # time goes, step by step, in the parent's form of each step (the generic
    # checks, torch.empty, a torch.cuda.Stream) and the lean one, with the
    # C call alone (n = 0 returns before the launch) beside the one that
    # launches.
    a = rec["probe_expand_a"]
    turns, turn_passes = _in_turns(torch, {"kernel": lambda: pk.expand_a(zt),
                                           "library": lambda: zt.reshape(-1, 1) + 1.0},
                                   P4_TURN_CALLS)
    out_a = pk.expand_a(zt)
    fn_a, n_a = kl.load("probe_expand").nerf_probe_expand_a, zt.numel()
    ptrs = (zt.data_ptr(), out_a.data_ptr(), n_a, kl.stream_of(zt.device))
    f32 = torch.float32
    split = _host_split_us(torch, {
        "device test (uses_kernel)": lambda: pk.uses_kernel(zt),
        "checks, parent (check_tensors + dim)": lambda: (
            kl.check_tensors([(zt, zt.shape, f32)], zt.device), zt.dim()),
        "checks, lean (inline)": lambda: (
            zt.dtype != f32 or zt.dim() != 2 or not zt.is_contiguous()),
        "alloc, parent (torch.empty)": lambda: torch.empty((n_a, 1), dtype=f32, device=zt.device),
        "alloc, lean (new_empty)": lambda: zt.new_empty((n_a, 1)),
        "load() and the lookup": lambda: kl.load("probe_expand").nerf_probe_expand_a,
        "stream, parent (current_stream().cuda_stream)":
            lambda: torch.cuda.current_stream(zt.device).cuda_stream,
        "stream, lean (stream_of)": lambda: kl.stream_of(zt.device),
        "data_ptr x2 and numel": lambda: (zt.data_ptr(), out_a.data_ptr(), zt.numel()),
        "ctypes call with the launch": lambda: fn_a(*ptrs),
        "ctypes call, no launch (n = 0)": lambda: fn_a(ptrs[0], ptrs[1], 0, ptrs[3]),
        "launched": lambda: kl.launched("probe_expand_a", 0),
        "whole wrapper (expand_a)": lambda: pk.expand_a(zt),
        "library call (reshape + add)": lambda: zt.reshape(-1, 1) + 1.0,
    }, HOST_SPLIT_CALLS)
    lean = ("device test (uses_kernel)", "checks, lean (inline)", "alloc, lean (new_empty)",
            "load() and the lookup", "stream, lean (stream_of)", "data_ptr x2 and numel",
            "ctypes call with the launch", "launched")
    parent = ("device test (uses_kernel)", "checks, parent (check_tensors + dim)",
              "alloc, parent (torch.empty)", "load() and the lookup",
              "stream, parent (current_stream().cuda_stream)", "data_ptr x2 and numel",
              "ctypes call with the launch", "launched")
    dev_a = _profiled_device_us(torch, {"kernel": lambda: pk.expand_a(zt),
                                        "library": lambda: zt.reshape(-1, 1) + 1.0},
                                {"kernel": "expand_a_kernel", "library": "elementwise_kernel"})
    a.update(ms=turns["kernel"], library_ms=turns["library"], ms_in_turns=turns,
             ms_passes=turn_passes, turn_calls=P4_TURN_CALLS,
             device_us=dev_a["kernel"], library_device_us=dev_a["library"],
             host_split_us=split, host_split_calls=HOST_SPLIT_CALLS,
             host_sum_lean_us=sum(split[k] for k in lean),
             host_sum_parent_us=sum(split[k] for k in parent),
             design="one thread per four outputs, 16-byte loads and stores, a lean launch path",
             library="zt.reshape(-1, 1) + 1.0")
    log(f"P4 ms a call in turns ({P4_TURN_CALLS} calls a pass, kernel library library "
        f"kernel): kernel {turns['kernel']:.5f}, library {turns['library']:.5f} (passes "
        f"{turn_passes}); device us a launch (profiler): kernel "
        f"{dev_a['kernel'] and round(dev_a['kernel']['us'], 3)}, library "
        f"{dev_a['library'] and round(dev_a['library']['us'], 3)}")
    log(f"P4 host split (us, median of {HOST_SPLIT_CALLS} warm calls a step): "
        + "; ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; sum of the lean steps {a['host_sum_lean_us']:.3f}, of the parent's "
        f"{a['host_sum_parent_us']:.3f}")
    if dev_a["kernel"] is None:
        log("P4: the profiler recorded no device time for expand_a_kernel")

    # P5 as P4: bitwise its plain version, one launch a call, also at a width
    # that is not a multiple of 4 and on a view one float into its storage
    # (both the kernel's scalar path); then the kernel, its one-call library
    # (rd expanded and doubled: one element-wise kernel writing the (S, R_t,
    # X) block contiguously), its plain version and P4 in turns,
    # P4_TURN_CALLS calls a pass; the wrapper's host time step by step, the
    # parent's form of each step (the generic checks, torch.empty) beside the
    # lean one, and P4's steps that differ again beside them (P4 in both:
    # the host's speed drifts between P4's measurements and P5's); then
    # device µs a launch of the kernel and of the library's (profiler).
    def lib_b(rd):
        return (rd.expand(n_s, *rd.shape) * 2.0).view(-1, rd.shape[1])

    b = rec["probe_expand_b"]
    checks_b = {}
    for case, rd in (("tool", rd8), ("x3", randn(r_t, 3)),
                     ("offset_view", randn(r_t * 8 + 1)[1:].view(r_t, 8))):
        was = kl.LAUNCHES["probe_expand_b"]
        out_k = pk.expand_b(rd, n_s)
        torch.cuda.synchronize()
        got = kl.LAUNCHES["probe_expand_b"] - was
        out_p, out_lib = pk.expand_b_plain(rd, n_s), lib_b(rd)
        if not (torch.equal(out_k, out_p) and torch.equal(out_lib, out_p) and got == 1):
            raise AssertionError(f"probe_expand_b {case} {tuple(rd.shape)} (data_ptr % 16 = "
                                 f"{rd.data_ptr() % 16}): kernel bitwise "
                                 f"{torch.equal(out_k, out_p)}, library bitwise "
                                 f"{torch.equal(out_lib, out_p)}, launches {got} (expected 1)")
        checks_b[case] = {"shape": list(rd.shape), "data_ptr_mod_16": rd.data_ptr() % 16,
                          "max_abs_err": float((out_k - out_p).abs().max())}
        log(f"kernel check probe_expand_b {case} rd {tuple(rd.shape)} (data_ptr % 16 = "
            f"{rd.data_ptr() % 16}) -> {tuple(out_k.shape)}: bitwise its plain version and its "
            f"library call, one launch")
    turns_b, passes_b = _in_turns(torch, {"kernel": lambda: pk.expand_b(rd8, n_s),
                                          "library": lambda: lib_b(rd8),
                                          "plain": lambda: pk.expand_b_plain(rd8, n_s),
                                          "p4 (control)": lambda: pk.expand_a(zt)},
                                  P4_TURN_CALLS)
    out_b = pk.expand_b(rd8, n_s)
    fn_b, (r_b, x_b) = kl.load("probe_expand").nerf_probe_expand_b, rd8.shape
    ptrs_b = (rd8.data_ptr(), out_b.data_ptr(), r_b, n_s, x_b, kl.stream_of(rd8.device))
    split_b = _host_split_us(torch, {
        "device test (uses_kernel)": lambda: pk.uses_kernel(rd8),
        "checks, parent (check_tensors + dim and count)": lambda: (
            kl.check_tensors([(rd8, rd8.shape, f32)], rd8.device), rd8.dim() != 2 or n_s <= 0),
        "checks, lean (inline)": lambda: (
            rd8.dtype != f32 or rd8.dim() != 2 or not rd8.is_contiguous() or n_s <= 0),
        "shape": lambda: rd8.shape,
        "alloc, parent (torch.empty)": lambda: torch.empty((n_s * r_b, x_b), dtype=f32,
                                                           device=rd8.device),
        "alloc, lean (new_empty)": lambda: rd8.new_empty((n_s * r_b, x_b)),
        "empty test (R_t, X == 0)": lambda: r_b == 0 or x_b == 0,
        "load() and the lookup": lambda: kl.load("probe_expand").nerf_probe_expand_b,
        "stream (stream_of)": lambda: kl.stream_of(rd8.device),
        "data_ptr x2": lambda: (rd8.data_ptr(), out_b.data_ptr()),
        "ctypes call with the launch": lambda: fn_b(*ptrs_b),
        "ctypes call, no launch (n_s = 0)": lambda: fn_b(*ptrs_b[:3], 0, *ptrs_b[4:]),
        "launched": lambda: kl.launched("probe_expand_b", 0),
        "whole wrapper (expand_b)": lambda: pk.expand_b(rd8, n_s),
        "library call (expand and multiply)": lambda: lib_b(rd8),
        "P4's whole wrapper (control)": lambda: pk.expand_a(zt),
        "P4's alloc (control)": lambda: zt.new_empty((n_a, 1)),
        "P4's ctypes call, no launch (control)": lambda: fn_a(ptrs[0], ptrs[1], 0, ptrs[3]),
    }, HOST_SPLIT_CALLS)
    dev_b = _profiled_device_us(torch, {"kernel": lambda: pk.expand_b(rd8, n_s),
                                        "library": lambda: lib_b(rd8)},
                                {"kernel": "expand_b_kernel", "library": "elementwise_kernel"})
    common = ("device test (uses_kernel)", "shape", "load() and the lookup",
              "stream (stream_of)", "data_ptr x2", "ctypes call with the launch", "launched")
    lean_b = common + ("checks, lean (inline)", "alloc, lean (new_empty)",
                       "empty test (R_t, X == 0)")
    parent_b = common + ("checks, parent (check_tensors + dim and count)",
                         "alloc, parent (torch.empty)")
    b.update(ms=turns_b["kernel"], library_ms=turns_b["library"], plain_ms=turns_b["plain"],
             ms_in_turns=turns_b, ms_passes=passes_b, turn_calls=P4_TURN_CALLS,
             device_us=dev_b["kernel"], library_device_us=dev_b["library"],
             host_split_us=split_b, host_split_calls=HOST_SPLIT_CALLS,
             host_sum_lean_us=sum(split_b[k] for k in lean_b),
             host_sum_parent_us=sum(split_b[k] for k in parent_b), checks=checks_b,
             design="no division: a thread an element of rd (a float4 where aligned, else a "
                    "float) stored into its samples; a lean launch path",
             library="(rd.expand(S, R_t, X) * 2.0).view(-1, X)",
             plain="expand_b_plain: rd.repeat(S, 1) * 2.0",
             ptxas={k: timings.get("sass", {}).get("probe_kernels", {}).get(k)
                    for k in ("P5", "P5 scalar")})
    log(f"P5 ms a call in turns ({P4_TURN_CALLS} calls a pass): kernel {turns_b['kernel']:.5f}, "
        f"library {turns_b['library']:.5f}, plain {turns_b['plain']:.5f}, P4 in the same turns "
        f"{turns_b['p4 (control)']:.5f} (passes {passes_b}); "
        f"kernel / library {turns_b['kernel'] / turns_b['library']:.3f}; device us a launch "
        f"(profiler): kernel {dev_b['kernel'] and round(dev_b['kernel']['us'], 3)}, library "
        f"{dev_b['library'] and round(dev_b['library']['us'], 3)}; bound "
        f"{b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}); registers, spills, SASS {b['ptxas']}")
    log(f"P5 host split (us, median of {HOST_SPLIT_CALLS} warm calls a step): "
        + "; ".join(f"{k} {v:.3f}" for k, v in split_b.items())
        + f"; sum of the lean steps {b['host_sum_lean_us']:.3f}, of the parent's "
        f"{b['host_sum_parent_us']:.3f}")
    if dev_b["kernel"] is None:
        log("P5: the profiler recorded no device time for expand_b_kernel")

    # P6: the kernel, its plain version and its library composition in turns
    # (P6_TURN_CALLS calls a pass, kernel library plain plain library
    # kernel); device µs a launch of the kernel and a call of the two torch
    # compositions (every device operation of the call, profiler); the
    # wrapper's host time step by step, each of its lean steps beside the
    # generic form the parent took (P6_SPLIT_CALLS warm calls a step: few
    # enough that the launching steps never wait for the card).
    def lib_c():  # the fewest torch calls: theta as two broadcast products, sin, one product
        pts = torch.stack((px, py, pz), dim=-1).view(n_tiles, n_s, r_t, 3)
        th = pts @ sc[:3] + vc.view(n_tiles, 1, r_t, 3) @ sc[3:]
        return torch.sin(th).view(-1, n_theta) @ gx

    c = rec["probe_expand_c"]
    out_c, out_lib = pk.expand_c(px, py, pz, vc, sc, gx), lib_c()
    torch.cuda.synchronize()
    e_lib = _scaled_err(out_lib, pk.expand_c_plain(px, py, pz, vc, sc, gx))
    if not e_lib <= TOL_EXPAND_C:
        raise AssertionError(f"P6's library composition is {e_lib} from the plain version")
    turns_c, passes_c = _in_turns(torch, {
        "kernel": lambda: pk.expand_c(px, py, pz, vc, sc, gx), "library": lib_c,
        "plain": lambda: pk.expand_c_plain(px, py, pz, vc, sc, gx)}, P6_TURN_CALLS)
    dev_c = _profiled_device_us(torch, {"kernel": lambda: pk.expand_c(px, py, pz, vc, sc, gx)},
                                {"kernel": "expand_c_kernel"})["kernel"]
    # A composition's device µs a call: all its device operations ("" matches
    # every name), their µs a launch times their launches, over the calls.
    calls_us = {name: _profiled_device_us(torch, {name: fn}, {name: ""})[name] for name, fn in (
        ("library", lib_c), ("plain", lambda: pk.expand_c_plain(px, py, pz, vc, sc, gx)))}
    lib_us, plain_us = (v and v["us"] * v["launches"] / PROFILED_CALLS for v in calls_us.values())
    fn_c = kl.load("probe_expand").nerf_probe_expand_c
    ins = (px, py, pz, vc, sc, gx)
    ptrs_c = (*(t.data_ptr() for t in ins), out_c.data_ptr(), n_tiles, r_t, n_s, n_theta, n_enc,
              kl.stream_of(px.device))
    split_c = _host_split_us(torch, {
        "device test (uses_kernel)": lambda: pk.uses_kernel(px),
        "shapes (_expand_c_shapes)": lambda: pk._expand_c_shapes(px, vc, sc, gx),
        "checks, parent (check_tensors, six tensors)": lambda: kl.check_tensors(
            [(px, (n_tiles * n_s, r_t), f32), (py, px.shape, f32), (pz, px.shape, f32),
             (vc, (n_tiles * r_t, 3), f32), (sc, (6, n_theta), f32),
             (gx, (n_theta, n_enc), f32)], px.device),
        "checks, lean (inline, the wrapper's)": lambda: [
            t.shape != shape or t.dtype != f32 or t.device != px.device or not t.is_contiguous()
            for t, shape in ((px, (n_tiles * n_s, r_t)), (py, px.shape), (pz, px.shape),
                             (vc, (n_tiles * r_t, 3)), (sc, (6, n_theta)),
                             (gx, (n_theta, n_enc)))],
        "alloc, parent (torch.empty)": lambda: torch.empty(
            (out_c.shape[0], n_enc), dtype=f32, device=px.device),
        "alloc, lean (new_empty, the wrapper's)": lambda: px.new_empty((out_c.shape[0], n_enc)),
        "load() and the lookup": lambda: kl.load("probe_expand").nerf_probe_expand_c,
        "stream (stream_of)": lambda: kl.stream_of(px.device),
        "data_ptr x7": lambda: tuple(t.data_ptr() for t in (*ins, out_c)),
        "ctypes call with the launch": lambda: fn_c(*ptrs_c),
        "ctypes call, no launch (n_tiles = 0)": lambda: fn_c(*ptrs_c[:7], 0, *ptrs_c[8:]),
        "launched": lambda: kl.launched("probe_expand_c", 0),
        "whole wrapper (expand_c)": lambda: pk.expand_c(px, py, pz, vc, sc, gx),
        "library composition": lib_c,
    }, P6_SPLIT_CALLS)
    generic = (split_c["checks, parent (check_tensors, six tensors)"]
               + split_c["alloc, parent (torch.empty)"])
    c.update(ms=turns_c["kernel"], library_ms=turns_c["library"], plain_ms=turns_c["plain"],
             ms_in_turns=turns_c, ms_passes=passes_c, turn_calls=P6_TURN_CALLS,
             device_us=dev_c and dev_c["us"], device_us_passes=dev_c and dev_c["passes"],
             library_device_us=lib_us, plain_device_us=plain_us,
             host_split_us=split_c, host_split_calls=P6_SPLIT_CALLS,
             host_parent_checks_and_alloc_us=generic,
             design="a thread a row: theta, sinf and the row's 33 sums in registers, sc and gx "
                    "in shared memory (broadcast float4 loads), outputs staged over them and "
                    "written coalesced; 256 rows a block, two blocks an SM; a lean wrapper",
             library="theta as two broadcast torch.matmul, torch.sin, one torch.matmul",
             plain="expand_c_plain: stack, expand, cat, torch.matmul, torch.sin, torch.matmul",
             ptxas=timings.get("sass", {}).get("probe_kernels", {}).get("P6"))
    log(f"P6 ms a call in turns ({P6_TURN_CALLS} calls a pass): kernel {turns_c['kernel']:.5f}, "
        f"library {turns_c['library']:.5f}, plain {turns_c['plain']:.5f} (passes {passes_c}); "
        f"device us: kernel a launch {dev_c and round(dev_c['us'], 3)}, library a call "
        f"{lib_us and round(lib_us, 3)}, plain a call {plain_us and round(plain_us, 3)}; bound "
        f"{c['bound_ms'] * 1e3:.2f} us ({c['bound_by']}); library's scaled err {e_lib:.2e}")
    log(f"P6 host split (us, median of {P6_SPLIT_CALLS} warm calls a step): "
        + "; ".join(f"{k} {v:.3f}" for k, v in split_c.items())
        + f"; the parent's checks and torch.empty {generic:.3f} against the kernel's device "
        f"{dev_c and round(dev_c['us'], 3)}")

    # P7 ------------------------------------------------------------------- #
    n_rays = 64 * r_t
    rd = randn(n_rays, 9)
    z = (2.0 + 4.0 * torch.rand((n_rays, n_s), generator=gen, device=DEVICE)).contiguous()
    stage_err, max_theta = {}, None
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
        log(f"kernel check probe_enccost {stage}: "
            f"{'scaled' if stage in TOL_ENC else 'max abs'} err {e:.3e} (tol {tol:.3e}"
            + (f", from max |theta| {max_theta:.1f}" if stage not in TOL_ENC else "")
            + f"), bitwise {torch.equal(out_k, out_p)}")
    del out_k, out_p
    # The stages in turns (ms a call) and under the profiler (device us a
    # launch), each against the stage before it; then `enc` and bf16 B6's
    # forward on the same rays and z, in turns: the encode's share of B6.
    stages = {st: (lambda st=st: pk.enc_cost(rd, z, st)) for st in pk.ENC_STAGES}
    stage_ms, stage_passes = _in_turns(torch, stages, ENC_TURN_CALLS)
    b6 = {"b6_fwd": lambda: rk.raymarch_fwd(ws, bs, cfg, rd, z, torch.bfloat16),
          "enc": stages["enc"]}
    b6_ms, b6_passes = _in_turns(torch, b6, B6_TURN_CALLS)
    dev = _profiled_device_us(torch, {**stages, "b6_fwd": b6["b6_fwd"]},
                              {**{st: f"enc_cost_kernel<{i}>"
                                  for i, st in enumerate(pk.ENC_STAGES)},
                               "b6_fwd": "rm_fwd_mma_kernel"})
    dev_us = {k: v and v["us"] for k, v in dev.items()}
    names = pk.ENC_STAGES
    diffs_ms = {f"{b} - {a_}": stage_ms[b] - stage_ms[a_] for a_, b in zip(names, names[1:])}
    diffs_us = {f"{b} - {a_}": (dev_us[b] - dev_us[a_] if dev_us[a_] and dev_us[b] else None)
                for a_, b in zip(names, names[1:])}
    spread_ms = {k: abs(v[0] - v[1]) for k, v in stage_passes.items()}
    spread_us = {k: v and abs(v["passes"][0] - v["passes"][1]) for k, v in dev.items()}
    share = b6_ms["enc"] / b6_ms["b6_fwd"]
    share_dev = (dev_us["enc"] / dev_us["b6_fwd"] if dev_us["enc"] and dev_us["b6_fwd"]
                 else None)
    rows = n_rays * n_s
    # A row of the `enc` stage: the point under each of its 33 xyz columns (a
    # product and a sum, not contracted), an angle for each of the 54 other
    # columns (a product, and for the cos half a sum) and their 54 sines.
    n_sin = cfg.xyz_dim - 3 + cfg.dir_dim
    enc_flops = 2 * cfg.xyz_dim + n_sin + n_sin // 2 + SINF_FLOPS * n_sin
    rec["probe_enccost"] = _probe_record(
        torch, stages["enc"], lambda: pk.enc_cost_plain(rd, z, "enc"), None,
        max(stage_err.values()),
        _bound(rows * enc_flops, PEAK_FLOPS["float32"], 4 * (rd.numel() + z.numel() + rows * 4)),
        ms=stage_ms["enc"], rays=n_rays, samples=n_s, stage="enc", ms_stages=stage_ms,
        ms_stage_passes=stage_passes, ms_stage_spread=spread_ms, ms_stage_diffs=diffs_ms,
        device_us_stages=dev_us, device_us_spread=spread_us, device_us_diffs=diffs_us,
        device_us_passes={k: v and v["passes"] for k, v in dev.items()},
        max_abs_err_by_stage=stage_err, b6_fwd_in_turns=b6_ms, b6_fwd_passes=b6_passes,
        enc_share_of_b6_fwd=share, enc_share_of_b6_fwd_device=share_dev,
        design="bf16 B6's input build (build_mma_inputs) at B6's 128-row block and forward "
               "memory, cut by its stage; stages nest")
    log(f"P7 ms a call in turns ({ENC_TURN_CALLS} calls a pass): "
        + ", ".join(f"{k} {v:.5f}" for k, v in stage_ms.items())
        + "; differences " + ", ".join(f"{k} {v:+.5f}" for k, v in diffs_ms.items())
        + "; spread of the two passes " + ", ".join(f"{k} {v:.5f}" for k, v in spread_ms.items()))
    log("P7 device us a launch (profiler, mean of two passes): "
        + ", ".join(f"{k} {v:.3f}" if v else f"{k} not recorded" for k, v in dev_us.items())
        + "; differences " + ", ".join(f"{k} {v:+.3f}" if v is not None else f"{k} n/a"
                                       for k, v in diffs_us.items())
        + "; spread " + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} n/a"
                                  for k, v in spread_us.items()))
    log(f"P7 enc and bf16 B6 forward at {n_rays} x {n_s}, ms in turns ({B6_TURN_CALLS} calls a "
        f"pass): B6 {b6_ms['b6_fwd']:.4f}, enc {b6_ms['enc']:.4f} (passes {b6_passes}); the "
        f"encode's share of B6's forward {share:.4f} (device {share_dev})")

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


# Each probe's launches in its tool's main([]): a case's warm-up call and its
# timed calls (the tools' default reps: 10, exp_expand 50, exp_enccost 20),
# plus a comparison call where the tool makes one. exp_mxu: five cases;
# exp_vpu: three variants, each compared with B1; exp_interleave: chains 1 and
# 2 each compared with B1, 4 chains refused before any launch; exp_expand:
# one case a kernel; exp_enccost: six stages.
TOOL_LAUNCHES = {"probe_mma": 5 * (1 + 10), "probe_mlp_epilogue": 3 * (2 + 10),
                 "probe_mlp_chains": 2 * (2 + 10), "probe_expand_a": 1 + 50,
                 "probe_expand_b": 1 + 50, "probe_expand_c": 1 + 50,
                 "probe_enccost": 6 * (1 + 20)}


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
        wrong = {k: got[k] for k in kernels if k in TOOL_LAUNCHES and got[k] != TOOL_LAUNCHES[k]}
        if wrong:
            raise AssertionError(f"{name}: launches {wrong}, expected "
                                 f"{ {k: TOOL_LAUNCHES[k] for k in wrong} }")
        log(f"{name}: main-path launches { {k: got[k] for k in kernels} }")
        launches.update({k: got[k] for k in kernels if k.startswith("probe_")})
    return launches


# --------------------------------------------------------------------------- #
# Profiler phase                                                               #
# --------------------------------------------------------------------------- #

PROFILE_STEPS = 4


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0)))


def _on_device(evt) -> bool:
    return str(evt.device_type).endswith("CUDA")


def _device_window(prof, what: str):
    """A trace's device-side entries by time, most first (kernels and memory
    operations: the host-side operations carry their kernels' time a second
    time), and its window: the device operations' count, the time from the
    first to the last (``window_ms``), the time some operation ran
    (``busy_ms``) and the rest's share (``idle_share``)."""
    averages = sorted((a for a in prof.key_averages() if _on_device(a)), key=_device_us,
                      reverse=True)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if _on_device(e))
    total_us = sum(_device_us(a) for a in averages)
    if not spans or total_us <= 0:
        raise AssertionError(f"{what}: the profiler recorded no device time ({len(spans)} device "
                             f"events, {total_us} us): the idle share cannot be read")
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
    return averages, {"device_ops": len(spans), "window_ms": window / 1e3, "busy_ms": busy / 1e3,
                      "idle_share": 1.0 - busy / window}


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

    averages, window = _device_window(prof, f"profiled {backend} steps")
    (log_dir / "ops.txt").write_text("\n".join(
        f"{_device_us(a):14.1f} us  {a.count:6d} calls  {a.key}" for a in averages))
    total_us = sum(_device_us(a) for a in averages)
    rec = {"backend": backend, "steps": PROFILE_STEPS, "host_seconds": wall, **window,
           "top": [{"name": a.key[:120], "ms": _device_us(a) / 1e3, "calls": a.count}
                   for a in averages[:10]]}
    log(f"profile: {PROFILE_STEPS} {backend} steps, traced window {rec['window_ms']:.3f} ms "
        f"(first to last device operation; host clock {wall * 1e3:.1f} ms with the "
        f"profiler's start and stop), device busy {rec['busy_ms']:.3f} ms, idle share "
        f"{rec['idle_share']:.4f}, {rec['device_ops']} device operations")
    for a in averages[:10]:
        log(f"profile top: {_device_us(a) / 1e3:10.3f} ms {100 * _device_us(a) / total_us:5.1f}% "
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

def _sphere_view(pos, size: int, fov: float):
    """The camera at ``pos`` looking at the origin, and where its ``size`` x
    ``size`` pixel rays meet the unit sphere: ``(c2w, hit, normal)``, in
    ``core/cameras.rays_for_image``'s conventions (pixel centres at +0.5, y
    up, the camera looking down -z, ``tan(fov / 2)``)."""
    import numpy as np

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
    return c2w, disc > 0, pos + t[..., None] * d


def _scene(images, poses, fov):
    import numpy as np

    from nerf_and_dietnerf_tpu_torch.data.loaders import Dataset

    return Dataset(
        images=np.asarray(images, np.float32), camera_poses=np.asarray(poses, np.float32),
        field_of_view=fov, near=2.0, far=6.0,
        average_c2w_before_recenter=np.eye(4), scale=1.0,
    )


def synthetic_scene(n_views=9, size=128, seed=SEED):
    """A unit sphere coloured by its normal (0.5 + 0.5 n), black background,
    seen by ``n_views`` cameras on a radius-4 ring looking at the origin.
    Rendered analytically in numpy, so the views are consistent."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fov = 0.7
    poses, images = [], []
    for i in range(n_views):
        phi = 2 * math.pi * i / n_views + rng.uniform(-0.1, 0.1)
        c2w, hit, normal = _sphere_view(
            np.array([4 * math.sin(phi), 1.0, 4 * math.cos(phi)]), size, fov)
        poses.append(c2w)
        images.append(np.where(hit[..., None], 0.5 + 0.5 * normal, 0.0))
    return _scene(images, poses, fov)


# The quality scene's held-out views: every QUALITY_HOLD_EVERY-th view from
# QUALITY_HOLD_FIRST on, interleaved between the training views.
QUALITY_HOLD_EVERY = 8
QUALITY_HOLD_FIRST = 3


def quality_held_out(n_views: int) -> list:
    return list(range(QUALITY_HOLD_FIRST, n_views, QUALITY_HOLD_EVERY))


def quality_scene(n_views=48, size=128, seed=SEED):
    """The training-quality scene: a unit sphere painted with a
    view-independent texture of latitude and longitude at a few frequencies
    (continuous at the poles), black background, seen by ``n_views`` cameras at radius 4 on the upper
    hemisphere (Blender's synthetic scenes' layout: azimuths a golden angle
    apart, elevations from 0.1 to 1.1 rad, a little jitter from ``seed``),
    looking at the origin; near 2, far 6. Rendered analytically in numpy, so
    the views are consistent. Held out: ``quality_held_out(n_views)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fov = 0.7
    poses, images = [], []
    for i in range(n_views):
        phi = i * math.pi * (3 - math.sqrt(5)) + rng.uniform(-0.05, 0.05)
        elev = 0.1 + 1.0 * ((i * 0.618034) % 1.0) + rng.uniform(-0.02, 0.02)
        pos = 4 * np.array([math.cos(elev) * math.sin(phi), math.sin(elev),
                            math.cos(elev) * math.cos(phi)])
        c2w, hit, n = _sphere_view(pos, size, fov)
        lat = np.arcsin(np.clip(n[..., 1], -1.0, 1.0))
        lon = np.arctan2(n[..., 0], n[..., 2])
        rgb = np.stack([
            0.5 + 0.3 * np.sin(2 * lon + 1.0) * np.cos(lat) + 0.15 * np.sin(5 * lat),
            0.5 + 0.3 * np.cos(3 * lat) + 0.15 * np.sin(4 * lon) * np.cos(lat),
            0.5 + (0.25 * np.sin(lon - 2 * lat) + 0.2 * np.cos(6 * lon)) * np.cos(lat),
        ], -1)
        poses.append(c2w)
        images.append(np.where(hit[..., None], rgb, 0.0))
    return _scene(images, poses, fov)


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


def _patch_vs_cpu(torch, params, cfg, ds, c2w, label: str, target=None) -> dict:
    """The 32x32-ray patch from the middle of the view ``c2w``, rendered as
    the eval renders render (``nerf.render`` with the f32 config ``cfg``,
    coarse + fine), on the card (f32 B1) and on the CPU (the plain path), from
    the same weights and the same injected ``strat_u`` / ``fine_u`` draws.
    Fails if a pixel differs by more than ``TOL_PATCH``; with ``target`` (the
    view's pixels) records both PSNRs."""
    import numpy as np

    from nerf_and_dietnerf_tpu_torch.core import cameras, rendering
    from nerf_and_dietnerf_tpu_torch.models import nerf
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_map

    h0, w0 = (ds.height - EVAL_PATCH) // 2, (ds.width - EVAL_PATCH) // 2
    orig, dirs = cameras.rays_for_image(
        ds.height, ds.width, ds.field_of_view,
        torch.as_tensor(np.asarray(c2w, np.float32), device=DEVICE))
    patch = (slice(h0, h0 + EVAL_PATCH), slice(w0, w0 + EVAL_PATCH))
    orig, dirs = (t.reshape(ds.height, ds.width, -1)[patch].reshape(EVAL_PATCH ** 2, -1)
                  .contiguous() for t in (orig, dirs))
    rng = np.random.default_rng(SEED)
    n = EVAL_PATCH ** 2
    draws = {"strat_u": rng.uniform(size=(n, cfg.n_samples_coarse)).astype(np.float32),
             "fine_u": np.sort(rng.uniform(size=(n, cfg.n_samples_fine)), -1).astype(np.float32)}
    out = {}
    for dev in (DEVICE, "cpu"):
        params_dev = tree_map(lambda t, d=dev: t.detach().to(d), params)
        before = kl.LAUNCHES["mlp_fwd"]
        result, _ = nerf.render(params_dev, cfg, None, orig.to(dev), dirs.to(dev),
                                diagnostics=False,
                                draws={k: torch.as_tensor(v, device=dev) for k, v in draws.items()})
        out[dev] = result.rgb.detach().float().cpu()
        launched = kl.LAUNCHES["mlp_fwd"] - before
        kl.LAUNCHES["mlp_fwd"] = before
        if (dev == DEVICE) != (launched > 0):
            raise AssertionError(f"{label} on {dev}: {launched} launches of mlp_fwd")
    diff = float((out[DEVICE] - out["cpu"]).abs().max())
    rec = {"rays": n, "max_abs_pixel_diff": diff, "tol": TOL_PATCH}
    text = ""
    if target is not None:
        target = torch.as_tensor(target[patch]).reshape(-1, 3)
        psnr = {dev: float(rendering.psnr(target, rgb)) for dev, rgb in out.items()}
        rec.update(psnr_card=psnr[DEVICE], psnr_cpu=psnr["cpu"])
        text = f", PSNR card {psnr[DEVICE]:.4f} dB, CPU {psnr['cpu']:.4f} dB"
    log(f"{label} {EVAL_PATCH}x{EVAL_PATCH} (f32, {cfg.backend}): card vs CPU max |pixel diff| "
        f"{diff:.3e} (tol {TOL_PATCH}){text}")
    if not (math.isfinite(diff) and diff <= TOL_PATCH):
        raise AssertionError(f"{label}: card and CPU renders differ by {diff} > {TOL_PATCH}")
    return rec


def eval_patch_phase(torch, timings: dict, trainer) -> None:
    """The held-out view's patch (``_patch_vs_cpu``) from the trainer's
    weights, with both PSNRs against the view's pixels."""
    ds, idx = trainer.dataset, trainer.run.test_img_idx
    timings["eval_patch"] = _patch_vs_cpu(
        torch, trainer.state.params, trainer.eval_config, ds, ds.camera_poses[idx],
        f"eval patch of view {idx}", target=ds.images[idx])


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


# --------------------------------------------------------------------------- #
# The quality phase: held-out PSNR of the training paths                       #
# --------------------------------------------------------------------------- #

# The flagship widths and batch (_flagship_run) on quality_scene at 128x128:
# 48 views, 6 held out, 42 x 16,384 rays = 168 steps of 4,096 rays an epoch,
# QUALITY_EPOCHS epochs a path, the lr decaying to QUALITY_LR_FINAL. Each
# path: (backend, compute type, its plain twin). The three bf16 fused paths
# train with FUSED_PATHS' model-config changes (B7; B4 on both passes; B4
# coarse and B5 fine: _quality_fusions) and are held against "xla" in bf16,
# the same training in other roundings; their eval renders, like every
# path's, run f32 with the fusions off (Trainer.eval_config), so what tells
# them from "pallas" / "pallas_rm" is their training. Every path starts from
# the same init_seed and draws the same permutations and uniforms (the epoch
# seeds), so a kernel path and its twin train in lockstep apart from their
# roundings.
QUALITY_DIR = ROOT / "build" / "chip_smoke_quality"
QUALITY_VIEWS = 48
QUALITY_SIZE = 128
QUALITY_EPOCHS = 3
QUALITY_PATHS = {
    "xla": ("xla", "bfloat16", None),
    "pallas": ("pallas", "bfloat16", "xla"),
    "pallas_rm": ("pallas_rm", "bfloat16", "xla"),
    **{path: (FUSED_PATHS[path]["backend"], "bfloat16", "xla")
       for path in ("pallas_rm_fused", "pallas_fused", "pallas_fused_loss")},
    "xla_f32": ("xla", "float32", None),
    "pallas_f32": ("pallas", "float32", "xla_f32"),
}
# The lr decays exponentially from the flagship's 5e-4 to this over the run,
# the JAX package's remedy for constant-lr oscillation near convergence
# (runs/256px_alexander_nerf_r04/RESULTS.md; runs/256px_alexander_nerf_r04_decay):
# at a constant lr a path's last epoch can lose 2-4 dB of held-out PSNR to
# an oscillation that another rounding of the same training escapes.
QUALITY_LR_FINAL = 5e-5
# The PSNR of the held-out views' pooled MSE (deterministic f32 renders) must
# rise by QUALITY_RISE_DB from the initial weights to the last epoch's on
# every path, and a kernel path may end at most QUALITY_WINDOW_DB below its
# plain twin. Over init seeds 1 and 2 (``python3 chip_smoke.py seeds quality 1 2``)
# every path rose 18.47-19.47 dB, to 27.18-28.08, and the five paths of a
# seed, the same training in other roundings, ended at most 0.83 dB apart,
# no kernel path below its twin.
QUALITY_RISE_DB = 15.0
QUALITY_WINDOW_DB = 1.5


def _digest(torch, tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _first_step_recorded(torch, rec: dict):
    """Records into ``rec`` the digests of the first ``train_step``'s ray
    batch (the permutation's first rows) and of the uniforms that step draws:
    drawn from a copy of its generator's state as ``nerf.training_mses``
    draws them (``nerf.draw_training_uniforms``); the step itself is left as
    it is. Also the digests of the copy's state after those draws and of the
    generator's after the step: equal when the step drew just those."""
    from nerf_and_dietnerf_tpu_torch.models import nerf
    from nerf_and_dietnerf_tpu_torch.train import train_step as ts

    step = ts.train_step

    def first(state, key, batch, **kw):
        if rec:
            return step(state, key, batch, **kw)
        gen = torch.Generator(device=key.device)
        gen.set_state(key.get_state())
        draws = nerf.draw_training_uniforms(gen, kw["config"], batch[0].shape[0],
                                            state.params.get("fine") is not None, key.device)
        rec.update(batch=_digest(torch, batch), draws=_digest(torch, draws.values()),
                   drawn=sorted(draws), rng_after_draws=_digest(torch, [gen.get_state()]))
        out = step(state, key, batch, **kw)
        rec["rng_after_step"] = _digest(torch, [key.get_state()])
        return out

    ts.train_step = first
    try:
        yield
    finally:
        ts.train_step = step


def _held_out_psnr(torch, trainer, views, config=None) -> dict:
    """Deterministic (``key=None``) renders of ``views`` from the trainer's
    weights through ``config`` (its f32 eval config by default): each view's
    PSNR and the PSNR of their pooled MSE."""
    from nerf_and_dietnerf_tpu_torch.models import nerf

    ds = trainer.dataset
    mses = []
    for i in views:
        result, _ = nerf.render_image(
            trainer.state.params, config or trainer.eval_config, None, ds.camera_poses[i],
            ds.field_of_view, ds.height, ds.width, chunk_size=trainer.run.offline_chunk_size(),
            diagnostics=False, device=DEVICE)
        rgb = result.rgb.float().cpu()
        if rgb.shape != (ds.height, ds.width, 3) or not bool(torch.isfinite(rgb).all()):
            raise AssertionError(f"bad held-out render of view {i}: {tuple(rgb.shape)}")
        mses.append(float(torch.mean(torch.square(rgb - torch.as_tensor(ds.images[i])))))
    return {"views": [-10 * math.log10(m) for m in mses],
            "pooled": -10 * math.log10(sum(mses) / len(mses))}


def _quality_fusions(path: str) -> dict:
    """The fusion flags a quality path's model config takes on top of its
    run config's (FUSED_PATHS' own; none for an unfused path)."""
    return {k: v for k, v in FUSED_PATHS.get(path, {}).items() if k.startswith("fuse_")}


def _quality_launches(path: str, steps: int, n_held: int) -> dict:
    """The exact launches of a quality path's QUALITY_EPOCHS epochs and final
    renders: under "pallas" / "pallas_rm" two forwards and two backwards a
    step; a fused path's kernels (MAIN_PATHS) twice a step each, once with
    ``fuse_fine_loss`` (B4 coarse, B5 fine); and the unfused backend's f32
    forward twice (coarse, fine) for each of an epoch's two eval frames and
    each final held-out render (one chunk a 128x128 frame); none under
    "xla"."""
    backend = QUALITY_PATHS[path][0]
    if backend == "xla":
        return {}
    fwd, bwd = MAIN_PATHS[backend]
    n, evals = steps * QUALITY_EPOCHS, 4 * QUALITY_EPOCHS + 2 * n_held
    fusions = _quality_fusions(path)
    if not fusions:
        return {fwd: 2 * n + evals, bwd: 2 * n}
    a_step = 1 if fusions.get("fuse_fine_loss") else 2
    return {**{k: a_step * n for k in MAIN_PATHS[path]}, fwd: evals}


def _quality_path(torch, ds, path: str, held: list, train: list, seed: int):
    """QUALITY_EPOCHS epochs of the ``Trainer`` on ``path`` from the init seed
    ``seed`` and the epoch seeds, with the launch counts set to 0 just before
    and read after the final held-out renders; returns ``(record,
    trainer)``."""
    import dataclasses

    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.train.trainer import Trainer
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

    backend, compute_dtype, _ = QUALITY_PATHS[path]
    run = dataclasses.replace(
        _flagship_run(backend, compute_dtype), n_epochs=QUALITY_EPOCHS, init_seed=seed,
        optimizer_lr_final=QUALITY_LR_FINAL,
        test_img_idx=held[0], idx_train_img_to_plot=train[0],
        pics_indices_to_use_in_dataset=train)
    trainer = Trainer(run, ds, QUALITY_DIR / path, device=DEVICE)
    # The step's model config, which the Trainer reads at its first epoch;
    # its eval config was set at construction (f32, fusions off).
    trainer.config = dataclasses.replace(trainer.config, **_quality_fusions(path))
    steps = trainer.data.batches_per_epoch
    lockstep = {"init_params": _digest(torch, tree_leaves(trainer.state.params))}
    before = _held_out_psnr(torch, trainer, held)
    first: dict = {}
    torch.cuda.synchronize()
    kl.reset_launch_counts()
    with _first_step_recorded(torch, first):
        stats = [trainer.train_epoch(e) for e in range(1, QUALITY_EPOCHS + 1)]
    after = _held_out_psnr(torch, trainer, held)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kl.LAUNCHES.items() if v}
    lockstep.update(first)
    # The same weights through the plain f32 eval: what the kernel path's
    # training gave, apart from its eval renders' kernel.
    plain_eval = _held_out_psnr(torch, trainer, held, dataclasses.replace(
        trainer.eval_config, backend="xla")) if backend != "xla" else after
    rec = {
        "backend": backend, "compute_dtype": compute_dtype, "steps_per_epoch": steps,
        "psnr_test_per_epoch": [s.psnr_test for s in stats],
        "loss_per_epoch": [s.loss for s in stats],
        "held_out_before": before, "held_out_after": after,
        "held_out_after_plain_eval": plain_eval,
        "rise_db": after["pooled"] - before["pooled"],
        "ms_per_step": 1e3 * sum(s.seconds for s in stats[1:]) / (steps * (len(stats) - 1)),
        "ms_per_step_epoch1": 1e3 * stats[0].seconds / steps,
        "fusions": _quality_fusions(path),
        "launches": launches, "launches_expected": _quality_launches(path, steps, len(held)),
        "lockstep": lockstep,
    }
    log(f"quality {path} ({backend}, {compute_dtype} step, fusions {rec['fusions']}): held-out "
        f"PSNR {before['pooled']:.3f} -> {after['pooled']:.3f} dB (plain f32 eval of the same "
        f"weights {plain_eval['pooled']:.3f}; views "
        + ", ".join(f"{v:.2f}" for v in after["views"]) + "); psnr_test per epoch "
        + ", ".join(f"{v:.3f}" for v in rec["psnr_test_per_epoch"]) + "; loss "
        + ", ".join(f"{v:.5f}" for v in rec["loss_per_epoch"])
        + f"; {rec['ms_per_step']:.3f} ms a step (epochs 2-{QUALITY_EPOCHS}; epoch 1 "
        f"{rec['ms_per_step_epoch1']:.3f}); launches {launches} (expected "
        f"{rec['launches_expected']}); lockstep {lockstep}")
    return rec, trainer


def _trained_field_checks(torch, trainer) -> dict:
    """B1 and B2 against their plain versions (:func:`_mlp_checks`, its
    tolerances) on the coarse pass of one 4,096-ray batch of the quality
    scene's training rays through a trained field, in bf16 and f32, with the
    cotangents :func:`_inputs` draws; records the share of samples at a leaky
    kink (a pre-activation of the plain forward on the other side of 0 from
    the f64 chain's, ``_vs_f64_chain``) and of opaque rays (coarse weights
    summing past 0.999)."""
    import dataclasses

    from nerf_and_dietnerf_tpu_torch.core import sampling
    from nerf_and_dietnerf_tpu_torch.models import nerf
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc

    config, cfg = trainer.config, trainer.config.mlp
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    tables = [torch.as_tensor(a, device=DEVICE) for a in (trainer.data.origins,
                                                          trainer.data.directions)]
    idx = torch.randperm(tables[0].shape[0], generator=gen, device=DEVICE)[:RAYS]
    orig, dirs = (t[idx] for t in tables)
    z = sampling.stratified_z_values(gen, config.near, config.far, (RAYS,), SAMPLES,
                                     device=DEVICE)
    params = trainer.state.params["coarse"]
    with torch.no_grad():
        plain = dataclasses.replace(trainer.eval_config, backend="xla")
        weights = nerf.render_rays(params, plain, orig, dirs, z).weights
        enc_xyz, enc_dir = nerf._encodings_per_ray(config, orig, dirs, z)
    enc_dir = enc_dir[:, None, :].expand(RAYS, SAMPLES, cfg.dir_dim).reshape(RAYS * SAMPLES, -1)
    out = {"rows": RAYS * SAMPLES,
           "opaque_ray_share": float((weights.sum(-1) > 0.999).float().mean())}
    for cd in (torch.bfloat16, torch.float32):
        name = str(cd).split(".")[-1]
        ws, bs = rc.flatten_params(params, cfg, cd)
        x, d = enc_xyz.to(cd).contiguous(), enc_dir.to(cd).contiguous()
        g = (0.5 + torch.rand((RAYS * SAMPLES, 4), generator=gen, device=DEVICE)).contiguous()
        abs_fwd, abs_bwd, exact = _mlp_checks(torch, rc, ws, bs, cfg, x, d, g, cd, name,
                                              f"trained field {name} rows={RAYS * SAMPLES}")
        out[name] = {"max_abs_err_fwd": abs_fwd, "max_abs_err_bwd": abs_bwd,
                     "leaky_kink_share": exact["rows_with_a_branch_flip"]}
    log(f"trained field: opaque rays {out['opaque_ray_share']:.4f}, samples at a leaky kink "
        f"bf16 {out['bfloat16']['leaky_kink_share']:.4e}, f32 "
        f"{out['float32']['leaky_kink_share']:.4e}")
    return out


def quality_phase(torch, timings: dict, seed: int = SEED) -> None:
    """Every path of QUALITY_PATHS trained on quality_scene (QUALITY_EPOCHS
    epochs of the ``Trainer`` at the flagship widths) from the init seed
    ``seed``: "xla", "pallas", "pallas_rm" and the three fused paths
    ("pallas_rm" + ``fuse_compositing``, "pallas" + ``fuse_compositing``,
    "pallas" + both flags) in bf16, "xla" and "pallas" in f32; then B1 and
    B2 held on the trained "pallas" field (:func:`_trained_field_checks`).
    Raises, after recording everything, if a path's held-out PSNR does not
    rise by QUALITY_RISE_DB, a kernel path ends more than QUALITY_WINDOW_DB
    below its plain twin, a launch count is off, two paths' initial weights,
    first batch or first uniforms differ, or a first step draws other than
    ``nerf.draw_training_uniforms``."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(QUALITY_DIR, ignore_errors=True)
    ds = quality_scene(QUALITY_VIEWS, QUALITY_SIZE)
    held = quality_held_out(QUALITY_VIEWS)
    train = [i for i in range(QUALITY_VIEWS) if i not in held]
    log(f"quality: {len(train)} training views of {QUALITY_SIZE}x{QUALITY_SIZE}, held out "
        f"{held}, {QUALITY_EPOCHS} epochs a path")
    paths, field = {}, None
    for path in QUALITY_PATHS:
        paths[path], trainer = _quality_path(torch, ds, path, held, train, seed)
        if path == "pallas":
            field = _trained_field_checks(torch, trainer)
        del trainer
    faults = []
    ref = paths["xla"]["lockstep"]
    for path, rec in paths.items():
        if rec["lockstep"] != ref:
            faults.append(f"{path} is not in lockstep with xla: {rec['lockstep']} vs {ref}")
        if rec["lockstep"]["rng_after_step"] != rec["lockstep"]["rng_after_draws"]:
            faults.append(f"{path}: its first step drew other than draw_training_uniforms")
        if not rec["rise_db"] >= QUALITY_RISE_DB:
            faults.append(f"{path}: held-out PSNR rose {rec['rise_db']:.3f} dB < {QUALITY_RISE_DB}")
        if rec["launches"] != rec["launches_expected"]:
            faults.append(f"{path}: launches {rec['launches']} != {rec['launches_expected']}")
        twin = QUALITY_PATHS[path][2]
        if twin is not None:
            rec["below_twin_db"] = paths[twin]["held_out_after"]["pooled"] - \
                rec["held_out_after"]["pooled"]
            if not rec["below_twin_db"] <= QUALITY_WINDOW_DB:
                faults.append(f"{path} ends {rec['below_twin_db']:.3f} dB below {twin} "
                              f"(window {QUALITY_WINDOW_DB})")
    timings["quality"] = {
        "init_seed": seed, "views": QUALITY_VIEWS, "size": QUALITY_SIZE, "held_out": held,
        "epochs": QUALITY_EPOCHS, "rise_db_min": QUALITY_RISE_DB,
        "window_db": QUALITY_WINDOW_DB, "paths": paths, "trained_field": field,
        "seconds": time.perf_counter() - t0, "faults": faults}
    log(f"quality phase: {timings['quality']['seconds']:.1f} s; "
        + "; ".join(f"{p} {r['held_out_after']['pooled']:.3f} dB"
                    + (f" ({r['below_twin_db']:+.3f} dB below its twin)"
                       if "below_twin_db" in r else "") for p, r in paths.items()))
    if faults:
        print(json.dumps({"quality": timings["quality"]}), flush=True)
        raise AssertionError("quality phase: " + "; ".join(faults))


def seed_runs(torch, phase: str, seeds) -> int:
    """``python3 chip_smoke.py seeds PHASE SEED ...``: one phase alone (after
    the build), once from each seed, one line of its timings' JSON each: the
    spread over seeds that a phase's limits are read against. ``quality``
    and ``distributed`` take the seed as their runs' init seed; ``diet``
    runs both diet phases with the held step's draws from that seed on.
    Returns 1 if a seed's phase failed."""
    failed = []
    for seed in seeds:
        timings: dict = {}
        try:
            if phase == "diet":
                for backend in DIET_KERNELS:
                    diet_phase(torch, timings, backend, seed)
            else:
                {"quality": quality_phase, "distributed": distributed_phase}[phase](
                    torch, timings, seed)
        except AssertionError as e:
            failed.append(seed)
            log(f"{phase}, seed {seed}: {e}")
        else:
            print(json.dumps(timings), flush=True)
    log(f"{phase}, seeds {list(seeds)}: failed {failed}")
    return 1 if failed else 0


# --------------------------------------------------------------------------- #
# The runner phase: the CLI end to end                                         #
# --------------------------------------------------------------------------- #

# The runner phase's config: _flagship_run("pallas") with every task on, two
# epochs, and 4 video frames a second in place of the flagship's 60 (its only
# cut besides the scene): 20 left-to-right, 48 sphere and 24 waypoint frames,
# 16 interpolation frames and one ray-value frame, all f32 at 128x128.
RUNNER_FPS = 4
RUNNER_WAYPOINTS = (1, 2, 3)
RUNNER_DIR = ROOT / "build" / "chip_smoke_runner"
# The Runner methods the phase times, each with the launch counts set to 0
# just before it; render_video is named by the video it writes.
RUNNER_TASKS = ("training", "render_video", "save_dataset_video", "save_plot_video",
                "create_ray_value_plots", "create_interpolation_plot")
RUNNER_ORDER = ("training", "l_to_r", "sphere", "path", "save_dataset_video",
                "save_plot_video", "create_ray_value_plots", "create_interpolation_plot")


def _runner_run(n_epochs: int, all_tasks: bool):
    """``_flagship_run("pallas")`` as the runner phase's configs use it."""
    import dataclasses

    from nerf_and_dietnerf_tpu_torch.utils.config import TasksConfig, VideoConfig

    run = _flagship_run("pallas")
    run.n_epochs = n_epochs
    run.tasks = TasksConfig(**{f.name: all_tasks or f.name == "start_training"
                               for f in dataclasses.fields(TasksConfig)})
    run.video = VideoConfig(fps_render_video=RUNNER_FPS,
                            img_indices_for_path_video=list(RUNNER_WAYPOINTS))
    return run


def _runner_stand_ins(torch, configs: dict, ds, rec: dict):
    """The script-only stand-ins of the runner phase, for what the card's
    machine cannot import (PyYAML, h5py, cv2, matplotlib, imageio):
    ``config_lib.load_config`` returns the Python-built config named by the
    file's name; ``loaders.load_dataset`` returns ``synthetic_scene()``; the
    video and plot writers record what they are given into ``rec`` (the plot
    writers leave an empty file under the plot's real name, so the plot
    video's numbered-file filter reads a real directory); the ``.h5`` writer
    and reader keep the reference's file names and hold the parameters with
    ``torch.save``. The package keeps its real writers."""
    import copy

    import numpy as np

    from nerf_and_dietnerf_tpu_torch.data import loaders
    from nerf_and_dietnerf_tpu_torch.train import checkpoint
    from nerf_and_dietnerf_tpu_torch.utils import config as config_lib
    from nerf_and_dietnerf_tpu_torch.viz import plots, video

    def load_config(path):
        run = copy.deepcopy(configs[Path(path).name])
        run.config_name = Path(path).stem
        return run

    def touch(save_dir, name):
        out = Path(save_dir) / plots.PLOT_ITERATION_DIRNAME
        out.mkdir(parents=True, exist_ok=True)
        (out / name).touch()

    def save_frames_as_video(filename, frames, fps):
        rec["videos"].append((Path(filename).name, [np.asarray(f) for f in frames]))

    def save_plot_video(fps, plots_dir, out_path):
        rec["plot_video"].append((Path(out_path).name, video._numbered_images_in(plots_dir)))

    def save_test_image(save_dir, image):
        touch(save_dir, plots.TEST_IMG_FILENAME)

    def save_epoch_plot(save_dir, epoch, train_image, train_render, test_image, test_render,
                        psnrs_train, psnrs_test):
        touch(save_dir, plots.EPOCH_PLOT_FORMAT.format(epoch))
        rec["epoch_plots"].append(epoch)

    def save_ray_value_plots(save_dir, render_image, ray_coords, weights_b, cumprod_b, alpha_b,
                             rgb_b, epoch):
        rec["rays"].append(dict(render=render_image, weights=weights_b, cumprod=cumprod_b,
                                alpha=alpha_b, rgb=rgb_b))

    def save_interpolation_plot(save_dir, image1, image2, rendered):
        rec["interp"].append(list(rendered))

    def save_keras_h5(path, params, config):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(params, path)

    def load_keras_h5(path, config, has_fine=True, device="cpu"):
        params = torch.load(path, map_location=device, weights_only=False)
        return params if has_fine else {**params, "fine": None}

    return [(config_lib, "load_config", load_config),
            (loaders, "load_dataset", lambda *a, **k: ds),
            (video, "save_frames_as_video", save_frames_as_video),
            (video, "save_plot_video", save_plot_video),
            (plots, "save_test_image", save_test_image),
            (plots, "save_epoch_plot", save_epoch_plot),
            (plots, "save_ray_value_plots", save_ray_value_plots),
            (plots, "save_interpolation_plot", save_interpolation_plot),
            (checkpoint, "save_keras_h5", save_keras_h5),
            (checkpoint, "load_keras_h5", load_keras_h5)]


def _fwd_by_dtype(torch, module, name: str, kernel: str, by_dtype: dict):
    """A wrapper of the forward wrapper ``module.name`` (its last argument
    the compute type) counting ``kernel``'s launches by compute type."""
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl

    real = getattr(module, name)

    def counted(*args):
        before = kl.LAUNCHES[kernel]
        out = real(*args)
        key = str(args[-1]).replace("torch.", "")
        by_dtype[key] = by_dtype.get(key, 0) + kl.LAUNCHES[kernel] - before
        return out

    return (module, name, counted)


def _runner_meters(torch, tasks: list, epochs: list):
    """Wrappers of the ``Runner`` tasks (``RUNNER_TASKS``) that set the launch
    counts to 0 just before each and record its seconds, frames and launches
    into ``tasks``; of its epoch callback, recording each epoch into
    ``epochs``; and of B1's wrapper, counting its launches by compute type."""
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda
    from nerf_and_dietnerf_tpu_torch.tasks.runner import Runner
    from nerf_and_dietnerf_tpu_torch.viz import video

    labels = {video.FILENAME_RGB_L_TO_R: "l_to_r", video.FILENAME_RGB_SPHERE: "sphere",
              video.FILENAME_RGB_PATH: "path"}
    frames_of = {"create_ray_value_plots": 1, "create_interpolation_plot": 16}
    by_dtype: dict = {}
    swaps = []
    for name in RUNNER_TASKS:
        def timed(self, *args, _real=getattr(Runner, name), _name=name, **kwargs):
            torch.cuda.synchronize()
            kl.reset_launch_counts()
            by_dtype.clear()
            t0 = time.perf_counter()
            out = _real(self, *args, **kwargs)
            torch.cuda.synchronize()
            tasks.append({
                "task": labels[args[1]] if _name == "render_video" else _name,
                "seconds": time.perf_counter() - t0,
                "frames": len(args[0]) if _name == "render_video" else frames_of.get(_name),
                "launches": {k: v for k, v in kl.LAUNCHES.items() if v},
                "mlp_fwd_by_dtype": dict(by_dtype), "runner": self})
            return out
        swaps.append((Runner, name, timed))

    def epoch_callback(self, trainer, stats, _real=Runner._epoch_callback):
        epochs.append({"epoch": stats.epoch, "loss": stats.loss, "psnr_test": stats.psnr_test,
                       "step_loop_s": stats.seconds, "steps": trainer.data.batches_per_epoch,
                       "at": time.perf_counter()})
        return _real(self, trainer, stats)

    return swaps + [(Runner, "_epoch_callback", epoch_callback),
                    _fwd_by_dtype(torch, raymarch_cuda, "mlp_fwd", "mlp_fwd", by_dtype)]


def _runner_launch_check(task: dict, want: dict, want_by_dtype: dict) -> None:
    """A task's launches must be exactly ``want`` (no other kernel), and B1's
    split by compute type exactly ``want_by_dtype``."""
    if task["launches"] != want or task["mlp_fwd_by_dtype"] != want_by_dtype:
        raise AssertionError(
            f"runner task {task['task']}: launches {task['launches']} by type "
            f"{task['mlp_fwd_by_dtype']}, expected {want} by type {want_by_dtype}")


def _check_runner_tasks(tasks: list, n_epochs: int, steps: int) -> None:
    """Launches of each task: the training's bf16 steps (B1 and B2, two each)
    and its f32 eval renders (B1, two a frame, two frames an epoch); two f32
    B1 launches (coarse, fine: one chunk) a rendered frame; none elsewhere."""
    for t in tasks:
        if t["task"] == "training":
            bf16, f32 = 2 * steps * n_epochs, 2 * 2 * n_epochs
            _runner_launch_check(t, {"mlp_fwd": bf16 + f32, "mlp_bwd": bf16},
                                 {"bfloat16": bf16, "float32": f32})
        elif t["frames"] is None:
            _runner_launch_check(t, {}, {})
        else:
            _runner_launch_check(t, {"mlp_fwd": 2 * t["frames"]}, {"float32": 2 * t["frames"]})


def _check_frame(what: str, frame, ds) -> None:
    import numpy as np

    frame = np.asarray(frame)
    if frame.shape != (ds.height, ds.width, 3) or not np.isfinite(frame).all() \
            or frame.min() < 0 or frame.max() > 1:
        raise AssertionError(f"{what}: frame of shape {frame.shape}, range "
                             f"[{np.nanmin(frame)}, {np.nanmax(frame)}]")


def _check_depth_frame(what: str, frame, ds) -> None:
    """An equalised depth frame: (h, w), on the 256-level grid, from 0 to 1."""
    import numpy as np

    frame = np.asarray(frame)
    levels = frame * 255.0
    if frame.shape != (ds.height, ds.width) or not np.isfinite(frame).all() \
            or frame.min() != 0.0 or not abs(frame.max() - 1.0) < 1e-12 \
            or np.abs(levels - np.round(levels)).max() > 1e-9:
        raise AssertionError(f"{what}: depth frame of shape {frame.shape} is not equalised")


def runner_phase(torch, timings: dict) -> None:
    """The normal entry point, ``main.main([cfg])``, on the runner config
    (``_runner_run(2, all_tasks=True)``) through the script's stand-ins
    (``_runner_stand_ins``): every task in the reference's order with the
    launch counts set to 0 before each, its frames checked, a 32x32 patch of
    the first left-to-right pose card vs CPU from the trained weights; then
    the resume drill: ``main`` for 4 epochs of training, against ``main`` for
    2 and a second ``main`` resuming that directory to epoch 4, parameters
    and PSNR histories bitwise equal."""
    import shutil
    from unittest import mock

    import numpy as np

    from nerf_and_dietnerf_tpu_torch import main as cli
    from nerf_and_dietnerf_tpu_torch.train import checkpoint
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves
    from nerf_and_dietnerf_tpu_torch.viz import plots, video

    shutil.rmtree(RUNNER_DIR, ignore_errors=True)
    RUNNER_DIR.mkdir(parents=True)
    results = RUNNER_DIR / "Results"
    ds = synthetic_scene()
    resume = _runner_run(4, all_tasks=False)
    resume.existing_save_dir_name, resume.starting_epoch_number = "drill_split_save_dir_0", 2
    configs = {"runner.yaml": _runner_run(2, all_tasks=True),
               "drill_straight.yaml": _runner_run(4, all_tasks=False),
               "drill_split.yaml": _runner_run(2, all_tasks=False),
               "drill_resume.yaml": resume}
    for name in configs:
        (RUNNER_DIR / name).write_text(f"# {name}: the config is built in chip_smoke.py\n")
    rec = {k: [] for k in ("videos", "plot_video", "epoch_plots", "rays", "interp")}
    tasks, epochs = [], []

    def cli_run(name: str) -> float:
        del tasks[:], epochs[:]
        argv = [str(RUNNER_DIR / name), "--save-root", str(results)]
        if DEVICE == "cpu":
            argv += ["--platform", "cpu"]
        t0 = time.perf_counter()
        rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"main.main({argv}) returned {rc}")
        return time.perf_counter() - t0

    out: dict = {"fps_render_video": RUNNER_FPS}
    drill: dict = {}
    with contextlib.ExitStack() as stack:
        for owner, name, value in (_runner_stand_ins(torch, configs, ds, rec)
                                   + _runner_meters(torch, tasks, epochs)):
            stack.enter_context(mock.patch.object(owner, name, value))
        out["main_seconds"] = cli_run("runner.yaml")
        order = [t["task"] for t in tasks]
        if order != list(RUNNER_ORDER):
            raise AssertionError(f"runner tasks ran as {order}, expected {RUNNER_ORDER}")
        steps = epochs[0]["steps"]
        _check_runner_tasks(tasks, 2, steps)
        runner = tasks[0]["runner"]
        paths = {"l_to_r": runner.l_to_r_path_matrices(), "sphere": runner.sphere_path_matrices(),
                 "path": runner.waypoint_path_matrices()}
        for t in tasks[1:4]:
            if t["frames"] != len(paths[t["task"]]):
                raise AssertionError(f"{t['task']}: {t['frames']} frames rendered")
        want = [(name, len(paths[task])) for task, names in (
            ("l_to_r", (video.FILENAME_RGB_L_TO_R, video.FILENAME_DEPTH_L_TO_R)),
            ("sphere", (video.FILENAME_RGB_SPHERE, video.FILENAME_DEPTH_SPHERE)),
            ("path", (video.FILENAME_RGB_PATH, video.FILENAME_DEPTH_PATH))) for name in names]
        want.append((video.FILENAME_TRAIN_SET, len(ds) - 1))
        got = [(name, len(frames)) for name, frames in rec["videos"]]
        if got != want:
            raise AssertionError(f"videos written {got}, expected {want}")
        for name, frames in rec["videos"][:-1]:
            check = _check_depth_frame if "depths" in name else _check_frame
            for i, frame in enumerate(frames):
                check(f"{name} frame {i}", frame, ds)
        want_plots = [plots.EPOCH_PLOT_FORMAT.format(e) for e in (1, 2)]
        if rec["plot_video"] != [(video.FILENAME_PLOTS, want_plots)] or \
                rec["epoch_plots"] != [1, 2]:
            raise AssertionError(f"plot video of {rec['plot_video']}, expected {want_plots}")
        (rays,) = rec["rays"]
        _check_frame("ray-value render", rays["render"], ds)
        if rays["weights"].shape != (3, runner.run.n_render_samples_coarse) or not all(
                np.isfinite(rays[k]).all() for k in ("weights", "cumprod", "alpha", "rgb")):
            raise AssertionError("ray-value arrays: bad shape or non-finite values")
        (interp,) = rec["interp"]
        if len(interp) != 16:
            raise AssertionError(f"{len(interp)} interpolation frames, expected 16")
        for i, frame in enumerate(interp):
            _check_frame(f"interpolation frame {i}", frame, ds)
        missing = [e for e in (1, 2) if not checkpoint.nerf_h5_path(runner.save_dir, e).exists()]
        if missing:
            raise AssertionError(f"no .h5 of epochs {missing} in {runner.save_dir}")
        if not all(math.isfinite(e["loss"]) for e in epochs):
            raise AssertionError(f"non-finite training loss {[e['loss'] for e in epochs]}")
        out["tasks"] = [{k: v for k, v in t.items() if k != "runner"} for t in tasks]
        for t in out["tasks"]:
            if t["frames"]:
                t["ms_per_frame"] = 1e3 * t["seconds"] / t["frames"]
        out["epochs"] = [{k: v for k, v in e.items() if k != "at"} for e in epochs]
        out["s_per_epoch"] = epochs[1]["at"] - epochs[0]["at"]
        out["patch"] = _patch_vs_cpu(torch, runner._params, runner.render_config, ds,
                                     paths["l_to_r"][0], "runner patch of the first l_to_r pose")

        # The resume drill (constant lr: the schedule's length does not enter).
        for name, trained in (("drill_straight.yaml", 4), ("drill_split.yaml", 2),
                              ("drill_resume.yaml", 2)):
            seconds = cli_run(name)
            if [t["task"] for t in tasks] != ["training"]:
                raise AssertionError(f"{name}: tasks {[t['task'] for t in tasks]}")
            _check_runner_tasks(tasks, trained, steps)
            drill[name] = {"seconds": seconds, "epochs": [e["epoch"] for e in epochs]}
        if drill["drill_resume.yaml"]["epochs"] != [3, 4]:
            raise AssertionError(f"the resumed run trained {drill['drill_resume.yaml']}")

    dirs = [results / "drill_straight_save_dir_0", results / "drill_split_save_dir_0"]
    states = [checkpoint.CheckpointManager(d / "states").restore(4, map_location="cpu")
              for d in dirs]
    start = checkpoint.CheckpointManager(dirs[1] / "states").restore(2, map_location="cpu")
    a, b = (tree_leaves(s.params) for s in states)
    equal = len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))
    hist = [np.load(checkpoint.psnr_path(d, 4)) for d in dirs]
    drill.update(params_bitwise_equal=equal, psnr_histories_equal=bool(
        hist[0].shape == hist[1].shape == (2, 4) and np.array_equal(hist[0], hist[1])),
        steps=[s.step for s in states], psnr_test=hist[0][0].tolist())
    out["resume_drill"] = drill
    log(f"resume drill: 4 epochs straight vs 2 + resume + 2: parameters bitwise equal {equal}, "
        f"PSNR histories equal {drill['psnr_histories_equal']}, steps {drill['steps']}")
    if not (equal and drill["psnr_histories_equal"] and states[0].step == 4 * steps
            and not torch.equal(a[0], tree_leaves(start.params)[0])):
        raise AssertionError(f"resume drill: {drill}")
    timings["runner"] = out
    for t in out["tasks"]:
        log(f"runner {t['task']}: {t['seconds']:.3f} s" + (
            f", {t['frames']} frames, {t['ms_per_frame']:.2f} ms a frame" if t["frames"] else "")
            + f", launches {t['launches']}")
    log(f"runner: main.main {out['main_seconds']:.3f} s, {out['s_per_epoch']:.3f} s an epoch "
        f"(steps {out['epochs'][1]['step_loop_s']:.3f} s)")


# --------------------------------------------------------------------------- #
# The DietNeRF phases                                                          #
# --------------------------------------------------------------------------- #

# Two epochs of DietNeRF at the flagship DietNeRF config's widths
# (config_files/256px_alexander_71pics_sphere_dietnerf_use10pics.yaml: the
# "pallas" path's NeRF, the full ViT-B/32, the 150x150 consistency render at
# 55 + 55 samples in 2,500-ray chunks, K = 13, weight 0.1, 95 % of the steps)
# on the synthetic scene: 64 steps, budget int(64 * 0.95) = 60, diet steps at
# these counters.
DIET_DIR = ROOT / "build" / "chip_smoke_diet"
DIET_COUNTERS = [13, 26, 39, 52]
DIET_METRICS = {"loss", "loss_for_rays", "cosine_similarity_loss", "psnr_coarse", "psnr_fine"}
# The forward and backward kernels of each diet phase's step.
DIET_KERNELS = {"pallas": ("mlp_fwd", "mlp_bwd"), "pallas_rm": ("raymarch_fwd", "raymarch_bwd")}
# The diet step held on the card: its consistency loss and gradient from the
# trained weights, the NeRF in f32 and in the run's own bf16, through the
# kernels and through their plain versions, each against the plain chain with
# f64 products and sums in the MLP (the same roundings to bf16 in the bf16
# NeRF; the other operations as they are) resampling from that run's own
# CDFs. The coarse network's gradient flows only through the resampled z,
# whose inverse CDF divides by the CDF's step over each picked bin: where
# that bin's weight is near 0 the step is a difference of two f32 sums near
# 1, and a rounding of one weight moves it, and the gradient, by a large
# factor; a rounding also moves a pick across a bin edge or two z across
# each other in the merge. Against the chain on its own CDFs a draw's
# distance is then set by a few such rays, for the plain version as for the
# kernels (the first draw also prints the chain on its own resampling). The
# run's CDFs are held to the chain's own to TOL at every draw.
# With the ViT in its bf16 (the
# consistency loss as it trains), a difference in the last place of the
# rendered image can flip a bf16 rounding in the ViT and move the gradient by
# a share of a bf16 ulp (3e-3 normwise in a CPU rehearsal at small widths): the
# loss to TOL_DIET_LOSS relative, each network's gradient to TOL_DIET_GRAD
# normwise, which a fault of the step's wiring (O(1)) exceeds. With the ViT
# in f32 no rounding in it flips, and the kernels' gradient must lie at most
# F64_FACTOR times as far from the f64 chain as the plain version's, each
# distance pooled over DIET_DRAWS draws (the consistency loss's generator
# seeded with each): one draw's distances are set by a few rays, and their
# ratio read 0.06x to 14.8x over eight draws on the card, where pools of four
# read 0.26x to 2.09x.
TOL_DIET_LOSS = 1e-3
TOL_DIET_GRAD = 3e-2
DIET_DRAWS = 4
# The diet step's bf16 kernels (B1 and B2, or B6's forward and backward) are
# also held one launch at a time at the consistency render's shapes, which no
# other phase gives them: a chunk's coarse pass (2,500 rays x 55 samples,
# 137,500 rows) and its fine pass (55 + 55 merged, 275,000 rows), on the
# inputs the render builds at the run's first diet pose (the chunk of the
# image's middle rows), with the kernel phases' checks and tolerances
# (``_mlp_checks``, ``_rm_checks``: positive random cotangents, B6's drawn
# from SEED + 16).
DIET_CHECK_CHUNK = 4
# The checkpointed render's gradient against the same chunks' without
# checkpoint (same draws, same kernel launches): normwise.
TOL_DIET_CKPT = 1e-6


def _diet_run(backend: str):
    """``_flagship_run(backend)`` as a DietNeRF config: the training task
    alone, the random embedder allowed (the "pallas" phase passes weights)."""
    import dataclasses

    from nerf_and_dietnerf_tpu_torch.utils.config import TasksConfig

    run = _flagship_run(backend)
    run.type_of_model, run.allow_random_embedder = "DietNeRF", backend != "pallas"
    run.tasks = TasksConfig(**{f.name: f.name == "start_training"
                               for f in dataclasses.fields(TasksConfig)})
    return run


def _diet_recorders(torch, rec: dict):
    """Wrappers recording what a diet run does: each diet step's counter,
    pose, target, consistency loss and ms (host clock, synchronised before
    and after); each epoch's mean metrics; the DietTrainer that ``fit`` ran;
    the target embeddings' set-up time."""
    from nerf_and_dietnerf_tpu_torch.models import dietnerf
    from nerf_and_dietnerf_tpu_torch.train.diet_trainer import DietTrainer

    step, make, fit = dietnerf.diet_train_step, dietnerf.make_diet_epoch_fn, DietTrainer.fit
    embed = DietTrainer._embed_training_images

    def diet_train_step(state, key, batch, c2w, target, vit_params, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, key, batch, c2w, target, vit_params, **kw)
        torch.cuda.synchronize()
        rec["steps"].append({"counter": state.step + 1, "c2w": c2w.clone(),
                             "target": target.clone(), "ms": 1e3 * (time.perf_counter() - t0),
                             "cs_loss": out[1]["cosine_similarity_loss"]})
        return out

    def make_diet_epoch_fn(*args, **kwargs):
        epoch_fn = make(*args, **kwargs)

        def recorded(*a):
            state, metrics = epoch_fn(*a)
            rec["epochs"].append(metrics)
            return state, metrics
        return recorded

    def fit_(self, *args, **kwargs):
        rec["trainer"] = self
        return fit(self, *args, **kwargs)

    def embed_(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = embed(self)
        torch.cuda.synchronize()
        rec["embed_s"] = time.perf_counter() - t0
        return out

    return [(dietnerf, "diet_train_step", diet_train_step),
            (dietnerf, "make_diet_epoch_fn", make_diet_epoch_fn),
            (DietTrainer, "fit", fit_), (DietTrainer, "_embed_training_images", embed_)]


def _check_diet_run(label: str, rec: dict, launches: dict, by_dtype: dict, backend: str,
                    n_epochs: int = 2) -> dict:
    """A diet run's launches, exactly; its diet steps at ``DIET_COUNTERS``,
    each consistency loss in [0, weight]; every epoch's metrics finite under
    the JAX package's keys; the ``.h5`` of each epoch. The launches: 2 + 2 a
    plain step; a diet step adds, per chunk of the consistency render, a
    coarse and a fine forward, both again in the checkpoint's recompute, and
    their two backwards (the coarse pass gets a gradient through the
    resampled z); two f32 forwards an eval frame, two frames an epoch."""
    from nerf_and_dietnerf_tpu_torch.train import checkpoint

    trainer = rec["trainer"]
    diet = trainer.diet
    steps = trainer.data.batches_per_epoch * n_epochs
    chunks = -(-diet.cs_image_size ** 2 // diet.cs_chunk_rays)
    n_diet = len(DIET_COUNTERS)
    fwd, bwd = DIET_KERNELS[backend]
    bf16 = 2 * steps + n_diet * 4 * chunks
    want = {fwd: bf16 + 2 * 2 * n_epochs, bwd: 2 * steps + n_diet * 2 * chunks}
    want_by_dtype = {"bfloat16": bf16, "float32": 2 * 2 * n_epochs}
    got = {k: v for k, v in launches.items() if v}
    log(f"{label}: launches {got}, {fwd} by type {by_dtype} (expected {want}, {want_by_dtype})")
    if got != want or by_dtype != want_by_dtype:
        raise AssertionError(f"{label}: launches {got} by type {by_dtype}, expected {want} by "
                             f"type {want_by_dtype}")
    counters = [s["counter"] for s in rec["steps"]]
    cs = [float(s["cs_loss"]) for s in rec["steps"]]
    if counters != DIET_COUNTERS or trainer.consistency_budget != int(steps * diet.active_fraction):
        raise AssertionError(f"{label}: diet steps at {counters}, budget "
                             f"{trainer.consistency_budget}")
    if not all(0.0 <= v <= diet.weight for v in cs):
        raise AssertionError(f"{label}: consistency losses {cs} outside [0, {diet.weight}]")
    epochs = [{k: float(v) for k, v in m.items()} for m in rec["epochs"]]
    for m in epochs:
        if set(m) != DIET_METRICS or not all(math.isfinite(v) for v in m.values()) \
                or not 0.0 <= m["cosine_similarity_loss"] <= diet.weight:
            raise AssertionError(f"{label}: epoch metrics {m}")
    missing = [e for e in range(1, n_epochs + 1)
               if not checkpoint.nerf_h5_path(trainer.save_dir, e).exists()]
    if len(epochs) != n_epochs or missing:
        raise AssertionError(f"{label}: {len(epochs)} epochs, no .h5 of epochs {missing}")
    for e, m in enumerate(epochs, 1):
        log(f"{label} epoch {e}: " + " ".join(f"{k}={v:.6f}" for k, v in sorted(m.items())))
    step_ms = [s["ms"] for s in rec["steps"]]
    log(f"{label}: consistency losses {cs} at counters {counters}, each diet step's ms "
        f"{step_ms}")
    return {"launches": got, "by_dtype": dict(by_dtype), "diet_counters": counters,
            "cs_losses": cs, "diet_step_ms_in_run": step_ms, "epochs": epochs,
            "embed_s": rec["embed_s"], "budget": trainer.consistency_budget}


def _plain_twins(torch, work):
    """Patches that make the B1/B2 and B6 wrappers take their plain versions
    on the card, the MLP's products and sums in ``work`` (float64: the same
    roundings with nearly exact sums), results in f32."""
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
    from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk

    forward, backward = rc._forward_plain, rc.mlp_bwd_plain

    def fwd(ws, bs, cfg, x, d, cd):
        return forward(ws, bs, cfg, x, d, cd, work)[0].float()

    def bwd(ws, bs, cfg, x, d, g, cd, given_work=None, branches=None):
        if given_work is not None and given_work != work:
            raise ValueError(f"the plain twin in {work} was asked for {given_work}")
        dws, dbs, dx, dd = backward(ws, bs, cfg, x, d, g, cd, work, branches)
        return ([t.float() for t in dws], [t.float() for t in dbs], dx.float(),
                None if dd is None else dd.float())

    return [(m, name, value) for m in (rc, rk) for name, value in (
        ("uses_kernel", lambda x: False), ("mlp_fwd_plain", fwd), ("mlp_bwd_plain", bwd))]


def _cdf_recorded(record: list):
    """Patches that record each CDF the resampling draws from
    (``sampling.resampling_cdf``), detached, in call order; the values are
    unchanged."""
    from nerf_and_dietnerf_tpu_torch.core import sampling

    cdf_of = sampling.resampling_cdf

    def recorded(weights):
        cdf = cdf_of(weights)
        record.append(cdf.detach())
        return cdf

    return [(sampling, "resampling_cdf", recorded)]


def _cdf_replayed(record: list, own: list):
    """Patches that make a run resample from the CDFs ``record`` holds, in the
    same call order, with the gradient of its own (``own`` gets its own CDFs):
    the chain evaluated at another run's resampling, so that run's bin picks,
    merge orders and the conditioning of its inverse CDF."""
    from nerf_and_dietnerf_tpu_torch.core import sampling

    cdf_of, values = sampling.resampling_cdf, iter(record)

    def replayed(weights):
        cdf = cdf_of(weights)
        own.append(cdf.detach())
        return next(values) + (cdf - cdf.detach())

    return [(sampling, "resampling_cdf", replayed)]


def _pooled(draws) -> dict:
    """``{w: sqrt(sum ||g - c||^2 / sum ||c||^2)}`` over ``draws``, each
    ``{w: (||g - c||^2, ||c||^2)}``: the normwise distance of the draws'
    gradients stacked."""
    return {w: math.sqrt(sum(d[w][0] for d in draws) / sum(d[w][1] for d in draws))
            for w in draws[0]}


def _diet_held_step(torch, trainer, c2w, target, label: str, seed: int = SEED) -> dict:
    """The diet step's consistency loss and gradient from the trained
    weights at the run's first diet pose and target, the NeRF in f32 (TF32
    off) and in the run's bf16, with the same draws (a generator seeded
    alike) on the card: the kernels and their plain versions, each against
    the plain chain with f64 sums (``_plain_twins``) resampling from that
    run's CDFs (``_cdf_recorded`` / ``_cdf_replayed``), which are held to the
    chain's own to ``TOL``; each once with the ViT in bf16
    (``consistency_loss`` as it trains) at draw ``seed``, once in f32 (the
    same call with ``vit.extract_features`` given ``compute_dtype=float32``)
    at the ``DIET_DRAWS`` draws from ``seed`` on, pooled (:func:`_pooled`).
    Then the bf16 render's gradient with and without
    ``torch.utils.checkpoint`` (same chunks, draws and kernels)."""
    import dataclasses
    import functools
    import types
    from unittest import mock

    from nerf_and_dietnerf_tpu_torch.models import dietnerf, vit
    from nerf_and_dietnerf_tpu_torch.tools import chain
    from nerf_and_dietnerf_tpu_torch.train import train_step as ts
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

    params, diet, fov = trainer.state.params, trainer.diet, trainer.dataset.field_of_view
    vit_f32 = [(vit, "extract_features",
                functools.partial(vit.extract_features, compute_dtype=torch.float32))]

    def grads_of(loss_fn, patches=()):
        with contextlib.ExitStack() as stack:
            for owner, name, value in patches:
                stack.enter_context(mock.patch.object(owner, name, value))
            loss, _, grads = ts.loss_and_grads(params, lambda p: (loss_fn(p), None))
        return float(loss), {w: torch.cat([g.reshape(-1).double() for g in tree_leaves(grads[w])])
                             for w in ("coarse", "fine")}

    def at_draw(cfg, patches, draw: int, own_resampling: bool):
        """One draw's record, and each run's squared distances to its chain."""

        def consistency(p):
            key = torch.Generator(device=DEVICE).manual_seed(draw)
            return dietnerf.consistency_loss(p, trainer.vit_params, cfg, diet, key, c2w, fov,
                                             target)[0]

        cdfs = {"kernel": [], "plain": []}
        runs = {"kernel": grads_of(consistency, patches + _cdf_recorded(cdfs["kernel"])),
                "plain": grads_of(consistency, patches + _plain_twins(torch, torch.float32)
                                  + _cdf_recorded(cdfs["plain"]))}
        own = {name: [] for name in runs}
        chains = {name: grads_of(consistency, patches + _plain_twins(torch, torch.float64)
                                 + _cdf_replayed(cdfs[name], own[name]))
                  for name in runs}
        rec: dict = {"draw": draw, "loss_f64_chain": chains["kernel"][0]}
        squares = {}
        for name in ("kernel", "plain"):
            (loss, g), (c_loss, c_g) = runs[name], chains[name]
            squares[name] = {w: (float((g[w] - c_g[w]).square().sum()),
                                 float(c_g[w].square().sum())) for w in g}
            rec[name] = {"loss_rel": abs(loss - c_loss) / abs(c_loss),
                         **_pooled([squares[name]]),
                         "cdf": max(chain.normwise(r, o) for r, o in
                                    zip(cdfs[name], own[name]))}
        rec["kernel_vs_plain"] = {w: float((runs["kernel"][1][w] - runs["plain"][1][w]).norm()
                                           / runs["plain"][1][w].norm())
                                 for w in ("coarse", "fine")}
        if own_resampling:  # printed, not held: against the chain on its own resampling
            _, own_g = grads_of(consistency, patches + _plain_twins(torch, torch.float64))
            rec["vs_f64_own_resampling"] = {
                name: {w: float((runs[name][1][w] - own_g[w]).norm() / own_g[w].norm())
                       for w in own_g} for name in runs}
        return rec, squares

    out: dict = {}
    for nerf_type, cfg in (("float32", dataclasses.replace(trainer.config,
                                                           compute_dtype=torch.float32)),
                           ("bfloat16", trainer.config)):
        for vit_type, patches in (("bfloat16", []), ("float32", vit_f32)):
            t0 = time.perf_counter()
            n = 1 if vit_type == "bfloat16" else DIET_DRAWS
            held = [at_draw(cfg, patches, seed + k, k == 0) for k in range(n)]
            recs = [rec for rec, _ in held]
            pooled = {name: _pooled([sq[name] for _, sq in held]) for name in ("kernel", "plain")}
            what = f"{label} held diet step ({nerf_type} NeRF, {vit_type} ViT)"
            for rec in recs:
                log(f"{what} draw {rec['draw']}: consistency loss {rec['loss_f64_chain']:.6e} "
                    f"(f64 chain); against the f64 chain on each run's resampling (cdf: the "
                    f"run's CDFs against the chain's own, worst call): kernels {rec['kernel']}, "
                    f"plain {rec['plain']}; kernels vs plain {rec['kernel_vs_plain']}"
                    + (f"; against the f64 chain on its own resampling (not held) "
                       f"{rec['vs_f64_own_resampling']}" if "vs_f64_own_resampling" in rec
                       else ""))
            log(f"{what}: pooled over draws {[r['draw'] for r in recs]}, kernels "
                f"{pooled['kernel']}, plain {pooled['plain']}, ratio "
                f"{ {w: pooled['kernel'][w] / pooled['plain'][w] for w in pooled['plain']} } "
                f"({time.perf_counter() - t0:.1f} s)")
            out[f"nerf_{nerf_type}_vit_{vit_type}"] = {"draws": recs, "pooled": pooled}
            ok = all(rec[k]["cdf"] <= TOL[nerf_type] for rec in recs for k in ("kernel", "plain"))
            if vit_type == "bfloat16":
                ok &= all(rec["kernel"]["loss_rel"] <= TOL_DIET_LOSS and all(
                    rec[k][w] <= TOL_DIET_GRAD for k in ("kernel", "plain") for w in pooled[k])
                    for rec in recs)
            else:
                ok &= all(pooled["kernel"][w] <= F64_FACTOR * pooled["plain"][w]
                          for w in pooled["plain"])
            if not ok:
                raise AssertionError(f"{label}: the held diet step ({nerf_type} NeRF, {vit_type} "
                                     f"ViT) is off: {out[f'nerf_{nerf_type}_vit_{vit_type}']}")

    cot = torch.randn((trainer.diet.cs_image_size, trainer.diet.cs_image_size, 3),
                      generator=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)

    def render(p):
        key = torch.Generator(device=DEVICE).manual_seed(SEED)
        return (dietnerf.render_image_differentiable(p, trainer.config, trainer.diet, key, c2w,
                                                     fov) * cot).sum()

    no_ckpt = types.SimpleNamespace(checkpoint=lambda fn, *a, use_reentrant: fn(*a))
    _, with_ckpt = grads_of(render)
    _, without = grads_of(render, [(dietnerf, "checkpoint", no_ckpt)])
    ckpt = {w: float((with_ckpt[w] - without[w]).norm() / without[w].norm()) for w in without}
    ckpt["bitwise"] = all(torch.equal(with_ckpt[w], without[w]) for w in without)
    out["checkpoint_vs_none"] = ckpt
    log(f"{label}: the bf16 render's gradient with checkpoint vs without: {ckpt} "
        f"(tol {TOL_DIET_CKPT})")
    if not all(ckpt[w] <= TOL_DIET_CKPT for w in without):
        raise AssertionError(f"{label}: checkpointed render's gradient is off: {ckpt}")
    return out


def _diet_kernel_checks(torch, trainer, c2w, label: str, backend: str) -> dict:
    """The diet step's bf16 kernels held against their plain versions on
    one chunk's coarse and fine launches of the consistency render
    (``DIET_CHECK_CHUNK``), their arguments recorded from a render at the
    run's first diet pose: B1 and B2 through ``_mlp_checks``, B6's forward
    and backward through ``_rm_checks``; returns each pass's max |kernel -
    plain|."""
    from unittest import mock

    from nerf_and_dietnerf_tpu_torch.models import dietnerf
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
    from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk

    owner = {"pallas": rc, "pallas_rm": rk}[backend]
    fwd = DIET_KERNELS[backend][0]
    real, calls = getattr(owner, fwd), []

    def record(*args):
        calls.append(args)
        return real(*args)

    diet = trainer.diet
    with mock.patch.object(owner, fwd, record), torch.no_grad():
        dietnerf.render_image_differentiable(
            trainer.state.params, trainer.config, diet,
            torch.Generator(device=DEVICE).manual_seed(SEED), c2w, trainer.dataset.field_of_view)
    out = {}
    for name, (ws, bs, cfg, a, b, cd) in zip(("coarse", "fine"),
                                            calls[2 * DIET_CHECK_CHUNK:2 * DIET_CHECK_CHUNK + 2]):
        samples = diet.cs_samples * (1 if name == "coarse" else 2)
        rows = diet.cs_chunk_rays * samples
        got = a.shape[0] if backend == "pallas" else tuple(b.shape)
        if cd != torch.bfloat16 or got != (rows if backend == "pallas" else
                                           (diet.cs_chunk_rays, samples)):
            raise AssertionError(f"{label}: the render's {name} launch took {cd} and shape {got}")
        what = f"{label} {name} pass ({diet.cs_chunk_rays} rays x {samples} samples)"
        if backend == "pallas":
            g = (0.5 + torch.rand((rows, 4), generator=torch.Generator(device=DEVICE).manual_seed(
                SEED + 16), device=DEVICE)).contiguous()
            abs_fwd, abs_bwd, _ = _mlp_checks(torch, rc, ws, bs, cfg, a, b, g, cd, "bfloat16",
                                              f"{what} rows={rows}")
            out[name] = {"mlp_fwd": abs_fwd, "mlp_bwd": abs_bwd}
        else:
            out[name] = _rm_checks(torch, rk, cfg, ws, bs, a, b, cd, "bfloat16",
                                   torch.Generator(device=DEVICE).manual_seed(SEED + 16), what,
                                   b7=False)[0]
    log(f"{label}: the render's bf16 kernels against their plain versions at its shapes, max "
        f"abs err: {out}")
    return out


def _diet_trace(torch, fn, backend: str, log_dir, what: str) -> dict:
    """``fn`` once, then once more under ``utils.profiling.trace``: its
    device window (:func:`_device_window`), the device ms of the path's
    forward kernel, of its backward kernel, of the library's matrix products
    (cuBLAS: the ViT's) and of the rest, and the eight device operations
    with the most time."""
    from nerf_and_dietnerf_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with profiling.trace(str(log_dir)) as prof:
        fn()
        torch.cuda.synchronize()
    averages, rec = _device_window(prof, what)
    fwd, bwd = (set(MMA_KERNELS[k]) for k in DIET_KERNELS[backend])
    groups = {"fwd_kernel": 0.0, "bwd_kernel": 0.0, "library_matmul": 0.0, "other": 0.0}
    for a in averages:
        key = a.key.lower()
        group = ("fwd_kernel" if any(k in a.key for k in fwd) else
                 "bwd_kernel" if any(k in a.key for k in bwd) else
                 "library_matmul" if any(t in key for t in ("gemm", "cutlass", "xmma")) else
                 "other")
        groups[group] += _device_us(a) / 1e3
    rec.update(ms=groups, top=[{"name": a.key[:120], "ms": _device_us(a) / 1e3,
                                "calls": a.count} for a in averages[:8]])
    log(f"{what}: traced window {rec['window_ms']:.3f} ms, device busy {rec['busy_ms']:.3f} ms, "
        f"idle share {rec['idle_share']:.4f}, {rec['device_ops']} device operations; device ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in groups.items()))
    for t in rec["top"]:
        log(f"{what} top: {t['ms']:10.3f} ms {t['calls']:5d} calls  {t['name']}")
    return rec


def _diet_timings(torch, trainer, c2w, target) -> dict:
    """ms a plain step and a diet step (host clock, synchronised, from the
    trained state, on batches of the ray table), the diet step's peak device
    memory, and the ViT's (forward + backward to the image) and the
    consistency render's (forward + backward) ms with CUDA events; then each
    of the three traced (:func:`_diet_trace`)."""
    from nerf_and_dietnerf_tpu_torch.models import dietnerf, vit
    from nerf_and_dietnerf_tpu_torch.train import train_step as ts

    state, diet, fov = trainer.state, trainer.diet, trainer.dataset.field_of_view
    tables = tuple(torch.as_tensor(a, device=DEVICE) for a in (
        trainer.data.origins, trainer.data.directions, trainer.data.rgb))
    batch = tuple(t[:trainer.run.n_rays_in_batch_train] for t in tables)
    key = torch.Generator(device=DEVICE).manual_seed(SEED)
    kw = dict(config=trainer.config, optimizer=trainer.optimizer)

    def per_step_ms(step, reps):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    diet_step = lambda: dietnerf.diet_train_step(  # noqa: E731
        state, key, batch, c2w, target, trainer.vit_params, diet=diet, field_of_view=fov, **kw)
    out = {"plain_step_ms": per_step_ms(lambda: ts.train_step(state, key, batch, **kw), 10),
           "diet_step_ms": per_step_ms(diet_step, 3)}
    torch.cuda.reset_peak_memory_stats()
    diet_step()
    torch.cuda.synchronize()
    out["diet_step_max_memory_bytes"] = torch.cuda.max_memory_allocated()

    image = dietnerf.render_image_differentiable(state.params, trainer.config, diet, None, c2w,
                                                 fov).detach().requires_grad_(True)

    def vit_fwd_bwd():
        emb = vit.extract_features(trainer.vit_params, vit.preprocess(image, diet.vit), diet.vit)
        torch.autograd.grad((emb[0] * target).sum(), image)

    cot = torch.ones((diet.cs_image_size, diet.cs_image_size, 3), device=DEVICE)

    def render_fwd_bwd():
        ts.loss_and_grads(state.params, lambda p: ((dietnerf.render_image_differentiable(
            p, trainer.config, diet, key, c2w, fov) * cot).sum(), None))

    out["vit_fwd_bwd_ms"] = _time_ms(torch, vit_fwd_bwd)
    out["cs_render_fwd_bwd_ms"] = _time_ms(torch, render_fwd_bwd, reps=3)
    backend = trainer.config.backend
    parts = (("diet_step", diet_step), ("cs_render_fwd_bwd", render_fwd_bwd),
             ("vit_fwd_bwd", vit_fwd_bwd))
    out["trace"] = {name: _diet_trace(torch, fn, backend, DIET_DIR / backend / f"trace_{name}",
                                      f"diet {backend} traced {name}") for name, fn in parts}
    return out


def _first_checkpoint_s() -> float:
    """Seconds of a process's first non-reentrant ``torch.utils.checkpoint``
    call, in a fresh interpreter on a CPU tensor: the imports that call
    makes (``torch._dynamo`` and what it pulls in), which a diet run pays
    once, in its first diet step."""
    code = ("import time, torch\nfrom torch.utils.checkpoint import checkpoint\n"
            "x = torch.ones(4, requires_grad=True)\nt = time.perf_counter()\n"
            "checkpoint(torch.sin, x, use_reentrant=False).sum().backward()\n"
            "print(time.perf_counter() - t)\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    return float(run.stdout.split()[-1])


def diet_phase(torch, timings: dict, backend: str, seed: int = SEED) -> None:
    """Two epochs of DietNeRF on the synthetic scene with the launch counts
    set to 0 just before: "pallas" through the normal entry point,
    ``main.main([cfg, "--vit-weights", npz])`` (the runner's stand-ins, the
    training task alone; ``npz`` a ViT-B/32 file of random weights with its
    geometry embedded, written by the port's ``save_npz``), "pallas_rm"
    through ``DietTrainer.fit`` with the random embedder. Then
    ``_check_diet_run``, the held diet step (its draws from ``seed`` on),
    the kernels at the render's
    shapes, the timings and the traces, and the first checkpoint call's
    seconds in a fresh interpreter (:func:`_first_checkpoint_s`)."""
    import shutil
    from unittest import mock

    from nerf_and_dietnerf_tpu_torch import main as cli
    from nerf_and_dietnerf_tpu_torch.models import vit
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
    from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
    from nerf_and_dietnerf_tpu_torch.train.diet_trainer import DietTrainer

    label = f"diet {backend}"
    work = DIET_DIR / backend
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ds = synthetic_scene()
    run = _diet_run(backend)
    rec: dict = {"steps": [], "epochs": []}
    stand_in_rec = {k: [] for k in ("videos", "plot_video", "epoch_plots", "rays", "interp")}
    by_dtype: dict = {}
    fwd_wrapper = {"pallas": (rc, "mlp_fwd"), "pallas_rm": (rk, "raymarch_fwd")}[backend]
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for owner, name, value in (
                _runner_stand_ins(torch, {"diet.yaml": run}, ds, stand_in_rec)
                + _diet_recorders(torch, rec)
                + [_fwd_by_dtype(torch, *fwd_wrapper, DIET_KERNELS[backend][0], by_dtype)]):
            stack.enter_context(mock.patch.object(owner, name, value))
        if backend == "pallas":
            npz = work / "vit_b32.npz"
            vit.save_npz(npz, vit.init_params(torch.Generator().manual_seed(SEED + 3)),
                         config=vit.ViTConfig())
            (work / "diet.yaml").write_text("# the config is built in chip_smoke.py\n")
            argv = [str(work / "diet.yaml"), "--save-root", str(work / "Results"),
                    "--vit-weights", str(npz)] + (["--platform", "cpu"] if DEVICE == "cpu" else [])
            torch.cuda.synchronize()
            kl.reset_launch_counts()
            code = cli.main(argv)
            torch.cuda.synchronize()
            if code != 0:
                raise AssertionError(f"main.main({argv}) returned {code}")
        else:
            trainer = DietTrainer(run, ds, work / "save", device=DEVICE)
            torch.cuda.synchronize()
            kl.reset_launch_counts()
            trainer.fit()
            torch.cuda.synchronize()
        launches = dict(kl.LAUNCHES)
    seconds = time.perf_counter() - t0
    out = _check_diet_run(label, rec, launches, by_dtype, backend)
    trainer = rec["trainer"]
    first = rec["steps"][0]
    out["seconds"] = seconds
    out["held_step"] = _diet_held_step(torch, trainer, first["c2w"], first["target"], label,
                                       seed)
    out["kernel_checks"] = _diet_kernel_checks(torch, trainer, first["c2w"], label, backend)
    out.update(_diet_timings(torch, trainer, first["c2w"], first["target"]))
    out["first_checkpoint_call_s"] = _first_checkpoint_s()
    timings["diet_" + backend] = out
    log(f"{label}: plain step {out['plain_step_ms']:.3f} ms, diet step {out['diet_step_ms']:.3f} "
        f"ms (peak {out['diet_step_max_memory_bytes'] / 2**30:.3f} GiB), ViT fwd+bwd "
        f"{out['vit_fwd_bwd_ms']:.3f} ms, consistency render fwd+bwd "
        f"{out['cs_render_fwd_bwd_ms']:.3f} ms, target embeddings {out['embed_s']:.3f} s, "
        f"the run {seconds:.3f} s; a process's first checkpoint call "
        f"{out['first_checkpoint_call_s']:.3f} s (a fresh interpreter, a CPU tensor)")


# --------------------------------------------------------------------------- #
# Data parallelism on one card (parallel/): two gloo ranks sharing it, NCCL   #
# at a world of one                                                            #
# --------------------------------------------------------------------------- #

DIST_DIR = ROOT / "build" / "chip_smoke_dist"
DIST_TIMEOUT = 600.0  # seconds the two ranks, or the NCCL process, may take
# The flagship config's fields the drill's worker runs with (``_flagship_run``).
DIST_RUN_FIELDS = ("hidden_layer_dim", "last_hidden_layer_dim", "n_pos_enc_dim_xyz",
                   "n_pos_enc_view_dir", "n_angles_for_model", "n_rays_in_batch_train",
                   "n_rays_in_batch_render", "n_render_samples_coarse", "n_render_samples_fine",
                   "compute_dtype", "backend", "init_seed")
# The two ranks' reduced f32 gradient (TF32 off) against the one-process
# gradient of the same global batch from the same state, normwise, at each of
# the first DIST_HELD_STEPS steps of an epoch: only the grouping of the sum
# over rows differs (each rank's kernels sum its 2,048 rows, then the
# all-reduce adds the two halves). The control, ranks drawing at their local
# shape, must land above it at every step.
TOL_DIST_GRAD = 1e-5
# The steps held so: each from the one-process run's state at that step, so
# that what Adam makes of last-bit gradient differences (a division by
# sqrt(nu), which over an epoch parts sound runs as far as the control) does
# not enter; the epoch's mean loss is printed, not held.
DIST_HELD_STEPS = 8
# The bf16 epoch's first step's loss, two ranks against one process,
# relative: the same state and global batch, sums in another order (sound
# runs read 0 to 1.0e-7 on the card); the local-draw control (9.3e-4 to
# 4.2e-3 there) must land above it.
TOL_DIST_STEP_LOSS = 1e-5
DIST_ALLREDUCE_REPS = 20
DIST_WARM_EPOCHS = 3  # untraced warm epochs timed after the first (and before the traced one)


def _local_draws(key, config, mesh, rows, has_fine, device):
    """The fault the group step rules out, for the drill's controls: a rank
    drawing the step's uniforms at its own rows' shape (in place of
    ``train_step.group_draws``), which leaves the single-device stream."""
    from nerf_and_dietnerf_tpu_torch.models import nerf

    return nerf.draw_training_uniforms(key, config, rows, has_fine, device)


@contextlib.contextmanager
def _drawing_locally(local: bool):
    """With ``local``, the group step draws as :func:`_local_draws` does."""
    from unittest import mock

    from nerf_and_dietnerf_tpu_torch.train import train_step as ts

    with (mock.patch.object(ts, "group_draws", _local_draws) if local
          else contextlib.nullcontext()):
        yield


def _dist_grads(torch, dev, mesh, seed: int) -> dict:
    """The gradient that ``train_step`` hands to Adam at each of the first
    ``DIST_HELD_STEPS`` steps of an epoch of the f32 flagship config
    (``pallas``, compute_dtype float32) from the parameters of init seed
    ``seed``, on the synthetic scene's training rays with a fixed generator,
    as ``train_step.run_epoch`` draws them: the permutation, then each step's
    uniforms. Each step starts from the one-process run's state and key, and
    gives three gradients: ``"one"``, the single-device step's on the whole
    batch (whose update the run takes); ``"sound"``, this rank's reduced
    gradient on its rows; ``"local"``, the same with the ranks drawing at
    their local shape (the control)."""
    import dataclasses

    from nerf_and_dietnerf_tpu_torch.data import loaders, pipeline
    from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib
    from nerf_and_dietnerf_tpu_torch.train import train_step as ts
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

    recorded = []

    class Recording(ts.Adam):
        def update(self, grads, opt_state):
            recorded.append([g.detach().clone() for g in tree_leaves(grads)])
            return super().update(grads, opt_state)

    run = dataclasses.replace(_flagship_run("pallas", "float32"), init_seed=seed)
    ds = synthetic_scene()
    cfg = dataclasses.replace(run.nerf_config(), near=ds.near, far=ds.far)
    optimizer = Recording(run.optimizer_lr)
    state = ts.init_train_state(torch.Generator().manual_seed(seed), cfg, optimizer, device=dev)
    idx = loaders.train_test_split_indices(len(ds), run.test_img_idx, None)
    data = pipeline.RayDataset(ds.images[idx], ds.camera_poses[idx], ds.field_of_view,
                               run.n_rays_in_batch_train)
    tables = [torch.as_tensor(a, device=dev) for a in (data.origins, data.directions, data.rgb)]
    key = torch.Generator(device=dev).manual_seed(seed + 21)
    perm = torch.randperm(tables[0].shape[0], generator=key, device=dev)
    group_cfg = dataclasses.replace(cfg, mesh=mesh)
    out: dict = {"one": [], "sound": [], "local": []}
    for i in range(DIST_HELD_STEPS):
        at = key.get_state()
        rows = mesh_lib.batch_indices(perm, i, data.batch_size, mesh.rank, mesh.world_size)
        for name, local in (("sound", False), ("local", True)):
            key.set_state(at)
            with _drawing_locally(local):
                ts.train_step(state, key, tuple(t[rows] for t in tables), config=group_cfg,
                              optimizer=optimizer, mesh=mesh)
            out[name].append(recorded.pop())
        key.set_state(at)
        rows = mesh_lib.batch_indices(perm, i, data.batch_size)
        state, _ = ts.train_step(state, key, tuple(t[rows] for t in tables), config=cfg,
                                 optimizer=optimizer)
        out["one"].append(recorded.pop())
    return out


def _dist_worker_args(out: Path, device, seed: int, diet: bool = False):
    """The drill's worker arguments: one epoch of the flagship config
    (``_flagship_run("pallas")``, init seed ``seed``) on the synthetic
    scene's ``.npz``."""
    from nerf_and_dietnerf_tpu_torch.tools import multiprocess_worker as worker

    fields = {k: getattr(_flagship_run("pallas"), k) for k in DIST_RUN_FIELDS}
    fields["init_seed"] = seed
    return worker.parse_args(["--out", str(out), "--epochs", "1", "--device", str(device),
                              "--scene", str(DIST_DIR / "scene.npz"), "--run",
                              json.dumps(fields)] + (["--diet", "full"] if diet else []))


def _h5_stand_ins(torch):
    """The runner phase's ``.h5`` stand-ins alone (the card's machine has no
    h5py)."""
    return [s for s in _runner_stand_ins(torch, {}, None, {})
            if s[1] in ("save_keras_h5", "load_keras_h5")]


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _warm_epochs(torch, trainer) -> list:
    """``DIST_WARM_EPOCHS`` more epochs of ``trainer``'s epoch function from
    its state (warm: its kernels loaded, its packs' indices cached; the
    states they reach are dropped), host clock synchronised at each end: for
    each, ms a step, and the host's ms between the calls of its steps
    (median, and the largest with its step)."""
    from unittest import mock

    from nerf_and_dietnerf_tpu_torch.train import train_step as ts

    dev = trainer.device
    real_step, starts = ts.train_step, []

    def train_step(*args, **kwargs):
        starts.append(time.perf_counter())
        return real_step(*args, **kwargs)

    out = []
    for _ in range(DIST_WARM_EPOCHS):
        gen = torch.Generator(device=dev).manual_seed(SEED + 22)
        starts.clear()
        _sync(torch, dev)
        t0 = time.perf_counter()
        with mock.patch.object(ts, "train_step", train_step):
            _, metrics = trainer._epoch_fn(trainer.state, gen, *trainer._tables)
        float(metrics["loss"])
        _sync(torch, dev)
        t1 = time.perf_counter()
        step_ms = [1e3 * (b - a) for a, b in zip(starts, starts[1:] + [t1])]
        out.append({"ms_per_step": 1e3 * (t1 - t0) / trainer.data.batches_per_epoch,
                    "median_step_ms": sorted(step_ms)[len(step_ms) // 2],
                    "max_step_ms": max(step_ms), "max_step_at": step_ms.index(max(step_ms))})
    return out


def _traced_epoch(torch, trainer, mesh) -> dict:
    """One more warm epoch of ``trainer``'s epoch function from its state,
    traced on this rank into ``DIST_DIR/trace_rank{r}`` (the state it
    reaches is dropped; :func:`_card_timeline` reads the two ranks' traces
    together): ms a step on the host clock inside the trace, and this
    rank's device operations with the most time (a kernel's time includes
    the other rank's, which shares the card)."""
    from nerf_and_dietnerf_tpu_torch.utils import profiling

    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    _sync(torch, dev)
    with profiling.trace(str(DIST_DIR / f"trace_rank{mesh.rank}")) as prof:
        t0 = time.perf_counter()
        _, metrics = trainer._epoch_fn(trainer.state, gen, *trainer._tables)
        float(metrics["loss"])
        _sync(torch, dev)
        ms = 1e3 * (time.perf_counter() - t0) / trainer.data.batches_per_epoch
    averages = sorted((a for a in prof.key_averages() if _on_device(a)), key=_device_us,
                      reverse=True)
    return {"ms_per_step": ms,
            "top_device_ops": [{"op": a.key.split("(")[0], "ms": _device_us(a) / 1e3,
                                "count": a.count} for a in averages[:3]]}


def _busy_us(spans) -> float:
    """The time some interval of ``spans`` (``(start, end)``, sorted by start) covers."""
    busy, cur = 0.0, None
    for start, end in spans:
        if cur is None or start > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return busy + (0.0 if cur is None else cur[1] - cur[0])


def _card_timeline(traces, steps: int) -> dict:
    """The two ranks' traced epochs on one clock (their Chrome traces' times,
    microseconds on a common base): the window from the first device
    operation to the last, each rank's device busy time, the card's (some
    rank's operation in flight) and the time both ranks had one in flight
    (the card time-shares the two contexts, so a kernel's span includes the
    other rank's turns), all a step; each rank's time a step inside
    ``gloo:all_reduce``, by the trace's category (host and device spans)."""
    ranks, spans = [], []
    for path in traces:
        events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
                  if e.get("ph") == "X"]
        dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
        if not dev:
            raise AssertionError(f"{path}: the trace holds no device operation")
        reduce_us: dict = {}
        for e in events:
            if e.get("name") == "gloo:all_reduce":
                reduce_us.setdefault(e.get("cat"), []).append(e["dur"])
        ranks.append({"busy_ms": _busy_us(dev) / 1e3 / steps,
                      "all_reduce": {cat: {"ms": sum(v) / 1e3 / steps, "count": len(v)}
                                     for cat, v in reduce_us.items()}})
        spans.append(dev)
    window = max(s[-1][1] for s in spans) - min(s[0][0] for s in spans)
    card = _busy_us(sorted(spans[0] + spans[1]))
    both = sum(_busy_us(s) for s in spans) - card
    return {"window_ms": window / 1e3 / steps, "card_busy_ms": card / 1e3 / steps,
            "card_idle_share": 1.0 - card / window, "both_in_flight_ms": both / 1e3 / steps,
            "ranks": ranks}


def _step_losses(record: list):
    """A patch that appends each training step's loss (``train_step``'s
    metrics, the group's mean in a group run) to ``record``, as a detached
    tensor: no host read inside the epoch."""
    from nerf_and_dietnerf_tpu_torch.train import train_step as ts

    real = ts.train_step

    def train_step(*args, **kwargs):
        state, metrics = real(*args, **kwargs)
        record.append(metrics["loss"].detach().clone())
        return state, metrics

    return (ts, "train_step", train_step)


def _dist_rank(rank: int, mesh, out_dir: str, seed: int) -> None:
    """One of the two spawned ranks of :func:`distributed_phase`, both on
    the same device in one gloo group: gloo's ``all_reduce`` and
    ``broadcast`` on the device's tensors first; the f32 gradient check's
    rank side (:func:`_dist_grads`, with its control) and the all-reduce's
    time on that gradient; one epoch of the flagship NeRF through the port's
    worker (launches counted by compute type), a warm epoch untraced and one
    traced; the same epoch with the ranks drawing locally (the control); one
    epoch of DietNeRF through the worker (each diet step's counter and
    consistency loss recorded), all from init seed ``seed``. Writes
    ``rank{r}.json``; rank 0 also its gradients and its trained parameters
    and eval frames."""
    from unittest import mock

    import torch
    import torch.distributed as dist

    from nerf_and_dietnerf_tpu_torch.models import dietnerf
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda
    from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib
    from nerf_and_dietnerf_tpu_torch.tools import multiprocess_worker as worker
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_map

    out_dir = Path(out_dir)
    dev = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {"rank": rank, "device": str(dev)}
    try:
        x = torch.full((1024,), float(rank + 1), device=dev)
        mesh_lib.all_reduce_sum_(x, mesh)
        y = torch.full((1024,), 7.0 if rank == 0 else -1.0, device=dev)
        dist.broadcast(y, src=0, group=mesh.group)
        _sync(torch, dev)
    except Exception as e:
        raise RuntimeError(f"gloo refused an all_reduce / broadcast of {dev} tensors: {e!r}") \
            from e
    if not (bool((x == 3.0).all()) and bool((y == 7.0).all())):
        raise RuntimeError(f"gloo on {dev}: all_reduce gave {x[:2].tolist()}, broadcast "
                           f"{y[:2].tolist()}")
    out["gloo_check"] = {"all_reduce_sum": float(x[0]), "broadcast": float(y[0])}

    grads = _dist_grads(torch, dev, mesh, seed)
    if rank == 0:
        torch.save({k: [[g.cpu() for g in step] for step in v] for k, v in grads.items()},
                   out_dir / "grads_rank0.pt")
    bufs = [g.clone() for g in grads["sound"][0]]
    ms = []
    for _ in range(DIST_ALLREDUCE_REPS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        mesh_lib.all_reduce_mean_(bufs, mesh)
        _sync(torch, dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    n = sum(g.numel() for g in bufs)
    out["all_reduce"] = {"values": n, "bytes": 4 * n, "ms": sorted(ms)[len(ms) // 2],
                         "ms_min": min(ms), "reps": len(ms)}

    by_dtype: dict = {}
    step_losses: list = []
    with contextlib.ExitStack() as stack:
        for owner, name, value in (_h5_stand_ins(torch) + [_fwd_by_dtype(
                torch, raymarch_cuda, "mlp_fwd", "mlp_fwd", by_dtype),
                _step_losses(step_losses)]):
            stack.enter_context(mock.patch.object(owner, name, value))
        trainer, nerf_result = worker.run(_dist_worker_args(out_dir / "nerf", dev, seed), dev,
                                         mesh)
    out["nerf"] = dict(nerf_result, mlp_fwd_by_dtype=by_dtype,
                       step_losses=[float(v) for v in step_losses],
                       warm_epochs=_warm_epochs(torch, trainer),
                       trace=_traced_epoch(torch, trainer, mesh))
    if rank == 0:
        torch.save({"params": tree_map(torch.Tensor.cpu, trainer.state.params),
                    "renders": trainer.render_eval_images(1)}, out_dir / "trained_rank0.pt")
    local_steps: list = []
    with contextlib.ExitStack() as stack:
        for owner, name, value in _h5_stand_ins(torch) + [_step_losses(local_steps)]:
            stack.enter_context(mock.patch.object(owner, name, value))
        stack.enter_context(_drawing_locally(True))
        _, local_result = worker.run(_dist_worker_args(out_dir / "nerf_local", dev, seed),
                                     dev, mesh)
    out["nerf_local_draws"] = {"losses": local_result["losses"],
                               "step_losses": [float(v) for v in local_steps]}

    steps = []
    real_step = dietnerf.diet_train_step

    def diet_train_step(state, *args, **kwargs):
        _sync(torch, dev)
        t0 = time.perf_counter()
        new, metrics = real_step(state, *args, **kwargs)
        _sync(torch, dev)
        steps.append({"counter": state.step + 1,
                      "cs_loss": float(metrics["cosine_similarity_loss"]),
                      "loss": float(metrics["loss"]), "ms": 1e3 * (time.perf_counter() - t0)})
        return new, metrics

    with contextlib.ExitStack() as stack:
        for owner, name, value in (_h5_stand_ins(torch)
                                   + [(dietnerf, "diet_train_step", diet_train_step)]):
            stack.enter_context(mock.patch.object(owner, name, value))
        trainer, diet_result = worker.run(
            _dist_worker_args(out_dir / "diet", dev, seed, diet=True), dev, mesh)
    out["diet"] = dict(diet_result, diet_steps=steps,
                       cs_weight=trainer.diet.weight, budget=trainer.consistency_budget,
                       cs_chunks=-(-trainer.diet.cs_image_size ** 2 // trainer.diet.cs_chunk_rays))
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))


def _nccl_child(out_dir: str, device: str) -> None:
    """The NCCL check, in a process of its own: ``main.main([cfg])`` and
    ``main.main([cfg, "--distributed"])`` with ``RANK=0``, ``WORLD_SIZE=1``
    and ``MASTER_*`` set (a one-rank NCCL group, so ``make_mesh`` gives None
    and the run is the single-device one), one epoch of the flagship
    ``pallas`` config's training task each through the runner phase's
    stand-ins; their ``.h5`` files compared bitwise; then
    ``mesh.all_reduce_mean_`` on a one-rank NCCL group against its input,
    bitwise. Writes ``nccl.json``."""
    import os
    from unittest import mock

    import torch
    import torch.distributed as dist

    from nerf_and_dietnerf_tpu_torch import main as cli
    from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib
    from nerf_and_dietnerf_tpu_torch.train import checkpoint
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

    out_dir = Path(out_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = _runner_run(1, all_tasks=False)
    configs = {"plain.yaml": run, "nccl.yaml": run}
    for name in configs:
        (out_dir / name).write_text(f"# {name}: the config is built in chip_smoke.py\n")
    results = out_dir / "Results"
    platform = ["--platform", "cpu"] if device == "cpu" else []
    out: dict = {}
    rec = {k: [] for k in ("videos", "plot_video", "epoch_plots", "rays", "interp")}
    with contextlib.ExitStack() as stack:
        for owner, name, value in _runner_stand_ins(torch, configs, synthetic_scene(), rec):
            stack.enter_context(mock.patch.object(owner, name, value))
        out["plain_rc"] = cli.main([str(out_dir / "plain.yaml"), "--save-root", str(results)]
                                   + platform)
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(mesh_lib.free_port()))
        out["distributed_rc"] = cli.main([str(out_dir / "nccl.yaml"), "--distributed",
                                          "--save-root", str(results)] + platform)
        weights = [torch.load(checkpoint.nerf_h5_path(results / f"{n}_save_dir_0", 1),
                              map_location="cpu", weights_only=False) for n in ("plain", "nccl")]
    a, b = tree_leaves(weights[0]), tree_leaves(weights[1])
    out["h5_bitwise"] = len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))

    os.environ["MASTER_PORT"] = str(mesh_lib.free_port())
    dev = mesh_lib.init_distributed("cuda:0" if device != "cpu" else "cpu")
    out["backend"] = dist.get_backend()
    try:
        group = mesh_lib.DataGroup(0, 1, dev, dist.group.WORLD)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        xs = [torch.randn(s, generator=gen, device=dev) for s in ((256, 63), (256,), (3,))]
        ref = [x.clone() for x in xs]
        mesh_lib.all_reduce_mean_(xs, group)
        out["all_reduce_bitwise"] = all(torch.equal(x, r) for x, r in zip(xs, ref))
    finally:
        dist.destroy_process_group()
    (out_dir / "nccl.json").write_text(json.dumps(out))


def _median_ms(epochs) -> float:
    return sorted(e["ms_per_step"] for e in epochs)[len(epochs) // 2]


def _normwise_leaves(torch, got, ref) -> float:
    g = torch.cat([t.reshape(-1).double() for t in got])
    r = torch.cat([t.reshape(-1).double() for t in ref])
    return float(torch.linalg.norm(g - r) / torch.linalg.norm(r))


def distributed_phase(torch, timings: dict, seed: int = SEED) -> None:
    """Data parallelism on the one card, the runs from init seed ``seed``:
    two ranks spawned in one gloo group, both on the card (``_dist_rank``:
    gloo on the card's tensors checked first); the ranks' parameters after a
    flagship NeRF epoch and a DietNeRF epoch bitwise equal, their logged
    losses equal, exact launch counts per rank; their eval frames against
    this process's single-device render of rank 0's parameters, bitwise;
    their reduced f32 gradient against the one-process gradient from the
    same state at each of the first ``DIST_HELD_STEPS`` steps, normwise
    ``TOL_DIST_GRAD``; their epoch's first step's loss against a one-process
    epoch's, ``TOL_DIST_STEP_LOSS``, with the controls of both (the ranks
    drawing at their local shape) above the tolerances; then NCCL at a world
    of one (``_nccl_child``). The ranks share one card: their times say
    nothing of scaling across cards."""
    import multiprocessing
    import shutil
    from unittest import mock

    import numpy as np

    from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib
    from nerf_and_dietnerf_tpu_torch.tools import multiprocess_worker as worker
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_map

    t_start = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    ds = synthetic_scene()
    np.savez(DIST_DIR / "scene.npz", images=ds.images, camera_poses=ds.camera_poses,
             field_of_view=ds.field_of_view, near=ds.near, far=ds.far)
    dev = torch.device("cuda:0" if DEVICE == "cuda" else DEVICE)
    try:
        mesh_lib.spawn(_dist_rank, [str(dev)] * 2, args=(str(DIST_DIR), seed), backend="gloo",
                       timeout=DIST_TIMEOUT)
    except Exception as e:
        raise AssertionError(f"distributed: the two gloo ranks on {dev} failed: {e}") from e
    ranks = [json.loads((DIST_DIR / f"rank{r}.json").read_text()) for r in (0, 1)]
    log(f"distributed: gloo on {dev} tensors: all_reduce and broadcast "
        f"{ranks[0]['gloo_check']}")

    # The flagship epoch: ranks bitwise alike, exact launches, vs one process.
    n0, n1 = ranks[0]["nerf"], ranks[1]["nerf"]
    steps = n0["steps_per_epoch"]
    want = {"mlp_fwd": 2 * steps + 2 * 2, "mlp_bwd": 2 * steps}
    want_by_dtype = {"bfloat16": 2 * steps, "float32": 2 * 2}
    for r in (n0, n1):
        if r["launches"] != want or r["mlp_fwd_by_dtype"] != want_by_dtype:
            raise AssertionError(f"distributed rank {r['rank']}: launches {r['launches']} by "
                                 f"type {r['mlp_fwd_by_dtype']}, expected {want} by type "
                                 f"{want_by_dtype}")
    if n0["params_sha256"] != n1["params_sha256"] or n0["losses"] != n1["losses"] \
            or n0["psnr_test"] != n1["psnr_test"] or n0["psnr_train"] != n1["psnr_train"]:
        raise AssertionError(f"distributed: the ranks differ: {n0} / {n1}")
    one_steps: list = []
    with contextlib.ExitStack() as stack:
        for owner, name, value in _h5_stand_ins(torch) + [_step_losses(one_steps)]:
            stack.enter_context(mock.patch.object(owner, name, value))
        one_trainer, one = worker.run(_dist_worker_args(DIST_DIR / "one", dev, seed), dev,
                                       None)
    one["step_losses"] = [float(v) for v in one_steps]
    one_warm = _warm_epochs(torch, one_trainer)

    def rel(losses, ref):
        return abs(losses[0] - ref[0]) / abs(ref[0])

    # Held: the first step's loss, from the same state on the same global
    # batch; printed: the epoch's, which Adam's steps part.
    step_rel = rel(n0["step_losses"], one["step_losses"])
    local_step_rel = [rel(r["nerf_local_draws"]["step_losses"], one["step_losses"])
                      for r in ranks]
    loss_rel = rel(n0["losses"], one["losses"])
    local_rel = [rel(r["nerf_local_draws"]["losses"], one["losses"]) for r in ranks]
    log(f"distributed: {steps} steps of {n0['rows_per_step']} rows a rank, first step's loss "
        f"{n0['step_losses'][0]:.7f} (two ranks) vs {one['step_losses'][0]:.7f} (one process), "
        f"relative {step_rel:.3e} (tolerance {TOL_DIST_STEP_LOSS}); the control drawing locally "
        f"{ranks[0]['nerf_local_draws']['step_losses'][0]:.7f}, relative "
        f"{local_step_rel[0]:.3e}; epoch loss (not held) {n0['losses'][0]:.6f} vs "
        f"{one['losses'][0]:.6f}, relative {loss_rel:.3e}, the control's {local_rel[0]:.3e}; "
        f"params sha256 {n0['params_sha256'][:16]} on both ranks; launches a rank "
        f"{n0['launches']}")
    if not step_rel <= TOL_DIST_STEP_LOSS or not all(math.isfinite(v) for v in
                                                     n0["losses"] + n0["step_losses"]):
        raise AssertionError(f"distributed: first step's loss {n0['step_losses'][0]} vs one "
                             f"process {one['step_losses'][0]} (epoch {n0['losses']} vs "
                             f"{one['losses']})")
    if not min(local_step_rel) > TOL_DIST_STEP_LOSS:
        raise AssertionError(f"distributed: the local-draw control's first step's loss is "
                             f"within {TOL_DIST_STEP_LOSS} of one process's ({local_step_rel}): "
                             f"the check cannot see the fault")
    timeline = _card_timeline([DIST_DIR / f"trace_rank{r}" / "trace.json" for r in (0, 1)],
                              steps)
    for r in ranks:
        log(f"distributed rank {r['rank']}: ms a step, first epoch "
            f"{1e3 * r['nerf']['seconds'][0] / steps:.3f}, warm epochs "
            + ", ".join(f"{e['ms_per_step']:.3f} (steps: median {e['median_step_ms']:.3f}, "
                        f"largest {e['max_step_ms']:.3f} at {e['max_step_at']})"
                        for e in r["nerf"]["warm_epochs"])
            + f", traced {r['nerf']['trace']['ms_per_step']:.3f}; top device ops "
            f"{r['nerf']['trace']['top_device_ops']}")
    log(f"distributed: one process, ms a step, first epoch {1e3 * one['seconds'][0] / steps:.3f}, "
        f"warm epochs " + ", ".join(f"{e['ms_per_step']:.3f} (steps: median "
                                    f"{e['median_step_ms']:.3f}, largest {e['max_step_ms']:.3f} "
                                    f"at {e['max_step_at']})" for e in one_warm))
    log(f"distributed: the traced epoch on the card, a step: {timeline}")

    # The tile-sharded eval frames against one process's frames of the same params.
    trained = torch.load(DIST_DIR / "trained_rank0.pt", weights_only=False)
    one_trainer.state.params = tree_map(lambda t: t.to(dev), trained["params"])
    one_trainer._eval_render_cache = None
    frames = one_trainer.render_eval_images(1)
    frame_diff = {name: float(np.abs(trained["renders"][name][1] - rgb).max())
                  for name, (_, rgb) in frames.items()}
    log(f"distributed: two-rank eval frames vs one process, max |diff| {frame_diff}")
    if any(v != 0.0 for v in frame_diff.values()):
        raise AssertionError(f"distributed: tile-sharded eval frames differ: {frame_diff}")

    # The reduced f32 gradient against the one-process gradient, step by step.
    got = torch.load(DIST_DIR / "grads_rank0.pt", weights_only=False)
    grad_err = [_normwise_leaves(torch, g, r) for g, r in zip(got["sound"], got["one"])]
    local_grad_err = [_normwise_leaves(torch, g, r) for g, r in zip(got["local"], got["one"])]
    log(f"distributed: f32 reduced gradient ({len(got['one'][0])} leaves, as train_step hands "
        f"it to Adam) vs one process's from the same state, normwise, steps 1-"
        f"{DIST_HELD_STEPS}: {[f'{e:.3e}' for e in grad_err]} (tolerance {TOL_DIST_GRAD}); the "
        f"control drawing locally {[f'{e:.3e}' for e in local_grad_err]}")
    if len(grad_err) != DIST_HELD_STEPS or not max(grad_err) <= TOL_DIST_GRAD:
        raise AssertionError(f"distributed: f32 reduced gradient {grad_err} from one process's")
    if not min(local_grad_err) > TOL_DIST_GRAD:
        raise AssertionError(f"distributed: the local-draw control's gradient is within "
                             f"{TOL_DIST_GRAD} ({local_grad_err}): the check cannot see the fault")

    # DietNeRF on the two ranks.
    d0, d1 = ranks[0]["diet"], ranks[1]["diet"]
    counters = [s["counter"] for s in d0["diet_steps"]]
    cs = [s["cs_loss"] for s in d0["diet_steps"]]
    want_counters = [c for c in range(1, d0["steps_per_epoch"] + 1)
                     if c % 13 == 0 and c < d0["budget"]]
    log(f"distributed diet: diet steps at {counters}, consistency losses {cs}, epoch loss "
        f"{d0['losses']}, launches a rank {d0['launches']}")
    if d0["params_sha256"] != d1["params_sha256"] or d0["losses"] != d1["losses"] or [
            {k: v for k, v in s.items() if k != "ms"} for s in d0["diet_steps"]] != [
            {k: v for k, v in s.items() if k != "ms"} for s in d1["diet_steps"]]:
        raise AssertionError(f"distributed diet: the ranks differ: {d0} / {d1}")
    if counters != want_counters or not all(0.0 <= v <= d0["cs_weight"] for v in cs) \
            or not all(math.isfinite(v) for v in d0["losses"] + [s["loss"] for s in
                                                                   d0["diet_steps"]]):
        raise AssertionError(f"distributed diet: steps {d0['diet_steps']}, losses "
                             f"{d0['losses']}")

    # NCCL at a world of one, in a process of its own.
    nccl_dir = DIST_DIR / "nccl"
    nccl_dir.mkdir()
    proc = multiprocessing.get_context("spawn").Process(
        target=_nccl_child, args=(str(nccl_dir), DEVICE))
    proc.start()
    proc.join(DIST_TIMEOUT)
    if proc.is_alive():
        proc.kill()
        proc.join()
        raise AssertionError("distributed: the NCCL process did not end in time")
    if proc.exitcode != 0:
        raise AssertionError(f"distributed: the NCCL process exited with {proc.exitcode}")
    nccl = json.loads((nccl_dir / "nccl.json").read_text())
    log(f"distributed: NCCL world of one: {nccl}")
    if nccl != {"plain_rc": 0, "distributed_rc": 0, "h5_bitwise": True,
                "backend": "nccl" if DEVICE == "cuda" else "gloo", "all_reduce_bitwise": True}:
        raise AssertionError(f"distributed: NCCL world of one: {nccl}")

    seconds = time.perf_counter() - t_start
    timings["distributed"] = {
        "ranks": 2, "backend": "gloo", "device": str(dev), "steps": steps,
        "rows_per_rank": n0["rows_per_step"],
        "ms_per_step_per_rank": [_median_ms(r["nerf"]["warm_epochs"]) for r in ranks],
        "ms_per_step_one_process": _median_ms(one_warm),
        "warm_epochs_per_rank": [r["nerf"]["warm_epochs"] for r in ranks],
        "warm_epochs_one_process": one_warm,
        "first_epoch_ms_per_step_per_rank": [1e3 * r["nerf"]["seconds"][0] / steps
                                             for r in ranks],
        "first_epoch_ms_per_step_one_process": 1e3 * one["seconds"][0] / steps,
        "all_reduce": ranks[0]["all_reduce"], "all_reduce_rank1": ranks[1]["all_reduce"],
        "launches_per_rank": n0["launches"], "mlp_fwd_by_dtype": n0["mlp_fwd_by_dtype"],
        "loss": n0["losses"][0], "loss_one_process": one["losses"][0], "loss_rel": loss_rel,
        "loss_rel_local_draws": local_rel, "first_step_loss_rel": step_rel,
        "first_step_loss_rel_local_draws": local_step_rel,
        "traced_epoch": [r["nerf"]["trace"] for r in ranks],
        "card_timeline": timeline,
        "eval_frame_max_diff": frame_diff, "f32_grad_normwise": grad_err,
        "f32_grad_normwise_local_draws": local_grad_err,
        "diet": {"counters": counters, "cs_losses": cs, "loss": d0["losses"][0],
                 "launches_per_rank": d0["launches"],
                 "diet_step_ms_per_rank": [[s["ms"] for s in r["diet"]["diet_steps"]]
                                           for r in ranks],
                 "epoch_s_per_rank": [r["diet"]["seconds"][0] for r in ranks]},
        "nccl_world_of_one": nccl, "seconds": seconds,
    }
    log(f"distributed phase: {seconds:.1f} s")


# --------------------------------------------------------------------------- #
# The parity phase: the whole fixed-z objective of every kernel path          #
# (tools/parity_gpu.py)                                                        #
# --------------------------------------------------------------------------- #

PARITY_DIR = ROOT / "build" / "chip_smoke_parity"
PARITY_ARGS: list = []  # the tool's defaults: the flagship shape
PARITY_SHAPE = {"rays": 4096, "coarse": 64, "fine": 128, "hidden": 256}
# The launches of one parity run of each path, from the code: a pass
# (nerf.render_rays_train, then nerf._fine_mse) launches its path's forward
# once and its backward once under autograd, the coarse pass then the fine
# pass; with fuse_fine_loss the fine pass is one B5 launch (its backward is
# in that launch). The plain runs launch nothing.
PARITY_LAUNCHES = {
    "pallas": {"mlp_fwd": 2, "mlp_bwd": 2},
    "pallas+fuse_fine_loss": {"mlp_fwd": 1, "mlp_bwd": 1, "mlp_loss_comp": 1},
    "pallas+fuse_compositing": {"mlp_comp_fwd": 2, "mlp_comp_bwd": 2},
    "pallas+fuse_compositing+fuse_fine_loss": {"mlp_comp_fwd": 1, "mlp_comp_bwd": 1,
                                               "mlp_loss_comp": 1},
    "pallas_rm": {"raymarch_fwd": 2, "raymarch_bwd": 2},
    "pallas_rm+fuse_compositing": {"raymarch_comp_fwd": 2, "raymarch_comp_bwd": 2},
}


def parity_phase(torch, timings: dict) -> None:
    """``tools/parity_gpu.main`` at the flagship shape (4096 rays, 64 + 128
    samples, 256/128 wide): the fixed-z objective's loss and every gradient
    leaf of six kernel paths in f32 and bf16 against the f64-chain oracle,
    under the JAX tool's criteria, check 1 against the oracle pinned to each
    f32 run's own leaky slopes (its backwards' recording builds, bitwise the
    run). Fails unless every check passed and each
    run launched exactly ``PARITY_LAUNCHES`` of its path (the plain runs
    nothing). The JSON is ``build/chip_smoke_parity/PARITY_GPU.json``."""
    from nerf_and_dietnerf_tpu_torch.tools import parity_gpu

    PARITY_DIR.mkdir(parents=True, exist_ok=True)
    out_path = PARITY_DIR / "PARITY_GPU.json"
    argv = PARITY_ARGS + ["--out", str(out_path)] + (
        ["--device", "cpu"] if DEVICE == "cpu" else [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    code = parity_gpu.main(argv)
    seconds = time.perf_counter() - t0
    res = json.loads(out_path.read_text())
    if res["shape"] != PARITY_SHAPE:
        raise AssertionError(f"parity: shape {res['shape']}, not the flagship {PARITY_SHAPE}")
    failed = [k for k, v in res["results"].items() if not v["pass"]]
    if code != 0 or not res["all_pass"] or failed:
        raise AssertionError(f"parity: exit {code}, failed checks {failed}")
    for dtype in ("float32", "bfloat16"):
        if res["plain"][dtype]["launches"]:
            raise AssertionError(f"parity: the plain {dtype} run launched "
                                 f"{res['plain'][dtype]['launches']}")
        for name, want in PARITY_LAUNCHES.items():
            got = res["results"][f"{name}/{dtype}"]["launches"]
            if got != want:
                raise AssertionError(f"parity: {name}/{dtype} launched {got}, not {want}")
    runs = {k: {"err_vs_oracle": v["max_rel_grad_err_vs_f32_oracle"],
                "err_vs_plain": v["max_rel_grad_err_vs_xla_same_dtype"],
                "plain_err_vs_oracle": v["xla_same_dtype_err_vs_f32_oracle"],
                "by_net": v["max_rel_grad_err_vs_oracle_by_net"],
                "rel_loss_err": v["rel_loss_err"], "launches": v["launches"]}
            for k, v in res["results"].items() if not k.endswith("/exact")}
    timings["parity"] = {
        "device": res["device"], "shape": res["shape"], "all_pass": res["all_pass"],
        "plain": res["plain"], "leaky_flips_f32_vs_f64": res["leaky_flips_f32_vs_f64"],
        "runs": runs,
        "exact": {k: {"pinned": v["max_rel_grad_err"], "unpinned": v["max_rel_grad_err_unpinned"],
                      "guard": v["branch_guard"]}
                  for k, v in res["results"].items() if k.endswith("/exact")},
        "bin_agreement": {k: v for k, v in res.items() if k.startswith("bin_agreement")},
        "seconds": seconds, "max_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    log(f"parity phase: all_pass {res['all_pass']}, launches as PARITY_LAUNCHES, "
        f"{seconds:.1f} s, peak {timings['parity']['max_memory_bytes'] / 2**30:.3f} GiB; "
        f"check 1 (f32 against the oracle on the kernels' leaky slopes; unpinned beside): "
        + "; ".join(f"{k[:-len('/float32/exact')]} {v['pinned']:.3e} ({v['unpinned']:.3e})"
                    for k, v in timings["parity"]["exact"].items()))


# --------------------------------------------------------------------------- #
# The embedder phase: the DietNeRF embedder tools on a corpus made here        #
# --------------------------------------------------------------------------- #

EMBED_DIR = ROOT / "build" / "chip_smoke_embedder"
# Three scenes: the synthetic sphere from three seeds (camera jitter), each
# coloured through its own channel order, 9 views of 128 px, resized to the
# tool's 256 px corpus.
EMBED_CHANNELS = ((0, 1, 2), (2, 0, 1), (1, 2, 0))
EMBED_VIEWS, EMBED_SIZE, EMBED_CORPUS = 9, 128, 256
EMBED_STEPS, EMBED_BATCH, EMBED_WINDOW = 40, 32, 10


def _embedder_corpus():
    from nerf_and_dietnerf_tpu_torch.tools import train_scene_embedder as ttr

    images, ids = [], []
    for k, order in enumerate(EMBED_CHANNELS):
        ds = synthetic_scene(n_views=EMBED_VIEWS, size=EMBED_SIZE, seed=SEED + 10 + k)
        images += list(ds.images[..., list(order)])
        ids += [k] * EMBED_VIEWS
    return ttr.corpus_from_arrays(images, ids, EMBED_CORPUS)


def embedder_phase(torch, timings: dict) -> None:
    """The trainer's default ViT (256 wide, 6 layers, 8 heads, MLP 1024, 224 /
    32 px) trained ``EMBED_STEPS`` steps of ``EMBED_BATCH`` pairs on the card
    in both pairing modes (``train_scene_embedder.train``): every loss finite,
    the last ``EMBED_WINDOW`` steps' mean loss below the first ones'; each
    saved with ``vit.save_npz`` and read back through ``vit.infer_config`` and
    ``vit.load_pretrained`` (leaves and features bitwise the trained ones);
    then the evaluator on each and on the random embedder."""
    from nerf_and_dietnerf_tpu_torch.models import vit
    from nerf_and_dietnerf_tpu_torch.tools import eval_embedder_consistency as tev
    from nerf_and_dietnerf_tpu_torch.tools import train_scene_embedder as ttr
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

    EMBED_DIR.mkdir(parents=True, exist_ok=True)
    card = gpu_line() if DEVICE == "cuda" else "cpu"
    t0 = time.perf_counter()
    corpus, ids = _embedder_corpus()
    cfg = ttr.vit_config(256, 6, 8, 1024)
    out: dict = {"images": int(corpus.shape[0]), "scenes": len(EMBED_CHANNELS),
                 "steps": EMBED_STEPS, "batch": EMBED_BATCH}
    cfg_r, params_r = tev.random_embedder(DEVICE)
    out["random"] = tev.consistency(tev.features(params_r, cfg_r, corpus, DEVICE), ids)
    log(tev.report("random-init", out["random"]))
    for positives in ("augment", "view"):
        label = f"embedder {positives}"
        run = ttr.train(corpus, ids, cfg, steps=EMBED_STEPS, batch=EMBED_BATCH, lr=3e-4,
                        temp=0.2, positives=positives, seed=SEED, device=DEVICE,
                        log_every=EMBED_WINDOW, log=lambda m: log(f"{label}: {m}"))
        losses = run["losses"]
        first, last = (sum(losses[:EMBED_WINDOW]) / EMBED_WINDOW,
                       sum(losses[-EMBED_WINDOW:]) / EMBED_WINDOW)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{label}: non-finite loss {losses}")
        if not last < first:
            raise AssertionError(f"{label}: mean loss of the last {EMBED_WINDOW} steps {last} "
                                 f"not below the first {EMBED_WINDOW}' {first}")
        npz = EMBED_DIR / f"scene_vit_{positives}.npz"
        vit.save_npz(npz, run["params"]["vit"], config=cfg)
        if vit.infer_config(npz) != cfg:
            raise AssertionError(f"{label}: infer_config {vit.infer_config(npz)} != {cfg}")
        loaded = vit.load_pretrained(npz, cfg, DEVICE)
        if not all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded),
                                                     tree_leaves(run["params"]["vit"]))):
            raise AssertionError(f"{label}: the npz does not read back bitwise")
        feats = tev.features(loaded, cfg, corpus, DEVICE)
        if not torch.equal(feats, tev.features(run["params"]["vit"], cfg, corpus, DEVICE)):
            raise AssertionError(f"{label}: the npz's features differ from the trained ones")
        numbers = tev.consistency(feats, ids)
        log(tev.report(str(npz.relative_to(ROOT)), numbers))
        out[positives] = {"loss_first": first, "loss_last": last, "losses": losses,
                          "acc_last": run["accs"][-1], "seconds": run["seconds"],
                          "ms_per_step": 1e3 * run["seconds"] / EMBED_STEPS,
                          "consistency": numbers}
        log(f"[{card}] {label}: {EMBED_STEPS} steps of "
            f"{EMBED_BATCH} pairs, {out[positives]['ms_per_step']:.3f} ms a step (the first "
            f"included), mean loss {first:.4f} -> {last:.4f}")
    out["seconds"] = time.perf_counter() - t0
    timings["embedder"] = out
    log(f"embedder phase: {out['seconds']:.1f} s")


# The kernels whose products must run on the tensor cores, and the SASS
# instruction they must hold: bf16 B1/B2/B4-B7, the f32 backwards of B2 and
# B4-B7 and the f32 forwards of B4 and B7 on `mma.sync` (HMMA; tf32 for the
# f32 ones), f32 B1/B6 forward and the probe P1 (bf16) on `wgmma` (HGMMA).
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
                                "mlp_comp_bwd_t32_kernel": "HMMA"},
               "probe_mlp_epilogue": {"mlp_fwd_variant_kernel": "HMMA"},
               "probe_mlp_chains": {"mlp_fwd_chains_kernel": "HMMA"},
               "probe_mma": {"mma_chain_kernel": "HGMMA"}}
# What ptxas prints when it serializes a kernel's `wgmma` (accumulator or A
# registers touched inside the asynchronous region, or too few registers).
WGMMA_SERIALIZED = "wgmma.mma_async instructions are serialized"
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


# The instances of B1's tile printed side by side: bf16 B1 (v0) and the
# probes P2 (each epilogue, by its policy's name) and P3 (each chain count,
# by its template argument): library -> {part of the mangled name: label}.
PROBE_INSTANCES = {"mlp_fwd": {"mlp_fwd_mma_kernel": "v0_b1"},
                   "probe_mlp_epilogue": {"CastOnlyEpilogue": "v1", "Bf16Epilogue": "v5",
                                          "MaxLeakyEpilogue": "v3"},
                   "probe_mlp_chains": {"ILi1EE": "chains_1", "ILi2EE": "chains_2"}}


# The probe libraries of P4-P7: every kernel's registers, spills and SASS
# counts, by label (part of the mangled name -> label; P7 by stage index).
PROBE_LIBS = {"probe_expand": {"expand_a_kernel": "P4", "expand_b_kernelI6float4EE": "P5",
                               "expand_b_kernelIfEE": "P5 scalar", "expand_c_kernel": "P6"},
              "probe_enccost": {f"enc_cost_kernelILi{i}EE": f"P7 {stage}" for i, stage in
                                enumerate(("dma", "repeat", "pts", "theta", "sin", "enc"))}}
# The SASS instructions counted in them: 16-byte global loads and stores, the
# special-function unit (what the fast __sinf would run on), f32 FMAs,
# barriers.
PROBE_OPS = {"LDG.128": r"\bLDG\S*\.128\b", "STG.128": r"\bSTG\S*\.128\b",
             "MUFU": r"\bMUFU\b", "FFMA": r"\bFFMA\b", "BAR": r"\bBAR\b"}


def tensor_core_report(kl, build_log: str) -> dict:
    """What the compiler made of B1, B2 and B6: their whole ``-Xptxas -v`` output
    (registers, shared memory, spills of each kernel, and any note that
    `wgmma` products were serialized), then, where the toolkit has
    ``cuobjdump``, the tensor-core (HMMA / HGMMA) and f32 FMA instructions of
    every kernel in their SASS. Fails if a kernel of ``MMA_KERNELS`` lacks
    its tensor-core instruction."""
    import re
    import shutil

    from nerf_and_dietnerf_tpu_torch.tools.sass_diff import (ptxas_blocks, ptxas_entries,
                                                            sass_functions)

    blocks = ptxas_blocks(build_log)
    entries = {lib: ptxas_entries(blocks.get(lib, [])) for lib in
               {lib for _, kernels in REPORTED for lib in kernels} | set(PROBE_INSTANCES)
               | set(PROBE_LIBS) | {"probe_mma"}}
    serialized = [line for line in blocks.get("probe_mma", []) if WGMMA_SERIALIZED in line]
    if serialized:
        raise AssertionError(f"probe_mma: ptxas serialized its wgmma: {serialized}")
    for lib in MMA_KERNELS:
        for line in blocks.get(lib, []):
            if "ptxas" in line:
                log(f"  ptxas {lib}: {line}")
    # registers and spill bytes of each kernel of REPORTED
    ptxas = {}
    for _, kernels in REPORTED:
        for lib, k in kernels.items():
            for entry, rec in entries[lib].items():
                if k in entry:
                    ptxas.setdefault(k, {}).update(rec)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("SASS: cuobjdump not available, tensor-core instructions not counted")
        return {"cuobjdump": "not available"}
    report = {}
    for lib, kernels in MMA_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(kl.lib_path(lib))], check=True,
                              capture_output=True, text=True).stdout
        counts = {fname: {op: sum(len(re.findall(rf"\b{op}\b", i)) for i in instructions)
                          for op in ("HMMA", "HGMMA", "FFMA")}
                  for fname, instructions in sass_functions(sass).items()}
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
    chain = {f: c for f, c in report["probe_mma"].items() if "mma_chain_kernel" in f}
    if any(c["HMMA"] for c in chain.values()):
        raise AssertionError(f"probe_mma: mma.sync (HMMA) in mma_chain_kernel: {chain}")
    report["probe_mma_chain"] = {**next(v for f, v in entries["probe_mma"].items()
                                        if "mma_chain_kernel" in f),
                                 **{op: sum(c[op] for c in chain.values())
                                    for op in ("HGMMA", "HMMA")}}
    log(f"P1 mma_chain_kernel (registers, spill bytes, SASS HGMMA / HMMA): "
        f"{report['probe_mma_chain']}")
    report["probes"] = {}
    for lib, labels in PROBE_INSTANCES.items():
        for fname, c in report[lib].items():
            for part, label in labels.items():
                if part in fname:
                    report["probes"][label] = {**entries.get(lib, {}).get(fname, {}),
                                               "HMMA": c["HMMA"]}
    log(f"B1 and the probes on its tile (registers, spill bytes, SASS HMMA): "
        f"{report['probes']}")
    report["probe_kernels"] = {}
    for lib, labels in PROBE_LIBS.items():
        sass = subprocess.run([tool, "-sass", str(kl.lib_path(lib))], check=True,
                              capture_output=True, text=True).stdout
        for fname, instructions in sass_functions(sass).items():
            for part, label in labels.items():
                if part in fname:
                    report["probe_kernels"][label] = {
                        **entries[lib].get(fname, {}), "instructions": len(instructions),
                        **{op: sum(len(re.findall(rx, i)) for i in instructions)
                           for op, rx in PROBE_OPS.items()}}
    missing = [label for labels in PROBE_LIBS.values() for label in labels.values()
               if label not in report["probe_kernels"]]
    if missing:
        raise AssertionError(f"no SASS found for the probe kernels {missing}")
    log(f"P4-P7 (registers, spill bytes, SASS instructions and counts): "
        f"{report['probe_kernels']}")
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
    build = kl.build_kernels(branches=True)
    log(f"build: {build['seconds']:.1f} s (the {len(kl.KERNEL_SOURCES)} libraries and the "
        f"recording builds of the {len(kl.BRANCH_KERNELS)} backward ones, together)")
    for line in build["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            log("  " + line.strip())
    timings: dict = {"sass": tensor_core_report(kl, build["log"])}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if sys.argv[1:2] == ["seeds"]:
        return seed_runs(torch, sys.argv[2], [int(s) for s in sys.argv[3:]] or [SEED])
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
    quality_phase(torch, timings)
    log(f"quality phase done at {time.perf_counter() - t_start:.0f} s")
    runner_phase(torch, timings)
    log(f"runner phase done at {time.perf_counter() - t_start:.0f} s")
    for backend in DIET_KERNELS:
        diet_phase(torch, timings, backend)
    log(f"diet phases done at {time.perf_counter() - t_start:.0f} s")
    distributed_phase(torch, timings)
    log(f"distributed phase done at {time.perf_counter() - t_start:.0f} s")
    parity_phase(torch, timings)
    log(f"parity phase done at {time.perf_counter() - t_start:.0f} s")
    embedder_phase(torch, timings)
    log(f"embedder phase done at {time.perf_counter() - t_start:.0f} s")
    launches.update(tools_phase(torch))
    profile_phase(torch, timings, trainer)
    log(f"tools and profile done at {time.perf_counter() - t_start:.0f} s")

    for path in MAIN_PATHS:
        t = timings["train_" + path]
        log(f"[{card}] {path} train step {t['ms_per_step']:.3f} ms ({t['rays_per_sec']:.0f} "
            f"rays/s)" + (f", eval frame {t['ms_per_eval_frame']:.3f} ms"
                          if "ms_per_eval_frame" in t else ""))
    r = timings["runner"]
    for t in r["tasks"]:
        log(f"[{card}] runner {t['task']}: {t['seconds']:.3f} s" + (
            f", {t['ms_per_frame']:.2f} ms a frame (128x128, f32)" if t["frames"] else ""))
    log(f"[{card}] runner: {r['s_per_epoch']:.3f} s an epoch (its steps "
        f"{r['epochs'][1]['step_loop_s']:.3f} s), main.main {r['main_seconds']:.3f} s")
    for backend in DIET_KERNELS:
        d = timings["diet_" + backend]
        log(f"[{card}] diet {backend}: plain step {d['plain_step_ms']:.3f} ms, diet step "
            f"{d['diet_step_ms']:.3f} ms (peak {d['diet_step_max_memory_bytes']} bytes), ViT "
            f"fwd+bwd {d['vit_fwd_bwd_ms']:.3f} ms, consistency render fwd+bwd "
            f"{d['cs_render_fwd_bwd_ms']:.3f} ms, target embeddings {d['embed_s']:.3f} s")
        for name, t in d["trace"].items():
            log(f"[{card}] diet {backend} traced {name}: device busy {t['busy_ms']:.3f} of "
                f"{t['window_ms']:.3f} ms (idle share {t['idle_share']:.4f}), device ms "
                + ", ".join(f"{k} {v:.3f}" for k, v in t["ms"].items()))
    d = timings["distributed"]
    log(f"[{card}] distributed, {d['ranks']} gloo ranks sharing one card (not scaling across "
        f"cards): ms a step per rank (median of {DIST_WARM_EPOCHS} warm epochs) " + " / ".join(f"{v:.3f}" for v in d["ms_per_step_per_rank"])
        + f" ({d['rows_per_rank']} rows) against {d['ms_per_step_one_process']:.3f} in one "
        f"process (4096 rows); gradient all-reduce of {d['all_reduce']['values']} f32 values "
        f"({d['all_reduce']['bytes']} bytes) {d['all_reduce']['ms']:.3f} ms (median of "
        f"{d['all_reduce']['reps']}, gloo on the card's tensors); diet steps (counters "
        f"{d['diet']['counters']}) " + " / ".join(
            ", ".join(f"{v:.3f}" for v in r) for r in d["diet"]["diet_step_ms_per_rank"])
        + f" ms on ranks 0 / 1; the phase {d['seconds']:.1f} s")
    p = timings["parity"]
    log(f"[{card}] parity ({p['shape']}), grad err vs the f64-chain oracle (the plain path "
        "of the dtype's): " + "; ".join(
            f"{k} {v['err_vs_oracle']:.3e} ({v['plain_err_vs_oracle']:.3e})"
            for k, v in p["runs"].items())
        + "; bin agreement " + ", ".join(f"{k[len('bin_agreement_'):]} {v}"
                                         for k, v in p["bin_agreement"].items()))
    for positives in ("augment", "view"):
        e = timings["embedder"][positives]
        log(f"[{card}] embedder {positives}: {e['ms_per_step']:.3f} ms a step, loss "
            f"{e['loss_first']:.4f} -> {e['loss_last']:.4f}, separation "
            f"{e['consistency']['separation']:.4f} (random "
            f"{timings['embedder']['random']['separation']:.4f})")
    r = timings["float32"]["mlp_fwd"]
    log(f"[{card}] mlp_fwd float32 ({r['design']}): {r['ms']:.3f} ms, library_ms "
        f"{r['library_ms']:.3f}, plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
        f"({100 * r['share_of_bound']:.1f} %); against the f64 chain "
        f"{timings['b1_f32_vs_f64_chain']['out']['ratio_kernel_to_plain']:.3f}x the plain "
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
    r = timings["probes"]["probe_mlp_epilogue"]
    log(f"[{card}] B1's bf16 tile and its probes at {r['rows']} rows, ms in turns: "
        + ", ".join(f"{k} {v:.3f}" for k, v in r["ms_in_turns"].items())
        + f"; epilogue share (v3 - v1) / v3 {r['epilogue_share']:.4f}; bound "
        f"{r['bound_ms']:.4f} ms, library {r['library_ms']:.3f} ms")
    r = timings["probes"]["probe_expand_a"]
    log(f"[{card}] P4 ms a call in turns: kernel {r['ms']:.5f}, library {r['library_ms']:.5f}; "
        f"device us a launch {r['device_us'] and r['device_us']['us']}; host us: lean steps "
        f"{r['host_sum_lean_us']:.3f}, parent's {r['host_sum_parent_us']:.3f}, whole wrapper "
        f"{r['host_split_us']['whole wrapper (expand_a)']:.3f}")
    r = timings["probes"]["probe_expand_b"]
    log(f"[{card}] P5 ms a call in turns: kernel {r['ms']:.5f}, library {r['library_ms']:.5f}, "
        f"plain {r['plain_ms']:.5f}, P4 {r['ms_in_turns']['p4 (control)']:.5f}; device us a "
        f"launch: kernel {r['device_us']}, library "
        f"{r['library_device_us']}; host us: lean steps {r['host_sum_lean_us']:.3f}, parent's "
        f"{r['host_sum_parent_us']:.3f}, whole wrapper "
        f"{r['host_split_us']['whole wrapper (expand_b)']:.3f}; {r['ptxas']}")
    r = timings["probes"]["probe_mma"]
    log(f"[{card}] P1 ms a call, share of bound: " + ", ".join(
        f"{k} {v['ms']:.4f} ({100 * v['share_of_bound']:.1f} %)" for k, v in r["cases"].items())
        + f"; device us at the first case {r['device_us']}; {r['ptxas']}")
    r = timings["probes"]["probe_expand_c"]
    log(f"[{card}] P6 ms a call in turns: kernel {r['ms']:.5f}, library {r['library_ms']:.5f}, "
        f"plain {r['plain_ms']:.5f}; device us: kernel {r['device_us']}, library "
        f"{r['library_device_us']}, plain {r['plain_device_us']}; bound "
        f"{r['bound_ms'] * 1e3:.2f} us; whole wrapper on the host "
        f"{r['host_split_us']['whole wrapper (expand_c)']:.3f} us; {r['ptxas']}")
    r = timings["probes"]["probe_enccost"]
    log(f"[{card}] P7 stages, ms a call in turns: "
        + ", ".join(f"{k} {v:.5f}" for k, v in r["ms_stages"].items())
        + "; device us a launch: " + ", ".join(f"{k} {v}" for k, v in
                                               r["device_us_stages"].items())
        + f"; enc / bf16 B6 forward in turns {r['enc_share_of_b6_fwd']:.4f} (device "
        f"{r['enc_share_of_b6_fwd_device']})")
    q = timings["quality"]
    for path, r in q["paths"].items():
        log(f"[{card}] quality {path}: held-out PSNR {r['held_out_before']['pooled']:.3f} -> "
            f"{r['held_out_after']['pooled']:.3f} dB (rise {r['rise_db']:.3f}, min "
            f"{QUALITY_RISE_DB})" + (f", {r['below_twin_db']:+.3f} dB below its twin (window "
                                      f"{QUALITY_WINDOW_DB})" if "below_twin_db" in r else "")
            + f", {r['ms_per_step']:.3f} ms a step, launches {r['launches']} (expected "
            f"{r['launches_expected']})")
    train = {path: timings["train_" + path] for path in MAIN_PATHS}
    print(json.dumps({"quality": q}), flush=True)
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
                      "eval_patch": timings["eval_patch"], "runner": timings["runner"],
                      "diet": {b: timings["diet_" + b] for b in DIET_KERNELS},
                      "distributed": timings["distributed"],
                      "parity": timings["parity"], "embedder": timings["embedder"]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
