#!/bin/bash
# Shows that chip_smoke.py's checks of the compositing kernels on the tensor
# cores (_hold_comp_bwd: B7's backward and B5 in bf16 and f32, B4's backward;
# _comp_checks for B4's forward and backward, f32 B4's at S = 128 too;
# _rm_checks for B7's bf16 forward, f32 B6's backward and f32 B7's forward
# at S = 128 and 192; R = 4096, S = 64, both variants) and of f32 B2 (_mlp_checks at a ragged row count, after NaN
# was left in every SM's shared memory) catch broken kernels. Each case copies the package and
# chip_smoke.py to a temporary directory, breaks one line there, rebuilds and
# runs the checks; the repository is not touched:
#   none     unbroken (every check passes);
#   ray2     composites only the first ray of each group (two rays a tile) in
#            the backwards;
#   sigbias  sums the blue cotangent into the xyz-only sigma head's bias
#            gradient, a leaf of one value (the view-dir variant is unbroken);
#   dd2      drops the second ray's dd rows from B4's dencd (two rays a tile;
#            the xyz-only variant, which has no dencd, is unbroken);
#   denc1    writes every group's denc rows but the first one row off (up);
#   t32row   reads the first register of the transposed A^T fragment of f32
#            B7's weight-gradient products one row off;
#   fwdray   B7's bf16 forward composites each ray of a two-ray group with
#            the other ray's depths and into the other ray's outputs;
#   b5sw     f32 B5's dz_points reads the f32 kit's swizzled X row plainly
#            (column c where sw(r, c) holds it);
#   b2pad    f32 B2's X and D loads (load_rows) leave the pad columns past
#            the encoding's width as they were;
#   b4carry  f32 B4's dencd sums drop the carry between a ray's two 64-row
#            tiles (S = 128: each ray's dencd is its second tile's rows only;
#            the xyz-only variant, which has no dencd, is unbroken);
#   b6row    f32 B6's backward reads each row's dx from the slab row r ^ 4
#            for its dz;
#   fwdtile  the forward loop writes every tile's raw rows where the first
#            tile's go (no 4 j BM offset): f32 B7's forward composites a ray
#            over two or three 64-row tiles from the wrong rows (S = 128 and
#            192; bf16 at S = 64 is one tile a group, unbroken);
#   b4dpad   f32 B4's forward (the f32 D-tile loader it shares with f32 B4's
#            backward and f32 B5) leaves the D tile's pad columns as they
#            were: NaN after _poison_comp_fwd (the xyz-only variant, which
#            has no D tile, is unbroken);
#   sinkcol  the recording builds' branch sink writes the other slope than
#            the one taken for column 5 of every layer (the production
#            builds are unbroken; the bf16 backwards' checks, which hold them
#            against f64_branches, must refuse the mask: raymarch_cuda.
#            branch_guard);
#   slope1   the bf16 grad_tile takes column 5's leaky slope from the wrong
#            side (trunk and r0), and its sink records the slope it took.
# The bf16 backwards (B7, B5, B4) are held against f64_branches, the f64
# chain on their recording builds' leaky slopes, as chip_smoke.py holds them.
# Run from the repository root on the card, after a build (build/kernels is
# copied, so only the broken libraries are rebuilt); name cases to run only
# those:
#   bash nerf_and_dietnerf_tpu_torch/tools/comp_mutants.sh [none b4carry b6row ...]
set -u
root=$(pwd)
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
cases=${*:-none ray2 sigbias dd2 denc1 t32row fwdray b5sw b2pad b4carry b6row fwdtile b4dpad sinkcol slope1}
for m in $cases; do
  d=$tmp/$m
  mkdir -p "$d/build" && cp -r nerf_and_dietnerf_tpu_torch chip_smoke.py "$d/"
  cp -r build/kernels build/branches "$d/build/" 2>/dev/null
  csrc=$d/nerf_and_dietnerf_tpu_torch/csrc
  case $m in
    ray2) sed -i 's/    if (tid < g.n_rays)$/    if (tid < 1)/' "$csrc/comp_mma_tile.cuh"
          grep -q "if (tid < 1)" "$csrc/comp_mma_tile.cuh" || exit 1 ;;
    sigbias) sed -i 's|narrow_bgrad(pb + L.b\[11\], t.GI + 3, 1, first);|narrow_bgrad(pb + L.b[11], t.GI + 2, 1, first);|' "$csrc/mlp_mma_tile.cuh"
             grep -q "L.b\[11\], t.GI + 2" "$csrc/mlp_mma_tile.cuh" || exit 1 ;;
    dd2) sed -i 's|^      for (int r = lo; r < hi; ++r) s += dd\[|      if (lr != 1) for (int r = lo; r < hi; ++r) s += dd[|' "$csrc/mlp_comp_bwd.cu"
         grep -q "if (lr != 1) for" "$csrc/mlp_comp_bwd.cu" || exit 1 ;;
    denc1) sed -i 's|return denc + ((size_t)g.ray0 \* in.S + r0) \* dm.xyz;|return denc + ((size_t)g.ray0 * in.S + r0 - (g.ray0 > 0)) * dm.xyz;|' "$csrc/mlp_comp_bwd.cu"
           grep -q "r0 - (g.ray0 > 0)" "$csrc/mlp_comp_bwd.cu" || exit 1 ;;
    t32row) sed -i 's|const float v\[4\] = {A\[ra \* lda + sw(ra, k)\],|const float v[4] = {A[(ra + 1) * lda + sw(ra + 1, k)],|' "$csrc/mlp_tf32_mma_tile.cuh"
            grep -q "A\[(ra + 1) \* lda" "$csrc/mlp_tf32_mma_tile.cuh" || exit 1 ;;
    fwdray) sed -i 's|    const size_t ray = (size_t)g.ray0 + i;|    const size_t ray = (size_t)g.ray0 + (g.n_rays - 1 - i);|' "$csrc/raymarch_comp_fwd.cu"
            grep -q "g.n_rays - 1 - i" "$csrc/raymarch_comp_fwd.cu" || exit 1 ;;
    b5sw) sed -i 's|SwizzledCols{row % nerf_tmma::BM});|PlainCols{});|' "$csrc/mlp_loss_comp.cu"
          grep -q "row / in.S) \* 3,$" "$csrc/mlp_loss_comp.cu" && ! grep -q "SwizzledCols{row" "$csrc/mlp_loss_comp.cu" || exit 1 ;;
    b2pad) sed -i 's|  const int wp = nerf_mma::pad16(width);|  const int wp = width;|' "$csrc/mlp_tf32_mma_tile.cuh"
           grep -q "  const int wp = width;" "$csrc/mlp_tf32_mma_tile.cuh" || exit 1 ;;
    b4carry) sed -i 's|      float s = lo == lr \* S ? 0.f : carry;|      float s = 0.f;|' "$csrc/mlp_comp_bwd.cu"
             grep -q "      float s = 0.f;" "$csrc/mlp_comp_bwd.cu" || exit 1 ;;
    b6row) # the first of the two kernels' dz lines is the f32 kernel's
           sed -i '0,/dz_of_row(ry, dxs + r \* dm.xyz, row0 + r)/s//dz_of_row(ry, dxs + (r ^ 4) * dm.xyz, row0 + r)/' "$csrc/raymarch_bwd.cu"
           awk '/rm_bwd_t32_kernel\(/ {k = 1} /rm_bwd_mma_kernel\(/ {k = 0}
                /dxs \+ \(r \^ 4\)/ {n += k} END {exit n != 1}' "$csrc/raymarch_bwd.cu" || exit 1 ;;
    fwdtile) sed -i 's|ring, nullptr, RAW + 4 \* j \* BM, 0,|ring, nullptr, RAW, 0,|' "$csrc/comp_mma_tile.cuh"
             grep -q "ring, nullptr, RAW, 0," "$csrc/comp_mma_tile.cuh" || exit 1 ;;
    b4dpad) # the f32 loader's pad width, not the bf16 one's
            sed -i '/load_comp_t32_inputs(/,/^}/ s|  const int dp = nerf_mma::pad16(dm.dir);|  const int dp = dm.dir;|' "$csrc/mlp_comp_common.cuh"
            awk '/load_comp_t32_inputs\(/ {k = 1} /const int dp = dm.dir;/ {n += k} END {exit n != 1}' "$csrc/mlp_comp_common.cuh" || exit 1 ;;
    sinkcol) sed -i 's|\* mask.width + c\] = pos ? 1 : 0;|* mask.width + c] = (pos != (c == 5)) ? 1 : 0;|' "$csrc/branch_sink.cuh"
             grep -q "(pos != (c == 5))" "$csrc/branch_sink.cuh" || exit 1 ;;
    slope1) sed -i 's|            const bool pos = bf(post\[r \* LDH + n + e\]) >= 0.f;|            const bool pos = (bf(post[r * LDH + n + e]) >= 0.f) != (n + e == 5);|' "$csrc/mlp_mma_tile.cuh"
            grep -q "!= (n + e == 5);" "$csrc/mlp_mma_tile.cuh" || exit 1 ;;
  esac
  (cd "$d" && python3 - "$m" <<'PY'
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from nerf_and_dietnerf_tpu_torch.models import mlp  # noqa: E402
from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl  # noqa: E402
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc  # noqa: E402
from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk  # noqa: E402

kl.build_kernels(branches=True)
torch.backends.cuda.matmul.allow_tf32 = False
cd, R, S = torch.bfloat16, 4096, 64
for n_angles in (0, 2):
    cfg = mlp.MLPConfig(n_angles=n_angles)
    ws, bs = rc.flatten_params(mlp.init_params(torch.Generator().manual_seed(0), cfg,
                                               device="cuda"), cfg, cd)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rd, z = cs._ray_batch(torch, cfg, R, S, gen)
    g_rgb = 0.5 + torch.rand((R, 3), generator=gen, device="cuda")
    g_w = 0.5 + torch.rand((R, S), generator=gen, device="cuda")
    batch = cs._enc_batch(torch, cfg, cd, R, S, gen)

    def b7(raw, branches=None):
        return (*rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, g_rgb, g_w, cd, raw=raw,
                                      branches=branches), None)

    def b5(raw, branches=None):
        mse, dz, dws, dbs = rk.mlp_loss_comp(ws, bs, cfg, *batch, cd, raw=raw, branches=branches)
        return dws, dbs, dz, mse

    ws32, bs32 = rc.flatten_params(mlp.init_params(torch.Generator().manual_seed(0), cfg,
                                                   device="cuda"), cfg, torch.float32)

    def b7_f32(raw, branches=None):
        return (*rk.raymarch_comp_bwd(ws32, bs32, cfg, rd, z, g_rgb, g_w, torch.float32,
                                      raw=raw, branches=branches), None)

    batch32 = []

    def b5_f32(raw, branches=None):
        mse, dz, dws, dbs = rk.mlp_loss_comp(ws32, bs32, cfg, *batch32, torch.float32, raw=raw,
                                             branches=branches)
        return dws, dbs, dz, mse

    for kernel, args, run in (("B7", (rd, z, g_rgb, g_w), b7), ("B5", batch, b5), ("B4", None,
                                                                                   None),
                              ("B7_f32", (rd, z, g_rgb, g_w), b7_f32), ("B7_fwd", None, None),
                              ("B5_f32", batch32, b5_f32), ("B2_f32", None, None),
                              ("B4_f32", None, None), ("B6_f32", None, None),
                              ("B7_fwd_f32", None, None)):
        label = f"{sys.argv[1]} n_angles={n_angles} {kernel}"
        try:
            if kernel == "B4":  # its forward and backward, as chip_smoke.py holds them
                cs._comp_checks(torch, rk, cfg, ws, bs, batch, cd, "bfloat16", gen, label,
                                b5=False)
            elif kernel == "B7_fwd":  # B6 and B7's forward, as chip_smoke.py holds them
                cs._rm_checks(torch, rk, cfg, ws, bs, rd, z, cd, "bfloat16", gen, label,
                              backward=False)
            elif kernel == "B7_f32":
                cs._hold_comp_bwd(torch, "B7", label, "float32", ws32, bs32, cfg, torch.float32,
                                  args, run)
            elif kernel == "B5_f32":  # its inputs drawn after every other case's
                batch32 += cs._enc_batch(torch, cfg, torch.float32, R, S, gen)
                cs._hold_comp_bwd(torch, "B5", label, "float32", ws32, bs32, cfg, torch.float32,
                                  tuple(batch32), run)
            elif kernel == "B2_f32":  # as chip_smoke.py holds it at a ragged row count
                x, d, g = cs._inputs(torch, cfg, torch.float32, cs.N_ROWS_RAGGED, gen)
                cs._mlp_checks(torch, rc, ws32, bs32, cfg, x, d, g, torch.float32, "float32",
                               label)
            elif kernel == "B4_f32":  # a ray over two tiles, as chip_smoke.py holds it
                cs._comp_checks(torch, rk, cfg, ws32, bs32,
                                cs._enc_batch(torch, cfg, torch.float32, R, 2 * S, gen),
                                torch.float32, "float32", gen, label, b5=False)
            elif kernel == "B6_f32":  # B6's forward and backward, as chip_smoke.py holds them
                cs._rm_checks(torch, rk, cfg, ws32, bs32, rd, z, torch.float32, "float32", gen,
                              label, b7=False)
            elif kernel == "B7_fwd_f32":  # rays over two and three 64-row tiles
                for n_s in (2 * S, 3 * S):
                    rd_f, z_f = cs._ray_batch(torch, cfg, R, n_s, gen)
                    cs._rm_checks(torch, rk, cfg, ws32, bs32, rd_f, z_f, torch.float32, "float32",
                                  gen, f"{label} S={n_s}", backward=False)
            else:
                cs._hold_comp_bwd(torch, kernel, label, "bfloat16", ws, bs, cfg, cd, args, run)
            print(f"RESULT {label}: passed", flush=True)
        except AssertionError as exc:
            print(f"RESULT {label}: caught: {str(exc)[:600]}", flush=True)
PY
  ) 2>&1 | grep "RESULT"
done
