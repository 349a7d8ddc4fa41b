"""The Python around the MLP + compositing kernels on the tensor-core tiles:
B7's backward (``csrc/raymarch_comp_bwd.cu``), B5 (``csrc/mlp_loss_comp.cu``)
and B4's backward (``csrc/mlp_comp_bwd.cu``) in bf16 run the ray-group loop of
``csrc/comp_mma_tile.cuh`` on the tiles of ``csrc/mlp_mma_tile.cuh``, B4's and
B7's forwards (``csrc/mlp_comp_fwd.cu``, ``csrc/raymarch_comp_fwd.cu``) its
forward loop; every f32 instance runs the same loops on the 64-row 3xTF32
tiles of ``csrc/mlp_tf32_mma_tile.cuh`` (their arithmetic is modelled in
``tests/test_torch_tf32_split.py``). The kernels run only on the card, where
``chip_smoke.py`` holds them against their plain versions. Here, at small
widths (hidden 32, L = 2-5):

- (a) the group and tile partition at S in {48, 64, 100, 128, 192} and ragged
  ray counts, against the constants and formulas of the CUDA sources;
- (b) B5's and B4's bf16 input tiles (the xyz encodings' rows copied, each
  ray's view-dir encoding rounded into every row, zero pad rows and columns)
  against what JAX's ``_loss_mlp_comp_pallas`` and ``_forward_mlp_comp_pallas``
  / ``_backward_mlp_comp_pallas`` read, in Pallas interpret mode;
- (c) an emulation of the groups in the kernels' order (a forward from the F
  pack on the tiles, the serial ``composite_ray`` / ``composite_ray_bwd``, the
  chain back from the B pack, dz as ``DZC + dz_of_row`` (B7), ``DZC +
  dz_points`` on the bf16-widened X (B5) or ``DZC`` (B4, its dx rows to denc,
  its dd rows summed per ray in row order)) against
  ``_backward_rays_comp_pallas``, ``_loss_mlp_comp_pallas`` and B4's two
  kernels in interpret mode;
- (d) the wrappers' weight packs and scratch against a fake library's
  per-compute-type exports, both types (the f32 backwards of B7, B5 and B4:
  64-row groups, their slots and slab, the F and B buffers of
  ``raymarch_cuda.t32_packs``; f32 B4's and B7's forwards its F buffer);
- f32 B5 and f32 B4's backward in the f32 kit's group order (64-row tiles,
  dz_points reading the swizzled X rows through sw; B4's dd rows summed per
  ray across a ray's two tiles) against JAX's f32 ``_loss_mlp_comp_pallas``
  and ``_backward_mlp_comp_pallas``, f32 B4's and B7's forwards in that
  order too (the 3xTF32 products of the f32 tile modelled as
  ``tests/test_torch_tf32_split.py`` models them) against JAX's f32
  forwards, their raw rows bitwise those the backwards' models composite,
  and the reckoning of ``tools/t32_phases.py``.
"""

import ctypes
import itertools
import json
import math
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_and_dietnerf_tpu.core import cameras as jcam
from nerf_and_dietnerf_tpu.core import encoding as jenc
from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.ops import research_kernels as jrk
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk

CSRC = Path(rc.__file__).resolve().parent.parent / "csrc"
COMP_SRC = (CSRC / "comp_mma_tile.cuh").read_text()
MMA_SRC = (CSRC / "mlp_mma_tile.cuh").read_text()
B7_SRC = (CSRC / "raymarch_comp_bwd.cu").read_text()
B5_SRC = (CSRC / "mlp_loss_comp.cu").read_text()
B4F_SRC = (CSRC / "mlp_comp_fwd.cu").read_text()
B4_SRC = (CSRC / "mlp_comp_bwd.cu").read_text()
EXPORTS_SRC = (CSRC / "comp_exports.cuh").read_text()


def _c_int(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


BM = _c_int(MMA_SRC, "BM")
HPAD = _c_int(MMA_SRC, "HPAD")
NACT = _c_int(MMA_SRC, "NACT")
LDX, LDD = 64 + 8, 32 + 8  # bf16 X and D row strides (checked below)
MLP_SRC = (CSRC / "mlp_common.cuh").read_text()
TM, HMAX = _c_int(MLP_SRC, "TM"), _c_int(MLP_SRC, "HMAX")  # the FMA tiles
MAX_S = _c_int((CSRC / "composite_common.cuh").read_text(), "MAX_S_COMP")
T32_BM = _c_int((CSRC / "mlp_tf32_mma_tile.cuh").read_text(), "BM")  # f32 B7's tiles
B7F_SRC = (CSRC / "raymarch_comp_fwd.cu").read_text()
B7_TILE_SRC = (CSRC / "raymarch_comp_tile.cuh").read_text()
SMEM_LIMIT = 232448
SAMPLES = [48, 64, 100, 128, 192]

CASES = [
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=5, n_freq_dir=2, n_angles=2),
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=2, n_angles=0),
]
IDS = ["view_dirs", "xyz_only"]
N_RAYS = 13
# (c) Against the JAX kernels. f32: the emulation and the TPU kernels sum in
# other orders (the TPU kernel composites with log-step scans and gathers the
# per-ray values as bf16 hi + lo pairs), the tolerances of
# tests/test_torch_research_kernels.py: 5e-4 of each leaf's max |value| for
# the gradients and dz, 1e-5 relative for B5's loss. bf16: the card's
# tolerances for these kernels against their plain versions (chip_smoke.py
# TOL_BWD / TOL_ROWS), normwise per leaf and for dz, 2^-8 relative for the
# loss (one bf16 ulp, as tests/test_torch_fused_mlp_kernels.py): both sides
# round activations and gradients to bf16 at the same places, but a 1-ulp
# difference of a sum (or of the two CPU sines under B7's encodings) flips a
# bf16 rounding, and the JAX kernel sums its bias gradients in bf16 per tile.
GRAD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


# --------------------------------------------------------------------------- #
# The partition, as the sources compute it                                     #
# --------------------------------------------------------------------------- #

def rays_per_group(S: int, bm: int = BM) -> int:
    return 1 if S >= bm else bm // S


def tiles_per_group(S: int, bm: int = BM) -> int:
    return -(-rays_per_group(S, bm) * S // bm)


def n_groups(R: int, S: int, bm: int = BM) -> int:
    return 0 if S <= 0 or S > MAX_S else -(-R // rays_per_group(S, bm))


def group_at(group: int, R: int, S: int, bm: int = BM):
    """``(ray0, n_rays, rows)`` of group ``group``, as ``group_at``."""
    ray0 = group * rays_per_group(S, bm)
    n_rays = min(rays_per_group(S, bm), R - ray0)
    return ray0, n_rays, n_rays * S


def act_elems(S: int, bm: int = BM) -> int:
    """Slot elements a block keeps for a group: NACT x bm x 256 a tile."""
    return tiles_per_group(S, bm) * NACT * bm * HPAD


def bwd_smem_bytes() -> int:
    """``nerf_mma::bwd_smem_bytes()``: P, X, D, the ring, G, sigma, GI."""
    ldh, ldw = HPAD + 8, _c_int(MMA_SRC, "KC") + 8
    fwd = 2 * (BM * ldh + BM * LDX + BM * LDD + _c_int(MMA_SRC, "NSTAGE") * HPAD * ldw) + 4 * BM
    return fwd + 2 * BM * ldh + 4 * BM * 8


def smem_bytes(S: int) -> int:
    return bwd_smem_bytes() + 4 * rays_per_group(S) * (9 * S + 1)


def fwd_smem_bytes(S: int) -> int:
    """``nerf_cmma::fwd_smem_bytes``: the forward tiles, then RAW."""
    return bwd_smem_bytes() - 2 * BM * (HPAD + 8) - 4 * BM * 8 + 16 * rays_per_group(S) * S


def test_tile_constants_match_the_cuda_sources():
    assert (BM, HPAD, NACT) == (128, 256, 10)
    assert "constexpr int LDX = 64 + 8;" in MMA_SRC and "constexpr int LDD = 32 + 8;" in MMA_SRC
    # The partition takes the kit's rows: bf16 128, f32 B7's backward 64.
    assert "__host__ __device__ constexpr int rays_per_group(int S, int bm = BM) {\n" \
           "  return S >= bm ? 1 : bm / S;" in COMP_SRC
    assert "return (rays_per_group(S, bm) * S + bm - 1) / bm;" in COMP_SRC
    assert "return (long long)tiles_per_group(S, K::BM) * K::TILE_SLOTS;" in COMP_SRC
    assert "TILE_SLOTS = (long long)nerf_mma::NACT * nerf_mma::SLOT;" in COMP_SRC
    assert "sizeof(float) * (size_t)rays_per_group(S, K::BM) * (9 * (size_t)S + 1);" in COMP_SRC
    assert "constexpr int SLOT = BM * HPAD;" in MMA_SRC
    assert T32_BM == 64 and "static constexpr int BM = nerf_tmma::BM;" in (
        CSRC / "mlp_tf32_mma_tile.cuh").read_text()
    # The bf16 kernels sum every 16-deep step into a fresh accumulator; B1, B2
    # and B6 keep the tensor core's running sum (the template's default). The
    # loops run the kit's tile code.
    assert "constexpr bool FRESH = true;" in COMP_SRC
    assert "nerf_mma::forward_tile<FRESH>(dm, L, M, F, B, t, ring, keep, out, row0, after);" \
        in COMP_SRC
    assert ("nerf_mma::backward_walk<FRESH>(dm, L, M, Bp, t, ring, acts, part, first, row0, dx, "
            "dd,") in COMP_SRC
    assert "K::forward_tile(tdm, L, M, F, B, t, ring, acts + j * tile_slots," in COMP_SRC
    assert "K::backward_walk(tdm, L, M, Bp, t, ring, slots, part, first, 0," in COMP_SRC
    assert "template <bool FRESH = false>\n__device__ inline void forward_tile(" in MMA_SRC
    assert "  forward_tile(dm, L, M, F, B, t, ring, acts, nullptr, row0, &b10);" in MMA_SRC
    assert "  backward_walk(dm, L, M, Bp, t, ring, acts, part, first, row0, dx, dd, after, b10);" \
        in MMA_SRC
    # The bytes the header states: the backward tiles, then 9 floats a row and
    # one a ray; the largest block at MAX_S_COMP, within a block's limit.
    assert bwd_smem_bytes() == 209408
    assert max(smem_bytes(s) for s in range(1, BM + 1)) == 214528
    assert smem_bytes(MAX_S) == max(smem_bytes(s) for s in range(1, MAX_S + 1)) == 227844
    assert smem_bytes(MAX_S) <= SMEM_LIMIT
    for text in ("214,528", "227,844", "655,360"):
        assert text in COMP_SRC
    assert act_elems(MAX_S) * 2 == 4 * 655360
    # B4's forward: the forward tiles, then 4 floats a row of the group.
    assert fwd_smem_bytes(128) == 139776 and fwd_smem_bytes(MAX_S) == 145920
    assert max(fwd_smem_bytes(s) for s in range(1, MAX_S + 1)) == fwd_smem_bytes(MAX_S)
    for text in ("137,728", "139,776", "145,920"):
        assert text in COMP_SRC
    assert "fwd_smem_bytes(nerf_comp::MAX_S_COMP) == 145920 && fwd_smem_bytes(128) == 139776" \
        in COMP_SRC
    assert "K::forward_tile(tdm, L, M, F, B, t, ring, nullptr, RAW + 4 * j * BM, 0," in COMP_SRC


@pytest.mark.parametrize("n_samples", SAMPLES)
def test_groups_cover_every_row_once_in_whole_rays(n_samples):
    S = n_samples
    rpg, tiles = rays_per_group(S), tiles_per_group(S)
    # Two rays a group at 64, one at 100 and 128 (100: a part-filled tile),
    # one ray over two tiles at 192.
    assert (rpg, tiles) == {48: (2, 1), 64: (2, 1), 100: (1, 1), 128: (1, 1), 192: (1, 2)}[S]
    for R in (1, 13, 4093):  # ragged ray counts: a last group with fewer rays
        seen = np.zeros(R * S, dtype=np.int64)
        for group in range(n_groups(R, S)):
            ray0, n_rays, rows = group_at(group, R, S)
            assert 1 <= n_rays <= rpg and rows <= tiles * BM
            for j in range(-(-rows // BM)):
                n = min(BM, rows - j * BM)  # the tile's rows; the rest are pad rows
                assert 0 < n <= BM
                r = ray0 * S + j * BM + np.arange(n)
                assert ((r // S >= ray0) & (r // S < ray0 + n_rays)).all()  # whole rays
                seen[r] += 1
        assert (seen == 1).all()
    assert n_groups(4096, S) == 4096 // rpg
    assert n_groups(4096, MAX_S + 1) == 0
    # The f32 kit's 64-row tiles: one ray a tile at 64, a ray over two at 100
    # and 128 and over three at 192, 64 / S rays a tile below 64.
    t32 = (rays_per_group(S, T32_BM), tiles_per_group(S, T32_BM))
    assert t32 == {48: (1, 1), 64: (1, 1), 100: (1, 2), 128: (1, 2), 192: (1, 3)}[S]
    for R in (1, 13):
        seen = np.zeros(R * S, dtype=np.int64)
        for group in range(n_groups(R, S, T32_BM)):
            ray0, n_rays, rows = group_at(group, R, S, T32_BM)
            seen[ray0 * S:ray0 * S + rows] += 1
        assert (seen == 1).all()


# --------------------------------------------------------------------------- #
# (b) B5's bf16 input tiles                                                     #
# --------------------------------------------------------------------------- #

def _pad(v: int, m: int) -> int:
    return -(-v // m) * m


def _enc_setup(case, n_samples, seed=1):
    """JAX params, numpy rays, z, the JAX package's encodings and targets."""
    jcfg, tcfg = jm.MLPConfig(**case), tm.MLPConfig(**case)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    orig = rng.normal(size=(N_RAYS, 4)).astype(np.float32)
    dirs = rng.normal(size=(N_RAYS, 4)).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 5.0, (N_RAYS, n_samples)), -1).astype(np.float32)
    pts = jcam.sample_points_along_rays(orig, dirs, z)[..., :3].reshape(-1, 3)
    enc = np.asarray(jenc.encode_xyz(pts, jcfg.n_freq_xyz))
    encd = None
    if jcfg.uses_view_dirs:
        comps = jcam.view_direction_components(dirs, jcfg.n_angles)
        encd = np.asarray(jenc.encode_view_dirs(comps, jcfg.n_freq_dir))
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    return jcfg, tcfg, params, dict(orig=orig, dirs=dirs, z=z, enc=enc, encd=encd,
                                    target=target)


def _b5_tiles(cfg, enc, encd, S):
    """The X (BM x LDX) and D (BM x LDD) tiles load_comp_mma_inputs leaves for
    every tile of every group, in f32: X the bf16 encodings copied, D each
    ray's f32 view-dir encoding rounded to bf16; pad columns below pad16 and
    rows past the group's zero, columns from pad16 on NaN (never read)."""
    R = enc.shape[0] // S
    enc_b = torch.tensor(enc).bfloat16().float()
    out = []
    for group in range(n_groups(R, S)):
        ray0, _, rows = group_at(group, R, S)
        for r0 in range(0, rows, BM):
            X = torch.full((BM, LDX), float("nan"))
            X[:, :_pad(cfg.xyz_dim, 16)] = 0.0
            n = min(BM, rows - r0)
            X[:n, :cfg.xyz_dim] = enc_b[ray0 * S + r0:ray0 * S + r0 + n]
            D = None
            if cfg.uses_view_dirs:
                D = torch.full((BM, LDD), float("nan"))
                D[:, :_pad(cfg.dir_dim, 16)] = 0.0
                ray = ray0 + (r0 + torch.arange(n)) // S
                D[:n, :cfg.dir_dim] = torch.tensor(encd)[ray].bfloat16().float()
            out.append((ray0 * S + r0, n, X, D))
    return out


def _jax_b5_inputs(enc, encd, S):
    """x and d as ``_make_loss_mlp_comp`` reads them (``x_ref[:].astype(cd)``,
    ``_ray_expand_rm(m1, d).astype(cd)``), in Pallas interpret mode, bf16 as f32."""
    R = enc.shape[0] // S
    m1 = jnp.asarray(jrk._m1b_np(R, S), jnp.bfloat16)
    has_dir = encd is not None

    def kernel(x_ref, m_ref, *refs):
        refs[-2 if has_dir else -1][:] = x_ref[:].astype(jnp.bfloat16).astype(jnp.float32)
        if has_dir:
            refs[-1][:] = jrk._ray_expand_rm(m_ref[:], refs[0][:]).astype(
                jnp.bfloat16).astype(jnp.float32)

    shapes = [jax.ShapeDtypeStruct(enc.shape, jnp.float32)]
    args = [jnp.asarray(enc), m1]
    if has_dir:
        shapes.append(jax.ShapeDtypeStruct((R * S, encd.shape[1]), jnp.float32))
        args.append(jnp.asarray(encd))
    outs = pl.pallas_call(kernel, out_shape=shapes, interpret=True)(*args)
    return np.asarray(outs[0]), (np.asarray(outs[1]) if has_dir else None)


# What each JAX kernel body reads: its xyz rows cast to the compute type, its
# per-ray view-dir encodings expanded to rows and cast (the expression
# _jax_b5_inputs runs).
JAX_READS = ("x = x_ref[:].astype(cd)", "_ray_expand_rm(m1_ref[:], d_ref[:]).astype(cd)")
JAX_BODIES = {"B5": [jrk._make_loss_mlp_comp],
              "B4": [jrk._make_forward_mlp_comp, jrk._make_backward_mlp_comp]}


@pytest.mark.parametrize("kernel", ["B5", "B4"])
@pytest.mark.parametrize("n_samples", [48, 100, 192])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_b5_bf16_tiles_match_what_jax_reads(case, n_samples, kernel):
    import inspect

    # B5 and both B4 kernels read their inputs alike, and the CUDA kernels
    # build their tiles with one function.
    for body in JAX_BODIES[kernel]:
        src = inspect.getsource(body)
        assert all(read in src for read in JAX_READS)
    for src in ((B5_SRC,) if kernel == "B5" else (B4F_SRC, B4_SRC)):
        assert "    load_comp_mma_inputs(in, dm, g, r0, X, D);" in src
    _, tcfg, _, x = _enc_setup(case, n_samples)
    jx, jd = _jax_b5_inputs(x["enc"], x["encd"], n_samples)
    tiles = _b5_tiles(tcfg, x["enc"], x["encd"], n_samples)
    covered = 0
    for row0, n, X, D in tiles:
        wx = _pad(tcfg.xyz_dim, 16)
        assert not X[n:, :wx].any() and not X[:n, tcfg.xyz_dim:wx].any()
        np.testing.assert_array_equal(X[:n, :tcfg.xyz_dim].numpy(), jx[row0:row0 + n])
        if jd is None:
            assert D is None
        else:
            wd = _pad(tcfg.dir_dim, 16)
            assert not D[n:, :wd].any() and not D[:n, tcfg.dir_dim:wd].any()
            # JAX gathers the per-ray rows as a bf16 hi + lo pair (2^-17
            # relative) and rounds that: the same bf16 value.
            np.testing.assert_array_equal(D[:n, :tcfg.dir_dim].numpy(), jd[row0:row0 + n])
        covered += n
    assert covered == N_RAYS * n_samples


# --------------------------------------------------------------------------- #
# (c) the groups in the kernels' order                                         #
# --------------------------------------------------------------------------- #

def _unpack(pack, cfg, kind):
    """The (K, N) matrices of an F (W^T, (pad16 N, pad16 K)) or B (W,
    (pad16 K, pad16 N)) pack, in f32."""
    layout, _ = rc.mma_layout(cfg)
    out = []
    for (k, n), (off, kp, np_) in zip(rc.weight_shapes(cfg)[0], layout):
        block = pack[off:off + kp * np_].float()
        out.append(block.view(np_, kp)[:n, :k].t() if kind == "f" else block.view(kp, np_)[:k, :n])
    return out


def _forward(cfg, x, d, wf, bs, cd):
    """The network as forward_tile runs it on a tile's X / D: products of bf16
    values summed in f32, bias and leaky in f32, activations rounded to cd,
    the narrow heads in f32."""
    a = cfg.leaky_relu_alpha

    def act(v):
        v = torch.where(v >= 0, v, a * v)
        return v.bfloat16().float() if cd == torch.bfloat16 else v

    h = x
    for layer in range(8):
        pre = x @ wf[4] + h @ wf[5] if layer == 4 else h @ wf[layer if layer < 4 else layer + 1]
        h = act(pre + bs[layer])
    if cfg.uses_view_dirs:
        sigma = h @ wf[12] + d @ wf[13] + bs[10]
        r = act(h @ wf[9] + d @ wf[10] + bs[8])
        rgb = r @ wf[11] + bs[9]
    else:
        sigma = h @ wf[12] + bs[11]
        r = act(act(h @ wf[9] + bs[8]) @ wf[10] + bs[9])
        rgb = r @ wf[11] + bs[10]
    return torch.cat([rgb, sigma], -1)


T32_K = 8  # depth of an m16n8k8 k-step


def _split_tf32(v):
    hi = rc.round_tf32(v.contiguous())
    return hi, rc.round_tf32(v - hi)


def _t32_dot(pairs):
    """The sum of a @ b over ``pairs`` as the f32 kit's mma_rows sums it into
    one accumulator (modelled as tests/test_torch_tf32_split.py models it): per
    8-deep k-step the three TF32 products lo.hi + hi.lo + hi.hi of the split
    operands (each exact in f64) into a fresh partial, rounded once to f32,
    which one f32 add then adds to the sum."""
    acc = None
    for a, b in pairs:
        ah, al = _split_tf32(a)
        bh, bl = _split_tf32(b)
        if acc is None:
            acc = torch.zeros((a.shape[0], b.shape[1]))
        for k0 in range(0, a.shape[1], T32_K):
            k = slice(k0, k0 + T32_K)
            part = (al[:, k].double() @ bh[k].double() + ah[:, k].double() @ bl[k].double()
                    + ah[:, k].double() @ bh[k].double())
            acc = acc + part.float()
    return acc


def _forward_t32(cfg, x, d, ws, bs):
    """nerf_tmma::forward_tile on one tile's X / D rows (f32, at most 64): the
    eleven wide products by :func:`_t32_dot` (the skip layer's two and the
    view layer's two into one accumulator), bias and leaky in f32, the narrow
    heads as f32 sums."""
    a = cfg.leaky_relu_alpha

    def act(v):
        return torch.where(v >= 0, v, a * v)

    h = x
    for layer in range(8):
        pairs = [(x, ws[4]), (h, ws[5])] if layer == 4 else [
            (h, ws[layer if layer < 4 else layer + 1])]
        h = act(_t32_dot(pairs) + bs[layer])
    if cfg.uses_view_dirs:
        sigma = h @ ws[12] + d @ ws[13] + bs[10]
        r = act(_t32_dot([(h, ws[9]), (d, ws[10])]) + bs[8])
        rgb = r @ ws[11] + bs[9]
    else:
        sigma = h @ ws[12] + bs[11]
        r = act(_t32_dot([(act(_t32_dot([(h, ws[9])]) + bs[8]), ws[10])]) + bs[9])
        rgb = r @ ws[11] + bs[10]
    return torch.cat([rgb, sigma], -1)


def _group_raw(tcfg, ws, bs, cd, x, d, wf, bm):
    """The raw rows (rows, 4) of one group from its X / D rows, as the kit's
    forward_tile writes them: the f32 kit (``bm`` = 64) tile after tile of
    :func:`_forward_t32`; else :func:`_forward` from the F pack's matrices
    ``wf``."""
    if bm != T32_BM:
        return _forward(tcfg, x, d, wf, bs, cd)
    return torch.cat([_forward_t32(tcfg, x[r0:r0 + T32_BM],
                                   None if d is None else d[r0:r0 + T32_BM], ws, bs)
                      for r0 in range(0, x.shape[0], T32_BM)])


def _composite_ray(raw, z):
    """composite_ray for a group's rays at once, sample by sample in f32:
    ``(pixel (n, 3), weights (n, S))``."""
    n, S = z.shape
    T, acc = torch.ones(n), torch.zeros(n, 3)
    w_all = torch.zeros(n, S)
    for s in range(S):
        delta = z[:, s + 1] - z[:, s] if s < S - 1 else torch.full((n,), 1e9)
        alpha = 1.0 - torch.exp(-torch.clamp_min(raw[:, s, 3], 0.0) * delta)
        w = alpha * T
        w_all[:, s] = w
        acc = acc + w[:, None] * (1.0 / (1.0 + torch.exp(-raw[:, s, :3])))
        T = T * (1.0 - alpha)
    return acc, w_all


def _composite_ray_bwd(raw, z, g_rgb, g_w):
    """composite_ray_bwd for a group's rays at once, in its order: the
    forward sweep keeping e_s and T_s, then the reverse affine recurrence
    ``C_s = gW_s a_s + (1 - a_s) C_{s+1}``, ``da_s = (gW_s - C_{s+1}) T_s``;
    ``(g_raw (n, S, 4), dz (n, S))``."""
    n, S = z.shape
    delta = [z[:, s + 1] - z[:, s] if s < S - 1 else torch.full((n,), 1e9) for s in range(S)]
    T, e_all, T_all = torch.ones(n), [], []
    for s in range(S):
        e = torch.exp(-torch.clamp_min(raw[:, s, 3], 0.0) * delta[s])
        e_all.append(e)
        T_all.append(T)
        T = T * (1.0 - (1.0 - e))
    g_raw, dz = torch.zeros(n, S, 4), torch.zeros(n, S)
    c_next = torch.zeros(n)
    for s in reversed(range(S)):
        e = e_all[s]
        alpha = 1.0 - e
        pre = raw[:, s, 3]
        sigma = torch.clamp_min(pre, 0.0)
        w = alpha * T_all[s]
        c = 1.0 / (1.0 + torch.exp(-raw[:, s, :3]))
        gw = torch.zeros(n)
        for ch in range(3):
            gw = gw + c[:, ch] * g_rgb[:, ch]
        gw = (g_w[:, s] if g_w is not None else 0.0) + gw
        da = (gw - c_next) * T_all[s]
        c_next = gw * alpha + (1.0 - alpha) * c_next
        g_raw[:, s, :3] = ((w[:, None] * g_rgb) * c) * (1.0 - c)
        g_raw[:, s, 3] = torch.where(pre > 0, da * delta[s] * e, torch.zeros(n))
        dd = da * sigma * e if s < S - 1 else torch.zeros(n)
        dz[:, s] = -dd
        if s < S - 1:
            dz[:, s + 1] = dz[:, s + 1] + dd
    return g_raw, dz


def _dz_of_row(cfg, rd, z, gx, rows):
    """dz_of_row (csrc/raymarch_common.cuh) for the global rows ``rows``, in its
    order: per coordinate s += (g_sin cos(theta_sin)) f_k, then the cos
    column's term, k = 0, 1, ...; dz += (s + g_id) d_c."""
    S, L, per = z.shape[1], cfg.n_freq_xyz, 1 + 2 * cfg.n_freq_xyz
    ray = rows // S
    o, dv, zr = rd[ray, 0:3], rd[ray, 3:6], z.reshape(-1)[rows]
    half_pi = torch.tensor(math.pi / 2, dtype=torch.float32)
    dz = torch.zeros(len(rows))
    for c in range(3):
        p = o[:, c] + zr * dv[:, c]
        g = gx[:, c * per:(c + 1) * per]
        s = torch.zeros(len(rows))
        for k in range(L):
            f = torch.tensor(math.pi * 2.0 ** k, dtype=torch.float32)
            s = s + (g[:, 1 + 2 * k] * torch.cos(p * f)) * f
            s = s + (g[:, 2 + 2 * k] * torch.cos(p * f + half_pi)) * f
        dz = dz + (s + g[:, 0]) * dv[:, c]
    return dz


def _dz_points(cfg, gx, x, dvec):
    """dz_points (csrc/mlp_loss_comp.cu) on the X tile's rows (bf16 values
    widened to f32), in its order: s = g_id, then per octave g_sin (f e_cos)
    and g_cos (-f e_sin); dz += s d_c."""
    L, per = cfg.n_freq_xyz, 1 + 2 * cfg.n_freq_xyz
    dz = torch.zeros(gx.shape[0])
    for c in range(3):
        g, e = gx[:, c * per:(c + 1) * per], x[:, c * per:(c + 1) * per]
        s = g[:, 0]
        for k in range(L):
            f = torch.tensor(math.pi * 2.0 ** k, dtype=torch.float32)
            s = s + g[:, 1 + 2 * k] * (f * e[:, 2 + 2 * k])
            s = s + g[:, 2 + 2 * k] * (-f * e[:, 1 + 2 * k])
        dz = dz + s * dvec[:, c]
    return dz


def _emulate_groups(tcfg, ws, bs, cd, S, tiles_of, per_ray, dz_rows, rows_out=None, bm=BM):
    """The kernel's order over every group (of ``bm``-row tiles): the forward of each tile
    (``tiles_of(ray0, rows)`` gives its (X, D) rows; :func:`_group_raw`, in the
    f32 kit's 3xTF32 products where ``bm`` is its 64 rows), the group's compositing
    (``per_ray(ray0, n_rays, raw)`` -> (g_raw, dzc, value)), the chain back on
    the group's rows from the B pack, then dz (``dz_rows(ray0, rows, dx,
    x)``) and, if given, ``rows_out(ray0, n_rays, dx, dd)``. Returns (dws,
    dbs, dz (R S), sum of the per-ray values)."""
    wf = _unpack(rc.pack_mma_weights(ws, tcfg, "f"), tcfg, "f")
    wb = [w.to(ws[0].dtype) for w in _unpack(rc.pack_mma_weights(ws, tcfg, "b"), tcfg, "b")]
    R = N_RAYS
    dws = [torch.zeros_like(w, dtype=torch.float32) for w in ws]
    dbs = [torch.zeros_like(b) for b in bs]
    dz = torch.zeros(R * S)
    total = 0.0
    for group in range(n_groups(R, S, bm)):
        ray0, n_rays, rows = group_at(group, R, S, bm)
        x, d = tiles_of(ray0, rows)
        raw = _group_raw(tcfg, ws, bs, cd, x, d, wf, bm).reshape(n_rays, S, 4)
        g_raw, dzc, value = per_ray(ray0, n_rays, raw)
        total += value
        gw, gb, dx, dd = rc.mlp_bwd_plain(wb, bs, tcfg, x.to(ws[0].dtype),
                                          d.to(ws[0].dtype) if d is not None else None,
                                          g_raw.reshape(-1, 4), cd)
        dws = [a + b for a, b in zip(dws, gw)]
        dbs = [a + b for a, b in zip(dbs, gb)]
        dz[ray0 * S:ray0 * S + rows] = dzc.reshape(-1) + dz_rows(ray0, rows, dx, x)
        if rows_out is not None:
            rows_out(ray0, n_rays, dx, dd)
    return dws, dbs, dz.reshape(R, S), total


def _hold(got, ref, tol, normwise):
    for a, b in zip(got, ref):
        a, b = a.detach().double().numpy(), np.asarray(b, dtype=np.float64)
        if normwise:
            assert np.linalg.norm(a - b) <= tol * max(np.linalg.norm(b), 1e-12)
        else:
            scale = max(1e-6, float(np.abs(b).max()))
            np.testing.assert_allclose(a / scale, b / scale, atol=tol)


def _flat_grads(jgp, tcfg):
    return rc.flatten_params(tm.params_from_jax(jgp), tcfg, torch.float32)


DTYPES = [("float32", torch.float32, jnp.float32), ("bfloat16", torch.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("name,cd,jcd", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("n_samples", [48, 192])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_b7_backward_in_the_kernels_order_matches_jax(case, n_samples, name, cd, jcd):
    S = n_samples
    jcfg, tcfg, params, x = _enc_setup(case, S, seed=3)
    orig, dirs, z = x["orig"], x["dirs"], x["z"]
    vc = jcam.view_direction_components(dirs, jcfg.n_angles) if jcfg.uses_view_dirs else None
    rng = np.random.default_rng(7)
    g_rgb = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    g_w = rng.normal(size=(N_RAYS, S)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, zz: jrk.apply_raymarch_composited(p, jcfg, orig, dirs, vc, zz,
                                                                 jcd), params, z)
    jgp, jgz = vjp((jnp.asarray(g_rgb), jnp.asarray(g_w)))

    ws, bs = rc.flatten_params(tm.params_from_jax(params), tcfg, cd)
    rd = rk.pack_rays(tcfg, torch.tensor(orig), torch.tensor(dirs),
                      torch.tensor(np.asarray(vc)) if vc is not None else None)
    tz = torch.tensor(z)
    _, xe, de = rk.encode_rays_plain(tcfg, rd, tz)  # the f32 features the tiles round
    rnd = (lambda t: t.bfloat16().float()) if cd == torch.bfloat16 else (lambda t: t)

    def tiles_of(ray0, rows):
        sl = slice(ray0 * S, ray0 * S + rows)
        return rnd(xe[sl]), (rnd(de[sl]) if de is not None else None)

    def per_ray(ray0, n_rays, raw):
        rays = slice(ray0, ray0 + n_rays)
        g_raw, dzc = _composite_ray_bwd(raw, tz[rays], torch.tensor(g_rgb)[rays],
                                        torch.tensor(g_w)[rays])
        return g_raw, dzc, 0.0

    def dz_rows(ray0, rows, dx, _x):
        return _dz_of_row(tcfg, rd, tz, dx, ray0 * S + torch.arange(rows))

    # f32: the groups of the 64-row 3xTF32 tiles (their products' arithmetic
    # against JAX in tests/test_torch_tf32_split.py), here summed in f32.
    dws, dbs, dz, _ = _emulate_groups(tcfg, ws, bs, cd, S, tiles_of, per_ray, dz_rows,
                                      bm=BM if cd == torch.bfloat16 else T32_BM)
    rws, rbs = _flat_grads(jgp, tcfg)
    normwise = cd == torch.bfloat16
    _hold(dws + dbs, rws + rbs, GRAD_TOL[name], normwise)
    _hold([dz], [jgz], GRAD_TOL[name], normwise)


def _fwd_groups(tcfg, ws, bs, cd, S, tiles_of, tz):
    """forward_groups in the kit of ``cd`` (bf16: 128-row groups; f32: the f32
    kit's 64-row groups, a ray over several tiles above 64 samples): each
    group's raw rows (:func:`_group_raw` on ``tiles_of(ray0, rows)``), then
    composite_ray one ray at a time, sample by sample. Returns (rgb, weights,
    raw (R, S, 4))."""
    bm = BM if cd == torch.bfloat16 else T32_BM
    wf = _unpack(rc.pack_mma_weights(ws, tcfg, "f"), tcfg, "f")
    rgb, weights = torch.zeros(N_RAYS, 3), torch.zeros(N_RAYS, S)
    raw_all = torch.zeros(N_RAYS, S, 4)
    for group in range(n_groups(N_RAYS, S, bm)):
        ray0, n_rays, rows = group_at(group, N_RAYS, S, bm)
        x, d = tiles_of(ray0, rows)
        raw = _group_raw(tcfg, ws, bs, cd, x, d, wf, bm).reshape(n_rays, S, 4)
        rays = slice(ray0, ray0 + n_rays)
        rgb[rays], weights[rays] = _composite_ray(raw, tz[rays])
        raw_all[rays] = raw
    return rgb, weights, raw_all


def _b7_setup(case, S, seed):
    """JAX's params and rays, the port's weights, packed rays and z, and
    ``tiles_of(ray0, rows)``: the features B7's tiles hold (bf16:
    build_mma_inputs' rounding; f32: build_t32_inputs' f32 features)."""
    jcfg, tcfg, params, x = _enc_setup(case, S, seed=seed)
    vc = (jcam.view_direction_components(x["dirs"], jcfg.n_angles) if jcfg.uses_view_dirs
          else None)
    rd = rk.pack_rays(tcfg, torch.tensor(x["orig"]), torch.tensor(x["dirs"]),
                      torch.tensor(np.asarray(vc)) if vc is not None else None)
    tz = torch.tensor(x["z"])
    _, xe, de = rk.encode_rays_plain(tcfg, rd, tz)  # the f32 features the tiles round

    def tiles_of(cd):
        rnd = (lambda t: t.bfloat16().float()) if cd == torch.bfloat16 else (lambda t: t)

        def of(ray0, rows):
            sl = slice(ray0 * S, ray0 * S + rows)
            return rnd(xe[sl]), (rnd(de[sl]) if de is not None else None)
        return of
    return jcfg, tcfg, params, x, vc, rd, tz, tiles_of


@pytest.mark.parametrize("name,cd,jcd", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("n_samples", SAMPLES)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_b7_forward_in_the_kernels_order_matches_jax(case, n_samples, name, cd, jcd):
    """forward_groups with B7's policy (:func:`_fwd_groups`): each tile's
    features as the tiles hold them, the forward of the kit (bf16: the F
    pack's products, 128-row groups; f32: the f32 kit's 3xTF32 products,
    64-row groups, a ray over two tiles at S = 100 and 128 and three at 192),
    then composite_ray one ray at a time, sample by sample; rgb and weights
    against JAX's B7 forward (``_forward_rays_comp_pallas`` in interpret
    mode), scaled by the largest |value|: 1e-4 in f32 (other orders of sums,
    the TPU kernel's log-step scans), 2e-2 in bf16 (chip_smoke.py TOL: a
    1-ulp difference of a sum or of the two CPU sines flips a bf16
    rounding)."""
    S = n_samples
    jcfg, tcfg, params, x, vc, _, tz, tiles_of = _b7_setup(case, S, 5)
    jrgb, jw = jrk.apply_raymarch_composited(params, jcfg, x["orig"], x["dirs"], vc, x["z"], jcd)
    ws, bs = rc.flatten_params(tm.params_from_jax(params), tcfg, cd)
    rgb, weights, _ = _fwd_groups(tcfg, ws, bs, cd, S, tiles_of(cd), tz)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[name]
    _hold([rgb, weights], [jrgb, jw], tol, normwise=False)
    # Both kernels: forward_groups of their kit with the inputs their
    # backwards build.
    for line in ("  nerf_cmma::forward_groups(pol, smem16, dm, L, M, F, B, raw, ry.R, ry.S, groups);",
                 "  nerf_cmma::forward_groups<RayCompFwd, nerf_tmma::Kit>(pol, smem16, dm, L, M, F, "
                 "B, raw, ry.R,", "struct RayCompFwd : RayGroupInputs {"):
        assert line in B7F_SRC
    assert "struct RayComp : RayGroupInputs {" in B7_SRC
    for line in ("    build_mma_inputs(ry, xyz, dir, grow0 + r0, grow0 + g.rows, X, D);",
                 "    build_t32_inputs(ry, xyz, dir, grow0 + r0, grow0 + g.rows, X, D);"):
        assert line in B7_TILE_SRC


def _enc_tiles_of(tcfg, x, S, cd):
    """B5's and B4's group X / D rows as the kernels read them: in bf16 the
    tiles of load_comp_mma_inputs (pad rows dropped), in f32 the rows
    load_comp_t32_inputs copies (the f32 encodings, each ray's exact f32
    view-dir encoding in every row of the ray)."""
    if cd == torch.bfloat16:
        tiles = {row0: (X, D) for row0, _, X, D in _b5_tiles(tcfg, x["enc"], x["encd"], S)}
    enc = torch.tensor(x["enc"])

    def tiles_of(ray0, rows):
        if cd == torch.bfloat16:
            parts = [tiles[ray0 * S + r0] for r0 in range(0, rows, BM)]
            n = [min(BM, rows - r0) for r0 in range(0, rows, BM)]
            X = torch.cat([p[0][:k, :tcfg.xyz_dim] for p, k in zip(parts, n)])
            D = (torch.cat([p[1][:k, :tcfg.dir_dim] for p, k in zip(parts, n)])
                 if tcfg.uses_view_dirs else None)
            return X, D
        ray = torch.arange(ray0 * S, ray0 * S + rows) // S
        return (enc[ray0 * S:ray0 * S + rows],
                torch.tensor(x["encd"])[ray] if x["encd"] is not None else None)
    return tiles_of


@pytest.mark.parametrize("name,cd,jcd", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("n_samples", [48, 192])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_b5_in_the_kernels_order_matches_jax(case, n_samples, name, cd, jcd):
    S = n_samples
    jcfg, tcfg, params, x = _enc_setup(case, S, seed=4)
    args = (params, x["enc"], x["encd"], x["z"], x["dirs"], x["target"])
    val, (jgp, jgz) = jax.value_and_grad(
        lambda p, e, d, zz, dv, tg: jrk.apply_mlp_loss_composited(p, jcfg, e, d, zz, dv, tg, jcd),
        argnums=(0, 3))(*args)

    ws, bs = rc.flatten_params(tm.params_from_jax(params), tcfg, cd)
    tz, target = torch.tensor(x["z"]), torch.tensor(x["target"])
    dvec = torch.tensor(x["dirs"][:, :3])
    inv_n = 1.0 / (3 * N_RAYS)

    def per_ray(ray0, n_rays, raw):
        rays = slice(ray0, ray0 + n_rays)
        pixel, _ = _composite_ray(raw, tz[rays])
        err = pixel - target[rays]
        e2 = (err[:, 0] * err[:, 0] + err[:, 1] * err[:, 1]) + err[:, 2] * err[:, 2]
        g_raw, dzc = _composite_ray_bwd(raw, tz[rays], (2.0 * inv_n) * err, None)
        return g_raw, dzc, float(e2.sum())

    def dz_rows(ray0, rows, dx, xt):
        ray = torch.arange(ray0 * S, ray0 * S + rows) // S
        return _dz_points(tcfg, dx, xt, dvec[ray])

    dws, dbs, dz, sq = _emulate_groups(tcfg, ws, bs, cd, S, _enc_tiles_of(tcfg, x, S, cd),
                                       per_ray, dz_rows)
    assert abs(sq * inv_n - float(val)) <= LOSS_RTOL[name] * abs(float(val))
    rws, rbs = _flat_grads(jgp, tcfg)
    normwise = cd == torch.bfloat16
    _hold(dws + dbs, rws + rbs, GRAD_TOL[name], normwise)
    _hold([dz], [jgz], GRAD_TOL[name], normwise)


def _t32_x_tile(xt):
    """The f32 kit's X tile (64 x LDX) of up to 64 rows ``xt`` as
    load_comp_t32_inputs stores it: column c of row r at sw(r, c) = c ^ (r &
    4), zero elsewhere."""
    rows, width = xt.shape
    tile = torch.zeros((T32_BM, 64 + 8))
    r, c = torch.arange(rows)[:, None], torch.arange(width)[None, :]
    tile[r.expand(-1, width), c ^ (r & 4)] = xt
    return tile


def _dz_points_t32(cfg, gx, tile, dvec):
    """dz_points on the f32 kit's X tile, in its order, with the row of the
    tile read through sw (``SwizzledCols``): column c of tile row r at c ^ (r
    & 4)."""
    L, per = cfg.n_freq_xyz, 1 + 2 * cfg.n_freq_xyz
    r = torch.arange(gx.shape[0])

    def col(c):
        return tile[r, c ^ (r & 4)]

    dz = torch.zeros(gx.shape[0])
    for c in range(3):
        g, e = gx[:, c * per:(c + 1) * per], c * per
        s = g[:, 0]
        for k in range(L):
            f = torch.tensor(math.pi * 2.0 ** k, dtype=torch.float32)
            s = s + g[:, 1 + 2 * k] * (f * col(e + 2 + 2 * k))
            s = s + g[:, 2 + 2 * k] * (-f * col(e + 1 + 2 * k))
        dz = dz + s * dvec[:, c]
    return dz


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_t32_dz_points_reads_the_swizzled_x_row_through_sw(case):
    """f32 B5's dz_points reads its X row from the f32 kit's swizzled tile
    through sw: that gives it the plain encoding's columns, bitwise what
    dz_points computes on the plain row; read plainly (the broken copy of
    tools/comp_mutants.sh), every row with r & 4 gets the wrong sin / cos
    neighbours."""
    cfg = tm.MLPConfig(**case)
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((T32_BM, cfg.xyz_dim), generator=gen) * 2 - 1
    gx = torch.rand((T32_BM, cfg.xyz_dim), generator=gen) * 2 - 1
    dvec = torch.rand((T32_BM, 3), generator=gen) * 2 - 1
    tile = _t32_x_tile(x)
    want = _dz_points(cfg, gx, x, dvec)
    assert torch.equal(_dz_points_t32(cfg, gx, tile, dvec), want)
    plain = _dz_points(cfg, gx, tile[:, :cfg.xyz_dim], dvec)
    odd = (torch.arange(T32_BM) & 4) != 0
    assert torch.equal(plain[~odd], want[~odd]) and bool((plain[odd] != want[odd]).all())
    # The policy passes the row of its tile; dz_points reads column c at col(c).
    for line in ("  int r;  // the row in its tile\n"
                 "  __device__ int operator()(int c) const { return nerf_tmma::sw(r, c); }",
                 "                     SwizzledCols{row % nerf_tmma::BM});",
                 "      s += g[1 + 2 * k] * (f * to_f<X>(x[col(e + 2 + 2 * k)]));",
                 "      s += g[2 + 2 * k] * (-f * to_f<X>(x[col(e + 1 + 2 * k)]));"):
        assert line in B5_SRC
    assert "nerf_cmma::backward_groups<LossComp<float>, K>(" in B5_SRC


@pytest.mark.parametrize("n_samples", [48, 100, 128])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_b5_f32_in_the_t32_kits_group_order_matches_jax(case, n_samples):
    """f32 B5 as backward_groups<LossComp<float>, nerf_tmma::Kit> walks it:
    64-row tiles, one ray a group (S = 48: one part-filled tile; 100: a full
    and a part-filled tile; 128: two full tiles, both tiles' slots kept),
    the f32 encodings and each ray's exact f32 view-dir encoding as the
    tiles' rows, dz_points reading the swizzled X rows through sw; loss,
    dparams and dz against JAX's f32 ``_loss_mlp_comp_pallas`` (interpret
    mode) at LOSS_RTOL / GRAD_TOL["float32"] (scaled per leaf)."""
    S = n_samples
    jcfg, tcfg, params, x = _enc_setup(case, S, seed=12)
    args = (params, x["enc"], x["encd"], x["z"], x["dirs"], x["target"])
    val, (jgp, jgz) = jax.value_and_grad(
        lambda p, e, d, zz, dv, tg: jrk.apply_mlp_loss_composited(p, jcfg, e, d, zz, dv, tg,
                                                                  jnp.float32),
        argnums=(0, 3))(*args)
    cd = torch.float32
    ws, bs = rc.flatten_params(tm.params_from_jax(params), tcfg, cd)
    tz, target = torch.tensor(x["z"]), torch.tensor(x["target"])
    dvec = torch.tensor(x["dirs"][:, :3])
    inv_n = 1.0 / (3 * N_RAYS)
    assert rays_per_group(S, T32_BM) == 1 and tiles_per_group(S, T32_BM) == -(-S // T32_BM)

    def per_ray(ray0, n_rays, raw):
        rays = slice(ray0, ray0 + n_rays)
        pixel, _ = _composite_ray(raw, tz[rays])
        err = pixel - target[rays]
        e2 = (err[:, 0] * err[:, 0] + err[:, 1] * err[:, 1]) + err[:, 2] * err[:, 2]
        g_raw, dzc = _composite_ray_bwd(raw, tz[rays], (2.0 * inv_n) * err, None)
        return g_raw, dzc, float(e2.sum())

    def dz_rows(ray0, rows, dx, xt):
        ray = torch.arange(ray0 * S, ray0 * S + rows) // S
        return torch.cat([_dz_points_t32(tcfg, dx[t0:t0 + T32_BM],
                                         _t32_x_tile(xt[t0:t0 + T32_BM]), dvec[ray[t0:t0 + T32_BM]])
                          for t0 in range(0, rows, T32_BM)])

    dws, dbs, dz, sq = _emulate_groups(tcfg, ws, bs, cd, S, _enc_tiles_of(tcfg, x, S, cd),
                                       per_ray, dz_rows, bm=T32_BM)
    assert abs(sq * inv_n - float(val)) <= LOSS_RTOL["float32"] * abs(float(val))
    rws, rbs = _flat_grads(jgp, tcfg)
    _hold(dws + dbs, rws + rbs, GRAD_TOL["float32"], normwise=False)
    _hold([dz], [jgz], GRAD_TOL["float32"], normwise=False)


def _b4_jax(jcfg, params, x, jcd, seed):
    """JAX's B4 (``apply_mlp_composited``, its two kernels in interpret mode)
    on the setup ``x``: ``((rgb, weights), (dparams, denc, dencd, dz),
    (g_rgb, g_w))`` for normal cotangents drawn from ``seed``."""
    S = x["z"].shape[1]
    rng = np.random.default_rng(seed)
    g_rgb = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    g_w = rng.normal(size=(N_RAYS, S)).astype(np.float32)
    out, vjp = jax.vjp(lambda p, e, d, zz: jrk.apply_mlp_composited(p, jcfg, e, d, zz, jcd),
                       params, x["enc"], x["encd"], x["z"])
    return out, vjp((jnp.asarray(g_rgb), jnp.asarray(g_w))), (g_rgb, g_w)


@pytest.mark.parametrize("name,cd,jcd", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("n_samples", SAMPLES)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_b4_forward_in_the_kernels_order_matches_jax(case, n_samples, name, cd, jcd):
    """forward_groups with B4's policy (:func:`_fwd_groups`): each tile's
    forward in the kit of ``cd`` (bf16: the F pack's products, 128-row
    groups; f32: the f32 kit's 3xTF32 products, 64-row groups, a ray over
    two tiles at S = 100 and 128 and three at 192), then composite_ray one
    ray at a time, sample by sample; rgb and weights against JAX's B4
    forward, scaled by the largest |value|: 1e-4 in f32 (other orders of
    sums, the TPU kernel's log-step scans), 2e-2 in bf16 (chip_smoke.py TOL:
    a 1-ulp difference of a sum flips a bf16 rounding of an activation)."""
    S = n_samples
    jcfg, tcfg, params, x = _enc_setup(case, S, seed=5)
    (jrgb, jw), _, _ = _b4_jax(jcfg, params, x, jcd, 9)
    ws, bs = rc.flatten_params(tm.params_from_jax(params), tcfg, cd)
    rgb, weights, _ = _fwd_groups(tcfg, ws, bs, cd, S, _enc_tiles_of(tcfg, x, S, cd),
                                  torch.tensor(x["z"]))
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[name]
    _hold([rgb, weights], [jrgb, jw], tol, normwise=False)
    # Both kernels: forward_groups of their kit, the policy's inputs as its
    # backward's.
    for line in ("  nerf_cmma::forward_groups(pol, smem16, dm, L, M, F, B, raw, in.R, in.S, groups);",
                 "  nerf_cmma::forward_groups<MlpCompFwd<float>, nerf_tmma::Kit>(pol, smem16, dm, L, "
                 "M, F, B, raw,", "    load_comp_mma_inputs(in, dm, g, r0, X, D);",
                 "    load_comp_t32_inputs(in, dm, g, r0, X, D);"):
        assert line in B4F_SRC


@pytest.mark.parametrize("name,cd,jcd", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("n_samples", [48, 192])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_b4_backward_in_the_kernels_order_matches_jax(case, n_samples, name, cd, jcd):
    """backward_groups with B4's policy: dx rows to denc, each ray's dd rows
    summed in row order (one running sum carried from tile to tile at S =
    192), dz the compositing's share alone; dparams, denc, dencd and dz
    against JAX's B4 backward at GRAD_TOL (scaled per leaf in f32, normwise in
    bf16, as B7's and B5's emulations); f32 in the groups of the f32 kit's
    64-row tiles."""
    _check_b4_backward(case, n_samples, name, cd, jcd, BM if cd == torch.bfloat16 else T32_BM)


@pytest.mark.parametrize("n_samples", [32, 48, 64, 100, 128])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_b4_f32_in_the_t32_kits_group_order_matches_jax(case, n_samples):
    """f32 B4's backward as backward_groups<MlpComp<float>, nerf_tmma::Kit>
    walks it: 64-row tiles (S = 32: two rays a group; 48: one ray in a
    part-filled tile; 64: one full tile; 100: a full and a part-filled tile;
    128: two full tiles, the ray's dencd sums carried from the first to the
    second), the f32 encodings and each ray's exact f32 view-dir encoding as
    the tiles' rows; dparams, denc, dencd and dz against JAX's f32
    ``_backward_mlp_comp_pallas`` (interpret mode) at GRAD_TOL["float32"]
    (scaled per leaf)."""
    S = n_samples
    assert tiles_per_group(S, T32_BM) == (1 if S <= 64 else 2)
    assert rays_per_group(S, T32_BM) == (2 if S == 32 else 1)
    _check_b4_backward(case, S, "float32", torch.float32, jnp.float32, T32_BM)
    # The policy sums the dd rows it is given per ray, tile after tile, from
    # the thread's carry; the f32 kernel runs it on the f32 kit.
    for line in ("      float s = lo == lr * S ? 0.f : carry;",
                 "      for (int r = lo; r < hi; ++r) s += dd[(r - r0) * dm.dir + c];",
                 "      carry = s;",
                 "    for (int idx = threadIdx.x; idx < g.n_rays * dm.dir; idx += blockDim.x) {",
                 "  nerf_cmma::backward_groups<MlpComp<float>, K>(",
                 "    load_comp_t32_inputs(in, dm, g, r0, X, D);"):
        assert line in B4_SRC


def _check_b4_backward(case, n_samples, name, cd, jcd, bm):
    S = n_samples
    jcfg, tcfg, params, x = _enc_setup(case, S, seed=6)
    _, (jgp, jgenc, jgencd, jgz), (g_rgb, g_w) = _b4_jax(jcfg, params, x, jcd, 8)
    ws, bs = rc.flatten_params(tm.params_from_jax(params), tcfg, cd)
    tz = torch.tensor(x["z"])
    denc = torch.full((N_RAYS * S, tcfg.xyz_dim), float("nan"))
    dencd = torch.full((N_RAYS, tcfg.dir_dim), float("nan"))

    def per_ray(ray0, n_rays, raw):
        rays = slice(ray0, ray0 + n_rays)
        g_raw, dzc = _composite_ray_bwd(raw, tz[rays], torch.tensor(g_rgb)[rays],
                                        torch.tensor(g_w)[rays])
        return g_raw, dzc, 0.0

    def rows_out(ray0, n_rays, dx, dd):
        denc[ray0 * S:(ray0 + n_rays) * S] = dx.float()
        if dd is None:
            return
        dd = dd.float().reshape(n_rays, S, -1)
        acc = torch.zeros(n_rays, dd.shape[-1])
        for s in range(S):  # row order, the tiles in turn
            acc = acc + dd[:, s]
        dencd[ray0:ray0 + n_rays] = acc

    dws, dbs, dz, _ = _emulate_groups(tcfg, ws, bs, cd, S, _enc_tiles_of(tcfg, x, S, cd), per_ray,
                                      lambda ray0, rows, dx, xt: torch.zeros(rows), rows_out,
                                      bm=bm)
    rws, rbs = _flat_grads(jgp, tcfg)
    normwise = cd == torch.bfloat16
    _hold(dws + dbs, rws + rbs, GRAD_TOL[name], normwise)
    _hold([dz, denc], [jgz, jgenc], GRAD_TOL[name], normwise)
    if tcfg.uses_view_dirs:
        _hold([dencd], [jgencd], GRAD_TOL[name], normwise)
    else:
        assert jgencd is None


def test_f32_forward_models_composite_the_raw_rows_of_the_backward_models():
    """f32 B7's and B4's forwards run forward_groups on the f32 kit, their
    backwards backward_groups, with one policy's inputs and one forward_tile
    (kept slots are copies, the ring's next matrix changes no sum): the
    source lines below. The kernels' raw values are held bitwise on the card
    (chip_smoke.py ``_same_raw``); here the forward model
    (:func:`_fwd_groups`) and the backward model (:func:`_emulate_groups` in
    the f32 kit's 64-row groups, as ``test_b7_backward_in_the_kernels_order_matches_jax``
    and ``test_b4_f32_in_the_t32_kits_group_order_matches_jax`` walk it) are
    held to composite the same raw rows at three tiles a ray (S = 192). Both
    models share :func:`_group_raw`, so this guards their group walks and
    tile splits only, not a second derivation of the rows."""
    S, cd = 192, torch.float32
    for case, kernel in itertools.product(CASES, ("B7", "B4")):
        if kernel == "B7":
            _, tcfg, params, x, _, _, tz, tiles_of = _b7_setup(case, S, 5)
            tiles = tiles_of(cd)
        else:
            _, tcfg, params, x = _enc_setup(case, S, seed=5)
            tz, tiles = torch.tensor(x["z"]), _enc_tiles_of(tcfg, x, S, cd)
        ws, bs = rc.flatten_params(tm.params_from_jax(params), tcfg, cd)
        _, _, raw_fwd = _fwd_groups(tcfg, ws, bs, cd, S, tiles, tz)
        raw_bwd = torch.full((N_RAYS, S, 4), float("nan"))
        g_rgb, g_w = torch.ones((N_RAYS, 3)), torch.ones((N_RAYS, S))

        def per_ray(ray0, n_rays, raw):  # the backward's compositing reads these raw rows
            rays = slice(ray0, ray0 + n_rays)
            raw_bwd[rays] = raw
            g_raw, dzc = _composite_ray_bwd(raw, tz[rays], g_rgb[rays], g_w[rays])
            return g_raw, dzc, 0.0

        _emulate_groups(tcfg, ws, bs, cd, S, tiles, per_ray, lambda ray0, rows, dx, xt:
                        torch.zeros(rows), bm=T32_BM)
        assert torch.equal(raw_fwd, raw_bwd), (kernel, case)
        src = {"B7": (B7F_SRC, B7_SRC), "B4": (B4F_SRC, B4_SRC)}[kernel]
        assert all("nerf_tmma::T32Layout M" in text for text in src)
    # The kernels: one forward_tile of the f32 kit in both loops, tile j's
    # raw rows at RAW + 4 j BM, so a ray over several tiles lies whole in RAW.
    assert COMP_SRC.count("K::forward_tile(tdm, L, M, F, B, t, ring, ") == 2
    assert "RAW + 4 * j * BM, 0," in COMP_SRC


def test_f32_forwards_shared_memory_and_grid_match_the_cuda_sources():
    """The f32 forwards' shared memory: the f32 kit's forward tiles (P, X, D,
    the ring, sigma: 129,280 bytes), then 4 floats a row of the group; one
    block a ray group, as the bf16 forwards launch."""
    ldh, ldx, ldd = 256 + 8, 64 + 8, 32 + 8
    tiles = 4 * (T32_BM * ldh + T32_BM * ldx + T32_BM * ldd + 2 * 256 * 16 + T32_BM)
    assert tiles == 129280

    def fwd_bytes(S):
        return tiles + 16 * rays_per_group(S, T32_BM) * S

    assert max(fwd_bytes(s) for s in range(1, 65)) == fwd_bytes(64) == fwd_bytes(32) == 130304
    assert fwd_bytes(128) == 131328 and fwd_bytes(MAX_S) == 137472
    assert max(fwd_bytes(s) for s in range(1, MAX_S + 1)) == fwd_bytes(MAX_S) <= SMEM_LIMIT
    for text in ("fwd_smem_bytes<nerf_tmma::Kit>(64) == 130304",
                 "fwd_smem_bytes<nerf_tmma::Kit>(32) == 130304",
                 "fwd_smem_bytes<nerf_tmma::Kit>(128) == 131328",
                 "fwd_smem_bytes<nerf_tmma::Kit>(nerf_comp::MAX_S_COMP) == 137472"):
        assert text in B7_TILE_SRC
    for text in ("130,304", "131,328", "137,472"):
        assert text in COMP_SRC
    for src, kernel in ((B7F_SRC, "rm_comp_fwd_t32_kernel"), (B4F_SRC, "mlp_comp_fwd_t32_kernel")):
        assert "nerf_cmma::n_groups(" in src and ", nerf_tmma::BM)" in src
        assert "nerf_cmma::fwd_smem_bytes<nerf_tmma::Kit>(" in src
        assert f"{kernel}<<<groups, nerf_tmma::NT, smem, stream>>>(" in src or (
            f"launch_kernel({kernel}, groups, nerf_tmma::NT," in src)


def test_no_model_kernel_runs_the_fma_compositing_forward():
    """Every compositing forward runs forward_groups: the FMA kernels and the
    helpers only they used are gone, and no source but B6's forward (its
    branch for encodings wider than the f32 tile's 64 input columns) calls
    the FMA tile's f32 forward_tile; the probes keep their own instances."""
    calls = set()
    for path in sorted(CSRC.glob("*.cu*")):
        text = path.read_text()
        for gone in ("mlp_comp_fwd_kernel", "rm_comp_fwd_kernel", "comp_fwd_smem_bytes",
                     "group_of(", "load_chunk"):
            assert gone not in text, (path.name, gone)
        if "forward_tile<float>" in text:
            calls.add(path.name)
    assert calls == {"raymarch_fwd.cu"}
    b6 = (CSRC / "raymarch_fwd.cu").read_text()
    fma = b6.index("rm_fwd_fma_kernel(Dims dm")
    assert b6.index("forward_tile<float>(") > fma
    assert "  if (!tf32_inputs_fit(dm.xyz, dm.dir)) {" in b6
    # The FMA-era grouping of composite_common.cuh is gone with them.
    comp = (CSRC / "composite_common.cuh").read_text()
    assert "rays_per_group" not in comp and "n_groups" not in comp


# --------------------------------------------------------------------------- #
# (d) the wrappers' packs and scratch                                          #
# --------------------------------------------------------------------------- #

class _FakeLib:
    """A compositing library's exports, as its sources compute them
    (``kernel`` "B7", "B5" or "B4"), and launches that record what they were
    given."""

    def __init__(self, kernel, cfg):
        self.kernel, self.cfg, self.calls = kernel, cfg, []

    def nerf_mlp_param_count(self, *dims):
        w, b = rc.weight_shapes(self.cfg)
        return sum(k * n for k, n in w) + sum(b)

    def nerf_mlp_mma_pack_elems(self, *dims):
        return rc.mma_layout(self.cfg)[1]

    def nerf_mlp_t32_pack_elems(self, *dims):
        return rc.t32_layout(self.cfg)[1]

    def nerf_comp_groups(self, is_bf16, R, S):
        return n_groups(R, S, BM if is_bf16 else T32_BM)

    def nerf_comp_act_elems(self, is_bf16, S):
        return act_elems(S, BM if is_bf16 else T32_BM)

    def nerf_comp_dx_rows(self, is_bf16):
        return BM if is_bf16 else T32_BM

    def _record(self, is_bf16, w, wt, dxs, raw, n_blocks, t32=False):
        n = self.nerf_mlp_mma_pack_elems() if is_bf16 else self.nerf_mlp_param_count() - sum(
            rc.weight_shapes(self.cfg)[1])
        if t32:  # the f32 pack, then the flat heads
            n = self.nerf_mlp_t32_pack_elems() + sum(
                k * m for k, m in rc.weight_shapes(self.cfg)[0][rc.N_TF32_PRODUCTS:])
        ctype = ctypes.c_uint16 if is_bf16 else ctypes.c_float
        read = [None if p is None else np.ctypeslib.as_array((ctype * n).from_address(p)).copy()
                for p in (w, wt)]
        self.calls.append(dict(is_bf16=is_bf16, w=read[0], wt=read[1], dxs=dxs, raw=raw,
                               n_blocks=n_blocks))
        return 0

    def nerf_rm_comp_bwd(self, is_bf16, has_dir, rd, z, w, wt, b, g_rgb, g_w, dz, raw, partial,
                         acts, dxs, dparams, n_blocks, *tail):
        return self._record(is_bf16, w, wt, dxs, raw, n_blocks, t32=not is_bf16)

    def nerf_rm_comp_fwd(self, is_bf16, has_dir, rd, z, w, b, rgb, weights, raw, *tail):
        return self._record(is_bf16, w, None, None, raw, None, t32=not is_bf16)

    def nerf_mlp_loss_comp(self, is_bf16, has_dir, enc, encd, z, dvec, target, w, wt, b, dz,
                           raw, partial, acts, dxs, out, n_blocks, *tail):
        return self._record(is_bf16, w, wt, dxs, raw, n_blocks, t32=not is_bf16)

    def nerf_mlp_comp_bwd(self, is_bf16, has_dir, enc, encd, z, w, wt, b, g_rgb, g_w, denc,
                          dencd, dz, raw, partial, acts, dds, dparams, n_blocks, *tail):
        return self._record(is_bf16, w, wt, dds, raw, n_blocks, t32=not is_bf16)

    def nerf_mlp_comp_fwd(self, is_bf16, has_dir, enc, encd, z, w, b, rgb, weights, raw, *tail):
        return self._record(is_bf16, w, None, None, raw, None, t32=not is_bf16)


SMS = 132


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers on CPU tensors as on the card: a fake library, a fake SM
    count and stream; the tensors stay on the CPU."""
    libs = {}
    monkeypatch.setattr(rk, "uses_kernel", lambda t: True)
    monkeypatch.setattr(rk, "load", lambda name: libs[name])
    monkeypatch.setattr(rk, "stream_of", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=SMS))
    counts = dict(kl.LAUNCHES)
    yield libs
    kl.LAUNCHES.update(counts)


SCRATCH_CASES = [("bfloat16", 4096, 64), ("bfloat16", 4096, 128), ("bfloat16", 7, 192),
                 ("bfloat16", 4093, 100), ("float32", 4096, 64), ("float32", 13, 100)]


@pytest.mark.parametrize("kernel", ["B7", "B5", "B4"])
@pytest.mark.parametrize("name,R,S", SCRATCH_CASES, ids=[f"{c[0]}-R{c[1]}-S{c[2]}"
                                                          for c in SCRATCH_CASES])
def test_scratch_is_sized_from_the_library_per_compute_type(fake_card, kernel, name, R, S):
    cfg = tm.MLPConfig(**CASES[0])
    cd = getattr(torch, name)
    lib = _FakeLib(kernel, cfg)
    n_params = lib.nerf_mlp_param_count() + (kernel == "B5")
    z = torch.zeros((R, S))
    # B4's slab holds dd rows (dir wide), the others' dx rows (xyz wide).
    width = cfg.dir_dim if kernel == "B4" else cfg.xyz_dim
    partial, acts, dxs, n_blocks = rk._comp_bwd_scratch(
        lib, n_params, cfg, cd, z, torch.device("cpu"), width if kernel == "B4" else None)
    groups = lib.nerf_comp_groups(cd == torch.bfloat16, R, S)
    assert n_blocks == min(groups, SMS)
    assert partial.numel() == n_blocks * n_params and partial.dtype == torch.float32
    assert acts.dtype == cd
    if cd == torch.bfloat16:
        assert groups == -(-R // rays_per_group(S))
        assert acts.numel() == n_blocks * tiles_per_group(S) * NACT * BM * HPAD
        assert dxs.numel() == n_blocks * BM * width and dxs.dtype == torch.float32
    else:
        # The f32 kit's 64-row 3xTF32 tiles, for all three: groups of about
        # 64 rows, one group's tiles kept, a 64-row slab (B4's of dd rows).
        rpg = 1 if S >= T32_BM else T32_BM // S
        assert groups == -(-R // rpg) == n_groups(R, S, T32_BM)
        assert acts.numel() == n_blocks * -(-rpg * S // T32_BM) * NACT * T32_BM * HPAD
        assert acts.numel() == n_blocks * act_elems(S, T32_BM)
        assert dxs.numel() == n_blocks * T32_BM * width and dxs.dtype == torch.float32


KERNEL_SRC = {"B7": B7_SRC, "B5": B5_SRC, "B4": B4_SRC}


@pytest.mark.parametrize("kernel", ["B7", "B5", "B4"])
def test_exports_in_the_sources_match_the_fake_library(kernel):
    # One definition of the exports, in the header each library includes:
    # both types from their kit's tile rows (bf16 128, f32 64).
    src = KERNEL_SRC[kernel]
    assert '#include "comp_exports.cuh"' in src and 'extern "C" int nerf_comp_' not in src
    assert ('extern "C" int nerf_comp_dx_rows(int is_bf16) { return is_bf16 ? nerf_mma::BM : '
            'nerf_tmma::BM; }') in EXPORTS_SRC
    assert ("return is_bf16 ? nerf_cmma::n_groups(R, S) : nerf_cmma::n_groups(R, S, "
            "nerf_tmma::BM);") in EXPORTS_SRC
    assert ("return is_bf16 ? nerf_cmma::act_elems(S) : "
            "nerf_cmma::act_elems<nerf_tmma::Kit>(S);") in EXPORTS_SRC
    # No library keeps an f32 sizing of its own, and no FMA backward is left.
    for text in (src, EXPORTS_SRC):
        assert "f32_chunks_kept" not in text and "f32_slab_rows" not in text
    for other in (CSRC / "mlp_comp_common.cuh", CSRC / "mlp_comp_fwd.cu"):
        assert "nerf_mlp_comp_act_slots" not in other.read_text()
    # Each kernel launches its bf16 instance on the bf16 branch and its f32
    # instance, on the 3xTF32 tiles through the same loop, on the other.
    launch = {"B7": ("if (bf16) {\n    err = launch_kernel(rm_comp_bwd_mma_kernel,",
                     "err = launch_kernel(rm_comp_bwd_t32_kernel, n_blocks, nerf_tmma::NT,"),
              "B5": ("mlp_loss_comp_mma_kernel<<<n_blocks, nerf_mma::NT, smem, stream>>>(",
                     "mlp_loss_comp_t32_kernel<<<n_blocks, nerf_tmma::NT, smem, stream>>>("),
              "B4": ("mlp_comp_bwd_mma_kernel<<<n_blocks, nerf_mma::NT, smem, stream>>>(",
                     "mlp_comp_bwd_t32_kernel<<<n_blocks, nerf_tmma::NT, smem, stream>>>(")}
    bf, f32 = src.index("  if (bf16) {"), src.index("  } else {")
    assert bf < src.index(launch[kernel][0]) < f32 < src.index(launch[kernel][1])
    loop = {"B7": "backward_groups<RayComp, K>(", "B5": "backward_groups<LossComp<float>, K>(",
            "B4": "backward_groups<MlpComp<float>, K>("}[kernel]
    assert loop in src and "using K = nerf_tmma::Kit;" in src
    for fma in ("rm_comp_bwd_kernel", "mlp_loss_comp_kernel", "mlp_comp_bwd_kernel(",
                "mlp_comp_bwd_kernel<", "backward_walk<float>", "cotangent_tile"):
        assert fma not in src
    # The forwards too: bf16 on the bf16 branch, f32 on the 3xTF32 tiles.
    bf, f32 = B4F_SRC.index("  if (bf16) {"), B4F_SRC.index("  } else {")
    assert bf < B4F_SRC.index("mlp_comp_fwd_mma_kernel<<<groups, nerf_mma::NT, smem, stream>>>(") < f32
    assert f32 < B4F_SRC.index("mlp_comp_fwd_t32_kernel<<<groups, nerf_tmma::NT, smem, stream>>>(")
    bf = B7F_SRC.index("  if (bf16) {")
    assert bf < B7F_SRC.index("launch_kernel(rm_comp_fwd_mma_kernel, groups, nerf_mma::NT,") < (
        B7F_SRC.index("launch_kernel(rm_comp_fwd_t32_kernel, groups, nerf_tmma::NT,"))


def _call_wrappers(fake_card, lib, kernel, cfg, ws, bs, cd, R, S, gen, fwd=True, **kw):
    """The wrapper(s) of ``kernel`` on small CPU inputs, through the fake
    library ``lib`` (B4 and B7: the forward, unless not ``fwd``, then the
    backward)."""
    z = torch.sort(2 + 4 * torch.rand((R, S), generator=gen), dim=1).values
    if kernel == "B7":
        fake_card["raymarch_comp_fwd"] = fake_card["raymarch_comp_bwd"] = lib
        rd = torch.rand((R, 6 + (cfg.n_angles + 1 if cfg.uses_view_dirs else 0)), generator=gen)
        if fwd:
            rk.raymarch_comp_fwd(ws, bs, cfg, rd, z, cd, **kw)
        rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, torch.rand((R, 3)), torch.rand((R, S)), cd, **kw)
        return
    enc = torch.rand((R * S, cfg.xyz_dim), generator=gen).to(cd)
    encd = torch.rand((R, cfg.dir_dim), generator=gen) if cfg.uses_view_dirs else None
    if kernel == "B5":
        fake_card["mlp_loss_comp"] = lib
        rk.mlp_loss_comp(ws, bs, cfg, enc, encd, z, torch.rand((R, 3)), torch.rand((R, 3)), cd,
                         **kw)
        return
    fake_card["mlp_comp_fwd"] = fake_card["mlp_comp_bwd"] = lib
    if fwd:
        rk.mlp_comp_fwd(ws, bs, cfg, enc, encd, z, cd, **kw)
    rk.mlp_comp_bwd(ws, bs, cfg, enc, encd, z, torch.rand((R, 3)), torch.rand((R, S)), cd, **kw)


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
@pytest.mark.parametrize("kernel", ["B7", "B5", "B4"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wrappers_pass_the_packs_of_the_compute_type(fake_card, case, kernel, name):
    """bf16: the F and B packs of ``pack_mma_weights`` (their size checked
    against the library's; B4's and B7's forwards the F pack alone), a slab
    (B4's of dd rows, with view dirs only); f32: the backwards and B5 the F
    and B buffers of ``t32_packs`` (their size checked) and a slab (B4's of
    dd rows, with view dirs only), the forwards its F buffer alone (its size
    checked too)."""
    cfg = tm.MLPConfig(**case)
    cd = getattr(torch, name)
    lib = _FakeLib(kernel, cfg)
    R, S = 5, 48
    ws, bs = rc.flatten_params(tm.init_params(torch.Generator().manual_seed(0), cfg), cfg, cd)
    _call_wrappers(fake_card, lib, kernel, cfg, ws, bs, cd, R, S, torch.Generator().manual_seed(1))
    calls = lib.calls
    assert len(calls) == (1 if kernel == "B5" else 2)
    if kernel != "B5":  # the forward: one pack, no scratch
        fwd, = [c for c in calls if c["n_blocks"] is None]
        assert fwd["wt"] is None
        calls = [c for c in calls if c is not fwd]
        want = (rc.pack_mma_weights(ws, cfg, "f").view(torch.int16).numpy().view(np.uint16)
                if cd == torch.bfloat16 else rc.t32_packs(ws, cfg)[0].numpy())
        np.testing.assert_array_equal(fwd["w"], want)
    (call,) = calls
    assert call["n_blocks"] == lib.nerf_comp_groups(cd == torch.bfloat16, R, S)
    if cd == torch.bfloat16:
        for got, kind in ((call["w"], "f"), (call["wt"], "b")):
            want = rc.pack_mma_weights(ws, cfg, kind).view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(got, want)
        assert (call["dxs"] is not None) == (kernel != "B4" or cfg.uses_view_dirs)
    else:
        for got, want in zip((call["w"], call["wt"]), rc.t32_packs(ws, cfg)):
            np.testing.assert_array_equal(got, want.numpy())
        assert (call["dxs"] is not None) == (kernel != "B4" or cfg.uses_view_dirs)
    bad = _FakeLib(kernel, cfg)
    bad.nerf_mlp_mma_pack_elems = lambda *dims: rc.mma_layout(cfg)[1] + 16
    bad.nerf_mlp_t32_pack_elems = lambda *dims: rc.t32_layout(cfg)[1] + 8
    match = "weight-pack layout" if cd == torch.bfloat16 else "f32 backward's pack layout"
    with pytest.raises(RuntimeError, match=match):
        _call_wrappers(fake_card, bad, kernel, cfg, ws, bs, cd, R, S,
                       torch.Generator().manual_seed(1))
    assert not bad.calls
    if kernel != "B5":  # the backward alone refuses the bad pack too
        with pytest.raises(RuntimeError, match=match):
            _call_wrappers(fake_card, bad, kernel, cfg, ws, bs, cd, R, S,
                           torch.Generator().manual_seed(1), fwd=False)
        assert not bad.calls


# --------------------------------------------------------------------------- #
# (e) the raw output and the plain versions the card's checks hold it to       #
# --------------------------------------------------------------------------- #

def test_kink_of_negates_sigma_only_where_the_signs_differ():
    raw = torch.tensor([[[0.1, 0.2, 0.3, 2.0], [0.4, 0.5, 0.6, -1e-3], [0.7, 0.8, 0.9, 3e-4],
                         [1.0, 1.1, 1.2, -5.0]]])
    side = torch.tensor([[1.0, 2e-4, -1e-6, -0.5]])
    out = rk.kink_of(raw, side)
    assert torch.equal(out[..., :3], raw[..., :3])
    assert out[0, :, 3].tolist() == pytest.approx([2.0, 1e-3, -3e-4, -5.0])
    assert rk.kink_of(raw, None) is raw


def _b7_small(case, seed=3, R=6, S=48):
    cfg = tm.MLPConfig(**case)
    ws, bs = rc.flatten_params(tm.init_params(torch.Generator().manual_seed(seed), cfg), cfg,
                               torch.bfloat16)
    gen = torch.Generator().manual_seed(seed + 1)
    o = torch.randn((R, 3), generator=gen)
    o = 4 * o / o.norm(dim=1, keepdim=True)
    d = -o / 4 + 0.3 * torch.randn((R, 3), generator=gen)
    vc = _view_components(d, cfg)
    rd = rk.pack_rays(cfg, o, d, vc)
    z = torch.sort(2 + 4 * torch.rand((R, S), generator=gen), dim=1).values
    return cfg, ws, bs, rd, z, 0.5 + torch.rand((R, 3), generator=gen), 0.5 + torch.rand(
        (R, S), generator=gen)


def _view_components(d, cfg):
    from nerf_and_dietnerf_tpu_torch.core import cameras

    return cameras.view_direction_components(d, cfg.n_angles) if cfg.uses_view_dirs else None


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_b7_backward_takes_the_given_side_of_the_kink(case):
    """With its own raw sigma as the side, the plain B7 backward is bitwise
    itself; a sample moved to the dead side (raw sigma <= 0) gets no sigma
    cotangent, one moved to the live side gets one; f64 sums stay within the
    bf16 tolerance of the f32 ones and come back in f64."""
    cfg, ws, bs, rd, z, g_rgb, g_w = _b7_small(case)
    cd = torch.bfloat16
    base = rk.raymarch_comp_bwd_plain(ws, bs, cfg, rd, z, g_rgb, g_w, cd)
    raw = rk.raymarch_fwd_plain(ws, bs, cfg, rd, z, cd)
    same = rk.raymarch_comp_bwd_plain(ws, bs, cfg, rd, z, g_rgb, g_w, cd, raw_sigma=raw[..., 3])
    assert all(torch.equal(a, b) for a, b in zip(base[0] + base[1] + [base[2]],
                                                 same[0] + same[1] + [same[2]]))
    side = -raw[..., 3]
    g_raw, _ = rk.composite_vjp(rk.kink_of(raw, side), z, g_rgb, g_w)
    live = raw[..., 3] > 0
    assert bool((g_raw[..., 3][live] == 0).all()) and bool((g_raw[..., 3][~live] != 0).any())
    moved = rk.raymarch_comp_bwd_plain(ws, bs, cfg, rd, z, g_rgb, g_w, cd, raw_sigma=side)
    assert not torch.equal(moved[2], base[2])
    exact = rk.raymarch_comp_bwd_plain(ws, bs, cfg, rd, z, g_rgb, g_w, cd, work=torch.float64)
    assert exact[2].dtype == torch.float64 and exact[0][0].dtype == torch.float64
    for got, want in zip(exact[0] + exact[1], base[0] + base[1]):
        assert _scaled_np(got, want) <= GRAD_TOL["bfloat16"]
    assert float((exact[2] - base[2]).norm() / base[2].norm()) <= GRAD_TOL["bfloat16"]


def _scaled_np(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_b5_takes_the_given_side_of_the_kink_and_sums_in_f64(case):
    cfg = tm.MLPConfig(**case)
    cd = torch.bfloat16
    ws, bs = rc.flatten_params(tm.init_params(torch.Generator().manual_seed(5), cfg), cfg, cd)
    tcfg, enc, encd, z, dvec, target = _b5_inputs(cfg, 5, 48)
    mse, dz, dws, dbs = rk.mlp_loss_comp_plain(ws, bs, cfg, enc, encd, z, dvec, target, cd)
    raw, _ = rk._raw_on_encodings(ws, bs, cfg, enc, encd, z, cd)
    same = rk.mlp_loss_comp_plain(ws, bs, cfg, enc, encd, z, dvec, target, cd,
                                  raw_sigma=raw[..., 3])
    assert torch.equal(same[0], mse) and torch.equal(same[1], dz)
    assert all(torch.equal(a, b) for a, b in zip(same[2] + same[3], dws + dbs))
    emse, edz, edws, edbs = rk.mlp_loss_comp_plain(ws, bs, cfg, enc, encd, z, dvec, target, cd,
                                                   work=torch.float64)
    assert edz.dtype == torch.float64 and edws[0].dtype == torch.float64
    assert abs(float(emse) - float(mse)) <= LOSS_RTOL["bfloat16"] * abs(float(mse))
    for got, want in zip(edws + edbs, dws + dbs):
        assert _scaled_np(got, want) <= GRAD_TOL["bfloat16"]
    assert float((edz - dz).norm() / dz.norm()) <= GRAD_TOL["bfloat16"]


def _b5_inputs(cfg, R, S, seed=7):
    from nerf_and_dietnerf_tpu_torch.core import encoding

    gen = torch.Generator().manual_seed(seed)
    pts = torch.rand((R * S, 3), generator=gen) * 2 - 1
    enc = encoding.encode_xyz(pts, cfg.n_freq_xyz).to(torch.bfloat16)
    encd = (encoding.encode_view_dirs(torch.randn((R, cfg.n_angles + 1), generator=gen),
                                      cfg.n_freq_dir) if cfg.uses_view_dirs else None)
    z = torch.sort(2 + 4 * torch.rand((R, S), generator=gen), dim=1).values
    return cfg, enc, encd, z, torch.randn((R, 3), generator=gen), -(0.5 + torch.rand(
        (R, 3), generator=gen))


@pytest.mark.parametrize("kernel", ["B7", "B5", "B4"])
def test_raw_output_on_the_cpu_is_the_plain_forward(kernel):
    cfg = tm.MLPConfig(**CASES[0])
    cd = torch.bfloat16
    if kernel == "B7":
        cfg, ws, bs, rd, z, g_rgb, g_w = _b7_small(CASES[0], R=3, S=40)
        raw = torch.full((*z.shape, 4), float("nan"))
        got = rk.raymarch_comp_bwd(ws, bs, cfg, rd, z, g_rgb, g_w, cd, raw=raw)
        want = rk.raymarch_comp_bwd_plain(ws, bs, cfg, rd, z, g_rgb, g_w, cd)
        assert torch.equal(raw, rk.raymarch_fwd_plain(ws, bs, cfg, rd, z, cd))
        assert torch.equal(got[2], want[2])
        # The bf16 forward gives its raw values too, and the plain forward's
        # pixels and weights.
        raw_f = torch.full((*z.shape, 4), float("nan"))
        got_f = rk.raymarch_comp_fwd(ws, bs, cfg, rd, z, cd, raw=raw_f)
        assert torch.equal(raw_f, raw)
        assert all(torch.equal(a, b) for a, b in zip(
            got_f, rk.raymarch_comp_fwd_plain(ws, bs, cfg, rd, z, cd)))
        # f32 B7's backward and forward give their raw values too (the C3
        # step report and the card's checks read them); a raw tensor of
        # another shape raises.
        ws32, bs32 = rc.flatten_params(tm.init_params(torch.Generator(), cfg), cfg,
                                       torch.float32)
        raw32, raw32_f = (torch.full((*z.shape, 4), float("nan")) for _ in range(2))
        rk.raymarch_comp_bwd(ws32, bs32, cfg, rd, z, g_rgb, g_w, torch.float32, raw=raw32)
        got32_f = rk.raymarch_comp_fwd(ws32, bs32, cfg, rd, z, torch.float32, raw=raw32_f)
        assert torch.equal(raw32, rk.raymarch_fwd_plain(ws32, bs32, cfg, rd, z, torch.float32))
        assert torch.equal(raw32_f, raw32)
        assert all(torch.equal(a, b) for a, b in zip(
            got32_f, rk.raymarch_comp_fwd_plain(ws32, bs32, cfg, rd, z, torch.float32)))
        for fn in (lambda r: rk.raymarch_comp_bwd(ws32, bs32, cfg, rd, z, g_rgb, g_w,
                                                  torch.float32, raw=r),
                   lambda r: rk.raymarch_comp_fwd(ws32, bs32, cfg, rd, z, torch.float32, raw=r)):
            with pytest.raises(ValueError, match="expected"):
                fn(raw32[:, :-1])
    elif kernel == "B5":
        ws, bs = rc.flatten_params(tm.init_params(torch.Generator().manual_seed(5), cfg), cfg, cd)
        _, enc, encd, z, dvec, target = _b5_inputs(cfg, 3, 40)
        raw = torch.full((*z.shape, 4), float("nan"))
        got = rk.mlp_loss_comp(ws, bs, cfg, enc, encd, z, dvec, target, cd, raw=raw)
        assert torch.equal(raw, rk._raw_on_encodings(ws, bs, cfg, enc, encd, z, cd)[0])
        assert torch.equal(got[1], rk.mlp_loss_comp_plain(ws, bs, cfg, enc, encd, z, dvec,
                                                          target, cd)[1])
        with pytest.raises(ValueError, match="expected"):
            rk.mlp_loss_comp(ws, bs, cfg, enc, encd, z, dvec, target, cd, raw=raw[:, :-1])
    else:
        ws, bs = rc.flatten_params(tm.init_params(torch.Generator().manual_seed(5), cfg), cfg, cd)
        _, enc, encd, z, _, _ = _b5_inputs(cfg, 3, 40)
        g_rgb, g_w = torch.rand((3, 3)), torch.rand((3, 40))
        want_raw = rk._raw_on_encodings(ws, bs, cfg, enc, encd, z, cd)[0]
        raw_f, raw_b = (torch.full((*z.shape, 4), float("nan")) for _ in range(2))
        got_f = rk.mlp_comp_fwd(ws, bs, cfg, enc, encd, z, cd, raw=raw_f)
        got_b = rk.mlp_comp_bwd(ws, bs, cfg, enc, encd, z, g_rgb, g_w, cd, raw=raw_b)
        assert torch.equal(raw_f, want_raw) and torch.equal(raw_b, want_raw)
        for got, want in ((got_f, rk.mlp_comp_fwd_plain(ws, bs, cfg, enc, encd, z, cd)),
                          (got_b, rk.mlp_comp_bwd_plain(ws, bs, cfg, enc, encd, z, g_rgb, g_w,
                                                        cd))):
            assert all(torch.equal(a, b) for a, b in zip(got[-2:], want[-2:]))
        with pytest.raises(ValueError, match="expected"):
            rk.mlp_comp_bwd(ws, bs, cfg, enc, encd, z, g_rgb, g_w, cd, raw=raw_b[:, :-1])
        # f32 B4's forward and backward give their raw values too (both on
        # the 3xTF32 tiles); a raw tensor of another shape raises.
        ws32, bs32 = rc.flatten_params(tm.init_params(torch.Generator().manual_seed(5), cfg), cfg,
                                       torch.float32)
        enc32 = enc.float()
        want32 = rk._raw_on_encodings(ws32, bs32, cfg, enc32, encd, z, torch.float32)[0]
        raw32, raw32_f = (torch.full((*z.shape, 4), float("nan")) for _ in range(2))
        got32 = rk.mlp_comp_bwd(ws32, bs32, cfg, enc32, encd, z, g_rgb, g_w, torch.float32,
                                raw=raw32)
        got32_f = rk.mlp_comp_fwd(ws32, bs32, cfg, enc32, encd, z, torch.float32, raw=raw32_f)
        assert torch.equal(raw32, want32) and torch.equal(raw32_f, want32)
        assert all(torch.equal(a, b) for a, b in zip(got32[-2:], rk.mlp_comp_bwd_plain(
            ws32, bs32, cfg, enc32, encd, z, g_rgb, g_w, torch.float32)[-2:]))
        assert all(torch.equal(a, b) for a, b in zip(got32_f, rk.mlp_comp_fwd_plain(
            ws32, bs32, cfg, enc32, encd, z, torch.float32)))
        with pytest.raises(ValueError, match="expected"):
            rk.mlp_comp_fwd(ws32, bs32, cfg, enc32, encd, z, torch.float32, raw=raw32[:, :-1])


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
@pytest.mark.parametrize("kernel", ["B7", "B5", "B4"])
def test_wrappers_pass_the_raw_output_to_the_bf16_kernels(fake_card, kernel, name):
    """Every kernel takes the raw output, in both types: B7's and B4's
    forwards and backwards and B5 (all on the tensor cores; the card's checks
    read it, and hold each f32 forward's raw values bitwise to its
    backward's)."""
    cfg = tm.MLPConfig(**CASES[1])
    cd = getattr(torch, name)
    lib = _FakeLib(kernel, cfg)
    R, S = 4, 48
    ws, bs = rc.flatten_params(tm.init_params(torch.Generator().manual_seed(0), cfg), cfg, cd)
    raw = torch.empty((R, S, 4))

    def call(**kw):
        _call_wrappers(fake_card, lib, kernel, cfg, ws, bs, cd, R, S,
                       torch.Generator().manual_seed(1), **kw)

    call()
    assert all(c["raw"] is None for c in lib.calls)
    n = len(lib.calls)
    call(raw=raw)
    assert len(lib.calls) == 2 * n and all(c["raw"] == raw.data_ptr() for c in lib.calls[n:])
    if kernel != "B5":  # the forward, then the backward
        assert lib.calls[n]["n_blocks"] is None and lib.calls[-1]["n_blocks"] is not None
        call(raw=raw, fwd=False)  # the backward alone
        assert len(lib.calls) == 2 * n + 1 and lib.calls[-1]["raw"] == raw.data_ptr()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_b4_takes_the_given_side_of_the_kink_and_sums_in_f64(case):
    """As B5's: with its own raw sigma as the side B4's plain backward and
    forward are bitwise themselves, the other side moves dz; f64 sums come
    back in f64 within the bf16 tolerance of the f32 ones."""
    cfg = tm.MLPConfig(**case)
    cd = torch.bfloat16
    ws, bs = rc.flatten_params(tm.init_params(torch.Generator().manual_seed(5), cfg), cfg, cd)
    _, enc, encd, z, _, _ = _b5_inputs(cfg, 5, 48)
    gen = torch.Generator().manual_seed(11)
    g_rgb, g_w = 0.5 + torch.rand((5, 3), generator=gen), 0.5 + torch.rand((5, 48), generator=gen)
    args = (ws, bs, cfg, enc, encd, z, g_rgb, g_w, cd)
    base = rk.mlp_comp_bwd_plain(*args)
    raw, _ = rk._raw_on_encodings(ws, bs, cfg, enc, encd, z, cd)
    flat = lambda r: [t for t in r[0] + r[1] + list(r[2:]) if t is not None]  # noqa: E731
    same = rk.mlp_comp_bwd_plain(*args, raw_sigma=raw[..., 3])
    assert all(torch.equal(a, b) for a, b in zip(flat(same), flat(base)))
    fwd = rk.mlp_comp_fwd_plain(ws, bs, cfg, enc, encd, z, cd)
    assert all(torch.equal(a, b) for a, b in zip(
        rk.mlp_comp_fwd_plain(ws, bs, cfg, enc, encd, z, cd, raw_sigma=raw[..., 3]), fwd))
    moved = rk.mlp_comp_bwd_plain(*args, raw_sigma=-raw[..., 3])
    assert not torch.equal(moved[-1], base[-1])
    exact = rk.mlp_comp_bwd_plain(*args, work=torch.float64)
    assert exact[-3].dtype == torch.float64 and exact[0][0].dtype == torch.float64
    for got, want in zip(exact[0] + exact[1], base[0] + base[1]):
        assert _scaled_np(got, want) <= GRAD_TOL["bfloat16"]
    for got, want in zip(exact[2:], base[2:]):
        if want is not None:
            assert float((got - want).norm() / want.norm()) <= GRAD_TOL["bfloat16"]
    efwd = rk.mlp_comp_fwd_plain(ws, bs, cfg, enc, encd, z, cd, work=torch.float64)
    for got, want in zip(efwd, fwd):
        assert _scaled_np(got, want) <= GRAD_TOL["bfloat16"]


def test_f32_step_report_runs_on_the_cpu(capsys):
    from nerf_and_dietnerf_tpu_torch.tools import comp_f32_steps

    assert comp_f32_steps.main(["--device", "cpu", "--rays", "8", "--hidden", "32",
                                "--seeds", "0"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["case"] for r in lines] == [f"seed=0 {v} R=8 S=64" for v in ("view_dirs",
                                                                           "xyz_only")]
    for rec in lines:
        d = rec["b7"]["dparams"]
        # On the CPU the wrappers run the plain versions: the "kernel" is the
        # plain version, and f32 B6's backward on the same cotangent is B7's
        # MLP walk up to the cotangent's rounding.
        assert d["kernel_vs_chain"] == d["plain_vs_chain"] and d["ratio_kernel_to_plain"] == 1.0
        assert rec["b7"]["raw"]["kernel"] == rec["b7"]["raw"]["plain"]
        assert rec["b7"]["g_raw"]["chain"]["vs_chain"] == 0.0
        assert d["b6_on_kernel_cotangent_vs_b7"] < 1e-5
        assert rec["b4"]["ratio_kernel_to_plain"] == 1.0
        assert len(d["worst_leaves"]) == comp_f32_steps.TOP_LEAVES


@pytest.mark.parametrize("hidden", [32, None], ids=["narrow", "flagship"])
def test_t32_phase_reckoning_runs_on_the_cpu(capsys, tmp_path, hidden):
    """tools/t32_phases.py on the CPU: the reckoning per 64-row tile from the
    shapes (no phase is stamped without a card); its phase names are the
    CUDA header's enum, in order."""
    from nerf_and_dietnerf_tpu_torch.tools import t32_phases

    argv = ["--device", "cpu", "--out", str(tmp_path / "p.jsonl")] + (
        ["--hidden", str(hidden)] if hidden else [])
    assert t32_phases.main(argv) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert (tmp_path / "p.jsonl").read_text().splitlines() == [json.dumps(r) for r in lines]
    rec = lines[0]["reckoning_per_tile"]
    assert lines[1]["measured"].startswith("not measured")
    cfg = tm.MLPConfig(**({} if hidden is None else {"hidden_dim": hidden,
                                                      "last_hidden_dim": hidden // 2}))
    layout, total = rc.t32_layout(cfg)
    # Every product of the 11 matrices: 4 m-tiles of 16 rows, 8-wide n-tiles,
    # 8-deep k-steps, three TF32 products each; forward and chain back alike.
    assert rec["products"]["fwd"] == rec["products"]["bwd"] == 3 * 4 * total // 64
    assert rec["bytes"]["ring"] == 2 * 4 * total  # the F and the B pack, f32
    w, b = rc.weight_shapes(cfg)
    assert rec["bytes"]["slab"] == 8 * (sum(k * n for k, n in w) + sum(b))
    if hidden is None:  # the flagship tile: 97,536 products each way, 4.1 MB of slab
        assert rec["products"]["fwd"] == 97536 and rec["bytes"]["slab"] == 4114656
    enum = (CSRC / "t32_phases.cuh").read_text()
    body = enum[enum.index("enum Phase {"):enum.index("N_PHASES")]
    names = re.findall(r"^\s+([A-Z_]+),", body, re.MULTILINE)
    assert tuple(n.lower() for n in names) == t32_phases.PHASES


def test_serial_vjp_is_the_compositing_derivative():
    """The step report's emulation of composite_ray_bwd against autograd of
    core.rendering.composite, in f64 (the same derivative), on rays with
    samples on both sides of the kink."""
    from nerf_and_dietnerf_tpu_torch.tools import comp_f32_steps

    gen = torch.Generator().manual_seed(3)
    raw = torch.randn((6, 20, 4), generator=gen, dtype=torch.float64)
    z = torch.sort(2 + 4 * torch.rand((6, 20), generator=gen, dtype=torch.float64), 1).values
    g_rgb, g_w = torch.rand((6, 3), generator=gen), torch.rand((6, 20), generator=gen)
    g_ser, dz_ser = comp_f32_steps.vjp_serial(raw, z, g_rgb, g_w)
    assert g_ser.dtype == torch.float64
    g_ag, dz_ag = rk.composite_vjp(raw.float(), z.float(), g_rgb, g_w)
    # autograd runs in f32 (composite casts): within f32 rounding of the f64
    # recurrence.
    np.testing.assert_allclose(g_ser.numpy(), g_ag.double().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dz_ser.numpy(), dz_ag.double().numpy(), rtol=1e-5, atol=1e-6)


def test_kink_report_runs_on_the_cpu(capsys):
    from nerf_and_dietnerf_tpu_torch.tools import comp_kink

    assert comp_kink.main(["--device", "cpu", "--rays", "8", "--hidden", "32", "--seeds", "0"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    # The three kernels at the four shapes of both variants, and on opaque rays.
    assert len(lines) == 3 * (2 * len(comp_kink.SHAPES) + 1)
    for rec in lines:
        # On the CPU the wrappers run the plain version: no distance, no kink.
        assert rec["plain"]["dz_normwise"] == 0 and rec["kink_vs_plain"]["count"] == 0
        assert set(rec) >= {"plain_kink", "f64", "f64_kink", "plain_vs_f64", "kink_vs_f64"}
        assert rec["f64"]["dz_normwise"] == rec["plain_vs_f64"]["dz_normwise"]
        if rec["kernel"] == "B4":
            assert "denc_normwise" in rec["f64"]
    # The opaque rays alone, one case a kernel for each seed.
    assert comp_kink.main(["--device", "cpu", "--rays", "8", "--hidden", "32", "--seeds", "0",
                           "--opaque-only"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["kernel"] for r in lines] == ["B7", "B5", "B4"]
    assert all(r["case"].endswith("opaque") for r in lines)


def test_outputs_compare_bitwise_with_a_saved_run(tmp_path, capsys):
    from nerf_and_dietnerf_tpu_torch.tools import comp_outputs

    path = tmp_path / "out.pt"
    args = ["--device", "cpu", "--rays", "2"]
    assert comp_outputs.main(args + ["--save", str(path)]) == 0
    assert comp_outputs.main(args + ["--compare", str(path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    # Nine kernels (B1, B2, B4 fwd / bwd, B5, B6 fwd / bwd, B7 fwd / bwd), two
    # variants, two compute types, two sample counts.
    kernels = {line.split()[0] for line in lines}
    assert kernels == {"B1", "B2", "B4_fwd", "B4", "B5", "B6_fwd", "B6", "B7_fwd", "B7"}
    assert len(lines) == 9 * 2 * 2 * len(comp_outputs.SAMPLES)
    assert all(line.endswith(" equal") for line in lines)
    saved = torch.load(path)
    key = sorted(saved)[0]
    saved[key][0] = saved[key][0] + 1  # one changed output
    torch.save(saved, path)
    assert comp_outputs.main(args + ["--compare", str(path)]) == 1
    assert sum(line.endswith(" differ") for line in capsys.readouterr().out.splitlines()) == 1
