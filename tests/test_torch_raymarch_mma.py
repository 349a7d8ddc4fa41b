"""The Python around B6 on the tensor-core tiles: the input tiles its kernels
build, a forward from the weight packs on them, dz from dx, and the weight
buffers the wrappers pass.

The kernels (``csrc/raymarch_fwd.cu``, ``csrc/raymarch_bwd.cu``, the builders
of ``csrc/raymarch_tile.cuh``) build each row's features straight into the
operand tiles of ``mlp_mma_tile.cuh`` (bf16: X 128 x 72, D 128 x 40) and
``mlp_tf32_tile.cuh`` (f32: 64 input columns after the 260 activation columns
of each 128-row tile's rows). They run only on the card, where ``chip_smoke.py`` holds
them against their plain versions. Here, for ragged row counts (R S not a
multiple of 128) at S in {48, 64, 192}:

- an emulation of both tiles is held against the encodings that the JAX
  package's ``_encode_tile`` gives in Pallas interpret mode (feature values,
  the row -> ray mapping, zero pad columns and rows past n), and the f32
  tile's rows read back through an emulation of ``ldmatrix``;
- a forward from the packs on those tiles (``pack_mma_weights`` unpacked for
  bf16, the 3xTF32 products of ``split_tf32`` for f32) against JAX's
  ``_forward_rays_pallas``;
- dz assembled from dx in ``dz_of_row``'s order against JAX's
  ``_backward_rays_pallas`` dz;
- the weight buffers the wrappers pass against the sizes a (fake) library
  reports.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_and_dietnerf_tpu.core import cameras as jcam
from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.ops import research_kernels as jrk
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk

CSRC = Path(rc.__file__).resolve().parent.parent / "csrc"
TILE_SRC = (CSRC / "raymarch_tile.cuh").read_text()
# Encodings at the flagship's widths (xyz 33, dir 24: the f32 input tile's
# 40 + 24 columns exactly) and an xyz-only variant; narrow hidden layers.
CASES = [
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=5, n_freq_dir=4, n_angles=2),
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=5, n_angles=0),
]
IDS = ["view_dirs", "xyz_only"]
N_RAYS = 13
SAMPLES = [48, 64, 192]  # 624, 832, 2496 rows: each leaves a part-filled last tile
# The emulated forwards against JAX's kernels, scaled by max |reference|. bf16:
# one bf16 ulp of the largest output, the tolerance the B1 pack test states (the
# sums run in another order, which can flip one activation's bf16 rounding). f32:
# the card's tolerance for f32 B1/B6 against their plain versions. dz: the
# tolerance tests/test_torch_research_kernels.py holds B6's gradients to.
FWD_TOL = {"bfloat16": 2.0 ** -8, "float32": 1e-4}
DZ_TOL = 5e-4


def _c_int(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


MMA_SRC = (CSRC / "mlp_mma_tile.cuh").read_text()
TF32_SRC = (CSRC / "mlp_tf32_tile.cuh").read_text()
BM = _c_int(MMA_SRC, "BM")
T32_BM = _c_int((CSRC / "mlp_tf32_mma_tile.cuh").read_text(), "BM")  # f32 backward tiles
LDX, LDD = 64 + 8, 32 + 8  # row strides of the bf16 X and D tiles (checked below)
IN_COLS = _c_int(TILE_SRC, "IN_COLS")  # f32 input columns of a tile row
ACT_COLS = 256 + 4  # f32 activation columns before them (checked below)
LDA = ACT_COLS + IN_COLS  # f32 tile row stride


def _pad(v: int, m: int) -> int:
    return -(-v // m) * m


def _setup(case, n_samples, seed=1):
    jcfg, tcfg = jm.MLPConfig(**case), tm.MLPConfig(**case)
    rng = np.random.default_rng(seed)
    orig = (3 * rng.normal(size=(N_RAYS, 3))).astype(np.float32)
    dirs = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 6.0, (N_RAYS, n_samples)), -1).astype(np.float32)
    vc = np.asarray(jcam.view_direction_components(dirs, jcfg.n_angles)) \
        if jcfg.uses_view_dirs else None
    rd = rk.pack_rays(tcfg, torch.tensor(orig), torch.tensor(dirs),
                      torch.tensor(vc) if vc is not None else None)
    return jcfg, tcfg, orig, dirs, vc, z, rd


# --------------------------------------------------------------------------- #
# Emulations of the kernels' builders                                          #
# --------------------------------------------------------------------------- #

def _feature(cfg, rd, z, row, c, of_dir):
    """What one thread of the builder computes for (row, column c): the point
    o + z d (a rounded product, then a rounded sum), theta = v f_k (+ pi/2 for
    a cos column), the sine, in f32; index tensors in, f32 out."""
    n_samples = z.shape[1]
    ray = row // n_samples
    if of_dir:
        per = 2 * cfg.n_freq_dir
        v = rd[ray, 6 + c // per]
        j = c % per
        k, is_cos = j // 2, j % 2
    else:
        per = 1 + 2 * cfg.n_freq_xyz
        coord, j = c // per, c % per
        v = rd[ray, coord] + z.reshape(-1)[row] * rd[ray, 3 + coord]
        k, is_cos = (j - 1).clamp(min=0) // 2, (j - 1).clamp(min=0) % 2
    f = (torch.full_like(v, math.pi) * torch.pow(2.0, k.float())).float()
    theta = v * f
    theta = torch.where(is_cos == 1, theta + torch.tensor(math.pi / 2, dtype=torch.float32),
                        theta)
    s = torch.sin(theta)
    return s if of_dir else torch.where(j == 0, v, s)


def _mma_tiles(cfg, rd, z):
    """The bf16 tiles of every 128-row tile, as build_mma_inputs leaves them:
    X (tiles, BM, LDX), D (tiles, BM, LDD) (None without view dirs), in f32;
    columns from pad16(width) on hold whatever the tile held before (here
    NaN, so a read of them shows), the pad columns below it and rows past n 0."""
    n = z.numel()
    tiles = -(-n // BM)
    out = []
    for width, ld, of_dir in ((cfg.xyz_dim, LDX, False), (cfg.dir_dim, LDD, True)):
        if of_dir and not cfg.uses_view_dirs:
            out.append(None)
            continue
        wp = _pad(width, 16)
        t = torch.full((tiles, BM, ld), float("nan"))
        row = torch.arange(tiles * BM)[:, None].expand(-1, wp)
        c = torch.arange(wp)[None, :].expand(tiles * BM, -1)
        live = (row < n) & (c < width)
        v = torch.zeros(row.shape)
        v[live] = _feature(cfg, rd, z, row[live], c[live], of_dir)
        t[:, :, :wp] = v.bfloat16().float().reshape(tiles, BM, wp)
        out.append(t)
    return out


def _tf32_tile(cfg, rd, z):
    """The f32 tile rows of every 128-row tile after RayTf32Inputs::begin_tile:
    (tiles, BM, LDA) floats, the activation columns NaN (what the tile held
    before, here made visible), input column c at ACT_COLS + c; and the
    logical (tiles, BM, IN_COLS) input columns."""
    n = z.numel()
    tiles = -(-n // BM)
    kx = _pad(cfg.xyz_dim, 8)
    dir_dim = cfg.dir_dim if cfg.uses_view_dirs else 0
    row = torch.arange(tiles * BM)[:, None].expand(-1, IN_COLS)
    c = torch.arange(IN_COLS)[None, :].expand(tiles * BM, -1)
    logical = torch.zeros(row.shape)
    is_x = (row < n) & (c < cfg.xyz_dim)
    is_d = (row < n) & (c >= kx) & (c - kx < dir_dim)
    logical[is_x] = _feature(cfg, rd, z, row[is_x], c[is_x], False)
    if dir_dim:
        logical[is_d] = _feature(cfg, rd, z, row[is_d], c[is_d] - kx, True)
    stored = torch.full((tiles * BM, LDA), float("nan"))
    stored[:, ACT_COLS:] = logical
    return stored.reshape(tiles, BM, LDA), logical.reshape(tiles, BM, IN_COLS)


def _ldmatrix_x4(warp_rows, addr):
    """``ldmatrix.x4`` of 32-bit words: matrix i's eight row addresses come
    from lanes 8 i .. 8 i + 7 (``addr``, float offsets into ``warp_rows``, the
    flat 16 rows of a warp, one per lane); lane l gets word l % 4 of row
    l / 4 of each matrix."""
    lane = torch.arange(32)
    return [warp_rows[addr[8 * i + lane // 4] + lane % 4] for i in range(4)]


def _jax_encodings(jcfg, rd, z):
    """``_encode_tile`` in Pallas interpret mode on one tile of all the rays:
    (enc (R S, xyz), encd (R S, dir) | None), rows ray-major, columns in the
    reference's order (the kernel's sample-major rows and weight-row
    permutation undone)."""
    lay = jrk._enc_layout(jcfg)
    n_rays, n_samples = z.shape
    f2, _ = jrk._expand_consts(n_rays, n_samples, need_m1=False)
    has_dir = jcfg.uses_view_dirs
    rows = n_rays * n_samples

    def kernel(rd_ref, z_ref, f2_ref, m_ref, o_ref, *outs):
        enc, encd, _, _ = jrk._encode_tile(jcfg, lay, rd_ref[:], z_ref[:], f2_ref[:], m_ref[:],
                                           o_ref[:], n_samples)
        outs[0][:] = enc
        if has_dir:
            outs[1][:] = encd

    shapes = [jax.ShapeDtypeStruct((rows, 3 + 2 * lay["nx"]), jnp.float32)]
    if has_dir:
        shapes.append(jax.ShapeDtypeStruct((rows, 2 * lay["nd"]), jnp.float32))
    outs = pl.pallas_call(kernel, out_shape=shapes, interpret=True)(
        jnp.asarray(rd.numpy()), jnp.asarray(z.numpy()), f2, jnp.asarray(lay["masks"]),
        jnp.asarray(lay["offs"]))
    res = []
    for out, perm in zip(outs, (lay["perm_xyz"], lay["perm_dir"])):
        out = np.asarray(out)
        ray_major = out.reshape(n_samples, n_rays, -1).transpose(1, 0, 2).reshape(rows, -1)
        ref = np.empty_like(ray_major)
        ref[:, perm] = ray_major
        res.append(ref)
    return res[0], (res[1] if has_dir else None)


def _sin_tol(cfg, rd, z):
    """XLA's CPU sine reduces its range in f32, which costs up to an f32 ulp
    of the angle: 1e-5 + max |theta| 2^-23 (as tests/test_torch_probes.py)."""
    pts = rd[:, None, :3] + z[..., None] * rd[:, None, 3:6]
    v = torch.cat([pts.reshape(-1), rd[:, 6:].reshape(-1)]).abs().max()
    return 1e-5 + float(v) * math.pi * 2.0 ** max(cfg.n_freq_xyz, cfg.n_freq_dir) * 2.0 ** -23


# --------------------------------------------------------------------------- #
# (i) the tiles                                                                #
# --------------------------------------------------------------------------- #

def test_tile_constants_match_the_cuda_sources():
    assert BM == 128 and _c_int(MMA_SRC, "NT") == 256
    assert "constexpr int LDX = 64 + 8;" in MMA_SRC and "constexpr int LDD = 32 + 8;" in MMA_SRC
    assert IN_COLS == 64 and _c_int(TILE_SRC, "NSTAGE") == 2
    assert "constexpr int ACT_COLS = HPAD + 4;" in TF32_SRC and _c_int(TF32_SRC, "HPAD") == 256
    assert "static constexpr int LDA = ACT_COLS + In::IN_COLS;" in TF32_SRC
    # The fragment loads: the activations' and the inputs' through one routine,
    # the inputs from column ACT_COLS on.
    assert "ldsm_x4(a, rw.tile + 4 * (row * LDA + k + 4 * (rw.lane >> 4)));" in TF32_SRC
    assert "const int row = (rw.lane & 7) + 8 * ((rw.lane >> 3) & 1);" in TF32_SRC
    assert "load_tile_a<LDA>(a, rw, nerf_tf32::ACT_COLS + (dir_cols ? kx() : 0) + k);" in TILE_SRC
    assert "st_shared_f32(rw.tile + 4 * (r * LDA + nerf_tf32::ACT_COLS + c), v);" in TILE_SRC
    # The f32 forward's shared memory: (hi, lo) stages of 256 x 16 floats, the
    # 128-row tile, the mbarriers; B6 two stages and 64 more columns a row.
    b6 = 4 * (2 * 2 * 256 * 16 + BM * LDA) + 8 * 2 * 2
    b1 = 4 * (3 * 2 * 256 * 16 + BM * ACT_COLS) + 8 * 2 * 3
    assert (b6, b1) == (231456, 231472) and max(b6, b1) <= 232448
    # Rows 16 bytes more than a multiple of 128 apart: the eight rows of an
    # ldmatrix phase fall in eight 16-byte bank groups (B1's stride and B6's).
    for stride in (ACT_COLS, LDA):
        assert len({(r * 4 * stride // 16) % 8 for r in range(8)}) == 8
    # The flagship's encodings fill the input columns exactly.
    cfg = tm.MLPConfig()
    assert _pad(cfg.xyz_dim, 8) + _pad(cfg.dir_dim, 8) == IN_COLS


@pytest.mark.parametrize("n_samples", SAMPLES)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_tiles_match_jax_encodings(case, n_samples):
    jcfg, tcfg, _, _, _, z, rd = _setup(case, n_samples)
    tz = torch.tensor(z)
    n = tz.numel()
    assert n % BM != 0
    X, D = _mma_tiles(tcfg, rd, tz)
    enc, encd = _jax_encodings(jcfg, rd, tz)
    tol = _sin_tol(tcfg, rd, tz)
    for tile, ref, width in ((X, enc, tcfg.xyz_dim), (D, encd, tcfg.dir_dim)):
        if ref is None:
            assert tile is None
            continue
        flat = tile.reshape(-1, tile.shape[-1])
        wp = _pad(width, 16)
        # Rows past n and the pad columns below pad16(width) are zero.
        assert not flat[n:, :wp].any() and not flat[:n, width:wp].any()
        # Row t * 128 + r of the tiles is ray (t * 128 + r) // S: the JAX
        # encodings (ray-major) rounded to bf16, within one bf16 ulp where the
        # two CPU sines straddle a rounding.
        b = torch.tensor(ref)
        a = flat[:n, :width]
        assert torch.all((a - b.bfloat16().float()).abs()
                         <= 2.0 ** -7 * b.abs() + tol)


@pytest.mark.parametrize("n_samples", SAMPLES)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tf32_tile_matches_jax_encodings_and_reads_back_through_ldmatrix(case, n_samples):
    jcfg, tcfg, _, _, _, z, rd = _setup(case, n_samples)
    tz = torch.tensor(z)
    n = tz.numel()
    stored, logical = _tf32_tile(tcfg, rd, tz)
    flat = logical.reshape(-1, IN_COLS)
    kx = _pad(tcfg.xyz_dim, 8)
    enc, encd = _jax_encodings(jcfg, rd, tz)
    tol = _sin_tol(tcfg, rd, tz)
    np.testing.assert_allclose(flat[:n, :tcfg.xyz_dim].numpy(), enc, atol=tol, rtol=1e-6)
    assert not flat[n:].any() and not flat[:n, tcfg.xyz_dim:kx].any()
    if encd is not None:
        np.testing.assert_allclose(flat[:n, kx:kx + tcfg.dir_dim].numpy(), encd, atol=tol,
                                   rtol=1e-6)
        assert not flat[:n, kx + tcfg.dir_dim:].any()
    # Every k8 step of x and d read back from the warp's rows as the TF32 A
    # fragment: a0 (g, k + t), a1 (g + 8, k + t), a2 (g, k + t + 4), a3 (g + 8, k + t + 4),
    # from 16-byte aligned row addresses.
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    row = (lane & 7) + 8 * ((lane >> 3) & 1)
    dir_dim = tcfg.dir_dim if tcfg.uses_view_dirs else 0
    for tile in (0, stored.shape[0] - 1):
        for warp in range(BM // 16):
            rows = logical[tile, 16 * warp:16 * warp + 16]
            warp_rows = stored[tile, 16 * warp:16 * warp + 16].reshape(-1)
            for col0, width in ((0, tcfg.xyz_dim), (kx, dir_dim)):
                for k in range(0, _pad(width, 8), 8):
                    addr = row * LDA + ACT_COLS + col0 + k + 4 * (lane >> 4)
                    assert bool((addr % 4 == 0).all())
                    a = _ldmatrix_x4(warp_rows, addr)
                    c = col0 + k + t
                    for got, want in zip(a, (rows[g, c], rows[g + 8, c], rows[g, c + 4],
                                             rows[g + 8, c + 4])):
                        assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
# (ii) a forward from the packs on the tiles                                   #
# --------------------------------------------------------------------------- #

def _unpack_f(pack, cfg):
    layout, _ = rc.mma_layout(cfg)
    return [pack[off:off + kp * np_].view(np_, kp)[:n, :k].t().float()
            for (k, n), (off, kp, np_) in zip(rc.weight_shapes(cfg)[0], layout)]


def _unpack_tf32(buf, cfg):
    """The hi and lo matrices of the 11 products and the head matrices."""
    layout, total = rc.tf32_layout(cfg)
    shapes = rc.weight_shapes(cfg)[0]
    out = []
    for half in (buf[:total], buf[total:2 * total]):
        ws = []
        for (k, n), (off, kp, np_) in zip(shapes, layout):
            nn, kk = torch.meshgrid(torch.arange(n), torch.arange(k), indexing="ij")
            ws.append(half[off + rc.tf32_stage_offset(nn, kk, np_, kp)].t())
        out.append(ws)
    heads, off = [], 2 * total
    for k, n in shapes[rc.N_TF32_PRODUCTS:]:
        heads.append(buf[off:off + k * n].view(k, n))
        off += k * n
    return out[0], out[1], heads


def _forward(cfg, x, d, bs, prod, heads, cd):
    """The network as both tiles run it on their operand tiles ``x`` / ``d``
    (pad columns included: they are zero, as the matrices' pad rows):
    products by ``prod(act, i)``, bias and leaky in f32, activations rounded
    to ``cd``, the narrow heads (rgb, sigma) in f32 from ``heads``."""
    a = cfg.leaky_relu_alpha

    def act(v):
        v = torch.where(v >= 0, v, a * v)
        return v.bfloat16().float() if cd == torch.bfloat16 else v

    h = x
    for layer in range(8):
        pre = prod(x, 4) + prod(h, 5) if layer == 4 else prod(h, layer if layer < 4 else layer + 1)
        h = act(pre + bs[layer])
    if cfg.uses_view_dirs:
        sigma = h @ heads[1] + d[:, :cfg.dir_dim] @ heads[2] + bs[10]
        r = act(prod(h, 9) + prod(d, 10) + bs[8])
        rgb = r @ heads[0] + bs[9]
    else:
        sigma = h @ heads[1] + bs[11]
        r = act(prod(h, 9) + bs[8])
        r = act(prod(r, 10) + bs[9])
        rgb = r @ heads[0] + bs[10]
    return torch.cat([rgb, sigma], -1)


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_from_the_packs_on_the_tiles_matches_jax(case, cd):
    jcfg, tcfg, orig, dirs, vc, z, rd = _setup(case, SAMPLES[0], seed=2)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    ws, bs = rc.flatten_params(tm.params_from_jax(params), tcfg, cd)
    tz = torch.tensor(z)
    n = tz.numel()
    if cd == torch.bfloat16:
        X, D = _mma_tiles(tcfg, rd, tz)
        x = X.reshape(-1, LDX)[:, :_pad(tcfg.xyz_dim, 16)]
        d = D.reshape(-1, LDD)[:, :_pad(tcfg.dir_dim, 16)] if D is not None else None
        wf = _unpack_f(rc.pack_mma_weights(ws, tcfg, "f"), tcfg)
        prod = lambda v, i: v[:, :wf[i].shape[0]] @ wf[i]  # noqa: E731
        heads = wf[rc.N_TF32_PRODUCTS:]
    else:
        _, logical = _tf32_tile(tcfg, rd, tz)
        flat = logical.reshape(-1, IN_COLS)
        kx = _pad(tcfg.xyz_dim, 8)
        x = flat[:, :kx]
        d = flat[:, kx:kx + _pad(tcfg.dir_dim, 8)] if tcfg.uses_view_dirs else None
        hi, lo, heads = _unpack_tf32(rc.tf32_weights(ws, tcfg), tcfg)

        def prod(v, i):  # lo.hi + hi.lo + hi.hi on split activations, exact products
            vh, vl = rc.split_tf32(v[:, :hi[i].shape[0]].contiguous())
            return vl @ hi[i] + vh @ lo[i] + vh @ hi[i]

    got = _forward(tcfg, x, d, bs, prod, heads, cd)[:n]
    ref = np.asarray(jrk.apply_raymarch_fused(
        params, jcfg, orig, dirs, vc, z,
        jnp.bfloat16 if cd == torch.bfloat16 else jnp.float32)).reshape(n, 4)
    scale = float(np.abs(ref).max())
    name = str(cd).split(".")[-1]
    np.testing.assert_allclose(got.numpy(), ref, atol=FWD_TOL[name] * scale, rtol=0)


# --------------------------------------------------------------------------- #
# (iii) dz from dx                                                             #
# --------------------------------------------------------------------------- #

def _dz_of_row(cfg, rd, z, dx):
    """dz as dz_of_row (csrc/raymarch_common.cuh) assembles it, row by row in
    f32, operations in its order: per coordinate c, s += (g_sin cos(theta_sin))
    f_k, then s += (g_cos cos(theta_cos)) f_k for k = 0, 1, ...; dz += (s +
    g_id) d_c."""
    n_samples = z.shape[1]
    n = z.numel()
    L, per = cfg.n_freq_xyz, 1 + 2 * cfg.n_freq_xyz
    ray = torch.arange(n) // n_samples
    o, dv = rd[ray, 0:3], rd[ray, 3:6]
    zr = z.reshape(-1)
    half_pi = torch.tensor(math.pi / 2, dtype=torch.float32)
    dz = torch.zeros(n)
    for c in range(3):
        p = o[:, c] + zr * dv[:, c]
        g = dx[:, c * per:(c + 1) * per]
        s = torch.zeros(n)
        for k in range(L):
            f = torch.tensor(math.pi * 2.0 ** k, dtype=torch.float32)
            s = s + (g[:, 1 + 2 * k] * torch.cos(p * f)) * f
            s = s + (g[:, 2 + 2 * k] * torch.cos(p * f + half_pi)) * f
        dz = dz + (s + g[:, 0]) * dv[:, c]
    return dz


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dz_from_dx_in_dz_of_rows_order_matches_jax(case):
    n_samples = SAMPLES[1]
    jcfg, tcfg, orig, dirs, vc, z, rd = _setup(case, n_samples, seed=4)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    g = np.random.default_rng(6).normal(size=(N_RAYS, n_samples, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda zz: jrk.apply_raymarch_fused(params, jcfg, orig, dirs, vc, zz,
                                                         jnp.float32), z)
    (ref,) = vjp(jnp.asarray(g))
    ws, bs = rc.flatten_params(tm.params_from_jax(params), tcfg, torch.float32)
    tz = torch.tensor(z)
    n = tz.numel()
    _, logical = _tf32_tile(tcfg, rd, tz)
    flat = logical.reshape(-1, IN_COLS)
    kx = _pad(tcfg.xyz_dim, 8)
    x = flat[:n, :tcfg.xyz_dim]
    d = flat[:n, kx:kx + tcfg.dir_dim] if tcfg.uses_view_dirs else None
    dx = rc.mlp_bwd_plain(ws, bs, tcfg, x, d, torch.tensor(g).reshape(n, 4), torch.float32)[2]
    # The kernel's per-block slab holds a tile's dx rows; dz is read back per
    # tile for its own rows only (the tile as a call of its own).
    dz = torch.cat([_dz_of_row(tcfg, rd, tz, dx)[r0:min(r0 + BM, n)] for r0 in range(0, n, BM)])
    ref = np.asarray(ref).reshape(-1)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(dz.numpy() / scale, ref / scale, atol=DZ_TOL)
    # The plain version's vectorised formula gives the same dz to f32 rounding.
    pts = rd[:, None, :3] + tz[..., None] * rd[:, None, 3:6]
    plain = rk._dz_from_dx(tcfg, rd, pts.reshape(-1, 3), dx, n_samples)
    np.testing.assert_allclose(dz.numpy() / scale, plain.numpy() / scale, atol=1e-5)


# --------------------------------------------------------------------------- #
# (iv) the weight buffers the wrappers pass                                    #
# --------------------------------------------------------------------------- #

class _FakeLib:
    """The size exports of a B6 library (csrc/raymarch_{fwd,bwd}.cu)."""

    def __init__(self, mma, tf32, tile=1, t32=None):
        self.mma, self.tf32, self.tile, self.t32 = mma, tf32, tile, t32
        self.calls = []

    def nerf_mlp_mma_pack_elems(self, has_dir, xyz, dir_, hid, last):
        return self.mma

    def nerf_mlp_tf32_pack_elems(self, has_dir, xyz, dir_, hid, last):
        return self.tf32

    def nerf_rm_fwd_tf32_tile(self, xyz, dir_):
        return self.tile

    def nerf_mlp_t32_pack_elems(self, has_dir, xyz, dir_, hid, last):
        return self.t32

    # The backward library's scratch exports (csrc/raymarch_bwd.cu) and launch.
    def nerf_mlp_param_count(self, has_dir, xyz, dir_, hid, last):
        return self.n_params

    def nerf_mlp_bwd_tile_rows(self, is_bf16):
        return BM if is_bf16 else T32_BM

    def nerf_mlp_bwd_tile_act_elems(self, is_bf16):
        return 10 * (BM if is_bf16 else T32_BM) * 256

    def nerf_rm_bwd(self, is_bf16, has_dir, rd, z, w, wt, b, g, dz, partial, acts, dxs, dparams,
                    n_blocks, *tail):
        self.calls.append(dict(is_bf16=is_bf16, w=w, wt=wt, acts=acts, dxs=dxs,
                               n_blocks=n_blocks))
        return 0


WEIGHT_CASES = [  # (compute type, backward, what the wrapper passes)
    ("bfloat16", False, "F pack"),
    ("bfloat16", True, "F and B packs"),
    ("float32", False, "TF32 buffer"),
    ("float32", True, "t32 F and B buffers"),
]


@pytest.mark.parametrize("cd,backward,what", WEIGHT_CASES, ids=[c[2] for c in WEIGHT_CASES])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wrappers_pass_packs_whose_size_the_library_checks(case, cd, backward, what):
    cfg = tm.MLPConfig(**case)
    dtype = getattr(torch, cd)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    ws, _ = rc.flatten_params(params, cfg, dtype)
    mma, tf32, t32 = rc.mma_layout(cfg)[1], rc.tf32_layout(cfg)[1], rc.t32_layout(cfg)[1]
    got = rk._rm_weights(_FakeLib(mma, tf32, t32=t32), ws, cfg, dtype, backward)
    if what == "F pack":
        want = [rc.pack_mma_weights(ws, cfg, "f")]
    elif what == "F and B packs":
        want = [rc.pack_mma_weights(ws, cfg, k) for k in ("f", "b")]
    elif what == "TF32 buffer":
        want = [rc.tf32_weights(ws, cfg)]
    else:
        want = list(rc.t32_packs(ws, cfg))
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    bad = (_FakeLib(mma + 16, tf32) if cd == "bfloat16" else
           _FakeLib(mma, tf32 + 512, t32=rc.t32_layout(cfg)[1] + 8))
    with pytest.raises(RuntimeError, match="pack layout"):
        rk._rm_weights(bad, ws, cfg, dtype, backward)


def test_f32_forward_beyond_the_input_tile_passes_the_flat_weights():
    # A library that runs these widths on the FMA tile (nerf_rm_fwd_tf32_tile
    # 0) gets the flat f32 weights, whatever its pack sizes.
    cfg = tm.MLPConfig(n_freq_xyz=10)
    assert _pad(cfg.xyz_dim, 8) + _pad(cfg.dir_dim, 8) > IN_COLS
    ws, _ = rc.flatten_params(tm.init_params(torch.Generator().manual_seed(0), cfg), cfg,
                              torch.float32)
    (w,) = rk._rm_weights(_FakeLib(0, 0, tile=0), ws, cfg, torch.float32, False)
    assert torch.equal(w, torch.cat([t.reshape(-1) for t in ws]))
    src = (CSRC / "raymarch_fwd.cu").read_text()
    assert "return tf32_inputs_fit(xyz, dir);" in src
    assert "return nerf_tf32::pad8(xyz) + nerf_tf32::pad8(dir) <= RayTf32Inputs::IN_COLS;" in TILE_SRC


def test_backward_scratch_and_dx_slab_are_sized_per_compute_type():
    bwd = (CSRC / "raymarch_bwd.cu").read_text()
    assert "return is_bf16 ? nerf_mma::BM : TM;" in bwd
    assert ("return is_bf16 ? (long long)nerf_mma::NACT * nerf_mma::SLOT : "
            "(long long)NACT * TM * HMAX;") in bwd
    # Both kernels give each block a dx slab of its tile's rows; the f32
    # kernel's tiles and slots are the exports' f32 sizes.
    assert "float* dxs = dx_all + (size_t)blockIdx.x * BM * dm.xyz;" in bwd
    assert "float* dxs = dx_all + (size_t)blockIdx.x * tm::BM * dm.xyz;" in bwd
    assert ("static_assert(nerf_tmma::BM == TM && (long long)nerf_tmma::NACT * nerf_tmma::SLOT =="
            in bwd)
    assert "n_blocks > tiles || dxs == nullptr)" in bwd
    src = Path(rk.__file__).read_text()
    assert "rows = lib.nerf_mlp_bwd_tile_rows(is_bf16)" in src
    assert "lib.nerf_mlp_bwd_tile_act_elems(is_bf16)" in src
    assert "torch.empty((n_blocks * rows * config.xyz_dim,)" in src


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_wrapper_passes_the_packs_and_a_dx_slab_per_compute_type(case, cd, monkeypatch):
    """B6's backward on the card, through a fake library: bf16 the F and B
    packs, f32 the F and B buffers of ``t32_packs``; in both a dx slab of
    each block's tile rows (128 bf16, 64 f32) x xyz f32, one block an SM at
    most, each block's NACT x rows x 256 slots."""
    from types import SimpleNamespace

    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl

    cfg = tm.MLPConfig(**case)
    ws, bs = rc.flatten_params(tm.init_params(torch.Generator().manual_seed(0), cfg), cfg, cd)
    lib = _FakeLib(rc.mma_layout(cfg)[1], rc.tf32_layout(cfg)[1], t32=rc.t32_layout(cfg)[1])
    lib.n_params = sum(w.numel() for w in ws) + sum(b.numel() for b in bs)
    R, S = 13, 48  # 624 rows: 5 tiles of 128 rows, 10 of 64, the last part-filled
    rd = torch.rand((R, 6 + (cfg.n_angles + 1 if cfg.uses_view_dirs else 0)))
    z = torch.sort(2 + 4 * torch.rand((R, S)), dim=1).values
    g = torch.rand((R, S, 4))
    seen = {}
    real = rk._rm_weights

    def rm_weights(*args):
        seen["bufs"] = real(*args)
        return seen["bufs"]

    monkeypatch.setattr(rk, "uses_kernel", lambda t: True)
    monkeypatch.setattr(rk, "load", lambda name: lib)
    monkeypatch.setattr(rk, "stream_of", lambda dev: 0)
    monkeypatch.setattr(rk, "_rm_weights", rm_weights)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=4))
    counts = dict(kl.LAUNCHES)
    try:
        rk.raymarch_bwd(ws, bs, cfg, rd, z, g, cd)
    finally:
        kl.LAUNCHES.update(counts)
    (call,) = lib.calls
    rows = BM if cd == torch.bfloat16 else T32_BM
    assert call["n_blocks"] == 4 and call["is_bf16"] == int(cd == torch.bfloat16)
    want = ([rc.pack_mma_weights(ws, cfg, k) for k in ("f", "b")] if cd == torch.bfloat16
            else list(rc.t32_packs(ws, cfg)))
    assert all(torch.equal(a, b) for a, b in zip(seen["bufs"], want))
    assert (call["w"], call["wt"]) == tuple(t.data_ptr() for t in seen["bufs"])
    assert call["dxs"] is not None
    assert lib.nerf_mlp_bwd_tile_rows(0) == T32_BM and -(-R * S // rows) > 4
