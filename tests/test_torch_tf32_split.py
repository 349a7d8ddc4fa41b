"""The Python around the f32 tensor-core forward B1: the TF32 split, the hi /
lo weight packs and their ring-stage layout; and a model of the f32
tensor-core backward tile (3xTF32 ``mma.sync``, ``csrc/mlp_tf32_mma_tile.cuh``)
that f32 B2 and f32 B6's backward run, against the JAX package's f32 kernels.

The kernel (``csrc/mlp_tf32_tile.cuh``) computes every wide product as
lo.hi + hi.lo + hi.hi on the tensor cores, with activations split in
registers and weights split by ``ops/raymarch_cuda.tf32_weights``. It runs
only on the card, where ``chip_smoke.py`` holds it against its plain f32
version and an f64 evaluation of the chain. Here the rounding is held against
a reference, the packs against the weights, a forward computed from the packs
with the 3xTF32 products emulated in f32 against the JAX package's f32 kernel
(interpret mode) and the f64 chain, and the sizes and the stage layout
against the CUDA source.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.ops import raymarch_pallas as jrp
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc

SRC = (Path(rc.__file__).resolve().parent.parent / "csrc" / "mlp_tf32_tile.cuh").read_text()
CASES = [
    dict(hidden_dim=40, last_hidden_dim=24, n_freq_xyz=5, n_freq_dir=4, n_angles=2),
    dict(hidden_dim=40, last_hidden_dim=24, n_freq_xyz=5, n_angles=0),
    dict(),  # the flagship widths: 256 / 128, xyz 33, dir 24
    dict(n_angles=0),
]
IDS = ["view_dirs", "xyz_only", "flagship_view_dirs", "flagship_xyz_only"]
# The forward from the packs against the JAX package's f32 kernel, scaled by
# max |reference|: the card's tolerance for f32 B1 against its plain version
# (chip_smoke.py TOL["float32"]). Against the f64 chain the emulation is held
# normwise within 4x the plain f32 version's distance, as on the card.
FWD_TOL = 1e-4
F64_FACTOR = 4.0


def _tf32_reference(v: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, to nearest, ties away from zero, in f64."""
    m, e = np.frexp(v.astype(np.float64))
    s = m * 2.0 ** 11
    r = np.sign(s) * np.floor(np.abs(s) + 0.5)
    return np.ldexp(r, e - 11).astype(np.float32)


def test_round_tf32_is_nearest_ties_away_with_low_bits_zero():
    rng = np.random.default_rng(0)
    v = (rng.normal(size=20000) * np.exp(rng.uniform(-20, 20, size=20000))).astype(np.float32)
    # Exact ties: an 11-bit value plus half of its last place, both signs.
    base = _tf32_reference(rng.normal(size=2000).astype(np.float32))
    half = np.ldexp(np.float32(1.0), np.frexp(base)[1] - 12).astype(np.float32)
    ties = np.concatenate([base + half, -(base + half)]).astype(np.float32)
    for vals in (v, ties):
        got = rc.round_tf32(torch.tensor(vals)).numpy()
        np.testing.assert_array_equal(got, _tf32_reference(vals))
        assert not (got.view(np.int32) & 0x1FFF).any()


def _weights(case, seed=0):
    cfg = tm.MLPConfig(**case)
    params = tm.init_params(torch.Generator().manual_seed(seed), cfg)
    ws, bs = rc.flatten_params(params, cfg, torch.float32)
    return cfg, ws, bs


def _unpack(buf, cfg):
    """(hi, lo) of each product matrix as (K, N), and the head matrices, read
    back through the layout."""
    layout, total = rc.tf32_layout(cfg)
    shapes = rc.weight_shapes(cfg)[0]
    out = []
    for half in (buf[:total], buf[total:2 * total]):
        mats = []
        for (k, n), (off, kp, np_) in zip(shapes, layout):
            nn, kk = torch.meshgrid(torch.arange(n), torch.arange(k), indexing="ij")
            mats.append(half[off + rc.tf32_stage_offset(nn, kk, np_, kp)].t().contiguous())
        out.append(mats)
    heads, off = [], 2 * total
    for k, n in shapes[rc.N_TF32_PRODUCTS:]:
        heads.append(buf[off:off + k * n].view(k, n))
        off += k * n
    assert off == buf.numel()
    return out[0], out[1], heads


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_packs_give_back_the_weights_and_pads_are_zero(case):
    cfg, ws, _ = _weights(case)
    buf = rc.tf32_weights(ws, cfg)
    layout, total = rc.tf32_layout(cfg)
    assert buf.dtype == torch.float32 and buf.is_contiguous()
    hi, lo, heads = _unpack(buf, cfg)
    for w, h, l_ in zip(ws, hi, lo):
        assert torch.equal(h, rc.round_tf32(w)) and torch.equal(l_, rc.round_tf32(w - h))
        assert float((h.double() + l_.double() - w.double()).abs().max()) <= \
            2.0 ** -22 * float(w.abs().max())
        for t in (h, l_):
            assert not (t.view(torch.int32) & 0x1FFF).any()
    for a, b in zip(heads, ws[rc.N_TF32_PRODUCTS:]):
        assert torch.equal(a, b)
    # Every entry outside the matrices' live blocks is zero in both packs.
    live = torch.zeros(total, dtype=torch.bool)
    for (k, n), (off, kp, np_) in zip(rc.weight_shapes(cfg)[0], layout):
        assert kp % 8 == 0 and kp - k < 8 and np_ in (64, 128, 256) and np_ >= n
        nn, kk = torch.meshgrid(torch.arange(n), torch.arange(k), indexing="ij")
        live[off + rc.tf32_stage_offset(nn, kk, np_, kp)] = True
    for half in (buf[:total], buf[total:2 * total]):
        assert not half[~live].any()


def _emulated_forward(buf, bs, cfg, x, d):
    """B1's arithmetic from the packs: each wide product as lo.hi + hi.lo +
    hi.hi in f32 on split activations (a TF32 x TF32 product is exact in
    f32), bias and leaky in f32, the heads in f32 from the flat head weights."""
    hi, lo, heads = _unpack(buf, cfg)
    a = cfg.leaky_relu_alpha

    def prod(act, i):
        ah, al = rc.split_tf32(act.contiguous())
        return al @ hi[i] + ah @ lo[i] + ah @ hi[i]

    def leaky(v):
        return torch.where(v >= 0, v, a * v)

    h = x
    for layer in range(8):
        if layer == 4:
            h = leaky(prod(x, 4) + prod(h, 5) + bs[layer])
        else:
            h = leaky(prod(h, layer if layer < 4 else layer + 1) + bs[layer])
    if cfg.uses_view_dirs:
        sigma = (h @ heads[1] + d @ heads[2]) + bs[10]
        r = leaky(prod(h, 9) + prod(d, 10) + bs[8])
        rgb = r @ heads[0] + bs[9]
    else:
        sigma = h @ heads[1] + bs[11]
        r = leaky(prod(h, 9) + bs[8])
        r = leaky(prod(r, 10) + bs[9])
        rgb = r @ heads[0] + bs[10]
    return torch.cat([rgb, sigma], -1)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_from_split_packs_matches_jax_f32_and_the_f64_chain(case):
    jcfg = jm.MLPConfig(**case)
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tm.MLPConfig(**case)
    ws, bs = rc.flatten_params(tm.params_from_jax(jparams), cfg, torch.float32)
    rng = np.random.default_rng(5)
    n = 130
    ex = rng.uniform(-1, 1, size=(n, cfg.xyz_dim)).astype(np.float32)
    ed = (rng.uniform(-1, 1, size=(n, cfg.dir_dim)).astype(np.float32)
          if cfg.uses_view_dirs else None)
    x = torch.tensor(ex)
    d = torch.tensor(ed) if ed is not None else None
    got = _emulated_forward(rc.tf32_weights(ws, cfg), bs, cfg, x, d)
    ref = np.asarray(jrp.apply_mlp_fused(jparams, jcfg, ex, ed, compute_dtype=jnp.float32))
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=FWD_TOL * scale, rtol=0)
    exact = rc._forward_plain(ws, bs, cfg, x, d, torch.float32, torch.float64)[0]
    plain = rc.mlp_fwd_plain(ws, bs, cfg, x, d, torch.float32)

    def dist(a):
        return float((a.double() - exact).norm() / exact.norm())

    assert dist(got) <= F64_FACTOR * dist(plain) + 2.0 ** -24


def _c_int(name: str) -> int:
    return int(re.search(rf"constexpr (?:int|uint32_t) {name} = (\d+)", SRC).group(1))


def test_pack_size_and_widths_match_the_cuda_source():
    assert _c_int("KS") == rc.TF32_CHUNK and _c_int("N_PROD") == rc.N_TF32_PRODUCTS
    assert "return (v + 7) & ~7;" in SRC  # pad8
    thresholds = re.search(r"npad\(int n\) \{ return n <= (\d+) \? (\d+) : n <= (\d+) \? (\d+) : "
                           r"(\d+); \}", SRC).groups()
    lo_n, lo_np, mid_n, mid_np, top_np = map(int, thresholds)
    for n in range(1, 257):
        want = lo_np if n <= lo_n else mid_np if n <= mid_n else top_np
        assert rc._npad(n) == want and rc._pad8(n) == (n + 7) & ~7
    # The export returns make_tf32_layout's total, which the layout builds as
    # the wrapper's tf32_layout does.
    for line in ("T.kp[i] = pad8(L.wk[i]);", "T.np[i] = npad(L.wn[i]);", "T.off[i] = T.total;",
                 "T.total += T.kp[i] * T.np[i];", "T.heads = 2 * T.total;",
                 "return nerf_tf32::make_tf32_layout(nerf_mlp::make_layout(dm)).total;"):
        assert line in SRC
    # Flagship widths: 515,072 floats a pack (view dirs), 577,536 (xyz-only).
    assert rc.tf32_layout(tm.MLPConfig())[1] == 515072
    assert rc.tf32_layout(tm.MLPConfig(n_angles=0))[1] == 577536


class _FakeLib:
    def __init__(self, elems):
        self.elems = elems

    def nerf_mlp_tf32_pack_elems(self, has_dir, xyz, dir_, hid, last):
        return self.elems


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_wrapper_checks_the_tf32_pack_size_against_the_library(case):
    cfg, ws, _ = _weights(case)
    total = rc.tf32_layout(cfg)[1]
    (buf,) = rc._weights_for(_FakeLib(total), ws, cfg, torch.float32, ("t",))
    assert torch.equal(buf, rc.tf32_weights(ws, cfg))
    with pytest.raises(RuntimeError, match="TF32 weight-pack layout"):
        rc._weights_for(_FakeLib(total + 512), ws, cfg, torch.float32, ("t",))


@pytest.mark.parametrize("np_", [64, 128, 256])
@pytest.mark.parametrize("kp", [8, 16, 24, 40, 256])
def test_stage_layout_is_the_descriptors_and_fills_each_stage_once(np_, kp):
    """Each chunk of a matrix block is what a ring stage holds: every (n, k)
    at the byte the no-swizzle K-major descriptor reads it from (core
    matrices of 8 rows x 16 bytes, LBO along K, SBO between 8-row groups),
    one distinct float per entry, filling the chunk's np x kc floats."""
    lbo = _c_int("LBO_BYTES")
    assert lbo == 128
    assert "return 32u * kc;" in SRC  # sbo_bytes
    # The products' descriptors: k8 step j at byte 256 j of the part's first
    # 8-row group; part h (columns SN h ..) SN / 8 groups down; lo a pack's
    # half stage (4 STAGE_FLOATS bytes) on.
    assert "const uint32_t b0 = base + (SN / 8) * h * sbo;" in SRC
    assert "make_desc(b0 + 256 * j, sbo)" in SRC
    assert "make_desc(b0 + 4 * STAGE_FLOATS + 256 * j, sbo)" in SRC
    stage_floats = _c_int("HPAD") * _c_int("KS")
    nn, kk = torch.meshgrid(torch.arange(np_), torch.arange(kp), indexing="ij")
    off = rc.tf32_stage_offset(nn, kk, np_, kp)
    assert torch.equal(off.flatten().sort().values, torch.arange(np_ * kp))
    for k0 in range(0, kp, 16):
        kc = min(16, kp - k0)
        assert np_ * kc <= stage_floats
        sl = off[:, k0:k0 + kc] - np_ * k0
        assert int(sl.min()) == 0 and int(sl.max()) == np_ * kc - 1
        n, k = nn[:, k0:k0 + kc], kk[:, k0:k0 + kc] - k0
        # k8 step j starts at byte 256 j: core matrices (k // 4) = 2 j, 2 j + 1.
        byte = (n % 8) * 16 + (n // 8) * (32 * kc) + (k % 4) * 4 + (k // 4) * lbo
        assert torch.equal(4 * sl, byte)
        for sn in (64, 128):  # part h of SN columns starts SN h / 8 groups down
            for h in range(np_ // sn if np_ >= sn else 0):
                assert int(4 * sl[sn * h, 0]) == (sn // 8) * h * 32 * kc


# --------------------------------------------------------------------------- #
# The f32 tensor-core backward (csrc/mlp_tf32_mma_tile.cuh, f32 B7's)          #
# --------------------------------------------------------------------------- #

CSRC = Path(rc.__file__).resolve().parent.parent / "csrc"
T32_SRC = (CSRC / "mlp_tf32_mma_tile.cuh").read_text()
COMP_SRC = (CSRC / "comp_mma_tile.cuh").read_text() + (CSRC / "raymarch_comp_tile.cuh").read_text()
SMEM_LIMIT = 232448
MAX_S = 512


def _t32_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+)", T32_SRC).group(1))


def _sw(r, c):
    """Where the tile stores column c of row r (``sw``)."""
    return c ^ (r & 4)


def test_t32_tile_constants_and_budget_match_the_cuda_source():
    bm, nt, hpad, kc, nstage, nact = (_t32_int(k) for k in
                                      ("BM", "NT", "HPAD", "KC", "NSTAGE", "NACT"))
    assert (bm, nt, hpad, kc, nstage, nact) == (64, 256, 256, 16, 2, 10)
    for line in ("constexpr int LDH = HPAD + 8;", "constexpr int LDX = 64 + 8;",
                 "constexpr int LDD = 32 + 8;", "constexpr int LDW = KC;",
                 "constexpr int STAGE = HPAD * LDW;", "constexpr int SLOT = BM * HPAD;",
                 "__device__ __forceinline__ int sw(int r, int c) { return c ^ (r & 4); }",
                 "T.kp[i] = pad16(L.wk[i]);", "T.np[i] = pad16(L.wn[i]);", "T.heads = T.total;"):
        assert line in T32_SRC
    ldh, ldx, ldd, stage = hpad + 8, 64 + 8, 32 + 8, hpad * kc
    fwd = 4 * (bm * ldh + bm * ldx + bm * ldd + nstage * stage + bm)
    bwd = fwd + 4 * (bm * ldh + bm * 8)
    assert (fwd, bwd) == (129280, 198912)

    # The ray-group loop's rows beside the tiles (comp_mma_tile.cuh): 9
    # floats a row of the group and one a ray, groups of 64-row tiles.
    def smem(S):
        return bwd + 4 * (1 if S >= bm else bm // S) * (9 * S + 1)

    assert max(smem(s) for s in range(1, MAX_S + 1)) == smem(MAX_S) == 217348 <= SMEM_LIMIT
    assert smem(64) == 201220
    for text in ("129,280", "198,912", "67,584", "32,768", "655,360"):
        assert text in T32_SRC
    for text in ("201,220", "217,348",
                 "smem_bytes<nerf_tmma::Kit>(nerf_comp::MAX_S_COMP) == 217348",
                 "smem_bytes<nerf_tmma::Kit>(64) == 201220"):
        assert text in COMP_SRC
    # A kept tile is NACT x 64 x 256 f32, the bytes of bf16's 128-row slots.
    assert nact * bm * hpad * 4 == 655360
    # 3xTF32: small terms first into fresh zero partials, each term issued
    # across every partial of the group before the next term (no product
    # waits on the one before it), then each partial added to its sum; in the
    # chain's products (mma_ntiles) and the weight gradients' (mma_wgrad).
    for p, a, b, acc in (("p[q][mt]", "[mt]", "[q]", "acc[mt][Q0 + q][e]"),
                         ("p[mt][nt]", "[mt]", "[nt]", "c[mt][nt][e]")):
        terms = [f"mma_tf32({p}, alo{a}, bh{b}[0], bh{b}[1]);",
                 f"mma_tf32({p}, ahi{a}, bl{b}[0], bl{b}[1]);",
                 f"mma_tf32({p}, ahi{a}, bh{b}[0], bh{b}[1]);"]
        if p == "p[mt][nt]":
            terms = [t.replace("bh[nt]", "bhi[nt]").replace("bl[nt]", "blo[nt]") for t in terms]
        at = [T32_SRC.index(t) for t in terms]
        assert at == sorted(at) and all(T32_SRC.count(t) == 1 for t in terms)
        assert T32_SRC.index(f"{acc} += {p}[e];") > at[-1]
        zero = T32_SRC.rindex(f"{p}[e] = 0.f;", 0, at[0])
        assert T32_SRC.rindex("#pragma unroll", 0, at[0]) > zero
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in T32_SRC


def _banks(addrs):
    return {a % 32 for a in addrs}


@pytest.mark.parametrize("ld", [256 + 8, 64 + 8, 32 + 8])
def test_t32_fragment_reads_fall_in_32_banks(ld):
    """Lane (g, t) of a warp reads, in the products' orientation, row g (and
    g + 8) at column k0 + t (and + 4), and, transposed for A^T G, row t (and
    t + 4) at column m0 + g (and + 8): with the row stride 8 (mod 32) and the
    swizzle, each of those loads touches 32 different banks."""
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for r0 in (0, 16, 32, 48):
        for k0 in range(0, 32, 8):
            for dr, dc in ((0, 0), (8, 0), (0, 4), (8, 4)):
                got = [(r0 + g + dr) * ld + _sw(r0 + g + dr, k0 + t + dc) for g, t in lanes]
                assert len(_banks(got)) == 32
    for r0 in range(0, 64, 8):
        for m0 in (0, 16):
            for dr, dc in ((0, 0), (4, 0), (0, 8), (4, 8)):
                got = [(r0 + t + dr) * ld + _sw(r0 + t + dr, m0 + g + dc) for g, t in lanes]
                assert len(_banks(got)) == 32


def test_t32_column_order_puts_a_lanes_b_fragment_side_by_side():
    """t32_offset (``t32_col`` in the CUDA source): every chunk of 16
    contraction columns is ``rows x 16`` floats in one piece (a bulk copy a
    chunk); the 8-byte load of lane (g, t) at float 2 t of a half holds its
    columns t and t + 4, and a half-warp's loads of a k-step (rows 8 j + g,
    64-byte rows) cover 32 different banks in either half of the chunk."""
    rows = 24
    r, c = torch.meshgrid(torch.arange(rows), torch.arange(48), indexing="ij")
    off = rc.t32_offset(r, c, rows)
    assert torch.equal(off.flatten().sort().values, torch.arange(rows * 48))
    for chunk in range(3):  # a chunk is its rows x 16 floats, row r at 16 r
        blk = off[:, 16 * chunk:16 * chunk + 16]
        assert int(blk.min()) == 16 * rows * chunk and int(blk.max()) == 16 * rows * (chunk + 1) - 1
        assert torch.equal(blk // 16 - rows * chunk, r[:, :16])
    for row in range(8):
        for half in range(2):
            base = 16 * row + 8 * (half ^ ((row >> 1) & 1))
            for t in range(4):
                assert int(off[row, 8 * half + t]) == base + 2 * t
                assert int(off[row, 8 * half + t + 4]) == base + 2 * t + 1
    for half in range(2):
        for hw in range(2):  # the two half-warps: g = 4 hw .. 4 hw + 3
            words = [int(off[8 + g, 8 * half]) + 2 * t + w
                     for g in range(4 * hw, 4 * hw + 4) for t in range(4) for w in range(2)]
            assert len(_banks(words)) == 32
    # The CUDA source's formula, and the load that uses it.
    assert ("  return ((((c >> 3) ^ (r >> 1)) & 1) << 3) + 2 * (c & 3) + ((c >> 2) & 1);"
            in T32_SRC)
    assert ("    const float2 w = lds2(cur + 4u * (row * LDW + t32_col(row, 8 * half) + "
            "2 * f.t));") in T32_SRC


def _t32_unpack(buf, cfg, kind):
    """Each product matrix as (K, N), and the head matrices, of a buffer of
    :func:`rc.t32_packs` (``kind`` "f" or "b")."""
    layout, total = rc.t32_layout(cfg)
    shapes = rc.weight_shapes(cfg)[0]
    mats = []
    for (k, n), (off, kp, np_) in zip(shapes, layout):
        kk, nn = torch.meshgrid(torch.arange(k), torch.arange(n), indexing="ij")
        at = rc.t32_offset(nn, kk, np_) if kind == "f" else rc.t32_offset(kk, nn, kp)
        mats.append(buf[off + at])
    heads, off = [], total
    for k, n in shapes[rc.N_TF32_PRODUCTS:]:
        heads.append(buf[off:off + k * n].view(k, n))
        off += k * n
    assert off == buf.numel()
    return mats, heads


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_t32_packs_give_back_the_weights_and_pads_are_zero(case):
    cfg, ws, _ = _weights(case)
    layout, total = rc.t32_layout(cfg)
    packs = rc.t32_packs(ws, cfg)
    for kind, buf in zip("fb", packs):
        assert buf.dtype == torch.float32 and buf.is_contiguous()
        mats, heads = _t32_unpack(buf, cfg, kind)
        for w, m in zip(ws, mats):
            assert torch.equal(m, w)  # f32 as given; the kernel splits in registers
        for a, b in zip(heads, ws[rc.N_TF32_PRODUCTS:]):
            assert torch.equal(a, b)
        live = torch.zeros(total, dtype=torch.bool)
        for (k, n), (off, kp, np_) in zip(rc.weight_shapes(cfg)[0], layout):
            assert kp == (k + 15) // 16 * 16 and np_ == (n + 15) // 16 * 16
            kk, nn = torch.meshgrid(torch.arange(k), torch.arange(n), indexing="ij")
            live[off + (rc.t32_offset(nn, kk, np_) if kind == "f"
                        else rc.t32_offset(kk, nn, kp))] = True
        assert not buf[:total][~live].any()
    # Flagship widths: 520,192 floats a pack with view dirs (every width a
    # multiple of 16 but xyz 33 -> 48 and dir 24 -> 32).
    assert rc.t32_layout(tm.MLPConfig())[1] == 2 * 48 * 256 + 7 * 256 * 256 + 256 * 128 + 32 * 128


class _FakeT32Lib:
    def __init__(self, elems):
        self.elems = elems

    def nerf_mlp_t32_pack_elems(self, has_dir, xyz, dir_, hid, last):
        return self.elems


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_wrapper_checks_the_t32_pack_size_against_the_library(case):
    cfg, ws, _ = _weights(case)
    total = rc.t32_layout(cfg)[1]
    got = rc._weights_for(_FakeT32Lib(total), ws, cfg, torch.float32, ("tf", "tb"))
    assert all(torch.equal(a, b) for a, b in zip(got, rc.t32_packs(ws, cfg)))
    with pytest.raises(RuntimeError, match="f32 backward's pack layout"):
        rc._weights_for(_FakeT32Lib(total + 64), ws, cfg, torch.float32, ("tf", "tb"))
    assert "return nerf_tmma::make_t32_layout(nerf_mlp::make_layout(dm)).total;" in T32_SRC


# The model of the tile's arithmetic below against the JAX package's f32
# backward (interpret mode), scaled per leaf and normwise for dx / dd: the
# card's tolerances for f32 B7's backward (chip_smoke.py TOL_BWD / TOL_ROWS
# in f32), since both sum in other orders. Against the backward evaluated in
# f64 it must be as close as the plain f32 version, within BWD_F64_FACTOR.
BWD_TOL, ROWS_TOL = 1e-3, 5e-3
BWD_F64_FACTOR = 1.0
T32_BM, T32_K = 64, 8


def _split(v):
    hi = rc.round_tf32(v.contiguous())
    return hi, rc.round_tf32(v - hi)


def _t32_dot(pairs, acc=None):
    """sum of a_i @ b_i over ``pairs`` as the tile's products run them into
    one accumulator: per 8-deep k-step the three TF32 products lo.hi + hi.lo
    + hi.hi of the split operands (each exact in f32) summed into a fresh
    partial (modelled as their f64 sum rounded once), which one f32 add then
    adds to the sum. A transposed operand (A^T G) is the same with the tile's
    rows as the contraction."""
    for a, b in pairs:
        ah, al = _split(a)
        bh, bl = _split(b)
        if acc is None:
            acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
        for k0 in range(0, a.shape[1], T32_K):
            s = slice(k0, k0 + T32_K)
            part = (al[:, s].double() @ bh[s].double() + ah[:, s].double() @ bl[s].double()
                    + ah[:, s].double() @ bh[s].double())
            acc = acc + part.float()
    return acc


def _load_rows(src, width, row0, ld):
    """``load_rows`` (csrc/mlp_tf32_mma_tile.cuh) of rows [row0, row0 + 64) of
    ``src`` (n, width) into a tile of row stride ``ld`` that held NaN before:
    column c of row r at sw(r, c), the pad columns [width, pad16(width)) and
    the rows past n zero; the columns past pad16 keep what they held."""
    n, wp = src.shape[0], -(-width // 16) * 16
    tile = torch.full((T32_BM, ld), float("nan"))
    r = torch.arange(T32_BM)[:, None]
    c = torch.arange(wp)[None, :]
    vals = torch.zeros((T32_BM, wp))
    k = min(T32_BM, max(0, n - row0))
    vals[:k, :width] = src[row0:row0 + k]
    tile[r.expand(-1, wp), c ^ (r & 4)] = vals
    return tile


def _read_cols(tile, width):
    """Columns [0, width) of each row of a swizzled tile, read through sw."""
    r = torch.arange(tile.shape[0])[:, None]
    c = torch.arange(width)[None, :]
    return tile[r.expand(-1, width), c ^ (r & 4)]


def _t32_mlp_bwd(ws, bs, cfg, x, d, g):
    """The backward of f32 B2's tile (and f32 B7's) on (x, d, g), tile by tile
    of 64 rows as B2's kernel walks them: X and D loaded by ``load_rows``
    (:func:`_load_rows`, rows past n zero, as the cotangent's), the forward
    (wide products by :func:`_t32_dot`, the skip layer's two and the view
    layer's two into one accumulator, heads in f32), then the chain back in
    backward_walk's order, weight gradients per tile by :func:`_t32_dot` with
    the rows as contraction, added to the slab tile after tile, dx and dd
    rows past n not written. Returns (dws, dbs, dx, dd)."""
    a = cfg.leaky_relu_alpha

    def leaky(v):
        return torch.where(v >= 0, v, a * v)

    def dleaky(post, gg):
        return torch.where(post >= 0, gg, a * gg)

    dws = [None] * len(ws)
    dbs = [None] * len(bs)
    dxs, dds = [], []

    def add(lst, i, v):
        lst[i] = v if lst[i] is None else lst[i] + v

    def colsum(v):
        return v.sum(0)

    n = x.shape[0]
    for r0 in range(0, n, T32_BM):
        tiles = [(_load_rows(x, cfg.xyz_dim, r0, 64 + 8), cfg.xyz_dim)] + (
            [(_load_rows(d, cfg.dir_dim, r0, 32 + 8), cfg.dir_dim)] if d is not None else [])
        for tile, width in tiles:  # pads and rows past n zero, the rest the rows
            wp = -(-width // 16) * 16
            got = _read_cols(tile, wp)
            assert not bool(got[:, width:].any()) and not bool(got[n - r0:].any())
            assert torch.equal(got[:n - r0, :width], (x if width == cfg.xyz_dim
                                                      else d)[r0:r0 + T32_BM])
        xt = _read_cols(tiles[0][0], cfg.xyz_dim)
        dt = _read_cols(tiles[1][0], cfg.dir_dim) if d is not None else None
        gt = torch.zeros((T32_BM, 4))
        gt[:min(T32_BM, n - r0)] = g[r0:r0 + T32_BM]
        hs, h = [], xt
        for layer in range(8):
            pairs = [(xt, ws[4]), (h, ws[5])] if layer == 4 else [
                (h, ws[layer if layer < 4 else layer + 1])]
            h = leaky(_t32_dot(pairs) + bs[layer])
            hs.append(h)
        h8 = hs[7]
        grgb, gsig = gt[:, :3], gt[:, 3:4]
        if cfg.uses_view_dirs:
            r = leaky(_t32_dot([(h8, ws[9]), (dt, ws[10])]) + bs[8])
            add(dws, 11, r.t() @ grgb)
            add(dbs, 9, colsum(grgb))
            gr = dleaky(r, grgb @ ws[11].t())
            add(dws, 9, _t32_dot([(h8.t(), gr)]))
            add(dws, 10, _t32_dot([(dt.t(), gr)]))
            add(dbs, 8, colsum(gr))
            add(dws, 12, h8.t() @ gsig)
            add(dws, 13, dt.t() @ gsig)
            add(dbs, 10, colsum(gsig))
            dds.append(_t32_dot([(gr, ws[10].t())]) + gsig * ws[13].t())
            gh = _t32_dot([(gr, ws[9].t())]) + gsig * ws[12].t()
        else:
            r0_ = leaky(_t32_dot([(h8, ws[9])]) + bs[8])
            r = leaky(_t32_dot([(r0_, ws[10])]) + bs[9])
            add(dws, 11, r.t() @ grgb)
            add(dbs, 10, colsum(grgb))
            gr = dleaky(r, grgb @ ws[11].t())
            add(dws, 10, _t32_dot([(r0_.t(), gr)]))
            add(dbs, 9, colsum(gr))
            gr0 = dleaky(r0_, _t32_dot([(gr, ws[10].t())]))
            add(dws, 9, _t32_dot([(h8.t(), gr0)]))
            add(dbs, 8, colsum(gr0))
            add(dws, 12, h8.t() @ gsig)
            add(dbs, 11, colsum(gsig))
            gh = _t32_dot([(gr0, ws[9].t())]) + gsig * ws[12].t()
        for layer in range(7, -1, -1):
            G = dleaky(hs[layer], gh)
            add(dbs, layer, colsum(G))
            prev = hs[layer - 1] if layer > 0 else None
            if layer == 4:
                add(dws, 4, _t32_dot([(xt.t(), G)]))
                add(dws, 5, _t32_dot([(prev.t(), G)]))
                dx_skip = _t32_dot([(G, ws[4].t())])
                gh = _t32_dot([(G, ws[5].t())])
            elif layer > 0:
                i = layer if layer < 4 else layer + 1
                add(dws, i, _t32_dot([(prev.t(), G)]))
                gh = _t32_dot([(G, ws[i].t())])
            else:
                add(dws, 0, _t32_dot([(xt.t(), G)]))
                dxs.append(_t32_dot([(G, ws[0].t())]) + dx_skip)
        dxs[-1] = dxs[-1][:n - r0]
        if dds:
            dds[-1] = dds[-1][:n - r0]
    return dws, dbs, torch.cat(dxs), (torch.cat(dds) if dds else None)


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_t32_backward_model_matches_jax_f32_and_the_f64_chain(case):
    """The 3xTF32 arithmetic of f32 B2's (and f32 B7's) backward tile in B2's
    tile order, modelled in torch: each 64-row tile loaded as ``load_rows``
    loads it (the last part-filled: n = 150), forwarded, then walked back; at
    narrow widths against the JAX package's f32 MLP backward
    (``_backward_pallas`` in interpret mode) at the card's f32 tolerances
    (``BWD_TOL`` per leaf, ``ROWS_TOL`` normwise), and no farther from the f64
    chain than the plain f32 version."""
    jcfg = jm.MLPConfig(**case)
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tm.MLPConfig(**case)
    ws, bs = rc.flatten_params(tm.params_from_jax(jparams), cfg, torch.float32)
    rng = np.random.default_rng(11)
    n = 150  # two full 64-row tiles and a part-filled one
    ex = rng.uniform(-1, 1, size=(n, cfg.xyz_dim)).astype(np.float32)
    ed = (rng.uniform(-1, 1, size=(n, cfg.dir_dim)).astype(np.float32)
          if cfg.uses_view_dirs else None)
    eg = rng.uniform(0.5, 1.5, size=(n, 4)).astype(np.float32)
    x, g = torch.tensor(ex), torch.tensor(eg)
    d = torch.tensor(ed) if ed is not None else None
    dws, dbs, dx, dd = _t32_mlp_bwd(ws, bs, cfg, x, d, g)

    args = (jnp.asarray(ex),) + ((jnp.asarray(ed),) if ed is not None else ())
    _, vjp = jax.vjp(lambda p, *e: jrp.apply_mlp_fused(p, jcfg, e[0], e[1] if len(e) > 1 else None,
                                                       compute_dtype=jnp.float32),
                     jparams, *args)
    jgrads = vjp(jnp.asarray(eg))
    rws, rbs = rc.flatten_params(tm.params_from_jax(jgrads[0]), cfg, torch.float32)
    for got, want in zip(dws + dbs, rws + rbs):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= BWD_TOL * scale
    rows = [(dx, jgrads[1])] + ([(dd, jgrads[2])] if ed is not None else [])
    for got, want in rows:
        want = torch.tensor(np.asarray(want))
        assert float((got - want).norm() / want.norm()) <= ROWS_TOL

    exact = rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, torch.float32, work=torch.float64)
    plain = rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, torch.float32)

    def dist(res):
        flat = torch.cat([t.reshape(-1).double() for t in res[0] + res[1]])
        ref = torch.cat([t.reshape(-1) for t in exact[0] + exact[1]])
        return (float((flat - ref).norm() / ref.norm()),
                float((res[2].double() - exact[2]).norm() / exact[2].norm()))

    for got, base in zip(dist((dws, dbs, dx)), dist(plain)):
        assert got <= BWD_F64_FACTOR * base + 2.0 ** -24


class _FakeB2Lib:
    """B2's library as the wrapper sees it: its exports, and a launch that
    records the weight buffers it was handed."""

    def __init__(self, cfg, t32_elems=None):
        self.cfg, self.calls = cfg, []
        self.t32_elems = rc.t32_layout(cfg)[1] if t32_elems is None else t32_elems

    def nerf_mlp_param_count(self, *dims):
        w, b = rc.weight_shapes(self.cfg)
        return sum(k * n for k, n in w) + sum(b)

    def nerf_mlp_t32_pack_elems(self, *dims):
        return self.t32_elems

    def nerf_mlp_mma_pack_elems(self, *dims):
        return rc.mma_layout(self.cfg)[1]

    def nerf_mlp_bwd_tile_rows(self, is_bf16):
        return 128 if is_bf16 else T32_BM

    def nerf_mlp_bwd_tile_act_elems(self, is_bf16):
        return 10 * (128 if is_bf16 else T32_BM) * 256

    def nerf_mlp_bwd(self, is_bf16, has_dir, x, d, w, wt, b, g, dx, dd, partial, acts, dparams,
                     n_blocks, n, *tail):
        self.calls.append(dict(is_bf16=is_bf16, w=w, wt=wt, acts=acts, n_blocks=n_blocks, n=n))
        return 0


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_b2_f32_wrapper_passes_the_t32_packs_and_sizes_its_scratch(case, monkeypatch):
    """f32 B2 on the card: the F and B buffers of ``t32_packs`` (their pack
    size checked against the library's), 64-row tiles, one block an SM at
    most, each block's NACT x 64 x 256 f32 slots."""
    from types import SimpleNamespace

    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl

    cfg, ws, bs = _weights(case)
    n = 2 * T32_BM * 3 + 5
    x = torch.rand((n, cfg.xyz_dim))
    d = torch.rand((n, cfg.dir_dim)) if cfg.uses_view_dirs else None
    g = torch.rand((n, 4))
    seen = {}
    real_weights_for = rc._weights_for

    def weights_for(lib, ws_, cfg_, cd, kinds):
        out = real_weights_for(lib, ws_, cfg_, cd, kinds)
        seen["kinds"], seen["bufs"] = kinds, out
        return out

    lib = _FakeB2Lib(cfg)
    monkeypatch.setattr(rc, "uses_kernel", lambda t: True)
    monkeypatch.setattr(rc, "load", lambda name: lib)
    monkeypatch.setattr(rc, "stream_of", lambda dev: 0)
    monkeypatch.setattr(rc, "_weights_for", weights_for)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=4))
    counts = dict(kl.LAUNCHES)
    try:
        rc.mlp_bwd(ws, bs, cfg, x, d, g, torch.float32)
        (call,) = lib.calls
        assert seen["kinds"] == ("tf", "tb")
        assert all(torch.equal(a, b) for a, b in zip(seen["bufs"], rc.t32_packs(ws, cfg)))
        assert (call["w"], call["wt"]) == tuple(b.data_ptr() for b in seen["bufs"])
        assert call["n"] == n and call["n_blocks"] == 4 and call["is_bf16"] == 0
        with pytest.raises(RuntimeError, match="f32 backward's pack layout"):
            monkeypatch.setattr(rc, "load", lambda name: _FakeB2Lib(cfg, t32_elems=8))
            rc.mlp_bwd(ws, bs, cfg, x, d, g, torch.float32)
    finally:
        kl.LAUNCHES.update(counts)


def test_b2_f32_kernel_runs_the_t32_tile_on_swizzled_zero_padded_inputs():
    """mlp_bwd.cu's f32 branch launches the 3xTF32 kernel (the FMA kernel is
    gone), which loads X and D with ``load_rows`` (modelled by
    :func:`_load_rows`) and runs ``backward_tile``: forward_tile keeping the
    slots, then backward_walk from the B pack's matrix 10."""
    b2 = (CSRC / "mlp_bwd.cu").read_text()
    assert "mlp_bwd_kernel<" not in b2 and "mlp_bwd_kernel(" not in b2
    f32 = b2.index("  } else {\n    const size_t smem = nerf_tmma::bwd_smem_bytes();")
    assert b2.index("mlp_bwd_t32_kernel<<<n_blocks, nerf_tmma::NT, smem, stream>>>(") > f32
    for line in ("    tm::load_rows(t.X, tm::LDX, x, dm.xyz, row0, dm.n);",
                 "    if (dm.has_dir) tm::load_rows(t.D, tm::LDD, d, dm.dir, row0, dm.n);",
                 "    tm::load_cotangent(t.GI, g, row0, dm.n);",
                 "    tm::backward_tile<nerf_br::Sink>(dm, L, M, F, Bp, B, t, ring, acts, part, "
                 "first, row0, dx,"):
        assert line in b2
    for line in ("  const int wp = nerf_mma::pad16(width);",
                 "    T[r * ld + sw(r, c)] = row < n && c < width ? src[(size_t)row * width + c]"
                 " : 0.f;",
                 "  const Mat b10 = bmat(Bp, M, 10);\n"
                 "  forward_tile(dm, L, M, F, B, t, ring, acts, nullptr, row0, &b10);\n"
                 "  backward_walk<Sink>(dm, L, M, Bp, t, ring, acts, part, first, row0, dx, dd, "
                 "after, b10);"):
        assert line in T32_SRC
    # The same tile rows and slots as the exports give.
    assert "return is_bf16 ? nerf_mma::BM : TM; }" in b2
    assert ("static_assert(nerf_tmma::BM == TM && (long long)nerf_tmma::NACT * nerf_tmma::SLOT =="
            in b2)


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_t32_b6_backward_model_matches_jax_f32(case):
    """f32 B6's backward as its kernel (``rm_bwd_t32_kernel``) runs it: each
    64-row tile's X and D built by ``build_t32_inputs`` (the f32 features,
    swizzled, the pad columns and the rows past n zero: the tiles
    ``load_rows`` gives, :func:`_load_rows`), B2's 3xTF32 tile
    (:func:`_t32_mlp_bwd`) writing the tile's dx rows to the block's slab,
    then each row's dz from its slab row; on 13 rays of 48 samples (624 rows,
    a part-filled last tile), dparams and dz against the JAX package's f32
    ``_backward_rays_pallas`` (interpret mode) at ``BWD_TOL`` per leaf and
    ``ROWS_TOL`` normwise."""
    from nerf_and_dietnerf_tpu.core import cameras as jcam
    from nerf_and_dietnerf_tpu.ops import research_kernels as jrk
    from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk

    jcfg = jm.MLPConfig(**case)
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tm.MLPConfig(**case)
    ws, bs = rc.flatten_params(tm.params_from_jax(jparams), cfg, torch.float32)
    rng = np.random.default_rng(13)
    n_rays, n_samples = 13, 48
    orig = (3 * rng.normal(size=(n_rays, 3))).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 6.0, (n_rays, n_samples)), -1).astype(np.float32)
    vc = (np.asarray(jcam.view_direction_components(dirs, jcfg.n_angles))
          if jcfg.uses_view_dirs else None)
    g = rng.uniform(0.5, 1.5, size=(n_rays, n_samples, 4)).astype(np.float32)
    n = n_rays * n_samples
    assert n % T32_BM != 0

    rd = rk.pack_rays(cfg, torch.tensor(orig), torch.tensor(dirs),
                      torch.tensor(vc) if vc is not None else None)
    tz = torch.tensor(z)
    pts, xe, de = rk.encode_rays_plain(cfg, rd, tz)  # the features the kernel builds
    dws, dbs, dx, _ = _t32_mlp_bwd(ws, bs, cfg, xe, de, torch.tensor(g).reshape(n, 4))
    dz = rk._dz_from_dx(cfg, rd, pts, dx, n_samples).reshape(n_rays, n_samples)

    _, vjp = jax.vjp(lambda p, zz: jrk.apply_raymarch_fused(p, jcfg, orig, dirs, vc, zz,
                                                           jnp.float32), jparams, z)
    jgp, jgz = vjp(jnp.asarray(g))
    rws, rbs = rc.flatten_params(tm.params_from_jax(jgp), cfg, torch.float32)
    for got, want in zip(dws + dbs, rws + rbs):
        assert float((got - want).abs().max()) <= BWD_TOL * float(want.abs().max())
    want = torch.tensor(np.asarray(jgz))
    assert float((dz - want).norm() / want.norm()) <= ROWS_TOL

    # The kernel: the tiles built as load_rows loads them, B2's tile on them
    # as a call of its own (its dx rows to the block's slab), dz from the slab.
    b6 = (CSRC / "raymarch_bwd.cu").read_text()
    tile = (CSRC / "raymarch_tile.cuh").read_text()
    for line in ("    build_t32_inputs(ry, dm.xyz, dm.dir, row0, dm.n, t.X, t.D);",
                 "    tm::load_cotangent(t.GI, g, row0, dm.n);",
                 "    tm::backward_tile<nerf_br::Sink>(tile_dm, L, M, F, Bp, B, t, ring, acts, part, "
                 "first, 0, dxs,\n                                     nullptr, more ? &f0 : nullptr);",
                 "    if (r < tile_dm.n) dz[row0 + r] = dz_of_row(ry, dxs + r * dm.xyz, "
                 "row0 + r);"):
        assert line in b6
    for line in ("  const int xp = nerf_mma::pad16(xyz);",
                 "    X[r * tm::LDX + tm::sw(r, c)] = row < n && c < xyz ? xyz_feature(ry, row, c)"
                 " : 0.f;",
                 "    D[r * tm::LDD + tm::sw(r, c)] = row < n && c < dir ? dir_feature(ry, row, c)"
                 " : 0.f;"):
        assert line in tile


def test_no_kernel_runs_the_fma_backward_walk():
    """Every backward runs on the tensor cores: no source calls the f32 FMA
    backward walk (``backward_walk<float>`` / ``backward_tile<float>``, its
    tiles and cotangent loads), and the header that held it keeps only the
    slabs' sum and the parameter count."""
    for path in sorted(CSRC.glob("*.cu*")):
        text = path.read_text()
        for fma in ("backward_walk<float>", "backward_tile<float>", "backward_walk<T>",
                    "backward_tile<T>", "BwdTiles", "bwd_tiles(", "cotangent_tile",
                    "mlp_bwd_tile.cuh", "comp_bwd_smem_bytes"):
            assert fma not in text, (path.name, fma)
    assert not (CSRC / "mlp_bwd_tile.cuh").exists()
    slabs = (CSRC / "grad_slabs.cuh").read_text()
    assert "reduce_partials" in slabs and "nerf_mlp_param_count" in slabs
    assert "backward_walk" not in slabs and "wgrad" not in slabs
    # The f32 kernels of B6's and B4's backwards are the tensor-core ones.
    assert "rm_bwd_kernel(" not in (CSRC / "raymarch_bwd.cu").read_text()
    assert "mlp_comp_bwd_kernel(" not in (CSRC / "mlp_comp_bwd.cu").read_text()
