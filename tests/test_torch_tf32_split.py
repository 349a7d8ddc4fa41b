"""The Python around the f32 tensor-core forward B1: the TF32 split, the hi /
lo weight packs and their ring-stage layout.

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
