"""The Python around the bf16 tensor-core kernels B1/B2: weight packs and the
backward's scratch sizes.

The kernels (``csrc/mlp_mma_tile.cuh``) read every weight matrix from two
zero-padded bf16 packs that ``ops/raymarch_cuda.pack_mma_weights`` builds,
and B2's scratch is sized per compute type. The kernels themselves run only
on the card, where ``chip_smoke.py`` holds them against their plain versions;
here the packs are held against ``flatten_params``, a forward computed from
the packs' padded blocks against the plain version and the JAX package's bf16
kernel (interpret mode), and the sizes against the CUDA sources.
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

CSRC = Path(rc.__file__).resolve().parent.parent / "csrc"
CASES = [
    dict(hidden_dim=40, last_hidden_dim=24, n_freq_xyz=5, n_freq_dir=4, n_angles=2),
    dict(hidden_dim=40, last_hidden_dim=24, n_freq_xyz=5, n_angles=0),
    dict(),  # the flagship widths: 256 / 128, xyz 33, dir 24
    dict(n_angles=0),
]
IDS = ["view_dirs", "xyz_only", "flagship_view_dirs", "flagship_xyz_only"]


def _unpack(pack, cfg, kind):
    """The weight matrices of a pack, read back through its layout."""
    layout, _ = rc.mma_layout(cfg)
    ws = []
    for (k, n), (off, kp, np_) in zip(rc.weight_shapes(cfg)[0], layout):
        block = pack[off:off + kp * np_]
        ws.append(block.view(np_, kp)[:n, :k].t() if kind == "f" else block.view(kp, np_)[:k, :n])
    return [w.contiguous() for w in ws]


def _weights(case, seed=0):
    cfg = tm.MLPConfig(**case)
    params = tm.init_params(torch.Generator().manual_seed(seed), cfg)
    ws, bs = rc.flatten_params(params, cfg, torch.bfloat16)
    return cfg, ws, bs


@pytest.mark.parametrize("kind", ["f", "b"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_unpacking_gives_back_the_weights_exactly(case, kind):
    cfg, ws, _ = _weights(case)
    pack = rc.pack_mma_weights(ws, cfg, kind)
    assert pack.dtype == torch.bfloat16 and pack.numel() == rc.mma_layout(cfg)[1]
    got = _unpack(pack, cfg, kind)
    assert len(got) == len(ws)
    for a, b in zip(got, ws):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["f", "b"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_every_pad_entry_is_zero_and_rows_are_aligned(case, kind):
    cfg, ws, _ = _weights(case)
    pack = rc.pack_mma_weights(ws, cfg, kind).float()
    layout, total = rc.mma_layout(cfg)
    live = torch.zeros(total, dtype=torch.bool)
    for (k, n), (off, kp, np_) in zip(rc.weight_shapes(cfg)[0], layout):
        assert kp % 16 == 0 and np_ % 16 == 0 and kp - k < 16 and np_ - n < 16
        # Each matrix starts on a 512-byte boundary and each row (kp or np
        # bf16 values) is a multiple of 32 bytes: 16-byte copies stay aligned.
        assert (2 * off) % 512 == 0 and (2 * kp) % 32 == 0 and (2 * np_) % 32 == 0
        blk = live[off:off + kp * np_]
        if kind == "f":
            blk.view(np_, kp)[:n, :k] = True
        else:
            blk.view(kp, np_)[:k, :n] = True
    assert int(live.sum()) == sum(k * n for k, n in rc.weight_shapes(cfg)[0])
    assert torch.count_nonzero(pack[~live]) == 0
    # Glorot weights are never exactly 0, so every live entry is non-zero.
    assert torch.count_nonzero(pack[live]) == int(live.sum())


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_plain_versions_fed_the_unpacked_weights_agree_bitwise(case):
    cfg, ws, bs = _weights(case)
    rng = np.random.default_rng(3)
    n = 200
    x = torch.tensor(rng.normal(size=(n, cfg.xyz_dim)), dtype=torch.float32).bfloat16()
    d = (torch.tensor(rng.normal(size=(n, cfg.dir_dim)), dtype=torch.float32).bfloat16()
         if cfg.uses_view_dirs else None)
    g = torch.tensor(0.5 + rng.random((n, 4)), dtype=torch.float32)
    for kind in ("f", "b"):
        ws2 = _unpack(rc.pack_mma_weights(ws, cfg, kind), cfg, kind)
        assert torch.equal(rc.mlp_fwd_plain(ws2, bs, cfg, x, d, torch.bfloat16),
                           rc.mlp_fwd_plain(ws, bs, cfg, x, d, torch.bfloat16))
        got = rc.mlp_bwd_plain(ws2, bs, cfg, x, d, g, torch.bfloat16)
        want = rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, torch.bfloat16)
        for a, b in zip(got[0] + got[1] + list(got[2:]), want[0] + want[1] + list(want[2:])):
            assert (a is None and b is None) or torch.equal(a, b)


def _forward_from_packs(fpack, bs, cfg, x, d):
    """The forward as the tensor-core tile computes it: every product on the
    padded blocks of the F pack (x and d zero-padded to multiples of 16,
    biases zero-padded), activations rounded to bf16 after each leaky."""
    layout, _ = rc.mma_layout(cfg)
    alpha = cfg.leaky_relu_alpha

    def block(i):  # W^T as (pad16(N), pad16(K)) -> the padded W (pad16(K), pad16(N))
        off, kp, np_ = layout[i]
        return fpack[off:off + kp * np_].view(np_, kp).t().float()

    def pad(t, width):
        return torch.nn.functional.pad(t.float(), (0, width - t.shape[1]))

    def layer(pre, bias, width):
        v = pre + pad(bias[None], width)
        return torch.where(v >= 0, v, alpha * v).bfloat16().float()

    xp = pad(x, layout[0][1])
    h = xp
    for l in range(8):
        i = rc._trunk_w(l)
        pre = h @ block(i)
        if l == 4:
            pre = xp @ block(4) + pre
        h = layer(pre, bs[l], layout[i][2])
    if cfg.uses_view_dirs:
        dp = pad(d, layout[10][1])
        sigma = h @ block(12)[:, :1] + dp @ block(13)[:, :1] + bs[10]
        r = layer(h @ block(9) + dp @ block(10), bs[8], layout[9][2])
        rgb = r @ block(11)[:, :3] + bs[9]
    else:
        sigma = h @ block(12)[:, :1] + bs[11]
        r = layer(h @ block(9), bs[8], layout[9][2])
        r = layer(r @ block(10), bs[9], layout[10][2])
        rgb = r @ block(11)[:, :3] + bs[10]
    return torch.cat([rgb, sigma], -1)


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_forward_from_the_packs_matches_plain_and_jax_bf16(case):
    jcfg = jm.MLPConfig(**case)
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tm.MLPConfig(**case)
    ws, bs = rc.flatten_params(tm.params_from_jax(jparams), cfg, torch.bfloat16)
    rng = np.random.default_rng(5)
    n = 130
    ex = rng.normal(size=(n, cfg.xyz_dim)).astype(np.float32)
    ed = rng.normal(size=(n, cfg.dir_dim)).astype(np.float32) if cfg.uses_view_dirs else None
    x = torch.tensor(ex).bfloat16()
    d = torch.tensor(ed).bfloat16() if ed is not None else None
    got = _forward_from_packs(rc.pack_mma_weights(ws, cfg, "f"), bs, cfg, x, d)
    plain = rc.mlp_fwd_plain(ws, bs, cfg, x, d, torch.bfloat16)
    # The zero pads add exact zeros: only the summation order may differ, which
    # can flip one bf16 rounding of an activation (2^-8 of the largest output).
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 2.0 ** -8 * scale
    ref = np.asarray(jrp.apply_mlp_fused(jparams, jcfg, ex, ed, compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), ref, atol=2.0 ** -8 * scale, rtol=0)


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / src).read_text()).group(1))


def test_backward_scratch_is_sized_per_compute_type():
    # B2's wrapper sizes its scratch from the library's exports; they return
    # the tile constants of the compute type's device code.
    bwd = (CSRC / "mlp_bwd.cu").read_text()
    assert "return is_bf16 ? nerf_mma::BM : TM;" in bwd
    assert ("return is_bf16 ? (long long)nerf_mma::NACT * nerf_mma::SLOT : "
            "(long long)NACT * TM * HMAX;") in bwd
    assert "constexpr int SLOT = BM * HPAD;" in (CSRC / "mlp_mma_tile.cuh").read_text()
    rows_bf16, rows_f32 = _constant("mlp_mma_tile.cuh", "BM"), _constant("mlp_common.cuh", "TM")
    assert (rows_bf16, rows_f32) == (128, 64)
    assert _constant("mlp_mma_tile.cuh", "NACT") == _constant("mlp_common.cuh", "NACT") == 10
    assert rc.MAX_WIDTH == _constant("mlp_mma_tile.cuh", "HPAD") == _constant(
        "mlp_common.cuh", "HMAX")
    # A ragged row count takes one more tile.
    n = 4096 * 64 - 37
    assert -(-n // rows_bf16) == 2048 and -(-n // rows_f32) == 4096
    # The wrapper reads both sizes from the library, for the compute type.
    src = Path(rc.__file__).read_text()
    assert "lib.nerf_mlp_bwd_tile_rows(is_bf16)" in src
    assert "lib.nerf_mlp_bwd_tile_act_elems(is_bf16)" in src


class _FakeLib:
    def __init__(self, elems):
        self.elems = elems

    def nerf_mlp_mma_pack_elems(self, has_dir, xyz, dir_, hid, last):
        return self.elems


def test_wrapper_checks_the_pack_size_against_the_library():
    cfg, ws, _ = _weights(CASES[0])
    total = rc.mma_layout(cfg)[1]
    f, b = rc._weights_for(_FakeLib(total), ws, cfg, torch.bfloat16, ("f", "b"))
    assert torch.equal(f, rc.pack_mma_weights(ws, cfg, "f"))
    assert torch.equal(b, rc.pack_mma_weights(ws, cfg, "b"))
    with pytest.raises(RuntimeError, match="weight-pack layout"):
        rc._weights_for(_FakeLib(total + 16), ws, cfg, torch.bfloat16, ("f",))
    ws32 = [w.float() for w in ws]
    (w,) = rc._weights_for(_FakeLib(0), ws32, cfg, torch.float32, ("f",))
    assert torch.equal(w, torch.cat([t.reshape(-1) for t in ws32]))
    with pytest.raises(ValueError, match="pack kind"):
        rc.pack_mma_weights(ws, cfg, "x")


def _packs_slice_by_slice(ws, cfg, kind):
    """The packs as a zero buffer with each matrix copied into its block."""
    layout, total = rc.mma_layout(cfg)
    pack = torch.zeros(total, dtype=torch.bfloat16)
    for w, (off, kp, np_) in zip(ws, layout):
        k, n = w.shape
        if kind == "f":
            pack[off:off + kp * np_].view(np_, kp)[:n, :k] = w.t()
        else:
            pack[off:off + kp * np_].view(kp, np_)[:k, :n] = w
    return pack


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gathered_packs_match_a_copy_per_matrix(case):
    """B2 takes both packs from one gather through a cached index: the same
    bits as copying each matrix into a zero buffer, one pack at a time."""
    cfg, ws, _ = _weights(case)
    both = rc._packs(ws, cfg, ("f", "b"))
    assert len(both) == 2
    for kind, pack in zip(("f", "b"), both):
        want = _packs_slice_by_slice(ws, cfg, kind)
        assert pack.is_contiguous() and torch.equal(pack, want)
        assert torch.equal(rc.pack_mma_weights(ws, cfg, kind), want)
    # The index is built once per layout and device; new weights reuse it.
    ws2 = [w * 2 for w in ws]
    hits = rc._pack_index.cache_info().hits
    assert torch.equal(rc._packs(ws2, cfg, ("f", "b"))[1], _packs_slice_by_slice(ws2, cfg, "b"))
    assert rc._pack_index.cache_info().hits == hits + 1
