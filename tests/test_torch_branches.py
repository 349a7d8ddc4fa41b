"""The leaky branches of the backward tiles: the masks the kernels' recording
builds write (``csrc/branch_sink.cuh``), the plain versions that take them
(``branches=``), the guard that decides whether a mask may stand in for the
f64 chain's own signs, and the tools that use them, on the CPU.

Widths 32 / 16 on 13 rays x 6 samples (as the other port tests), both MLP
variants. On the CPU a wrapper given ``branches=`` writes the plain version's
own signs; the recording builds themselves run on the card only
(``chip_smoke.py``), their launch path is held here against a fake library.
"""

import dataclasses
import json
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_and_dietnerf_tpu.core import cameras as jcam
from nerf_and_dietnerf_tpu.core import encoding as jenc
from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.ops import raymarch_pallas as jrp
from nerf_and_dietnerf_tpu.ops import research_kernels as jrk
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
from nerf_and_dietnerf_tpu_torch.tools import comp_kink, parity_gpu
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

CASES = [
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=2, n_freq_dir=2, n_angles=2),
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=2, n_angles=0),
]
IDS = ["view_dirs", "xyz_only"]
N_RAYS, S = 13, 6
CSRC = Path(kl.CSRC_DIR)
# The JAX package's tolerances these plain versions are held to elsewhere
# (tests/test_torch_mlp_kernel.py: B2; tests/test_torch_research_kernels.py:
# B7; tests/test_torch_fused_mlp_kernels.py: B4, B5), gradients scaled by
# each leaf's max |value|.
TOL = {"B2": 5e-5, "B7": 5e-4, "B4": 1e-4, "B5": 1e-4}
KERNELS = ["B2", "B6", "B7", "B4", "B5"]
# Each plain backward in the types of its sums (B6's sums in f32 only).
WORKS = [(k, w) for k in KERNELS for w in (torch.float32, torch.float64)
         if not (k == "B6" and w == torch.float64)]


def _inputs(case, cd, seed=1):
    """The port's config, flat weights in ``cd`` and the inputs of every
    backward: rays and z (B6, B7), their plain encodings x / d, B4's and
    B5's torch-made encodings, the cotangents."""
    cfg = tm.MLPConfig(**case)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    ws, bs = rc.flatten_params(params, cfg, cd)
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    orig, dirs = f(N_RAYS, 3), f(N_RAYS, 3)
    vc = f(N_RAYS, cfg.n_angles + 1) if cfg.uses_view_dirs else None
    rd = rk.pack_rays(cfg, orig, dirs, vc)
    z = torch.sort(torch.tensor(rng.uniform(1.0, 5.0, (N_RAYS, S)).astype(np.float32)),
                   dim=1).values
    _, x, d = rk._mlp_inputs(cfg, rd, z, cd)
    enc = x.contiguous()
    encd = f(N_RAYS, cfg.dir_dim) if cfg.uses_view_dirs else None
    return SimpleNamespace(
        cfg=cfg, ws=ws, bs=bs, rd=rd, z=z, x=x, d=d, enc=enc, encd=encd,
        d_rows=rk._dir_rows(cfg, encd, S, cd), g=torch.rand(N_RAYS * S, 4) + 0.5,
        g_rgb=f(N_RAYS, 3), g_w=f(N_RAYS, S), dvec=dirs, target=f(N_RAYS, 3))


def _plain(kernel, t, cd, **kw):
    """Kernel ``kernel``'s plain backward on ``t``: its outputs, flat."""
    a = (t.ws, t.bs, t.cfg)
    if kernel == "B2":
        out = rc.mlp_bwd_plain(*a, t.x, t.d, t.g, cd, **kw)
    elif kernel == "B6":
        out = rk.raymarch_bwd_plain(*a, t.rd, t.z, t.g.reshape(N_RAYS, S, 4), cd, **kw)
    elif kernel == "B7":
        out = rk.raymarch_comp_bwd_plain(*a, t.rd, t.z, t.g_rgb, t.g_w, cd, **kw)
    elif kernel == "B4":
        out = rk.mlp_comp_bwd_plain(*a, t.enc, t.encd, t.z, t.g_rgb, t.g_w, cd, **kw)
    else:
        mse, dz, dws, dbs = rk.mlp_loss_comp_plain(*a, t.enc, t.encd, t.z, t.dvec, t.target, cd,
                                                   **kw)
        out = (dws, dbs, dz, mse)
    flat = []
    for o in out:
        flat += list(o) if isinstance(o, list) else [] if o is None else [o]
    return flat


def _mlp_rows(kernel, t):
    """The (x, d) rows the kernel's MLP runs on."""
    return (t.enc, t.d_rows) if kernel in ("B4", "B5") else (t.x, t.d)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("kernel,work", WORKS, ids=[f"{k}-{str(w)[-7:]}" for k, w in WORKS])
def test_own_branches_give_the_unpinned_result_bitwise(kernel, work, case, cd):
    t = _inputs(case, cd)
    mask = rc.own_branches(t.ws, t.bs, t.cfg, *_mlp_rows(kernel, t), cd, work)
    kw = {} if kernel == "B6" else {"work": work}
    base = _plain(kernel, t, cd, **kw)
    pinned = _plain(kernel, t, cd, branches=mask, **kw)
    assert len(base) == len(pinned)
    for a, b in zip(base, pinned):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_flipped_element_moves_only_its_row(case, cd):
    """B2 (dx) and B6 (dz): a flip of one recorded slope moves that row's
    input gradient and, in every weight gradient, that row's term only."""
    t = _inputs(case, cd)
    f64 = torch.float64
    mask = rc.own_branches(t.ws, t.bs, t.cfg, t.x, t.d, cd, f64)
    row, layer, col = 17, 3, 5
    flipped = mask.clone()
    flipped[layer, row, col] ^= 1
    base = rc.mlp_bwd_plain(t.ws, t.bs, t.cfg, t.x, t.d, t.g, cd, f64, mask)
    moved = rc.mlp_bwd_plain(t.ws, t.bs, t.cfg, t.x, t.d, t.g, cd, f64, flipped)
    others = torch.arange(t.x.shape[0]) != row
    assert torch.equal(base[2][others], moved[2][others])
    assert not torch.equal(base[2][row], moved[2][row])
    # The row alone, with and without the flip: its terms of the sums.
    one = slice(row, row + 1)
    d1 = t.d[one] if t.d is not None else None
    alone = [rc.mlp_bwd_plain(t.ws, t.bs, t.cfg, t.x[one], d1, t.g[one], cd, f64, m[:, one])
             for m in (mask, flipped)]
    for full_a, full_b, one_a, one_b in zip(base[0] + base[1], moved[0] + moved[1],
                                            alone[0][0] + alone[0][1], alone[1][0] + alone[1][1]):
        scale = float(full_a.abs().max()) + 1e-30
        assert float(((full_b - full_a) - (one_b - one_a)).abs().max()) <= 1e-12 * scale
    # B6: the same flip moves that row's dz alone.
    g = t.g.reshape(N_RAYS, S, 4)
    dz = [rk.raymarch_bwd_plain(t.ws, t.bs, t.cfg, t.rd, t.z, g, cd, branches=m)[2].reshape(-1)
          for m in (mask, flipped)]
    assert torch.equal(dz[0][others], dz[1][others]) and dz[0][row] != dz[1][row]


def _jax_signs(monkeypatch, params, jcfg, x, d):
    """The signs of every leaky pre-activation of the JAX package's own plain
    chain (``models/mlp.apply_mlp`` in f32) on the rows ``x`` / ``d``, as a
    mask of the port's layout."""
    signs, real = [], jm.leaky_relu

    def recording(pre, alpha):
        signs.append(torch.tensor(np.asarray(pre) >= 0))
        return real(pre, alpha)

    monkeypatch.setattr(jm, "leaky_relu", recording)
    jm.apply_mlp(params, jcfg, jnp.asarray(x), None if d is None else jnp.asarray(d),
                 compute_dtype=jnp.float32)
    monkeypatch.setattr(jm, "leaky_relu", real)
    return rc.pack_branches(signs, tm.MLPConfig(**{k: getattr(jcfg, k) for k in (
        "hidden_dim", "last_hidden_dim", "n_freq_xyz", "n_freq_dir", "n_angles")}))


def _assert_scaled(got, ref, tol):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        scale = max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a.detach().numpy() / scale, b / scale, atol=tol)


def _tree(dws, dbs, cfg):
    return tree_leaves(rc.unflatten_grads(dws, dbs, cfg))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("kernel", ["B2", "B7", "B4", "B5"])
def test_plain_versions_on_the_jax_chains_signs_match_jax(monkeypatch, kernel, case):
    """The plain versions pinned to the JAX package's own plain chain's signs
    against the JAX functions (their Pallas kernels in interpret mode) at the
    tolerances they are held to unpinned."""
    jcfg, tcfg = jm.MLPConfig(**case), tm.MLPConfig(**case)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    ws, bs = rc.flatten_params(tm.params_from_jax(params), tcfg, torch.float32)
    rng = np.random.default_rng(2)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    orig, dirs = f(N_RAYS, 4), f(N_RAYS, 4)
    z = np.sort(rng.uniform(1.0, 5.0, (N_RAYS, S)), -1).astype(np.float32)
    vc = jcam.view_direction_components(dirs, jcfg.n_angles) if jcfg.uses_view_dirs else None
    g_rgb, g_w = f(N_RAYS, 3), f(N_RAYS, S)
    if kernel == "B2":
        ex, ed = f(96, jcfg.xyz_dim), f(96, jcfg.dir_dim) if jcfg.uses_view_dirs else None
        g = f(96, 4)
        argnums = (0, 1, 2) if ed is not None else (0, 1)
        jg = jax.grad(lambda p, x, d: jnp.sum(
            jrp.apply_mlp_fused(p, jcfg, x, d, compute_dtype=jnp.float32) * g),
            argnums=argnums)(params, ex, ed)
        mask = _jax_signs(monkeypatch, params, jcfg, ex, ed)
        dws, dbs, dx, dd = rc.mlp_bwd_plain(ws, bs, tcfg, torch.tensor(ex),
                                            None if ed is None else torch.tensor(ed),
                                            torch.tensor(g), torch.float32, branches=mask)
        got = _tree(dws, dbs, tcfg) + [dx] + ([dd] if ed is not None else [])
        ref = jax.tree.leaves(jg[0]) + [jg[1]] + ([jg[2]] if ed is not None else [])
    elif kernel == "B7":
        (_, _), vjp = jax.vjp(lambda p, zz: jrk.apply_raymarch_composited(
            p, jcfg, orig, dirs, vc, zz, jnp.float32), params, z)
        jgp, jgz = vjp((jnp.asarray(g_rgb), jnp.asarray(g_w)))
        rd = rk.pack_rays(tcfg, torch.tensor(orig), torch.tensor(dirs),
                          None if vc is None else torch.tensor(np.asarray(vc)))
        _, x, d = rk.encode_rays_plain(tcfg, rd, torch.tensor(z))
        mask = _jax_signs(monkeypatch, params, jcfg, x.numpy(),
                          None if d is None else d.numpy())
        dws, dbs, dz = rk.raymarch_comp_bwd_plain(ws, bs, tcfg, rd, torch.tensor(z),
                                                  torch.tensor(g_rgb), torch.tensor(g_w),
                                                  torch.float32, branches=mask)
        got, ref = _tree(dws, dbs, tcfg) + [dz], jax.tree.leaves(jgp) + [jgz]
    else:
        pts = jcam.sample_points_along_rays(orig, dirs, z)[..., :3].reshape(-1, 3)
        enc = np.asarray(jenc.encode_xyz(pts, jcfg.n_freq_xyz))
        encd = (np.asarray(jenc.encode_view_dirs(vc, jcfg.n_freq_dir))
                if jcfg.uses_view_dirs else None)
        d_rows = None if encd is None else np.repeat(encd, S, axis=0)
        mask = _jax_signs(monkeypatch, params, jcfg, enc, d_rows)
        t_enc, t_encd, tz = (None if a is None else torch.tensor(a) for a in (enc, encd, z))
        if kernel == "B4":
            _, vjp = jax.vjp(lambda p, zz: jrk.apply_mlp_composited(p, jcfg, enc, encd, zz,
                                                                    jnp.float32), params, z)
            jgp, jgz = vjp((jnp.asarray(g_rgb), jnp.asarray(g_w)))
            dws, dbs, _, _, dz = rk.mlp_comp_bwd_plain(
                ws, bs, tcfg, t_enc, t_encd, tz, torch.tensor(g_rgb), torch.tensor(g_w),
                torch.float32, branches=mask)
        else:
            target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
            _, (jgp, jgz) = jax.value_and_grad(
                lambda p, zz: jrk.apply_mlp_loss_composited(p, jcfg, enc, encd, zz, dirs,
                                                            target, jnp.float32),
                argnums=(0, 1))(params, z)
            _, dz, dws, dbs = rk.mlp_loss_comp_plain(
                ws, bs, tcfg, t_enc, t_encd, tz, torch.tensor(dirs[:, :3]), torch.tensor(target),
                torch.float32, branches=mask)
        got, ref = _tree(dws, dbs, tcfg) + [dz], jax.tree.leaves(jgp) + [jgz]
    _assert_scaled(got, ref, TOL[kernel])


def _synthetic(cfg, rows, seed=0):
    """Pre-activations of every hidden layer, each row's largest |value| 1,
    and their signs as a mask."""
    gen = torch.Generator().manual_seed(seed)
    pres = []
    for w in rc.branch_widths(cfg):
        p = torch.rand((rows, w), generator=gen, dtype=torch.float64) * 2 - 1
        p[:, 0] = 1.0
        pres.append(p)
    return pres, rc.pack_branches([p >= 0 for p in pres], cfg)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_guard_takes_a_flip_inside_the_band_and_refuses_one_outside(case, cd):
    cfg = tm.MLPConfig(**case)
    pres, mask = _synthetic(cfg, 5000)
    band = rc.BRANCH_BAND[cd]
    rec = rc.branch_guard(mask, pres, cfg, cd)
    assert rec["ok"] and rec["disagreements"] == 0
    assert rec["elements"] == 5000 * sum(rc.branch_widths(cfg))
    # One element within the band of its row's largest, the other side taken.
    pres[4][7, 3] = 0.5 * band
    inside = rc.pack_branches([p >= 0 for p in pres], cfg)
    inside[4, 7, 3] = 0
    rec = rc.branch_guard(inside, pres, cfg, cd)
    assert rec["ok"] and rec["disagreements"] == 1
    assert rec["max_rel_pre"] == pytest.approx(0.5 * band)
    # The same at twice the band: refused, though it records the slope taken.
    pres[4][7, 3] = 2 * band
    rec = rc.branch_guard(inside, pres, cfg, cd)
    assert not rec["ok"] and rec["max_rel_pre"] == pytest.approx(2 * band)
    # Every disagreement inside the band, but more of them than the share.
    pres, mask = _synthetic(cfg, 5000, seed=1)
    n = int(rc.KINK_SHARE * rec["elements"]) + 2
    rows = torch.arange(n) % 5000
    cols = 1 + torch.arange(n) // 5000
    pres[2][rows, cols] = 0.5 * band
    mask[2, rows, cols] = 0
    rec = rc.branch_guard(mask, pres, cfg, cd)
    assert rec["disagreements"] == n and rec["max_rel_pre"] <= band and not rec["ok"]
    assert rec["share"] > rec["share_limit"] == rc.KINK_SHARE


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mask_layout_round_trips_and_refuses_unrecorded_elements(case):
    cfg = tm.MLPConfig(**case)
    widths = rc.branch_widths(cfg)
    assert widths == [32] * 8 + ([16] if cfg.uses_view_dirs else [32, 16])
    gen = torch.Generator().manual_seed(3)
    layers = [torch.rand((29, w), generator=gen) < 0.5 for w in widths]
    mask = rc.pack_branches(layers, cfg)
    # (layers, rows, max width) bytes, layer-major: byte (l, r, c) at
    # (l * rows + r) * width + c, as RecordBranches::record writes it.
    assert mask.shape == (len(widths), 29, 32) and mask.dtype == torch.uint8
    flat = mask.reshape(-1)
    for layer, r, c in ((0, 0, 0), (3, 11, 31), (len(widths) - 1, 28, 15)):
        assert flat[(layer * 29 + r) * 32 + c] == int(layers[layer][r, c])
    # Past the last layer's own width: unrecorded.
    assert bool((mask[-1, :, 16:] == rc.BRANCH_UNSET).all())
    back = rc.unpack_branches(mask, cfg)
    assert all(torch.equal(a, b) for a, b in zip(back, layers))
    empty = rc.branch_mask(cfg, 29, "cpu")
    assert bool((empty == rc.BRANCH_UNSET).all())
    mask[5, 20, 7] = rc.BRANCH_UNSET
    with pytest.raises(ValueError, match="no launch recorded"):
        rc.unpack_branches(mask, cfg)
    with pytest.raises(ValueError, match="not a branch mask"):
        rc.unpack_branches(torch.zeros((3, 29, 32), dtype=torch.uint8), cfg)


def _body(src: str, start: str) -> str:
    """The braces-balanced body that follows ``start`` in ``src``."""
    i = src.index("{", src.index(start))
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i + 1:j]
    raise AssertionError(start)


def test_production_builds_instantiate_the_no_op_sink():
    sink = (CSRC / "branch_sink.cuh").read_text()
    # The production branch of the header: the no-op sink, whose calls have
    # empty bodies; the recording one only under the flag the port's own
    # builds never pass.
    no_op = _body(sink, "struct NoBranches")
    # (three calls, each with an empty body and nothing else in the struct)
    assert len(re.findall(r"static __device__ __forceinline__ void \w+\([^)]*\) \{\}",
                          no_op)) == 3 == no_op.count(";") + 3 == no_op.count("{}")
    assert re.search(r"#else\s+namespace nerf_br \{\s+using Sink = NoBranches;", sink)
    assert sink.index("#ifdef NERF_BRANCHES") < sink.index("using Sink = RecordBranches;") \
        < sink.index("#else")
    assert "-DNERF_BRANCHES" not in kl.NVCC_FLAGS and kl.BRANCH_FLAGS == ["-DNERF_BRANCHES"]
    assert kl.lib_path("mlp_bwd").parent == kl.BUILD_DIR
    assert kl.lib_path("mlp_bwd", branches=True).parent == kl.BRANCH_DIR != kl.BUILD_DIR
    assert kl.lib_path("mlp_bwd", branches=True).name != kl.lib_path("mlp_bwd").name
    # The layout the Python side unpacks: layer-major, then rows, then columns.
    assert ("mask.bytes[((long long)layer * mask.rows + tile_row0 + r) * mask.width + c]"
            in sink)
    # Each backward kernel, in both types, instantiates its walk with
    # nerf_br::Sink and names its tile's rows to it before the barrier that
    # precedes the walk.
    for name in kl.BRANCH_KERNELS:
        src = (CSRC / kl.KERNEL_SOURCES[name]).read_text()
        assert len(re.findall(r"backward_(?:tile|groups)<[^;]*nerf_br::Sink>\(", src)) == 2, name
        assert "nerf_br::NoBranches" not in src and "RecordBranches" not in src
    # (with values the loops hold, so that no argument is an operation of its
    # own in the production code)
    for name in ("mlp_bwd", "raymarch_bwd"):
        src = (CSRC / kl.KERNEL_SOURCES[name]).read_text()
        assert len(re.findall(r"nerf_br::Sink::tile\(0, 0, tile, dm\.n, (?:tm::)?BM\);\n\s+"
                              r"__syncthreads\(\);", src)) == 2
    loop = (CSRC / "comp_mma_tile.cuh").read_text()
    assert re.search(r"Sink::tile\(g\.ray0, S, j, g\.rows, BM\);\n\s+__syncthreads\(\);", loop)
    # Every slope the two tiles take reaches the sink: the grad_tile sites and
    # the rgb head's, in bf16 and in f32; no kernel records elsewhere.
    # (f32's grad_tile hands its sink the pair of post-activations whose signs
    # picked the slopes)
    for header, pairs in (("mlp_mma_tile.cuh", 0), ("mlp_tf32_mma_tile.cuh", 1)):
        src = (CSRC / header).read_text()
        assert src.count("Sink::record(") == 2 - pairs
        assert src.count("Sink::record_pair(layer, r, n, N, p);") == pairs
        assert src.count("grad_tile<Sink>(") == 2
        assert "Sink::record(dm.has_dir ? 8 : 9, r, n, pos);" in src
    assert "if (c < N) record(layer, r, c, p.x >= 0.f);" in sink
    others = [p for p in CSRC.iterdir() if p.name not in (
        "branch_sink.cuh", "mlp_mma_tile.cuh", "mlp_tf32_mma_tile.cuh")]
    assert not any("Sink::record" in p.read_text() for p in others)


class _FakeRecordingLib:
    """B7's backward library as the wrapper sees it: exports, a launch and
    the recording build's mask export, each call kept in order."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, []

    def nerf_mlp_param_count(self, *a):
        w, b = rc.weight_shapes(self.cfg)
        return sum(k * n for k, n in w) + sum(b)

    def nerf_mlp_mma_pack_elems(self, *a):
        return rc.mma_layout(self.cfg)[1]

    def nerf_comp_groups(self, is_bf16, R, S):
        return R

    def nerf_comp_act_elems(self, is_bf16, S):
        return 1

    def nerf_comp_dx_rows(self, is_bf16):
        return 128

    def nerf_branch_buffer(self, ptr, rows, width, stream):
        self.calls.append(("buffer", ptr, rows, width, stream))
        return 0

    def nerf_rm_comp_bwd(self, *args):
        self.calls.append(("launch",))
        return 0


def test_wrapper_launches_the_recording_build_only_when_given_a_mask(monkeypatch):
    cfg = tm.MLPConfig(**CASES[0])
    t = _inputs(CASES[0], torch.bfloat16)
    prod, rec = _FakeRecordingLib(cfg), _FakeRecordingLib(cfg)
    monkeypatch.setattr(rk, "uses_kernel", lambda x: True)
    monkeypatch.setattr(rk, "load", lambda name: prod)
    monkeypatch.setattr(rk, "load_branches", lambda name: rec)
    monkeypatch.setattr(rk, "stream_of", lambda dev: 7)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    before = dict(kl.LAUNCHES)
    try:
        args = (t.ws, t.bs, cfg, t.rd, t.z.contiguous(), t.g_rgb, t.g_w, torch.bfloat16)
        rk.raymarch_comp_bwd(*args)
        assert prod.calls == [("launch",)] and rec.calls == []
        mask = rc.branch_mask(cfg, N_RAYS * S, "cpu")
        rk.raymarch_comp_bwd(*args, branches=mask)
        # The mask is named to the recording build, on the launch's stream,
        # before its launch; the launch counts under the kernel's name.
        assert rec.calls == [("buffer", mask.data_ptr(), N_RAYS * S, 32, 7), ("launch",)]
        assert prod.calls == [("launch",)]
        assert kl.LAUNCHES["raymarch_comp_bwd"] == before["raymarch_comp_bwd"] + 2
        with pytest.raises(ValueError):
            rk.raymarch_comp_bwd(*args, branches=rc.branch_mask(cfg, N_RAYS * S - 1, "cpu"))
        assert len(rec.calls) == 2
    finally:
        kl.LAUNCHES.update(before)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cpu_wrappers_record_the_plain_versions_own_signs(case):
    t = _inputs(case, torch.bfloat16)
    cd = torch.bfloat16
    for kernel, call in (
            ("B2", lambda m: rc.mlp_bwd(t.ws, t.bs, t.cfg, t.x, t.d, t.g, cd, branches=m)),
            ("B6", lambda m: rk.raymarch_bwd(t.ws, t.bs, t.cfg, t.rd, t.z,
                                             t.g.reshape(N_RAYS, S, 4), cd, branches=m)),
            ("B7", lambda m: rk.raymarch_comp_bwd(t.ws, t.bs, t.cfg, t.rd, t.z, t.g_rgb, t.g_w,
                                                  cd, branches=m)),
            ("B4", lambda m: rk.mlp_comp_bwd(t.ws, t.bs, t.cfg, t.enc, t.encd, t.z, t.g_rgb,
                                             t.g_w, cd, branches=m)),
            ("B5", lambda m: rk.mlp_loss_comp(t.ws, t.bs, t.cfg, t.enc, t.encd, t.z, t.dvec,
                                              t.target, cd, branches=m))):
        mask = rc.branch_mask(t.cfg, N_RAYS * S, "cpu")
        call(mask)
        want = rc.own_branches(t.ws, t.bs, t.cfg, *_mlp_rows(kernel, t), cd)
        assert torch.equal(mask, want), kernel


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kink_tool_holds_against_f64_branches_on_the_cpu(case):
    """comp_kink's fifth reference, fed the plain version's own signs: the
    recording run bitwise, the guard passed, f64_branches present."""
    t = _inputs(case, torch.bfloat16)
    for kernel, args in (("B7", (t.rd, t.z, t.g_rgb, t.g_w)),
                         ("B5", (t.enc, t.encd, t.z, t.dvec, t.target)),
                         ("B4", (t.enc, t.encd, t.z, t.g_rgb, t.g_w))):
        rec = comp_kink.held(kernel, t.ws, t.bs, t.cfg, torch.bfloat16, args)
        assert rec["recording_bitwise"] and rec["branches"]["ok"], kernel
        assert rec["f64_branches"]["dparams_worst_leaf"] <= rec["f64_kink"][
            "dparams_worst_leaf"] + 1e-6
    assert comp_kink.summary([{"kernel": "B7", "recording_bitwise": True, **rec}])["B7"][
        "guard_ok"]


def test_parity_pins_each_f32_paths_oracle_on_the_cpu():
    """parity_gpu's pinned check 1 on the CPU, where the wrappers record the
    plain version's own signs: one mask a pass, the rerun bitwise, each mask
    guarded, and the pinned oracle within the unpinned one's reach."""
    problem = parity_gpu.make_problem(1, rays=32, coarse=4, fine=8, hidden=16, device="cpu")
    for name, overrides in parity_gpu.PATHS:
        cfg = dataclasses.replace(problem.config, **overrides)
        family = parity_gpu.family_of(cfg.backend)
        loss, grads = parity_gpu.loss_and_grads(problem, cfg)
        out = parity_gpu.pinned_run(problem, cfg, family, loss, grads)
        assert out["recording_bitwise"], name
        assert set(out["guard"]) == {"coarse", "fine"} and all(
            g["ok"] for g in out["guard"].values()), name
        pinned_loss, pinned_grads = out["oracle"]
        ref_loss, ref_grads = parity_gpu.oracle_loss_and_grads(problem, family)
        assert abs(pinned_loss - ref_loss) <= 1e-6 * abs(ref_loss)
        assert parity_gpu.max_rel_err(ref_grads, pinned_grads) < parity_gpu.EXACT_TOL
        assert parity_gpu.max_rel_err(pinned_grads, grads) < parity_gpu.EXACT_TOL
    # Outside the recording, the wrappers are the modules' own again.
    assert rk.mlp_comp_bwd.__module__ == rk.__name__ and rc.mlp_bwd.__module__ == rc.__name__


def test_parity_seeds_report_each_paths_worst_leaf(tmp_path):
    out = tmp_path / "p.json"
    assert parity_gpu.main(["--device", "cpu", "--rays", "16", "--coarse", "4", "--fine", "8",
                            "--hidden", "16", "--seeds", "1", "2", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert set(res["seeds"]) == {"1", "2"} and res["all_pass"]
    worst = res["worst_over_seeds"]
    assert set(worst) == {name for name, _ in parity_gpu.PATHS}
    for name, w in worst.items():
        runs = [r["results"][f"{name}/float32/exact"] for r in res["seeds"].values()]
        assert w["pinned"] == max(r["max_rel_grad_err"] for r in runs)
        assert w["unpinned"] == max(r["max_rel_grad_err_unpinned"] for r in runs)
