"""Port vs JAX package: the fused ray-march kernels B6 and B7 (``pallas_rm``).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX package's ``apply_raymarch_fused`` / ``apply_raymarch_composited``
run in Pallas interpret mode, as ``tests/test_pallas_kernel.py`` runs them, at
width 32 on 13 rays x 6 samples (not a multiple of any tile). The CUDA kernels
are held against the same plain versions on the GPU by ``chip_smoke.py``.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_and_dietnerf_tpu.core import cameras as jcam
from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.ops import research_kernels as jrk
from nerf_and_dietnerf_tpu_torch.core import cameras
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

CASES = [
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=2, n_freq_dir=2, n_angles=2),
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=2, n_angles=0),
]
IDS = ["view_dirs", "xyz_only"]
N_RAYS, S = 13, 6
# The JAX package's own tolerances for these kernels (tests/test_pallas_kernel.py):
# f32 on both sides; the encodings are the same sin calls, but the MLP sums
# and the compositing scans run in another order (the TPU kernel composites
# with a log-step scan), so values agree to float rounding carried through
# eight layers. Gradients are scaled by each leaf's max |value|.
FWD_TOL = 3e-4
GRAD_TOL = 5e-4


def _setup(case, seed=1):
    jcfg, tcfg = jm.MLPConfig(**case), tm.MLPConfig(**case)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    orig = rng.normal(size=(N_RAYS, 4)).astype(np.float32)
    dirs = rng.normal(size=(N_RAYS, 4)).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 5.0, (N_RAYS, S)), -1).astype(np.float32)
    return jcfg, tcfg, params, orig, dirs, z


def _jax_vc(jcfg, dirs):
    return jcam.view_direction_components(dirs, jcfg.n_angles) if jcfg.uses_view_dirs else None


def _port_inputs(tcfg, params, orig, dirs, z):
    tp = tm.params_from_jax(params)
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    o, d = torch.tensor(orig, requires_grad=True), torch.tensor(dirs)
    vc = cameras.view_direction_components(d, tcfg.n_angles) if tcfg.uses_view_dirs else None
    return tp, leaves, o, d, vc, torch.tensor(z, requires_grad=True)


def _assert_scaled(got, ref, tol):
    for a, b in zip(got, ref):
        b = np.asarray(b)
        scale = max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a.detach().numpy() / scale, b / scale, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_raymarch_fused_matches_jax(case):
    """B6: raw values and the gradients w.r.t. params and z."""
    jcfg, tcfg, params, orig, dirs, z = _setup(case)
    g = np.random.default_rng(5).normal(size=(N_RAYS, S, 4)).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda p, zz: jrk.apply_raymarch_fused(p, jcfg, orig, dirs, _jax_vc(jcfg, dirs), zz,
                                               jnp.float32), params, z)
    jgp, jgz = vjp(jnp.asarray(g))

    tp, leaves, o, d, vc, tz = _port_inputs(tcfg, params, orig, dirs, z)
    out = rk.apply_raymarch_fused(tp, tcfg, o, d, vc, tz, torch.float32)
    assert out.shape == (N_RAYS, S, 4) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_TOL, rtol=FWD_TOL)
    (out * torch.tensor(g)).sum().backward()
    _assert_scaled([leaf.grad for leaf in leaves] + [tz.grad],
                   jax.tree.leaves(jgp) + [jgz], GRAD_TOL)
    assert o.grad is not None and float(o.grad.abs().max()) == 0.0  # structural zero


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_raymarch_composited_matches_jax(case):
    """B7: pixels and weights, and the gradients w.r.t. params and z with
    cotangents on both outputs (the coarse weights feed the resampler)."""
    jcfg, tcfg, params, orig, dirs, z = _setup(case)
    rng = np.random.default_rng(6)
    g_rgb = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    g_w = rng.normal(size=(N_RAYS, S)).astype(np.float32)
    (rgb_ref, w_ref), vjp = jax.vjp(
        lambda p, zz: jrk.apply_raymarch_composited(p, jcfg, orig, dirs, _jax_vc(jcfg, dirs), zz,
                                                    jnp.float32), params, z)
    jgp, jgz = vjp((jnp.asarray(g_rgb), jnp.asarray(g_w)))

    tp, leaves, o, d, vc, tz = _port_inputs(tcfg, params, orig, dirs, z)
    rgb, w = rk.apply_raymarch_composited(tp, tcfg, o, d, vc, tz, torch.float32)
    assert rgb.shape == (N_RAYS, 3) and w.shape == (N_RAYS, S)
    for a, b in ((rgb, rgb_ref), (w, w_ref)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=FWD_TOL, rtol=FWD_TOL)
    ((rgb * torch.tensor(g_rgb)).sum() + (w * torch.tensor(g_w)).sum()).backward()
    _assert_scaled([leaf.grad for leaf in leaves] + [tz.grad],
                   jax.tree.leaves(jgp) + [jgz], GRAD_TOL)
    assert float(o.grad.abs().max()) == 0.0


def test_raymarch_composited_opaque_rays_nan_free():
    """Rays whose transmittance underflows to exactly 0 (huge sigma) give
    finite gradients (the backward recurrence is division-free), and the
    same ones as the JAX package."""
    jcfg, tcfg, params, orig, dirs, z = _setup(CASES[1])
    params["sigma_out"]["bias"] = params["sigma_out"]["bias"] + 1e6
    val, (jgp, jgz) = jax.value_and_grad(
        lambda p, zz: sum(jnp.sum(t) for t in jrk.apply_raymarch_composited(
            p, jcfg, orig, dirs, None, zz, jnp.float32)), argnums=(0, 1))(params, z)

    tp, leaves, o, d, _, tz = _port_inputs(tcfg, params, orig, dirs, z)
    rgb, w = rk.apply_raymarch_composited(tp, tcfg, o, d, None, tz, torch.float32)
    assert float(w.detach()[:, 1:].abs().max()) == 0.0  # all light stops at the first sample
    loss = rgb.sum() + w.sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=FWD_TOL)
    grads = [leaf.grad for leaf in leaves] + [tz.grad]
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    _assert_scaled(grads, jax.tree.leaves(jgp) + [jgz], GRAD_TOL)


@pytest.mark.parametrize("kernel", ["B6", "B7"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backwards_match_autograd_of_plain_forwards(case, kernel):
    """The plain backwards (B2's hand-written chain and the encoding VJP down
    to dz) against autograd through the plain forwards, in f32, where every
    rounding of the plain versions is the identity."""
    _, tcfg, params, orig, dirs, z = _setup(case, seed=3)
    tp, _, o, d, vc, _ = _port_inputs(tcfg, params, orig, dirs, z)
    ws, bs = rc.flatten_params(tp, tcfg, torch.float32)
    ws = [w.detach().requires_grad_(True) for w in ws]
    bs = [b.detach().requires_grad_(True) for b in bs]
    rd = rk.pack_rays(tcfg, o, d, vc).detach()
    tz = torch.tensor(z, requires_grad=True)
    rng = np.random.default_rng(9)
    if kernel == "B6":
        g = torch.tensor(rng.normal(size=(N_RAYS, S, 4)).astype(np.float32))
        outs, cots = (rk.raymarch_fwd_plain(ws, bs, tcfg, rd, tz, torch.float32),), (g,)
        with torch.no_grad():
            got = rk.raymarch_bwd_plain(ws, bs, tcfg, rd, tz, g, torch.float32)
    else:
        cots = (torch.tensor(rng.normal(size=(N_RAYS, 3)).astype(np.float32)),
                torch.tensor(rng.normal(size=(N_RAYS, S)).astype(np.float32)))
        outs = rk.raymarch_comp_fwd_plain(ws, bs, tcfg, rd, tz, torch.float32)
        with torch.no_grad():
            got = rk.raymarch_comp_bwd_plain(ws, bs, tcfg, rd, tz, *cots, torch.float32)
    want = torch.autograd.grad(outs, ws + bs + [tz], cots)
    _assert_scaled(list(got[0]) + list(got[1]) + [got[2]], [w.numpy() for w in want], 1e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flat_wrappers_match_autograd(case):
    """The flat kernel-layout wrappers give the gradients the autograd
    Functions hand back, and the plain versions' encodings are the
    reference's column order (B6's raw values equal B1's on them)."""
    _, tcfg, params, orig, dirs, z = _setup(case)
    tp, leaves, o, d, vc, tz = _port_inputs(tcfg, params, orig, dirs, z)
    g = torch.tensor(np.random.default_rng(8).normal(size=(N_RAYS, S, 4)).astype(np.float32))
    (rk.apply_raymarch_fused(tp, tcfg, o, d, vc, tz, torch.float32) * g).sum().backward()
    with torch.no_grad():
        rd = rk.pack_rays(tcfg, o, d, vc)
        ws, bs = rc.flatten_params(tp, tcfg, torch.float32)
        dws, dbs, dz = rk.raymarch_bwd(ws, bs, tcfg, rd, tz.detach(), g, torch.float32)
        _, x, dd = rk.encode_rays_plain(tcfg, rd, tz.detach())
        via_b1 = rc.mlp_fwd(ws, bs, tcfg, x, dd, torch.float32).reshape(N_RAYS, S, 4)
        raw = rk.raymarch_fwd(ws, bs, tcfg, rd, tz.detach(), torch.float32)
    for a, b in zip(tree_leaves(rc.unflatten_grads(dws, dbs, tcfg)), [lf.grad for lf in leaves]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(dz.numpy(), tz.grad.numpy())
    np.testing.assert_array_equal(raw.numpy(), via_b1.numpy())


def test_wrappers_raise_on_device_they_cannot_serve():
    cfg = tm.MLPConfig(**CASES[0])
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    ws, bs = rc.flatten_params(params, cfg, torch.float32)
    rd = torch.empty((8, 9), device="meta")
    z = torch.empty((8, 4), device="meta")
    before = dict(kl.LAUNCHES)
    for call in (lambda: rk.raymarch_fwd(ws, bs, cfg, rd, z, torch.float32),
                 lambda: rk.raymarch_comp_fwd(ws, bs, cfg, rd, z, torch.float32),
                 lambda: rk.raymarch_bwd(ws, bs, cfg, rd, z, torch.empty((8, 4, 4), device="meta"),
                                         torch.float32)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert kl.LAUNCHES == before
    # B7 keeps whole rays on chip: above its maximum it raises on every device.
    big = torch.zeros((2, rk.MAX_SAMPLES_COMPOSITED + 1))
    with pytest.raises(ValueError, match="maximum of 512"):
        rk.raymarch_comp_fwd(ws, bs, cfg, torch.zeros((2, 9)), big, torch.float32)


def test_build_hash_covers_every_included_header(tmp_path):
    """A library's name hashes its source and every header it includes, so
    an edit to a shared header never loads a stale build."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kl.CSRC_DIR, csrc)
    names = list(kl.KERNEL_SOURCES)
    before = {n: kl.lib_path(n, csrc) for n in names}
    assert before == {n: kl.lib_path(n) for n in names}
    deps = {n: {p.name for p in kl.source_closure(csrc / kl.KERNEL_SOURCES[n])} for n in names}
    assert {"mlp_common.cuh", "grad_slabs.cuh", "raymarch_common.cuh"} <= deps[
        "raymarch_comp_bwd"]

    with open(csrc / "raymarch_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: kl.lib_path(n, csrc) for n in names}
    assert {n for n in names if after[n] != before[n]} == {
        n for n in names if "raymarch_common.cuh" in deps[n]} == {
        "raymarch_fwd", "raymarch_bwd", "raymarch_comp_fwd", "raymarch_comp_bwd",
        "probe_enccost"}

    # Every library but P4-P6's includes mlp_common.cuh (P1 through
    # wgmma_bf16.cuh, which takes its PTX helpers from mlp_tf32_tile.cuh).
    with open(csrc / "mlp_common.cuh", "a") as f:
        f.write("// edited\n")
    assert {n for n in names if kl.lib_path(n, csrc) == after[n]} == {"probe_expand"}
