"""Port vs JAX package: the MLP + compositing kernels B4 and B5 (``pallas`` with
``fuse_compositing`` / ``fuse_fine_loss``).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX package's ``apply_mlp_composited`` / ``apply_mlp_loss_composited``
run in Pallas interpret mode, as ``tests/test_pallas_kernel.py`` runs them, at
width 32 on 13 rays x 6 samples (not a multiple of any tile), and through the
whole training objective. The CUDA kernels are held against the same plain
versions on the GPU by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_and_dietnerf_tpu.core import cameras as jcam
from nerf_and_dietnerf_tpu.core import encoding as jenc
from nerf_and_dietnerf_tpu.core import sampling as jsam
from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.models import nerf as jn
from nerf_and_dietnerf_tpu.ops import research_kernels as jrk
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.models import nerf as tn
from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
from nerf_and_dietnerf_tpu_torch.train.train_step import loss_and_grads
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

CASES = [
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=2, n_freq_dir=2, n_angles=2),
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=2, n_angles=0),
]
IDS = ["view_dirs", "xyz_only"]
N_RAYS, S = 13, 6
# f32 on both sides, the same encodings fed to both. The sums run in another
# order, the TPU kernel composites with log-step scans, and it copies the
# per-ray view-dir encodings to the rows as a bf16 hi + lo pair (2^-17
# relative), so pixels and weights agree to 1e-5 absolute and the loss to
# 1e-5 relative. Gradients are scaled by each leaf's max |value|.
FWD_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _setup(case, seed=1):
    """Configs, JAX params and numpy inputs: rays, z, and the encodings both
    sides are fed (made once, by the JAX package's encoders)."""
    jcfg, tcfg = jm.MLPConfig(**case), tm.MLPConfig(**case)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    orig = rng.normal(size=(N_RAYS, 4)).astype(np.float32)
    dirs = rng.normal(size=(N_RAYS, 4)).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 5.0, (N_RAYS, S)), -1).astype(np.float32)
    pts = jcam.sample_points_along_rays(orig, dirs, z)[..., :3].reshape(-1, 3)
    enc = np.asarray(jenc.encode_xyz(pts, jcfg.n_freq_xyz))
    encd = None
    if jcfg.uses_view_dirs:
        comps = jcam.view_direction_components(dirs, jcfg.n_angles)
        encd = np.asarray(jenc.encode_view_dirs(comps, jcfg.n_freq_dir))
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    return jcfg, tcfg, params, dict(enc=enc, encd=encd, z=z, orig=orig, dirs=dirs,
                                     target=target)


def _t(a, grad=False):
    return None if a is None else torch.tensor(np.asarray(a)).requires_grad_(grad)


def _port_params(params):
    tp = tm.params_from_jax(params)
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    return tp, leaves


def _assert_scaled(got, ref, tol):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        scale = max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a.detach().numpy() / scale, b / scale, atol=tol)


# --------------------------------------------------------------------------- #
# B4: MLP + compositing                                                        #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mlp_composited_matches_jax(case):
    """Pixels and weights, and the gradients w.r.t. the parameters, both
    encodings and z, with cotangents on both outputs."""
    jcfg, tcfg, params, x = _setup(case)
    rng = np.random.default_rng(6)
    g_rgb = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    g_w = rng.normal(size=(N_RAYS, S)).astype(np.float32)
    (rgb_ref, w_ref), vjp = jax.vjp(
        lambda p, e, d, zz: jrk.apply_mlp_composited(p, jcfg, e, d, zz, jnp.float32),
        params, x["enc"], x["encd"], x["z"])
    jgp, jge, jgd, jgz = vjp((jnp.asarray(g_rgb), jnp.asarray(g_w)))

    tp, leaves = _port_params(params)
    enc, encd, z = _t(x["enc"], True), _t(x["encd"], jcfg.uses_view_dirs), _t(x["z"], True)
    rgb, w = rk.apply_mlp_composited(tp, tcfg, enc, encd, z, torch.float32)
    assert rgb.shape == (N_RAYS, 3) and w.shape == (N_RAYS, S)
    assert rgb.dtype == w.dtype == torch.float32
    for a, b in ((rgb, rgb_ref), (w, w_ref)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=FWD_ATOL)
    ((rgb * _t(g_rgb)).sum() + (w * _t(g_w)).sum()).backward()
    got = [leaf.grad for leaf in leaves] + [enc.grad, z.grad]
    ref = jax.tree.leaves(jgp) + [jge, jgz]
    if jcfg.uses_view_dirs:
        got.append(encd.grad)
        ref.append(jgd)
    _assert_scaled(got, ref, GRAD_TOL)


def test_mlp_composited_dz_is_the_compositing_share_only():
    """B4's dz carries the sample spacings only; the points' share arrives
    through denc and the encoding's own backward. Through the model their sum
    is the z gradient of the plain pipeline; the kernel's own dz is not."""
    _, tcfg, params, x = _setup(CASES[0])
    tp = tm.params_from_jax(params)
    cfg = tn.NeRFConfig(mlp=tcfg, compute_dtype=torch.float32, backend="pallas",
                        fuse_compositing=True)
    grads = []
    for c in (cfg, dataclasses.replace(cfg, backend="xla", fuse_compositing=False)):
        z = _t(x["z"], True)
        rgb, w = tn.render_rays_train(tp, c, _t(x["orig"]), _t(x["dirs"]), z)
        (rgb.sum() + (w * w).sum()).backward()
        grads.append(z.grad)
    _assert_scaled([grads[0]], [grads[1].numpy()], GRAD_TOL)

    ws, bs = rc.flatten_params(tp, tcfg, torch.float32)
    with torch.no_grad():
        flat_in = (ws, bs, tcfg, _t(x["enc"]), _t(x["encd"]), _t(x["z"]))
        rgb, w = rk.mlp_comp_fwd(*flat_in, torch.float32)
        *_, dz = rk.mlp_comp_bwd(*flat_in, torch.ones_like(rgb), 2 * w, torch.float32)
    assert float((dz - grads[0]).abs().max()) > 1e-3 * float(grads[0].abs().max())


def test_mlp_composited_opaque_rays_nan_free():
    """Rays whose transmittance underflows to exactly 0 keep finite gradients,
    the same ones as the JAX package's."""
    jcfg, tcfg, params, x = _setup(CASES[1])
    params["sigma_out"]["bias"] = params["sigma_out"]["bias"] + 1e6
    val, (jgp, jge, jgz) = jax.value_and_grad(
        lambda p, e, zz: sum(jnp.sum(t) for t in jrk.apply_mlp_composited(
            p, jcfg, e, None, zz, jnp.float32)), argnums=(0, 1, 2))(params, x["enc"], x["z"])
    tp, leaves = _port_params(params)
    enc, z = _t(x["enc"], True), _t(x["z"], True)
    rgb, w = rk.apply_mlp_composited(tp, tcfg, enc, None, z, torch.float32)
    assert float(w.detach()[:, 1:].abs().max()) == 0.0  # all light stops at the first sample
    loss = rgb.sum() + w.sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=LOSS_RTOL)
    grads = [leaf.grad for leaf in leaves] + [enc.grad, z.grad]
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    _assert_scaled(grads, jax.tree.leaves(jgp) + [jge, jgz], GRAD_TOL)


# --------------------------------------------------------------------------- #
# B5: the fine-pass objective in one kernel                                    #
# --------------------------------------------------------------------------- #

def _jax_loss(jcfg, cd=jnp.float32):
    return lambda p, e, d, zz, dv, tg: jrk.apply_mlp_loss_composited(p, jcfg, e, d, zz, dv, tg, cd)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mlp_loss_composited_matches_jax(case):
    """The loss, its gradients w.r.t. the parameters and z (the total dz), and
    structural-zero cotangents for the encodings, directions and targets."""
    jcfg, tcfg, params, x = _setup(case)
    has_dir = jcfg.uses_view_dirs
    args = (params, x["enc"], x["encd"], x["z"], x["dirs"], x["target"])
    val, (jgp, jgz) = jax.value_and_grad(_jax_loss(jcfg), argnums=(0, 3))(*args)

    tp, leaves = _port_params(params)
    enc, encd, z = _t(x["enc"], True), _t(x["encd"], has_dir), _t(x["z"], True)
    dirs, target = _t(x["dirs"], True), _t(x["target"], True)
    mse = rk.apply_mlp_loss_composited(tp, tcfg, enc, encd, z, dirs, target, torch.float32)
    assert mse.shape == () and mse.dtype == torch.float32
    np.testing.assert_allclose(float(mse.detach()), float(val), rtol=LOSS_RTOL)
    (3.0 * mse).backward()  # a cotangent other than 1 scales every gradient
    _assert_scaled([leaf.grad / 3.0 for leaf in leaves] + [z.grad / 3.0],
                   jax.tree.leaves(jgp) + [jgz], GRAD_TOL)
    for zero in [enc, dirs, target] + ([encd] if has_dir else []):
        assert zero.grad is not None and float(zero.grad.abs().max()) == 0.0


def test_mlp_loss_composited_without_a_graph_and_with_some_gradients():
    """The Function makes its gradients in its forward: it also runs under
    ``no_grad``, and with gradients asked for some inputs only."""
    _, tcfg, params, x = _setup(CASES[0])
    tp, leaves = _port_params(params)
    args = [_t(x[k]) for k in ("enc", "encd", "z", "dirs", "target")]
    ref = rk.apply_mlp_loss_composited(tp, tcfg, *args, torch.float32)
    g_ref = torch.autograd.grad(ref, leaves)
    with torch.no_grad():
        quiet = rk.apply_mlp_loss_composited(tp, tcfg, *args, torch.float32)
    assert not quiet.requires_grad and torch.equal(quiet, ref.detach())

    frozen = tm.params_from_jax(params)  # no parameter gradients: z only
    z = _t(x["z"], True)
    mse = rk.apply_mlp_loss_composited(frozen, tcfg, args[0], args[1], z, args[3], args[4],
                                       torch.float32)
    (dz,) = torch.autograd.grad(mse, [z])
    assert dz.shape == z.shape and float(dz.abs().max()) > 0
    assert all(leaf.grad is None for leaf in tree_leaves(frozen))
    assert len(g_ref) == len(leaves)


def test_mlp_loss_composited_opaque_rays_nan_free():
    jcfg, tcfg, params, x = _setup(CASES[1])
    params["sigma_out"]["bias"] = params["sigma_out"]["bias"] + 1e6
    args = (params, x["enc"], None, x["z"], x["dirs"], x["target"])
    val, (jgp, jgz) = jax.value_and_grad(_jax_loss(jcfg), argnums=(0, 3))(*args)
    tp, leaves = _port_params(params)
    z = _t(x["z"], True)
    mse = rk.apply_mlp_loss_composited(tp, tcfg, _t(x["enc"]), None, z, _t(x["dirs"]),
                                       _t(x["target"]), torch.float32)
    mse.backward()
    np.testing.assert_allclose(float(mse.detach()), float(val), rtol=LOSS_RTOL)
    grads = [leaf.grad for leaf in leaves] + [z.grad]
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    _assert_scaled(grads, jax.tree.leaves(jgp) + [jgz], GRAD_TOL)


# --------------------------------------------------------------------------- #
# bf16 plain versions against the JAX package's bf16 kernels                   #
# --------------------------------------------------------------------------- #

def test_bf16_plain_versions_match_jax_bf16_kernels():
    """bf16 operands: the plain versions round where the JAX kernels round.
    One bf16 ulp of the largest raw output (2^-8 relative) is the tolerance
    ``test_bf16_twin_matches_jax_bf16_forward`` states for the MLP; pixels and
    weights are sigmoids and alphas of those values (slopes <= 1/4 and <= the
    sample spacing), so they and the loss are held to 2^-8 of their largest
    value as well."""
    jcfg, tcfg, params, x = _setup(CASES[0])
    tp = tm.params_from_jax(params)
    rgb_ref, w_ref = jrk.apply_mlp_composited(params, jcfg, x["enc"], x["encd"], x["z"],
                                              jnp.bfloat16)
    rgb, w = rk.apply_mlp_composited(tp, tcfg, _t(x["enc"]), _t(x["encd"]), _t(x["z"]),
                                     torch.bfloat16)
    for a, b in ((rgb, rgb_ref), (w, w_ref)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=np.abs(b).max() * 2 ** -8)
    val = float(_jax_loss(jcfg, jnp.bfloat16)(params, x["enc"], x["encd"], x["z"], x["dirs"],
                                              x["target"]))
    mse = rk.apply_mlp_loss_composited(tp, tcfg, _t(x["enc"]), _t(x["encd"]), _t(x["z"]),
                                       _t(x["dirs"]), _t(x["target"]), torch.bfloat16)
    np.testing.assert_allclose(float(mse), val, rtol=2 ** -8)


# --------------------------------------------------------------------------- #
# The plain backwards against autograd of the plain forwards                   #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kernel", ["B4", "B5"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backwards_match_autograd_of_plain_forwards(case, kernel):
    """In f32 every rounding of the plain versions is the identity, so the
    hand-written chain (B2's, the per-ray sum of the view-dir gradient, and
    B5's encoding VJP from neighbouring columns) must equal autograd. For B5
    the encodings are a function of z, as on the fine pass."""
    jcfg, tcfg, params, x = _setup(case, seed=3)
    has_dir = tcfg.uses_view_dirs
    tp = tm.params_from_jax(params)
    ws, bs = rc.flatten_params(tp, tcfg, torch.float32)
    ws = [w.detach().requires_grad_(True) for w in ws]
    bs = [b.detach().requires_grad_(True) for b in bs]
    z = _t(x["z"], True)
    encd = _t(x["encd"], has_dir)
    rng = np.random.default_rng(9)
    if kernel == "B4":
        enc = _t(x["enc"], True)
        cots = (_t(rng.normal(size=(N_RAYS, 3)).astype(np.float32)),
                _t(rng.normal(size=(N_RAYS, S)).astype(np.float32)))
        outs = rk.mlp_comp_fwd_plain(ws, bs, tcfg, enc, encd, z, torch.float32)
        with torch.no_grad():
            dws, dbs, denc, dencd, dz = rk.mlp_comp_bwd_plain(ws, bs, tcfg, enc, encd, z, *cots,
                                                              torch.float32)
        wrt = ws + bs + [enc, z] + ([encd] if has_dir else [])
        got = list(dws) + list(dbs) + [denc, dz] + ([dencd] if has_dir else [])
        want = torch.autograd.grad(outs, wrt, cots)
    else:
        from nerf_and_dietnerf_tpu_torch.core import encoding

        orig, dirs, target = torch.zeros((N_RAYS, 3)), _t(x["dirs"])[:, :3], _t(x["target"])
        pts = orig[:, None, :] + z[..., None] * dirs[:, None, :]
        enc = encoding.encode_xyz(pts.reshape(-1, 3), tcfg.n_freq_xyz)
        raw, _ = rk._raw_on_encodings(ws, bs, tcfg, enc, encd, z, torch.float32)
        from nerf_and_dietnerf_tpu_torch.core import rendering

        loss = torch.mean(torch.square(rendering.composite(raw, z).rgb - target))
        want = torch.autograd.grad(loss, ws + bs + [z])
        with torch.no_grad():
            mse, dz, dws, dbs = rk.mlp_loss_comp_plain(ws, bs, tcfg, enc.detach(), encd, z, dirs,
                                                       target, torch.float32)
        np.testing.assert_allclose(float(mse), float(loss.detach()), rtol=1e-6)
        got = list(dws) + list(dbs) + [dz]
    # B5's neighbouring-column derivative is exact for exact sin/cos pairs; the
    # double-angle recurrence's columns are sin/cos to 1e-6 at octave 1.
    _assert_scaled(got, [w.numpy() for w in want], 1e-5)


# --------------------------------------------------------------------------- #
# The whole training objective                                                 #
# --------------------------------------------------------------------------- #

N_TRAIN, N_C, N_F = 9, 5, 7
FLAGS = [dict(fuse_compositing=True), dict(fuse_fine_loss=True),
         dict(fuse_compositing=True, fuse_fine_loss=True)]
FLAG_IDS = ["fuse_compositing", "fuse_fine_loss", "both"]


def _train_inputs(case, backend="pallas", **kw):
    common = dict(n_samples_coarse=N_C, n_samples_fine=N_F, near=2.0, far=6.0, backend=backend,
                  **kw)
    jcfg = jn.NeRFConfig(mlp=jm.MLPConfig(**case), compute_dtype=jnp.float32, **common)
    tcfg = tn.NeRFConfig(mlp=tm.MLPConfig(**case), compute_dtype=torch.float32, **common)
    jp = jn.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(2)
    orig = np.concatenate([rng.normal(size=(N_TRAIN, 3)) * 0.2, np.ones((N_TRAIN, 1))], -1)
    dirs = np.concatenate([rng.normal(size=(N_TRAIN, 3)) * 0.3 + [0, 0, 1],
                           np.zeros((N_TRAIN, 1))], -1)
    rgb = rng.uniform(size=(N_TRAIN, 3))
    orig, dirs, rgb = (a.astype(np.float32) for a in (orig, dirs, rgb))
    key = jax.random.PRNGKey(11)
    k_strat, k_res, _, _ = jax.random.split(key, 4)
    draws = {"strat_u": jax.random.uniform(k_strat, (N_TRAIN, N_C)),
             "fine_u": jsam.sorted_uniforms(k_res, (N_TRAIN,), N_F)}
    return jcfg, tcfg, jp, key, orig, dirs, rgb, draws


def _port_losses(tcfg, jp, orig, dirs, rgb, draws):
    return loss_and_grads(
        tm.params_from_jax(jp),
        lambda p: tn.training_losses(p, tcfg, None, _t(orig), _t(dirs), _t(rgb),
                                     draws={k: _t(v) for k, v in draws.items()}))


def _assert_tree(tg, jg, tol=GRAD_TOL):
    _assert_scaled(tree_leaves(tg), jax.tree.leaves(jg), tol)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_training_losses_fused_flags_match_jax(flags):
    """Coarse pass, resampling (and its z gradient into the coarse net) and
    fine pass under "pallas" with each flag and with both, against the JAX
    package under the same flags, on the same draws."""
    jcfg, tcfg, jp, key, orig, dirs, rgb, draws = _train_inputs(CASES[0], **flags)
    (jloss, jmet), jg = jax.value_and_grad(
        lambda p: jn.training_losses(p, jcfg, key, orig, dirs, rgb), has_aux=True)(jp)
    tloss, tmet, tg = _port_losses(tcfg, jp, orig, dirs, rgb, draws)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for k in ("loss", "psnr_coarse", "psnr_fine"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=LOSS_RTOL)
    _assert_tree(tg, jg)


@pytest.mark.parametrize("flags", FLAGS[1:], ids=FLAG_IDS[1:])
def test_fuse_fine_loss_respects_stop_fine_z_grad(flags):
    """With ``stop_fine_z_grad`` B5's dz is dropped: the coarse net's
    gradients are those of the coarse MSE alone, as in the JAX package."""
    jcfg, tcfg, jp, key, orig, dirs, rgb, draws = _train_inputs(
        CASES[1], stop_fine_z_grad=True, **flags)
    jg = jax.grad(lambda p: jn.training_losses(p, jcfg, key, orig, dirs, rgb)[0])(jp)
    _, _, tg = _port_losses(tcfg, jp, orig, dirs, rgb, draws)
    _assert_tree(tg, jg)
    # ... and they differ from the gradients with the resampling path open.
    _, _, open_g = _port_losses(dataclasses.replace(tcfg, stop_fine_z_grad=False), jp, orig,
                                dirs, rgb, draws)
    a, b = tg["coarse"]["sigma_out"]["kernel"], open_g["coarse"]["sigma_out"]["kernel"]
    assert float((a - b).abs().max()) > 1e-3 * float(b.abs().max())


# --------------------------------------------------------------------------- #
# Wrappers                                                                     #
# --------------------------------------------------------------------------- #

def test_flat_wrappers_match_autograd_functions():
    """The flat kernel-layout wrappers give what the autograd Functions hand
    back (B4: parameters, both encodings, z; B5: loss, parameters, total dz)."""
    _, tcfg, params, x = _setup(CASES[0])
    tp, leaves = _port_params(params)
    enc, encd, z = _t(x["enc"], True), _t(x["encd"], True), _t(x["z"], True)
    g_rgb = _t(np.random.default_rng(8).normal(size=(N_RAYS, 3)).astype(np.float32))
    g_w = _t(np.random.default_rng(9).normal(size=(N_RAYS, S)).astype(np.float32))
    rgb, w = rk.apply_mlp_composited(tp, tcfg, enc, encd, z, torch.float32)
    ((rgb * g_rgb).sum() + (w * g_w).sum()).backward()
    with torch.no_grad():
        ws, bs = rc.flatten_params(tp, tcfg, torch.float32)
        flat_in = (ws, bs, tcfg, enc.detach(), encd.detach(), z.detach())
        dws, dbs, denc, dencd, dz = rk.mlp_comp_bwd(*flat_in, g_rgb, g_w, torch.float32)
        mse, dz_total, lws, lbs = rk.mlp_loss_comp(*flat_in, _t(x["dirs"])[:, :3].contiguous(),
                                                   _t(x["target"]), torch.float32)
    for a, b in zip(tree_leaves(rc.unflatten_grads(dws, dbs, tcfg)), [lf.grad for lf in leaves]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in ((denc, enc.grad), (dencd, encd.grad), (dz, z.grad)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert dencd.shape == (N_RAYS, tcfg.dir_dim)

    tp2, leaves2 = _port_params(params)
    z2 = _t(x["z"], True)
    out = rk.apply_mlp_loss_composited(tp2, tcfg, _t(x["enc"]), _t(x["encd"]), z2, _t(x["dirs"]),
                                       _t(x["target"]), torch.float32)
    out.backward()
    assert torch.equal(out.detach(), mse)
    for a, b in zip(tree_leaves(rc.unflatten_grads(lws, lbs, tcfg)),
                    [lf.grad for lf in leaves2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(dz_total.numpy(), z2.grad.numpy())


def test_wrappers_raise_on_device_they_cannot_serve():
    cfg = tm.MLPConfig(**CASES[0])
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    ws, bs = rc.flatten_params(params, cfg, torch.float32)
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    enc, encd, z = meta(32, cfg.xyz_dim), meta(8, cfg.dir_dim), meta(8, 4)
    before = dict(kl.LAUNCHES)
    for call in (
            lambda: rk.mlp_comp_fwd(ws, bs, cfg, enc, encd, z, torch.float32),
            lambda: rk.mlp_comp_bwd(ws, bs, cfg, enc, encd, z, meta(8, 3), meta(8, 4),
                                    torch.float32),
            lambda: rk.mlp_loss_comp(ws, bs, cfg, enc, encd, z, meta(8, 3), meta(8, 3),
                                     torch.float32)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert kl.LAUNCHES == before
    assert {"mlp_comp_fwd", "mlp_comp_bwd", "mlp_loss_comp"} <= set(kl.LAUNCHES)
    # Whole rays stay on chip: above the maximum every device raises.
    n_s = rk.MAX_SAMPLES_COMPOSITED + 1
    big = (torch.zeros((2 * n_s, cfg.xyz_dim)), torch.zeros((2, cfg.dir_dim)),
           torch.zeros((2, n_s)))
    with pytest.raises(ValueError, match="maximum of 512"):
        rk.mlp_comp_fwd(ws, bs, cfg, *big, torch.float32)
    with pytest.raises(ValueError, match="maximum of 512"):
        rk.mlp_loss_comp(ws, bs, cfg, *big, torch.zeros((2, 3)), torch.zeros((2, 3)),
                         torch.float32)
    with pytest.raises(ValueError, match="per-ray view-dir encodings"):
        rk.apply_mlp_composited(params, cfg, torch.zeros((8, cfg.xyz_dim)), None,
                                torch.zeros((2, 4)), torch.float32)


def test_build_hash_of_the_new_kernels_covers_their_headers():
    deps = {n: {p.name for p in kl.source_closure(kl.CSRC_DIR / kl.KERNEL_SOURCES[n])}
            for n in ("mlp_comp_fwd", "mlp_comp_bwd", "mlp_loss_comp", "raymarch_comp_bwd")}
    shared = {"mlp_common.cuh", "composite_common.cuh", "mlp_comp_common.cuh"}
    # Every bf16 kernel of the family runs a ray-group loop on the
    # tensor-core tiles (whose loops carry the phase stamps of
    # tools/t32_phases.py and the branch sinks of the recording builds, both
    # empty in these builds); the backwards share one header of scratch
    # exports and the slabs' sum; the f32 backwards run the loop on the 3xTF32
    # tiles, whose input loads the shared header holds.
    tiles = {"comp_mma_tile.cuh", "mlp_mma_tile.cuh", "t32_phases.cuh", "branch_sink.cuh"}
    t32 = {"mlp_tf32_mma_tile.cuh", "mlp_tf32_tile.cuh"}
    bwd = tiles | t32 | {"comp_exports.cuh", "grad_slabs.cuh"}
    assert deps["mlp_comp_fwd"] == shared | tiles | t32 | {"mlp_comp_fwd.cu"}
    assert deps["mlp_comp_bwd"] == shared | bwd | {"mlp_comp_bwd.cu"}
    assert deps["mlp_loss_comp"] == shared | bwd | {"mlp_loss_comp.cu"}
    assert {"composite_common.cuh"} | bwd <= deps["raymarch_comp_bwd"]
    # B7's forward and backward build their tiles with one header, which
    # brings both kits (bf16 and the f32 backward's 3xTF32 tiles).
    b7 = {"raymarch_comp_tile.cuh", "comp_mma_tile.cuh", "mlp_mma_tile.cuh",
          "mlp_tf32_mma_tile.cuh", "raymarch_tile.cuh"}
    assert b7 <= deps["raymarch_comp_bwd"]
    assert b7 | {"raymarch_comp_fwd.cu"} <= {
        p.name for p in kl.source_closure(kl.CSRC_DIR / kl.KERNEL_SOURCES["raymarch_comp_fwd"])}
