"""Port vs JAX package: the NeRF model (losses, gradients, renders) at width 32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_and_dietnerf_tpu.core import sampling as jsam
from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.models import nerf as jn
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.models import nerf as tn
from nerf_and_dietnerf_tpu_torch.train.train_step import loss_and_grads
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

MLP = dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=3, n_freq_dir=2, n_angles=2)
N_RAYS, N_C, N_F = 24, 8, 12
# f32 throughout; the losses differ by summation order only. Gradients are
# scaled by each leaf's max |value|.
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _configs(backend, **kw):
    common = dict(n_samples_coarse=N_C, n_samples_fine=N_F, near=2.0, far=6.0,
                  backend=backend, **kw)
    return (jn.NeRFConfig(mlp=jm.MLPConfig(**MLP), compute_dtype=jnp.float32, **common),
            tn.NeRFConfig(mlp=tm.MLPConfig(**MLP), compute_dtype=torch.float32, **common))


def _rays(seed=0):
    rng = np.random.default_rng(seed)
    orig = np.concatenate([rng.normal(size=(N_RAYS, 3)) * 0.2, np.ones((N_RAYS, 1))], -1)
    dirs = np.concatenate([rng.normal(size=(N_RAYS, 3)) * 0.3 + [0, 0, 1],
                           np.zeros((N_RAYS, 1))], -1)
    rgb = rng.uniform(size=(N_RAYS, 3))
    return [a.astype(np.float32) for a in (orig, dirs, rgb)]


def _params(jcfg):
    p = jn.init_params(jax.random.PRNGKey(0), jcfg)
    return p, tm.params_from_jax(p)


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_grads(tg, jg):
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl) == 44
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        scale = max(1e-8, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=GRAD_TOL)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_fixed_z_loss_and_all_grads_match_jax(backend):
    jcfg, tcfg = _configs(backend)
    jp, tp = _params(jcfg)
    orig, dirs, rgb = _rays()
    rng = np.random.default_rng(1)
    z_c = np.sort(rng.uniform(2, 6, (N_RAYS, N_C)), -1).astype(np.float32)
    z_f = np.sort(rng.uniform(2, 6, (N_RAYS, N_F)), -1).astype(np.float32)
    jloss, jg = jax.value_and_grad(
        lambda p: jn.training_losses_fixed_z(p, jcfg, orig, dirs, rgb, z_c, z_f))(jp)
    tloss, _, tg = loss_and_grads(
        tp, lambda p: (tn.training_losses_fixed_z(p, tcfg, _t(orig), _t(dirs), _t(rgb),
                                                  _t(z_c), _t(z_f)), None))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(tg, jg)


# The fused ray-march backend, with and without in-kernel compositing (the
# fused path takes no density noise).
RAYMARCH = [dict(backend="pallas_rm", sigma_noise_std=0.5),
            dict(backend="pallas_rm", fuse_compositing=True)]
RAYMARCH_IDS = ["pallas_rm", "pallas_rm_fused"]


def test_training_losses_with_injected_draws_match_jax():
    _check_training_losses(backend="pallas", sigma_noise_std=0.5)


@pytest.mark.parametrize("kw", RAYMARCH, ids=RAYMARCH_IDS)
def test_training_losses_raymarch_backends_match_jax(kw):
    """The whole objective through B6 / B7, resampling and its z gradient
    included, against the JAX package's Pallas kernels."""
    _check_training_losses(**kw)


def _check_training_losses(backend, **kw):
    jcfg, tcfg = _configs(backend, **kw)
    jp, tp = _params(jcfg)
    orig, dirs, rgb = _rays(2)
    key = jax.random.PRNGKey(3)
    k_strat, k_res, k_nc, k_nf = jax.random.split(key, 4)
    draws = {
        "strat_u": jax.random.uniform(k_strat, (N_RAYS, N_C)),
        "fine_u": jsam.sorted_uniforms(k_res, (N_RAYS,), N_F),
        "noise_coarse": jax.random.normal(k_nc, (N_RAYS, N_C)),
        "noise_fine": jax.random.normal(k_nf, (N_RAYS, N_F)),
    }
    (jloss, jm_), jg = jax.value_and_grad(
        lambda p: jn.training_losses(p, jcfg, key, orig, dirs, rgb), has_aux=True)(jp)
    tloss, tmet, tg = loss_and_grads(
        tp, lambda p: tn.training_losses(p, tcfg, None, _t(orig), _t(dirs), _t(rgb),
                                         draws={k: _t(v) for k, v in draws.items()}))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for k in ("loss", "psnr_coarse", "psnr_fine"):
        np.testing.assert_allclose(float(tmet[k]), float(jm_[k]), rtol=1e-5)
    _assert_grads(tg, jg)


@pytest.mark.parametrize("diagnostics", [True, False])
def test_render_deterministic_matches_jax(diagnostics):
    _check_render(diagnostics, backend="pallas")


@pytest.mark.parametrize("kw,diagnostics", [(RAYMARCH[0], True), (RAYMARCH[0], False),
                                            (RAYMARCH[1], False)],
                         ids=["pallas_rm", "pallas_rm_no_diagnostics", "pallas_rm_fused"])
def test_render_raymarch_backends_match_jax(kw, diagnostics):
    """Renders route as in the JAX package: without diagnostics through the
    train path, so "pallas_rm" + fuse_compositing renders through B7. The
    merged z are the inverse CDF of the coarse weights, which amplifies a
    weight's rounding by the bin width over its CDF step: the TPU kernel sums
    the encoding features in its own column order, the coarse weights agree
    to 4e-7 and the z to 2e-5 here, so z is also held relatively (1e-5)."""
    _check_render(diagnostics, z_rtol=1e-5, **kw)


def _check_render(diagnostics, backend, z_rtol=1e-7, **kw):
    jcfg, tcfg = _configs(backend, **kw)
    jp, tp = _params(jcfg)
    orig, dirs, _ = _rays(4)
    jr, jz = jn.render(jp, jcfg, None, orig, dirs, diagnostics=diagnostics)
    tr, tz = tn.render(tp, tcfg, None, _t(orig), _t(dirs), diagnostics=diagnostics)
    assert tz.shape == (N_RAYS, N_C + N_F)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5, rtol=z_rtol)
    for a, b in zip(tr, jr):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_render_image_matches_jax_and_pads_chunks():
    jcfg, tcfg = _configs("xla")
    jp, tp = _params(jcfg)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    jr, jz = jn.render_image(jp, jcfg, None, c2w, 0.7, 5, 7, chunk_size=16, diagnostics=False)
    tr, tz = tn.render_image(tp, tcfg, None, c2w, 0.7, 5, 7, chunk_size=16, diagnostics=False,
                             device="cpu")
    assert tr.rgb.shape == (5, 7, 3) and tr.cumprod is None
    np.testing.assert_allclose(tr.rgb.numpy(), np.asarray(jr.rgb), atol=1e-5)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)


# The fused paths of the MLP backends: B4 (MLP + compositing) and B5 (the
# fine-pass objective in one kernel).
FUSED_MLP = [dict(fuse_compositing=True), dict(fuse_fine_loss=True),
             dict(fuse_compositing=True, fuse_fine_loss=True)]
FUSED_MLP_IDS = ["fuse_compositing", "fuse_fine_loss", "both"]


@pytest.mark.parametrize("flags", FUSED_MLP, ids=FUSED_MLP_IDS)
@pytest.mark.parametrize("backend", ["pallas", "pallas_mlp"])
def test_fused_flags_route_to_their_kernels(backend, flags, monkeypatch):
    """With ``fuse_compositing`` B4 carries the coarse and the fine pass; with
    ``fuse_fine_loss`` B5 carries the fine pass (and B1/B2 or B4 the coarse
    one). Counted on the CPU at the plain versions the wrappers take there."""
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
    from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk

    calls = {}

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapper)

    for name in ("mlp_comp_fwd_plain", "mlp_comp_bwd_plain", "mlp_loss_comp_plain"):
        counted(rk, name)
    for name in ("mlp_fwd", "mlp_bwd"):  # B1 / B2's wrappers
        counted(rc, name)
    _, tcfg = _configs(backend, **flags)
    _, tp = _params(_configs(backend)[0])
    orig, dirs, rgb = _rays(2)
    loss, _, grads = loss_and_grads(
        tp, lambda p: tn.training_losses(p, tcfg, None, _t(orig), _t(dirs), _t(rgb)))
    assert np.isfinite(float(loss)) and len(tree_leaves(grads)) == 44
    comp, fine_loss = bool(flags.get("fuse_compositing")), bool(flags.get("fuse_fine_loss"))
    b4 = (2 - fine_loss) if comp else 0      # passes B4 carries
    b12 = 0 if comp else (2 - fine_loss)     # passes B1/B2 carry
    want = {"mlp_comp_fwd_plain": b4, "mlp_comp_bwd_plain": b4,
            "mlp_loss_comp_plain": int(fine_loss), "mlp_fwd": b12, "mlp_bwd": b12}
    assert {k: calls.get(k, 0) for k in want} == want


@pytest.mark.parametrize("backend", ["pallas_rm", "xla"])
def test_fuse_fine_loss_is_accepted_and_inert_off_the_mlp_backends(backend):
    """As in the JAX package, the flag has an effect only under "pallas" /
    "pallas_mlp": elsewhere the loss and gradients are those without it, and
    those of the JAX package with it."""
    _check_training_losses(backend, fuse_fine_loss=True)
    orig, dirs, rgb = _rays(2)
    outs = []
    for kw in (dict(), dict(fuse_fine_loss=True)):
        jcfg, tcfg = _configs(backend, **kw)
        _, tp = _params(jcfg)
        outs.append(loss_and_grads(
            tp, lambda p: tn.training_losses(p, tcfg, None, _t(orig), _t(dirs), _t(rgb))))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tree_leaves(outs[0][2]), tree_leaves(outs[1][2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flags", FUSED_MLP, ids=FUSED_MLP_IDS)
def test_density_noise_with_fused_mlp_flags_raises_like_jax(flags):
    """B4 and B5 composite in the kernel without a noise input: asking for
    density noise with either flag raises, in both packages."""
    orig, dirs, rgb = _rays()
    jcfg, tcfg = _configs("pallas", sigma_noise_std=0.5, **flags)
    jp, tp = _params(jcfg)
    with pytest.raises(ValueError, match="sigma_noise_std"):
        jn.training_losses(jp, jcfg, jax.random.PRNGKey(0), orig, dirs, rgb)
    noise = np.random.default_rng(2).normal(size=(N_RAYS, N_C)).astype(np.float32)
    with pytest.raises(ValueError, match="sigma_noise_std"):
        tn.training_losses(tp, tcfg, None, _t(orig), _t(dirs), _t(rgb),
                           draws={"noise_coarse": _t(noise)})
    with pytest.raises(ValueError, match="sigma_noise_std"):
        tn.training_losses(tp, tcfg, torch.Generator().manual_seed(0), _t(orig), _t(dirs),
                           _t(rgb))


def test_density_noise_with_fused_compositing_raises_like_jax():
    """The fused kernels composite without a noise input, so noise with
    fuse_compositing raises; plain "pallas_rm" adds it after the kernel."""
    orig, dirs, _ = _rays()
    z = np.sort(np.random.default_rng(1).uniform(2, 6, (N_RAYS, N_C)), -1).astype(np.float32)
    noise = np.random.default_rng(2).normal(size=(N_RAYS, N_C)).astype(np.float32)
    jcfg, tcfg = _configs("pallas_rm", fuse_compositing=True, sigma_noise_std=0.5)
    jp, tp = _params(jcfg)
    with pytest.raises(ValueError, match="sigma_noise_std"):
        jn.render_rays_train(jp["coarse"], jcfg, orig, dirs, z, noise_key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="sigma_noise_std"):
        tn.render_rays_train(tp["coarse"], tcfg, _t(orig), _t(dirs), _t(z), noise=_t(noise))

    _, tcfg = _configs("pallas_rm", sigma_noise_std=0.5)
    args = (tp["coarse"], tcfg, _t(orig), _t(dirs), _t(z))
    rgb, weights = tn.render_rays_train(*args, noise=_t(noise))
    ref = tn.render_rays(*args, sigma_noise=0.5 * _t(noise))
    torch.testing.assert_close(rgb, ref.rgb, rtol=0, atol=0)
    assert not torch.equal(weights, tn.render_rays_train(*args)[1])
