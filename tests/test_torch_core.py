"""Port vs JAX package: encodings, cameras, compositing and z sampling.

Inputs are made with numpy from a seed and fed to both packages; random
draws are taken from JAX and injected into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_and_dietnerf_tpu.core import cameras as jcam
from nerf_and_dietnerf_tpu.core import encoding as jenc
from nerf_and_dietnerf_tpu.core import rendering as jren
from nerf_and_dietnerf_tpu.core import sampling as jsam
from nerf_and_dietnerf_tpu_torch.core import cameras as tcam
from nerf_and_dietnerf_tpu_torch.core import encoding as tenc
from nerf_and_dietnerf_tpu_torch.core import rendering as tren
from nerf_and_dietnerf_tpu_torch.core import sampling as tsam

# Encodings: the double-angle recurrence doubles the rounding error of sin/cos
# at each octave; by octave 4 the two libraries' f32 sin/cos differ by up to
# ~1e-5 after propagation.
ENC_ATOL = 1e-5


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("n_freqs", [0, 2, 5])
def test_encode_xyz_matches_jax(n_freqs):
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (257, 3)).astype(np.float32)
    ref = np.asarray(jenc.encode_xyz(jnp.asarray(x), n_freqs))
    got = tenc.encode_xyz(t(x), n_freqs).numpy()
    assert got.shape == ref.shape == (257, tenc.xyz_encoding_dim(n_freqs))
    np.testing.assert_allclose(got, ref, atol=ENC_ATOL, rtol=0)


@pytest.mark.parametrize("n_angles", [1, 2])
def test_encode_view_dirs_matches_jax(n_angles):
    d = np.random.default_rng(1).normal(size=(129, n_angles + 1)).astype(np.float32)
    ref = np.asarray(jenc.encode_view_dirs(jnp.asarray(d), 4))
    got = tenc.encode_view_dirs(t(d), 4).numpy()
    assert got.shape == (129, tenc.view_encoding_dim(4, n_angles))
    np.testing.assert_allclose(got, ref, atol=ENC_ATOL, rtol=0)


def _c2w(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = q
    c2w[:3, 3] = rng.normal(size=3)
    return c2w


def test_cameras_match_jax():
    c2w = _c2w(2)
    ro, rd = jcam.rays_for_image(7, 11, 0.8, jnp.asarray(c2w))
    to, td = tcam.rays_for_image(7, 11, 0.8, t(c2w))
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), atol=1e-6)
    z = np.random.default_rng(3).uniform(2, 6, (77, 5)).astype(np.float32)
    ref = jcam.sample_points_along_rays(ro, rd, jnp.asarray(z))
    got = tcam.sample_points_along_rays(to, td, t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    for n_angles in (1, 2):
        np.testing.assert_array_equal(
            tcam.view_direction_components(td, n_angles).numpy(),
            np.asarray(jcam.view_direction_components(rd, n_angles)),
        )


def test_composite_values_and_grads_match_jax():
    rng = np.random.default_rng(4)
    raw = rng.normal(size=(6, 9, 4)).astype(np.float32) * 2
    z = np.sort(rng.uniform(2, 6, (6, 9)), -1).astype(np.float32)
    noise = rng.normal(size=(6, 9)).astype(np.float32)
    w = rng.normal(size=(6, 3)).astype(np.float32)

    def jloss(raw, z):
        r = jren.composite(raw, z, sigma_noise=noise)
        return jnp.sum(r.rgb * w) + jnp.sum(r.weights ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(raw), jnp.asarray(z))
    jr = jren.composite(jnp.asarray(raw), jnp.asarray(z), sigma_noise=noise)
    traw, tz = t(raw).requires_grad_(True), t(z).requires_grad_(True)
    tr = tren.composite(traw, tz, sigma_noise=t(noise))
    (torch.sum(tr.rgb * t(w)) + torch.sum(tr.weights ** 2)).backward()
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(traw.grad.numpy(), np.asarray(jg[0]), atol=1e-5)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg[1]), atol=1e-5)


def test_composite_grad_finite_at_very_negative_logits():
    raw = torch.full((2, 4, 4), -100.0, requires_grad=True)
    z = torch.linspace(2, 6, 4).expand(2, 4)
    r = tren.composite(raw, z)
    r.rgb.sum().backward()
    assert torch.isfinite(raw.grad).all()


def test_psnr_matches_jax():
    a = np.random.default_rng(5).uniform(size=(4, 5, 3)).astype(np.float32)
    b = np.random.default_rng(6).uniform(size=(4, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(float(tren.psnr(t(a), t(b))), float(jren.psnr(a, b)), rtol=1e-6)


def test_stratified_and_sorted_uniforms_match_jax():
    key = jax.random.PRNGKey(7)
    ref = jsam.stratified_z_values(key, 2.0, 6.0, (33,), 16)
    u = jax.random.uniform(key, (33, 16))
    got = tsam.stratified_z_values(None, 2.0, 6.0, (33,), 16, uniform=t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(
        tsam.stratified_z_values(None, 2.0, 6.0, (3,), 8).numpy(),
        np.asarray(jsam.stratified_z_values(None, 2.0, 6.0, (3,), 8)), atol=1e-6)
    np.testing.assert_allclose(
        tsam.sorted_uniforms(None, (3,), 8).numpy(),
        np.asarray(jsam.sorted_uniforms(None, (3,), 8)), atol=0)
    s = tsam.sorted_uniforms(torch.Generator().manual_seed(0), (50,), 12)
    assert (torch.diff(s, dim=-1) >= 0).all() and (s > 0).all() and (s < 1).all()


def _weights_and_z(seed, rays=17, n=12):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, (rays, n)).astype(np.float32) ** 3
    w[0] = 0.0  # an all-zero row exercises the CDF_EPS / DENOM_CLAMP path
    z = np.sort(rng.uniform(2, 6, (rays, n)), -1).astype(np.float32)
    return w, z


def test_resample_values_and_grads_match_jax():
    w, z = _weights_and_z(8)
    key = jax.random.PRNGKey(9)
    u = jsam.sorted_uniforms(key, (w.shape[0],), 20)
    c = np.random.default_rng(10).normal(size=(w.shape[0], 20)).astype(np.float32)

    def jf(w, z):
        return jnp.sum(jsam.resample_z_from_weights(key, w, z, 20) * c)

    ref = jsam.resample_z_from_weights(key, jnp.asarray(w), jnp.asarray(z), 20)
    jg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(z))
    tw, tz = t(w).requires_grad_(True), t(z).requires_grad_(True)
    got = tsam.resample_z_from_weights(None, tw, tz, 20, u=t(u))
    torch.sum(got * t(c)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)
    assert (torch.diff(got, dim=-1) >= 0).all()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg[0]), atol=1e-4, rtol=1e-4)
    # A draw below the first CDF value gets t = (u - cdf_0) / DENOM_CLAMP, of
    # order 1e4, and z = z_lo + t (z_hi - z_lo) with z_lo and z_hi the same
    # midpoint: its gradient (1 - t) + t = 1 is summed from terms of size t,
    # so the two gather orders differ by t * 2^-23 ~ 1e-3 there.
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg[1]), atol=5e-3, rtol=1e-5)


def test_resample_backward_has_no_scatter():
    """The picks of the resampling differentiate as one-hot products, so the
    backward adds with no scatter (``torch.gather``'s backward adds with
    atomics on the GPU, which made a training step differ from run to run)."""
    w, z = _weights_and_z(8)
    tw, tz = t(w).requires_grad_(True), t(z).requires_grad_(True)
    got = tsam.resample_z_from_weights(torch.Generator().manual_seed(0), tw, tz, 20)
    names, todo, seen = set(), [got.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo += [nxt for nxt, _ in fn.next_functions]
    assert "_PickBackward" in names
    assert not [n for n in names if "Gather" in n or "Scatter" in n or "Index" in n], names
    grads = [torch.autograd.grad(torch.sum(got * got), (tw, tz), retain_graph=True)
             for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_resample_backward_product_runs_without_tf32(monkeypatch):
    """The one-hot product of the picks' backward runs with TF32 off even
    where the caller allowed it (TF32 would round the cotangents), and the
    caller's setting comes back afterwards."""
    w, z = _weights_and_z(4)
    tw, tz = t(w).requires_grad_(True), t(z).requires_grad_(True)
    got = tsam.resample_z_from_weights(torch.Generator().manual_seed(0), tw, tz, 12)
    want = torch.autograd.grad(got.sum(), (tw, tz), retain_graph=True)
    seen, matmul = [], torch.matmul

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(*args)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch, "matmul", spy)
    grads = torch.autograd.grad(got.sum(), (tw, tz))
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_merge_matches_jax_rank_rule():
    rng = np.random.default_rng(11)
    a = np.sort(rng.integers(0, 6, (9, 7)), -1).astype(np.float32)  # ties on purpose
    b = np.sort(rng.integers(0, 6, (9, 5)), -1).astype(np.float32)
    c = rng.normal(size=(9, 12)).astype(np.float32)
    ref = jsam.merge_sorted(jnp.asarray(a), jnp.asarray(b))
    jg = jax.grad(lambda a, b: jnp.sum(jsam.merge_sorted(a, b) * c), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = t(a).requires_grad_(True), t(b).requires_grad_(True)
    got = tsam.merge_sorted(ta, tb)
    torch.sum(got * t(c)).backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg[0]), atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[1]), atol=1e-6)


def test_merged_fine_z_deterministic_matches_jax():
    w, z = _weights_and_z(12, rays=5, n=8)
    ref = jsam.merged_fine_z_values(None, jnp.asarray(w), jnp.asarray(z), 6)
    got = tsam.merged_fine_z_values(None, t(w), t(z), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
