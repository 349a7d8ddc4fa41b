"""The reference against the port's plain path at small sizes on the CPU.

The reference imports nothing of the program; here both are run on the same
weights, rays and draws, so a fault in either shows as a gap."""

import math

import numpy as np
import pytest
import torch

from harness import scene, weights
from reference import nerf as ref_nerf, train as ref_train
from reference.precision import rounder

from nerf_and_dietnerf_tpu_torch.core import cameras
from nerf_and_dietnerf_tpu_torch.models import nerf
from nerf_and_dietnerf_tpu_torch.models.mlp import MLPConfig
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

CFG = {"hidden_layer_dim": 32, "last_hidden_layer_dim": 16, "n_pos_enc_dim_xyz": 3,
       "n_pos_enc_view_dir": 2, "n_angles_for_model": 2, "leaky_relu_alpha": 0.05,
       "near_depth_render": 2.0, "far_depth_render": 6.0}
N_C, N_F, RAYS = 8, 16, 48
FOV = 0.7


def _port_config(dtype):
    mlp = MLPConfig(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=3, n_freq_dir=2, n_angles=2)
    return nerf.NeRFConfig(mlp=mlp, n_samples_coarse=N_C, n_samples_fine=N_F, near=2.0, far=6.0,
                           compute_dtype=dtype, backend="xla")


def _setup(seed=0):
    dims = weights.mlp_dims(CFG)
    params = weights.nerf_params(dims, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    c2w = torch.as_tensor(scene.look_at([4 * math.sin(0.3), 1.0, 4 * math.cos(0.3)]),
                          dtype=torch.float32)
    o4, d4 = cameras.rays_for_image(8, 6, FOV, c2w)
    o4, d4 = o4[:RAYS], d4[:RAYS]
    rgb = torch.rand(RAYS, 3, generator=g)
    strat = torch.rand(RAYS, N_C, generator=g)
    e = torch.empty(RAYS, N_F + 1).exponential_(generator=g)
    return dims, params, c2w, o4, d4, rgb, strat, ref_nerf.sorted_uniforms(e)


def test_rays_agree():
    _, _, c2w, o4, d4, *_ = _setup()
    o, d = ref_nerf.image_rays(c2w, 8, 6, FOV)
    torch.testing.assert_close(o[:RAYS], o4[:, :3], rtol=0, atol=0)
    torch.testing.assert_close(d[:RAYS], d4[:, :3], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,kind", [(torch.float32, "float32"), (torch.bfloat16, "bfloat16")])
def test_training_objective_and_gradients_agree(dtype, kind):
    dims, params, _, o4, d4, rgb, strat, fine = _setup(1)
    draws = {"strat_u": strat, "fine_u": fine}
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(params)]
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_unflatten
    loss, _ = nerf.training_losses(tree_unflatten(params, leaves), _port_config(dtype), None,
                                   o4, d4, rgb, draws=draws)
    grads = torch.autograd.grad(loss, leaves)
    batch = {"o": o4[:, :3], "d": d4[:, :3], "rgb": rgb, "strat_u": strat, "fine_u": fine}
    ref_loss, ref_grads, _ = ref_train.loss_and_grads(params, dims, batch, rounder(kind), block=16)
    tol = 1e-5 if kind == "float32" else 2e-3
    assert ref_loss == pytest.approx(float(loss.detach()), rel=tol)
    for a, b in zip(grads, ref_grads):
        scale = float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 50 * tol * scale


def test_render_path_agrees():
    dims, params, _, o4, d4, _, strat, fine = _setup(2)
    result, _ = nerf.render(params, _port_config(torch.float32), None, o4, d4, N_C, N_F,
                            diagnostics=False, draws={"strat_u": strat, "fine_u": fine})
    ref = ref_nerf.render_rays(params, dims, o4[:, :3], d4[:, :3], strat, fine, rounder("float32"))
    torch.testing.assert_close(ref, result.rgb, rtol=1e-5, atol=1e-6)


def test_the_fine_pass_follows_the_given_samples():
    dims, params, _, o4, d4, rgb, strat, fine = _setup(4)
    batch = {"o": o4[:, :3], "d": d4[:, :3], "rgb": rgb, "strat_u": strat, "fine_u": fine}
    rnd = rounder("float32")
    loss, grads, z = ref_train.loss_and_grads(params, dims, batch, rnd, block=16)
    same = ref_train.loss_and_grads(params, dims, dict(batch, z_follow=z), rnd, block=16)
    assert same[0] == pytest.approx(loss, rel=1e-6)
    for a, b in zip(same[1], grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    moved = z + 0.05
    m_loss, _, m_z = ref_train.loss_and_grads(params, dims, dict(batch, z_follow=moved), rnd,
                                              block=16)
    assert torch.equal(m_z, z)                    # its own resampling, whatever it follows
    rgb_c, _ = ref_nerf.shade(params["coarse"], dims, batch["o"], batch["d"],
                              ref_nerf.stratified(strat, 2.0, 6.0), rnd)
    rgb_f, _ = ref_nerf.shade(params["fine"], dims, batch["o"], batch["d"], moved, rnd)
    want = float((torch.sum((rgb - rgb_c) ** 2) + torch.sum((rgb - rgb_f) ** 2)) / rgb.numel())
    assert m_loss == pytest.approx(want, rel=1e-5)


def test_the_control_is_further_from_the_reference_than_the_stated_precision():
    dims, params, _, o4, d4, rgb, strat, fine = _setup(3)
    batch = {"o": o4[:, :3], "d": d4[:, :3], "rgb": rgb, "strat_u": strat, "fine_u": fine}
    f32, *_ = ref_train.loss_and_grads(params, dims, batch, rounder("float32"))
    gaps = {k: abs(ref_train.loss_and_grads(params, dims, batch, rounder(k))[0] - f32) / f32
            for k in ("tfloat32", "bfloat16", "float8")}
    assert 0 < gaps["tfloat32"] < gaps["bfloat16"] < gaps["float8"]
    x = torch.randn(1000, generator=torch.Generator().manual_seed(5))
    assert float((rounder("tfloat32")(x) - x).abs().max() / x.abs().max()) <= 2.0 ** -11
    assert np.unique(rounder("float8")(x).numpy()).size < 256
